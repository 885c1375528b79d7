"""Lightweight stage timing.

The reference has no observability at all (SURVEY.md section 5); here
every pipeline run can report where its wall-clock went (host parse, GTR
eigen, device transfer, per-chunk execution).  The torch.profiler trace
of a run is pipeline/run.py's ``maybe_trace``.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict


class StageTimer:
    """Accumulates named wall-clock spans."""

    def __init__(self):
        self.times: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"total {total * 1e3:.1f}ms"]
        for name, t in self.times.items():
            n = self.counts[name]
            lines.append(
                f"  {name}: {t * 1e3:.1f}ms"
                + (f" ({n}x)" if n > 1 else ""))
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.times)
