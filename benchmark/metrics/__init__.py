"""Per-layer metrics, one module each, found by the metric's name.

A module declares ``UNIT``, ``LAYER``, ``SOURCE``, ``MOVES`` and
``WORKLOADS`` (as ``BENCHMARK.json`` lists them) and ``read(run)``, which
returns the metric's value from a ``benchmark.harness.RunRecord``, or None
where the run holds nothing to read (the harness then leaves the metric
out).  The helpers below are shared arithmetic, not metrics.
"""

from __future__ import annotations

from typing import Optional


def stage_ms_per_ktree(run, stage: str) -> Optional[float]:
    """A program stage's summed milliseconds per 1,000 trees of the
    window, or None where no job reported the stage."""
    spent = [j.stages[stage] for j in run.jobs if stage in j.stages]
    if not spent or run.trees == 0:
        return None
    return sum(spent) * 1e3 / (run.trees / 1e3)
