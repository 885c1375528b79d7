"""The traced window: a torch.profiler trace, read back from its JSON.

``Tracer`` runs the profiler (host and CUDA activity) around the window
and labels the host's time: every ``StageTimer`` stage of the program
becomes a ``stage/<name>`` range and every job a ``bench/job`` range.
``summarize`` reads the exported Chrome trace: the device's operations
(kernels, copies, memsets) as intervals, the host ranges, and the
window's bounds, all on the trace's one clock.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench/window"
JOB = "bench/job"


@dataclass
class TraceSummary:
    window: Tuple[float, float]                # seconds, trace clock
    device_ops: List[Tuple[str, str, float, float]]   # cat, name, start, end
    host_ranges: List[Tuple[str, float, float]]       # name, start, end

    def spans(self) -> List[Tuple[float, float]]:
        """The window's time: its jobs' spans (the harness reads each
        job's outputs between jobs, off the window's clock), or the whole
        window where no job range was recorded."""
        lo, hi = self.window
        jobs = [(max(a, lo), min(b, hi)) for n, a, b in self.host_ranges
                if n == JOB and b > lo and a < hi]
        return merged(jobs) if jobs else [self.window]

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.spans())

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [(n, a, b) for c, n, a, b in self.device_ops if c == "kernel"]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_intervals(summary: TraceSummary) -> List[Tuple[float, float]]:
    """The union of device operations, clipped to the window's spans."""
    spans = summary.spans()
    his = [hi for _, hi in spans]
    out = []
    for _, _, a, b in summary.device_ops:
        i = bisect.bisect_right(his, a)          # the first span past a
        while i < len(spans) and spans[i][0] < b:
            lo, hi = spans[i]
            out.append((max(a, lo), min(b, hi)))
            i += 1
    return merged(out)


def busy_s(summary: TraceSummary) -> float:
    return sum(b - a for a, b in busy_intervals(summary))


def idle_gaps(summary: TraceSummary) -> List[Tuple[float, float]]:
    busy = busy_intervals(summary)
    ends = [b for _, b in busy]
    gaps = []
    for lo, hi in summary.spans():
        t = lo
        i = bisect.bisect_right(ends, lo)        # the first busy past lo
        while i < len(busy) and busy[i][0] < hi:
            a, b = busy[i]
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
            i += 1
        if hi > t:
            gaps.append((t, hi))
    return gaps


def host_labels(summary: TraceSummary, times: List[float]) -> List[str]:
    """What the host was doing at each of ``times``: the innermost
    program stage open then (the latest started; of two that started
    together, the one recorded first), else ``job`` inside a job, else
    ``harness``.  One sweep over the times in order and the ranges by
    start: a heap holds the stages started so far, latest first, and drops
    one once it has ended before the time at hand."""
    stages = sorted((a, n, b, name[len("stage/"):]) for n, (name, a, b)
                    in enumerate(summary.host_ranges)
                    if name.startswith("stage/"))
    jobs = sorted((a, b) for name, a, b in summary.host_ranges
                  if name == JOB)
    labels = [""] * len(times)
    heap: List[Tuple[float, int, float, str]] = []
    si = ji = 0
    job_end = -math.inf          # the latest end of a job started so far
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while si < len(stages) and stages[si][0] <= t:
            a, n, b, name = stages[si]
            heapq.heappush(heap, (-a, n, b, name))
            si += 1
        while heap and heap[0][2] < t:
            heapq.heappop(heap)
        while ji < len(jobs) and jobs[ji][0] <= t:
            job_end = max(job_end, jobs[ji][1])
            ji += 1
        labels[k] = heap[0][3] if heap else \
            "job" if job_end >= t else "harness"
    return labels


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and argument list."""
    if "<" not in name and "::" not in name:
        return name[:width]
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != ":" \
                and not name.startswith("(anonymous", i):
            cut = i
            break
    return name[:cut][:width]


def breakdown(summary: TraceSummary, top: int = 10) -> Dict[str, list]:
    by_op: Dict[str, float] = {}
    for _, name, a, b in summary.device_ops:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (b - a)
    by_stage: Dict[str, float] = {}
    gaps = idle_gaps(summary)
    labels = host_labels(summary, [(a + b) / 2 for a, b in gaps])
    for (a, b), label in zip(gaps, labels):
        by_stage[label] = by_stage.get(label, 0.0) + (b - a)
    return {
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_stage.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def summarize(path: str) -> TraceSummary:
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        a = float(ev["ts"]) * 1e-6
        b = a + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            ops.append((cat, name, a, b))
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (a, b)
            elif name == JOB or name.startswith("stage/"):
                host.append((name, a, b))
    if window is None:
        raise RuntimeError(f"{path}: the trace holds no {WINDOW} range")
    return TraceSummary(window, ops, host)


class Tracer:
    """The profiler around the window, and the host labels inside it."""

    def __init__(self, outdir: str):
        self.path = os.path.join(outdir, "window.trace.json")

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from linearham_tpu_torch.utils import profiling

        original = profiling.StageTimer.stage

        @contextlib.contextmanager
        def labelled(timer, name):
            with record_function(f"stage/{name}"), original(timer, name):
                yield

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        profiling.StageTimer.stage = labelled
        try:
            with profile(activities=activities) as prof:
                with record_function(WINDOW):
                    yield
                    if cuda:
                        torch.cuda.synchronize()
        finally:
            profiling.StageTimer.stage = original
        prof.export_chrome_trace(self.path)

    @staticmethod
    def job():
        from torch.profiler import record_function

        return record_function(JOB)
