"""The port's span recorder, and the profiler trace of a call.

The reference has no observability at all (SURVEY.md section 5).  Here one
``StageTimer`` records the spans and counters of one request (a
``run_pipeline`` call, a ``serve`` request, a ``repertoire`` call): each
span's name, start and end in nanoseconds on the torch.profiler trace's
clock (epoch time), its thread, the span that encloses it on that thread,
and the request.  ``recording`` makes a recorder the active one for a
block (a context variable), so library code opens ``span(name)`` and
``count(name)`` without a timer argument; with no recorder active both do
nothing.  A span opens a ``stage/<name>`` profiler range only where the
profiler is on in its thread.  Spans stay in memory: ``as_dict`` sums them
per name, ``self_times`` sums each span less its children, and ``trace``
writes a profiler trace of a block with the spans the profiler did not see
(another thread's, the device's) appended to it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Union

import torch

from linearham_tpu_torch.utils.runtime import resolve_device

# perf_counter_ns plus this offset is epoch time, the profiler trace's clock.
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_REQUESTS = itertools.count(1)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "linearham_recorder", default=None)
# How far a span may stick out of the profiler range that holds it, in µs
# (the profiler's clock and this module's differ by a few).
_SLACK_US = 100.0


def now_ns() -> int:
    """Now on the profiler trace's clock, in epoch nanoseconds."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: Union[int, str]   # native thread id, or the device of a CUDA span
    parent: Optional[int]     # id of the enclosing span of the same thread
    request: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class StageTimer:
    """The spans and counters of one request."""

    def __init__(self):
        self.request = next(_REQUESTS)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count()
        self._open = threading.local()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        """A span of the calling thread, enclosed by the one it has open."""
        with contextlib.ExitStack() as ranged:
            if torch.autograd._profiler_enabled():
                ranged.enter_context(
                    torch.profiler.record_function(f"stage/{name}"))
            stack = self._open.__dict__.setdefault("stack", [])
            sid = next(self._ids)
            parent = stack[-1] if stack else None
            stack.append(sid)
            start = now_ns()   # inside the range: the range holds the span
            try:
                yield
            finally:
                end = now_ns()
                stack.pop()
                self.spans.append(Span(sid, name, start, end,
                                       threading.get_native_id(), parent,
                                       self.request))

    def add(self, name: str, start_ns: int, end_ns: int,
            thread: Union[int, str]) -> None:
        """A span timed elsewhere (a ``CudaSpan``), with no parent."""
        self.spans.append(Span(next(self._ids), name, start_ns, end_ns,
                               thread, None, self.request))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def as_dict(self) -> Dict[str, float]:
        """Seconds per span name, summed over the spans, in order of first
        start."""
        return self._sums({})

    def self_times(self) -> Dict[str, float]:
        """As ``as_dict``, each span less the part of it that its children
        cover."""
        covered: Dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                covered[s.parent] = covered.get(s.parent, 0) \
                    + s.end_ns - s.start_ns
        return self._sums(covered)

    def _sums(self, covered: Dict[int, int]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in sorted(self.spans, key=lambda s: s.start_ns):
            out[s.name] = out.get(s.name, 0.0) + s.seconds \
                - covered.get(s.id, 0) * 1e-9
        return out


def active() -> Optional[StageTimer]:
    return _ACTIVE.get()


def span(name: str):
    """A span of the active recorder; nothing without one."""
    timer = _ACTIVE.get()
    return timer.stage(name) if timer is not None \
        else contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the active recorder, if there is one."""
    timer = _ACTIVE.get()
    if timer is not None:
        timer.count(name, n)


@contextlib.contextmanager
def recording():
    """The block's recorder: the active one, whose request the block joins,
    else a new one, active for the block."""
    timer = _ACTIVE.get()
    if timer is not None:
        yield timer
        return
    timer = StageTimer()
    token = _ACTIVE.set(timer)
    try:
        yield timer
    finally:
        _ACTIVE.reset(token)


class CudaSpan:
    """A span timed on the device by two CUDA timing events on ``device``'s
    current stream: one recorded at construction, one by ``close()``.
    ``wait()`` blocks until the second has passed and adds the span to the
    recorder that was active at construction.  Its start is where the host
    recorded the first event (on an idle device the two agree), its length
    the events' elapsed time."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.timer = _ACTIVE.get()
        self.stream = torch.cuda.current_stream(device)
        self.begin = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start_ns = now_ns()
        self.begin.record(self.stream)

    def close(self) -> None:
        self.end.record(self.stream)

    def wait(self) -> None:
        self.end.synchronize()
        if self.timer is not None:
            ns = int(self.begin.elapsed_time(self.end) * 1e6)
            self.timer.add(self.name, self.start_ns, self.start_ns + ns,
                           str(self.device))


def cuda_span(name: str, device: torch.device) -> Optional[CudaSpan]:
    """A ``CudaSpan`` on a CUDA device; None elsewhere."""
    return CudaSpan(name, device) if device.type == "cuda" else None


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device, timer: StageTimer,
          label: str):
    """A torch.profiler trace of the block (host activity, and the card's on
    a CUDA device; ``device`` as ``utils.runtime.resolve_device`` takes it)
    written as Chrome trace JSON into ``trace_dir`` as
    ``<label>.<pid>.<ns>.trace.json``, with ``timer``'s spans that it lacks
    appended (``append_spans``); a no-op without a directory."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"{label}.{os.getpid()}.{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    append_spans(path, timer.spans)


def append_spans(path: str, spans: List[Span]) -> None:
    """Append to the Chrome trace at ``path`` every span it lacks: a span is
    there when a ``stage/<name>`` range of its name, not taken by another
    span, holds it (``stage`` reads its clock inside the range; the two
    clocks may differ by microseconds).  The profiler records ranges of the
    thread that started it only.  Appended spans keep their thread (a
    device's spans get a thread of their own, named after it) and carry
    their id, parent and request."""
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"]
    base = int(data.get("baseTimeNanoseconds", 0))
    ranges: Dict[str, List[List[float]]] = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith("stage/"):
            a = float(ev["ts"])
            ranges.setdefault(name[len("stage/"):], []).append(
                [a - _SLACK_US, a + float(ev.get("dur", 0.0)) + _SLACK_US])
    pid = os.getpid()
    tids: Dict[Union[int, str], int] = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        held = next((r for r in ranges.get(s.name, ())
                     if r[0] <= a and b <= r[1]), None)
        if held is not None:
            ranges[s.name].remove(held)
            continue
        if s.thread not in tids:
            tids[s.thread] = s.thread if isinstance(s.thread, int) \
                else (1 << 30) + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[s.thread],
                           "args": {"name": f"linearham {s.thread}"}})
        events.append({
            "ph": "X", "cat": "user_annotation", "name": f"stage/{s.name}",
            "pid": pid, "tid": tids[s.thread], "ts": a, "dur": b - a,
            "args": {"span": s.id, "parent": s.parent,
                     "request": s.request}})
    with open(path, "w") as fh:
        json.dump(data, fh)
