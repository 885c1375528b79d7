"""Idle share, launches and the breakdown from a synthetic timeline."""

import json

import numpy as np
import pytest

from benchmark import harness, trace


def _summary():
    ops = [("kernel", "k1", 1.0, 2.0), ("kernel", "k2", 1.5, 2.5),
           ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 4.0, 4.5),
           ("kernel", "k1", 9.5, 11.0)]           # runs past the window
    host = [("bench/job", 0.0, 10.0), ("stage/build_hmm", 2.5, 4.0),
            ("stage/write_tsv", 4.5, 10.0)]
    return trace.TraceSummary((0.0, 10.0), ops, host)


def test_idle_share_is_the_window_less_the_union():
    s = _summary()
    # Busy: [1, 2.5] and [4, 4.5] and [9.5, 10] (clipped): 2.5 s.
    assert trace.busy_s(s) == pytest.approx(2.5)
    idle = harness.metric_module("device_idle_pct")
    run = harness.RunRecord("c", [], 2000, 10.0, 0.0, s)
    assert idle.read(run) == pytest.approx(75.0)
    launches = harness.metric_module("device_launches_per_ktree")
    assert launches.read(run) == pytest.approx(3 / 2.0)


def test_idle_gaps_are_labelled_by_the_host_stage():
    b = trace.breakdown(_summary())
    gaps = dict(b["idle_gaps"])
    assert gaps["write_tsv"] == pytest.approx(5.0)     # [4.5, 9.5]
    assert gaps["build_hmm"] == pytest.approx(1.5)     # [2.5, 4.0]
    assert gaps["job"] == pytest.approx(1.0)           # [0, 1]
    ops = dict(b["device_ops"])
    assert ops["k1"] == pytest.approx(2.5)


def test_the_window_is_its_jobs_spans():
    """Between jobs the harness reads outputs: that time is neither busy
    nor idle."""
    ops = [("kernel", "k", 1.0, 2.0), ("kernel", "k", 4.5, 5.0),
           ("kernel", "k", 7.0, 8.0)]
    host = [("bench/job", 0.0, 4.0), ("bench/job", 6.0, 10.0)]
    s = trace.TraceSummary((0.0, 10.0), ops, host)
    assert s.window_s == pytest.approx(8.0)
    assert trace.busy_s(s) == pytest.approx(2.0)
    gaps = trace.idle_gaps(s)
    assert gaps == [(0.0, 1.0), (2.0, 4.0), (6.0, 7.0), (8.0, 10.0)]


def test_summarize_reads_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/window",
         "ts": 1_000_000, "dur": 2_000_000},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1_500_000,
         "dur": 500_000},
        {"ph": "X", "cat": "user_annotation", "name": "stage/decode",
         "ts": 2_000_000, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1_200_000,
         "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path))
    assert s.window == (1.0, 3.0) and s.window_s == 2.0
    assert s.kernels() == [("k", 1.5, 2.0)]
    assert [h[0] for h in s.host_ranges] == ["stage/decode"]


def test_short_kernel_names():
    assert trace.short_name(
        "void (anonymous namespace)::pruning_kernel<float, 4, 64>(int const*)"
    ) == "(anonymous namespace)::pruning_kernel<float, 4, 64>"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


# The scans the sweep replaced, kept as its oracle: each gap's label by a
# scan of every host range, and the window's clipping and gaps by a scan
# of every operation for every job.
def _host_label_scan(summary, t):
    best, start = None, -1.0
    for name, a, b in summary.host_ranges:
        if a <= t <= b and name.startswith("stage/") and a > start:
            best, start = name[len("stage/"):], a
    if best is not None:
        return best
    if any(a <= t <= b for n, a, b in summary.host_ranges
           if n == trace.JOB):
        return "job"
    return "harness"


def _busy_scan(summary):
    out = []
    for lo, hi in summary.spans():
        out += [(max(a, lo), min(b, hi)) for _, _, a, b in
                summary.device_ops if b > lo and a < hi]
    return trace.merged(out)


def _gaps_scan(summary):
    busy = _busy_scan(summary)
    gaps = []
    for lo, hi in summary.spans():
        t = lo
        for a, b in busy:
            if b <= lo or a >= hi:
                continue
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
    return gaps


def _breakdown_scan(summary):
    by_stage = {}
    for a, b in _gaps_scan(summary):
        label = _host_label_scan(summary, (a + b) / 2)
        by_stage[label] = by_stage.get(label, 0.0) + (b - a)
    return sorted(([k, v] for k, v in by_stage.items()),
                  key=lambda kv: -kv[1])[:10]


def _stages(rng, lo, hi, depth, out):
    """Nested stage ranges inside [lo, hi], on a coarse grid so that
    starts and ends tie, some of zero length."""
    t = lo
    while t < hi and rng.random() < 0.8:
        a = min(hi, t + rng.integers(0, 3) * 0.25)
        b = min(hi, a + rng.integers(0, 8) * 0.25)
        out.append((f"stage/s{depth}_{rng.integers(0, 4)}", a, b))
        if depth < 3 and b > a:
            _stages(rng, a, b, depth + 1, out)
        t = b if rng.random() < 0.7 else a      # siblings may overlap


def _random_summary(seed):
    rng = np.random.default_rng(seed)
    host, t = [], 0.0
    for _ in range(rng.integers(1, 6)):
        t += rng.integers(0, 3) * 0.5           # harness time between jobs
        end = t + rng.integers(1, 12) * 0.5
        host.append(("bench/job", t, end))
        _stages(rng, t - 0.5, end + 0.25, 0, host)   # some poke out
        t = end
    host = [host[i] for i in rng.permutation(len(host))]
    ops = []
    for _ in range(rng.integers(0, 40)):
        a = rng.uniform(-1.0, t + 1.0)
        ops.append(("kernel", f"k{rng.integers(0, 3)}", a,
                    a + rng.uniform(0.0, 0.6)))
    return trace.TraceSummary((0.0, t), ops, host)


@pytest.mark.parametrize("seed", range(40))
def test_the_sweep_labels_as_the_scan_did(seed):
    s = _random_summary(seed)
    assert trace.busy_intervals(s) == _busy_scan(s)
    gaps = trace.idle_gaps(s)
    assert gaps == _gaps_scan(s)
    # The gaps' midpoints, and every grid point: starts and ends exactly.
    times = [(a + b) / 2 for a, b in gaps] + \
        [x * 0.25 for x in range(-4, int(s.window[1] * 4) + 5)]
    assert trace.host_labels(s, times) == \
        [_host_label_scan(s, t) for t in times]
    assert trace.breakdown(s)["idle_gaps"] == _breakdown_scan(s)
