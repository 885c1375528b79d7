"""Idle share, launches and the breakdown from a synthetic timeline."""

import json

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
