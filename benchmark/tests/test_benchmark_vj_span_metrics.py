"""The readers of the light-chain cell's spans: the state space and its
transition tables per family, and the junction scan per 1,000 trees.  Each
returns None where no job reported its span (a program without it)."""

import pytest

from benchmark import harness
from benchmark.drivers import Job


def _run(stages_per_job, trees=1001, families=1):
    jobs = [Job(trees, 0.5, [], stages, families)
            for stages in stages_per_job]
    return harness.RunRecord("igk-partition.cold", jobs, trees * len(jobs),
                             1.0, 0.0)


def test_state_space_is_ms_per_family_built():
    metric = harness.metric_module("state_space_ms_per_family")
    run = _run([{"state_space": 0.16, "compile": 0.9},
                {"state_space": 0.32}, {"compile": 0.5}],
               trees=16016, families=16)
    assert metric.read(run) == pytest.approx(480.0 / 32)
    assert metric.read(_run([{"compile": 0.9}], families=16)) is None
    assert metric.read(_run([])) is None


def test_junction_scan_is_ms_per_ktree():
    metric = harness.metric_module("junction_scan_ms_per_ktree")
    run = _run([{"junction_scan": 0.02, "device_step": 0.3},
                {"junction_scan": 0.01}], trees=1000)
    assert metric.read(run) == pytest.approx(30.0 / 2)
    assert metric.read(_run([{"device_step": 0.3}])) is None
    assert metric.read(_run([])) is None
