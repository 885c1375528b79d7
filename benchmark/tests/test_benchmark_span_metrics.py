"""The readers of the program's own spans: the germline parse per family,
the device time of the chunks, and the main thread's wait for the drain.
Each returns None where no job reported its span (a program without it)."""

import pytest

from benchmark import harness
from benchmark.drivers import Job


def _run(stages_per_job, trees=1001, families=1):
    jobs = [Job(trees, 0.5, [], stages, families)
            for stages in stages_per_job]
    return harness.RunRecord("c", jobs, trees * len(jobs), 1.0, 0.0)


def test_gene_map_is_seconds_per_family_built():
    metric = harness.metric_module("gene_map_s_per_family")
    run = _run([{"load_gene_map": 8.4, "build_hmm": 9.9},
                {"load_gene_map": 7.6}], trees=8008, families=8)
    assert metric.read(run) == pytest.approx(16.0 / 16)
    assert metric.read(_run([{"build_hmm": 9.9}], families=8)) is None


@pytest.mark.parametrize("name,stage", [
    ("chunk_device_ms_per_ktree", "chunk_device"),
    ("drain_wait_ms_per_ktree", "drain_wait"),
])
def test_span_ms_per_ktree(name, stage):
    metric = harness.metric_module(name)
    run = _run([{stage: 0.25, "dispatch": 0.3}, {stage: 0.05}], trees=1000)
    assert metric.read(run) == pytest.approx(300.0 / 2)
    assert metric.read(_run([{"dispatch": 0.3}])) is None
    assert metric.read(_run([])) is None
