"""``host_prepare_ms_per_ktree``: the program's ``host_prepare`` stage,
summed over the window's jobs, in milliseconds per 1,000 trees.  The span
is opened in ``pipeline/run.run_pipeline_arrays`` around
``models/step.Prepared.of``, which runs ``models/step.prepare_ensemble``:
the native Newick parse, io/schedule, ops/gtr."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "pipeline"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "host_prepare")
