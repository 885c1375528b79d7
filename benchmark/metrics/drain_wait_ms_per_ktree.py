"""``drain_wait_ms_per_ktree``: the program's ``drain_wait`` span, summed
over the window's jobs, in milliseconds per 1,000 trees: the main thread's
wait, after its last dispatch, for the drain thread's decode and TSV write
(``pipeline/run.run_pipeline_arrays``)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "pipeline"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "drain_wait")
