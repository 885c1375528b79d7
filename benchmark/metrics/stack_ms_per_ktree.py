"""``stack_ms_per_ktree``: the program's ``stack_families`` stage, summed over the window's
jobs, in milliseconds per 1,000 trees (parallel/repertoire: host prep of the bucket and ops/pruning_cuda.stack_schedules)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "repertoire"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold"]


def read(run):
    return stage_ms_per_ktree(run, "stack_families")
