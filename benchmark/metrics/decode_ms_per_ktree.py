"""``decode_ms_per_ktree``: the program's ``decode`` stage, summed over the window's
jobs, in milliseconds per 1,000 trees (models/decode: sampled paths to annotation columns (on the drain thread in the pipeline))."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "decode"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "decode")
