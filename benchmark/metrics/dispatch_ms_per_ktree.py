"""``dispatch_ms_per_ktree``: the program's ``dispatch`` stage, summed over the window's
jobs, in milliseconds per 1,000 trees (models/phylo_hmm: the device step launched from the host, per chunk)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "phylo_hmm"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "dispatch")
