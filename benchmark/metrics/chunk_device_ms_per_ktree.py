"""``chunk_device_ms_per_ktree``: the program's ``chunk_device`` spans,
summed over the window's jobs, in milliseconds per 1,000 trees: CUDA-event
time on the card from before a chunk's (a bucket's) first host-to-device
copy to its results' landing on the host (``pipeline/run.py``,
``parallel/mesh.multi_family_step``)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "phylo_hmm"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "chunk_device")
