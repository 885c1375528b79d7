"""``junction_scan_ms_per_ktree``: the program's ``junction_scan`` span
(the host's time to launch the per-row junction recursions of
``ops/forward.forward`` and of the FFBS sampler's backward walk), summed
over the window's jobs, in milliseconds per 1,000 trees."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "forward"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["igk-partition.cold"]


def read(run):
    return stage_ms_per_ktree(run, "junction_scan")
