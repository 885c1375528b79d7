"""``window_trees_per_s``: the trees of every job of the traced window
over the jobs' time, as ``trees_per_s`` counts them, read from the traced
run (the profiler on).  It stands per layer in the cells where the
window's rate follows the host's other load by more than the largest
bound can hold (PERF.md §2), so that their rate is still reported; their
end-to-end metrics are ``setup_s`` and ``device_memory_peak_mb``."""

UNIT = "trees/s"
LAYER = "job loop"
SOURCE = "host_clock"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "igk-partition.cold", "partition.serve"]


def read(run):
    if not run.trees or run.window_s <= 0:
        return None
    return run.trees / run.window_s
