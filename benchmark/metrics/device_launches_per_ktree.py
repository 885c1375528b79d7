"""``device_launches_per_ktree``: device kernels in the traced window (the
profiler's count) per 1,000 trees the window completed."""

UNIT = "launches/ktree"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    if run.trace is None or run.trees == 0:
        return None
    return len(run.trace.kernels()) / (run.trees / 1e3)
