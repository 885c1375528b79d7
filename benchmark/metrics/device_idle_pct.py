"""``device_idle_pct``: the share of the traced window in which no device
operation ran: 100 less the union of kernel, copy and memset intervals
of the profiler's trace over the window's length."""

from benchmark.trace import busy_s

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / run.trace.window_s)
