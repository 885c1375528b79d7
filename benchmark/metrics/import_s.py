"""``import_s``: seconds from before the first import of torch to the end
of the first CUDA call: the imports of torch and of linearham_tpu_torch's
modules that the traffic's entry loads, and the CUDA context.  Taken by
the benchmark's clock in set-up."""

UNIT = "s"
LAYER = "start-up"
SOURCE = "host_clock"
MOVES = "setup_s"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    return run.import_s
