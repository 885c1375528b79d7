"""``host_prepare_ms_per_ktree``: the program's ``host_prepare`` stage, summed over the window's
jobs, in milliseconds per 1,000 trees (pipeline/run.prepare_ensemble: the native Newick parse, io/schedule, ops/gtr)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "pipeline"
SOURCE = "program_span"
MOVES = "trees_per_s"
WORKLOADS = ["ch103.serve"]


def read(run):
    return stage_ms_per_ktree(run, "host_prepare")
