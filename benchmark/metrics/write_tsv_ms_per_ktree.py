"""``write_tsv_ms_per_ktree``: the program's ``write_tsv`` stage, summed over the window's
jobs, in milliseconds per 1,000 trees (pipeline/run.write_tsv_rows and parallel/repertoire.write_family_output)."""

from benchmark.metrics import stage_ms_per_ktree

UNIT = "ms/ktree"
LAYER = "tsv writer"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]


def read(run):
    return stage_ms_per_ktree(run, "write_tsv")
