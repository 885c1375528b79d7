"""``build_s_per_family``: the ``build_hmm`` stage of the repertoire CLI
(``compiler/family_cache.cached_phylo_hmm``: the germline directory's
parse, the state space, the xMSA, the transitions), seconds per family
built in the window."""

UNIT = "s"
LAYER = "compiler"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold"]


def read(run):
    jobs = [j for j in run.jobs if "build_hmm" in j.stages]
    families = sum(j.families for j in jobs)
    if not families:
        return None
    return sum(j.stages["build_hmm"] for j in jobs) / families
