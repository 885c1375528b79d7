"""``gene_map_s_per_family``: the program's ``load_gene_map`` span (the
germline directory's parse, ``io/germline.load_gene_map``, inside the cold
family build of ``compiler/family_cache.cached_phylo_hmm``), seconds per
family of the window's jobs that report it."""

UNIT = "s"
LAYER = "compiler"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold"]


def read(run):
    jobs = [j for j in run.jobs if "load_gene_map" in j.stages]
    families = sum(j.families for j in jobs)
    if not families:
        return None
    return sum(j.stages["load_gene_map"] for j in jobs) / families
