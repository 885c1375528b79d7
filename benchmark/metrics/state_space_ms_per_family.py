"""``state_space_ms_per_family``: the program's ``state_space`` span (the
state space and its transition tables, ``compiler/state_space`` and
``compiler/transitions``, inside the cold family build's ``compile``),
milliseconds per family of the window's jobs that report it."""

UNIT = "ms"
LAYER = "compiler"
SOURCE = "program_span"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["igk-partition.cold"]


def read(run):
    jobs = [j for j in run.jobs if "state_space" in j.stages]
    families = sum(j.families for j in jobs)
    if not families:
        return None
    return sum(j.stages["state_space"] for j in jobs) * 1e3 / families
