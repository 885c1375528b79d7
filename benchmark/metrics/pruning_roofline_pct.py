"""``pruning_roofline_pct``: the Felsenstein pruning kernels' share of
their roofline over the traced window.

The time is the profiler's device time of every kernel whose name matches
``KERNEL_PATTERN``.  The work is counted from the shapes of the trees the
benchmark generated (rooted binary trees over the family's tips, one per
posterior sample), never from the port's schedule, so it reads the same
whatever kernel computes it.  Per tree, with R rate categories and X
sites (xMSA columns, one per (naive base, alignment column) pair):

* per edge and rate, one transition matrix P(t r) = U diag(exp(lam t r))
  U^-1: 4 products and 4 exponentials, 16 products, then 64 products and
  48 sums, ``FLOP_P`` = 136;
* per site, rate and internal node, the child products: a child that is a
  tip gives a column of P (no arithmetic), an internal child a 4x4 by 4
  product (16 products, 12 sums), and the messages of a node's two
  children meet in 4 products;
* per site and rate, the root mix over pi (4 products, 3 sums) and the
  sum over the rate categories (1), ``FLOP_ROOT`` = 8.

Bytes count each input read once and each output written once: per tree
its edges (a length and two int32 node indices), its 10 model parameters
and R rates and its X site log-likelihoods, each float of the run's
precision (4 bytes in f32, 8 in f64); per family and job the xMSA codes
(one byte a tip and column).

The bound is the larger of the work over the peak of the run's precision
outside the tensor cores (67 TFLOP/s in float32, 34 in float64) and the
bytes over 3.35 TB/s, the published peaks of one H100 SXM at its 700 W
power limit; the harness prints the card's power limit beside the metric
and which of the two binds.
"""

UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "device_memory_peak_mb"
WORKLOADS = ["partition.cold", "ch103.serve", "partition.serve"]

KERNEL_PATTERN = "pruning_kernel"
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
FLOAT_BYTES = {"f32": 4, "f64": 8}
PEAK_BYTES = 3.35e12
FLOP_P = 136
FLOP_MATVEC = 28
FLOP_JOIN = 4
FLOP_ROOT = 8


def tree_work(tips: int, cols: int, rates: int, precision: str = "f32"):
    """(FLOP, bytes) of one rooted binary tree over ``tips`` tips."""
    edges = 2 * tips - 2
    internal = tips - 1
    internal_children = internal - 1
    per_site = (FLOP_MATVEC * internal_children + FLOP_JOIN * internal
                + FLOP_ROOT)
    flops = rates * edges * FLOP_P + rates * cols * per_site
    fb = FLOAT_BYTES[precision]
    nbytes = edges * (fb + 8) + (10 + rates) * fb + cols * fb
    return flops, nbytes


def work(ensembles, precision: str = "f32"):
    """Total (FLOP, bytes) of the ensembles a window ran: each a dict of
    trees, tips, cols and rates."""
    flops = nbytes = 0.0
    for e in ensembles:
        f, b = tree_work(e["tips"], e["cols"], e["rates"], precision)
        flops += e["trees"] * f
        nbytes += e["trees"] * b + e["tips"] * e["cols"]
    return flops, nbytes


def bound_s(flops: float, nbytes: float, precision: str = "f32"):
    """(the least seconds the card could take, what binds)."""
    ops, mem = flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def read(run):
    if run.trace is None or not run.ensembles:
        return None
    spent = sum(b - a for name, a, b in run.trace.kernels()
                if KERNEL_PATTERN in name)
    if spent <= 0:
        return None
    least, binds = bound_s(*work(run.ensembles, run.precision),
                           run.precision)
    run.notes["pruning_roofline"] = (
        f"bound {least * 1e3:.3f} ms ({binds} bind, {run.precision}) over "
        f"{spent * 1e3:.3f} ms of kernel time; card {run.card}")
    return 100.0 * least / spent
