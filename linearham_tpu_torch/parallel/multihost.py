"""Host-side helpers for a repertoire spread over several processes.

Counterpart of the host-side half of linearham_tpu/parallel/multihost.py.
Families never communicate, so the pattern is fully independent execution:
each process takes its ``process_slice`` of the family list and runs
``run_repertoire`` on its own GPU; only the repertoire-wide summary needs
one reduction across processes, a ``torch.distributed.all_reduce`` of four
scalars.  The processes form a group the usual way, with the address,
world size and rank given explicitly::

    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:29500", world_size=n, rank=r)
    mine = multihost.process_slice(all_families)
    ...run_repertoire over ``mine``, then
    multihost.pooled_repertoire_summary_multiprocess(logliks, rbs)

Without a process group every helper acts as one process of one, so
single-process callers need no branch.  The mesh half of the JAX module
(``initialize``, ``global_family_mesh``: sharding one stacked bucket over a
``(fam, trees)`` mesh of devices) is not ported here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_slice(items: Sequence, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> list:
    """The contiguous slice of ``items`` this process should load.

    Split evenly by process, remainders to the leading processes; the rank
    and world size default to the process group's.
    """
    rank, world = _world()
    p = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    base, rem = divmod(len(items), n)
    start = p * base + min(p, rem)
    return list(items[start:start + base + (1 if p < rem else 0)])


def pooled_repertoire_summary_multiprocess(logliks_by_family,
                                           rb_by_family) -> dict:
    """Repertoire-wide pooled statistics across every process.

    Each process passes its own families' log-likelihood and RevBayes
    log-likelihood arrays (ragged is fine).  Four scalar partials -- trees,
    sum of LogWeight, families, sum of per-family importance-weight ESS --
    are summed over the process group with one ``all_reduce`` (on the GPU
    for an NCCL group), so every process returns the same summary: the
    total tree count, the pooled mean LogWeight and the mean family ESS.
    A family with no trees adds nothing (its ESS is undefined).
    """
    partial = np.zeros(4)
    for ll, rb in zip(logliks_by_family, rb_by_family):
        lw = np.asarray(ll, float) - np.asarray(rb, float)
        if lw.size == 0:
            continue
        e = np.exp(lw - lw.max())
        partial += (lw.size, lw.sum(), 1, e.sum() ** 2 / (e * e).sum())

    if _world()[1] > 1:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.as_tensor(partial, dtype=torch.float64, device=device)
        dist.all_reduce(t)
        partial = t.cpu().numpy()

    n_trees, sum_lw, n_fam, sum_ess = partial
    return {
        "n_trees": float(n_trees),
        "mean_logweight": float(sum_lw / n_trees) if n_trees else 0.0,
        "mean_family_ess": float(sum_ess / n_fam) if n_fam else 0.0,
    }
