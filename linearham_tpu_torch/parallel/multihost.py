"""Multi-process data parallelism over clonal families.

Counterpart of linearham_tpu/parallel/multihost.py.  Processes form one
``torch.distributed`` group, one process per GPU; ``initialize`` starts it
(from torchrun's ``env://`` variables, or with the address, world size and
rank given explicitly), and two patterns run on it:

* One mesh over every rank (``global_family_mesh``): every process passes
  the same task list to ``run_repertoire(mesh=...)``, which shards each
  bucket over the (fam, trees) mesh and hands every rank the whole
  result::

      multihost.initialize()                        # under torchrun
      mesh = multihost.global_family_mesh(n_tree_shards=1)
      results = run_repertoire(tasks, mesh=mesh)

* Fully independent processes: each takes its ``process_slice`` of the
  family list and runs ``run_repertoire`` alone on its own GPU; only the
  repertoire-wide summary crosses processes, a
  ``torch.distributed.all_reduce`` of four scalars
  (``pooled_repertoire_summary_multiprocess``)::

      mine = multihost.process_slice(all_families)
      ...run_repertoire over ``mine``, then
      multihost.pooled_repertoire_summary_multiprocess(logliks, rbs)

Without a process group every helper acts as one process of one, so
single-process callers need no branch.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from linearham_tpu_torch.parallel.mesh import (GROUP_TIMEOUT, FamilyMesh,
                                               local_cuda_index, make_mesh,
                                               pooled_repertoire_summary,
                                               span)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[timedelta] = None) -> None:
    """Start the default process group (a no-op if one is running).

    With no arguments it reads torchrun's ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``backend`` defaults to
    NCCL when CUDA is present, else gloo; under NCCL the process first
    takes its GPU (``LOCAL_RANK``, else the rank modulo the GPUs).  Ranks
    that share one GPU must use gloo: NCCL refuses them.  ``timeout``
    (default ``mesh.GROUP_TIMEOUT``) bounds every collective of the group.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_cuda_index(rank or 0))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=timeout or GROUP_TIMEOUT)


def global_family_mesh(n_tree_shards: int = 1,
                       device=None) -> FamilyMesh:
    """A (world / n_tree_shards, n_tree_shards) mesh over every rank.

    ``n_tree_shards`` > 1 also splits each family's trees over that many
    GPUs (for a repertoire of few, very large families).  ``device``: every
    rank's device (e.g. "cpu"); by default each rank's GPU, raising
    without CUDA.
    """
    world = _world()[1]
    if world % n_tree_shards:
        raise ValueError(f"{world} devices do not split into "
                         f"{n_tree_shards} tree shards")
    return make_mesh(world // n_tree_shards, n_tree_shards,
                     devices=None if device is None else [device] * world)


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
    return list(items[span(len(items), p, n)])


def pooled_repertoire_summary_multiprocess(logliks_by_family,
                                           rb_by_family) -> dict:
    """Repertoire-wide pooled statistics across every process.

    Each process passes its own families' log-likelihood and RevBayes
    log-likelihood arrays (ragged is fine).  Each holds whole families, so
    this is ``mesh.pooled_repertoire_summary`` on a (world, 1) mesh over
    the default group: four scalar partials -- trees, sum of LogWeight,
    families, sum of per-family importance-weight ESS -- summed with one
    ``all_reduce`` (on the GPU for an NCCL group).  Every process returns
    the same summary: the total tree count, the pooled mean LogWeight and
    the mean family ESS.  A family with no trees adds nothing (its ESS is
    undefined).
    """
    rank, world = _world()
    group = dist.group.WORLD if world > 1 else None
    nccl = group is not None and dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl \
        else torch.device("cpu")
    mesh = FamilyMesh(shape={"fam": world, "trees": 1}, rank=rank,
                      device=device, mesh_group=group)
    return pooled_repertoire_summary(mesh, logliks_by_family, rb_by_family)
