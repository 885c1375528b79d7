"""The repertoire over a (fam, trees) mesh of GPUs.

Counterpart of linearham_tpu/parallel/mesh.py.  The model is tiny (a
family's germline tensors are KB-scale); all scaling is data parallelism
over two axes:

  fam    clonal families of a bucket, split contiguously over the mesh rows
  trees  each family's posterior trees, split contiguously over the columns

One process per GPU (SPMD): every rank holds the same task list, runs its
share of each bucket -- ONE pruning launch over its blocks, each block a
family plus a contiguous tree range -- decodes that share, and gathers the
decoded results, so every rank ends with the whole bucket in task order,
as the JAX package's single controller does.  The processes talk through
``torch.distributed`` (NCCL between GPUs, gloo on the CPU or when several
ranks share one card, which NCCL refuses); ``multihost.initialize`` starts
the group.

What differs from the JAX module, and why:

* ``multi_family_step`` is one stacked kernel launch over ragged blocks
  (``models.step``, through ``ops.pruning_cuda.stack_schedules``), then
  each block's own post-pruning step at its own shapes, where the JAX
  package vmaps one padded step.  So ``shard_family_batch`` cuts blocks
  instead of padding families and trees up to multiples of the mesh (JAX
  ``parallel/repertoire.py:303-324``); a rank whose share is empty
  launches nothing but joins every collective.
* Random draws: each block samples from its own ``torch.Generator``, seeded
  from (seed, the family's index in the task list, and the first tree of
  the block when that is not 0).  A mesh that splits only families draws
  exactly what the unsharded run draws.
* ``sharded_pipeline`` runs the share now instead of returning a jitted
  function, and gathers with ``all_gather_object`` (pickled per-block
  log-likelihoods and annotations).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from linearham_tpu_torch.models.decode import Annotation
from linearham_tpu_torch.models.step import Prepared, stack_blocks, step_blocks
from linearham_tpu_torch.ops.ffbs import path_to_numpy
from linearham_tpu_torch.utils import profiling

AXIS_NAMES = ("fam", "trees")
# Every process group of a mesh waits at most this long in a collective: a
# rank that died or skipped one ends the run instead of hanging it.
GROUP_TIMEOUT = timedelta(minutes=5)


@dataclass
class FamilyBlock:
    """A family of a bucket and a contiguous range of its trees."""

    index: int          # the family's position in run_repertoire's tasks
    task: Any           # parallel.repertoire.FamilyTask
    trees: slice        # [start, stop) of task.samples

    @property
    def n_trees(self) -> int:
        return self.trees.stop - self.trees.start


@dataclass
class FamilyMesh:
    """A (fam, trees) grid of ranks; this process is one cell of it.

    ``trees_group`` joins this rank's row (the ranks that share its
    families), ``mesh_group`` every rank of the mesh; both are None for a
    mesh of one without a process group, and then no collective runs.
    """

    shape: Dict[str, int]
    rank: int
    device: torch.device
    trees_group: Optional[Any] = None
    mesh_group: Optional[Any] = None
    axis_names: ClassVar[Tuple[str, str]] = AXIS_NAMES

    @property
    def size(self) -> int:
        return self.shape["fam"] * self.shape["trees"]

    @property
    def coords(self) -> Tuple[int, int]:
        """(fam index, trees index) of this rank."""
        return divmod(self.rank, self.shape["trees"])

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: this rank's GPU under NCCL, else the
        CPU."""
        if self.mesh_group is not None and \
                dist.get_backend(self.mesh_group) == "nccl":
            return self.device
        return torch.device("cpu")


def local_cuda_index(rank: int) -> int:
    """This process's GPU: ``LOCAL_RANK`` (set by torchrun), else the rank
    modulo the visible GPUs."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None \
        else rank % torch.cuda.device_count()


def _default_device(rank: int) -> torch.device:
    """This rank's GPU; raises without one (the CPU is used only when
    named, as ``utils/runtime.py:resolve_device`` does)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; name the ranks' devices "
            "(devices=['cpu', ...]) to run the mesh on the CPU")
    return torch.device("cuda", local_cuda_index(rank))


def local_mesh(device) -> FamilyMesh:
    """A mesh of one on ``device`` that runs no collective."""
    return FamilyMesh(shape={"fam": 1, "trees": 1}, rank=0,
                      device=torch.device(device))


def make_mesh(n_fam: int, n_trees: int,
              devices: Optional[Sequence] = None) -> Optional[FamilyMesh]:
    """A (fam, trees) mesh over ranks 0 .. n_fam*n_trees - 1 of the process
    group; rank r sits at (r // n_trees, r % n_trees) on ``devices[r]``
    (default: ``cuda:{local rank}``, raising without CUDA; ranks may name
    the same device).

    Every rank of the group must call it, in the same order as its other
    ``new_group`` calls; a rank outside the mesh gets None.  Every group
    waits at most ``GROUP_TIMEOUT`` in a collective.  Without a
    process group it is a mesh of one: (1, 1) is legal and runs no
    collective.
    """
    n = n_fam * n_trees
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    rank = dist.get_rank() if initialized else 0
    row = whole = None
    if initialized:
        rows = [dist.new_group(list(range(f * n_trees, (f + 1) * n_trees)),
                               timeout=GROUP_TIMEOUT) for f in range(n_fam)]
        whole = dist.new_group(list(range(n)), timeout=GROUP_TIMEOUT)
        if rank >= n:
            return None
        row = rows[rank // n_trees]
    device = torch.device(devices[rank]) if devices is not None \
        else _default_device(rank)
    return FamilyMesh(shape={"fam": n_fam, "trees": n_trees}, rank=rank,
                      device=device, trees_group=row, mesh_group=whole)


def span(n: int, part: int, n_parts: int) -> slice:
    """The ``part``-th of ``n_parts`` contiguous ranges of ``range(n)``,
    remainders to the leading parts."""
    base, rem = divmod(n, n_parts)
    start = part * base + min(part, rem)
    return slice(start, start + base + (1 if part < rem else 0))


def shard_family_batch(mesh: FamilyMesh,
                       blocks: Sequence[FamilyBlock]) -> List[FamilyBlock]:
    """This rank's share of a bucket: its contiguous run of the families
    (over "fam"), and of each its contiguous range of trees (over
    "trees").  Empty ranges are dropped; nothing is padded."""
    f, t = mesh.coords
    share = []
    for b in blocks[span(len(blocks), f, mesh.shape["fam"])]:
        part = span(b.n_trees, t, mesh.shape["trees"])
        if part.stop > part.start:
            share.append(FamilyBlock(
                b.index, b.task, slice(b.trees.start + part.start,
                                       b.trees.start + part.stop)))
    return share


def block_generator(seed: int, block: FamilyBlock,
                    device: torch.device) -> torch.Generator:
    """The block's own generator: seeded from (seed, family index), plus
    the block's first tree when that is not 0."""
    key = [seed, block.index] + ([block.trees.start]
                                 if block.trees.start else [])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))
    return gen


def multi_family_step(blocks: Sequence[FamilyBlock], num_rates: int,
                      seed: int, device: torch.device,
                      dtype: torch.dtype) -> list:
    """ONE pruning launch over every block's trees, then each block's
    post-pruning step (naive prior, region emissions, forward, FFBS from
    ``block_generator``) on its slice ``site_ll[trees_b, :X_b]``, through
    ``models.step``.

    Returns, per block, (log-likelihoods [n_trees] float64, sampled path
    with numpy leaves).  Spans: stack_families (host prep and stacking),
    device_transfer, device_step (the launch and the blocks' steps, until
    their results landed), and on the card chunk_device (CUDA events from
    before the first host-to-device copy to the last result's landing).
    Counter: chunks.
    """
    with profiling.span("stack_families"):
        host = stack_blocks([Prepared.of(b.task.hmm, b.task.samples[b.trees],
                                         num_rates) for b in blocks])
    span = profiling.cuda_span("chunk_device", device)
    with profiling.span("device_transfer"):
        inputs = host.to_device(device, dtype)
    with profiling.span("device_step"):
        results = step_blocks(
            inputs, [block_generator(seed, b, device) for b in blocks], span)
        for _, _, done in results:
            done()
    profiling.count("chunks")
    return [(loglik_h.numpy().astype(np.float64), path_to_numpy(path_h))
            for loglik_h, path_h, _ in results]


def sharded_pipeline(mesh: FamilyMesh, blocks: Sequence[FamilyBlock],
                     num_rates: int, seed: int, dtype: torch.dtype
                     ) -> List[Tuple[np.ndarray, List[Annotation]]]:
    """Run this rank's share of a bucket (``blocks``: whole families, in
    task order), decode it here, and gather every rank's share.

    Returns, on every rank and for every block of ``blocks``, the family's
    (log-likelihoods [T], annotations [T]).  Spans: those of
    ``multi_family_step``, then decode (decode and, on a mesh with a
    process group, gather inside it).
    """
    share = shard_family_batch(mesh, blocks)
    stepped = multi_family_step(share, num_rates, seed, mesh.device,
                                dtype) if share else []
    with profiling.span("decode"):
        pieces = [(b.index, b.trees.start, loglik,
                   b.task.hmm.decode_batch(path))
                  for b, (loglik, path) in zip(share, stepped)]
        if mesh.mesh_group is not None:
            with profiling.span("gather"):
                gathered = [None] * mesh.size
                dist.all_gather_object(gathered, pieces,
                                       group=mesh.mesh_group)
                pieces = [p for rank_pieces in gathered for p in rank_pieces]
        by_family: Dict[int, list] = {}
        for index, start, loglik, anns in sorted(pieces,
                                                 key=lambda p: p[:2]):
            by_family.setdefault(index, []).append((loglik, anns))
        out = []
        for b in blocks:
            parts = by_family.get(b.index, [])
            loglik = np.concatenate([p[0] for p in parts]) if parts \
                else np.zeros(0)
            anns = [a for p in parts for a in p[1]]
            if loglik.shape != (b.n_trees,) or len(anns) != b.n_trees:
                raise RuntimeError(
                    f"family {b.index}: gathered {loglik.shape[0]} of "
                    f"{b.n_trees} trees")
            out.append((loglik, anns))
    return out


def _all_reduce(t: torch.Tensor, op, group) -> None:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)


def pooled_repertoire_summary(mesh: FamilyMesh, loglik, rb_loglik) -> dict:
    """Repertoire-wide pooled statistics, reduced over the mesh.

    ``loglik`` and ``rb_loglik`` are this rank's blocks: one 1-D array or
    tensor per family of its "fam" share (a [f_l, t_l] tensor is one row
    per family), each holding its "trees" range, possibly empty; every
    rank of a "trees" row passes the same families in the same order.

    Per family, a distributed softmax: the max of the log-weights
    ``lw = loglik - rb_loglik`` by all_reduce(MAX) over the "trees" group,
    the sums of ``e = exp(lw - max)`` and ``e**2`` by all_reduce(SUM) over
    the same group, and the importance-weight ESS ``(sum e)**2 / sum e**2``.
    Then trees, the sum of lw, families and the sum of ESS by one
    all_reduce(SUM) over the mesh, each family counted once (by its
    trees-rank 0).  Collectives run on ``mesh.comm_device``; every rank
    returns the same summary: total trees, pooled mean LogWeight, mean
    family ESS.  A family with no trees adds nothing.
    """
    dev = mesh.comm_device

    def vec(a):
        return torch.as_tensor(a).to(dev, torch.float64).reshape(-1)

    lws = [vec(ll) - vec(rb) for ll, rb in zip(loglik, rb_loglik)]
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    n_fam = sum_ess = zero
    if lws:
        m = torch.stack([lw.max() if lw.numel() else zero - torch.inf
                         for lw in lws])
        _all_reduce(m, dist.ReduceOp.MAX, mesh.trees_group)
        sums = torch.stack([torch.stack([e.sum(), (e * e).sum()]) for e in
                            (torch.exp(lw - mf) for lw, mf in zip(lws, m))])
        _all_reduce(sums, dist.ReduceOp.SUM, mesh.trees_group)
        if mesh.coords[1] == 0:
            have = sums[:, 1] > 0
            n_fam = have.sum().to(torch.float64)
            sum_ess = torch.where(have, sums[:, 0] ** 2 / sums[:, 1],
                                  zero).sum()
    partial = torch.stack([
        zero + sum(lw.numel() for lw in lws),
        sum((lw.sum() for lw in lws), zero), n_fam, sum_ess])
    _all_reduce(partial, dist.ReduceOp.SUM, mesh.mesh_group)
    n_trees, sum_lw, n_fam, sum_ess = partial.tolist()
    return {
        "n_trees": float(n_trees),
        "mean_logweight": sum_lw / n_trees if n_trees else 0.0,
        "mean_family_ess": sum_ess / n_fam if n_fam else 0.0,
    }
