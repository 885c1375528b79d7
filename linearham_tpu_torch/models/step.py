"""The one route from a batch of prepared trees to the pruning kernel and
back, for every caller: ``pipeline.run``'s chunks (one family, rows of its
prepared ensemble), ``parallel.mesh``'s bucket shares (several families),
``PhyloHMM``'s single-tree API and the measurement tools.

``Prepared.of`` prepares a family's trees on the host; ``stack_blocks``
stacks the blocks of one launch (``ops.pruning_cuda.stack_schedules``,
every index checked against the table the kernel reads); ``to_device``
makes pinned, non-blocking copies; ``launch`` is the ONE kernel launch;
``step_blocks`` launches, runs each block's post-pruning step with its own
generator and starts its results' copies to the host.  Callers time these
under spans of their own (``utils.profiling``); this module opens none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np
import torch

from linearham_tpu_torch.io.newick import batch_trees, parse_newick
from linearham_tpu_torch.io.schedule import PruningSchedule, build_schedule
from linearham_tpu_torch.io.trees_tsv import TreeSamples
from linearham_tpu_torch.ops.ffbs import SampledPath
from linearham_tpu_torch.ops.gtr import (GTREigen, gamma_category_rates_batch,
                                         gtr_eigen)
from linearham_tpu_torch.ops.pruning_cuda import (StackedSchedule,
                                                  site_log_likelihoods,
                                                  stack_schedules)
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.runtime import to_device

if TYPE_CHECKING:
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM


def prepare_ensemble(hmm: "PhyloHMM", samples: TreeSamples, num_rates: int,
                     rates: Optional[np.ndarray] = None):
    """Host-side ensemble prep: parse and schedule every tree, gamma rates
    (unless given), GTR eigenfactors.  Returns (PruningSchedule, GTREigen
    numpy, rates).

    The whole ensemble is parsed at once (one native batch call), so every
    chunk shares one schedule width and slot count.
    """
    from linearham_tpu_torch.io.native import parse_newicks_batch

    tb = parse_newicks_batch(samples.newicks, hmm.xmsa.labels)
    if tb is None:   # no native library: the Python parser, on the host
        tb = batch_trees([parse_newick(nw) for nw in samples.newicks],
                         hmm.xmsa.labels)
    if rates is None:
        rates = gamma_category_rates_batch(samples.alpha, num_rates)
    return build_schedule(tb), gtr_eigen(samples.er, samples.pi), rates


@dataclass
class Prepared:
    """A family's prepared trees, or rows of them: one block of a launch."""

    hmm: "PhyloHMM"
    sched: PruningSchedule
    eig: GTREigen              # numpy: u, u_inv [T, 4, 4], lam [T, 4]
    rates: np.ndarray          # [T, R]
    pi: np.ndarray             # [T, 4]

    @classmethod
    def of(cls, hmm: "PhyloHMM", samples: TreeSamples, num_rates: int,
           rates: Optional[np.ndarray] = None) -> "Prepared":
        """``samples`` prepared under ``hmm`` (``prepare_ensemble``)."""
        return cls(hmm, *prepare_ensemble(hmm, samples, num_rates, rates),
                   np.asarray(samples.pi))

    def rows(self, rows: slice) -> "Prepared":
        """Trees ``rows`` of these."""
        s = self.sched
        return Prepared(
            self.hmm,
            PruningSchedule(src=s.src[rows], penc=s.penc[rows],
                            length=s.length[rows], root=s.root[rows],
                            n_slots=s.n_slots),
            GTREigen(*(a[rows] for a in self.eig)), self.rates[rows],
            self.pi[rows])


@dataclass
class Launch:
    """One launch's inputs, on the host (``stack_blocks``) or the device
    (``to_device``), and which trees and sites of its output are each
    block's (``stacked.trees(b)``, ``stacked.n_cols[b]``)."""

    blocks: List[Prepared]
    stacked: StackedSchedule
    args: tuple        # site_log_likelihoods' arguments, in its order

    @property
    def pi(self):
        """The trees' stationary frequencies [T, 4]."""
        return self.args[1]

    def to_device(self, device: torch.device, dtype: torch.dtype) -> "Launch":
        """Pinned, non-blocking copies to ``device``, floats in ``dtype``.
        One block reads its model's resident xMSA rows: ``stack_schedules``
        gives one family back as it is, checked against those rows."""
        def put(a):
            return to_device(a, device, dtype, non_blocking=True)

        eig, pi, rates, codes, src, penc, length, root, n_slots = self.args
        codes = self.blocks[0].hmm.xmsa_rows if len(self.blocks) == 1 \
            else put(codes)
        return Launch(self.blocks, self.stacked, (
            GTREigen(*(put(a) for a in eig)), put(pi), put(rates), codes,
            put(src), put(penc), put(length), put(root), n_slots))


def stack_blocks(blocks: Sequence[Prepared]) -> Launch:
    """The blocks of one launch, stacked on the host: one schedule and one
    code table (``stack_schedules``, indices checked), the trees' GTR
    factors, pi and rates in block order."""
    stacked = stack_schedules([b.sched for b in blocks],
                              [b.hmm.xmsa.matrix for b in blocks])
    s = stacked.sched
    return Launch(list(blocks), stacked, (
        GTREigen(*(np.concatenate(parts)
                   for parts in zip(*(b.eig for b in blocks)))),
        np.concatenate([b.pi for b in blocks]),
        np.concatenate([b.rates for b in blocks]), stacked.codes, s.src,
        s.penc, s.length, s.root, s.n_slots))


def launch(inputs: Launch) -> torch.Tensor:
    """ONE pruning launch: site log-likelihoods [sum_b T_b, X_max]."""
    return site_log_likelihoods(*inputs.args)


def step_blocks(inputs: Launch, generators: Sequence[torch.Generator],
                span: Optional[profiling.CudaSpan] = None) -> list:
    """``launch``, then each block's post-pruning step (naive prior, region
    emissions, forward, FFBS from its generator) on its slice
    ``site_ll[trees_b, :X_b]``, then the start of its results' copies to
    the host.  ``span``, begun before the launch's first host-to-device
    copy, ends with the last block's copies.

    Returns per block (loglik, path, done): ``done()`` blocks until both
    landed (``_to_host``).
    """
    site_ll = launch(inputs)
    st, last = inputs.stacked, len(inputs.blocks) - 1
    out = []
    for f, (b, gen) in enumerate(zip(inputs.blocks, generators)):
        rows = st.trees(f)
        loglik, _, path = b.hmm.step_from_site_ll(
            site_ll[rows, :st.n_cols[f]], inputs.pi[rows], gen)
        out.append(_to_host(loglik, path, span if f == last else None))
    return out


def _to_host(loglik: torch.Tensor, path: SampledPath,
             span: Optional[profiling.CudaSpan] = None):
    """Start the device->host copies of one block's results.  Returns
    (loglik, path, done): ``done()`` blocks until the copies landed.
    ``span``, begun before the launch's first host-to-device copy, ends
    with the copies, and ``done()`` records it."""
    if loglik.device.type != "cuda":
        return loglik, path, lambda: None
    host = [None if a is None else a.to("cpu", non_blocking=True)
            for a in (loglik, *path)]
    if span is None:
        event = torch.cuda.Event()
        event.record()
        return host[0], SampledPath(*host[1:]), event.synchronize
    span.close()
    return host[0], SampledPath(*host[1:]), span.wait
