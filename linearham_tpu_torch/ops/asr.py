"""Ancestral sequence reconstruction: joint posterior state sampling, in torch.

Counterpart of linearham_tpu/ops/asr.py, batched over a leading tree axis
where the JAX package vmaps.  Given trees, GTR+Gamma parameters and the
alignment (naive row set to a sampled naive sequence), one call draws one
joint sample of every ancestral state at every site of every tree:

  1. per site, the rate category, proportional to its root likelihood;
  2. the root state, from pi x root partial at that rate;
  3. edges root-down (reverse post-order): each child from
     P(t * r_site)[parent state, .] x child partial;
  4. tips in one draw; observed bases win (their one-hot partial leaves no
     other state), ambiguous tips are resolved by sampling.

Draws use the port's Gumbel-max ``ops.ffbs.categorical`` on an explicit
``torch.Generator``, so samples are reproducible per seed but are not the
JAX package's draws (threefry vs Philox): compare them distributionally.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from linearham_tpu_torch.ops.ffbs import categorical
from linearham_tpu_torch.ops.gtr import GTREigen
from linearham_tpu_torch.ops.pruning import (compute_partials,
                                            per_rate_root_loglik, tip_onehot)


class ASRSample(NamedTuple):
    internal_states: torch.Tensor   # [T, n_slots, X] int codes
    tip_states: torch.Tensor        # [T, n_tips, X] (ambiguities resolved)
    rate_idx: torch.Tensor          # [T, X] sampled rate category per site


def _log_clamped(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=0.0))


def _at_rate(partial: torch.Tensor, rate_idx: torch.Tensor) -> torch.Tensor:
    """[T, R, 4, X] partials at each site's rate -> [T, 4, X]."""
    T, _, _, X = partial.shape
    idx = rate_idx[:, None, None, :].expand(T, 1, 4, X)
    return torch.gather(partial, 1, idx)[:, 0]


def _transition_rows(eig: GTREigen, parent_states: torch.Tensor,
                     expd: torch.Tensor) -> torch.Tensor:
    """P(t)[parent_state, .] per tree and site, clamped at 0.

    parent_states: [T, ..., X]; expd: eigenvalue scalings broadcastable to
    [T, ..., X, 4].  Returns [T, ..., X, 4]."""
    T = parent_states.shape[0]
    lead = (T,) + (1,) * (parent_states.dim() - 1)
    ar = torch.arange(T, device=parent_states.device).reshape(lead)
    u_rows = eig.u[ar, parent_states.long()]                # [T, ..., X, 4]
    w = (u_rows * expd).reshape(T, -1, 4)
    pvec = torch.einsum("tnk,tkc->tnc", w, eig.u_inv)
    return torch.clamp(pvec, min=0.0).reshape(u_rows.shape)


def sample_ancestral_states(
    generator: torch.Generator,
    eig: GTREigen,               # u/u_inv [T,4,4], lam [T,4]
    pi: torch.Tensor,            # [T, 4]
    rates: torch.Tensor,         # [T, R]
    tip_states: torch.Tensor,    # [T, n_tips, X] with >= 4 == ambiguous
    tip_parent: torch.Tensor,    # [T, n_tips]
    tip_length: torch.Tensor,    # [T, n_tips]
    edge_child: torch.Tensor,    # [T, E]
    edge_parent: torch.Tensor,   # [T, E]
    edge_length: torch.Tensor,   # [T, E]
    root_slot: torch.Tensor,     # [T]
    n_slots: int,
) -> ASRSample:
    """One joint ancestral sample per tree of the batch."""
    T, _, X = tip_states.shape
    device = tip_states.device
    ar = torch.arange(T, device=device)
    partials, scale = compute_partials(
        eig, rates, tip_states, tip_parent, tip_length, edge_child,
        edge_parent, edge_length, n_slots)

    # 1. Rate category per site.
    per_rate = per_rate_root_loglik(partials, scale, pi, root_slot)
    rate_idx = categorical(generator, per_rate.transpose(1, 2))   # [T, X]
    lam_r = eig.lam[:, None, :] * torch.gather(rates, 1, rate_idx)[..., None]

    # 2. Root state per site.
    root = root_slot.long()
    root_partial = _at_rate(partials[ar, root], rate_idx)         # [T, 4, X]
    root_logits = torch.log(pi)[:, None, :] \
        + _log_clamped(root_partial.transpose(1, 2))
    states = torch.zeros((T, n_slots, X), dtype=torch.long, device=device)
    states[ar, root] = categorical(generator, root_logits)

    # 3. Internal edges, root-down.
    child_idx, parent_idx = edge_child.long(), edge_parent.long()
    for e in range(edge_child.shape[1] - 1, -1, -1):
        child, parent = child_idx[:, e], parent_idx[:, e]
        pvec = _transition_rows(
            eig, states[ar, parent],
            torch.exp(lam_r * edge_length[:, e, None, None]))     # [T, X, 4]
        child_partial = _at_rate(partials[ar, child], rate_idx)
        logits = torch.log(pvec) + _log_clamped(child_partial.transpose(1, 2))
        states[ar, child] = categorical(generator, logits)

    # 4. Tips in one draw: observed bases win through their one-hot.
    parent_states = states[ar[:, None], tip_parent.long()]        # [T, n, X]
    pvec = _transition_rows(
        eig, parent_states,
        torch.exp(lam_r[:, None] * tip_length[:, :, None, None]))
    onehot = tip_onehot(tip_states, pvec.dtype).transpose(2, 3)   # [T,n,X,4]
    tip_sampled = categorical(generator,
                              torch.log(pvec) + _log_clamped(onehot))
    return ASRSample(internal_states=states, tip_states=tip_sampled,
                     rate_idx=rate_idx)
