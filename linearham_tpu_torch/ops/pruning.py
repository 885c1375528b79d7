"""Felsenstein pruning over one-slot-per-internal-node tree batches, in torch.

Counterpart of linearham_tpu/ops/pruning.py, with the tree axis written out
(``[T, ...]`` leading every argument) where the JAX package vmaps.  Trees are
``io.newick.TreeBatch`` arrays: every tip has exactly one parent edge, so
all tip messages are one batched eigenbasis product and one multiplicative
scatter into their parent slots; the internal edges follow in post-order.
Every internal node keeps its own slot, which is what the downward passes of
``ops/asr.py`` need (the slot-reuse schedule walk of ``ops/pruning_cuda.py``
overwrites finished partials).

Messages go through the GTR eigenbasis, ``U @ (exp(lam * t * r) * (Uinv @
partial))``, are clamped at 0 after the product, and each written slot is
max-renormalized per (rate, site) with the log-scale accumulated (a zero
maximum divides by 1).  Tip code >= 4 (N) is an all-ones partial.  This is
plain torch on every device: the JAX original is jnp code that reaches no
Pallas kernel.
"""

from __future__ import annotations

import torch

from linearham_tpu_torch.ops.gtr import GTREigen


def tip_onehot(tip_states: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One-hot tip partials [T, n_tips, 4, X]; ambiguous (>=4) rows are ones."""
    codes = torch.arange(4, device=tip_states.device)[:, None]
    s = tip_states[:, :, None, :]
    return ((s == codes) | (s >= 4)).to(dtype)


def _renormalize(upd: torch.Tensor):
    """Max-normalize over the state axis (-2); returns (partial, log-scale)."""
    m = upd.amax(dim=-2, keepdim=True)
    m = torch.where(m > 0, m, torch.ones_like(m))
    return upd / m, torch.log(m.squeeze(-2))


def compute_partials(
    eig: GTREigen,              # u/u_inv [T,4,4], lam [T,4]
    rates: torch.Tensor,        # [T, R]
    tip_states: torch.Tensor,   # [T, n_tips, X] xMSA codes in tip-slot order
    tip_parent: torch.Tensor,   # [T, n_tips] internal slot ids
    tip_length: torch.Tensor,   # [T, n_tips]
    edge_child: torch.Tensor,   # [T, E] internal slots (post-order)
    edge_parent: torch.Tensor,  # [T, E]
    edge_length: torch.Tensor,  # [T, E]
    n_slots: int,               # internal slots incl. the sink
):
    """Upward (Felsenstein) pass for a batch of trees.

    Returns (partials [T, n_slots, R, 4, X], scale [T, R, X]): each slot
    holds the likelihood of the data below it conditional on its state,
    max-normalized, with the log-scale accumulated per (rate, site).
    Padding edges and tips point at the sink slot (``n_slots - 1``).
    """
    dtype = eig.u.dtype
    T, n_tips, X = tip_states.shape
    R = rates.shape[1]
    ar = torch.arange(T, device=tip_states.device)

    # Tips: every tip message at once, multiplied into its parent slot.
    expd_tip = torch.exp(eig.lam[:, None, None, :] * (
        tip_length[:, :, None] * rates[:, None, :])[..., None])  # [T,n,R,4]
    w = torch.einsum("tij,tnjx->tnix", eig.u_inv,
                     tip_onehot(tip_states, dtype))
    w = w[:, :, None] * expd_tip[..., None]                     # [T,n,R,4,X]
    msg = torch.clamp(torch.einsum("tij,tnrjx->tnrix", eig.u, w), min=0.0)
    partials = torch.ones((T * n_slots, R * 4 * X), dtype=dtype,
                          device=tip_states.device)
    flat_parent = (ar[:, None] * n_slots + tip_parent.long()).reshape(-1, 1)
    partials.scatter_reduce_(
        0, flat_parent.expand(T * n_tips, R * 4 * X),
        msg.reshape(T * n_tips, R * 4 * X), "prod", include_self=True)
    partials, log_m = _renormalize(partials.reshape(T, n_slots, R, 4, X))
    scale = log_m.sum(dim=1)                                    # [T, R, X]

    # Internal edges, post-order.
    expd_edge = torch.exp(eig.lam[:, None, None, :] * (
        edge_length[:, :, None] * rates[:, None, :])[..., None])  # [T,E,R,4]
    child_idx, parent_idx = edge_child.long(), edge_parent.long()
    for e in range(edge_child.shape[1]):
        child, parent = child_idx[:, e], parent_idx[:, e]
        w = torch.einsum("tij,trjx->trix", eig.u_inv, partials[ar, child])
        w = w * expd_edge[:, e, :, :, None]
        msg = torch.clamp(torch.einsum("tij,trjx->trix", eig.u, w), min=0.0)
        upd, log_m = _renormalize(partials[ar, parent] * msg)
        partials[ar, parent] = upd
        scale = scale + log_m
    return partials, scale


def per_rate_root_loglik(partials: torch.Tensor, scale: torch.Tensor,
                         pi: torch.Tensor,
                         root_slot: torch.Tensor) -> torch.Tensor:
    """Per-(rate, site) log-likelihood [T, R, X] at the root."""
    root = partials[torch.arange(partials.shape[0], device=partials.device),
                    root_slot.long()]                           # [T,R,4,X]
    return torch.log(torch.einsum("ti,trix->trx", pi, root)) + scale


def site_log_likelihoods(eig: GTREigen, pi, rates, tip_states, tip_parent,
                         tip_length, edge_child, edge_parent, edge_length,
                         root_slot, n_slots: int) -> torch.Tensor:
    """Per-site rate-mixed log-likelihood [T, X] for a batch of trees."""
    partials, scale = compute_partials(
        eig, rates, tip_states, tip_parent, tip_length, edge_child,
        edge_parent, edge_length, n_slots)
    per_rate = per_rate_root_loglik(partials, scale, pi, root_slot)
    R = rates.shape[1]
    return torch.logsumexp(per_rate, dim=1) - torch.log(
        torch.tensor(float(R), dtype=per_rate.dtype, device=per_rate.device))
