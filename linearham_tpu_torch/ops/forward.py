"""The V(D)J forward pass in torch.

Counterpart of linearham_tpu/ops/forward.py.  The state space is a chain
of regions; the junction recursions are the hot loop: one row-vector x
matrix product per junction site, batched over the posterior tree ensemble
into [T, S] x [S, S] matmuls.

Numerics: transitions stay in linear space; emissions arrive in log space;
the carried forward vector is kept max-normalized with an explicit per-tree
log-scale accumulator, the replacement for the reference's
SCALE_FACTOR=2^256 block scaling (src/HMM.cpp:254-354).

All functions take a leading tree axis T on emissions and return batched
log-likelihoods [T].
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from linearham_tpu_torch.utils import profiling


class ForwardCache(NamedTuple):
    """Max-normalized forward vectors kept for backward sampling."""

    vgerm_u: torch.Tensor            # [T, Gv]
    vd_u: torch.Tensor               # [R1, T, S1]
    dgerm_u: Optional[torch.Tensor]  # [T, Gd] (igh only)
    dj_u: Optional[torch.Tensor]     # [R2, T, S2] (igh only)
    jgerm_u: torch.Tensor            # [T, Gj]


def widen_cache(cache: ForwardCache, n: int) -> ForwardCache:
    """A one-tree cache seen as ``n`` identical trees (views, no copies), so
    one backward walk draws ``n`` paths from one forward pass."""

    def widen(a, axis):
        if a is None:
            return None
        shape = [-1] * a.dim()
        shape[axis] = n
        return a.expand(*shape)

    return ForwardCache(
        vgerm_u=widen(cache.vgerm_u, 0), vd_u=widen(cache.vd_u, 1),
        dgerm_u=widen(cache.dgerm_u, 0), dj_u=widen(cache.dj_u, 1),
        jgerm_u=widen(cache.jgerm_u, 0))


def _normalize(f_log: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split log-space values into (max-normalized linear, log-scale)."""
    m = f_log.amax(dim=-1)
    return torch.exp(f_log - m[..., None]), m


def _junction_scan(
    germ_u: torch.Tensor,          # [T, G]  normalized entry vector
    germ_scale: torch.Tensor,      # [T]
    germ_junction: torch.Tensor,   # [G, S]
    junction: torch.Tensor,        # [S, S]
    emis_log: torch.Tensor,        # [T, R, S]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the junction recursion; returns (rows_u [R,T,S], u_last, scale)."""
    if emis_log.shape[1] == 0:
        raise ValueError(
            "junction emission has zero site rows; the flexbounds collapse "
            "this junction window to nothing")
    u, scale = _normalize(torch.log(germ_u @ germ_junction) + emis_log[:, 0])
    scale = germ_scale + scale
    rows = [u]
    for r in range(1, emis_log.shape[1]):
        u, m = _normalize(torch.log(u @ junction) + emis_log[:, r])
        scale = scale + m
        rows.append(u)
    return torch.stack(rows), u, scale


def _germline_contract(
    junction_u: torch.Tensor,      # [T, S] last junction row, normalized
    junction_scale: torch.Tensor,  # [T]
    junction_germ: torch.Tensor,   # [S, G]
    static_log: torch.Tensor,      # [G] padding-transition etc. log terms
    emis_log: torch.Tensor,        # [T, G] germline (+padding) emissions
) -> Tuple[torch.Tensor, torch.Tensor]:
    u, m = _normalize(torch.log(junction_u @ junction_germ)
                      + static_log[None] + emis_log)
    return u, junction_scale + m


def forward(
    trans: Dict[str, torch.Tensor],
    emis: Dict[str, torch.Tensor],
    heavy: bool,
) -> Tuple[torch.Tensor, ForwardCache]:
    """Run the full forward chain.

    ``trans`` and ``emis`` carry the keys documented in
    linearham_tpu/ops/forward.py:forward.  Returns per-tree log-likelihood
    [T] and the forward cache for FFBS.

    Span (``utils.profiling``): junction_scan, once a call around the
    junction recursions (V-D, the D germline and D-J on igh; V-J on a light
    chain).  Counter: junction_rows, the junction rows scanned.
    """
    vgerm_u, vgerm_scale = _normalize(
        trans["vgerm_static_log"][None] + emis["vpadding"] + emis["vgerm"])

    with profiling.span("junction_scan"):
        vd_rows, last, scale = _junction_scan(
            vgerm_u, vgerm_scale, trans["vgerm_vd"], trans["vd"],
            emis["vd_junction"])
        dgerm_u = dj_rows = None
        if heavy:
            dgerm_u, dgerm_scale = _germline_contract(
                last, scale, trans["vd_dgerm"],
                torch.zeros_like(trans["dgerm_dj"][:, 0]), emis["dgerm"])
            dj_rows, last, scale = _junction_scan(
                dgerm_u, dgerm_scale, trans["dgerm_dj"], trans["dj"],
                emis["dj_junction"])
    profiling.count("junction_rows",
                    vd_rows.shape[0] + (dj_rows.shape[0] if heavy else 0))

    # The last junction's exit into the J germline: D-J on igh, V-J (whose
    # tables carry the heavy chain's V-D names) on igk and igl.
    jgerm_u, jgerm_scale = _germline_contract(
        last, scale, trans["dj_jgerm" if heavy else "vd_dgerm"],
        trans["jpadding_log"], emis["jgerm"] + emis["jpadding"])

    loglik = jgerm_scale + torch.log(jgerm_u.sum(dim=-1))
    return loglik, ForwardCache(vgerm_u=vgerm_u, vd_u=vd_rows,
                                dgerm_u=dgerm_u, dj_u=dj_rows,
                                jgerm_u=jgerm_u)
