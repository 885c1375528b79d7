"""Viterbi (MAP) hidden-path decoding, in torch.

Counterpart of linearham_tpu/ops/viterbi.py: the forward chain of
``ops/forward.py`` with max-product semantics and an argmax backtrace,
batched over trees.  ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does, so ties break the same way in both packages.  Scores
are log-space throughout: a zero transition is -inf, and a row of all -inf
scores takes index 0 (a valid state), never an out-of-range one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from linearham_tpu_torch.ops.ffbs import SampledPath


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=0.0))


def _max_argmax(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, first argmax) over axis 1 of [T, S_from, S_to] scores."""
    # torch.max(dim=) leaves the index of a tie unspecified; argmax's is
    # the first, as the JAX package's.
    return scores.amax(dim=1), torch.argmax(scores, dim=1)


def _junction_max(
    germ_log: torch.Tensor,        # [T, G] entry log scores
    germ_junction: torch.Tensor,   # [G, S]
    junction: torch.Tensor,        # [S, S]
    emis_log: torch.Tensor,        # [T, R, S]
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Max-product over junction rows.

    Returns (score [T, S] at the last row, germ backpointers [T, S] for row
    0, junction backpointers: R-1 tensors [T, S]).
    """
    v, bp0 = _max_argmax(germ_log[:, :, None]
                         + _safe_log(germ_junction)[None])
    v = v + emis_log[:, 0]
    log_tr = _safe_log(junction)[None]
    bps = []
    for r in range(1, emis_log.shape[1]):
        best, bp = _max_argmax(v[:, :, None] + log_tr)
        v = best + emis_log[:, r]
        bps.append(bp)
    return v, bp0, bps


def _pick(bp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bp[t, idx[t]] for every tree."""
    return torch.gather(bp, 1, idx[:, None])[:, 0]


def _backtrace(last_idx, bps, bp0):
    """Walk junction backpointers; returns (row indices [T, R], germ idx)."""
    idx = last_idx
    rows = [idx]
    for bp in reversed(bps):
        idx = _pick(bp, idx)
        rows.append(idx)
    return torch.stack(rows[::-1], dim=1), _pick(bp0, idx)


def viterbi(
    trans: Dict[str, torch.Tensor],
    emis: Dict[str, torch.Tensor],
    heavy: bool,
) -> Tuple[torch.Tensor, SampledPath]:
    """MAP path and its joint log-probability per tree.

    Same inputs as ops.forward.forward; returns (score [T], path).
    """
    vgerm_log = (trans["vgerm_static_log"][None] + emis["vpadding"]
                 + emis["vgerm"])
    vd_last, vd_bp0, vd_bps = _junction_max(
        vgerm_log, trans["vgerm_vd"], trans["vd"], emis["vd_junction"])

    if heavy:
        dgerm_best, d_bp = _max_argmax(
            vd_last[:, :, None] + _safe_log(trans["vd_dgerm"])[None])
        dgerm_log = dgerm_best + emis["dgerm"]
        dj_last, dj_bp0, dj_bps = _junction_max(
            dgerm_log, trans["dgerm_dj"], trans["dj"], emis["dj_junction"])
        last, to_j = dj_last, trans["dj_jgerm"]
    else:
        last, to_j = vd_last, trans["vd_dgerm"]
    j_best, j_bp = _max_argmax(last[:, :, None] + _safe_log(to_j)[None])
    jgerm_log = (j_best + trans["jpadding_log"][None] + emis["jgerm"]
                 + emis["jpadding"])

    score = jgerm_log.amax(dim=1)
    jgerm_idx = torch.argmax(jgerm_log, dim=1)

    if heavy:
        dj_rows, dgerm_idx = _backtrace(_pick(j_bp, jgerm_idx), dj_bps,
                                        dj_bp0)
        vd_rows, vgerm_idx = _backtrace(_pick(d_bp, dgerm_idx), vd_bps,
                                        vd_bp0)
    else:
        dj_rows = dgerm_idx = None
        vd_rows, vgerm_idx = _backtrace(_pick(j_bp, jgerm_idx), vd_bps,
                                        vd_bp0)
    return score, SampledPath(vgerm_idx=vgerm_idx, vd_idx=vd_rows,
                              dgerm_idx=dgerm_idx, dj_idx=dj_rows,
                              jgerm_idx=jgerm_idx)
