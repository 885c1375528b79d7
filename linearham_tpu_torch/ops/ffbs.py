"""Forward-filtering backward-sampling (FFBS) of hidden V(D)J paths.

Counterpart of linearham_tpu/ops/ffbs.py.  The J germline state is drawn
from the final forward vector, then junction rows are walked backwards,
each draw a categorical over transition-column x forward-row, then the
preceding germline state, and so on down to V (reference semantics:
src/HMM.cpp:358-431, 1180-1353).

Batched over trees: one path per tree per call.  Draws come from an
explicit ``torch.Generator`` on the tensors' device (Gumbel-max over the
logits), so sampled paths are reproducible per seed but not the JAX
package's draws; conformance is distributional.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from linearham_tpu_torch.ops.forward import ForwardCache


class SampledPath(NamedTuple):
    vgerm_idx: torch.Tensor            # [T]
    vd_idx: torch.Tensor               # [T, R1]
    dgerm_idx: Optional[torch.Tensor]  # [T] (igh only)
    dj_idx: Optional[torch.Tensor]     # [T, R2] (igh only)
    jgerm_idx: torch.Tensor            # [T]


def path_to_numpy(path: SampledPath) -> SampledPath:
    """The same path with numpy leaves (copied to the host)."""
    return SampledPath(*(None if a is None else a.cpu().numpy()
                         for a in path))


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=0.0))


def categorical(generator: torch.Generator,
                logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` [T, S] (Gumbel-max); returns [T]."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    u = torch.clamp(u, min=torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_junction_backward(
    generator: torch.Generator,
    exit_cols: torch.Tensor,    # [T, S] junction->germ column of the
                                #        already-sampled downstream state
    junction: torch.Tensor,     # [S, S]
    rows_u: torch.Tensor,       # [R, T, S] forward rows
) -> torch.Tensor:
    """Walk junction rows last-to-first; returns indices [T, R]."""
    col_logits = _safe_log(exit_cols)
    idx_rev = []
    for r in range(rows_u.shape[0] - 1, -1, -1):
        idx = categorical(generator, col_logits + _safe_log(rows_u[r]))
        idx_rev.append(idx)
        col_logits = _safe_log(junction[:, idx].T)
    return torch.stack(idx_rev[::-1], dim=1)


def _sample_germline(generator, germ_junction, first_junction_idx, germ_u):
    logits = _safe_log(germ_junction[:, first_junction_idx].T) \
        + _safe_log(germ_u)
    return categorical(generator, logits)


def sample_path(
    generator: torch.Generator,
    trans: Dict[str, torch.Tensor],
    cache: ForwardCache,
    heavy: bool,
) -> SampledPath:
    """Draw one posterior hidden path per tree."""
    jgerm_idx = categorical(generator, _safe_log(cache.jgerm_u))
    if heavy:
        dj_idx = _sample_junction_backward(
            generator, trans["dj_jgerm"][:, jgerm_idx].T, trans["dj"],
            cache.dj_u)
        dgerm_idx = _sample_germline(
            generator, trans["dgerm_dj"], dj_idx[:, 0], cache.dgerm_u)
        vd_idx = _sample_junction_backward(
            generator, trans["vd_dgerm"][:, dgerm_idx].T, trans["vd"],
            cache.vd_u)
    else:
        dj_idx = dgerm_idx = None
        vd_idx = _sample_junction_backward(
            generator, trans["vd_dgerm"][:, jgerm_idx].T, trans["vd"],
            cache.vd_u)
    vgerm_idx = _sample_germline(
        generator, trans["vgerm_vd"], vd_idx[:, 0], cache.vgerm_u)
    return SampledPath(vgerm_idx=vgerm_idx, vd_idx=vd_idx,
                       dgerm_idx=dgerm_idx, dj_idx=dj_idx,
                       jgerm_idx=jgerm_idx)
