"""Transition-tensor assembly for the compiled V(D)J state space.

Produces the dense inter/intra-region transition probability matrices the
device forward pass consumes:

  vpadding  [Gv]           geometric N-padding factor per V gene
  vgerm->vd [Gv, Svd]      V germline region -> V-D junction
  vd        [Svd, Svd]     junction self-transition (one matmul per site row)
  vd->dgerm [Svd, Gd]      junction -> D germline region
  dgerm->dj [Gd, Sdj]      etc.
  dj        [Sdj, Sdj]
  dj->jgerm [Sdj, Gj]
  jpadding  [Gj]

Semantics follow the reference's transition contract (src/HMM.cpp:622-1089):
NTI self/exit blocks, within-gene superdiagonals, cross-gene NTI entries
weighted by landing-out x gene-prob x NTI-landing-in, direct gene-to-gene
matches on the site-adjacency diagonal, and destination-region transition
products folded into junction->germline matrices.  The construction here is
a fresh numpy implementation driven by block descriptors rather than a port
of the C++ loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from linearham_tpu_torch.compiler.state_space import (
    GermlineRegion,
    JunctionRegion,
    PaddingRegion,
    StateSpace,
)
from linearham_tpu_torch.io.germline import GermlineGene


@dataclass
class BlockSide:
    """Describes one gene's slice of a transition matrix axis.

    ``nti_start``/``nti_len`` cover the gene's NTI states (junction axes
    only); ``germ_start``/``germ_len`` cover its germline-position states,
    which begin at germline position ``germ_ind0`` / site ``site_ind0``.
    """

    nti_start: int = 0
    nti_len: int = 0
    germ_start: int = 0
    germ_len: int = 0
    germ_ind0: int = -1
    site_ind0: int = -1


def _germline_side(region: GermlineRegion, gene_name: str,
                   exit_side: bool) -> BlockSide:
    """Axis descriptor for a germline-region state (a 1-wide block).

    When the germline region is the *source* (``exit_side``) of a
    transition, the relevant germline position is the region's last; when it
    is the destination, it is the region's first.
    """
    start, end = region.ggene_ranges[gene_name]
    idx = list(region.ggene_ranges).index(gene_name)
    if end > start:
        pos = end - 1 if exit_side else start
        g0, s0 = region.germ_inds[pos], region.site_inds[pos]
    else:
        g0, s0 = -1, -1
    return BlockSide(germ_start=idx, germ_len=1, germ_ind0=g0, site_ind0=s0)


def _junction_side(region: JunctionRegion, gene: GermlineGene,
                   right_gtype: str) -> BlockSide:
    """Axis descriptor for one gene's junction states."""
    start, end = region.ggene_ranges[gene.name]
    nti_len = len(gene.alphabet) if gene.gtype == right_gtype else 0
    germ_start = start + nti_len
    germ_len = end - germ_start
    if germ_len > 0:
        g0 = region.germ_inds[germ_start]
        s0 = region.site_inds[germ_start]
    else:
        g0, s0 = -1, -1
    return BlockSide(
        nti_start=start, nti_len=nti_len,
        germ_start=germ_start, germ_len=germ_len,
        germ_ind0=g0, site_ind0=s0,
    )


def _fill_block(
    out: np.ndarray,
    fg: GermlineGene,
    tg: GermlineGene,
    left_gtype: str,
    right_gtype: str,
    row: BlockSide,
    col: BlockSide,
) -> None:
    """Write all transition probabilities from gene ``fg`` into gene ``tg``."""
    # --- same gene -------------------------------------------------------
    if fg.name == tg.name:
        if fg.gtype == right_gtype and row.nti_len > 0:
            if col.nti_len > 0:
                out[row.nti_start:row.nti_start + row.nti_len,
                    col.nti_start:col.nti_start + col.nti_len] = \
                    fg.nti_transition
            if col.germ_len > 0:
                out[row.nti_start:row.nti_start + row.nti_len,
                    col.germ_start:col.germ_start + col.germ_len] = \
                    fg.nti_landing_out[:, col.germ_ind0:
                                       col.germ_ind0 + col.germ_len]
        if row.germ_len > 0 and col.germ_len > 0:
            if row.germ_ind0 == col.germ_ind0:
                # Same germline positions on both axes (junction self-step):
                # each position steps to its successor.
                for i in range(row.germ_len - 1):
                    out[row.germ_start + i, col.germ_start + i + 1] = \
                        fg.transition[row.germ_ind0 + i]
            else:
                # Row region immediately precedes the column region: only
                # the last row position can continue into the first column
                # position.
                k = row.germ_ind0 + row.germ_len - 1
                if k < fg.transition.shape[0]:
                    out[row.germ_start + row.germ_len - 1, col.germ_start] = \
                        fg.transition[k]

    # --- across genes (left-type gene exits into right-type gene) --------
    if fg.gtype == left_gtype and tg.gtype == right_gtype:
        if row.germ_len > 0 and col.nti_len > 0:
            exit_probs = fg.landing_out[row.germ_ind0:
                                        row.germ_ind0 + row.germ_len]
            entry_probs = tg.gene_prob * tg.nti_landing_in
            out[row.germ_start:row.germ_start + row.germ_len,
                col.nti_start:col.nti_start + col.nti_len] = \
                np.outer(exit_probs, entry_probs)
        if row.germ_len > 0 and col.germ_len > 0 and row.site_ind0 >= 0 \
                and col.site_ind0 >= 0:
            # Direct gene-to-gene continuation: row site s hands off to
            # column site s+1.
            shift = row.site_ind0 + 1 - col.site_ind0
            for i in range(row.germ_len):
                j = i + shift
                if 0 <= j < col.germ_len:
                    out[row.germ_start + i, col.germ_start + j] = (
                        fg.landing_out[row.germ_ind0 + i]
                        * tg.gene_prob
                        * tg.landing_in[col.germ_ind0 + j]
                    )


def padding_transition(
    region: PaddingRegion, genes: Dict[str, GermlineGene]
) -> np.ndarray:
    """Per-gene geometric padding factor (1-p) * p^k over k padded sites."""
    out = np.zeros(len(region.ggene_ranges))
    for i, (gname, (start, end)) in enumerate(region.ggene_ranges.items()):
        p = genes[gname].n_transition
        out[i] = (1.0 - p) * p ** (end - start)
    return out


def germline_to_junction(
    germ: GermlineRegion,
    junction: JunctionRegion,
    left_gtype: str,
    right_gtype: str,
    genes: Dict[str, GermlineGene],
) -> np.ndarray:
    out = np.zeros((germ.n_states, junction.n_states))
    for fname in germ.ggene_ranges:
        fg = genes[fname]
        row = _germline_side(germ, fname, exit_side=True)
        for tname in junction.ggene_ranges:
            tg = genes[tname]
            col = _junction_side(junction, tg, right_gtype)
            _fill_block(out, fg, tg, left_gtype, right_gtype, row, col)
    return out


def junction_transition(
    junction: JunctionRegion,
    left_gtype: str,
    right_gtype: str,
    genes: Dict[str, GermlineGene],
) -> np.ndarray:
    out = np.zeros((junction.n_states, junction.n_states))
    for fname in junction.ggene_ranges:
        fg = genes[fname]
        row = _junction_side(junction, fg, right_gtype)
        for tname in junction.ggene_ranges:
            tg = genes[tname]
            col = _junction_side(junction, tg, right_gtype)
            _fill_block(out, fg, tg, left_gtype, right_gtype, row, col)
    return out


def junction_to_germline(
    junction: JunctionRegion,
    germ: GermlineRegion,
    left_gtype: str,
    right_gtype: str,
    genes: Dict[str, GermlineGene],
) -> np.ndarray:
    out = np.zeros((junction.n_states, germ.n_states))
    for fname in junction.ggene_ranges:
        fg = genes[fname]
        row = _junction_side(junction, fg, right_gtype)
        for ti, tname in enumerate(germ.ggene_ranges):
            tg = genes[tname]
            col = _germline_side(germ, tname, exit_side=False)
            _fill_block(out, fg, tg, left_gtype, right_gtype, row, col)
            # Fold in the destination region's within-gene transition chain
            # so the germline state absorbs its whole matched run.
            t_start, t_end = germ.ggene_ranges[tname]
            n_steps = t_end - t_start - 1
            if n_steps > 0:
                out[row.nti_start if row.nti_len else row.germ_start:
                    row.germ_start + row.germ_len, ti] *= np.prod(
                    tg.transition[col.germ_ind0:col.germ_ind0 + n_steps]
                )
    return out


@dataclass
class TransitionSet:
    """All transition tensors of one compiled family."""

    vpadding: np.ndarray
    vgerm_vd: np.ndarray
    vd: np.ndarray
    vd_dgerm: np.ndarray          # junction -> D germ (igh) or J germ (igk/l)
    dgerm_dj: Optional[np.ndarray]
    dj: Optional[np.ndarray]
    dj_jgerm: Optional[np.ndarray]
    jpadding: np.ndarray


def build_transitions(
    space: StateSpace, genes: Dict[str, GermlineGene]
) -> TransitionSet:
    heavy = space.is_heavy
    right1 = "D" if heavy else "J"
    vpad = padding_transition(space.vpadding, genes)
    jpad = padding_transition(space.jpadding, genes)

    vgerm_vd = germline_to_junction(
        space.vgerm, space.vd_junction, "V", right1, genes)
    vd = junction_transition(space.vd_junction, "V", right1, genes)

    if heavy:
        vd_dgerm = junction_to_germline(
            space.vd_junction, space.dgerm, "V", "D", genes)
        dgerm_dj = germline_to_junction(
            space.dgerm, space.dj_junction, "D", "J", genes)
        dj = junction_transition(space.dj_junction, "D", "J", genes)
        dj_jgerm = junction_to_germline(
            space.dj_junction, space.jgerm, "D", "J", genes)
    else:
        vd_dgerm = junction_to_germline(
            space.vd_junction, space.jgerm, "V", "J", genes)
        dgerm_dj = dj = dj_jgerm = None

    return TransitionSet(
        vpadding=vpad,
        vgerm_vd=vgerm_vd,
        vd=vd,
        vd_dgerm=vd_dgerm,
        dgerm_dj=dgerm_dj,
        dj=dj,
        dj_jgerm=dj_jgerm,
        jpadding=jpad,
    )
