"""Star-tree ("simple") emission log-probabilities (host side).

Under partis' star-tree independence assumption each observed sequence
emits independently given the naive base, so a state's emission is the
product over MSA rows of per-base probabilities; ambiguous (N) observed
bases contribute nothing (reference semantics: src/SimpleHMM.cpp:95-271).

Everything here is computed in log space: the TPU forward kernel takes
log-emissions and carries explicit scale accumulators, which replaces the
reference's 2^256 block-scaling machinery.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from linearham_tpu_torch.compiler.state_space import (
    GermlineRegion,
    JunctionRegion,
    PaddingRegion,
    StateSpace,
)
from linearham_tpu_torch.io.germline import GermlineGene

NEG_INF = -np.inf


def _safe_log(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(x)


def star_germline_emission(
    region: GermlineRegion,
    genes: Dict[str, GermlineGene],
    msa: np.ndarray,
    n_code: int,
) -> np.ndarray:
    """Per-gene log emission over the whole matched germline run.  [G]"""
    out = np.zeros(len(region.ggene_ranges))
    for i, (gname, (start, end)) in enumerate(region.ggene_ranges.items()):
        log_emit = _safe_log(genes[gname].emission)
        total = 0.0
        for j in range(start, end):
            col = msa[:, region.site_inds[j]]
            valid = col != n_code
            total += log_emit[col[valid], region.germ_inds[j]].sum()
        out[i] = total
    return out


def star_padding_emission(
    region: PaddingRegion,
    genes: Dict[str, GermlineGene],
    msa: np.ndarray,
    n_code: int,
) -> np.ndarray:
    """Per-gene log emission over the padding run.  [G]"""
    out = np.zeros(len(region.ggene_ranges))
    for i, (gname, (start, end)) in enumerate(region.ggene_ranges.items()):
        log_n = _safe_log(genes[gname].n_emission)
        total = 0.0
        for j in range(start, end):
            col = msa[:, region.site_inds[j]]
            valid = col != n_code
            total += log_n[col[valid]].sum()
        out[i] = total
    return out


def star_junction_emission(
    region: JunctionRegion,
    genes: Dict[str, GermlineGene],
    msa: np.ndarray,
    n_code: int,
) -> np.ndarray:
    """Per-(site row, state) log emission matrix.  [rows, S]

    NTI states are live at every row; each germline-position state is live
    only at its own site's row.  Dead (row, state) cells are -inf.
    """
    out = np.full((region.n_rows, region.n_states), NEG_INF)
    for gname, (start, end) in region.ggene_ranges.items():
        gene = genes[gname]
        log_emit = _safe_log(gene.emission)
        log_nti = (
            _safe_log(gene.nti_emission)
            if gene.nti_emission is not None else None
        )
        for i in range(start, end):
            if region.site_inds[i] == -1:  # NTI state: all rows
                for site in range(region.site_start, region.site_end):
                    col = msa[:, site]
                    valid = col != n_code
                    out[site - region.site_start, i] = \
                        log_nti[col[valid], region.naive_bases[i]].sum()
            else:
                site = region.site_inds[i]
                col = msa[:, site]
                valid = col != n_code
                out[site - region.site_start, i] = \
                    log_emit[col[valid], region.germ_inds[i]].sum()
    return out


def star_emissions(
    space: StateSpace, genes: Dict[str, GermlineGene], msa: np.ndarray
) -> dict:
    """All region log-emissions for the star-tree model, as a dict pytree."""
    n_code = len(space.alphabet) - 1
    emis = {
        "vpadding": star_padding_emission(space.vpadding, genes, msa, n_code),
        "vgerm": star_germline_emission(space.vgerm, genes, msa, n_code),
        "vd_junction": star_junction_emission(
            space.vd_junction, genes, msa, n_code),
        "jgerm": star_germline_emission(space.jgerm, genes, msa, n_code),
        "jpadding": star_padding_emission(space.jpadding, genes, msa, n_code),
    }
    if space.is_heavy:
        emis["dgerm"] = star_germline_emission(
            space.dgerm, genes, msa, n_code)
        emis["dj_junction"] = star_junction_emission(
            space.dj_junction, genes, msa, n_code)
    return emis
