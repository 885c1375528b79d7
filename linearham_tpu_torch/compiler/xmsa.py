"""The expanded MSA (xMSA): deduplicated (naive base, site) emission columns.

Phylo-HMM emissions are per-site phylogenetic likelihoods conditional on
the hidden naive base.  Many states share the same (naive base, MSA column)
pair, so those pairs are deduplicated into the columns of an expanded
alignment; the pruning kernel then computes each column's likelihood
exactly once and region emissions become cheap gathers (reference design:
src/PhyloHMM.cpp:45-144, 452-536 and the xMSA notes in
src/linearham.cpp:215-253).

Column indices are assigned in *insertion* order while walking the regions
left to right, which fixes the layout the conformance literals assume.
The naive sequence is row 0 of the xMSA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from linearham_tpu_torch.compiler.state_space import (
    JunctionRegion,
    StateSpace,
)


@dataclass
class XmsaIndexMaps:
    """xMSA column indices for every region state (−1 where not live)."""

    vpadding: np.ndarray           # [n_vpad_elems]
    vgerm: np.ndarray              # [n_vgerm_elems]
    vd_junction: np.ndarray        # [rows1, S1]
    dgerm: Optional[np.ndarray]    # [n_dgerm_elems] (igh)
    dj_junction: Optional[np.ndarray]  # [rows2, S2] (igh)
    jgerm: np.ndarray
    jpadding: np.ndarray


@dataclass
class Xmsa:
    """The deduplicated emission-column alignment."""

    matrix: np.ndarray             # [n_seqs + 1, X] int codes, naive row 0
    labels: List[str]              # ["naive", *unique_ids]
    naive_row: int                 # always 0
    inds: XmsaIndexMaps

    @property
    def n_cols(self) -> int:
        return self.matrix.shape[1]

    @property
    def naive_bases(self) -> np.ndarray:
        return self.matrix[self.naive_row]


def _linear_inds(region, ids: Dict[Tuple[int, int], int]) -> np.ndarray:
    out = np.full(len(region.naive_bases), -1, np.int32)
    for i, (base, site) in enumerate(
            zip(region.naive_bases, region.site_inds)):
        key = (base, site)
        out[i] = ids.setdefault(key, len(ids))
    return out


def _junction_inds(region: JunctionRegion,
                   ids: Dict[Tuple[int, int], int]) -> np.ndarray:
    out = np.full((region.n_rows, region.n_states), -1, np.int32)
    for i in range(region.n_states):
        base = region.naive_bases[i]
        if region.site_inds[i] == -1:  # NTI state: live at every row
            for site in range(region.site_start, region.site_end):
                out[site - region.site_start, i] = \
                    ids.setdefault((base, site), len(ids))
        else:
            site = region.site_inds[i]
            out[site - region.site_start, i] = \
                ids.setdefault((base, site), len(ids))
    return out


def build_xmsa(space: StateSpace, msa: np.ndarray,
               unique_ids: List[str]) -> Xmsa:
    """Walk the regions, dedup (naive base, site) pairs, stack the xMSA."""
    ids: Dict[Tuple[int, int], int] = {}

    vpad = _linear_inds(space.vpadding, ids)
    vgerm = _linear_inds(space.vgerm, ids)
    vd = _junction_inds(space.vd_junction, ids)
    if space.is_heavy:
        dgerm = _linear_inds(space.dgerm, ids)
        dj = _junction_inds(space.dj_junction, ids)
    else:
        dgerm = dj = None
    jgerm = _linear_inds(space.jgerm, ids)
    jpad = _linear_inds(space.jpadding, ids)

    n_seqs = msa.shape[0]
    matrix = np.full((n_seqs + 1, len(ids)), -1, np.int32)
    for (base, site), col in ids.items():
        matrix[0, col] = base
        matrix[1:, col] = msa[:, site]

    return Xmsa(
        matrix=matrix,
        labels=["naive"] + list(unique_ids),
        naive_row=0,
        inds=XmsaIndexMaps(
            vpadding=vpad, vgerm=vgerm, vd_junction=vd,
            dgerm=dgerm, dj_junction=dj, jgerm=jgerm, jpadding=jpad,
        ),
    )


def segment_matrix(region_inds: np.ndarray, ranges: Dict[str, Tuple[int, int]],
                   n_genes: int) -> np.ndarray:
    """One-hot [n_elems, n_genes] map from region elements to their gene.

    Lets per-gene log-emission sums run as a single matmul on device.
    """
    out = np.zeros((len(region_inds), n_genes))
    for gi, (gname, (start, end)) in enumerate(ranges.items()):
        out[start:end, gi] = 1.0
    return out
