"""A compiled family's transition tensors on the host (numpy).

Twin of linearham_tpu/compiler/compiled.py, whose module imports jax for
its device-placement helper; the host part is reproduced here so the port
loads without jax.  Device placement belongs to models.phylo_hmm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from linearham_tpu_torch.compiler.state_space import GermlineRegion, StateSpace
from linearham_tpu_torch.compiler.transitions import (TransitionSet,
                                                      build_transitions)
from linearham_tpu_torch.io.germline import GermlineGene


def _within_region_log(region: GermlineRegion,
                       genes: Dict[str, GermlineGene]) -> np.ndarray:
    """Log product of within-gene transitions across each germline run."""
    out = np.zeros(len(region.ggene_ranges))
    for i, (gname, (start, end)) in enumerate(region.ggene_ranges.items()):
        if end - start > 1:
            g0 = region.germ_inds[start]
            out[i] = np.log(
                genes[gname].transition[g0:g0 + (end - start - 1)]
            ).sum()
    return out


@dataclass
class CompiledFamily:
    """State space + transition tensors of one family, host resident."""

    space: StateSpace
    genes: Dict[str, GermlineGene]
    trans: TransitionSet

    def host_transitions(self, dtype=np.float64) -> Dict[str, np.ndarray]:
        """The transition dict consumed by ops.forward.forward, as numpy."""
        space, genes, trans = self.space, self.genes, self.trans
        with np.errstate(divide="ignore"):
            gene_prob_log = np.log([
                genes[g].gene_prob for g in space.vgerm.ggene_ranges
            ])
            vgerm_static_log = (
                gene_prob_log
                + np.log(trans.vpadding)
                + _within_region_log(space.vgerm, genes)
            )
            jpadding_log = np.log(trans.jpadding)

        out = {
            "vgerm_static_log": np.asarray(vgerm_static_log, dtype),
            "vgerm_vd": np.asarray(trans.vgerm_vd, dtype),
            "vd": np.asarray(trans.vd, dtype),
            "vd_dgerm": np.asarray(trans.vd_dgerm, dtype),
            "jpadding_log": np.asarray(jpadding_log, dtype),
        }
        if space.is_heavy:
            out["dgerm_dj"] = np.asarray(trans.dgerm_dj, dtype)
            out["dj"] = np.asarray(trans.dj, dtype)
            out["dj_jgerm"] = np.asarray(trans.dj_jgerm, dtype)
        return out


def compile_family(space: StateSpace,
                   genes: Dict[str, GermlineGene]) -> CompiledFamily:
    return CompiledFamily(
        space=space, genes=genes, trans=build_transitions(space, genes)
    )
