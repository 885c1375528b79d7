"""The V(D)J hidden-state-space compiler (host side, runs once per family).

Given a clonal family's Smith-Waterman alignment summary (``flexbounds`` site
windows and per-gene ``relpos`` offsets from partis) and the germline gene
map, this module lays out the collapsed HMM state space:

  V "padding" -> V "germline" -> V-D "junction" -> D "germline"
  -> D-J "junction" -> J "germline" -> J "padding"        (igh)

or the 5-region V-J variant for igk/igl.  Within-gene runs of matched
germline positions collapse to a single "germline" state per gene, which is
what keeps the forward pass linear in the number of states (reference
design: src/HMM.cpp:86-185 and the model notes in src/linearham.cpp:154-158).

All outputs are parallel flat arrays ("struct of arrays"), ordered by gene
name (byte order) and, within a gene, by site position -- the same state
ordering contract the reference uses, so its test literals apply directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from linearham_tpu_torch.io.germline import GermlineGene

Range = Tuple[int, int]


@dataclass
class GermlineRegion:
    """One collapsed "germline" region: one state per germline gene."""

    state_strs: List[str] = field(default_factory=list)
    left_del: List[int] = field(default_factory=list)
    right_del: List[int] = field(default_factory=list)
    ggene_ranges: Dict[str, Range] = field(default_factory=dict)
    naive_bases: List[int] = field(default_factory=list)
    germ_inds: List[int] = field(default_factory=list)
    site_inds: List[int] = field(default_factory=list)

    @property
    def n_states(self) -> int:
        return len(self.state_strs)


@dataclass
class JunctionRegion:
    """A junction window: per-site NTI and germline-position states."""

    site_start: int = 0  # left flexbound lower edge
    site_end: int = 0    # right flexbound upper edge
    state_strs: List[str] = field(default_factory=list)
    deletions: List[int] = field(default_factory=list)   # -1 for NTI states
    gtypes: List[str] = field(default_factory=list)
    ggene_ranges: Dict[str, Range] = field(default_factory=dict)
    naive_bases: List[int] = field(default_factory=list)
    germ_inds: List[int] = field(default_factory=list)   # -1 for NTI states
    site_inds: List[int] = field(default_factory=list)   # -1 for NTI states

    @property
    def n_states(self) -> int:
        return len(self.state_strs)

    @property
    def n_rows(self) -> int:
        return self.site_end - self.site_start


@dataclass
class PaddingRegion:
    """Ambiguous-N padding flanking the V (left) or J (right) gene."""

    ggene_ranges: Dict[str, Range] = field(default_factory=dict)
    naive_bases: List[int] = field(default_factory=list)
    site_inds: List[int] = field(default_factory=list)


@dataclass
class StateSpace:
    """The full compiled state space of one clonal family."""

    locus: str
    alphabet: str                       # includes trailing N, e.g. "ACGTN"
    flexbounds: Dict[str, Range]
    relpos: Dict[str, int]
    vpadding: PaddingRegion
    vgerm: GermlineRegion
    vd_junction: JunctionRegion
    dgerm: Optional[GermlineRegion]     # None for igk/igl
    dj_junction: Optional[JunctionRegion]
    jgerm: GermlineRegion
    jpadding: PaddingRegion

    @property
    def is_heavy(self) -> bool:
        return self.locus == "igh"


def _add_germline_states(
    region: GermlineRegion,
    gene: GermlineGene,
    left_flex: Range,
    right_flex: Range,
    relpos: int,
    left_end: bool,
    right_end: bool,
) -> None:
    """Append one gene's collapsed germline state to ``region``.

    The state's site span runs from the left window's inner edge to the
    right window's inner edge; at sequence boundaries (``left_end`` /
    ``right_end``) it is clipped to the gene body instead.
    """
    site_start = max(relpos, left_flex[0]) if left_end else left_flex[1]
    site_end = (
        min(relpos + gene.length, right_flex[1]) if right_end
        else right_flex[0]
    )

    start = len(region.naive_bases)
    region.ggene_ranges[gene.name] = (start, start + (site_end - site_start))
    region.state_strs.append(gene.name)
    region.left_del.append(site_start - relpos)
    region.right_del.append(relpos + gene.length - site_end)
    for site in range(site_start, site_end):
        region.naive_bases.append(int(gene.bases[site - relpos]))
        region.germ_inds.append(site - relpos)
        region.site_inds.append(site)


def _add_junction_states(
    region: JunctionRegion,
    gene: GermlineGene,
    left_flex: Range,
    right_flex: Range,
    relpos: int,
    left_end: bool,
) -> None:
    """Append one gene's junction states (NTI block, then per-site states).

    ``left_end`` marks the gene whose 5' end lies inside this junction (the
    right-hand gene of the junction); it contributes one NTI state per
    alphabet letter ahead of its germline-position states.
    """
    A = len(gene.alphabet)
    site_start = max(relpos, left_flex[0]) if left_end else left_flex[0]
    site_end = (
        right_flex[1] if left_end
        else min(relpos + gene.length, right_flex[1])
    )

    start = len(region.naive_bases)
    n_states = (site_end - site_start) + (A if left_end else 0)
    region.ggene_ranges[gene.name] = (start, start + n_states)

    if left_end:
        for i, base in enumerate(gene.alphabet):
            region.state_strs.append(f"{gene.name}:N_{base}")
            region.deletions.append(-1)
            region.gtypes.append(gene.gtype)
            region.naive_bases.append(i)
            region.germ_inds.append(-1)
            region.site_inds.append(-1)

    for site in range(site_start, site_end):
        region.state_strs.append(f"{gene.name}:{site - relpos}")
        region.deletions.append(
            site - relpos if left_end
            else relpos + gene.length - site - 1
        )
        region.gtypes.append(gene.gtype)
        region.naive_bases.append(int(gene.bases[site - relpos]))
        region.germ_inds.append(site - relpos)
        region.site_inds.append(site)


def _add_padding_states(
    region: PaddingRegion,
    gene: GermlineGene,
    flex: Range,
    relpos: int,
    left_end: bool,
) -> None:
    """Append one gene's padding run (N naive bases out to the boundary)."""
    if left_end:
        site_start, site_end = flex[0], max(relpos, flex[0])
    else:
        site_start, site_end = min(relpos + gene.length, flex[1]), flex[1]

    start = len(region.naive_bases)
    region.ggene_ranges[gene.name] = (start, start + (site_end - site_start))
    n_code = len(gene.alphabet)  # N is coded just past the base alphabet
    for site in range(site_start, site_end):
        region.naive_bases.append(n_code)
        region.site_inds.append(site)


def _validate_inputs(
    locus: str,
    fb: Dict[str, Range],
    relpos: Dict[str, int],
    genes: Dict[str, GermlineGene],
    heavy: bool,
) -> None:
    """Actionable input validation (reference style, src/HMM.cpp:34-43).

    Degenerate Smith-Waterman summaries -- missing/reversed windows,
    out-of-order regions, zero-width junction windows, genes absent from
    the parameter directory -- fail here with messages naming the bad
    field instead of crashing the compiled forward pass downstream.
    """
    required = (["v_l", "v_r", "d_l", "d_r", "j_l", "j_r"] if heavy
                else ["v_l", "v_r", "j_l", "j_r"])
    missing = [k for k in required if k not in fb]
    if missing:
        raise ValueError(
            f"flexbounds lacks window(s) {missing} for locus {locus!r}; "
            "run 'partis get-linearham-info' to produce the full "
            "linearham-info block")
    for k in required:
        lo, hi = fb[k]
        if lo < 0 or hi < lo:
            raise ValueError(
                f"flexbounds[{k!r}] = ({lo}, {hi}) is not a valid "
                "(min, max) site window")
    for left, right in zip(required, required[1:]):
        if fb[right][0] < fb[left][0] or fb[right][1] < fb[left][1]:
            raise ValueError(
                f"flexbounds windows out of order: {left}={fb[left]} vs "
                f"{right}={fb[right]} (regions must be left-to-right)")
    junctions = [("v_r", "d_l"), ("d_r", "j_l")] if heavy \
        else [("v_r", "j_l")]
    for left, right in junctions:
        if fb[right][1] - fb[left][0] < 1:
            raise ValueError(
                f"the {left}..{right} junction window "
                f"[{fb[left][0]}, {fb[right][1]}) has zero width; "
                "linearham needs at least one junction site between "
                "matched germline regions (check the Smith-Waterman "
                "flexbounds from partis)")
    germ_windows = [("v_l", "v_r"), ("j_l", "j_r")] + (
        [("d_l", "d_r")] if heavy else [])
    for left, right in germ_windows:
        if fb[right][0] - fb[left][1] < 1:
            raise ValueError(
                f"the {left[0].upper()} germline region "
                f"[{fb[left][1]}, {fb[right][0]}) has zero width; the "
                "collapsed-region HMM needs at least one matched germline "
                "site per segment (the reference factorization has the "
                "same requirement)")
    unknown = [g for g in relpos if g not in genes]
    if unknown:
        raise ValueError(
            f"relpos names germline gene(s) {unknown} with no parameter "
            "file in the --hmm-param-dir (expected "
            "IG[HKL][VDJ]*_star_*.yaml files)")
    # Each gene must span its segment's occupied sites, or germline-position
    # lookups would index past the gene body.
    spans = {"V": ("v_l", "v_r"), "J": ("j_l", "j_r")}
    if heavy:
        spans["D"] = ("d_l", "d_r")
    for gname, rp in relpos.items():
        gene = genes[gname]
        if gene.gtype == "D" and not heavy:
            continue
        left, right = spans[gene.gtype]
        if rp > fb[left][1] or rp + gene.length < fb[right][0]:
            raise ValueError(
                f"gene {gname!r} (relpos {rp}, length {gene.length}) does "
                f"not span its germline window [{fb[left][1]}, "
                f"{fb[right][0]}); check relpos/flexbounds consistency")


def build_state_space(
    locus: str,
    flexbounds: Dict[str, Range],
    relpos: Dict[str, int],
    genes: Dict[str, GermlineGene],
) -> StateSpace:
    """Compile the state space for one clonal family."""
    heavy = locus == "igh"
    if not heavy and locus not in ("igk", "igl"):
        raise ValueError(f"unsupported locus {locus!r}")

    fb = {k: (int(v[0]), int(v[1])) for k, v in flexbounds.items()}
    _validate_inputs(locus, fb, relpos, genes, heavy)
    alphabet = next(iter(genes.values())).alphabet

    vpadding = PaddingRegion()
    vgerm = GermlineRegion()
    vd_junction = JunctionRegion(
        site_start=fb["v_r"][0],
        site_end=fb["d_l"][1] if heavy else fb["j_l"][1],
    )
    dgerm = GermlineRegion() if heavy else None
    dj_junction = (
        JunctionRegion(site_start=fb["d_r"][0], site_end=fb["j_l"][1])
        if heavy else None
    )
    jgerm = GermlineRegion()
    jpadding = PaddingRegion()

    # Iterate genes in byte order of their display names -- this fixes the
    # state ordering used by every downstream tensor.
    for gname in sorted(relpos):
        gene = genes[gname]
        rp = int(relpos[gname])
        if gene.gtype == "V":
            _add_padding_states(vpadding, gene, fb["v_l"], rp, left_end=True)
            _add_germline_states(
                vgerm, gene, fb["v_l"], fb["v_r"], rp,
                left_end=True, right_end=False,
            )
            right = fb["d_l"] if heavy else fb["j_l"]
            _add_junction_states(
                vd_junction, gene, fb["v_r"], right, rp, left_end=False
            )
        elif gene.gtype == "D":
            if not heavy:
                continue  # light-chain loci have no D segment
            _add_junction_states(
                vd_junction, gene, fb["v_r"], fb["d_l"], rp, left_end=True
            )
            _add_germline_states(
                dgerm, gene, fb["d_l"], fb["d_r"], rp,
                left_end=False, right_end=False,
            )
            _add_junction_states(
                dj_junction, gene, fb["d_r"], fb["j_l"], rp, left_end=False
            )
        else:  # J
            if heavy:
                _add_junction_states(
                    dj_junction, gene, fb["d_r"], fb["j_l"], rp, left_end=True
                )
            else:
                _add_junction_states(
                    vd_junction, gene, fb["v_r"], fb["j_l"], rp, left_end=True
                )
            _add_germline_states(
                jgerm, gene, fb["j_l"], fb["j_r"], rp,
                left_end=False, right_end=True,
            )
            _add_padding_states(jpadding, gene, fb["j_r"], rp, left_end=False)

    return StateSpace(
        locus=locus,
        alphabet=alphabet + "N",
        flexbounds=fb,
        relpos={k: int(v) for k, v in relpos.items()},
        vpadding=vpadding,
        vgerm=vgerm,
        vd_junction=vd_junction,
        dgerm=dgerm,
        dj_junction=dj_junction,
        jgerm=jgerm,
        jpadding=jpadding,
    )
