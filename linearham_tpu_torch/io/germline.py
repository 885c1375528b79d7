"""Ingestion of partis HMM germline parameter YAML files.

One YAML file per germline gene.  Each file describes a small left-to-right
profile HMM: an ``init`` state, optional ``insert_left_*`` states (the
non-templated-insertion / N-padding machinery), the germline-position states
``<gene>_<i>``, and (for J genes) an ``insert_right_N`` state.

This module parses those files into flat numpy parameter sets.  It is the
TPU-native equivalent of the reference's Germline/NTInsertion/NPadding/
VDJGermline component family (src/Germline.cpp:20-115, src/NTInsertion.cpp:
21-104, src/NPadding.cpp:22-109, src/VDJGermline.cpp:46-108); the output here
is a plain dataclass of arrays intended to feed the numpy "HMM compiler"
(linearham_tpu_torch.compiler) rather than an object graph.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import yaml

from linearham_tpu_torch.utils.constants import EPS

_GENE_FILE_RE = re.compile(r"^(IG([HKL])([VDJ]).*_star_.*)\.yaml$")


def _unmangle(name: str) -> str:
    """partis encodes '*' as '_star_' and '/' as '_slash_' in names."""
    return name.replace("_star_", "*").replace("_slash_", "/")


def _germline_state_re(mangled_name: str) -> re.Pattern:
    return re.compile("^" + re.escape(mangled_name) + r"_([0-9]+)$")


def _nti_state_re(alphabet: str) -> re.Pattern:
    return re.compile(r"^insert_left_([" + alphabet + r"])$")


def _prob_map(node: dict):
    """Return (names, probs) from a YAML {state: prob} map; probs must sum to 1."""
    names = list(node.keys())
    probs = np.array([float(node[k]) for k in names], dtype=np.float64)
    if abs(probs.sum() - 1.0) > EPS:
        raise ValueError(f"probability map does not sum to 1: {node}")
    return names, probs


def _alphabet_of(root: dict) -> str:
    return "".join(sorted(str(c) for c in root["tracks"]["nukes"]))


def _germline_span(states: list, mangled_name: str):
    """Indices of the first/last state whose name contains the gene name."""
    lo = 0
    while mangled_name not in str(states[lo]["name"]):
        lo += 1
    hi = len(states) - 1
    while mangled_name not in str(states[hi]["name"]):
        hi -= 1
    return lo, hi


@dataclass
class GermlineGene:
    """All parameters of one germline gene's profile HMM, as numpy arrays.

    ``L`` is the germline length, ``A`` the alphabet size (4).
    """

    name: str                      # display name, e.g. "IGHV_ex*01"
    gtype: str                     # 'V' | 'D' | 'J'
    alphabet: str                  # e.g. "ACGT"
    gene_prob: float               # P(gene)
    landing_in: np.ndarray         # [L]  init -> position i
    landing_out: np.ndarray        # [L]  position i -> end
    transition: np.ndarray         # [L-1] position i -> i+1
    emission: np.ndarray           # [A, L] match emissions
    bases: np.ndarray              # [L] germline base codes
    # NTI sub-model (D and J genes only; insertions sit LEFT of the gene)
    nti_landing_in: Optional[np.ndarray] = None    # [A] init -> N_x
    nti_landing_out: Optional[np.ndarray] = None   # [A, L] N_x -> position i
    nti_transition: Optional[np.ndarray] = None    # [A, A] N_x -> N_y
    nti_emission: Optional[np.ndarray] = None      # [A, A] emitted x | state y
    # N-padding sub-model (V genes pad left, J genes pad right)
    n_transition: Optional[float] = None           # geometric self-transition
    n_emission: Optional[np.ndarray] = None        # [A], flat 0.25

    @property
    def length(self) -> int:
        return int(self.bases.shape[0])


def _parse_core(root: dict) -> GermlineGene:
    """Parse the shared germline-position parameters of one gene file."""
    alphabet = _alphabet_of(root)
    A = len(alphabet)
    mangled = str(root["name"])
    grx = _germline_state_re(mangled)

    states = root["states"]
    lo, hi = _germline_span(states, mangled)
    L = hi - lo + 1

    gg = GermlineGene(
        name=_unmangle(mangled),
        gtype="",  # filled by caller
        alphabet=alphabet,
        gene_prob=float(root["extras"]["gene_prob"]),
        landing_in=np.zeros(L),
        landing_out=np.zeros(L),
        transition=np.zeros(max(L - 1, 0)),
        emission=np.zeros((A, L)),
        bases=np.zeros(L, dtype=np.int32),
    )

    init = states[0]
    if str(init["name"]) != "init":
        raise ValueError("first state must be 'init'")
    for sname, p in zip(*_prob_map(init["transitions"])):
        m = grx.match(sname)
        if m:
            gg.landing_in[int(m.group(1))] = p
        elif not sname.startswith("insert_left_"):
            raise ValueError(f"unexpected init transition target {sname!r}")

    for idx in range(lo, hi + 1):
        st = states[idx]
        m = grx.match(str(st["name"]))
        if not m or int(m.group(1)) != idx - lo:
            raise ValueError(f"germline states out of order at {st['name']!r}")
        gi = idx - lo
        for sname, p in zip(*_prob_map(st["transitions"])):
            m2 = grx.match(sname)
            if m2:
                if int(m2.group(1)) != gi + 1:
                    raise ValueError("non-adjacent germline transition")
                gg.transition[gi] = p
            elif sname == "end":
                gg.landing_out[gi] = p
            elif sname != "insert_right_N":
                raise ValueError(f"unexpected transition target {sname!r}")
        if str(st["emissions"]["track"]) != "nukes":
            raise ValueError("expected 'nukes' emission track")
        for sname, p in zip(*_prob_map(st["emissions"]["probs"])):
            gg.emission[alphabet.index(sname[0]), gi] = p
        gg.bases[gi] = alphabet.index(str(st["extras"]["germline"]))

    return gg


def _parse_nti(root: dict, gg: GermlineGene) -> None:
    """Parse insert_left_[ACGT] (non-templated insertion) states."""
    alphabet = gg.alphabet
    A = len(alphabet)
    mangled = str(root["name"])
    grx = _germline_state_re(mangled)
    nrx = _nti_state_re(alphabet)
    states = root["states"]
    L = gg.length

    gg.nti_landing_in = np.zeros(A)
    gg.nti_landing_out = np.zeros((A, L))
    gg.nti_transition = np.zeros((A, A))
    gg.nti_emission = np.zeros((A, A))

    for sname, p in zip(*_prob_map(states[0]["transitions"])):
        m = nrx.match(sname)
        if m:
            gg.nti_landing_in[alphabet.index(m.group(1))] = p
        elif not grx.match(sname):
            raise ValueError(f"unexpected init transition target {sname!r}")

    for idx in range(1, A + 1):
        st = states[idx]
        m = nrx.match(str(st["name"]))
        if not m:
            raise ValueError(f"expected NTI state, got {st['name']!r}")
        b = alphabet.index(m.group(1))
        for sname, p in zip(*_prob_map(st["transitions"])):
            mg = grx.match(sname)
            if mg:
                gg.nti_landing_out[b, int(mg.group(1))] = p
            else:
                mn = nrx.match(sname)
                if not mn:
                    raise ValueError(f"unexpected NTI target {sname!r}")
                gg.nti_transition[b, alphabet.index(mn.group(1))] = p
        if str(st["emissions"]["track"]) != "nukes":
            raise ValueError("expected 'nukes' emission track")
        for sname, p in zip(*_prob_map(st["emissions"]["probs"])):
            gg.nti_emission[alphabet.index(sname[0]), b] = p


def _parse_npadding(root: dict, gg: GermlineGene) -> None:
    """Parse the insert_left_N (V) or insert_right_N (J) padding state."""
    alphabet = gg.alphabet
    mangled = str(root["name"])
    states = root["states"]
    lo, hi = _germline_span(states, mangled)

    if lo == 2:  # V gene: N-padding sits just before the germline block
        n_idx, check_idx = lo - 1, lo - 2
        n_name, next_name = "insert_left_N", mangled + "_0"
    else:        # J gene: N-padding is the penultimate state
        if hi != len(states) - 2:
            raise ValueError("cannot locate N-padding state")
        n_idx, check_idx = hi + 1, hi
        n_name, next_name = "insert_right_N", "end"

    n_state = states[n_idx]
    if str(n_state["name"]) != n_name:
        raise ValueError(f"expected {n_name}, got {n_state['name']!r}")

    # The padding state's transitions must mirror those of its predecessor
    # (the geometric structure the reference asserts, src/NPadding.cpp:80-92).
    n_trans = {str(k): float(v) for k, v in n_state["transitions"].items()}
    chk_trans = {
        str(k): float(v) for k, v in states[check_idx]["transitions"].items()
    }
    if set(n_trans) != set(chk_trans):
        raise ValueError("N-padding transitions disagree with checkpoint state")
    for k in n_trans:
        if abs(n_trans[k] - chk_trans[k]) > EPS:
            raise ValueError("N-padding transition probs disagree")
        if k == n_name:
            gg.n_transition = n_trans[k]
        elif k != next_name:
            raise ValueError(f"unexpected N-padding target {k!r}")

    gg.n_emission = np.zeros(len(alphabet))
    for sname, p in zip(*_prob_map(n_state["emissions"]["probs"])):
        if p != 0.25:
            raise ValueError("N-padding emissions must be flat 0.25")
        gg.n_emission[alphabet.index(sname[0])] = p
    if str(n_state["extras"]["germline"]) != "N":
        raise ValueError("N-padding germline symbol must be N")


def load_gene(path: str, gtype: str) -> GermlineGene:
    """Load one germline gene YAML as a GermlineGene of the given type."""
    with open(path) as fh:
        root = yaml.safe_load(fh)
    gg = _parse_core(root)
    gg.gtype = gtype
    if gtype in ("D", "J"):
        _parse_nti(root, gg)
    if gtype in ("V", "J"):
        _parse_npadding(root, gg)
    return gg


def _mangle(name: str) -> str:
    return name.replace("*", "_star_").replace("/", "_slash_")


def write_gene_yaml(gene: GermlineGene) -> str:
    """Render a GermlineGene back into the partis HMM YAML contract.

    Inverse of load_gene; used to materialize synthetic gene sets as real
    parameter directories (all probability maps sum to 1 by construction).
    """
    mangled = _mangle(gene.name)
    A, L = len(gene.alphabet), gene.length

    def prob_map(d: dict) -> str:
        items = ", ".join(f"{k}: {float(v)!r}" for k, v in d.items()
                          if float(v) != 0.0)
        return "{" + items + "}"

    def emission_map(col) -> str:
        return "{" + ", ".join(
            f"{b}: {float(col[i])!r}" for i, b in enumerate(gene.alphabet)
        ) + "}"

    lines = [f"extras: {{gene_prob: {gene.gene_prob!r}}}",
             f"name: {mangled}", "states:"]

    def state(sname, emis, extras, trans):
        if emis is None:
            lines.append("- emissions: null")
        else:
            lines.append("- emissions:")
            lines.append(f"    probs: {emis}")
            lines.append("    track: nukes")
        lines.append(f"  extras: {extras}")
        lines.append(f"  name: {sname}")
        lines.append(f"  transitions: {prob_map(trans)}")

    init_trans = {f"{mangled}_{i}": p
                  for i, p in enumerate(gene.landing_in) if p != 0}
    if gene.gtype == "V":
        init_trans["insert_left_N"] = gene.n_transition
    else:
        for i, b in enumerate(gene.alphabet):
            init_trans[f"insert_left_{b}"] = gene.nti_landing_in[i]
    state("init", None, "{}", init_trans)

    if gene.gtype == "V":
        flat = "{" + ", ".join(f"{b}: 0.25" for b in gene.alphabet) + "}"
        state("insert_left_N", flat,
              "{ambiguous_emission_prob: 0.25, germline: N}", init_trans)
    else:
        for bi, b in enumerate(gene.alphabet):
            trans = {f"{mangled}_{i}": p
                     for i, p in enumerate(gene.nti_landing_out[bi])
                     if p != 0}
            for bj, b2 in enumerate(gene.alphabet):
                trans[f"insert_left_{b2}"] = gene.nti_transition[bi, bj]
            state(f"insert_left_{b}", emission_map(gene.nti_emission[:, bi]),
                  f"{{germline: {b}}}", trans)

    for i in range(L):
        trans = {}
        if i < L - 1 and gene.transition[i] != 0:
            trans[f"{mangled}_{i + 1}"] = gene.transition[i]
        if gene.landing_out[i] != 0:
            trans["end"] = gene.landing_out[i]
        if gene.gtype == "J" and i == L - 1:
            trans["insert_right_N"] = gene.n_transition
        state(f"{mangled}_{i}", emission_map(gene.emission[:, i]),
              f"{{germline: {gene.alphabet[gene.bases[i]]}}}", trans)

    if gene.gtype == "J":
        flat = "{" + ", ".join(f"{b}: 0.25" for b in gene.alphabet) + "}"
        state("insert_right_N", flat,
              "{ambiguous_emission_prob: 0.25, germline: N}",
              {"end": 1.0 - gene.n_transition,
               "insert_right_N": gene.n_transition})

    lines.append("tracks:")
    lines.append("  nukes: [" + ", ".join(gene.alphabet) + "]")
    return "\n".join(lines) + "\n"


def write_gene_dir(genes: Dict[str, GermlineGene], out_dir: str) -> None:
    """Materialize a gene map as a partis HMM parameter directory."""
    os.makedirs(out_dir, exist_ok=True)
    for gene in genes.values():
        path = os.path.join(out_dir, _mangle(gene.name) + ".yaml")
        with open(path, "w") as fh:
            fh.write(write_gene_yaml(gene))


def load_gene_map(hmm_param_dir: str) -> Dict[str, GermlineGene]:
    """Scan a partis HMM parameter directory into a {name: gene} map.

    Mirrors the reference's directory contract (src/VDJGermline.cpp:46-108):
    files named ``IG[HKL][VDJ]*_star_*.yaml``; IGK/IGL "D" files are skipped;
    all genes must share one alphabet.
    """
    if not os.path.isdir(hmm_param_dir):
        raise FileNotFoundError(
            f"--hmm-param-dir {hmm_param_dir!r} does not exist"
        )
    genes: Dict[str, GermlineGene] = {}
    for fname in sorted(os.listdir(hmm_param_dir)):
        m = _GENE_FILE_RE.match(fname)
        if not m:
            continue
        locus_letter, gtype = m.group(2), m.group(3)
        if gtype == "D" and locus_letter in ("K", "L"):
            continue
        gg = load_gene(os.path.join(hmm_param_dir, fname), gtype)
        genes[gg.name] = gg

    if not genes:
        raise ValueError(f"no germline gene YAMLs found in {hmm_param_dir!r}")
    alphabets = {g.alphabet for g in genes.values()}
    if len(alphabets) != 1:
        raise ValueError(f"inconsistent alphabets across genes: {alphabets}")
    return genes
