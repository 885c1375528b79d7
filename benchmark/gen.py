"""Synthetic clonal families and posterior ensembles, generated fast.

The files are those the port reads (a partis output YAML, a partis HMM
germline directory, a RevBayes posterior TSV), in the formats of
``linearham_tpu_torch/utils/synth.py``; the draws are the benchmark's own.
Trees are random rooted binary trees drawn for a whole ensemble in a few
numpy calls: the loop that joins two nodes per step does no random draws
and no formatting of its own.

Every function takes a ``numpy.random.Generator``; the harness derives
one per input from ``--seed``, so a seed gives the same files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.frozen.germline import (  # noqa: F401
    GermlineGene, write_gene_dir)

ALPHABET = "ACGT"
TSV_COLUMNS = (["Iteration", "Likelihood", "Prior", "alpha"]
               + [f"er[{i}]" for i in range(1, 7)]
               + [f"pi[{i}]" for i in range(1, 5)] + ["tree"])


def _make_gene(rng, name: str, gtype: str, length: int) -> GermlineGene:
    """One gene whose probability maps are normalised as the partis HMM
    files require (see utils/synth.py of the port for the invariants)."""
    bases = rng.integers(0, 4, size=length).astype(np.int32)
    n_entry, n_exit = min(4, length), min(5, length)
    n_self = 0.9 if gtype in ("V", "J") else None
    landing_in = np.zeros(length)
    if gtype == "V":
        landing_in[0] = 1.0 - n_self
    else:
        landing_in[:n_entry] = rng.dirichlet(
            [3.0] + [1.0] * (n_entry - 1)) * 0.5
    landing_out = np.zeros(length)
    landing_out[-n_exit:-1] = np.linspace(0.05, 0.6, n_exit - 1)
    landing_out[-1] = (1.0 - n_self) if gtype == "J" else 1.0
    emission = np.full((4, length), 0.08 / 3)
    emission[bases, np.arange(length)] = 0.92
    gene = GermlineGene(
        name=name, gtype=gtype, alphabet=ALPHABET, gene_prob=1.0,
        landing_in=landing_in, landing_out=landing_out,
        transition=1.0 - landing_out[:-1], emission=emission, bases=bases)
    if gtype in ("D", "J"):
        gene.nti_landing_in = rng.dirichlet([2.0] * 4) * 0.5
        nlo = np.zeros((4, length))
        nlo[:, :n_entry] = np.tile(
            rng.dirichlet([2.0] * n_entry) * 0.6, (4, 1))
        gene.nti_landing_out = nlo
        gene.nti_transition = np.tile(rng.dirichlet([2.0] * 4) * 0.4, (4, 1))
        gene.nti_emission = np.full((4, 4), 0.05) + np.eye(4) * 0.8
    if gtype in ("V", "J"):
        gene.n_transition = n_self
        gene.n_emission = np.full(4, 0.25)
    return gene


@dataclass
class Germline:
    """One germline directory's genes and the alignment layout they fix."""

    locus: str
    genes: Dict[str, GermlineGene]
    relpos: Dict[str, int]
    flexbounds: Dict[str, Tuple[int, int]]
    n_sites: int
    first: Dict[str, str]      # the gene of each segment the naive follows


def gene_name(imgt: str) -> str:
    """The synthetic gene that stands for an IMGT gene, ``IGHV1-2*02`` ->
    ``IGHV1-2_syn*02``: its length, not its sequence."""
    base, allele = imgt.split("*")
    return f"{base}_syn*{allele}"


def make_germline(rng, locus: str, V, J, D=()) -> Germline:
    """Genes and the Smith-Waterman window layout of one locus.  ``V``,
    ``D`` and ``J`` list ``[IMGT gene, length]`` pairs; each gene gets
    random bases of that length.  V genes end at one site and D and J
    genes start at one (a shorter V is padded with N on the left, a
    shorter J on the right).  The windows are those of utils/synth.py's
    make_family / make_light_family, widened as partis's are to hold
    every candidate gene's ends: the D germline window is the shortest D
    gene's, and J starts where the longest D gene may end, so that each
    D gene can leave the D-J junction."""
    v_len = max(n for _, n in V)
    v_end = 1 + v_len
    v_short = v_len - min(n for _, n in V)
    if locus == "igh":
        d_rel = v_end - 3
        d_min, d_max = min(n for _, n in D), max(n for _, n in D)
        j_rel = d_rel + d_max - 3
        flexbounds = {
            "v_l": (0, 2 + v_short), "v_r": (v_end - 7, v_end - 3),
            "d_l": (v_end - 2, v_end + 2),
            "d_r": (d_rel + d_min - 9, d_rel + d_min - 5),
            "j_l": (j_rel - 1, j_rel + 3)}
        kinds = (("V", V, None), ("D", D, d_rel), ("J", J, j_rel))
    elif locus == "igk":
        j_rel = v_end - 3
        flexbounds = {"v_l": (0, 2 + v_short),
                      "v_r": (v_end - 7, v_end - 3),
                      "j_l": (v_end - 2, v_end + 2)}
        kinds = (("V", V, None), ("J", J, j_rel))
    else:
        raise ValueError(f"unsupported locus {locus!r}")
    n_sites = j_rel + max(n for _, n in J)
    flexbounds["j_r"] = (j_rel + min(n for _, n in J), n_sites)
    genes, relpos, first = {}, {}, {}
    for kind, members, rel in kinds:
        for imgt, length in members:
            name = gene_name(imgt)
            gene = _make_gene(rng, name, kind, int(length))
            gene.gene_prob = 1.0 / len(members)
            genes[name] = gene
            relpos[name] = v_end - int(length) if rel is None else rel
            first.setdefault(kind, name)
    return Germline(locus, genes, relpos, flexbounds, n_sites, first)


@dataclass
class Family:
    germline: Germline
    naive: np.ndarray          # [L] codes
    msa: np.ndarray            # [n_seqs, L] codes, N = 4
    unique_ids: List[str]


def make_family(rng, germline: Germline, n_seqs: int, mutation_rate: float,
                ambig_rate: float = 0.0) -> Family:
    """A clonal family: a naive sequence that follows each segment's first
    gene, and ``n_seqs`` mutated copies of it."""
    L = germline.n_sites
    naive = rng.integers(0, 4, size=L).astype(np.int32)
    for name in germline.first.values():
        g, rel = germline.genes[name], germline.relpos[name]
        naive[rel:rel + g.length] = g.bases[:L - rel]
    msa = np.tile(naive, (n_seqs, 1))
    mut = rng.random(msa.shape) < mutation_rate
    msa[mut] = rng.integers(0, 4, size=int(mut.sum()))
    if ambig_rate > 0:
        msa[rng.random(msa.shape) < ambig_rate] = 4
    return Family(germline, naive, msa, [f"seq{i}" for i in range(n_seqs)])


def _codes(codes) -> str:
    return "".join((ALPHABET + "N")[c] for c in codes)


def write_partis_yaml(family: Family, path: str) -> None:
    """The partis output YAML of one family (one event, cluster index 0)
    with its ``linearham-info`` block."""
    import yaml

    gl = family.germline
    ids = list(family.unique_ids)
    seqs: Dict[str, Dict[str, str]] = {"v": {}, "d": {}, "j": {}}
    for name, g in gl.genes.items():
        seqs[g.gtype.lower()][name] = _codes(g.bases)
    first = {t: gl.first.get(t) for t in "VDJ"}
    event = {
        "unique_ids": ids,
        "input_seqs": [_codes(row) for row in family.msa],
        "indel_reversed_seqs": [""] * len(ids),
        "has_shm_indels": [False] * len(ids),
        "naive_seq": _codes(family.naive),
        "v_gene": first["V"],
        "j_gene": first["J"],
        "duplicates": [[] for _ in ids],
        "linearham-info": {
            "flexbounds": {k: list(v) for k, v in gl.flexbounds.items()},
            "relpos": dict(gl.relpos)},
    }
    if first["D"] is not None:
        event["d_gene"] = first["D"]
    root = {
        "version-info": {"partis-yaml": "0.1"},
        "germline-info": {
            "locus": gl.locus, "seqs": seqs,
            "cyst-positions": {n: 3 * ((len(s) - 25) // 3)
                               for n, s in seqs["v"].items()},
            "tryp-positions": {n: 9 for n in seqs["j"]}},
        "partitions": [{"logprob": -1234.5, "n_procs": 1,
                        "partition": [ids]}],
        "events": [event],
    }
    with open(path, "w") as fh:
        yaml.safe_dump(root, fh, sort_keys=False, width=10 ** 6)


def random_newicks(rng, labels: List[str], n_trees: int) -> List[str]:
    """``n_trees`` random rooted binary trees over ``labels`` (at least
    two), branch lengths uniform on [0.01, 0.3], each tip carrying a
    RevBayes ``[&index=N]`` comment.

    Each step joins two distinct nodes of the ``m`` left into one; the
    indices come from two uniform draws made up front for the whole
    ensemble.
    """
    n = len(labels)
    if n < 2:
        raise ValueError("a tree needs two tips at least")
    picks = rng.random((n_trees, n - 2, 2))
    lengths = rng.uniform(0.01, 0.3, (n_trees, 2 * n - 2))
    m = np.arange(n, 2, -1)                                   # nodes left
    first = (picks[:, :, 0] * m).astype(np.int64)
    second = (picks[:, :, 1] * (m - 1)).astype(np.int64)
    second += second >= first
    tips = [f"{lab}[&index={i + 1}]:" for i, lab in enumerate(labels)]
    out = []
    for t in range(n_trees):
        ls = [f"{x:.5f}" for x in lengths[t].tolist()]
        nodes = [tip + ls[i] for i, tip in enumerate(tips)]
        for k, (i, j) in enumerate(zip(first[t].tolist(),
                                       second[t].tolist())):
            joined = f"({nodes[i]},{nodes[j]}):{ls[n + k]}"
            lo, hi = (i, j) if i < j else (j, i)
            nodes[lo] = joined
            nodes[hi] = nodes[-1]
            nodes.pop()
        out.append(f"({nodes[0]},{nodes[1]});")
    return out


def write_trees_tsv(rng, family: Family, n_trees: int, path: str) -> None:
    """A RevBayes posterior TSV of ``n_trees`` samples over the family's
    tips (the naive sequence and every member)."""
    newicks = random_newicks(rng, ["naive"] + family.unique_ids, n_trees)
    rb = -rng.uniform(900, 1100, n_trees)
    prior = -rng.uniform(10, 20, n_trees)
    alpha = rng.uniform(0.4, 3.0, n_trees)
    er = rng.uniform(0.5, 2.0, (n_trees, 6))
    pi = rng.dirichlet([8.0] * 4, n_trees)
    nums = np.concatenate([rb[:, None], prior[:, None], alpha[:, None], er,
                           pi], axis=1).tolist()
    lines = ["\t".join(TSV_COLUMNS)]
    for t in range(n_trees):
        lines.append("\t".join([str(10 * t)] + [repr(x) for x in nums[t]]
                               + [newicks[t]]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")

