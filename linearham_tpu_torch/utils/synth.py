"""Synthetic clonal families and posterior ensembles as pipeline inputs.

Produces a realistic-shape BCR problem (300+ site alignment, multiple
genes per segment, posterior tree ensembles) without any external data:
random germline gene parameter sets, a consistent Smith-Waterman window
layout, a mutated alignment, and random binary trees in Newick form.  The
generators are those of the JAX package's utils/synth.py, kept byte for
byte in what they write for a seed; the writers below turn them into the
files the pipeline, repertoire and bootstrap entry points read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from linearham_tpu_torch.io.germline import GermlineGene, write_gene_dir
from linearham_tpu_torch.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu_torch.postprocess.parse_cluster import parse_cluster

__all__ = ["PipelineInputs", "RepertoireInputs", "SyntheticFamily",
           "TreeSamples", "load_tree_samples", "make_family",
           "make_light_family", "make_tree_samples", "write_family_fasta",
           "write_partis_yaml", "write_pipeline_inputs",
           "write_repertoire_inputs", "write_trees_tsv"]

ALPHABET = "ACGT"


def _emission_matrix(rng, bases: np.ndarray, fidelity=0.92) -> np.ndarray:
    L = len(bases)
    out = np.full((4, L), (1 - fidelity) / 3)
    out[bases, np.arange(L)] = fidelity
    return out


def _make_gene(rng, name: str, gtype: str, length: int) -> GermlineGene:
    """One synthetic gene with properly normalized probability maps.

    Invariants kept (so the gene roundtrips through the partis YAML
    ingestion contract): landing_in (+N-padding / NTI entry mass) sums to
    1; per-position continue + exit sums to 1; NTI rows sum to 1; a J
    gene's last position exits with 1 - n_transition (the rest enters the
    right N-padding).
    """
    bases = rng.integers(0, 4, size=length).astype(np.int32)
    n_entry = min(4, length)
    n_exit = min(5, length)
    n_self = 0.9 if gtype in ("V", "J") else None

    landing_in = np.zeros(length)
    if gtype == "V":
        # The N-padding contract pins V entry to position 0: init (and
        # insert_left_N) may only transition to V_0 / insert_left_N.
        landing_in[0] = 1.0 - n_self
    else:
        landing_in[:n_entry] = rng.dirichlet(
            [3.0] + [1.0] * (n_entry - 1)) * 0.5

    landing_out = np.zeros(length)
    landing_out[-n_exit:-1] = np.linspace(0.05, 0.6, n_exit - 1)
    landing_out[-1] = (1.0 - n_self) if gtype == "J" else 1.0
    transition = 1.0 - landing_out[:-1]

    gene = GermlineGene(
        name=name, gtype=gtype, alphabet=ALPHABET,
        gene_prob=1.0,  # normalized by caller across genes of a type
        landing_in=landing_in, landing_out=landing_out,
        transition=transition,
        emission=_emission_matrix(rng, bases),
        bases=bases,
    )
    if gtype in ("D", "J"):
        gene.nti_landing_in = rng.dirichlet([2.0] * 4) * 0.5
        nlo = np.zeros((4, length))
        nlo[:, :n_entry] = np.tile(
            rng.dirichlet([2.0] * n_entry) * 0.6, (4, 1))
        gene.nti_landing_out = nlo
        gene.nti_transition = np.tile(
            rng.dirichlet([2.0] * 4) * 0.4, (4, 1))
        gene.nti_emission = np.full((4, 4), 0.05) + np.eye(4) * 0.8
    if gtype in ("V", "J"):
        gene.n_transition = n_self
        gene.n_emission = np.full(4, 0.25)
    return gene


@dataclass
class SyntheticFamily:
    genes: Dict[str, GermlineGene]
    locus: str
    flexbounds: Dict[str, Tuple[int, int]]
    relpos: Dict[str, int]
    naive_seq_codes: np.ndarray        # [L]
    msa: np.ndarray                    # [n_seqs, L] int codes incl. N=4
    unique_ids: List[str]
    n_sites: int


def make_family(
    n_seqs: int = 10,
    n_v: int = 3,
    n_d: int = 3,
    n_j: int = 2,
    v_len: int = 290,
    d_len: int = 30,
    j_len: int = 55,
    mutation_rate: float = 0.05,
    seed: int = 0,
    ambig_rate: float = 0.0,
) -> SyntheticFamily:
    """Build one synthetic igh clonal family (~v_len+80 sites)."""
    rng = np.random.default_rng(seed)

    genes: Dict[str, GermlineGene] = {}
    relpos: Dict[str, int] = {}
    v_end = 1 + v_len                       # 291 for defaults
    d_rel = v_end - 3                       # D starts inside the V tail
    j_rel = d_rel + d_len - 3
    L = j_rel + j_len
    flexbounds = {
        "v_l": (0, 2),
        "v_r": (v_end - 7, v_end - 3),
        "d_l": (v_end - 2, v_end + 2),
        "d_r": (d_rel + d_len - 9, d_rel + d_len - 5),
        "j_l": (d_rel + d_len - 4, d_rel + d_len),
        "j_r": (L, L),
    }

    for kind, count, length, rel in (
            ("V", n_v, v_len, 1), ("D", n_d, d_len, d_rel),
            ("J", n_j, j_len, j_rel)):
        for k in range(count):
            name = f"IGH{kind}_syn*{k:02d}"
            g = _make_gene(rng, name, kind, length)
            g.gene_prob = 1.0 / count
            genes[name] = g
            relpos[name] = rel

    # Naive sequence: follow the first gene of each segment.
    naive = rng.integers(0, 4, size=L).astype(np.int32)
    for name, g in genes.items():
        rel = relpos[name]
        if name.endswith("*00"):
            naive[rel:rel + g.length] = g.bases[:L - rel]

    msa = np.tile(naive, (n_seqs, 1))
    mut = rng.random(msa.shape) < mutation_rate
    msa[mut] = rng.integers(0, 4, size=mut.sum())
    if ambig_rate > 0:
        msa[rng.random(msa.shape) < ambig_rate] = 4  # ambiguous N reads

    return SyntheticFamily(
        genes=genes, locus="igh", flexbounds=flexbounds, relpos=relpos,
        naive_seq_codes=naive, msa=msa,
        unique_ids=[f"seq{i}" for i in range(n_seqs)],
        n_sites=L,
    )


def make_light_family(
    n_seqs: int = 6,
    n_v: int = 2,
    n_j: int = 2,
    v_len: int = 280,
    j_len: int = 50,
    mutation_rate: float = 0.05,
    seed: int = 0,
) -> SyntheticFamily:
    """Build one synthetic igk clonal family (V-J, no D segment).

    Mirrors ``make_family``'s geometry with the J gene taking the D's
    place: the single VJ junction window spans the V 3' flex through the
    J 5' flex (the reference's 5-region light-chain state space,
    src/HMM.cpp; igk/igl skip D genes entirely).
    """
    rng = np.random.default_rng(seed)

    genes: Dict[str, GermlineGene] = {}
    relpos: Dict[str, int] = {}
    v_end = 1 + v_len
    j_rel = v_end - 3                       # J starts inside the V tail
    L = j_rel + j_len
    flexbounds = {
        "v_l": (0, 2),
        "v_r": (v_end - 7, v_end - 3),
        "j_l": (v_end - 2, v_end + 2),
        "j_r": (L, L),
    }

    for kind, count, length, rel in (
            ("V", n_v, v_len, 1), ("J", n_j, j_len, j_rel)):
        for k in range(count):
            name = f"IGK{kind}_syn*{k:02d}"
            g = _make_gene(rng, name, kind, length)
            g.gene_prob = 1.0 / count
            genes[name] = g
            relpos[name] = rel

    naive = rng.integers(0, 4, size=L).astype(np.int32)
    for name, g in genes.items():
        rel = relpos[name]
        if name.endswith("*00"):
            naive[rel:rel + g.length] = g.bases[:L - rel]

    msa = np.tile(naive, (n_seqs, 1))
    mut = rng.random(msa.shape) < mutation_rate
    msa[mut] = rng.integers(0, 4, size=mut.sum())

    return SyntheticFamily(
        genes=genes, locus="igk", flexbounds=flexbounds, relpos=relpos,
        naive_seq_codes=naive, msa=msa,
        unique_ids=[f"seq{i}" for i in range(n_seqs)],
        n_sites=L,
    )


def _codes_to_str(codes: np.ndarray) -> str:
    return "".join((ALPHABET + "N")[c] for c in codes)


def write_partis_yaml(
    family: SyntheticFamily,
    path: str,
    shm_indel_ids: Tuple[int, ...] = (),
    unmutated_ids: Tuple[int, ...] = (),
    seed: int = 0,
) -> None:
    """Materialize a family as a full-schema partis output YAML.

    Produces the realistic ingestion contract a real ``partis partition
    --extra-annotation-columns linearham-info`` run emits (reference
    boundary: src/HMM.cpp:27-83 and scripts/write_lh_annotations.py):
    ``germline-info`` with per-region gene sequences and conserved-codon
    positions, a ``partitions`` list, and one event with input +
    indel-reversed sequences, ``has_shm_indels`` variety, duplicates, and
    the ``linearham-info`` flexbounds/relpos block.

    ``shm_indel_ids``: member indices whose *input* sequence carries a 3-nt
    insertion (the aligned version goes into ``indel_reversed_seqs``).
    ``unmutated_ids``: member indices forced identical to the naive
    sequence (a common real-data case partis emits).
    """
    import yaml

    rng = np.random.default_rng(seed)
    naive = _codes_to_str(family.naive_seq_codes)
    ids = list(family.unique_ids)

    gl_seqs: Dict[str, Dict[str, str]] = {"v": {}, "d": {}, "j": {}}
    for name, g in family.genes.items():
        gl_seqs[g.gtype.lower()][name] = _codes_to_str(g.bases)

    v0 = next(n for n, g in family.genes.items() if g.gtype == "V")
    cyst = {n: 3 * ((len(s) - 25) // 3) for n, s in gl_seqs["v"].items()}
    tryp = {n: 9 for n in gl_seqs["j"]}

    input_seqs, reversed_seqs, has_shm = [], [], []
    for i in range(len(ids)):
        aligned = _codes_to_str(family.msa[i])
        if i in unmutated_ids:
            aligned = naive
        if i in shm_indel_ids:
            pos = int(rng.integers(40, len(aligned) - 40))
            ins = "".join(rng.choice(list(ALPHABET), 3))
            input_seqs.append(aligned[:pos] + ins + aligned[pos:])
            reversed_seqs.append(aligned)
            has_shm.append(True)
        else:
            input_seqs.append(aligned)
            reversed_seqs.append("")
            has_shm.append(False)

    event = {
        "unique_ids": ids,
        "input_seqs": input_seqs,
        "indel_reversed_seqs": reversed_seqs,
        "has_shm_indels": has_shm,
        "naive_seq": naive,
        "v_gene": v0,
        "j_gene": next(
            n for n, g in family.genes.items() if g.gtype == "J"),
        "duplicates": [[] for _ in ids],
        "linearham-info": {
            "flexbounds": {k: list(v) for k, v in family.flexbounds.items()},
            "relpos": dict(family.relpos),
        },
    }
    d_genes = [n for n, g in family.genes.items() if g.gtype == "D"]
    if d_genes:                       # igk/igl events carry no d_gene
        event["d_gene"] = d_genes[0]
    root = {
        "version-info": {"partis-yaml": "0.1"},
        "germline-info": {
            "locus": family.locus,
            "seqs": gl_seqs,
            "cyst-positions": cyst,
            "tryp-positions": tryp,
        },
        "partitions": [{"logprob": -1234.5, "n_procs": 1,
                        "partition": [ids]}],
        "events": [event],
    }
    with open(path, "w") as fh:
        yaml.safe_dump(root, fh, sort_keys=False, width=10 ** 6)


def write_trees_tsv(samples: TreeSamples, path: str,
                    index_comments: bool = True) -> None:
    """Write a posterior ensemble in the RevBayes output TSV contract.

    ``index_comments`` adds the ``[&index=N]`` node comments RevBayes
    emits (the reference strips them, src/PhyloHMM.cpp:419-420).
    """
    cols = (["Iteration", "Likelihood", "Prior", "alpha"]
            + [f"er[{i}]" for i in range(1, 7)]
            + [f"pi[{i}]" for i in range(1, 5)] + ["tree"])
    with open(path, "w") as fh:
        fh.write("\t".join(cols) + "\n")
        for t in range(samples.n_samples):
            nwk = samples.newicks[t]
            if index_comments:
                # Tag each tip label with a RevBayes-style index comment.
                import re

                counter = [0]

                def tag(m):
                    counter[0] += 1
                    return m.group(0) + f"[&index={counter[0]}]"

                nwk = re.sub(r"[A-Za-z_][\w.|-]*", tag, nwk)
            row = ([str(int(samples.iteration[t])),
                    repr(float(samples.rb_loglik[t])),
                    repr(float(samples.prior[t])),
                    repr(float(samples.alpha[t]))]
                   + [repr(float(x)) for x in samples.er[t]]
                   + [repr(float(x)) for x in samples.pi[t]]
                   + [nwk])
            fh.write("\t".join(row) + "\n")


def random_newick(rng, labels: List[str]) -> str:
    """Random binary tree over the given labels with random branch lengths."""
    nodes = [f"{lab}:{rng.uniform(0.01, 0.3):.5f}" for lab in labels]
    while len(nodes) > 2:
        i, j = sorted(rng.choice(len(nodes), size=2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.uniform(0.01, 0.3):.5f}")
    return f"({nodes[0]},{nodes[1]});" if len(nodes) == 2 \
        else f"({nodes[0]});"


def make_tree_samples(family: SyntheticFamily, n_trees: int,
                      seed: int = 0) -> TreeSamples:
    """A synthetic posterior ensemble over the family's taxa."""
    rng = np.random.default_rng(seed)
    labels = ["naive"] + list(family.unique_ids)
    newicks = [random_newick(rng, labels) for _ in range(n_trees)]
    return TreeSamples(
        iteration=np.arange(n_trees) * 10,
        rb_loglik=-rng.uniform(900, 1100, n_trees),
        prior=-rng.uniform(10, 20, n_trees),
        alpha=rng.uniform(0.4, 3.0, n_trees),
        er=rng.uniform(0.5, 2.0, (n_trees, 6)),
        pi=rng.dirichlet([8.0] * 4, n_trees),
        newicks=newicks,
    )


@dataclass
class PipelineInputs:
    """Paths of one family's pipeline inputs, and the family itself."""

    family: SyntheticFamily
    yaml_path: str
    gene_dir: str
    trees_path: str


def write_pipeline_inputs(outdir: str, n_seqs: int, n_trees: int,
                          seed: int = 0) -> PipelineInputs:
    """Write a synthetic igh family's partis YAML, germline directory and a
    RevBayes-style posterior TSV of ``n_trees`` trees into ``outdir``."""
    fam = make_family(n_seqs=n_seqs, seed=seed)
    gene_dir = os.path.join(outdir, "hmm_params")
    write_gene_dir(fam.genes, gene_dir)
    yaml_path = os.path.join(outdir, "partis_run.yaml")
    write_partis_yaml(fam, yaml_path, seed=seed)
    trees_path = os.path.join(outdir, "revbayes_run.trees")
    write_trees_tsv(make_tree_samples(fam, n_trees, seed=seed), trees_path)
    return PipelineInputs(fam, yaml_path, gene_dir, trees_path)


def write_family_fasta(yaml_path: str, outdir: str) -> str:
    """Write the clonal family FASTA (the partis naive sequence first, then
    every member) of the YAML's only cluster into ``outdir``; returns its
    path.  This is the FASTA the bootstrap/ASR stage reads."""
    fasta = os.path.join(outdir, "cluster_seqs.fasta")
    parse_cluster(yaml_path, os.path.join(outdir, "cluster.yaml"), fasta)
    return fasta


@dataclass
class RepertoireInputs:
    """One locus of a synthetic repertoire: the ``repertoire`` manifest,
    the shared germline directory, and each family's inputs and output."""

    manifest: str
    gene_dir: str
    families: List[PipelineInputs]
    outputs: List[str]


def write_repertoire_inputs(
        outdir: str, specs: Sequence[Tuple[str, int, int, float]],
        seed: int = 0) -> Dict[str, RepertoireInputs]:
    """Write a mixed-depth repertoire's inputs into ``outdir``.

    ``specs`` holds one ``(locus, n_seqs, n_trees, mutation_rate)`` per
    family, locus "igh" or "igk".  Every family of a locus is drawn with the
    same ``seed``: the generators draw the genes (and the naive sequence)
    first, so the families of a locus share one germline directory and
    differ in depth, mutations and trees (family ``i``'s trees use seed
    ``seed + i``).  Per locus it writes ``<locus>_hmm_params/``, one
    ``<locus>_<i>/`` directory per family (partis YAML, RevBayes TSV; the
    output path is ``lh_revbayes_run.trees`` there) and
    ``<locus>_manifest.tsv`` (yaml, cluster index, trees, output per line).
    Returns the inputs by locus.
    """
    makers = {"igh": make_family, "igk": make_light_family}
    out: Dict[str, RepertoireInputs] = {}
    for i, (locus, n_seqs, n_trees, rate) in enumerate(specs):
        fam = makers[locus](n_seqs=n_seqs, seed=seed, mutation_rate=rate)
        if locus not in out:
            gene_dir = os.path.join(outdir, f"{locus}_hmm_params")
            write_gene_dir(fam.genes, gene_dir)
            out[locus] = RepertoireInputs(
                os.path.join(outdir, f"{locus}_manifest.tsv"), gene_dir, [],
                [])
        rep = out[locus]
        d = os.path.join(outdir, f"{locus}_{i:02d}")
        os.makedirs(d, exist_ok=True)
        yaml_path = os.path.join(d, "partis_run.yaml")
        write_partis_yaml(fam, yaml_path, seed=seed)
        trees_path = os.path.join(d, "revbayes_run.trees")
        write_trees_tsv(make_tree_samples(fam, n_trees, seed=seed + i),
                        trees_path)
        rep.families.append(
            PipelineInputs(fam, yaml_path, rep.gene_dir, trees_path))
        rep.outputs.append(os.path.join(d, "lh_revbayes_run.trees"))
    for rep in out.values():
        with open(rep.manifest, "w") as fh:
            for files, dst in zip(rep.families, rep.outputs):
                fh.write(f"{files.yaml_path}\t0\t{files.trees_path}\t"
                         f"{dst}\n")
    return out
