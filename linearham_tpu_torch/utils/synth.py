"""Synthetic clonal families and posterior ensembles as pipeline inputs.

The generators are those of linearham_tpu/utils/synth.py, which are numpy
only and load without jax; the family FASTA comes from the jax-free
linearham_tpu/postprocess/parse_cluster.py.  This module is the port's one
door to them, so the port's scripts (chip_smoke.py, benchmarks) import
nothing of the JAX package themselves.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from linearham_tpu.io.germline import write_gene_dir
from linearham_tpu.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu.postprocess.parse_cluster import parse_cluster
from linearham_tpu.utils.synth import (SyntheticFamily, make_family,
                                       make_light_family, make_tree_samples,
                                       write_partis_yaml, write_trees_tsv)

__all__ = ["PipelineInputs", "RepertoireInputs", "SyntheticFamily",
           "TreeSamples", "load_tree_samples", "make_family",
           "make_light_family", "make_tree_samples", "write_family_fasta",
           "write_pipeline_inputs", "write_repertoire_inputs"]


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
