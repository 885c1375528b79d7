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

from linearham_tpu.io.germline import write_gene_dir
from linearham_tpu.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu.postprocess.parse_cluster import parse_cluster
from linearham_tpu.utils.synth import (SyntheticFamily, make_family,
                                       make_tree_samples, write_partis_yaml,
                                       write_trees_tsv)

__all__ = ["PipelineInputs", "SyntheticFamily", "TreeSamples",
           "load_tree_samples", "make_family", "make_tree_samples",
           "write_family_fasta", "write_pipeline_inputs"]


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
