"""The port's linearham_annotations_{best,all}.yaml, heavy and light
(mirrors tests/test_annotation_schema.py).

The port's workflow runs a synthetic family on the CPU (f64); its two
annotation YAMLs must pass the JAX test's partis schema checks, and the
JAX package's ``write_lh_annotations`` on the same cluster YAML, bootstrap
log and annotated trees must write them byte for byte.
"""

import pytest
import torch

from linearham_tpu.postprocess.annotations import \
    write_lh_annotations as jax_write_lh_annotations
from linearham_tpu_torch.io.germline import write_gene_dir
from linearham_tpu_torch.utils.synth import (make_family, make_light_family,
                                             make_tree_samples,
                                             write_partis_yaml,
                                             write_trees_tsv)
from linearham_tpu_torch.workflow import run_family_workflow
from test_annotation_schema import _validate_outputs

torch.set_num_threads(1)


@pytest.mark.parametrize("heavy, n_seqs, n_trees, seed", [
    (True, 6, 24, 21), (False, 5, 16, 22)], ids=["heavy", "light"])
def test_annotation_yamls_match_jax(heavy, n_seqs, n_trees, seed, tmp_path,
                                    monkeypatch):
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    family = (make_family if heavy else make_light_family)(n_seqs=n_seqs,
                                                           seed=seed)
    out = tmp_path / "wf"
    out.mkdir()
    write_gene_dir(family.genes, str(tmp_path / "hmm_params"))
    write_partis_yaml(family, str(tmp_path / "partis_run.yaml"), seed=seed)
    write_trees_tsv(make_tree_samples(family, n_trees, seed=seed),
                    str(out / "revbayes_run.trees"))
    run_family_workflow(
        str(out), partis_yaml_file=str(tmp_path / "partis_run.yaml"),
        hmm_param_dir=str(tmp_path / "hmm_params"), mcmc_iter=10,
        mcmc_thin=1, tune_iter=0, tune_thin=1, num_rates=4, burnin_frac=0.0,
        subsamp_frac=0.5, seed=seed, precision="f64", device="cpu")
    _validate_outputs(out, heavy=heavy, n_seqs=n_seqs)

    jax_write_lh_annotations(str(out / "cluster.yaml"),
                             str(out / "linearham_run.log"),
                             str(out / "linearham_run.trees"),
                             str(tmp_path / "jax_annotations"))
    for kind in ("best", "all"):
        assert (out / f"linearham_annotations_{kind}.yaml").read_bytes() == \
            (tmp_path / f"jax_annotations_{kind}.yaml").read_bytes(), kind
