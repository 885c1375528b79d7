"""Degenerate inputs through the port, against the JAX package (mirrors
tests/test_edge_cases.py).

* Seven malformed Smith-Waterman summaries: the port's
  ``build_state_space`` raises the JAX package's exception with the same
  message for each.
* A one-sequence clonal family (the smallest schedule: two tips), 4 trees,
  R = 4: the port's CPU pipeline (f64) equals the JAX pipeline's
  log-likelihoods at rtol 1e-9, every naive sequence of full length.
* ``cuda`` (skipped without a GPU): the same family through the kernel, f64
  within 1e-6 nats and f32 within 1e-2 nats of the CPU's f64.  The JAX
  package is imported inside the tests that use it, so the file runs on a
  machine without jax (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch
import yaml

from linearham_tpu_torch.compiler.state_space import build_state_space
from linearham_tpu_torch.io.germline import load_gene_map
from linearham_tpu_torch.io.partis import load_cluster

torch.set_num_threads(1)

BOUNDS = {"v_l": (0, 2), "v_r": (4, 6), "d_l": (7, 8),
          "d_r": (9, 10), "j_l": (11, 12), "j_r": (15, 15)}
RELPOS = {"IGHD_ex*01": 5, "IGHJ_ex*01": 10, "IGHV_ex*01": 1}
F64_BOUND = 1e-6     # nats, the f64 kernel vs the CPU's f64
F32_BOUND = 1e-2     # nats, the f32 kernel vs the CPU's f64 (|ll| ~ 200)


def _empty_d_germline(fixtures_dir, tmp_path):
    """The simple fixture with flexbounds that squeeze the whole D match
    into the junctions (a zero-width D germline region)."""
    root = yaml.safe_load((fixtures_dir / "simple_hmm_input.yaml").read_text())
    root["events"][0]["linearham-info"]["flexbounds"]["d_r"] = [8, 10]
    path = tmp_path / "empty_dgerm.yaml"
    path.write_text(yaml.safe_dump(root, sort_keys=False))
    return str(path)


def _args(case, fixtures_dir, tmp_path, cluster_of):
    """(locus, flexbounds, relpos) of one rejection case."""
    fb = dict(BOUNDS)
    relpos = dict(RELPOS)
    if case == "zero_width_junction":
        fb.update(v_r=(5, 5), d_l=(5, 5))
    elif case == "missing_window":
        del fb["d_r"]
    elif case == "reversed_window":
        fb["v_r"] = (6, 4)
    elif case == "out_of_order_windows":
        fb["d_l"] = (2, 3)
    elif case == "unknown_gene":
        relpos["IGHV_missing*01"] = 1
    elif case == "gene_not_spanning_window":
        relpos["IGHJ_ex*01"] = 13       # a 5-long J starting at 13
    elif case == "empty_d_germline_region":
        cluster = cluster_of(_empty_d_germline(fixtures_dir, tmp_path), 0)
        return cluster.locus, cluster.flexbounds, cluster.relpos
    return "igh", fb, relpos


@pytest.mark.parametrize("case", [
    "zero_width_junction", "missing_window", "reversed_window",
    "out_of_order_windows", "unknown_gene", "empty_d_germline_region",
    "gene_not_spanning_window"])
def test_rejection_matches_jax(case, fixtures_dir, tmp_path):
    from linearham_tpu.compiler.state_space import \
        build_state_space as jax_build_state_space
    from linearham_tpu.io.germline import load_gene_map as jax_load_gene_map
    from linearham_tpu.io.partis import load_cluster as jax_load_cluster

    params = str(fixtures_dir / "hmm_params")
    with pytest.raises(ValueError) as want:
        jax_build_state_space(*_args(case, fixtures_dir, tmp_path,
                                     jax_load_cluster),
                              jax_load_gene_map(params))
    with pytest.raises(ValueError) as got:
        build_state_space(*_args(case, fixtures_dir, tmp_path, load_cluster),
                          load_gene_map(params))
    assert str(got.value) == str(want.value)


def _one_sequence_family():
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=1, seed=4)
    return fam, make_tree_samples(fam, 4, seed=4)


def _port_logliks(device, dtype):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.pipeline.run import run_pipeline_arrays

    fam, samples = _one_sequence_family()
    hmm = PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes, fam.msa, fam.unique_ids,
                              fam.n_sites, device=device, dtype=dtype)
    result = run_pipeline_arrays(hmm, samples, num_rates=4, seed=0)
    assert len(result.annotations) == 4
    assert all(len(a.naive_seq) == fam.n_sites for a in result.annotations)
    return result.lh_loglik


def test_single_sequence_family_matches_jax():
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.pipeline.run import \
        run_pipeline_arrays as jax_run_pipeline_arrays
    from linearham_tpu.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=1, seed=4)
    hmm = JaxPhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                                 fam.genes, fam.msa, fam.unique_ids,
                                 fam.n_sites, seed=0)
    want = jax_run_pipeline_arrays(hmm, make_tree_samples(fam, 4, seed=4),
                                   num_rates=4, seed=0).lh_loglik
    got = _port_logliks("cpu", torch.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert got[0] == pytest.approx(-202.04933436, abs=1e-8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, bound", [(torch.float64, F64_BOUND),
                                          (torch.float32, F32_BOUND)])
def test_single_sequence_family_through_the_kernel(cuda_device, dtype,
                                                   bound):
    from linearham_tpu_torch.ops import pruning_cuda

    before = pruning_cuda.launches
    got = _port_logliks(cuda_device, dtype)
    assert pruning_cuda.launches == before + 1
    want = _port_logliks("cpu", torch.float64)
    assert np.abs(got - want).max() <= bound
