"""The new paths of the port on the card (marked ``cuda``; skipped without
a GPU).  jax-free, and needs no conftest fixture, so it runs on the card's
machine with ``python -m pytest --noconftest -m cuda``.

* TreeBatch pruning in f64 on the card equals the CPU's at 1e-9;
* the single tree's MAP step in f32 (one launch through ``models.step``,
  then ``PhyloHMM.map_step``) launches the kernel exactly once and meets
  the same step with the plain pruning on the card (MAP score within
  5e-3 nats, the kernel's site tolerance summed over a 15-site family);
* ASR on the card keeps every observed tip base.
"""

import pathlib

import numpy as np
import pytest
import torch

from linearham_tpu_torch.ops.gtr import (GTREigen, gamma_category_rates_batch,
                                        gtr_eigen)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
PI = [0.17, 0.19, 0.25, 0.39]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _family(device, dtype):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    hmm = PhyloHMM(str(FIXTURES / "phylo_hmm_input.yaml"), 0,
                   str(FIXTURES / "hmm_params"), device=device, dtype=dtype)
    hmm.init_phylo_parameters(str(FIXTURES / "newton.tree"), [1.0] * 6, PI,
                              1.0, 4)
    return hmm


def _treebatch_site_ll(device):
    from linearham_tpu_torch.ops.pruning import site_log_likelihoods

    hmm = _family(device, torch.float64)
    tb = hmm.tree_batch

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return site_log_likelihoods(
        GTREigen(*map(f, gtr_eigen([[1.0] * 6], [PI]))), f([PI]),
        f(gamma_category_rates_batch([1.0], 4)),
        hmm.xmsa_rows[i(tb.tip_perm).long()], i(tb.tip_parent),
        f(tb.tip_length), i(tb.edge_child), i(tb.edge_parent),
        f(tb.edge_length), i(tb.root_slot), tb.n_slots).cpu().numpy()


@pytest.mark.cuda
def test_treebatch_pruning_on_the_card_matches_cpu(cuda_device):
    np.testing.assert_allclose(_treebatch_site_ll(cuda_device),
                               _treebatch_site_ll("cpu"), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.cuda
def test_map_step_launches_the_kernel_once(cuda_device, monkeypatch):
    from linearham_tpu_torch.models import step
    from linearham_tpu_torch.ops import pruning_cuda

    hmm = _family(cuda_device, torch.float32)
    before = pruning_cuda.launches
    score, path = hmm.map_step(*hmm._launch_current())
    torch.cuda.synchronize()
    assert pruning_cuda.launches == before + 1
    monkeypatch.setattr(step, "site_log_likelihoods",
                        pruning_cuda.site_log_likelihoods_plain)
    plain_score, plain_path = hmm.map_step(*hmm._launch_current())
    assert pruning_cuda.launches == before + 1
    assert abs(float(score[0]) - float(plain_score[0])) <= 5e-3
    for a, b in zip(path, plain_path):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_asr_on_the_card_keeps_observed_tips(cuda_device):
    from linearham_tpu.io.newick import parse_newick
    from linearham_tpu_torch.ops.asr import sample_ancestral_states

    tree = parse_newick("((a:0.1,b:0.3):0.2,naive:0.15);")
    seqs = {"a": "ACGTN", "b": "ACGGA", "naive": "ANGTA"}
    lut = {c: k for k, c in enumerate("ACGT")}
    tips = np.array([[lut.get(c, 4) for c in seqs[lab]]
                     for lab in tree.tip_labels])
    n = 256

    def rep(a, dtype):
        a = torch.as_tensor(np.asarray(a), dtype=dtype, device=cuda_device)
        return a.expand(n, *a.shape).contiguous()

    f, i = torch.float64, torch.int64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sample = sample_ancestral_states(
        gen, GTREigen(*(rep(a, f) for a in gtr_eigen([1.0] * 6, PI))),
        rep(PI, f), rep(gamma_category_rates_batch([1.0], 4)[0], f),
        rep(tips, i), rep(tree.tip_parent, i), rep(tree.tip_length, f),
        rep(tree.edge_child, i), rep(tree.edge_parent, i),
        rep(tree.edge_length, f), rep(tree.n_internal - 1, i),
        tree.n_internal + 1)
    got = sample.tip_states.cpu().numpy()
    observed = tips < 4
    assert (got[:, observed] == tips[observed]).all()
    assert ((got >= 0) & (got <= 3)).all()
