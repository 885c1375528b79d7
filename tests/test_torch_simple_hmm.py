"""Port SimpleHMM (linearham_tpu_torch.models.SimpleHMM) conformance, f64 CPU.

The mirror of tests/test_simple_hmm.py on the port: the reference goldens
-42.8027747544 and -37.1354672701 at rel 1e-8, the decode of the paths the
reference sampled at seed 0, and FFBS path frequencies against the exact
posterior (4000 draws, |empirical - exact| < max(5 se, 0.005) for the five
most visited paths).  Plus the port against the JAX SimpleHMM on the same
fixtures: identical transition and emission tensors, log-likelihoods at
rel 1e-12.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from linearham_tpu_torch.models import Annotation, SimpleHMM
from linearham_tpu_torch.models.decode import decode_path

from test_simple_hmm import _joint_logprob

torch.set_num_threads(1)

FIXTURES = {
    "base": ("simple_hmm_input.yaml", "hmm_params"),
    "extra": ("simple_hmm_input_extra.yaml", "hmm_params"),
    "igk": ("simple_hmm_input_igk.yaml", "igk_hmm_params"),
}


def _port(fixtures_dir, name, seed=0):
    yaml_name, params = FIXTURES[name]
    return SimpleHMM(str(fixtures_dir / yaml_name), 0,
                     str(fixtures_dir / params), seed=seed, device="cpu")


@pytest.fixture(scope="module")
def base_hmm(fixtures_dir):
    return _port(fixtures_dir, "base")


def host_view(hmm):
    """The port model's tensors in the layout test_simple_hmm's
    ``_joint_logprob`` reads (``_trans``, ``_emis`` with a tree axis)."""
    return SimpleNamespace(
        _trans={k: v.numpy() for k, v in hmm.trans.items()},
        _emis={k: v.numpy() for k, v in hmm.emis.items()})


@pytest.mark.parametrize("name,golden", [("base", -42.8027747544),
                                         ("extra", -37.1354672701)])
def test_golden_loglik(fixtures_dir, name, golden):
    hmm = _port(fixtures_dir, name)
    assert hmm.dtype == torch.float64
    assert hmm.log_likelihood() == pytest.approx(golden, rel=1e-8)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_tensors_and_loglik_match_jax(fixtures_dir, name):
    from linearham_tpu.models import SimpleHMM as JaxSimpleHMM

    yaml_name, params = FIXTURES[name]
    ref = JaxSimpleHMM(str(fixtures_dir / yaml_name), 0,
                       str(fixtures_dir / params), seed=0)
    port = _port(fixtures_dir, name)
    assert set(port.trans) == set(ref._trans)
    assert set(port.emis) == set(ref._emis)
    for k, v in port.trans.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref._trans[k]))
    for k, v in port.emis.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref._emis[k]))
    assert port.log_likelihood() == pytest.approx(ref.log_likelihood(),
                                                  rel=1e-12)


def test_decode_reference_path_base(base_hmm):
    """Decode the path the reference sampled at seed 0 (test.cpp:377-399)."""
    ann = decode_path(base_hmm.space, vgerm_idx=0, vd_idx=[7, 4, 5, 6],
                      dgerm_idx=0, dj_idx=[4, 5, 6], jgerm_idx=0, n_sites=15)
    assert ann.naive_seq == "NATGAGGTATATGCG"
    assert ann.vgerm_state == "IGHV_ex*01"
    assert (ann.v_5p_del, ann.v_3p_del) == (0, 1)
    assert ann.v_fwk_insertion == "N"
    assert ann.vd_states == ["IGHV_ex*01:3", "IGHD_ex*01:0", "IGHD_ex*01:1",
                             "IGHD_ex*01:2"]
    assert ann.vd_insertion == ""
    assert ann.dgerm_state == "IGHD_ex*01"
    assert (ann.d_5p_del, ann.d_3p_del) == (0, 1)
    assert ann.dj_states == ["IGHJ_ex*01:N_T", "IGHJ_ex*01:0",
                             "IGHJ_ex*01:1"]
    assert ann.dj_insertion == "T"
    assert ann.jgerm_state == "IGHJ_ex*01"
    assert (ann.j_5p_del, ann.j_3p_del) == (0, 0)
    assert ann.j_fwk_insertion == ""


def test_decode_reference_path_extra(fixtures_dir):
    """Decode the path the reference sampled at seed 0 (test.cpp:640-660)."""
    extra = _port(fixtures_dir, "extra")
    ann = decode_path(extra.space, vgerm_idx=1, vd_idx=[13, 14], dgerm_idx=1,
                      dj_idx=[5, 7], jgerm_idx=0, n_sites=15)
    assert ann.naive_seq == "NCAGGACACTATGCG"
    assert ann.vgerm_state == "IGHV_ex*99"
    assert (ann.v_5p_del, ann.v_3p_del) == (0, 3)
    assert ann.vd_insertion == ""
    assert ann.dgerm_state == "IGHD_ex*99"
    assert (ann.d_5p_del, ann.d_3p_del) == (3, 2)
    assert ann.dj_insertion == "CT"
    assert ann.jgerm_state == "IGHJ_ex*01"
    assert (ann.j_5p_del, ann.j_3p_del) == (0, 0)
    assert ann.j_fwk_insertion == ""


def test_ffbs_samples_true_posterior(base_hmm):
    """Empirical path frequencies match exact posterior probabilities,
    the joint recomputed from the raw tensors by test_simple_hmm's
    independent arithmetic."""
    n = 4000
    counts = {}
    for ann in base_hmm.sample_annotations(n):
        key = (ann.vgerm_idx, tuple(ann.vd_idx), ann.dgerm_idx,
               tuple(ann.dj_idx), ann.jgerm_idx)
        counts[key] = counts.get(key, 0) + 1

    loglik = base_hmm.log_likelihood()
    view = host_view(base_hmm)
    checked = 0
    for key, c in sorted(counts.items(), key=lambda kv: -kv[1])[:5]:
        vgerm, vd, dgerm, dj, jgerm = key
        p_exact = np.exp(_joint_logprob(view, vgerm, list(vd), dgerm,
                                        list(dj), jgerm) - loglik)
        p_emp = c / n
        se = np.sqrt(p_exact * (1 - p_exact) / n)
        assert abs(p_emp - p_exact) < max(5 * se, 0.005), (
            f"path {key}: empirical {p_emp:.4f} vs exact {p_exact:.4f}")
        checked += 1
    assert checked >= 3


def test_sample_naive_sequence_and_seeding(fixtures_dir):
    """One draw decodes to a full annotation; one seed gives one stream."""
    a, b = _port(fixtures_dir, "base", 5), _port(fixtures_dir, "base", 5)
    ann = a.sample_naive_sequence()
    assert isinstance(ann, Annotation) and len(ann.naive_seq) == 15
    assert ann == b.sample_naive_sequence()
    assert [x.naive_seq for x in a.sample_annotations(20)] == \
        [x.naive_seq for x in b.sample_annotations(20)]


def test_light_chain_samples(fixtures_dir):
    igk = _port(fixtures_dir, "igk")
    anns = igk.sample_annotations(16)
    assert all(a.dgerm_state is None and a.dj_insertion is None
               for a in anns)
    assert all(len(a.naive_seq) == 15 for a in anns)
