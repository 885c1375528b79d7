"""Port Viterbi (linearham_tpu_torch.ops.viterbi) vs the JAX package, f64 CPU.

The mirror of tests/test_viterbi.py: on the base, extra and igk SimpleHMM
fixtures and the phylo fixture, the port's ``map_annotation`` gives the JAX
package's MAP path exactly and its ``map_score`` at rel 1e-10; the MAP
score is its own path's joint log-probability (rel 1e-12), never exceeds
the log-likelihood, and is at least the joint of every sampled path.  The
batched ``viterbi`` function meets the JAX one on random emissions with
dead (-inf) cells, several trees at once.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from linearham_tpu_torch.models import SimpleHMM
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.ops.viterbi import viterbi

from test_simple_hmm import _joint_logprob
from test_torch_simple_hmm import FIXTURES, host_view

torch.set_num_threads(1)

PI = [0.17, 0.19, 0.25, 0.39]


def _path_key(ann):
    return (ann.vgerm_idx, list(ann.vd_idx), ann.dgerm_idx,
            None if ann.dj_idx is None else list(ann.dj_idx), ann.jgerm_idx)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_simple_map_matches_jax(fixtures_dir, name):
    from linearham_tpu.models import SimpleHMM as JaxSimpleHMM

    yaml_name, params = FIXTURES[name]
    args = (str(fixtures_dir / yaml_name), 0, str(fixtures_dir / params))
    ref = JaxSimpleHMM(*args, seed=0)
    port = SimpleHMM(*args, seed=0, device="cpu")
    want, got = ref.map_annotation(), port.map_annotation()
    assert _path_key(got) == _path_key(want)
    assert asdict(got) == asdict(want)
    assert port.map_score == pytest.approx(ref.map_score, rel=1e-10)
    assert port.map_score <= port.log_likelihood()


def test_phylo_map_matches_jax(fixtures_dir):
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM

    args = (str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
            str(fixtures_dir / "hmm_params"))
    tree = (str(fixtures_dir / "newton.tree"), [1.0] * 6, PI, 1.0, 4)
    ref = JaxPhyloHMM(*args, seed=0)
    ref.init_phylo_parameters(*tree)
    port = PhyloHMM(*args, seed=0, device="cpu")
    port.init_phylo_parameters(*tree)
    want, got = ref.map_annotation(), port.map_annotation()
    assert asdict(got) == asdict(want)
    assert got.vgerm_state == "IGHV_ex*01" and len(got.naive_seq) == 15
    assert port.map_score == pytest.approx(ref.map_score, rel=1e-10)
    assert port.map_score <= port.log_likelihood()


def test_map_score_is_its_path_joint_prob(fixtures_dir):
    hmm = SimpleHMM(str(fixtures_dir / "simple_hmm_input.yaml"), 0,
                    str(fixtures_dir / "hmm_params"), seed=0, device="cpu")
    ann = hmm.map_annotation()
    joint = _joint_logprob(host_view(hmm), ann.vgerm_idx, ann.vd_idx,
                           ann.dgerm_idx, ann.dj_idx, ann.jgerm_idx)
    assert hmm.map_score == pytest.approx(joint, rel=1e-12)
    assert hmm.map_score <= hmm.log_likelihood()


def test_map_dominates_sampled_paths(fixtures_dir):
    hmm = SimpleHMM(str(fixtures_dir / "simple_hmm_input.yaml"), 0,
                    str(fixtures_dir / "hmm_params"), seed=0, device="cpu")
    view = host_view(hmm)
    best_sampled = max(
        _joint_logprob(view, a.vgerm_idx, a.vd_idx, a.dgerm_idx, a.dj_idx,
                       a.jgerm_idx)
        for a in hmm.sample_annotations(300))
    hmm.map_annotation()
    assert hmm.map_score >= best_sampled - 1e-9
    # On this concentrated fixture the sampler visits the MAP path.
    assert hmm.map_score == pytest.approx(best_sampled, rel=1e-9)


@pytest.mark.parametrize("name", ["base", "igk"])
def test_batched_viterbi_matches_jax_on_random_emissions(fixtures_dir, name):
    """Five trees of random emissions (a tenth of the junction cells dead)
    through both packages' ``viterbi``: equal paths, scores at 1e-10."""
    import jax.numpy as jnp

    from linearham_tpu.ops.viterbi import viterbi as jax_viterbi

    yaml_name, params = FIXTURES[name]
    hmm = SimpleHMM(str(fixtures_dir / yaml_name), 0,
                    str(fixtures_dir / params), device="cpu")
    rng = np.random.default_rng(4)
    emis = {}
    for k, v in hmm.emis.items():
        e = rng.normal(-4.0, 2.0, size=(5,) + tuple(v.shape[1:]))
        if k.endswith("junction"):
            e[rng.random(e.shape) < 0.1] = -np.inf
        emis[k] = e
    trans = {k: v.numpy() for k, v in hmm.trans.items()}
    want_score, want = jax_viterbi(
        {k: jnp.asarray(v) for k, v in trans.items()},
        {k: jnp.asarray(v) for k, v in emis.items()}, hmm.heavy)
    got_score, got = viterbi(
        {k: torch.as_tensor(v) for k, v in trans.items()},
        {k: torch.as_tensor(v) for k, v in emis.items()}, hmm.heavy)
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                               rtol=1e-10)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
