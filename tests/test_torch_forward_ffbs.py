"""Port forward pass and FFBS sampler vs the JAX package.

The forward chain runs on identical f64 tensors through both packages (the
star-tree SimpleHMM fixtures give the transitions and emissions; a seeded
numpy perturbation widens them to a batch of trees).  The sampler is
checked distributionally: empirical path frequencies against exact
posterior probabilities recomputed from the raw tensors, as in
tests/test_simple_hmm.py:test_ffbs_samples_true_posterior.
"""

import numpy as np
import pytest
import torch

from linearham_tpu_torch.ops.ffbs import categorical, sample_path
from linearham_tpu_torch.ops.forward import ForwardCache, forward

torch.set_num_threads(1)

FIXTURES = {"igh": ("simple_hmm_input.yaml", True),
            "igk": ("simple_hmm_input_igk.yaml", False)}


def _simple_hmm(fixtures_dir, name):
    from linearham_tpu.models import SimpleHMM

    yaml_name, _ = FIXTURES[name]
    params = "igk_hmm_params" if name == "igk" else "hmm_params"
    return SimpleHMM(str(fixtures_dir / yaml_name), 0,
                     str(fixtures_dir / params), seed=0)


def _batched_emissions(emis, n_trees, seed):
    """[1, ...] emissions -> [n_trees, ...]: copy 0 is the fixture's own,
    the rest add seeded noise (-inf entries stay -inf)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in emis.items():
        v = np.asarray(v)
        noise = rng.normal(0.0, 0.3, size=(n_trees - 1,) + v.shape[1:])
        out[k] = np.concatenate([v, v + noise], axis=0)
    return out


def _torch(d):
    return {k: torch.as_tensor(np.array(v), dtype=torch.float64)
            for k, v in d.items()}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_forward_matches_jax(fixtures_dir, name):
    import jax.numpy as jnp

    from linearham_tpu.ops.forward import forward as jax_forward

    hmm = _simple_hmm(fixtures_dir, name)
    heavy = FIXTURES[name][1]
    trans = {k: np.asarray(v) for k, v in hmm._trans.items()}
    emis = _batched_emissions(hmm._emis, 3, seed=1)
    want_ll, want_cache = jax_forward(
        {k: jnp.asarray(v) for k, v in trans.items()},
        {k: jnp.asarray(v) for k, v in emis.items()}, heavy)
    got_ll, got_cache = forward(_torch(trans), _torch(emis), heavy)

    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll),
                               rtol=1e-10)
    assert float(got_ll[0]) == pytest.approx(hmm.log_likelihood(), rel=1e-10)
    for field in ForwardCache._fields:
        want, got = getattr(want_cache, field), getattr(got_cache, field)
        if want is None:
            assert got is None, field
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-300, err_msg=field)


def _joint_logprob(t, e, vgerm, vd, dgerm, dj, jgerm):
    """Independent arithmetic for one heavy-chain path's joint log-prob."""
    with np.errstate(divide="ignore"):
        lp = t["vgerm_static_log"][vgerm] + e["vpadding"][vgerm] \
            + e["vgerm"][vgerm]
        lp += np.log(t["vgerm_vd"][vgerm, vd[0]])
        for i in range(1, len(vd)):
            lp += np.log(t["vd"][vd[i - 1], vd[i]])
        for i, s in enumerate(vd):
            lp += e["vd_junction"][i, s]
        lp += np.log(t["vd_dgerm"][vd[-1], dgerm]) + e["dgerm"][dgerm]
        lp += np.log(t["dgerm_dj"][dgerm, dj[0]])
        for i in range(1, len(dj)):
            lp += np.log(t["dj"][dj[i - 1], dj[i]])
        for i, s in enumerate(dj):
            lp += e["dj_junction"][i, s]
        lp += np.log(t["dj_jgerm"][dj[-1], jgerm]) \
            + t["jpadding_log"][jgerm] + e["jgerm"][jgerm] \
            + e["jpadding"][jgerm]
    return lp


def test_ffbs_samples_true_posterior(fixtures_dir):
    """Empirical path frequencies from the port's sampler must match the
    exact posterior probabilities exp(joint - evidence)."""
    hmm = _simple_hmm(fixtures_dir, "igh")
    t = {k: np.asarray(v) for k, v in hmm._trans.items()}
    e1 = {k: np.asarray(v) for k, v in hmm._emis.items()}
    trans = _torch(t)
    loglik, cache = forward(trans, _torch(e1), heavy=True)

    n = 4000
    cache_n = ForwardCache(*(
        None if a is None else
        a.expand(n, -1) if a.dim() == 2 else a.expand(-1, n, -1)
        for a in cache))
    gen = torch.Generator().manual_seed(0)
    path = sample_path(gen, trans, cache_n, heavy=True)
    assert path.vd_idx.shape == (n, cache.vd_u.shape[0])
    keys = zip(path.vgerm_idx.tolist(), map(tuple, path.vd_idx.tolist()),
               path.dgerm_idx.tolist(), map(tuple, path.dj_idx.tolist()),
               path.jgerm_idx.tolist())
    counts = {}
    for key in keys:
        counts[key] = counts.get(key, 0) + 1

    e = {k: v[0] for k, v in e1.items()}
    checked = 0
    for key, c in sorted(counts.items(), key=lambda kv: -kv[1])[:5]:
        vgerm, vd, dgerm, dj, jgerm = key
        p_exact = np.exp(_joint_logprob(t, e, vgerm, list(vd), dgerm,
                                        list(dj), jgerm) - float(loglik[0]))
        p_emp = c / n
        se = np.sqrt(p_exact * (1 - p_exact) / n)
        assert abs(p_emp - p_exact) < max(5 * se, 0.005), (
            f"path {key}: empirical {p_emp:.4f} vs exact {p_exact:.4f}")
        checked += 1
    assert checked >= 3


def test_categorical_frequencies_and_seeding():
    """Gumbel-max draws follow softmax(logits), never pick a -inf logit,
    and repeat exactly for one seed."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2, 0.0]],
                                    dtype=torch.float64)).expand(20000, -1)
    draws = categorical(torch.Generator().manual_seed(3), logits)
    freq = torch.bincount(draws, minlength=4).double() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2, 0.0], atol=0.015)
    again = categorical(torch.Generator().manual_seed(3), logits)
    assert torch.equal(draws, again)
