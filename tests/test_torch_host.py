"""The port's jax-free host twins equal the JAX package's originals.

linearham_tpu_torch carries numpy twins of host code that sits in
jax-importing modules of linearham_tpu: GTR eigenfactors and gamma rates
(ops/gtr.py), the family's transition tensors (compiler/compiled.py) and
the path decoder (models/decode.py).  Each must give the original's
results exactly.
"""

import numpy as np
import pytest
import torch

from linearham_tpu.compiler.state_space import build_state_space
from linearham_tpu.utils.synth import make_family, make_light_family

torch.set_num_threads(1)


def test_gtr_and_gamma_rates_match_jax():
    from linearham_tpu.ops import gtr as jax_gtr
    from linearham_tpu_torch.ops import gtr

    rng = np.random.default_rng(0)
    er = rng.uniform(0.5, 2.0, (7, 6))
    pi = rng.dirichlet([5.0] * 4, 7)
    for got, want in zip(gtr.gtr_eigen(er, pi), jax_gtr.gtr_eigen(er, pi)):
        np.testing.assert_array_equal(got, want)
    alphas = rng.uniform(0.3, 3.0, 7)
    for r in (1, 2, 4):
        np.testing.assert_allclose(
            gtr.gamma_category_rates_batch(alphas, r),
            jax_gtr.gamma_category_rates_batch(alphas, r), rtol=1e-14)
        np.testing.assert_allclose(
            gtr.gamma_category_rates(float(alphas[0]), r),
            jax_gtr.gamma_category_rates(float(alphas[0]), r), rtol=1e-14)


def test_transition_matrices_match_jax():
    import jax.numpy as jnp

    from linearham_tpu.ops import gtr as jax_gtr
    from linearham_tpu_torch.ops import gtr

    eig = gtr.gtr_eigen([1.0, 2.0, 0.5, 1.0, 3.0, 1.0],
                        [0.2, 0.3, 0.1, 0.4])
    t = np.array([0.0, 0.05, 0.7])
    got = gtr.transition_matrices(
        gtr.GTREigen(*map(torch.as_tensor, eig)), torch.as_tensor(t))
    want = jax_gtr.transition_matrices(
        jax_gtr.GTREigen(*map(jnp.asarray, eig)), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("light", [False, True], ids=["igh", "igk"])
def test_host_transitions_match_jax(light):
    from linearham_tpu.compiler.compiled import \
        compile_family as jax_compile
    from linearham_tpu_torch.compiler.compiled import compile_family

    fam = make_light_family(n_seqs=3, seed=1) if light \
        else make_family(n_seqs=3, seed=1)
    space = build_state_space(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes)
    got = compile_family(space, fam.genes).host_transitions()
    want = jax_compile(space, fam.genes).host_transitions()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("light", [False, True], ids=["igh", "igk"])
def test_decode_matches_jax(light):
    from linearham_tpu.models.decode import decode_path as jax_decode_path
    from linearham_tpu.models.decode import \
        decode_paths_batch as jax_decode_batch
    from linearham_tpu_torch.models.decode import (decode_path,
                                                   decode_paths_batch)

    fam = make_light_family(n_seqs=3, seed=9) if light \
        else make_family(n_seqs=3, seed=9)
    space = build_state_space(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes)
    rng = np.random.default_rng(0)
    T = 100
    vg = rng.integers(0, space.vgerm.n_states, T)
    vd = rng.integers(0, space.vd_junction.n_states,
                      (T, space.vd_junction.n_rows))
    jg = rng.integers(0, space.jgerm.n_states, T)
    dg = None if light else rng.integers(0, space.dgerm.n_states, T)
    dj = None if light else rng.integers(
        0, space.dj_junction.n_states, (T, space.dj_junction.n_rows))
    got = decode_paths_batch(space, vg, vd, dg, dj, jg, fam.n_sites)
    want = jax_decode_batch(space, vg, vd, dg, dj, jg, fam.n_sites)
    assert [vars(a) for a in got] == [vars(a) for a in want]
    one = decode_path(space, int(vg[0]), vd[0],
                      None if light else int(dg[0]),
                      None if light else dj[0], int(jg[0]), fam.n_sites)
    ref = jax_decode_path(space, int(vg[0]), vd[0],
                          None if light else int(dg[0]),
                          None if light else dj[0], int(jg[0]), fam.n_sites)
    assert vars(one) == vars(ref)
