"""Port TreeBatch pruning (linearham_tpu_torch.ops.pruning) vs the JAX package.

The one-slot-per-internal-node path runs on the CPU in f64 and is held at
rtol = atol = 1e-9 against

* the JAX jnp path (linearham_tpu/ops/pruning.site_log_likelihoods,
  vmapped over trees), and
* the port's own slot-reuse schedule walk (ops.pruning_cuda.
  site_log_likelihoods_plain) on the same trees,

on random binary trees, polytomies, all-zero branch lengths (impossible
sites below -15 in all three, never NaN), an all-N tip row, trees whose
every tip is all-N, a 40-sequence family and the fixture tree; and it
reproduces the R phylomd golden -55.73483 through the PhyloHMM emission
chain.
"""

import numpy as np
import pytest
import torch

from linearham_tpu.compiler.state_space import build_state_space
from linearham_tpu.compiler.xmsa import build_xmsa
from linearham_tpu.io.newick import batch_trees, parse_newick
from linearham_tpu.io.schedule import build_schedule
from linearham_tpu.utils.synth import make_family, make_tree_samples
from linearham_tpu_torch.ops.gtr import (GTREigen, gamma_category_rates_batch,
                                        gtr_eigen)
from linearham_tpu_torch.ops.pruning import site_log_likelihoods
from linearham_tpu_torch.ops.pruning_cuda import site_log_likelihoods_plain

torch.set_num_threads(1)

TOL = 1e-9
# case -> (family seed, n_seqs, T, R)
CASES = {
    "binary": (3, 5, 6, 4),
    "polytomy": (5, 6, 3, 4),
    "zero_length": (11, 4, 3, 1),
    "all_N_tip": (3, 5, 4, 2),
    "all_N_tree": (3, 5, 2, 4),
    "deep_40": (7, 40, 3, 2),
}


def _polytomies(labels):
    """A star tree and a mixed polytomy over ``labels`` (naive included)."""
    a = [f"{lab}:{0.05 * (i + 1):.3f}" for i, lab in enumerate(labels)]
    return [f"({','.join(a)});",
            f"(({a[0]},{a[1]},{a[2]}):0.2,({a[3]},{a[4]}):0.1,"
            f"{','.join(a[5:])});",
            f"((({a[0]},{a[1]}):0.1,{a[2]},{a[3]}):0.3,{','.join(a[4:])});"]


def _case(name):
    seed, n_seqs, T, R = CASES[name]
    fam = make_family(n_seqs=n_seqs, seed=seed)
    space = build_state_space(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes)
    xmsa = build_xmsa(space, fam.msa, fam.unique_ids)
    samples = make_tree_samples(fam, T, seed=seed)
    newicks = _polytomies(xmsa.labels) if name == "polytomy" \
        else samples.newicks
    tb = batch_trees([parse_newick(nw) for nw in newicks], xmsa.labels)
    rows = np.asarray(xmsa.matrix, np.int32)
    if name == "zero_length":
        tb.tip_length[:] = 0.0
        tb.edge_length[:] = 0.0
    if name in ("all_N_tip", "all_N_tree"):
        rows = np.concatenate([rows, np.full((1, rows.shape[1]), 4,
                                             np.int32)])
        if name == "all_N_tip":
            tb.tip_perm[:, 0] = rows.shape[0] - 1
        else:      # every tip all-N: each site's likelihood is exactly 1
            tb.tip_perm[:] = rows.shape[0] - 1
    return dict(rows=rows, tb=tb, eig=gtr_eigen(samples.er, samples.pi),
                pi=np.asarray(samples.pi),
                rates=gamma_category_rates_batch(samples.alpha, R))


def _f64(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)


def _treebatch_args(c):
    tb = c["tb"]
    return (GTREigen(*map(_f64, c["eig"])), _f64(c["pi"]), _f64(c["rates"]),
            _i32(c["rows"][tb.tip_perm]), _i32(tb.tip_parent),
            _f64(tb.tip_length), _i32(tb.edge_child), _i32(tb.edge_parent),
            _f64(tb.edge_length), _i32(tb.root_slot), tb.n_slots)


def _jax_reference(c):
    import jax
    import jax.numpy as jnp

    from linearham_tpu.ops.gtr import GTREigen as JaxEigen
    from linearham_tpu.ops.pruning import site_log_likelihoods as jnp_sll

    tb, rows = c["tb"], jnp.asarray(c["rows"])
    f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731

    def per_tree(u, uinv, lam, pi, rates, perm, tparent, tlen, echild,
                 eparent, elen, root):
        return jnp_sll(JaxEigen(u, uinv, lam), pi, rates, rows[perm],
                       tparent, tlen, echild, eparent, elen, root,
                       tb.n_slots)

    return np.asarray(jax.vmap(per_tree)(
        *map(f64, c["eig"]), f64(c["pi"]), f64(c["rates"]),
        jnp.asarray(tb.tip_perm), jnp.asarray(tb.tip_parent),
        f64(tb.tip_length), jnp.asarray(tb.edge_child),
        jnp.asarray(tb.edge_parent), f64(tb.edge_length),
        jnp.asarray(tb.root_slot)))


def _schedule_walk(c):
    s = build_schedule(c["tb"])
    return site_log_likelihoods_plain(
        GTREigen(*map(_f64, c["eig"])), _f64(c["pi"]), _f64(c["rates"]),
        _i32(c["rows"]), _i32(s.src), _i32(s.penc), _f64(s.length),
        _i32(s.root), s.n_slots).numpy()


def _assert_close(got, want):
    """Equal at TOL.  Impossible sites (zero branches under a disagreeing
    cherry) come out -inf or, through eigenbasis roundoff, hugely
    negative: below -15 in both, never NaN."""
    assert not np.isnan(got).any()
    impossible = want < -15
    assert (got[impossible] < -15).all()
    np.testing.assert_allclose(got[~impossible], want[~impossible],
                               rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_treebatch_matches_jax_f64(cases, name):
    c = cases[name]
    got = site_log_likelihoods(*_treebatch_args(c)).numpy()
    if name == "zero_length":
        assert (got < -15).any()            # the scenario actually fires
    if name == "all_N_tree":
        np.testing.assert_allclose(got, 0.0, atol=TOL)
    _assert_close(got, _jax_reference(c))


@pytest.mark.parametrize("name", list(CASES))
def test_treebatch_matches_schedule_walk_f64(cases, name):
    c = cases[name]
    got = site_log_likelihoods(*_treebatch_args(c)).numpy()
    _assert_close(got, _schedule_walk(c))


def _fixture_case(fixtures_dir, yaml_name, params, R):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    hmm = PhyloHMM(str(fixtures_dir / yaml_name), 0,
                   str(fixtures_dir / params), device="cpu")
    tree = parse_newick((fixtures_dir / "newton.tree").read_text())
    tb = batch_trees([tree], hmm.xmsa.labels)
    pi = np.array([[0.17, 0.19, 0.25, 0.39]])
    c = dict(rows=np.asarray(hmm.xmsa.matrix, np.int32), tb=tb,
             eig=gtr_eigen([[1.0] * 6], pi), pi=pi,
             rates=gamma_category_rates_batch([1.0], R))
    return hmm, c


def test_treebatch_fixture_tree_matches_jax(fixtures_dir):
    _, c = _fixture_case(fixtures_dir, "phylo_hmm_input.yaml", "hmm_params",
                         4)
    got = site_log_likelihoods(*_treebatch_args(c)).numpy()
    _assert_close(got, _jax_reference(c))
    _assert_close(got, _schedule_walk(c))


def test_pure_phylo_golden_through_treebatch(fixtures_dir):
    """R=1: the HMM reduces to a bare phylo likelihood (R phylomd oracle
    -55.73483), here with TreeBatch pruning feeding the emission chain."""
    from linearham_tpu_torch.models.phylo_hmm import (naive_prior_correction,
                                                      region_emissions)
    from linearham_tpu_torch.ops.forward import forward

    hmm, c = _fixture_case(fixtures_dir, "phylo_likelihood_hmm_input.yaml",
                           "phylo_likelihood_hmm_params", 1)
    args = _treebatch_args(c)
    site_ll = site_log_likelihoods(*args)
    emis = region_emissions(
        naive_prior_correction(site_ll, args[1], hmm.naive_bases),
        hmm.consts, hmm.heavy)
    loglik = forward(hmm.trans, emis, hmm.heavy)[0]
    assert float(loglik[0]) == pytest.approx(-55.73483, abs=1e-5)
