"""Port pruning (linearham_tpu_torch.ops.pruning_cuda) vs the JAX package.

The plain torch schedule walk runs here on the CPU; it is held against

* the JAX one-slot-per-node jnp path (ops.pruning.site_log_likelihoods,
  vmapped) with every input in f64, at rtol = atol = 1e-9, and
* the Pallas kernel under its interpreter (f32), at the tolerances of
  tests/test_pruning_pallas.py: 2e-4, 3e-4 for the deep tree.

The cases are those of test_pruning_pallas.py: odd T, an all-N tip row,
R=1 with zero branches (no NaN; impossible sites below -15), a
40-sequence family, and R=8 (the widest rate count the kernel takes).  The CUDA kernel itself is held against the plain
version on the card (marked ``cuda``; skipped without a GPU).
"""

import numpy as np
import pytest
import torch

from linearham_tpu.compiler.state_space import build_state_space
from linearham_tpu.compiler.xmsa import build_xmsa
from linearham_tpu.io.native import parse_newicks_batch
from linearham_tpu.io.newick import batch_trees, parse_newick
from linearham_tpu.io.schedule import build_schedule
from linearham_tpu.utils.synth import make_family, make_tree_samples
from linearham_tpu_torch.ops.gtr import (GTREigen, gamma_category_rates_batch,
                                        gtr_eigen)
from linearham_tpu_torch.ops.pruning_cuda import (site_log_likelihoods,
                                                  site_log_likelihoods_plain)

torch.set_num_threads(1)

# case -> (family seed, n_seqs, T, R, Pallas-interpreter tolerance)
CASES = {
    "odd_T": (3, 5, 9, 4, 2e-4),
    "all_N_tip": (3, 5, 9, 4, 2e-4),
    "R1_zero_branches": (11, 4, 3, 1, 2e-4),
    "deep_40": (7, 40, 5, 2, 3e-4),
    "R8": (5, 12, 3, 8, 2e-4),
}


def _case(name):
    """Host inputs (numpy, f64) of one case, both tree encodings."""
    seed, n_seqs, T, R, _ = CASES[name]
    fam = make_family(n_seqs=n_seqs, seed=seed)
    space = build_state_space(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes)
    xmsa = build_xmsa(space, fam.msa, fam.unique_ids)
    samples = make_tree_samples(fam, T, seed=seed)
    tb = parse_newicks_batch(samples.newicks, xmsa.labels)
    if tb is None:
        tb = batch_trees([parse_newick(nw) for nw in samples.newicks],
                         xmsa.labels)
    rows = np.asarray(xmsa.matrix, np.int32)
    if name == "R1_zero_branches":
        # Identity transitions: a site where two tips of a cherry disagree
        # has likelihood exactly zero.
        tb.tip_length[:] = 0.0
        tb.edge_length[:] = 0.0
    sched = build_schedule(tb)
    if name == "all_N_tip":
        # Every tree's tip slot 0 reads a new all-N row.
        n_rows = rows.shape[0]
        rows = np.concatenate([rows, np.full((1, rows.shape[1]), 4,
                                             np.int32)])
        target = tb.tip_perm[:, 0:1]
        is_tip = (sched.penc & 1) == 1
        sched.src = np.where(is_tip & (sched.src == target), n_rows,
                             sched.src).astype(np.int32)
        tb.tip_perm = tb.tip_perm.copy()
        tb.tip_perm[:, 0] = n_rows
    return dict(rows=rows, tb=tb, sched=sched,
                eig=gtr_eigen(samples.er, samples.pi),
                pi=np.asarray(samples.pi),
                rates=gamma_category_rates_batch(samples.alpha, R))


def _jnp_reference(c):
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


def _pallas_reference(c):
    import jax.numpy as jnp

    from linearham_tpu.ops.gtr import GTREigen as JaxEigen
    from linearham_tpu.ops.pruning_pallas import site_log_likelihoods_pallas

    s = c["sched"]
    f32 = lambda a: jnp.asarray(np.asarray(a), jnp.float32)  # noqa: E731
    return np.asarray(site_log_likelihoods_pallas(
        JaxEigen(*map(f32, c["eig"])), f32(c["pi"]), f32(c["rates"]),
        jnp.asarray(c["rows"]), jnp.asarray(s.src), jnp.asarray(s.penc),
        f32(s.length), jnp.asarray(s.root), n_slots=s.n_slots,
        interpret=True))


def _port_args(c, dtype, device="cpu"):
    s = c["sched"]

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def it(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=device)

    return (GTREigen(*map(fl, c["eig"])), fl(c["pi"]), fl(c["rates"]),
            it(c["rows"]), it(s.src), it(s.penc), fl(s.length), it(s.root),
            s.n_slots)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def _assert_matches(name, got, want, tol):
    """Equal within ``tol``; for the zero-branch case, impossible sites
    (-inf in the reference) need only be hugely negative, never NaN."""
    assert not np.isnan(got).any()
    if name == "R1_zero_branches":
        impossible = want < -15
        assert impossible.any()              # the scenario actually fires
        assert (got[impossible] < -15).all()
        got, want = got[~impossible], want[~impossible]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jnp_path_f64(cases, name):
    c = cases[name]
    got = site_log_likelihoods(*_port_args(c, torch.float64)).numpy()
    _assert_matches(name, got, _jnp_reference(c), 1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpreter_f32(cases, name):
    c = cases[name]
    got = site_log_likelihoods(*_port_args(c, torch.float32)).numpy()
    _assert_matches(name, got, _pallas_reference(c), CASES[name][4])


def test_deep_tree_slot_reuse():
    """A 300-tip family: slot reuse keeps the live partials at <= 16 slots,
    and the f32 plain walk stays within the production-width tolerance of
    the f64 one."""
    fam = make_family(n_seqs=300, seed=13, mutation_rate=0.03)
    space = build_state_space(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes)
    xmsa = build_xmsa(space, fam.msa, fam.unique_ids)
    samples = make_tree_samples(fam, 1, seed=13)
    sched = build_schedule(parse_newicks_batch(samples.newicks, xmsa.labels)
                           or batch_trees([parse_newick(samples.newicks[0])],
                                          xmsa.labels))
    assert sched.n_slots <= 16 and xmsa.n_cols >= 700
    c = dict(rows=np.asarray(xmsa.matrix, np.int32), sched=sched,
             eig=gtr_eigen(samples.er, samples.pi), pi=samples.pi,
             rates=gamma_category_rates_batch(samples.alpha, 4))
    want = site_log_likelihoods(*_port_args(c, torch.float64)).numpy()
    got = site_log_likelihoods(*_port_args(c, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_renorm_stride_is_an_identity(cases):
    """Renormalizing every entry or every 4th gives the same f64 result:
    the stride only keeps f32 partials out of the subnormal range."""
    args = _port_args(cases["deep_40"], torch.float64)
    every = site_log_likelihoods_plain(*args, renorm_stride=1)
    fourth = site_log_likelihoods_plain(*args, renorm_stride=4)
    np.testing.assert_allclose(fourth.numpy(), every.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_inputs_on_mixed_devices_are_refused(cases):
    args = list(_port_args(cases["odd_T"], torch.float32))
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="all on one CUDA device"):
        site_log_likelihoods(*args)


def test_kernel_wrapper_checks_inputs_before_launch(cases):
    """What the kernel does not take is refused before any build or launch:
    a wrong dtype, a non-contiguous tensor, an unsupported R."""
    from linearham_tpu_torch.ops.pruning_cuda import _launch

    args = list(_port_args(cases["odd_T"], torch.float32))
    with pytest.raises(ValueError, match="pi must be torch.float32"):
        _launch(*args[:1], args[1].double(), *args[2:])
    eig = args[0]
    args_t = [eig._replace(u_inv=eig.u_inv.transpose(1, 2))] + args[1:]
    with pytest.raises(ValueError, match="u_inv must be contiguous"):
        _launch(*args_t)
    args_r = args[:2] + [torch.ones(args[2].shape[0], 3)] + args[3:]
    with pytest.raises(ValueError, match="R=3"):
        _launch(*args_r)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain(cases, name, cuda_device):
    from linearham_tpu_torch.ops import pruning_cuda

    args = _port_args(cases[name], torch.float32, cuda_device)
    before = pruning_cuda.launches
    got = site_log_likelihoods(*args)
    assert pruning_cuda.launches == before + 1
    want = site_log_likelihoods_plain(*args)
    _assert_matches(name, got.cpu().numpy(), want.cpu().numpy(), 5e-4)


@pytest.mark.cuda
def test_cuda_kernel_refuses_oversized_shared_memory(cases, cuda_device):
    """More live partials than a block's 227 KB of shared memory hold are
    refused before launch, not narrowed or run elsewhere."""
    from linearham_tpu_torch.ops import pruning_cuda

    args = list(_port_args(cases["R8"], torch.float32, cuda_device))
    args[-1] = 64                  # 64 slots x R=8 x 4 x 64 sites x 4 B
    before = pruning_cuda.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        site_log_likelihoods(*args)
    assert pruning_cuda.launches == before
