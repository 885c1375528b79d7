"""The Hopper pruning kernel (csrc/pruning.cu): its reckoning and its cases.

On the CPU: the shared-memory layout the stub tests of
``test_torch_f64_kernel.py`` write out is the one the kernel source
declares (tile, stage, ring), and ``tools/pruning_ab.kernel_work`` counts
the work of real entries only, over each tree's real sites, as a hand count
does.  The ``cuda`` tests (skipped without a GPU; they decide inside a
fixture) hold the library's own reckoning (tile, shared memory) to that
CPU mirror, check that the ptxas report survives a missing build log, and
hold the kernel against ``site_log_likelihoods_plain`` at the tolerances
of tests/test_pruning_pallas.py in f32 (5e-4 at most) and at 1e-9 in f64:
R = 1/2/4/8, the 312-sequence family, a ragged stacked bucket with sink
padding, runs of consecutive tips (star-shaped nodes), an all-zero (-inf)
site, and single-family sink padding (a one-hot row at length 0).
"""

import dataclasses
import pathlib

import pytest
import torch

from linearham_tpu_torch.ops import pruning_cuda
from linearham_tpu_torch.tools import pruning_ab

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "linearham_tpu_torch"
          / "csrc" / "pruning.cu")
TOL = {torch.float32: 5e-4, torch.float64: 1e-9}


def test_stub_reckoning_follows_the_kernel_source():
    """The CPU mirror of the layout (test_torch_f64_kernel._smem) assumes
    the source's tiles, stages, ring and P columns."""
    from test_torch_f64_kernel import _smem

    text = SOURCE.read_text()
    assert "constexpr int kTile = sizeof(T) == 8 ? 32 : 64;" in text
    assert "constexpr int kStageOf = sizeof(T) == 8 ? 4 : 8;" in text
    assert "constexpr int kRing = 2;" in text
    assert "constexpr int kPCols = 6;" in text
    # 8 slots, R=4: 32 KB of partials, the ring, the codes, the barriers.
    assert _smem(200, 8, 4, 4) == (8 * 4 * 4 * 64 + 2 * 8 * 4 * 24 + 76) * 4 \
        + (2 * 8 * 64 + 2 * 17) * 4 + 32


def _family_args(n_trees, R, dtype, device="cpu", newicks=None, **family):
    """Kernel arguments of a synthetic family (``make_family(**family)``;
    ``newicks(fam)`` replaces the sampled topologies)."""
    hmm, samples = pruning_ab.make_batch(n_trees, dtype, device=device,
                                         **family)
    if newicks is not None:
        from linearham_tpu_torch.utils.synth import make_family

        samples = dataclasses.replace(samples,
                                      newicks=newicks(make_family(**family)))
    return pruning_ab.ensemble_args(hmm, samples, R)


def _hand_count(args, cols):
    """FLOP of one launch by a loop over trees and entries."""
    eig, pi, rates, codes, src, penc, length, root, n_slots = args
    R = rates.shape[1]
    pad = (n_slots - 1) * 4 + 3
    total = 0
    for t, row in enumerate(penc.tolist()):
        per_site, per_tree = pruning_ab.FLOP_ROOT, 0
        for k, e in enumerate(row):
            if e == pad:
                continue
            per_tree += pruning_ab.FLOP_P
            per_site += pruning_ab.FLOP_INTERNAL * (e & 1 == 0) \
                + pruning_ab.FLOP_NONFIRST * ((e >> 1) & 1 == 0) \
                + pruning_ab.FLOP_RENORM * (k % 4 == 3)
        total += R * (per_site * cols[t] + per_tree)
    return total


def test_kernel_work_counts_real_entries_and_sites():
    """A stacked bucket of three families: sink padding is no work, each
    tree's sites are its own family's; at the bench unit's depth the count
    is ~3.9 kFLOP per (site, rate) and the bound is set by operations."""
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.utils.synth import (make_family,
                                                 make_light_family,
                                                 make_tree_samples)

    hmms, samples = [], []
    for maker, n_seqs, T, seed in ((make_family, 4, 3, 1),
                                   (make_family, 9, 2, 2),
                                   (make_light_family, 6, 2, 3)):
        fam = maker(n_seqs=n_seqs, seed=seed)
        hmms.append(PhyloHMM.from_parts(
            fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
            fam.unique_ids, fam.n_sites, device="cpu", dtype=torch.float64))
        samples.append(make_tree_samples(fam, T, seed=seed))
    args, cols = pruning_ab.stacked_args(hmms, samples, torch.float64,
                                         device="cpu")
    pad = (args[8] - 1) * 4 + 3
    assert (args[5] == pad).any()            # the shallow trees are padded
    assert len(set(cols.tolist())) == 3      # each family its own width
    flops, nbytes = pruning_ab.kernel_work(args, cols)
    assert flops == _hand_count(args, cols)
    ms, by = pruning_ab.bound_ms(flops, nbytes, torch.float32)
    assert by == "operations" and ms == flops / 67e12 * 1e3
    # The bench unit's depth: ~3.9 kFLOP per (site, rate).
    deep = _family_args(2, 4, torch.float64, n_seqs=100, seed=0)
    X = deep[3].shape[1]
    assert 3_800 < pruning_ab.kernel_work(deep)[0] / (2 * 4 * X) < 4_100


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,R", [(8, 4), (4, 1), (16, 8), (32, 2)])
@pytest.mark.parametrize("elem", [4, 8], ids=["f32", "f64"])
def test_library_reckoning_matches_the_cpu_mirror(cuda_device, n_slots, R,
                                                  elem):
    """lh_pruning_smem_bytes and lh_pruning_tile of the built library are
    what the stub tests assume (test_torch_f64_kernel._smem)."""
    from test_torch_f64_kernel import _smem

    lib = pruning_cuda.kernel_lib()
    assert lib.lh_pruning_tile(elem) == (32 if elem == 8 else 64)
    for n_entries in (200, 624):
        assert lib.lh_pruning_smem_bytes(n_entries, n_slots, R, elem) \
            == _smem(n_entries, n_slots, R, elem)


@pytest.mark.cuda
def test_ptxas_report_survives_a_missing_build_log(cuda_device, tmp_path,
                                                   monkeypatch):
    """A library whose ``.log`` is gone still yields the ptxas report of
    all 8 instantiations (compiled again into a temporary directory)."""
    from linearham_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = cuda_build.build_source(SOURCE, "pruning")
    first = cuda_build.build_report(SOURCE, "pruning")
    lib.with_suffix(".log").unlink()
    again = cuda_build.build_report(SOURCE, "pruning")
    assert not lib.with_suffix(".log").exists()
    for report in (first, again):
        entries = [ln for ln in report.splitlines()
                   if "Compiling entry function" in ln
                   and "pruning_kernel" in ln]
        assert len(entries) == 8
        assert report.count("registers") >= 8


def _check(args, dtype):
    before = pruning_cuda.launches
    got = pruning_cuda.site_log_likelihoods(*args)
    assert pruning_cuda.launches == before + 1
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_kernel_matches_plain_at_each_rate_count(cuda_device, R, dtype):
    _check(_family_args(24, R, dtype, cuda_device, n_seqs=100), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_at_312_sequences(cuda_device, dtype):
    _check(_family_args(8, 4, dtype, cuda_device, **pruning_ab.FAMILY_312),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_on_a_ragged_stacked_bucket(cuda_device, dtype):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.utils.synth import (make_family,
                                                 make_light_family,
                                                 make_tree_samples)

    hmms, samples = [], []
    for maker, n_seqs, T, seed in ((make_family, 5, 7, 1),
                                   (make_family, 60, 5, 2),
                                   (make_light_family, 20, 6, 3)):
        fam = maker(n_seqs=n_seqs, seed=seed)
        hmms.append(PhyloHMM.from_parts(
            fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
            fam.unique_ids, fam.n_sites, device=cuda_device, dtype=dtype))
        samples.append(make_tree_samples(fam, T, seed=seed))
    args, _ = pruning_ab.stacked_args(hmms, samples, dtype,
                                      device=cuda_device)
    assert (args[5] == (args[8] - 1) * 4 + 3).any()
    _check(args, dtype)


def _stars(fam):
    """Trees whose internal nodes hold long runs of tips: two stars of
    tips under one root, and a caterpillar of cherries."""
    ids = list(fam.unique_ids)
    half = len(ids) // 2
    star = (f"(({','.join(f'{i}:0.05' for i in ids[:half])}):0.1,"
            f"({','.join(f'{i}:0.07' for i in ids[half:])}):0.2,naive:0.1);")
    cat = "naive:0.1"
    for a, b in zip(ids[::2], ids[1::2]):
        cat = f"({cat},({a}:0.03,{b}:0.04):0.02):0.01"
    if len(ids) % 2:
        cat = f"({cat},{ids[-1]}:0.05):0.01"
    return [star, cat + ";"] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_on_runs_of_tips(cuda_device, dtype):
    _check(_family_args(6, 4, dtype, cuda_device, newicks=_stars,
                        n_seqs=40, seed=5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_gives_minus_inf_at_an_all_zero_site(cuda_device, dtype):
    """R=1 and every branch length 0: a site where two tips of a cherry
    disagree has likelihood 0 up to the rounding of U U^-1, -inf or
    hugely negative, never NaN; every other site as the plain walk."""
    args = _family_args(8, 1, dtype, cuda_device, n_seqs=12, seed=11)
    args[6] = torch.zeros_like(args[6])
    got = pruning_cuda.site_log_likelihoods(*args)
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    possible = want > -15
    assert bool((~possible).any()) and not torch.isnan(got).any()
    assert bool((got[~possible] < -15).all())
    torch.testing.assert_close(got[possible], want[possible],
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_with_one_hot_sink_padding(cuda_device, dtype):
    """A family's own padding (io/schedule.py): xMSA row 0 at length 0 into
    the sink, whose maximum is 1 up to rounding."""
    args = _family_args(5, 4, dtype, cuda_device, n_seqs=30, seed=7)
    T, sink = args[4].shape[0], args[8] - 1
    pad = 7
    args[4] = torch.cat([args[4], torch.zeros_like(args[4][:, :pad])], 1)
    args[5] = torch.cat([args[5], torch.full_like(args[5][:, :pad],
                                                  sink * 4 + 3)], 1)
    args[6] = torch.cat([args[6], torch.zeros_like(args[6][:, :pad])], 1)
    _check([a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args], dtype)
