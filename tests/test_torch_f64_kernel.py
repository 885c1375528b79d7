"""f64 through the Hopper pruning kernel (csrc/pruning.cu, ops/pruning_cuda.py).

On the CPU the wrapper's choices are checked against a stub kernel
library, as tests/test_torch_repertoire.py::test_card_failing_launch_raises
stubs the real one: all-f64 inputs take ``lh_pruning_launch_f64``, all-f32
inputs ``lh_pruning_launch``, a mix is refused by the tensor's name, and
the shared memory follows the kernel's layout (8-byte scalars, a 32-site
tile and 4-entry stages in f64; 4-byte scalars, a 64-site tile and 8-entry
stages in f32; a refusal where that does not fit).

The ``cuda`` tests (skipped without a GPU; jax-free, no conftest fixture)
hold the f64 kernel against the f64 plain walk at rtol = atol = 1e-9 on a
100-sequence family at R = 1/2/4/8, and run the reference
goldens and ``cli pipeline`` / ``compute-logl`` / ``repertoire`` with
``--precision f64 --device cuda`` through it.
"""

import contextlib
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from linearham_tpu_torch.ops import pruning_cuda
from linearham_tpu_torch.ops.gtr import GTREigen

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ER1 = [1.0] * 6
PI = [0.17, 0.19, 0.25, 0.39]


def _smem(n_entries, n_slots, n_rates, elem):
    """csrc/pruning.cu:smem_bytes, written out: the scalars (partials, the
    ring of 2 stages of P in 6 columns, outer, lam, pi, rates), the int32
    code ring and schedule ring, then two mbarriers a ring slot.  The tile
    and stage are the kernel's for the element size; the schedule's length
    does not enter."""
    block_x, stage = (32, 4) if elem == 8 else (64, 8)
    scalars = (n_slots * n_rates * 4 * block_x + 2 * stage * n_rates * 24
               + 64 + 8 + n_rates)
    ints = 2 * stage * block_x + 2 * (2 * stage + 1)
    return (scalars * elem + 4 * ints + 7) // 8 * 8 + 2 * 2 * 8


class StubLib:
    """The kernel library's interface, recording launches."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def lh_pruning_smem_bytes(n_entries, n_slots, n_rates, elem):
        return _smem(n_entries, n_slots, n_rates, elem)

    def lh_pruning_launch(self, *args):
        self.calls.append(("f32", args))
        return 0

    def lh_pruning_launch_f64(self, *args):
        self.calls.append(("f64", args))
        return 0


@pytest.fixture
def stub(monkeypatch):
    """The stub library, and the CUDA context calls made harmless so that
    ``_launch`` runs on CPU tensors up to the (recorded) launch."""
    lib = StubLib()
    monkeypatch.setattr(pruning_cuda, "kernel_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib


def _args(dtype, T=3, N=200, X=10, R=4, n_slots=8, **override):
    """Kernel inputs of the given shapes (values do not matter to the
    stub); ``override`` replaces one tensor's dtype by name."""
    f = {k: override.get(k, dtype) for k in
         ("u", "u_inv", "lam", "pi", "rates", "sched_len")}
    eig = GTREigen(torch.zeros(T, 4, 4, dtype=f["u"]),
                   torch.zeros(T, 4, 4, dtype=f["u_inv"]),
                   torch.zeros(T, 4, dtype=f["lam"]))
    i32 = torch.int32
    return [eig, torch.zeros(T, 4, dtype=f["pi"]),
            torch.zeros(T, R, dtype=f["rates"]), torch.zeros(5, X, dtype=i32),
            torch.zeros(T, N, dtype=i32), torch.zeros(T, N, dtype=i32),
            torch.zeros(T, N, dtype=f["sched_len"]), torch.zeros(T, dtype=i32),
            n_slots]


@pytest.mark.parametrize("dtype,R,n_slots,entry", [
    (torch.float64, 4, 8, "f64"),     # 32 KB of partials 32 wide
    (torch.float64, 8, 8, "f64"),     # 64 KB
    (torch.float64, 1, 4, "f64"),
    (torch.float32, 4, 8, "f32"),
    (torch.float32, 8, 8, "f32"),
], ids=["f64_R4", "f64_R8", "f64_R1", "f32_R4", "f32_R8"])
def test_launch_picks_the_entry_point_and_tile(stub, dtype, R, n_slots,
                                               entry):
    before = pruning_cuda.launches
    out = pruning_cuda._launch(*_args(dtype, R=R, n_slots=n_slots))
    assert pruning_cuda.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (3, 10)
    (kind, args), = stub.calls
    T, N, X, slots, rates = args[11:16]
    assert (kind, T, N, X, slots, rates) == (entry, 3, 200, 10, n_slots, R)
    assert len(args) == 17                  # ... R, stream: no tile argument
    elem = pruning_cuda.KERNEL_DTYPES[dtype]
    assert _smem(N, slots, R, elem) <= pruning_cuda.MAX_SHARED_BYTES


def test_f64_shared_memory_doubles():
    """A site's partials double in f64 (1 KB against 512 B at 8 slots,
    R=4), so f64 takes half the f32 tile: both blocks hold 32 KB of
    partials, and neither depends on the schedule's length."""
    for slots, elem, tile in ((1, 4, 64), (1, 8, 32), (8, 4, 64),
                              (8, 8, 32)):
        partials = _smem(200, slots, 4, elem) - _smem(200, 0, 4, elem)
        assert partials == slots * 4 * 4 * elem * tile
    for elem in (4, 8):
        assert _smem(200, 8, 4, elem) == _smem(624, 8, 4, elem)
        assert 32_768 < _smem(200, 8, 4, elem) < 45_000


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_refuses_what_fits_no_tile(stub, dtype):
    """32 slots and R=8 need 256 KB of partials in either type's tile (f64
    32 wide, f32 64 wide), over a block's 227 KB: refused before any
    launch, with nothing run in its place."""
    assert _smem(200, 16, 8, 8) <= pruning_cuda.MAX_SHARED_BYTES
    before = pruning_cuda.launches
    with pytest.raises(ValueError, match=f"bytes of shared memory.*{dtype}"):
        pruning_cuda._launch(*_args(dtype, R=8, n_slots=32))
    assert pruning_cuda.launches == before and not stub.calls


@pytest.mark.parametrize("dtype,name", [
    (torch.float64, "sched_len"), (torch.float64, "pi"),
    (torch.float32, "rates"), (torch.float32, "u_inv"),
])
def test_launch_refuses_a_mix_by_name(stub, dtype, name):
    other = torch.float32 if dtype == torch.float64 else torch.float64
    label = {"u_inv": "eig.u_inv"}.get(name, name)
    with pytest.raises(ValueError, match=f"{label} must be {dtype}"):
        pruning_cuda._launch(*_args(dtype, **{name: other}))
    assert not stub.calls


def test_launch_skips_an_empty_batch(stub):
    """T = 0 or X = 0: an empty output of the inputs' type, no launch."""
    for shape in (dict(T=0), dict(X=0)):
        out = pruning_cuda._launch(*_args(torch.float64, **shape))
        assert out.dtype == torch.float64 and out.numel() == 0
    assert not stub.calls


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _family_args(device, n_trees, R):
    from linearham_tpu_torch.tools import pruning_ab

    return pruning_ab.family_args(n_trees, torch.float64, R, device=device,
                                  n_seqs=100, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_f64_kernel_matches_plain_f64(cuda_device, R):
    args = _family_args(cuda_device, 24, R)
    before = pruning_cuda.launches
    got = pruning_cuda._launch(*args)
    assert pruning_cuda.launches == before + 1
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("yaml_name,golden,tol", [
    ("phylo_hmm_input.yaml", -75.8136, 1e-4),
    ("phylo_hmm_input_extra.yaml", -75.1122515055, 1e-9 * 75.1122515055),
])
def test_goldens_on_the_card_in_f64(cuda_device, yaml_name, golden, tol):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    h = PhyloHMM(str(FIXTURES / yaml_name), 0, str(FIXTURES / "hmm_params"),
                 device=cuda_device, dtype=torch.float64)
    h.init_phylo_parameters(str(FIXTURES / "newton.tree"), ER1, PI, 1.0, 4)
    before = pruning_cuda.launches
    assert abs(h.log_likelihood() - golden) <= tol
    assert pruning_cuda.launches == before + 1


@pytest.mark.cuda
def test_cli_f64_on_the_card_goes_through_the_kernel(cuda_device, tmp_path,
                                                     capsys):
    """``pipeline`` (every row, one launch per chunk, equal to the CPU's
    f64 run), ``compute-logl`` and ``repertoire`` with ``--precision f64
    --device cuda``."""
    from linearham_tpu_torch import cli
    from linearham_tpu_torch.utils.synth import (write_pipeline_inputs,
                                                 write_repertoire_inputs)

    files = write_pipeline_inputs(str(tmp_path), 12, 600, seed=0)
    family = ["--yaml-path", files.yaml_path, "--cluster-ind", "0",
              "--hmm-param-dir", files.gene_dir, "--num-rates", "4"]
    lls = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.tsv"
        before = pruning_cuda.launches
        assert cli.main(["pipeline", *family, "--input-path",
                         files.trees_path, "--output-path", str(out),
                         "--chunk-size", "256", "--precision", "f64",
                         "--device", device]) == 0
        launched = pruning_cuda.launches - before
        assert launched == (math.ceil(600 / 256) if device == "cuda" else 0)
        lines = out.read_text().rstrip("\n").split("\n")
        col = lines[0].split("\t").index("LHLogLikelihood")
        lls[device] = np.array([float(ln.split("\t")[col])
                                for ln in lines[1:]])
        assert lls[device].shape == (600,)
        assert np.isfinite(lls[device]).all()
    np.testing.assert_allclose(lls["cuda"], lls["cpu"], rtol=1e-9, atol=1e-9)

    capsys.readouterr()
    before = pruning_cuda.launches
    assert cli.main(["compute-logl", "--yaml-path",
                     str(FIXTURES / "phylo_hmm_input.yaml"), "--cluster-ind",
                     "0", "--hmm-param-dir", str(FIXTURES / "hmm_params"),
                     "--newick-path", str(FIXTURES / "newton.tree"),
                     *sum((["--er", "1.0"] for _ in ER1), []),
                     *sum((["--pi", str(p)] for p in PI), []),
                     "--num-rates", "4", "--precision", "f64",
                     "--device", "cuda"]) == 0
    assert pruning_cuda.launches == before + 1
    assert float(capsys.readouterr().out) == pytest.approx(-75.8136,
                                                           abs=1e-4)

    reps = write_repertoire_inputs(str(tmp_path / "rep"),
                                   [("igh", 4, 30, 0.02), ("igh", 9, 20, 0.05)])
    before = pruning_cuda.launches
    assert cli.main(["repertoire", "--families", reps["igh"].manifest,
                     "--hmm-param-dir", reps["igh"].gene_dir, "--precision",
                     "f64", "--device", "cuda"]) == 0
    assert pruning_cuda.launches == before + 1
    for out in reps["igh"].outputs:
        assert len(pathlib.Path(out).read_text().strip().split("\n")) > 1
