"""The port loads without jax, runs matmuls at full f32, and asks for its
device explicitly."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from linearham_tpu_torch.utils import runtime
from linearham_tpu_torch.utils.cuda_build import CSRC_DIR, build_key

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "linearham_tpu_torch"


def test_import_leaves_jax_out_of_sys_modules():
    """Run in a fresh interpreter: this test process already holds jax
    (tests/conftest.py imports it)."""
    code = (
        "import sys\n"
        "import linearham_tpu_torch, linearham_tpu_torch.pipeline.run, "
        "linearham_tpu_torch.cli, linearham_tpu_torch.ops.pruning_cuda, "
        "linearham_tpu_torch.utils.synth, linearham_tpu_torch.ops.pruning, "
        "linearham_tpu_torch.ops.asr, linearham_tpu_torch.ops.viterbi, "
        "linearham_tpu_torch.models, linearham_tpu_torch.models.simple_hmm, "
        "linearham_tpu_torch.compiler.family_cache, "
        "linearham_tpu_torch.postprocess.bootstrap_asr, "
        "linearham_tpu_torch.parallel.repertoire, "
        "linearham_tpu_torch.parallel.multihost, "
        "linearham_tpu_torch.parallel.mesh, "
        "linearham_tpu_torch.parallel.dryrun, "
        "linearham_tpu_torch.workflow\n"
        "print(sorted(m for m in sys.modules "
        "if m == 'jax' or m.startswith(('jax.', 'jaxlib'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders


def test_building_a_model_turns_tf32_off(fixtures_dir):
    """Counterpart of tests/test_precision.py's HIGHEST pin: the region
    emissions sum hundreds of site log-likelihoods, so f32 matmuls must
    not run in TF32."""
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
             str(fixtures_dir / "hmm_params"), device="cpu",
             dtype=torch.float32)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_no_device_means_cuda_or_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_resolve_dtype():
    assert runtime.resolve_dtype(None, "cpu") == torch.float64
    assert runtime.resolve_dtype("auto", "cpu") == torch.float64
    assert runtime.resolve_dtype("auto", "cuda") == torch.float32
    assert runtime.resolve_dtype("f32", "cpu") == torch.float32
    assert runtime.resolve_dtype(torch.float64) == torch.float64
    with pytest.raises(ValueError):
        runtime.resolve_dtype("bf16", "cpu")


def test_kernel_build_key_tracks_source_and_compiler(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    key = build_key(src, "nvcc 12.9")
    assert key == build_key(src, "nvcc 12.9")
    assert key != build_key(src, "nvcc 12.8")
    src.write_text("__global__ void k() { }\n")
    assert key != build_key(src, "nvcc 12.9")
    assert (CSRC_DIR / "pruning.cu").is_file()


def test_device_errors_are_told_from_bad_requests():
    """What ends the serve loop: the port's kernel failures and torch's
    CUDA errors; an out-of-memory error or a bad input does not."""
    assert runtime.is_device_error(runtime.DeviceError("launch failed"))
    assert runtime.is_device_error(
        RuntimeError("CUDA error: device-side assert triggered"))
    assert not runtime.is_device_error(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not runtime.is_device_error(ValueError("missing key"))
    assert not runtime.is_device_error(FileNotFoundError("no such file"))
