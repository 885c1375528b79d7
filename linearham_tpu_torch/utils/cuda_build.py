"""Build and load the port's CUDA kernels.

Each kernel source under ``linearham_tpu_torch/csrc/`` has a plain C
interface and is compiled by ``nvcc`` into its own shared library, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
are built at first use, from the sources in the checkout only, into
``build/kernels/`` at the repository root, keyed by a hash of the source,
the flags and the compiler's version, so an edited source is rebuilt and an
unchanged one is reused.

Nothing here runs when the module is imported: a CPU-only installation
without ``nvcc`` imports it freely and fails only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.runtime import DeviceError

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"

# Hopper only: the "a" target admits wgmma/setmaxnreg for later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise DeviceError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit")


def build_key(source: Path, nvcc_version: str) -> str:
    """Content hash of everything that determines the built library."""
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(nvcc_version.encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, source: Path, out: Path) -> str:
    """Run nvcc on ``source`` into ``out``; returns its output (the ptxas
    report: registers, shared memory, spills)."""
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        out.unlink(missing_ok=True)
        raise DeviceError(f"nvcc failed to build {source}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build_source(source: Path, name: str) -> Path:
    """Compile ``source`` (if not already built) into
    ``build/kernels/<name>-<key>.so`` and return its path.  The ptxas
    report is kept beside it as ``<lib>.log``.  A build is a kernel_build
    span and counts in kernel_builds (``utils.profiling``)."""
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    lib = BUILD_DIR / f"{name}-{build_key(source, version)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    with profiling.span("kernel_build"):
        lib.with_suffix(".log").write_text(_compile(nvcc, source, tmp))
    profiling.count("kernel_builds")
    os.replace(tmp, lib)   # atomic: concurrent builds each leave a whole file
    return lib


def build_report(source: Path, name: str) -> str:
    """The ptxas report of ``source``'s library: the ``.log`` kept beside
    it, or, where that is missing (a library left by another build), the
    output of compiling ``source`` again into a temporary directory."""
    log = build_source(source, name).with_suffix(".log")
    if log.exists():
        return log.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        return _compile(find_nvcc(), source, Path(tmp) / f"{name}.so")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the path
    of the shared library."""
    return build_source(CSRC_DIR / f"{name}.cu", name)


def load_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built if need be and loaded: a
    kernel_load span (``utils.profiling``), a kernel_build inside it."""
    with profiling.span("kernel_load"):
        return ctypes.CDLL(str(build_library(name)))
