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
from pathlib import Path

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


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the path
    of the shared library.  The ptxas report (registers, shared memory,
    spills) is kept beside it as ``<lib>.log``."""
    source = CSRC_DIR / f"{name}.cu"
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    lib = BUILD_DIR / f"{name}-{build_key(source, version)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise DeviceError(f"nvcc failed to build {source}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)   # atomic: concurrent builds each leave a whole file
    return lib


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
