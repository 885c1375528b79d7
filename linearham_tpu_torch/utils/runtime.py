"""Device, dtype and matmul-precision policy.

Production runs use a CUDA device in f32, where the hand-written pruning
kernel runs; conformance runs use the CPU in f64, where the plain version
reproduces the reference's golden log-likelihoods.  There is no automatic
fallback: without a device argument the port asks for CUDA and raises if
there is none; the CPU is used only when it is named.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class DeviceError(RuntimeError):
    """A CUDA kernel of the port failed to build or launch."""


def is_device_error(exc: BaseException) -> bool:
    """True for a failure of the device itself -- a kernel that did not
    build or launch, or a CUDA error reported by torch (a device-side
    assert, an illegal address) -- after which the CUDA context may be
    unusable.  An out-of-memory error is not one: the context survives it.
    """
    if isinstance(exc, DeviceError):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def full_f32_matmuls() -> None:
    """Run every f32 matmul and convolution at full f32, never TF32.

    The region emissions sum hundreds of site log-likelihoods of ~-26 each
    at a 312-sequence family's depth; TF32 keeps 10 mantissa bits, which
    random-walks the per-tree log-likelihood and distorts the importance
    weights.  This is the port's counterpart of the JAX package's
    ``Precision.HIGHEST`` (linearham_tpu/models/phylo_hmm.py:158-166).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the production device, CUDA; any name is taken as is."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "CPU conformance path")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(precision: Union[str, torch.dtype, None] = None,
                  device: DeviceLike = None) -> torch.dtype:
    """Map a --precision value onto a torch dtype.

    ``f32``/``f64`` (or a torch dtype) are explicit; ``None``/``auto`` picks
    f32 on CUDA and f64 on the CPU.
    """
    if isinstance(precision, torch.dtype):
        if precision not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {precision}")
        return precision
    if precision in (None, "auto"):
        return torch.float32 if resolve_device(device).type == "cuda" \
            else torch.float64
    if precision in ("f32", "float32"):
        return torch.float32
    if precision in ("f64", "float64"):
        return torch.float64
    raise ValueError(f"unknown precision {precision!r} "
                     "(expected f32, f64, or auto)")


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (one line a card)."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def to_device(a, device: torch.device, dtype: torch.dtype,
              non_blocking: bool = False) -> torch.Tensor:
    """numpy array -> tensor on ``device``.  Floating arrays take ``dtype``;
    integer arrays become int32.  With ``non_blocking`` on a CUDA device the
    host copy is pinned first, so the transfer is asynchronous."""
    import numpy as np

    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    if device.type == "cuda" and non_blocking:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
