"""Batched Felsenstein pruning over xMSA columns: Hopper kernel + plain torch.

Counterpart of linearham_tpu/ops/pruning_pallas.py.  The input is a batch of
slot-reuse schedules (linearham_tpu/io/schedule.py): one flat post-order
entry list per tree, each entry applying one branch's message to a parent
slot.  The output is the per-site rate-mixed log-likelihood [T, X].

``site_log_likelihoods`` dispatches on the device of its tensors: CPU
tensors take ``site_log_likelihoods_plain``; CUDA tensors launch the
hand-written kernel (``csrc/pruning.cu``) or raise.  The plain version
follows the kernel's numerics exactly (P clamped at 0, renormalization on
every 4th entry, the -inf-safe rate mix), so on one device the two agree to
f32 roundoff.

Not carried over from the TPU wrapper: VMEM/SMEM block sizing, equal-shape
tree chunking, the R=1 category duplication (a Mosaic broadcast limit) and
site/tree padding -- the CUDA grid covers exactly T trees and masks the
ragged site edge.
"""

from __future__ import annotations

import ctypes

import torch

from linearham_tpu_torch.ops.gtr import GTREigen
from linearham_tpu_torch.utils.runtime import DeviceError

# Kernel launches made by site_log_likelihoods in this process (reset freely).
launches = 0

SUPPORTED_RATES = (1, 2, 4, 8)
MAX_SHARED_BYTES = 232_448      # 227 KB: a Hopper block's shared-memory cap

_lib = None


def kernel_lib() -> ctypes.CDLL:
    """Build (first use only) and bind csrc/pruning.cu."""
    global _lib
    if _lib is None:
        from linearham_tpu_torch.utils.cuda_build import load_library

        lib = load_library("pruning")
        lib.lh_pruning_smem_bytes.restype = ctypes.c_size_t
        lib.lh_pruning_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.lh_pruning_launch.restype = ctypes.c_int
        lib.lh_pruning_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def site_log_likelihoods(
    eig: GTREigen,               # u/u_inv [T,4,4], lam [T,4]
    pi: torch.Tensor,            # [T, 4]
    rates: torch.Tensor,         # [T, R]
    row_codes: torch.Tensor,     # [n_rows, X] int32 xMSA rows (shared)
    sched_src: torch.Tensor,     # [T, N] int32 xMSA row / live child slot
    sched_penc: torch.Tensor,    # [T, N] int32 parent*4 + first*2 + is_tip
    sched_len: torch.Tensor,     # [T, N] branch lengths
    sched_root: torch.Tensor,    # [T] int32 slot of the root partial
    n_slots: int,
) -> torch.Tensor:
    """Per-site rate-mixed log-likelihoods [T, X] for a scheduled batch."""
    args = (eig.u, eig.u_inv, eig.lam, pi, rates, row_codes, sched_src,
            sched_penc, sched_len, sched_root)
    kinds = {a.device.type for a in args}
    if kinds == {"cpu"}:
        return site_log_likelihoods_plain(
            eig, pi, rates, row_codes, sched_src, sched_penc, sched_len,
            sched_root, n_slots)
    if kinds != {"cuda"} or len({a.device for a in args}) != 1:
        raise ValueError(
            "pruning inputs must all lie on the CPU or all on one CUDA "
            f"device; got {sorted(str(a.device) for a in args)}")
    return _launch(eig, pi, rates, row_codes, sched_src, sched_penc,
                   sched_len, sched_root, n_slots)


def _launch(eig, pi, rates, row_codes, sched_src, sched_penc, sched_len,
            sched_root, n_slots) -> torch.Tensor:
    global launches
    T, N = sched_src.shape
    n_rows, X = row_codes.shape
    R = rates.shape[1] if rates.dim() == 2 else -1
    expect = {
        "eig.u": (eig.u, torch.float32, (T, 4, 4)),
        "eig.u_inv": (eig.u_inv, torch.float32, (T, 4, 4)),
        "eig.lam": (eig.lam, torch.float32, (T, 4)),
        "pi": (pi, torch.float32, (T, 4)),
        "rates": (rates, torch.float32, (T, R)),
        "row_codes": (row_codes, torch.int32, (n_rows, X)),
        "sched_src": (sched_src, torch.int32, (T, N)),
        "sched_penc": (sched_penc, torch.int32, (T, N)),
        "sched_len": (sched_len, torch.float32, (T, N)),
        "sched_root": (sched_root, torch.int32, (T,)),
    }
    for name, (a, dtype, shape) in expect.items():
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(
                f"pruning kernel: {name} must be {dtype} {shape}, got "
                f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"pruning kernel: {name} must be contiguous")
    if R not in SUPPORTED_RATES:
        raise ValueError(f"pruning kernel: R={R} rate categories; the kernel "
                         f"is built for R in {SUPPORTED_RATES}")

    lib = kernel_lib()
    need = lib.lh_pruning_smem_bytes(N, n_slots, R)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"pruning kernel: {need} bytes of shared memory needed at "
            f"N={N}, n_slots={n_slots}, R={R}; a block has at most "
            f"{MAX_SHARED_BYTES}")
    out = torch.empty((T, X), dtype=torch.float32, device=row_codes.device)
    if T == 0 or X == 0:
        return out
    with torch.cuda.device(row_codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lh_pruning_launch(
            row_codes.data_ptr(), sched_src.data_ptr(), sched_penc.data_ptr(),
            sched_len.data_ptr(), sched_root.data_ptr(), eig.u.data_ptr(),
            eig.u_inv.data_ptr(), eig.lam.data_ptr(), rates.data_ptr(),
            pi.data_ptr(), out.data_ptr(), T, N, X, n_slots, R, stream)
    if rc != 0:
        raise DeviceError(f"pruning kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def site_log_likelihoods_plain(
    eig: GTREigen, pi, rates, row_codes, sched_src, sched_penc, sched_len,
    sched_root, n_slots: int, renorm_stride: int = 4,
) -> torch.Tensor:
    """The kernel's computation as a batched torch schedule walk.

    Runs on any device in the dtype of ``eig.u``; it holds the partials of
    every tree at once, [T, n_slots, R, 4, X].
    """
    dtype, device = eig.u.dtype, eig.u.device
    T, N = sched_src.shape
    X = row_codes.shape[1]
    R = rates.shape[1]
    ar = torch.arange(T, device=device)
    rates, pi = rates.to(dtype), pi.to(dtype)
    lam, u_inv = eig.lam.to(dtype), eig.u_inv.to(dtype)
    # outer[t, k, i, j] = u[t, i, k] * u_inv[t, k, j]
    outer = eig.u.transpose(1, 2)[:, :, :, None] * u_inv[:, :, None, :]
    # Tip codes index P's columns; 4 = ambiguous (ones), 5 = invalid (zeros).
    codes = row_codes.long()
    codes = torch.where(codes >= 4, 4, torch.where(codes < 0, 5, codes))
    pad_cols = torch.stack([torch.ones((), dtype=dtype, device=device),
                            torch.zeros((), dtype=dtype, device=device)])
    pad_cols = pad_cols.expand(T, R, 4, 2)

    partials = torch.zeros((T, n_slots, R, 4, X), dtype=dtype, device=device)
    scale = torch.zeros((T, R, X), dtype=dtype, device=device)
    src, penc = sched_src.long(), sched_penc.long()
    lengths = sched_len.to(dtype)
    for k in range(N):
        expd = torch.exp(rates[:, :, None]
                         * (lengths[:, k, None, None] * lam[:, None, :]))
        P = torch.clamp(
            (expd[:, :, :, None, None] * outer[:, None]).sum(2), min=0.0)
        s, enc = src[:, k], penc[:, k]
        p, first, is_tip = enc >> 2, (enc >> 1) & 1, enc & 1
        tip_cols = codes[torch.where(is_tip == 1, s, 0)]          # [T, X]
        tip_msg = torch.gather(
            torch.cat([P, pad_cols], dim=3), 3,
            tip_cols[:, None, None, :].expand(T, R, 4, X))
        child = partials[ar, torch.where(is_tip == 1, 0, s)]      # [T,R,4,X]
        edge_msg = torch.matmul(P, child)
        msg = torch.where(is_tip[:, None, None, None] == 1, tip_msg, edge_msg)
        upd = torch.where(first[:, None, None, None] == 1, msg,
                          partials[ar, p] * msg)
        if k % renorm_stride == renorm_stride - 1:
            m = upd.amax(dim=2, keepdim=True)
            m = torch.where(m > 0, m, torch.ones_like(m))
            upd = upd / m
            scale = scale + torch.log(m[:, :, 0, :])
        partials[ar, p] = upd

    root = partials[ar, sched_root.long()]                        # [T,R,4,X]
    lik = (pi[:, None, :, None] * root).sum(2)          # [T, R, X]
    per_rate = torch.log(lik) + scale
    mx = per_rate.amax(dim=1, keepdim=True)
    # Zero-likelihood sites make every per_rate entry -inf; subtracting a
    # finite 0 instead of -inf keeps exp() at 0 so the mix is -inf, not NaN.
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    mix = mx + torch.log(torch.exp(per_rate - safe).sum(1, keepdim=True))
    return (mix - torch.log(torch.tensor(float(R), dtype=dtype,
                                         device=device)))[:, 0, :]
