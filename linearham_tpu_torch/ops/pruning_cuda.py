"""Batched Felsenstein pruning over xMSA columns: Hopper kernel + plain torch.

Counterpart of linearham_tpu/ops/pruning_pallas.py.  The input is a batch of
slot-reuse schedules (linearham_tpu/io/schedule.py): one flat post-order
entry list per tree, each entry applying one branch's message to a parent
slot.  The output is the per-site rate-mixed log-likelihood [T, X].

``site_log_likelihoods`` dispatches on the device of its tensors: CPU
tensors take ``site_log_likelihoods_plain``; CUDA tensors launch the
hand-written kernel (``csrc/pruning.cu``) or raise.  The kernel runs in f32
or in f64 (all floating inputs in one of the two); the plain version
follows its numerics exactly (P clamped at 0, renormalization on every 4th
entry, the -inf-safe rate mix), so on one device the two agree to the
roundoff of the dtype.

Not carried over from the TPU wrapper: VMEM/SMEM block sizing, equal-shape
tree chunking, the R=1 category duplication (a Mosaic broadcast limit) and
site/tree padding -- the CUDA grid covers exactly T trees and masks the
ragged site edge.

``stack_schedules`` turns several families' schedules and xMSA row tables
into the inputs of ONE launch (the repertoire path): the row tables are
stacked into one code table, each family's tip entries are offset to its
rows, and the families' trees are concatenated along T.  The kernel's
interface is unchanged: it already reads one shared row table and per-tree
tip row indices.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from linearham_tpu_torch.io.schedule import PruningSchedule
from linearham_tpu_torch.ops.gtr import GTREigen
from linearham_tpu_torch.utils.runtime import DeviceError

# Kernel launches made by site_log_likelihoods in this process (reset freely).
launches = 0

SUPPORTED_RATES = (1, 2, 4, 8)
KERNEL_DTYPES = {torch.float32: 4, torch.float64: 8}   # -> element bytes
MAX_SHARED_BYTES = 232_448      # 227 KB: a Hopper block's shared-memory cap

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built pruning library (csrc/pruning.cu
    or an earlier version of it, for a comparison on the card)."""
    lib.lh_pruning_smem_bytes.restype = ctypes.c_size_t
    lib.lh_pruning_smem_bytes.argtypes = [ctypes.c_int] * 4
    for entry in (lib.lh_pruning_launch, lib.lh_pruning_launch_f64):
        entry.restype = ctypes.c_int
        entry.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
    return lib


def kernel_lib() -> ctypes.CDLL:
    """Build (first use only) and bind csrc/pruning.cu."""
    global _lib
    if _lib is None:
        from linearham_tpu_torch.utils.cuda_build import load_library

        lib = bind(load_library("pruning"))
        lib.lh_pruning_tile.restype = ctypes.c_int
        lib.lh_pruning_tile.argtypes = [ctypes.c_int]
        lib.lh_pruning_blocks_per_sm.restype = ctypes.c_int
        lib.lh_pruning_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        _lib = lib
    return _lib


def check_schedule(sched: PruningSchedule, n_rows: int) -> None:
    """Raise unless every schedule index is in range: the kernel trusts
    them as addresses."""
    is_tip = (sched.penc & 1) == 1
    parent = sched.penc >> 2
    bad = (sched.penc < 0) | (parent >= sched.n_slots) | (sched.src < 0) \
        | np.where(is_tip, sched.src >= n_rows, sched.src >= sched.n_slots)
    if bad.any() or (sched.root < 0).any() \
            or (sched.root >= sched.n_slots).any():
        raise ValueError("pruning schedule indexes outside the xMSA rows or "
                         "the live slots")


@dataclass
class StackedSchedule:
    """Several families' pruning inputs as one launch's (``stack_schedules``).

    Family ``f`` owns trees ``tree_offsets[f]:tree_offsets[f+1]`` of
    ``sched`` and rows ``row_offsets[f]:row_offsets[f+1]`` of ``codes``; its
    real sites are the first ``n_cols[f]`` columns of the output.
    """

    codes: np.ndarray            # [sum_f n_rows_f + 1, X_max] int32
    sched: PruningSchedule       # [sum_f T_f, N_max], bucket n_slots
    tree_offsets: np.ndarray     # [F + 1]
    row_offsets: np.ndarray      # [F + 1]
    n_cols: List[int]            # X_f

    def trees(self, f: int) -> slice:
        return slice(int(self.tree_offsets[f]), int(self.tree_offsets[f + 1]))


def stack_schedules(scheds: Sequence[PruningSchedule],
                    row_tables: Sequence[np.ndarray]) -> StackedSchedule:
    """Stack families' schedules and xMSA row tables for one launch.

    * Rows: one table [sum_f n_rows_f + 1, X_max]; a family's columns past
      its own X_f, and the last row, hold code 4 (N, a message of ones).
    * Entries: each family's [T_f, N_f] schedule keeps its entries at their
      positions (so the every-4th-entry renormalisation lands where it does
      in a launch of that family alone); its tip entries' ``src`` move by
      the family's row offset, and its own sink padding moves to the
      bucket-wide sink (slot ``n_slots - 1`` of the largest ``n_slots``).
      Entries past N_f are sink padding too (io/schedule.py's convention,
      ``penc = sink*4 + 2 + 1``, length 0) whose tip row is the all-N
      row: the message is exactly ones, its renormalisation adds log 1 = 0,
      and real sites come out as in a launch of the family alone.
    * ``src`` stays int32: offsets pass 32,767 rows in a large repertoire.

    Every index is checked against the stacked table before it can reach
    the kernel.
    """
    if not scheds or len(scheds) != len(row_tables):
        raise ValueError("stack_schedules needs one row table per schedule")
    n_entries = max(s.n_entries for s in scheds)
    n_slots = max(s.n_slots for s in scheds)
    pad = (n_slots - 1) * 4 + 2 + 1
    X = max(r.shape[1] for r in row_tables)
    row_off = np.cumsum([0] + [r.shape[0] for r in row_tables])
    tree_off = np.cumsum([0] + [s.n_trees for s in scheds])
    codes = np.full((int(row_off[-1]) + 1, X), 4, np.int32)
    T = int(tree_off[-1])
    src = np.full((T, n_entries), codes.shape[0] - 1, np.int32)
    penc = np.full((T, n_entries), pad, np.int32)
    length = np.zeros((T, n_entries))
    root = np.empty(T, np.int32)
    for f, (s, rows) in enumerate(zip(scheds, row_tables)):
        codes[row_off[f]:row_off[f + 1], :rows.shape[1]] = rows
        t = slice(tree_off[f], tree_off[f + 1])
        n = s.n_entries
        own_penc = np.asarray(s.penc, np.int32)
        src[t, :n] = np.where((own_penc & 1) == 1, s.src + row_off[f], s.src)
        penc[t, :n] = np.where(own_penc == (s.n_slots - 1) * 4 + 2 + 1, pad,
                               own_penc)
        length[t, :n] = s.length
        root[t] = s.root
    stacked = PruningSchedule(src=src, penc=penc, length=length, root=root,
                              n_slots=n_slots)
    check_schedule(stacked, codes.shape[0])
    return StackedSchedule(codes=codes, sched=stacked, tree_offsets=tree_off,
                           row_offsets=row_off,
                           n_cols=[r.shape[1] for r in row_tables])


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
            sched_root, n_slots, lib=None) -> torch.Tensor:
    """Check the inputs and launch the kernel in their float type (all f32
    or all f64; a mix is refused by name).  The kernel fixes each type's
    site tile (csrc/pruning.cu: 64 sites in f32, 32 in f64, one a thread,
    beside a producer warp).  ``lib``: another build of the same interface
    (a comparison on the card); every launch counts."""
    global launches
    T, N = sched_src.shape
    n_rows, X = row_codes.shape
    R = rates.shape[1] if rates.dim() == 2 else -1
    fdtype = eig.u.dtype if eig.u.dtype in KERNEL_DTYPES else torch.float32
    expect = {
        "eig.u": (eig.u, fdtype, (T, 4, 4)),
        "eig.u_inv": (eig.u_inv, fdtype, (T, 4, 4)),
        "eig.lam": (eig.lam, fdtype, (T, 4)),
        "pi": (pi, fdtype, (T, 4)),
        "rates": (rates, fdtype, (T, R)),
        "row_codes": (row_codes, torch.int32, (n_rows, X)),
        "sched_src": (sched_src, torch.int32, (T, N)),
        "sched_penc": (sched_penc, torch.int32, (T, N)),
        "sched_len": (sched_len, fdtype, (T, N)),
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

    lib = lib or kernel_lib()
    need = lib.lh_pruning_smem_bytes(N, n_slots, R, KERNEL_DTYPES[fdtype])
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"pruning kernel: {need} bytes of shared memory needed at "
            f"N={N}, n_slots={n_slots}, R={R}, {fdtype}; a block has at "
            f"most {MAX_SHARED_BYTES}")
    out = torch.empty((T, X), dtype=fdtype, device=row_codes.device)
    if T == 0 or X == 0:
        return out
    entry = lib.lh_pruning_launch_f64 if fdtype == torch.float64 \
        else lib.lh_pruning_launch
    with torch.cuda.device(row_codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(
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
