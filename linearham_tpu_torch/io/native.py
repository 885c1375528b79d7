"""ctypes bindings for the native (C++) host kernels.

The shared library is built from ``csrc/native/`` with ``g++`` (no external
deps) on first use by ``utils/native_build.py``; every entry point has a
pure-Python fallback, taken where the library cannot be built.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from linearham_tpu_torch.utils.constants import EPS

_lib = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    from linearham_tpu_torch.utils.native_build import build_native

    path = build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.lh_parse_newicks.restype = ctypes.c_int
    lib.lh_parse_newicks.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64),
        ctypes.c_char_p, ctypes.c_long,
    ]
    if hasattr(lib, "lh_parse_trees_tsv"):
        lib.lh_parse_trees_tsv.restype = ctypes.c_int
        lib.lh_parse_trees_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_char_p, ctypes.c_long,
        ]
    if hasattr(lib, "lh_build_schedule"):
        lib.lh_build_schedule.restype = ctypes.c_int
        lib.lh_build_schedule.argtypes = [
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.int32),     # tip_perm
            np.ctypeslib.ndpointer(np.int32),     # tip_parent
            np.ctypeslib.ndpointer(np.float64),   # tip_length
            np.ctypeslib.ndpointer(np.int32),     # edge_child
            np.ctypeslib.ndpointer(np.int32),     # edge_parent
            np.ctypeslib.ndpointer(np.float64),   # edge_length
            np.ctypeslib.ndpointer(np.int32),     # root_slot
            np.ctypeslib.ndpointer(np.int32),     # src out
            np.ctypeslib.ndpointer(np.int32),     # penc out
            np.ctypeslib.ndpointer(np.float64),   # length out
            np.ctypeslib.ndpointer(np.int32),     # root out
            np.ctypeslib.ndpointer(np.int32),     # peak out
            ctypes.c_char_p, ctypes.c_long,
        ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def parse_newicks_batch(newicks: Sequence[str], labels: Sequence[str],
                        default_branch_length: float = EPS):
    """Parse a batch of Newick strings into a TreeBatch via the C++ kernel.

    Returns None when the native library is unavailable (callers fall back
    to the Python parser).
    """
    lib = _load()
    if lib is None:
        return None
    from linearham_tpu_torch.io.newick import TreeBatch

    n = len(newicks)
    n_tips = len(labels)
    max_edges = max(n_tips, 1)

    texts = (ctypes.c_char_p * n)(
        *[s.encode("utf-8") for s in newicks])
    labels_cat = b"".join(lab.encode("utf-8") + b"\0" for lab in labels)

    n_internal = np.zeros(n, np.int32)
    tip_perm = np.zeros((n, n_tips), np.int32)
    tip_parent = np.zeros((n, n_tips), np.int32)
    tip_length = np.zeros((n, n_tips), np.float64)
    edge_child = np.zeros((n, max_edges), np.int32)
    edge_parent = np.zeros((n, max_edges), np.int32)
    edge_length = np.zeros((n, max_edges), np.float64)
    err = ctypes.create_string_buffer(512)

    rc = lib.lh_parse_newicks(
        texts, n, default_branch_length, labels_cat, n_tips,
        n_tips, max_edges,
        n_internal, tip_perm, tip_parent, tip_length,
        edge_child, edge_parent, edge_length, err, len(err),
    )
    if rc != 0:
        raise ValueError(
            "native Newick parse failed: " + err.value.decode())

    # Trim padding to the batch-wide maximum and point no-op edges at the
    # sink slot (mirrors io.newick.batch_trees).
    max_internal = int(n_internal.max())
    n_slots = max_internal + 1
    sink = n_slots - 1
    e_max = max(int((n_internal - 1).max()), 0)
    edge_child = edge_child[:, :e_max].copy()
    edge_parent = edge_parent[:, :e_max].copy()
    edge_length = edge_length[:, :e_max].copy()
    pad = edge_child < 0
    edge_child[pad] = sink
    edge_parent[pad] = sink

    return TreeBatch(
        tip_perm=tip_perm,
        tip_parent=tip_parent,
        tip_length=tip_length,
        edge_child=edge_child,
        edge_parent=edge_parent,
        edge_length=edge_length,
        root_slot=(n_internal - 1).astype(np.int32),
        n_slots=n_slots,
    )


def build_schedule_batch_native(tb):
    """Slot-reuse pruning schedules via the C++ kernel (io.schedule docs).

    Returns None when the native library is unavailable or lacks the
    symbol (callers fall back to the Python builder)."""
    lib = _load()
    if lib is None or not hasattr(lib, "lh_build_schedule"):
        return None
    from linearham_tpu_torch.io.schedule import (PruningSchedule,
                                                 _fill_padding, _round_slots)

    T, n_tips = tb.tip_perm.shape
    e_max = tb.edge_child.shape[1]
    N = n_tips + e_max
    src = np.zeros((T, N), np.int32)
    penc = np.full((T, N), -1, np.int32)
    length = np.zeros((T, N), np.float64)
    root = np.zeros(T, np.int32)
    peak = np.zeros(T, np.int32)
    err = ctypes.create_string_buffer(256)

    rc = lib.lh_build_schedule(
        T, n_tips, e_max,
        np.ascontiguousarray(tb.tip_perm, np.int32),
        np.ascontiguousarray(tb.tip_parent, np.int32),
        np.ascontiguousarray(tb.tip_length, np.float64),
        np.ascontiguousarray(tb.edge_child, np.int32),
        np.ascontiguousarray(tb.edge_parent, np.int32),
        np.ascontiguousarray(tb.edge_length, np.float64),
        np.ascontiguousarray(tb.root_slot, np.int32),
        src, penc, length, root, peak, err, len(err))
    if rc != 0:
        raise ValueError(
            "native schedule build failed: " + err.value.decode())

    n_slots = _round_slots(int(peak.max()))
    _fill_padding(src, penc, length, n_slots)
    return PruningSchedule(src=src, penc=penc, length=length, root=root,
                           n_slots=n_slots)


def parse_trees_tsv_bytes(data: bytes):
    """Parse RevBayes .trees TSV bytes via the C++ kernel.

    Returns (numeric [rows, 14] float64 in column order Iteration,
    Likelihood, Prior, alpha, er[1..6], pi[1..4]; newicks list[str]), or
    None when the native library is unavailable or lacks the symbol
    (callers fall back to the Python csv loader).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "lh_parse_trees_tsv"):
        return None

    max_rows = max(data.count(b"\n"), 1)
    numeric = np.zeros((max_rows, 14), np.float64)
    tree_off = np.zeros(max_rows, np.int64)
    tree_len = np.zeros(max_rows, np.int64)
    n_rows = ctypes.c_long(0)
    err = ctypes.create_string_buffer(512)

    rc = lib.lh_parse_trees_tsv(
        data, len(data), max_rows, ctypes.byref(n_rows),
        numeric, tree_off, tree_len, err, len(err),
    )
    if rc != 0:
        raise ValueError(
            "native trees-TSV parse failed: " + err.value.decode())
    n = n_rows.value
    newicks = [
        data[tree_off[i]:tree_off[i] + tree_len[i]].decode()
        for i in range(n)
    ]
    return numeric[:n], newicks
