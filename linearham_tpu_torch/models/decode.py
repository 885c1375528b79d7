"""Decoding sampled hidden-state paths into V(D)J annotations (host numpy).

Twin of linearham_tpu/models/decode.py: that module is numpy inside, but
its package's __init__ imports jax.  It turns the integer state paths drawn
by ops.ffbs into the reference's annotation vocabulary: naive sequence,
per-segment gene choices, 5'/3' deletion lengths, junction insertion
strings, and framework (leading / trailing N) insertions (reference
semantics: src/HMM.cpp:322-431).  Only the vectorized batch walk is kept;
``decode_path`` is its one-path case (the JAX package's tests pin the two
walks field for field, tests/test_decode_batch.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from linearham_tpu_torch.compiler.state_space import (GermlineRegion,
                                                      JunctionRegion,
                                                      StateSpace)


@dataclass
class Annotation:
    naive_seq: str
    vgerm_state: str
    vgerm_idx: int
    v_5p_del: int
    v_3p_del: int
    v_fwk_insertion: str
    vd_states: List[str]
    vd_idx: List[int]
    vd_insertion: str             # VJ insertion for light chains
    dgerm_state: Optional[str]
    dgerm_idx: Optional[int]
    d_5p_del: Optional[int]
    d_3p_del: Optional[int]
    dj_states: Optional[List[str]]
    dj_idx: Optional[List[int]]
    dj_insertion: Optional[str]
    jgerm_state: str
    jgerm_idx: int
    j_5p_del: int
    j_3p_del: int
    j_fwk_insertion: str


def _region_fill_tables(region: GermlineRegion, n_sites: int, alphabet: str):
    """Padded per-state (positions, ASCII base codes) fill tables.

    Row g gives gene state g's naive-site scatter, padded to the longest
    gene with a scratch column (``n_sites``) so a whole batch of sampled
    states fills in one fancy-index assignment.  Cached on the region.
    """
    cached = getattr(region, "_port_fill_tables", None)
    if cached is not None and cached[0] == n_sites:
        return cached[1], cached[2]
    per_state = []
    for name in region.state_strs:
        start, end = region.ggene_ranges[name]
        pos = np.asarray(region.site_inds[start:end], dtype=np.intp)
        base = np.array(
            [ord(alphabet[b]) for b in region.naive_bases[start:end]],
            dtype=np.uint8)
        per_state.append((pos, base))
    l_max = max((len(p) for p, _ in per_state), default=0)
    G = len(per_state)
    pos_pad = np.full((G, max(l_max, 1)), n_sites, dtype=np.intp)
    base_pad = np.full((G, max(l_max, 1)), ord("N"), dtype=np.uint8)
    for g, (pos, base) in enumerate(per_state):
        pos_pad[g, : len(pos)] = pos
        base_pad[g, : len(base)] = base
    object.__setattr__(region, "_port_fill_tables",
                       (n_sites, pos_pad, base_pad))
    return pos_pad, base_pad


def _junction_tables(junction: JunctionRegion, alphabet: str,
                     left_gtype: str, right_gtype: str):
    """Per-state lookup arrays for the vectorized junction walk (cached)."""
    key = (left_gtype, right_gtype)
    cache = getattr(junction, "_port_walk_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(junction, "_port_walk_tables", cache)
    tables = cache.get(key)
    if tables is None:
        base = np.array(
            [ord(alphabet[b]) for b in junction.naive_bases],
            dtype=np.uint8)
        dels = np.asarray(junction.deletions, dtype=np.int64)
        gt = np.asarray(junction.gtypes)
        cache[key] = tables = (
            base, dels, gt == left_gtype, gt == right_gtype)
    return tables


def _batch_fill_germline(buf: np.ndarray, region: GermlineRegion,
                         idx: np.ndarray, n_sites: int,
                         alphabet: str) -> None:
    """Fill every path's germline sites for this region in one scatter
    (``buf`` is [T, n_sites+1]; the extra column absorbs padding writes)."""
    pos_pad, base_pad = _region_fill_tables(region, n_sites, alphabet)
    T = idx.shape[0]
    buf[np.arange(T)[:, None], pos_pad[idx]] = base_pad[idx]


def _batch_walk_junction(buf, junction: JunctionRegion, idx: np.ndarray,
                         left_gtype: str, right_gtype: str, alphabet: str):
    """The junction walk over T paths at once.

    Returns (right_5p_del [T], has_right [T], insertions List[str],
    left_3p_del [T], has_left [T]).  Walking right to left, the reference
    keeps overwriting ``right_5p_del`` (so the LEFTMOST right-germline row
    wins) and keeps only the first ``left_3p_del`` (the RIGHTMOST
    left-germline row); argmax over boolean masks picks both extremes.
    """
    base, dels, is_left, is_right = _junction_tables(
        junction, alphabet, left_gtype, right_gtype)
    T, R = idx.shape
    if R == 0:
        zeros = np.zeros(T, dtype=np.int64)
        falses = np.zeros(T, dtype=bool)
        return zeros, falses, [""] * T, zeros, falses
    buf[:, junction.site_start: junction.site_start + R] = base[idx]

    d = dels[idx]                               # [T, R]
    t_ids = np.arange(T)

    right_germ = is_right[idx] & (d != -1)
    has_right = right_germ.any(axis=1)
    right_5p = d[t_ids, np.argmax(right_germ, axis=1)]

    left_m = is_left[idx]
    has_left = left_m.any(axis=1)
    left_3p = d[t_ids, R - 1 - np.argmax(left_m[:, ::-1], axis=1)]

    nti = is_right[idx] & (d == -1)
    chars = base[idx].view("S1")                # [T, R] one-byte strings
    masked = np.where(nti, chars, b"")
    insertions = [b"".join(row).decode() for row in masked.tolist()]
    return right_5p, has_right, insertions, left_3p, has_left


def decode_paths_batch(
    space: StateSpace,
    vgerm_idx: np.ndarray,                 # [T]
    vd_idx: np.ndarray,                    # [T, R1]
    dgerm_idx: Optional[np.ndarray],       # [T] (igh only)
    dj_idx: Optional[np.ndarray],          # [T, R2] (igh only)
    jgerm_idx: np.ndarray,                 # [T]
    n_sites: int,
) -> List[Annotation]:
    """Decode T sampled paths at once.  Region fill order is J, DJ, D, VD,
    V: later stages overwrite earlier ones, as in the reference walk."""
    alphabet = space.alphabet
    heavy = space.is_heavy
    vgerm_idx = np.asarray(vgerm_idx, dtype=np.intp).reshape(-1)
    jgerm_idx = np.asarray(jgerm_idx, dtype=np.intp).reshape(-1)
    vd_idx = np.asarray(vd_idx, dtype=np.intp)
    T = vgerm_idx.shape[0]
    buf = np.full((T, n_sites + 1), ord("N"), dtype=np.uint8)

    j_5p = np.asarray(space.jgerm.left_del)[jgerm_idx]
    j_3p = np.asarray(space.jgerm.right_del)[jgerm_idx]
    _batch_fill_germline(buf, space.jgerm, jgerm_idx, n_sites, alphabet)

    if heavy:
        dgerm_idx = np.asarray(dgerm_idx, dtype=np.intp).reshape(-1)
        dj_idx = np.asarray(dj_idx, dtype=np.intp)
        r5, has_r5, dj_ins, l3, has_l3 = _batch_walk_junction(
            buf, space.dj_junction, dj_idx, "D", "J", alphabet)
        j_5p = np.where(has_r5, r5, j_5p)
        d_5p = np.asarray(space.dgerm.left_del)[dgerm_idx]
        d_3p = np.where(has_l3, l3,
                        np.asarray(space.dgerm.right_del)[dgerm_idx])
        _batch_fill_germline(buf, space.dgerm, dgerm_idx, n_sites, alphabet)

        r5, has_r5, vd_ins, l3, has_l3 = _batch_walk_junction(
            buf, space.vd_junction, vd_idx, "V", "D", alphabet)
        d_5p = np.where(has_r5, r5, d_5p)
    else:
        r5, has_r5, vd_ins, l3, has_l3 = _batch_walk_junction(
            buf, space.vd_junction, vd_idx, "V", "J", alphabet)
        j_5p = np.where(has_r5, r5, j_5p)

    v_5p = np.asarray(space.vgerm.left_del)[vgerm_idx]
    v_3p = np.where(has_l3, l3, np.asarray(space.vgerm.right_del)[vgerm_idx])
    _batch_fill_germline(buf, space.vgerm, vgerm_idx, n_sites, alphabet)

    codes = np.ascontiguousarray(buf[:, :n_sites])
    naive_seqs = [
        s.decode() for s in codes.view(f"S{n_sites}").ravel().tolist()
    ] if n_sites else [""] * T

    # Framework insertions: leading/trailing N runs, but only when the
    # interior is N-free (the reference's ^(N*)[ACGT]+(N*)$ match).
    if n_sites:
        non_n = codes != ord("N")
        any_non = non_n.any(axis=1)
        first = np.argmax(non_n, axis=1)
        last = n_sites - 1 - np.argmax(non_n[:, ::-1], axis=1)
        clean = any_non & (non_n.sum(axis=1) == last - first + 1)
        v_fwk = ["N" * int(f) if c else ""
                 for c, f in zip(clean.tolist(), first.tolist())]
        j_fwk = ["N" * int(n_sites - 1 - l) if c else ""
                 for c, l in zip(clean.tolist(), last.tolist())]
    else:
        v_fwk = j_fwk = [""] * T

    def strs(region, idx):
        return np.asarray(region.state_strs, dtype=object)[idx].tolist()

    vgerm_states = strs(space.vgerm, vgerm_idx)
    jgerm_states = strs(space.jgerm, jgerm_idx)
    vd_states = strs(space.vd_junction, vd_idx)
    vd_lists = vd_idx.tolist()
    if heavy:
        dgerm_states = strs(space.dgerm, dgerm_idx)
        dj_states = strs(space.dj_junction, dj_idx)
        dj_lists = dj_idx.tolist()

    out = []
    for t in range(T):
        out.append(Annotation(
            naive_seq=naive_seqs[t],
            vgerm_state=vgerm_states[t],
            vgerm_idx=int(vgerm_idx[t]),
            v_5p_del=int(v_5p[t]),
            v_3p_del=int(v_3p[t]),
            v_fwk_insertion=v_fwk[t],
            vd_states=vd_states[t],
            vd_idx=vd_lists[t],
            vd_insertion=vd_ins[t],
            dgerm_state=dgerm_states[t] if heavy else None,
            dgerm_idx=int(dgerm_idx[t]) if heavy else None,
            d_5p_del=int(d_5p[t]) if heavy else None,
            d_3p_del=int(d_3p[t]) if heavy else None,
            dj_states=dj_states[t] if heavy else None,
            dj_idx=dj_lists[t] if heavy else None,
            dj_insertion=dj_ins[t] if heavy else None,
            jgerm_state=jgerm_states[t],
            jgerm_idx=int(jgerm_idx[t]),
            j_5p_del=int(j_5p[t]),
            j_3p_del=int(j_3p[t]),
            j_fwk_insertion=j_fwk[t],
        ))
    return out


def decode_path(
    space: StateSpace,
    vgerm_idx: int,
    vd_idx: Sequence[int],
    dgerm_idx: Optional[int],
    dj_idx: Optional[Sequence[int]],
    jgerm_idx: int,
    n_sites: int,
) -> Annotation:
    """Decode one sampled path into a full annotation."""
    heavy = space.is_heavy
    return decode_paths_batch(
        space, np.asarray([vgerm_idx]), np.asarray([vd_idx]),
        np.asarray([dgerm_idx]) if heavy else None,
        np.asarray([dj_idx]) if heavy else None,
        np.asarray([jgerm_idx]), n_sites)[0]
