"""Slot-reuse pruning schedules: Sethi-Ullman register allocation on trees.

The Pallas pruning kernel keeps every live Felsenstein partial in a VMEM
scratch of shape [n_slots, R, 4, Xb].  With one slot per internal node
(io.newick.TreeBatch), a 312-sequence clonal family needs ~313 slots and
the site-block width Xb collapses to 256 under the ~16MB scoped-VMEM cap —
so every tree pays FOUR serial passes over its topology plus a
313-iteration renormalization loop (measured: the binding constraint at
the reference's CI family depth, PERF_r04_312seq.json).

But a partial is only needed until its parent consumes it.  Scheduling
each node's heaviest subtree first and freeing a child's slot the moment
its message multiplies into the parent (Sethi-Ullman register allocation),
the peak number of simultaneously-live slots is at most
ceil(log2(n_tips)) + 1 — ~10 slots for 313 tips, ~17 for 100k.  The
scratch shrinks ~30x, Xb covers the full xMSA in ONE pass, and the
per-slot renorm loop disappears (first-write flags replace the ones-init).

A schedule is one flat post-order entry list per tree; each entry applies
one branch's message to a parent slot:

    src    tip entries: xMSA row of the tip's observed codes
           internal entries: the child's (live) slot
    penc   parent_slot * 4 + first * 2 + is_tip
           first=1 stores the message (fresh slot, or the in-place
           transform of a node's FIRST internal child, where src==parent);
           first=0 multiplies into the existing parent partial
    length branch length

Batch padding entries re-store a one-hot into the sink slot (slot
n_slots-1): exact no-ops whose renormalization factor is exactly 1.

The reference has no analogue: libpll allocates one CLV buffer per inner
node (src/PhyloHMM.cpp:224-226 boundary).  This is a TPU-VMEM-shaped
design choice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from linearham_tpu_torch.io.newick import TreeBatch


@dataclass
class PruningSchedule:
    """A padded batch of slot-reuse pruning schedules (one per tree)."""

    src: np.ndarray      # [T, N] int32 (xMSA row for tips; slot otherwise)
    penc: np.ndarray     # [T, N] int32 = parent_slot*4 + first*2 + is_tip
    length: np.ndarray   # [T, N] float64 branch lengths
    root: np.ndarray     # [T] int32 live slot holding the root partial
    n_slots: int         # live slots incl. the sink (sink = n_slots-1)

    @property
    def n_trees(self) -> int:
        return self.src.shape[0]

    @property
    def n_entries(self) -> int:
        return self.src.shape[1]


def _round_slots(peak: int) -> int:
    """Batch slot count: peak live + sink, rounded up to a multiple of 8
    (>= 8) so the kernel's compiled shape — and the exec-cache key — stays
    stable across ensembles of similar depth (peak grows ~log2(tips))."""
    return max(8, -(-(peak + 1) // 8) * 8)


def _schedule_one(tip_perm, tip_parent, tip_length,
                  edge_child, edge_parent, edge_length, root,
                  src, penc, length) -> int:
    """Emit one tree's schedule into src/penc/length[:n_tips+E]; returns
    the peak live-slot count.  Entries appear in a post order where every
    node's heaviest internal child is evaluated first (in-place into the
    parent's slot) and later children free their slots on consumption."""
    n_tips = len(tip_parent)
    I = int(root) + 1
    E = I - 1   # real internal edges (post-order: exactly root of them)

    tip_children = [[] for _ in range(I)]
    for i in range(n_tips):
        tip_children[int(tip_parent[i])].append(i)
    int_children = [[] for _ in range(I)]
    for e in range(E):
        int_children[int(edge_parent[e])].append(e)

    # Subtree slot need, computed in increasing slot order (post-order
    # numbering guarantees children have smaller ids than their parent).
    need = np.ones(I, np.int32)
    order = [None] * I
    for s in range(I):
        ics = int_children[s]
        if ics:
            # Stable sort by descending child need (ties keep edge order).
            ics = sorted(ics, key=lambda e: -need[edge_child[e]])
            ns = [need[edge_child[e]] for e in ics]
            need[s] = max(1, ns[0], *[1 + n for n in ns[1:]]) \
                if len(ns) > 1 else max(1, ns[0])
        order[s] = ics

    out = 0

    def emit(s, p, first, tip, ln):
        nonlocal out
        src[out] = s
        penc[out] = p * 4 + first * 2 + tip
        length[out] = ln
        out += 1

    free: list = []
    next_slot = 0
    live = 0
    peak = 0

    def alloc() -> int:
        nonlocal next_slot, live, peak
        if free:
            s = free.pop()
        else:
            s = next_slot
            next_slot += 1
        live += 1
        peak = max(peak, live)
        return s

    def release(s) -> None:
        nonlocal live
        free.append(s)
        live -= 1

    # Iterative emit: frame = [node, consumed_ics, slot, child_pending].
    stack = [[int(root), 0, -1, False]]
    last = -1
    while stack:
        f = stack[-1]
        v, k, slot, pending = f
        ics = order[v]
        if pending:
            f[3] = False
            e = ics[k]
            if k == 0:
                # Heaviest child's slot BECOMES this node's slot: the
                # first message is an in-place transform (src == parent,
                # first=1), then the node's tip messages multiply in.
                slot = f[2] = last
                emit(slot, slot, 1, 0, edge_length[e])
                for i in tip_children[v]:
                    emit(tip_perm[i], slot, 0, 1, tip_length[i])
            else:
                emit(last, f[2], 0, 0, edge_length[e])
                release(last)
            f[1] = k = k + 1
        if k == 0:
            if not ics:
                # All-tip node: fresh slot, first tip stores.
                s = f[2] = alloc()
                tips = tip_children[v]
                for j, i in enumerate(tips):
                    emit(tip_perm[i], s, 1 if j == 0 else 0, 1,
                         tip_length[i])
                last = f[2]
                stack.pop()
                continue
            f[3] = True
            stack.append([int(edge_child[ics[0]]), 0, -1, False])
            continue
        if k < len(ics):
            f[3] = True
            stack.append([int(edge_child[ics[k]]), 0, -1, False])
            continue
        last = f[2]
        stack.pop()

    assert out == n_tips + E, (out, n_tips, E)
    assert live == 1   # only the root partial remains
    return peak, last


def build_schedule_python(tb: TreeBatch) -> PruningSchedule:
    """Pure-Python schedule builder (native C++ fast path in io.native)."""
    T, n_tips = tb.tip_perm.shape
    e_max = tb.edge_child.shape[1]
    N = n_tips + e_max
    src = np.zeros((T, N), np.int32)
    penc = np.full((T, N), -1, np.int32)
    length = np.zeros((T, N), np.float64)
    root = np.zeros(T, np.int32)

    peak = 0
    for t in range(T):
        p, r = _schedule_one(
            tb.tip_perm[t], tb.tip_parent[t], tb.tip_length[t],
            tb.edge_child[t], tb.edge_parent[t], tb.edge_length[t],
            tb.root_slot[t], src[t], penc[t], length[t])
        peak = max(peak, p)
        root[t] = r

    n_slots = _round_slots(peak)
    _fill_padding(src, penc, length, n_slots)
    return PruningSchedule(src=src, penc=penc, length=length, root=root,
                           n_slots=n_slots)


def _fill_padding(src, penc, length, n_slots) -> None:
    """Padding entries (penc == -1): re-STORE a one-hot of xMSA row 0 into
    the sink slot with branch length 0 — P(0)=I so the message is the
    one-hot itself, its per-(rate, site) max is exactly 1, and a
    renormalization landing on the sink adds log(1) = 0 to the scale."""
    sink = n_slots - 1
    pad = penc < 0
    src[pad] = 0
    penc[pad] = sink * 4 + 2 + 1
    length[pad] = 0.0


def build_schedule(tb: TreeBatch) -> PruningSchedule:
    """Batch schedule builder: native C++ when available, else Python."""
    from linearham_tpu_torch.io.native import build_schedule_batch_native

    sched = build_schedule_batch_native(tb)
    if sched is not None:
        return sched
    return build_schedule_python(tb)
