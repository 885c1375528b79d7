"""Newick tree parsing into fixed-layout arrays for the pruning kernel.

Topologies change with every posterior sample, so trees are encoded as
*data*: per-tip parent edges plus a post-ordered internal edge list, padded
to a fixed width.  One compiled pruning kernel then serves every sample
(reference boundary: libpll's pll_utree_parse_newick_string + traversal,
src/PhyloHMM.cpp:419-426 — replaced here by array encoding).

Node numbering: tips 0..n_tips-1 in order of appearance, internal nodes
following in post-order (so the root is always the last internal node).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from linearham_tpu_torch.utils.constants import EPS

_COMMENT_RE = re.compile(r"\[[^\]]*\]")
_TOKEN_RE = re.compile(r"\s*([(),;:])|\s*([^(),;:\s]+)")


@dataclass
class TreeArrays:
    """One parsed tree, pruned-kernel ready."""

    tip_labels: List[str]
    tip_parent: np.ndarray       # [n_tips] internal-node slot of each tip edge
    tip_length: np.ndarray       # [n_tips]
    edge_child: np.ndarray       # [n_internal-1] internal slot (child side)
    edge_parent: np.ndarray      # [n_internal-1] internal slot (parent side)
    edge_length: np.ndarray      # [n_internal-1]
    n_internal: int              # root slot == n_internal - 1

    @property
    def n_tips(self) -> int:
        return len(self.tip_labels)


def collapse_unary(n):
    """Collapse single-child chains by summing branch lengths."""
    while len(n.children) == 1:
        child = n.children[0]
        if n.length is not None or child.length is not None:
            child.length = (n.length or 0.0) + (child.length or 0.0)
        child.parent = n.parent
        n = child
    n.children = [collapse_unary(c) for c in n.children]
    for c in n.children:
        c.parent = n
    return n


def parse_newick(text: str, default_branch_length: float = EPS) -> TreeArrays:
    """Parse one Newick string; missing branch lengths default to EPS.

    Comments ([&...]) are ignored here; use io.annotated_newick to keep
    them.  Unary chains are collapsed by summing branch lengths.
    """
    from linearham_tpu_torch.io.annotated_newick import parse_annotated_newick

    root = collapse_unary(
        parse_annotated_newick(_COMMENT_RE.sub("", text.strip())))
    arrays, _, _ = tree_arrays_from_node(
        root, default_branch_length=default_branch_length)
    return arrays


def tree_arrays_from_node(root, default_branch_length: float = EPS):
    """Convert a parsed node tree into TreeArrays.

    Returns (arrays, tip_nodes, internal_nodes): the node lists are indexed
    by tip slot / internal slot so device results map back onto the tree.
    """
    tip_labels: List[str] = []
    tip_nodes: List[object] = []
    internal_nodes: List[object] = []
    tip_parent: List[int] = []
    tip_length: List[float] = []
    edge_child: List[int] = []
    edge_parent: List[int] = []
    edge_length: List[float] = []
    internal_count = 0

    def visit(n) -> Tuple[bool, int]:
        """Post-order walk; returns (is_tip, node id within its class)."""
        nonlocal internal_count
        if not n.children:
            tip_labels.append(n.label or "")
            tip_nodes.append(n)
            tip_parent.append(-1)
            tip_length.append(
                n.length if n.length is not None else default_branch_length)
            return True, len(tip_labels) - 1
        child_ids = [visit(c) for c in n.children]
        my_id = internal_count
        internal_count += 1
        internal_nodes.append(n)
        for (is_tip, cid), c in zip(child_ids, n.children):
            length = (
                c.length if c.length is not None else default_branch_length)
            if is_tip:
                tip_parent[cid] = my_id
                tip_length[cid] = length
            else:
                edge_child.append(cid)
                edge_parent.append(my_id)
                edge_length.append(length)
        return False, my_id

    is_tip, _ = visit(root)
    if is_tip:
        raise ValueError("Newick tree must have at least one internal node")

    arrays = TreeArrays(
        tip_labels=tip_labels,
        tip_parent=np.asarray(tip_parent, np.int32),
        tip_length=np.asarray(tip_length, np.float64),
        edge_child=np.asarray(edge_child, np.int32),
        edge_parent=np.asarray(edge_parent, np.int32),
        edge_length=np.asarray(edge_length, np.float64),
        n_internal=internal_count,
    )
    return arrays, tip_nodes, internal_nodes


@dataclass
class TreeBatch:
    """A padded batch of trees sharing one tip label set.

    Padding edges point child and parent at an extra sink slot with branch
    length 0, which the pruning kernel treats as a no-op.  ``tip_perm`` maps
    tip slot -> row of the alignment (labels may appear in any order per
    tree).
    """

    tip_perm: np.ndarray      # [T, n_tips] alignment row per tip slot
    tip_parent: np.ndarray    # [T, n_tips]
    tip_length: np.ndarray    # [T, n_tips]
    edge_child: np.ndarray    # [T, E_max]
    edge_parent: np.ndarray   # [T, E_max]
    edge_length: np.ndarray   # [T, E_max]
    root_slot: np.ndarray     # [T]
    n_slots: int              # internal slots incl. the sink

    @property
    def n_trees(self) -> int:
        return self.tip_perm.shape[0]


def batch_trees(trees: Sequence[TreeArrays],
                labels: Sequence[str]) -> TreeBatch:
    """Pad and stack parsed trees against a fixed alignment label order."""
    label_row: Dict[str, int] = {lab: i for i, lab in enumerate(labels)}
    n_tips = len(labels)
    max_internal = max(t.n_internal for t in trees)
    n_slots = max_internal + 1           # plus the sink slot
    sink = n_slots - 1
    e_max = max(len(t.edge_child) for t in trees)

    T = len(trees)
    tip_perm = np.zeros((T, n_tips), np.int32)
    tip_parent = np.zeros((T, n_tips), np.int32)
    tip_length = np.zeros((T, n_tips), np.float64)
    edge_child = np.full((T, e_max), sink, np.int32)
    edge_parent = np.full((T, e_max), sink, np.int32)
    edge_length = np.zeros((T, e_max), np.float64)
    root_slot = np.zeros(T, np.int32)

    for i, t in enumerate(trees):
        if t.n_tips != n_tips:
            raise ValueError(
                f"tree {i} has {t.n_tips} tips, expected {n_tips}")
        for slot, lab in enumerate(t.tip_labels):
            if lab not in label_row:
                raise ValueError(f"tree {i} tip {lab!r} not in alignment")
            tip_perm[i, slot] = label_row[lab]
        tip_parent[i] = t.tip_parent
        tip_length[i] = t.tip_length
        ne = len(t.edge_child)
        edge_child[i, :ne] = t.edge_child
        edge_parent[i, :ne] = t.edge_parent
        edge_length[i, :ne] = t.edge_length
        root_slot[i] = t.n_internal - 1

    return TreeBatch(
        tip_perm=tip_perm,
        tip_parent=tip_parent,
        tip_length=tip_length,
        edge_child=edge_child,
        edge_parent=edge_parent,
        edge_length=edge_length,
        root_slot=root_slot,
        n_slots=n_slots,
    )
