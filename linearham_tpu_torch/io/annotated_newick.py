"""Annotated Newick trees: node objects with ``[&key="value"]`` comments.

The host-side post-processing tree representation: the ASR stage emits
Newick strings where every node carries an ``[&ancestral="SEQ"]`` comment,
and the tabulation stages walk lineages through them (reference boundary:
scripts/run_bootstrap_asr_ess.R:90-103 writes them via phylotate;
scripts/tabulate_*_probs.py read them via dendropy -- both replaced here).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_TOKEN_RE = re.compile(
    r"\s*(\[&[^\]]*\])|\s*([(),;:])|\s*([^(),;:\s\[\]]+)")
_ANNOT_RE = re.compile(r'(\w+)\s*=\s*(?:"([^"]*)"|([^,\]]+))')


@dataclass
class AnnotatedNode:
    label: Optional[str] = None
    length: Optional[float] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    children: List["AnnotatedNode"] = field(default_factory=list)
    parent: Optional["AnnotatedNode"] = None

    @property
    def is_tip(self) -> bool:
        return not self.children

    def find_tip(self, label: str) -> Optional["AnnotatedNode"]:
        for node in self.walk():
            if node.is_tip and node.label == label:
                return node
        return None

    def walk(self):
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children)

    def lineage_to_root(self) -> List["AnnotatedNode"]:
        out = [self]
        while out[-1].parent is not None:
            out.append(out[-1].parent)
        return out


def _parse_annotations(comment: str) -> Dict[str, str]:
    # comment looks like [&a="x",b=3]
    out = {}
    for m in _ANNOT_RE.finditer(comment[2:-1]):
        out[m.group(1)] = m.group(2) if m.group(2) is not None else m.group(3)
    return out


def parse_annotated_newick(text: str) -> AnnotatedNode:
    """Parse one Newick string, keeping [&...] node annotations."""
    tokens = []
    pos = 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"bad Newick near {text[pos:pos + 30]!r}")
        pos = m.end()
        tokens.append(m.group(1) or m.group(2) or m.group(3))
    i = 0

    def peek():
        return tokens[i] if i < len(tokens) else None

    def node() -> AnnotatedNode:
        nonlocal i
        n = AnnotatedNode()
        if peek() == "(":
            i += 1
            while True:
                child = node()
                child.parent = n
                n.children.append(child)
                if peek() == ",":
                    i += 1
                    continue
                if peek() == ")":
                    i += 1
                    break
                raise ValueError("expected ',' or ')' in Newick")
        tok = peek()
        if tok is not None and tok not in "(),;:" and not tok.startswith("[&"):
            n.label = tok
            i += 1
        while (tok := peek()) is not None and tok.startswith("[&"):
            n.annotations.update(_parse_annotations(tok))
            i += 1
        if peek() == ":":
            i += 1
            n.length = float(tokens[i])
            i += 1
            while (tok := peek()) is not None and tok.startswith("[&"):
                n.annotations.update(_parse_annotations(tok))
                i += 1
        return n

    try:
        root = node()
    except IndexError:
        raise ValueError("truncated Newick string") from None
    if peek() != ";":
        raise ValueError("Newick string must end with ';'")
    return root


def reroot_at_tip(root: AnnotatedNode, label: str) -> AnnotatedNode:
    """Reroot so that the named tip hangs directly off a fresh binary root.

    Replicates the reference's ``ape::unroot`` + ``ape::root(outgroup,
    resolve.root=TRUE)`` before ancestral-state simulation
    (scripts/run_bootstrap_asr_ess.R:51-53): the old root (if binary) is
    spliced out with its two edges merged, and the new root has exactly two
    children -- the tip (keeping its branch length) and the rest of the
    tree on a zero-length edge.  All tip-to-tip path lengths are preserved,
    so under a reversible model the likelihood and the joint ancestral law
    are unchanged.  Restructures in place and returns the new root.
    """
    tip = root.find_tip(label)
    if tip is None:
        raise ValueError(f"tree has no tip named {label!r}")
    if tip.parent is None:
        raise ValueError("cannot reroot a single-tip tree")

    def flipped(n: AnnotatedNode, exclude: AnnotatedNode,
                new_len: Optional[float]) -> AnnotatedNode:
        """Re-hang ``n`` as a child (edge length ``new_len``), folding its
        former parent in as one of its children."""
        kids = [c for c in n.children if c is not exclude]
        if n.parent is not None:
            kids.append(flipped(n.parent, n, n.length))
        if len(kids) == 1 and n.label is None and not n.annotations:
            # Splicing out a now-unary old root == ape::unroot's merge of
            # the root's two edges.
            k = kids[0]
            k.length = (k.length or 0.0) + (new_len or 0.0)
            return k
        n.children = kids
        for k in kids:
            k.parent = n
        n.length = new_len
        return n

    rest = flipped(tip.parent, tip, 0.0)
    new_root = AnnotatedNode()
    tip.parent = new_root
    rest.parent = new_root
    new_root.children = [tip, rest]
    return new_root


def write_annotated_newick(root: AnnotatedNode) -> str:
    """Serialize with node annotations placed before the branch length."""

    def fmt(n: AnnotatedNode) -> str:
        s = ""
        if n.children:
            s += "(" + ",".join(fmt(c) for c in n.children) + ")"
        if n.label:
            s += n.label
        if n.annotations:
            inner = ",".join(f'{k}="{v}"' for k, v in n.annotations.items())
            s += f"[&{inner}]"
        if n.length is not None:
            s += f":{n.length:g}"
        return s

    return fmt(root) + ";"
