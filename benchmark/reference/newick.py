"""A plain recursive Newick parser for the reference.

Comments (``[&index=3]``) are dropped, a missing branch length is 1e-6 (the
reference linearham's default), and a node with one child is merged into
that child, its branch length added.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

_COMMENT_RE = re.compile(r"\[[^\]]*\]")
DEFAULT_LENGTH = 1e-6


@dataclass
class Node:
    label: Optional[str] = None
    length: Optional[float] = None
    children: List["Node"] = field(default_factory=list)


def strip_comments(text: str) -> str:
    return _COMMENT_RE.sub("", text)


def parse(text: str) -> Node:
    s = strip_comments(text).strip()
    if not s.endswith(";"):
        raise ValueError("a Newick string ends with ';'")
    pos = 0

    def name_and_length(node: Node) -> None:
        nonlocal pos
        start = pos
        while pos < len(s) and s[pos] not in ",():;":
            pos += 1
        label = s[start:pos].strip()
        node.label = label or None
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in ",();":
                pos += 1
            node.length = float(s[start:pos])

    def subtree() -> Node:
        nonlocal pos
        node = Node()
        if s[pos] == "(":
            pos += 1
            node.children.append(subtree())
            while s[pos] == ",":
                pos += 1
                node.children.append(subtree())
            if s[pos] != ")":
                raise ValueError(f"expected ')' at {pos}")
            pos += 1
        name_and_length(node)
        return node

    root = subtree()
    if s[pos] != ";":
        raise ValueError(f"trailing text at {pos}")
    return _merge_unary(root)


def _merge_unary(node: Node) -> Node:
    while len(node.children) == 1:
        child = node.children[0]
        if node.length is not None or child.length is not None:
            child.length = (node.length or 0.0) + (child.length or 0.0)
        node = child
    node.children = [_merge_unary(c) for c in node.children]
    return node


def postorder(root: Node) -> List[Node]:
    """Internal nodes, children before parents (the root last)."""
    out: List[Node] = []
    stack = [(root, False)]
    while stack:
        node, seen = stack.pop()
        if not node.children:
            continue
        if seen:
            out.append(node)
        else:
            stack.append((node, True))
            stack.extend((c, False) for c in reversed(node.children))
    return out


def branch_length(node: Node) -> float:
    return DEFAULT_LENGTH if node.length is None else node.length
