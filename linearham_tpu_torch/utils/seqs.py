"""Small sequence utilities: translation and FASTA I/O (no Biopython dep)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

_CODON_TABLE = {}


def _build_codon_table() -> Dict[str, str]:
    # Standard genetic code, laid out by the classic TCAG convention.
    bases = "TCAG"
    aas = (
        "FFLLSSSSYY**CC*W"
        "LLLLPPPPHHQQRRRR"
        "IIIMTTTTNNKKSSRR"
        "VVVVAAAADDEEGGGG"
    )
    table = {}
    i = 0
    for b1 in bases:
        for b2 in bases:
            for b3 in bases:
                table[b1 + b2 + b3] = aas[i]
                i += 1
    return table


_CODON_TABLE = _build_codon_table()


def translate(seq: str) -> str:
    """In-frame DNA -> amino acids; trailing partial codon dropped; codons
    containing ambiguity translate to X."""
    seq = seq.upper()
    out = []
    for i in range(0, len(seq) - len(seq) % 3, 3):
        out.append(_CODON_TABLE.get(seq[i:i + 3], "X"))
    return "".join(out)


def write_fasta(records: Dict[str, str], path: str) -> None:
    with open(path, "w") as fh:
        for name, seq in records.items():
            fh.write(f">{name}\n{seq}\n")


def read_fasta(path: str, invert: bool = False) -> "OrderedDict[str, str]":
    """FASTA as an ordered (id: seq) dict, or (seq: id) with ``invert``.

    Multi-line records are concatenated (reference util_functions.py:10-16
    semantics, minus the Biopython dependency).
    """
    out: "OrderedDict[str, str]" = OrderedDict()
    name = None
    chunks = []

    def flush():
        if name is not None:
            seq = "".join(chunks)
            if invert:
                out[seq] = name
            else:
                out[name] = seq

    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                flush()
                name = line[1:].split()[0] if line[1:].split() else ""
                chunks = []
            elif line:
                chunks.append(line)
    flush()
    return out
