"""An output row's annotation columns, and the path of sites they name.

The columns name the genes, their deletions and the inserted bases.
Together with the family's ``relpos`` they say what every site of the
naive sequence holds, so they name one path of the reference's states
(``reference/model.py``).  ``path_of_row`` lays that path out (or says why
there is none); ``columns_of_path`` writes a path's columns, which have to
give the row back; and the model gives the path's probability, which has
to be above 0.

Conventions (those of linearham's output): a deletion counts the gene's
bases left out at its 5' or 3' end; the naive sequence has N wherever no
gene base or inserted base stands; the framework insertions are its
leading and trailing runs of N, where every base between them is not N.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# The annotation columns of a heavy- and of a light-chain row, in the order
# of the output TSV.
HEAVY = ("NaiveSequence", "VGene", "V5pDel", "V3pDel", "VFwkInsertion",
         "VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion", "JGene",
         "J5pDel", "J3pDel", "JFwkInsertion")
LIGHT = tuple("VJInsertion" if c == "VDInsertion" else c for c in HEAVY
              if c not in ("DGene", "D5pDel", "D3pDel", "DJInsertion"))


def columns(heavy: bool) -> Tuple[str, ...]:
    return HEAVY if heavy else LIGHT


def _keys_of_row(model, row: Dict[str, str]) -> List[tuple]:
    """The state of every site from the model's first to its last, as
    the row's columns name them."""
    alphabet = model.alphabet
    segs = [("V", row["VGene"], "")]
    if model.heavy:
        segs.append(("D", row["DGene"], row["VDInsertion"]))
        segs.append(("J", row["JGene"], row["DJInsertion"]))
    else:
        segs.append(("J", row["JGene"], row["VJInsertion"]))
    keys: List[tuple] = []
    site = model.first
    for gtype, gene, inserted in segs:
        if gene not in model.relpos or model.genes[gene].gtype != gtype:
            raise KeyError(f"{gtype} gene {gene!r} is not one of the family")
        rp, length = model.relpos[gene], model.genes[gene].length
        start = rp + int(row[f"{gtype}5pDel"])
        end = rp + length - int(row[f"{gtype}3pDel"])
        if gtype == "V":
            keys += [("VP", gene, -1)] * (start - site)
            site = start
        for ch in inserted:
            keys.append((f"{gtype}N", gene, alphabet.index(ch)))
            site += 1
        if start != site or end < start:
            raise KeyError(f"{gene} spans [{start}, {end}) where site "
                           f"{site} comes next")
        keys += [(f"{gtype}G", gene, -1)] * (end - start)
        site = end
    keys += [("JP", segs[-1][1], -1)] * (model.last - site)
    if len(keys) != model.last - model.first:
        raise KeyError(f"the row covers {site - model.first} sites, the "
                       f"family {model.last - model.first}")
    return keys


def path_of_row(model, row: Dict[str, str]
                ) -> Tuple[Optional[np.ndarray], str]:
    """(each site's state index, "") for one row, or (None, the reason)."""
    try:
        keys = _keys_of_row(model, row)
        path = np.asarray([model.index[model.first + i][k]
                           for i, k in enumerate(keys)], np.int64)
    except (KeyError, ValueError) as exc:
        return None, f"no path of the family's states: {exc}"
    return path, ""


def columns_of_path(model, path) -> Dict[str, str]:
    """The annotation columns of one path of state indices."""
    naive = ["N"] * model.n_sites
    letters = model.alphabet + "N"
    spans: Dict[str, List[int]] = {}
    genes: Dict[str, str] = {}
    inserted = {"D": [], "J": []}
    for i, idx in enumerate(path):
        s = model.first + i
        key = model.states[s][int(idx)]
        naive[s] = letters[model.base(key, s)]
        kind, gene, x = key
        if kind.endswith("G"):
            spans.setdefault(kind[0], []).append(s)
            genes[kind[0]] = gene
        elif kind.endswith("N"):
            inserted[kind[0]].append(letters[x])
    seq = "".join(naive)
    inner = seq.strip("N")
    clean = bool(inner) and "N" not in inner
    lead = len(seq) - len(seq.lstrip("N"))
    trail = len(seq) - len(seq.rstrip("N"))
    out = {"NaiveSequence": seq,
           "VFwkInsertion": "N" * lead if clean else "",
           "JFwkInsertion": "N" * trail if clean else ""}
    for gtype in ("V", "D", "J") if model.heavy else ("V", "J"):
        gene = genes[gtype]
        rp, length = model.relpos[gene], model.genes[gene].length
        out[f"{gtype}Gene"] = gene
        out[f"{gtype}5pDel"] = str(spans[gtype][0] - rp)
        out[f"{gtype}3pDel"] = str(rp + length - spans[gtype][-1] - 1)
    if model.heavy:
        out["VDInsertion"] = "".join(inserted["D"])
        out["DJInsertion"] = "".join(inserted["J"])
    else:
        out["VJInsertion"] = "".join(inserted["J"])
    return out


def mismatch(model, path, row: Dict[str, str]) -> str:
    """"" where the path gives back every annotation column of the row,
    else the first column that differs."""
    got = columns_of_path(model, path)
    for col in columns(model.heavy):
        if got[col] != row[col]:
            return f"{col}: {row[col]!r}, the path gives {got[col]!r}"
    return ""
