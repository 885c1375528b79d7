"""Ancestral-lineage posterior tabulation for a seed sequence.

For every ASR-annotated tree, walk the lineage from the seed tip up to the
root (appending the naive tip, reference semantics:
scripts/tabulate_lineage_probs.py:46-62), tally amino-acid node and
adjacent-edge frequencies, and emit the lineage FASTA/.dnamap plus
probability-filtered Graphviz DOT lineage graphs.
"""

from __future__ import annotations

import math
from collections import Counter, OrderedDict
from itertools import groupby
from typing import Dict, List

from linearham_tpu_torch.io.annotated_newick import parse_annotated_newick
from linearham_tpu_torch.utils.seqs import read_fasta, translate, write_fasta


def find_muts(orig: str, mutated: str) -> List[str]:
    return [f"{o}{i + 1}{m}"
            for i, (o, m) in enumerate(zip(orig, mutated)) if o != m]


def _mut_edge_label(muts: List[str]) -> str:
    """Squarish multi-line layout for edge mutation labels."""
    if not muts:
        return ""
    per_line = max(1, int(math.sqrt(len(muts))))
    lines = [" ".join(muts[i:i + per_line])
             for i in range(0, len(muts), per_line)]
    return "\\n".join(lines)


def lineage_seqs(tree_line: str, seed: str) -> List[str]:
    """Ancestral DNA sequences from naive (first) down to the seed tip."""
    root = parse_annotated_newick(tree_line.strip())
    seed_node = root.find_tip(seed)
    if seed_node is None:
        raise ValueError(f"seed tip {seed!r} not found in tree")
    lineage = seed_node.lineage_to_root()
    naive = root.find_tip("naive")
    if naive is None:
        raise ValueError("tree lacks a 'naive' tip")
    lineage.append(naive)
    seqs = [n.annotations.get("ancestral") for n in lineage]
    if any(s is None for s in seqs):
        raise ValueError("lineage node lacks an 'ancestral' annotation")
    return seqs[::-1]


def tabulate_lineage_probs(
    trees_path: str,
    naive_seqs_path: str,
    seed_seq: str,
    pfilters: List[float],
    output_base: str,
) -> Dict[str, str]:
    """Write <base>.fasta / <base>.dnamap and per-pfilter DOT graphs."""
    node_counts: Counter = Counter()
    node_dna: Dict[str, Counter] = {}
    edge_counts: Counter = Counter()
    naive_set = set()
    seed_set = set()
    num_trees = 0

    with open(trees_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            num_trees += 1
            dna = lineage_seqs(line, seed_seq)
            for aa, grp in groupby(dna, key=translate):
                node_dna.setdefault(aa, Counter()).update(frozenset(grp))
            aas = [translate(s) for s in dna]
            node_counts.update(frozenset(aas))
            edge_counts.update(zip(aas[:-1], aas[1:]))
            naive_set.add(aas[0])
            seed_set.add(aas[-1])

    if len(seed_set) != 1:
        raise ValueError(f"seed AA sequence not unique: {len(seed_set)}")
    seed_aa = next(iter(seed_set))

    aa_naive_names = read_fasta(naive_seqs_path, invert=True)

    out_seqs: "OrderedDict[str, str]" = OrderedDict()
    dnamap: "OrderedDict[str, str]" = OrderedDict()
    i = 0
    for aa, count in node_counts.most_common():
        if aa == seed_aa:
            name = seed_seq
        elif aa in aa_naive_names:
            name = aa_naive_names[aa]
        else:
            name = f"intermediate_{i}_{count / num_trees}"
            i += 1
        out_seqs[name] = aa
        dnamap[name] = "\n".join(
            f"{cnt / num_trees},{dna}"
            for dna, cnt in node_dna[aa].most_common())

    write_fasta(out_seqs, output_base + ".fasta")
    write_fasta(dnamap, output_base + ".dnamap")

    names_of = {v: k for k, v in out_seqs.items()}
    for pfilter in pfilters:
        _write_dot(output_base + f".pfilter{pfilter}.dot", edge_counts,
                   node_counts, names_of, seed_seq, num_trees, pfilter)
    return out_seqs


def _node_display(name: str, frac: float) -> str:
    parts = name.split("_")
    if len(parts) != 3 or parts[0] not in ("naive", "intermediate"):
        return name
    kind = "int" if parts[0] == "intermediate" else parts[0]
    return f"{kind} {parts[1]}\\n{100 * frac:.0f}%"


def _write_dot(path, edge_counts, node_counts, names_of, seed_seq,
               num_trees, pfilter):
    """Posterior lineage graph as Graphviz DOT text (no graphviz dep)."""
    lines = ["digraph lineage {",
             '  graph [size="24,14", ratio=fill, fontsize=14];']
    for (a, b), count in edge_counts.most_common():
        if a == b or count / num_trees < pfilter:
            continue
        la = _node_display(names_of[a], node_counts[a] / num_trees)
        lb = _node_display(names_of[b], node_counts[b] / num_trees)
        conf = int(40 + 60 * count / node_counts[a])
        color = "#0000ff" + (f"{conf}" if conf < 100 else "")
        xlabel = (f"{_mut_edge_label(find_muts(a, b))}\\n"
                  f"{100 * count / node_counts[a]:.0f}%")
        lines.append(f'  "{la}" -> "{lb}" [xlabel="{xlabel}", '
                     f'color="{color}", fontsize=11];')
        for ab, lab in ((a, la), (b, lb)):
            if names_of[ab] == seed_seq:
                continue
            nconf = int(10 + 90 * node_counts[ab] / num_trees)
            fill = "#ff0000" + (f"{nconf}" if nconf < 100 else "")
            lines.append(f'  "{lab}" [style=filled, fillcolor="{fill}"];')
    lines.append("}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
