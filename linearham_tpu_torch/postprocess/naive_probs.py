"""Naive-sequence posterior tabulation.

From ASR-annotated trees, collect each tree's naive amino-acid sequence,
then emit (a) a FASTA of unique AA naive sequences named
``naive_<rank>_<posterior>``, (b) a ``.dnamap`` mapping each AA sequence to
its contributing DNA sequences with probabilities, and (c) a per-site
posterior-probability logo plot (matplotlib; the reference used WebLogo).
Reference contract: scripts/tabulate_naive_probs.py.
"""

from __future__ import annotations

from collections import Counter, OrderedDict
from itertools import groupby
from typing import Dict, List

from linearham_tpu_torch.io.annotated_newick import parse_annotated_newick
from linearham_tpu_torch.utils.seqs import translate, write_fasta


def read_naive_seqs(trees_path: str) -> List[str]:
    """The per-tree naive DNA sequences from an annotated trees file."""
    out = []
    with open(trees_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            root = parse_annotated_newick(line)
            tip = root.find_tip("naive")
            if tip is None or "ancestral" not in tip.annotations:
                raise ValueError(
                    "tree lacks an annotated 'naive' tip: " + line[:60])
            out.append(tip.annotations["ancestral"])
    return out


# Classic WebLogo amino-acid chemistry palette.
_AA_COLORS = {}
_AA_COLORS.update({a: "#109648" for a in "GSTYCQN"})   # polar
_AA_COLORS.update({a: "#255C99" for a in "KRH"})       # basic
_AA_COLORS.update({a: "#D62839" for a in "DE"})        # acidic
_AA_COLORS.update({a: "#221E22" for a in "AVLIPWFM"})  # hydrophobic


def plot_logo(aa_seqs: List[str], path: str) -> None:
    """Per-site AA posterior as a WebLogo-style probability logo.

    Letters are glyph outlines scaled so their HEIGHT equals the residue's
    posterior probability, stacked per site with the most probable residue
    on top -- the same information content as the reference's ``weblogo``
    output (scripts/tabulate_naive_probs.py:38-53).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.font_manager import FontProperties
    from matplotlib.patches import PathPatch
    from matplotlib.textpath import TextPath
    from matplotlib.transforms import Affine2D

    fp = FontProperties(family="DejaVu Sans", weight="bold")
    n_sites = max(len(s) for s in aa_seqs)
    n = len(aa_seqs)
    fig, ax = plt.subplots(figsize=(max(8, n_sites * 0.25), 3))
    for site in range(n_sites):
        counts = Counter(s[site] for s in aa_seqs if len(s) > site)
        y = 0.0
        # Stack least -> most probable so the top letter is the mode.
        for aa, c in counts.most_common()[::-1]:
            frac = c / n
            if frac >= 0.004:
                tp = TextPath((0, 0), aa, size=1.0, prop=fp)
                bb = tp.get_extents()
                tr = (Affine2D()
                      .translate(-bb.x0, -bb.y0)
                      .scale(0.9 / bb.width, frac / bb.height)
                      .translate(site + 0.55, y))
                ax.add_patch(PathPatch(
                    tr.transform_path(tp), linewidth=0,
                    facecolor=_AA_COLORS.get(aa, "#777777")))
            y += frac
    ax.set_xlim(0.2, n_sites + 0.8)
    ax.set_ylim(0, 1.02)
    ax.set_xlabel("Site Position")
    ax.set_ylabel("Probability")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def tabulate_naive_probs(trees_path: str, output_base: str,
                         make_png: bool = True) -> Dict[str, str]:
    """Write <base>.fasta / <base>.dnamap (and <base>.png)."""
    naive_seqs = read_naive_seqs(trees_path)
    aa_seqs = [translate(s) for s in naive_seqs]
    n = len(aa_seqs)

    counts = Counter(aa_seqs)
    named = OrderedDict(
        (f"naive_{i}_{count / n}", seq)
        for i, (seq, count) in enumerate(counts.most_common())
    )
    write_fasta(named, output_base + ".fasta")

    # (AA seq -> Counter of DNA seqs) over contiguous runs, reference-style.
    aa_dna: Dict[str, Counter] = {}
    for aa, grp in groupby(naive_seqs, key=translate):
        aa_dna.setdefault(aa, Counter()).update(grp)
    dnamap = OrderedDict(
        (name, "\n".join(f"{cnt / n},{dna}"
                         for dna, cnt in aa_dna[seq].most_common()))
        for name, seq in named.items()
    )
    write_fasta(dnamap, output_base + ".dnamap")

    if make_png:
        try:
            plot_logo(aa_seqs, output_base + ".png")
        except Exception as exc:  # plotting must never sink the pipeline
            print(f"warning: logo plot failed: {exc}")
    return named
