"""Collapse sampled annotations into posterior-weighted partis-style output.

Reads the pipeline TSV (one sampled V(D)J annotation per posterior tree)
plus the annotated trees, collapses duplicate annotations, assigns
``logprob = log(count / N)``, attaches the contributing trees under
``tree-info.linearham.trees``, and writes ``<base>_best.yaml`` /
``<base>_all.yaml`` (reference contract: scripts/write_lh_annotations.py).

The reference rebuilds full partis annotation lines via partis' own
libraries (utils.add_implicit_info); partis stays an external dependency
by design, so the key implicit fields are re-derived here from the
germline info carried in the partis YAML: regional bounds and lengths,
conserved-codon positions, cdr3_length, in-frame/stop/mutated-invariant
flags, and per-sequence mutation counts/frequencies.  Fields whose inputs
are absent from a minimal YAML (e.g. no ``germline-info.seqs``) are
skipped rather than guessed.
"""

from __future__ import annotations

import csv
import math
from typing import List, Optional

import yaml

from linearham_tpu_torch.io.annotated_newick import parse_annotated_newick
from linearham_tpu_torch.io.yaml_load import load_yaml

ANNOTATION_KEYS = [
    "NaiveSequence", "VGene", "V5pDel", "V3pDel", "VFwkInsertion",
    "VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion",
    "VJInsertion", "JGene", "J5pDel", "J3pDel", "JFwkInsertion",
]


def _naive_from_tree(tree_line: str) -> str:
    tip = parse_annotated_newick(tree_line).find_tip("naive")
    if tip is None or "ancestral" not in tip.annotations:
        raise ValueError("tree lacks an annotated naive tip")
    return tip.annotations["ancestral"]


def _partis_style(row: dict, heavy: bool) -> dict:
    """Map pipeline TSV columns onto partis annotation vocabulary."""
    ann = {
        "naive_seq": row["NaiveSequence"],
        "v_gene": row["VGene"],
        "j_gene": row["JGene"],
        "v_5p_del": int(row["V5pDel"]),
        "v_3p_del": int(row["V3pDel"]),
        "j_5p_del": int(row["J5pDel"]),
        "j_3p_del": int(row["J3pDel"]),
        "fv_insertion": row.get("VFwkInsertion", ""),
        "jf_insertion": row.get("JFwkInsertion", ""),
    }
    if heavy:
        ann.update({
            "d_gene": row["DGene"],
            "d_5p_del": int(row["D5pDel"]),
            "d_3p_del": int(row["D3pDel"]),
            "vd_insertion": row.get("VDInsertion", ""),
            "dj_insertion": row.get("DJInsertion", ""),
        })
    else:
        ann["vj_insertion"] = row.get("VJInsertion", "")
    return ann


_STOP_CODONS = {"TAA", "TAG", "TGA"}


def derive_implicit_fields(ann: dict, germline_info: Optional[dict],
                           seqs: Optional[List[str]] = None) -> dict:
    """Re-derive the key partis implicit fields for one annotation line.

    The reference calls partis' ``utils.add_implicit_info`` (reference:
    scripts/write_lh_annotations.py:70-74); this computes the fields that
    downstream tooling actually consumes -- ``regional_bounds``,
    ``lengths``, ``codon_positions``, ``cdr3_length``, ``cdr3_seqs``,
    ``in_frames``, ``stops``, ``mutated_invariants``, ``n_mutations``,
    ``mut_freqs`` -- directly from the naive sequence layout plus the
    germline gene sequences and conserved-codon positions in
    ``germline-info`` (keys ``seqs``, ``cyst-positions``,
    ``tryp-positions``/``phen-positions``), skipping any field whose
    inputs are missing.  Returns the fields added.
    """
    gi = germline_info or {}
    gl_seqs = gi.get("seqs") or {}
    naive = ann["naive_seq"]
    heavy = "d_gene" in ann
    out: dict = {}

    v_gl = gl_seqs.get("v", {}).get(ann["v_gene"])
    j_gl = gl_seqs.get("j", {}).get(ann["j_gene"])
    d_gl = gl_seqs.get("d", {}).get(ann.get("d_gene")) if heavy else ""

    fv = len(ann.get("fv_insertion", ""))
    jf = len(ann.get("jf_insertion", ""))
    if v_gl is not None and j_gl is not None and (not heavy or
                                                  d_gl is not None):
        v_match = len(v_gl) - ann["v_5p_del"] - ann["v_3p_del"]
        j_match = len(j_gl) - ann["j_5p_del"] - ann["j_3p_del"]
        d_match = (len(d_gl) - ann["d_5p_del"] - ann["d_3p_del"]) \
            if heavy else 0
        vd = len(ann.get("vd_insertion", "") if heavy
                 else ann.get("vj_insertion", ""))
        dj = len(ann.get("dj_insertion", "")) if heavy else 0
        bounds = {"v": (fv, fv + v_match)}
        pos = fv + v_match + vd
        if heavy:
            bounds["d"] = (pos, pos + d_match)
            pos += d_match + dj
        bounds["j"] = (pos, pos + j_match)
        expected_len = pos + j_match + jf
        if expected_len == len(naive):
            out["regional_bounds"] = {k: list(v) for k, v in bounds.items()}
            out["lengths"] = {k: v[1] - v[0] for k, v in bounds.items()}

            # Conserved codons: cysteine in V, tryptophan (igh) /
            # phenylalanine (igk/igl) in J.
            cyst = (gi.get("cyst-positions") or {}).get(ann["v_gene"])
            tryp = (gi.get("tryp-positions") or
                    gi.get("phen-positions") or {}).get(ann["j_gene"])
            if cyst is not None and tryp is not None:
                cp_v = fv + int(cyst) - ann["v_5p_del"]
                cp_j = bounds["j"][0] + int(tryp) - ann["j_5p_del"]
                if 0 <= cp_v and cp_j + 3 <= len(naive) and cp_v < cp_j:
                    out["codon_positions"] = {"v": cp_v, "j": cp_j}
                    out["cdr3_length"] = cp_j - cp_v + 3

    n_seqs = len(seqs or [])
    if "cdr3_length" in out:
        cp_v, cp_j = out["codon_positions"]["v"], out["codon_positions"]["j"]
        out["cdr3_seqs"] = [s[cp_v:cp_j + 3] for s in (seqs or [])]
        in_frame = out["cdr3_length"] % 3 == 0
        out["in_frames"] = [in_frame] * n_seqs

        def has_stop(seq: str) -> bool:
            for p in range(cp_v, len(seq) - 2, 3):
                if seq[p:p + 3].upper() in _STOP_CODONS:
                    return True
            return False

        out["stops"] = [has_stop(s) for s in (seqs or [])]
        gl_cyst = v_gl[int(cyst):int(cyst) + 3].upper()
        gl_tryp = j_gl[int(tryp):int(tryp) + 3].upper()
        out["mutated_invariants"] = [
            s[cp_v:cp_v + 3].upper() != gl_cyst
            or s[cp_j:cp_j + 3].upper() != gl_tryp
            for s in (seqs or [])
        ]

    if seqs:
        n_mut = []
        for s in seqs:
            n_mut.append(sum(
                1 for a, b in zip(s.upper(), naive.upper())
                if a != b and a != "N" and b != "N"))
        out["n_mutations"] = n_mut
        out["mut_freqs"] = [round(m / max(1, len(naive)), 6) for m in n_mut]

    ann.update(out)
    return out


def write_lh_annotations(
    partis_yaml_path: str,
    log_path: str,
    trees_path: str,
    output_base: str,
    collapse_by: Optional[List[str]] = None,
) -> List[dict]:
    """Collapse + rank annotations; returns the sorted unique list."""
    with open(log_path, newline="") as fh:
        rows = list(csv.DictReader(fh, delimiter="\t"))
    with open(trees_path) as fh:
        trees = [l.strip() for l in fh if l.strip()]
    if len(rows) != len(trees):
        raise ValueError(
            f"annotation rows ({len(rows)}) and trees ({len(trees)}) differ")

    heavy = "DGene" in rows[0]
    # The .log drops NaiveSequence (reference behavior); recover each
    # sample's naive sequence from its annotated tree.
    for row, tree in zip(rows, trees):
        row.setdefault("NaiveSequence", _naive_from_tree(tree))
    keys = collapse_by or [k for k in ANNOTATION_KEYS if k in rows[0]]

    uniq: List[dict] = []
    for row, tree in zip(rows, trees):
        for entry in uniq:
            if all(entry["row"][k] == row[k] for k in keys):
                entry["count"] += 1
                entry["trees"].append(tree)
                break
        else:
            uniq.append({"row": row, "count": 1, "trees": [tree]})

    n = len(rows)
    with open(partis_yaml_path) as fh:
        partis_root = load_yaml(fh)
    base_event = partis_root["events"][0]

    member_seqs = []
    shm = base_event.get("has_shm_indels") or []
    for i in range(len(base_event.get("unique_ids", []))):
        key = "indel_reversed_seqs" if (i < len(shm) and shm[i]) \
            else "input_seqs"
        if key in base_event:
            member_seqs.append(base_event[key][i])

    out = []
    for entry in sorted(uniq, key=lambda e: -e["count"]):
        ann = dict(base_event)
        ann.update(_partis_style(entry["row"], heavy))
        derive_implicit_fields(ann, partis_root.get("germline-info"),
                               seqs=member_seqs)
        ann["logprob"] = math.log(entry["count"] / n)
        ann["tree-info"] = {"linearham": {"trees": entry["trees"]}}
        out.append(ann)

    def write(path: str, events: List[dict]) -> None:
        doc = {
            "germline-info": partis_root.get("germline-info", {}),
            "events": events,
        }
        with open(path, "w") as fh:
            yaml.safe_dump(doc, fh, sort_keys=False, width=10 ** 6)

    write(output_base + "_best.yaml", [out[0]])
    write(output_base + "_all.yaml", out)
    return out


def main(argv=None) -> int:
    """CLI mirroring the reference script
    (scripts/write_lh_annotations.py:22-35).

    Like the reference (:39), the annotated trees file defaults to the log
    path with ``.log`` replaced by ``.trees``.
    """
    import argparse

    p = argparse.ArgumentParser(
        description="Combine the partis output YAML and linearham_run.log "
                    "into partis-style linearham annotations.")
    p.add_argument("partis_yaml_file",
                   help="Path to partis output YAML file.")
    p.add_argument("linearham_log_file",
                   help="Path to linearham_run.log TSV file.")
    p.add_argument("--output-base", required=True,
                   help="The base output path for linearham annotations.")
    p.add_argument("--collapse-annotations-by",
                   type=lambda x: x.split(","), default=None,
                   help="comma-separated list of annotation keys defining "
                        "a unique annotation")
    p.add_argument("--trees-file", default=None,
                   help="annotated trees file (default: the log path with "
                        ".log -> .trees)")
    a = p.parse_args(argv)
    trees = a.trees_file or a.linearham_log_file.replace(".log", ".trees")
    write_lh_annotations(a.partis_yaml_file, a.linearham_log_file, trees,
                         a.output_base, collapse_by=a.collapse_annotations_by)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
