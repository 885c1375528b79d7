"""Importance-weighted bootstrap + ESS + ancestral sequence reconstruction.

Counterpart of linearham_tpu/postprocess/bootstrap_asr.py (the reference's
scripts/run_bootstrap_asr_ess.R): drop burn-in, subsample posterior rows
without replacement with probabilities softmax(LogWeight), report
weight-adjusted effective sample sizes, and draw one joint ancestral
sequence sample per subsampled tree on the device (``ops/asr.py``).

The resampling and the ESS are numpy on the same ``default_rng(seed)``
stream as the JAX package, so ``.log`` and ``.ess`` come out byte-identical
to its; only the ancestral strings in ``.trees`` differ (torch Philox draws,
not threefry).  Outputs: ``<base>.trees`` (one ``[&ancestral="SEQ"]``
annotated Newick per line), ``<base>.log`` and ``<base>.ess``.

    python -m linearham_tpu_torch.postprocess.bootstrap_asr \\
        input.tsv fasta burnin subsamp num_cores seed out.trees out.log \\
        out.ess [--device cpu]
"""

from __future__ import annotations

import csv
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from linearham_tpu_torch.io.annotated_newick import (parse_annotated_newick,
                                                     reroot_at_tip,
                                                     write_annotated_newick)
from linearham_tpu_torch.io.newick import collapse_unary, tree_arrays_from_node
from linearham_tpu_torch.ops.asr import sample_ancestral_states
from linearham_tpu_torch.ops.gtr import GTREigen, gtr_eigen
from linearham_tpu_torch.utils.runtime import resolve_device
from linearham_tpu_torch.utils.seqs import read_fasta
from linearham_tpu_torch.utils.stats import effective_sample_size

_NON_NUMERIC = {"tree", "NaiveSequence", "VGene", "DGene", "JGene",
                "VFwkInsertion", "VDInsertion", "DJInsertion",
                "VJInsertion", "JFwkInsertion"}
_DROPPED = {"Iteration", "tree", "NaiveSequence"}
_ALPHABET = "ACGT"

# Bytes one [B, n_slots, R, 4, L] partials tensor may take: trees of a
# shape group run in batches of at most this size (a 100-sequence tree
# over 370 sites at R=4 in f64 holds ~4.7 MB of partials).
BATCH_BYTES = 512 * 2**20


def _read_rows(path: str) -> List[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def _log_sum_exp(v: np.ndarray) -> float:
    m = v.max()
    return m + np.log(np.exp(v - m).sum())


@dataclass
class BootstrapResult:
    rows: List[dict]              # subsampled posterior rows
    annotated_trees: List[str]
    ess: Dict[str, float]


def run_bootstrap_asr(
    pipeline_tsv: str,
    fasta_path: str,
    burnin_frac: float,
    subsamp_frac: float,
    seed: int,
    output_base: Optional[str] = None,
    dtype: torch.dtype = torch.float64,
    output_trees_path: Optional[str] = None,
    output_log_path: Optional[str] = None,
    output_ess_path: Optional[str] = None,
    device=None,
) -> BootstrapResult:
    """Full bootstrap/ESS/ASR stage; writes <base>.{trees,log,ess}.

    ``device``: None means CUDA (raises without one); "cpu" runs the ASR on
    the CPU.  ``dtype`` stays f64 by default on every device.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = _read_rows(pipeline_tsv)
    if not rows:
        raise ValueError(f"{pipeline_tsv} has no posterior rows")
    rows = rows[int(burnin_frac * len(rows)):]
    n = len(rows)

    # Importance weights -> bootstrap subsample without replacement.
    logw = np.array([float(r["LogWeight"]) for r in rows])
    probs = np.exp(logw - _log_sum_exp(logw))
    n_boot = max(1, int(subsamp_frac * n))
    boot_idx = rng.choice(n, size=n_boot, replace=False, p=probs)
    boot_rows = [rows[i] for i in boot_idx]

    # Weight-adjusted ESS over the numeric columns.  Rows with non-finite
    # entries are dropped before the fit, as the reference drops ROWS
    # (run_bootstrap_asr_ess.R:36-40).
    w2 = float((probs ** 2).sum())
    num_cols = [c for c in rows[0]
                if c not in _DROPPED and c not in _NON_NUMERIC]
    mat = np.array([[float(r[c]) for c in num_cols] for r in rows])
    finite = np.isfinite(mat).all(axis=1)
    if not finite.all():
        print(f"WARNING removed {int((~finite).sum())} / {len(rows)} rows "
              "with nan/inf entries when calculating ess values",
              file=sys.stderr)
    mat = mat[finite]
    ess = {}
    if len(mat):
        for j, col in enumerate(num_cols):
            ess[col] = round(
                effective_sample_size(mat[:, j]) / len(mat) / w2)

    annotated = _asr_annotate(boot_rows, fasta_path, seed, dtype, device)

    if output_base is not None:
        output_trees_path = output_trees_path or output_base + ".trees"
        output_log_path = output_log_path or output_base + ".log"
        output_ess_path = output_ess_path or output_base + ".ess"
    if output_trees_path is not None:
        with open(output_trees_path, "w") as fh:
            fh.write("\n".join(annotated) + "\n")
    if output_log_path is not None:
        log_cols = [c for c in rows[0] if c not in _DROPPED]
        with open(output_log_path, "w") as fh:
            fh.write("\t".join(log_cols) + "\n")
            for r in boot_rows:
                fh.write("\t".join(str(r[c]) for c in log_cols) + "\n")
    if output_ess_path is not None:
        with open(output_ess_path, "w") as fh:
            fh.write("Parameter\tESS\n")
            for k, v in ess.items():
                fh.write(f"{k}\t{v:g}\n")

    return BootstrapResult(rows=boot_rows, annotated_trees=annotated,
                           ess=ess)


def _encode(s: str) -> np.ndarray:
    lut = {c: i for i, c in enumerate(_ALPHABET)}
    return np.array([lut.get(c.upper(), 4) for c in s], np.int32)


def _asr_annotate(boot_rows: List[dict], fasta_path: str, seed: int,
                  dtype: torch.dtype, device: torch.device) -> List[str]:
    """Sample ancestral sequences for every bootstrap tree (trees of one
    shape run together, in batches of at most BATCH_BYTES of partials)
    and annotate the Newick strings."""
    seqs = read_fasta(fasta_path)
    encoded = {lab: _encode(seq) for lab, seq in seqs.items()}
    n_rates = len([c for c in boot_rows[0] if c.startswith("sr[")])
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    parsed = []
    for r in boot_rows:
        # Reroot at the naive outgroup, as the reference does
        # (run_bootstrap_asr_ess.R:51-53): the annotated trees are
        # naive-rooted for the downstream lineage walk.
        root = reroot_at_tip(
            collapse_unary(parse_annotated_newick(r["tree"])), "naive")
        arrays, tip_nodes, internal_nodes = tree_arrays_from_node(root)
        parsed.append((root, arrays, tip_nodes, internal_nodes))

    L = len(next(iter(seqs.values())))
    groups: Dict[tuple, List[int]] = {}
    for i, (_, arrays, _, _) in enumerate(parsed):
        groups.setdefault((arrays.n_internal, len(arrays.edge_child)),
                          []).append(i)

    itemsize = torch.empty((), dtype=dtype).element_size()
    out = [None] * len(boot_rows)
    for (n_internal, _), idxs in groups.items():
        n_tips = parsed[idxs[0]][1].n_tips
        per_tree = max(n_internal + 1, n_tips) * n_rates * 4 * L * itemsize
        batch = max(1, BATCH_BYTES // per_tree)
        for lo in range(0, len(idxs), batch):
            part = idxs[lo:lo + batch]
            internal = _sample_group(boot_rows, parsed, encoded, part,
                                     n_rates, fasta_path, generator, dtype,
                                     device)
            # State codes -> one ASCII string per (tree, slot) in one pass.
            letters = np.frombuffer(_ALPHABET.encode(), np.uint8)[internal]
            strings = np.ascontiguousarray(letters).view(f"S{L}")[..., 0]
            for t, i in enumerate(part):
                root, arrays, tip_nodes, internal_nodes = parsed[i]
                row_seqs = dict(seqs)
                row_seqs["naive"] = boot_rows[i]["NaiveSequence"]
                # Tips keep their observed sequences verbatim (ambiguous Ns
                # included), as in the reference's annotated output.
                for s_i, node in enumerate(tip_nodes):
                    node.annotations["ancestral"] = \
                        row_seqs[arrays.tip_labels[s_i]]
                for s_i, node in enumerate(internal_nodes):
                    node.annotations["ancestral"] = strings[t, s_i].decode()
                out[i] = write_annotated_newick(root)
    return out


def _sample_group(boot_rows, parsed, seqs, idxs, n_rates, fasta_path,
                  generator, dtype, device) -> np.ndarray:
    """One device call for trees ``idxs`` (all of one shape); ``seqs`` maps
    each FASTA id to its encoded sequence (the naive row comes from each
    posterior row).  Returns the sampled internal states
    [T, n_internal + 1, L] on the host."""
    T = len(idxs)
    first = parsed[idxs[0]][1]
    n_tips, n_internal = first.n_tips, first.n_internal
    n_edges = len(first.edge_child)
    L = len(next(iter(seqs.values())))
    tip_states = np.zeros((T, n_tips, L), np.int32)
    tip_parent = np.zeros((T, n_tips), np.int32)
    tip_length = np.zeros((T, n_tips))
    edge_child = np.zeros((T, n_edges), np.int32)
    edge_parent = np.zeros((T, n_edges), np.int32)
    edge_length = np.zeros((T, n_edges))
    er = np.zeros((T, 6))
    pi = np.zeros((T, 4))
    rates = np.zeros((T, n_rates))
    for t, i in enumerate(idxs):
        r = boot_rows[i]
        arrays = parsed[i][1]
        for s_i, lab in enumerate(arrays.tip_labels):
            if lab == "naive":
                tip_states[t, s_i] = _encode(r["NaiveSequence"])
            elif lab in seqs:
                tip_states[t, s_i] = seqs[lab]
            else:
                raise ValueError(f"tip {lab!r} missing from {fasta_path}")
        tip_parent[t] = arrays.tip_parent
        tip_length[t] = arrays.tip_length
        edge_child[t] = arrays.edge_child
        edge_parent[t] = arrays.edge_parent
        edge_length[t] = arrays.edge_length
        er[t] = [float(r[f"er[{k}]"]) for k in range(1, 7)]
        pi[t] = [float(r[f"pi[{k}]"]) for k in range(1, 5)]
        rates[t] = [float(r[f"sr[{k}]"]) for k in range(1, n_rates + 1)]

    def fl(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def it(a):
        return torch.as_tensor(a, device=device)

    sample = sample_ancestral_states(
        generator, GTREigen(*(fl(a) for a in gtr_eigen(er, pi))), fl(pi),
        fl(rates), it(tip_states), it(tip_parent), fl(tip_length),
        it(edge_child), it(edge_parent), fl(edge_length),
        it(np.full(T, n_internal - 1, np.int32)), n_internal + 1)
    return sample.internal_states.cpu().numpy()


def main(argv=None) -> int:
    """CLI mirroring the reference R script's positional contract
    (scripts/run_bootstrap_asr_ess.R:2-13):

        input.path fasta.path burnin.frac subsamp.frac num.cores seed
        output.trees.path output.log.path output.ess.path

    num.cores is accepted for compatibility and ignored: the ASR runs as
    batched device calls.  ``--device`` (default CUDA) picks the device.
    """
    import argparse

    p = argparse.ArgumentParser(
        description="Importance-weighted bootstrap + ESS + ancestral "
                    "sequence reconstruction over the pipeline TSV.")
    p.add_argument("input_path", help="lh_revbayes_run.trees TSV")
    p.add_argument("fasta_path", help="clonal family FASTA")
    p.add_argument("burnin_frac", type=float)
    p.add_argument("subsamp_frac", type=float)
    p.add_argument("num_cores", type=int)
    p.add_argument("seed", type=int)
    p.add_argument("output_trees_path")
    p.add_argument("output_log_path")
    p.add_argument("output_ess_path")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (a GPU is required), "
                        "'cpu' to run the ASR on the CPU")
    a = p.parse_args(argv)
    run_bootstrap_asr(
        a.input_path, a.fasta_path, a.burnin_frac, a.subsamp_frac, a.seed,
        output_trees_path=a.output_trees_path,
        output_log_path=a.output_log_path,
        output_ess_path=a.output_ess_path, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
