"""RevBayes posterior-sample TSV ingestion.

The RevBayes `.trees` file contract (reference: src/PhyloHMM.cpp:393-426):
a tab-separated header with at least the 15 columns Iteration, Likelihood,
Prior, alpha, er[1..6], pi[1..4], tree; one row per posterior sample; the
Newick strings may carry ``[&index=N]`` comments and occasionally lack
branch lengths.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import List

import numpy as np

_REQUIRED = (
    ["Iteration", "Likelihood", "Prior", "alpha"]
    + [f"er[{i}]" for i in range(1, 7)]
    + [f"pi[{i}]" for i in range(1, 5)]
    + ["tree"]
)


@dataclass
class TreeSamples:
    """A full posterior sample table for one clonal family."""

    iteration: np.ndarray      # [T] int
    rb_loglik: np.ndarray      # [T]
    prior: np.ndarray          # [T]
    alpha: np.ndarray          # [T]
    er: np.ndarray             # [T, 6]
    pi: np.ndarray             # [T, 4]
    newicks: List[str]         # [T]

    @property
    def n_samples(self) -> int:
        return len(self.newicks)

    def __getitem__(self, sl) -> "TreeSamples":
        return TreeSamples(
            iteration=self.iteration[sl], rb_loglik=self.rb_loglik[sl],
            prior=self.prior[sl], alpha=self.alpha[sl], er=self.er[sl],
            pi=self.pi[sl],
            newicks=self.newicks[sl] if isinstance(sl, slice)
            else [self.newicks[i] for i in np.atleast_1d(sl)],
        )


def load_tree_samples(path: str) -> TreeSamples:
    """Read a RevBayes output TSV; extra columns are ignored.

    Uses the native C++ parser when available (native/trees_tsv.cpp, the
    analogue of the reference's vendored fast-cpp-csv-parser,
    src/PhyloHMM.cpp:396); falls back to the Python csv module.
    """
    from linearham_tpu_torch.io.native import parse_trees_tsv_bytes

    with open(path, "rb") as fh:
        data = fh.read()
    parsed = None
    try:
        parsed = parse_trees_tsv_bytes(data)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc
    if parsed is not None:
        numeric, newicks = parsed
        return TreeSamples(
            iteration=numeric[:, 0].astype(int),
            rb_loglik=numeric[:, 1].copy(),
            prior=numeric[:, 2].copy(),
            alpha=numeric[:, 3].copy(),
            er=numeric[:, 4:10].copy(),
            pi=numeric[:, 10:14].copy(),
            newicks=newicks,
        )

    with open(path, newline="") as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        missing = [c for c in _REQUIRED if c not in (reader.fieldnames or [])]
        if missing:
            raise ValueError(
                f"{path} lacks required columns {missing}; header was "
                f"{reader.fieldnames}"
            )
        rows = list(reader)

    T = len(rows)
    if T == 0:
        raise ValueError(f"{path} contains no posterior samples")
    out = TreeSamples(
        iteration=np.array([int(float(r["Iteration"])) for r in rows]),
        rb_loglik=np.array([float(r["Likelihood"]) for r in rows]),
        prior=np.array([float(r["Prior"]) for r in rows]),
        alpha=np.array([float(r["alpha"]) for r in rows]),
        er=np.array([[float(r[f"er[{i}]"]) for i in range(1, 7)]
                     for r in rows]),
        pi=np.array([[float(r[f"pi[{i}]"]) for i in range(1, 5)]
                     for r in rows]),
        newicks=[r["tree"].strip().strip('"') for r in rows],
    )
    return out
