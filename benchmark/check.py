"""Whether the window's output TSVs are correct.

As each job ends, ``Collector.take`` reads every row of its outputs, off
the window's clock: the row count, the columns copied from the posterior
TSV (equal as numbers, the tree equal once its comments are gone) and
finite log-likelihoods.  It keeps a sample of rows from every output,
drawn from the seed, with their input rows, and deletes the file, so a
run keeps little on disk.  Once the window has closed, ``compare`` holds
the sample against the plain reference (``benchmark/reference``): the
log-likelihood and the log weight by their relative gap, the gamma rates
to 1e-9, and the annotation by the one path it names, which has to give
the row's columns back and have a probability above 0 under the row's
tree.

Two numbers come out and are compared with the cell's limits:
``loglik_rel_gap`` (the widest relative gap of a log-likelihood or log
weight) and ``bad_rows`` (rows that fail any other check; limit 0).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference import annotation
from benchmark.reference.newick import strip_comments

RATE_RTOL = 1e-9


@dataclass
class Output:
    """One family's output TSV of one job, with the inputs it came from."""

    yaml_path: str
    gene_dir: str
    trees_path: str
    out_path: str
    n_seqs: int


@dataclass
class Kept:
    """A sampled row: the output it came from, its input row and its
    output row by column."""

    output: int
    src: List[str]
    row: Dict[str, str]


@dataclass
class Verdict:
    rows_read: int = 0
    rows_sampled: int = 0
    bad_rows: int = 0
    loglik_rel_gap: float = 0.0
    loglik_abs_gap: float = 0.0
    reasons: List[str] = field(default_factory=list)
    failed_outputs: set = field(default_factory=set)
    worst_output: int = -1       # where the widest gap was read

    def bad(self, output: int, why: str) -> None:
        self.bad_rows += 1
        self.failed_outputs.add(output)
        if len(self.reasons) < 5:
            self.reasons.append(why)


def read_tsv(path: str) -> Tuple[List[str], List[List[str]]]:
    with open(path) as fh:
        lines = fh.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


def expected_header(num_rates: int, heavy: bool) -> List[str]:
    return (["Iteration", "RBLogLikelihood", "Prior", "alpha"]
            + [f"er[{i}]" for i in range(1, 7)]
            + [f"pi[{i}]" for i in range(1, 5)] + ["tree"]
            + [f"sr[{i}]" for i in range(1, num_rates + 1)]
            + ["LHLogLikelihood", "LogWeight"]
            + list(annotation.columns(heavy)))


class Collector:
    """Reads each job's outputs as the job ends and keeps a sample."""

    def __init__(self, num_rates: int, heavy: bool, rng,
                 rows_per_output: int):
        self.num_rates, self.heavy, self.rng = num_rates, heavy, rng
        self.rows_per_output = rows_per_output
        self.verdict = Verdict()
        self.outputs: List[Output] = []
        self.owner: List[int] = []            # the job of each output
        self.kept: List[Kept] = []
        self._inputs: Dict[str, tuple] = {}

    def _read_inputs(self, path: str):
        """A posterior TSV's rows and its trees without comments, read
        once however many jobs ran it."""
        if path not in self._inputs:
            rows = read_tsv(path)[1]
            self._inputs[path] = (rows, [strip_comments(r[14])
                                         for r in rows])
        return self._inputs[path]

    def take(self, job: int, outputs: List[Output]) -> None:
        for out in outputs:
            o = len(self.outputs)
            self.outputs.append(out)
            self.owner.append(job)
            try:
                self._take_one(o, out)
            finally:
                if os.path.exists(out.out_path):
                    os.remove(out.out_path)

    def _take_one(self, o: int, out: Output) -> None:
        v = self.verdict
        try:
            header, rows = read_tsv(out.out_path)
        except (OSError, IndexError) as exc:
            v.bad(o, f"{out.out_path}: {exc}")
            return
        inputs, trees = self._read_inputs(out.trees_path)
        if header != expected_header(self.num_rates, self.heavy):
            v.bad(o, f"{out.out_path}: header {header[:3]}... is not the "
                     "pipeline's")
            return
        for _ in range(abs(len(inputs) - len(rows))):
            v.bad(o, f"{out.out_path}: {len(rows)} rows for {len(inputs)} "
                     "trees")
        lh, lw = header.index("LHLogLikelihood"), header.index("LogWeight")
        sound = []
        for r, (row, src, tree) in enumerate(zip(rows, inputs, trees)):
            v.rows_read += 1
            if len(row) != len(header):
                v.bad(o, f"{out.out_path}: a row of {len(row)} fields")
                continue
            same = (row[:14] == src[:14] or (
                int(row[0]) == int(src[0]) and all(
                    float(a) == float(b)
                    for a, b in zip(row[1:14], src[1:14]))
            )) and row[14] == tree
            if not same:
                v.bad(o, f"{out.out_path}: row {row[0]} does not carry its "
                         "input columns")
            elif not (math.isfinite(float(row[lh]))
                      and math.isfinite(float(row[lw]))):
                v.bad(o, f"{out.out_path}: row {row[0]} has a non-finite "
                         "log-likelihood")
            else:
                sound.append(r)
        n = min(self.rows_per_output, len(sound))
        for i in sorted(self.rng.choice(len(sound), size=n,
                                        replace=False).tolist()):
            r = sound[i]
            self.kept.append(Kept(o, inputs[r], dict(zip(header, rows[r]))))


def reference_inputs(model, srcs: List[List[str]], num_rates: int):
    """A reference ``Block`` of the given posterior rows and their gamma
    rates (float64, [n, R])."""
    import torch

    from benchmark.reference.model import Block, gamma_rates

    nums = np.asarray([[float(x) for x in p[1:14]] for p in srcs])

    def put(a):
        return torch.as_tensor(a, dtype=model.dtype, device=model.device)

    rates = gamma_rates(nums[:, 2], num_rates)
    return Block(trees=[p[14] for p in srcs], er=put(nums[:, 3:9]),
                 pi=put(nums[:, 9:13]), rates=put(rates)), rates


def compare(collector: Collector, device, block: int) -> "Verdict":
    """Hold the collector's sample against the float64 reference, in
    blocks of ``block`` rows of one family."""
    import torch

    from benchmark.reference.model import FamilyModel

    v = collector.verdict
    v.rows_sampled = len(collector.kept)
    by_family: Dict[Tuple[str, str], List[Kept]] = {}
    for k in collector.kept:
        out = collector.outputs[k.output]
        by_family.setdefault((out.yaml_path, out.gene_dir), []).append(k)
    gene_maps: dict = {}
    for (yaml_path, gene_dir), kept in by_family.items():
        model = FamilyModel.build(yaml_path, 0, gene_dir, device,
                                  torch.float64, gene_maps)
        for lo in range(0, len(kept), block):
            part = kept[lo:lo + block]
            b, rates = reference_inputs(model, [k.src for k in part],
                                        collector.num_rates)
            emis = model.emissions(model.site_log_likelihoods(b))
            ll = model.log_likelihood(emis).cpu().numpy()
            _judge_block(model, part, ll, emis, rates, collector, v)
            del emis
        del model
    return v


def _judge_block(model, part: List[Kept], ll, emis, rates, collector, v):
    paths, ok = [], []
    for i, k in enumerate(part):
        d, o = k.row, k.output
        where = f"{collector.outputs[o].out_path}: row {d['Iteration']}"
        rb = float(d["RBLogLikelihood"])
        lh, lw = float(d["LHLogLikelihood"]), float(d["LogWeight"])
        gap = max(abs(lh - ll[i]), abs(lw - (ll[i] - rb)))
        if not math.isfinite(gap):
            v.bad(o, f"{where}: log-likelihood {lh} against {ll[i]}")
            gap = math.inf
        v.loglik_abs_gap = max(v.loglik_abs_gap, gap)
        rel = gap / abs(ll[i])
        if rel > v.loglik_rel_gap:
            v.loglik_rel_gap = float(rel)
            v.worst_output = o
        sr = np.asarray([float(d[f"sr[{r}]"]) for r in
                         range(1, collector.num_rates + 1)])
        if not np.allclose(sr, rates[i], rtol=RATE_RTOL, atol=0):
            v.bad(o, f"{where}: gamma rates {sr} against {rates[i]}")
        path, why = annotation.path_of_row(model, d)
        if path is None:
            v.bad(o, f"{where}: {why}")
            continue
        why = annotation.mismatch(model, path, d)
        if why:
            v.bad(o, f"{where}: {why}")
            continue
        paths.append(path)
        ok.append(i)
    if not paths:
        return
    joint = model.path_log_joint(emis[ok], np.stack(paths)).cpu().numpy()
    for i, lp in zip(ok, joint):
        k = part[i]
        if not (lp > -math.inf and lp <= ll[i] + 1e-6 * abs(ll[i])):
            v.bad(k.output, f"{collector.outputs[k.output].out_path}: row "
                            f"{k.row['Iteration']}: its path has log P(path,"
                            f" data) {lp} against log P(data) {ll[i]}")
