"""The calls that a traffic mix drives, and the inputs they read.

A traffic file's ``entry`` names one driver here:

* ``repertoire``: one job is ``linearham_tpu_torch.cli.main(["repertoire",
  ...])`` over a manifest of a partition's families, with the germline
  directory they share;
* ``pipeline``: one job is ``linearham_tpu_torch.pipeline.run.run_pipeline``
  over one family's posterior TSV, with the keys a ``serve`` request
  carries.

``family_cache`` is ``cold`` (every job gets a family cache directory of
its own, so every family is built) or ``warm`` (one directory, filled in
set-up).  ``vary`` says what a pool item is: ``partition`` (a germline
directory and every family of the configuration, new) or ``trees`` (new
posterior samples of the same families).  Jobs cycle through the pool;
job ``k`` passes the program the sampling seed ``job_seed(seed, k)``.

Both entries pass the program the configuration's ``precision``
(``--precision`` of ``cli repertoire``, ``precision=`` of
``run_pipeline``), one of ``PRECISIONS``; a configuration without it, or
with another value, is refused when the driver is made.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import gen
from benchmark.check import Output

_PROFILE_RE = re.compile(r"^#\s+(\w+): ([0-9.]+)ms$")
# The precisions a configuration may state.  The port's ``auto`` is not
# one: it picks f32 on a card and f64 on the CPU, whatever was stated.
PRECISIONS = ("f32", "f64")


def job_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k) % (1 << 62)


@dataclass
class FamilyFiles:
    yaml_path: str
    trees_path: str
    n_seqs: int
    n_trees: int
    germline: "gen.Germline"


@dataclass
class PoolItem:
    gene_dir: str
    families: List[FamilyFiles]


@dataclass
class Job:
    """What one job did: its trees, its wall time, its outputs and the
    program's stage sums (seconds, when the run asked for them)."""

    trees: int
    wall_s: float
    outputs: List[Output]
    stages: Dict[str, float] = field(default_factory=dict)
    families: int = 0


def make_pool(workdir: str, config: dict, traffic: dict, seed: int
              ) -> List[PoolItem]:
    """Write the traffic's pool of inputs under ``workdir``."""
    gl_cfg = config["germline"]
    fams = config["families"]
    root = np.random.SeedSequence([seed % (1 << 64), 0x6c68])
    streams = root.spawn(traffic["pool"] + 1)
    pool = []
    shared = None
    for p, ss in enumerate(streams[1:]):
        rng = np.random.default_rng(ss)
        if traffic["vary"] == "partition" or shared is None:
            grng = rng if traffic["vary"] == "partition" \
                else np.random.default_rng(streams[0])
            germline = gen.make_germline(grng, config["locus"], **gl_cfg)
            gene_dir = os.path.join(workdir, f"genes{p}")
            gen.write_gene_dir(germline.genes, gene_dir)
            family_objs = [gen.make_family(grng, germline, f["seqs"],
                                           f["mutation_rate"],
                                           f.get("ambig_rate", 0.0))
                           for f in fams]
            yamls = []
            for i, fam in enumerate(family_objs):
                path = os.path.join(workdir, f"p{p}_f{i}.yaml")
                gen.write_partis_yaml(fam, path)
                yamls.append(path)
            if traffic["vary"] == "trees":
                shared = (germline, gene_dir, family_objs, yamls)
        else:
            germline, gene_dir, family_objs, yamls = shared
        files = []
        for i, (f, fam) in enumerate(zip(fams, family_objs)):
            trees = os.path.join(workdir, f"p{p}_f{i}.trees")
            gen.write_trees_tsv(rng, fam, f["trees"], trees)
            files.append(FamilyFiles(yamls[i], trees, f["seqs"], f["trees"],
                                     germline))
        pool.append(PoolItem(gene_dir, files))
    return pool


class Driver:
    """Runs jobs of one traffic mix over a pool."""

    def __init__(self, workdir: str, config: dict, traffic: dict,
                 pool: List[PoolItem], seed: int, device: Optional[str],
                 stages: bool):
        self.workdir, self.config, self.traffic = workdir, config, traffic
        self.pool, self.seed, self.device = pool, seed, device
        self.stages = stages
        self.num_rates = config["num_rates"]
        self.precision = config.get("precision")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"configuration {config.get('name')!r} states precision "
                f"{self.precision!r}; it has to state one of {PRECISIONS}")
        self.cache_root = os.path.join(workdir, "family_cache")
        self._saved_env = os.environ.get("LINEARHAM_FAMILY_CACHE")
        if traffic["family_cache"] == "warm":
            os.environ["LINEARHAM_FAMILY_CACHE"] = self.cache_root

    def close(self) -> None:
        """Give LINEARHAM_FAMILY_CACHE back its value from before."""
        if self._saved_env is None:
            os.environ.pop("LINEARHAM_FAMILY_CACHE", None)
        else:
            os.environ["LINEARHAM_FAMILY_CACHE"] = self._saved_env

    def _cold_cache(self, tag: str) -> None:
        if self.traffic["family_cache"] == "cold":
            os.environ["LINEARHAM_FAMILY_CACHE"] = os.path.join(
                self.cache_root, tag)

    def run(self, k: int) -> Job:
        self._cold_cache(f"job{k}")
        outdir = os.path.join(self.workdir, "out", f"job{k}")
        os.makedirs(outdir, exist_ok=True)
        if self.traffic["entry"] == "repertoire":
            return self._repertoire(k, outdir)
        return self._pipeline(k, outdir)

    def warm_up(self) -> Job:
        """The jobs before the window, at the cell's shapes, as one Job.

        A repertoire warm-up is one job over only the ``warmup_families``
        largest families of the first partition (by sequences, then
        trees): every family costs a cold build, and the bucket's launch
        has no shape to compile.  A ``warm`` pipeline warm-up is one
        request for each family of the first pool item, in family order
        (the window's first requests), so every family is in the cache
        before the window opens.  A ``cold`` pipeline warm-up is one
        request: its window builds every family anyway."""
        self._cold_cache("warmup")
        outdir = os.path.join(self.workdir, "out", "warmup")
        os.makedirs(outdir, exist_ok=True)
        if self.traffic["entry"] == "repertoire":
            fams = self.pool[0].families
            order = sorted(range(len(fams)), key=lambda i: (
                -fams[i].n_seqs, -fams[i].n_trees))
            return self._repertoire(0, outdir, sorted(
                order[:self.traffic["warmup_families"]]))
        n = len(self.pool[0].families) \
            if self.traffic["family_cache"] == "warm" else 1
        jobs = [self._pipeline(k, outdir) for k in range(n)]
        return Job(sum(j.trees for j in jobs), sum(j.wall_s for j in jobs),
                   [o for j in jobs for o in j.outputs], {}, n)

    def discard(self, job: Job) -> None:
        """Delete a job's output files (the warm-up's are not judged)."""
        for o in job.outputs:
            if os.path.exists(o.out_path):
                os.remove(o.out_path)

    def plan(self, k: int, outdir: str,
             families: Optional[List[int]] = None
             ) -> Tuple[PoolItem, List[Tuple[FamilyFiles, Output]]]:
        """The pool item job ``k`` reads and the outputs it writes."""
        if self.traffic["entry"] == "repertoire":
            item = self.pool[k % len(self.pool)]
            chosen = [(i, f) for i, f in enumerate(item.families)
                      if families is None or i in families]
            name = "f{}.tsv"
        else:
            n_fam = len(self.pool[0].families)
            item = self.pool[(k // n_fam) % len(self.pool)]
            chosen = [(k % n_fam, item.families[k % n_fam])]
            name = "out.tsv"
        return item, [(f, Output(f.yaml_path, item.gene_dir, f.trees_path,
                                 os.path.join(outdir, name.format(i)),
                                 f.n_seqs)) for i, f in chosen]

    def _repertoire(self, k: int, outdir: str,
                    families: Optional[List[int]] = None) -> Job:
        from linearham_tpu_torch import cli

        item, planned = self.plan(k, outdir, families)
        outs = [o for _, o in planned]
        manifest = os.path.join(outdir, "manifest.tsv")
        with open(manifest, "w") as fh:
            for o in outs:
                fh.write(f"{o.yaml_path}\t0\t{o.trees_path}\t{o.out_path}\n")
        argv = ["repertoire", "--families", manifest, "--hmm-param-dir",
                item.gene_dir, "--seed", str(job_seed(self.seed, k)),
                "--precision", self.precision]
        if self.device is not None:
            argv += ["--device", self.device]
        if self.stages:
            argv.append("--profile")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"repertoire job {k} exited {rc}")
        stages = {}
        for line in err.getvalue().splitlines():
            m = _PROFILE_RE.match(line)
            if m:
                stages[m.group(1)] = float(m.group(2)) / 1e3
        return Job(sum(f.n_trees for f, _ in planned), wall, outs, stages,
                   len(planned))

    def _pipeline(self, k: int, outdir: str) -> Job:
        from linearham_tpu_torch.pipeline.run import run_pipeline

        item, [(f, out)] = self.plan(k, outdir)
        t0 = time.perf_counter()
        result = run_pipeline(f.yaml_path, 0, item.gene_dir, f.trees_path,
                              out.out_path, num_rates=self.num_rates,
                              seed=job_seed(self.seed, k),
                              precision=self.precision, device=self.device)
        wall = time.perf_counter() - t0
        return Job(f.n_trees, wall, [out], dict(result.timings or {}), 1)
