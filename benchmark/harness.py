"""The benchmark's run: set-up, the measured window, the check, the result.

``main`` follows one cell of ``BENCHMARK.json``:

1. find the cell, its configuration (``configs/<config>.json``), its
   traffic mix (``traffic/<traffic>.json``) and its limits
   (``limits/<cell>.json``);
2. refuse to run without the CUDA devices the cell asks for;
3. set-up: import torch and the port and start CUDA (``import_s``),
   write the pool of inputs (``gen_s``), warm up at the cell's own shapes
   (``drivers.Driver.warm_up``: a warm pool's every family built);
4. the window: jobs in a closed loop with one client until they have
   taken ``--seconds``; the job running then runs to its end, and the
   window ends with it.  Between jobs, off the window's clock, the
   harness reads each job's outputs, keeps a sample and deletes them.
   With ``--trace 1`` the profiler records the window;
5. read the device's memory peak (``device_memory_peak_mb``: the CUDA
   allocator's peak over set-up and window, in 10**6 bytes), free the
   program's state, and check the window's outputs against the plain
   reference;
6. print the cell's metrics as one JSON line, last on standard output,
   and each number compared beside its limit, last on standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "linearham_tpu")


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(name: str, root: str = ROOT, base: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files under
    ``base``: everything a cell needs is found by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    spec = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[spec["config"]]["file"]))
    traffic = load_json(os.path.join(base, "traffic",
                                     spec["traffic"] + ".json"))
    limits = load_json(os.path.join(base, "limits", name + ".json"))

    def applies(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m)
             and ("workloads" in m or m["moves"] in moves)]
    return Cell(name, spec, config, traffic, limits, e2e, layer)


def metric_module(name: str, base: str = HERE):
    """The reader ``<base>/metrics/<name>.py``, loaded by its path."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_window(run_job, seconds: float, after=None,
               clock=time.perf_counter):
    """Jobs in a closed loop: a job starts while its forerunners have
    taken fewer than ``seconds`` (the first always starts) and runs to its
    end; the window closes when the last job ends.  ``after(k, job)``, the
    harness's own reading of a job's outputs, runs between jobs off the
    window's clock.  Returns (jobs, the window's seconds: the jobs' time
    end to end, less ``after``)."""
    jobs, spent = [], 0.0
    while not jobs or spent < seconds:
        t0 = clock()
        job = run_job(len(jobs))
        spent += clock() - t0
        jobs.append(job)
        if after is not None:
            after(len(jobs) - 1, job)
    return jobs, spent


@dataclass
class RunRecord:
    """What per-layer metric readers read."""

    cell: str
    jobs: list
    trees: int
    window_s: float
    import_s: float
    trace: object = None
    ensembles: List[dict] = field(default_factory=list)
    card: str = ""
    notes: Dict[str, str] = field(default_factory=dict)
    precision: str = "f32"          # the configuration's


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_identity() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"unknown ({exc})"


def ensembles_run(jobs, pool, num_rates: int) -> List[dict]:
    """Every family ensemble the window's jobs ran: its trees, tips,
    emission columns (one per site and naive base that some state needs,
    the xMSA's columns, counted by the plain reference) and rate
    categories (what the roofline's work is counted from)."""
    import torch

    from benchmark.reference.model import FamilyModel

    families = {f.trees_path: (f, item.gene_dir)
                for item in pool for f in item.families}
    columns: Dict[str, int] = {}
    gene_maps: dict = {}
    out = []
    for job in jobs:
        for o in job.outputs:
            fam, gene_dir = families[o.trees_path]
            if fam.yaml_path not in columns:
                columns[fam.yaml_path] = FamilyModel.build(
                    fam.yaml_path, 0, gene_dir, "cpu", torch.float64,
                    gene_maps).n_cols
            out.append({"trees": fam.n_trees, "tips": fam.n_seqs + 1,
                        "cols": columns[fam.yaml_path],
                        "rates": num_rates})
    return out


def per_layer_metrics(cell: Cell, record: RunRecord) -> dict:
    """The cell's per-layer metrics that its run holds something for."""
    metrics = {}
    for m in cell.per_layer:
        value = metric_module(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def quantiles(values: List[float]) -> str:
    if len(values) < 2:
        return f"median {values[0]:.4f}" if values else "none"
    ordered = sorted(values)
    p90 = ordered[min(len(ordered) - 1, int(0.9 * len(ordered)))]
    return f"median {statistics.median(values):.4f} p90 {p90:.4f}"


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, t_start: Optional[float] = None, device: str = "cuda",
         cell: Optional[Cell] = None) -> int:
    """One run.  ``device="cpu"`` and a ``cell`` given directly are for the
    benchmark's own tests: they skip the look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = cell or find_cell(args.workload)
    config, traffic = cell.config, cell.traffic

    t0 = time.perf_counter()
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.spec["chips"]:
            log(f"benchmark: {cell.name} needs {cell.spec['chips']} CUDA "
                "device(s); none or too few are present")
            return 2
    if traffic["entry"] == "repertoire":
        import linearham_tpu_torch.cli  # noqa: F401
    else:
        import linearham_tpu_torch.pipeline.run  # noqa: F401
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    from benchmark import check, drivers
    from benchmark.trace import Tracer, breakdown, busy_s, summarize

    workdir = tempfile.mkdtemp(prefix="linearham-bench-")
    driver = None
    try:
        t0 = time.perf_counter()
        pool = drivers.make_pool(workdir, config, traffic, args.seed)
        gen_s = time.perf_counter() - t0
        driver = drivers.Driver(workdir, config, traffic, pool, args.seed,
                                None if device == "cuda" else device,
                                stages=bool(args.trace))
        t0 = time.perf_counter()
        driver.discard(driver.warm_up())
        warmup_s = time.perf_counter() - t0
        tracer = Tracer(workdir) if args.trace else None
        heavy = config["locus"] == "igh"
        collector = check.Collector(
            config["num_rates"], heavy,
            np.random.default_rng([args.seed % (1 << 64), 0x636b]),
            traffic["rows_per_output"])
        read_s = [0.0]

        def job(k):
            with (tracer.job() if tracer else contextlib.nullcontext()):
                return driver.run(k)

        def collect(k, done):
            t0 = time.perf_counter()
            collector.take(k, done.outputs)
            read_s[0] += time.perf_counter() - t0

        with (tracer.window() if tracer else contextlib.nullcontext()):
            setup_s = time.perf_counter() - t_start
            jobs, window_s = run_window(job, args.seconds, collect)
        peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
        trees = sum(j.trees for j in jobs)
        log(f"set-up {setup_s:.4f} s: imports and CUDA {import_s:.4f}, "
            f"input generation {gen_s:.4f}, warm-up job {warmup_s:.4f}, "
            f"the rest {setup_s - import_s - gen_s - warmup_s:.4f}")
        log(f"window {window_s:.4f} s: {len(jobs)} jobs, {trees} trees; "
            f"job wall {quantiles([j.wall_s for j in jobs])} s; outputs "
            f"read between jobs {read_s[0]:.4f} s, off the clock")
        log("job walls: " + " ".join(f"{j.wall_s:.4f}" for j in jobs))

        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        verdict = check.compare(collector, device,
                                traffic["reference_block"])
        log(f"check {time.perf_counter() - t0:.4f} s: {verdict.rows_read} "
            f"rows read, {verdict.rows_sampled} held against the reference; "
            f"widest gap {verdict.loglik_abs_gap:.6g} nats")
        for why in verdict.reasons:
            log(f"  bad row: {why}")
        owner = collector.owner
        numbers = {
            "loglik_rel_gap": (verdict.loglik_rel_gap,
                               cell.limits["loglik_rel_gap"]),
            "bad_rows": (verdict.bad_rows, cell.limits["bad_rows"]),
        }
        correct = bool(jobs) and all(v <= lim for v, lim in numbers.values())
        failed_jobs = {owner[o] for o in verdict.failed_outputs if o >= 0}
        if verdict.loglik_rel_gap > cell.limits["loglik_rel_gap"]:
            failed_jobs.add(owner[verdict.worst_output])

        device_info = {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0)
                       if device == "cuda" else device,
                       "count": cell.spec["chips"],
                       "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": len(jobs),
                  "failed": len(failed_jobs)}
        card = card_identity() if device == "cuda" else device
        log(f"card: {card}")
        if not args.trace:
            values = {"trees_per_s": trees / window_s, "setup_s": setup_s,
                      "device_memory_peak_mb": peak / 1e6}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        else:
            summary = summarize(tracer.path)
            device_info["busy_s"] = busy_s(summary)
            device_info["window_s"] = summary.window_s
            ensembles = ensembles_run(jobs, pool, config["num_rates"])
            record = RunRecord(cell.name, jobs, trees, window_s, import_s,
                               summary, ensembles, card,
                               precision=config["precision"])
            metrics = per_layer_metrics(cell, record)
            for k, v in record.notes.items():
                log(f"{k}: {v}")
            result["breakdown"] = breakdown(summary)
        result["metrics"] = metrics
        result["device"] = device_info
        result["check"] = {k: {"value": v, "limit": lim}
                           for k, (v, lim) in numbers.items()}
    finally:
        if driver is not None:
            driver.close()
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules()
    if found:
        log(f"benchmark: forbidden modules were loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    for k, (v, lim) in numbers.items():
        log(f"check {k} {v!r} limit {lim!r}")
    return 0

