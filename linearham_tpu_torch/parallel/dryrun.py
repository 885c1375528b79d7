"""Multi-process dry run of the (fam, trees) mesh.

Counterpart of ``__graft_entry__.py:dryrun_multichip``.  Where the JAX
package shards one controller's arrays over a virtual device mesh, the
port runs one process per rank: ``launch_ranks`` starts ``n`` Python
processes, each joins a ``torch.distributed`` group at an explicit free
localhost port and calls a target function, and the parent collects every
rank's return value (or raises, with the failing rank's error, after
stopping the others).  ``dryrun_multigpu`` is the dry run itself; run it
from a checkout as

    python -m linearham_tpu_torch.parallel.dryrun --ranks 2 [--backend gloo]
        [--device cpu]

Each rank of ``dryrun_multigpu``:

* builds a (2, n/2) mesh, or (1, n) when n is odd;
* runs one sharded step over F = 2 (or 1) stacked copies of a synthetic
  8-sequence family, at least 8 trees, as many per tree shard, and checks
  the log-likelihoods finite;
* reduces ``pooled_repertoire_summary`` at a non-trivial ESS (log-weights
  spread per tree, 1.5 < ESS < T - 0.5) against a numpy oracle;
* runs a ragged repertoire (5/7/T_top-tree heavy families and a lone igk
  family in a second bucket) in f64, sharded and unsharded: the
  log-likelihoods must agree within 1e-6 nats, and where only families are
  split (n_trees = 1) the sampled naive sequences must be identical.  It
  runs in f64 on every device: a mesh that splits trees changes each
  family's post-pruning batch, and in f32 the sums then move by a few ulps
  of |ll|, more than 1e-6 nats.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
MODULE = "linearham_tpu_torch.parallel.dryrun"
RAGGED_TOL = 1e-6          # nats, sharded vs unsharded repertoire, f64
GRACE_S = 5.0              # seconds the other ranks get to exit on a failure


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, target: str, payload: Any = None,
                 backend: str = "gloo", devices: Optional[Sequence] = None,
                 timeout: float = 600.0, pythonpath: Sequence[str] = (),
                 threads: Optional[int] = None) -> List[Any]:
    """Run ``target(devices, payload)`` in ``n`` processes of one group.

    ``target`` is "module:function", importable with the repository root
    and ``pythonpath`` on the path; ``devices[r]`` is rank r's device
    (default: the CPU).  The ranks' return values come back pickled, in
    rank order.  A rank that fails, or a run past ``timeout`` seconds,
    stops every rank and raises RuntimeError with the error output.
    ``threads`` caps each rank's torch CPU threads.

    Not ``torch.multiprocessing.spawn``: its children unpickle the target
    by re-importing the caller's ``__main__`` (a script such as
    ``chip_smoke.py``, with its own start-up), it returns no values, and
    it keeps no per-rank log to report the rank that failed first.
    """
    devices = [str(d) for d in (devices or ["cpu"] * n)]
    if len(devices) != n:
        raise ValueError(f"{n} ranks need {n} devices, got {len(devices)}")
    with tempfile.TemporaryDirectory(prefix="lh_ranks_") as tmp:
        spec = Path(tmp) / "spec.pkl"
        spec.write_bytes(pickle.dumps({
            "target": target, "payload": payload, "backend": backend,
            "devices": devices, "world": n, "port": free_port(),
            "out": tmp, "threads": threads}))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO_ROOT), *map(str, pythonpath),
             os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
        procs, logs = [], []
        try:
            for r in range(n):
                log = open(Path(tmp) / f"rank{r}.log", "w+")
                logs.append(log)
                rank_env = {**env, "LOCAL_RANK": str(_cuda_index(devices[r]))}
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE, "--rank", str(r),
                     "--spec", str(spec)], cwd=str(REPO_ROOT), env=rank_env,
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks still running after {timeout:.0f}s:\n"
                        + _tails(logs, range(n)))
                time.sleep(0.05)
            # A rank's failure makes its peers fail soon after (a closed
            # connection); give them a moment so the report holds the
            # rank that failed first.
            grace = time.monotonic() + GRACE_S
            while any(p.poll() is None for p in procs) \
                    and time.monotonic() < grace:
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                raise RuntimeError(
                    ", ".join(f"rank {r} exited {procs[r].returncode}"
                              for r in failed) + ":\n" + _tails(logs, failed))
            return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                    for r in range(n)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()


def _cuda_index(device: str) -> int:
    import torch

    d = torch.device(device)
    return (d.index or 0) if d.type == "cuda" else 0


def _tails(logs, ranks, n_bytes: int = 4000) -> str:
    out = []
    for r in ranks:
        logs[r].flush()
        logs[r].seek(0)
        out.append(f"--- rank {r} ---\n{logs[r].read()[-n_bytes:]}")
    return "\n".join(out)


def _rank_main(rank: int, spec_path: str) -> None:
    """One rank: join the group, run the target, pickle its result."""
    import torch
    import torch.distributed as dist

    from linearham_tpu_torch.parallel import multihost

    spec = pickle.loads(Path(spec_path).read_bytes())
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    multihost.initialize(init_method=f"tcp://localhost:{spec['port']}",
                         world_size=spec["world"], rank=rank,
                         backend=spec["backend"])
    module, name = spec["target"].split(":")
    try:
        result = getattr(importlib.import_module(module), name)(
            spec["devices"], spec["payload"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (Path(spec["out"]) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


# -- the dry run ----------------------------------------------------------------

def dryrun_multigpu(n: int, backend: Optional[str] = None,
                    devices: Optional[Sequence] = None,
                    timeout: float = 600.0) -> dict:
    """Run the dry run over ``n`` ranks and print one
    ``dryrun_multigpu ok: mesh=(...)`` line.

    ``devices`` defaults to ``cuda:0 .. cuda:n-1`` and raises without
    CUDA (name ``["cpu"] * n`` for the CPU); ``backend`` to NCCL on GPUs,
    else gloo.  Ranks that share a GPU need gloo.  Returns every rank's
    report (mesh, shape, summary, launches, wall).
    """
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * n (--device cpu) to run "
                               "the dry run on the CPU")
        devices = [f"cuda:{r}" for r in range(n)]
    devices = list(devices)
    cuda = all(torch.device(d).type == "cuda" for d in devices)
    backend = backend or ("nccl" if cuda else "gloo")
    reports = launch_ranks(n, f"{MODULE}:_dryrun_rank", None, backend,
                           devices, timeout, threads=None if cuda else 1)
    first = reports[0]
    if any(r["summary"] != first["summary"] for r in reports):
        raise RuntimeError(f"ranks disagree on the pooled summary: "
                           f"{[r['summary'] for r in reports]}")
    summary = {k: round(v, 3) for k, v in first["summary"].items()}
    print(f"dryrun_multigpu ok: mesh={first['mesh']} backend={backend} "
          f"devices={devices} loglik shape {first['shape']} "
          f"pooled_summary={summary} ragged_bucket_parity=ok "
          f"(max|d| {max(r['ragged_max_abs'] for r in reports):.3e}) "
          f"launches per rank {[r['launches'] for r in reports]} "
          f"wall per rank (s) {[round(r['wall'], 3) for r in reports]}",
          flush=True)
    return {"backend": backend, "devices": devices, "reports": reports}


def _synthetic_task(device, dtype, n_trees, seed, light=False, **family):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.parallel.repertoire import FamilyTask
    from linearham_tpu_torch.utils.synth import (make_family,
                                                 make_light_family,
                                                 make_tree_samples)

    fam = (make_light_family if light else make_family)(seed=seed, **family)
    hmm = PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes, fam.msa, fam.unique_ids, fam.n_sites,
                              device=device, dtype=dtype)
    return FamilyTask(hmm=hmm, samples=make_tree_samples(fam, n_trees,
                                                         seed=seed))


def _dryrun_rank(devices, payload) -> dict:
    import torch
    import torch.distributed as dist

    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.parallel.mesh import (FamilyBlock, make_mesh,
                                                   pooled_repertoire_summary,
                                                   sharded_pipeline, span)
    from linearham_tpu_torch.parallel.repertoire import run_repertoire
    from linearham_tpu_torch.utils.profiling import StageTimer
    from linearham_tpu_torch.utils.runtime import resolve_dtype

    world = dist.get_world_size()
    n_fam = 2 if world % 2 == 0 else 1
    n_tr = world // n_fam
    mesh = make_mesh(n_fam, n_tr, devices=devices)
    device = mesh.device
    dtype = resolve_dtype(None, device)
    t0 = time.perf_counter()
    launches = pruning_cuda.launches

    # One sharded step over F stacked copies of one family (equal shapes),
    # at least 8 trees and an equal number per tree shard, so that the
    # spread below gives 1.5 < ESS < T - 0.5.
    F, T = n_fam, n_tr * -(-8 // n_tr)
    task = _synthetic_task(device, dtype, T, seed=0, n_seqs=8)
    blocks = [FamilyBlock(i, task, slice(0, T)) for i in range(F)]
    done = sharded_pipeline(mesh, blocks, 4, 0, dtype, StageTimer())
    loglik = np.stack([d[0] for d in done])
    if loglik.shape != (F, T) or not np.isfinite(loglik).all():
        raise RuntimeError(f"sharded step: log-likelihoods {loglik}")

    # The pooled summary at a non-trivial ESS: lw = -spread per tree.
    spread = 0.25 * np.arange(T)[None, :] * (1.0 + 0.5 * np.arange(F)[:, None])
    rb = loglik + spread
    f, t = mesh.coords
    fams, trees = span(F, f, n_fam), span(T, t, n_tr)
    summary = pooled_repertoire_summary(
        mesh, [loglik[i, trees] for i in range(F)[fams]],
        [rb[i, trees] for i in range(F)[fams]])
    e = np.exp(-spread)
    ess = float((e.sum(1) ** 2 / (e * e).sum(1)).mean())
    if summary["n_trees"] != F * T \
            or abs(summary["mean_family_ess"] - ess) > 1e-9 * ess \
            or not 1.5 < summary["mean_family_ess"] < T - 0.5:
        raise RuntimeError(f"pooled summary {summary}, ESS oracle {ess}")

    # The ragged repertoire in f64, sharded against unsharded.
    t_top = n_tr * -(-8 // n_tr)
    f64 = torch.float64
    shapes = dict(n_seqs=4, n_v=2, n_d=2, n_j=2, v_len=30, d_len=16, j_len=12)
    tasks = [_synthetic_task(device, f64, k, seed=s, **shapes)
             for s, k in enumerate([5, 7] + [t_top] * (2 * n_fam - 2))]
    tasks.append(_synthetic_task(device, f64, 6, seed=31, light=True,
                                 n_seqs=4, v_len=24, j_len=12))
    sharded = run_repertoire(tasks, num_rates=4, seed=0, mesh=mesh,
                             dtype=f64)
    alone = run_repertoire(tasks, num_rates=4, seed=0, device=device,
                           dtype=f64)
    worst = 0.0
    for i, (a, b) in enumerate(zip(sharded, alone)):
        worst = max(worst, float(np.abs(a.loglik - b.loglik).max()))
        if len(a.annotations) != tasks[i].samples.n_samples:
            raise RuntimeError(f"family {i}: {len(a.annotations)} "
                               "annotations")
        if n_tr == 1 and [x.naive_seq for x in a.annotations] != \
                [x.naive_seq for x in b.annotations]:
            raise RuntimeError(f"family {i}: sampled naive sequences differ "
                               "under a families-only mesh")
    if worst > RAGGED_TOL:
        raise RuntimeError(f"ragged repertoire: sharded vs unsharded "
                           f"max|d loglik| {worst:.3e} > {RAGGED_TOL}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"mesh": (n_fam, n_tr), "shape": loglik.shape, "summary": summary,
            "ragged_max_abs": worst,
            "launches": pruning_cuda.launches - launches,
            "wall": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--spec", help=argparse.SUPPRESS)
    p.add_argument("--ranks", type=int, default=2,
                   help="processes in the dry run")
    p.add_argument("--backend", help="nccl or gloo (default: nccl with "
                                     "CUDA, else gloo)")
    p.add_argument("--device", action="append",
                   help="a rank's device, once per rank, or once for every "
                        "rank (default: one GPU each; without one, name "
                        "--device cpu)")
    args = p.parse_args(argv)
    if args.spec is not None:
        _rank_main(args.rank, args.spec)
    else:
        devices = args.device
        if devices is not None and len(devices) == 1:
            devices = devices * args.ranks
        dryrun_multigpu(args.ranks, args.backend, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
