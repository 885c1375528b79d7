"""The pruning kernel on the card: its work, its bound, and timings in turns.

    python -m linearham_tpu_torch.tools.pruning_ab [--source NAME=SRC ...]
        [--shape NAME ...] [--out PATH]

Builds each ``--source`` (another version of the kernel with the same C
interface, e.g. an earlier commit's ``pruning.cu``) and ``csrc/pruning.cu``.
At each shape of the main path (``SHAPES``: the 100-sequence bench unit in
f32 and f64, the 312-sequence depth, the stacked igh bucket of the
mixed-depth repertoire ``REPERTOIRE``) it holds every build against the
plain walk (f32 within 5e-4, f64 within 1e-9) and times them in turns (the
builds in order, then in reverse, each the median of ``REPS`` CUDA-event
timings).  It prints, per shape, the FLOP count of the real entries and
sites, the bound, and each build's time, FLOP/s and share of the bound;
with ``--out``, the same as JSON.  It needs a CUDA device.

``chip_smoke.py`` builds its kernel inputs with ``family_args``,
``ensemble_args`` and ``stacked_args``, runs ``REPERTOIRE`` and reports
``kernel_work`` and ``bound_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at a 700 W power limit.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 5e-4, torch.float64: 1e-9}
REPS = 10
FLOP_INTERNAL = 32      # per (site, rate): a 4x4 by 4 product
FLOP_NONFIRST = 4       # per (site, rate): the multiply into the parent
FLOP_RENORM = 7         # per (site, rate): max of 4, 4 divides (~7 ops)
FLOP_ROOT = 8           # per (site, rate): the stationary mix
FLOP_P = 128 + 4        # per (entry, rate): 16 entries of 4 FMAs, 4 exps
# tools/bench_312.py's family (reference CI depth: xMSA [313, 863]).
FAMILY_312 = dict(n_seqs=312, n_v=4, n_d=5, n_j=3, v_len=296, d_len=26,
                  j_len=52, mutation_rate=0.04, ambig_rate=0.005, seed=19)
# The mixed-depth repertoire (write_repertoire_inputs, seed 0): (locus,
# sequences, trees, mutation rate) per family.  Its 24 igh families are one
# stacked bucket of 24,565 trees; the 2 igk families a second bucket.
REPERTOIRE = [("igh", (10, 25, 50, 100)[i % 4], 768 + 512 * i // 23,
               0.02 + 0.0025 * i) for i in range(24)] \
    + [("igk", 20, 1000, 0.03), ("igk", 60, 900, 0.05)]


def kernel_work(args, real_cols: Optional[Sequence[int]] = None):
    """(FLOP, bytes) of one launch on ``args`` (site_log_likelihoods'
    arguments).  FLOP counts the real entries only (sink padding is not
    work) over each tree's real sites (``real_cols``, one per tree; default
    all X); bytes count each input read once and the output written once.
    """
    eig, pi, rates, codes, src, penc, length, root, n_slots = args
    T, N = src.shape
    X = codes.shape[1]
    R = rates.shape[1]
    e = eig.u.element_size()
    enc = penc.cpu().numpy()
    real = enc != (n_slots - 1) * 4 + 3
    internal = real & ((enc & 1) == 0)
    nonfirst = real & (((enc >> 1) & 1) == 0)
    renorm = real & ((np.arange(N) % 4) == 3)[None, :]
    per_site = (FLOP_INTERNAL * internal.sum(1) + FLOP_NONFIRST
                * nonfirst.sum(1) + FLOP_RENORM * renorm.sum(1) + FLOP_ROOT)
    cols = np.full(T, X) if real_cols is None else np.asarray(real_cols)
    flops = float(R * (per_site * cols).sum() + R * FLOP_P * real.sum())
    nbytes = (codes.numel() * 4 + 2 * T * N * 4 + T * N * e + T * 4
              + T * (16 + 16 + 4 + 4 + R) * e + T * X * e)
    return flops, float(nbytes)


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype):
    """(least milliseconds the card could take, "operations" or "bytes")."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def cuda_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def in_turns(fns: Dict[str, Callable[[], object]],
             reps: int = REPS) -> Dict[str, List[float]]:
    """Each function timed twice, in order and then in reverse (a, b, b,
    a): the medians by name."""
    names = list(fns)
    out: Dict[str, List[float]] = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(cuda_ms(fns[n], reps))
    return out


def make_batch(n_trees: int, dtype, tree_seed=None, device="cuda",
               **family):
    """(PhyloHMM on ``device`` in ``dtype``, ``n_trees`` sampled trees) of
    one synthetic igh family, ``make_family(**family)``; the trees are
    seeded ``tree_seed``, by default the family's seed."""
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(**family)
    hmm = PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes, fam.msa, fam.unique_ids,
                              fam.n_sites, device=device, dtype=dtype)
    samples = make_tree_samples(
        fam, n_trees, seed=family.get("seed", 0) if tree_seed is None
        else tree_seed)
    return hmm, samples


def ensemble_args(hmm, samples, num_rates: int = 4):
    """Kernel arguments (site_log_likelihoods') of ``samples`` under
    ``hmm``, on its device."""
    from linearham_tpu_torch.pipeline.run import prepare_ensemble

    sched, eig, rates = prepare_ensemble(hmm, samples, num_rates)
    s, eig_t, pi_t, rates_t = hmm.ensemble_inputs(sched, eig, samples.pi,
                                                  rates)
    return [eig_t, pi_t, rates_t, hmm.xmsa_rows, s["sched_src"],
            s["sched_penc"], s["sched_len"], s["sched_root"], sched.n_slots]


def family_args(n_trees: int, dtype, num_rates: int = 4, tree_seed=None,
                device="cuda", **family):
    """Kernel arguments of ``n_trees`` trees of one synthetic igh family on
    ``device``."""
    return ensemble_args(*make_batch(n_trees, dtype, tree_seed, device,
                                     **family), num_rates)


def stacked_args(hmms, samples, dtype, num_rates: int = 4, device="cuda"):
    """(kernel arguments of one stacked launch over the families on
    ``device``, each tree's real sites)."""
    from linearham_tpu_torch.ops.gtr import GTREigen
    from linearham_tpu_torch.ops.pruning_cuda import stack_schedules
    from linearham_tpu_torch.pipeline.run import prepare_ensemble

    preps = [prepare_ensemble(h, s, num_rates) for h, s in zip(hmms, samples)]
    stacked = stack_schedules(
        [p[0] for p in preps],
        [np.asarray(h.xmsa.matrix, np.int32) for h in hmms])

    def put(a):
        a = np.ascontiguousarray(a)
        return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f"
                               else torch.int32, device=device)

    st = stacked.sched
    args = [GTREigen(*(put(np.concatenate(parts))
                       for parts in zip(*(p[1] for p in preps)))),
            put(np.concatenate([s.pi for s in samples])),
            put(np.concatenate([p[2] for p in preps])), put(stacked.codes),
            put(st.src), put(st.penc), put(st.length), put(st.root),
            st.n_slots]
    cols = np.repeat(stacked.n_cols, [s.n_samples for s in samples])
    return args, cols


def igh_bucket_args(dtype=torch.float32):
    """The stacked igh bucket of ``REPERTOIRE`` (T = 24,565), from its
    files as the repertoire reads them."""
    import tempfile

    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.utils.synth import (load_tree_samples,
                                                 write_repertoire_inputs)

    with tempfile.TemporaryDirectory() as tmp:
        igh = write_repertoire_inputs(
            tmp, [f for f in REPERTOIRE if f[0] == "igh"], seed=0)["igh"]
        hmms = [PhyloHMM(f.yaml_path, 0, f.gene_dir, device="cuda",
                         dtype=dtype) for f in igh.families]
        samples = [load_tree_samples(f.trees_path) for f in igh.families]
    return stacked_args(hmms, samples, dtype)


SHAPES = {
    "bench_T4096_f32": lambda: (family_args(4096, torch.float32, n_seqs=100,
                                            seed=0), None),
    "bench_T4096_f64": lambda: (family_args(4096, torch.float64, n_seqs=100,
                                            seed=0), None),
    "312seq_T512_f32": lambda: (family_args(512, torch.float32,
                                            tree_seed=20, **FAMILY_312),
                                None),
    "igh_bucket_T24565_f32": igh_bucket_args,
}


def load_builds(sources: Sequence[str] = (), verbose: bool = False):
    """{name: bound library}: each other source (``NAME=SRC``), then this
    checkout's kernel as "new".  Builds run in parallel; ``verbose`` prints
    each build's ptxas report."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    import ctypes

    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.utils.cuda_build import (CSRC_DIR,
                                                      build_report,
                                                      build_source)

    jobs = {}
    for v in sources:
        name, _, path = v.partition("=")
        jobs[name] = (Path(path), f"pruning_{name}")
    jobs["new"] = (CSRC_DIR / "pruning.cu", "pruning")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda j: build_source(*j),
                                        jobs.values())))
    libs = {}
    for name, path in paths.items():
        for line in (build_report(*jobs[name]).splitlines()
                     if verbose else []):
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name} ptxas: {line.strip()}")
        libs[name] = (pruning_cuda.kernel_lib() if name == "new"
                      else pruning_cuda.bind(ctypes.CDLL(str(path))))
    if verbose:
        print(f"built {len(paths)} libraries in "
              f"{time.perf_counter() - t0:.1f}s")
    return libs


def blocks_per_sm(lib, args) -> Optional[int]:
    """Resident blocks per SM of ``lib``'s kernel at these sizes, where the
    library reports it (csrc/pruning.cu does; older builds do not)."""
    import ctypes

    fn = getattr(lib, "lh_pruning_blocks_per_sm", None)
    if fn is None:
        return None
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    return fn(args[8], args[2].shape[1], args[0].u.element_size())


def compare(libs, args, cols=None, reps: int = REPS) -> dict:
    """Every build against the plain walk, then timed in turns: one shape's
    report."""
    from linearham_tpu_torch.ops import pruning_cuda

    dtype = args[0].u.dtype
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    flops, nbytes = kernel_work(args, cols)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    rep = {"T": args[4].shape[0], "N": args[4].shape[1],
           "X": args[3].shape[1], "n_slots": args[8],
           "R": args[2].shape[1], "dtype": str(dtype).split(".")[1],
           "flop": flops, "bytes": nbytes, "bound_ms": b_ms,
           "bound_by": b_by, "builds": {}}
    for name, lib in libs.items():
        got = pruning_cuda._launch(*args, lib=lib)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype]))
        rep["builds"][name] = {"max_abs_err": err, "within_tol": ok,
                               "blocks_per_sm": blocks_per_sm(lib, args)}
    del want
    times = in_turns({n: (lambda lib=lib: pruning_cuda._launch(*args,
                                                               lib=lib))
                      for n, lib in libs.items()}, reps)
    for name, ms in times.items():
        med = sorted(ms)[len(ms) // 2]
        rep["builds"][name].update(
            ms=ms, tflops=flops / (med * 1e-3) / 1e12,
            share_of_bound=b_ms / med)
    return rep


def show(name: str, rep: dict) -> None:
    print(f"{name}: T={rep['T']} N={rep['N']} X={rep['X']} "
          f"n_slots={rep['n_slots']} R={rep['R']} {rep['dtype']}: "
          f"{rep['flop'] / 1e9:.3f} GFLOP, {rep['bytes'] / 1e6:.2f} MB, "
          f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    for b, r in rep["builds"].items():
        print(f"  {b}: {' / '.join(f'{m:.3f}' for m in r['ms'])} ms, "
              f"{r['tflops']:.2f} TFLOP/s, {r['share_of_bound']:.1%} of "
              f"bound; max|kernel-plain| {r['max_abs_err']:.3e} "
              f"(within: {r['within_tol']}); blocks/SM "
              f"{r['blocks_per_sm']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=SRC: another version of the kernel")
    ap.add_argument("--shape", action="append", choices=sorted(SHAPES),
                    help="shapes to run (default all)")
    ap.add_argument("--out", help="write the reports as JSON here")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pruning_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    libs = load_builds(a.source, verbose=True)
    reports = {}
    failed = []
    for name in a.shape or list(SHAPES):
        t0 = time.perf_counter()
        args, cols = SHAPES[name]()
        print(f"{name}: inputs built in {time.perf_counter() - t0:.1f}s",
              flush=True)
        reports[name] = rep = compare(libs, args, cols)
        show(name, rep)
        failed += [f"{name}/{b}" for b, r in rep["builds"].items()
                   if not r["within_tol"]]
        del args
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "shapes": reports}, fh, indent=1)
    if failed:
        print(f"pruning_ab: disagrees with plain: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
