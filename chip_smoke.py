#!/usr/bin/env python3
"""Smoke run of the PyTorch port (linearham_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code and no
result line; nothing is caught and passed over):

1. Environment: torch / CUDA / nvcc / triton / yaml versions and the card's
   name and power limit.  A CUDA device is required, and so is the C++ host
   library (its path is printed): the Python parsers never stand in for it
   silently on the card.
2. Build the pruning kernel (csrc/pruning.cu) from the checkout with nvcc;
   print ptxas's registers, stack and spills for each of its 8
   instantiations, and each type's tile, shared memory and resident warps
   an SM at the bench unit.
3. Kernel vs its plain torch version on the card, in f32, at the main
   path's shapes: a 100-sequence family at T=4096, R=4; R=1 with every
   branch length 0 (no NaN, impossible sites hugely negative); an all-N
   tip row; a 312-sequence family at T=64.  The plain walk is timed at the
   first shape.  Then the kernel is checked again and timed (CUDA events,
   median) at the bench unit and at tools/bench_312.py's family (T=512),
   in turns with an earlier version of the kernel where its source was
   placed at ``BASELINE_SOURCE`` (a comparison run): FLOP of the real
   entries, bound,
   FLOP/s and share of the bound of each.  Then the f64 instantiation
   against the f64 plain walk (rtol = atol = 1e-9) at the first shape and
   the 312-sequence one, and timed at the bench unit the same way.
4. The posterior-ensemble pipeline file to file at bench scale (igh,
   100 sequences, 10,240 trees, 4 rates, chunk 4096) through the port's
   run_pipeline, with the kernel's launch count read around it; then the
   first 512 trees through the plain f64 path on the card for the f32
   error bound, and a timed device step split into pruning vs the rest.
   Then the same file in f64 (``precision="f64"``, through the kernel's
   f64 instantiation): trees/s, launches, its first 512 trees against the
   plain f64 path (<= 1e-6 nats), and f32 against f64 LHLogLikelihood and
   LogWeight over the first 4,096 trees (max |d|, its spread about the
   mean, the importance-weight ESS in each).
5. The family disk cache: the bench pipeline twice into a fresh cache
   directory (a miss, then a hit); build_hmm of each, and the two TSVs
   equal in every non-sampled column, LHLogLikelihood within 1e-4 nats.
   Then one chunk (``max_chunks=1``) under ``trace_dir``: the
   torch.profiler trace holds exactly one pruning-kernel launch.
6. ``cli warmup`` and then ``cli serve`` as subprocesses on a 1,024-tree
   ensemble of the bench family: two good requests (every row written, the
   kernel launched) and one missing a key (answered ok: false, naming it),
   then ``quit`` (exit 0); the wall time of each request.
7. Viterbi through the kernel: ``PhyloHMM.map_step`` on 4,096 bench trees in
   f32 (exactly one kernel launch), held against the plain f64 path on the
   card for the first 512 trees (|dMAP| <= 1 nat, MAP <= log-likelihood),
   timed; ``map_annotation`` on one tree.
8. Goldens on the card in f64: SimpleHMM -42.8027747544 / -37.1354672701,
   PhyloHMM -75.8136 / -75.1122515055 through the f64 kernel (exactly one
   launch each), TreeBatch pruning -55.73483; ``map_annotation`` on the
   phylo fixture (card, f32 through the kernel) equal to the CPU's (f64).
   Then a one-sequence family (the smallest schedule: two tips), 4 trees,
   R = 4, through the kernel in f64 and f32 against the plain f64 path
   (F64_LOGLIK_BOUND and F32_LOGLIK_BOUND).
9. Bootstrap ASR (burn-in 0.1, subsample 0.05: 460 trees) on phase 5's
   10,240-row output, on the card in f64: internal sequences in ACGT, tips
   verbatim, ``.log``/``.ess`` byte-identical to the same call on the CPU.
10. The mixed-depth repertoire: 24 igh families of 10/25/50/100 sequences
   sharing one germline directory, with ragged ensembles of 768-1,280
   trees, and 2 igk families (a second bucket).  ``cli repertoire
   --profile`` on the igh manifest as a cold subprocess (one launch, every
   row written and finite); ``run_repertoire`` over all 26 families in
   process (exactly 2 launches, one per bucket); the shallowest, the
   deepest and an igk family against ``run_pipeline_arrays`` on the card
   (<= 1e-4 nats); a stacked launch of 64 trees from each of three
   families against the plain walk (KERNEL_TOL, and in f64 within 1e-9);
   the whole igh bucket (T = 24,565) against the plain walk and timed in
   turns with the earlier kernel as in phase 3 (the fourth shape); the
   deepest family's
   first 256 trees against the plain f64 path (<= 1 nat); then
   ``python -m linearham_tpu_torch.workflow --cluster-indices 0`` twice on
   the bench family with a pre-placed 1,024-tree ensemble (the second run
   up to date).
11. The mesh on the card (parallel/mesh.py, parallel/dryrun.py): (i) an
   NCCL group of one in this process, ``run_repertoire(mesh=make_mesh(1,
   1))`` on phase 10's 26 families equal to the run without a mesh (2
   launches, the same samples); (ii) ``dryrun_multigpu(2)`` over gloo, both
   ranks on cuda:0 (NCCL refuses two ranks on one card), then two gloo
   ranks sharing cuda:0 run the 26 families from phase 10's warm family
   cache under a (2, 1) and a (1, 2) mesh: every rank's f32
   log-likelihoods within rel 2e-6 of phase 10's (a tree split changes the
   post-pruning batch), the kernel's rows of each share bitwise equal to a
   launch over the whole bucket, six families also in f64 within 1e-6
   nats of their unsharded run, the same samples under (2, 1), one launch
   per non-empty bucket share, the wall and the gather's share of it per
   rank; (iii) with two or more GPUs, the dry run over NCCL on up
   to four of them (else it says it did not run).
12. The result lines (after phase 13): the nvidia-smi line, the kernels
   JSON line (launch counts of the pipeline, map, serve, repertoire,
   workflow, mesh, f64, one-sequence and bench paths; the time, bound and
   share of the bound at each timed shape, in
   f32 and f64, with the earlier kernel's time where it ran), and the
   {"ok": true, ...} line last.
   Before them the script checks that nothing it ran loaded jax or any
   module of the JAX package (linearham_tpu): the port keeps its own host
   modules, synthetic inputs included.
13. The measurement tool and the mains, as fresh processes:
   ``python -m linearham_tpu_torch.tools.bench`` in each mode
   (``BENCH_RUNS``: the pipeline at the bench unit, in igk at 2,048 trees,
   step, repertoire --mixed --fams 4, repertoire_step, depth312,
   f32_weights, probe, ensemble --reps 1), each ending with one JSON line
   that names the card, every row written and every number finite; then
   the five post-processing mains (``python -m
   linearham_tpu_torch.postprocess.*``) on phase 9's bootstrap outputs and
   phase 4's files, while the same functions run in this process: their
   files byte-equal.  No process loads jax or the JAX package.  The tool's
   kernel launches are the ``bench`` path's.  (The script runs under
   PYTHONHASHSEED=0, re-executing itself where it is not set: see
   ``main``.)
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 5e-4          # rtol = atol, kernel vs plain, both f32
F64_KERNEL_TOL = 1e-9      # rtol = atol, kernel vs plain, both f64
F64_LOGLIK_BOUND = 1e-6    # nats, f64 pipeline (kernel) vs f64 plain path
MESH_LL_BOUND = 1e-6       # nats, a mesh's f64 repertoire vs unsharded
# A mesh that splits trees changes each family's post-pruning batch, and
# cuBLAS's f32 sums then take another order: a few f32 ulps of |ll| ~ 1e4
# (rel 4.755e-07 measured on an H100 at 700 W).  The kernel's rows are held
# bitwise equal to the unsplit launch's, so the drift is pinned after it.
MESH_F32_RTOL = 2e-6
MESH_F64_FAMILIES = (0, 3, 12, 23, 24, 25)   # phase 10 indices, run in f64
F32_LOGLIK_BOUND = 1.0     # nats, f32 pipeline vs f64 plain path
# An earlier version of csrc/pruning.cu (same C interface), placed here
# (git-ignored) for a comparison run: phases 3 and 10 then time it in turns
# with this checkout's kernel.
BASELINE_SOURCE = os.path.join(REPO, "build", "baseline", "pruning.cu")
BENCH = dict(n_seqs=100, n_trees=10240, chunk=4096, num_rates=4)
CACHE_LL_BOUND = 1e-4      # nats, family-cache hit vs miss
SERVE_TREES = 1024         # the reference's default ensemble size
# Workflow defaults (linearham_tpu/workflow.py:175-176): 460 of 10,240 rows.
ASR_BURNIN, ASR_SUBSAMPLE, ASR_TREES = 0.1, 0.05, 460
PI_FIXTURE = [0.17, 0.19, 0.25, 0.39]
REPERTOIRE_PLAIN_TREES = 64     # per family, stacked launch vs plain walk
REPERTOIRE_F64_TREES = 256      # deepest family, f32 vs plain f64
SAMPLED_COLS = {"NaiveSequence", "VGene", "V5pDel", "V3pDel",
                "VFwkInsertion", "VDInsertion", "DGene", "D5pDel", "D3pDel",
                "DJInsertion", "JGene", "J5pDel", "J3pDel", "JFwkInsertion"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)


def environment(torch):
    phase(1, "environment")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from linearham_tpu_torch.io import native
    from linearham_tpu_torch.utils.cuda_build import find_nvcc
    from linearham_tpu_torch.utils.runtime import card_identity

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = card_identity()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"nvcc: {nvcc[-1]}")
    for mod in ("triton", "yaml"):
        print(f"import {mod}: "
              f"{'yes' if importlib.util.find_spec(mod) else 'no'}")
    print(f"device: {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}  nvidia-smi: {smi}")
    # The host parsers' C++ library: on the card the Python fallback must
    # never stand in silently for it.
    lib = native._load()
    print(f"native host library: {lib._name if lib else None}")
    check(lib is not None, "the native host library did not build or load")
    return smi


def build():
    phase(2, "build the pruning kernel")
    import re

    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.utils.cuda_build import (CSRC_DIR,
                                                      build_library,
                                                      build_report)

    t0 = time.perf_counter()
    lib = build_library("pruning")
    k = pruning_cuda.kernel_lib()
    print(f"built {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0:.2f}s")
    log = build_report(CSRC_DIR / "pruning.cu", "pruning")
    # -Xptxas -v for every instantiation pruning_kernel<T, R, tile>:
    # registers, stack, spills.
    name, seen = None, 0
    for line in log.splitlines():
        m = re.search(r"pruning_kernelI([fd])Li(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            name = (f"pruning_kernel<{'float' if m[1] == 'f' else 'double'}"
                    f", R={m[2]}, {m[3]} sites>")
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
            seen += "registers" in line
    check(seen == 8, f"ptxas reported {seen} of 8 instantiations")
    # Shared memory and residency at the bench unit (N = 200, 8 slots,
    # R = 4), from the library's own reckoning and the occupancy API.
    for label, elem in (("f32", 4), ("f64", 8)):
        tile = k.lh_pruning_tile(elem)
        blocks = k.lh_pruning_blocks_per_sm(8, 4, elem)
        print(f"  {label}: {tile}-site tile, {tile} + 32 threads a block "
              f"(a site each, one producer warp), "
              f"{k.lh_pruning_smem_bytes(200, 8, 4, elem)} B of shared "
              f"memory; {blocks} blocks = {blocks * (tile + 32) // 32} "
              f"resident warps an SM")


def cuda_ms(torch, fn, reps):
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


def kernel_vs_plain(torch):
    phase(3, "kernel vs plain on the card (f32)")
    from linearham_tpu_torch.ops.pruning_cuda import (
        site_log_likelihoods, site_log_likelihoods_plain)
    from linearham_tpu_torch.tools import pruning_ab

    hmm, samples = pruning_ab.make_batch(4096, torch.float32,
                                         n_seqs=BENCH["n_seqs"], seed=0)
    main_args = pruning_ab.ensemble_args(hmm, samples, BENCH["num_rates"])
    sub = pruning_ab.ensemble_args(hmm, samples[:64], BENCH["num_rates"])

    # R=1 and every branch length 0: identity transitions, so a site where
    # two tips of a cherry disagree has likelihood exactly 0.
    zero = list(sub)
    zero[2] = torch.ones_like(sub[2][:, :1]).contiguous()
    zero[6] = torch.zeros_like(sub[6])
    # An all-N xMSA row replaces every tree's tip of row 1.
    rows_n = torch.cat([hmm.xmsa_rows, torch.full_like(hmm.xmsa_rows[:1], 4)])
    is_tip = (sub[5] & 1) == 1
    all_n = list(sub)
    all_n[3] = rows_n
    all_n[4] = torch.where(is_tip & (sub[4] == 1), rows_n.shape[0] - 1,
                           sub[4]).contiguous()
    cases = {
        "100seq_T4096_R4": main_args,
        "R1_zero_branches": zero,
        "all_N_tip": all_n,
        "312seq_T64_R4": pruning_ab.family_args(64, torch.float32,
                                                n_seqs=312, seed=1),
    }
    worst = 0.0
    for name, args in cases.items():
        got = site_log_likelihoods(*args)
        want = site_log_likelihoods_plain(*args)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"{name}: kernel gave NaN")
        check(tuple(got.shape) == tuple(want.shape), f"{name}: shape")
        possible = want > -15 if name == "R1_zero_branches" \
            else torch.ones_like(want, dtype=torch.bool)
        if name == "R1_zero_branches":
            check(bool((~possible).any()), "no impossible site arose")
            check(bool((got[~possible] < -15).all()),
                  f"{name}: impossible sites not hugely negative")
        g, w = got[possible], want[possible]
        check(bool(torch.isfinite(w).all()), f"{name}: plain not finite")
        err = float((g - w).abs().max())
        ok = torch.allclose(g, w, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        print(f"{name}: shape {tuple(got.shape)}  max|kernel-plain| "
              f"{err:.3e}  within {KERNEL_TOL}: {ok}")
        check(ok, f"{name}: kernel disagrees with plain ({err:.3e})")
        worst = max(worst, err)

    plain_ms = cuda_ms(torch, lambda: site_log_likelihoods_plain(*main_args),
                       5)
    print(f"plain walk at 100seq T=4096 R=4 (X={main_args[3].shape[1]}, "
          f"N={main_args[4].shape[1]}, n_slots={main_args[8]}): "
          f"{plain_ms:.3f} ms (median of 5, CUDA events)")
    del zero, all_n, cases
    reports = {"bench_T4096_f32": in_turns(torch, "bench_T4096_f32",
                                           main_args)}
    del main_args, sub
    args312 = pruning_ab.family_args(512, torch.float32, tree_seed=20,
                                     **pruning_ab.FAMILY_312)
    reports["312seq_T512_f32"] = in_turns(torch, "312seq_T512_f32", args312)
    return worst, plain_ms, reports


def in_turns(torch, name, args, cols=None):
    """The kernel (and the earlier one, where present) against the plain
    walk and timed in turns at one shape: FLOP, bound, FLOP/s, share."""
    from linearham_tpu_torch.tools import pruning_ab

    libs = pruning_ab.load_builds(
        [f"baseline={BASELINE_SOURCE}"] if os.path.exists(BASELINE_SOURCE)
        else [])
    rep = pruning_ab.compare(libs, args, cols)
    pruning_ab.show(name, rep)
    if "baseline" not in libs:
        print(f"  (no earlier kernel at "
              f"{os.path.relpath(BASELINE_SOURCE, REPO)}: the new one alone)")
    bad = [b for b, r in rep["builds"].items() if not r["within_tol"]]
    check(not bad, f"{name}: {bad} disagree with the plain walk")
    return rep


def kernel_vs_plain_f64(torch):
    """The f64 instantiation against the f64 plain walk, and its time (in
    turns with the earlier kernel, where present)."""
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.tools import pruning_ab

    worst, f64 = 0.0, torch.float64
    for name, (n_seqs, T, seed) in (("100seq_T4096_R4", (100, 4096, 0)),
                                    ("312seq_T64_R4", (312, 64, 1))):
        args = pruning_ab.family_args(T, f64, n_seqs=n_seqs, seed=seed)
        before = pruning_cuda.launches
        got = pruning_cuda.site_log_likelihoods(*args)
        want = pruning_cuda.site_log_likelihoods_plain(*args)
        torch.cuda.synchronize()
        check(pruning_cuda.launches == before + 1 and got.dtype == f64,
              f"f64 {name}: not one f64 launch")
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=F64_KERNEL_TOL,
                            atol=F64_KERNEL_TOL)
        print(f"f64 {name}: max|kernel-plain| {err:.3e}  "
              f"within {F64_KERNEL_TOL}: {ok}")
        check(ok, f"f64 {name}: kernel disagrees with plain ({err:.3e})")
        worst = max(worst, err)
        if name.startswith("100seq"):
            main_args = args
    plain_ms = cuda_ms(
        torch, lambda: pruning_cuda.site_log_likelihoods_plain(*main_args), 5)
    print(f"f64 plain walk at 100seq T=4096 R=4: {plain_ms:.3f} ms (median "
          "of 5, CUDA events)")
    return worst, plain_ms, in_turns(torch, "bench_T4096_f64", main_args)


def plain_f64_emissions(torch, yaml_path, gene_dir, samples):
    """(f64 model on the card, region emissions of ``samples``) through the
    plain pruning walk: the reference the f32 kernel paths are held to."""
    from linearham_tpu_torch.models.phylo_hmm import (
        PhyloHMM, naive_prior_correction, region_emissions)
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.tools import pruning_ab

    hmm64 = PhyloHMM(yaml_path, 0, gene_dir, device="cuda",
                     dtype=torch.float64)
    args = pruning_ab.ensemble_args(hmm64, samples, BENCH["num_rates"])
    site_ll = pruning_cuda.site_log_likelihoods_plain(*args)
    return hmm64, region_emissions(
        naive_prior_correction(site_ll, args[1], hmm64.naive_bases),
        hmm64.consts, hmm64.heavy)


def pipeline(torch, tmp):
    phase(4, "pipeline file to file")
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.models.step import (Prepared, stack_blocks,
                                                 step_blocks)
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.ops.forward import forward
    from linearham_tpu_torch.pipeline.run import run_pipeline
    from linearham_tpu_torch.utils.synth import (load_tree_samples,
                                                 write_pipeline_inputs)

    n_trees, chunk = BENCH["n_trees"], BENCH["chunk"]
    t0 = time.perf_counter()
    files = write_pipeline_inputs(tmp, BENCH["n_seqs"], n_trees, seed=0)
    fam, yaml_path = files.family, files.yaml_path
    gene_dir, trees_path = files.gene_dir, files.trees_path
    out_tsv = os.path.join(tmp, "lh_revbayes_run.trees")
    print(f"inputs written (untimed) in {time.perf_counter() - t0:.1f}s")

    torch.cuda.synchronize()
    pruning_cuda.launches = 0
    t0 = time.perf_counter()
    result = run_pipeline(yaml_path, 0, gene_dir, trees_path, out_tsv,
                          num_rates=BENCH["num_rates"], seed=0,
                          chunk_size=chunk, precision="f32",
                          device="cuda")
    wall = time.perf_counter() - t0
    launches = pruning_cuda.launches
    check(launches > 0, "the pipeline never launched the kernel")

    with open(out_tsv) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    col = header.index("LHLogLikelihood")
    lh = torch.tensor([float(r[col]) for r in rows],
                      dtype=torch.float64)
    check(len(rows) == n_trees, f"{len(rows)} rows, want {n_trees}")
    check(bool(torch.isfinite(lh).all()), "non-finite LHLogLikelihood")
    naive_col = header.index("NaiveSequence")
    check(all(len(r[naive_col]) == fam.n_sites for r in rows),
          "NaiveSequence of the wrong length")
    stages = {k: round(v, 4) for k, v in result.timings.items()}
    print(f"pipeline: {n_trees} trees x {BENCH['n_seqs']} seqs, chunk "
          f"{chunk}: wall {wall:.3f}s, {n_trees / wall:.1f} trees/s, "
          f"kernel launches {launches}")
    print(f"stages (s): {json.dumps(stages)}")

    # f32 pipeline vs the plain f64 path on the card, first 512 trees.
    n_ref = 512
    hmm64, emis = plain_f64_emissions(
        torch, yaml_path, gene_dir, load_tree_samples(trees_path)[:n_ref])
    ll64 = forward(hmm64.trans, emis, hmm64.heavy)[0].cpu()
    dll = float((ll64 - lh[:n_ref]).abs().max())
    print(f"f32 pipeline vs f64 plain, first {n_ref} trees: "
          f"max|dLHLogLikelihood| = {dll:.4e} nats "
          f"(bound {F32_LOGLIK_BOUND})")
    check(dll <= F32_LOGLIK_BOUND, "f32 log-likelihood error too large")

    # One 4096-tree device step, split into pruning and the rest.
    hmm32 = PhyloHMM(yaml_path, 0, gene_dir, device="cuda",
                     dtype=torch.float32)
    first = load_tree_samples(trees_path)[:chunk]
    inputs = stack_blocks([Prepared.of(hmm32, first, BENCH["num_rates"])]
                          ).to_device(hmm32.device, hmm32.dtype)
    gen = torch.Generator(device="cuda")
    step_ms = cuda_ms(torch, lambda: step_blocks(inputs, [gen]), 5)
    prune_ms = cuda_ms(torch, lambda: pruning_cuda._launch(*inputs.args), 10)
    print(f"device step at T={chunk}: {step_ms:.3f} ms, of which "
          f"pruning kernel {prune_ms:.3f} ms, emissions+forward+FFBS "
          f"{step_ms - prune_ms:.3f} ms (median, CUDA events)")

    # The same file in f64, through the kernel's f64 instantiation.
    import numpy as np

    out64 = os.path.join(tmp, "lh_f64.trees")
    torch.cuda.synchronize()
    before = pruning_cuda.launches
    t0 = time.perf_counter()
    result64 = run_pipeline(yaml_path, 0, gene_dir, trees_path, out64,
                            num_rates=BENCH["num_rates"], seed=0,
                            chunk_size=chunk, precision="f64",
                            device="cuda")
    wall64 = time.perf_counter() - t0
    launches64 = pruning_cuda.launches - before
    check(launches64 == -(-n_trees // chunk),
          f"the f64 pipeline launched {launches64} kernels")
    header64, rows64 = read_tsv(out64)
    check(header64 == header and len(rows64) == n_trees,
          "the f64 TSV differs in shape")
    lw_col = header.index("LogWeight")
    ll32, ll64p = (np.array([float(r[col]) for r in rs])
                   for rs in (rows, rows64))
    lw32, lw64 = (np.array([float(r[lw_col]) for r in rs])
                  for rs in (rows, rows64))
    check(bool(np.isfinite(ll64p).all()), "non-finite f64 LHLogLikelihood")
    print(f"f64 pipeline: {n_trees} trees, chunk {chunk}: wall "
          f"{wall64:.3f}s, {n_trees / wall64:.1f} trees/s, kernel launches "
          f"{launches64}")
    print(f"stages (s): "
          f"{json.dumps({k: round(v, 4) for k, v in result64.timings.items()})}")
    d64 = float(np.abs(ll64p[:n_ref] - ll64.numpy()).max())
    print(f"f64 pipeline (kernel) vs f64 plain, first {n_ref} trees: "
          f"max|dLHLogLikelihood| = {d64:.4e} nats (bound "
          f"{F64_LOGLIK_BOUND})")
    check(d64 <= F64_LOGLIK_BOUND, "the f64 kernel path strays from plain")

    def ess(lw):
        e = np.exp(lw - lw.max())
        return float(e.sum() ** 2 / (e * e).sum())

    n_w = chunk
    d = ll32[:n_w] - ll64p[:n_w]
    print(f"f32 vs f64, first {n_w} trees: max|dLHLogLikelihood| "
          f"{np.abs(d).max():.4e}, about its mean {d.mean():.4e}: max "
          f"{np.abs(d - d.mean()).max():.4e}, std {d.std():.4e}; "
          f"max|dLogWeight| {np.abs(lw32[:n_w] - lw64[:n_w]).max():.4e}; "
          f"importance-weight ESS f32 {ess(lw32[:n_w]):.4f}, f64 "
          f"{ess(lw64[:n_w]):.4f}")
    return launches, files, launches64


def read_tsv(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        return header, [ln.rstrip("\n").split("\t") for ln in fh]


def family_cache(torch, tmp, files):
    phase(5, "family cache: the bench pipeline twice, miss then hit")
    from linearham_tpu_torch.pipeline.run import run_pipeline

    cache = os.path.join(tmp, "family_cache")
    os.environ["LINEARHAM_FAMILY_CACHE"] = cache
    outs, builds = {}, {}
    for run in ("miss", "hit"):
        outs[run] = os.path.join(tmp, f"lh_cache_{run}.trees")
        t0 = time.perf_counter()
        result = run_pipeline(files.yaml_path, 0, files.gene_dir,
                              files.trees_path, outs[run],
                              num_rates=BENCH["num_rates"], seed=0,
                              chunk_size=BENCH["chunk"], precision="f32",
                              device="cuda")
        builds[run] = result.timings["build_hmm"]
        print(f"{run}: build_hmm {builds[run]:.4f}s, wall "
              f"{time.perf_counter() - t0:.3f}s")
    entries = [f for f in os.listdir(cache) if f.endswith(".pkl")]
    check(len(entries) == 1, f"cache holds {entries}, want one entry")

    header, miss = read_tsv(outs["miss"])
    header_hit, hit = read_tsv(outs["hit"])
    check(header == header_hit and len(miss) == len(hit) == BENCH["n_trees"],
          "miss and hit TSVs differ in shape")
    ll = header.index("LHLogLikelihood")
    fixed = [i for i, c in enumerate(header) if c not in SAMPLED_COLS
             and c not in ("LHLogLikelihood", "LogWeight")]
    dll = max(abs(float(a[ll]) - float(b[ll])) for a, b in zip(miss, hit))
    differ = sum(a != b for a, b in zip(miss, hit))
    check(all(a[i] == b[i] for a, b in zip(miss, hit) for i in fixed),
          "a non-sampled column differs between miss and hit")
    print(f"miss vs hit: max|dLHLogLikelihood| {dll:.3e} nats "
          f"(bound {CACHE_LL_BOUND}); rows differing in any column: "
          f"{differ} of {len(miss)}")
    check(dll <= CACHE_LL_BOUND, "hit log-likelihoods differ from miss")

    # One chunk (max_chunks=1, whole-ensemble shapes) under the exporter of
    # --trace-dir: the torch.profiler trace must hold the kernel's launch.
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
    from linearham_tpu_torch.utils import profiling
    from linearham_tpu_torch.utils.synth import load_tree_samples

    trace_dir = os.path.join(tmp, "trace")
    hmm = cached_phylo_hmm(files.yaml_path, 0, files.gene_dir,
                           device="cuda", dtype=torch.float32)
    samples = load_tree_samples(files.trees_path)
    before = pruning_cuda.launches
    with profiling.recording() as timer, profiling.trace(
            trace_dir, "cuda", timer, "pipeline"):
        result = run_pipeline_arrays(hmm, samples, BENCH["num_rates"],
                                     chunk_size=BENCH["chunk"], max_chunks=1)
    check(len(result.annotations) == BENCH["chunk"]
          and pruning_cuda.launches == before + 1,
          "max_chunks=1 did not run exactly one chunk")
    traces = os.listdir(trace_dir)
    check(len(traces) == 1, f"trace directory holds {traces}")
    with open(os.path.join(trace_dir, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    pruning = [e for e in kernel_events if "pruning_kernel" in e["name"]]
    print(f"trace of one {BENCH['chunk']}-tree chunk: {len(events)} events,"
          f" {len(kernel_events)} CUDA kernels, {len(pruning)} pruning "
          f"kernel(s), {sum(e['dur'] for e in pruning) / 1e3:.3f} ms")
    check(len(pruning) == 1, "the trace lacks the pruning kernel's launch")
    return outs["hit"], builds


def warmup_and_serve(torch, tmp, files):
    phase(6, f"warmup and serve, {SERVE_TREES}-tree ensemble, subprocesses")
    trees = os.path.join(tmp, f"revbayes_{SERVE_TREES}.trees")
    with open(files.trees_path) as src, open(trees, "w") as dst:
        for _ in range(SERVE_TREES + 1):
            dst.write(src.readline())
    env = {**os.environ, "LINEARHAM_FAMILY_CACHE":
           os.path.join(tmp, "serve_cache"), "PYTHONPATH": REPO}
    cli = [sys.executable, "-m", "linearham_tpu_torch.cli"]
    family = ["--yaml-path", files.yaml_path, "--cluster-ind", "0",
              "--hmm-param-dir", files.gene_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cli + ["warmup", *family, "--input-path", trees, "--num-rates",
               str(BENCH["num_rates"]), "--chunk-size", str(SERVE_TREES),
               "--device", "cuda"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    print(f"warmup: rc {proc.returncode} in {time.perf_counter() - t0:.1f}s:"
          f" {proc.stdout.strip()}")
    check(proc.returncode == 0, f"warmup failed:\n{proc.stderr[-3000:]}")

    def request(name, drop=None):
        req = {"yaml_path": files.yaml_path, "cluster_ind": 0,
               "hmm_param_dir": files.gene_dir, "input_path": trees,
               "output_path": os.path.join(tmp, name),
               "num_rates": BENCH["num_rates"], "chunk_size": SERVE_TREES,
               "precision": "f32"}
        req.pop(drop, None)
        return json.dumps(req)

    stdin = "\n".join([request("serve_a.tsv"),
                       request("serve_bad.tsv", drop="input_path"),
                       request("serve_b.tsv"), "quit"]) + "\n"
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["serve", "--device", "cuda"], input=stdin,
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    print(f"serve: rc {proc.returncode} in {time.perf_counter() - t0:.1f}s")
    check(proc.returncode == 0, f"serve failed:\n{proc.stderr[-3000:]}")
    answers = [json.loads(ln) for ln in proc.stdout.splitlines()]
    check([a["ok"] for a in answers] == [True, False, True],
          f"serve answered {answers}")
    check("'input_path'" in answers[1]["error"],
          f"the bad request's answer does not name the key: {answers[1]}")
    launches = 0
    for a in (answers[0], answers[2]):
        _, rows = read_tsv(a["output_path"])
        check(a["n_trees"] == len(rows) == SERVE_TREES,
              f"{a['output_path']}: {len(rows)} rows")
        check(a["kernel_launches"] >= 1, "serve never launched the kernel")
        launches += a["kernel_launches"]
        print(f"request {os.path.basename(a['output_path'])}: wall "
              f"{a['wall_s']}s, {a['kernel_launches']} kernel launch(es)")
    print(f"bad request answered: {answers[1]['error']}")
    return launches


def viterbi_through_kernel(torch, tmp, files):
    phase(7, "Viterbi (MAP) through the kernel")
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.models.step import Prepared, launch, stack_blocks
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.ops.forward import forward
    from linearham_tpu_torch.ops.viterbi import viterbi
    from linearham_tpu_torch.utils.synth import load_tree_samples

    chunk, n_ref, R = BENCH["chunk"], 512, BENCH["num_rates"]
    hmm = cached_phylo_hmm(files.yaml_path, 0, files.gene_dir,
                           device="cuda", dtype=torch.float32)
    first = load_tree_samples(files.trees_path)[:chunk]
    inputs = stack_blocks([Prepared.of(hmm, first, R)]).to_device(
        hmm.device, hmm.dtype)
    torch.cuda.synchronize()
    pruning_cuda.launches = 0
    score, path = hmm.map_step(launch(inputs), inputs.pi)
    torch.cuda.synchronize()
    step_launches = pruning_cuda.launches
    check(step_launches == 1, f"map step launched {step_launches} kernels")
    check(bool(torch.isfinite(score).all()), "non-finite MAP score")

    hmm64, emis = plain_f64_emissions(torch, files.yaml_path,
                                      files.gene_dir, first[:n_ref])
    score64, path64 = viterbi(hmm64.trans, emis, hmm64.heavy)
    ll64 = forward(hmm64.trans, emis, hmm64.heavy)[0]
    dmap = float((score[:n_ref].double() - score64).abs().max())
    gap = float((score64 - ll64).max())
    same = int((path.vd_idx[:n_ref] == path64.vd_idx).all(1).sum())
    print(f"f32 MAP (kernel) vs f64 plain, first {n_ref} trees: "
          f"max|dMAP| {dmap:.4e} nats (bound {F32_LOGLIK_BOUND}); "
          f"max(MAP - loglik) in f64 {gap:.4e}; "
          f"{same} of {n_ref} VD paths identical")
    check(dmap <= F32_LOGLIK_BOUND, "f32 MAP score error too large")
    check(gap <= 1e-9, "a MAP score exceeds its tree's log-likelihood")

    step_ms = cuda_ms(torch, lambda: hmm.map_step(launch(inputs), inputs.pi),
                      5)
    print(f"MAP step at T={chunk}: {step_ms:.3f} ms (median of 5, CUDA "
          "events)")

    nwk = os.path.join(tmp, "tree0.nwk")
    with open(nwk, "w") as fh:
        fh.write(first.newicks[0] + "\n")
    hmm.init_phylo_parameters(nwk, list(first.er[0]), list(first.pi[0]),
                              float(first.alpha[0]), R)
    pruning_cuda.launches = 0
    ann = hmm.map_annotation()
    one_launch = pruning_cuda.launches
    check(one_launch == 1, "map_annotation did not launch the kernel once")
    check(len(ann.naive_seq) == files.family.n_sites,
          "map_annotation naive sequence of the wrong length")
    print(f"map_annotation, tree 0: score {hmm.map_score:.4f}, "
          f"V {ann.vgerm_state}, J {ann.jgerm_state}")
    return step_launches + one_launch, step_ms


def goldens(torch):
    phase(8, "goldens on the card, f64")
    from dataclasses import asdict

    from linearham_tpu_torch.models import SimpleHMM
    from linearham_tpu_torch.models.phylo_hmm import (PhyloHMM,
                                                      naive_prior_correction,
                                                      region_emissions)
    from linearham_tpu_torch.ops.forward import forward
    from linearham_tpu_torch.ops.gtr import GTREigen, gtr_eigen
    from linearham_tpu_torch.ops.pruning import site_log_likelihoods

    fx = os.path.join(REPO, "tests", "fixtures")
    for yaml_name, want in (("simple_hmm_input.yaml", -42.8027747544),
                            ("simple_hmm_input_extra.yaml", -37.1354672701)):
        got = SimpleHMM(os.path.join(fx, yaml_name), 0,
                        os.path.join(fx, "hmm_params"), device="cuda",
                        dtype=torch.float64).log_likelihood()
        print(f"SimpleHMM {yaml_name}: {got:.10f} (golden {want})")
        check(abs(got - want) <= 1e-8 * abs(want), f"{yaml_name} golden")

    # TreeBatch pruning feeding the emission chain: R=1, newton.tree.
    newton = os.path.join(fx, "newton.tree")
    h = PhyloHMM(os.path.join(fx, "phylo_likelihood_hmm_input.yaml"), 0,
                 os.path.join(fx, "phylo_likelihood_hmm_params"),
                 device="cuda", dtype=torch.float64)
    h.init_phylo_parameters(newton, [1.0] * 6, PI_FIXTURE, 1.0, 1)
    tb = h.tree_batch

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device="cuda")

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device="cuda")

    pi = f64([PI_FIXTURE])
    site_ll = site_log_likelihoods(
        GTREigen(*(f64(a) for a in gtr_eigen([[1.0] * 6], [PI_FIXTURE]))),
        pi, f64([[1.0]]), h.xmsa_rows[i32(tb.tip_perm).long()],
        i32(tb.tip_parent), f64(tb.tip_length), i32(tb.edge_child),
        i32(tb.edge_parent), f64(tb.edge_length), i32(tb.root_slot),
        tb.n_slots)
    emis = region_emissions(naive_prior_correction(site_ll, pi,
                                                   h.naive_bases),
                            h.consts, h.heavy)
    ll = float(forward(h.trans, emis, h.heavy)[0][0])
    print(f"TreeBatch pruning, phylo_likelihood fixture: {ll:.6f} "
          "(golden -55.73483)")
    check(abs(ll + 55.73483) <= 1e-5, "TreeBatch pruning golden")

    # PhyloHMM through the kernel's f64 instantiation, one launch each.
    from linearham_tpu_torch.ops import pruning_cuda

    launches = 0
    for yaml_name, want, tol in (
            ("phylo_hmm_input.yaml", -75.8136, 1e-4),
            ("phylo_hmm_input_extra.yaml", -75.1122515055,
             1e-9 * 75.1122515055)):
        h = PhyloHMM(os.path.join(fx, yaml_name), 0,
                     os.path.join(fx, "hmm_params"), device="cuda",
                     dtype=torch.float64)
        h.init_phylo_parameters(newton, [1.0] * 6, PI_FIXTURE, 1.0, 4)
        before = pruning_cuda.launches
        got = h.log_likelihood()
        n = pruning_cuda.launches - before
        print(f"PhyloHMM {yaml_name}, f64 kernel: {got:.10f} (golden "
              f"{want}), {n} launch")
        check(n == 1, f"{yaml_name}: {n} launches, want 1")
        check(abs(got - want) <= tol, f"{yaml_name} golden on the card")
        launches += n

    # map_annotation on the card (f32, through the kernel) vs the CPU (f64).
    args = (os.path.join(fx, "phylo_hmm_input.yaml"), 0,
            os.path.join(fx, "hmm_params"))
    anns, scores = {}, {}
    for dev in ("cuda", "cpu"):
        hmm = PhyloHMM(*args, device=dev)
        hmm.init_phylo_parameters(newton, [1.0] * 6, PI_FIXTURE, 1.0, 4)
        anns[dev], scores[dev] = asdict(hmm.map_annotation()), hmm.map_score
    print(f"map_annotation phylo fixture: card {scores['cuda']:.6f} "
          f"(f32), CPU {scores['cpu']:.6f} (f64), naive "
          f"{anns['cuda']['naive_seq']}")
    check(anns["cuda"] == anns["cpu"], "card and CPU MAP annotations differ")
    check(abs(scores["cuda"] - scores["cpu"]) <= 1e-3,
          "card and CPU MAP scores differ")
    return launches, one_sequence_family(torch)


def one_sequence_family(torch):
    """A one-sequence family (the smallest schedule: two tips), 4 trees,
    R = 4, through the kernel in f64 and f32, against the plain f64 path
    on the card.  Returns the kernel's launches."""
    from linearham_tpu_torch.models.step import Prepared, launch, stack_blocks
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.tools import pruning_ab

    lls, launches = {}, 0
    for dtype in (torch.float64, torch.float32):
        hmm, trees = pruning_ab.make_batch(4, dtype, n_seqs=1, seed=4)
        inputs = stack_blocks([Prepared.of(hmm, trees, 4)]).to_device(
            hmm.device, hmm.dtype)
        before = pruning_cuda.launches
        lls[dtype] = hmm.step_from_site_ll(
            launch(inputs), inputs.pi, None)[0].double().cpu()
        launches += pruning_cuda.launches - before
        if dtype == torch.float64:
            plain = hmm.step_from_site_ll(
                pruning_cuda.site_log_likelihoods_plain(*inputs.args),
                inputs.pi, None)[0].cpu()
    d64 = float((lls[torch.float64] - plain).abs().max())
    d32 = float((lls[torch.float32] - plain).abs().max())
    sched = inputs.stacked.sched
    print(f"one-sequence family (N = {sched.src.shape[1]}, {sched.n_slots} "
          f"slots), 4 trees: plain f64 {plain.tolist()}; kernel f64 max|d| "
          f"{d64:.3e} (bound {F64_LOGLIK_BOUND}), f32 {d32:.3e} (bound "
          f"{F32_LOGLIK_BOUND}); {launches} launches")
    check(launches == 2, f"one-sequence family: {launches} launches")
    check(bool(torch.isfinite(plain).all()), "one-sequence: not finite")
    check(d64 <= F64_LOGLIK_BOUND, "one-sequence family: f64 kernel strays")
    check(d32 <= F32_LOGLIK_BOUND, "one-sequence family: f32 kernel strays")
    return launches


def bootstrap_asr(torch, tmp, files, pipeline_tsv):
    phase(9, "bootstrap ASR on the 10,240-row pipeline output")
    import re

    from linearham_tpu_torch.postprocess.bootstrap_asr import \
        run_bootstrap_asr
    from linearham_tpu_torch.utils.synth import write_family_fasta

    fasta = write_family_fasta(files.yaml_path, tmp)
    with open(fasta) as fh:          # one ">name" line, one sequence line
        lines = fh.read().split()
    seqs = dict(zip((name[1:] for name in lines[0::2]), lines[1::2]))
    times = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_bootstrap_asr(pipeline_tsv, fasta, ASR_BURNIN,
                                ASR_SUBSAMPLE, 0,
                                output_base=os.path.join(tmp, f"asr_{dev}"),
                                device=dev)
        torch.cuda.synchronize()
        times[dev] = time.perf_counter() - t0
        if dev == "cuda":
            cuda_res = res
    n = len(cuda_res.annotated_trees)
    print(f"ASR: {n} trees, card {times['cuda']:.3f}s (f64), CPU "
          f"{times['cpu']:.3f}s (f64, same call)")
    check(n == ASR_TREES, f"{n} annotated trees, want {ASR_TREES}")
    node = re.compile(r'([^(),:\[\]]*)\[&ancestral="([^"]*)"\]')
    n_internal = 0
    for row, line in zip(cuda_res.rows, cuda_res.annotated_trees):
        for label, anc in node.findall(line):
            if label:
                want = row["NaiveSequence"] if label == "naive" \
                    else seqs[label]
                check(anc == want, f"tip {label} not kept verbatim")
            else:
                n_internal += 1
                check(set(anc) <= set("ACGT"), "internal sequence not ACGT")
    print(f"{n_internal} internal sequences all in ACGT; every tip verbatim")
    for ext in (".log", ".ess"):
        with open(os.path.join(tmp, f"asr_cuda{ext}"), "rb") as a, \
                open(os.path.join(tmp, f"asr_cpu{ext}"), "rb") as b:
            check(a.read() == b.read(), f"{ext} differs between card and CPU")
    print(".log and .ess byte-identical between the card and the CPU")
    return times["cuda"]


def repertoire(torch, tmp, files):
    phase(10, "mixed-depth repertoire: one kernel launch per bucket")
    import numpy as np

    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.ops.forward import forward
    from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                         run_repertoire)
    from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
    from linearham_tpu_torch.tools import pruning_ab
    from linearham_tpu_torch.utils import profiling
    from linearham_tpu_torch.utils.synth import (load_tree_samples,
                                                 write_repertoire_inputs)

    t0 = time.perf_counter()
    reps = write_repertoire_inputs(os.path.join(tmp, "repertoire"),
                                   pruning_ab.REPERTOIRE, seed=0)
    igh, igk = reps["igh"], reps["igk"]
    n_igh = sum(n for loc, _, n, _ in pruning_ab.REPERTOIRE if loc == "igh")
    print(f"inputs written (untimed) in {time.perf_counter() - t0:.1f}s: "
          f"{len(igh.families)} igh families ({n_igh} trees), "
          f"{len(igk.families)} igk")

    # The CLI, cold: a fresh family cache, a fresh process.
    cache = os.path.join(tmp, "repertoire_cache")
    env = {**os.environ, "LINEARHAM_FAMILY_CACHE": cache, "PYTHONPATH": REPO}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "linearham_tpu_torch.cli", "repertoire",
         "--families", igh.manifest, "--hmm-param-dir", igh.gene_dir,
         "--num-rates", "4", "--profile", "--device", "cuda"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    cli_wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli repertoire failed:\n"
                                f"{proc.stderr[-3000:]}")
    print(f"cli repertoire: rc 0, subprocess wall {cli_wall:.1f}s")
    print(f"  {proc.stdout.strip()}")
    for line in proc.stderr.splitlines():
        if line.startswith("#"):
            print(f"  {line}")
    check(proc.stdout.startswith(f"repertoire ok: {len(igh.families)} "
                                 f"families, {n_igh} trees in "),
          "cli repertoire closing line")
    cli_launches = int(proc.stderr.split(
        "# pruning-kernel launches: ")[1].split()[0])
    check(cli_launches == 1, f"cli repertoire: {cli_launches} launches")
    for fam_files, out, (_, _, n, _) in zip(igh.families, igh.outputs,
                                            pruning_ab.REPERTOIRE):
        header, rows = read_tsv(out)
        check(len(rows) == n, f"{out}: {len(rows)} rows, want {n}")
        for c in ("LHLogLikelihood", "LogWeight"):
            i = header.index(c)
            check(all(np.isfinite(float(r[i])) for r in rows),
                  f"{out}: non-finite {c}")
        i = header.index("NaiveSequence")
        check(all(len(r[i]) == fam_files.family.n_sites for r in rows),
              f"{out}: NaiveSequence of the wrong length")
    print(f"every family's TSV has all its rows; LHLogLikelihood and "
          f"LogWeight finite")

    # In process: all 26 families, two buckets.
    os.environ["LINEARHAM_FAMILY_CACHE"] = cache
    tasks = []
    for rep in (igh, igk):
        for fam_files in rep.families:
            tasks.append(FamilyTask(
                hmm=cached_phylo_hmm(fam_files.yaml_path, 0,
                                     fam_files.gene_dir, device="cuda",
                                     dtype=torch.float32),
                samples=load_tree_samples(fam_files.trees_path)))
    n_trees = sum(t.samples.n_samples for t in tasks)
    torch.cuda.synchronize()
    pruning_cuda.launches = 0
    t0 = time.perf_counter()
    with profiling.recording() as timer:
        results = run_repertoire(tasks, num_rates=4, seed=0, device="cuda",
                                 dtype=torch.float32)
    wall = time.perf_counter() - t0
    timings = timer.as_dict()
    launches = pruning_cuda.launches
    check(launches == 2, f"run_repertoire launched {launches} kernels, "
                         "want 2 (one per bucket)")
    stages = {k: round(v, 4) for k, v in timings.items()}
    print(f"run_repertoire: {len(tasks)} families, {n_trees} trees, 2 "
          f"buckets: wall {wall:.3f}s, {n_trees / wall:.1f} trees/s, kernel "
          f"launches {launches}")
    print(f"stages (s): {json.dumps(stages)}")
    for t, r in zip(tasks, results):
        check(r.loglik.shape == (t.samples.n_samples,)
              and bool(np.isfinite(r.loglik).all()),
              "non-finite or missing repertoire log-likelihoods")

    # Against the single-family pipeline on the card.
    shallow, deep, light = 0, 3, len(igh.families)
    for name, f in (("shallowest igh", shallow), ("deepest igh", deep),
                    ("igk", light)):
        t = tasks[f]
        single = run_pipeline_arrays(t.hmm, t.samples, 4,
                                     chunk_size=BENCH["chunk"])
        dll = float(np.abs(results[f].loglik - single.lh_loglik).max())
        print(f"{name} ({t.hmm.xmsa.matrix.shape[0] - 1} seqs, "
              f"{t.samples.n_samples} trees): repertoire vs pipeline "
              f"max|dLHLogLikelihood| {dll:.3e} nats (bound "
              f"{CACHE_LL_BOUND})")
        check(dll <= CACHE_LL_BOUND, f"{name}: repertoire != pipeline")

    def stacked(group, n=None, dtype=torch.float32):
        """Kernel arguments of one stacked launch over the first ``n`` trees
        of each family of ``group``, and each tree's real sites."""
        return pruning_ab.stacked_args([t.hmm for t in group],
                                       [t.samples[:n] for t in group], dtype)

    # A stacked launch of three families (unequal N, rows and X) vs plain.
    k = REPERTOIRE_PLAIN_TREES
    three = [tasks[f] for f in (shallow, deep, light)]
    args, cols = stacked(three, k)
    got = pruning_cuda._launch(*args)
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    print(f"stacked launch, {k} trees x 3 families (N {args[4].shape[1]}, "
          f"n_slots {args[8]}, rows {args[3].shape[0]}, X "
          f"{sorted(set(cols.tolist()))} -> {args[3].shape[1]}): "
          f"max|kernel-plain| {err:.3e}, within {KERNEL_TOL}: {ok}")
    check(ok, f"stacked launch disagrees with plain ({err:.3e})")
    stacked_ms = cuda_ms(torch, lambda: pruning_cuda._launch(*args), 10)
    stacked_plain_ms = cuda_ms(
        torch, lambda: pruning_cuda.site_log_likelihoods_plain(*args), 3)
    print(f"time of that stacked launch: kernel {stacked_ms:.3f} ms, plain "
          f"{stacked_plain_ms:.3f} ms (median, CUDA events)")
    # The same launch in f64: the f64 instantiation against its plain walk.
    args, _ = stacked(three, k, torch.float64)
    got = pruning_cuda._launch(*args)
    want = pruning_cuda.site_log_likelihoods_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, rtol=F64_KERNEL_TOL, atol=F64_KERNEL_TOL)
    print(f"the same stacked launch in f64: max|kernel-plain| {err:.3e}, "
          f"within {F64_KERNEL_TOL}: {ok}")
    check(ok, f"f64 stacked launch disagrees with plain ({err:.3e})")

    # The igh bucket's whole stacked launch against the plain walk, timed
    # in turns with the earlier kernel where present.
    args, cols = stacked(tasks[:len(igh.families)])
    real = float((args[5] != (args[8] - 1) * 4 + 3).double().mean())
    print(f"igh bucket launch: T={args[4].shape[0]}, N={args[4].shape[1]}, "
          f"n_slots {args[8]}, X={args[3].shape[1]}; real entries "
          f"{real:.3f} of the walked ones")
    bucket = in_turns(torch, "igh_bucket_T24565_f32", args, cols)
    del args

    # The deepest family's first trees, f32 repertoire vs plain f64.
    n_ref = REPERTOIRE_F64_TREES
    deep_files = igh.families[deep]
    hmm64, emis = plain_f64_emissions(
        torch, deep_files.yaml_path, deep_files.gene_dir,
        load_tree_samples(deep_files.trees_path)[:n_ref])
    ll64 = forward(hmm64.trans, emis, hmm64.heavy)[0].cpu().numpy()
    dll = float(np.abs(ll64 - results[deep].loglik[:n_ref]).max())
    print(f"deepest family, f32 repertoire vs f64 plain, first {n_ref} "
          f"trees: max|dLHLogLikelihood| {dll:.4e} nats (bound "
          f"{F32_LOGLIK_BOUND})")
    check(dll <= F32_LOGLIK_BOUND, "repertoire f32 error too large")

    # The workflow on the bench family with a pre-placed 1,024-tree
    # ensemble (phase 6's), --cluster-indices 0, twice.
    wf_dir = os.path.join(tmp, "workflow")
    os.makedirs(os.path.join(wf_dir, "cluster_0"))
    shutil.copy(os.path.join(tmp, f"revbayes_{SERVE_TREES}.trees"),
                os.path.join(wf_dir, "cluster_0", "revbayes_run.trees"))
    argv = [sys.executable, "-m", "linearham_tpu_torch.workflow", "--outdir",
            wf_dir, "--partis-yaml-file", files.yaml_path, "--hmm-param-dir",
            files.gene_dir, "--cluster-indices", "0", "--device", "cuda"]
    wf_launches = None
    for run in ("first", "second"):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              cwd=REPO, timeout=600)
        print(f"workflow, {run} run: rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f}s")
        check(proc.returncode == 0, f"workflow failed:\n"
                                    f"{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            print(f"  {line}")
        if run == "first":
            check("batching 1 clusters" in proc.stdout,
                  "the workflow did not batch its pipeline")
            wf_launches = int(proc.stdout.split(
                " pruning-kernel launch")[0].rsplit(" ", 1)[1])
            check(wf_launches == 1, f"workflow: {wf_launches} launches")
        else:
            check("running" not in proc.stdout,
                  "the second workflow run was not up to date")
    out = os.path.join(wf_dir, "cluster_0")
    _, rows = read_tsv(os.path.join(out, "lh_revbayes_run.trees"))
    check(len(rows) == SERVE_TREES, f"workflow pipeline: {len(rows)} rows")
    for name in ("linearham_run.trees", "linearham_run.log",
                 "linearham_run.ess", "linearham_annotations_best.yaml",
                 "aa_naive_seqs.fasta", "aa_naive_seqs.dnamap"):
        check(os.path.exists(os.path.join(out, name)),
              f"workflow did not write {name}")
    print("workflow artifacts present; the second run was up to date")
    families = [(f.yaml_path, f.gene_dir, f.trees_path)
                for rep in (igh, igk) for f in rep.families]
    return launches, wf_launches, cli_launches, dict(
        tasks=tasks, results=results, cache=cache, families=families,
        bucket=bucket)


def naive_digest(result):
    """One hash of a family's sampled naive sequences, in tree order."""
    import hashlib

    return hashlib.sha1("\n".join(a.naive_seq for a in result.annotations)
                        .encode()).hexdigest()


def share_site_ll_matches(torch, mesh, buckets, dtype):
    """Whether every row of this rank's stacked launch over its share of
    each bucket is bitwise equal to the same tree's row of one launch over
    the whole bucket (``buckets``: lists of whole-family blocks; 4 rates,
    run_repertoire's default)."""
    from linearham_tpu_torch.models.step import Prepared, launch, stack_blocks
    from linearham_tpu_torch.parallel.mesh import shard_family_batch

    def site_ll(blocks):
        inputs = stack_blocks([Prepared.of(b.task.hmm, b.task.samples[b.trees],
                                           4) for b in blocks]).to_device(
            mesh.device, dtype)
        return launch(inputs), inputs.stacked

    for blocks in buckets:
        share = shard_family_batch(mesh, blocks)
        if not share:
            continue
        whole, st_whole = site_ll(blocks)
        part, st_part = site_ll(share)
        at = {b.index: f for f, b in enumerate(blocks)}
        for f, b in enumerate(share):
            start = st_whole.trees(at[b.index]).start
            cols = st_part.n_cols[f]
            if not torch.equal(part[st_part.trees(f), :cols],
                               whole[start + b.trees.start:
                                     start + b.trees.stop, :cols]):
                return False
    return True


def mesh_repertoire_rank(devices, payload):
    """One rank of phase 11 (ii): phase 10's families from the warm family
    cache in f32, and a subset of them built afresh in f64, through
    ``run_repertoire`` under each mesh shape of the payload.  The f64 runs
    are held here against this rank's own unsharded f64 run; after each
    run, the kernel's rows of this rank's share are compared bit for bit
    with a launch over each whole bucket."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.parallel.mesh import (FamilyBlock, make_mesh,
                                                   shard_family_batch)
    from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                         buckets_of,
                                                         run_repertoire)
    from linearham_tpu_torch.utils import profiling
    from linearham_tpu_torch.utils.synth import load_tree_samples

    device = devices[dist.get_rank()]
    families = payload["families"]
    out = []
    for dtype, idx in ((torch.float32, range(len(families))),
                       (torch.float64, payload["f64_families"])):
        tasks = [FamilyTask(
            hmm=cached_phylo_hmm(families[i][0], 0, families[i][1],
                                 device=device, dtype=dtype,
                                 cache_dir=payload["cache"]),
            samples=load_tree_samples(families[i][2])) for i in idx]
        alone = run_repertoire(tasks, seed=0, device=device, dtype=dtype) \
            if dtype == torch.float64 else None
        for shape in payload["shapes"]:
            mesh = make_mesh(*shape, devices=devices)
            buckets = [[FamilyBlock(i, tasks[i],
                                    slice(0, tasks[i].samples.n_samples))
                        for i in b] for b in buckets_of(tasks)]
            shares = [shard_family_batch(mesh, b) for b in buckets]
            torch.cuda.synchronize(device)
            dist.barrier()
            pruning_cuda.launches = 0
            t0 = time.perf_counter()
            with profiling.recording() as timer:
                results = run_repertoire(tasks, seed=0, mesh=mesh,
                                         dtype=dtype)
            torch.cuda.synchronize(device)
            wall, launches = time.perf_counter() - t0, pruning_cuda.launches
            timings = timer.as_dict()
            out.append({
                "dtype": str(dtype).removeprefix("torch."), "shape": shape,
                "wall": wall, "gather_s": timings.get("gather", 0.0),
                "timings": timings,
                "launches": launches,
                "expected_launches": sum(1 for share in shares if share),
                "trees": sum(b.n_trees for share in shares for b in share),
                "logliks": [r.loglik for r in results],
                "naive": [naive_digest(r) for r in results],
                "vs_alone": None if alone is None else max(
                    float(np.abs(r.loglik - a.loglik).max())
                    for r, a in zip(results, alone)),
                "site_ll_bitwise": share_site_ll_matches(torch, mesh,
                                                         buckets, dtype)})
    return out


def mesh_on_the_card(torch, rep):
    phase(11, "the (fam, trees) mesh on the card")
    import numpy as np
    import torch.distributed as dist

    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.parallel import multihost
    from linearham_tpu_torch.parallel.dryrun import (dryrun_multigpu,
                                                     free_port, launch_ranks)
    from linearham_tpu_torch.parallel.mesh import make_mesh
    from linearham_tpu_torch.parallel.repertoire import run_repertoire
    from linearham_tpu_torch.utils import profiling

    tasks, want = rep["tasks"], rep["results"]
    want_naive = [naive_digest(r) for r in want]

    def max_dll(logliks):
        return max(float(np.abs(a - w.loglik).max())
                   for a, w in zip(logliks, want))

    # (i) An NCCL group of one in this process.  The communicator is set
    # up at the first collective: one small gather does that untimed.
    t0 = time.perf_counter()
    multihost.initialize(init_method=f"tcp://localhost:{free_port()}",
                         world_size=1, rank=0, backend="nccl")
    try:
        mesh = make_mesh(1, 1)
        dist.all_gather_object([None], 0, group=mesh.mesh_group)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        pruning_cuda.launches = 0
        t0 = time.perf_counter()
        with profiling.recording() as timer:
            got = run_repertoire(tasks, seed=0, mesh=mesh,
                                 dtype=torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        in_process = pruning_cuda.launches
        timings = timer.as_dict()
    finally:
        dist.destroy_process_group()
    dll = max_dll([r.loglik for r in got])
    same = [naive_digest(r) for r in got] == want_naive
    print(f"(i) NCCL group of one, mesh (1, 1) on {mesh.device}: group and "
          f"communicator set-up {setup:.3f}s; wall {wall:.3f}s, "
          f"{in_process} launches, gather "
          f"{timings.get('gather', 0.0):.4f}s; "
          f"vs no mesh: max|dLHLogLikelihood| {dll:.3e} nats, samples "
          f"identical: {same}")
    check(in_process == 2, f"(i): {in_process} launches, want 2")
    check(dll <= MESH_LL_BOUND and same, "(i): the mesh of one differs")

    # (ii) Two gloo ranks sharing cuda:0: the dry run, then the repertoire.
    t0 = time.perf_counter()
    dry = dryrun_multigpu(2, backend="gloo", devices=["cuda:0"] * 2,
                          timeout=300)
    print(f"(ii) dryrun_multigpu(2, gloo, cuda:0 x 2): "
          f"{time.perf_counter() - t0:.1f}s as two subprocesses")
    t0 = time.perf_counter()
    ranks = launch_ranks(2, "chip_smoke:mesh_repertoire_rank", {
        "cache": rep["cache"], "families": rep["families"],
        "f64_families": MESH_F64_FAMILIES, "shapes": [(2, 1), (1, 2)]},
        backend="gloo", devices=["cuda:0"] * 2, timeout=600)
    print(f"two ranks on cuda:0: {len(tasks)} families in f32 and "
          f"{len(MESH_F64_FAMILIES)} in f64 (built cold), each under (2, 1) "
          f"then (1, 2): {time.perf_counter() - t0:.1f}s as two subprocesses")
    rank_launches = sum(r["launches"] for runs in ranks for r in runs)
    for rank, runs in enumerate(ranks):
        for r in runs:
            stages = {k: round(v, 4) for k, v in r["timings"].items()}
            where = f"rank {rank}, {r['dtype']}, mesh {r['shape']}"
            if r["dtype"] == "float32":
                dll = max_dll(r["logliks"])
                rel = max(float(np.abs(a / w.loglik - 1).max())
                          for a, w in zip(r["logliks"], want))
                same = r["naive"] == want_naive
                versus = (f"vs phase 10: max|d| {dll:.3e} nats, max rel "
                          f"{rel:.3e} (bound {MESH_F32_RTOL}), samples "
                          f"identical: {same}")
                check(rel <= MESH_F32_RTOL, f"{where}: rel {rel:.3e}")
                check(same or r["shape"][1] > 1,
                      f"{where}: samples differ under a families-only mesh")
            else:
                versus = (f"vs the unsharded f64 run: max|d| "
                          f"{r['vs_alone']:.3e} nats (bound {MESH_LL_BOUND})")
                check(r["vs_alone"] <= MESH_LL_BOUND,
                      f"{where}: |d| {r['vs_alone']:.3e} nats")
            print(f"  {where}: {r['trees']} trees of its own, wall "
                  f"{r['wall']:.3f}s, gather {r['gather_s']:.3f}s "
                  f"({r['gather_s'] / r['wall']:.1%} of the wall), launches "
                  f"{r['launches']} (non-empty bucket shares "
                  f"{r['expected_launches']}); {versus}; kernel rows "
                  f"bitwise equal to the whole bucket's launch: "
                  f"{r['site_ll_bitwise']}; stages (s) {json.dumps(stages)}")
            check(r["launches"] == r["expected_launches"],
                  f"{where}: {r['launches']} launches")
            check(r["site_ll_bitwise"],
                  f"{where}: the kernel's rows of a share differ from the "
                  "whole bucket's launch")

    # (iii) NCCL over several GPUs, one process each.
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        multi = dryrun_multigpu(min(n_gpu, 4), backend="nccl", timeout=300)
        rank_launches += sum(r["launches"] for r in multi["reports"])
    else:
        print("(iii) NCCL over several GPUs: not run, this machine has one "
              "GPU")
    dry_launches = sum(r["launches"] for r in dry["reports"])
    return in_process + rank_launches + dry_launches


# Phase 13's runs of linearham_tpu_torch.tools.bench, one fresh process
# each: every mode; the pipeline at the full bench unit; the igk pipeline
# and the mixed repertoire cut to keep the phase short (the repertoire's
# first 4 igh families and both igk ones: still two buckets).
BENCH_RUNS = (("pipeline",),
              ("pipeline", "--locus", "igk", "--trees", "2048"),
              ("step",), ("repertoire", "--mixed", "--fams", "4"),
              ("repertoire_step",), ("depth312",), ("f32_weights",),
              ("probe",), ("ensemble", "--reps", "1"))
# Runs a module as ``python -m`` would, then prints on stderr's last line
# the modules of jax and of the JAX package that the process loaded.
RUN_MODULE = (
    "import json, runpy, sys\n"
    "module, sys.argv = sys.argv[1], sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    if e.code:\n"
    "        raise\n"
    "print(json.dumps([m for m in sys.modules if m in ('jax', "
    "'linearham_tpu') or m.startswith(('jax.', 'jaxlib', "
    "'linearham_tpu.'))]), file=sys.stderr)\n")


def start_module(module, args, cwd):
    """``python -m module args`` started in a fresh process (through
    RUN_MODULE)."""
    return subprocess.Popen(
        [sys.executable, "-c", RUN_MODULE, module, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=cwd,
        env={**os.environ, "PYTHONPATH": REPO})


def finish_module(proc, timeout):
    """The stdout of a process from ``start_module``; fails when it failed
    or loaded jax or the JAX package, and kills it when it overran."""
    name = " ".join(proc.args[3:])
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"{name} failed:\n{err[-3000:]}")
    foreign = json.loads(err.strip().splitlines()[-1])
    check(not foreign, f"{name} loaded {foreign[:5]}")
    return out


def finite_numbers(value):
    """Whether every number in a parsed JSON value is finite (and no value
    is null)."""
    import math

    if isinstance(value, dict):
        return all(finite_numbers(v) for v in value.values())
    if isinstance(value, list):
        return all(finite_numbers(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return value is not None


def tools_and_mains(tmp, files, smi):
    phase(13, "the measurement tool and the post-processing mains, as "
              "fresh processes")
    t_phase = time.perf_counter()
    launches = 0
    for args in BENCH_RUNS:
        t0 = time.perf_counter()
        out = finish_module(start_module("linearham_tpu_torch.tools.bench",
                                         args, REPO), 900)
        wall = time.perf_counter() - t0
        line = json.loads(out.strip().splitlines()[-1])
        name = " ".join(args)
        check(line["device"] == smi, f"bench {name}: device {line['device']}")
        check(finite_numbers(line), f"bench {name}: a value is not finite")
        for part in (line, line.get("pipeline", {})):
            if "n_rows" in part:
                check(part["n_rows"] == part["n_trees"],
                      f"bench {name}: {part['n_rows']} rows")
        launches += line["kernel_launches"]
        print(f"bench {name}: {wall:.1f}s as a process; {line['metric']} "
              f"{line['value']} {line['unit']}, {line['kernel_launches']} "
              f"kernel launches")
        print(f"  {json.dumps(line)}")
    bench_s = time.perf_counter() - t_phase

    # The five mains on phase 9's bootstrap outputs and phase 4's files, as
    # fresh processes while the same functions run in this process
    # (relative output names: the files name them).
    from linearham_tpu_torch.postprocess import (annotations, lineage_probs,
                                                 naive_probs, parse_cluster,
                                                 revbayes_config)

    t0 = time.perf_counter()
    asr = os.path.join(tmp, "asr_cuda")
    fasta = os.path.join(tmp, "cluster_seqs.fasta")
    cluster = os.path.join(tmp, "cluster.yaml")
    with open(fasta) as fh:
        seed_seq = fh.read().split()[2][1:]    # the first member's name
    rev = ["--mcmc-iter", "1000", "--mcmc-thin", "10", "--tune-iter", "500",
           "--tune-thin", "100", "--num-rates", "4", "--seed", "0"]
    mains = [
        (parse_cluster, [files.yaml_path, "--yaml-output-file", "c.yaml",
                         "--fasta-output-file", "c.fasta", "--cluster-index",
                         "0"]),
        (revbayes_config, ["--fasta-path", fasta, *rev, "--output-path",
                           "run.rev"]),
        (naive_probs, [asr + ".trees", "--output-base", "naive"]),
        (annotations, [cluster, asr + ".log", "--output-base", "ann"]),
        # Last: it reads naive_probs' naive.fasta.
        (lineage_probs, [asr + ".trees", "naive.fasta", "--seed-seq",
                         seed_seq, "--pfilters", "0.1", "0.5",
                         "--output-base", "lineage"]),
    ]
    dirs = {k: os.path.join(tmp, "mains", k) for k in ("process", "cli")}
    cwd = os.getcwd()
    for d in dirs.values():
        os.makedirs(d)
    procs = [start_module(mod.__name__, argv, dirs["cli"])
             for mod, argv in mains[:-1]]
    try:
        os.chdir(dirs["process"])
        for mod, argv in mains:
            check(mod.main(argv) == 0, f"{mod.__name__}.main failed")
        for proc in procs:
            finish_module(proc, 300)
        mod, argv = mains[-1]
        procs.append(start_module(mod.__name__, argv, dirs["cli"]))
        finish_module(procs[-1], 300)
    finally:
        os.chdir(cwd)
        for proc in procs:
            proc.kill()
    got = {d: {f.name: f.read_bytes()
               for f in sorted(Path(dirs[d]).iterdir())} for d in dirs}
    check(len(got["cli"]) >= 10 and got["cli"] == got["process"],
          "the mains' files differ from the in-process functions' files")
    print(f"the five mains as python -m: {len(got['cli'])} files, "
          f"byte-equal to the in-process functions'; "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f}s (the tool's runs "
          f"{bench_s:.1f}s)")
    return launches


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        # The lineage tables order tied counts by set iteration, which
        # follows str hashing: phase 13 holds the mains' files written by
        # fresh processes byte-equal to this process's, so every process
        # of the run takes one hash seed.
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__),
                                   *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    import torch

    sys.path.insert(0, REPO)
    smi = environment(torch)
    build()
    worst, plain_ms, shapes = kernel_vs_plain(torch)
    worst64, f64_plain_ms, shapes["bench_T4096_f64"] = kernel_vs_plain_f64(
        torch)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        launches, files, f64_launches = pipeline(torch, tmp)
        hit_tsv, _ = family_cache(torch, tmp, files)
        serve_launches = warmup_and_serve(torch, tmp, files)
        map_launches, _ = viterbi_through_kernel(torch, tmp, files)
        golden_launches, one_seq_launches = goldens(torch)
        f64_launches += golden_launches
        bootstrap_asr(torch, tmp, files, hit_tsv)
        rep_launches, wf_launches, cli_launches, rep = repertoire(
            torch, tmp, files)
        mesh_launches = mesh_on_the_card(torch, rep)
        shapes["igh_bucket_T24565_f32"] = rep["bucket"]
        bench_launches = tools_and_mains(tmp, files, smi)
    phase(12, "result")
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    check(not jax_mods, f"the port loaded jax: {jax_mods[:5]}")
    ref_mods = sorted(m for m in sys.modules if m == "linearham_tpu"
                      or m.startswith("linearham_tpu."))
    check(not ref_mods, f"the port loaded the JAX package: {ref_mods[:5]}")
    print(smi)

    def ms_of(shape, build="new"):
        times = shapes[shape]["builds"][build]["ms"]
        return sorted(times)[len(times) // 2]

    bench, bench64 = shapes["bench_T4096_f32"], shapes["bench_T4096_f64"]
    print(json.dumps({"kernels": [{
        "name": "felsenstein_pruning",
        "route": "cuda",
        "source": "linearham_tpu_torch/csrc/pruning.cu",
        "replaces": "linearham_tpu/ops/pruning_pallas.py:84",
        "launches": launches,
        "launches_by_path": {"pipeline": launches, "map": map_launches,
                             "serve": serve_launches,
                             "repertoire": rep_launches,
                             "repertoire_cli": cli_launches,
                             "workflow": wf_launches,
                             "mesh": mesh_launches,
                             "f64": f64_launches,
                             "one_sequence": one_seq_launches,
                             "bench": bench_launches},
        "max_abs_err": worst,
        "ms": ms_of("bench_T4096_f32"),
        "plain_ms": plain_ms,
        "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"],
        "library_ms": None,
        "flop": bench["flop"],
        "f64_max_abs_err": worst64,
        "f64_ms": ms_of("bench_T4096_f64"),
        "f64_plain_ms": f64_plain_ms,
        "f64_bound_ms": bench64["bound_ms"],
        "shapes": {name: {"ms": ms_of(name), "bound_ms": r["bound_ms"],
                          "share_of_bound": r["builds"]["new"]
                          ["share_of_bound"],
                          "baseline_ms": ms_of(name, "baseline")
                          if "baseline" in r["builds"] else None}
                   for name, r in shapes.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
