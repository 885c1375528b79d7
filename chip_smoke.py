#!/usr/bin/env python3
"""Smoke run of the PyTorch port (linearham_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code and no
result line; nothing is caught and passed over):

1. Environment: torch / CUDA / nvcc / triton / yaml versions and the card's
   name and power limit.  A CUDA device is required.
2. Build the pruning kernel (csrc/pruning.cu) from the checkout with nvcc.
3. Kernel vs its plain torch version on the card, in f32, at the main
   path's shapes: a 100-sequence family at T=4096, R=4; R=1 with every
   branch length 0 (no NaN, impossible sites hugely negative); an all-N
   tip row; a 312-sequence family at T=64.  Both are timed at the first
   shape (CUDA events, median of several launches).
4. The posterior-ensemble pipeline file to file at bench scale (igh,
   100 sequences, 10,240 trees, 4 rates, chunk 4096) through the port's
   run_pipeline, with the kernel's launch count read around it; then the
   first 512 trees through the plain f64 path on the card for the f32
   error bound, and a timed device step split into pruning vs the rest.
5. The result lines: the nvidia-smi line, the kernels JSON line, and the
   {"ok": true, ...} line last.  Before them the script checks that nothing
   it ran loaded jax: the port's synthetic inputs come through
   linearham_tpu_torch.utils.synth, the port's door to the JAX package's
   numpy-only host modules.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 5e-4          # rtol = atol, kernel vs plain, both f32
F32_LOGLIK_BOUND = 1.0     # nats, f32 pipeline vs f64 plain path
BENCH = dict(n_seqs=100, n_trees=10240, chunk=4096, num_rates=4)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)


def environment(torch):
    phase(1, "environment")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from linearham_tpu_torch.utils.cuda_build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"nvcc: {nvcc[-1]}")
    for mod in ("triton", "yaml"):
        print(f"import {mod}: "
              f"{'yes' if importlib.util.find_spec(mod) else 'no'}")
    print(f"device: {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}  nvidia-smi: {smi}")
    return smi


def build():
    phase(2, "build the pruning kernel")
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.utils.cuda_build import build_library

    t0 = time.perf_counter()
    lib = build_library("pruning")
    pruning_cuda._kernel_lib()
    print(f"built {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0:.2f}s")
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(
        ".log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def family_batch(torch, n_seqs, n_trees, num_rates, seed):
    """(hmm f32 on cuda, schedule, eig, pi, rates) for a synthetic family."""
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.pipeline.run import prepare_ensemble
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=n_seqs, seed=seed)
    hmm = PhyloHMM.from_parts(
        fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
        fam.unique_ids, fam.n_sites, device="cuda", dtype=torch.float32)
    samples = make_tree_samples(fam, n_trees, seed=seed)
    sched, eig, rates = prepare_ensemble(hmm, samples, num_rates)
    return hmm, sched, eig, samples.pi, rates


def kernel_args(hmm, sched, eig, pi, rates, idx=None):
    s, eig_t, pi_t, rates_t = hmm.ensemble_inputs(sched, eig, pi, rates, idx)
    return [eig_t, pi_t, rates_t, hmm.xmsa_rows, s["sched_src"],
            s["sched_penc"], s["sched_len"], s["sched_root"], sched.n_slots]


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

    hmm, sched, eig, pi, rates = family_batch(
        torch, BENCH["n_seqs"], 4096, BENCH["num_rates"], seed=0)
    main_args = kernel_args(hmm, sched, eig, pi, rates)
    sub = kernel_args(hmm, sched, eig, pi, rates, idx=slice(0, 64))

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
    h312, s312, e312, p312, r312 = family_batch(torch, 312, 64, 4, seed=1)
    cases = {
        "100seq_T4096_R4": main_args,
        "R1_zero_branches": zero,
        "all_N_tip": all_n,
        "312seq_T64_R4": kernel_args(h312, s312, e312, p312, r312),
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

    from linearham_tpu_torch.ops import pruning_cuda

    ms = cuda_ms(torch, lambda: pruning_cuda._launch(*main_args), 20)
    plain_ms = cuda_ms(torch, lambda: site_log_likelihoods_plain(*main_args),
                       5)
    print(f"time at 100seq T=4096 R=4 (X={hmm.xmsa.n_cols}, "
          f"N={sched.n_entries}, n_slots={sched.n_slots}): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events)")
    return worst, ms, plain_ms


def pipeline(torch):
    phase(4, "pipeline file to file")
    from linearham_tpu_torch.models.phylo_hmm import (
        PhyloHMM, naive_prior_correction, region_emissions)
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.ops.forward import forward
    from linearham_tpu_torch.pipeline.run import (prepare_ensemble,
                                                  run_pipeline)
    from linearham_tpu_torch.utils.synth import (load_tree_samples,
                                                 write_pipeline_inputs)

    n_trees, chunk = BENCH["n_trees"], BENCH["chunk"]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
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
        hmm64 = PhyloHMM(yaml_path, 0, gene_dir, device="cuda",
                         dtype=torch.float64)
        sub = load_tree_samples(trees_path)[:n_ref]
        sched, eig, rates = prepare_ensemble(hmm64, sub, BENCH["num_rates"])
        s, eig_t, pi_t, rates_t = hmm64.ensemble_inputs(sched, eig, sub.pi,
                                                        rates)
        site_ll = pruning_cuda.site_log_likelihoods_plain(
            eig_t, pi_t, rates_t, hmm64.xmsa_rows, s["sched_src"],
            s["sched_penc"], s["sched_len"], s["sched_root"], sched.n_slots)
        emis = region_emissions(
            naive_prior_correction(site_ll, pi_t, hmm64.naive_bases),
            hmm64.consts, hmm64.heavy)
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
        sched, eig, rates = prepare_ensemble(hmm32, first, BENCH["num_rates"])
        inputs = hmm32.ensemble_inputs(sched, eig, first.pi, rates)
        gen = torch.Generator(device="cuda")
        step_ms = cuda_ms(torch, lambda: hmm32.step(*inputs, gen,
                                                    sched.n_slots), 5)
        s, eig_t, pi_t, rates_t = inputs
        prune_ms = cuda_ms(torch, lambda: pruning_cuda._launch(
            eig_t, pi_t, rates_t, hmm32.xmsa_rows, s["sched_src"],
            s["sched_penc"], s["sched_len"], s["sched_root"],
            sched.n_slots), 10)
        print(f"device step at T={chunk}: {step_ms:.3f} ms, of which "
              f"pruning kernel {prune_ms:.3f} ms, emissions+forward+FFBS "
              f"{step_ms - prune_ms:.3f} ms (median, CUDA events)")
    return launches


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    smi = environment(torch)
    build()
    worst, ms, plain_ms = kernel_vs_plain(torch)
    launches = pipeline(torch)
    phase(5, "result")
    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib")))
    check(not jax_mods, f"the port loaded jax: {jax_mods[:5]}")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "felsenstein_pruning",
        "route": "cuda",
        "source": "linearham_tpu_torch/csrc/pruning.cu",
        "replaces": "linearham_tpu/ops/pruning_pallas.py:84",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
