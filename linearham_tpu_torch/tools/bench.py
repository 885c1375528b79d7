"""The port's measurement tool: one run, one JSON line.

    python -m linearham_tpu_torch.tools.bench MODE [--device cpu]
        [--trees T] [--seqs S] [--chunk C] [--locus igh|igk] [--reps R]
        [--fams F] [--mixed]

The counterpart of the JAX package's ``bench.py`` and ``tools/bench_312.py``,
``tools/bench_f32_weights.py``, ``tools/bench_ensemble.py`` and
``tools/probe_compile.py``, at their sizes by default:

  pipeline         ``run_pipeline`` file to file: 10,240 trees x 100
                   sequences, chunk 4096, 4 rates (``--locus igk``: the
                   light-chain family); its stages, the share of the wall
                   the drain waited on the device, trees/s over that wait.
  step             the device step alone (pruning + emissions + forward +
                   FFBS), 4096 trees x 10 sequences: median of ``--reps``,
                   split into the pruning launch and the rest.
  repertoire       F families x T trees file to file through
                   ``run_repertoire`` + ``write_family_output`` (32 x 320,
                   10 sequences); ``--mixed``: ``pruning_ab.REPERTOIRE``
                   (26 families, 2 buckets; ``--fams`` keeps the first F of
                   each locus, ``--trees`` caps each ensemble).
  repertoire_step  the stacked device step alone, 8 families x 256 trees.
  depth312         ``pruning_ab.FAMILY_312``: f32 (the kernel) against the
                   plain f64 path on the same device over 8 trees, the
                   step at T = chunk (512), the pipeline at 1,024 trees.
  f32_weights      1,024 trees of ``FAMILY_312`` in f32 and f64: per-tree
                   |d|, importance-weight ESS, the weighted bootstrap
                   subsample's overlap, the naive posteriors' L1.
  ensemble         the pipeline at T = 1,024 in fresh processes (``--reps``
                   runs, every run kept) and twice in one, at 10 T, and
                   8 x T through ``cli repertoire``; each fresh process
                   reports its imports and device start-up on their own.
  probe            a cold family build stage by stage (100 sequences), then
                   a first and a second step of one 4096-tree chunk.

Every family is built cold: the family cache lies in the run's temporary
directory (``ensemble``'s fresh processes share one, so its first run is
cold and the others warm).  Input files are written before the clock
starts.  ``device`` in the line is the card's name and power limit as
``nvidia-smi`` prints them, or "cpu"; ``kernel_launches`` counts the
pruning kernel's launches (0 on the CPU, where the plain walk runs).
Without a GPU the tool raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from linearham_tpu_torch.ops import pruning_cuda
from linearham_tpu_torch.tools.pruning_ab import FAMILY_312, REPERTOIRE
from linearham_tpu_torch.utils.runtime import (card_identity,
                                               resolve_device,
                                               resolve_dtype)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NUM_RATES = 4
SUBSAMP_FRAC = 0.05   # the reference's default (SConstruct:78-124)
BOUND_TREES = 8       # tools/bench_312.py's f32-vs-f64 sample
# Modules no process of the port may load.
FOREIGN = "[m for m in sys.modules if m in ('jax', 'linearham_tpu') " \
          "or m.startswith(('jax.', 'jaxlib', 'linearham_tpu.'))]"


# -- helpers ---------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, reps: int, device: torch.device) -> float:
    """Median milliseconds of ``fn()`` after one warm-up call: CUDA events
    on a card, the host clock on the CPU."""
    if device.type == "cuda":
        from linearham_tpu_torch.tools.pruning_ab import cuda_ms

        return cuda_ms(fn, reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


@contextlib.contextmanager
def _family_cache(path: str):
    """The family cache at ``path`` for the block (a cold build)."""
    old = os.environ.get("LINEARHAM_FAMILY_CACHE")
    os.environ["LINEARHAM_FAMILY_CACHE"] = path
    try:
        yield
    finally:
        if old is None:
            del os.environ["LINEARHAM_FAMILY_CACHE"]
        else:
            os.environ["LINEARHAM_FAMILY_CACHE"] = old


def _model(fam, device, dtype):
    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    return PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                               fam.genes, fam.msa, fam.unique_ids,
                               fam.n_sites, device=device, dtype=dtype)


def _write_inputs(outdir: str, fam, n_trees: int, yaml_seed: int,
                  tree_seed: int):
    """(partis YAML, germline directory, RevBayes TSV) of ``fam``."""
    from linearham_tpu_torch.io.germline import write_gene_dir
    from linearham_tpu_torch.utils.synth import (make_tree_samples,
                                                 write_partis_yaml,
                                                 write_trees_tsv)

    os.makedirs(outdir, exist_ok=True)
    gene_dir = os.path.join(outdir, "hmm_params")
    write_gene_dir(fam.genes, gene_dir)
    yaml_path = os.path.join(outdir, "partis_run.yaml")
    write_partis_yaml(fam, yaml_path, seed=yaml_seed)
    trees_path = os.path.join(outdir, "revbayes_run.trees")
    write_trees_tsv(make_tree_samples(fam, n_trees, seed=tree_seed),
                    trees_path)
    return yaml_path, gene_dir, trees_path


def _check_rows(path: str, want: int) -> int:
    """The rows of a pipeline TSV, which must be ``want``; raises on a
    non-finite LHLogLikelihood or LogWeight."""
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        cols = [header.index("LHLogLikelihood"), header.index("LogWeight")]
        n = 0
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if not all(np.isfinite(float(fields[c])) for c in cols):
                raise RuntimeError(f"{path}: a non-finite value in row {n}")
            n += 1
    if n != want:
        raise RuntimeError(f"{path}: {n} rows, want {want}")
    return n


def _pipeline_run(yaml_path, gene_dir, trees_path, out_tsv, n_trees, chunk,
                  device) -> dict:
    """``run_pipeline`` file to file: wall, trees/s and stages."""
    from linearham_tpu_torch.pipeline.run import run_pipeline

    _sync(device)
    t0 = time.perf_counter()
    result = run_pipeline(yaml_path, 0, gene_dir, trees_path, out_tsv,
                          num_rates=NUM_RATES, seed=0, chunk_size=chunk,
                          device=device)
    wall = time.perf_counter() - t0
    stages = dict(result.timings)
    out = {"n_trees": n_trees, "chunk": chunk, "wall_s": wall,
           "trees_per_sec": n_trees / wall, "stages": stages,
           "n_rows": _check_rows(out_tsv, n_trees),
           "device_frac": stages["device_step"] / wall}
    if stages["device_step"] > 0:
        out["device_trees_per_sec"] = n_trees / stages["device_step"]
    return out


def _time_step(hmm, samples, reps, device) -> dict:
    """One batched device step over ``samples`` (``models.step``): the
    host prep and copy, the first call, then the median step (with its
    results' copies to the host) and pruning launch (ms)."""
    from linearham_tpu_torch.models.step import (Prepared, launch,
                                                 stack_blocks, step_blocks)

    t0 = time.perf_counter()
    prepared = Prepared.of(hmm, samples, NUM_RATES)
    host_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs = stack_blocks([prepared]).to_device(hmm.device, hmm.dtype)
    _sync(device)
    transfer = time.perf_counter() - t0
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    ((loglik, _, _),) = step_blocks(inputs, [gen])
    _sync(device)
    first = time.perf_counter() - t0
    if not bool(torch.isfinite(loglik).all()):
        raise RuntimeError("the step gave a non-finite log-likelihood")
    step_ms = _median_ms(lambda: step_blocks(inputs, [gen]), reps, device)
    prune_ms = _median_ms(lambda: launch(inputs), reps, device)
    return {"n_trees": samples.n_samples, "step_ms": step_ms,
            "trees_per_sec": samples.n_samples / step_ms * 1e3,
            "pruning_ms": prune_ms, "rest_ms": step_ms - prune_ms,
            "first_step_s": first, "host_prepare_s": host_prep,
            "transfer_s": transfer, "reps": reps,
            "mean_loglik": float(loglik.double().mean())}


# -- tools/bench_f32_weights.py's statistics (same numpy streams) ------------

def softmax(lw):
    e = np.exp(lw - lw.max())
    return e / e.sum()


def ess(w):
    return float(w.sum() ** 2 / (w * w).sum())


def weighted_subsample_no_replacement(w, k, seed):
    """The R sample(prob=w, replace=FALSE) semantics: successive draws
    from the renormalized remaining weights."""
    rng = np.random.default_rng(seed)
    w = w.copy()
    out = []
    for _ in range(k):
        p = w / w.sum()
        i = rng.choice(len(w), p=p)
        out.append(i)
        w[i] = 0.0
    return np.asarray(out)


# -- modes -------------------------------------------------------------------

def pipeline_mode(a, device, tmp):
    from linearham_tpu_torch.utils.synth import make_family, make_light_family

    maker = make_light_family if a.locus == "igk" else make_family
    files = _write_inputs(tmp, maker(n_seqs=a.seqs, seed=0), a.trees, 0, 0)
    run = _pipeline_run(*files, os.path.join(tmp, "lh_revbayes_run.trees"),
                        a.trees, a.chunk, device)
    return {"metric": "pipeline_end_to_end_trees_per_sec",
            "value": run.pop("trees_per_sec"), "unit": "trees/s",
            "n_seqs": a.seqs, "locus": a.locus, **run}


def step_mode(a, device, tmp):
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=a.seqs, seed=0)
    hmm = _model(fam, device, resolve_dtype(None, device))
    step = _time_step(hmm, make_tree_samples(fam, a.trees, seed=0), a.reps,
                      device)
    return {"metric": "device_step_trees_per_sec",
            "value": step.pop("trees_per_sec"), "unit": "trees/s",
            "n_seqs": a.seqs, "n_sites": fam.n_sites,
            "xmsa_cols": hmm.xmsa.n_cols, **step}


def repertoire_mode(a, device, tmp):
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.io.trees_tsv import load_tree_samples
    from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                         buckets_of,
                                                         run_repertoire,
                                                         write_family_output)
    from linearham_tpu_torch.utils import profiling
    from linearham_tpu_torch.utils.synth import (make_family,
                                                 make_tree_samples,
                                                 write_repertoire_inputs,
                                                 write_trees_tsv)

    if a.mixed:
        specs, kept = [], {}
        for locus, n_seqs, n_trees, rate in REPERTOIRE:
            kept[locus] = kept.get(locus, 0) + 1
            if a.fams is None or kept[locus] <= a.fams:
                specs.append((locus, n_seqs, min(n_trees, a.trees or n_trees),
                              rate))
        reps = write_repertoire_inputs(tmp, specs, seed=0)
        families = [(f.yaml_path, f.gene_dir, f.trees_path, out)
                    for rep in reps.values()
                    for f, out in zip(rep.families, rep.outputs)]
    else:
        # One family structure (one bucket), a different ensemble each.
        fam = make_family(n_seqs=a.seqs, seed=0)
        yaml_path, gene_dir, _ = _write_inputs(tmp, fam, 1, 0, 0)
        families = []
        for f in range(a.fams):
            trees = os.path.join(tmp, f"fam{f:04d}.trees")
            write_trees_tsv(make_tree_samples(fam, a.trees, seed=f), trees)
            families.append((yaml_path, gene_dir, trees,
                             os.path.join(tmp, f"lh_fam{f:04d}.trees")))

    dtype = resolve_dtype(None, device)
    stages = {}
    _sync(device)
    t_wall = time.perf_counter()
    t0 = time.perf_counter()
    hmms = [cached_phylo_hmm(y, 0, g, seed=0, device=device, dtype=dtype)
            for y, g, _, _ in families]
    stages["build_hmm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tasks = [FamilyTask(hmm=h, samples=load_tree_samples(f[2]))
             for h, f in zip(hmms, families)]
    stages["load_trees_tsv"] = time.perf_counter() - t0
    with profiling.recording() as timer:
        results = run_repertoire(tasks, num_rates=NUM_RATES, seed=0,
                                 device=device, dtype=dtype)
    stages.update(timer.as_dict())
    t0 = time.perf_counter()
    for task, res, f in zip(tasks, results, families):
        write_family_output(task, res, NUM_RATES, f[3])
    stages["write_tsv"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_wall
    total = sum(t.samples.n_samples for t in tasks)
    n_rows = sum(_check_rows(f[3], t.samples.n_samples)
                 for t, f in zip(tasks, families))
    return {"metric": "repertoire_end_to_end_trees_per_sec",
            "value": total / wall, "unit": "trees/s", "wall_s": wall,
            "stages": stages, "decode_frac": stages["decode"] / wall,
            "mixed": a.mixed, "n_fams": len(tasks),
            "n_buckets": len(buckets_of(tasks)), "n_trees": total,
            "n_rows": n_rows}


def repertoire_step_mode(a, device, tmp):
    from linearham_tpu_torch.models.step import (Prepared, stack_blocks,
                                                 step_blocks)
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    dtype = resolve_dtype(None, device)
    fam = make_family(n_seqs=a.seqs, seed=0)
    hmm = _model(fam, device, dtype)
    samples = [make_tree_samples(fam, a.trees, seed=f) for f in range(a.fams)]
    inputs = stack_blocks([Prepared.of(hmm, s, NUM_RATES)
                           for s in samples]).to_device(device, dtype)
    _sync(device)
    gens = [torch.Generator(device=device).manual_seed(f)
            for f in range(a.fams)]

    def step():
        """One stacked launch, then each family's post-pruning step."""
        return step_blocks(inputs, gens)

    t0 = time.perf_counter()
    first = step()
    _sync(device)
    first_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(ll).all()) for ll, _, _ in first):
        raise RuntimeError("the stacked step gave a non-finite value")
    step_ms = _median_ms(step, a.reps, device)
    total = a.fams * a.trees
    return {"metric": "repertoire_step_trees_per_sec",
            "value": total / step_ms * 1e3, "unit": "trees/s",
            "n_fams": a.fams, "n_trees": total, "n_seqs": a.seqs,
            "step_ms": step_ms, "first_step_s": first_s, "reps": a.reps}


def depth312_mode(a, device, tmp):
    from linearham_tpu_torch.tools.pruning_ab import ensemble_args
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    family = dict(FAMILY_312, n_seqs=a.seqs)
    fam = make_family(**family)
    hmm32 = _model(fam, device, torch.float32)
    hmm64 = _model(fam, device, torch.float64)

    # f32 through the kernel against the plain f64 path, same device.
    bound_trees = make_tree_samples(fam, BOUND_TREES, seed=19)
    a32 = ensemble_args(hmm32, bound_trees, NUM_RATES)
    a64 = ensemble_args(hmm64, bound_trees, NUM_RATES)
    site32 = pruning_cuda.site_log_likelihoods(*a32)
    site64 = pruning_cuda.site_log_likelihoods_plain(*a64)
    ll32 = hmm32.step_from_site_ll(site32, a32[1], None)[0]
    ll64 = hmm64.step_from_site_ll(site64, a64[1], None)[0]
    site32, site64 = site32.double().cpu().numpy(), site64.cpu().numpy()
    ll32, ll64 = ll32.double().cpu().numpy(), ll64.cpu().numpy()
    if not np.array_equal(np.isfinite(site32), np.isfinite(site64)):
        raise RuntimeError("f32 and f64 disagree on which sites are finite")
    finite = np.isfinite(site64)
    site_abs = np.abs(site32 - site64)[finite]
    ll_abs = np.abs(ll32 - ll64)
    bound = {"n_trees": BOUND_TREES, "site_abs_max": float(site_abs.max()),
             "site_abs_p99": float(np.percentile(site_abs, 99)),
             "loglik_abs_max": float(ll_abs.max()),
             "loglik_rel_max": float((ll_abs / np.abs(ll64)).max()),
             "ref_loglik_mean": float(ll64.mean())}

    step = _time_step(hmm32, make_tree_samples(fam, a.chunk, seed=20),
                      a.reps, device)
    files = _write_inputs(os.path.join(tmp, "pipeline"), fam, a.trees, 19,
                          21)
    pipeline = _pipeline_run(*files, os.path.join(tmp, "lh.trees"), a.trees,
                             a.chunk, device)
    return {"metric": "312seq_step_trees_per_sec",
            "value": step["trees_per_sec"], "unit": "trees/s",
            "n_seqs": a.seqs, "n_sites": fam.n_sites,
            "xmsa_cols": hmm32.xmsa.n_cols, "n_trees": a.trees,
            "loglik_rel_max": bound["loglik_rel_max"], "bound": bound,
            "step": step, "pipeline": pipeline}


def _logliks(hmm, samples, chunk, plain):
    """Per-tree log-likelihoods (f64 numpy) in chunks, through the kernel
    (``plain=False``; the plain walk on the CPU) or the plain walk."""
    from linearham_tpu_torch.models.step import (Prepared, launch,
                                                 stack_blocks)

    ensemble = Prepared.of(hmm, samples, NUM_RATES)
    out = np.zeros(samples.n_samples)
    for start in range(0, samples.n_samples, chunk):
        rows = slice(start, min(start + chunk, samples.n_samples))
        inputs = stack_blocks([ensemble.rows(rows)]).to_device(hmm.device,
                                                               hmm.dtype)
        site_ll = pruning_cuda.site_log_likelihoods_plain(*inputs.args) \
            if plain else launch(inputs)
        ll = hmm.step_from_site_ll(site_ll, inputs.pi, None)[0]
        out[rows] = ll.double().cpu().numpy()
    return out


def f32_weights_mode(a, device, tmp):
    from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(**dict(FAMILY_312, n_seqs=a.seqs))
    samples = make_tree_samples(fam, a.trees, seed=23)
    hmm32 = _model(fam, device, torch.float32)
    ll32 = _logliks(hmm32, samples, 512, plain=False)
    ll64 = _logliks(_model(fam, device, torch.float64), samples, 256,
                    plain=True)

    d = ll32 - ll64
    centered = d - d.mean()
    # The synthetic TSV's RBLogLikelihood is unrelated to the HMM's, which
    # makes the ESS 1 in both types; RevBayes scores nearly the same model,
    # so emulate a spread of a few nats: rb = loglik_f64 + N(0, 2).
    rng = np.random.default_rng(11)
    rb = ll64 + rng.normal(0.0, 2.0, size=ll64.shape)
    w32, w64 = softmax(ll32 - rb), softmax(ll64 - rb)
    k = max(1, int(round(SUBSAMP_FRAC * len(ll32))))
    sub32 = weighted_subsample_no_replacement(w32, k, seed=7)
    sub64 = weighted_subsample_no_replacement(w64, k, seed=7)
    sub64b = weighted_subsample_no_replacement(w64, k, seed=8)

    def overlap(x, y):
        return len(set(x.tolist()) & set(y.tolist())) / k

    # The same sampled annotations (one FFBS draw a tree, f32) weighed
    # both ways: the naive-sequence posterior's distortion alone.
    res = run_pipeline_arrays(hmm32, samples, num_rates=NUM_RATES, seed=0,
                              chunk_size=512)
    post32, post64 = {}, {}
    for ann, x, y in zip(res.annotations, w32, w64):
        post32[ann.naive_seq] = post32.get(ann.naive_seq, 0.0) + x
        post64[ann.naive_seq] = post64.get(ann.naive_seq, 0.0) + y
    keys = set(post32) | set(post64)
    return {"metric": "f32_vs_f64_ess_ratio", "value": ess(w32) / ess(w64),
            "unit": "ratio", "n_seqs": a.seqs, "n_trees": len(ll32),
            "loglik_abs_diff": {"max": float(np.abs(d).max()),
                                "mean": float(np.abs(d).mean()),
                                "systematic_mean": float(d.mean())},
            "centered_diff": {
                "max": float(np.abs(centered).max()),
                "p99": float(np.percentile(np.abs(centered), 99)),
                "std": float(centered.std())},
            "ess": {"f64": ess(w64), "f32": ess(w32)},
            "bootstrap_k": k,
            "bootstrap_overlap_frac": overlap(sub32, sub64),
            "bootstrap_overlap_control_f64_seed_change":
                overlap(sub64, sub64b),
            "topk_by_weight_overlap": overlap(np.argsort(w32)[-k:],
                                              np.argsort(w64)[-k:]),
            "naive_posterior_l1": sum(abs(post32.get(s, 0.0)
                                          - post64.get(s, 0.0))
                                      for s in keys),
            "n_unique_naive": len(keys)}


def _fresh(body: str, device, cache: str) -> dict:
    """Run ``body`` in a fresh interpreter: its import time, its device
    start-up, the walls it appends to ``walls``, its kernel launches, and
    the whole process's wall as this process sees it."""
    code = (
        "import json, sys, time\n"
        "t0 = time.perf_counter()\n"
        "import torch\n"
        "from linearham_tpu_torch.ops import pruning_cuda\n"
        "from linearham_tpu_torch.pipeline.run import run_pipeline\n"
        "from linearham_tpu_torch.cli import main\n"
        "import_s = time.perf_counter() - t0\n"
        f"device = torch.device({str(device)!r})\n"
        "t0 = time.perf_counter()\n"
        "torch.zeros(1, device=device).sum().item()\n"
        "device_init_s = time.perf_counter() - t0\n"
        "walls = []\n"
        f"{body}"
        "print(json.dumps({'import_s': import_s, 'device_init_s': "
        "device_init_s, 'walls': walls, 'launches': pruning_cuda.launches, "
        f"'foreign': {FOREIGN}}}))\n")
    env = {**os.environ, "LINEARHAM_FAMILY_CACHE": cache,
           "PYTHONPATH": os.pathsep.join(
               [REPO, *filter(None, [os.environ.get("PYTHONPATH")])])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=REPO, env=env)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"a fresh process failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["foreign"]:
        raise RuntimeError(f"a fresh process loaded {out['foreign'][:5]}")
    del out["foreign"]
    return {**out, "process_s": process_s}


def _single_family(tmp, cache, n_seqs, n_trees, reps, device) -> dict:
    """tools/bench_ensemble.py's single_family: ``reps`` fresh processes,
    then one process that runs the pipeline twice (its second wall)."""
    from linearham_tpu_torch.utils.synth import make_family

    d = os.path.join(tmp, f"single_{n_trees}")
    yaml_path, gene_dir, trees = _write_inputs(
        d, make_family(n_seqs=n_seqs, seed=0), n_trees, 0, 100)
    # The CLI's 256-tree chunks for small ensembles, 4096 for large ones.
    chunk = min(n_trees, 4096) if n_trees > 2048 else 256

    def script(out_tsv, n_calls):
        return (f"for _ in range({n_calls}):\n"
                "    t0 = time.perf_counter()\n"
                f"    run_pipeline({yaml_path!r}, 0, {gene_dir!r}, {trees!r},"
                f" {out_tsv!r}, num_rates={NUM_RATES}, seed=0, "
                f"chunk_size={chunk}, device=device)\n"
                "    walls.append(time.perf_counter() - t0)\n")

    runs = []
    for r in range(reps):
        out_tsv = os.path.join(d, f"lh_{r}.trees")
        runs.append(_fresh(script(out_tsv, 1), device, cache))
        _check_rows(out_tsv, n_trees)
    out_tsv = os.path.join(d, "lh_inproc.trees")
    steady = _fresh(script(out_tsv, 2), device, cache)
    _check_rows(out_tsv, n_trees)
    for run in runs + [steady]:
        run["wall_s"] = run.pop("walls")[-1]
        run["trees_per_sec"] = n_trees / run["wall_s"]
    return {"n_trees": n_trees, "chunk": chunk, "runs": runs,
            "best_trees_per_sec": max(r["trees_per_sec"] for r in runs),
            "in_process_steady": steady}


def _multi_family(tmp, cache, n_seqs, n_fams, n_trees, reps, device):
    """tools/bench_ensemble.py's multi_family: ``n_fams`` ensembles of one
    family (several RevBayes chains) through ``cli repertoire``, each run
    a fresh process."""
    from linearham_tpu_torch.utils.synth import (make_family,
                                                 make_tree_samples,
                                                 write_trees_tsv)

    d = os.path.join(tmp, "repertoire")
    fam = make_family(n_seqs=n_seqs, seed=0)
    yaml_path, gene_dir, _ = _write_inputs(d, fam, 1, 0, 100)
    manifest = os.path.join(d, "families.tsv")
    outs = []
    with open(manifest, "w") as fh:
        for f in range(n_fams):
            trees = os.path.join(d, f"rb_chain{f}.trees")
            write_trees_tsv(make_tree_samples(fam, n_trees, seed=200 + f),
                            trees)
            outs.append(os.path.join(d, f"lh_fam{f}.trees"))
            fh.write(f"{yaml_path}\t0\t{trees}\t{outs[-1]}\n")
    argv = ["repertoire", "--families", manifest, "--hmm-param-dir",
            gene_dir, "--num-rates", str(NUM_RATES), "--seed", "0",
            "--device", str(device)]
    body = ("t0 = time.perf_counter()\n"
            f"assert main({argv!r}) == 0\n"
            "walls.append(time.perf_counter() - t0)\n")
    runs = []
    for _ in range(reps):
        for o in outs:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(o)
        run = _fresh(body, device, cache)
        for o in outs:
            _check_rows(o, n_trees)
        run["wall_s"] = run.pop("walls")[-1]
        run["trees_per_sec"] = n_fams * n_trees / run["wall_s"]
        runs.append(run)
    return {"n_fams": n_fams, "n_trees_per_fam": n_trees, "runs": runs,
            "best_trees_per_sec": max(r["trees_per_sec"] for r in runs)}


def ensemble_mode(a, device, tmp):
    cache = os.path.join(tmp, "family_cache")
    more = max(1, a.reps - 1)   # at the default, tools/bench_ensemble.py's
    single = _single_family(tmp, cache, a.seqs, a.trees, a.reps, device)
    large = _single_family(tmp, cache, a.seqs, 10 * a.trees, more, device)
    rep = _multi_family(tmp, cache, a.seqs, 8, a.trees, more, device)
    launches = sum(r["launches"] for part in (single, large)
                   for r in part["runs"] + [part["in_process_steady"]]) \
        + sum(r["launches"] for r in rep["runs"])
    return {"metric": f"ensemble_{a.trees}_trees_per_sec",
            "value": single["best_trees_per_sec"], "unit": "trees/s",
            "n_seqs": a.seqs, "n_trees": a.trees, "single": single,
            "single_10x": large, "repertoire": rep,
            "repertoire_aggregate": rep["best_trees_per_sec"],
            "child_kernel_launches": launches}


def probe_mode(a, device, tmp):
    from linearham_tpu_torch.compiler.compiled import compile_family
    from linearham_tpu_torch.compiler.state_space import build_state_space
    from linearham_tpu_torch.compiler.xmsa import build_xmsa
    from linearham_tpu_torch.io import native
    from linearham_tpu_torch.io.germline import load_gene_map
    from linearham_tpu_torch.io.partis import load_cluster
    from linearham_tpu_torch.models.phylo_hmm import (PhyloHMM,
                                                      gather_consts,
                                                      place_consts)
    from linearham_tpu_torch.models.step import (Prepared, stack_blocks,
                                                 step_blocks)
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    dtype = resolve_dtype(None, device)
    fam = make_family(n_seqs=a.seqs, seed=0)
    yaml_path, gene_dir, _ = _write_inputs(tmp, fam, 1, 0, 0)
    samples = make_tree_samples(fam, a.chunk, seed=0)
    stages = {}

    def t(name, fn):
        t0 = time.perf_counter()
        r = fn()
        _sync(device)
        stages[name] = time.perf_counter() - t0
        return r

    t("device_init", lambda: torch.zeros(1, device=device).sum().item())
    lib = t("native_load", native._load)
    cluster = t("load_cluster", lambda: load_cluster(yaml_path, 0))
    genes = t("load_gene_map", lambda: load_gene_map(gene_dir))
    space = t("build_state_space", lambda: build_state_space(
        cluster.locus, cluster.flexbounds, cluster.relpos, genes))
    family = t("compile_family", lambda: compile_family(space, genes))
    msa = cluster.msa_codes(next(iter(genes.values())).alphabet + "N")
    xmsa = t("build_xmsa", lambda: build_xmsa(space, msa,
                                              cluster.unique_ids))
    consts_np = t("gather_consts", lambda: gather_consts(space, xmsa))
    trans_np = t("host_transitions",
                 lambda: family.host_transitions(np.float64))
    placed = t("h2d_copy", lambda: (
        {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
         for k, v in trans_np.items()},
        place_consts(consts_np, xmsa.n_cols, device, dtype)))
    tensors = [*placed[0].values(),
               *(v for parts in placed[1].values() for v in parts.values())]
    const_bytes = sum(v.numel() * v.element_size() for v in tensors)
    hmm = t("full_build_hmm", lambda: PhyloHMM(yaml_path, 0, gene_dir,
                                               device=device, dtype=dtype))
    if device.type == "cuda":
        t("kernel_load", pruning_cuda.kernel_lib)
    prepared = t("host_prepare", lambda: Prepared.of(hmm, samples,
                                                      NUM_RATES))
    inputs = t("launch_inputs", lambda: stack_blocks(
        [prepared]).to_device(device, dtype))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for name in ("first_step", "second_step"):
        loglik = t(name, lambda: step_blocks(inputs, [gen])[0][0])
        if not bool(torch.isfinite(loglik).all()):
            raise RuntimeError(f"{name}: a non-finite log-likelihood")
    return {"metric": "cold_family_build_s", "value": stages["full_build_hmm"],
            "unit": "s", "n_seqs": a.seqs, "n_trees": a.chunk,
            "chunk": a.chunk, "stages": stages, "const_bytes": const_bytes,
            "native_library": "none" if lib is None else lib._name,
            "xmsa_shape": list(xmsa.matrix.shape)}


# Each mode and the flags it takes, with their defaults (the JAX tools').
MODES = {
    "pipeline": (pipeline_mode, dict(trees=10240, seqs=100, chunk=4096,
                                     locus="igh")),
    "step": (step_mode, dict(trees=4096, seqs=10, reps=5)),
    "repertoire": (repertoire_mode, dict(fams=32, trees=320, seqs=10,
                                         mixed=False)),
    "repertoire_step": (repertoire_step_mode, dict(fams=8, trees=256, seqs=8,
                                                   reps=5)),
    "depth312": (depth312_mode, dict(seqs=FAMILY_312["n_seqs"], trees=1024,
                                     chunk=512, reps=3)),
    "f32_weights": (f32_weights_mode, dict(seqs=FAMILY_312["n_seqs"],
                                           trees=1024)),
    "ensemble": (ensemble_mode, dict(seqs=100, trees=1024, reps=3)),
    "probe": (probe_mode, dict(seqs=100, chunk=4096)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linearham_tpu_torch.tools.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (a GPU is required), "
                         "'cpu' for a run on the CPU")
    ap.add_argument("--trees", type=int)
    ap.add_argument("--seqs", type=int)
    ap.add_argument("--chunk", type=int)
    ap.add_argument("--locus", choices=["igh", "igk"])
    ap.add_argument("--reps", type=int)
    ap.add_argument("--fams", type=int)
    ap.add_argument("--mixed", action="store_true", default=None)
    a = ap.parse_args(argv)
    fn, defaults = MODES[a.mode]
    for flag in ("trees", "seqs", "chunk", "locus", "reps", "fams", "mixed"):
        if getattr(a, flag) is not None and flag not in defaults:
            ap.error(f"{a.mode} takes no --{flag}")
    if a.mode == "repertoire" and a.mixed:
        defaults = dict(defaults, fams=None, trees=None)
    for flag, value in defaults.items():
        if getattr(a, flag) is None:
            setattr(a, flag, value)

    device = torch.empty(0, device=resolve_device(a.device)).device
    pruning_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp, \
            _family_cache(os.path.join(tmp, "family_cache")):
        out = fn(a, device, tmp)
    out["kernel_launches"] = pruning_cuda.launches \
        + out.pop("child_kernel_launches", 0)
    out["precision"] = str(resolve_dtype(None, device)).split(".")[1]
    out["device"] = card_identity() if device.type == "cuda" else "cpu"
    print(json.dumps({"mode": a.mode, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
