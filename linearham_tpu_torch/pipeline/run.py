"""The batched posterior-ensemble pipeline, in torch.

Counterpart of linearham_tpu/pipeline/run.py.  The reference walks the
RevBayes TSV one tree at a time (src/PhyloHMM.cpp:393-446); here the
ensemble runs in chunks, each chunk ONE device step (pruning + emissions +
forward + FFBS for every tree at once).  The main thread prepares chunk k's
host inputs and enqueues its pinned, non-blocking copies and its step
without waiting for the device; one drain thread waits for each chunk's
results in order, decodes its annotations and streams its rows to the
output TSV.

Output columns match the reference contract exactly
(src/PhyloHMM.cpp:244-327).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, TextIO

import numpy as np
import torch

from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
from linearham_tpu_torch.io.newick import batch_trees, parse_newick
from linearham_tpu_torch.io.schedule import build_schedule
from linearham_tpu_torch.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu_torch.models.decode import Annotation
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.ops.ffbs import SampledPath, path_to_numpy
from linearham_tpu_torch.ops.gtr import gamma_category_rates_batch, gtr_eigen
from linearham_tpu_torch.utils.fileio import atomic_write
from linearham_tpu_torch.utils.profiling import StageTimer
from linearham_tpu_torch.utils.runtime import resolve_dtype

_COMMENT_RE = re.compile(r"\[[^\]]*\]")


@dataclass
class PipelineResult:
    """Per-sample pipeline outputs for one clonal family."""

    samples: TreeSamples
    rates: np.ndarray            # [T, R]
    lh_loglik: np.ndarray        # [T]
    logweight: np.ndarray        # [T]
    annotations: List[Annotation]
    timings: Optional[dict] = None  # stage -> seconds


def prepare_ensemble(hmm: PhyloHMM, samples: TreeSamples, num_rates: int,
                     rates: Optional[np.ndarray] = None):
    """Host-side ensemble prep: parse and schedule every tree, gamma rates
    (unless given), GTR eigenfactors.  Returns (PruningSchedule, GTREigen
    numpy, rates).

    The whole ensemble is parsed at once (one native batch call), so every
    chunk shares one schedule width and slot count.
    """
    from linearham_tpu_torch.io.native import parse_newicks_batch

    tb = parse_newicks_batch(samples.newicks, hmm.xmsa.labels)
    if tb is None:   # no native library: the Python parser, on the host
        tb = batch_trees([parse_newick(nw) for nw in samples.newicks],
                         hmm.xmsa.labels)
    if rates is None:
        rates = gamma_category_rates_batch(samples.alpha, num_rates)
    return build_schedule(tb), gtr_eigen(samples.er, samples.pi), rates


def _to_host(loglik: torch.Tensor, path: SampledPath):
    """Start the device->host copies of one chunk's results.  Returns
    (loglik, path, done): ``done()`` blocks until the copies landed."""
    if loglik.device.type != "cuda":
        return loglik, path, lambda: None
    host = [None if a is None else a.to("cpu", non_blocking=True)
            for a in (loglik, *path)]
    event = torch.cuda.Event()
    event.record()
    return host[0], SampledPath(*host[1:]), event.synchronize


def _drain_chunk(hmm, timer, logliks, annotations, start, n, loglik_h,
                 path_h, done, on_chunk=None) -> None:
    """Wait for one chunk's results, decode its annotations, and hand them
    to ``on_chunk(start, n, logliks, annotations)``."""
    with timer.stage("device_step"):
        done()
    with timer.stage("decode"):
        loglik_np = loglik_h.numpy().astype(np.float64)
        logliks[start:start + n] = loglik_np
        anns = hmm.decode_batch(path_to_numpy(path_h))
        annotations.extend(anns)
    if on_chunk is not None:
        on_chunk(start, n, loglik_np, anns)


def run_pipeline_arrays(
    hmm: PhyloHMM,
    samples: TreeSamples,
    num_rates: int,
    seed: int = 0,
    chunk_size: int = 256,
    on_chunk=None,
    rates: Optional[np.ndarray] = None,
    max_chunks: Optional[int] = None,
    trace_dir: Optional[str] = None,
) -> PipelineResult:
    """Run the whole ensemble through the device step, chunk by chunk.

    ``on_chunk(start, n_valid, logliks, annotations)`` (optional) fires as
    each chunk drains, in order, so the output can be streamed.  ``rates``
    [T, R] are the gamma rates if the caller already has them.
    ``max_chunks`` stops after that many chunks (the warmup path): shapes
    still come from the whole ensemble, and the results cover only the
    rows run.  ``trace_dir`` writes a torch.profiler trace of the chunk
    loop there (see ``_maybe_trace``).
    """
    timer = StageTimer()
    T = samples.n_samples
    chunk_size = max(1, min(chunk_size, T))
    generator = torch.Generator(device=hmm.device)
    generator.manual_seed(seed)

    with timer.stage("host_prepare"):
        sched, eig, rates = prepare_ensemble(hmm, samples, num_rates, rates)

    starts = list(range(0, T, chunk_size))[:max_chunks]
    logliks = np.zeros(T)
    annotations: List[Annotation] = []
    futures = []
    with _maybe_trace(trace_dir, hmm.device), \
            ThreadPoolExecutor(1) as drain_pool:
        for start in starts:
            idx = np.arange(start, min(start + chunk_size, T))
            with timer.stage("device_transfer"):
                inputs = hmm.ensemble_inputs(sched, eig, samples.pi, rates,
                                             idx, non_blocking=True)
            with timer.stage("dispatch"):
                loglik, _, path = hmm.step(*inputs, generator, sched.n_slots)
                host = _to_host(loglik, path)
            futures.append(drain_pool.submit(
                _drain_chunk, hmm, timer, logliks, annotations, start,
                len(idx), *host, on_chunk=on_chunk))
        for f in futures:
            f.result()   # propagate drain errors; also the tail barrier

    return PipelineResult(
        samples=samples, rates=rates, lh_loglik=logliks,
        logweight=logliks - samples.rb_loglik, annotations=annotations,
        timings=timer.as_dict())


@contextlib.contextmanager
def _maybe_trace(trace_dir: Optional[str], device: torch.device):
    """A torch.profiler trace (CPU activity, plus CUDA kernels on a CUDA
    device) of the block, written as a Chrome trace JSON file into
    ``trace_dir``; a no-op without a directory.  The counterpart of
    linearham_tpu/utils/profiling.py:maybe_trace."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"pipeline.{os.getpid()}.{time.time_ns()}.trace.json"))


def write_tsv_header(num_rates: int, heavy: bool, outfile: TextIO) -> None:
    """Write the reference-format pipeline TSV header row."""
    cols = (
        ["Iteration", "RBLogLikelihood", "Prior", "alpha"]
        + [f"er[{i}]" for i in range(1, 7)]
        + [f"pi[{i}]" for i in range(1, 5)]
        + ["tree"]
        + [f"sr[{i}]" for i in range(1, num_rates + 1)]
        + ["LHLogLikelihood", "LogWeight", "NaiveSequence",
           "VGene", "V5pDel", "V3pDel", "VFwkInsertion"]
    )
    if heavy:
        cols += ["VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion"]
    else:
        cols += ["VJInsertion"]
    cols += ["JGene", "J5pDel", "J3pDel", "JFwkInsertion"]
    outfile.write("\t".join(cols) + "\n")


def write_tsv_rows(samples: TreeSamples, rates, lh_loglik, logweight,
                   annotations, start: int, n: int, heavy: bool,
                   outfile: TextIO) -> None:
    """Write rows [start, start+n) of the pipeline TSV.

    ``samples`` and ``rates`` cover the whole ensemble; ``lh_loglik``,
    ``logweight`` and ``annotations`` are the chunk's own (index 0 is row
    ``start``).
    """
    if len(annotations) != n:
        raise ValueError(f"chunk arrays must have length {n}, "
                         f"got {len(annotations)}")
    s = samples
    for t in range(start, start + n):
        i = t - start
        ann = annotations[i]
        row = (
            [s.iteration[t], s.rb_loglik[t], s.prior[t], s.alpha[t]]
            + list(s.er[t]) + list(s.pi[t])
            + [_COMMENT_RE.sub("", s.newicks[t])]
            + list(rates[t])
            + [lh_loglik[i], logweight[i], ann.naive_seq,
               ann.vgerm_state, ann.v_5p_del, ann.v_3p_del,
               ann.v_fwk_insertion]
        )
        if heavy:
            row += [ann.vd_insertion, ann.dgerm_state, ann.d_5p_del,
                    ann.d_3p_del, ann.dj_insertion]
        else:
            row += [ann.vd_insertion]
        row += [ann.jgerm_state, ann.j_5p_del, ann.j_3p_del,
                ann.j_fwk_insertion]
        outfile.write("\t".join(str(v) for v in row) + "\n")


def run_pipeline(
    yaml_path: str,
    cluster_ind: int,
    hmm_param_dir: str,
    input_path: str,
    output_path: str,
    num_rates: int,
    seed: int = 0,
    chunk_size: int = 256,
    profile: bool = False,
    precision: Optional[str] = None,
    device=None,
    trace_dir: Optional[str] = None,
) -> PipelineResult:
    """End-to-end: partis YAML + RevBayes TSV -> linearham output TSV.

    ``device``: None means CUDA (raises without one); name "cpu" for the
    CPU conformance path.  ``precision``: f32, f64, or None/auto (f32 on
    CUDA, f64 on the CPU).  The family is built through the family disk
    cache (compiler/family_cache.py).  Rows are streamed to a temp file
    that is renamed into place only on success, so a crash leaves no
    partial TSV.  ``trace_dir``: see ``run_pipeline_arrays``.
    """
    t0 = time.perf_counter()
    samples = load_tree_samples(input_path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hmm = cached_phylo_hmm(yaml_path, cluster_ind, hmm_param_dir, seed=seed,
                           device=device,
                           dtype=resolve_dtype(precision, device))
    build_s = time.perf_counter() - t0

    rates = gamma_category_rates_batch(samples.alpha, num_rates)
    heavy = hmm.heavy
    write_s = [0.0]
    with atomic_write(output_path) as fh:
        write_tsv_header(num_rates, heavy, fh)

        def on_chunk(start, n, loglik, anns):
            t0 = time.perf_counter()
            lw = loglik - samples.rb_loglik[start:start + n]
            write_tsv_rows(samples, rates, loglik, lw, anns, start, n,
                           heavy, fh)
            write_s[0] += time.perf_counter() - t0

        result = run_pipeline_arrays(hmm, samples, num_rates, seed=seed,
                                     chunk_size=chunk_size,
                                     on_chunk=on_chunk, rates=rates,
                                     trace_dir=trace_dir)
    result.timings["build_hmm"] = build_s
    result.timings["load_trees_tsv"] = load_s
    result.timings["write_tsv"] = write_s[0]
    if profile:
        total = sum(result.timings.values())
        print(f"# pipeline timings ({samples.n_samples} trees, "
              f"{total * 1e3:.0f}ms total):", file=sys.stderr)
        for k, v in result.timings.items():
            print(f"#   {k}: {v * 1e3:.1f}ms", file=sys.stderr)
    return result
