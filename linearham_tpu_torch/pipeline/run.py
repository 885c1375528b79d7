"""The batched posterior-ensemble pipeline, in torch.

Counterpart of linearham_tpu/pipeline/run.py.  The reference walks the
RevBayes TSV one tree at a time (src/PhyloHMM.cpp:393-446); here the
ensemble runs in chunks, each chunk ONE device step (pruning + emissions +
forward + FFBS for every tree at once), a one-family launch through
``models.step``, the route every tree batch takes.  The main thread
prepares chunk k's host inputs and enqueues its pinned, non-blocking copies
and its step without waiting for the device; one drain thread waits for
each chunk's results in order, decodes its annotations and streams its rows
to the output TSV.

Output columns match the reference contract exactly
(src/PhyloHMM.cpp:244-327); ``io/output_tsv`` writes them.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
from linearham_tpu_torch.io.output_tsv import write_tsv_header, write_tsv_rows
from linearham_tpu_torch.io.trees_tsv import TreeSamples, load_tree_samples
from linearham_tpu_torch.models.decode import Annotation
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.models.step import Prepared, stack_blocks, step_blocks
from linearham_tpu_torch.ops.ffbs import path_to_numpy
from linearham_tpu_torch.ops.gtr import gamma_category_rates_batch
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.fileio import atomic_write
from linearham_tpu_torch.utils.runtime import resolve_dtype


@dataclass
class PipelineResult:
    """Per-sample pipeline outputs for one clonal family."""

    samples: TreeSamples
    rates: np.ndarray            # [T, R]
    lh_loglik: np.ndarray        # [T]
    logweight: np.ndarray        # [T]
    annotations: List[Annotation]
    timings: Optional[dict] = None   # span name -> seconds
    counters: Optional[dict] = None  # counter name -> count


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
        with timer.stage("write_tsv"):
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
) -> PipelineResult:
    """Run the whole ensemble through the device step, chunk by chunk.

    ``on_chunk(start, n_valid, logliks, annotations)`` (optional) fires as
    each chunk drains, in order, so the output can be streamed.  ``rates``
    [T, R] are the gamma rates if the caller already has them.
    ``max_chunks`` stops after that many chunks (the warmup path): shapes
    still come from the whole ensemble, and the results cover only the
    rows run.

    Spans (``utils.profiling``; the request's recorder where one is active):
    host_prepare, then per chunk device_transfer and dispatch on this
    thread, device_step, decode and write_tsv (around ``on_chunk``) on the
    drain thread, chunk_device on the device (CUDA events from before the
    chunk's first host-to-device copy to its results' landing); then
    drain_wait, this thread's wait for the drain.  Counter: chunks.  The
    drain thread records into the request's recorder too (the writer's
    ``tsv_*_rows`` counters, from ``on_chunk``).
    """
    with profiling.recording() as timer:
        T = samples.n_samples
        chunk_size = max(1, min(chunk_size, T))
        generator = torch.Generator(device=hmm.device)
        generator.manual_seed(seed)

        with timer.stage("host_prepare"):
            ensemble = Prepared.of(hmm, samples, num_rates, rates)

        starts = list(range(0, T, chunk_size))[:max_chunks]
        logliks = np.zeros(T)
        annotations: List[Annotation] = []
        futures = []
        with ThreadPoolExecutor(1) as drain_pool:
            for start in starts:
                rows = slice(start, min(start + chunk_size, T))
                span = profiling.cuda_span("chunk_device", hmm.device)
                with timer.stage("device_transfer"):
                    inputs = stack_blocks([ensemble.rows(rows)]).to_device(
                        hmm.device, hmm.dtype)
                with timer.stage("dispatch"):
                    (host,) = step_blocks(inputs, [generator], span)
                timer.count("chunks")
                # The drain runs in a copy of this thread's context, so
                # the request's recorder is the active one there too.
                futures.append(drain_pool.submit(
                    contextvars.copy_context().run, _drain_chunk, hmm, timer,
                    logliks, annotations, start, rows.stop - start, *host,
                    on_chunk=on_chunk))
            with timer.stage("drain_wait"):
                for f in futures:
                    f.result()   # propagate drain errors; the tail barrier

    return PipelineResult(
        samples=samples, rates=ensemble.rates, lh_loglik=logliks,
        logweight=logliks - samples.rb_loglik, annotations=annotations,
        timings=timer.as_dict(), counters=dict(timer.counters))


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
    partial TSV.  ``trace_dir``: write a torch.profiler trace of the whole
    call there (``utils.profiling.trace``).

    Spans, besides ``run_pipeline_arrays``'s: load_trees_tsv, build_hmm
    (``cached_phylo_hmm``'s spans inside), gamma_rates, open_output and
    rename_output.  ``timings`` and ``counters`` cover the whole call.
    """
    with profiling.recording() as timer, profiling.trace(
            trace_dir, device, timer, "pipeline"):
        with timer.stage("load_trees_tsv"):
            samples = load_tree_samples(input_path)
        with timer.stage("build_hmm"):
            hmm = cached_phylo_hmm(yaml_path, cluster_ind, hmm_param_dir,
                                   seed=seed, device=device,
                                   dtype=resolve_dtype(precision, device))
        with timer.stage("gamma_rates"):
            rates = gamma_category_rates_batch(samples.alpha, num_rates)
        heavy = hmm.heavy
        with contextlib.ExitStack() as output:
            with timer.stage("open_output"):
                fh = output.enter_context(atomic_write(output_path))
                write_tsv_header(num_rates, heavy, fh)

            def on_chunk(start, n, loglik, anns):
                lw = loglik - samples.rb_loglik[start:start + n]
                write_tsv_rows(samples, rates, loglik, lw, anns, start, n,
                               heavy, fh)

            result = run_pipeline_arrays(hmm, samples, num_rates, seed=seed,
                                         chunk_size=chunk_size,
                                         on_chunk=on_chunk, rates=rates)
            with timer.stage("rename_output"):
                output.close()   # the file is whole: rename it into place
    result.timings = timer.as_dict()
    result.counters = dict(timer.counters)
    if profile:
        print(f"# pipeline timings ({samples.n_samples} trees):",
              file=sys.stderr)
        print_profile(result.timings, result.counters)
    return result


def print_profile(timings: dict, counters: dict) -> None:
    """``--profile``'s lines on stderr: ``#   <span>: <ms>ms`` a span name,
    then ``# counters: <JSON>``."""
    for k, v in timings.items():
        print(f"#   {k}: {v * 1e3:.1f}ms", file=sys.stderr)
    print(f"# counters: {json.dumps(counters, sort_keys=True)}",
          file=sys.stderr)
