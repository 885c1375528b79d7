"""Command-line interface of the PyTorch port.

Mirrors linearham_tpu/cli.py and the reference binary's subcommand
contract (src/linearham.cpp:268-455):

  python -m linearham_tpu_torch.cli compute-logl --yaml-path ...
      --cluster-ind 0 --hmm-param-dir ... --newick-path ... --er ...x6
      --pi ...x4 [--alpha A] [--num-rates K] [--seed S]
  python -m linearham_tpu_torch.cli sample       (same, plus --N)
  python -m linearham_tpu_torch.cli pipeline --yaml-path ... --cluster-ind 0
      --hmm-param-dir ... --input-path revbayes.trees --output-path out.tsv
      [--num-rates K] [--seed S] [--chunk-size C] [--profile]
      [--trace-dir DIR]
  python -m linearham_tpu_torch.cli warmup   (pipeline args minus
      --output-path: fills the family cache, builds the kernel, runs one
      chunk)
  python -m linearham_tpu_torch.cli serve    (one JSON pipeline request per
      stdin line, one JSON answer per stdout line)
  python -m linearham_tpu_torch.cli repertoire --families manifest.tsv
      --hmm-param-dir ... [--num-rates K] [--seed S] [--profile]
      [--trace-dir DIR]
      (many families, one pruning-kernel launch per bucket; the manifest
      has one tab-separated line per family:
      yaml_path, cluster_ind, trees_tsv, output_tsv)

Every subcommand also takes ``--device`` (default: CUDA, which must be
present; ``cpu`` runs the f64 conformance path) and ``--precision``.  Both
``--compute-logl`` (reference spelling) and ``compute-logl`` are accepted.
Families are built through the family disk cache
(compiler/family_cache.py; ``LINEARHAM_FAMILY_CACHE=off`` disables it).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

# Keys every serve request must carry; the rest are optional.
SERVE_KEYS = ("yaml_path", "cluster_ind", "hmm_param_dir", "input_path",
              "output_path")


def _device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto",
                   help="compute precision: f32 (production, CUDA pruning "
                        "kernel), f64 (reference-conformance numerics); "
                        "auto = f32 on CUDA, f64 on the CPU")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (a GPU is required), "
                        "'cpu' for the CPU conformance path")


def _base_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--yaml-path", required=True,
                   help="partis output YAML file")
    p.add_argument("--cluster-ind", type=int, required=True,
                   help="index of the clonal family of interest")
    p.add_argument("--hmm-param-dir", required=True,
                   help="directory of partis HMM germline parameter files")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--num-rates", type=int, default=1,
                   help="number of gamma rate categories")
    _device_args(p)


def _trace_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace-dir",
                   help="write a torch.profiler trace of the whole call, "
                        "with the program's spans, (Chrome trace JSON) into "
                        "this directory")


def _phylo_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--newick-path", required=True, help="Newick tree file")
    p.add_argument("--er", type=float, action="append", required=True,
                   help="GTR exchangeability (give 6 times)")
    p.add_argument("--pi", type=float, action="append", required=True,
                   help="GTR stationary probability (give 4 times)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="gamma shape parameter")


def build_parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(
        prog="linearham-tpu-torch",
        description="A phylo-HMM for B cell receptor analysis "
                    "(PyTorch / CUDA).")
    sub = top.add_subparsers(dest="subcommand", required=True)

    p = sub.add_parser("compute-logl",
                       help="compute the Phylo-HMM log-likelihood")
    _base_args(p)
    _phylo_args(p)

    p = sub.add_parser("sample", help="sample naive sequences")
    _base_args(p)
    _phylo_args(p)
    p.add_argument("--N", type=int, default=1,
                   help="number of naive sequences to sample")

    p = sub.add_parser("pipeline", help="run the full pipeline")
    _base_args(p)
    p.add_argument("--input-path", required=True,
                   help="RevBayes output TSV file")
    p.add_argument("--output-path", required=True, help="output TSV file")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall-clock timings to stderr")
    p.add_argument("--chunk-size", type=int, default=256,
                   help="trees per device step (default 256)")
    _trace_arg(p)

    p = sub.add_parser(
        "serve",
        help="long-lived pipeline server: one JSON request per stdin line "
             "({yaml_path, cluster_ind, hmm_param_dir, input_path, "
             "output_path, num_rates?, seed?, chunk_size?, precision?}), "
             "one JSON answer per stdout line; 'quit' ends it")
    _device_args(p)

    p = sub.add_parser(
        "repertoire",
        help="run many families' pipelines in one process: families are "
             "bucketed by junction shape and each bucket's trees go through "
             "one pruning-kernel launch")
    p.add_argument("--families", required=True,
                   help="manifest TSV, one family per line: "
                        "yaml_path<TAB>cluster_ind<TAB>trees_tsv<TAB>"
                        "output_tsv ('#' comments allowed)")
    p.add_argument("--hmm-param-dir", required=True,
                   help="directory of partis HMM germline parameter files")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--num-rates", type=int, default=4,
                   help="number of gamma rate categories")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall-clock timings to stderr")
    _trace_arg(p)
    _device_args(p)

    p = sub.add_parser(
        "warmup",
        help="fill the family cache, build the kernel library, and run one "
             "chunk of the ensemble with the whole ensemble's shapes")
    _base_args(p)
    p.add_argument("--input-path", required=True,
                   help="RevBayes output TSV file (shapes come from all of "
                        "it; only the first chunk runs)")
    p.add_argument("--chunk-size", type=int, default=256,
                   help="chunk size the later pipeline run will use")
    return top


def _validate_gtr(args) -> None:
    if len(args.er) != 6:
        raise SystemExit(f"error: --er must be given 6 times, got "
                         f"{len(args.er)}")
    if len(args.pi) != 4:
        raise SystemExit(f"error: --pi must be given 4 times, got "
                         f"{len(args.pi)}")
    if abs(sum(args.pi) - 1.0) > 1e-6:
        print(f"warning: pi sums to {sum(args.pi):g}; it will be used as "
              "given by the normalized GTR model", file=sys.stderr)


def _serve(args) -> int:
    """Answer pipeline requests from stdin, one JSON object per line.

    A bad request (a missing key, an unreadable file, a malformed value)
    is answered ``{"ok": false, "error": ...}`` and the server goes on.  A
    device failure is not a bad request: it ends the server with exit code
    1, so nothing carries on over a broken CUDA context.
    """
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.pipeline.run import run_pipeline
    from linearham_tpu_torch.utils import profiling
    from linearham_tpu_torch.utils.runtime import (is_device_error,
                                                   resolve_device)

    device = resolve_device(args.device)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        t0 = time.perf_counter()
        launches = pruning_cuda.launches
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("a request must be a JSON object")
            missing = [k for k in SERVE_KEYS if k not in req]
            if missing:
                raise ValueError("request is missing key(s): "
                                 + ", ".join(repr(k) for k in missing))
            with profiling.recording() as timer:
                result = run_pipeline(
                    req["yaml_path"], int(req["cluster_ind"]),
                    req["hmm_param_dir"], req["input_path"],
                    req["output_path"],
                    num_rates=int(req.get("num_rates", 4)),
                    seed=int(req.get("seed", 0)),
                    chunk_size=int(req.get("chunk_size", 256)),
                    precision=req.get("precision", args.precision),
                    device=device)
        except Exception as exc:  # noqa: BLE001 -- the server's boundary
            if is_device_error(exc):
                traceback.print_exc()
                print("serve: device failure; stopping", file=sys.stderr)
                return 1
            print(json.dumps({"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"}),
                  flush=True)
            continue
        print(json.dumps({
            "ok": True,
            "output_path": req["output_path"],
            "n_trees": result.samples.n_samples,
            "wall_s": round(time.perf_counter() - t0, 3),
            "kernel_launches": pruning_cuda.launches - launches,
            "stages": {k: round(v, 6) for k, v in
                       timer.self_times().items()},
            "counters": timer.counters,
        }), flush=True)
    return 0


def _warmup(args, dtype) -> int:
    """Fill the family cache, build the kernel library (on CUDA), and run
    one chunk with the whole ensemble's shapes."""
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.io.trees_tsv import load_tree_samples
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.pipeline.run import run_pipeline_arrays

    t0 = time.perf_counter()
    samples = load_tree_samples(args.input_path)
    hmm = cached_phylo_hmm(args.yaml_path, args.cluster_ind,
                           args.hmm_param_dir, seed=args.seed,
                           device=args.device, dtype=dtype)
    if hmm.device.type == "cuda":
        pruning_cuda.kernel_lib()
    result = run_pipeline_arrays(hmm, samples, args.num_rates,
                                 seed=args.seed, chunk_size=args.chunk_size,
                                 max_chunks=1)
    n = len(result.annotations)
    expected = min(args.chunk_size, samples.n_samples)
    if n != expected:
        raise RuntimeError(f"warmup drained {n} trees, expected {expected}")
    print(f"warmup ok: family cache and kernel ready for "
          f"chunk={args.chunk_size} on {hmm.device} in "
          f"{time.perf_counter() - t0:.1f}s ({n} trees exercised)")
    return 0


def read_manifest(path: str) -> list:
    """The repertoire manifest's (yaml_path, cluster_ind, trees_tsv,
    output_tsv) rows; blank lines and '#' comments are skipped."""
    rows = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split("\t")
            if len(parts) != 4:
                raise SystemExit(
                    f"error: manifest line needs 4 tab-separated "
                    f"fields (yaml, cluster_ind, trees, out): {ln!r}")
            rows.append((parts[0], int(parts[1]), parts[2], parts[3]))
    if not rows:
        raise SystemExit("error: empty family manifest")
    return rows


def _repertoire(args, dtype) -> int:
    """Build every family of the manifest (through the family cache), run
    them with one kernel launch per bucket, and write each family's TSV."""
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.io.trees_tsv import load_tree_samples
    from linearham_tpu_torch.ops import pruning_cuda
    from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                         run_repertoire,
                                                         write_family_output)
    from linearham_tpu_torch.pipeline.run import print_profile
    from linearham_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    rows = read_manifest(args.families)
    gene_maps: dict = {}  # one parse of the germline directory a call
    with profiling.recording() as timer, profiling.trace(
            args.trace_dir, args.device, timer, "repertoire"):
        tasks = []
        for yaml_path, ci, trees, _ in rows:
            with timer.stage("load_trees_tsv"):
                samples = load_tree_samples(trees)
            with timer.stage("build_hmm"):
                hmm = cached_phylo_hmm(yaml_path, ci, args.hmm_param_dir,
                                       seed=args.seed, device=args.device,
                                       dtype=dtype, gene_maps=gene_maps)
            tasks.append(FamilyTask(hmm=hmm, samples=samples))
        results = run_repertoire(tasks, num_rates=args.num_rates,
                                 seed=args.seed, device=args.device,
                                 dtype=dtype)
        with timer.stage("write_tsv"):
            for (_, _, _, out_path), task, res in zip(rows, tasks, results):
                write_family_output(task, res, args.num_rates, out_path)
    wall = time.perf_counter() - t0
    total = sum(t.samples.n_samples for t in tasks)
    if args.profile:
        print_profile(timer.as_dict(), timer.counters)
        print(f"# pruning-kernel launches: {pruning_cuda.launches}",
              file=sys.stderr)
    print(f"repertoire ok: {len(tasks)} families, {total} trees in "
          f"{wall:.2f}s ({total / wall:.1f} trees/s aggregate)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Accept the reference's '--compute-logl' style subcommand spelling.
    if argv and argv[0].startswith("--") and argv[0][2:] in (
            "compute-logl", "sample", "pipeline"):
        argv[0] = argv[0][2:]
    args = build_parser().parse_args(argv)

    if args.subcommand == "serve":
        return _serve(args)

    from linearham_tpu_torch.utils.runtime import resolve_dtype

    dtype = resolve_dtype(args.precision, args.device)
    if args.subcommand == "warmup":
        return _warmup(args, dtype)
    if args.subcommand == "repertoire":
        return _repertoire(args, dtype)
    if args.subcommand == "pipeline":
        from linearham_tpu_torch.pipeline.run import run_pipeline

        run_pipeline(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            args.input_path, args.output_path, args.num_rates,
            seed=args.seed, chunk_size=args.chunk_size,
            profile=args.profile, precision=dtype, device=args.device,
            trace_dir=args.trace_dir)
        return 0

    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm

    _validate_gtr(args)
    hmm = cached_phylo_hmm(args.yaml_path, args.cluster_ind,
                           args.hmm_param_dir, seed=args.seed,
                           device=args.device, dtype=dtype)
    hmm.init_phylo_parameters(args.newick_path, args.er, args.pi,
                              args.alpha, args.num_rates)
    if args.subcommand == "compute-logl":
        print(f"{hmm.log_likelihood():.6g}")
    else:
        for ann in hmm.sample_annotations(args.N):
            print(ann.naive_seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
