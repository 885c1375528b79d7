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

Every subcommand also takes ``--device`` (default: CUDA, which must be
present; ``cpu`` runs the f64 conformance path) and ``--precision``.  Both
``--compute-logl`` (reference spelling) and ``compute-logl`` are accepted.
"""

from __future__ import annotations

import argparse
import sys


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
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto",
                   help="compute precision: f32 (production, CUDA pruning "
                        "kernel), f64 (reference-conformance numerics); "
                        "auto = f32 on CUDA, f64 on the CPU")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (a GPU is required), "
                        "'cpu' for the CPU conformance path")


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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Accept the reference's '--compute-logl' style subcommand spelling.
    if argv and argv[0].startswith("--") and argv[0][2:] in (
            "compute-logl", "sample", "pipeline"):
        argv[0] = argv[0][2:]
    args = build_parser().parse_args(argv)

    if args.subcommand == "pipeline":
        from linearham_tpu_torch.pipeline.run import run_pipeline

        run_pipeline(
            args.yaml_path, args.cluster_ind, args.hmm_param_dir,
            args.input_path, args.output_path, args.num_rates,
            seed=args.seed, chunk_size=args.chunk_size,
            profile=args.profile, precision=args.precision,
            device=args.device)
        return 0

    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
    from linearham_tpu_torch.utils.runtime import resolve_dtype

    _validate_gtr(args)
    hmm = PhyloHMM(args.yaml_path, args.cluster_ind, args.hmm_param_dir,
                   seed=args.seed, device=args.device,
                   dtype=resolve_dtype(args.precision, args.device))
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
