"""The end-to-end workflow runner of the PyTorch port.

Counterpart of linearham_tpu/workflow.py, with the same step table, output
layout, artifact resume and command line, plus ``--device``:

  parse-cluster     partis YAML -> cluster.yaml + cluster_seqs.fasta
  revbayes-config   -> revbayes_run.rev
  revbayes          (external) -> revbayes_run.trees
  pipeline          -> lh_revbayes_run.trees          (the port's pipeline)
  bootstrap-asr     -> linearham_run.{trees,log,ess}  (the port's ASR)
  annotations       -> linearham_annotations_{best,all}.yaml
  naive-probs       -> aa_naive_seqs.{fasta,dnamap,png}
  lineage-probs     -> aa_lineage_seqs.* (with --lineage-unique-ids)

Every step runs on the port: the pipeline, bootstrap-ASR, repertoire
(``--cluster-indices``) and family cache steps on the device; the
freshness rule (``Workflow``, ``_fresh``), the git stamp, the external
partis calls and the post-processing modules on the host, as the JAX
package's workflow runs them.  Nothing here loads jax or the JAX package.

Usage: python -m linearham_tpu_torch.workflow --outdir out
           --partis-yaml-file ... --hmm-param-dir ... [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
from typing import List, Optional


__all__ = ["Workflow", "main", "run_family_workflow",
           "run_get_linearham_info", "run_partis", "run_repertoire_workflow",
           "run_workflow_grid", "write_git_stamp"]


def _fresh(outputs: List[str], inputs: List[str]) -> bool:
    if not all(os.path.exists(o) for o in outputs):
        return False
    newest_in = max((os.path.getmtime(i) for i in inputs if
                     os.path.exists(i)), default=0.0)
    return all(os.path.getmtime(o) >= newest_in for o in outputs)


class Workflow:
    def __init__(self, outdir: str, verbose: bool = True):
        self.outdir = outdir
        self.verbose = verbose
        os.makedirs(outdir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.outdir, name)

    def step(self, name: str, outputs: List[str], inputs: List[str],
             fn, external: bool = False) -> None:
        """Run ``fn`` unless the outputs are fresh.

        ``external`` steps (artifacts produced by an external engine, e.g.
        RevBayes) are skipped whenever their outputs merely exist -- a
        hand-supplied artifact must not be invalidated by config mtimes.
        """
        fresh = (all(os.path.exists(o) for o in outputs) if external
                 else _fresh(outputs, inputs))
        if fresh:
            if self.verbose:
                print(f"[workflow] {name}: up to date")
            return
        if self.verbose:
            print(f"[workflow] {name}: running")
        fn()
        missing = [o for o in outputs if not os.path.exists(o)]
        if missing:
            raise RuntimeError(f"step {name} did not produce {missing}")


def write_git_stamp(outdir: str) -> None:
    """Reproducibility stamp: commit + describe of the framework checkout.

    The reference records ``git rev-parse HEAD`` and ``git describe
    --dirty`` into ``<outdir>/git.log`` before running anything
    (SConstruct:231-235).  When the package is not running from a git
    checkout, the package version is stamped instead.
    """
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = []
    # Only trust git when the package directory itself is the checkout;
    # a site-packages install nested inside some unrelated repository must
    # not stamp that repository's commit.
    # .git is a directory in a normal checkout and a FILE in worktrees
    # and submodules; both are real checkouts.
    if os.path.exists(os.path.join(pkg_dir, ".git")):
        for cmd in (["git", "rev-parse", "HEAD"],
                    ["git", "describe", "--dirty", "--always"]):
            try:
                out = subprocess.run(
                    cmd, cwd=pkg_dir, check=True, capture_output=True,
                    text=True, timeout=10,
                ).stdout.strip()
            except Exception:
                out = None
            if out:
                lines.append(out)
    if not lines:
        import linearham_tpu_torch

        lines = ["linearham_tpu_torch " + getattr(
            linearham_tpu_torch, "__version__", "unversioned")]
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "git.log"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def run_partis(
    outdir: str,
    fasta_path: str,
    partis_binary: str,
    locus: str = "igh",
    parameter_dir: Optional[str] = None,
    all_clonal_seqs: bool = False,
    extra_args: Optional[List[str]] = None,
) -> str:
    """Invoke partis with linearham-info (external engine).

    Mirrors the reference's partis step exactly (SConstruct:296-311):
    mode ``partition`` normally, ``annotate --all-seqs-simultaneous``
    when all input sequences are known-clonal; an explicit parameter dir
    adds ``--refuse-to-cache-parameters``, otherwise partis caches into
    ``<outdir>/parameter_dir``.  stdout lands in partis_run.stdout.log
    (the reference's second target).  Returns the output YAML path.
    """
    out_yaml = os.path.join(outdir, "partis_run.yaml")
    mode = (["annotate", "--all-seqs-simultaneous"] if all_clonal_seqs
            else ["partition"])
    if parameter_dir is not None:
        param_args = [parameter_dir.rstrip("/"),
                      "--refuse-to-cache-parameters"]
    else:
        param_args = [os.path.join(outdir, "parameter_dir")]
    cmd = (
        [partis_binary] + mode
        + ["--infname", fasta_path]
        + ["--parameter-dir"] + param_args
        + ["--locus", locus,
           "--extra-annotation-columns", "linearham-info",
           "--outfname", out_yaml]
        + (extra_args or [])
    )
    with open(os.path.join(outdir, "partis_run.stdout.log"), "w") as log:
        subprocess.run(cmd, check=True, stdout=log)
    return out_yaml


def run_get_linearham_info(partis_yaml_file: str, partis_binary: str,
                           out_path: str,
                           parameter_dir: Optional[str] = None) -> str:
    """``partis get-linearham-info`` for a pre-existing partis file
    (reference: SConstruct:318-336): annotates the existing YAML in place
    into ``--linearham-info-fname``."""
    cmd = [partis_binary, "get-linearham-info",
           "--outfname", partis_yaml_file]
    if parameter_dir is not None:
        cmd += ["--parameter-dir", parameter_dir.rstrip("/")]
    cmd += ["--linearham-info-fname", out_path]
    subprocess.run(cmd, check=True)
    return out_path


def _int_list(text: str) -> List[int]:
    return [int(x) for x in str(text).split(",")]


def _float_list(text: str) -> List[float]:
    return [float(x) for x in str(text).split(",")]


def run_family_workflow(
    outdir: str,
    partis_yaml_file: str,
    hmm_param_dir: str,
    cluster_index: Optional[int] = None,
    partition_index: Optional[int] = None,
    seed_unique_id: Optional[str] = None,
    mcmc_iter: int = 10000,
    mcmc_thin: int = 10,
    tune_iter: int = 5000,
    tune_thin: int = 100,
    num_rates: int = 4,
    burnin_frac: float = 0.1,
    subsamp_frac: float = 0.05,
    seed: int = 0,
    rb_binary: Optional[str] = None,
    lineage_unique_ids: Optional[List[str]] = None,
    pfilters: Optional[List[float]] = None,
    indel_reversed_seqs: bool = True,
    precision: Optional[str] = None,
    template_path: Optional[str] = None,
    stop_after: Optional[str] = None,
    device=None,
) -> None:
    """Run one family's step chain (linearham_tpu/workflow.py's, on the
    port).  ``device``: None means CUDA (raises without one), "cpu" runs
    the CPU conformance path.  ``stop_after="revbayes"`` stops at the
    pipeline boundary (``run_repertoire_workflow`` batches the pipelines of
    several clusters, then re-enters here)."""
    from linearham_tpu_torch.pipeline.run import run_pipeline
    from linearham_tpu_torch.postprocess.annotations import (write_lh_annotations)
    from linearham_tpu_torch.postprocess.bootstrap_asr import run_bootstrap_asr
    from linearham_tpu_torch.postprocess.lineage_probs import (tabulate_lineage_probs)
    from linearham_tpu_torch.postprocess.naive_probs import (tabulate_naive_probs)
    from linearham_tpu_torch.postprocess.parse_cluster import parse_cluster
    from linearham_tpu_torch.postprocess.revbayes_config import (generate_rev_file)

    wf = Workflow(outdir)
    write_git_stamp(outdir)
    cluster_yaml = wf.path("cluster.yaml")
    cluster_fasta = wf.path("cluster_seqs.fasta")
    rev_file = wf.path("revbayes_run.rev")
    rb_trees = wf.path("revbayes_run.trees")
    lh_trees = wf.path("lh_revbayes_run.trees")
    run_base = wf.path("linearham_run")
    ann_base = wf.path("linearham_annotations")
    naive_base = wf.path("aa_naive_seqs")

    wf.step(
        "parse-cluster", [cluster_yaml, cluster_fasta], [partis_yaml_file],
        lambda: parse_cluster(
            partis_yaml_file, cluster_yaml, cluster_fasta,
            partition_index=partition_index, cluster_index=cluster_index,
            seed_unique_id=seed_unique_id,
            indel_reversed_seqs=indel_reversed_seqs))
    wf.step(
        "revbayes-config", [rev_file],
        [cluster_fasta] + ([template_path] if template_path else []),
        lambda: generate_rev_file(
            cluster_fasta, rev_file, mcmc_iter, mcmc_thin, tune_iter,
            tune_thin, num_rates, seed, template_path=template_path))

    def run_revbayes():
        if rb_binary is None:
            raise RuntimeError(
                f"{rb_trees} is missing and no --rb-binary was given; run "
                f"RevBayes on {rev_file} (the tree MCMC stays an external "
                "engine, as in the reference)")
        subprocess.run([rb_binary, rev_file], check=True, cwd=outdir)

    wf.step("revbayes", [rb_trees], [rev_file], run_revbayes, external=True)
    if stop_after == "revbayes":
        return

    wf.step(
        "pipeline", [lh_trees], [rb_trees, cluster_yaml],
        lambda: run_pipeline(
            cluster_yaml, 0, hmm_param_dir, rb_trees, lh_trees, num_rates,
            seed=seed, precision=precision, device=device))
    wf.step(
        "bootstrap-asr",
        [run_base + ext for ext in (".trees", ".log", ".ess")],
        [lh_trees, cluster_fasta],
        lambda: run_bootstrap_asr(
            lh_trees, cluster_fasta, burnin_frac, subsamp_frac, seed,
            output_base=run_base, device=device))
    wf.step(
        "annotations",
        [ann_base + "_best.yaml", ann_base + "_all.yaml"],
        [run_base + ".log", run_base + ".trees", cluster_yaml],
        lambda: write_lh_annotations(
            cluster_yaml, run_base + ".log", run_base + ".trees", ann_base))
    wf.step(
        "naive-probs",
        [naive_base + ".fasta", naive_base + ".dnamap"],
        [run_base + ".trees"],
        lambda: tabulate_naive_probs(run_base + ".trees", naive_base))
    for uid in lineage_unique_ids or []:
        lineage_base = wf.path(f"aa_lineage_seqs_{uid}")
        wf.step(
            f"lineage-probs[{uid}]",
            [lineage_base + ".fasta", lineage_base + ".dnamap"],
            [run_base + ".trees", naive_base + ".fasta"],
            lambda uid=uid, base=lineage_base: tabulate_lineage_probs(
                run_base + ".trees", naive_base + ".fasta", uid,
                pfilters or [0.1], base))


def run_repertoire_workflow(
    base_outdir: str,
    partis_yaml_file: str,
    hmm_param_dir: str,
    cluster_indices: List[int],
    num_rates: int = 4,
    seed: int = 0,
    precision: Optional[str] = None,
    device=None,
    **family_kw,
) -> None:
    """Several clusters of one partis output, their pipelines batched.

    Each cluster's pre-steps run in ``cluster_<i>/``; every cluster whose
    ``lh_revbayes_run.trees`` is stale then runs through ONE
    ``run_repertoire`` call (one pruning launch per bucket); finally each
    cluster's post-processing chain runs, its pipeline step up to date.
    """
    if len(set(cluster_indices)) != len(cluster_indices):
        raise ValueError(
            f"duplicate cluster indices: {cluster_indices} (each cluster "
            "gets one cluster_<i>/ output directory)")
    subdirs = [os.path.join(base_outdir, f"cluster_{i}")
               for i in cluster_indices]
    common = dict(num_rates=num_rates, seed=seed, precision=precision,
                  device=device, **family_kw)
    for i, sub in zip(cluster_indices, subdirs):
        run_family_workflow(sub, partis_yaml_file, hmm_param_dir,
                            cluster_index=i, stop_after="revbayes", **common)

    stale = []
    for sub in subdirs:
        cluster_yaml = os.path.join(sub, "cluster.yaml")
        rb_trees = os.path.join(sub, "revbayes_run.trees")
        lh_trees = os.path.join(sub, "lh_revbayes_run.trees")
        if not _fresh([lh_trees], [rb_trees, cluster_yaml]):
            stale.append((cluster_yaml, rb_trees, lh_trees))
    if stale:
        from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
        from linearham_tpu_torch.io.trees_tsv import load_tree_samples
        from linearham_tpu_torch.ops import pruning_cuda
        from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                             run_repertoire,
                                                             write_family_output)
        from linearham_tpu_torch.utils.runtime import resolve_dtype

        dtype = resolve_dtype(precision, device)
        print(f"[workflow] pipeline: batching {len(stale)} clusters "
              "through one repertoire workload")
        tasks = [
            FamilyTask(hmm=cached_phylo_hmm(cy, 0, hmm_param_dir, seed=seed,
                                            device=device, dtype=dtype),
                       samples=load_tree_samples(rb))
            for cy, rb, _ in stale]
        launches = pruning_cuda.launches
        results = run_repertoire(tasks, num_rates=num_rates, seed=seed,
                                 device=device, dtype=dtype)
        for (_, _, lh), task, res in zip(stale, tasks, results):
            write_family_output(task, res, num_rates, lh)
        print(f"[workflow] pipeline: {sum(len(r.loglik) for r in results)} "
              f"trees, {pruning_cuda.launches - launches} pruning-kernel "
              "launch(es)")

    for i, sub in zip(cluster_indices, subdirs):
        run_family_workflow(sub, partis_yaml_file, hmm_param_dir,
                            cluster_index=i, **common)


def run_workflow_grid(base_outdir: str, grid: dict, fixed: dict,
                      nestly_subdirs: bool = True) -> None:
    """Cartesian fan-out over multi-valued MCMC parameters, one
    ``run_family_workflow`` per combination (directory layout as in
    linearham_tpu/workflow.py:run_workflow_grid)."""
    keys = [k for k, v in grid.items() if len(v) > 1]
    for combo in itertools.product(*grid.values()):
        params = dict(zip(grid.keys(), combo))
        if not keys:
            sub = base_outdir
        elif nestly_subdirs:
            sub = os.path.join(base_outdir,
                               *(f"{k}_{params[k]}" for k in keys))
        else:
            sub = os.path.join(
                base_outdir, "_".join(f"{k}_{params[k]}" for k in keys))
        run_family_workflow(sub, **params, **fixed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="linearham-tpu-torch-workflow",
        description="Run the full linearham workflow for one family "
                    "(PyTorch / CUDA).")
    p.add_argument("--outdir", required=True)
    p.add_argument("--partis-yaml-file",
                   help="partis output with linearham-info (or use "
                        "--fasta-path with --partis-binary)")
    p.add_argument("--fasta-path",
                   help="input sequences; runs partis when given with "
                        "--partis-binary")
    p.add_argument("--partis-binary", help="partis executable (external)")
    p.add_argument("--locus", default="igh")
    p.add_argument("--parameter-dir",
                   help="partis parameter dir (hmm params live under "
                        "<dir>/hmm/hmms)")
    p.add_argument("--all-clonal-seqs", action="store_true")
    p.add_argument("--hmm-param-dir")
    p.add_argument("--cluster-index", type=int)
    p.add_argument("--cluster-indices", type=_int_list,
                   help="comma-separated cluster indices: run SEVERAL "
                        "clusters of the partis output, batching their "
                        "pipelines through one repertoire run (per-cluster "
                        "outputs in cluster_<i>/ subdirectories)")
    p.add_argument("--partition-index", type=int)
    p.add_argument("--cluster-seed-unique-id",
                   help="restrict the analysis to this sequence's cluster")
    p.add_argument("--template-path",
                   help="a Rev template to render instead of the built-in "
                        "model spec")
    # Multi-valued (comma-separated) parameters fan out into nested dirs.
    p.add_argument("--mcmc-iter", type=_int_list, default=[10000])
    p.add_argument("--mcmc-thin", type=_int_list, default=[10])
    p.add_argument("--tune-iter", type=_int_list, default=[5000])
    p.add_argument("--tune-thin", type=_int_list, default=[100])
    p.add_argument("--num-rates", type=_int_list, default=[4])
    p.add_argument("--burnin-frac", type=float, default=0.1)
    p.add_argument("--subsamp-frac", type=float, default=0.05)
    p.add_argument("--rng-seed", type=_int_list, default=[0],
                   help="RNG seed(s); multiple values fan out like the "
                        "other grid parameters")
    p.add_argument("--rb-binary", help="RevBayes executable (external)")
    p.add_argument("--lineage-unique-ids", nargs="*", default=None)
    p.add_argument("--no-nestly-subdirs", action="store_true",
                   help="flat one-directory-per-combination layout instead "
                        "of nested subdirectories")
    p.add_argument("--asr-pfilters", type=_float_list, default=[0.1],
                   help="comma-separated ancestral-sequence posterior "
                        "probability thresholds")
    p.add_argument("--precision", choices=["f32", "f64", "auto"],
                   default="auto",
                   help="pipeline compute precision (auto = f32 on CUDA, "
                        "f64 on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (a GPU is required), "
                        "'cpu' for the CPU conformance path")
    args = p.parse_args(argv)

    partis_yaml = args.partis_yaml_file
    if partis_yaml is None:
        if not (args.fasta_path and args.partis_binary):
            raise SystemExit(
                "error: give --partis-yaml-file, or --fasta-path with "
                "--partis-binary to run partis here")
        os.makedirs(args.outdir, exist_ok=True)
        partis_yaml = run_partis(
            args.outdir, args.fasta_path, args.partis_binary,
            locus=args.locus, parameter_dir=args.parameter_dir,
            all_clonal_seqs=args.all_clonal_seqs)

    hmm_param_dir = args.hmm_param_dir
    if hmm_param_dir is None:
        if args.parameter_dir is None:
            raise SystemExit(
                "error: give --hmm-param-dir (or --parameter-dir, whose "
                "hmm/hmms subdirectory is used, as in the reference)")
        hmm_param_dir = os.path.join(args.parameter_dir, "hmm", "hmms")

    grid = {
        "mcmc_iter": args.mcmc_iter,
        "mcmc_thin": args.mcmc_thin,
        "tune_iter": args.tune_iter,
        "tune_thin": args.tune_thin,
        "num_rates": args.num_rates,
        "seed": args.rng_seed,
    }
    family_kw = dict(
        partition_index=args.partition_index,
        seed_unique_id=args.cluster_seed_unique_id,
        burnin_frac=args.burnin_frac,
        subsamp_frac=args.subsamp_frac,
        rb_binary=args.rb_binary,
        lineage_unique_ids=args.lineage_unique_ids,
        pfilters=args.asr_pfilters,
        template_path=args.template_path,
    )
    if args.cluster_indices:
        if any(len(v) > 1 for v in grid.values()):
            raise SystemExit(
                "error: --cluster-indices does not combine with "
                "multi-valued MCMC grid parameters; run one grid "
                "combination per invocation")
        if args.cluster_index is not None:
            raise SystemExit(
                "error: give --cluster-index or --cluster-indices, "
                "not both")
        params = {k: v[0] for k, v in grid.items()}
        run_repertoire_workflow(
            args.outdir, partis_yaml, hmm_param_dir, args.cluster_indices,
            precision=args.precision, device=args.device, **params,
            **family_kw)
        return 0
    run_workflow_grid(
        args.outdir, grid,
        dict(partis_yaml_file=partis_yaml, hmm_param_dir=hmm_param_dir,
             cluster_index=args.cluster_index, precision=args.precision,
             device=args.device, **family_kw),
        nestly_subdirs=not args.no_nestly_subdirs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
