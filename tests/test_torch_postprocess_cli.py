"""The port's five post-processing mains against the JAX package's, on the
CPU (mirrors tests/test_postprocess.py::test_postprocess_clis and
::test_parse_cluster_cli).

* In this process: each main of ``linearham_tpu_torch.postprocess`` and its
  JAX counterpart, on the same inputs (one bootstrap output of the port's
  pipeline, a synthetic partis YAML), write byte-equal files -- the Rev
  file with the embedded model spec and with a user template, the
  annotations with the trees path defaulted from the log path.
* As ``python -m`` in fresh processes: each port main loads neither jax nor
  the JAX package, and its files equal the JAX main's run the same way.
  Both run under one PYTHONHASHSEED: the lineage tables order tied counts
  by set iteration, which follows str hashing, in both packages.
"""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.io.partis import load_cluster
from linearham_tpu_torch.io.output_tsv import write_output_tsv
from linearham_tpu_torch.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
from linearham_tpu_torch.postprocess import bootstrap_asr
from linearham_tpu_torch.utils.seqs import write_fasta
from linearham_tpu_torch.utils.synth import make_family, write_partis_yaml
from test_torch_pipeline import _make_tsv

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_MODULE = (
    "import json, runpy, sys\n"
    "module, sys.argv = sys.argv[1], sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    if e.code:\n"
    "        raise\n")
FOREIGN = ("print(json.dumps([m for m in sys.modules if m in ('jax', "
           "'linearham_tpu') or m.startswith(('jax.', 'jaxlib', "
           "'linearham_tpu.'))]), file=sys.stderr)\n")


@pytest.fixture(scope="module")
def inputs(fixtures_dir, tmp_path_factory):
    """Absolute input paths: the fixture family's pipeline TSV (the port,
    f64 on the CPU), its FASTA, the bootstrap outputs of the port's main,
    and a synthetic partis YAML with an shm-indel sequence."""
    tmp = tmp_path_factory.mktemp("mains")
    yaml_path = str(fixtures_dir / "phylo_hmm_input.yaml")
    tsv_in = tmp / "revbayes_run.trees"
    _make_tsv(tsv_in, n_rows=12, seed=3)
    hmm = PhyloHMM(yaml_path, 0, str(fixtures_dir / "hmm_params"),
                   device="cpu")
    result = run_pipeline_arrays(hmm, load_tree_samples(str(tsv_in)),
                                 num_rates=4, seed=0)
    out_tsv = tmp / "lh_revbayes_run.trees"
    with open(out_tsv, "w") as fh:
        write_output_tsv(result, heavy=True, outfile=fh)
    cluster = load_cluster(yaml_path, 0)
    fasta = tmp / "cluster_seqs.fasta"
    write_fasta({"naive": cluster.naive_seq,
                 **dict(zip(cluster.unique_ids, cluster.seqs))}, str(fasta))
    run = tmp / "lh"
    assert bootstrap_asr.main([
        str(out_tsv), str(fasta), "0.25", "0.5", "1", "0", f"{run}.trees",
        f"{run}.log", f"{run}.ess", "--device", "cpu"]) == 0
    partis = tmp / "partis_run.yaml"
    write_partis_yaml(make_family(n_seqs=6, seed=4), str(partis),
                      shm_indel_ids=(1,), seed=4)
    template = tmp / "custom.rev"
    template.write_text(
        'data <- readDiscreteCharacterData("{{ fasta_path }}")\n'
        "mcmc.run(generations={{ mcmc_iter }}, thin={{ mcmc_thin }})\n"
        "tune({{ tune_iter }}, {{ tune_thin }}); rates({{num_rates}})\n"
        "seed({{ seed }}) # base: {{ output_base }}\n")
    return dict(yaml=yaml_path, fasta=str(fasta), run=str(run),
                partis=str(partis), template=str(template))


REV = ["--mcmc-iter", "100", "--mcmc-thin", "2", "--tune-iter", "50",
       "--tune-thin", "5", "--num-rates", "4", "--seed", "7"]
# Each main's argv (the reference scripts' contracts), outputs relative to
# the working directory.
MAINS = {
    "parse_cluster": lambda p: (
        "parse_cluster", [p["partis"], "--yaml-output-file", "cluster.yaml",
                          "--fasta-output-file", "cluster_seqs.fasta",
                          "--cluster-index", "0", "--indel-reversed-seqs"]),
    "revbayes_config": lambda p: (
        "revbayes_config", ["--fasta-path", p["fasta"], *REV,
                            "--output-path", "revbayes_run.rev"]),
    "revbayes_config_template": lambda p: (
        "revbayes_config", [p["template"], "--fasta-path", p["fasta"], *REV,
                            "--output-path", "custom_out.rev"]),
    "naive_probs": lambda p: (
        "naive_probs", [p["run"] + ".trees", "--output-base",
                        "aa_naive_seqs"]),
    "lineage_probs": lambda p: (
        "lineage_probs", [p["run"] + ".trees", p["run"] + "_naive.fasta",
                          "--seed-seq", "0", "--pfilters", "0.0", "0.5",
                          "--output-base", "aa_lineage_seqs"]),
    "annotations": lambda p: (
        "annotations", [p["yaml"], p["run"] + ".log", "--output-base",
                        "linearham_annotations"]),
}


@pytest.fixture(scope="module")
def naive_fasta(inputs):
    """The naive-sequence FASTA that lineage_probs reads, written once."""
    from linearham_tpu_torch.postprocess.naive_probs import \
        tabulate_naive_probs

    tabulate_naive_probs(inputs["run"] + ".trees", inputs["run"] + "_naive",
                         make_png=False)
    return inputs["run"] + "_naive.fasta"


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", list(MAINS))
def test_main_matches_the_jax_main(case, inputs, naive_fasta, tmp_path):
    module, argv = MAINS[case](inputs)
    out = {}
    for pkg in ("linearham_tpu", "linearham_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        main = importlib.import_module(f"{pkg}.postprocess.{module}").main
        cwd = os.getcwd()
        os.chdir(d)
        try:
            assert main(argv) == 0
        finally:
            os.chdir(cwd)
        out[pkg] = _files(d)
    assert out["linearham_tpu_torch"], case
    assert list(out["linearham_tpu_torch"]) == list(out["linearham_tpu"])
    for name, data in out["linearham_tpu"].items():
        assert out["linearham_tpu_torch"][name] == data, name
    if case == "revbayes_config_template":
        text = out["linearham_tpu_torch"]["custom_out.rev"].decode()
        assert "generations=100" in text and inputs["fasta"] in text
        assert "{{" not in text


@pytest.mark.parametrize("case", ["parse_cluster", "revbayes_config",
                                  "naive_probs", "lineage_probs",
                                  "annotations"])
def test_main_as_a_fresh_process_loads_no_jax(case, inputs, naive_fasta,
                                              tmp_path):
    """``python -m linearham_tpu_torch.postprocess.<main>`` in a process
    that loads no jax, its files equal to ``python -m
    linearham_tpu.postprocess.<main>``'s."""
    module, argv = MAINS[case](inputs)
    env = {**os.environ, "PYTHONHASHSEED": "0",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
    out = {}
    for pkg in ("linearham_tpu", "linearham_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        code = RUN_MODULE + (FOREIGN if pkg == "linearham_tpu_torch" else "")
        proc = subprocess.run(
            [sys.executable, "-c", code, f"{pkg}.postprocess.{module}",
             *argv], capture_output=True, text=True, cwd=d, env=env,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        if pkg == "linearham_tpu_torch":
            assert json.loads(proc.stderr.strip().splitlines()[-1]) == []
        out[pkg] = _files(d)
    assert out["linearham_tpu_torch"]
    assert out["linearham_tpu_torch"] == out["linearham_tpu"]
