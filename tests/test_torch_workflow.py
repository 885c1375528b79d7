"""Port workflow runner (linearham_tpu_torch.workflow) vs the JAX package's,
on the CPU: end to end with artifact resume, the --cluster-indices batched
pipeline through the port's run_repertoire, and the JAX workflow's
LHLogLikelihood column at rtol 1e-9 (mirrors tests/test_workflow.py)."""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from linearham_tpu.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
from linearham_tpu_torch.workflow import (run_family_workflow,
                                          run_repertoire_workflow)
from test_torch_pipeline import _make_tsv

torch.set_num_threads(1)

ARTIFACTS = [  # tests/test_workflow.py:36-43
    "cluster.yaml", "cluster_seqs.fasta", "revbayes_run.rev",
    "lh_revbayes_run.trees", "linearham_run.trees",
    "linearham_run.log", "linearham_run.ess",
    "linearham_annotations_best.yaml", "linearham_annotations_all.yaml",
    "aa_naive_seqs.fasta", "aa_naive_seqs.dnamap",
    "aa_lineage_seqs_0.fasta", "aa_lineage_seqs_0.dnamap",
]


@pytest.fixture(autouse=True)
def _family_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", str(tmp_path / "fc"))


def _outdir(tmp_path, name="wf"):
    out = tmp_path / name
    out.mkdir()
    # The tree MCMC is an external engine; pre-place its artifact.
    _make_tsv(out / "revbayes_run.trees", n_rows=8, seed=1)
    return out


def _run(run, fixtures_dir, outdir, **kw):
    run(str(outdir),
        partis_yaml_file=str(fixtures_dir / "phylo_hmm_input.yaml"),
        hmm_param_dir=str(fixtures_dir / "hmm_params"),
        mcmc_iter=10, mcmc_thin=1, tune_iter=0, tune_thin=1,
        num_rates=4, burnin_frac=0.25, subsamp_frac=0.5, seed=0,
        lineage_unique_ids=["0"], pfilters=[0.0], **kw)


def _lh_loglik(path):
    lines = path.read_text().strip().split("\n")
    col = lines[0].split("\t").index("LHLogLikelihood")
    return np.array([float(ln.split("\t")[col]) for ln in lines[1:]])


def test_workflow_end_to_end_and_resume(fixtures_dir, tmp_path, capsys):
    outdir = _outdir(tmp_path)
    _run(run_family_workflow, fixtures_dir, outdir, device="cpu")
    for name in ARTIFACTS:
        assert (outdir / name).exists(), name
    capsys.readouterr()

    mtimes = {n: os.path.getmtime(outdir / n) for n in ARTIFACTS}
    _run(run_family_workflow, fixtures_dir, outdir, device="cpu")
    out = capsys.readouterr().out
    assert "running" not in out
    for n in ARTIFACTS:
        assert os.path.getmtime(outdir / n) == mtimes[n], n

    time.sleep(0.02)
    os.utime(outdir / "lh_revbayes_run.trees")
    _run(run_family_workflow, fixtures_dir, outdir, device="cpu")
    out = capsys.readouterr().out
    assert "bootstrap-asr: running" in out
    assert "parse-cluster: up to date" in out


def test_workflow_matches_jax_workflow(fixtures_dir, tmp_path):
    """Same inputs through both workflows: every artifact, the
    LHLogLikelihood column at rtol 1e-9, and the bootstrap stage's rows
    (numpy resampling on the same seed) in every column the FFBS sampler
    does not decide."""
    from linearham_tpu.workflow import \
        run_family_workflow as jax_run_family_workflow

    port, ref = _outdir(tmp_path, "port"), _outdir(tmp_path, "jax")
    _run(run_family_workflow, fixtures_dir, port, device="cpu")
    _run(jax_run_family_workflow, fixtures_dir, ref, precision="f64")
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    got = _lh_loglik(port / "lh_revbayes_run.trees")
    assert got.shape == (8,)
    np.testing.assert_allclose(
        got, _lh_loglik(ref / "lh_revbayes_run.trees"), rtol=1e-9)
    header, *rows = (port / "linearham_run.log").read_text().splitlines()
    ref_header, *ref_rows = (ref / "linearham_run.log").read_text() \
        .splitlines()
    assert header == ref_header and len(rows) == len(ref_rows) == 3
    n_fixed = header.split("\t").index("LogWeight") + 1
    for g, w in zip(rows, ref_rows):
        np.testing.assert_allclose(
            [float(x) for x in g.split("\t")[:n_fixed]],
            [float(x) for x in w.split("\t")[:n_fixed]], rtol=1e-9)


def test_workflow_missing_external_artifact(fixtures_dir, tmp_path):
    out = tmp_path / "wf2"
    out.mkdir()
    with pytest.raises(RuntimeError, match="RevBayes"):
        run_family_workflow(
            str(out),
            partis_yaml_file=str(fixtures_dir / "phylo_hmm_input.yaml"),
            hmm_param_dir=str(fixtures_dir / "hmm_params"), device="cpu")


def _two_cluster_inputs(fixtures_dir, tmp_path):
    """tests/test_workflow.py's two-cluster partis YAML and trees."""
    base = tmp_path / "multi"
    for i in range(2):
        d = base / f"cluster_{i}"
        d.mkdir(parents=True)
        tsv = d / "revbayes_run.trees"
        _make_tsv(tsv, n_rows=4 + i, seed=80 + i)
        if i == 1:
            tsv.write_text(re.sub(r"([(,])([012]):", r"\1\2_b:",
                                  tsv.read_text()))
    doc = yaml.safe_load((fixtures_dir / "phylo_hmm_input.yaml").read_text())
    ev2 = dict(doc["events"][0])
    ev2["unique_ids"] = [f"{u}_b" for u in ev2["unique_ids"]]
    doc["events"] = [doc["events"][0], ev2]
    doc["partitions"] = [{
        "logprob": 0.0,
        "partition": [list(doc["events"][0]["unique_ids"]),
                      list(ev2["unique_ids"])],
    }]
    two_yaml = tmp_path / "partis_two_clusters.yaml"
    two_yaml.write_text(yaml.safe_dump(doc))
    return base, two_yaml


def test_repertoire_workflow_batches_pipeline(fixtures_dir, tmp_path, capsys,
                                              monkeypatch):
    """--cluster-indices: the two stale clusters' pipelines go through ONE
    run_repertoire call; each equals the port's single-family pipeline; a
    second invocation is fully up to date."""
    import linearham_tpu_torch.parallel.repertoire as rep

    calls = []
    real = rep.run_repertoire
    monkeypatch.setattr(rep, "run_repertoire",
                        lambda tasks, **kw: calls.append(len(tasks))
                        or real(tasks, **kw))
    base, two_yaml = _two_cluster_inputs(fixtures_dir, tmp_path)
    args = (str(base), str(two_yaml), str(fixtures_dir / "hmm_params"),
            [0, 1])
    run_repertoire_workflow(*args, num_rates=4, seed=0, device="cpu")
    assert "batching 2 clusters" in capsys.readouterr().out
    assert calls == [2]

    for i in range(2):
        d = base / f"cluster_{i}"
        for name in ARTIFACTS[:-2]:
            assert (d / name).exists(), (i, name)
        hmm = PhyloHMM(str(d / "cluster.yaml"), 0,
                       str(fixtures_dir / "hmm_params"), device="cpu")
        ref = run_pipeline_arrays(
            hmm, load_tree_samples(str(d / "revbayes_run.trees")),
            num_rates=4)
        np.testing.assert_allclose(_lh_loglik(d / "lh_revbayes_run.trees"),
                                   ref.lh_loglik, rtol=1e-9)

    run_repertoire_workflow(*args, num_rates=4, seed=0, device="cpu")
    out = capsys.readouterr().out
    assert "batching" not in out and "running" not in out
    assert calls == [2]


def test_workflow_main_cluster_indices_loads_no_jax(fixtures_dir, tmp_path):
    """``main(['--cluster-indices', ...])`` in a fresh interpreter runs the
    whole chain on the port, and nothing it ran loaded jax."""
    base, two_yaml = _two_cluster_inputs(fixtures_dir, tmp_path)
    argv = ["--outdir", str(base), "--partis-yaml-file", str(two_yaml),
            "--hmm-param-dir", str(fixtures_dir / "hmm_params"),
            "--cluster-indices", "0,1", "--mcmc-iter", "10",
            "--burnin-frac", "0.25", "--subsamp-frac", "0.5",
            "--device", "cpu"]
    code = ("import sys\n"
            "from linearham_tpu_torch.workflow import main\n"
            f"assert main({argv!r}) == 0\n"
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)),
                          env={**os.environ, "LINEARHAM_FAMILY_CACHE": "off"})
    assert proc.returncode == 0, proc.stderr
    assert "batching 2 clusters" in proc.stdout
    assert proc.stdout.strip().endswith("[]")
    for i in range(2):
        assert (base / f"cluster_{i}" / "aa_naive_seqs.fasta").exists()


def test_grid_layout(tmp_path, monkeypatch):
    """run_workflow_grid's directories and single-combination shortcut, as
    in the JAX package (tests/test_workflow.py:test_grid_flat_layout)."""
    import linearham_tpu_torch.workflow as wf

    seen = []
    monkeypatch.setattr(wf, "run_family_workflow",
                        lambda sub, **kw: seen.append((sub, kw)))
    grid = {"mcmc_iter": [10, 20], "mcmc_thin": [1], "num_rates": [2, 4]}
    wf.run_workflow_grid(str(tmp_path), grid, {"device": "cpu"})
    assert [s for s, _ in seen] == [
        str(tmp_path / "mcmc_iter_10" / "num_rates_2"),
        str(tmp_path / "mcmc_iter_10" / "num_rates_4"),
        str(tmp_path / "mcmc_iter_20" / "num_rates_2"),
        str(tmp_path / "mcmc_iter_20" / "num_rates_4"),
    ]
    assert seen[1][1] == {"mcmc_iter": 10, "mcmc_thin": 1, "num_rates": 4,
                          "device": "cpu"}
    seen.clear()
    wf.run_workflow_grid(str(tmp_path), grid, {}, nestly_subdirs=False)
    assert seen[0][0] == str(tmp_path / "mcmc_iter_10_num_rates_2")
    seen.clear()
    wf.run_workflow_grid(str(tmp_path), {"mcmc_iter": [10]}, {})
    assert seen[0][0] == str(tmp_path)
