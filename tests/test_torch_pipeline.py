"""Port pipeline + CLI (linearham_tpu_torch) vs the JAX package, f64 CPU.

The port's run_pipeline and the JAX run_pipeline read the same fixture
YAML and RevBayes-style TSV (tests/test_pipeline.py:_make_tsv's recipe),
chunk 2 (a short final chunk).  Every column the sampler does not decide
must be identical; the log-likelihoods agree at rel 1e-9.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from linearham_tpu.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.io.output_tsv import write_tsv_header, write_tsv_rows
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.pipeline.run import run_pipeline, run_pipeline_arrays
from linearham_tpu_torch.utils.synth import write_pipeline_inputs

from test_torch_profiling import junction_rows

torch.set_num_threads(1)

PI = [0.17, 0.19, 0.25, 0.39]
SAMPLED = {"NaiveSequence", "VGene", "V5pDel", "V3pDel", "VFwkInsertion",
           "VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion",
           "JGene", "J5pDel", "J3pDel", "JFwkInsertion"}


def _make_tsv(path, n_rows=5, seed=0):
    """A RevBayes-style posterior TSV over the fixture taxa."""
    rng = np.random.default_rng(seed)
    cols = (["Iteration", "Likelihood", "Prior", "alpha"]
            + [f"er[{i}]" for i in range(1, 7)]
            + [f"pi[{i}]" for i in range(1, 5)] + ["tree"])
    lines = ["\t".join(cols)]
    topologies = [
        "((0:{a},1:{b}):{c},naive:{d},2:{e});",
        "((0:{a},2:{b}):{c},naive:{d},1:{e});",
        "((1:{a},2:{b})[&index=7]:{c},naive:{d},0:{e});",
    ]
    for t in range(n_rows):
        bl = rng.uniform(0.05, 0.8, size=5)
        tree = topologies[t % 3].format(
            a=bl[0], b=bl[1], c=bl[2], d=bl[3], e=bl[4])
        er = rng.uniform(0.5, 2.0, size=6)
        pi = rng.dirichlet([5, 5, 5, 5])
        alpha = rng.uniform(0.4, 3.0)
        row = ([str(t * 10), f"{-100 - t:.4f}", "-12.0", f"{alpha:.6f}"]
               + [f"{x:.6f}" for x in er] + [f"{x:.6f}" for x in pi]
               + [tree])
        lines.append("\t".join(row))
    path.write_text("\n".join(lines) + "\n")


def _read(path):
    lines = path.read_text().rstrip("\n").split("\n")
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_pipeline") / "revbayes_run.trees"
    _make_tsv(p)
    return p


def test_pipeline_tsv_matches_jax(fixtures_dir, tsv, tmp_path, monkeypatch):
    from linearham_tpu.pipeline.run import run_pipeline as jax_run_pipeline

    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    args = (str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
            str(fixtures_dir / "hmm_params"), str(tsv))
    jax_run_pipeline(*args, str(tmp_path / "jax.tsv"), num_rates=4, seed=0,
                     chunk_size=2, precision="f64")
    run_pipeline(*args, str(tmp_path / "port.tsv"), num_rates=4, seed=0,
                 chunk_size=2, precision="f64", device="cpu")

    want_header, want = _read(tmp_path / "jax.tsv")
    got_header, got = _read(tmp_path / "port.tsv")
    assert got_header == want_header
    assert len(got) == len(want) == 5
    ll_cols = [got_header.index(c) for c in ("LHLogLikelihood", "LogWeight")]
    naive = got_header.index("NaiveSequence")
    for g, w in zip(got, want):
        for i, name in enumerate(got_header):
            if i in ll_cols:
                assert float(g[i]) == pytest.approx(float(w[i]), rel=1e-9)
            elif name not in SAMPLED:
                assert g[i] == w[i], name
        assert len(g[naive]) == 15 == len(w[naive])


def test_pipeline_matches_single_tree(fixtures_dir, tsv, tmp_path):
    hmm = PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                   str(fixtures_dir / "hmm_params"), device="cpu")
    samples = load_tree_samples(str(tsv))
    result = run_pipeline_arrays(hmm, samples, num_rates=4, seed=0,
                                 chunk_size=2)
    assert result.lh_loglik.shape == (5,)
    np.testing.assert_allclose(result.logweight,
                               result.lh_loglik - samples.rb_loglik)
    for t in range(samples.n_samples):
        nw_file = tmp_path / f"t{t}.nwk"
        nw_file.write_text(samples.newicks[t] + "\n")
        hmm.init_phylo_parameters(str(nw_file), list(samples.er[t]),
                                  list(samples.pi[t]),
                                  float(samples.alpha[t]), 4)
        assert result.lh_loglik[t] == pytest.approx(hmm.log_likelihood(),
                                                    rel=1e-9), f"tree {t}"


def test_drain_thread_keeps_rows_in_order(fixtures_dir, tmp_path):
    """One-tree chunks with the interpreter switching threads as often as
    it can: the drain thread's streamed rows stay in input order and its
    log-likelihoods equal a single-chunk run's."""
    src = tmp_path / "in.tsv"
    _make_tsv(src, n_rows=9, seed=5)
    hmm = PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                   str(fixtures_dir / "hmm_params"), device="cpu")
    samples = load_tree_samples(str(src))
    whole = run_pipeline_arrays(hmm, samples, num_rates=4, chunk_size=9)
    seen = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        chunked = run_pipeline_arrays(
            hmm, samples, num_rates=4, chunk_size=1,
            on_chunk=lambda start, n, ll, anns: seen.append((start, n)))
    finally:
        sys.setswitchinterval(interval)
    assert seen == [(t, 1) for t in range(9)]
    assert len(chunked.annotations) == 9
    np.testing.assert_allclose(chunked.lh_loglik, whole.lh_loglik,
                               rtol=1e-12)


def test_streamed_tsv_matches_batch_write(fixtures_dir, tmp_path):
    """run_pipeline's chunk-streamed TSV (chunks of 3 over 7 rows) is
    byte-identical to writing its whole result as one chunk afterwards."""
    src = tmp_path / "in.tsv"
    _make_tsv(src, n_rows=7, seed=9)
    out = tmp_path / "out.tsv"
    result = run_pipeline(
        str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
        str(fixtures_dir / "hmm_params"), str(src), str(out), num_rates=4,
        seed=0, chunk_size=3, precision="f64", device="cpu")
    buf = io.StringIO()
    write_tsv_header(4, True, buf)
    write_tsv_rows(result.samples, result.rates, result.lh_loglik,
                   result.logweight, result.annotations, 0, 7, True, buf)
    assert out.read_text() == buf.getvalue()


def test_synthetic_inputs_run_through_the_pipeline(tmp_path):
    """The port's synthetic-input writer (what chip_smoke.py feeds the
    card) produces files the port's pipeline reads end to end."""
    files = write_pipeline_inputs(str(tmp_path), n_seqs=4, n_trees=3,
                                  seed=2)
    out = tmp_path / "out.tsv"
    run_pipeline(files.yaml_path, 0, files.gene_dir, files.trees_path,
                 str(out), num_rates=2, chunk_size=2, device="cpu")
    header, rows = _read(out)
    assert len(rows) == 3
    ll = [float(r[header.index("LHLogLikelihood")]) for r in rows]
    assert np.isfinite(ll).all()
    naive = header.index("NaiveSequence")
    assert all(len(r[naive]) == files.family.n_sites for r in rows)


def test_crash_leaves_no_partial_output(fixtures_dir, tmp_path, monkeypatch):
    import linearham_tpu_torch.pipeline.run as run_mod

    src = tmp_path / "in.tsv"
    _make_tsv(src, n_rows=6, seed=12)
    out = tmp_path / "out.tsv"

    def boom(*a, **k):
        raise RuntimeError("device died")

    monkeypatch.setattr(run_mod, "run_pipeline_arrays", boom)
    with pytest.raises(RuntimeError, match="device died"):
        run_pipeline(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                     str(fixtures_dir / "hmm_params"), str(src), str(out),
                     num_rates=4, device="cpu")
    assert not out.exists()
    assert not list(tmp_path.glob("*.partial"))


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "linearham_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=300)


def test_cli_pipeline_writes_every_row(fixtures_dir, tsv, tmp_path):
    out = tmp_path / "cli.tsv"
    proc = _cli("--pipeline", "--yaml-path",
                str(fixtures_dir / "phylo_hmm_input.yaml"),
                "--cluster-ind", "0", "--hmm-param-dir",
                str(fixtures_dir / "hmm_params"), "--input-path", str(tsv),
                "--output-path", str(out), "--num-rates", "4",
                "--chunk-size", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    header, rows = _read(out)
    assert len(rows) == 5
    assert all(len(r) == len(header) for r in rows)


def test_cli_compute_logl(fixtures_dir):
    argv = ["compute-logl", "--yaml-path",
            str(fixtures_dir / "phylo_hmm_input.yaml"), "--cluster-ind", "0",
            "--hmm-param-dir", str(fixtures_dir / "hmm_params"),
            "--newick-path", str(fixtures_dir / "newton.tree"),
            "--alpha", "1.0", "--num-rates", "4", "--device", "cpu"]
    for x in [1.0] * 6:
        argv += ["--er", str(x)]
    for x in PI:
        argv += ["--pi", str(x)]
    proc = _cli(*argv)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip()) == pytest.approx(-75.8136, abs=1e-3)


def test_max_chunks_drains_exactly_that_many(fixtures_dir, tmp_path):
    """Shapes come from the whole ensemble; only the first chunk runs, and
    its rows equal a full run's."""
    src = tmp_path / "in.tsv"
    _make_tsv(src, n_rows=7, seed=4)
    hmm = PhyloHMM(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                   str(fixtures_dir / "hmm_params"), device="cpu")
    samples = load_tree_samples(str(src))
    seen = []
    one = run_pipeline_arrays(
        hmm, samples, num_rates=4, chunk_size=3, max_chunks=1,
        on_chunk=lambda start, n, ll, anns: seen.append((start, n)))
    assert seen == [(0, 3)] and len(one.annotations) == 3
    whole = run_pipeline_arrays(hmm, samples, num_rates=4, chunk_size=3)
    np.testing.assert_allclose(one.lh_loglik[:3], whole.lh_loglik[:3],
                               rtol=1e-12)
    assert (one.lh_loglik[3:] == 0).all()


def _pipeline_argv(fixtures_dir, tsv, *extra):
    return ["--yaml-path", str(fixtures_dir / "phylo_hmm_input.yaml"),
            "--cluster-ind", "0", "--hmm-param-dir",
            str(fixtures_dir / "hmm_params"), "--input-path", str(tsv),
            "--num-rates", "4", "--device", "cpu", *extra]


def test_cli_pipeline_trace_dir_writes_a_trace(fixtures_dir, tsv, tmp_path):
    import json

    trace = tmp_path / "trace"
    proc = _cli("pipeline", *_pipeline_argv(
        fixtures_dir, tsv, "--output-path", str(tmp_path / "out.tsv"),
        "--chunk-size", "2", "--trace-dir", str(trace)))
    assert proc.returncode == 0, proc.stderr
    files = list(trace.glob("*.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("einsum" in str(e.get("name", "")) or
               "matmul" in str(e.get("name", "")) for e in events)
    assert len(_read(tmp_path / "out.tsv")[1]) == 5


def test_cli_warmup(fixtures_dir, tsv, tmp_path):
    env_cache = tmp_path / "fam_cache"
    proc = subprocess.run(
        [sys.executable, "-m", "linearham_tpu_torch.cli", "warmup",
         *_pipeline_argv(fixtures_dir, tsv, "--chunk-size", "2")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "LINEARHAM_FAMILY_CACHE": str(env_cache)})
    assert proc.returncode == 0, proc.stderr
    assert "warmup ok" in proc.stdout and "(2 trees exercised)" in proc.stdout
    assert len(list(env_cache.glob("*.pkl"))) == 1


def test_cli_serve_answers_each_request(fixtures_dir, tsv, tmp_path):
    """Two good requests, one missing a key (answered ok: false, naming the
    key, and the server goes on), then quit: exit 0."""
    import json

    def request(name, **drop):
        req = {"yaml_path": str(fixtures_dir / "phylo_hmm_input.yaml"),
               "cluster_ind": 0, "hmm_param_dir": str(fixtures_dir /
                                                      "hmm_params"),
               "input_path": str(tsv), "output_path": str(tmp_path / name),
               "num_rates": 4, "chunk_size": 2}
        for k in drop:
            del req[k]
        return json.dumps(req)

    stdin = "\n".join([request("a.tsv"), request("b.tsv", input_path=None),
                       "", request("c.tsv"), "quit", request("d.tsv")])
    proc = subprocess.run(
        [sys.executable, "-m", "linearham_tpu_torch.cli", "serve",
         "--device", "cpu"], input=stdin + "\n", capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "LINEARHAM_FAMILY_CACHE": str(tmp_path / "fc")})
    assert proc.returncode == 0, proc.stderr
    answers = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [a["ok"] for a in answers] == [True, False, True]
    rows = junction_rows(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                         str(fixtures_dir / "hmm_params"))
    assert "'input_path'" in answers[1]["error"]
    for a, name in zip((answers[0], answers[2]), ("a.tsv", "c.tsv")):
        assert a["output_path"] == str(tmp_path / name)
        assert a["n_trees"] == 5 and a["kernel_launches"] == 0
        assert {"load_trees_tsv", "build_hmm", "dispatch", "decode",
                "write_tsv", "drain_wait", "junction_scan"} <= set(a["stages"])
        assert a["counters"]["chunks"] == 3
        assert a["counters"]["junction_rows"] == 3 * rows
        assert len(_read(tmp_path / name)[1]) == 5
    assert "state_space" in answers[0]["stages"]     # the cold build
    assert not (tmp_path / "b.tsv").exists()
    assert not (tmp_path / "d.tsv").exists()       # after quit


def test_serve_stops_on_a_device_error(fixtures_dir, tsv, tmp_path,
                                       monkeypatch, capsys):
    """A device failure is not a bad request: no answer line, exit 1, and
    the requests after it are never read."""
    import json

    import linearham_tpu_torch.pipeline.run as run_mod
    from linearham_tpu_torch import cli
    from linearham_tpu_torch.utils.runtime import DeviceError

    calls = []

    def broken(*a, **k):
        calls.append(a)
        raise DeviceError("pruning kernel launch failed: cudaError 719")

    monkeypatch.setattr(run_mod, "run_pipeline", broken)
    req = json.dumps({"yaml_path": "y", "cluster_ind": 0,
                      "hmm_param_dir": "h", "input_path": str(tsv),
                      "output_path": str(tmp_path / "o.tsv")})
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"{req}\n{req}\n"))
    assert cli.main(["serve", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "device failure" in out.err
    assert len(calls) == 1
