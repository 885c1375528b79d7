"""The port's measurement tool, ``linearham_tpu_torch.tools.bench``, on the
CPU at tiny sizes.

* Every mode with ``--device cpu`` prints one JSON line: the required keys,
  ``device`` "cpu", no kernel launch, every number finite, and every row of
  every output TSV written.
* Without ``--device`` and without a GPU it raises; a flag that a mode does
  not take is refused.
* Its ``softmax``, ``ess`` and weighted subsample equal
  ``tools/bench_f32_weights.py``'s on seeded inputs (exactly: the same
  numpy operations and streams).  That file is loaded by path here; the
  port never reads it.
* Run as ``python -m`` in a fresh process, it loads neither jax nor the JAX
  package.
"""

import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from linearham_tpu_torch.tools import bench

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = {
    "pipeline": ["--trees", "8", "--seqs", "4", "--chunk", "4"],
    "pipeline_igk": ["--trees", "8", "--seqs", "4", "--chunk", "4",
                     "--locus", "igk"],
    "step": ["--trees", "8", "--seqs", "4", "--reps", "2"],
    "repertoire": ["--fams", "2", "--trees", "4", "--seqs", "4"],
    "repertoire_mixed": ["--mixed", "--fams", "1", "--trees", "4"],
    "repertoire_step": ["--fams", "2", "--trees", "4", "--seqs", "4",
                        "--reps", "2"],
    "depth312": ["--seqs", "6", "--trees", "8", "--chunk", "4", "--reps",
                 "2"],
    "f32_weights": ["--seqs", "6", "--trees", "16"],
    "probe": ["--seqs", "4", "--chunk", "8"],
    "ensemble": ["--seqs", "4", "--trees", "4", "--reps", "1"],
}


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return value is not None


def _rows_of(line):
    """Every (rows written, rows wanted) pair the line reports."""
    parts = [line, line.get("pipeline", {})]
    return [(p["n_rows"], p["n_trees"]) for p in parts if "n_rows" in p]


@pytest.mark.parametrize("case", list(TINY))
def test_mode_prints_one_json_line(case, capsys):
    mode = case.split("_igk")[0].split("_mixed")[0]
    assert bench.main([mode, "--device", "cpu", *TINY[case]]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert {"mode", "metric", "value", "unit", "n_trees", "device",
            "kernel_launches", "precision"} <= set(line)
    assert line["mode"] == mode and line["device"] == "cpu"
    assert line["kernel_launches"] == 0 and line["precision"] == "float64"
    assert _finite(line)
    for got, want in _rows_of(line):
        assert got == want
    if mode in ("pipeline", "repertoire", "probe"):
        assert line["stages"] and all(v >= 0 for v in line["stages"].values())
    if case == "pipeline_igk":
        assert line["locus"] == "igk"
    if case == "repertoire_mixed":
        assert line["n_fams"] == 2 and line["n_buckets"] == 2
    if mode == "probe":
        assert line["native_library"] != "none"
        assert list(line["stages"])[:3] == ["device_init", "native_load",
                                            "load_cluster"]
    if mode == "ensemble":
        runs = [*line["single"]["runs"], line["single"]["in_process_steady"],
                *line["single_10x"]["runs"], *line["repertoire"]["runs"]]
        assert len(runs) == 4 and all(
            r["device_init_s"] >= 0 and r["import_s"] > 0 for r in runs)


def test_no_gpu_means_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["step", "--trees", "2", "--seqs", "2"])


def test_a_flag_the_mode_does_not_take_is_refused():
    with pytest.raises(SystemExit):
        bench.main(["step", "--locus", "igk", "--device", "cpu"])


def test_weight_statistics_match_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_f32_weights", REPO / "tools" / "bench_f32_weights.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rng = np.random.default_rng(5)
    for n, spread in ((50, 0.5), (400, 3.0), (1024, 20.0)):
        lw = rng.normal(-1000.0, spread, size=n)
        w = bench.softmax(lw)
        np.testing.assert_array_equal(w, ref.softmax(lw))
        assert bench.ess(w) == ref.ess(w)
        k = max(1, round(0.05 * n))
        for seed in (7, 8):
            np.testing.assert_array_equal(
                bench.weighted_subsample_no_replacement(w, k, seed),
                ref.weighted_subsample_no_replacement(w, k, seed))


def test_fresh_process_loads_no_jax(tmp_path):
    code = ("import json, runpy, sys\n"
            "sys.argv = ['bench', *sys.argv[1:]]\n"
            "try:\n"
            "    runpy.run_module('linearham_tpu_torch.tools.bench', "
            "run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    if e.code:\n"
            "        raise\n"
            "print(json.dumps([m for m in sys.modules if m in ('jax', "
            "'linearham_tpu') or m.startswith(('jax.', 'jaxlib', "
            "'linearham_tpu.'))]), file=sys.stderr)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "probe", "--device", "cpu", "--seqs",
         "2", "--chunk", "4"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["mode"] == "probe"
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == []
