"""Cells, configurations, traffic mixes, limits and metrics are found by
name, so a later cell or metric is added as files alone."""

import json
import os
import shutil

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "BENCHMARK.json")


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["num_rates"] == 4
        assert cell.traffic["entry"] in ("repertoire", "pipeline")
        assert set(cell.limits) == {"loglik_rel_gap", "bad_rows"}
        # The window's rate is end to end only where it holds still.
        rate = {"trees_per_s"} if w["name"] == "ch103.serve" else set()
        assert {m["name"] for m in cell.end_to_end} == rate | {
            "setup_s", "device_memory_peak_mb"}
        assert cell.per_layer, w["name"]


def test_metric_files_match_benchmark_json():
    for m in _bench()["per_layer"]:
        mod = harness.metric_module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES,
                mod.WORKLOADS) == (m["unit"], m["layer"], m["source"],
                                   m["moves"], m["workloads"])


def test_cell_added_in_a_temp_dir_is_found(tmp_path):
    root = tmp_path / "repo"
    base = root / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub), base / sub)
    bench = _bench()
    bench["configs"].append(dict(bench["configs"][0], name="igh-tiny",
                                 file="benchmark/configs/igh-tiny.json"))
    bench["workloads"].append({"name": "tiny.cold", "config": "igh-tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tiny_metric", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "start-up", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((base / "configs" / "igh-partition.json").read_text())
    (base / "configs" / "igh-tiny.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"entry": "pipeline", "family_cache": "warm", "vary": "trees",
         "pool": 1, "check_rows": 4, "reference_block": 4}))
    (base / "limits" / "tiny.cold.json").write_text(json.dumps(
        {"loglik_rel_gap": 1e-5, "bad_rows": 0}))
    (base / "metrics" / "tiny_metric.py").write_text(
        "UNIT = 's'\nLAYER = 'start-up'\nSOURCE = 'host_clock'\n"
        "MOVES = 'setup_s'\nWORKLOADS = None\n\n"
        "def read(run):\n    return run.import_s * 2\n")
    cell = harness.find_cell("tiny.cold", root=str(root), base=str(base))
    assert cell.traffic["pool"] == 1 and cell.config["locus"] == "igh"
    # A metric without "workloads" goes to every cell reporting its moves.
    assert "tiny_metric" in [m["name"] for m in cell.per_layer]
    other = harness.find_cell("partition.cold", root=str(root),
                              base=str(base))
    assert "tiny_metric" in [m["name"] for m in other.per_layer]
    mod = harness.metric_module("tiny_metric", base=str(base))
    record = harness.RunRecord("tiny.cold", [], 0, 1.0, 0.25)
    assert mod.read(record) == 0.5
