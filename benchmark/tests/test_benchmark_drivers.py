"""What the drivers hand the program: the configuration's precision, and a
warm pipeline pool built whole before the window."""

import copy
import json
import os
import types

import pytest

from benchmark import drivers, harness
from benchmark.tests.conftest import tiny_cell


def _driver(tmp_path, cell, seed=2 ** 31 + 77, device="cpu"):
    pool = drivers.make_pool(str(tmp_path), cell.config, cell.traffic, seed)
    return drivers.Driver(str(tmp_path), cell.config, cell.traffic, pool,
                          seed, device, stages=False)


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_the_repertoire_argv_carries_the_precision(tmp_path, monkeypatch,
                                                   family_cache_env,
                                                   precision):
    from linearham_tpu_torch import cli

    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 0)
    driver = _driver(tmp_path, tiny_cell("partition.cold", seqs=3, trees=4,
                                         families=2, precision=precision))
    try:
        driver.run(0)
    finally:
        driver.close()
    [argv] = seen
    assert argv[argv.index("--precision") + 1] == precision


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_the_pipeline_call_carries_the_precision(tmp_path, monkeypatch,
                                                 family_cache_env,
                                                 precision):
    from linearham_tpu_torch.pipeline import run

    seen = []

    def fake(*args, **kwargs):
        seen.append(kwargs)
        return types.SimpleNamespace(timings={})

    monkeypatch.setattr(run, "run_pipeline", fake)
    driver = _driver(tmp_path, tiny_cell("ch103.serve", seqs=3, trees=4,
                                         families=1, precision=precision))
    try:
        driver.run(0)
    finally:
        driver.close()
    assert [k["precision"] for k in seen] == [precision]


@pytest.mark.parametrize("stated", [None, "auto", "bf16"])
def test_a_configuration_without_a_precision_fails_at_set_up(capsys, stated):
    """No silent fallback to the port's ``auto``: the run stops in set-up,
    before any job, and prints no result."""
    cell = tiny_cell("ch103.serve", seqs=3, trees=4, families=1)
    cfg = copy.deepcopy(cell.config)
    if stated is None:
        del cfg["precision"]
    else:
        cfg["precision"] = stated
    cell.config = cfg
    with pytest.raises(ValueError, match="precision"):
        harness.main(["--workload", cell.name, "--seed", "5", "--seconds",
                      "0.1"], device="cpu", cell=cell)
    assert not capsys.readouterr().out.strip()


@pytest.mark.parametrize("entry", ["ch103.serve", "partition.cold"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_the_stated_precision_reaches_the_port(tmp_path, monkeypatch,
                                               family_cache_env, entry,
                                               precision):
    """A real job on the CPU (whose ``auto`` is f64): every family the
    program places is in the stated precision."""
    import torch

    from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

    place = PhyloHMM.from_host_products.__func__
    dtypes = []

    def spy(cls, host, device=None, dtype=None, seed=0):
        dtypes.append(dtype)
        return place(cls, host, device, dtype, seed)

    monkeypatch.setattr(PhyloHMM, "from_host_products", classmethod(spy))
    driver = _driver(tmp_path, tiny_cell(entry, seqs=3, trees=4, families=2,
                                         precision=precision))
    try:
        job = driver.run(0)
    finally:
        driver.close()
    want = {"f32": torch.float32, "f64": torch.float64}[precision]
    assert dtypes and set(dtypes) == {want}
    assert job.trees == 4 * len(dtypes)


@pytest.mark.parametrize("name,families", [("partition.serve", 3),
                                           ("ch103.serve", 1)])
def test_a_warm_pipeline_pool_is_built_whole_in_set_up(tmp_path, monkeypatch,
                                                       family_cache_env,
                                                       name, families):
    """The warm-up makes one request for each family of the first pool
    item, and then no request of the window builds a family: every one
    finds its family in the cache (``ch103.serve``'s one family: one
    warm-up request, as before)."""
    from linearham_tpu_torch.compiler import family_cache
    from linearham_tpu_torch.pipeline import run

    built, requests = [], []
    load = family_cache.load_host_products
    pipeline = run.run_pipeline

    def counted_load(yaml_path, *args, **kwargs):
        built.append(yaml_path)
        return load(yaml_path, *args, **kwargs)

    def counted_pipeline(*args, **kwargs):
        requests.append(args[0])
        return pipeline(*args, **kwargs)

    monkeypatch.setattr(family_cache, "load_host_products", counted_load)
    monkeypatch.setattr(run, "run_pipeline", counted_pipeline)
    cell = tiny_cell(name, seqs=3, trees=4, families=families)
    assert cell.traffic["family_cache"] == "warm"
    driver = _driver(tmp_path, cell)
    try:
        warm = driver.warm_up()
        driver.discard(warm)
        assert warm.families == families and warm.trees == 4 * families
        assert len(requests) == families
        assert sorted(built) == sorted(
            f.yaml_path for f in driver.pool[0].families)
        window = [driver.run(k) for k in range(2 * families)]
    finally:
        driver.close()
    assert len(built) == families            # no miss in the window
    assert [j.families for j in window] == [1] * (2 * families)
    # The window's requests cycle through every family of both pool items.
    assert {o.trees_path for j in window for o in j.outputs} == {
        f.trees_path for item in driver.pool for f in item.families}


def test_the_configurations_state_a_precision():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as fh:
            assert json.load(fh)["precision"] in drivers.PRECISIONS, c["name"]
