"""The port's (fam, trees) mesh (parallel/mesh.py, the mesh half of
parallel/multihost.py, parallel/dryrun.py) against the JAX package, on the
CPU.

One module fixture runs four gloo processes (``dryrun.launch_ranks``: an
explicit free port, a group timeout, every rank stopped on the first
failure or after 120 s).  Each rank builds the port's families from the
fixture YAMLs (f64) and runs

* ``run_repertoire`` on the fixture families of tests/test_repertoire.py
  and on its ragged 5/7/9 + igk repertoire, under a (2, 2) and a (4, 1)
  mesh and without one;
* ``pooled_repertoire_summary`` on the (2, 2) mesh over the [4, 8] data of
  tests/test_repertoire.py::test_pooled_repertoire_summary;
* ``global_family_mesh`` at 1 and 2 tree shards, one that does not split,
  and ``initialize`` a second time.

The test process holds the ranks' results against the JAX package's
``run_repertoire(mesh=make_mesh(2, 2))`` and ``pooled_repertoire_summary``
on the conftest's 8 virtual CPU devices (rtol 1e-9 and 1e-12), against the
port's own unsharded run (1e-12), and against each other.  jax is imported
inside the tests only: the rank processes import this module.
"""

import pathlib

import numpy as np
import pytest
import torch

from linearham_tpu.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.parallel.dryrun import dryrun_multigpu, launch_ranks
from linearham_tpu_torch.parallel.mesh import (FamilyBlock, FamilyMesh,
                                               make_mesh, shard_family_batch)
from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                     run_repertoire)

torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).resolve().parent
FIXTURES = TESTS / "fixtures"
RANK_TIMEOUT = 120
# (yaml, germline dir, trees, TSV seed): tests/test_repertoire.py's sets.
SETS = {
    "fixture": [("phylo_hmm_input.yaml", "hmm_params", 4, 11),
                ("phylo_hmm_input_extra.yaml", "hmm_params", 4, 12),
                ("phylo_hmm_input.yaml", "hmm_params", 4, 13),
                ("phylo_hmm_input_igk.yaml", "igk_hmm_params", 4, 14)],
    "ragged": [("phylo_hmm_input.yaml", "hmm_params", n, 40 + i)
               for i, n in enumerate((5, 7, 9))]
    + [("phylo_hmm_input_igk.yaml", "igk_hmm_params", 6, 50)],
}
MESHES = [(2, 2), (4, 1)]


def _summary_data():
    rng = np.random.default_rng(0)
    return rng.normal(-1000.0, 5.0, size=(4, 8)), \
        rng.normal(-1010.0, 5.0, size=(4, 8))


def _port_tasks(entries):
    return [FamilyTask(hmm=PhyloHMM(str(FIXTURES / y), 0, str(FIXTURES / p),
                                    device="cpu"),
                       samples=load_tree_samples(tsv))
            for y, p, tsv in entries]


def _results(results):
    return [(r.loglik, r.logweight, [a.naive_seq for a in r.annotations])
            for r in results]


def _mesh_rank(devices, payload):
    """One rank of the 4-process run (see the module docstring)."""
    import torch.distributed as dist

    from linearham_tpu_torch.parallel import multihost
    from linearham_tpu_torch.parallel.mesh import (pooled_repertoire_summary,
                                                   span)

    torch.set_num_threads(1)
    sets = {name: _port_tasks(entries)
            for name, entries in payload["sets"].items()}
    out = {"rank": dist.get_rank()}
    for shape in MESHES:
        mesh = make_mesh(*shape, devices=devices)
        out[shape] = {name: _results(run_repertoire(tasks, seed=0, mesh=mesh))
                      for name, tasks in sets.items()}
        if shape == (2, 2):
            ll, rb = _summary_data()
            f, t = mesh.coords
            rows, cols = span(4, f, 2), span(8, t, 2)
            out["pooled"] = pooled_repertoire_summary(
                mesh, ll[rows, cols], rb[rows, cols])
            out["coords"] = mesh.coords
    out["alone"] = {name: _results(run_repertoire(tasks, seed=0,
                                                  device="cpu"))
                    for name, tasks in sets.items()}
    meshes = [multihost.global_family_mesh(device="cpu"),
              multihost.global_family_mesh(n_tree_shards=2, device="cpu")]
    out["global"] = [(m.shape, m.axis_names, m.coords) for m in meshes]
    with pytest.raises(ValueError, match="do not split") as err:
        multihost.global_family_mesh(n_tree_shards=3, device="cpu")
    out["split_error"] = str(err.value)
    group = dist.group.WORLD
    multihost.initialize(init_method="tcp://localhost:1", world_size=4,
                         rank=0)
    out["same_group"] = dist.group.WORLD is group
    return out


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    from test_torch_pipeline import _make_tsv

    tmp = tmp_path_factory.mktemp("mesh")
    out = {}
    for name, specs in SETS.items():
        out[name] = []
        for i, (yaml_name, params, n_rows, seed) in enumerate(specs):
            path = tmp / f"{name}_{i}.tsv"
            _make_tsv(path, n_rows=n_rows, seed=seed)
            out[name].append((yaml_name, params, str(path)))
    return out


@pytest.fixture(scope="module")
def ranks(tsvs):
    return launch_ranks(4, "test_torch_mesh:_mesh_rank", {"sets": tsvs},
                        backend="gloo", timeout=RANK_TIMEOUT,
                        pythonpath=[str(TESTS)], threads=1)


def _assert_same(got, want, rtol):
    assert len(got) == len(want)
    for (ll, lw, seqs), (ll_w, lw_w, seqs_w) in zip(got, want):
        np.testing.assert_allclose(ll, ll_w, rtol=rtol, atol=0)
        np.testing.assert_allclose(lw, lw_w, rtol=rtol, atol=0)
        assert len(seqs) == len(seqs_w)


@pytest.mark.parametrize("name", list(SETS))
def test_mesh_repertoire_matches_jax_and_unsharded(ranks, tsvs, name):
    """(2, 2) over four processes: every rank returns every family, equal
    to the JAX package's run on its (2, 2) mesh at rtol 1e-9 and to the
    port's unsharded run at 1e-12."""
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from linearham_tpu.parallel.repertoire import FamilyTask as JaxTask
    from linearham_tpu.parallel.repertoire import \
        run_repertoire as jax_run_repertoire

    jax_tasks = [JaxTask(hmm=JaxPhyloHMM(str(FIXTURES / y), 0,
                                         str(FIXTURES / p), seed=0),
                         samples=load_tree_samples(tsv))
                 for y, p, tsv in tsvs[name]]
    want = jax_run_repertoire(jax_tasks, num_rates=4, seed=0,
                              mesh=jax_make_mesh(2, 2))
    want = [(w.loglik, w.logweight, [a.naive_seq for a in w.annotations])
            for w in want]
    for r in ranks:
        _assert_same(r[(2, 2)][name], want, 1e-9)
        _assert_same(r[(2, 2)][name], r["alone"][name], 1e-12)
        for got, task in zip(r[(2, 2)][name], jax_tasks):
            assert len(got[2]) == task.samples.n_samples
            assert all(len(s) == task.hmm.cluster.n_sites for s in got[2])
    first = ranks[0][(2, 2)][name]
    for r in ranks[1:]:
        for a, b in zip(r[(2, 2)][name], first):
            assert np.array_equal(a[0], b[0]) and a[2] == b[2]


@pytest.mark.parametrize("name", list(SETS))
def test_families_only_mesh_draws_the_unsharded_samples(ranks, name):
    """Under (4, 1) each family runs whole on one rank with its own
    generator: the sampled naive sequences equal the unsharded run's."""
    for r in ranks:
        got, alone = r[(4, 1)][name], r["alone"][name]
        _assert_same(got, alone, 1e-12)
        assert [g[2] for g in got] == [a[2] for a in alone]


def test_pooled_summary_on_the_mesh_matches_jax_and_numpy(ranks):
    import jax.numpy as jnp

    from linearham_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from linearham_tpu.parallel.mesh import \
        pooled_repertoire_summary as jax_summary

    ll, rb = _summary_data()
    want = jax_summary(jax_make_mesh(2, 4), jnp.asarray(ll), jnp.asarray(rb))
    lw = ll - rb
    e = np.exp(lw - lw.max(axis=1, keepdims=True))
    oracle = {"n_trees": 32.0, "mean_logweight": lw.mean(),
              "mean_family_ess": (e.sum(1) ** 2 / (e * e).sum(1)).mean()}
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in ranks:
        for k, v in oracle.items():
            assert r["pooled"][k] == pytest.approx(v, rel=1e-12)
            assert r["pooled"][k] == pytest.approx(want[k], rel=1e-12)


def test_global_family_mesh_and_initialize_twice(ranks):
    for rank, r in enumerate(ranks):
        (one, names, c1), (two, _, c2) = r["global"]
        assert one == {"fam": 4, "trees": 1} and c1 == (rank, 0)
        assert two == {"fam": 2, "trees": 2} and c2 == divmod(rank, 2)
        assert names == ("fam", "trees")
        assert r["split_error"] == "4 devices do not split into 3 tree " \
                                   "shards"
        assert r["same_group"]


def test_a_mesh_of_one_without_a_group(tsvs):
    """No process group: make_mesh(1, 1) runs no collective and equals no
    mesh; make_mesh(2, 1) needs two ranks."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = make_mesh(1, 1, devices=["cpu"])
    assert mesh.mesh_group is None and mesh.coords == (0, 0)
    tasks = _port_tasks(tsvs["ragged"])
    _assert_same(_results(run_repertoire(tasks, mesh=mesh)),
                 _results(run_repertoire(tasks, device="cpu")), 0)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, 1)


def test_no_cpu_fallback_without_a_gpu(monkeypatch):
    """Without a GPU, a mesh or a dry run whose devices are not named
    raises instead of running on the CPU."""
    from linearham_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_family_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multigpu(2, backend="gloo")
    assert make_mesh(1, 1, devices=["cpu"]).device == torch.device("cpu")


@pytest.mark.parametrize("shape", [(2, 2), (3, 1), (1, 3), (2, 3)])
def test_shard_family_batch_covers_each_tree_once(shape):
    """Families split contiguously over "fam", each family's trees over
    "trees"; empty shares are dropped, nothing is padded."""
    tasks = [object()] * 5
    sizes = [5, 7, 1, 0, 2]
    blocks = [FamilyBlock(i, tasks[i], slice(0, n))
              for i, n in enumerate(sizes)]
    seen = {i: [] for i in range(5)}
    for rank in range(shape[0] * shape[1]):
        mesh = FamilyMesh(shape={"fam": shape[0], "trees": shape[1]},
                          rank=rank, device=torch.device("cpu"))
        for b in shard_family_batch(mesh, blocks):
            assert b.n_trees > 0
            seen[b.index].extend(range(b.trees.start, b.trees.stop))
    assert {i: sorted(v) for i, v in seen.items()} == \
        {i: list(range(n)) for i, n in enumerate(sizes)}


def test_dryrun_multigpu_on_two_gloo_ranks(capsys):
    out = dryrun_multigpu(2, backend="gloo", devices=["cpu"] * 2,
                          timeout=RANK_TIMEOUT)
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multigpu ok: mesh=(2, 1) backend=gloo")
    assert "ragged_bucket_parity=ok" in line
    for r in out["reports"]:
        assert r["mesh"] == (2, 1) and r["shape"] == (2, 8)
        assert 1.5 < r["summary"]["mean_family_ess"] < 7.5
        assert r["ragged_max_abs"] <= 1e-12


def _failing_rank(devices, payload):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()         # rank 0 waits here until it is stopped


def test_a_failing_rank_stops_the_run():
    with pytest.raises(RuntimeError, match="rank 1 exited 1") as err:
        launch_ranks(2, "test_torch_mesh:_failing_rank", backend="gloo",
                     timeout=RANK_TIMEOUT, pythonpath=[str(TESTS)],
                     threads=1)
    assert "ValueError: rank 1 gives up" in str(err.value)
