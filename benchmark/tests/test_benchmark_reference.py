"""The plain reference against the port's CPU path (float64) on tiny
families, a fault in the port's compiler, the sample, and the control."""

import os

import numpy as np
import pytest

from benchmark import check, control, drivers
from benchmark.tests.conftest import tiny_cell


def _pool_outputs(tmp_path, cell, seed):
    pool = drivers.make_pool(str(tmp_path), cell.config, cell.traffic, seed)
    return [check.Output(f.yaml_path, item.gene_dir, f.trees_path,
                         os.path.join(str(tmp_path), f"out{p}_{i}.tsv"),
                         f.n_seqs)
            for p, item in enumerate(pool)
            for i, f in enumerate(item.families)]


def _run_port(outs):
    from linearham_tpu_torch.pipeline.run import run_pipeline

    for k, o in enumerate(outs):
        run_pipeline(o.yaml_path, 0, o.gene_dir, o.trees_path, o.out_path,
                     4, seed=k, device="cpu")


def _judge(outs, heavy=True, rows_per_output=6, block=5):
    c = check.Collector(4, heavy, np.random.default_rng(3), rows_per_output)
    for k, o in enumerate(outs):
        c.take(k, [o])
    return check.compare(c, "cpu", block)


@pytest.mark.parametrize("name", ["partition.cold", "ch103.serve",
                                  "partition.serve"])
def test_reference_matches_the_port_on_the_cpu(tmp_path, family_cache_env,
                                              name):
    cell = tiny_cell(name, seqs=6, trees=10, families=2)
    outs = _pool_outputs(tmp_path, cell, 2 ** 31 + 99)[:2]
    _run_port(outs)
    v = _judge(outs)
    assert v.rows_read == 20 and v.rows_sampled == 12
    assert v.bad_rows == 0, v.reasons
    assert v.loglik_rel_gap < 1e-12
    assert not any(os.path.exists(o.out_path) for o in outs)


def test_a_light_chain_family_is_judged_too(tmp_path, family_cache_env):
    from benchmark import gen

    rng = np.random.default_rng(5)
    gl = gen.make_germline(rng, "igk", V=[["IGKV1-39*01", 120],
                                          ["IGKV3-20*01", 117]],
                           J=[["IGKJ1*01", 38], ["IGKJ2*01", 40]])
    gene_dir = str(tmp_path / "genes")
    gen.write_gene_dir(gl.genes, gene_dir)
    fam = gen.make_family(rng, gl, 5, 0.05)
    yaml_path, trees = str(tmp_path / "p.yaml"), str(tmp_path / "t.tsv")
    gen.write_partis_yaml(fam, yaml_path)
    gen.write_trees_tsv(rng, fam, 8, trees)
    out = check.Output(yaml_path, gene_dir, trees, str(tmp_path / "o.tsv"),
                       5)
    _run_port([out])
    v = _judge([out], heavy=False, rows_per_output=8, block=4)
    assert v.rows_sampled == 8
    assert v.bad_rows == 0, v.reasons
    assert v.loglik_rel_gap < 1e-12


def test_the_reference_counts_the_ports_xmsa_columns(tmp_path):
    """Its emission columns, one per site and naive base some state
    needs, are the port's xMSA columns, counted independently."""
    import torch

    from linearham_tpu_torch.compiler.state_space import build_state_space
    from linearham_tpu_torch.compiler.xmsa import build_xmsa
    from linearham_tpu_torch.io.germline import load_gene_map
    from linearham_tpu_torch.io.partis import load_cluster

    from benchmark.reference.model import FamilyModel

    for name in ("partition.cold", "ch103.serve"):
        cell = tiny_cell(name, seqs=4, trees=2, families=1)
        out = _pool_outputs(tmp_path / name, cell, 7)[0]
        m = FamilyModel.build(out.yaml_path, 0, out.gene_dir, "cpu",
                              torch.float64)
        cl = load_cluster(out.yaml_path, 0)
        space = build_state_space(cl.locus, cl.flexbounds, cl.relpos,
                                  load_gene_map(out.gene_dir))
        x = build_xmsa(space, cl.msa_codes("ACGTN"), cl.unique_ids)
        assert m.n_cols == x.n_cols
        assert (m.first, m.last) == (0, cl.n_sites)


@pytest.mark.parametrize("fault", ["junction_step", "germline_fold"])
def test_a_fault_in_the_ports_compiler_is_caught(tmp_path, family_cache_env,
                                                monkeypatch, fault):
    """The reference lays out its own states and steps, so a wrong
    transition table in the program shows as a gap."""
    from linearham_tpu_torch.models import phylo_hmm

    compile_family = phylo_hmm.compile_family

    def faulty(space, genes):
        family = compile_family(space, genes)
        t = family.trans
        if fault == "junction_step":
            t.vd = t.vd * 0.9                  # every junction step
        else:
            t.dj_jgerm = t.dj_jgerm ** 0.5     # the J run's fold
        return family

    monkeypatch.setattr(phylo_hmm, "compile_family", faulty)
    cell = tiny_cell("ch103.serve", seqs=6, trees=10, families=1)
    outs = _pool_outputs(tmp_path, cell, 31)[:1]
    _run_port(outs)
    v = _judge(outs)
    assert v.loglik_rel_gap > 1e-3 or v.bad_rows > 0


def test_every_output_gives_rows(tmp_path, family_cache_env):
    """The sample is drawn output by output, so every job is held
    against the reference."""
    cell = tiny_cell("partition.cold", seqs=4, trees=10, families=3)
    outs = _pool_outputs(tmp_path, cell, 11)
    _run_port(outs)
    c = check.Collector(4, True, np.random.default_rng(0), 2)
    for k, o in enumerate(outs):
        c.take(k, [o])
    assert sorted({k.output for k in c.kept}) == list(range(len(outs)))
    assert len(c.kept) == 2 * len(outs)


def test_the_control_machinery_is_sound_in_float64(tmp_path):
    """The control's writer, its drawn paths and their columns, run in
    float64: the comparison finds nothing wrong."""
    import torch

    for name in ("partition.cold", "ch103.serve"):
        cell = tiny_cell(name, seqs=5, trees=6, families=2)
        v = control.control(cell, 2 ** 40 + 3, 12, device="cpu",
                            dtype=torch.float64, tf32=False)
        assert v.rows_sampled >= 12
        assert v.bad_rows == 0, v.reasons
        assert v.loglik_rel_gap < 1e-12


@pytest.mark.parametrize("name,seqs", [("partition.cold", 25),
                                       ("ch103.serve", 40),
                                       ("partition.serve", 25)])
def test_the_control_fails_the_check(name, seqs):
    """The reference in float32 with TF32 matmul inputs, put in the
    program's place, comes out not correct through the harness's
    comparison (here on two small families; benchmark/control.py and the
    cuda test run it at the cells' own sizes)."""
    from benchmark import harness

    cell = tiny_cell(name, seqs=seqs, trees=16, families=2,
                     precision="f32")
    v = control.control(cell, 2 ** 33 + 17, 32, device="cpu")
    limits = harness.find_cell(name).limits
    assert v.loglik_rel_gap > limits["loglik_rel_gap"] \
        or v.bad_rows > limits["bad_rows"]


@pytest.mark.cuda
def test_the_control_fails_the_check_at_the_cells_size(cuda_device):
    """The same at each cell's own size on the card, one seed (a few
    minutes)."""
    from benchmark import harness

    for name in ("partition.cold", "ch103.serve", "partition.serve"):
        cell = harness.find_cell(name)
        v = control.control(cell, 2 ** 33 + 17, 320, device=cuda_device)
        assert v.loglik_rel_gap > cell.limits["loglik_rel_gap"] \
            or v.bad_rows > cell.limits["bad_rows"]


@pytest.mark.parametrize("precision,rounded", [("f32", True),
                                               ("f64", False)])
def test_the_control_runs_one_precision_below_the_configuration(
        monkeypatch, precision, rounded):
    """Below ``f32`` the control is float32 with TF32 matmul inputs; below
    ``f64`` it is float32 with TF32 off."""
    import torch

    from benchmark.reference import model

    built = []
    build = model.FamilyModel.build.__func__

    def spy(cls, *args, **kwargs):
        built.append(build(cls, *args, **kwargs))
        return built[-1]

    monkeypatch.setattr(model.FamilyModel, "build", classmethod(spy))
    cell = tiny_cell("ch103.serve", seqs=3, trees=4, families=1,
                     precision=precision)
    control.control(cell, 2 ** 33 + 5, 4, device="cpu")
    programs = [m for m in built if m.dtype == torch.float32]
    assert programs and len(programs) == len(built) - 1   # + the judge's
    assert all((m.matmul_input is model.tf32) == rounded for m in programs)
