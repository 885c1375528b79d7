"""The light-chain cell ``igk-partition.cold`` on the CPU: a small igk
partition of four families of different depths (short genes, few trees)
through the port's ``cli repertoire``, judged by the harness's comparison
against the plain reference; a fault planted in the V-J junction's
transition table; and the control at a small size."""

import copy
import os

import numpy as np
import pytest

from benchmark import check, control, drivers, harness
from benchmark.tests.conftest import tiny_cell

CELL = "igk-partition.cold"


def _small_partition():
    """The cell with V genes cut to 120-123 sites and four families of 3-9
    sequences and 6 trees each, one pool item, run in f64 (the port's CPU
    conformance path)."""
    cell = harness.find_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["precision"] = "f64"
    cfg["germline"]["V"] = [[name, length - 167]
                            for name, length in cfg["germline"]["V"]]
    cfg["families"] = [dict(f, seqs=s, trees=6) for f, s in
                       zip(cfg["families"], (3, 5, 7, 9))]
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool=1)
    return cell


def _judge_a_job(tmp_path, cell, seed=2 ** 35 + 11):
    """One repertoire job of the cell through ``cli repertoire`` on the CPU
    (float64), its outputs judged as a run judges them."""
    pool = drivers.make_pool(str(tmp_path), cell.config, cell.traffic, seed)
    driver = drivers.Driver(str(tmp_path), cell.config, cell.traffic, pool,
                            seed, "cpu", stages=False)
    try:
        job = driver.run(0)
    finally:
        driver.close()
    assert job.families == 4 and job.trees == 24
    collector = check.Collector(4, False, np.random.default_rng(seed), 6)
    collector.take(0, job.outputs)
    assert not any(os.path.exists(o.out_path) for o in job.outputs)
    return check.compare(collector, "cpu", 5)


def test_a_small_igk_partition_is_correct(tmp_path, family_cache_env):
    v = _judge_a_job(tmp_path, _small_partition())
    limits = harness.find_cell(CELL).limits
    assert v.rows_read == 24 and v.rows_sampled == 24
    assert v.bad_rows == 0, v.reasons
    assert v.loglik_rel_gap < 1e-12 < limits["loglik_rel_gap"]


def test_a_fault_in_the_vj_junction_table_is_caught(tmp_path,
                                                    family_cache_env,
                                                    monkeypatch):
    """The V-J junction's transition table (``vd`` on a light chain) a
    tenth short in the program: the judged job comes out not correct."""
    from linearham_tpu_torch.models import phylo_hmm

    compile_family = phylo_hmm.compile_family

    def faulty(space, genes):
        family = compile_family(space, genes)
        assert not space.is_heavy
        family.trans.vd = family.trans.vd * 0.9
        return family

    monkeypatch.setattr(phylo_hmm, "compile_family", faulty)
    v = _judge_a_job(tmp_path, _small_partition())
    limits = harness.find_cell(CELL).limits
    assert v.loglik_rel_gap > limits["loglik_rel_gap"] \
        or v.bad_rows > limits["bad_rows"]


def test_the_control_fails_the_igk_check():
    """The reference in float32 with TF32 matmul inputs, in the program's
    place, comes out not correct under the cell's limits (two families of
    25 sequences; ``benchmark/control.py`` runs it at the cell's size)."""
    cell = tiny_cell(CELL, seqs=25, trees=16, families=2, precision="f32")
    v = control.control(cell, 2 ** 33 + 17, 32, device="cpu")
    limits = harness.find_cell(CELL).limits
    assert v.loglik_rel_gap > limits["loglik_rel_gap"] \
        or v.bad_rows > limits["bad_rows"]


@pytest.mark.cuda
def test_the_control_fails_the_igk_check_at_the_cells_size(cuda_device):
    """The same at the cell's own size on the card, one seed."""
    cell = harness.find_cell(CELL)
    v = control.control(cell, 2 ** 33 + 17, 320, device=cuda_device)
    assert v.loglik_rel_gap > cell.limits["loglik_rel_gap"] \
        or v.bad_rows > cell.limits["bad_rows"]
