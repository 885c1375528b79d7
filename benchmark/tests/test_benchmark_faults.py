"""A whole run on the CPU, the look for a card skipped, with the timed
path broken underneath: ``correct`` has to come out false."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_cell


def _run(cell, capsys, seed=2 ** 31 + 5):
    rc = harness.main(["--workload", cell.name, "--seed", str(seed),
                       "--seconds", "0.2", "--trace", "0"], device="cpu",
                      cell=cell)
    assert rc == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert out.err.strip().splitlines()[-1].startswith("check bad_rows")
    return result


def _pipeline_cell():
    return tiny_cell("ch103.serve", seqs=5, trees=12, families=1)


def test_a_sound_run_is_correct(capsys):
    result = _run(_pipeline_cell(), capsys)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert result["check"]["bad_rows"] == {"value": 0, "limit": 0}


def test_a_sound_warm_pool_run_is_correct(capsys):
    """Three warm families, built in set-up, judged whole."""
    result = _run(tiny_cell("partition.serve", seqs=4, trees=10), capsys)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1


def test_a_sound_repertoire_run_is_correct(capsys):
    result = _run(tiny_cell("partition.cold", seqs=4, trees=10), capsys)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "device_memory_peak_mb"}


def test_log_likelihoods_altered_where_produced(capsys, monkeypatch):
    from linearham_tpu_torch.models import phylo_hmm

    forward = phylo_hmm.forward

    def altered(*a, **k):
        loglik, cache = forward(*a, **k)
        return loglik * (1 + 1e-4), cache

    monkeypatch.setattr(phylo_hmm, "forward", altered)
    result = _run(_pipeline_cell(), capsys)
    assert result["correct"] is False
    assert result["check"]["loglik_rel_gap"]["value"] > \
        result["check"]["loglik_rel_gap"]["limit"]


def test_an_annotation_altered_where_produced(capsys, monkeypatch):
    from linearham_tpu_torch.models import phylo_hmm

    decode = phylo_hmm.decode_paths_batch

    def altered(*a, **k):
        anns = decode(*a, **k)
        for ann in anns:
            ann.d_5p_del += 1
        return anns

    monkeypatch.setattr(phylo_hmm, "decode_paths_batch", altered)
    result = _run(_pipeline_cell(), capsys)
    assert result["correct"] is False
    assert result["check"]["bad_rows"]["value"] > 0


def test_sampled_paths_altered_where_produced(capsys, monkeypatch):
    """Paths drawn at random instead of from the posterior: the decoded
    columns are self-consistent, but most paths have probability 0."""
    from linearham_tpu_torch.models import phylo_hmm

    sample = phylo_hmm.sample_path

    def altered(generator, trans, cache, heavy):
        path = sample(generator, trans, cache, heavy)
        g = np.random.default_rng(0)
        vd = path.vd_idx
        shuffled = vd[:, g.permutation(vd.shape[1])]
        return path._replace(vd_idx=shuffled)

    monkeypatch.setattr(phylo_hmm, "sample_path", altered)
    result = _run(_pipeline_cell(), capsys)
    assert result["correct"] is False
    assert result["check"]["bad_rows"]["value"] > 0


@pytest.mark.parametrize("entry", ["ch103.serve", "partition.cold",
                                   "partition.serve"])
def test_half_of_the_trees_left_out(capsys, monkeypatch, entry):
    from linearham_tpu_torch.io import trees_tsv
    from linearham_tpu_torch.pipeline import run

    load = trees_tsv.load_tree_samples

    def half(path):
        s = load(path)
        return s[:max(1, s.n_samples // 2)]

    monkeypatch.setattr(trees_tsv, "load_tree_samples", half)
    monkeypatch.setattr(run, "load_tree_samples", half)
    cell = _pipeline_cell() if entry == "ch103.serve" else \
        tiny_cell(entry, seqs=4, trees=10)
    result = _run(cell, capsys)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
