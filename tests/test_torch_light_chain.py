"""Light-chain (igk/igl) 5-region path of the port: brute-force oracle and
sampling.

The mirror of tests/test_light_chain.py through ``linearham_tpu_torch``: the
V-J chain (no D segment, one junction) held to an exhaustive enumeration
of its paths written with plain Python loops, for the star-tree SimpleHMM
and for the phylo-HMM's pipeline path over a posterior TSV; FFBS draws
held to the enumeration's posterior; and the light-chain TSV columns.
The port's code path imports no JAX; the oracle reads only the model's
tensors.
"""

import io
import itertools
import pathlib

import numpy as np
import pytest
import torch

from linearham_tpu_torch.io.germline import load_gene_map
from linearham_tpu_torch.io.output_tsv import write_output_tsv
from linearham_tpu_torch.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.models import SimpleHMM
from linearham_tpu_torch.models.phylo_hmm import (PhyloHMM,
                                                  naive_prior_correction,
                                                  region_emissions)
from linearham_tpu_torch.models.step import Prepared, launch, stack_blocks
from linearham_tpu_torch.ops.ffbs import path_to_numpy, sample_path
from linearham_tpu_torch.ops.forward import widen_cache
from linearham_tpu_torch.pipeline.run import run_pipeline_arrays

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
GENES = str(FIXTURES / "igk_hmm_params")


def _fixture(name, locus, tmp_path):
    """The fixture YAML ``name``, its locus rewritten to ``locus`` (igl has
    the igk fixtures' shape; the germline directory is the same)."""
    src = FIXTURES / name
    if locus == "igk":
        return str(src)
    dst = tmp_path / f"{locus}_{name}"
    dst.write_text(src.read_text().replace('"locus": "igk"',
                                           f'"locus": "{locus}"'))
    return str(dst)


def _paths(trans, emis):
    """Every (V germline state, V-J junction path, J germline state) of
    the chain with its probability, by exhaustive enumeration.  ``trans``
    and ``emis`` are numpy, emissions without the tree axis."""
    n_rows, S = emis["vd_junction"].shape
    with np.errstate(divide="ignore"):
        v_entry = np.exp(trans["vgerm_static_log"] + emis["vpadding"]
                         + emis["vgerm"])
        j_exit = np.exp(trans["jpadding_log"] + emis["jgerm"]
                        + emis["jpadding"])
        junction = np.exp(emis["vd_junction"])
    for g in range(v_entry.shape[0]):
        for path in itertools.product(range(S), repeat=n_rows):
            p = v_entry[g] * trans["vgerm_vd"][g, path[0]] \
                * junction[0, path[0]]
            for i in range(1, n_rows):
                p *= trans["vd"][path[i - 1], path[i]] * junction[i, path[i]]
            if p == 0.0:
                continue
            for j in range(j_exit.shape[0]):
                q = p * trans["vd_dgerm"][path[-1], j] * j_exit[j]
                if q > 0.0:
                    yield (g, path, j), q


def _brute_force_loglik(trans, emis):
    return np.log(sum(p for _, p in _paths(trans, emis)))


def _numpy(tensors, tree=None):
    return {k: v.numpy() if tree is None else v.numpy()[tree]
            for k, v in tensors.items()}


@pytest.fixture(params=["igk", "igl"])
def light_hmm(request, tmp_path):
    return SimpleHMM(_fixture("simple_hmm_input_igk.yaml", request.param,
                              tmp_path), 0, GENES, seed=0, device="cpu")


def test_igk_gene_map_skips_d():
    assert sorted(load_gene_map(GENES)) == ["IGKJ_ex*01", "IGKV_ex*01"]


def test_light_state_space(light_hmm):
    space = light_hmm.space
    assert not space.is_heavy and not light_hmm.heavy
    assert space.dgerm is None and space.dj_junction is None
    vj = space.vd_junction
    assert (vj.site_start, vj.site_end) == (4, 9)
    assert vj.state_strs == [
        "IGKJ_ex*01:N_A", "IGKJ_ex*01:N_C", "IGKJ_ex*01:N_G",
        "IGKJ_ex*01:N_T", "IGKJ_ex*01:0",
        "IGKV_ex*01:3", "IGKV_ex*01:4",
    ]
    assert space.jgerm.site_inds == [9, 10, 11, 12]
    assert space.jpadding.site_inds == [13, 14]
    assert set(light_hmm.trans) == {"vgerm_static_log", "vgerm_vd", "vd",
                                    "vd_dgerm", "jpadding_log"}


def test_light_loglik_matches_brute_force(light_hmm):
    """Exhaustive path enumeration over the 5-row V-J junction."""
    oracle = _brute_force_loglik(_numpy(light_hmm.trans),
                                 _numpy(light_hmm.emis, tree=0))
    assert light_hmm.log_likelihood() == pytest.approx(oracle, rel=1e-10)


def test_light_ffbs_samples_the_brute_force_posterior(light_hmm):
    """4,000 FFBS draws of (V state, V-J path, J state) against the
    enumeration's posterior: the five likeliest paths within 5 standard
    errors (at least 0.005), and no draw of a path of probability 0."""
    exact = dict(_paths(_numpy(light_hmm.trans),
                        _numpy(light_hmm.emis, tree=0)))
    total = sum(exact.values())
    n = 4000
    cache = light_hmm._run_forward()
    drawn = path_to_numpy(sample_path(light_hmm.generator, light_hmm.trans,
                                      widen_cache(cache, n), False))
    assert drawn.dgerm_idx is None and drawn.dj_idx is None
    counts = {}
    for t in range(n):
        key = (int(drawn.vgerm_idx[t]), tuple(int(i) for i in
                                              drawn.vd_idx[t]),
               int(drawn.jgerm_idx[t]))
        assert key in exact, key
        counts[key] = counts.get(key, 0) + 1
    for key, p in sorted(exact.items(), key=lambda kv: -kv[1])[:5]:
        q = p / total
        se = np.sqrt(q * (1 - q) / n)
        assert abs(counts.get(key, 0) / n - q) < max(5 * se, 0.005), key


def test_light_sampling_and_decode(light_hmm):
    anns = light_hmm.sample_annotations(50)
    for ann in anns:
        assert ann.dgerm_state is None and ann.dj_insertion is None
        assert ann.vgerm_state == "IGKV_ex*01"
        assert ann.jgerm_state == "IGKJ_ex*01"
        assert len(ann.naive_seq) == 15
        # The VJ insertion decodes from NTI states (may be empty).
        assert set(ann.vd_insertion) <= set("ACGT")
        assert ann.v_5p_del == 0 and ann.j_3p_del == 0
        assert ann.j_fwk_insertion == "NN"


def _posterior_tsv(path, n_rows, seed):
    """A RevBayes-style posterior TSV over the igk fixture's taxa."""
    rng = np.random.default_rng(seed)
    cols = (["Iteration", "Likelihood", "Prior", "alpha"]
            + [f"er[{i}]" for i in range(1, 7)]
            + [f"pi[{i}]" for i in range(1, 5)] + ["tree"])
    topologies = ["((0:{a},1:{b}):{c},naive:{d},2:{e});",
                  "((0:{a},2:{b}):{c},naive:{d},1:{e});",
                  "((1:{a},2:{b})[&index=7]:{c},naive:{d},0:{e});"]
    lines = ["\t".join(cols)]
    for t in range(n_rows):
        bl = rng.uniform(0.05, 0.8, size=5)
        tree = topologies[t % 3].format(a=bl[0], b=bl[1], c=bl[2], d=bl[3],
                                        e=bl[4])
        row = ([str(t * 10), f"{-100 - t:.4f}", "-12.0",
                f"{rng.uniform(0.4, 3.0):.6f}"]
               + [f"{x:.6f}" for x in rng.uniform(0.5, 2.0, size=6)]
               + [f"{x:.6f}" for x in rng.dirichlet([5, 5, 5, 5])] + [tree])
        lines.append("\t".join(row))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("locus", ["igk", "igl"])
def test_light_phylo_pipeline_matches_brute_force(tmp_path, locus):
    """The pipeline's per-tree log-likelihoods on the phylo-HMM equal the
    enumeration over each tree's own emissions (pruning, naive prior,
    region emissions), and its TSV has the light-chain columns."""
    hmm = PhyloHMM(_fixture("phylo_hmm_input_igk.yaml", locus, tmp_path), 0,
                   GENES, seed=0, device="cpu")
    assert not hmm.heavy
    tsv = tmp_path / "rb.trees"
    _posterior_tsv(tsv, n_rows=4, seed=2)
    samples = load_tree_samples(str(tsv))
    result = run_pipeline_arrays(hmm, samples, num_rates=4, seed=0,
                                 chunk_size=3)

    inputs = stack_blocks([Prepared.of(hmm, samples, 4)]).to_device(
        hmm.device, hmm.dtype)
    emis = region_emissions(
        naive_prior_correction(launch(inputs), inputs.pi, hmm.naive_bases),
        hmm.consts, False)
    trans = _numpy(hmm.trans)
    oracle = [_brute_force_loglik(trans, _numpy(emis, tree=t))
              for t in range(samples.n_samples)]
    np.testing.assert_allclose(result.lh_loglik, oracle, rtol=1e-10)

    buf = io.StringIO()
    write_output_tsv(result, heavy=False, outfile=buf)
    header = buf.getvalue().split("\n")[0].split("\t")
    assert "VJInsertion" in header
    assert not {"DGene", "D5pDel", "D3pDel", "VDInsertion",
                "DJInsertion"} & set(header)
    rows = buf.getvalue().rstrip("\n").split("\n")[1:]
    assert len(rows) == 4 and all(len(r.split("\t")) == len(header)
                                  for r in rows)
