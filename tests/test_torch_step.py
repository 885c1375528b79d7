"""The one route from a tree batch to the pruning kernel (``models.step``),
on the CPU in f64.

The pipeline's chunks, the repertoire's buckets and the single-tree API
all launch through ``models.step.launch``.  Whatever the cut, the same
trees give the same log-likelihoods, for a heavy-chain (igh) and a
light-chain (igk) synthetic family; each route's launches are counted
where the route calls the pruning walk.
"""

import numpy as np
import pytest
import torch

from linearham_tpu_torch.models import step
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.parallel.repertoire import FamilyTask, run_repertoire
from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
from linearham_tpu_torch.utils.synth import (make_family, make_light_family,
                                             make_tree_samples)

torch.set_num_threads(1)

N_TREES = 5
MAKERS = {"igh": make_family, "igk": make_light_family}


def _family(locus):
    fam = MAKERS[locus](n_seqs=5, seed=7)
    hmm = PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes, fam.msa, fam.unique_ids,
                              fam.n_sites, device="cpu")
    return hmm, make_tree_samples(fam, N_TREES, seed=7)


def _single_trees(hmm, samples, tmp_path):
    """``PhyloHMM.log_likelihood()`` of each tree, one at a time."""
    out = []
    for t in range(samples.n_samples):
        newick = tmp_path / f"tree{t}.nwk"
        newick.write_text(samples.newicks[t] + "\n")
        hmm.init_phylo_parameters(str(newick), list(samples.er[t]),
                                  list(samples.pi[t]),
                                  float(samples.alpha[t]), 4)
        out.append(hmm.log_likelihood())
    return np.array(out)


ROUTES = {
    # route -> (log-likelihoods of every tree, launches it makes)
    "pipeline_one_chunk": (lambda hmm, s, tmp: run_pipeline_arrays(
        hmm, s, 4, chunk_size=s.n_samples).lh_loglik, 1),
    "repertoire": (lambda hmm, s, tmp: run_repertoire(
        [FamilyTask(hmm, s)], num_rates=4, device="cpu")[0].loglik, 1),
    "single_tree": (_single_trees, N_TREES),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("locus", sorted(MAKERS))
def test_every_route_gives_the_chunked_pipelines_log_likelihoods(
        locus, route, tmp_path, monkeypatch):
    """Against ``run_pipeline_arrays`` in chunks of 3 (two launches): one
    chunk of every tree, ``run_repertoire([task])`` and the single-tree
    API on tree t give row t's log-likelihood."""
    hmm, samples = _family(locus)
    assert hmm.heavy == (locus == "igh")
    calls = []
    walk = step.site_log_likelihoods

    def counted(*args):
        calls.append(args[4].shape[0])
        return walk(*args)

    monkeypatch.setattr(step, "site_log_likelihoods", counted)
    want = run_pipeline_arrays(hmm, samples, 4, chunk_size=3)
    assert calls == [3, 2]
    run, launches = ROUTES[route]
    got = run(hmm, samples, tmp_path)
    assert len(calls) == 2 + launches
    assert sum(calls[2:]) == N_TREES
    np.testing.assert_allclose(got, want.lh_loglik, rtol=1e-12, atol=0)
