"""Port ASR (linearham_tpu_torch.ops.asr, postprocess.bootstrap_asr) vs JAX.

The three gates of tests/test_asr.py on the port, with that file's sample
counts and tolerances (n = 3000 joint samples, |empirical - exact| <
5 se + 0.01 per state and site), the exact posteriors computed from the
JAX package's partials.  Then the port's bootstrap stage against the JAX
one on the same pipeline output: ``.log`` and ``.ess`` byte-identical (the
resampling is the same numpy stream), and the same topologies, branch
lengths and tip sequences in ``.trees`` (only internal draws differ).
"""

import re

import numpy as np
import pytest
import torch

from linearham_tpu.io.annotated_newick import parse_annotated_newick
from linearham_tpu.io.newick import parse_newick
from linearham_tpu_torch.ops.asr import sample_ancestral_states
from linearham_tpu_torch.ops.gtr import GTREigen, gamma_category_rates, gtr_eigen

torch.set_num_threads(1)

PI = np.array([0.17, 0.19, 0.25, 0.39])
ER = np.array([1.3, 2.2, 0.6, 1.0, 3.1, 0.8])
N_DRAWS = 3000


def _setup(seqs, newick, alpha=1.0, n_rates=4):
    """Host arrays of one tree (numpy) in tests/test_asr.py's layout."""
    tree = parse_newick(newick)
    lut = {c: i for i, c in enumerate("ACGT")}
    tips = np.array(
        [[lut.get(c, 4) for c in seqs[lab]] for lab in tree.tip_labels],
        np.int32)
    return tree, dict(
        eig=gtr_eigen(ER, PI), pi=PI, rates=gamma_category_rates(alpha,
                                                                 n_rates),
        tips=tips, tip_parent=tree.tip_parent, tip_length=tree.tip_length,
        edge_child=tree.edge_child, edge_parent=tree.edge_parent,
        edge_length=tree.edge_length, root_slot=tree.n_internal - 1,
        n_slots=tree.n_internal + 1)


def _port_sample(h, n, seed):
    """``n`` independent joint samples: the tree repeated n times."""
    def rep(a, dtype):
        a = torch.as_tensor(np.asarray(a), dtype=dtype)
        return a.expand(n, *a.shape).contiguous()

    f, i = torch.float64, torch.int64
    gen = torch.Generator().manual_seed(seed)
    return sample_ancestral_states(
        gen, GTREigen(*(rep(a, f) for a in h["eig"])), rep(h["pi"], f),
        rep(h["rates"], f), rep(h["tips"], i), rep(h["tip_parent"], i),
        rep(h["tip_length"], f), rep(h["edge_child"], i),
        rep(h["edge_parent"], i), rep(h["edge_length"], f),
        rep(h["root_slot"], i), h["n_slots"])


def _jax_partials(h):
    import jax.numpy as jnp

    from linearham_tpu.ops.gtr import GTREigen as JaxEigen
    from linearham_tpu.ops.pruning import compute_partials

    partials, scale = compute_partials(
        JaxEigen(*map(jnp.asarray, h["eig"])), jnp.asarray(h["rates"]),
        jnp.asarray(h["tips"]), jnp.asarray(h["tip_parent"]),
        jnp.asarray(h["tip_length"]), jnp.asarray(h["edge_child"]),
        jnp.asarray(h["edge_parent"]), jnp.asarray(h["edge_length"]),
        h["n_slots"])
    return np.asarray(partials), np.asarray(scale)


def _assert_frequencies(draws, exact):
    """draws [n, X] categorical samples; exact [K, X] probabilities."""
    n = draws.shape[0]
    for site in range(draws.shape[1]):
        emp = np.bincount(draws[:, site], minlength=exact.shape[0]) / n
        se = np.sqrt(exact[:, site] * (1 - exact[:, site]) / n)
        assert np.all(np.abs(emp - exact[:, site]) < 5 * se + 0.01), site


def test_asr_fixes_observed_tips_and_resolves_ambiguity():
    seqs = {"a": "ACGTN", "b": "ACGGA", "naive": "ANGTA"}
    tree, h = _setup(seqs, "((a:0.1,b:0.3):0.2,naive:0.15);")
    tips = _port_sample(h, 64, seed=0).tip_states.numpy()
    lut = {c: i for i, c in enumerate("ACGT")}
    for i, lab in enumerate(tree.tip_labels):
        for site, c in enumerate(seqs[lab]):
            if c in lut:
                assert (tips[:, i, site] == lut[c]).all(), (lab, site)
            else:
                assert ((0 <= tips[:, i, site]) & (tips[:, i, site] <= 3)
                        ).all()


def test_asr_root_marginal_matches_exact_posterior():
    """Empirical root-state frequencies vs the exact rate-mixed marginal."""
    seqs = {"a": "ACGTA", "b": "ACGGA", "naive": "AAGTA"}
    _, h = _setup(seqs, "((a:0.4,b:0.6):0.3,naive:0.5);")
    partials, scale = _jax_partials(h)
    root = partials[h["root_slot"]]                       # [R, 4, X]
    w = PI[None, :, None] * root * np.exp(scale)[:, None, :]
    marg = w.sum(0) / w.sum((0, 1))                       # [4, X]
    states = _port_sample(h, N_DRAWS, seed=1).internal_states.numpy()
    _assert_frequencies(states[:, h["root_slot"], :], marg)


def test_asr_rate_marginal_matches_exact_posterior():
    seqs = {"a": "AG", "b": "AT", "naive": "AC"}
    _, h = _setup(seqs, "((a:0.4,b:0.6):0.3,naive:0.5);", alpha=0.5)
    partials, scale = _jax_partials(h)
    root = partials[h["root_slot"]]
    per_rate = np.log(np.einsum("i,rix->rx", PI, root)) + scale   # [R, X]
    exact = np.exp(per_rate - per_rate.max(0))
    exact /= exact.sum(0)
    ridx = _port_sample(h, N_DRAWS, seed=2).rate_idx.numpy()
    _assert_frequencies(ridx, exact)


@pytest.fixture(scope="module")
def pipeline_out(fixtures_dir, tmp_path_factory):
    """A 12-row pipeline output TSV (the port's, f64 CPU) and the cluster
    FASTA over the phylo fixture."""
    from linearham_tpu.io.partis import load_cluster
    from linearham_tpu.utils.seqs import write_fasta
    from linearham_tpu_torch.pipeline.run import run_pipeline
    from test_torch_pipeline import _make_tsv

    tmp = tmp_path_factory.mktemp("torch_asr")
    _make_tsv(tmp / "revbayes_run.trees", n_rows=12, seed=3)
    out_tsv = tmp / "lh_revbayes_run.trees"
    run_pipeline(str(fixtures_dir / "phylo_hmm_input.yaml"), 0,
                 str(fixtures_dir / "hmm_params"),
                 str(tmp / "revbayes_run.trees"), str(out_tsv), num_rates=4,
                 device="cpu")
    cluster = load_cluster(str(fixtures_dir / "phylo_hmm_input.yaml"), 0)
    fasta = tmp / "cluster_seqs.fasta"
    seqs = {"naive": cluster.naive_seq}
    seqs.update(dict(zip(cluster.unique_ids, cluster.seqs)))
    write_fasta(seqs, str(fasta))
    return tmp, out_tsv, fasta


def _tips(line):
    return {n.label: n.annotations["ancestral"]
            for n in parse_annotated_newick(line).walk() if n.is_tip}


def test_bootstrap_asr_matches_jax(pipeline_out, tmp_path):
    from linearham_tpu.postprocess.bootstrap_asr import \
        run_bootstrap_asr as jax_bootstrap_asr
    from linearham_tpu_torch.postprocess.bootstrap_asr import \
        run_bootstrap_asr

    _, out_tsv, fasta = pipeline_out
    args = (str(out_tsv), str(fasta), 0.25, 0.5, 7)
    jax_res = jax_bootstrap_asr(*args, output_base=str(tmp_path / "jax"))
    port_res = run_bootstrap_asr(*args, output_base=str(tmp_path / "port"),
                                 device="cpu")
    for ext in (".log", ".ess"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes(), ext
    assert port_res.rows == jax_res.rows and port_res.ess == jax_res.ess
    assert len(port_res.annotated_trees) == len(jax_res.annotated_trees) == 4

    bare = re.compile(r"\[[^\]]*\]")
    for got, want in zip(port_res.annotated_trees, jax_res.annotated_trees):
        assert bare.sub("", got) == bare.sub("", want)   # topology, lengths
        assert _tips(got) == _tips(want)                  # observed tips
        for node in parse_annotated_newick(got).walk():
            anc = node.annotations["ancestral"]
            assert len(anc) == 15
            if not node.is_tip:
                assert set(anc) <= set("ACGT")
    lines = (tmp_path / "port.trees").read_text().splitlines()
    assert lines == port_res.annotated_trees


def test_bootstrap_asr_cli_contract(pipeline_out, tmp_path):
    """The reference script's nine positional arguments, plus --device."""
    from linearham_tpu_torch.postprocess import bootstrap_asr

    _, out_tsv, fasta = pipeline_out
    paths = [str(tmp_path / f"run.{e}") for e in ("trees", "log", "ess")]
    assert bootstrap_asr.main([str(out_tsv), str(fasta), "0.25", "0.5", "4",
                               "0", *paths, "--device", "cpu"]) == 0
    assert len((tmp_path / "run.trees").read_text().splitlines()) == 4
    assert (tmp_path / "run.ess").read_text().startswith("Parameter\tESS\n")
