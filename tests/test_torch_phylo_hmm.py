"""Port PhyloHMM (linearham_tpu_torch.models.phylo_hmm) conformance, f64 CPU.

The reference goldens through the port at the JAX tests' tolerances
(tests/test_phylo_hmm.py), and the port against the JAX package on the
same host tensors (``PhyloHMM.from_host_products`` takes the dict the JAX
``PhyloHMM._host_products`` returns).
"""

import numpy as np
import pytest
import torch

from linearham_tpu_torch.models.phylo_hmm import (PhyloHMM, region_emissions)

torch.set_num_threads(1)

ER1 = [1.0] * 6
PI = [0.17, 0.19, 0.25, 0.39]


def _port(fixtures_dir, yaml_name, params="hmm_params", num_rates=4):
    h = PhyloHMM(str(fixtures_dir / yaml_name), 0, str(fixtures_dir / params),
                 seed=0, device="cpu")
    h.init_phylo_parameters(str(fixtures_dir / "newton.tree"), ER1, PI, 1.0,
                            num_rates)
    return h


@pytest.fixture(scope="module")
def phylo(fixtures_dir):
    return _port(fixtures_dir, "phylo_hmm_input.yaml")


def test_defaults_on_cpu_are_f64(phylo):
    assert phylo.device == torch.device("cpu")
    assert phylo.dtype == torch.float64
    assert all(b.device.type == "cpu" for b in phylo.buffers())


def test_golden_loglik(phylo):
    assert phylo.log_likelihood() == pytest.approx(-75.8136, abs=1e-4)


def test_golden_loglik_extra(fixtures_dir):
    h = _port(fixtures_dir, "phylo_hmm_input_extra.yaml")
    assert h.log_likelihood() == pytest.approx(-75.1122515055, rel=1e-9)


def test_pure_phylo_likelihood_cross_check(fixtures_dir):
    """R=1; the HMM reduces to a bare phylo likelihood (R phylomd oracle)."""
    h = _port(fixtures_dir, "phylo_likelihood_hmm_input.yaml",
              params="phylo_likelihood_hmm_params", num_rates=1)
    assert h.log_likelihood() == pytest.approx(-55.73483, abs=1e-5)


def test_xmsa_emission_golden(phylo):
    expected = np.array([
        0.00734474, 0.0233122, 0.00563729, 0.0107866, 0.00342739,
        0.0177109, 0.0279823, 0.0215197, 0.00270654, 0.0177109,
        0.00399037, 0.0215197, 0.00437549, 0.0446185, 0.00399037,
        0.0609261, 0.00225322, 0.0406717, 0.00429863, 0.0400067,
        0.00783313, 0.00255793, 0.0179374, 0.0177172, 0.0118535,
        0.019866, 0.0118535, 0.00286619, 0.00514627, 0.0134759,
        0.00255793, 0.00514627, 0.0322063, 0.016355, 1, 1,
    ])
    np.testing.assert_allclose(phylo.xmsa_emission, expected, rtol=2e-5)


def test_sample_annotations_batched(phylo):
    anns = phylo.sample_annotations(64)
    assert len(anns) == 64
    for ann in anns:
        assert len(ann.naive_seq) == 15
        assert ann.naive_seq[0] == "N"          # V padding site
        assert set(ann.naive_seq[1:13]) <= set("ACGT")
        assert ann.vgerm_state == "IGHV_ex*01"
        assert ann.jgerm_state == "IGHJ_ex*01"
    assert len({a.naive_seq for a in anns}) > 1
    assert phylo.log_likelihood() == pytest.approx(-75.8136, abs=1e-4)


def _jax_host_products(fam):
    import jax.numpy as jnp

    from linearham_tpu.io.partis import ClusterData
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM

    cluster = ClusterData(
        locus=fam.locus, unique_ids=list(fam.unique_ids),
        naive_seq="N" * fam.n_sites, seqs=[], flexbounds=dict(fam.flexbounds),
        relpos=dict(fam.relpos), raw_event={})
    return JaxPhyloHMM._host_products(cluster, fam.genes, fam.msa,
                                      jnp.float64)


@pytest.mark.parametrize("light", [False, True], ids=["igh", "igk"])
def test_loglik_matches_jax_on_shared_host_products(tmp_path, light):
    """Both packages on identical host tensors and one random tree."""
    import jax.numpy as jnp

    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.utils.synth import (make_family, make_light_family,
                                           make_tree_samples)

    fam = make_light_family(n_seqs=5, seed=4) if light \
        else make_family(n_seqs=5, seed=4)
    host = _jax_host_products(fam)
    port = PhyloHMM.from_host_products(host, device="cpu",
                                       dtype=torch.float64)
    ref = JaxPhyloHMM.__new__(JaxPhyloHMM)
    ref._install(host, 0, jnp.float64)

    samples = make_tree_samples(fam, 1, seed=4)
    nwk = tmp_path / "tree.nwk"
    nwk.write_text(samples.newicks[0] + "\n")
    args = (str(nwk), list(samples.er[0]), list(samples.pi[0]),
            float(samples.alpha[0]), 4)
    port.init_phylo_parameters(*args)
    ref.init_phylo_parameters(*args)
    assert port.heavy is not light
    assert port.log_likelihood() == pytest.approx(ref.log_likelihood(),
                                                  rel=1e-9)
    np.testing.assert_allclose(port.xmsa_emission, ref.xmsa_emission,
                               rtol=1e-9)


def test_region_emissions_match_jax(phylo):
    """Same [T, X] site log-likelihoods (one impossible site) through both
    packages' region_emissions: equal values, -inf at the same cells."""
    import jax.numpy as jnp

    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.models.phylo_hmm import \
        region_emissions as jax_region_emissions

    host = JaxPhyloHMM._host_products(
        phylo.cluster, phylo.genes, phylo.msa, jnp.float64)
    rng = np.random.default_rng(0)
    site_ll = rng.normal(-3.0, 1.0, size=(5, phylo.xmsa.n_cols))
    site_ll[0, 2] = -np.inf
    want = jax_region_emissions(jnp.asarray(site_ll), host["consts_np"],
                                heavy=True)
    got = region_emissions(torch.as_tensor(site_ll), phylo.consts, True)
    assert set(got) == set(want)
    for name in want:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert not np.isnan(g).any(), name
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w),
                                      err_msg=name)
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
