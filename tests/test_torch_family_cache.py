"""Port family disk cache (linearham_tpu_torch.compiler.family_cache).

The mirror of tests/test_caches.py:26,51,67,84 on the port (roundtrip,
log-likelihood parity at rel 1e-12, the key tracks every input's content,
a corrupt entry is rebuilt), plus: the key changes when a source of the
port (or a reused JAX host module) changes, the environment variable
relocates or disables the cache, and a hit builds for the device and dtype
asked for -- neither is memoised.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from linearham_tpu_torch.compiler import family_cache
from linearham_tpu_torch.compiler.family_cache import (cached_phylo_hmm,
                                                      family_key)
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM

torch.set_num_threads(1)

TREE = dict(er=[1.0] * 6, pi=[0.17, 0.19, 0.25, 0.39], alpha=1.0,
            num_rates=4)


@pytest.fixture
def family_files(fixtures_dir):
    return str(fixtures_dir / "phylo_hmm_input.yaml"), \
        str(fixtures_dir / "hmm_params")


def test_family_cache_roundtrip(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    cache = str(tmp_path / "fam_cache")
    fresh = PhyloHMM(yaml_path, 0, gene_dir, device="cpu")
    first = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                             cache_dir=cache)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].endswith(".pkl")
    second = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                              cache_dir=cache)
    assert os.listdir(cache) == entries
    for hmm in (first, second):
        assert hmm.heavy == fresh.heavy
        assert hmm.xmsa.labels == fresh.xmsa.labels
        want = dict(fresh.named_buffers())
        got = dict(hmm.named_buffers())
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_family_cache_loglik_parity(family_files, fixtures_dir, tmp_path):
    yaml_path, gene_dir = family_files
    cache = str(tmp_path / "fam_cache")
    newick = str(fixtures_dir / "newton.tree")
    cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                     cache_dir=cache)                          # populate
    hmm = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                           cache_dir=cache)                    # hit
    hmm.init_phylo_parameters(newick, **TREE)
    ref = PhyloHMM(yaml_path, 0, gene_dir, device="cpu")
    ref.init_phylo_parameters(newick, **TREE)
    assert hmm.log_likelihood() == pytest.approx(ref.log_likelihood(),
                                                 rel=1e-12)
    assert hmm.log_likelihood() == pytest.approx(-75.8136, abs=1e-4)


def test_family_cache_key_tracks_input_content(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    k1 = family_key(yaml_path, 0, gene_dir, "float64")
    assert k1 == family_key(yaml_path, 0, gene_dir, "float64")
    assert k1 != family_key(yaml_path, 1, gene_dir, "float64")
    assert k1 != family_key(yaml_path, 0, gene_dir, "float32")

    # A single changed byte in any gene YAML must change the key.
    alt = tmp_path / "hmm_params"
    shutil.copytree(gene_dir, alt)
    victim = sorted(p for p in alt.iterdir() if p.suffix == ".yaml")[0]
    victim.write_text(victim.read_text() + "\n# changed\n")
    assert k1 != family_key(yaml_path, 0, str(alt), "float64")


def test_family_cache_key_tracks_sources(family_files, tmp_path,
                                         monkeypatch):
    """The key covers the port's own sources, its copies of the host
    modules included (none of the JAX package's); editing any one of them
    changes it."""
    files = family_cache.source_files()
    names = {str(p.relative_to(family_cache.PORT_DIR.parent)) for p in files}
    assert "linearham_tpu_torch/models/phylo_hmm.py" in names
    assert "linearham_tpu_torch/compiler/family_cache.py" in names
    assert "linearham_tpu_torch/compiler/state_space.py" in names
    assert not any(n.startswith("linearham_tpu/") for n in names)
    assert all(p.is_file() for p in files)

    copies = []
    for p in files:
        c = tmp_path / "src" / p.relative_to(family_cache.PORT_DIR.parent)
        c.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(p, c)
        copies.append(c)
    monkeypatch.setattr(family_cache, "source_files", lambda: copies)
    yaml_path, gene_dir = family_files
    k1 = family_key(yaml_path, 0, gene_dir, "float64")
    port_src = next(c for c in copies if c.name == "phylo_hmm.py"
                    and "linearham_tpu_torch" in str(c))
    port_src.write_text(port_src.read_text() + "\n# edited\n")
    k2 = family_key(yaml_path, 0, gene_dir, "float64")
    assert k2 != k1
    host_src = next(c for c in copies if c.name == "state_space.py")
    host_src.write_text(host_src.read_text() + "\n# edited\n")
    assert family_key(yaml_path, 0, gene_dir, "float64") != k2


def test_family_cache_corrupt_entry_falls_back(family_files, tmp_path):
    yaml_path, gene_dir = family_files
    cache = tmp_path / "fam_cache"
    cache.mkdir()
    bad = cache / (family_key(yaml_path, 0, gene_dir, "float64") + ".pkl")
    bad.write_bytes(b"not a pickle")
    hmm = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                           cache_dir=str(cache))
    assert hmm.space is not None
    assert bad.read_bytes() != b"not a pickle"     # replaced by a fresh one


def test_hit_builds_for_the_device_and_dtype_asked(family_files, tmp_path,
                                                   monkeypatch):
    """A hit with device='cpu' gives f64; f32 is another entry; the hit's
    tensors live where asked, nothing is memoised from the first call; and
    a hit with no device still means CUDA or an error."""
    yaml_path, gene_dir = family_files
    cache = str(tmp_path / "fam_cache")
    cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu", cache_dir=cache)
    hit = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                           cache_dir=cache)
    assert hit.dtype == torch.float64
    assert all(b.device.type == "cpu" for b in hit.buffers())
    f32 = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu",
                           dtype=torch.float32, cache_dir=cache)
    assert f32.dtype == torch.float32 and f32.trans_vd.dtype == torch.float32
    assert len(os.listdir(cache)) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cached_phylo_hmm(yaml_path, 0, gene_dir, cache_dir=cache)


def test_environment_relocates_or_disables(family_files, tmp_path,
                                           monkeypatch):
    yaml_path, gene_dir = family_files
    where = tmp_path / "env_cache"
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", str(where))
    cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu")
    assert len(os.listdir(where)) == 1
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    shutil.rmtree(where)
    hmm = cached_phylo_hmm(yaml_path, 0, gene_dir, device="cpu")
    assert not where.exists()
    assert np.asarray(hmm.xmsa.matrix).shape[0] == len(hmm.xmsa.labels)
