"""The port's YAML reader (``io/yaml_load``): libyaml's loader and the
pure-Python one give the same objects from every germline directory and
partis file the port reads, raise alike on malformed text, and the
recorder counts which of them read each document."""

import dataclasses
import pathlib

import numpy as np
import pytest
import yaml

from linearham_tpu_torch.io import yaml_load
from linearham_tpu_torch.io.germline import load_gene_map, write_gene_dir
from linearham_tpu_torch.io.partis import load_cluster
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.synth import (make_family, make_light_family,
                                             write_partis_yaml)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GENE_DIRS = ["hmm_params", "igk_hmm_params", "phylo_likelihood_hmm_params",
             "synth-igh", "synth-igk"]
PARTIS_FILES = ["phylo_hmm_input.yaml", "phylo_hmm_input_extra.yaml",
                "phylo_hmm_input_igk.yaml", "phylo_likelihood_hmm_input.yaml",
                "simple_hmm_input.yaml", "simple_hmm_input_extra.yaml",
                "simple_hmm_input_igk.yaml", "synth-igh", "synth-igk"]
SYNTH = {"synth-igh": lambda: make_family(n_seqs=7, seed=11),
         "synth-igk": lambda: make_light_family(n_seqs=7, seed=12)}


def _needs_libyaml():
    if not yaml.__with_libyaml__:
        pytest.skip("this PyYAML was built without libyaml")


def _gene_dir(name, tmp_path) -> str:
    if name not in SYNTH:
        return str(FIXTURES / name)
    out = tmp_path / name
    write_gene_dir(SYNTH[name]().genes, str(out))
    return str(out)


def _partis_file(name, tmp_path) -> str:
    if name not in SYNTH:
        return str(FIXTURES / name)
    out = tmp_path / f"{name}.yaml"
    write_partis_yaml(SYNTH[name](), str(out), shm_indel_ids=(1,),
                      unmutated_ids=(2,), seed=3)
    return str(out)


def _read(monkeypatch, loader, fn, *args):
    """``fn(*args)`` with ``loader`` as the port's choice, and the counters
    it recorded."""
    with monkeypatch.context() as m:
        m.setattr(yaml_load, "LOADER", loader)
        with profiling.recording() as timer:
            return fn(*args), timer.counters


def _same(a, b, path="value"):
    """Equal in type, value and structure; arrays exactly, dtype too."""
    assert type(a) is type(b), (path, type(a), type(b))
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _n_gene_files(gene_dir) -> int:
    """The gene files ``load_gene_map`` reads (an IGK or IGL D is skipped)."""
    return sum(1 for p in pathlib.Path(gene_dir).glob("IG*_star_*.yaml")
               if not p.name.startswith(("IGKD", "IGLD")))


@pytest.mark.parametrize("name", GENE_DIRS)
def test_gene_map_is_the_same_under_either_loader(name, tmp_path,
                                                  monkeypatch):
    _needs_libyaml()
    assert yaml_load.LOADER is yaml.CSafeLoader
    gene_dir = _gene_dir(name, tmp_path)
    fast, fast_counts = _read(monkeypatch, yaml.CSafeLoader, load_gene_map,
                              gene_dir)
    slow, slow_counts = _read(monkeypatch, yaml.SafeLoader, load_gene_map,
                              gene_dir)
    _same(fast, slow)
    n = _n_gene_files(gene_dir)
    assert len(fast) == n
    assert fast_counts == {"yaml_libyaml_loads": n}
    assert slow_counts == {"yaml_python_loads": n}


@pytest.mark.parametrize("name", PARTIS_FILES)
def test_cluster_is_the_same_under_either_loader(name, tmp_path,
                                                 monkeypatch):
    _needs_libyaml()
    path = _partis_file(name, tmp_path)
    fast, fast_counts = _read(monkeypatch, yaml.CSafeLoader, load_cluster,
                              path, 0)
    slow, slow_counts = _read(monkeypatch, yaml.SafeLoader, load_cluster,
                              path, 0)
    _same(fast, slow)
    assert fast_counts == {"yaml_libyaml_loads": 1}
    assert slow_counts == {"yaml_python_loads": 1}


@pytest.mark.parametrize("loader", ["libyaml", "python"])
def test_malformed_yaml_raises_under_either_loader(loader, tmp_path,
                                                   monkeypatch):
    if loader == "libyaml":
        _needs_libyaml()
    choice = yaml.CSafeLoader if loader == "libyaml" else yaml.SafeLoader
    path = tmp_path / "bad.yaml"
    path.write_text("germline-info: {locus: igh\nevents: [1, 2\n")
    monkeypatch.setattr(yaml_load, "LOADER", choice)
    with profiling.recording() as timer:
        with pytest.raises(yaml.YAMLError):
            load_cluster(str(path), 0)
    assert timer.counters == {}


def test_without_libyaml_the_python_loader_reads_the_same(tmp_path,
                                                          monkeypatch):
    """PyYAML without libyaml: the port falls back to the pure-Python
    loader, gets the same objects as its own choice here, and counts only
    pure-Python loads."""
    gene_dir = _gene_dir("synth-igk", tmp_path)
    path = _partis_file("synth-igk", tmp_path)

    def build():
        return load_gene_map(gene_dir), load_cluster(path, 0)

    chosen, _ = _read(monkeypatch, yaml_load.LOADER, build)
    got, counts = _read(monkeypatch, yaml.SafeLoader, build)
    _same(got, chosen)
    assert counts == {"yaml_python_loads": _n_gene_files(gene_dir) + 1}
