"""Host-side repairs of the port, on the CPU.

* ``utils/native_build.build_native`` returns None, and does not raise,
  where ``build/native/`` cannot be created (here: a regular file in its
  path); the CPU pipeline then parses through the Python path and writes
  the same TSV, byte for byte, as with the C++ library, and counts its
  rows as written by Python.
* ``io/output_tsv.write_output_tsv`` (the reference's whole-result writer)
  writes the JAX package's bytes on the same result, and the same bytes
  as ``run_pipeline``'s streamed TSV.
"""

import io

import pytest
import torch

from linearham_tpu_torch.io import native
from linearham_tpu_torch.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.io.output_tsv import write_output_tsv
from linearham_tpu_torch.pipeline.run import run_pipeline, run_pipeline_arrays
from linearham_tpu_torch.utils import native_build
from test_torch_pipeline import _make_tsv

torch.set_num_threads(1)


@pytest.fixture
def family(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    trees = tmp_path / "revbayes_run.trees"
    _make_tsv(trees, n_rows=7, seed=4)
    return (str(fixtures_dir / "phylo_hmm_input.yaml"),
            str(fixtures_dir / "hmm_params"), str(trees))


def _pipeline_tsv(family, out):
    """``run_pipeline``'s TSV bytes and its counters of the rows written."""
    yaml_path, gene_dir, trees = family
    result = run_pipeline(yaml_path, 0, gene_dir, trees, str(out),
                          num_rates=4, seed=0, chunk_size=3, device="cpu")
    return out.read_bytes(), {k: v for k, v in result.counters.items()
                              if k.startswith("tsv_")}


def test_unbuildable_native_dir_falls_back(family, tmp_path, monkeypatch):
    with_library, rows = _pipeline_tsv(family, tmp_path / "native.tsv")
    assert native.native_available()
    assert rows == {"tsv_native_rows": 7}

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a regular file where a directory should be\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", blocker / "native")
    assert native_build.build_native() is None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_checked", False)
    assert not native.native_available()
    assert _pipeline_tsv(family, tmp_path / "python.tsv") == (
        with_library, {"tsv_python_rows": 7})


def test_write_output_tsv_matches_jax(family, tmp_path):
    from linearham_tpu.pipeline.run import \
        write_output_tsv as jax_write_output_tsv

    yaml_path, gene_dir, trees = family
    hmm = PhyloHMM(yaml_path, 0, gene_dir, device="cpu")
    result = run_pipeline_arrays(hmm, load_tree_samples(trees), num_rates=4,
                                 seed=0, chunk_size=3)
    got, want = io.StringIO(), io.StringIO()
    write_output_tsv(result, hmm.heavy, got)
    jax_write_output_tsv(result, hmm.heavy, want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") == 8
    assert got.getvalue().encode() == _pipeline_tsv(family,
                                                    tmp_path / "run.tsv")[0]

