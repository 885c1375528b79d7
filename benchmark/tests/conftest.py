"""The benchmark's own tests: CPU, small sizes.  Run from the repository
root with ``python -m pytest benchmark/tests -q``; those marked ``cuda``
skip without a card and are run on one with ``-m cuda``."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def tiny_cell(name: str, seqs: int = 5, trees: int = 12, families: int = 3,
              precision: str = "f64"):
    """The cell ``name`` of BENCHMARK.json cut to a size the CPU runs in
    seconds: at most ``families`` families of at most ``seqs`` sequences
    and ``trees`` trees, run in ``precision`` (f64 by default: the port's
    CPU conformance path, which the tests hold to the reference at 1e-12)."""
    from benchmark import harness

    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["precision"] = precision
    cfg["families"] = cfg["families"][:families]
    for f in cfg["families"]:
        f["seqs"] = min(f["seqs"], seqs)
        f["trees"] = trees
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool=2, rows_per_output=4)
    return cell


@pytest.fixture
def family_cache_env(monkeypatch):
    """Keep the runs' LINEARHAM_FAMILY_CACHE setting inside the test."""
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
