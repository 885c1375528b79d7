"""No module the benchmark loads has a forbidden top-level name, and the
reference loads nothing of the port either.  Names compare whole: the
port's name merely begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark import harness


def _loaded_tops(code: str):
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        f"{code}\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "linearham_tpu_torch_fake", object())
    monkeypatch.delitem(sys.modules, "linearham_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    found = harness.forbidden_modules()
    assert "linearham_tpu" not in found and "jax" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_the_harness_and_the_port_load_no_jax():
    tops = _loaded_tops(
        "import benchmark.harness, benchmark.drivers, benchmark.check, "
        "benchmark.trace, benchmark.control\n"
        "import linearham_tpu_torch.cli, linearham_tpu_torch.pipeline.run\n"
        "for n in ['import_s', 'pruning_roofline_pct', 'device_idle_pct']:\n"
        "    benchmark.harness.metric_module(n)")
    assert "linearham_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded_tops(
        "import benchmark.reference.model, benchmark.reference.annotation, "
        "benchmark.reference.newick, benchmark.check")
    assert not tops & (set(harness.FORBIDDEN) | {"linearham_tpu_torch"})
