"""The port is self-contained: it loads no module of the JAX package.

* A fresh interpreter in a checkout that holds only ``linearham_tpu_torch/``
  imports every module of the port and runs its CPU pipeline on the
  fixture: neither jax nor any ``linearham_tpu`` module is loaded.
* No source of the port, nor ``chip_smoke.py``, imports the JAX package.
* Each host module the port copied from the JAX package gives the
  original's results on the same inputs, exactly: schedules (Python and
  the port's own C++ build), Newick and trees-TSV parsing, state space,
  transitions, xMSA, emissions, the post-processing files, the statistics
  helpers, and the synthetic input files of seeds 0-2 byte for byte.
* The family cache passes over a format-1 entry (one that names the JAX
  package's classes) without importing that package, and rebuilds.
"""

import dataclasses
import os
import pathlib
import pickle
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_pipeline import _make_tsv

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "linearham_tpu_torch"
FIXTURES = REPO / "tests" / "fixtures"
IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(from|import) linearham_tpu(\.| |$)", re.M)
FORBIDDEN = ("[m for m in sys.modules if m in ('jax', 'linearham_tpu') "
             "or m.startswith(('jax.', 'jaxlib', 'linearham_tpu.'))]")


def _clean_env(checkout):
    """The environment with ``checkout`` first on the path and no entry
    that holds the JAX package."""
    keep = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and not (pathlib.Path(p) / "linearham_tpu").is_dir()]
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(checkout),
                                                         *keep]),
            "LINEARHAM_FAMILY_CACHE": "off"}


def _checkout_without_jax_package(tmp_path):
    """A directory holding only the port's package (no linearham_tpu/)."""
    checkout = tmp_path / "checkout"
    shutil.copytree(PKG, checkout / "linearham_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return checkout


def test_cpu_pipeline_loads_neither_jax_nor_the_jax_package(tmp_path):
    checkout = _checkout_without_jax_package(tmp_path)
    trees = tmp_path / "rb.trees"
    _make_tsv(trees, n_rows=6, seed=3)
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        assert importlib.util.find_spec("linearham_tpu") is None
        import linearham_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            linearham_tpu_torch.__path__, "linearham_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from linearham_tpu_torch.io import native
        from linearham_tpu_torch.pipeline.run import run_pipeline
        assert native.native_available()
        res = run_pipeline({str(FIXTURES / 'phylo_hmm_input.yaml')!r}, 0,
                           {str(FIXTURES / 'hmm_params')!r}, {str(trees)!r},
                           {str(tmp_path / 'out.tsv')!r}, num_rates=4,
                           seed=0, chunk_size=4, precision="f64",
                           device="cpu")
        assert len(res.annotations) == 6
        print(len(names), {FORBIDDEN})
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env=_clean_env(checkout), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules, loaded = proc.stdout.strip().split(" ", 1)
    assert int(n_modules) > 40 and loaded == "[]"
    # The C++ host library was built inside the checkout, from its sources.
    assert list((checkout / "build" / "native").glob("*.so"))


def test_no_port_source_imports_the_jax_package():
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if IMPORT_OF_JAX_PACKAGE.search(p.read_text())]
    assert not offenders
    assert IMPORT_OF_JAX_PACKAGE.search("from linearham_tpu.io import x\n")
    assert not IMPORT_OF_JAX_PACKAGE.search(
        "from linearham_tpu_torch.io import x\n")


# -- the copies against their originals -------------------------------------

def _same(a, b, path="value"):
    """Equal in value and structure; classes compared by name (the port's
    copies are other classes of the same shape)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _family(pkg, yaml_name="phylo_hmm_input.yaml", params="hmm_params"):
    """(cluster, genes, space) of a fixture family through ``pkg``'s own
    partis, germline and state-space modules."""
    import importlib

    partis = importlib.import_module(f"{pkg}.io.partis")
    germline = importlib.import_module(f"{pkg}.io.germline")
    state_space = importlib.import_module(f"{pkg}.compiler.state_space")
    cluster = partis.load_cluster(str(FIXTURES / yaml_name), 0)
    genes = germline.load_gene_map(str(FIXTURES / params))
    space = state_space.build_state_space(cluster.locus, cluster.flexbounds,
                                          cluster.relpos, genes)
    return cluster, genes, space


def _families():
    return {pkg: _family(pkg) for pkg in ("linearham_tpu",
                                          "linearham_tpu_torch")}


def _tree_batches():
    """(the same synthetic trees batched by each package's Python parser,
    the Newick strings, the taxa)."""
    from linearham_tpu.io import newick as ref
    from linearham_tpu_torch.io import newick
    from linearham_tpu_torch.utils.synth import make_family, make_tree_samples

    fam = make_family(n_seqs=30, seed=4)
    newicks = make_tree_samples(fam, 24, seed=4).newicks
    labels = ["naive"] + list(fam.unique_ids)
    return (ref.batch_trees([ref.parse_newick(n) for n in newicks], labels),
            newick.batch_trees([newick.parse_newick(n) for n in newicks],
                               labels), newicks, labels)


def _case_schedule_python():
    from linearham_tpu.io import schedule as ref
    from linearham_tpu_torch.io import schedule

    ref_tb, tb, _, _ = _tree_batches()
    _same(ref_tb, tb)
    _same(ref.build_schedule_python(ref_tb),
          schedule.build_schedule_python(tb))


def _case_native_newick_and_schedule():
    """The port's own C++ build against the JAX package's Python path."""
    from linearham_tpu.io import schedule as ref
    from linearham_tpu_torch.io import native
    from linearham_tpu_torch.io.schedule import build_schedule

    ref_tb, _, newicks, labels = _tree_batches()
    tb = native.parse_newicks_batch(newicks, labels)
    assert tb is not None and native.native_available()
    _same(ref_tb, tb)
    _same(ref.build_schedule_python(ref_tb), build_schedule(tb))


def _case_trees_tsv(tmp_path):
    from linearham_tpu.io.trees_tsv import load_tree_samples as ref
    from linearham_tpu_torch.io.trees_tsv import load_tree_samples

    path = tmp_path / "rb.trees"
    _make_tsv(path, n_rows=9, seed=2)
    _same(ref(str(path)), load_tree_samples(str(path)))


def _case_state_space():
    fams = _families()
    _same(fams["linearham_tpu"], fams["linearham_tpu_torch"])


def _case_transitions():
    from linearham_tpu.compiler.transitions import build_transitions as ref
    from linearham_tpu_torch.compiler.transitions import build_transitions

    fams = _families()
    _same(ref(*fams["linearham_tpu"][2:], fams["linearham_tpu"][1]),
          build_transitions(fams["linearham_tpu_torch"][2],
                            fams["linearham_tpu_torch"][1]))


def _case_xmsa():
    from linearham_tpu.compiler.xmsa import build_xmsa as ref
    from linearham_tpu_torch.compiler.xmsa import build_xmsa

    out = {}
    for pkg, build in (("linearham_tpu", ref),
                       ("linearham_tpu_torch", build_xmsa)):
        cluster, genes, space = _family(pkg)
        out[pkg] = build(space, cluster.msa_codes(space.alphabet),
                         cluster.unique_ids)
    _same(out["linearham_tpu"], out["linearham_tpu_torch"])


def _case_emissions():
    from linearham_tpu.compiler.emissions import star_emissions as ref
    from linearham_tpu_torch.compiler.emissions import star_emissions

    out = {}
    for pkg, fn in (("linearham_tpu", ref),
                    ("linearham_tpu_torch", star_emissions)):
        cluster, genes, space = _family(pkg, "simple_hmm_input.yaml")
        out[pkg] = fn(space, genes, cluster.msa_codes(space.alphabet))
    _same(out["linearham_tpu"], out["linearham_tpu_torch"])


def _case_stats_and_seqs(tmp_path):
    from linearham_tpu.utils import seqs as ref_seqs, stats as ref_stats
    from linearham_tpu_torch.utils import seqs, stats

    rng = np.random.default_rng(7)
    for x in (rng.normal(size=300), np.cumsum(rng.normal(size=200))):
        assert stats.effective_sample_size(x) == \
            ref_stats.effective_sample_size(x)
    assert seqs.translate("ATGGCCTAA") == ref_seqs.translate("ATGGCCTAA")
    records = {"a": "ACGT", "b": "GGNN"}
    seqs.write_fasta(records, str(tmp_path / "p.fasta"))
    ref_seqs.write_fasta(records, str(tmp_path / "r.fasta"))
    assert (tmp_path / "p.fasta").read_bytes() == \
        (tmp_path / "r.fasta").read_bytes()
    _same(ref_seqs.read_fasta(str(tmp_path / "r.fasta")),
          seqs.read_fasta(str(tmp_path / "p.fasta")))


def _tree_files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _case_postprocess(tmp_path):
    """Each post-processing step of both packages on one bootstrap output
    of the port's workflow: the files they write are byte-equal."""
    import importlib

    from linearham_tpu_torch.workflow import run_family_workflow

    wf = tmp_path / "wf"
    wf.mkdir()
    _make_tsv(wf / "revbayes_run.trees", n_rows=8, seed=1)
    yaml_path = str(FIXTURES / "phylo_hmm_input.yaml")
    os.environ["LINEARHAM_FAMILY_CACHE"] = "off"
    try:
        run_family_workflow(str(wf), yaml_path, str(FIXTURES / "hmm_params"),
                            mcmc_iter=10, mcmc_thin=1, tune_iter=0,
                            tune_thin=1, num_rates=4, burnin_frac=0.25,
                            subsamp_frac=0.5, seed=0, device="cpu")
    finally:
        del os.environ["LINEARHAM_FAMILY_CACHE"]
    run = str(wf / "linearham_run")
    cwd = os.getcwd()
    for pkg in ("linearham_tpu", "linearham_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        pp = {m: importlib.import_module(f"{pkg}.postprocess.{m}") for m in
              ("parse_cluster", "revbayes_config", "annotations",
               "naive_probs", "lineage_probs")}
        os.chdir(out)   # relative output paths: the files name them
        try:
            pp["parse_cluster"].parse_cluster(
                yaml_path, "cluster.yaml", "seqs.fasta", cluster_index=0,
                indel_reversed_seqs=True)
            pp["revbayes_config"].generate_rev_file(
                "seqs.fasta", "run.rev", 10, 1, 0, 1, 4, 0)
            pp["annotations"].write_lh_annotations(
                str(wf / "cluster.yaml"), run + ".log", run + ".trees", "ann")
            pp["naive_probs"].tabulate_naive_probs(run + ".trees", "naive")
            pp["lineage_probs"].tabulate_lineage_probs(
                run + ".trees", "naive.fasta", "0", [0.0, 0.1], "lineage")
        finally:
            os.chdir(cwd)
    ref, got = (_tree_files(tmp_path / p) for p in ("linearham_tpu",
                                                    "linearham_tpu_torch"))
    assert len(got) >= 8 and list(ref) == list(got)
    for name in ref:
        assert ref[name] == got[name], name


def _case_synth_files(tmp_path, seed):
    """The port's synthetic inputs equal the JAX generators' byte for byte:
    a family's YAML, germline directory and trees TSV, and an igk one."""
    from linearham_tpu.io.germline import write_gene_dir
    from linearham_tpu.utils import synth as ref
    from linearham_tpu_torch.utils.synth import write_pipeline_inputs

    want = tmp_path / "ref"
    want.mkdir()
    fam = ref.make_family(n_seqs=9, seed=seed)
    write_gene_dir(fam.genes, str(want / "hmm_params"))
    ref.write_partis_yaml(fam, str(want / "partis_run.yaml"), seed=seed)
    ref.write_trees_tsv(ref.make_tree_samples(fam, 20, seed=seed),
                        str(want / "revbayes_run.trees"))
    got = tmp_path / "port"
    got.mkdir()
    write_pipeline_inputs(str(got), 9, 20, seed=seed)
    assert _tree_files(want) == _tree_files(got)

    from linearham_tpu_torch.utils import synth

    light_ref = ref.make_light_family(n_seqs=7, seed=seed)
    light = synth.make_light_family(n_seqs=7, seed=seed)
    ref.write_partis_yaml(light_ref, str(want / "igk.yaml"), seed=seed)
    synth.write_partis_yaml(light, str(got / "igk.yaml"), seed=seed)
    assert (want / "igk.yaml").read_bytes() == (got / "igk.yaml").read_bytes()


CASES = {
    "schedule_python": _case_schedule_python,
    "native_newick_and_schedule": _case_native_newick_and_schedule,
    "trees_tsv": _case_trees_tsv,
    "state_space": _case_state_space,
    "transitions": _case_transitions,
    "xmsa": _case_xmsa,
    "emissions": _case_emissions,
    "stats_and_seqs": _case_stats_and_seqs,
    "postprocess": _case_postprocess,
    "synth_seed0": lambda tmp_path: _case_synth_files(tmp_path, 0),
    "synth_seed1": lambda tmp_path: _case_synth_files(tmp_path, 1),
    "synth_seed2": lambda tmp_path: _case_synth_files(tmp_path, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_copied_module_matches_its_original(case, tmp_path):
    fn = CASES[case]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()


def test_family_cache_passes_over_a_format_1_entry(tmp_path):
    """A format-1 entry (its key and a pickle naming the JAX package's
    classes) is not read: a fresh interpreter builds the family, writes a
    format-2 entry, and never imports that package."""
    from linearham_tpu.utils.profiling import StageTimer
    from linearham_tpu_torch.compiler import family_cache

    yaml_path = str(FIXTURES / "phylo_hmm_input.yaml")
    gene_dir = str(FIXTURES / "hmm_params")
    key = family_cache.family_key(yaml_path, 0, gene_dir, "float64")
    old = family_cache._FORMAT_VERSION
    family_cache._FORMAT_VERSION = 1
    try:
        key1 = family_cache.family_key(yaml_path, 0, gene_dir, "float64")
    finally:
        family_cache._FORMAT_VERSION = old
    assert key1 != key
    cache = tmp_path / "cache"
    cache.mkdir()
    stale = cache / f"{key1}.pkl"
    stale.write_bytes(pickle.dumps({"timer": StageTimer()}))
    assert b"linearham_tpu.utils.profiling" in stale.read_bytes()

    code = textwrap.dedent(f"""
        import pickle, sys
        from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
        from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
        hit = cached_phylo_hmm({yaml_path!r}, 0, {gene_dir!r}, device="cpu",
                               cache_dir={str(cache)!r})
        fresh = PhyloHMM({yaml_path!r}, 0, {gene_dir!r}, device="cpu")
        for h in (hit, fresh):
            h.init_phylo_parameters({str(FIXTURES / 'newton.tree')!r},
                                    [1.0] * 6, [0.17, 0.19, 0.25, 0.39],
                                    1.0, 4)
        assert hit.log_likelihood() == fresh.log_likelihood()
        with open({str(cache / f"{key}.pkl")!r}, "rb") as fh:
            assert "cluster" in pickle.load(fh)
        print({FORBIDDEN})
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [f"{key}.pkl", f"{key1}.pkl"])
