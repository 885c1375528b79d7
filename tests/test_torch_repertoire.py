"""Port repertoire path (linearham_tpu_torch.parallel) vs the JAX package.

The families are built once by the JAX package and handed to the port with
``PhyloHMM.from_host_products``, so both packages compute on identical
constants.  On the CPU in f64 the port's ``run_repertoire`` (one pruning
call per bucket over the stacked families) matches the JAX package's
``run_repertoire`` (a vmap over padded families) at rtol 1e-9, and each
family matches the port's own single-family pipeline.  The stacking itself
(``stack_schedules``) is held against per-family plain walks at 1e-12.

The JAX package is imported inside the tests, not at the top, so the
``cuda`` tests at the end run on a machine without jax
(``python -m pytest --noconftest -m cuda tests/test_torch_repertoire.py``).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from linearham_tpu.io.schedule import PruningSchedule
from linearham_tpu.io.trees_tsv import load_tree_samples
from linearham_tpu_torch.models.phylo_hmm import PhyloHMM
from linearham_tpu_torch.ops import pruning_cuda
from linearham_tpu_torch.ops.gtr import GTREigen
from linearham_tpu_torch.parallel import multihost
from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                     run_repertoire,
                                                     write_family_output)
from linearham_tpu_torch.models.step import (Prepared, launch,
                                             prepare_ensemble, stack_blocks)
from linearham_tpu_torch.pipeline.run import run_pipeline_arrays
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.synth import (make_family, make_light_family,
                                             make_tree_samples,
                                             write_repertoire_inputs)
from test_torch_pipeline import _make_tsv
from test_torch_profiling import YAML_LOADS, junction_rows

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
SPECS = [  # tests/test_repertoire.py's four families: three buckets
    ("phylo_hmm_input.yaml", "hmm_params", 11),
    ("phylo_hmm_input_extra.yaml", "hmm_params", 12),
    ("phylo_hmm_input.yaml", "hmm_params", 13),
    ("phylo_hmm_input_igk.yaml", "igk_hmm_params", 14),
]
STAGES = {"stack_families", "device_transfer", "device_step", "decode",
          "junction_scan"}


def _host_of(jax_hmm) -> dict:
    """The host products a JAX PhyloHMM was installed from."""
    h = jax_hmm
    return {"cluster": h.cluster, "genes": h.genes, "space": h.space,
            "family": h.family, "msa": h.msa, "xmsa": h.xmsa,
            "trans_np": h._trans_np, "consts_np": h._consts_np,
            "xmsa_rows_np": h._xmsa_rows_np,
            "naive_bases_np": h._naive_bases_np}


def _task_pairs(tmp, specs):
    """[(JAX FamilyTask, port FamilyTask)] on shared host products."""
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.parallel.repertoire import FamilyTask as JaxTask

    pairs = []
    for i, (yaml_name, params, seed, n_rows) in enumerate(specs):
        tsv = tmp / f"trees_{i}.tsv"
        _make_tsv(tsv, n_rows=n_rows, seed=seed)
        samples = load_tree_samples(str(tsv))
        ref = JaxPhyloHMM(str(FIXTURES / yaml_name), 0,
                          str(FIXTURES / params), seed=0)
        port = PhyloHMM.from_host_products(_host_of(ref), device="cpu",
                                           dtype=torch.float64)
        pairs.append((JaxTask(hmm=ref, samples=samples),
                      FamilyTask(hmm=port, samples=samples)))
    return pairs


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_rep")
    return _task_pairs(tmp, [(*s, 4) for s in SPECS])


def _check_against_jax_and_pipeline(pairs):
    from linearham_tpu.parallel.repertoire import \
        run_repertoire as jax_run_repertoire

    want = jax_run_repertoire([j for j, _ in pairs], num_rates=4, seed=0)
    got = run_repertoire([p for _, p in pairs], num_rates=4, seed=0,
                         device="cpu")
    assert len(got) == len(pairs)
    for (_, task), g, w in zip(pairs, got, want):
        T = task.samples.n_samples
        assert g.loglik.shape == (T,) and len(g.annotations) == T
        np.testing.assert_allclose(g.loglik, w.loglik, rtol=1e-9)
        np.testing.assert_allclose(g.logweight, w.logweight, rtol=1e-9)
        single = run_pipeline_arrays(task.hmm, task.samples, num_rates=4)
        np.testing.assert_allclose(g.loglik, single.lh_loglik, rtol=1e-9)
        for ann in g.annotations:
            assert len(ann.naive_seq) == task.hmm.cluster.n_sites


def test_repertoire_matches_jax_three_buckets(pairs):
    """Two igh families of one junction shape, one igh family of another
    and one igk family: three pruning calls, each family at rtol 1e-9."""
    _check_against_jax_and_pipeline(pairs)


def test_repertoire_one_bucket_of_unequal_columns():
    """Three synthetic igh families of one junction shape but 864, 619 and
    446 xMSA columns and 4, 7 and 5 rows: one stacked call, the padded
    columns sliced off before the emissions."""
    from linearham_tpu.models.phylo_hmm import PhyloHMM as JaxPhyloHMM
    from linearham_tpu.parallel.repertoire import FamilyTask as JaxTask

    pairs = []
    for i, kw in enumerate([dict(n_seqs=3), dict(n_seqs=6, v_len=200,
                                                 j_len=40),
                            dict(n_seqs=4, v_len=120, d_len=20)]):
        fam = make_family(seed=i + 1, **kw)
        ref = JaxPhyloHMM.from_parts(
            fam.locus, fam.flexbounds, fam.relpos, fam.genes, fam.msa,
            fam.unique_ids, fam.n_sites, seed=0)
        port = PhyloHMM.from_host_products(_host_of(ref), device="cpu",
                                           dtype=torch.float64)
        samples = make_tree_samples(fam, 3 + i, seed=i)
        pairs.append((JaxTask(hmm=ref, samples=samples),
                      FamilyTask(hmm=port, samples=samples)))
    assert [p.hmm.xmsa.n_cols for _, p in pairs] == [864, 619, 446]
    _check_against_jax_and_pipeline(pairs)


def test_repertoire_ragged_tree_counts(tmp_path):
    """5/7/9-tree families share a bucket; the port concatenates their
    trees (no padding) and slices each family's rows back."""
    specs = [("phylo_hmm_input.yaml", "hmm_params", 20 + i, n)
             for i, n in enumerate((5, 7, 9))]
    _check_against_jax_and_pipeline(_task_pairs(tmp_path, specs))


def test_one_pruning_call_per_bucket(pairs, monkeypatch):
    import linearham_tpu_torch.models.step as step

    calls = []

    def counting(*args):
        calls.append(args[4].shape[0])            # trees in the call
        return pruning_cuda.site_log_likelihoods(*args)

    monkeypatch.setattr(step, "site_log_likelihoods", counting)
    run_repertoire([p for _, p in pairs], num_rates=4, device="cpu")
    assert calls == [8, 4, 4]


def test_repertoire_rejects_a_model_on_another_dtype(pairs):
    with pytest.raises(ValueError, match="lies on"):
        run_repertoire([pairs[0][1]], device="cpu", dtype=torch.float32)


# -- stack_schedules ----------------------------------------------------------

def _family_inputs(make, n_seqs, n_trees, seed, n_slots=None):
    """(schedule, xMSA rows, eig, pi, rates) of a synthetic family, the
    schedule optionally re-slotted to ``n_slots`` (its sink moved)."""
    fam = make(n_seqs=n_seqs, seed=seed)
    hmm = PhyloHMM.from_parts(fam.locus, fam.flexbounds, fam.relpos,
                              fam.genes, fam.msa, fam.unique_ids, fam.n_sites,
                              device="cpu")
    samples = make_tree_samples(fam, n_trees, seed=seed)
    sched, eig, rates = prepare_ensemble(hmm, samples, 4)
    if n_slots is not None:
        penc = sched.penc.copy()
        penc[penc == (sched.n_slots - 1) * 4 + 3] = (n_slots - 1) * 4 + 3
        sched = PruningSchedule(sched.src, penc, sched.length, sched.root,
                                n_slots)
    return (sched, np.asarray(hmm.xmsa.matrix, np.int32), eig,
            np.asarray(samples.pi), rates)


def _plain(sched, rows, eig, pi, rates):
    def t(a):
        a = np.asarray(a)
        return torch.as_tensor(a, dtype=torch.float64 if a.dtype.kind == "f"
                               else torch.int32)

    return pruning_cuda.site_log_likelihoods_plain(
        GTREigen(*map(t, eig)), t(pi), t(rates), t(rows), t(sched.src),
        t(sched.penc), t(sched.length), t(sched.root), sched.n_slots).numpy()


def _stacked_vs_each(families):
    stacked = pruning_cuda.stack_schedules([f[0] for f in families],
                                           [f[1] for f in families])
    cat = [np.concatenate(parts) for parts in zip(*(f[2] for f in families))]
    got = _plain(stacked.sched, stacked.codes, cat,
                 np.concatenate([f[3] for f in families]),
                 np.concatenate([f[4] for f in families]))
    assert got.shape == (stacked.sched.n_trees, stacked.codes.shape[1])
    for f, fam in enumerate(families):
        want = _plain(*fam)
        rows = got[stacked.trees(f)]
        np.testing.assert_allclose(rows[:, :want.shape[1]], want,
                                   rtol=1e-12, atol=1e-12)
        # Padded columns are all-N sites: log(sum_i pi_i) = 0.
        np.testing.assert_allclose(rows[:, want.shape[1]:], 0.0, atol=1e-12)
    return stacked


def test_stacked_plain_walk_matches_each_family():
    """Unequal N (5 vs 30 vs 7 tips), n_slots (8 vs 16), row counts and X
    (igh 863 vs igk): every family's rows of the one stacked walk equal its
    own walk at 1e-12."""
    families = [_family_inputs(make_family, 4, 3, seed=1),
                _family_inputs(make_family, 29, 2, seed=2, n_slots=16),
                _family_inputs(make_light_family, 6, 3, seed=3)]
    n_entries = [f[0].n_entries for f in families]
    assert len(set(n_entries)) == 3
    assert families[0][1].shape[1] != families[2][1].shape[1]
    stacked = _stacked_vs_each(families)
    s = stacked.sched
    assert s.n_slots == 16 and s.n_entries == max(n_entries)
    assert list(stacked.row_offsets) == [0, 5, 35, 42]
    # Padding: the bucket sink, branch length 0; past N_f, the all-N row.
    pad = (s.n_slots - 1) * 4 + 3
    tail = s.penc[stacked.trees(0), n_entries[0]:]
    assert (tail == pad).all()
    assert (s.src[stacked.trees(0), n_entries[0]:]
            == stacked.codes.shape[0] - 1).all()
    assert (stacked.codes[-1] == 4).all()
    assert (s.length[stacked.trees(0), n_entries[0]:] == 0).all()


def test_stacked_table_past_int16_rows():
    """A first family of 40,000 rows pushes the second family's tip rows
    past 32,767: ``src`` stays int32 and both families stay exact (the JAX
    package's int16 cast of sched_src is not copied)."""
    sched, rows, eig, pi, rates = _family_inputs(make_family, 5, 3, seed=4)
    rows = rows[:, :3]                                  # a narrow X
    big = np.random.default_rng(0).integers(0, 5, (40_000, 3)).astype(
        np.int32)
    tip = (sched.penc & 1) == 1
    far = PruningSchedule(np.where(tip, sched.src + 39_990, sched.src),
                          sched.penc, sched.length, sched.root,
                          sched.n_slots)
    stacked = _stacked_vs_each([(far, big, eig, pi, rates),
                                (sched, rows, eig, pi, rates)])
    assert stacked.sched.src.dtype == np.int32
    assert stacked.sched.src[stacked.trees(1)].max() > 40_000 > 32_767


def test_stack_schedules_checks_the_stacked_rows():
    sched, rows, *_ = _family_inputs(make_family, 4, 2, seed=5)
    bad = PruningSchedule(np.where((sched.penc & 1) == 1, rows.shape[0] + 1,
                                   sched.src), sched.penc, sched.length,
                          sched.root, sched.n_slots)
    with pytest.raises(ValueError, match="outside the xMSA rows"):
        pruning_cuda.stack_schedules([bad], [rows])
    with pytest.raises(ValueError, match="one row table per schedule"):
        pruning_cuda.stack_schedules([sched], [])


# -- end to end ----------------------------------------------------------------

def test_repertoire_e2e_tsv_and_timings(pairs, tmp_path):
    tasks = [p for _, p in pairs]
    with profiling.recording() as timer:
        results = run_repertoire(tasks, num_rates=4, seed=0, device="cpu")
    timings = timer.as_dict()
    assert set(timings) == STAGES
    assert all(v >= 0 for v in timings.values())
    for f, (task, res) in enumerate(zip(tasks, results)):
        out = tmp_path / f"lh_fam{f}.trees"
        write_family_output(task, res, 4, str(out))
        lines = out.read_text().rstrip("\n").split("\n")
        assert len(lines) == task.samples.n_samples + 1
        header = lines[0].split("\t")
        assert header[:4] == ["Iteration", "RBLogLikelihood", "Prior",
                              "alpha"]
        ll_col = header.index("LHLogLikelihood")
        for t, line in enumerate(lines[1:]):
            fields = line.split("\t")
            assert len(fields) == len(header)
            assert float(fields[ll_col]) == pytest.approx(res.loglik[t],
                                                          rel=1e-12)
        if not task.hmm.heavy:
            assert "VJInsertion" in header and "DGene" not in header


def _cli(*argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", "linearham_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, **(env or {})})


def test_cli_repertoire_on_the_synthetic_writer(tmp_path):
    """write_repertoire_inputs' igh manifest (three depths sharing one
    germline directory) through ``cli repertoire --profile --trace-dir``;
    every family equals its single-family pipeline, every stage line is one
    the benchmark reads, and the trace holds the program's spans."""
    from benchmark.drivers import _PROFILE_RE
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm

    reps = write_repertoire_inputs(
        str(tmp_path), [("igh", 3, 4, 0.02), ("igh", 6, 3, 0.05),
                        ("igh", 9, 5, 0.08), ("igk", 4, 3, 0.03)])
    assert set(reps) == {"igh", "igk"}
    igh = reps["igh"]
    msas = [f.family.msa for f in igh.families]
    assert [m.shape[0] for m in msas] == [3, 6, 9]
    assert all(f.family.genes.keys() == igh.families[0].family.genes.keys()
               for f in igh.families)
    trace_dir = tmp_path / "trace"
    proc = _cli("repertoire", "--families", igh.manifest, "--hmm-param-dir",
                igh.gene_dir, "--num-rates", "4", "--profile", "--device",
                "cpu", "--trace-dir", str(trace_dir),
                env={"LINEARHAM_FAMILY_CACHE": "off"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("repertoire ok: 3 families, 12 trees in ")
    stage_lines = [ln for ln in proc.stderr.splitlines()
                   if ln.startswith("#   ")]
    stages = {_PROFILE_RE.match(ln).group(1) for ln in stage_lines}
    assert STAGES | {"build_hmm", "load_trees_tsv", "write_tsv",
                     "load_gene_map", "compile", "place"} <= stages
    (counters,) = [json.loads(ln[len("# counters: "):])
                   for ln in proc.stderr.splitlines()
                   if ln.startswith("# counters: ")]
    # 8 gene files once, and the 3 families' partis files.
    assert counters == {"gene_map_parses": 1, "gene_map_shared": 2,
                        YAML_LOADS: 8 + 3, "chunks": 1,
                        "junction_rows": sum(
                            junction_rows(f.yaml_path, 0, f.gene_dir)
                            for f in igh.families),
                        "tsv_native_rows": 12}
    (trace,) = trace_dir.glob("repertoire.*.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {f"stage/{s}" for s in stages} <= names
    for files, out in zip(igh.families, igh.outputs):
        lines = pathlib.Path(out).read_text().strip().split("\n")
        header = lines[0].split("\t")
        got = [float(ln.split("\t")[header.index("LHLogLikelihood")])
               for ln in lines[1:]]
        hmm = cached_phylo_hmm(files.yaml_path, 0, files.gene_dir,
                               device="cpu", cache_dir=str(tmp_path / "fc"))
        ref = run_pipeline_arrays(hmm, load_tree_samples(files.trees_path),
                                  num_rates=4)
        np.testing.assert_allclose(got, ref.lh_loglik, rtol=1e-9)


def _repertoire_counters(manifest, gene_dir, capsys) -> dict:
    """``cli repertoire --profile`` in process: its ``# counters:`` line."""
    from linearham_tpu_torch import cli

    capsys.readouterr()
    assert cli.main(["repertoire", "--families", manifest, "--hmm-param-dir",
                     gene_dir, "--num-rates", "4", "--seed", "7",
                     "--profile", "--device", "cpu"]) == 0
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("# counters: ")]
    return json.loads(line[len("# counters: "):])


def _repertoire_call(rep, outdir, capsys):
    """``cli repertoire --profile`` over ``rep``'s families, writing into
    ``outdir``: the counters and each family's TSV bytes."""
    outdir.mkdir()
    outs = [outdir / f"f{i}.tsv" for i in range(len(rep.families))]
    manifest = outdir / "manifest.tsv"
    manifest.write_text("".join(
        f"{f.yaml_path}\t0\t{f.trees_path}\t{out}\n"
        for f, out in zip(rep.families, outs)))
    counters = _repertoire_counters(str(manifest), rep.gene_dir, capsys)
    return counters, [out.read_bytes() for out in outs]


def test_cli_repertoire_parses_the_shared_gene_dir_once(tmp_path, capsys,
                                                        monkeypatch):
    """A cold call over four families of one germline directory parses it
    once and shares it three times; a warm call over the same cache parses
    nothing; and the TSVs equal, byte for byte, those of a call in which
    every family parses the directory itself."""
    from linearham_tpu_torch.compiler import family_cache

    (igh,) = write_repertoire_inputs(
        str(tmp_path / "in"), [("igh", 3, 4, 0.02), ("igh", 5, 3, 0.05),
                               ("igh", 4, 5, 0.08), ("igh", 6, 2, 0.03)]
    ).values()
    assert len(igh.families) == 4

    def call(name, cache):
        monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", str(tmp_path / cache))
        return _repertoire_call(igh, tmp_path / name, capsys)

    scanned = sum(junction_rows(f.yaml_path, 0, f.gene_dir)
                  for f in igh.families)
    cold, shared = call("cold", "fc")
    # 8 gene files once, and the 4 families' partis files.
    assert cold == {"cache_misses": 4, "gene_map_parses": 1,
                    "gene_map_shared": 3, YAML_LOADS: 8 + 4, "chunks": 1,
                    "junction_rows": scanned, "tsv_native_rows": 14}
    warm, again = call("warm", "fc")
    assert warm == {"cache_hits": 4, "chunks": 1, "junction_rows": scanned,
                    "tsv_native_rows": 14}
    assert again == shared

    lone = family_cache.load_host_products
    monkeypatch.setattr(
        family_cache, "load_host_products",
        lambda y, ci, d, gene_maps=None: lone(y, ci, d))
    each, alone = call("alone", "fc_alone")
    assert each == {"cache_misses": 4, "gene_map_parses": 4,
                    YAML_LOADS: 4 * 8 + 4, "chunks": 1,
                    "junction_rows": scanned, "tsv_native_rows": 14}
    assert alone == shared
    assert all(b.count(b"\n") > 1 for b in shared)


@pytest.mark.parametrize("locus,n_gene_files", [("igh", 8), ("igk", 4)])
def test_cli_repertoire_writes_the_same_bytes_under_either_loader(
        locus, n_gene_files, tmp_path, capsys, monkeypatch):
    """A cold call over three families reads the germline directory and
    each partis file through libyaml, and writes TSVs byte-equal to those
    of the same call through the pure-Python loader."""
    from linearham_tpu_torch.io import yaml_load

    if not yaml.__with_libyaml__:
        pytest.skip("this PyYAML was built without libyaml")
    (rep,) = write_repertoire_inputs(
        str(tmp_path / "in"), [(locus, 3, 4, 0.02), (locus, 5, 3, 0.05),
                               (locus, 4, 2, 0.08)]).values()
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")

    def call(name, loader):
        with monkeypatch.context() as m:
            m.setattr(yaml_load, "LOADER", loader)
            return _repertoire_call(rep, tmp_path / name, capsys)

    fast, fast_tsvs = call("libyaml", yaml.CSafeLoader)
    slow, slow_tsvs = call("python", yaml.SafeLoader)
    rest = {k: v for k, v in fast.items() if k != "yaml_libyaml_loads"}
    assert rest["gene_map_parses"] == 1
    assert fast == {**rest, "yaml_libyaml_loads": n_gene_files + 3}
    assert slow == {**rest, "yaml_python_loads": n_gene_files + 3}
    assert fast_tsvs == slow_tsvs
    assert all(b.count(b"\n") > 1 for b in fast_tsvs)


@pytest.mark.parametrize("locus", ["igh", "igk"])
def test_cli_repertoire_writes_the_same_bytes_under_either_writer(
        locus, tmp_path, capsys, monkeypatch):
    """A cold call over three families formats every row in the C++ host
    library, and writes TSVs byte-equal to those of the same call with the
    rows formatted in Python."""
    from linearham_tpu_torch.io import output_tsv

    (rep,) = write_repertoire_inputs(
        str(tmp_path / "in"), [(locus, 3, 4, 0.02), (locus, 5, 3, 0.05),
                               (locus, 4, 2, 0.08)]).values()
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    fast, fast_tsvs = _repertoire_call(rep, tmp_path / "native", capsys)
    with monkeypatch.context() as m:
        m.setattr(output_tsv, "format_output_rows", lambda *args: None)
        slow, slow_tsvs = _repertoire_call(rep, tmp_path / "python", capsys)
    rest = {k: v for k, v in fast.items() if k != "tsv_native_rows"}
    assert fast == {**rest, "tsv_native_rows": 4 + 3 + 2}
    assert slow == {**rest, "tsv_python_rows": 4 + 3 + 2}
    assert fast_tsvs == slow_tsvs
    assert [b.count(b"\n") for b in fast_tsvs] == [5, 4, 3]
    assert not any(b"[&index=" in b for b in fast_tsvs)


@pytest.mark.parametrize("manifest,message", [
    ("a.yaml\t0\tt.tsv\n", "needs 4 tab-separated fields"),
    ("# only a comment\n\n", "empty family manifest"),
], ids=["three_fields", "empty"])
def test_cli_repertoire_manifest_errors(tmp_path, manifest, message):
    path = tmp_path / "manifest.tsv"
    path.write_text(manifest)
    proc = _cli("repertoire", "--families", str(path), "--hmm-param-dir",
                str(FIXTURES / "hmm_params"), "--device", "cpu")
    assert proc.returncode != 0
    assert message in proc.stderr


# -- multihost helpers --------------------------------------------------------

def test_process_slice_matches_jax():
    from linearham_tpu.parallel import multihost as jax_multihost

    for n_items in (0, 1, 7, 10):
        items = list(range(n_items))
        for n in (1, 2, 3, 4):
            got = [multihost.process_slice(items, p, n) for p in range(n)]
            assert got == [jax_multihost.process_slice(items, p, n)
                           for p in range(n)]
            assert sum(got, []) == items
    assert multihost.process_slice(list(range(10))) == list(range(10))


def _oracle(ll, rb):
    lw = [np.asarray(a) - np.asarray(b) for a, b in zip(ll, rb)]
    ess = [np.exp(x - x.max()).sum() ** 2 / np.exp(2 * (x - x.max())).sum()
           for x in lw]
    flat = np.concatenate(lw)
    return {"n_trees": float(flat.size), "mean_logweight": flat.mean(),
            "mean_family_ess": float(np.mean(ess))}


def test_pooled_summary_matches_jax_and_numpy():
    from linearham_tpu.parallel import multihost as jax_multihost

    rng = np.random.default_rng(0)
    ll = [rng.normal(-1000.0, 5.0, size=n) for n in (8, 3, 11)]
    rb = [rng.normal(-1010.0, 5.0, size=n) for n in (8, 3, 11)]
    got = multihost.pooled_repertoire_summary_multiprocess(ll, rb)
    want = jax_multihost.pooled_repertoire_summary_multiprocess(ll, rb)
    oracle = _oracle(ll, rb)
    for k in oracle:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
        assert got[k] == pytest.approx(oracle[k], rel=1e-12)
    # A family with no trees adds nothing (the JAX helper raises on it).
    assert multihost.pooled_repertoire_summary_multiprocess(
        ll + [[]], rb + [[]]) == got


WORKER = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from linearham_tpu_torch.parallel import multihost

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
rng = np.random.default_rng(0)
ll = [rng.normal(-1000.0, 5.0, size=n) for n in (8, 3, 11)]
rb = [rng.normal(-1010.0, 5.0, size=n) for n in (8, 3, 11)]
mine = multihost.process_slice(list(range(3)))
pooled = multihost.pooled_repertoire_summary_multiprocess(
    [ll[i] for i in mine], [rb[i] for i in mine])
dist.destroy_process_group()
json.dump({"mine": mine, "pooled": pooled}, open(out, "w"))
"""


def test_pooled_summary_across_two_gloo_processes(tmp_path):
    """Two processes over a gloo group: each takes its process_slice of
    three families, and both report the one-process summary."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port),
         str(tmp_path / f"w{r}.json")], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    reports = [json.loads((tmp_path / f"w{r}.json").read_text())
               for r in range(2)]
    assert [r["mine"] for r in reports] == [[0, 1], [2]]
    rng = np.random.default_rng(0)
    ll = [rng.normal(-1000.0, 5.0, size=n) for n in (8, 3, 11)]
    rb = [rng.normal(-1010.0, 5.0, size=n) for n in (8, 3, 11)]
    want = multihost.pooled_repertoire_summary_multiprocess(ll, rb)
    for r in reports:
        for k, v in want.items():
            assert r["pooled"][k] == pytest.approx(v, rel=1e-12)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_tasks(tmp):
    reps = write_repertoire_inputs(
        str(tmp), [("igh", 4, 40, 0.02), ("igh", 20, 30, 0.06),
                   ("igk", 6, 20, 0.03)])
    tasks = []
    for rep in reps.values():
        for files in rep.families:
            hmm = PhyloHMM(files.yaml_path, 0, files.gene_dir,
                           device="cuda", dtype=torch.float32)
            tasks.append(FamilyTask(
                hmm=hmm, samples=load_tree_samples(files.trees_path)))
    return tasks


@pytest.mark.cuda
def test_card_one_launch_per_bucket_and_matches_pipeline(cuda_device,
                                                         tmp_path):
    tasks = _card_tasks(tmp_path)
    before = pruning_cuda.launches
    results = run_repertoire(tasks, num_rates=4, seed=0, device="cuda")
    torch.cuda.synchronize()
    assert pruning_cuda.launches == before + 2
    for task, res in zip(tasks, results):
        single = run_pipeline_arrays(task.hmm, task.samples, num_rates=4)
        assert np.isfinite(res.loglik).all()
        np.testing.assert_allclose(res.loglik, single.lh_loglik, rtol=0,
                                   atol=1e-4)


@pytest.mark.cuda
def test_card_stacked_launch_matches_plain(cuda_device, tmp_path):
    tasks = _card_tasks(tmp_path)
    inputs = stack_blocks([Prepared.of(t.hmm, t.samples, 4)
                           for t in tasks]).to_device(torch.device("cuda"),
                                                      torch.float32)
    got = launch(inputs)
    want = pruning_cuda.site_log_likelihoods_plain(*inputs.args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_card_failing_launch_raises(cuda_device, tmp_path, monkeypatch):
    """A launch the card refuses raises DeviceError out of run_repertoire:
    nothing carries on with the plain version."""
    from linearham_tpu_torch.utils.runtime import DeviceError

    tasks = _card_tasks(tmp_path)
    lib = pruning_cuda.kernel_lib()

    class Refusing:
        lh_pruning_smem_bytes = lib.lh_pruning_smem_bytes

        @staticmethod
        def lh_pruning_launch(*args):
            return 719                       # cudaErrorLaunchFailure

    monkeypatch.setattr(pruning_cuda, "kernel_lib", lambda: Refusing)
    monkeypatch.setattr(pruning_cuda, "site_log_likelihoods_plain", None)
    before = pruning_cuda.launches
    with pytest.raises(DeviceError, match="cudaError 719"):
        run_repertoire(tasks, num_rates=4, device="cuda")
    assert pruning_cuda.launches == before
