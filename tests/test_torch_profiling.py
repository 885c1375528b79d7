"""The port's span recorder (linearham_tpu_torch/utils/profiling.py) and
where its spans and counters leave the program: ``run_pipeline``'s
``timings`` and ``counters``, and the ``--trace-dir`` export.  jax-free
and without conftest fixtures, so the ``cuda`` test runs on the card's
machine with ``python -m pytest --noconftest -m cuda``."""

import json
import threading
import time

import pytest
import torch
import yaml

from linearham_tpu_torch.pipeline.run import run_pipeline
from linearham_tpu_torch.utils import profiling
from linearham_tpu_torch.utils.profiling import StageTimer
from linearham_tpu_torch.utils.synth import (write_pipeline_inputs,
                                             write_repertoire_inputs)

# The keys run_pipeline's timings had before the recorder spanned the whole
# call; the benchmark's per-layer metrics read them with these meanings.
OLD_KEYS = {"load_trees_tsv", "build_hmm", "host_prepare", "device_transfer",
            "dispatch", "device_step", "decode", "write_tsv"}
NEW_KEYS = {"family_key", "cache_read", "load_cluster", "load_gene_map",
            "compile", "cache_write", "place", "gamma_rates", "open_output",
            "drain_wait", "rename_output"}
# The counter of the documents the port's YAML reader loads, by loader.
YAML_LOADS = ("yaml_libyaml_loads" if yaml.__with_libyaml__
              else "yaml_python_loads")


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_nesting_parents_and_self_time():
    timer = StageTimer()
    with timer.stage("outer"):
        _busy(0.004)
        with timer.stage("inner"):
            _busy(0.006)
        with timer.stage("inner"):
            _busy(0.002)
    by_name = {}
    for s in timer.spans:
        by_name.setdefault(s.name, []).append(s)
    (outer,), inners = by_name["outer"], by_name["inner"]
    assert outer.parent is None
    assert all(s.parent == outer.id for s in inners)
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
               for s in inners)
    assert {s.request for s in timer.spans} == {timer.request}
    assert {s.thread for s in timer.spans} == {threading.get_native_id()}
    totals, own = timer.as_dict(), timer.self_times()
    assert list(totals) == ["outer", "inner"]           # by first start
    assert totals["inner"] == own["inner"] >= 0.008
    assert own["outer"] == pytest.approx(
        totals["outer"] - totals["inner"], abs=1e-9)
    assert 0.004 <= own["outer"] < totals["outer"]


def test_threads_and_requests_are_kept_apart():
    """A span of another thread has no parent there, carries that thread's
    id, and is not taken from the open span of the thread that started it;
    each recorder is its own request."""
    timer, other = StageTimer(), StageTimer()
    seen = []

    def work():
        seen.append(threading.get_native_id())
        with timer.stage("drain"):
            pass

    with timer.stage("main"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
    drain = next(s for s in timer.spans if s.name == "drain")
    main = next(s for s in timer.spans if s.name == "main")
    assert drain.parent is None and drain.thread == seen[0] != main.thread
    assert other.request != timer.request
    timer.count("chunks")
    timer.count("chunks", 2)
    assert timer.counters == {"chunks": 3} and other.counters == {}


def test_threads_sharing_a_recorder_lose_nothing():
    """More threads than cores on one recorder, switching every few µs:
    every span and count lands, each parent on its own thread."""
    import os
    import sys

    timer = StageTimer()
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200

    def work():
        for _ in range(n_spans):
            with timer.stage("outer"):
                with timer.stage("inner"):
                    timer.count("n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timer.counters == {"n": n_threads * n_spans}
    assert len(timer.spans) == 2 * n_threads * n_spans
    assert len({s.id for s in timer.spans}) == len(timer.spans)
    by_id = {s.id: s for s in timer.spans}
    for s in timer.spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].thread == s.thread
        else:
            assert s.parent is None


def test_library_spans_go_to_the_active_recorder():
    """Without a recorder span() and count() do nothing; inside recording()
    they reach it, and a nested recording() joins the same request."""
    with profiling.span("nowhere"):
        profiling.count("nowhere")
    assert profiling.active() is None
    with profiling.recording() as timer:
        with profiling.span("outer"):
            with profiling.recording() as inner:
                assert inner is timer
                with profiling.span("deep"):
                    profiling.count("hits")
    assert profiling.active() is None
    assert [s.name for s in timer.spans] == ["deep", "outer"]
    assert timer.spans[0].parent == timer.spans[1].id
    assert timer.counters == {"hits": 1}
    with profiling.recording() as fresh:
        assert fresh is not timer and fresh.request != timer.request


def test_spans_open_profiler_ranges_only_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer()
    with timer.stage("quiet"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("loud"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "stage/loud" in names and "stage/quiet" not in names


def junction_rows(yaml_path, cluster_ind, gene_dir, *_):
    """The junction rows ``compiler/state_space`` lays out for a family:
    V-D and D-J on igh, V-J alone on a light chain."""
    from linearham_tpu_torch.models.phylo_hmm import load_host_products

    space = load_host_products(yaml_path, cluster_ind, gene_dir)["space"]
    return space.vd_junction.n_rows + (
        space.dj_junction.n_rows if space.is_heavy else 0)


@pytest.fixture
def pipeline_args(tmp_path, monkeypatch):
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", str(tmp_path / "fc"))
    files = write_pipeline_inputs(str(tmp_path / "in"), n_seqs=4, n_trees=7)
    return files.yaml_path, 0, files.gene_dir, files.trees_path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_run_pipeline_timings_keep_the_old_keys(pipeline_args, tmp_path):
    """A cold call holds every old key and the new spans; a warm one reads
    the cache.  A parent's time covers its children's."""
    cold = run_pipeline(*pipeline_args, str(tmp_path / "a.tsv"), 4,
                        chunk_size=3, device="cpu")
    assert OLD_KEYS | NEW_KEYS <= set(cold.timings)
    assert all(v >= 0 for v in cold.timings.values())
    rows = junction_rows(*pipeline_args)
    # A cold build reads 8 gene files and 1 partis file.
    assert cold.counters == {"cache_misses": 1, "gene_map_parses": 1,
                             YAML_LOADS: 8 + 1, "chunks": 3,
                             "junction_rows": 3 * rows}
    build = sum(cold.timings[k] for k in ("family_key", "cache_read",
                                          "load_cluster", "load_gene_map",
                                          "compile", "cache_write", "place"))
    assert build <= cold.timings["build_hmm"]
    warm = run_pipeline(*pipeline_args, str(tmp_path / "b.tsv"), 4,
                        chunk_size=3, device="cpu")
    assert warm.counters == {"cache_hits": 1, "chunks": 3,
                             "junction_rows": 3 * rows}
    assert "load_gene_map" not in warm.timings
    assert (tmp_path / "a.tsv").read_text().count("\n") == 8


def test_trace_dir_holds_every_span_once(pipeline_args, tmp_path):
    """The export: the main thread's spans as the profiler recorded them
    (within 1 ms of the recorder's copy), the drain thread's appended under
    its own thread id, each span once."""
    trace_dir = tmp_path / "trace"
    with profiling.recording() as timer:
        run_pipeline(*pipeline_args, str(tmp_path / "o.tsv"), 4,
                     chunk_size=2, device="cpu", trace_dir=str(trace_dir))
    (path,) = trace_dir.glob("pipeline.*.trace.json")
    data = json.loads(path.read_text())
    base = int(data["baseTimeNanoseconds"])
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"
              and e.get("name", "").startswith("stage/")]
    counts = {}
    for s in timer.spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert {n: sum(e["name"] == f"stage/{n}" for e in events)
            for n in counts} == counts
    # The main thread's spans are the profiler's own ranges (no "span"
    # argument), each holding its span; most lie within 1 ms of theirs (a
    # thread switch inside a range may part them further).
    main = threading.get_native_id()
    ranged = [e for e in events if "span" not in e["args"]]
    assert ranged and all(e["tid"] == main for e in ranged)
    gaps = []
    for s in timer.spans:
        if s.thread != main:
            continue
        a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        (e,) = [e for e in ranged if e["name"] == f"stage/{s.name}"
                and e["ts"] - 100 <= a and b <= e["ts"] + e["dur"] + 100]
        gaps.append(max(abs(a - e["ts"]), abs(e["ts"] + e["dur"] - b)))
    assert len(gaps) == len(ranged)
    assert sorted(gaps)[len(gaps) // 2] < 1e3
    drained = [e for e in events if e["name"] in ("stage/decode",
                                                  "stage/device_step")]
    assert len(drained) == 2 * 4 and all(e["tid"] != main for e in drained)
    assert len({e["tid"] for e in drained}) == 1
    assert all(e["args"]["request"] == timer.request for e in drained)


def test_chunk_device_spans_on_the_card(pipeline_args, cuda_device,
                                        tmp_path):
    """On the card each chunk (each bucket of the repertoire) is one
    chunk_device span timed by CUDA events, no longer than the host's time
    from its first copy to its results' landing; each launch counts once;
    the export puts the device's spans on a thread of their own."""
    from linearham_tpu_torch.compiler.family_cache import cached_phylo_hmm
    from linearham_tpu_torch.io.trees_tsv import load_tree_samples
    from linearham_tpu_torch.parallel.repertoire import (FamilyTask,
                                                         run_repertoire)

    trace_dir = tmp_path / "trace"
    with profiling.recording() as timer:
        result = run_pipeline(*pipeline_args, str(tmp_path / "o.tsv"), 4,
                              chunk_size=2, device=cuda_device,
                              trace_dir=str(trace_dir))
    device_spans = [s for s in timer.spans if s.name == "chunk_device"]
    assert len(device_spans) == result.counters["chunks"] == 4
    assert result.counters["pruning_launches"] == 4
    assert all(s.thread.startswith("cuda") and s.end_ns > s.start_ns
               for s in device_spans)
    host = [s for s in timer.spans if s not in device_spans]
    wall = max(s.end_ns for s in host) - min(s.start_ns for s in host)
    assert 0 < result.timings["chunk_device"] * 1e9 <= wall
    (path,) = trace_dir.glob("pipeline.*.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    on_device = [e for e in events if e.get("name") == "stage/chunk_device"]
    assert len(on_device) == 4 and len({e["tid"] for e in on_device}) == 1
    assert any(e.get("cat") == "kernel" for e in events)

    reps = write_repertoire_inputs(
        str(tmp_path / "rep"), [("igh", 3, 4, 0.02), ("igh", 5, 3, 0.05)])
    tasks = [FamilyTask(hmm=cached_phylo_hmm(f.yaml_path, 0, f.gene_dir,
                                             device=cuda_device),
                        samples=load_tree_samples(f.trees_path))
             for f in reps["igh"].families]
    timings = {}
    with profiling.recording() as timer:
        run_repertoire(tasks, device=cuda_device, timings=timings)
    assert timer.counters["chunks"] == timer.counters["pruning_launches"]
    assert timings["chunk_device"] > 0


def _repertoire_profile(manifest, gene_dir, capsys):
    """An in-process ``cli repertoire --profile`` call on the CPU: (span
    names of its stage lines, its counters)."""
    from linearham_tpu_torch import cli

    assert cli.main(["repertoire", "--families", manifest, "--hmm-param-dir",
                     gene_dir, "--num-rates", "4", "--profile", "--device",
                     "cpu"]) == 0
    err = capsys.readouterr().err.splitlines()
    stages = {ln[4:].split(":")[0] for ln in err if ln.startswith("#   ")}
    (counters,) = [json.loads(ln[len("# counters: "):]) for ln in err
                   if ln.startswith("# counters: ")]
    return stages, counters


def test_cli_repertoire_profiles_the_light_chain(tmp_path, monkeypatch,
                                                 capsys):
    """An igk partition through ``cli repertoire --profile``: the layout's
    and the junction scan's spans print, every family counts as a light
    chain, and the junction rows are the V-J rows alone."""
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    igk = write_repertoire_inputs(
        str(tmp_path), [("igk", 3, 4, 0.02), ("igk", 5, 3, 0.04),
                        ("igk", 7, 2, 0.06)])["igk"]
    stages, counters = _repertoire_profile(igk.manifest, igk.gene_dir,
                                           capsys)
    assert {"compile", "state_space", "junction_scan"} <= stages
    assert counters["light_chain_families"] == 3
    assert counters["junction_rows"] == sum(
        junction_rows(f.yaml_path, 0, f.gene_dir) for f in igk.families)


@pytest.mark.parametrize("locus", ["igh", "igk"])
def test_junction_rows_sum_the_laid_out_rows(tmp_path, monkeypatch, capsys,
                                             locus):
    """``junction_rows`` is, over a call's chunks, the sum of the junction
    rows ``compiler/state_space`` lays out for each family: one bucket a
    partition in ``cli repertoire``, ``chunks`` chunks in ``run_pipeline``.
    No heavy family counts as a light chain."""
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    rep = write_repertoire_inputs(
        str(tmp_path), [(locus, 3, 4, 0.02), (locus, 6, 5, 0.05)])[locus]
    rows = [junction_rows(f.yaml_path, 0, f.gene_dir) for f in rep.families]
    _, counters = _repertoire_profile(rep.manifest, rep.gene_dir, capsys)
    assert counters["chunks"] == 1
    assert counters["junction_rows"] == sum(rows)
    assert counters.get("light_chain_families", 0) == (
        0 if locus == "igh" else 2)
    f = rep.families[1]
    result = run_pipeline(f.yaml_path, 0, f.gene_dir, f.trees_path,
                          str(tmp_path / "o.tsv"), 4, chunk_size=2,
                          device="cpu")
    assert result.counters["chunks"] == 3
    assert result.counters["junction_rows"] == 3 * rows[1]


def test_junction_scan_opens_once_a_chunk_not_once_a_row(tmp_path,
                                                         monkeypatch):
    """Per chunk, the forward opens one ``junction_scan`` span and the
    sampler one, each inside the chunk's ``dispatch``: the count follows
    the chunks, not the rows (igh scans more rows than igk)."""
    monkeypatch.setenv("LINEARHAM_FAMILY_CACHE", "off")
    reps = write_repertoire_inputs(
        str(tmp_path), [("igh", 4, 5, 0.03), ("igk", 4, 5, 0.03)])
    rows = {}
    for locus, rep in reps.items():
        (f,) = rep.families
        rows[locus] = junction_rows(f.yaml_path, 0, f.gene_dir)
        for chunk_size in (1, 2, 5):
            with profiling.recording() as timer:
                result = run_pipeline(f.yaml_path, 0, f.gene_dir,
                                      f.trees_path, str(tmp_path / "o.tsv"),
                                      4, chunk_size=chunk_size, device="cpu")
            chunks = result.counters["chunks"]
            assert chunks == -(-5 // chunk_size)
            scans = [s for s in timer.spans if s.name == "junction_scan"]
            assert len(scans) == 2 * chunks
            by_id = {s.id: s for s in timer.spans}
            assert {by_id[s.parent].name for s in scans} == {"dispatch"}
            assert result.timings["junction_scan"] > 0
    assert rows["igh"] > rows["igk"] > 1
