"""The pruning roofline's count of work, from tree shapes alone."""

import numpy as np
import pytest

from benchmark import gen, harness
from benchmark.reference import newick


def _roofline():
    return harness.metric_module("pruning_roofline_pct")


def test_tree_work_by_hand():
    m = _roofline()
    # 3 tips: 4 edges, 2 internal nodes, 1 of them a child of the other.
    flops, nbytes = m.tree_work(tips=3, cols=10, rates=4)
    assert flops == 4 * 4 * 136 + 4 * 10 * (28 * 1 + 4 * 2 + 8)
    assert nbytes == 4 * 12 + (10 + 4) * 4 + 10 * 4


def test_generated_trees_have_the_counted_shape():
    """The count assumes rooted binary trees: check the generator's."""
    rng = np.random.default_rng(7)
    labels = ["naive"] + [f"seq{i}" for i in range(20)]
    for text in gen.random_newicks(rng, labels, 25):
        root = newick.parse(text)
        internal = newick.postorder(root)
        assert len(internal) == len(labels) - 1
        assert all(len(n.children) == 2 for n in internal)
        internal_children = sum(1 for n in internal for c in n.children
                                if c.children)
        assert internal_children == len(labels) - 2


def test_work_sums_ensembles_and_bound_picks_the_binding_side():
    m = _roofline()
    e = {"trees": 10, "tips": 313, "cols": 1009, "rates": 4}
    flops, nbytes = m.work([e, e])
    f1, b1 = m.tree_work(313, 1009, 4)
    assert flops == 20 * f1
    assert nbytes == 20 * b1 + 2 * 313 * 1009
    least, binds = m.bound_s(flops, nbytes)
    assert binds == "operations" and least == pytest.approx(flops / 67e12)
    assert m.bound_s(1.0, 1e12)[1] == "bytes"


def test_share_reads_kernel_time_by_name():
    from benchmark.trace import TraceSummary

    m = _roofline()
    e = {"trees": 1000, "tips": 101, "cols": 863, "rates": 4}
    least = m.bound_s(*m.work([e]))[0]
    summary = TraceSummary((0.0, 1.0), [
        ("kernel", "void (anonymous namespace)::pruning_kernel<float>(int)",
         0.1, 0.1 + 4 * least),
        ("kernel", "at::native::add_kernel", 0.5, 0.6)], [])
    run = harness.RunRecord("c", [], 1000, 1.0, 0.0, summary, [e])
    assert m.read(run) == pytest.approx(25.0)
    run.trace = TraceSummary((0.0, 1.0), [], [])
    assert m.read(run) is None


def test_an_f64_run_counts_8_byte_floats_against_the_f64_peak():
    """A configuration at ``"precision": "f64"`` runs the kernel's double
    instantiation: its floats are 8 bytes and its bound the f64 peak."""
    from benchmark.trace import TraceSummary

    m = _roofline()
    flops, nbytes = m.tree_work(tips=3, cols=10, rates=4, precision="f64")
    assert flops == m.tree_work(3, 10, 4)[0]
    assert nbytes == 4 * (8 + 8) + (10 + 4) * 8 + 10 * 8
    e = {"trees": 1000, "tips": 101, "cols": 863, "rates": 4}
    least, binds = m.bound_s(*m.work([e], "f64"), "f64")
    assert binds == "operations"
    assert least == pytest.approx(m.work([e])[0] / 34e12)
    summary = TraceSummary((0.0, 1.0), [
            ("kernel", "void (anonymous namespace)::pruning_kernel<double, "
             "4, 32>(int)", 0.1, 0.1 + 2 * least)], [])
    run = harness.RunRecord("c", [], 1000, 1.0, 0.0, summary, [e],
                            precision="f64")
    assert m.read(run) == pytest.approx(50.0)
