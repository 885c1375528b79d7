"""The output-TSV writer (``io/output_tsv``) on the CPU: rows formatted by
the C++ host library against the same rows formatted in Python.

* Blocks of heavy- and light-chain rows, whole and as a chunk (``start``
  > 0, ``n`` < T), give the same bytes either way, and count their rows
  under each path's counter.
* Every float is laid out as ``repr(float)``: edge values, 100,000 seeded
  random floats across decimal exponents -8 to 20, and random bit patterns.
* The Newick loses its bracketed comments as ``_COMMENT_RE`` takes them:
  each ``[`` through the first ``]`` after it; an unclosed ``[`` stays.
"""

import io

import numpy as np
import pytest

from linearham_tpu_torch.io import native, output_tsv
from linearham_tpu_torch.io.trees_tsv import TreeSamples
from linearham_tpu_torch.models.decode import Annotation
from linearham_tpu_torch.utils import profiling

T = 11


def _samples(rng, n: int) -> TreeSamples:
    newicks = [f"((a[&index=1]:{rng.uniform():.5f},b[&index=2]:0.2)"
               f"[&index=4]:{rng.uniform()!r},naive[&index=3]:1e-05);"
               for _ in range(n)]
    return TreeSamples(
        iteration=np.arange(n) * 10,
        rb_loglik=-rng.uniform(900, 1100, n),
        prior=-rng.uniform(10, 20, n),
        alpha=rng.uniform(0.4, 3.0, n),
        er=rng.uniform(0.5, 2.0, (n, 6)),
        pi=rng.dirichlet([8.0] * 4, n),
        newicks=newicks,
    )


def _annotation(rng, heavy: bool) -> Annotation:
    ints = [int(x) for x in rng.integers(0, 9, 6)]
    return Annotation(
        naive_seq="".join(rng.choice(list("ACGT"), 30)),
        vgerm_state="IGHV3-23*01" if heavy else "IGKV1-39*01", vgerm_idx=0,
        v_5p_del=ints[0], v_3p_del=ints[1], v_fwk_insertion="",
        vd_states=[], vd_idx=[], vd_insertion="AC",
        dgerm_state="IGHD3-22*01" if heavy else None,
        dgerm_idx=1 if heavy else None,
        d_5p_del=ints[2] if heavy else None,
        d_3p_del=ints[3] if heavy else None,
        dj_states=[] if heavy else None, dj_idx=[] if heavy else None,
        dj_insertion="G" if heavy else None,
        jgerm_state="IGHJ4*02" if heavy else "IGKJ1*01", jgerm_idx=0,
        j_5p_del=ints[4], j_3p_del=ints[5], j_fwk_insertion="TT")


def _write_block(monkeypatch, in_python: bool, heavy: bool, start: int,
                 n: int):
    """The header and rows [start, start+n) of a seeded block, and the
    counters of the write."""
    rng = np.random.default_rng(17)
    samples = _samples(rng, T)
    rates = rng.gamma(2.0, 0.5, (T, 4 if heavy else 2))
    loglik = -rng.uniform(900, 1100, n)
    anns = [_annotation(rng, heavy) for _ in range(n)]
    buf = io.StringIO()
    with monkeypatch.context() as m, profiling.recording() as timer:
        if in_python:
            m.setattr(output_tsv, "format_output_rows", lambda *args: None)
        output_tsv.write_tsv_header(rates.shape[1], heavy, buf)
        output_tsv.write_tsv_rows(samples, rates, loglik,
                                  loglik - samples.rb_loglik[start:start + n],
                                  anns, start, n, heavy, buf)
    return buf.getvalue(), timer.counters


@pytest.mark.parametrize("heavy", [True, False], ids=["heavy", "light"])
@pytest.mark.parametrize("start,n", [(0, T), (3, 5)],
                         ids=["whole", "chunk"])
def test_native_rows_equal_the_python_rows(monkeypatch, heavy, start, n):
    assert native.native_available()
    got, native_counts = _write_block(monkeypatch, False, heavy, start, n)
    want, python_counts = _write_block(monkeypatch, True, heavy, start, n)
    assert got == want
    assert native_counts == {"tsv_native_rows": n}
    assert python_counts == {"tsv_python_rows": n}
    header, *rows = got.splitlines()
    assert len(rows) == n
    width = len(header.split("\t"))
    assert all(len(r.split("\t")) == width for r in rows)
    assert "[" not in "".join(rows)
    assert rows[0].startswith(f"{start * 10}\t")


def _formatted(values) -> list:
    """Each of ``values`` as the native writer lays out a float column."""
    values = np.asarray(values, np.float64)
    rows = -(-values.size // 13)
    head = np.resize(values, (rows, 13))
    text = native.format_output_rows(np.zeros(rows, np.int64), head,
                                     [""] * rows, np.zeros((rows, 0)),
                                     [""] * rows)
    assert text is not None
    fields = [ln.split("\t")[1:14] for ln in text.splitlines()]
    return [f for row in fields for f in row][:values.size]


@pytest.mark.parametrize("x", [
    1e16, 9999999999999998.0, 1e-5, 1e-4, 0.0, -0.0, 123.0, 5e-324,
    1.7976931348623157e308, float("inf"), float("-inf"), float("nan"),
    1e15, 0.1, -2.5e-7, 1e22, 123456789012345678.0,
])
def test_float_layout_of_edge_values(x):
    assert _formatted([x, -x]) == [repr(float(x)), repr(float(-x))]


@pytest.mark.parametrize("draw", ["exponents", "bit_patterns"])
def test_float_layout_of_random_values(draw):
    rng = np.random.default_rng(20250417)
    n = 100_000
    if draw == "exponents":
        values = (rng.uniform(1.0, 10.0, n)
                  * 10.0 ** rng.integers(-8, 21, n) * rng.choice([-1, 1], n))
    else:
        values = rng.integers(0, 2 ** 64, n, dtype=np.uint64).view(np.float64)
    assert _formatted(values) == [repr(float(v)) for v in values]


@pytest.mark.parametrize("newick", [
    "((a[&index=1]:0.1,b[&index=2]:0.2)[&index=3]:0.3,naive[&index=4]:0.4);",
    "((a:0.1,b:0.2)[&R][a comment, with (punctuation): 1]:0.3,c);",
    "(a:0.1,b[never closed:0.2,c);",
    "(a[x]:0.1,b[never closed:0.2);",
    "(a[x[y]z]:0.1,b[]:0.2);",
    "]a[b]c[",
    "(a:0.1,b:0.2);",
    "[&index=1]",
    "",
])
def test_newick_comments_go_as_the_regex_takes_them(newick):
    text = native.format_output_rows(np.zeros(1, np.int64),
                                     np.zeros((1, 13)), [newick],
                                     np.zeros((1, 0)), ["tail"])
    assert text.split("\t")[14] == output_tsv._COMMENT_RE.sub("", newick)
    assert text.endswith("\ttail\n")
