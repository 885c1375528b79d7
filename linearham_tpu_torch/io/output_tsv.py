"""The reference-format pipeline TSV (reference src/PhyloHMM.cpp:244-327).

The one home of the writers that ``pipeline/run`` (a chunk at a time, on
its drain thread) and ``parallel/repertoire`` (a family at a time) share.
A block of rows is formatted by one call into the C++ host library
(``io/native.format_output_rows``): the numeric columns in Python's
``repr(float)`` layout, the Newick stripped of its ``[...]`` comments.  The
call releases the GIL, so the main thread runs while a drain thread
writes.  Only the annotation columns are joined here, a row at a time,
from the decoder's strings.  Where the library is not available the rows
are formatted in Python, with the same bytes.
"""

from __future__ import annotations

import re
from typing import TextIO

import numpy as np

from linearham_tpu_torch.io.native import format_output_rows
from linearham_tpu_torch.io.trees_tsv import TreeSamples
from linearham_tpu_torch.utils import profiling

_COMMENT_RE = re.compile(r"\[[^\]]*\]")


def write_tsv_header(num_rates: int, heavy: bool, outfile: TextIO) -> None:
    """Write the reference-format pipeline TSV header row."""
    cols = (
        ["Iteration", "RBLogLikelihood", "Prior", "alpha"]
        + [f"er[{i}]" for i in range(1, 7)]
        + [f"pi[{i}]" for i in range(1, 5)]
        + ["tree"]
        + [f"sr[{i}]" for i in range(1, num_rates + 1)]
        + ["LHLogLikelihood", "LogWeight", "NaiveSequence",
           "VGene", "V5pDel", "V3pDel", "VFwkInsertion"]
    )
    if heavy:
        cols += ["VDInsertion", "DGene", "D5pDel", "D3pDel", "DJInsertion"]
    else:
        cols += ["VJInsertion"]
    cols += ["JGene", "J5pDel", "J3pDel", "JFwkInsertion"]
    outfile.write("\t".join(cols) + "\n")


def _annotation_columns(ann, heavy: bool) -> str:
    """A row's columns from NaiveSequence on, tab-joined."""
    cols = [ann.naive_seq, ann.vgerm_state, ann.v_5p_del, ann.v_3p_del,
            ann.v_fwk_insertion]
    if heavy:
        cols += [ann.vd_insertion, ann.dgerm_state, ann.d_5p_del,
                 ann.d_3p_del, ann.dj_insertion]
    else:
        cols += [ann.vd_insertion]
    cols += [ann.jgerm_state, ann.j_5p_del, ann.j_3p_del, ann.j_fwk_insertion]
    return "\t".join(map(str, cols))


def _python_rows(samples: TreeSamples, rates, lh_loglik, logweight,
                 annots, start: int, n: int) -> str:
    s = samples
    lines = []
    for i in range(n):
        t = start + i
        row = ([s.iteration[t], s.rb_loglik[t], s.prior[t], s.alpha[t]]
               + list(s.er[t]) + list(s.pi[t])
               + [_COMMENT_RE.sub("", s.newicks[t])]
               + list(rates[t]) + [lh_loglik[i], logweight[i], annots[i]])
        lines.append("\t".join(map(str, row)) + "\n")
    return "".join(lines)


def write_tsv_rows(samples: TreeSamples, rates, lh_loglik, logweight,
                   annotations, start: int, n: int, heavy: bool,
                   outfile: TextIO) -> None:
    """Write rows [start, start+n) of the pipeline TSV.

    ``samples`` and ``rates`` cover the whole ensemble; ``lh_loglik``,
    ``logweight`` and ``annotations`` are the block's own (index 0 is row
    ``start``).  The columns are written as int64 (Iteration) and float64
    (the rest), as the trees-TSV reader and the pipeline give them.

    Counter (``utils.profiling``): ``tsv_native_rows``, or
    ``tsv_python_rows`` where the host library is not available, the rows
    written.
    """
    if len(annotations) != n:
        raise ValueError(f"chunk arrays must have length {n}, "
                         f"got {len(annotations)}")
    s, rows = samples, slice(start, start + n)
    annots = [_annotation_columns(a, heavy) for a in annotations]
    text = format_output_rows(
        s.iteration[rows],
        np.column_stack([s.rb_loglik[rows], s.prior[rows], s.alpha[rows],
                         s.er[rows], s.pi[rows]]),
        s.newicks[rows],
        np.column_stack([rates[rows], lh_loglik, logweight]),
        annots)
    if text is None:
        text = _python_rows(s, rates, lh_loglik, logweight, annots, start, n)
        profiling.count("tsv_python_rows", n)
    else:
        profiling.count("tsv_native_rows", n)
    outfile.write(text)


def write_output_tsv(result, heavy: bool, outfile: TextIO) -> None:
    """Write the reference-format pipeline TSV (header + all rows) of a
    ``pipeline.run.PipelineResult``."""
    write_tsv_header(result.rates.shape[1], heavy, outfile)
    write_tsv_rows(result.samples, result.rates, result.lh_loglik,
                   result.logweight, result.annotations, 0,
                   result.samples.n_samples, heavy, outfile)
