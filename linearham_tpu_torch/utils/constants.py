"""Shared constants.

The reference (linearham) uses EPS=1e-6 both as a probability-sum tolerance
and as the default branch length for missing Newick branch lengths
(src/utils.hpp:20, src/PhyloHMM.cpp:355,422).  The reference's
SCALE_FACTOR=2^256 block-scaling machinery (src/utils.hpp:22-24) is not
reproduced here: the TPU engine carries explicit log-scale accumulators
instead, which is both simpler and accelerator-friendly.
"""

EPS = 1e-6

# Integer code appended after the nucleotide alphabet for the ambiguous base.
# With alphabet "ACGT", the full symbol set is "ACGTN" and N has code 4
# (reference: src/HMM.cpp:50).
AMBIGUOUS = "N"
