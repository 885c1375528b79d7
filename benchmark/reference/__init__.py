"""The plain reference that decides whether a run's output is correct.

It imports nothing of the port or of the JAX package.  Of the port's host
logic it keeps only copies of the file loaders (``frozen/``).  The model
(the states of each site and their steps, written out from the partis
HMM files; Newick parsing; the GTR model and its gamma rates;
Felsenstein pruning; the naive-base correction; the forward algorithm;
the probability of one path; drawing paths) and the reading of the
annotation columns are written here in plain torch and numpy, in a dtype
the caller names, so that one code serves as the reference (float64) and
as its control (float32 with TF32 matmuls).
"""
