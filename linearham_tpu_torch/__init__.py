"""linearham_tpu_torch: the PyTorch / CUDA port of linearham_tpu.

The same phylo-HMM engine as the JAX package beside it, written against
PyTorch with a hand-written CUDA kernel for Felsenstein pruning on NVIDIA
Hopper.  It imports torch, never jax, and nothing of the JAX package: the
host modules it needs (io, compiler, utils, postprocess and the C++ host
library) are its own copies, at the JAX package's relative paths, so it
runs with linearham_tpu/ absent.

Layers (each mirrors the JAX package's module of the same path):
  io/          partis YAML, germline genes, Newick, trees TSV, slot-reuse
               schedules; ctypes bindings of the C++ host library
  ops/         torch device code: forward, FFBS, Viterbi, GTR, ASR, pruning
               (slot-reuse kernel + plain walk; one-slot-per-node TreeBatch)
  csrc/        the CUDA kernel (nvcc) and the C++ host library (g++),
               both built at first use into build/
  compiler/    state space, transitions, xMSA, emissions; the family cache
  models/      PhyloHMM and SimpleHMM (nn.Modules) and the host decoder
  parallel/    repertoire buckets, the (fam, trees) mesh, multihost
  pipeline/    the batched posterior-ensemble pipeline + TSV output
  postprocess/ bootstrap + ESS + ancestral sequence reconstruction, and the
               workflow's host tables
  tools/       kernel measurement on the card
  utils/       device/dtype policy, builds, synthetic inputs, host helpers
"""

__version__ = "0.1.0"
