"""linearham_tpu_torch: the PyTorch / CUDA port of linearham_tpu.

The same phylo-HMM engine as the JAX package beside it, written against
PyTorch with a hand-written CUDA kernel for Felsenstein pruning on NVIDIA
Hopper.  It imports torch and never jax; the jax-free host modules of
linearham_tpu (io, compiler, utils) are reused as they are.

Layers (each mirrors the JAX package's module of the same path):
  ops/         torch device code: forward, FFBS, Viterbi, GTR, ASR, pruning
               (slot-reuse kernel + plain walk; one-slot-per-node TreeBatch)
  csrc/        CUDA C++ sources of the kernels, built at first use
  compiler/    jax-free twin of compiler/compiled.py; the family disk cache
  models/      PhyloHMM and SimpleHMM (nn.Modules) and the host decoder
  pipeline/    the batched posterior-ensemble pipeline + TSV output
  postprocess/ bootstrap + ESS + ancestral sequence reconstruction
  utils/       device/dtype policy, the kernel build, synthetic inputs
"""

__version__ = "0.1.0"
