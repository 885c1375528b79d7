"""linearham_tpu_torch: the PyTorch / CUDA port of linearham_tpu.

The same phylo-HMM engine as the JAX package beside it, written against
PyTorch with a hand-written CUDA kernel for Felsenstein pruning on NVIDIA
Hopper.  It imports torch and never jax; the jax-free host modules of
linearham_tpu (io, compiler, utils) are reused as they are.

Layers (each mirrors the JAX package's module of the same path):
  ops/         torch device code: forward, FFBS, GTR, pruning (kernel + plain)
  csrc/        CUDA C++ sources of the kernels, built at first use
  compiler/    jax-free twin of compiler/compiled.py
  models/      PhyloHMM (nn.Module) and the host decoder
  pipeline/    the batched posterior-ensemble pipeline + TSV output
  utils/       device/dtype policy and the kernel build
"""

__version__ = "0.1.0"
