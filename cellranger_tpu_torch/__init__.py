"""cellranger_tpu_torch: the PyTorch/CUDA port of cellranger_tpu.

A second package beside the JAX one, which stays the reference.  This
slice runs `count` on a single-library, single-end 3' gene-expression run
with no BAM: the host stages reuse the JAX package's jax-free modules, the
device step is plain torch, and the banded Smith-Waterman rescue is a CUDA
kernel written for sm_90a (csrc/sw.cu).  Nothing here imports jax.
"""

__version__ = "0.1.0"
