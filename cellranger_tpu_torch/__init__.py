"""cellranger_tpu_torch: the PyTorch/CUDA port of cellranger_tpu.

A second package beside the JAX one, which stays the reference.  It runs
`count` on single-end runs on one device: gene expression with or without
a possorted BAM, and Feature Barcode libraries beside it.  The host stages
are verbatim copies of the JAX package's jax-free modules, the device
work is plain torch, and the banded Smith-Waterman rescue is a CUDA kernel
written for sm_90a (csrc/sw.cu).  Nothing here imports jax or the JAX
package.
"""

__version__ = "0.1.0"
