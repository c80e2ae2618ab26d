"""cellranger_tpu_torch: the PyTorch/CUDA port of cellranger_tpu.

A second package beside the JAX one, which stays the reference.  It runs
`count` and `multi` on one device for every chemistry and library type
short of V(D)J: single-end and paired-end gene expression with or without
a possorted BAM, Feature Barcode libraries beside it, RTL probe runs with
probe-barcode multiplexing; and above them sample demultiplexing,
multi-GEM-well runs and `aggr`.  The host stages
are verbatim copies of the JAX package's jax-free modules, the device
work is plain torch, and the banded Smith-Waterman rescue is a CUDA kernel
written for sm_90a (csrc/sw.cu).  Nothing here imports jax or the JAX
package.
"""

__version__ = "0.1.0"
