"""cellranger_tpu_torch: the PyTorch/CUDA port of cellranger_tpu.

A second package beside the JAX one, which stays the reference.  It runs
everything the JAX package runs, on one device, on a mesh of devices
(parallel/mesh.py) and across hosts (parallel/distributed.py): `count`
and `multi` for
every chemistry and library type (single-end and paired-end gene
expression with or without a possorted BAM, Feature Barcode libraries
beside it, RTL probe runs with probe-barcode multiplexing, V(D)J
libraries), sample demultiplexing, multi-GEM-well runs, `aggr`, `vdj`
with `mkvdjref`, and `mkfastq`.  The host stages
are verbatim copies of the JAX package's jax-free modules, the device
work is plain torch, and the banded Smith-Waterman rescue is a CUDA kernel
written for sm_90a (csrc/sw.cu).  Nothing here imports jax or the JAX
package.
"""

__version__ = "0.1.0"
