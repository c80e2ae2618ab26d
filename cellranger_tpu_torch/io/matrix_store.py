"""Reading a count run's matrices where h5py may be missing.

The JAX package's downstream stages (sample demux) read the count run's
`*_feature_bc_matrix.h5`.  The port writes the h5 outputs only where h5py
is installed (a machine with the GPU may not have it) and always writes
MEX, so its downstream stages read through `load_count_matrix`: the h5
where the run wrote one, else the MEX directory of the same name.  The
two readers stay side by side because MEX carries feature id, name and
type but no genome column: read from MEX, a per-sample h5 would lose the
genome of every feature, so the h5 is read wherever it can be.  Barcodes,
features and counts are the same from both (tests/test_torch_multi.py
holds each reader's demux against the JAX package's).
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import scipy.sparse as sp

from .matrix_io import CountMatrix, FeatureDef, FeatureReference


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def load_mex(directory: str) -> CountMatrix:
    """Read the three files `CountMatrix.save_mex` writes."""
    with gzip.open(os.path.join(directory, "features.tsv.gz"), "rt") as f:
        feats = [FeatureDef(*line.rstrip("\n").split("\t")[:3])
                 for line in f if line.strip()]
    with gzip.open(os.path.join(directory, "barcodes.tsv.gz"), "rb") as f:
        barcodes = [b for b in f.read().split(b"\n") if b]
    with gzip.open(os.path.join(directory, "matrix.mtx.gz"), "rt") as f:
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(x) for x in line.split())
        body = np.loadtxt(f, dtype=np.int64, ndmin=2) if nnz else \
            np.zeros((0, 3), np.int64)
    m = sp.csc_matrix((body[:, 2], (body[:, 0] - 1, body[:, 1] - 1)),
                      shape=(n_rows, n_cols), dtype=np.int32)
    return CountMatrix(m, barcodes, FeatureReference(feats))


def load_count_matrix(out_dir: str, name: str) -> CountMatrix:
    """`<out_dir>/<name>.h5` where it exists and h5py imports, else the
    MEX directory `<out_dir>/<name>`."""
    h5 = os.path.join(out_dir, name + ".h5")
    if os.path.exists(h5) and h5py_available():
        return CountMatrix.load_h5(h5)
    return load_mex(os.path.join(out_dir, name))
