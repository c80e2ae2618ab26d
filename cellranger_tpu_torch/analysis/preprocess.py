"""Matrix preprocessing for secondary analysis (PREPROCESS_MATRIX analog).

Semantics per lib/python/cellranger/analysis/pca.py:110-125 and
analysis/stats.py:21-30: scale each cell to the median total UMI count,
log2(1+x) transform, optional selection of high-dispersion features.

Verbatim copy of cellranger_tpu/analysis/preprocess.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def normalize_by_umi(m: sp.spmatrix) -> sp.csc_matrix:
    """Scale each cell (column) so totals equal the median total."""
    counts = np.asarray(m.sum(axis=0)).ravel()
    median = max(1.0, float(np.median(counts[counts > 0]))) if counts.size else 1.0
    scale = np.divide(median, counts, out=np.ones_like(counts, float),
                      where=counts > 0)
    out = m.tocsc().astype(np.float64)
    out = out @ sp.diags(scale)
    return out.tocsc()


def normalized_dispersion(m_norm: sp.csc_matrix, bins: int = 20):
    """Dispersion (var/mean) z-scored within mean-quantile bins
    (pca.py get_normalized_dispersion semantics)."""
    mean = np.asarray(m_norm.mean(axis=1)).ravel()
    sq = m_norm.copy()
    sq.data **= 2
    var = np.asarray(sq.mean(axis=1)).ravel() - mean ** 2
    dispersion = np.divide(var, mean, out=np.zeros_like(var), where=mean > 0)
    df = np.zeros_like(dispersion)
    ok = mean > 0
    if ok.sum() == 0:
        return df
    quantiles = np.percentile(mean[ok], np.arange(0, 100, 100 / bins))
    bin_idx = np.digitize(mean, quantiles)
    for b in np.unique(bin_idx):
        sel = bin_idx == b
        d = dispersion[sel]
        med = np.median(d)
        mad = np.median(np.abs(d - med)) + 1e-12
        df[sel] = (d - med) / mad
    return df


def select_features(m: sp.spmatrix, num_features: int | None = None) -> np.ndarray:
    """Indices of features to use: nonzero everywhere-expressed features,
    optionally top-N by normalized dispersion."""
    totals = np.asarray(m.sum(axis=1)).ravel()
    nonzero = np.flatnonzero(totals)
    if num_features is None or len(nonzero) <= num_features:
        return nonzero
    disp = normalized_dispersion(normalize_by_umi(m)[nonzero])
    top = np.argsort(disp)[::-1][:num_features]
    return np.sort(nonzero[top])


def log_normalize_dense(m: sp.spmatrix, features: np.ndarray) -> np.ndarray:
    """-> dense float32 [cells, features_sel]: median-normalized, log2(1+x),
    feature-standardized (centered/scaled), ready for PCA on device."""
    mn = normalize_by_umi(m)[features]
    mn.data = np.log2(1 + mn.data)
    x = np.asarray(mn.todense(), np.float32).T  # cells x features
    c = x.mean(axis=0)
    v = x.var(axis=0)
    v[v == 0] = 1.0
    return (x - c) / np.sqrt(v)
