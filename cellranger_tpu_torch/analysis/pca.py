"""PCA by randomized subspace iteration (port of cellranger_tpu/analysis/
pca.py, the RUN_PCA_NG analog).

The start basis is `jax.random.normal(PRNGKey(seed), (f, k))` drawn by
`prng.normal` on the host and uploaded; the power iterations, QR and the
small SVD run on the matrix's device in float32 (cuBLAS/cuSOLVER on the
card, with TF32 off).  A singular vector's sign is the solver's choice and
may differ from the JAX package's; nothing downstream reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng

N_COMPONENTS_DEFAULT = 10  # analysis/constants.py:53


def randomized_svd(x: torch.Tensor, n_components: int = N_COMPONENTS_DEFAULT,
                   n_iter: int = 7, seed: int = 0):
    """x [n, f] float32 -> (u [n, k], s [k], vt [k, f]) on x's device."""
    n, f = x.shape
    k = min(n_components + 10, min(n, f))  # oversampling
    q = torch.from_numpy(prng.normal(prng.PRNGKey(seed), (f, k))) \
        .to(x.device)
    y = x @ q
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(y)
        y = x @ (x.T @ q)
    q, _ = torch.linalg.qr(y)
    b = q.T @ x                       # [k, f]
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :n_components], s[:n_components], vt[:n_components]


def run_pca(x: torch.Tensor, n_components: int = N_COMPONENTS_DEFAULT):
    """x [cells, features] float32, standardized, on the device -> the
    JAX package's PCA dict (numpy float64), plus `proj_dev`: the float32
    projection left on the device for the stages after PCA."""
    n, f = x.shape
    k = min(n_components, max(1, min(n, f) - 1))
    u, s, vt = randomized_svd(x, k)
    proj_dev = u * s[None, :]
    total_var = float(torch.sum(x.double() ** 2)) / max(n - 1, 1)
    var_explained = s.cpu().numpy().astype(np.float64) ** 2 / max(n - 1, 1)
    return dict(
        transformed_pca_matrix=proj_dev.cpu().numpy().astype(np.float64),
        components=vt.cpu().numpy().astype(np.float64),
        variance_explained=var_explained,
        variance_explained_ratio=var_explained / max(total_var, 1e-12),
        proj_dev=proj_dev,
    )
