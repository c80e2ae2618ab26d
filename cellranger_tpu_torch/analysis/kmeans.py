"""K-means (port of cellranger_tpu/analysis/kmeans.py, the RUN_KMEANS
analog): k-means++ seeding from `jax.random`'s stream (`prng`), then
Lloyd iterations on the projection's device.

Each seeding step brings the `[n]` seeding weights to the host, where
`prng.choice` draws the next center exactly as `jax.random.choice` does.
Distances are `graphclust.sq_dists`, the JAX package's formula: the
tiny fixture's identical cells tie exactly and fall the same way.
Centroid sums are `one_hot(labels).T @ x`: deterministic on CUDA, where a
scatter-add would sum in a different order on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .graphclust import sq_dists


def kmeans_fit(x: torch.Tensor, k: int, n_iter: int = 100, seed: int = 0):
    """x [n, d] float32 -> (labels int64 [n], centers [k, d], inertia), all
    on x's device."""
    n, d = x.shape
    key = prng.PRNGKey(seed)

    # k-means++ seeding: the key sequence split -> choice of kmeans.py:22-41
    key, sub = prng.split(key)
    centers = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    centers[0] = x[int(prng.choice(sub, n))]
    for n_chosen in range(1, k):
        d2 = ((x[:, None, :] - centers[None, :n_chosen, :]) ** 2) \
            .sum(-1).min(1).values
        key, sub = prng.split(key)
        p = d2 / torch.clamp(d2.sum(), min=1e-12)
        idx = int(prng.choice(sub, n, p=p.cpu().numpy()))
        centers[n_chosen] = x[idx]

    eye = torch.eye(k, dtype=x.dtype, device=x.device)
    labels = torch.zeros(n, dtype=torch.int64, device=x.device)
    for _ in range(n_iter):
        labels = torch.argmin(sq_dists(x, centers), dim=1)  # first hit
        onehot = eye[labels]                                  # [n, k]
        sums = onehot.T @ x
        counts = onehot.sum(0)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1),
                              centers)
    inertia = sq_dists(x, centers).min(1).values.sum()
    return labels, centers, inertia


def run_kmeans(proj: torch.Tensor, k: int, seed: int = 0):
    """-> (1-based labels, centers, inertia) as numpy, like the JAX
    package's run_kmeans."""
    labels, centers, inertia = kmeans_fit(proj.to(torch.float32), k,
                                          seed=seed)
    return (labels.cpu().numpy().astype(np.int32) + 1,
            centers.cpu().numpy(), float(inertia))
