"""UMAP on the device (port of cellranger_tpu/analysis/umap_tpu.py, the
RUN_UMAP analog; the module name is kept so each counterpart is easy to
find).

The fuzzy simplicial set comes from the exact kNN graph; its per-cell
bandwidths are found on the host (`[n, k]` work, the JAX package's code)
and the dense membership matrix is assembled on the device.  The layout
is 500 epochs of dense attraction/repulsion over `[N, N]` planes.  The
gradient keeps the JAX package's `sum_j coef_ij (y_j - y_i)` form, one
plane per component: the repulsion coefficients reach 1e10 where two
points nearly coincide, and the matmul form `rowsum * y - coef @ y` would
cancel catastrophically there.  Like t-SNE the layout is chaotic at float
level (see tsne.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .graphclust import knn_graph

UMAP_N_NEIGHBORS = 30
UMAP_MIN_DIST = 0.3
UMAP_COMPONENTS = 2
UMAP_EPOCHS = 500


def _fit_ab(min_dist: float, spread: float = 1.0):
    """Least-squares fit of the UMAP low-dim curve 1/(1+a d^(2b))."""
    from scipy.optimize import curve_fit

    xs = np.linspace(0, spread * 3, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xs, ys, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _memberships(dists: np.ndarray) -> np.ndarray:
    """kNN distances [n, k] -> fuzzy memberships exp(-(d - rho) / sigma),
    sigma bisected so each row sums to log2(k) (host, float64)."""
    n, k = dists.shape
    rho = dists[:, 0]
    target = np.log2(k)
    lo = np.full(n, 1e-6)
    hi = np.full(n, 1e3)
    for _ in range(40):
        mid = (lo + hi) / 2
        val = np.exp(-(np.maximum(dists - rho[:, None], 0)) / mid[:, None]).sum(1)
        hi = np.where(val > target, mid, hi)
        lo = np.where(val > target, lo, mid)
    sigma = (lo + hi) / 2
    return np.exp(-np.maximum(dists - rho[:, None], 0) / sigma[:, None])


def _fuzzy_graph(idx: torch.Tensor, dists: np.ndarray, n: int):
    """kNN -> symmetric fuzzy membership matrix (dense [n, n] float32 on
    idx's device)."""
    w = torch.from_numpy(_memberships(dists).astype(np.float32))
    m = torch.zeros((n, n), dtype=torch.float32, device=idx.device)
    m.scatter_(1, idx, w.to(idx.device))   # each (row, col) written once
    # fuzzy union: a + b - a*b
    mt = m.T.contiguous()
    prod = m * mt
    return m.add_(mt).sub_(prod)


def _optimize(p: torch.Tensor, y0: torch.Tensor, a: float, b: float,
              n_epochs: int = UMAP_EPOCHS) -> torch.Tensor:
    # the JAX package's a and b enter its jitted loop as float32
    a32, b32 = np.float32(a), np.float32(b)
    attr_c = float(np.float32(-2.0) * a32 * b32)
    attr_e = float(b32 - np.float32(1.0))
    # a 0-d tensor: `scalar / tensor` in torch is reciprocal() * scalar,
    # which rounds differently from the division the JAX package does
    rep_c = torch.tensor(np.float32(2.0) * b32, device=p.device)
    one_minus_p = 1.0 - p
    y = y0
    for i in range(n_epochs):
        lr = float(np.float32(1.0) - np.float32(i) / np.float32(n_epochs))
        dx = y[:, 0, None] - y[None, :, 0]          # diff[..., 0]
        dy = y[:, 1, None] - y[None, :, 1]
        d2 = torch.clamp(dx * dx + dy * dy, min=1e-10)
        one_pow = d2.pow(float(b32)).mul_(float(a32)).add_(1.0)
        # attractive: -2ab d^(2b-2) / (1 + a d^2b) * p
        coef = d2.pow(attr_e).mul_(attr_c).div_(one_pow).mul_(p)
        # repulsive: 2b / (d2 (1 + a d^2b)) * (1 - p)
        rep = torch.div(rep_c, one_pow.mul_(d2))
        del d2, one_pow
        coef.add_(rep.mul_(one_minus_p).mul_(0.005))
        del rep
        coef.fill_diagonal_(0.0)
        g = torch.stack([(coef * dx).sum(1), (coef * dy).sum(1)], 1).neg_()
        y = y - lr * torch.clamp(g, -4.0, 4.0)
        y = y - y.mean(dim=0)
    return y


def run_umap(proj: torch.Tensor, n_neighbors: int = UMAP_N_NEIGHBORS,
             min_dist: float = UMAP_MIN_DIST,
             n_components: int = UMAP_COMPONENTS, seed: int = 0,
             n_epochs: int = UMAP_EPOCHS) -> np.ndarray:
    """PCA projection [n, d] (on the device) -> UMAP embedding
    [n, n_components] (numpy float64)."""
    n = proj.shape[0]
    if n <= 2:
        return np.zeros((n, n_components))
    k = min(n_neighbors, n - 1)
    idx, d = knn_graph(proj.to(torch.float32), k)
    dists = np.sqrt(np.maximum(d.cpu().numpy(), 0))
    p = _fuzzy_graph(idx, dists, n)
    a, b = _fit_ab(min_dist)
    y0 = _init(p, n_components, seed)
    return _optimize(p, y0, a, b, n_epochs).cpu().numpy().astype(np.float64)


def _init(p: torch.Tensor, n_components: int, seed: int) -> torch.Tensor:
    """Spectral-ish start: P times a numpy RandomState(seed) normal
    matrix (float64, as numpy promotes it), scaled to max |y| = 10."""
    rng = np.random.RandomState(seed)
    r = torch.from_numpy(rng.normal(size=(p.shape[0], n_components)))
    y0 = (p.double() @ r.to(p.device)).float()
    return 10.0 * y0 / (y0.abs().max() + 1e-9)
