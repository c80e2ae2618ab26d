"""Exact t-SNE on the device (port of cellranger_tpu/analysis/tsne.py, the
RUN_TSNE_NG analog): dense `[N, N]` affinities calibrated by a 50-step
bisection on beta, then 1000 gradient steps with early exaggeration,
momentum and gains.

Each `[N, N]` plane is 4 N^2 bytes (400 MB at N = 10,000); the step
updates its planes in place, so it holds P, the exaggerated P (first 250
steps) and two work planes; `diag(rowsum) - M` is formed in M's plane.
The optimization is chaotic at float level: runs
that differ in the last bit of one input drift apart after a few dozen
steps, so the port equals the JAX package over a short horizon and in
embedding quality, not element by element after 1000 steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng

TSNE_DEFAULT_PERPLEXITY = 30   # analysis/constants.py:19
TSNE_DEFAULT_COMPONENTS = 2
TSNE_THETA = 0.5
TSNE_MAX_ITER = 1000
TSNE_STOP_LYING_ITER = 250
TSNE_MOM_SWITCH_ITER = 250


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """s_i - 2 x_i.x_j + s_j, written into one new [n, n] plane."""
    s = torch.sum(x ** 2, dim=1)
    d2 = (2 * x) @ x.T
    return d2.neg_().add_(s[:, None]).add_(s[None, :])


def _entropy_p(d2: torch.Tensor, beta: torch.Tensor):
    """(row entropies, row-normalized P) at precisions beta."""
    p = torch.exp(d2 * -beta[:, None])
    p.fill_diagonal_(0.0)
    sw = torch.clamp(p.sum(dim=1), min=1e-12)
    p.div_(sw[:, None])
    # xlogy(p, p) is p * log(p) where p > 0 and 0 where p == 0
    h = -torch.special.xlogy(p, p).sum(dim=1)
    return h, p


def _calibrated_p(x: torch.Tensor,
                  perplexity: int = TSNE_DEFAULT_PERPLEXITY) -> torch.Tensor:
    """Binary-search per-point beta so conditional entropy = log(perplexity);
    returns symmetrized, normalized P."""
    n = x.shape[0]
    d2 = _pairwise_sq_dists(x)
    d2.fill_diagonal_(0.0)
    target = float(np.log(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float32, device=x.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, math.inf)
    for _ in range(50):
        h, _ = _entropy_p(d2, beta)
        too_high = h > target          # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2, (lo + hi) / 2)
    _, p = _entropy_p(d2, beta)
    del d2
    p = p.add_(p.T.clone()).div_(2.0 * n)
    return p.clamp_(min=1e-12)


def _grad(y: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    q_num = _pairwise_sq_dists(y).add_(1.0).reciprocal_()   # 1 / (1 + d2)
    q_num.fill_diagonal_(0.0)
    z = torch.clamp(q_num.sum(), min=1e-12)
    mult = torch.clamp(q_num / z, min=1e-12)                 # q
    mult.neg_().add_(pp).mul_(q_num)                         # (pp - q) q_num
    # diag(rowsum) - mult, in place: mult's diagonal is 0 (q_num's is)
    rowsum = mult.sum(dim=1)
    mult.neg_().diagonal().copy_(rowsum)
    return 4.0 * (mult @ y)


def _tsne_optimize(p: torch.Tensor, y0: torch.Tensor,
                   n_iter: int = TSNE_MAX_ITER) -> torch.Tensor:
    pp = p * 12.0                      # early exaggeration
    y = y0
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(n_iter):
        if i == TSNE_STOP_LYING_ITER:
            pp = p                     # frees the exaggerated plane
        mom = 0.5 if i < TSNE_MOM_SWITCH_ITER else 0.8
        g = _grad(y, pp)
        gains = torch.where(torch.sign(g) != torch.sign(vel),
                            gains + 0.2, gains * 0.8)
        gains = torch.clamp(gains, min=0.01)
        vel = mom * vel - 200.0 * gains * g
        y = y + vel
        y = y - y.mean(dim=0)
    return y


def run_tsne(proj: torch.Tensor, n_components: int = TSNE_DEFAULT_COMPONENTS,
             perplexity: int = TSNE_DEFAULT_PERPLEXITY, seed: int = 0,
             n_iter: int = TSNE_MAX_ITER) -> np.ndarray:
    """PCA projection [n, d] (on the device) -> t-SNE embedding
    [n, n_components] (numpy float64)."""
    n = proj.shape[0]
    if n <= 2:
        return np.zeros((n, n_components))
    perplexity = int(min(perplexity, max(2, (n - 1) // 3)))
    x = proj.to(torch.float32)
    p = _calibrated_p(x, perplexity)
    y0 = 1e-4 * prng.normal(prng.PRNGKey(seed), (n, n_components))
    y = _tsne_optimize(p, torch.from_numpy(y0).to(x.device), n_iter)
    return y.cpu().numpy().astype(np.float64)
