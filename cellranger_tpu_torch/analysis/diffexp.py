"""sSeq differential expression (RUN_DIFFERENTIAL_EXPRESSION_NG analog).

Implements the shrunken-dispersion negative-binomial exact test of
Yu, Huber & Vitek (2013), matching the reference's behavior
(lib/python/cellranger/analysis/diffexp.py + the scan-rs diff-exp crate
driven from cr_ana/src/stages/diff_exp_stage.rs:78):

  * size factors = per-cell totals / median total (diffexp.py:32-43)
  * method-of-moments per-gene dispersion on size-normalized counts,
    shrunk toward zeta_hat = quantile_0.995 of MoM dispersions with weight
    delta per the sSeq formula (SSEQ_ZETA_QUANTILE, diffexp.py:29)
  * per cluster-vs-rest: NB exact test on summed counts when both sums
    <= big_count=900, else normal approximation (diffexp.py:100)
  * Benjamini-Hochberg adjustment; log2 fold change with pseudocounts.

Verbatim copy of cellranger_tpu/analysis/diffexp.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.stats as st

SSEQ_ZETA_QUANTILE = 0.995
BIG_COUNT = 900


def estimate_size_factors(x: sp.spmatrix) -> np.ndarray:
    counts = np.asarray(x.sum(axis=0)).ravel().astype(np.float64)
    med = np.median(counts[counts > 0]) if (counts > 0).any() else 1.0
    return counts / max(med, 1e-12)


def compute_sseq_params(x: sp.spmatrix, zeta_quantile: float = SSEQ_ZETA_QUANTILE):
    """x: feature x cell raw counts. Returns the sSeq parameter dict."""
    G, N = x.shape
    s = estimate_size_factors(x)
    s_nz = np.where(s > 0, s, 1.0)
    xn = x.tocsc().astype(np.float64) @ sp.diags(1.0 / s_nz)
    mean_g = np.asarray(xn.mean(axis=1)).ravel()
    sq = xn.copy()
    sq.data **= 2
    ex2 = np.asarray(sq.mean(axis=1)).ravel()
    var_g = (ex2 - mean_g ** 2) * (N / max(N - 1, 1))
    use_g = var_g > 0

    # method-of-moments NB dispersion on normalized counts:
    # Var = mu + phi mu^2  (normalized scale)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi_mm_g = np.maximum(0.0, (N * var_g - mean_g * np.sum(1.0 / s_nz))
                              / (mean_g ** 2 * N))
    phi_mm_g[~np.isfinite(phi_mm_g)] = 0.0

    if use_g.sum() > 1:
        zeta_hat = float(np.quantile(phi_mm_g[use_g], zeta_quantile))
        mean_phi = float(np.mean(phi_mm_g[use_g]))
        g_used = int(use_g.sum())
        num = np.sum((phi_mm_g[use_g] - mean_phi) ** 2) / max(g_used - 1, 1)
        den = np.sum((phi_mm_g[use_g] - zeta_hat) ** 2) / max(g_used - 2, 1)
        delta = float(num / max(den, 1e-12))
        delta = min(max(delta, 0.0), 1.0)
    else:
        zeta_hat, delta = 0.0, 0.0
    phi_g = np.where(use_g, delta * zeta_hat + (1 - delta) * phi_mm_g, np.nan)
    return dict(N=N, G=G, size_factors=s, mean_g=mean_g, var_g=var_g,
                use_g=use_g, phi_mm_g=phi_mm_g, zeta_hat=zeta_hat,
                delta=delta, phi_g=phi_g)


def _nb_exact_pvals(x_a, x_b, size_a, size_b, mu, phi):
    """Exact NB test per gene (vectorized over a chunk of genes).

    Under the null, sum_a ~ NB(mean=size_a*mu, disp=phi/size_a) and
    sum_b ~ NB(size_b*mu, phi/size_b) independently. p-value = total
    probability of all splits (k, n-k) of n = x_a+x_b that are no more
    likely than the observed split.
    """
    n = (x_a + x_b).astype(int)
    out = np.ones(len(n))
    if len(n) == 0:
        return out
    max_n = int(n.max())
    ks = np.arange(max_n + 1)

    def logpmf(k, mean, disp):
        if disp <= 0:
            return st.poisson.logpmf(k, mean)
        r = 1.0 / disp
        p = r / (r + mean)
        return st.nbinom.logpmf(k, r, p)

    for i in range(len(n)):
        ni = n[i]
        k = ks[:ni + 1]
        la = logpmf(k, size_a[i] * mu[i], phi[i] / size_a[i])
        lb = logpmf(ni - k, size_b[i] * mu[i], phi[i] / size_b[i])
        joint = la + lb
        obs = joint[int(x_a[i])]
        total = np.logaddexp.reduce(joint)
        sel = joint <= obs + 1e-10
        out[i] = np.exp(np.logaddexp.reduce(joint[sel]) - total)
    return np.minimum(out, 1.0)


def _nb_asymptotic_pvals(x_a, x_b, size_a, size_b, mu, phi):
    """Normal approximation for large counts (big_count branch)."""
    mean_a = size_a * mu
    mean_b = size_b * mu
    var_a = mean_a + phi * mean_a ** 2 / np.maximum(size_a, 1e-12)
    var_b = mean_b + phi * mean_b ** 2 / np.maximum(size_b, 1e-12)
    # two-sided on the standardized difference of the split
    diff = (x_a - mean_a) - (mean_a / np.maximum(mean_b, 1e-12)) * (x_b - mean_b)
    var_diff = var_a + (mean_a / np.maximum(mean_b, 1e-12)) ** 2 * var_b
    z = diff / np.sqrt(np.maximum(var_diff, 1e-12))
    return 2.0 * st.norm.sf(np.abs(z))


def adjust_pvalue_bh(p: np.ndarray) -> np.ndarray:
    desc = np.argsort(p)[::-1]
    scale = float(len(p)) / np.arange(len(p), 0, -1)
    q = np.minimum(1, np.minimum.accumulate(scale * p[desc]))
    return q[np.argsort(desc)]


def sseq_differential_expression(x: sp.spmatrix, cond_a, cond_b, params,
                                 big_count: int = BIG_COUNT):
    """Group A vs group B. Returns dict of per-gene arrays (reference
    column names, diffexp.py:119-133)."""
    x = x.tocsc()
    x_a = np.asarray(x[:, cond_a].sum(axis=1)).ravel()
    x_b = np.asarray(x[:, cond_b].sum(axis=1)).ravel()
    s = params["size_factors"]
    s_a = float(s[cond_a].sum())
    s_b = float(s[cond_b].sum())
    G = params["G"]

    # pooled mean under the null (normalized scale)
    mu = (x_a + x_b) / max(s_a + s_b, 1e-12)
    phi = np.nan_to_num(params["phi_g"], nan=0.0)
    use = params["use_g"] & ((x_a + x_b) > 0)

    pvals = np.ones(G)
    small = use & (x_a <= big_count) & (x_b <= big_count)
    big = use & ~small
    if small.any():
        idx = np.flatnonzero(small)
        pvals[idx] = _nb_exact_pvals(
            x_a[idx], x_b[idx], np.full(len(idx), s_a), np.full(len(idx), s_b),
            mu[idx], phi[idx])
    if big.any():
        idx = np.flatnonzero(big)
        pvals[idx] = _nb_asymptotic_pvals(
            x_a[idx], x_b[idx], np.full(len(idx), s_a), np.full(len(idx), s_b),
            mu[idx], phi[idx])

    padj = adjust_pvalue_bh(pvals)
    norm_mean_a = x_a / max(s_a, 1e-12)
    norm_mean_b = x_b / max(s_b, 1e-12)
    l2fc = np.log2((1 + x_a) / (1 + s_a)) - np.log2((1 + x_b) / (1 + s_b))
    return dict(tested=use, sum_a=x_a, sum_b=x_b, common_mean=mu,
                common_dispersion=phi, norm_mean_a=norm_mean_a,
                norm_mean_b=norm_mean_b, p_value=pvals,
                adjusted_p_value=padj, log2_fold_change=l2fc)


def run_differential_expression(x: sp.spmatrix, clusters: np.ndarray):
    """Per-cluster one-vs-rest DE (diffexp.py:137-172). clusters 1-based.
    Returns dict cluster -> result dict."""
    params = compute_sseq_params(x)
    out = {}
    for c in np.unique(clusters):
        in_c = np.flatnonzero(clusters == c)
        out_c = np.flatnonzero(clusters != c)
        if len(in_c) == 0 or len(out_c) == 0:
            continue
        out[int(c)] = sseq_differential_expression(x, in_c, out_c, params)
    return out
