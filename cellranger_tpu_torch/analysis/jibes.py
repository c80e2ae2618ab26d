"""JIBES: joint inference of barcoding errors and states — the CMO/hashtag
tag-assignment model (reference: lib/python/cellranger/analysis/jibes_py.py
JibesModelPy/JibesEMPy, Rust twin jibes_o3).

Model: per cell, observed log-scale tag counts Y[c, :] ~ Normal(X_s @ B,
diag(sigma^2)) where the latent state s encodes tag multiplicities (blank /
singlet / k-let up to 3) with priors from the GEM loading model; B stacks a
per-tag background intercept and a per-tag foreground effect
(jibes_py.py:50 B = vstack(background, diag(foreground))). EM alternates
state responsibilities with weighted per-tag linear regression.

Assignments: Blank / <tag> / Multiplet by posterior argmax, matching the
reference's call semantics.

Verbatim copy of cellranger_tpu/analysis/jibes.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations_with_replacement

import numpy as np

DEFAULT_BLANK_PROB = 0.04  # jibes_py.py:21
MAX_K_LET = 3              # jibes_py.py:22 _MAX_K_LETS_TO_CONSIDER = 3


def _latent_states(num_tags: int, max_k: int = MAX_K_LET):
    """State design matrix X [S, num_tags] of tag multiplicities: blank,
    singlets, multiplets."""
    rows = [np.zeros(num_tags)]  # blank
    kinds = ["Blank"]
    for k in range(1, max_k + 1):
        for combo in combinations_with_replacement(range(num_tags), k):
            x = np.zeros(num_tags)
            for t in combo:
                x[t] += 1
            rows.append(x)
            kinds.append(str(combo[0]) if k == 1 else "Multiplet")
    return np.asarray(rows), kinds


@dataclass
class JibesResult:
    assignments: list[str]        # per cell: "Blank" | tag name | "Multiplet"
    posteriors: np.ndarray        # [cells] posterior of the called state
    background: np.ndarray        # per-tag background mean (log scale)
    foreground: np.ndarray        # per-tag foreground effect
    std_devs: np.ndarray
    n_iters: int
    converged: bool


def fit_jibes(counts: np.ndarray, tag_names: list[str],
              blank_prob: float = DEFAULT_BLANK_PROB,
              max_iters: int = 100, tol: float = 1e-4) -> JibesResult:
    """counts: [cells, tags] raw tag UMI counts. EM fit + assignment."""
    Y = np.log10(1.0 + np.asarray(counts, np.float64))
    n, T = Y.shape
    X, kinds = _latent_states(T)
    S = len(kinds)

    # init: background = per-tag lower-half mean; foreground = upper-decile
    bg = np.percentile(Y, 30, axis=0)
    fg = np.maximum(np.percentile(Y, 95, axis=0) - bg, 0.3)
    sd = np.maximum(Y.std(axis=0) / 2, 0.05)
    # state priors: blank + uniform singlets + small multiplets
    n_singlet = T
    n_multi = S - 1 - T
    prior = np.zeros(S)
    prior[0] = blank_prob
    prior[1:1 + T] = (1 - blank_prob) * 0.85 / n_singlet
    if n_multi:
        prior[1 + T:] = (1 - blank_prob) * 0.15 / n_multi
    prior /= prior.sum()

    ll_prev = -np.inf
    converged = False
    for it in range(max_iters):
        means = bg[None, :] + X * fg[None, :]          # [S, T]
        # log N(y; mean_s, sd) summed over tags -> [n, S]
        logp = -0.5 * (((Y[:, None, :] - means[None, :, :]) / sd) ** 2).sum(-1) \
            - np.log(sd).sum() - 0.5 * T * np.log(2 * np.pi)
        logp = logp + np.log(np.maximum(prior, 1e-12))[None, :]
        m = logp.max(axis=1, keepdims=True)
        resp = np.exp(logp - m)
        resp /= resp.sum(axis=1, keepdims=True)
        ll = float((m.ravel() + np.log(np.exp(logp - m).sum(axis=1))).sum())

        # M-step: per tag weighted regression y ~ b0 + f * multiplicity
        w_state = resp.sum(axis=0)                      # [S]
        for t in range(T):
            xs = X[:, t]                                # multiplicity per state
            # weighted sums over cells x states
            W = resp                                    # [n, S]
            sw = W.sum()
            sx = float((W * xs[None, :]).sum())
            sxx = float((W * (xs ** 2)[None, :]).sum())
            sy = float((W * Y[:, t:t + 1]).sum())
            sxy = float((W * xs[None, :] * Y[:, t:t + 1]).sum())
            det = sw * sxx - sx * sx
            if det > 1e-9 and sxx > 0:
                b0 = (sxx * sy - sx * sxy) / det
                f = (sw * sxy - sx * sy) / det
            else:
                b0, f = bg[t], fg[t]
            bg[t] = b0
            fg[t] = max(f, 0.05)  # foreground must stay positive
            pred = b0 + xs * fg[t]
            resid2 = float((W * (Y[:, t:t + 1] - pred[None, :]) ** 2).sum())
            sd[t] = max(np.sqrt(resid2 / max(sw, 1e-9)), 0.02)
        prior = np.maximum(w_state / n, 1e-9)
        prior /= prior.sum()

        if abs(ll - ll_prev) < tol * max(abs(ll_prev), 1.0):
            converged = True
            break
        ll_prev = ll

    best = resp.argmax(axis=1)
    post = resp[np.arange(n), best]
    labels = []
    for s in best:
        kind = kinds[s]
        if kind == "Blank":
            labels.append("Blank")
        elif kind == "Multiplet":
            labels.append("Multiplet")
        else:
            labels.append(tag_names[int(kind)])
    return JibesResult(assignments=labels, posteriors=post, background=bg,
                       foreground=fg, std_devs=sd, n_iters=it + 1,
                       converged=converged)


def assign_tags(matrix, tag_feature_indices: list[int], barcodes: list,
                tag_names: list[str], **kw) -> dict:
    """Convenience: feature x barcode sparse matrix + tag feature rows ->
    {barcode: assignment} (+ the fitted JibesResult under '_result')."""
    counts = np.asarray(matrix[tag_feature_indices, :].todense()).T
    res = fit_jibes(counts, tag_names, **kw)
    out = {b: a for b, a in zip(barcodes, res.assignments)}
    out["_result"] = res
    return out
