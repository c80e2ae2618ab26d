"""Simple Good-Turing frequency smoothing (Gale & Sampson 1995).

Used to estimate the ambient RNA profile for EmptyDrops-style cell calling.
Behavior matches the reference's estimator (lib/python/cellranger/sgt.py,
itself a port of Sampson's S code): averaging transform of the frequency-of-
frequency spectrum, log-log regression for the linear Good-Turing estimate,
positional switch rule from the Turing estimate at 1.65 SD, and unseen mass
p0 = N1/N.

Verbatim copy of cellranger_tpu/analysis/sgt.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np


class SGTError(ValueError):
    pass


def simple_good_turing(r: np.ndarray, nr: np.ndarray):
    """r: distinct observed frequencies (ascending), nr: counts of each.

    Returns (r_star adjusted frequencies, p0 unseen probability mass).
    """
    r = np.asarray(r, dtype=float)
    nr = np.asarray(nr, dtype=float)
    n = len(r)
    total = float(np.sum(r * nr))

    # averaging transform: spread each nr over half the gap to its neighbors
    gap = np.diff(r, prepend=r[0] - 1.0)
    avg_width = np.append(0.5 * (gap[1:] + gap[:-1]), gap[-1])
    z = nr / avg_width

    # log-log least squares for the linear (smoothed) estimate
    lx, ly = np.log(r), np.log(z)
    slope = np.sum((lx - lx.mean()) * (ly - ly.mean())) / np.sum((lx - lx.mean()) ** 2)
    if slope > -1:
        raise SGTError(f"SGT log-log slope {slope:.3f} > -1; estimator inapplicable")
    lgt_rel = np.power(1 + 1 / r, 1 + slope)  # r*_LGT / r

    # Turing estimate (relative), defined where frequency r+1 was observed
    has_next = np.append(r[1:] == r[:-1] + 1, False)
    nr_next = np.append(nr[1:], 0.0)
    turing_rel = np.where(has_next, (r + 1) / r * nr_next / nr, 0.0)

    # positional SD of the Turing estimate (Sampson's S code uses the row
    # index, not the frequency value)
    sd = np.ones(n)
    idx = np.arange(n, dtype=float)
    with np.errstate(invalid="ignore"):
        sd_vals = (idx + 2) / nr * np.sqrt(nr_next * (1 + nr_next / nr))
    sd[has_next] = sd_vals[has_next]

    combined_rel = np.empty(n)
    use_turing = True
    for i in range(n):
        if use_turing and abs(lgt_rel[i] - turing_rel[i]) * (1 + i) / sd[i] > 1.65:
            combined_rel[i] = turing_rel[i]
        else:
            use_turing = False
            combined_rel[i] = lgt_rel[i]

    p0 = nr[0] / total
    norm = float(np.sum(combined_rel * r * nr / total))
    combined_rel = combined_rel * (1 - p0) / norm
    return r * combined_rel, p0


def sgt_proportions(frequencies: np.ndarray):
    """Per-item smoothed proportions for a vector of nonzero frequencies.

    Returns (pstar per item, p0). Raises SGTError when the frequency-of-
    frequency spectrum is too sparse (<10 distinct values, sgt.py:117-119).
    """
    frequencies = np.asarray(frequencies)
    if len(frequencies) == 0:
        raise ValueError("empty frequency vector")
    if (frequencies <= 0).any():
        raise ValueError("frequencies must be positive")
    ff = np.bincount(frequencies)
    distinct = np.flatnonzero(ff)
    if len(distinct) < 10:
        raise SGTError(f"too few distinct frequencies ({len(distinct)}) for SGT")
    r_star, p0 = simple_good_turing(distinct, ff[distinct])
    lookup = dict(zip(distinct.tolist(), r_star))
    r_star_i = np.asarray([lookup[f] for f in frequencies.tolist()])
    denom = float(np.sum(ff[distinct] * r_star))
    pstar = (1 - p0) * r_star_i / denom
    assert np.isclose(p0 + pstar.sum(), 1.0)
    return pstar, p0
