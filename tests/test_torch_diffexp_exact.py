"""The port's sSeq test on many genes at once (`analysis/diffexp.py`)
against the JAX package's gene-at-a-time `analysis/diffexp.py`: every
array of every cluster's result equal bit for bit, on matrices that reach
the exact test's Poisson and negative-binomial branches, genes of no
count, the asymptotic branch past 900 counts, one-cell clusters, chunks
of one gene and a single cluster."""

import numpy as np
import pytest
import scipy.sparse as sp

from cellranger_tpu.analysis import diffexp as jde
from cellranger_tpu_torch.analysis import diffexp as dx


def _equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for c in a:
        assert list(a[c]) == list(b[c])
        for k in a[c]:
            assert np.asarray(a[c][k]).dtype == np.asarray(b[c][k]).dtype, k
            assert np.array_equal(a[c][k], b[c][k], equal_nan=True), (c, k)


def _matrix(seed: int, genes: int, cells: int, scale: float) -> sp.csc_matrix:
    """Counts of genes whose means span three decades, a few genes of no
    count and a few past the exact test's 900."""
    rng = np.random.default_rng(seed)
    lam = rng.gamma(0.6, scale, genes)[:, None] * rng.uniform(
        0.5, 1.5, cells)[None, :]
    x = rng.poisson(lam).astype(np.float64)
    x[:5] = 0
    x[5:8] *= 40
    return sp.csc_matrix(x)


@pytest.mark.parametrize("seed,genes,cells,clusters,scale", [
    (0, 2_000, 120, 6, 0.5),      # small counts: the Flex sample's regime
    (1, 600, 300, 3, 4.0),        # deep genes: long splits, big_count
    (2, 800, 60, 12, 1.0),        # many clusters, some of one cell
    (3, 400, 50, 1, 1.0),         # a single cluster: no test
    (4, 300, 400, 2, 12.0),       # two clusters of deep genes
])
def test_run_differential_expression_matches_jax(seed, genes, cells,
                                                 clusters, scale):
    x = _matrix(seed, genes, cells, scale)
    labels = np.random.default_rng(seed + 10).integers(1, clusters + 1,
                                                       cells)
    if clusters > 1:
        labels[0] = clusters + 1          # a cluster of one cell
    _equal(jde.run_differential_expression(x, labels),
           dx.run_differential_expression(x, labels))


@pytest.mark.parametrize("chunk", [1, 64, 1 << 20])
def test_exact_pvals_match_jax_in_any_chunking(monkeypatch, chunk):
    """Splits of up to 1,800 counts, zero dispersions (the Poisson
    branch), genes of n = 0 and chunks down to one gene."""
    rng = np.random.default_rng(7)
    g = 700
    x_a = rng.integers(0, 901, g).astype(np.float64)
    x_b = rng.integers(0, 901, g).astype(np.float64)
    x_a[:40] = rng.integers(0, 3, 40)
    x_b[:40] = rng.integers(0, 3, 40)
    x_a[40:45] = x_b[40:45] = 0
    size_a, size_b = np.full(g, 11.75), np.full(g, 188.5)
    mu = (x_a + x_b) / (11.75 + 188.5)
    phi = rng.gamma(0.5, 0.4, g)
    phi[::6] = 0.0
    monkeypatch.setattr(dx, "CHUNK_SPLITS", chunk)
    want = jde._nb_exact_pvals(x_a, x_b, size_a, size_b, mu, phi)
    got = dx._nb_exact_pvals(x_a, x_b, size_a, size_b, mu, phi)
    assert np.array_equal(want, got)
    assert np.array_equal(dx._nb_exact_pvals(x_a[:0], x_b[:0], size_a[:0],
                                            size_b[:0], mu[:0], phi[:0]),
                          np.ones(0))
