"""Secondary analysis of the port (cellranger_tpu_torch/analysis/) against
the JAX package, module by module, on the CPU.

Inputs are the planted-population matrices of
`testing.fixtures.build_analysis_matrix` (seed 0, 1000 genes): 2
populations in 200 cells, 5 in 1,000, 8 in 2,000, log-normalized by the
JAX package's preprocess; each module gets the same numpy inputs in both
packages (the JAX package's PCA projection downstream of PCA).

  * PCA: sign-aligned projections within 1e-3 of max |proj| (measured
    4.2e-5, 3.9e-4, 5.3e-4) and explained variances within rtol 1e-4;
  * k-means labels (K = 2..10) and batch correction equal the JAX
    package's; kNN indices too (also on a matrix of duplicated cells,
    whose exact ties keep the lower index first), except where two
    candidates are within float32 rounding of each other; graph-clustering
    labels equal at 200 and 1,000 cells and agree on 99.5% of the 2,000
    (a near-tie, see the tests);
  * t-SNE and UMAP are chaotic at float level, so they are compared over
    a short horizon.  The JAX package's own result moves, under a 1-ulp
    change of every start coordinate, by up to 1.6e-4 of max |y| after 10
    t-SNE steps (200 cells) and by 0.12-0.17 after 5 UMAP epochs (1,000
    and 2,000 cells), so UMAP is compared after 1 and 2 epochs.
    Tolerances, as a share of max |y| (testing/analysis_check.py): t-SNE
    1e-4 after 1 and 5 steps (measured at most 2.4e-6) and 5e-4 after 10
    (measured at most 1.95e-4, at 1,000 cells); UMAP 1e-4 after 1 epoch (measured at most 1.2e-6) and 1e-3
    after 2 (measured at most 3.3e-4).  The calibrated P agrees within
    rtol 1e-4 at 200 and 1,000 cells (measured 1.3e-5, 1.8e-5); at 2,000
    cells within 1e-3 (measured 4.5e-4; the JAX package's own P moves by
    1.7e-4 under a 1-ulp change of one input coordinate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellranger_tpu.analysis import batch_correction as jbc
from cellranger_tpu.analysis import graphclust as jgc
from cellranger_tpu.analysis import kmeans as jkm
from cellranger_tpu.analysis import pca as jpca
from cellranger_tpu.analysis import tsne as jts
from cellranger_tpu.analysis import umap_tpu as jum
from cellranger_tpu.analysis.preprocess import (log_normalize_dense,
                                                select_features)
from cellranger_tpu_torch.analysis import batch_correction as tbc
from cellranger_tpu_torch.analysis import graphclust as tgc
from cellranger_tpu_torch.analysis import kmeans as tkm
from cellranger_tpu_torch.analysis import pca as tpca
from cellranger_tpu_torch.analysis import prng
from cellranger_tpu_torch.analysis import tsne as tts
from cellranger_tpu_torch.analysis import umap_tpu as tum
from cellranger_tpu_torch.testing import analysis_check as check
from cellranger_tpu_torch.testing.analysis_check import (rel_err,
                                                         sign_aligned_err)
from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix

MATRICES = {"2pop": (200, 2), "5pop": (1000, 5), "8pop": (2000, 8)}
CALIB_RTOL = {"2pop": 1e-4, "5pop": 1e-4, "8pop": check.CALIB_RTOL}
EPS32 = float(np.finfo(np.float32).eps)

_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    """(standardized x float32, JAX PCA projection float32, truth)."""
    if name not in _CACHE:
        n, pops = MATRICES[name]
        mat, truth = build_analysis_matrix(n, 1000, pops, seed=0)
        x = log_normalize_dense(mat.m, select_features(mat.m, 2000))
        proj = jpca.run_pca(x, 10)["transformed_pca_matrix"]
        _CACHE[name] = (x, proj.astype(np.float32), truth)
    return _CACHE[name]


@pytest.mark.parametrize("name", MATRICES)
def test_pca_matches_jax(name):
    x, _, _ = _inputs(name)
    j = jpca.run_pca(x, 10)
    t = tpca.run_pca(torch.from_numpy(x), 10)
    assert t["transformed_pca_matrix"].shape == (x.shape[0], 10)
    assert sign_aligned_err(j["transformed_pca_matrix"],
                            t["transformed_pca_matrix"]) <= 1e-3
    for k in ("variance_explained", "variance_explained_ratio"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4)
    assert sign_aligned_err(j["components"].T, t["components"].T) <= 1e-3
    np.testing.assert_array_equal(
        t["proj_dev"].numpy().astype(np.float64),
        t["transformed_pca_matrix"])


def test_randomized_svd_start_basis_is_jax_normal():
    """The start basis the port draws is JAX's (within the normal's
    stated ulps), so both packages iterate from the same subspace."""
    import jax
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1000, 20)))
    np.testing.assert_allclose(prng.normal(prng.PRNGKey(0), (1000, 20)), q,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", MATRICES)
def test_kmeans_labels_equal_jax(name):
    _, proj, _ = _inputs(name)
    for k in range(2, 11):
        jl, jc, ji = jkm.run_kmeans(proj, k)
        tl, tc, ti = tkm.run_kmeans(torch.from_numpy(proj), k)
        assert tl.dtype == jl.dtype
        np.testing.assert_array_equal(tl, jl)
        assert rel_err(jc, tc) <= 1e-4
        assert abs(ti / ji - 1) <= 1e-4


def _duplicate_cells():
    """Integer coordinates (exact in float32) with every point four
    times: each row has exact distance ties, nearest ones included."""
    rng = np.random.default_rng(3)
    base = rng.integers(-4, 5, (40, 6)).astype(np.float32)
    return np.repeat(base, 4, axis=0)[rng.permutation(160)]


def _non_tie_mismatches(x, ji, ti):
    """Slots where the two neighbor lists differ by more than a near-tie:
    the two candidates' exact squared distances differ by more than
    4 eps32 (|x_i|^2 + |x_j|^2), the float32 rounding of
    |x_i|^2 - 2 x_i.x_j + |x_j|^2 (measured ties here: at most
    1.9 eps32 (|x_i|^2 + |x_j|^2))."""
    x64 = x.astype(np.float64)
    s = (x64 ** 2).sum(1)
    bad = []
    for i, c in zip(*np.nonzero(ji != ti)):
        a, b = ji[i, c], ti[i, c]
        gap = abs(((x64[i] - x64[a]) ** 2).sum()
                  - ((x64[i] - x64[b]) ** 2).sum())
        if gap > 4 * EPS32 * (s[i] + max(s[a], s[b])):
            bad.append((int(i), int(c)))
    return bad


@pytest.mark.parametrize("name", list(MATRICES) + ["duplicates"])
def test_knn_graph_equal_jax(name):
    """Equal indices, nearest first and lower index first among exact
    ties.  Both packages compute |x_i|^2 - 2 x_i.x_j + |x_j|^2 through a
    matmul whose rounding is the BLAS's, so two candidates within float32
    rounding of each other may order differently: at 2,000 cells 26 of
    the 60,000 slots at k = 30 do (none at 200 or 1,000 cells), all
    within 1.9 eps32 (|x_i|^2 + |x_j|^2); the JAX package's own kNN moves
    14-16 slots at 2,000 cells under a 1-ulp change of its input.  The
    distances agree within the same rounding, 8 eps32 max |x|^2."""
    x = _duplicate_cells() if name == "duplicates" else _inputs(name)[1]
    for k in (3, 10, 30):
        ji, jd = jgc.knn_graph(jnp.asarray(x), k)
        ji = np.asarray(ji)
        ti, td = tgc.knn_graph(torch.from_numpy(x), k)
        ti = ti.numpy()
        if name in ("duplicates", "2pop"):
            np.testing.assert_array_equal(ti, ji)
        assert not _non_tie_mismatches(x, ji, ti), k
        assert (ji != ti).sum() <= 0.001 * ji.size, k
        if name == "duplicates":
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        else:
            bound = 8 * EPS32 * float((x.astype(np.float64) ** 2).sum(1).max())
            assert np.abs(np.sort(np.asarray(jd), 1)
                          - np.sort(td.numpy(), 1)).max() <= bound


@pytest.mark.parametrize("name", MATRICES)
def test_graph_clustering_equal_jax(name):
    """Equal labels at 200 and 1,000 cells.  At 2,000 cells one neighbor
    set differs at a near-tie (test above), and Louvain moves 2 of the
    2,000 cells: the test holds the port's Louvain and label order to the
    JAX package's on the JAX package's own kNN graph, and the end-to-end
    labels to the same cluster count and 99.5% agreement after matching
    clusters."""
    from scipy.optimize import linear_sum_assignment

    _, proj, _ = _inputs(name)
    j = jgc.run_graph_clustering(proj)
    t = tgc.run_graph_clustering(torch.from_numpy(proj))
    if name != "8pop":
        np.testing.assert_array_equal(t, j)
        return
    n, k = len(proj), jgc.default_knn_k(len(proj))
    ji = np.asarray(jgc.knn_graph(jnp.asarray(proj), k)[0])
    src, dst, w = np.repeat(np.arange(n), k), ji.ravel(), np.ones(n * k)
    np.testing.assert_array_equal(tgc.louvain(src, dst, w, n),
                                  jgc.louvain(src, dst, w, n))
    assert len(np.unique(t)) == len(np.unique(j))
    c = np.zeros((t.max() + 1, j.max() + 1))
    np.add.at(c, (t, j), 1)
    r, cc = linear_sum_assignment(-c)
    assert c[r, cc].sum() >= check.NEAR_TIE_AGREEMENT * n


def test_batch_correction_matches_jax():
    _, proj, truth = _inputs("2pop")
    rng = np.random.default_rng(4)
    batches = rng.integers(0, 2, len(proj))
    shifted = proj.astype(np.float64) + batches[:, None] * 3.0
    j = jbc.correct_batches(shifted, batches)
    t = tbc.correct_batches(shifted, batches, device="cpu")
    np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-9)
    assert jbc.find_mnn_pairs(proj[:90], proj[90:]) == \
        tbc.find_mnn_pairs(proj[:90], proj[90:], device="cpu")


@pytest.mark.parametrize("name", MATRICES)
def test_calibrated_p_matches_jax(name):
    _, proj, _ = _inputs(name)
    j = np.asarray(jts._calibrated_p(jnp.asarray(proj), 30))
    t = tts._calibrated_p(torch.from_numpy(proj), 30).numpy()
    np.testing.assert_allclose(t, j, rtol=CALIB_RTOL[name], atol=0)


@pytest.mark.parametrize("name", MATRICES)
def test_tsne_short_horizon_matches_jax(name):
    _, proj, _ = _inputs(name)
    p = np.asarray(jts._calibrated_p(jnp.asarray(proj), 30))
    # run_tsne's start
    y0 = 1e-4 * prng.normal(prng.PRNGKey(0), (len(proj), 2))
    for n_iter, tol in check.TSNE_TOL.items():
        j = np.asarray(jts._tsne_optimize(jnp.asarray(p), jnp.asarray(y0),
                                          n_iter))
        t = tts._tsne_optimize(torch.from_numpy(p.copy()),
                               torch.from_numpy(y0), n_iter).numpy()
        assert rel_err(j, t) <= tol, (n_iter, rel_err(j, t))


@pytest.mark.parametrize("name", MATRICES)
def test_umap_graph_init_and_short_horizon_match_jax(name):
    _, proj, _ = _inputs(name)
    n = len(proj)
    ji, jd = jgc.knn_graph(jnp.asarray(proj), 30)
    dists = np.sqrt(np.maximum(np.asarray(jd), 0))
    p = jum._fuzzy_graph(np.asarray(ji), dists, n)
    tp = tum._fuzzy_graph(torch.from_numpy(np.asarray(ji, np.int64)), dists,
                          n)
    np.testing.assert_array_equal(tp.numpy(), p)
    assert tum._fit_ab(0.3) == jum._fit_ab(0.3)
    a, b = jum._fit_ab(0.3)
    # run_umap's start
    y0 = (p @ np.random.RandomState(0).normal(size=(n, 2))).astype(np.float32)
    y0 = 10.0 * y0 / (np.abs(y0).max() + 1e-9)
    np.testing.assert_allclose(tum._init(tp, 2, 0).numpy(), y0, rtol=1e-6,
                               atol=1e-6)
    for n_epochs, tol in check.UMAP_TOL.items():
        j = np.asarray(jum._optimize(jnp.asarray(p), jnp.asarray(y0), a, b,
                                     n_epochs))
        t = tum._optimize(torch.from_numpy(p), torch.from_numpy(y0), a, b,
                          n_epochs).numpy()
        assert rel_err(j, t) <= tol, (n_epochs, rel_err(j, t))


def test_aligned_err_rotates_only_within_degenerate_groups():
    """A rotation inside a group of near-equal variances is aligned away;
    one that mixes components of distinct variances, or a changed
    value, is not."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(300, 4))
    var = np.asarray([10.0, 9.95, 9.9, 1.0])
    c, s = np.cos(0.7), np.sin(0.7)
    inside = a.copy()
    inside[:, :2] = a[:, :2] @ np.asarray([[c, -s], [s, c]])
    inside[:, 3] *= -1
    assert check.aligned_err(a, inside, var) < 1e-12
    assert check.sign_aligned_err(a, inside) > 0.1
    across = a.copy()
    across[:, 2:] = a[:, 2:] @ np.asarray([[c, -s], [s, c]])
    assert check.aligned_err(a, across, var) > 0.1
    moved = a.copy()
    moved[7, 1] += 0.01
    assert check.aligned_err(a, moved, var) > 1e-3


def test_compare_analysis_finds_changed_files(tmp_path):
    """compare_analysis reports a moved label, a changed diff-exp value
    and a moved PCA coordinate; an untouched copy has no differences."""
    import shutil

    mat, truth = build_analysis_matrix(200, 1000, 2, seed=0)
    ref = str(tmp_path / "ref")
    from cellranger_tpu_torch.analysis.run import run_secondary_analysis
    run_secondary_analysis(mat, ref, skip_embeddings=True, device="cpu")
    assert check.compare_analysis(ref, ref, truth)[0] == []

    def changed(rel, edit):
        got = str(tmp_path / rel.replace("/", "_"))
        shutil.copytree(ref, got)
        path = f"{got}/{rel}"
        with open(path) as f:
            lines = f.read().split("\n")
        lines[1] = edit(lines[1])
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return check.compare_analysis(ref, got, truth)[0]

    def relabel(line):
        bc, c = line.split(",")
        return f"{bc},{3 - int(c)}"

    assert changed("clustering/kmeans_2_clusters/clusters.csv", relabel)
    assert changed("diffexp/graphclust/differential_expression.csv",
                   lambda ln: ln.replace(",", ",9", 2))
    assert changed("pca/10_components/projection.csv",
                   lambda ln: ln.replace(",", ",1", 1))
