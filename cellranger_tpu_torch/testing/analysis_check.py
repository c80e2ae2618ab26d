"""How two secondary-analysis results are held against each other, shared
by the tests and chip_smoke.py.

Labels and the files derived from them must be equal byte for byte: the
k-means and graph-clustering `clusters.csv`, `hierarchy.json` and
`differential_expression.csv`.  A caller may accept labels that agree on
a share `min_label_agreement` of the cells after matching clusters
(near-ties of float32 distances, see tests/test_torch_analysis.py); where
the graph clusters then differ, their hierarchy and diff-exp, host
functions of those labels, are not compared.  `same_projection_labels`
holds the clusterings of one projection on two devices equal.

PCA projections are held within PCA_TOL of max |proj| and the explained
variances within VAR_RTOL (a variance under VAR_ZERO of the first, a
rank-deficient matrix's zero, against that floor).  A singular vector is
defined only up to its sign, and up to a rotation within a group of
equal singular values; balanced populations give near-equal ones (the
JAX package's own 1-ulp change of its input moves components 5 and 6 of
the 8-population matrix by 1.4e-3 of max |proj| after sign alignment).
So the projection is aligned by the best rotation within each group of
variances within DEGENERATE_RTOL of each other (`aligned_err`; a group
of one is the sign), which leaves every distance between cells, all
that the later stages read, unchanged; the sign-aligned error is
reported beside it.

t-SNE and UMAP are chaotic at float level (a 1-ulp change of
their start moves the JAX package's own 1000-step t-SNE by half its
extent), so full embeddings are held by quality: each cell's nearest
population centroid in the embedding is its planted population for at
least MIN_CENTROID_ACC of the cells, and the share of each cell's 10
nearest neighbors in PCA space that stay among its 10 nearest in the
embedding is no more than KNN_SLACK below the reference run's.

A kNN result at a size no other package can be run beside is held to
exact float64 neighbours of seeded rows (`sampled_knn_check`): a slot
may differ only at a near-tie, two candidates whose exact squared
distances lie within KNN_TIE_EPS (|x_i|^2 + |x_j|^2) of each other, the
float32 rounding of |x_i|^2 - 2 x_i.x_j + |x_j|^2 (measured ties between
the two packages at 2,000 cells: at most 1.9 eps32 of it,
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

PCA_TOL = 1e-3
DEGENERATE_RTOL = 0.02
VAR_RTOL = 1e-4
VAR_ZERO = 1e-12
MIN_CENTROID_ACC = 0.9
KNN_SLACK = 0.05
KNN_K = 10
# graph-clustering labels at 2,000 cells, where a near-tie in one kNN list
# moves a few cells (tests/test_torch_analysis.py)
NEAR_TIE_AGREEMENT = 0.995
# graph-clustering labels of two devices' whole runs at 2,000 cells: each
# device's float32 PCA rounds the near-degenerate components differently,
# and Louvain moves a small cluster (0.990 measured on an H100 against the
# CPU; permuting the feature order, which changes only the summation
# order, gives 0.9975-1.0 on the CPU)
DEVICE_AGREEMENT = 0.98
# short horizon, as a share of max |y| (tests/test_torch_analysis.py
# states what was measured and why UMAP stops at 2 epochs)
TSNE_TOL = {1: 1e-4, 5: 1e-4, 10: 5e-4}
CALIB_RTOL = 1e-3   # the calibrated P at 2,000 cells (1e-4 up to 1,000)
UMAP_TOL = {1: 1e-4, 2: 1e-3}
KNN_TIE_EPS = 4 * float(np.finfo(np.float32).eps)
# analysis/ files with embeddings, and without past max_cells_tsne
N_FILES = 16
EMBEDDINGS = ("tsne/2_components/projection.csv",
              "umap/2_components/projection.csv")
GRAPH_DERIVED = ("clustering/graphclust/hierarchy.json",
                 "diffexp/graphclust/differential_expression.csv")


def read_table(path: str) -> tuple[list[str], np.ndarray]:
    """A projection/variance CSV -> (first column, float matrix of the
    rest)."""
    with open(path) as f:
        rows = [ln.rstrip("\n").split(",") for ln in f][1:]
    return ([r[0] for r in rows],
            np.asarray([[float(v) for v in r[1:]] for r in rows]))


def sign_aligned_err(ref: np.ndarray, got: np.ndarray) -> float:
    """max |ref - got * sign| / max |ref|, each column's sign aligned."""
    sign = np.where((ref * got).sum(0) < 0, -1.0, 1.0)
    return float(np.abs(ref - got * sign).max() / np.abs(ref).max())


def aligned_err(ref: np.ndarray, got: np.ndarray, var: np.ndarray) -> float:
    """max |ref - got R| / max |ref|, R orthogonal and block-diagonal over
    the groups of consecutive components whose explained variances `var`
    lie within DEGENERATE_RTOL of each other: each block is the rotation
    (orthogonal Procrustes) that brings got's columns of the group
    nearest to ref's, and for a group of one it is the sign."""
    out = np.empty_like(got)
    start = 0
    for i in range(1, len(var) + 1):
        if i < len(var) and var[i] >= (1 - DEGENERATE_RTOL) * var[i - 1]:
            continue
        u, _, vt = np.linalg.svd(got[:, start:i].T @ ref[:, start:i])
        out[:, start:i] = got[:, start:i] @ (u @ vt)
        start = i
    return float(np.abs(ref - out).max() / np.abs(ref).max())


def centroid_accuracy(y: np.ndarray, truth: np.ndarray) -> float:
    """Share of cells whose nearest population centroid (in y) is their
    own population."""
    pops = np.unique(truth)
    c = np.stack([y[truth == q].mean(0) for q in pops])
    near = np.argmin(((y[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    return float((pops[near] == truth).mean())


def knn_preservation(x: np.ndarray, y: np.ndarray, k: int = KNN_K,
                     device="cpu") -> float:
    """Mean share of each row's k nearest neighbors in x that are among
    its k nearest in y (exact kNN on `device`)."""
    from ..analysis.graphclust import knn_graph

    a, _ = knn_graph(torch.as_tensor(x, dtype=torch.float32,
                                     device=device), k)
    b, _ = knn_graph(torch.as_tensor(y, dtype=torch.float32,
                                     device=device), k)
    hit = (a[:, :, None] == b[:, None, :]).any(-1)
    return float(hit.double().mean())


def non_tie_slots(a: np.ndarray, b: np.ndarray, ref, got) -> list:
    """(row, slot) pairs where two kNN results over the same rows of a
    (ref, got: [len(a), k] indices into b) hold neighbours whose exact
    squared distances differ by more than a near-tie."""
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    sa, sb = (a64 ** 2).sum(1), (b64 ** 2).sum(1)
    bad = []
    for i, c in zip(*np.nonzero(np.asarray(ref) != np.asarray(got))):
        r, g = ref[i, c], got[i, c]
        gap = abs(((a64[i] - b64[r]) ** 2).sum()
                  - ((a64[i] - b64[g]) ** 2).sum())
        if not gap <= KNN_TIE_EPS * (sa[i] + max(sb[r], sb[g])):
            bad.append((int(i), int(c)))
    return bad


def sampled_knn_check(a: np.ndarray, b: np.ndarray, idx, rows: int,
                      seed: int = 0, exclude_self: bool = False
                      ) -> tuple[list, dict]:
    """A kNN result idx [len(a), k] (the rows of b nearest each row of a,
    nearest first, lower index first among ties; exclude_self: a is b and
    a row is not its own neighbour) against exact float64 neighbours on
    `rows` seeded rows of a, computed here in numpy.  Returns (the
    (row, slot) pairs that differ by more than a near-tie or hold the row
    itself, measured)."""
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    got = np.asarray(idx)
    k = got.shape[1]
    pick = np.sort(np.random.default_rng(seed).choice(
        len(a64), min(rows, len(a64)), replace=False))
    got = got[pick]
    ref = np.empty_like(got)
    for c0 in range(0, len(pick), 16):   # [16, len(b), d] float64 at once
        p = pick[c0:c0 + 16]
        d = ((a64[p, None, :] - b64[None, :, :]) ** 2).sum(-1)
        if exclude_self:
            d[np.arange(len(p)), p] = np.inf
        kth = np.partition(d, k - 1, axis=1)[:, k - 1]
        for j, row in enumerate(d):
            cand = np.flatnonzero(row <= kth[j])
            ref[c0 + j] = cand[np.argsort(row[cand], kind="stable")][:k]
    bad = [(int(pick[i]), c) for i, c in non_tie_slots(a64[pick], b64,
                                                       ref, got)]
    if exclude_self:
        bad = sorted(set(bad) | {(int(pick[i]), int(c)) for i, c in
                                 zip(*np.nonzero(got == pick[:, None]))})
    return bad, dict(rows=len(pick), k=k,
                     slots_differ=int((ref != got).sum()),
                     non_tie_mismatches=len(bad))


def embedding_rule_diffs(files: list[str], n_cells: int,
                         max_cells_tsne: int) -> list[str]:
    """The JAX package's rule for analysis/: N_FILES files with t-SNE and
    UMAP up to max_cells_tsne cells, none of tsne/ or umap/ past it."""
    want = N_FILES if n_cells <= max_cells_tsne else \
        N_FILES - len(EMBEDDINGS)
    embedded = [f for f in files if f.split("/")[0] in ("tsne", "umap")]
    if len(files) != want or (n_cells > max_cells_tsne and embedded) \
            or (n_cells <= max_cells_tsne
                and not set(EMBEDDINGS) <= set(files)):
        return [f"{n_cells} cells, max_cells_tsne {max_cells_tsne}: "
                f"analysis/ holds {files}"]
    return []


def label_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of cells whose labels agree after the best one-to-one
    matching of a's clusters to b's."""
    from scipy.optimize import linear_sum_assignment

    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    c = np.zeros((len(ua), len(ub)))
    np.add.at(c, (ia, ib), 1)
    r, cc = linear_sum_assignment(-c)
    return float(c[r, cc].sum() / len(a))


def cluster_purity(labels: np.ndarray, truth: np.ndarray) -> float:
    """Share of cells whose cluster's most common truth label is their
    own: 1.0 when every cluster lies within one population, however many
    clusters a population is split into."""
    _, ic = np.unique(labels, return_inverse=True)
    _, it = np.unique(truth, return_inverse=True)
    c = np.zeros((ic.max() + 1, it.max() + 1))
    np.add.at(c, (ic, it), 1)
    return float(c.max(1).sum() / len(labels))


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref|."""
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def short_horizon(proj: np.ndarray, ref_device, device,
                  calib_rtol: float = CALIB_RTOL) -> tuple[list[str], dict]:
    """The t-SNE and UMAP device functions of the port on `device`
    against `ref_device`, from the same inputs: the calibrated P within
    `calib_rtol`, then `_tsne_optimize` and the UMAP `_optimize` from
    run_tsne's and run_umap's starts, both fed `ref_device`'s P, within
    TSNE_TOL and UMAP_TOL of max |y|.  Returns (diffs, measured)."""
    from ..analysis import prng, tsne, umap_tpu
    from ..analysis.graphclust import knn_graph

    diffs, seen = [], {}
    x = torch.from_numpy(np.asarray(proj, np.float32))
    n = len(x)
    p_ref = tsne._calibrated_p(x.to(ref_device))
    p_got = tsne._calibrated_p(x.to(device)).cpu().numpy()
    p_np = p_ref.cpu().numpy()
    seen["calibrated_p_rtol"] = float((np.abs(p_got - p_np) / p_np).max())
    if seen["calibrated_p_rtol"] > calib_rtol:
        diffs.append(f"calibrated P rtol {seen['calibrated_p_rtol']:.3g}")
    y0 = torch.from_numpy(1e-4 * prng.normal(prng.PRNGKey(0), (n, 2)))
    p_dev = torch.from_numpy(p_np).to(device)
    for n_iter, tol in TSNE_TOL.items():
        a = tsne._tsne_optimize(p_ref, y0.to(ref_device), n_iter)
        b = tsne._tsne_optimize(p_dev, y0.to(device), n_iter)
        err = rel_err(a.cpu().numpy(), b.cpu().numpy())
        seen[f"tsne_{n_iter}"] = err
        if err > tol:
            diffs.append(f"t-SNE after {n_iter} steps: {err:.3g} > {tol}")
    idx, d2 = knn_graph(x.to(ref_device), umap_tpu.UMAP_N_NEIGHBORS)
    pu = umap_tpu._fuzzy_graph(idx, np.sqrt(np.maximum(d2.cpu().numpy(), 0)),
                               n)
    yu = umap_tpu._init(pu, 2, 0)
    a_, b_ = umap_tpu._fit_ab(umap_tpu.UMAP_MIN_DIST)
    for n_epochs, tol in UMAP_TOL.items():
        a = umap_tpu._optimize(pu, yu, a_, b_, n_epochs)
        b = umap_tpu._optimize(pu.to(device), yu.to(device), a_, b_,
                               n_epochs)
        err = rel_err(a.cpu().numpy(), b.cpu().numpy())
        seen[f"umap_{n_epochs}"] = err
        if err > tol:
            diffs.append(f"UMAP after {n_epochs} epochs: {err:.3g} > {tol}")
    return diffs, seen


def same_projection_labels(proj: np.ndarray, ref_device, device
                           ) -> tuple[list[str], dict]:
    """k-means (K = 2..10) and graph-clustering labels of one projection
    computed on `ref_device` and on `device`: equal.  Returns (diffs,
    measured: kNN slots that differ, at the graph's k)."""
    from ..analysis.graphclust import (default_knn_k, knn_graph,
                                       run_graph_clustering)
    from ..analysis.kmeans import run_kmeans
    from ..analysis.run import KMEANS_RANGE

    x = torch.from_numpy(np.asarray(proj, np.float32))
    xr, xd = x.to(ref_device), x.to(device)
    diffs = [f"kmeans K={k}" for k in KMEANS_RANGE
             if not np.array_equal(run_kmeans(xr, k)[0],
                                   run_kmeans(xd, k)[0])]
    if not np.array_equal(run_graph_clustering(xr),
                          run_graph_clustering(xd)):
        diffs.append("graphclust")
    k = min(default_knn_k(len(x)), len(x) - 1)
    slots = int((knn_graph(xr, k)[0].cpu() != knn_graph(xd, k)[0].cpu())
                .sum())
    return diffs, {"knn_slots_differ": slots}


def analysis_files(d: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def same_bytes(pa: str, pb: str) -> bool:
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        return fa.read() == fb.read()


def compare_analysis(ref: str, got: str, truth: np.ndarray | None = None,
                     device="cpu", min_label_agreement: float = 1.0
                     ) -> tuple[list[str], dict]:
    """Differences of the analysis/ directory `got` from `ref` under the
    rules above (truth: planted population per barcode, where known);
    returns (diffs, measured numbers)."""
    diffs, seen = [], {}
    files = analysis_files(ref)
    if analysis_files(got) != files:
        return [f"file sets differ: {files} vs {analysis_files(got)}"], seen
    pca = None
    graph_equal = True
    for f in files:
        pa, pb = os.path.join(ref, f), os.path.join(got, f)
        if f.endswith("clusters.csv") and not same_bytes(pa, pb):
            bca, a = read_table(pa)
            bcb, b = read_table(pb)
            agree = label_agreement(a[:, 0], b[:, 0]) if bca == bcb else 0.0
            seen.setdefault("label_agreement", {})[f] = [
                agree, len(np.unique(a)), len(np.unique(b))]
            graph_equal &= "graphclust" not in f
            if agree < min_label_agreement:
                diffs.append(f"{f} differs: agreement {agree:.4f}")
            continue
        if f in GRAPH_DERIVED and not graph_equal:
            # host functions of graph labels that differ (within the
            # agreement accepted above): nothing of the device to compare
            seen.setdefault("not_compared", []).append(f)
            continue
        if f.startswith("pca/") and f.endswith("projection.csv"):
            bca, a = read_table(pa)
            bcb, b = read_table(pb)
            var = read_table(os.path.join(os.path.dirname(pa),
                                          "variance.csv"))[1][:, 0]
            seen["pca_sign_aligned_err"] = sign_aligned_err(a, b)
            err = seen["pca_err"] = aligned_err(a, b, var)
            if bca != bcb or err > PCA_TOL:
                diffs.append(f"{f}: aligned error {err:.3g}")
            pca = a
        elif f.startswith("pca/") and f.endswith("variance.csv"):
            a, b = read_table(pa)[1], read_table(pb)[1]
            # a variance under 1e-12 of the first is the float32 SVD's
            # zero: compared against that floor instead of itself
            floor = VAR_ZERO * np.abs(a).max() if a.size else 0.0
            rel = float((np.abs(b - a) / np.maximum(np.abs(a), floor)).max()
                        if a.size else 0.0)
            seen["var_rtol"] = rel
            if a.shape != b.shape or rel > VAR_RTOL:
                diffs.append(f"{f}: variance rtol {rel:.3g}")
        elif f not in EMBEDDINGS and not same_bytes(pa, pb):
            diffs.append(f"{f} differs")
    for f in EMBEDDINGS:
        if f not in files:
            continue
        bca, a = read_table(os.path.join(ref, f))
        bcb, b = read_table(os.path.join(got, f))
        name = f.split("/")[0]
        if bca != bcb or a.shape != b.shape or not np.isfinite(b).all():
            diffs.append(f"{f}: barcodes, shape or finiteness differ")
            continue
        if truth is not None:
            acc = (centroid_accuracy(a, truth), centroid_accuracy(b, truth))
            seen[f"{name}_centroid_acc"] = acc
            if min(acc) < MIN_CENTROID_ACC:
                diffs.append(f"{f}: centroid accuracy {acc}")
        if pca is not None:
            kp = (knn_preservation(pca, a, device=device),
                  knn_preservation(pca, b, device=device))
            seen[f"{name}_knn_preservation"] = kp
            if kp[1] < kp[0] - KNN_SLACK:
                diffs.append(f"{f}: 10-NN preservation {kp}")
    return diffs, seen
