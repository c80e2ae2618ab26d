"""Graph clustering: kNN graph on the device + host Louvain (port of
cellranger_tpu/analysis/graphclust.py, the RUN_GRAPH_CLUSTERING_NG
analog).

`knn_graph` keeps `lax.top_k`'s order: nearest first, and among equal
distances the lower index first (identical cells give exact ties).  It is
a stable ascending sort of each distance row; `torch.topk` promises no
order among ties.  The search goes a block of rows at a time
(`knn_search`), so no [n, n] plane is ever held: the block's rows come
from the byte budget KNN_BLOCK_BYTES.  `default_knn_k`, `louvain` and the
label ordering are copies of the JAX package's host code, whose module
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

# Bytes of the device that one row of a kNN block keeps alive, per
# candidate (column of b).  sq_dists' expression holds two float32 planes
# (the matmul and the difference it feeds: 8); then the distances (4)
# stay while the stable sort returns float32 values and int64 indices
# (12) from an int64 iota of the columns (8) and keeps a second buffer of
# keys and values for its radix passes (12): 36, rounded up.
KNN_BYTES_PER_PAIR = 40
# The block's budget: 1,565 rows of a 68,579-cell search, 5,368 of a
# 20,000-cell one; the standardized matrix of the PCA is gone by then.
KNN_BLOCK_BYTES = 4 << 30


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, m] squared distances as the JAX package writes them,
    |a|^2 - 2 a.b + |b|^2: where the arithmetic is exact (integer data,
    one component) ties fall as they do there.  Elsewhere the matmul
    rounds by its BLAS, so two candidates within float32 rounding of each
    other may order differently than in the JAX package or on another
    device."""
    return ((a ** 2).sum(1)[:, None] - 2 * a @ b.T
            + (b ** 2).sum(1)[None, :])


def nearest(d2: torch.Tensor, k: int):
    """(indices int64 [n, k], d2 [n, k]) of each row's k smallest entries
    in lax.top_k(-d2, k)'s order."""
    order = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return order, torch.gather(d2, 1, order)


def knn_block_rows(m: int) -> int:
    """Rows of a block whose search against m candidates stays within
    KNN_BLOCK_BYTES (read at call time); raises when one row does not
    fit."""
    per_row = max(1, m) * KNN_BYTES_PER_PAIR
    if per_row > KNN_BLOCK_BYTES:
        raise ValueError(f"one kNN row of {m} candidates needs {per_row} "
                         f"bytes, over the budget of {KNN_BLOCK_BYTES}")
    return KNN_BLOCK_BYTES // per_row


def knn_search(a: torch.Tensor, b: torch.Tensor, k: int,
               exclude_self: bool = False):
    """(indices int64 [len(a), k], squared dists [len(a), k]) of the k
    rows of b nearest each row of a, in nearest()'s order, on a's device,
    a block of knn_block_rows(len(b)) rows of a at a time.  exclude_self:
    a is b, and each row's own distance is +inf."""
    n, rows = a.shape[0], knn_block_rows(b.shape[0])
    idx = torch.empty((n, k), dtype=torch.int64, device=a.device)
    d = torch.empty((n, k), dtype=a.dtype, device=a.device)
    for r0 in range(0, n, rows):
        d2 = sq_dists(a[r0:r0 + rows], b)
        if exclude_self:
            r = torch.arange(d2.shape[0], device=a.device)
            d2[r, r + r0] = float("inf")
        idx[r0:r0 + rows], d[r0:r0 + rows] = nearest(d2, k)
        del d2   # before the next block's planes are made
    return idx, d


def knn_graph(x: torch.Tensor, k: int):
    """x [n, d] -> (indices int64 [n, k], squared dists [n, k]) excluding
    self, on x's device."""
    return knn_search(x, x, k, exclude_self=True)


def default_knn_k(n: int) -> int:
    """The reference uses ceil(sqrt(n)/2) neighbors by default
    (cr_ana graph_clustering / python graphclust compute_nearest_neighbors)."""
    return max(2, int(np.ceil(np.sqrt(n) / 2)))


def louvain(edges_src, edges_dst, weights, n_nodes: int, seed: int = 0,
            max_levels: int = 10, max_sweeps: int = 50):
    """Louvain modularity clustering; returns int labels [n_nodes].

    Standard two-phase algorithm (Blondel et al. 2008): local move sweeps to
    a fixpoint, then graph aggregation, repeated while modularity improves.
    Deterministic given the seed (node visitation order is a seeded
    permutation per sweep).
    """
    rng = np.random.RandomState(seed)
    # symmetrize
    src = np.concatenate([edges_src, edges_dst])
    dst = np.concatenate([edges_dst, edges_src])
    w = np.concatenate([weights, weights]).astype(np.float64)

    node_map = np.arange(n_nodes)

    for _level in range(max_levels):
        n = int(node_map.max()) + 1 if len(node_map) else 0
        # adjacency in CSR-ish form
        order = np.argsort(src, kind="stable")
        s, d, ww = src[order], dst[order], w[order]
        starts = np.searchsorted(s, np.arange(n + 1))
        degree = np.bincount(s, weights=ww, minlength=n)
        total_w = ww.sum() / 2.0
        if total_w <= 0:
            break
        comm = np.arange(n)
        comm_deg = degree.copy()

        improved_any = False
        for _sweep in range(max_sweeps):
            moved = 0
            for u in rng.permutation(n):
                cu = comm[u]
                lo, hi = starts[u], starts[u + 1]
                nbr_c = comm[d[lo:hi]]
                nbr_w = ww[lo:hi]
                # weight from u to each neighboring community
                uniq, inv = np.unique(nbr_c, return_inverse=True)
                w_to = np.bincount(inv, weights=nbr_w)
                ku = degree[u]
                comm_deg[cu] -= ku
                # self-links to own community (excluding u itself)
                base = 0.0
                gains = w_to - ku * comm_deg[uniq] / (2 * total_w)
                if cu in uniq:
                    base = gains[np.searchsorted(uniq, cu)]
                best = int(np.argmax(gains))
                if gains[best] > base + 1e-12 and uniq[best] != cu:
                    comm[u] = uniq[best]
                    comm_deg[uniq[best]] += ku
                    moved += 1
                else:
                    comm_deg[cu] += ku
            if moved == 0:
                break
            improved_any = True
        # relabel communities compactly
        uniq, comm = np.unique(comm, return_inverse=True)
        node_map = comm[node_map]
        if not improved_any or len(uniq) == n:
            break
        # aggregate graph
        src = comm[src]
        dst = comm[dst]
        agg = {}
        for a, b, x in zip(src, dst, w):
            agg[(a, b)] = agg.get((a, b), 0.0) + x
        src = np.fromiter((k1 for k1, _ in agg), int, len(agg))
        dst = np.fromiter((k2 for _, k2 in agg), int, len(agg))
        w = np.fromiter(agg.values(), float, len(agg))
    return node_map


def run_graph_clustering(proj: torch.Tensor, k: int | None = None,
                         seed: int = 0) -> np.ndarray:
    """PCA projection (on the device) -> 1-based cluster labels via kNN +
    Louvain."""
    n = proj.shape[0]
    if n < 3:
        return np.ones(n, int)
    k = k or min(default_knn_k(n), n - 1)
    idx, _ = knn_graph(proj.to(torch.float32), k)
    idx = idx.cpu().numpy()
    src = np.repeat(np.arange(n), k)
    dst = idx.ravel()
    # shared-neighbor weighting: unweighted kNN edges (the reference's NN
    # graph is unweighted, graph_clustering.rs builds a binary adjacency)
    wts = np.ones(len(src))
    labels = louvain(src, dst, wts, n, seed=seed)
    # order clusters by size (largest first), 1-based — matches reference
    # output convention
    uniq, counts = np.unique(labels, return_counts=True)
    order = uniq[np.argsort(-counts)]
    remap = {c: i + 1 for i, c in enumerate(order)}
    return np.asarray([remap[c] for c in labels])
