"""Graph clustering: kNN graph on the device + host Louvain (port of
cellranger_tpu/analysis/graphclust.py, the RUN_GRAPH_CLUSTERING_NG
analog).

`knn_graph` keeps `lax.top_k`'s order: nearest first, and among equal
distances the lower index first (identical cells give exact ties).  It is
a stable ascending sort of each distance row; `torch.topk` promises no
order among ties.  `default_knn_k`, `louvain` and the label ordering are
copies of the JAX package's host code, whose module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


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


def knn_graph(x: torch.Tensor, k: int):
    """x [n, d] -> (indices int64 [n, k], squared dists [n, k]) excluding
    self, on x's device."""
    d2 = sq_dists(x, x)
    d2.fill_diagonal_(float("inf"))
    return nearest(d2, k)


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
