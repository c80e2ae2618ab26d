"""Hierarchical clustering of graph clusters
(RUN_HIERARCHICAL_CLUSTERING analog, cr_ana/stages/hierarchical_clustering.rs):
average-linkage agglomeration over per-cluster mean log-normalized
expression, producing the dendrogram/ordering the web summary uses to
arrange cluster heatmaps.

Verbatim copy of cellranger_tpu/analysis/hclust.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch
import scipy.sparse as sp

from .preprocess import normalize_by_umi


def cluster_mean_profiles(matrix: sp.spmatrix, clusters: np.ndarray):
    """feature x cell counts + 1-based labels -> (cluster ids, [k, F] means
    of log2(1+median-normalized) expression)."""
    mn = normalize_by_umi(matrix)
    mn.data = np.log2(1 + mn.data)
    ids = np.unique(clusters)
    means = np.zeros((len(ids), matrix.shape[0]))
    for i, c in enumerate(ids):
        cols = np.flatnonzero(clusters == c)
        means[i] = np.asarray(mn[:, cols].mean(axis=1)).ravel()
    return ids, means


def run_hierarchical_clustering(matrix: sp.spmatrix, clusters: np.ndarray):
    """Returns dict(linkage [k-1,4], order: dendrogram leaf order of cluster
    ids, ids)."""
    ids, means = cluster_mean_profiles(matrix, clusters)
    if len(ids) < 2:
        return dict(ids=ids.tolist(), order=ids.tolist(), linkage=[])
    z = sch.linkage(means, method="average", metric="euclidean")
    order = sch.leaves_list(z)
    return dict(ids=ids.tolist(), order=[int(ids[i]) for i in order],
                linkage=z.tolist())
