"""Secondary analysis orchestrator (port of cellranger_tpu/analysis/run.py,
the SC_RNA_ANALYZER analog): PCA -> k-means K=2..10 + graph clustering
-> hierarchical clustering and differential expression -> t-SNE + UMAP,
written in the reference's analysis/ layout with the JAX package's CSV
formatting.

The standardized dense matrix is uploaded once; the PCA projection stays
on the device through k-means, the kNN graphs, t-SNE and UMAP, and comes
to the host only for the CSVs and for Louvain.  Preprocessing, hierarchical
clustering and differential expression are verbatim copies of the JAX
package's jax-free host modules.  `results["stage_s"]` holds each stage's wall seconds, the
device synchronized at each stage's end.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..io.matrix_io import CountMatrix
from . import diffexp as de
from .graphclust import run_graph_clustering
from .hclust import run_hierarchical_clustering
from .kmeans import run_kmeans
from .pca import N_COMPONENTS_DEFAULT, run_pca
from .preprocess import log_normalize_dense, select_features
from .tsne import run_tsne
from .umap_tpu import run_umap

KMEANS_RANGE = range(2, 11)  # reference: K=2..10
MAX_CELLS_TSNE = 20000       # the JAX package's: no embeddings past it


def _write_csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")


class _Stages:
    """Wall seconds per stage, each ending with a device synchronize."""

    def __init__(self, device: torch.device):
        self.device = device
        self.s: dict[str, float] = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + (t - self.t)
        self.t = t


def run_secondary_analysis(matrix: CountMatrix, out_dir: str,
                           n_components: int = N_COMPONENTS_DEFAULT,
                           max_cells_tsne: int = MAX_CELLS_TSNE,
                           skip_embeddings: bool = False,
                           num_features: int = 2000,
                           batch_labels=None, *, device) -> dict:
    """Filtered matrix -> analysis/ outputs; returns in-memory results
    (numpy, as the JAX package's) and `stage_s`."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    bcs = [b.decode() for b in matrix.barcodes]
    n_cells = len(bcs)
    results: dict = {}
    if n_cells < 2:
        return results
    st = _Stages(device)

    features = select_features(matrix.m, num_features)
    if len(features) == 0:
        return results
    x = torch.from_numpy(log_normalize_dense(matrix.m, features)).to(device)
    st.lap("preprocess")
    pca = run_pca(x, n_components=min(n_components,
                                      max(1, min(x.shape) - 1)))
    del x
    proj_dev = pca.pop("proj_dev")
    proj = pca["transformed_pca_matrix"]
    if batch_labels is not None and len(set(batch_labels)) > 1:
        # CORRECT_CHEMISTRY_BATCH analog: MNN alignment of batches in PCA
        # space before clustering/embedding
        from .batch_correction import correct_batches
        proj = correct_batches(proj, np.asarray(batch_labels), device=device)
        pca["transformed_pca_matrix"] = proj
        proj_dev = torch.from_numpy(proj.astype(np.float32)).to(device)
        results["batch_corrected"] = True
    results["pca"] = pca
    st.lap("pca")
    k_str = f"{proj.shape[1]}_components"
    _write_csv(os.path.join(out_dir, "pca", k_str, "projection.csv"),
               ["Barcode"] + [f"PC-{i+1}" for i in range(proj.shape[1])],
               [[bcs[i]] + list(np.round(proj[i], 6)) for i in range(n_cells)])
    _write_csv(os.path.join(out_dir, "pca", k_str, "variance.csv"),
               ["PC", "Variance.Explained"],
               [[i + 1, v] for i, v in enumerate(pca["variance_explained"])])
    st.lap("write_csv")

    # clustering
    clusterings = {}
    for k in KMEANS_RANGE:
        if k >= n_cells:
            break
        labels, _, _ = run_kmeans(proj_dev, k)
        key = f"kmeans_{k}_clusters"
        clusterings[key] = labels
        _write_csv(os.path.join(out_dir, "clustering", key, "clusters.csv"),
                   ["Barcode", "Cluster"],
                   [[bcs[i], int(labels[i])] for i in range(n_cells)])
    st.lap("kmeans")
    glabels = run_graph_clustering(proj_dev)
    clusterings["graphclust"] = glabels
    _write_csv(os.path.join(out_dir, "clustering", "graphclust", "clusters.csv"),
               ["Barcode", "Cluster"],
               [[bcs[i], int(glabels[i])] for i in range(n_cells)])
    results["clusterings"] = clusterings
    st.lap("graphclust")

    # hierarchical clustering of the graph clusters
    hc = run_hierarchical_clustering(matrix.m, glabels)
    results["hclust"] = hc
    with open(os.path.join(out_dir, "clustering", "graphclust",
                           "hierarchy.json"), "w") as f:
        json.dump(hc, f)
    st.lap("hclust")

    # differential expression per clustering
    results["diffexp"] = {}
    for key in ("graphclust",):
        d = de.run_differential_expression(matrix.m, clusterings[key])
        results["diffexp"][key] = d
        ids = matrix.features.ids
        names = [f.name for f in matrix.features.feature_defs]
        header = ["Feature ID", "Feature Name"]
        for c in sorted(d):
            header += [f"Cluster {c} Mean Counts", f"Cluster {c} Log2 fold change",
                       f"Cluster {c} Adjusted p value"]
        rows = []
        for g in range(len(ids)):
            row = [ids[g], names[g]]
            for c in sorted(d):
                r = d[c]
                row += [round(r["norm_mean_a"][g], 6),
                        round(r["log2_fold_change"][g], 6),
                        r["adjusted_p_value"][g]]
            rows.append(row)
        _write_csv(os.path.join(out_dir, "diffexp", key,
                                "differential_expression.csv"), header, rows)
    st.lap("diffexp")

    # embeddings
    if not skip_embeddings and n_cells <= max_cells_tsne:
        ts = run_tsne(proj_dev)
        results["tsne"] = ts
        st.lap("tsne")
        _write_csv(os.path.join(out_dir, "tsne", "2_components", "projection.csv"),
                   ["Barcode", "TSNE-1", "TSNE-2"],
                   [[bcs[i], round(ts[i, 0], 6), round(ts[i, 1], 6)]
                    for i in range(n_cells)])
        st.lap("write_csv")
        um = run_umap(proj_dev)
        results["umap"] = um
        st.lap("umap")
        _write_csv(os.path.join(out_dir, "umap", "2_components", "projection.csv"),
                   ["Barcode", "UMAP-1", "UMAP-2"],
                   [[bcs[i], round(um[i, 0], 6), round(um[i, 1], 6)]
                    for i in range(n_cells)])
        st.lap("write_csv")
    results["stage_s"] = st.s
    return results
