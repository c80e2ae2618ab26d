"""Chemistry/batch correction via mutual nearest neighbors (port of
cellranger_tpu/analysis/batch_correction.py, the CORRECT_CHEMISTRY_BATCH
analog).

The cross-batch neighbor searches run on the device with `lax.top_k`'s
tie order, a block of rows at a time (graphclust.knn_search); pairing
and the Gaussian-weighted correction vectors are the JAX package's host
code (float64 numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from .graphclust import knn_search


def _cross_knn(a: np.ndarray, b: np.ndarray, k: int, device) -> np.ndarray:
    """indices [len(a), k] of b-rows nearest to each a-row."""
    a_t = torch.from_numpy(np.asarray(a, np.float32)).to(device)
    b_t = torch.from_numpy(np.asarray(b, np.float32)).to(device)
    idx, _ = knn_search(a_t, b_t, min(k, b.shape[0]))
    return idx.cpu().numpy()


def find_mnn_pairs(ref: np.ndarray, target: np.ndarray, k: int = 20, *,
                   device):
    """Mutual nearest neighbor (ref_idx, target_idx) pairs."""
    k = max(1, min(k, len(ref), len(target)))
    t2r = _cross_knn(target, ref, k, device)   # [T, k]
    r2t = _cross_knn(ref, target, k, device)   # [R, k]
    r_sets = [set(row) for row in r2t]
    pairs = []
    for t, row in enumerate(t2r):
        for r in row:
            if t in r_sets[r]:
                pairs.append((int(r), int(t)))
    return pairs


def correct_batches(proj: np.ndarray, batches: np.ndarray, k: int = 20,
                    sigma: float | None = None, *, device) -> np.ndarray:
    """proj [n, d] PCA coordinates, batches [n] labels. Returns corrected
    coordinates; the first (largest) batch anchors the reference."""
    proj = np.asarray(proj, np.float64).copy()
    labels, counts = np.unique(batches, return_counts=True)
    if len(labels) < 2:
        return proj
    order = labels[np.argsort(-counts)]
    ref_mask = batches == order[0]
    if sigma is None:
        sigma = float(np.median(np.linalg.norm(
            proj - proj.mean(0), axis=1))) / 2 + 1e-9
    for b in order[1:]:
        t_mask = batches == b
        # two passes: the first removes the bulk shift so the second pairs
        # cells within their true populations
        for _ in range(2):
            ref_pts = proj[ref_mask]
            t_pts = proj[t_mask]
            pairs = find_mnn_pairs(ref_pts, t_pts, k=k, device=device)
            if not pairs:
                break
            r_idx = np.asarray([p[0] for p in pairs])
            t_idx = np.asarray([p[1] for p in pairs])
            vecs = ref_pts[r_idx] - t_pts[t_idx]      # correction per pair
            anchors = t_pts[t_idx]
            # smooth: Gaussian-weighted vector average per target cell
            d2 = ((t_pts[:, None, :] - anchors[None, :, :]) ** 2).sum(-1)
            w = np.exp(-d2 / (2 * sigma ** 2)) + 1e-12
            corr = (w @ vecs) / w.sum(axis=1, keepdims=True)
            proj[t_mask] = t_pts + corr
        ref_mask = ref_mask | t_mask                   # merged becomes ref
    return proj
