"""Barcode resolution: whitelist membership + posterior Hamming-1
correction (barcode/src/corrector.rs:111-164, the `Posterior` strategy).

Port of cellranger_tpu/ops/barcode.py: `host_resolve_barcodes` (numpy,
copied) resolves cell barcodes before upload; `correct_barcodes` (torch)
corrects feature barcodes, and the V(D)J barcodes, on the device against a
BucketTable whose count column holds the prior (one row gather per
candidate, `membership3`); `whitelist_lookup` and `count_valid_barcodes`
(torch) are the V(D)J pipeline's device membership and pass-1 histogram.
"""

from __future__ import annotations

import torch

from ..constants import (
    BARCODE_CONFIDENCE_THRESHOLD,
    BC_MAX_QV,
    ILLUMINA_QUAL_OFFSET,
)
from .bucket_table import BucketTable
from .lookup import SortedTable


def whitelist_lookup(packed: torch.Tensor, wl):
    """Membership of packed barcodes (u32 values in int64) in the
    whitelist.

    wl: BucketTable (one row gather), SortedTable, or a raw ascending
    tensor of u32 values (binary search).  Returns (is_member bool, index
    int32, -1 on a miss)."""
    if isinstance(wl, (SortedTable, BucketTable)):
        return wl.membership(packed)
    idx = torch.searchsorted(wl, packed)
    idx_c = torch.clamp_max(idx, wl.shape[0] - 1)
    hit = wl[idx_c] == packed
    return hit, torch.where(hit, idx_c, -1).to(torch.int32)


def qual_error_prob(qual: torch.Tensor) -> torch.Tensor:
    """Phred ASCII qual -> float32 error probability, capped at QV 66
    (corrector.rs:8,127,169-173)."""
    q = torch.clamp_max(qual.to(torch.int64), BC_MAX_QV).to(torch.float32)
    return torch.pow(torch.full_like(q, 10.0),
                     -(q - ILLUMINA_QUAL_OFFSET) / 10.0)


def correct_barcodes(packed: torch.Tensor, quals: torch.Tensor,
                     wl: BucketTable, length: int):
    """Posterior 1-Hamming correction of a batch of barcodes.

    packed: u32 values (int64) [B]; quals: uint8 [B, length] phred+33;
    wl: table with its count column filled (`with_counts`).  Returns
    (corrected u32 values [B], corrected idx [B] (-1 unaccepted), accepted
    bool [B]); unaccepted rows keep the input barcode.  Candidates are
    bc ^ (d << 2*(length-1-pos)) for d in 1..3, scored P(err|qual) *
    (count + 1) over members; accepted when best / total >= 0.975; ties
    on likelihood go to the larger packed barcode (corrector.rs:144-148
    max((likelihood, bc)))."""
    B = packed.shape[0]
    dev = packed.device
    shifts = 2 * (length - 1 - torch.arange(length, device=dev))
    d = torch.arange(1, 4, device=dev)
    xor = d[None, :] << shifts[:, None]                   # [L, 3]
    cands = packed[:, None, None] ^ xor[None]             # [B, L, 3]
    is_member, idx, counts = wl.membership3(cands)
    prob_edit = qual_error_prob(quals)                    # [B, L]
    like = torch.where(is_member,
                       prob_edit[:, :, None] * (counts.to(torch.float32)
                                                + 1.0),
                       torch.zeros((), dtype=torch.float32, device=dev))
    flat_like = like.reshape(B, -1)
    flat_cand = cands.reshape(B, -1)
    flat_idx = idx.reshape(B, -1)
    total = flat_like.sum(1)
    at_max = flat_like >= flat_like.amax(1, keepdim=True)
    best_cand_val = torch.where(at_max, flat_cand, 0).amax(1)
    # first column holding the best (likelihood, candidate)
    best_pos = (at_max & (flat_cand == best_cand_val[:, None])) \
        .to(torch.int32).argmax(1)
    take = lambda a: a.gather(1, best_pos[:, None])[:, 0]  # noqa: E731
    best_like = take(flat_like)
    accepted = (total > 0) & (
        best_like / torch.clamp_min(total, 1e-30)
        >= BARCODE_CONFIDENCE_THRESHOLD)
    out_bc = torch.where(accepted, take(flat_cand), packed)
    out_idx = torch.where(accepted, take(flat_idx), -1)
    return out_bc, out_idx, accepted


def host_resolve_barcodes(bc_packed, bc_qual, slot_valid, wl_sorted,
                          wl_counts, length: int):
    """HOST whitelist membership + posterior 1-Hamming correction — the
    numpy twin of `correct_barcodes` (corrector.rs:111-164 Posterior).

    Barcode resolution moved OFF the device in round 3: membership is one
    vectorized searchsorted against the sorted whitelist (~1M reads/s on
    one core), correction touches only the few % invalid reads, and doing
    both before upload removes the barcode-qual plane (16B/read), the
    whitelist HBM table, and the in-step correction capacity (plus its
    overflow retry) from the hot path entirely.  Device batches then carry
    a final `bc_idx` and the step does only alignment/annotation FLOPs.

    Args: bc_packed uint32 [B]; bc_qual uint8 [B, length] phred+33;
    slot_valid bool [B]; wl_sorted uint32 [W] ascending; wl_counts int [W]
    observed-count prior (pass-1 histogram).
    Returns (bc_idx int32 [B] — whitelist rank or -1, hit bool [B] —
    exact member, corrected bool [B], corrected_bc uint32 [B]).
    """
    import numpy as np

    from .encode import sorted_search

    bc_packed = np.asarray(bc_packed, np.uint32)
    B = len(bc_packed)
    W = len(wl_sorted)
    idx = sorted_search(wl_sorted, bc_packed)
    idxc = np.minimum(idx, W - 1)
    hit = (wl_sorted[idxc] == bc_packed) & slot_valid
    bc_idx = np.where(hit, idxc, -1).astype(np.int32)
    corrected = np.zeros(B, bool)
    corr_bc = bc_packed.copy()
    inv = np.flatnonzero(~hit & slot_valid)
    if len(inv):
        pos = np.arange(length, dtype=np.uint32)
        shifts = (2 * (length - 1 - pos)).astype(np.uint32)
        d = np.arange(1, 4, dtype=np.uint32)
        xor = (d[None, :] << shifts[:, None]).reshape(-1)       # [3L]
        cand = bc_packed[inv, None] ^ xor[None, :]              # [I, 3L]
        ci = sorted_search(wl_sorted, cand.ravel()).reshape(cand.shape)
        cic = np.minimum(ci, W - 1)
        member = wl_sorted[cic] == cand
        q = np.minimum(np.asarray(bc_qual)[inv], BC_MAX_QV).astype(np.float32)
        prob = np.power(np.float32(10.0),
                        -(q - ILLUMINA_QUAL_OFFSET) / np.float32(10.0))
        prob3 = np.repeat(prob, 3, axis=1)                      # [I, 3L]
        cnts = np.where(member, np.asarray(wl_counts, np.float32)[cic], 0.0)
        like = np.where(member, prob3 * (cnts + np.float32(1.0)),
                        np.float32(0.0))
        total = like.sum(axis=1, dtype=np.float32)
        max_like = like.max(axis=1, keepdims=True)
        at_max = like >= max_like
        # ties on likelihood resolve to the larger packed barcode
        # (corrector.rs:144-148 max((likelihood, bc)))
        best_cand = np.max(np.where(at_max, cand, np.uint32(0)), axis=1)
        sel = at_max & (cand == best_cand[:, None])
        best_col = np.argmax(sel, axis=1)
        take = lambda a: a[np.arange(len(inv)), best_col]
        best_like = take(like)
        accepted = (total > 0) & (
            best_like / np.maximum(total, np.float32(1e-30))
            >= BARCODE_CONFIDENCE_THRESHOLD)
        rows = inv[accepted]
        corrected[rows] = True
        corr_bc[rows] = best_cand[accepted]
        bc_idx[rows] = take(cic)[accepted].astype(np.int32)
    return bc_idx, hit, corrected, corr_bc


def count_valid_barcodes(idx: torch.Tensor, valid: torch.Tensor,
                         wl_size: int) -> torch.Tensor:
    """Histogram of the whitelist indices of valid reads -> int32 [W] (the
    prior counts of correction, corrector.rs:14-16); a miss (idx -1) adds
    0 at index 0."""
    contrib = torch.where(idx >= 0, valid.to(torch.int32), 0)
    out = torch.zeros(wl_size, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, torch.clamp_min(idx, 0).to(torch.int64),
                          contrib.to(torch.int32))
