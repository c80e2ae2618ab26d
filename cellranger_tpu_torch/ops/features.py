"""Device feature-barcode extraction + matching (the FeatureExtractor
analog, cr_types/src/reference/feature_extraction.rs, as batched tensor
ops).

Port of cellranger_tpu/ops/features.py.  Anchored patterns slice at a
fixed offset; unanchored patterns locate their fixed prefix with a rolling
compare (first match wins, as the reference's leftmost regex match does).
Matching is one BucketTable row gather over the pattern's packed
sequences, with posterior 1-Hamming correction from the count column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.feature_ref import CompiledPattern
from . import barcode as bcops
from .bucket_table import BucketTable
from .tensor_ops import U32_MASK


def make_feature_extractor(pattern: CompiledPattern, table: BucketTable,
                           feature_index: np.ndarray, read_len: int):
    """table: BucketTable (fields=3, counts filled).  Returns
    extract(rna uint8 [B, L], nmask bool [B, L], rna_len [B]) -> dict of
    [B] tensors: feature (-1 none), found, corrected, seq_idx (-1 none),
    offset (barcode start or -1), raw_packed, extracted (barcode bases
    read)."""
    bc_len = pattern.bc_len
    pre = np.asarray(pattern.prefix_codes, np.int32)
    suf = np.asarray(pattern.suffix_codes, np.int32)
    dev = table.rows.device
    fidx = torch.from_numpy(np.asarray(feature_index, np.int64)).to(dev)
    fixed_mask = pre != 255
    pre_fixed = np.where(fixed_mask, pre, 0).astype(np.uint8)
    P = len(pre)

    def find_offset(rna, nmask, rna_len):
        """[B] barcode start offset (or -1)."""
        B, L = rna.shape
        if pattern.anchor3p:
            off = rna_len - len(suf) - bc_len
            return torch.where(off >= P, off, -1)
        if pattern.anchor5p or not fixed_mask.any():
            return torch.full((B,), P, dtype=torch.int64, device=rna.device)
        # rolling anchor search for the fixed prefix
        n = L - P + 1
        ok = torch.ones((B, n), dtype=torch.bool, device=rna.device)
        for i in range(P):
            if fixed_mask[i]:
                ok = ok & (rna[:, i:i + n] == int(pre_fixed[i])) \
                    & nmask[:, i:i + n]
        # argmax over an int cast returns the FIRST hit, as jnp.argmax does
        first = ok.to(torch.int32).argmax(1)
        return torch.where(ok.any(1), first + P, -1)

    def extract(rna, nmask, rna_len):
        B, L = rna.shape
        rna_len = rna_len.to(torch.int64)
        off = find_offset(rna, nmask, rna_len)
        off_ok = (off >= 0) & (off + bc_len <= rna_len)
        offc = torch.clamp(off, 0, max(L - bc_len, 0))
        li = offc[:, None] + torch.arange(bc_len, device=rna.device)[None, :]
        bc_codes = rna.gather(1, li)
        bc_ok = nmask.gather(1, li).all(1) & off_ok
        # verify fixed prefix bases for anchored patterns
        if (pattern.anchor5p or pattern.anchor3p) and fixed_mask.any():
            pli = (offc - P)[:, None] + torch.arange(P, device=rna.device)
            pc = rna.gather(1, torch.clamp(pli, 0, L - 1))
            for i in np.flatnonzero(fixed_mask):
                bc_ok = bc_ok & (pc[:, i] == int(pre_fixed[i]))
        # packed inline as the JAX extractor's uint32 word: past 16 bases
        # the high bits fall off, so a longer feature barcode is matched on
        # its last 16 bases, as in the reference
        packed = torch.zeros((B,), dtype=torch.int64, device=rna.device)
        for i in range(bc_len):
            packed = ((packed << 2) | bc_codes[:, i].to(torch.int64)) \
                & U32_MASK
        hit, idx = table.membership(packed)
        _corr_bc, corr_idx, corrected = bcops.correct_barcodes(
            packed, torch.full((B, bc_len), 70, dtype=torch.uint8,
                               device=rna.device), table, bc_len)
        use_idx = torch.where(hit, idx, torch.where(corrected, corr_idx, -1))
        found = bc_ok & (use_idx >= 0)
        feature = torch.where(found, fidx[torch.clamp_min(use_idx, 0).long()],
                              -1)
        return dict(feature=feature, found=found,
                    corrected=corrected & ~hit & bc_ok,
                    seq_idx=torch.where(found, use_idx, -1),
                    # BAM fr/fq tags: where the feature barcode sits in the
                    # read (read.rs:1335-1352 FeatureExtracted tags)
                    offset=off, raw_packed=packed, extracted=bc_ok)

    return extract
