"""Device RTL probe alignment — the Hurtle analog
(cr_types/src/probe_set.rs:300 align_probe_read), batched:

  * each read half (lhs = probe_len/2 bases, rhs after the odd-middle skip)
    packs into a (hi, lo) u32 pair and binary-searches the sorted
    half-sequence tables; exact misses retry all 3*half_len 1-Hamming
    mutants (XOR trick), rejecting ambiguous (>1 distinct) mutant hits —
    probe_set.rs:254-296 align_half_read;
  * both halves hit: confident when they agree on a probe (identical-seq
    duplicates resolve to the lexicographically minimal probe id);
  * one half hit: the other half rescues by hamming the read bases against
    that probe's stored half sequence, requiring positive score and total
    >= transcriptome_min_score — probe_set.rs:358-421.

Gapped (indel) probe reads are NOT rescued here (the reference also treats
them as half matches).

Port of cellranger_tpu/ops/probes.py: plain tensor ops there (no Pallas
kernel), plain torch here.  u32 values ride in int64; the mutant order
(position-major, XOR 1, 2, 3) and the table order of
`ProbeSet.half_tables()` decide ties and are kept.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.probe_set import ProbeSet
from ..ops import encode
from .dedup import lex3_search
from .tensor_ops import U32_MASK

# the aligner's outputs, in the column order `stack_outputs` packs them
PROBE_OUT_FIELDS = ("probe", "gene", "conf_mapped", "score", "mapped")


def _pack_half(codes: torch.Tensor, length: int):
    """codes [B, length] -> (hi, lo) u32 values in int64, MSB-first, hi =
    first 16 bases."""
    hi_len = min(length, 16)
    c = codes.to(torch.int64)
    hi = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for i in range(hi_len):
        hi = ((hi << 2) | c[..., i]) & U32_MASK
    lo = torch.zeros_like(hi)
    for i in range(hi_len, length):
        lo = ((lo << 2) | c[..., i]) & U32_MASK
    return hi, lo


def make_probe_aligner(ps: ProbeSet, read_len: int, device,
                       min_score: int | None = None):
    """Build the probe alignment on `device`: align(rna uint8 [B, L],
    nmask bool [B, L]) -> dict(probe, gene, conf_mapped, score, mapped) of
    [B] tensors."""
    (lhs_hi, lhs_lo, lhs_idx), (rhs_hi, rhs_lo, rhs_idx), half, rhs_start = \
        ps.half_tables()
    plen = ps.probe_len
    if read_len < plen:
        raise ValueError(f"read_len {read_len} is shorter than the "
                         f"{plen}bp probes")
    if min_score is None:
        min_score = int(ps.metadata.get("transcriptome_min_score", 30))
    device = torch.device(device)
    hi_len = min(half, 16)
    rhs_len = plen - rhs_start
    rhs_hi_len = min(rhs_len, 16)

    def dev64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    # probe half sequences as dense code arrays for rescue hamming
    seq_codes = np.stack([encode.encode_str(s)[0] for s in ps.sequences])
    lhs_codes_d = torch.from_numpy(
        np.ascontiguousarray(seq_codes[:, :half])).to(device)
    rhs_codes_d = torch.from_numpy(
        np.ascontiguousarray(seq_codes[:, rhs_start:])).to(device)
    gene_of_probe = dev64(ps.probe_gene_idx)
    included = torch.from_numpy(np.asarray(ps.included, bool)).to(device)

    def mutant_masks(length: int, h_len: int):
        """XOR masks (hi, lo) of every 1-Hamming mutant, position-major."""
        l_len = length - h_len
        xh, xl = [], []
        for pos in range(length):
            for d in (1, 2, 3):
                if pos < h_len:
                    xh.append(d << (2 * (h_len - 1 - pos)))
                    xl.append(0)
                else:
                    xh.append(0)
                    xl.append(d << (2 * (l_len - 1 - (pos - h_len))))
        return dev64(xh), dev64(xl)

    tables = dict(
        lhs=(dev64(lhs_hi), dev64(lhs_lo), dev64(lhs_idx))
        + mutant_masks(half, hi_len),
        rhs=(dev64(rhs_hi), dev64(rhs_lo), dev64(rhs_idx))
        + mutant_masks(rhs_len, rhs_hi_len),
    )

    def half_lookup(codes, which, length):
        """codes [B, length] -> (probe (-1 none/ambiguous), score)."""
        his, los, pidx, xh, xl = tables[which]
        zk = torch.zeros_like(his)
        hi, lo = _pack_half(codes, length)
        idx, found = lex3_search(his, los, zk, hi, lo, torch.zeros_like(hi))
        # exact hit: the table is sorted by (hi, lo, original order), so the
        # leftmost equal row is the smallest probe index among duplicates
        exact_probe = torch.where(found, pidx[idx], -1)
        # 1-Hamming mutants on the hi and lo words
        mhi = hi[:, None] ^ xh[None, :]                   # [B, M]
        mlo = lo[:, None] ^ xl[None, :]
        midx, mfound = lex3_search(his, los, zk, mhi, mlo,
                                   torch.zeros_like(mhi))
        mprobe = torch.where(mfound, pidx[midx], -1)
        n_hits = mfound.sum(1)
        first = mfound & (torch.cumsum(mfound.to(torch.int64), 1) == 1)
        first_probe = torch.where(first, mprobe, -1).amax(1)
        mut_probe = torch.where(n_hits == 1, first_probe, -1)

        probe = torch.where(found, exact_probe, mut_probe)
        score = torch.where(found, length,
                            torch.where(mut_probe >= 0, length - 2, 0))
        return probe, score

    def rescue(read_half, probe, mapped_score, probe_codes, length):
        """Hamming the unmapped read half vs the mapped probe's half."""
        pc = probe_codes[torch.clamp_min(probe, 0)]
        mm = (read_half != pc).sum(1)
        score = length - 2 * mm
        ok = (probe >= 0) & (score > 0) & (mapped_score + score >= min_score)
        return ok, score

    def align(rna, nmask):
        lhs = rna[:, :half]
        rhs = rna[:, rhs_start:rhs_start + rhs_len]
        lhs_ok = nmask[:, :half].all(1)
        rhs_ok = nmask[:, rhs_start:rhs_start + rhs_len].all(1)

        lp, ls = half_lookup(lhs, "lhs", half)
        rp, rs = half_lookup(rhs, "rhs", rhs_len)
        lp = torch.where(lhs_ok, lp, -1)
        rp = torch.where(rhs_ok, rp, -1)

        both = (lp >= 0) & (rp >= 0)
        agree = both & (lp == rp)
        # both halves mapped to different probes: not confident
        l_only = (lp >= 0) & (rp < 0)
        r_only = (rp >= 0) & (lp < 0)
        l_rescue_ok, l_rescue_score = rescue(lhs, rp, rs, lhs_codes_d, half)
        r_rescue_ok, r_rescue_score = rescue(rhs, lp, ls, rhs_codes_d,
                                             rhs_len)

        probe = torch.where(
            agree, lp, torch.where(l_only & r_rescue_ok, lp,
                                   torch.where(r_only & l_rescue_ok, rp, -1)))
        score = torch.where(
            agree, ls + rs,
            torch.where(l_only & r_rescue_ok, ls + r_rescue_score,
                        torch.where(r_only & l_rescue_ok,
                                    rs + l_rescue_score, 0)))
        probe_c = torch.clamp_min(probe, 0)
        conf = (probe >= 0) & (score >= min_score) & included[probe_c]
        gene = torch.where(conf, gene_of_probe[probe_c], -1)
        return dict(probe=probe, gene=gene, conf_mapped=conf,
                    score=score, mapped=probe >= 0)

    return align


def stack_outputs(pa: dict) -> torch.Tensor:
    """The aligner's five outputs as one [B, 5] int32 tensor (one device
    -> host transfer per batch); columns are PROBE_OUT_FIELDS."""
    return torch.stack([pa[k].to(torch.int32) for k in PROBE_OUT_FIELDS], 1)


def unstack_outputs(arr: np.ndarray) -> dict:
    """Host [B, 5] array of `stack_outputs` -> named arrays (flags bool)."""
    out = {k: arr[:, j] for j, k in enumerate(PROBE_OUT_FIELDS)}
    for k in ("conf_mapped", "mapped"):
        out[k] = out[k].astype(bool)
    return out
