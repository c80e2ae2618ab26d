"""Device seed-and-extend aligner (batched, fixed-shape, eager torch).

Port of cellranger_tpu/align/aligner.py `make_aligner` and `DeviceIndex`
(the replacement for the reference's STAR alignment,
cr_lib/src/aligner.rs:396-422).  Stages, each equal to the JAX
package's on the same inputs:

  1. rolling 2-bit k-mers at static seed offsets (or winnowed minimizer
     picks), canonicalized so one bucket-row lookup serves both strands;
  2. k-mer lookup in the bucket table (up to E=8 positions per seed);
  3. diagonal voting by pairwise equality counting + first-occurrence
     dedup; the top-D candidates (ties to the lower index) go on;
  4. ungapped extension against genome windows cut from packed text rows,
     scored with Kadane max-substring via prefix scans;
  5. distinct-locus counting -> STAR MAPQ (255 / 3 / 1 / 0);
  6. novel splice junction split scoring over candidate pairs;
  7. banded Smith-Waterman rescue of the low-score subset (the CUDA kernel
     of align/sw.py on the card).

u32 quantities are int64 tensors holding values in [0, 2**32) and are
re-wrapped with U32_MASK wherever uint32 arithmetic would wrap; device
tables keep their u32 bits in int32 tensors.  The rare-work stages
compact their subset to a static capacity (compact_indices) and scatter
back with a dropped fill index, as the JAX package does, so the step
makes no host round trip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DEFAULT_ALIGN_SCORE_MIN
from ..ops.bucket_table import BucketTable
from ..ops.encode import revcomp_packed
from ..ops.tensor_ops import (U32_MASK, U32_MAX, compact_indices,
                              scatter_drop, u32_table, widen)
from .index import (GenomeIndex, MINIMIZER_HASH, overlap_rows_torch,
                    pack_text_rows_torch)

# Tunables, as in the JAX package (align_and_count.rs:63 for the floor).
SEED_STRIDE = 10       # extract a seed every N bases of the read
MAX_HITS_PER_SEED = 8  # bucket-row width = max hits surfaced per seed
MAX_CANDIDATES = 3     # diagonals taken to extension, pooled across strands
RESCUE_CAP_FRAC = 4    # SW rescue capacity = B // RESCUE_CAP_FRAC
RESCUE_MARGIN = 4      # rescue when ungapped score < valid_len - margin

# Novel splice junction discovery (STAR defaults: alignIntronMin=21, ...)
SJ_MIN_INTRON = 21
SJ_MAX_INTRON = 500_000
SJ_MIN_SEG = 12
SJ_MARGIN = 4
SJ_NONCANON_PEN = 8

# texts above this size skip the overlapped window-row table (the JAX
# package's default; the site parameter overlap_rows_max_text overrides)
OVERLAP_ROWS_MAX_TEXT = 3_400_000_000
OV_RW = 14  # overlapped-row words: covers 128-stride + <=96-base windows

BIG = 2**31 - 1


@dataclass(frozen=True)
class DeviceIndex:
    """GenomeIndex tables on one device (u32 tables as int32 bit-views)."""

    text_rows: torch.Tensor          # [NR+2, 32] code words | valid words
    kmer_table: BucketTable          # canonical kmer -> packed pos/strand
    chrom_starts: torch.Tensor       # int64 [C+1]
    sj_rows: torch.Tensor            # [J, 2] (donor_abs, acceptor_abs)
    text_rows_ov: torch.Tensor | None = None  # [R, 28] overlapped rows
    genome_len: int = 0
    text_len: int = 0
    sj_overhang: int = 120
    k: int = 16
    pos_mode: str = "strand31"
    sampling: str = "every"
    minimizer_w: int = 0

    @staticmethod
    def host_arrays(gi: GenomeIndex):
        """(arrays, meta): the numpy tables and static fields a DeviceIndex
        is made of, built from a GenomeIndex exactly as the JAX package
        builds its DeviceIndex."""
        assert len(gi.text) < 2**32, "u32 position space: text must be <4Gb"
        from ..params import get as _param
        ov_max = int(_param("overlap_rows_max_text")
                     or OVERLAP_ROWS_MAX_TEXT)
        rows, bits = BucketTable.build_rows(gi.kmer_keys, gi.kmer_pos,
                                            entries=MAX_HITS_PER_SEED,
                                            fields=2)
        arrays = dict(
            text_rows=gi.packed_rows(),
            kmer_rows=rows,
            chrom_starts=gi.chrom_starts.astype(np.int64),
            sj_rows=_junction_rows(gi),
            text_rows_ov=(gi.packed_overlap_rows()
                          if len(gi.text) <= ov_max else None))
        meta = dict(kmer_bits=bits, genome_len=int(gi.genome_len),
                    text_len=len(gi.text), sj_overhang=int(gi.sj_overhang),
                    k=gi.k, pos_mode=gi.pos_mode, sampling=gi.sampling,
                    minimizer_w=int(gi.minimizer_w))
        return arrays, meta

    @staticmethod
    def from_numpy(arrays: dict, meta: dict, device) -> "DeviceIndex":
        ov = arrays.get("text_rows_ov")
        return DeviceIndex(
            text_rows=u32_table(arrays["text_rows"], device),
            kmer_table=BucketTable.from_rows(
                arrays["kmer_rows"], int(meta["kmer_bits"]), device,
                entries=MAX_HITS_PER_SEED, fields=2, probe_rows=1),
            chrom_starts=torch.from_numpy(
                np.asarray(arrays["chrom_starts"], np.int64)).to(device),
            sj_rows=u32_table(arrays["sj_rows"], device),
            text_rows_ov=None if ov is None else u32_table(ov, device),
            genome_len=int(meta["genome_len"]),
            text_len=int(meta["text_len"]),
            sj_overhang=int(meta["sj_overhang"]), k=int(meta["k"]),
            pos_mode=str(meta["pos_mode"]), sampling=str(meta["sampling"]),
            minimizer_w=int(meta["minimizer_w"]))

    @staticmethod
    def build(gi: GenomeIndex, device, lap=None) -> "DeviceIndex":
        """The tables of `host_arrays`, made on `device`: the text, its
        mask and the kmer arrays uploaded once, then the text rows
        (`pack_text_rows_torch`), the overlapped rows
        (`overlap_rows_torch`, for texts up to the overlap limit) and the
        kmer bucket rows (`BucketTable.build_rows_torch`) built there.
        `lap(name)`, if given,
        is called after each step: "upload_s", "text_rows_s",
        "overlap_rows_s", "kmer_rows_s"."""
        assert len(gi.text) < 2**32, "u32 position space: text must be <4Gb"
        lap = lap or (lambda name: None)
        from ..params import get as _param
        ov_max = int(_param("overlap_rows_max_text")
                     or OVERLAP_ROWS_MAX_TEXT)
        text = torch.from_numpy(gi.text).to(device)
        valid = torch.from_numpy(gi.text_valid).to(device)
        keys = torch.from_numpy(gi.kmer_keys.view(np.int32)).to(device)
        vals = torch.from_numpy(gi.kmer_pos.view(np.int32)).to(device)
        lap("upload_s")
        text_rows = pack_text_rows_torch(text, valid)
        del text, valid
        lap("text_rows_s")
        ov = (overlap_rows_torch(text_rows, len(gi.text))
              if len(gi.text) <= ov_max else None)
        lap("overlap_rows_s")
        rows, bits = BucketTable.build_rows_torch(
            keys, vals, entries=MAX_HITS_PER_SEED, fields=2)
        del keys, vals
        lap("kmer_rows_s")
        return DeviceIndex(
            text_rows=text_rows,
            kmer_table=BucketTable(rows=rows, bits=bits,
                                   entries=MAX_HITS_PER_SEED, fields=2,
                                   probe_rows=1),
            chrom_starts=torch.from_numpy(
                gi.chrom_starts.astype(np.int64)).to(device),
            sj_rows=u32_table(_junction_rows(gi), device), text_rows_ov=ov,
            genome_len=int(gi.genome_len), text_len=len(gi.text),
            sj_overhang=int(gi.sj_overhang), k=gi.k, pos_mode=gi.pos_mode,
            sampling=gi.sampling, minimizer_w=int(gi.minimizer_w))

    @staticmethod
    def from_host(gi: GenomeIndex, device) -> "DeviceIndex":
        arrays, meta = DeviceIndex.host_arrays(gi)
        return DeviceIndex.from_numpy(arrays, meta, device)

    @staticmethod
    def from_jax(jidx, device) -> "DeviceIndex":
        """The tables of a cellranger_tpu DeviceIndex (any object with its
        fields), via np.asarray of each array."""
        kt = jidx.kmer_table
        arrays = dict(
            text_rows=np.asarray(jidx.text_rows),
            kmer_rows=np.asarray(kt.rows),
            chrom_starts=np.asarray(jidx.chrom_starts),
            sj_rows=np.asarray(jidx.sj_rows),
            text_rows_ov=(None if jidx.text_rows_ov is None
                          else np.asarray(jidx.text_rows_ov)))
        meta = dict(kmer_bits=kt.bits, genome_len=jidx.genome_len,
                    text_len=jidx.text_len, sj_overhang=jidx.sj_overhang,
                    k=jidx.k, pos_mode=jidx.pos_mode,
                    sampling=jidx.sampling, minimizer_w=jidx.minimizer_w)
        return DeviceIndex.from_numpy(arrays, meta, device)


def _junction_rows(gi: GenomeIndex) -> np.ndarray:
    """uint32 [J, 2]: each junction contig's (donor end, acceptor start)
    in text coordinates."""
    if not gi.n_junctions:
        return np.zeros((0, 2), np.uint32)
    return np.stack([gi.sj_donor_end.astype(np.uint32),
                     gi.sj_acceptor_start.astype(np.uint32)], axis=1)


def _rolling_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """codes uint8 [B, L] -> packed kmers (u32 values) [B, L-k+1]."""
    B, L = codes.shape
    n = L - k + 1
    km = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    for i in range(k):
        km = (km << 2) | codes[:, i:i + n].to(torch.int64)
    return km


def _window_valid(mask: torch.Tensor, k: int) -> torch.Tensor:
    """bool [B, L] -> [B, L-k+1]: all k bases valid."""
    cs = torch.cumsum(mask.to(torch.int32), 1)
    cs = torch.nn.functional.pad(cs, (1, 0))
    return (cs[:, k:] - cs[:, :-k]) == k


def _minimizer_picks(mh: torch.Tensor, w: int) -> torch.Tensor:
    """bool [B, n]: position i is the min of SOME w-window of mh (the rule
    of index.minimizer_mask)."""
    n = mh.shape[1]
    w = min(w, n)
    if w <= 1:
        return torch.ones(mh.shape, dtype=torch.bool, device=mh.device)

    def sweep(x, ww, op):  # out[:, j] = op-fold(x[:, j:j+ww])
        m = x
        have = 1
        while have < ww:
            step = min(have, ww - have)
            m = op(m[:, :m.shape[1] - step], m[:, step:])
            have += step
        return m

    wm = sweep(mh, w, torch.minimum)                  # [B, n-w+1]
    pad = torch.zeros((mh.shape[0], w - 1), dtype=mh.dtype, device=mh.device)
    cover = sweep(torch.cat([pad, wm, pad], 1), w, torch.maximum)
    return mh == cover


def make_window_fetch(idx: DeviceIndex, width: int):
    """fetch(pos u32 [...]) -> (codes uint8 [..., width], valid bool).

    A window costs one overlapped-row gather (text_rows_ov, 128-base
    stride, windows <= 96 bases) or two 256-base row gathers; the word run
    is picked by a gather and realigned with variable word shifts."""
    assert width <= 128
    n_words = (width + 15) // 16 + 1
    NR = int(idx.text_rows.shape[0])
    G = int(idx.text_len)
    use_ov = idx.text_rows_ov is not None and n_words <= OV_RW - 7
    R_ov = int(idx.text_rows_ov.shape[0]) if use_ov else 0

    def realign(words, vwords, pos):
        off2 = (2 * (pos & 15))[..., None]
        hi = (words[..., :-1] << off2) & U32_MASK
        lo = torch.where(off2 == 0, 0,
                         words[..., 1:] >> torch.clamp_max(32 - off2, 31))
        aligned = hi | lo
        off1 = (pos & 15)[..., None]
        vhi = (vwords[..., :-1] << off1) & 0xFFFF
        vlo = torch.where(off1 == 0, 0,
                          vwords[..., 1:] >> torch.clamp_max(16 - off1, 15))
        valigned = vhi | vlo
        dev = pos.device
        shifts = 2 * (15 - torch.arange(16, device=dev))
        codes16 = ((aligned[..., None] >> shifts) & 3).to(torch.uint8)
        vshifts = 15 - torch.arange(16, device=dev)
        valid16 = ((valigned[..., None] >> vshifts) & 1).to(torch.bool)
        win = codes16.reshape(*pos.shape, (n_words - 1) * 16)[..., :width]
        wok = valid16.reshape(*pos.shape, (n_words - 1) * 16)[..., :width]
        in_bounds = ((pos[..., None] + torch.arange(width, device=dev))
                     & U32_MASK) < G
        return win, wok & in_bounds

    def pick_words(arr, s):
        # words s .. s+n_words-1 of each row (always inside the row)
        j = s[..., None] + torch.arange(n_words, device=s.device)
        return torch.gather(arr, -1, j)

    def fetch_two_row(pos):
        pos = pos.to(torch.int64) & U32_MASK
        w0 = pos >> 4                      # first word index
        r = w0 >> 4                        # row = 16 words
        rows_a = widen(idx.text_rows[torch.clamp_max(r, NR - 2)])
        rows_b = widen(idx.text_rows[torch.clamp_max(r + 1, NR - 1)])
        codes32 = torch.cat([rows_a[..., :16], rows_b[..., :16]], -1)
        valid32 = torch.cat([rows_a[..., 16:], rows_b[..., 16:]], -1)
        s = w0 & 15
        return realign(pick_words(codes32, s), pick_words(valid32, s), pos)

    def fetch_overlap(pos):
        pos = pos.to(torch.int64) & U32_MASK
        row = widen(idx.text_rows_ov[torch.clamp_max(pos >> 7, R_ov - 1)])
        s = (pos >> 4) & 7                 # word offset within the row
        return realign(pick_words(row[..., :OV_RW], s),
                       pick_words(row[..., OV_RW:], s), pos)

    return fetch_overlap if use_ov else fetch_two_row


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a [B, D, ...], i [B] -> a[b, i[b]]."""
    return a[torch.arange(a.shape[0], device=a.device), i]


def _distinct_count(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Distinct non-sentinel values per row of a row-sorted [B, D]."""
    distinct = torch.ones_like(keys_sorted, dtype=torch.bool)
    distinct[:, 1:] = keys_sorted[:, 1:] != keys_sorted[:, :-1]
    return (distinct & (keys_sorted != U32_MAX)).sum(1)


def make_aligner(idx: DeviceIndex, read_len: int,
                 score_min: int = DEFAULT_ALIGN_SCORE_MIN,
                 sw_rescue: bool = True, novel_sj: bool = True,
                 seed_lookup=None):
    """Build align(rna uint8 [B, L], nmask bool [B, L]) -> dict of [B]
    (and [B, D] loci_*) tensors, on the index's device.

    seed_lookup: a replacement for idx.kmer_table.lookup (canonical kmers
    [B, S] -> (hit, val) [B, S, H]); a mesh with a sharded kmer table
    passes parallel/index_shard.ShardedIndex.lookup."""
    k = idx.k
    L = read_len
    MINI = idx.sampling == "minimizer"
    PARITY = idx.pos_mode == "parity"
    # parity packing loses <=1 bit of position and the vote key rounds the
    # diagonal to a multiple of 4: the true window offset is in [0, 4]
    N_OFF = 5 if PARITY else 1
    if MINI:
        from ..params import get as _param
        headroom = float(_param("minimizer_seed_headroom"))
        S = max(8, int(np.ceil(headroom * 2 * (L - k + 1)
                               / (idx.minimizer_w + 1))))
        seed_offsets = None
    else:
        seed_offsets = np.arange(0, L - k + 1, SEED_STRIDE, dtype=np.int64)
        S = len(seed_offsets)
    H = MAX_HITS_PER_SEED * idx.kmer_table.probe_rows
    D = MAX_CANDIDATES + (1 if PARITY else 0)
    n_sj = int(idx.sj_rows.shape[0])
    contig_len = 2 * idx.sj_overhang
    glen = idx.genome_len
    fetch_win = make_window_fetch(idx, L + N_OFF - 1)
    lookup = seed_lookup or idx.kmer_table.lookup
    dev = idx.text_rows.device
    seed_off_t = (None if seed_offsets is None
                  else torch.from_numpy(seed_offsets).to(dev))
    M = S * H
    tri = torch.tril(torch.ones((M, M), dtype=torch.bool, device=dev), -1)

    def canonical_pos(pos):
        """Text position -> genomic-equivalent coordinate (junction-contig
        donor flanks map onto the genome copy) for locus counting."""
        if n_sj == 0:
            return pos
        in_sj = pos >= glen
        rel = torch.where(in_sj, pos - glen, 0)
        j = torch.clamp(rel // contig_len, 0, n_sj - 1)
        row = widen(idx.sj_rows[j])                   # [..., 2] one gather
        off = rel % contig_len
        donor_start = row[..., 0] - idx.sj_overhang
        canon_sj = torch.where(off < idx.sj_overhang, donor_start + off,
                               row[..., 1] + off - idx.sj_overhang)
        return torch.where(in_sj, canon_sj & U32_MASK, pos)

    def align_batch(rna, nmask):
        B = rna.shape[0]
        rc = (3 - rna.flip(1)).to(torch.uint8)
        rc_mask = nmask.flip(1)

        # ---- canonical seed lookup: ONE row gather per seed ----
        kms = _rolling_kmers(rna, k)                 # [B, n]
        kvalid = _window_valid(nmask, k)
        if MINI:
            # winnowed seed picking, compacted to the earliest S picks by
            # a rank-indexed scatter (the JAX package's one-hot einsum
            # selects the same seeds)
            n = kms.shape[1]
            kmr_all = revcomp_packed(kms, k)
            flip_all = kmr_all < kms
            canon_all = torch.where(flip_all, kmr_all, kms)
            mh = (canon_all * int(MINIMIZER_HASH)) & U32_MASK
            mh = torch.where(kvalid, mh, U32_MAX)
            picked = _minimizer_picks(mh, idx.minimizer_w) & kvalid
            rank = torch.cumsum(picked.to(torch.int64), 1) - 1
            slot = torch.where(picked & (rank < S), rank, S)
            src = torch.arange(n, device=dev).expand(B, n)
            pos_s = torch.zeros((B, S + 1), dtype=torch.int64, device=dev)
            pos_s.scatter_(1, slot, src)
            kv = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)
            kv.scatter_(1, slot, torch.ones_like(picked))
            pos_s, kv = pos_s[:, :S], kv[:, :S]
            canon = torch.where(kv, torch.gather(canon_all, 1, pos_s), 0)
            flip = kv & torch.gather(flip_all, 1, pos_s)
            off = torch.where(kv, pos_s, 0)[:, :, None]
        else:
            km = kms[:, seed_off_t]                  # [B, S]
            kv = kvalid[:, seed_off_t]
            kmr = revcomp_packed(km, k)
            flip = kmr < km
            canon = torch.where(flip, kmr, km)
            off = seed_off_t[None, :, None]
        hit, val = lookup(canon)                     # [B, S, H]
        hit = hit & kv[:, :, None]
        if PARITY:
            pos_h = val & 0xFFFFFFFE                 # strand in parity bit
            sbit = val & 1
        else:
            pos_h = val & 0x7FFFFFFF
            sbit = val >> 31
        strand_h = sbit ^ flip[:, :, None].to(torch.int64)   # 0 fwd / 1 rc
        offterm = torch.where(strand_h == 0, off, L - k - off)
        ok = hit & (pos_h >= offterm)
        diag = pos_h - offterm                       # >= 0 where ok
        if PARITY:
            key = (diag & 0xFFFFFFFC) | strand_h
        else:
            key = diag | (strand_h << 31)
        key = torch.where(ok, key, U32_MAX)          # [B, S, H]

        # ---- diagonal voting via pairwise equality counting ----
        flat = key.reshape(B, M)
        fvalid = flat != U32_MAX
        eq = flat[:, None, :] == flat[:, :, None]    # [B, M, M]
        votes_all = (eq & fvalid[:, None, :]).sum(2)
        earlier = (eq & tri[None]).any(2)
        del eq
        votes = torch.where(fvalid & ~earlier, votes_all, 0)
        # lax.top_k order: descending, ties to the lower index
        top_votes, top_i = torch.sort(votes, stable=True, dim=1,
                                           descending=True)
        top_votes, top_i = top_votes[:, :D], top_i[:, :D]
        cand_key = torch.gather(flat, 1, top_i)      # [B, D]
        cand_ok = top_votes > 0
        if PARITY:
            cand_pos = cand_key & 0xFFFFFFFC
            cand_strand = cand_key & 1
        else:
            cand_pos = cand_key & 0x7FFFFFFF
            cand_strand = cand_key >> 31

        # ---- ungapped local extension (Kadane via prefix scans) ----
        on_rc = (cand_strand == 1)[:, :, None]
        codes_d = torch.where(on_rc, rc[:, None, :], rna[:, None, :])
        mask_d = torch.where(on_rc, rc_mask[:, None, :], nmask[:, None, :])
        win, wok = fetch_win(torch.where(cand_ok, cand_pos, 0))
        if N_OFF > 1:
            # parity mode: pick the true start offset o in [0, N_OFF) by
            # net matches over every 5th read position, then score once
            sub = torch.arange(0, L, 5, device=dev)
            wins = torch.stack([win[..., o:o + L][..., sub]
                                for o in range(N_OFF)], 2)
            woks = torch.stack([wok[..., o:o + L][..., sub]
                                for o in range(N_OFF)], 2)
            act5 = mask_d[:, :, None, sub] & woks         # [B, D, O, |sub|]
            m5 = (wins == codes_d[:, :, None, sub]) & act5
            net = 2 * m5.sum(-1) - act5.sum(-1)
            best_off = torch.argmax(net, 2)               # first max
            j = best_off[..., None] + torch.arange(L, device=dev)
            win = torch.gather(win, 2, j)
            wok = torch.gather(wok, 2, j)
            cand_pos = (cand_pos + best_off) & U32_MASK
        m = (win == codes_d) & wok & mask_d
        active = mask_d & wok
        contrib = torch.where(active, torch.where(m, 1, -1), 0)
        cs = torch.cumsum(contrib, 2)
        pref = cs - contrib                          # exclusive prefix
        run_min = torch.cummax(-pref, 2).values      # = -min prefix
        best_at = cs + run_min                       # best sum ending at i
        score, end_i = torch.max(best_at, 2)         # first max
        li = torch.arange(L, device=dev)[None, None, :]
        pref_masked = torch.where(li <= end_i[:, :, None], pref, BIG)
        start_i = torch.argmin(pref_masked, 2)       # first min
        aln_len = end_i - start_i + 1
        score = torch.where(cand_ok, score, -BIG)

        # ---- distinct-locus counting + deterministic pick ----
        best_score = score.max(1).values             # [B]
        is_best = score == best_score[:, None]
        canon_p = (canonical_pos(torch.where(cand_ok, cand_pos, 0))
                   + start_i) & U32_MASK
        if PARITY:
            ckey_full = (canon_p & 0xFFFFFFFE) | cand_strand
        else:
            ckey_full = ((canon_p << 1) & U32_MASK) | cand_strand
        ckey = torch.where(is_best & (score > -BIG), ckey_full, U32_MAX)
        n_best = _distinct_count(torch.sort(ckey, 1).values)

        # ---- candidate-cap honesty (repeat-rich genomes) ----
        n_diags = (votes > 0).sum(1)
        ckey_any = torch.where(cand_ok & (score > -BIG), ckey_full, U32_MAX)
        n_exam = _distinct_count(torch.sort(ckey_any, 1).values)
        saturated = (n_diags > D) & (n_best >= n_exam) & (n_best >= 1)
        n_best = torch.where(saturated, torch.clamp(n_diags, D + 1, 5),
                             n_best)

        # deterministic pick among ties: smallest (canon, strand)
        pick = torch.argmin(ckey, 1)
        best_pos = _take(cand_pos, pick)
        best_strand = _take(cand_strand, pick)
        # ALL distinct best-scoring loci in canonical order
        order_l = torch.argsort(ckey, dim=1, stable=True)
        ckey_s = torch.gather(ckey, 1, order_l)
        loci_ok = ckey_s != U32_MAX
        loci_ok[:, 1:] &= ckey_s[:, 1:] != ckey_s[:, :-1]
        takeL = lambda a: torch.gather(a, 1, order_l)  # noqa: E731
        out = dict(
            pos=best_pos, strand=best_strand, score=best_score,
            aln_start=_take(start_i, pick), aln_len=_take(aln_len, pick),
            n_best=n_best,
            loci_pos=takeL(cand_pos), loci_strand=takeL(cand_strand),
            loci_start=takeL(start_i), loci_len=takeL(aln_len),
            loci_ok=loci_ok, saturated=saturated,
        )

        if novel_sj:
            # ---- novel splice junction discovery (compacted) ----
            # a read over an unannotated junction seeds two same-strand
            # diagonals whose offset is the intron; the split score at x
            # is best-sum ending at x on the left window plus best-sum
            # starting at x+1 on the right window
            CJ = min(B, max(B // RESCUE_CAP_FRAC, 64))
            vlen = nmask.sum(1)
            n_cand = cand_ok.sum(1)
            need_sj = ((best_score < vlen - SJ_MARGIN) & (n_cand >= 2)
                       & (best_score > -BIG))
            selj = compact_indices(need_sj, CJ, B)
            sjc = torch.clamp_max(selj, B - 1)
            cs_j, pref_j, best_at_j = cs[sjc], pref[sjc], best_at[sjc]
            posu = cand_pos[sjc]
            cand_strand_j = cand_strand[sjc]
            cand_ok_j = cand_ok[sjc]
            best_score_j = best_score[sjc]

            rcm = torch.cummax(cs_j.flip(2), 2).values.flip(2)
            best_start_at = rcm - pref_j                 # [C, D, L]
            bs_shift = torch.cat(
                [best_start_at[:, :, 1:],
                 torch.full((CJ, D, 1), -BIG, dtype=best_start_at.dtype,
                            device=dev)], 2)
            in_gen = posu < glen                         # contigs excluded
            intron = posu[:, None, :] - posu[:, :, None]  # [C, i, j]
            pair_ok = (cand_ok_j[:, :, None] & cand_ok_j[:, None, :]
                       & (cand_strand_j[:, :, None]
                          == cand_strand_j[:, None, :])
                       & in_gen[:, :, None] & in_gen[:, None, :]
                       & (posu[:, None, :] > posu[:, :, None])
                       & (intron >= SJ_MIN_INTRON)
                       & (intron <= SJ_MAX_INTRON))
            seg_r_ok = bs_shift >= SJ_MIN_SEG
            ps, pxs = [], []
            for i in range(D):
                left = best_at_j[:, i:i + 1, :]
                t = torch.where((left >= SJ_MIN_SEG) & seg_r_ok,
                                left + bs_shift, -BIG)
                pv, px_i = torch.max(t, 2)               # [C, D]
                ps.append(pv)
                pxs.append(px_i)
            pscore = torch.where(pair_ok, torch.stack(ps, 1), -BIG)
            px = torch.stack(pxs, 1)
            bestp = torch.argmax(pscore.reshape(CJ, D * D), 1)
            ar_c = torch.arange(CJ, device=dev)
            sp_score = pscore.reshape(CJ, D * D)[ar_c, bestp]
            sx = px.reshape(CJ, D * D)[ar_c, bestp]      # split read index
            bi = bestp // D
            bj = bestp % D
            pos_l = posu[ar_c, bi]
            pos_r = posu[ar_c, bj]
            sj_strand = cand_strand_j[ar_c, bi]
            ba_l = best_at_j[ar_c, bi]                   # [C, L]
            bs_r = bs_shift[ar_c, bj]
            pref_l = pref_j[ar_c, bi]
            cs_r = cs_j[ar_c, bj]

            # canonical-motif plateau shift (STAR junction shifting): among
            # equal-score splits near x*, prefer GT..AG / CT..AC
            fetch8 = make_window_fetch(idx, 8)
            dsum = (pos_l + sx) & U32_MASK
            dstart = torch.where(dsum >= 2, dsum - 2, 0)   # donor_end - 3
            asum = (pos_r + sx) & U32_MASK
            astart = torch.where(asum >= 4, asum - 4, 0)   # acc_start - 5
            dwin, dok8 = fetch8(dstart)
            awin, aok8 = fetch8(astart)
            sh_np = np.array([0, -1, 1, -2, 2, -3, 3], np.int64)  # priority
            shifts = torch.from_numpy(sh_np).to(dev)
            xi = sx[:, None] + shifts[None, :]
            inb = (xi >= 0) & (xi < L - 1)
            xic = torch.clamp(xi, 0, L - 1)
            t_eq = (torch.gather(ba_l, 1, xic)
                    + torch.gather(bs_r, 1, xic)) == sp_score[:, None]
            i3 = torch.from_numpy(sh_np + 3).to(dev)
            i4 = i3 + 1
            d0, d1 = dwin[:, i3], dwin[:, i4]
            a0, a1 = awin[:, i3], awin[:, i4]
            mok = dok8[:, i3] & dok8[:, i4] & aok8[:, i3] & aok8[:, i4]
            # A=0 C=1 G=2 T=3: GT..AG or CT..AC (either gene strand)
            canon7 = (((d0 == 2) & (d1 == 3) & (a0 == 0) & (a1 == 2))
                      | ((d0 == 1) & (d1 == 3) & (a0 == 0) & (a1 == 1)))
            canon7 = canon7 & t_eq & inb & mok
            has_canon = canon7.any(1)
            s_sel = torch.where(has_canon,
                                shifts[torch.argmax(canon7.to(torch.int8), 1)],
                                0)
            xs = sx + s_sel
            sp_final = sp_score - torch.where(has_canon, 0, SJ_NONCANON_PEN)
            win_c = ((sp_final > best_score_j + SJ_MARGIN) & (sp_score > 0)
                     & (selj < B))

            li1 = torch.arange(L, device=dev)[None, :]
            pm = torch.where(li1 <= xs[:, None], pref_l, BIG)
            lstart = torch.argmin(pm, 1)
            cm = torch.where(li1 > xs[:, None], cs_r, -BIG)
            rend = torch.argmax(cm, 1)
            xs1 = xs + 1

            def scat(init, vals):
                return scatter_drop(init, selj,
                                    torch.where(win_c, vals, init[sjc]))

            zeros = torch.zeros(B, dtype=torch.int64, device=dev)
            win_sj = scatter_drop(torch.zeros(B, dtype=torch.bool,
                                              device=dev), selj, win_c)
            out["novel_sj"] = win_sj
            out["sj_donor"] = scat(zeros, (pos_l + xs1) & U32_MASK)
            out["sj_acceptor"] = scat(zeros, (pos_r + xs1) & U32_MASK)
            out["sj_left_len"] = scat(zeros, xs - lstart + 1)
            out["sj_right_len"] = scat(zeros, rend - xs)
            out["sj_score"] = scat(torch.full((B,), -BIG, dtype=torch.int64,
                                              device=dev), sp_final)
            out["pos"] = scat(out["pos"], pos_l)
            out["strand"] = scat(out["strand"], sj_strand)
            out["aln_start"] = scat(out["aln_start"], lstart)
            out["aln_len"] = scat(out["aln_len"], xs - lstart + 1)
            n_best = torch.where(win_sj, 1, n_best)
            out["n_best"] = n_best
            best_score = scat(best_score, sp_final)
            out["score"] = best_score

        if sw_rescue:
            # gapped rescue only for reads whose ungapped score missed the
            # floor but that have a candidate locus (indel suspects),
            # compacted to a fixed capacity and scattered back
            from .sw import BAND, banded_sw
            C = max(B // RESCUE_CAP_FRAC, 1)
            valid_len = nmask.sum(1)
            need = (best_score < valid_len - RESCUE_MARGIN) \
                & (best_score > -BIG)
            sel = compact_indices(need, C, B)
            selc = torch.clamp_max(sel, B - 1)
            on_rc_b = (best_strand == 1)[:, None]
            codes_b = torch.where(on_rc_b, rc, rna)[selc]
            mask_b = torch.where(on_rc_b, rc_mask, nmask)[selc]
            half = BAND // 2
            win_start = torch.where(best_pos > half, best_pos - half, 0)[selc]
            win_s, wok_s = make_window_fetch(idx, L + BAND)(win_start)
            sw_score_c, _, _ = banded_sw(codes_b.contiguous(),
                                         mask_b.contiguous(),
                                         win_s.contiguous(),
                                         wok_s.contiguous())
            sw_score = scatter_drop(torch.zeros(B, dtype=torch.int64,
                                                device=dev), sel, sw_score_c)
            eff_score = torch.maximum(best_score, sw_score)
            out["sw_score"] = sw_score
        else:
            eff_score = best_score

        mapped = (eff_score >= score_min) & (n_best >= 1)
        mapq = torch.where(n_best <= 1, 255,
                           torch.where(n_best == 2, 3,
                                       torch.where(n_best <= 4, 1, 0)))
        out["mapq"] = torch.where(mapped, mapq, 0)
        out["mapped"] = mapped
        return out

    return align_batch
