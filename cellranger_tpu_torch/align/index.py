"""Genome index for the TPU seed-and-extend aligner.

Replaces the reference's in-process STAR suffix-array aligner
(lib/rust/cr_lib/src/stages/align_and_count.rs:588 StarReference,
aligner.rs:396 align_read) with a TPU-friendly design:

  * The *text* is the 2-bit-coded concatenation of all chromosomes plus one
    mini-contig per annotated splice junction (donor flank + acceptor flank,
    STAR's sjdb insertion idea): a read spanning an annotated junction aligns
    *contiguously* to the junction contig, so the device kernel never needs
    data-dependent gap placement for splices. Coordinate maps translate
    junction-contig hits back to genomic (chrom, pos, gap) triplets on host.
  * The index is a sorted array of (kmer, position): k=16 so a seed packs
    into uint32 (JAX default x64-off friendly); lookup on device is a
    vectorized binary search returning a position range per seed. Positions
    are sampled every `stride` bases to bound HBM (seeds are extracted at
    every read offset, so any alignment still yields ~(L-k)/stride hits).
  * The index's arrays are host numpy, uploaded once to the device and
    shared by all batches (the analog of STAR's mmap-shared index).

Host build cost is O(G log G) numpy sorts — minutes for human-scale, and
cacheable to .npz (mkref analog, lib/python/cellranger/reference_builder.py).

Copied from cellranger_tpu/align/index.py over the port's encode; it reads
and writes the same index.npz as the JAX package.  The port adds a torch
build of the kmer table (`kmer_table_torch`, `GenomeIndex.build(device=)`)
and of the packed text rows (`pack_text_rows_torch`,
`overlap_rows_torch`), each equal array for array to the numpy functions
below, which stay as their plain versions.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..io.gtf import Transcriptome
from ..ops import encode
from ..ops.tensor_ops import U32_MASK, _pack2

DEFAULT_K = 16
DEFAULT_STRIDE = 1
# v3: canonical kmer keys; value = (pos & ~1) | strand — the strand bit
# rides in the position's parity bit, so a full 32-bit coordinate space
# (4Gb text: human-scale) fits one u32. The <=1-base position rounding is
# absorbed by the extension window's local alignment.
INDEX_VERSION = 3
MINIMIZER_W = 12          # winnowing window (minimizer sampling mode)
MINIMIZER_HASH = np.uint32(0x85EBCA6B)  # ordering hash (both sides use it)
AUTO_MINIMIZER_LEN = 256_000_000  # genomes above this sample minimizers


def revcomp_packed_np(km: np.ndarray, k: int) -> np.ndarray:
    """Host reverse-complement of packed 2-bit kmers (vectorized)."""
    x = (~km.astype(np.uint64)) & np.uint64((1 << (2 * k)) - 1)
    out = np.zeros_like(x)
    for i in range(k):
        out |= ((x >> np.uint64(2 * i)) & np.uint64(3)) << np.uint64(2 * (k - 1 - i))
    return out


@dataclass
class GenomeIndex:
    """Device-uploadable genome + kmer index (host numpy arrays)."""

    # text: concatenated chrom sequences then junction contigs
    text: np.ndarray          # uint8 [G] 2-bit codes (N -> 0)
    text_valid: np.ndarray    # bool [G] false at N bases and contig boundaries pad
    chrom_names: list[str]
    chrom_starts: np.ndarray  # int64 [C+1] offsets into text (genome part)
    genome_len: int           # length of the pure-genome prefix of text
    # junction contigs (appended after genome_len)
    sj_contig_start: np.ndarray  # int64 [J] offset of each contig in text
    sj_overhang: int             # flank length per side
    sj_chrom: np.ndarray         # int32 [J] chromosome index
    sj_donor_end: np.ndarray     # int64 [J] genomic end of donor exon (exclusive)
    sj_acceptor_start: np.ndarray  # int64 [J] genomic start of acceptor exon
    # kmer index
    k: int
    stride: int
    kmer_keys: np.ndarray     # uint32 [P] sorted canonical packed kmers
    kmer_pos: np.ndarray      # uint32 [P] packed (pos & ~1) | strand values
    sampling: str = "every"   # "every" or "minimizer"
    minimizer_w: int = 0      # winnowing window when sampling="minimizer"
    pos_mode: str = "strand31"  # "strand31" (exact) or "parity" (>=2^31 text)

    def packed_rows(self):
        """Genome text as 128-byte HBM rows: [NR+2, 32] uint32, columns
        0..15 = code words (16 MSB-first 2-bit codes each), 16..31 = the
        matching 16-bit validity masks. One row covers 256 bases; any
        <=128-base window lives in rows (r, r+1), so a candidate window
        costs exactly two row gathers (row fetches are the unit of HBM cost
        regardless of width — tools/row_bench.py). Two pad rows keep r+1 in
        bounds at the text tail.  Built a block of rows at a time, so the
        host holds the rows and one block's scratch (a whole-text build
        held ~3 bytes of scratch a base: 7 GB at human scale)."""
        if not hasattr(self, "_rows"):
            self._rows = _pack_text_rows(self.text, self.text_valid)
        return self._rows

    def packed_overlap_rows(self, rw: int = 14):
        """[R, 2*rw] u32 OVERLAPPED text rows: stride 128 bases, width
        rw*16 bases — any window of <= rw*16-128 bases starting anywhere
        lives entirely in row pos>>7, so a candidate window costs ONE row
        gather instead of two (row fetches are the unit of HBM cost;
        extension was ~8 row gathers/read at D=4).  Costs ~0.9 bytes/base
        of extra HBM, so DeviceIndex builds it only for texts that leave
        room next to the kmer table."""
        rows = self.packed_rows()
        tw = np.ascontiguousarray(rows[:, :16]).reshape(-1)
        vw = np.ascontiguousarray(rows[:, 16:]).reshape(-1)
        R = len(self.text) // 128 + 2
        from numpy.lib.stride_tricks import sliding_window_view
        tws = sliding_window_view(tw, rw)[::8][:R]
        vws = sliding_window_view(vw, rw)[::8][:R]
        R = min(len(tws), len(vws))
        return np.concatenate([tws[:R], vws[:R]], axis=1)

    @property
    def n_junctions(self) -> int:
        return len(self.sj_contig_start)

    # ---------- position mapping ----------
    def pos_to_genomic(self, pos: np.ndarray, aln_len: np.ndarray):
        """Map text positions of alignments back to genomic coordinates.

        pos: int64 [N] start offset in text; aln_len: alignment span in text.
        Returns dict of arrays: chrom int32, gpos int64 (genomic start),
        spliced bool, intron_len int64 (0 if unspliced), junc_idx int32 (-1),
        donor_off int32 (bases of the alignment before the junction; only for
        spliced rows).
        """
        pos = np.asarray(pos, np.int64)
        aln_len = np.asarray(aln_len, np.int64)
        n = len(pos)
        chrom = np.zeros(n, np.int32)
        gpos = np.zeros(n, np.int64)
        spliced = pos >= self.genome_len
        intron = np.zeros(n, np.int64)
        junc_idx = np.full(n, -1, np.int32)
        donor_off = np.zeros(n, np.int32)

        g = ~spliced
        if g.any():
            ci = np.searchsorted(self.chrom_starts, pos[g], side="right") - 1
            chrom[g] = ci
            gpos[g] = pos[g] - self.chrom_starts[ci]
        if spliced.any():
            sj = np.searchsorted(self.sj_contig_start, pos[spliced], side="right") - 1
            junc_idx[spliced] = sj
            off = pos[spliced] - self.sj_contig_start[sj]  # offset in contig
            ov = self.sj_overhang
            chrom[spliced] = self.sj_chrom[sj]
            # contig layout: [donor_end-ov, donor_end) ++ [acc_start, acc_start+ov)
            before = np.maximum(ov - off, 0)  # bases before junction point
            donor_off[spliced] = np.minimum(before, aln_len[spliced]).astype(np.int32)
            crosses = (off < ov) & (off + aln_len[spliced] > ov)
            starts_in_donor = off < ov
            gstart = np.where(
                starts_in_donor,
                self.sj_donor_end[sj] - ov + off,
                self.sj_acceptor_start[sj] + (off - ov),
            )
            # sj_donor_end/sj_acceptor_start are absolute text coords; make
            # gpos chromosome-relative like the unspliced branch.
            gpos[spliced] = gstart - self.chrom_starts[self.sj_chrom[sj]]
            intron[spliced] = np.where(
                crosses, self.sj_acceptor_start[sj] - self.sj_donor_end[sj], 0)
        return dict(chrom=chrom, gpos=gpos, spliced=spliced, intron_len=intron,
                    junc_idx=junc_idx, donor_off=donor_off)

    # ---------- construction ----------
    @staticmethod
    def build(seqs: dict[str, bytes], transcriptome: Transcriptome | None,
              k: int = DEFAULT_K, stride: int = DEFAULT_STRIDE,
              sj_overhang: int = 120,
              sampling: str = "auto",
              minimizer_w: int = MINIMIZER_W,
              pos_mode: str = "auto", device=None) -> "GenomeIndex":
        """device: None builds the kmer table with the numpy functions on
        the host; a torch device builds it there (`kmer_table_torch`),
        text and mask uploaded once, the table copied back.  Either gives
        the same arrays.  Text encoding and junction contigs are host
        numpy in both."""
        chrom_names = list(seqs)
        chrom_codes = []
        chrom_valid = []
        starts = [0]
        for name in chrom_names:
            codes, valid = encode.encode_seqs(
                np.frombuffer(seqs[name], dtype=np.uint8))
            chrom_codes.append(codes)
            chrom_valid.append(valid)
            starts.append(starts[-1] + len(codes))
        genome = np.concatenate(chrom_codes) if chrom_codes else np.zeros(0, np.uint8)
        gvalid = np.concatenate(chrom_valid) if chrom_valid else np.zeros(0, bool)
        chrom_starts = np.asarray(starts, np.int64)
        genome_len = len(genome)
        cidx = {n: i for i, n in enumerate(chrom_names)}

        # Junction contigs from annotated introns.
        sj_keys = sorted(transcriptome.junctions()) if transcriptome else []
        sj_chrom, sj_donor, sj_acc, contigs, contig_valid = [], [], [], [], []
        for (chrom, donor_end, acc_start) in sj_keys:
            if chrom not in cidx:
                continue
            ci = cidx[chrom]
            c0 = chrom_starts[ci]
            clen = chrom_starts[ci + 1] - c0
            ov = sj_overhang
            d_lo, d_hi = max(0, donor_end - ov), donor_end
            a_lo, a_hi = acc_start, min(clen, acc_start + ov)
            if d_hi <= d_lo or a_hi <= a_lo or acc_start <= donor_end:
                continue
            left = genome[c0 + d_lo:c0 + d_hi]
            right = genome[c0 + a_lo:c0 + a_hi]
            lv = gvalid[c0 + d_lo:c0 + d_hi]
            rv = gvalid[c0 + a_lo:c0 + a_hi]
            # pad flanks to exactly ov so contig offsets are uniform
            if len(left) < ov:
                left = np.concatenate([np.zeros(ov - len(left), np.uint8), left])
                lv = np.concatenate([np.zeros(ov - len(lv), bool), lv])
            if len(right) < ov:
                right = np.concatenate([right, np.zeros(ov - len(right), np.uint8)])
                rv = np.concatenate([rv, np.zeros(ov - len(rv), bool)])
            contigs.append(np.concatenate([left, right]))
            contig_valid.append(np.concatenate([lv, rv]))
            sj_chrom.append(ci)
            sj_donor.append(c0 + donor_end)   # absolute text coords of genome copy
            sj_acc.append(c0 + acc_start)

        n_j = len(contigs)
        contig_len = 2 * sj_overhang
        sj_contig_start = genome_len + contig_len * np.arange(n_j, dtype=np.int64)
        text = np.concatenate([genome] + contigs) if n_j else genome
        text_valid = np.concatenate([gvalid] + contig_valid) if n_j else gvalid

        # kmer index over the full text.
        if sampling == "auto":
            sampling = ("minimizer" if len(text) > AUTO_MINIMIZER_LEN
                        else "every")
        if pos_mode == "auto":
            pos_mode = "strand31" if len(text) < 2**31 else "parity"
        assert len(text) < 2**31 or pos_mode == "parity", \
            "text >= 2Gb requires parity position packing"
        if device is not None:
            keys, pos = kmer_table_torch(
                torch.from_numpy(text).to(device),
                torch.from_numpy(text_valid).to(device), k, stride,
                sampling, minimizer_w, pos_mode)
            keys = keys.cpu().numpy().view(np.uint32)
            pos = pos.cpu().numpy().view(np.uint32)
        elif sampling == "minimizer":
            keys, pos = _build_kmer_table_minimizer(text, text_valid, k,
                                                    minimizer_w, pos_mode)
        else:
            keys, pos = _build_kmer_table(text, text_valid, k, stride,
                                          pos_mode)
        return GenomeIndex(
            text=text, text_valid=text_valid, chrom_names=chrom_names,
            chrom_starts=chrom_starts, genome_len=genome_len,
            sj_contig_start=sj_contig_start, sj_overhang=sj_overhang,
            sj_chrom=np.asarray(sj_chrom, np.int32),
            sj_donor_end=np.asarray(sj_donor, np.int64),
            sj_acceptor_start=np.asarray(sj_acc, np.int64),
            k=k, stride=stride, kmer_keys=keys, kmer_pos=pos,
            sampling=sampling,
            minimizer_w=minimizer_w if sampling == "minimizer" else 0,
            pos_mode=pos_mode,
        )

    def save(self, path: str):
        np.savez_compressed(path, **self.npz_arrays())

    def npz_arrays(self) -> dict:
        """The arrays of index.npz, by key (`load` reads them from a
        compressed or an uncompressed npz)."""
        return dict(
            text=self.text, text_valid=np.packbits(self.text_valid),
            text_len=len(self.text),
            chrom_starts=self.chrom_starts, genome_len=self.genome_len,
            sj_contig_start=self.sj_contig_start, sj_overhang=self.sj_overhang,
            sj_chrom=self.sj_chrom, sj_donor_end=self.sj_donor_end,
            sj_acceptor_start=self.sj_acceptor_start,
            k=self.k, stride=self.stride,
            kmer_keys=self.kmer_keys, kmer_pos=self.kmer_pos,
            chrom_names=np.asarray(self.chrom_names),
            sampling=self.sampling, minimizer_w=self.minimizer_w,
            pos_mode=self.pos_mode,
            version=INDEX_VERSION,
        )

    @staticmethod
    def load(path: str) -> "GenomeIndex":
        z = np.load(path, allow_pickle=False)
        if int(z["version"]) != INDEX_VERSION:
            raise ValueError(
                f"index version {int(z['version'])} != {INDEX_VERSION}; "
                "rebuild the reference (mkref)")
        tlen = int(z["text_len"])
        return GenomeIndex(
            text=z["text"], text_valid=np.unpackbits(z["text_valid"])[:tlen].astype(bool),
            chrom_names=[str(x) for x in z["chrom_names"]],
            chrom_starts=z["chrom_starts"], genome_len=int(z["genome_len"]),
            sj_contig_start=z["sj_contig_start"], sj_overhang=int(z["sj_overhang"]),
            sj_chrom=z["sj_chrom"], sj_donor_end=z["sj_donor_end"],
            sj_acceptor_start=z["sj_acceptor_start"],
            k=int(z["k"]), stride=int(z["stride"]),
            kmer_keys=z["kmer_keys"], kmer_pos=z["kmer_pos"],
            sampling=str(z["sampling"]), minimizer_w=int(z["minimizer_w"]),
            pos_mode=str(z["pos_mode"]),
        )


PACK_BLOCK_ROWS = 1 << 14   # text rows packed at a time (4 Mb of text)


def _pack_text_rows(text, valid) -> np.ndarray:
    """`GenomeIndex.packed_rows` of (text, valid), PACK_BLOCK_ROWS rows at
    a time: each code is two bits and each validity flag one, packed
    MSB-first by np.packbits into big-endian words."""
    G = len(text)
    NR = (G + 255) // 256 + 2
    rows = np.zeros((NR, 32), np.uint32)
    for r0 in range(0, (G + 255) // 256, PACK_BLOCK_ROWS):
        r1 = min(r0 + PACK_BLOCK_ROWS, NR)
        n = min(r1 * 256, G) - r0 * 256
        c = np.zeros((r1 - r0) * 256, np.uint8)
        c[:n] = text[r0 * 256:r0 * 256 + n]
        v = np.zeros((r1 - r0) * 256, bool)
        v[:n] = valid[r0 * 256:r0 * 256 + n]
        bits = np.stack([c >> 1, c & 1], 1).reshape(-1, 32).astype(bool)
        rows[r0:r1, :16] = np.packbits(bits, axis=1).view(">u4") \
            .reshape(r1 - r0, 16)
        rows[r0:r1, 16:] = np.packbits(v.reshape(-1, 16), axis=1) \
            .view(">u2").reshape(r1 - r0, 16)
    return rows


def _canonical_kmers_block(text, valid, k):
    """(keys uint32 [n], is_rc bool [n], ok bool [n]) for every kmer start
    of `text`. Canonical = min(kmer, revcomp): ONE seed lookup then serves
    both read strands (the hit's strand = stored bit XOR the query's
    flipped bit), halving the per-read row-gather count — the dominant
    cost on TPU (tools/row_bench.py)."""
    G = len(text)
    n = G - k + 1
    km = np.zeros(n, np.uint64)
    for i in range(k):
        km = (km << np.uint64(2)) | text[i:i + n].astype(np.uint64)
    cs = np.concatenate([[0], np.cumsum(valid.astype(np.uint8))])
    ok = (cs[k:] - cs[:-k]) == k
    fwd = km.astype(np.uint32)
    rc = revcomp_packed_np(fwd, k).astype(np.uint32)
    is_rc = rc < fwd
    keys = np.where(is_rc, rc, fwd)
    return keys, is_rc, ok


def _pack_vals(pos, is_rc, pos_mode):
    """v3 value packings:
    - "strand31" (text < 2^31): val = pos | strand<<31 — exact positions.
    - "parity"  (text >= 2^31, human-scale): val = (pos & ~1) | strand —
      the strand bit rides in the position's parity bit so a full 32-bit
      coordinate space fits; the <=1-base rounding is recovered by the
      aligner's multi-offset extension scoring."""
    if pos_mode == "strand31":
        return pos.astype(np.uint32) | (is_rc.astype(np.uint32) << np.uint32(31))
    return ((pos.astype(np.uint32) & np.uint32(0xFFFFFFFE))
            | is_rc.astype(np.uint32))


def _build_kmer_table(text, valid, k, stride, pos_mode):
    """Every-position sampling: all (canonical kmer, packed val) at stride
    over text where all k bases are valid; sorted by (key, pos)."""
    G = len(text)
    if G < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    keys_all, is_rc_all, ok = _canonical_kmers_block(text, valid, k)
    n = len(keys_all)
    pos = np.arange(0, n, stride, dtype=np.uint32)
    pos = pos[ok[::stride][:len(pos)]]
    keys = keys_all[pos]
    vals = _pack_vals(pos, is_rc_all[pos], pos_mode)
    order = np.lexsort((pos, keys))
    return keys[order], vals[order]


def _window_sweep(mh, w, op):
    """out[i] = op-fold of mh[i : i+w] for i in [0, n-w]; log-doubling."""
    m = mh.copy()
    have = 1
    while have < w:
        step = min(have, w - have)
        m[: len(m) - step] = op(m[: len(m) - step], m[step:])
        have += step
    return m[: len(mh) - w + 1]


def minimizer_mask(mh, w):
    """True at positions that are the minimum of SOME w-window of mh.
    Both the genome build and the read seed picker use THIS rule, so every
    genome minimizer inside a read (>= w-1 bases from the read edges) is
    also a read minimizer.

    i is picked iff wm[j] == mh[i] for some window j containing i; since
    wm[j] <= mh[i] for every such window, that is equivalent to
    max(wm[j], j in [i-w+1, i]) == mh[i] — a window-max over window-mins."""
    n = len(mh)
    if n == 0:
        return np.zeros(0, bool)
    if n < w:
        return mh == mh.min()
    wm = _window_sweep(mh, w, np.minimum)    # [n-w+1] min of window at j
    pad = np.concatenate([np.zeros(w - 1, mh.dtype), wm,
                          np.zeros(w - 1, mh.dtype)])
    cover = _window_sweep(pad, w, np.maximum)  # max wm over [i-w+1, i]
    return mh == cover[:n]


def _build_kmer_table_minimizer(text, valid, k, w, pos_mode,
                                block=1 << 26):
    """Winnowed sampling: only window-minimum canonical kmers are indexed
    (density ~2/(w+1)), shrinking a human-genome index to HBM scale.
    Processed in overlapping blocks to bound host memory."""
    G = len(text)
    if G < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    keys_l, vals_l = [], []
    ov = w + k
    start = 0
    while start < G - k + 1:
        stop = min(start + block, G - k + 1)
        lo = max(start - ov, 0)
        hi = min(stop + ov + k, G)
        keys, is_rc, ok = _canonical_kmers_block(text[lo:hi], valid[lo:hi], k)
        mh = (keys * MINIMIZER_HASH).astype(np.uint32)
        mh = np.where(ok, mh, np.uint32(0xFFFFFFFF))
        picked = minimizer_mask(mh, w) & ok
        abs_pos = np.arange(lo, lo + len(keys), dtype=np.uint32)
        sel = picked & (abs_pos >= start) & (abs_pos < stop)
        keys_l.append(keys[sel])
        vals_l.append(_pack_vals(abs_pos[sel], is_rc[sel], pos_mode))
        start = stop
    keys = np.concatenate(keys_l) if keys_l else np.zeros(0, np.uint32)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.uint32)
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


# ---------------------------------------------------------------------------
# torch build: the kmer table and the packed text rows on a device, equal
# to the numpy functions above (u32 values in int64, tables returned as
# int32 bit-views; ops/tensor_ops.py)
# ---------------------------------------------------------------------------

KMER_BLOCK = 1 << 26   # kmer starts per block (_build_kmer_table_minimizer)
ROW_BLOCK = 1 << 18    # text rows packed per block (64 Mb of text)


def _canonical_kmers_torch(text, valid, k):
    """`_canonical_kmers_block` on tensors, through the aligner's rolling
    kmers and window mask on a [1, n] view: (keys int64 u32 values,
    is_rc, ok) for every kmer start of `text` (uint8 codes, bool mask)."""
    from .aligner import _rolling_kmers, _window_valid

    fwd = _rolling_kmers(text[None], k)[0] & U32_MASK
    rc = encode.revcomp_packed(fwd, k) & U32_MASK
    is_rc = rc < fwd
    keys = torch.where(is_rc, rc, fwd)
    del rc, fwd
    return keys, is_rc, _window_valid(valid[None], k)[0]


def _pack_vals_torch(pos, is_rc, pos_mode):
    """`_pack_vals` on int64 tensors."""
    if pos_mode == "strand31":
        return pos | (is_rc.to(torch.int64) << 31)
    return (pos & 0xFFFFFFFE) | is_rc.to(torch.int64)


def kmer_table_torch(text, valid, k, stride, sampling, w, pos_mode,
                     block: int = KMER_BLOCK):
    """(kmer_keys, kmer_pos) of the text on its device, as int32
    bit-views of the numpy build's uint32 arrays: `_build_kmer_table`
    (every `stride`-th start, sorted by (key, position)) or
    `_build_kmer_table_minimizer` (window minimizers, sorted by (key,
    value)), in blocks of `block` kmer starts with the numpy build's
    overlap of w + k.  Each entry is kept as one int64 sort key, (key,
    position) or (key, value) with the key's sign bit flipped: a sort of
    those orders the entries as lexsort does.  Equal (key, value) pairs
    (parity packing) are equal entries, so the sort need not be stable."""
    from .aligner import _minimizer_picks

    G = text.shape[0]
    dev = text.device
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    if G < k:
        return empty, empty
    n_all = G - k + 1
    ov = w + k if sampling == "minimizer" else 0
    packed, rcs = [], []
    start = 0
    while start < n_all:
        stop = min(start + block, n_all)
        lo = max(start - ov, 0)
        hi = min(stop + ov + k, G) if ov else stop + k - 1
        keys, is_rc, ok = _canonical_kmers_torch(text[lo:hi], valid[lo:hi],
                                                 k)
        abs_pos = torch.arange(lo, lo + keys.shape[0], device=dev)
        if sampling == "minimizer":
            mh = (keys * int(MINIMIZER_HASH)) & U32_MASK
            mh = torch.where(ok, mh, U32_MASK)
            # the aligner's picks are `minimizer_mask`, its short case
            # (n < w: every position holding the minimum) included
            sel = _minimizer_picks(mh[None], w)[0] & ok
            del mh
            sel &= (abs_pos >= start) & (abs_pos < stop)
            vals = _pack_vals_torch(abs_pos[sel], is_rc[sel], pos_mode)
            packed.append(_pack2(keys[sel], vals))
        else:
            sel = ok & (abs_pos % stride == 0)
            packed.append(_pack2(keys[sel], abs_pos[sel]))
            rcs.append(is_rc[sel])
        del keys, is_rc, ok, abs_pos, sel
        start = stop
    packed = torch.cat(packed)
    if sampling == "minimizer":
        packed = torch.sort(packed).values
        keys = (packed >> 32) + (1 << 31)
        vals = packed & U32_MASK
    else:
        packed, order = torch.sort(packed)
        keys = (packed >> 32) + (1 << 31)
        vals = _pack_vals_torch(packed & U32_MASK, torch.cat(rcs)[order],
                                pos_mode)
    del packed
    return keys.to(torch.int32), vals.to(torch.int32)


def pack_text_rows_torch(text, valid, block: int = ROW_BLOCK):
    """`_pack_text_rows` on the text's device: [NR+2, 32] int32 bit-view,
    code words (16 MSB-first 2-bit codes) then validity words (16
    MSB-first bits), `block` rows at a time."""
    G = text.shape[0]
    dev = text.device
    n_rows = (G + 255) // 256
    rows = torch.zeros((n_rows + 2, 32), dtype=torch.int32, device=dev)
    c_sh = 2 * (15 - torch.arange(16, device=dev))
    v_sh = 15 - torch.arange(16, device=dev)
    for r0 in range(0, n_rows, block):
        r1 = min(r0 + block, n_rows)
        n = min(r1 * 256, G) - r0 * 256
        c = torch.zeros((r1 - r0) * 256, dtype=torch.int64, device=dev)
        c[:n] = text[r0 * 256:r0 * 256 + n]
        v = torch.zeros((r1 - r0) * 256, dtype=torch.int64, device=dev)
        v[:n] = valid[r0 * 256:r0 * 256 + n]
        # disjoint bit fields: their sum is their OR
        rows[r0:r1, :16] = (c.view(-1, 16) << c_sh).sum(1) \
            .view(r1 - r0, 16).to(torch.int32)
        rows[r0:r1, 16:] = (v.view(-1, 16) << v_sh).sum(1) \
            .view(r1 - r0, 16).to(torch.int32)
    return rows


def overlap_rows_torch(rows, text_len: int, rw: int = 14):
    """`GenomeIndex.packed_overlap_rows` of `pack_text_rows_torch`'s
    rows: windows of rw words at a stride of 8 words (128 bases) over the
    code words and over the validity words, side by side."""
    R = text_len // 128 + 2
    tws = rows[:, :16].reshape(-1).unfold(0, rw, 8)[:R]
    vws = rows[:, 16:].reshape(-1).unfold(0, rw, 8)[:R]
    R = min(tws.shape[0], vws.shape[0])
    return torch.cat([tws[:R], vws[:R]], 1)
