"""The V(D)J pipeline's per-barcode host work, batched: the reads of a
barcode as arrays, the UMI support and base qualities of its contigs,
contig annotation through a native local alignment, and the primer trim
of pass 2.

The JAX package's versions (vdj/assembly.py `umi_support`,
`contig_base_quals`, `trim_primer_read`; vdj/annotate.py `local_align`,
`best_hit`, `annotate_contig`) walk every read base by base in Python;
the port keeps them verbatim as the plain versions its tests and
chip_smoke.py hold these to.  Each function here gives the same result
bit for bit:

- integer work (20-mers of reads and contigs, anchors, primer hits) runs
  in torch on the device it is given;
- the pileup's float sums stay float64 on the host and add their terms in
  the original's order: a UMI's observations in read order (native, one
  pass), the UMIs of a position in the order first seen there, each sum
  from 0.0; the per-quality terms come from a table filled with the
  original's own scalar expressions, powers and logarithms are numpy's,
  and every 4- and 3-term sum is written out left to right, as numpy sums
  an array of fewer than 8 values;
- `Annotator` aligns only the segments that share a 16-mer with the
  contig, in the reference's order, natively.

The native routines are native/vdj_host.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..native.vdj_host import local_align, pileup_sums
from .annotate import KSEED, ContigAnnotation, SegmentHit, _kmers, find_cdr3
from .assembly import (MAX_OUT_QUAL, MAX_READ_QUAL, MIN_LOG_PROB, RT_ERR, K,
                       Contig)
from .reference import VdjReference

_ACGT = np.full(256, 4, np.uint8)
_ACGT[list(b"ACGT")] = [0, 1, 2, 3]

# contig_base_quals' per-quality terms, indexed by the quality byte: q is
# the byte - 33, capped at MAX_READ_QUAL, or 30 past the quality string
_Q = [min(x - 33, MAX_READ_QUAL) for x in range(256)]
_MATCH = np.array([np.log10(max(1.0 - 10 ** (-q / 10.0), 1e-10)) for q in _Q])
_MISMATCH = np.array([-q / 10.0 - np.log10(3.0) for q in _Q])
_PAST_QUAL = 30 + 33                  # the byte whose q is 30
# an observation's terms for each base b, indexed by quality byte * 4 +
# observed base: _TERMS[b, qb * 4 + base]
_TERMS = np.where(np.arange(4)[:, None] == np.arange(1024) % 4,
                  np.repeat(_MATCH, 4), np.repeat(_MISMATCH, 4))
# the RT-error prior added to the UMI's row for true base r
_LF1 = np.log10(1.0 - RT_ERR)
_LF2 = np.log10(RT_ERR / 3.0)
_PRIOR = np.where(np.eye(4, dtype=bool), _LF1, _LF2)
_OTHERS = np.array([[b for b in range(4) if b != r] for r in range(4)])


@dataclass
class BarcodeReads:
    """A barcode's reads as rows: read r is columns [start[r], end[r]) of
    its row, base codes 0-3 where `valid` (A, C, G, T), anything else
    elsewhere; `qual` holds its quality bytes at the same columns, the
    first qlen[r] of them given (past them a base takes quality 30)."""
    codes: np.ndarray      # uint8 [R, W]
    valid: np.ndarray      # bool [R, W]
    qual: np.ndarray       # uint8 [R, W]
    start: np.ndarray      # int64 [R]
    end: np.ndarray        # int64 [R]
    qlen: np.ndarray       # int64 [R]
    umi: np.ndarray        # int64 [R]

    @staticmethod
    def from_tuples(reads: list) -> "BarcodeReads":
        """From the originals' read list: (umi, seq, qual bytes) tuples."""
        W = max([len(s) for _, s, *_ in reads] + [1])
        R = len(reads)
        codes = np.full((R, W), 4, np.uint8)
        qual = np.zeros((R, W), np.uint8)
        end = np.zeros(R, np.int64)
        qlen = np.zeros(R, np.int64)
        for r, (_, seq, q, *_) in enumerate(reads):
            b = seq.encode() if isinstance(seq, str) else bytes(seq)
            codes[r, :len(b)] = _ACGT[np.frombuffer(b, np.uint8)]
            n = min(len(q), len(b))
            qual[r, :n] = np.frombuffer(bytes(q[:n]), np.uint8)
            end[r], qlen[r] = len(b), len(q)
        return BarcodeReads(codes, codes < 4, qual, np.zeros(R, np.int64),
                            end, qlen,
                            np.array([u for u, *_ in reads], np.int64))


class ReadStore:
    """Pass 2's reads of every barcode, as the original's `reads_by_bc`
    lists them: per barcode in the order the rows were added (per batch,
    mate 1 then mate 2), the first `cap` of them.  Rows are those of the
    arrays handed to the kmer spectrum: read r is columns
    [start[r], end[r]) of rna[r], its qualities at the same columns."""

    def __init__(self, bc, umi, rna, nmask, qual, start, end, cap: int):
        self._bc = bc
        self.umi, self.rna, self.nmask, self.qual = umi, rna, nmask, qual
        self.start, self.end, self.cap = start, end, cap
        self.order = np.argsort(bc, kind="stable")
        sb = bc[self.order]
        first = np.flatnonzero(np.r_[True, sb[1:] != sb[:-1]]) \
            if len(sb) else np.zeros(0, np.int64)
        sizes = np.diff(np.r_[first, len(sb)])
        self.index = dict(zip(sb[first].tolist(),
                              zip(first.tolist(), sizes.tolist())))
        self._first, self._sizes = first, sizes

    def distinct_umis(self, device) -> tuple[np.ndarray, np.ndarray]:
        """Every barcode, ascending, and the distinct UMIs among the rows
        `reads` gives it (its first `cap`), counted on `device`."""
        pos = np.arange(len(self.order)) - np.repeat(self._first,
                                                     self._sizes)
        rows = self.order[pos < self.cap]
        # a row's (barcode, UMI) as one u64, its top bit flipped so that
        # int64 order is the unsigned order
        key = ((self._bc[rows].astype(np.uint64) << np.uint64(32))
               | self.umi[rows].astype(np.uint64)) ^ np.uint64(1 << 63)
        pairs = torch.unique(torch.from_numpy(key.view(np.int64)).to(device))
        bc, n = torch.unique_consecutive(pairs >> 32, return_counts=True)
        return ((bc.cpu().numpy() ^ (1 << 31)).astype(np.uint32),
                n.cpu().numpy())

    def reads(self, bc: int) -> BarcodeReads:
        s, n = self.index.get(bc, (0, 0))
        rows = self.order[s:s + min(n, self.cap)]
        start = self.start[rows].astype(np.int64)
        end = self.end[rows].astype(np.int64)
        return BarcodeReads(self.rna[rows], self.nmask[rows],
                            self.qual[rows], start, end, end - start,
                            self.umi[rows].astype(np.int64))


def _rolling(codes: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit packed k-mers [R, W - k + 1] (int64) of base codes [R, W]."""
    n = max(codes.shape[1] - k + 1, 0)
    km = torch.zeros((codes.shape[0], n), dtype=torch.int64,
                     device=codes.device)
    for j in range(k if n else 0):
        km = (km << 2) | (codes[:, j:j + n] & 3)
    return km


def _windows_valid(valid: torch.Tensor, k: int) -> torch.Tensor:
    """[R, W - k + 1]: every base of the k-window is valid."""
    bad = torch.nn.functional.pad(torch.cumsum(~valid, 1, dtype=torch.int32),
                                  (1, 0))
    return (bad[:, k:] - bad[:, :-k]) == 0 if valid.shape[1] >= k else \
        torch.zeros((valid.shape[0], 0), dtype=torch.bool,
                    device=valid.device)


def _seq_kmers(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """(K-mers, positions) of the windows of `seq` that hold only A, C, G
    and T, in position order."""
    c = _ACGT[np.frombuffer(seq.encode(), np.uint8)]
    n = len(c) - K + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    t = torch.from_numpy(c.astype(np.int64))[None]
    ok = _windows_valid(t < 4, K)[0].numpy()
    km = _rolling(t, K)[0].numpy()
    return km[ok], np.flatnonzero(ok)


def _ordered_sums(index: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """[n, c]: per target t < n and column b of vals ([len(index), c]),
    the sum of the vals[:, b] whose index is t, added in order onto 0.0,
    as a Python loop over them adds them (np.bincount's weighted loop is
    that loop)."""
    return np.stack([np.bincount(index, weights=vals[:, b], minlength=n)
                     for b in range(vals.shape[1])], 1)


def _logsumexp10(x: np.ndarray) -> np.ndarray:
    """m + log10(sum(10 ** (x - m))) over the last axis (3 or 4 values),
    m its max, the sum taken left to right."""
    m = x.max(-1)
    e = 10 ** (x - m[..., None])
    s = e[..., 0] + e[..., 1]
    for i in range(2, x.shape[-1]):
        s = s + e[..., i]
    return m + np.log10(s)


class BarcodeSupport:
    """One barcode's reads against its contigs: the reads' K-mers are
    computed once, on `device`, and looked up for every contig."""

    def __init__(self, reads: BarcodeReads, device):
        self.reads = reads
        self.device = device
        dev = lambda a: torch.from_numpy(a).to(device)
        self.codes = dev(reads.codes)
        self.valid = dev(reads.valid)
        self.start, self.end = dev(reads.start), dev(reads.end)
        R, W = reads.codes.shape
        s = torch.arange(max(W - K + 1, 0), device=device)
        self.kmers = _rolling(self.codes.long(), K)
        self.ok = (_windows_valid(self.valid, K) & (s >= self.start[:, None])
                   & (s + K <= self.end[:, None]))
        self.tot = self.ok.sum(1).cpu().numpy()
        self._umi = None

    def _lookup(self, table: np.ndarray):
        """(hit [R, n], index into the sorted `table`) of every read
        window."""
        if not len(table):
            return torch.zeros_like(self.ok), None
        t = torch.from_numpy(table).to(self.device)
        idx = torch.searchsorted(t, self.kmers).clamp_(max=len(table) - 1)
        return self.ok & (t[idx] == self.kmers), idx

    def umi_support(self, contig: Contig, min_frac: float = 0.5) -> None:
        """assembly.umi_support: the reads with at least `min_frac` of
        their valid K-mers on the contig, and their distinct UMIs."""
        if any(ch not in "ACGT" for ch in contig.seq):
            raise ValueError(f"contig base outside ACGT: {contig.seq!r}")
        km, _ = _seq_kmers(contig.seq)
        hit, _ = self._lookup(np.unique(km))
        hits = hit.sum(1).cpu().numpy()
        tot = self.tot
        sel = tot > 0
        sel[sel] = hits[sel] / tot[sel] >= min_frac
        contig.n_umis = len(np.unique(self.reads.umi[sel]))
        contig.n_reads = int(sel.sum())

    def _pileup(self, contig_seq: str):
        """The pileup's integer part, on the device: every observation
        (read base at a contig position) grouped by (position, UMI), each
        group's in read order; the groups of a position in the order
        their UMI is first seen there.  Returns host arrays: per
        observation its quality byte * 4 + base and its group id; the
        group ids in their order at the positions and, in that order,
        each group's position rank; the positions; or None."""
        from ..ops.tensor_ops import first_of_run

        L = len(contig_seq)
        km, pos = _seq_kmers(contig_seq)
        table, first = np.unique(km, return_index=True)
        hit, idx = self._lookup(table)
        if idx is None or not hit.shape[1]:
            return None
        dev = self.device
        s0 = hit.to(torch.int8).argmax(1)
        cpos = torch.from_numpy(pos[first]).to(dev)[
            idx.gather(1, s0[:, None])[:, 0]]
        rows = torch.nonzero(hit.any(1))[:, 0]
        if not len(rows):
            return None
        # contig position of read column c: c + (anchor's contig position
        # - anchor's column)
        col = torch.arange(self.codes.shape[1], device=dev)
        start = self.start[rows][:, None]
        p = col + (cpos - s0)[rows][:, None]
        keep = ((col >= start) & (col < self.end[rows][:, None])
                & self.valid[rows] & (p >= 0) & (p < L))
        rr, cc = torch.nonzero(keep, as_tuple=True)    # read order, column
        r = rows[rr]
        p = p[rr, cc]
        qlen = torch.from_numpy(self.reads.qlen).to(dev)
        qual = torch.from_numpy(self.reads.qual).to(dev)[r, cc]
        qb = torch.where(cc - self.start[r] < qlen[r], qual,
                         torch.full_like(qual, _PAST_QUAL))
        if self._umi is None:
            self._umi = torch.from_numpy(np.unique(
                self.reads.umi, return_inverse=True)[1].astype(np.int64)
            ).to(dev)
        key = p * (int(self._umi.max()) + 1) + self._umi[r]
        key, order = torch.sort(key, stable=True)
        newg = first_of_run(key)
        g = torch.cumsum(newg, 0) - 1
        gpos = p[order][newg]
        gfirst = r[order][newg]
        gorder = torch.sort(gpos * len(self.reads.umi) + gfirst).indices
        gp = gpos[gorder]
        newp = first_of_run(gp)
        host = lambda t: t.cpu().numpy()
        obs = qb.to(torch.int16) * 4 + self.codes[r, cc]
        return (host(obs[order]), host(g), host(gorder),
                host(torch.cumsum(newp, 0) - 1), host(gp[newp]))

    def contig_base_quals(self, contig_seq: str) -> np.ndarray:
        """assembly.contig_base_quals of the barcode's reads."""
        quals = np.zeros(len(contig_seq), np.uint8)
        pile = self._pileup(contig_seq)
        if pile is None:
            return quals
        obs, g, gorder, prank, positions = pile
        # per (position, UMI) group and base b: its observations' terms,
        # match or mismatch by quality, in read order
        base_probs = pileup_sums(obs, g, len(gorder), _TERMS)
        # per group and true base r: log10 P(the UMI's reads | r), clipped
        umi_lp = np.clip(_logsumexp10(base_probs[:, None, :] + _PRIOR[None]),
                         MIN_LOG_PROB, 0.0)
        # per position: its UMIs' terms in the order first seen there
        probs = _ordered_sums(prank, umi_lp[gorder], len(positions))
        denom = _logsumexp10(probs)
        best = probs.argmax(1)
        numer = _logsumexp10(np.take_along_axis(probs, _OTHERS[best], 1))
        quals[positions] = np.clip(-10.0 * (numer - denom), 0,
                                   MAX_OUT_QUAL).astype(np.int64)
        return quals


def primer_trim_starts(codes: np.ndarray, valid: np.ndarray,
                       length: np.ndarray, primers_rc: list[bytes],
                       device) -> np.ndarray:
    """assembly.trim_primer_read of every row at once: per primer its
    first hit in the read (columns [0, length) of the row, a base only
    where `valid`), kept if above 0; the trim start is the least kept
    hit, 0 if none.  Returns int64 [B]."""
    B, W = codes.shape
    if not B:
        return np.zeros(0, np.int64)
    c = torch.from_numpy(codes).to(device).long() & 3
    v = (torch.from_numpy(valid).to(device)
         & (torch.arange(W, device=device)
            < torch.from_numpy(np.asarray(length)).to(device)[:, None]))
    by_len: dict[int, list[int]] = {}
    for p in primers_rc:
        if not p or any(ch not in b"ACGT" for ch in p):
            raise ValueError(f"primer outside ACGT: {p!r}")
        packed = 0
        for ch in p:
            packed = (packed << 2) | int(_ACGT[ch])
        by_len.setdefault(len(p), []).append(packed)
    best = torch.zeros(B, dtype=torch.int64, device=device)
    km = None
    for m in range(1, min(max(by_len), W) + 1):
        n = W - m + 1
        km = (c[:, :n] if km is None
              else (km[:, :n] << 2) | c[:, m - 1:m - 1 + n])
        if m not in by_len:
            continue
        ok = _windows_valid(v, m)
        for packed in by_len[m]:
            hit = ok & (km == packed)
            q = hit.to(torch.int8).argmax(1)
            take = hit.any(1) & (q > 0) & ((best == 0) | (q < best))
            best = torch.where(take, q, best)
    return best.cpu().numpy()


class Annotator:
    """annotate.annotate_contig against one reference: each region's
    segments and their 16-mer sets are indexed once; a contig is aligned
    to the segments that share a 16-mer with it, in the reference's order,
    by the native local alignment.  `alignments` counts the calls."""

    def __init__(self, ref: VdjReference):
        self.regions = {}
        for region in ("V", "J", "C"):
            segs = ref.by_region(region)
            seqs = [s.seq.decode() for s in segs]
            index: dict[str, list[int]] = {}
            for i, s in enumerate(seqs):
                for km in _kmers(s):
                    index.setdefault(km, []).append(i)
            self.regions[region] = (segs, seqs, index)
        self.alignments = 0

    def best_hit(self, contig: str, region: str, min_score=40,
                 ck: set | None = None):
        segs, seqs, index = self.regions[region]
        ck = _kmers(contig) if ck is None else ck
        cand = sorted({i for km in ck for i in index.get(km, ())})
        best = None
        for i in cand:
            score, cs, ce, ss, se = local_align(contig, seqs[i])
            self.alignments += 1
            if score >= min_score and (best is None or score > best.score):
                best = SegmentHit(segs[i], score, cs, ce, ss, se)
        return best

    def annotate(self, contig: str) -> ContigAnnotation:
        ann = ContigAnnotation(contig_seq=contig)
        ck = _kmers(contig, KSEED)
        v = self.best_hit(contig, "V", ck=ck)
        j = self.best_hit(contig, "J", min_score=24, ck=ck)
        c = self.best_hit(contig, "C", min_score=24, ck=ck)
        ann.v, ann.j, ann.c = v, j, c
        if v is not None:
            ann.chain = v.segment.chain
        elif j is not None:
            ann.chain = j.segment.chain
        if v is not None and j is not None and v.contig_end <= j.contig_end:
            ann.full_length = True
            nt, aa = find_cdr3(contig, v.contig_end, j.contig_start,
                               j.contig_end)
            ann.cdr3_nt, ann.cdr3_aa = nt, aa
            if aa and "*" not in aa and len(nt) % 3 == 0:
                ann.productive = True
        return ann
