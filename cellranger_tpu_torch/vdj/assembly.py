"""Per-barcode contig assembly (the vdj_asm_utils analog,
lib/rust/vdj_asm_utils/src/process.rs:610 process_barcode +
ref_free.rs:118 strong_paths).

Device/host split: the heavy, regular work -- counting (barcode, UMI,
kmer) multiplicities across ALL reads of the run -- happens on the device
as sorts and segmented counts; the branchy, data-dependent unitig walking
runs on the host over the (small) per-barcode kmer spectra.

k = 20 like the reference (process.rs:610 hyperbase k=20).

Port of cellranger_tpu/vdj/assembly.py.  The device half
(`_rolling_kmers_2w`, `count_bc_kmers`, `count_bc_umi_kmers`) is plain
torch on the device it is given; everything else is the original's code,
unchanged.  A kmer's two u32 words (hi = leading 4 bases, lo = trailing
16) join into one 40-bit value, and the (barcode[, UMI]) columns of a
read become its dense rank among the run's distinct values, so the sort
key of a kmer row is one int64, rank << 40 | kmer, whose order is the
original's unsigned (barcode, [UMI,] hi, lo) order.  Reads are taken in
blocks of about `chunk` kmer rows; each block is sorted and counted on the
device and the partial counts are merged there again, so the outputs equal
the original's whatever the blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

K = 20
K_HI = K - 16          # leading bases in the hi key word
MIN_KMER_COUNT = 2     # graph cleaning: drop singleton kmers (sequencing errors)
MIN_CONTIG_LEN = 45
MASK = np.uint64((1 << (2 * K)) - 1)


def _rolling_kmers_2w(rna, nmask, *, device):
    """Rolling K=20-mers as (hi, lo) u32 words (int64) + validity
    [B, L-K+1], computed on `device`."""
    from ..align.aligner import _rolling_kmers, _window_valid
    rna = torch.as_tensor(rna).to(device)
    nmask = torch.as_tensor(nmask).to(device)
    L = rna.shape[1]
    nk = L - K + 1
    hi = _rolling_kmers(rna, K_HI)[:, :nk]
    lo = _rolling_kmers(rna, 16)[:, K_HI:K_HI + nk]
    return hi, lo, _window_valid(nmask, K)


KMER_BITS = 2 * K
KMER_MASK = (1 << KMER_BITS) - 1
RANKS_PER_KEY = 1 << (63 - KMER_BITS)   # ranks that fit above a kmer
DEFAULT_CHUNK = 1 << 26                 # kmer rows sorted at once


def _sort_count(key: torch.Tensor, cnt: torch.Tensor | None):
    """Distinct keys, ascending, and the number of rows (or the sum of
    `cnt`) behind each."""
    from ..ops.tensor_ops import first_of_run, seg_ids, segment_sum
    key, order = torch.sort(key)
    new = first_of_run(key)
    w = torch.ones_like(key) if cnt is None else cnt[order]
    return key[new], segment_sum(w, seg_ids(new), int(new.sum()))


def _kmer_spectrum(cols: list, rna: np.ndarray, nmask: np.ndarray,
                   chunk: int, device):
    """Distinct (cols..., kmer) rows over every valid K-mer of every read,
    in the unsigned order of those columns, with the number of K-mer
    occurrences behind each.  cols: u32 arrays [N] (barcode[, UMI]).
    Returns host arrays: each column uint32, kmer uint64, count int32."""
    from ..ops.tensor_ops import first_of_run, lexsort, seg_ids
    N, L = rna.shape
    nk = L - K + 1
    c = [torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)
         for x in cols]
    perm = lexsort(*c)
    new = first_of_run(*[x[perm] for x in c])
    rank = torch.empty_like(perm)
    rank[perm] = seg_ids(new)
    distinct = [x[perm][new] for x in c]
    n_rank = int(new.sum())
    rows_per_block = max(1, chunk // max(nk, 1))
    groups = [(0, np.arange(N))]
    if n_rank > RANKS_PER_KEY:
        # a kmer key holds ranks below 2^23: one pass per range of ranks,
        # the passes in rank order
        rank_host = rank.cpu().numpy()
        groups = [(g0, np.flatnonzero((rank_host >= g0)
                                      & (rank_host < g0 + RANKS_PER_KEY)))
                  for g0 in range(0, n_rank, RANKS_PER_KEY)]
    ranks, kmers, counts = [], [], []
    for g0, rows in groups:
        parts = []
        for s in range(0, len(rows), rows_per_block):
            r = rows[s:s + rows_per_block]
            hi, lo, ok = _rolling_kmers_2w(rna[r], nmask[r], device=device)
            rk = rank[torch.from_numpy(r).to(device)] - g0
            key = ((rk[:, None] << KMER_BITS) | (hi << 32) | lo)[ok]
            if key.numel():
                parts.append(_sort_count(key, None))
        if len(parts) > 1:
            # a block boundary may split a run of equal keys: merge the
            # partial counts again
            parts = [_sort_count(torch.cat([k for k, _ in parts]),
                                 torch.cat([n for _, n in parts]))]
        for k, n in parts:
            ranks.append((k >> KMER_BITS) + g0)
            kmers.append(k & KMER_MASK)
            counts.append(n)
    if not counts:
        return ([np.zeros(0, np.uint32) for _ in cols]
                + [np.zeros(0, np.uint64), np.zeros(0, np.int32)])
    r = torch.cat(ranks)
    return ([d[r].cpu().numpy().astype(np.uint32) for d in distinct]
            + [torch.cat(kmers).cpu().numpy().astype(np.uint64),
               torch.cat(counts).cpu().numpy().astype(np.int32)])


def count_bc_kmers(bc: np.ndarray, rna: np.ndarray, nmask: np.ndarray,
                   chunk: int = DEFAULT_CHUNK, *, device):
    """Device: distinct (barcode, kmer) counts over all reads.

    bc uint32 [N], rna uint8 [N, L]. Returns (bc, kmer uint64, count)
    host arrays, sorted by (bc, kmer).
    """
    return tuple(_kmer_spectrum([bc], rna, nmask, chunk, device))


@dataclass
class Contig:
    seq: str
    kmer_support: int        # total kmer multiplicity along the path
    n_umis: int = 0
    n_reads: int = 0


def _decode(km: int, k: int = K) -> str:
    return "".join("ACGT"[(km >> (2 * (k - 1 - i))) & 3] for i in range(k))


def assemble_barcode(kmers: dict[int, int]) -> list[Contig]:
    """Greedy unitig assembly over a barcode's kmer spectrum: from each
    unused seed (highest count first), extend right/left choosing the
    highest-count neighbor (the reference's strong-path heuristic,
    ref_free.rs:118,316)."""
    live = {km: c for km, c in kmers.items() if c >= MIN_KMER_COUNT}
    used: set[int] = set()
    contigs: list[Contig] = []
    mask = (1 << (2 * K)) - 1

    def succ(km):
        base = (km << 2) & mask
        return [(base | b) for b in range(4)]

    def pred(km):
        base = km >> 2
        return [(base | (b << (2 * (K - 1)))) for b in range(4)]

    for seed in sorted(live, key=lambda x: -live[x]):
        if seed in used:
            continue
        path = [seed]
        used.add(seed)
        support = live[seed]
        # extend right
        cur = seed
        while True:
            cands = [(live[s], s) for s in succ(cur) if s in live and s not in used]
            if not cands:
                break
            c, nxt = max(cands)
            path.append(nxt)
            used.add(nxt)
            support += c
            cur = nxt
        # extend left
        cur = seed
        left = []
        while True:
            cands = [(live[p], p) for p in pred(cur) if p in live and p not in used]
            if not cands:
                break
            c, prv = max(cands)
            left.append(prv)
            used.add(prv)
            support += c
            cur = prv
        path = left[::-1] + path
        seq = _decode(path[0]) + "".join("ACGT"[km & 3] for km in path[1:])
        if len(seq) >= MIN_CONTIG_LEN:
            contigs.append(Contig(seq=seq, kmer_support=int(support)))
    contigs.sort(key=lambda c: (-len(c.seq), -c.kmer_support))
    return contigs


def umi_support(contig: Contig, reads: list,
                min_frac: float = 0.5) -> None:
    """Count reads/UMIs whose kmers mostly land on the contig
    (the UMI-support filter of strong paths)."""
    ckmers = set()
    s = contig.seq
    for i in range(len(s) - K + 1):
        km = 0
        for ch in s[i:i + K]:
            km = (km << 2) | "ACGT".index(ch)
        ckmers.add(km)
    umis = set()
    n_reads = 0
    for umi, read, *_ in reads:
        tot = hits = 0
        km = 0
        valid = 0
        for i, ch in enumerate(read):
            if ch not in "ACGT":
                valid = 0
                continue
            km = ((km << 2) | "ACGT".index(ch)) & ((1 << (2 * K)) - 1)
            valid += 1
            if valid >= K:
                tot += 1
                if km in ckmers:
                    hits += 1
        if tot and hits / tot >= min_frac:
            umis.add(umi)
            n_reads += 1
    contig.n_umis = len(umis)
    contig.n_reads = n_reads


# ---------------------------------------------------------------------------
# Inner enrichment primers (vdj_asm_utils/src/primers.rs:29-74 — constant
# oligo sequences, shared facts) + primer trimming (process.rs:730-758):
# a read containing the reverse complement of an inner primer is cut so
# only the primer match and everything 3' of it (in read orientation)
# survives — the 5' side is primer-derived enrichment sequence.
# ---------------------------------------------------------------------------
INNER_PRIMERS = {
    ("human", "tcr"): [b"AGTCTCTCAGCTGGTACACG", b"TCTGATGGCTCAAACACAGC"],
    ("human", "bcr"): [b"GGGAAGTTTCTGGCGGTCA", b"GGTGGTACCCAGTTATCAAGCAT",
                       b"GTGTCCCAGGTCACCATCAC", b"TCCTGAGGACTGTAGGACAGC",
                       b"CACGCTGCTCGTATCCGA", b"TAGCTGCTGGCCGC",
                       b"GCGTTATCCACCTTCCACTGT"],
    ("mouse", "tcr"): [b"AGTCAAAGTCGGTGAACAGGCA", b"GGCCAAGCACACGAGGGTA"],
    ("mouse", "bcr"): [b"TACACACCAGTGTGGCCTT", b"CAGGCCACTGTCACACCACT",
                       b"CAGGTCACATTCATCGTGCCG", b"GAGGCCAGCACAGTGACCT",
                       b"GCAGGGAAGTTCACAGTGCT", b"CTGTTTGAGATCAGTTTGCCATCCT",
                       b"TGCGAGGTGGCTAGGTACTTG", b"CCCTTGACCAGGCATCC",
                       b"AGGTCACGGAGGAACCAGTTG", b"GGCATCCCAGTGTCACCGA",
                       b"AGAAGATCCACTTCACCTTGAAC", b"GAAGCACACGACTGAGGCAC"],
}

_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _revcomp_b(s: bytes) -> bytes:
    return s.translate(_RC)[::-1]


def all_inner_primers() -> list[bytes]:
    out = []
    for v in INNER_PRIMERS.values():
        out.extend(v)
    return out


def trim_primer_read(seq: str, primers_rc: list[bytes]) -> int:
    """Return the trim START for a read: the first position of the
    LEFTMOST reverse-complemented inner-primer hit (0 = no trim)."""
    sb = seq.encode() if isinstance(seq, str) else seq
    best = 0
    for p in primers_rc:
        q = sb.find(p)
        if q > 0 and (best == 0 or q < best):
            best = q
    return best


# ---------------------------------------------------------------------------
# UMI-aware de Bruijn graph with the reference's cleaning suite
# (ref_free.rs:422-810) re-expressed over a kmer spectrum: an "edge" is a
# kmer; a branch point is a (K-1)-mer with multiple extensions; support is
# per-(kmer, umi) read counts.
# ---------------------------------------------------------------------------
BRANCH_MIN_RATIO = 10   # branch_clean / comp_clean / power_clean
SOLO_MIN_RATIO = 5      # solo_clean
SOLO_MIN_READS = 10


class BarcodeGraph:
    """Per-barcode kmer graph: kmer -> {umi: read count}."""

    def __init__(self, support: dict[int, dict[int, int]]):
        self.support = {km: dict(us) for km, us in support.items()}

    @staticmethod
    def from_triples(kmers: np.ndarray, umis: np.ndarray,
                     counts: np.ndarray) -> "BarcodeGraph":
        sup: dict[int, dict[int, int]] = {}
        for km, u, c in zip(kmers.tolist(), umis.tolist(), counts.tolist()):
            sup.setdefault(km, {})[u] = sup.get(km, {}).get(u, 0) + c
        return BarcodeGraph(sup)

    def reads_of(self, km: int) -> int:
        return sum(self.support.get(km, {}).values())

    def umis_of(self, km: int) -> int:
        return len(self.support.get(km, {}))

    def _branches(self):
        """Yield (prefix, [kmers]) groups of >=2 kmers sharing a (K-1)-mer
        prefix (out-branch points)."""
        by_prefix: dict[int, list[int]] = {}
        for km in self.support:
            by_prefix.setdefault(km >> 2, []).append(km)
        for pre, kms in by_prefix.items():
            if len(kms) >= 2:
                yield pre, kms

    def branch_clean(self):
        """For each branch and each UMI: if one branch has >=10x the
        UMI's reads of another, delete that UMI's support on the weak
        branch (ref_free.rs:536-540)."""
        for _, kms in self._branches():
            umis = set()
            for km in kms:
                umis.update(self.support[km])
            for u in umis:
                counts = [(self.support[km].get(u, 0), km) for km in kms]
                best = max(c for c, _ in counts)
                for c, km in counts:
                    if c and c * BRANCH_MIN_RATIO <= best:
                        del self.support[km][u]
        self._drop_empty()

    def power_clean(self):
        """If a branch has >=10x the UMIs AND >=10x the reads of a
        sibling, delete the weak sibling entirely (ref_free.rs:725-729)."""
        dead = []
        for _, kms in self._branches():
            for km1 in kms:
                for km2 in kms:
                    if km1 == km2 or km2 in dead:
                        continue
                    if (self.umis_of(km1) >= BRANCH_MIN_RATIO
                            * max(self.umis_of(km2), 1)
                            and self.umis_of(km2) > 0
                            and self.reads_of(km1) >= BRANCH_MIN_RATIO
                            * max(self.reads_of(km2), 1)):
                        dead.append(km2)
        for km in dead:
            self.support.pop(km, None)

    def solo_clean(self):
        """At well-supported branch points, delete branches carried by a
        single UMI with few reads when a sibling is >=5x stronger
        (ref_free.rs:786-800 spirit)."""
        dead = []
        for _, kms in self._branches():
            strongest = max(self.reads_of(km) for km in kms)
            if strongest < SOLO_MIN_READS:
                continue
            for km in kms:
                r = self.reads_of(km)
                if (self.umis_of(km) == 1 and r * SOLO_MIN_RATIO <= strongest
                        and km not in dead):
                    dead.append(km)
        for km in dead:
            self.support.pop(km, None)

    def comp_clean(self):
        """Per UMI: if one connected component holds >=10x the UMI's
        reads of another, delete the UMI's support in the weak component
        (ref_free.rs:640-647)."""
        comp = self._components()
        by_umi: dict[int, dict[int, int]] = {}
        for km, us in self.support.items():
            c = comp[km]
            for u, n in us.items():
                by_umi.setdefault(u, {})
                by_umi[u][c] = by_umi[u].get(c, 0) + n
        for u, per_comp in by_umi.items():
            best = max(per_comp.values())
            weak = {c for c, n in per_comp.items()
                    if n * BRANCH_MIN_RATIO <= best}
            if not weak:
                continue
            for km, us in self.support.items():
                if comp[km] in weak:
                    us.pop(u, None)
        self._drop_empty()

    def _components(self) -> dict[int, int]:
        """kmer -> component id via (K-1)-mer overlap union-find."""
        parent: dict[int, int] = {}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for km in self.support:
            parent[km] = km
        by_prefix: dict[int, int] = {}
        by_suffix: dict[int, int] = {}
        mask_km1 = (1 << (2 * (K - 1))) - 1
        for km in self.support:
            pre = km >> 2          # leading (K-1)-mer
            suf = km & mask_km1    # trailing (K-1)-mer
            if pre in by_suffix:
                union(km, by_suffix[pre])
            if suf in by_prefix:
                union(km, by_prefix[suf])
            by_prefix[pre] = km
            by_suffix[suf] = km
        # second pass: link all kmers sharing overlap nodes
        for km in self.support:
            pre, suf = km >> 2, km & mask_km1
            union(km, by_prefix.get(pre, km) if pre in by_prefix else km)
            if suf in by_suffix:
                union(km, by_suffix[suf])
        return {km: find(km) for km in self.support}

    def clean(self):
        """The reference's pass order: per-UMI incompatibility-style
        branch cleaning, component cleaning, then structural branch
        removal (process.rs invokes the suite in sequence)."""
        self.branch_clean()
        self.comp_clean()
        self.power_clean()
        self.solo_clean()
        return self

    def _drop_empty(self):
        for km in [km for km, us in self.support.items() if not us]:
            del self.support[km]

    def spectrum(self) -> dict[int, int]:
        """Collapse to kmer -> total reads (assemble_barcode input)."""
        return {km: sum(us.values()) for km, us in self.support.items()}


def count_bc_umi_kmers(bc: np.ndarray, umi: np.ndarray, rna: np.ndarray,
                       nmask: np.ndarray, chunk: int = DEFAULT_CHUNK, *,
                       device):
    """Device: distinct (barcode, umi, kmer) read counts over all reads,
    sorted by (barcode, umi, kmer): bc uint32, umi uint32, kmer uint64,
    count int32 host arrays."""
    return tuple(_kmer_spectrum([bc, umi], rna, nmask, chunk, device))


# ---------------------------------------------------------------------------
# Per-base contig quality from the read pileup (sw.rs:59 pos_base_quals):
# per UMI, per base, accumulate log-probabilities of the observed reads
# given each true base; combine UMIs with an RT error prior; emit
# Q = -10 log10 P(other bases | data), capped.
# ---------------------------------------------------------------------------
RT_ERR = 1e-4
MAX_READ_QUAL = 30
MAX_OUT_QUAL = 60
MIN_LOG_PROB = -100.0


def contig_base_quals(contig_seq: str, reads: list[tuple[int, str, bytes]]
                      ) -> np.ndarray:
    """reads: (umi, seq, qual bytes phred+33).  Reads anchor to the contig
    by their first shared kmer; per-position per-UMI Bayesian pileup.
    Returns uint8 phred quals per contig base."""
    L = len(contig_seq)
    ckmers = {}
    for i in range(L - K + 1):
        km = 0
        ok = True
        for ch in contig_seq[i:i + K]:
            if ch not in "ACGT":
                ok = False
                break
            km = (km << 2) | "ACGT".index(ch)
        if ok and km not in ckmers:
            ckmers[km] = i
    # pileup[pos] -> {umi: [(base, qual), ...]}
    pileup: list[dict] = [dict() for _ in range(L)]
    for umi, seq, qual in reads:
        km = 0
        valid = 0
        anchor = None
        for i, ch in enumerate(seq):
            if ch not in "ACGT":
                valid = 0
                continue
            km = ((km << 2) | "ACGT".index(ch)) & ((1 << (2 * K)) - 1)
            valid += 1
            if valid >= K and km in ckmers:
                anchor = (ckmers[km], i - K + 1)
                break
        if anchor is None:
            continue
        cpos0, rpos0 = anchor
        off = cpos0 - rpos0
        for i, ch in enumerate(seq):
            p = i + off
            if 0 <= p < L and ch in "ACGT":
                q = (qual[i] - 33) if i < len(qual) else 30
                pileup[p].setdefault(umi, []).append(
                    ("ACGT".index(ch), min(q, MAX_READ_QUAL)))

    quals = np.zeros(L, np.uint8)
    lf1 = np.log10(1.0 - RT_ERR)
    lf2 = np.log10(RT_ERR / 3.0)
    for p in range(L):
        if not pileup[p]:
            continue
        probs = np.zeros(4)
        for umi, obs in pileup[p].items():
            base_probs = np.zeros((4, 4))   # [true r][umi base b]
            for base, q in obs:
                match = np.log10(max(1.0 - 10 ** (-q / 10.0), 1e-10))
                mismatch = -q / 10.0 - np.log10(3.0)
                for b in range(4):
                    base_probs[:, b] += match if b == base else mismatch
            for r in range(4):
                row = base_probs[r].copy()
                for b in range(4):
                    row[b] += lf1 if b == r else lf2
                m = row.max()
                probs[r] += np.clip(
                    m + np.log10(np.sum(10 ** (row - m))),
                    MIN_LOG_PROB, 0.0)
        denom_m = probs.max()
        denom = denom_m + np.log10(np.sum(10 ** (probs - denom_m)))
        r = int(np.argmax(probs))
        others = np.delete(probs, r)
        om = others.max()
        numer = om + np.log10(np.sum(10 ** (others - om)))
        quals[p] = int(np.clip(-10.0 * (numer - denom), 0, MAX_OUT_QUAL))
    return quals
