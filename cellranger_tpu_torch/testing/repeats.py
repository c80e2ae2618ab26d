"""A seeded repeat model of the human reference (GRCh38) for the count
fixtures of `fixtures.py`: the copy structure of each repeat family,
written over random bases, so that chromosome lengths stay what they are.
Nothing is downloaded; every consensus is drawn from the seed, because
the model needs how the copies relate, not the real Alu or L1 bases.

Figures, at GRCh38's 3,088,269,832 primary bases, and their sources
(named, not fetched); a smaller genome takes copy numbers and block sizes
in proportion to its length (`scale`), consensus lengths as they are:

  Alu              a 300-base consensus, ~1.1M copies, ~10% of bases, in
                   three age classes at 5 / 10 / 15% substitution (AluY /
                   AluS / AluJ; 15 / 60 / 25% of the copies), each class's
                   consensus 1% off the family's.  IHGSC 2001, Nature
                   409:860, Table 11.
  L1               a 6,000-base consensus, ~500k copies, ~17% of bases,
                   3% full length and the rest 5'-truncated (lognormal,
                   median 700 bases), 2-25% substitution.  Same table.
  simple repeats   (A)n, (CA)n, (GGAAT)n and five more units, runs of
                   20-200 bases, ~3% of bases, 3% substitution.  Same
                   table; RepeatMasker's simple-repeat class.
  alpha satellite  a 171-base monomer; each centromere holds its own
                   higher-order repeat of 4-16 monomers (25% apart),
                   tandem over the centromere at 1% substitution.  GRC's
                   GRCh38 release notes (GRCh38 models its centromeres);
                   positions and sizes are approximate (`CENTROMERES`).
  segmental dup.   ~5% of bases in blocks of 1-400 kb (log-uniform) at
                   90-99.9% identity (divergence log-uniform in 0.1-10%),
                   half within a chromosome, either orientation; and
                   whole genes with a paralog (`paralogs`).  Bailey et
                   al. 2002, Science 297:1003.
  N gaps           the short arms of chr13, 14, 15, 21 and 22 and the
                   heterochromatin of 1q12, 9q12, 16q11.2 and Yq12: 135.5
                   Mb (`GAPS`, approximate), against the ~150 Mb that
                   NCBI's GRCh38 assembly statistics give as total less
                   ungapped length.

Old families (AluJ and L1 copies at 10% substitution or more) take 1-3
indels of 1-3 bases.  Every copy's orientation is drawn.  The families'
copies avoid the genes' spans (a read's length on each side), and they
and the segmental duplications avoid `forbid` (chr1's repeat segment)
and the gaps and centromeres.  Then, in this order: the general
duplications (which may cover genes: such genes are no longer `clean`),
gene paralogs (a clean '+' gene's span copied onto another clean '+'
gene's at the same offsets, or into an intergenic stretch), one repeat
copy in exon 2 of some clean '+' genes (an Alu or an L1 3' end, like a
repeat in a 3' UTR, clear of the junction flank), and the N gaps.

The build is vectorized numpy, in chunks of `CHUNK` bases."""

from __future__ import annotations

import numpy as np

from .fixtures import GRCH38_CHROMS

GRCH38_BASES = 3_088_269_832
CHUNK = 1 << 24

ALU_LEN = 300
ALU_COPIES = 1_100_000
ALU_CLASSES = (("AluY", 0.05, 0.15), ("AluS", 0.10, 0.60),
               ("AluJ", 0.15, 0.25))      # name, substitution, share
ALU_CLASS_OFF = 0.01
L1_LEN = 6000
L1_COPIES = 500_000
L1_FULL = 0.03
L1_MEDIAN, L1_SIGMA = 700, 0.8
L1_DIV = (0.02, 0.25)
OLD_DIV = 0.10                             # copies this old take indels
SIMPLE_UNITS = ("A", "CA", "GGAAT", "AT", "AAAT", "CAG", "GATA", "AAAAC")
SIMPLE_RUN = (20, 200)
SIMPLE_FRAC = 0.03
SIMPLE_DIV = 0.03
ALPHA_MONOMER = 171
ALPHA_HOR = (4, 16)
ALPHA_MONOMER_DIV = 0.25
ALPHA_DIV = 0.01
SD_FRAC = 0.05
SD_LEN = (1_000, 400_000)
SD_DIV = (0.001, 0.10)
SD_INTRA = 0.5
PARALOG_DIV = (0.001, 0.01)
PARALOG_FLANK = 300                        # bases copied either side of a gene
GENE_SPAN = 2400
EXON_REPEAT_AT = (1450, 2350)              # a 3' part of exon 2

# approximate GRCh38 coordinates (bases): centromere models, and the N
# gaps named above
CENTROMERES = {
    "chr1": (121_700_000, 125_100_000), "chr2": (92_200_000, 94_100_000),
    "chr3": (90_500_000, 93_600_000), "chr4": (49_700_000, 51_700_000),
    "chr5": (46_500_000, 50_100_000), "chr6": (58_500_000, 59_800_000),
    "chr7": (58_100_000, 60_900_000), "chr8": (44_000_000, 45_900_000),
    "chr9": (43_000_000, 45_500_000), "chr10": (39_600_000, 41_600_000),
    "chr11": (51_100_000, 54_400_000), "chr12": (34_700_000, 37_200_000),
    "chr13": (16_000_000, 18_100_000), "chr14": (16_000_000, 18_200_000),
    "chr15": (17_000_000, 19_700_000), "chr16": (36_300_000, 38_300_000),
    "chr17": (22_800_000, 26_900_000), "chr18": (15_500_000, 20_900_000),
    "chr19": (24_500_000, 27_200_000), "chr20": (26_400_000, 30_000_000),
    "chr21": (10_900_000, 13_000_000), "chr22": (12_900_000, 15_100_000),
    "chrX": (58_100_000, 61_000_000), "chrY": (10_300_000, 10_600_000)}
GAPS = (("chr13", 0, 16_000_000), ("chr14", 0, 16_000_000),
        ("chr15", 0, 17_000_000), ("chr21", 0, 5_000_000),
        ("chr22", 0, 10_500_000), ("chr1", 125_100_000, 143_100_000),
        ("chr9", 45_500_000, 60_500_000), ("chr16", 38_300_000, 46_300_000),
        ("chrY", 26_600_000, 56_600_000))
GRCH38_LENS = dict(GRCH38_CHROMS)


def chrom_blocks(names, lens) -> list:
    """Each chromosome's gap and centromere blocks, [(start, end, kind)]
    sorted, kind "N" or "alpha": GRCh38's (`GAPS`, `CENTROMERES`) for a
    chromosome of that name, its coordinates scaled by the length given
    over GRCh38's."""
    out = []
    for name, n in zip(names, lens):
        f = int(n) / GRCH38_LENS[name] if name in GRCH38_LENS else 0.0
        b = [(int(a * f), int(e * f), "N") for c, a, e in GAPS if c == name]
        if name in CENTROMERES:
            a, e = CENTROMERES[name]
            b.append((int(a * f), int(e * f), "alpha"))
        out.append(sorted(x for x in b if x[1] > x[0]))
    return out


def gene_layout(lens, n_per, blocks, floor_first: int = 0):
    """Gene starts (0-based, each chromosome's own coordinates) laid out
    evenly over what each chromosome's blocks leave, and the blocks moved
    into the middle of the intergenic stretch nearest them, so that no
    gene meets a block: ([starts per chromosome], [blocks per
    chromosome], spacing per chromosome).  On the first chromosome no
    block starts before `floor_first` (chr1's repeat segment)."""
    starts, moved, spacing = [], [], []
    for c, (n, k, bl) in enumerate(zip(lens, n_per, blocks)):
        n, k = int(n), int(k)
        size = [e - a for a, e, _ in bl]
        eu = n - sum(size)
        sp = eu // max(k, 1)
        assert k == 0 or sp >= 3600, "genes need 3,400 bases"
        gap_mid = 1000 + GENE_SPAN + (sp - GENE_SPAN - 1000) // 2
        local = np.arange(k, dtype=np.int64) * sp + 1000
        shift = np.zeros(k, np.int64)
        out, before, lo = [], 0, floor_first if c == 0 else 0
        for (a, e, kind), s in zip(bl, size):
            q = a - before                         # where it cuts the rest
            if q >= 1000 or lo:
                q = max(q, lo)
                j = min(max((q - 1000) // max(sp, 1), 0), max(k - 1, 0))
                if k and q > j * sp + 1000:
                    q = j * sp + gap_mid
                if q < lo:
                    q = (j + 1) * sp + gap_mid
                q = min(q, eu)
            else:
                q = 0
            out.append((q + before, q + before + s, kind))
            shift[local > q] += s
            before += s
        starts.append(local + shift)
        moved.append(out)
        spacing.append(sp)
    return starts, moved, spacing


def _complement_intervals(G: int, bad):
    """Sorted merged [a, b) intervals `bad` (an [n, 2] array) -> the
    allowed (lo, hi) arrays of [0, G)."""
    a, b = _merge(np.clip(bad, 0, G))
    lo = np.concatenate([[0], b])
    hi = np.concatenate([a, [G]])
    keep = hi > lo
    return lo[keep], hi[keep]


def _sites(rng, lo, hi, lens):
    """Starts drawn uniformly over the allowed intervals (lo, hi), each
    copy cut to the end of its interval: (starts, lengths)."""
    lens = np.asarray(lens, np.int64)
    if len(lens) == 0:
        return np.zeros(0, np.int64), lens
    w = hi - lo
    cum = np.cumsum(w)
    u = (rng.random(len(lens)) * cum[-1]).astype(np.int64)
    i = np.searchsorted(cum, u, side="right")
    st = lo[i] + u - (cum[i] - w[i])
    return st, np.minimum(lens, hi[i] - st)


def _mutate(seq, thr, rng):
    """Substitutions in place: base i changes, with probability thr_i /
    65536, to one of the other three."""
    u = np.frombuffer(rng.bytes(2 * len(seq)), np.uint16)
    hit = np.flatnonzero(u < thr)
    seq[hit] = (seq[hit] + 1 + (u[hit] % 3).astype(np.uint8)) & 3


def _thr(div) -> np.ndarray:
    return (np.asarray(div) * 65536).astype(np.uint32)


def write_copies(codes, table, base, period, wrap, starts, lens, rc, div,
                 n_indel, rng):
    """Copies of consensus runs of `table` (codes 0-3) into `codes` at
    `starts`, each `lens` bases: copy i reads table[base_i + x] for x in
    [0, period_i) (wrapping for tandem units when `wrap`, else clipped),
    takes `n_indel`_i indels of 1-3 bases, substitutions at div_i, and is
    written reverse-complemented where rc_i.  Forward copies go first,
    then the reverse ones, each in chunks of about CHUNK bases."""
    args = [np.asarray(a) for a in (base, period, starts, lens, div,
                                    n_indel)]
    rc = np.asarray(rc, bool)
    for sel in (np.flatnonzero(~rc), np.flatnonzero(rc)):
        b, per, st, ln, dv, ni = (a[sel] for a in args)
        c = np.cumsum(ln)
        i0 = 0
        while i0 < len(sel):
            i1 = max(int(np.searchsorted(c, c[i0] - ln[i0] + CHUNK)), i0 + 1)
            _write_chunk(codes, table, b[i0:i1], per[i0:i1], wrap,
                         st[i0:i1], ln[i0:i1], bool(rc[sel[0]]), dv[i0:i1],
                         ni[i0:i1], rng)
            i0 = i1


def _write_chunk(codes, table, base, period, wrap, st, ln, rc, div, ni,
                 rng):
    T = int(ln.sum())
    if T == 0:
        return
    m = len(ln)
    first = (np.cumsum(ln) - ln).astype(np.int32)
    j = np.arange(T, dtype=np.int32)
    j -= np.repeat(first, ln)
    if ni.any():
        ev = np.repeat(np.arange(m), ni)
        off = (rng.random(len(ev)) * ln[ev]).astype(np.int64)
        d = rng.integers(1, 4, len(ev))
        ins = rng.random(len(ev)) < 0.5
        at = first[ev] + off
        delta = np.zeros(T, np.int32)
        np.add.at(delta, at, np.where(ins, -d, d).astype(np.int32))
        cum = np.cumsum(delta, dtype=np.int32)
        x = j + (cum - np.repeat(cum[first] - delta[first], ln))
        rnd = np.zeros(T, bool)
        for k in (0, 1, 2):
            mk = ins & (d > k) & (off + k < ln[ev])
            rnd[at[mk] + k] = True
    else:
        x, rnd = j, None
    per = np.repeat(period.astype(np.int32), ln)
    if wrap:
        x = np.mod(x, per)
    else:
        np.minimum(x, per - 1, out=x)
        np.maximum(x, 0, out=x)
    x += np.repeat(base.astype(np.int32), ln)
    seq = table[x]
    if rnd is not None and rnd.any():
        seq[rnd] = np.frombuffer(rng.bytes(int(rnd.sum())), np.uint8) & 3
    _mutate(seq, np.repeat(_thr(div), ln), rng)
    if rc:
        at = np.repeat(st.astype(np.int64) + ln - 1, ln)
        at -= j
        codes[at] = 3 - seq
    else:
        at = np.repeat(st.astype(np.int64), ln)
        at += j
        codes[at] = seq


def _drawn(rng, n: int) -> np.ndarray:
    return np.frombuffer(rng.bytes(n), np.uint8) & 3


def _off(cons, frac, rng):
    """A copy of consensus `cons` with `frac` of its bases changed."""
    c = cons.copy()
    _mutate(c, _thr(frac), rng)
    return c


def _interval_hits(a, b, lo, hi) -> np.ndarray:
    """bool per [a, b): meets any interval of the sorted merged (lo, hi)
    set (its complement's form, as _complement_intervals returns)."""
    if len(lo) == 0:
        return np.zeros(len(a), bool)
    i = np.searchsorted(lo, b, side="left") - 1
    return (i >= 0) & (hi[np.maximum(i, 0)] > a)


def _merge(iv) -> tuple:
    """[n, 2] intervals -> the sorted merged (lo, hi) of their union."""
    iv = np.asarray(iv, np.int64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if len(iv) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.flatnonzero(np.concatenate([[True],
                                         iv[1:, 0] > run_end[:-1]]))
    return iv[new, 0], np.maximum.reduceat(iv[:, 1], new)


def plant(codes, chrom_starts, blocks, seed, *, gene_start=None,
          forbid=(), n_reads_len: int = 91) -> dict:
    """The repeat model written over the random base codes `codes` (0-3,
    the whole genome; chromosome c from chrom_starts[c]), with N (code 4)
    and alpha satellite in `blocks` (each chromosome's, its own
    coordinates).  `gene_start` (the genes' exon-1 starts, whole-genome
    coordinates; gene g is '+' when g is even) turns on gene protection,
    the gene paralogs and the exon-2 copies; `forbid` lists more [a, b)
    intervals no copy may touch.  Copy numbers follow len(codes) over
    GRCh38's bases.  Returns the copies by family (`copies`: start,
    length, rc), the gene paralogs, the exon-2 copies, the genes no copy
    or duplication touches (`clean`) and the bases of each family."""
    rng = np.random.default_rng(seed)
    G = len(codes)
    scale = G / GRCH38_BASES
    cs = np.asarray(chrom_starts, np.int64)
    blk = np.asarray([(cs[c] + a, cs[c] + e) for c, bl in enumerate(blocks)
                      for a, e, _ in bl], np.int64).reshape(-1, 2)
    bad = [blk, np.asarray(forbid, np.int64).reshape(-1, 2)]
    L = n_reads_len + 8
    if gene_start is not None:
        gs = np.asarray(gene_start, np.int64)
        prot = np.stack([gs - L, gs + GENE_SPAN + L], 1)
    else:
        gs = np.zeros(0, np.int64)
        prot = np.zeros((0, 2), np.int64)
    lo, hi = _complement_intervals(G, np.concatenate(bad + [prot]))
    copies, bases = {}, {}

    def family(name, table, base, period, wrap, lens, div, old):
        st, ln = _sites(rng, lo, hi, lens)
        keep = ln > 0
        st, ln, base, period, div = (a[keep] for a in (st, ln, base, period,
                                                       div))
        rc = rng.random(len(st)) < 0.5
        ni = np.where(div >= OLD_DIV, rng.integers(1, 4, len(st)), 0) \
            if old else np.zeros(len(st), np.int64)
        write_copies(codes, table, base, period, wrap, st, ln, rc, div, ni,
                     rng)
        copies[name] = dict(start=st, length=ln, rc=rc)
        bases[name] = int(ln.sum())

    # Alu: a consensus and its three classes
    alu = _drawn(rng, ALU_LEN)
    tabs = [_off(alu, ALU_CLASS_OFF, rng) for _ in ALU_CLASSES]
    n_alu = int(round(ALU_COPIES * scale))
    cls = rng.choice(len(ALU_CLASSES), n_alu,
                     p=[s for _, _, s in ALU_CLASSES])
    div = np.asarray([d for _, d, _ in ALU_CLASSES])[cls]
    family("alu", np.concatenate(tabs), cls * ALU_LEN,
           np.full(n_alu, ALU_LEN), False, np.full(n_alu, ALU_LEN), div,
           True)
    alu_tables = tabs
    # L1: 5'-truncated copies are the consensus's 3' ends
    l1 = _drawn(rng, L1_LEN)
    n_l1 = int(round(L1_COPIES * scale))
    ln = np.clip(np.exp(rng.normal(np.log(L1_MEDIAN), L1_SIGMA, n_l1)),
                 50, L1_LEN).astype(np.int64)
    ln[rng.random(n_l1) < L1_FULL] = L1_LEN
    family("l1", l1, L1_LEN - ln, ln, False, ln,
           rng.uniform(*L1_DIV, n_l1), True)
    # simple repeats: tandem units
    units = [np.frombuffer(u.encode(), np.uint8) for u in SIMPLE_UNITS]
    look = np.zeros(256, np.uint8)
    look[list(b"ACGT")] = [0, 1, 2, 3]
    utab = np.concatenate([look[u] for u in units])
    uoff = np.cumsum([0] + [len(u) for u in units])[:-1]
    ulen = np.asarray([len(u) for u in units])
    n_s = int(round(SIMPLE_FRAC * G / (sum(SIMPLE_RUN) / 2)))
    which = rng.integers(0, len(units), n_s)
    family("simple", utab, uoff[which], ulen[which], True,
           rng.integers(SIMPLE_RUN[0], SIMPLE_RUN[1] + 1, n_s),
           np.full(n_s, SIMPLE_DIV), False)
    # alpha satellite: one higher-order repeat per centromere
    mono = _drawn(rng, ALPHA_MONOMER)
    sat = [(cs[c] + a, e - a) for c, bl in enumerate(blocks)
           for a, e, kind in bl if kind == "alpha"]
    hors = [np.concatenate([_off(mono, ALPHA_MONOMER_DIV, rng)
                            for _ in range(rng.integers(ALPHA_HOR[0],
                                                       ALPHA_HOR[1] + 1))])
            for _ in sat]
    if sat:
        htab = np.concatenate(hors)
        hoff = np.cumsum([0] + [len(h) for h in hors])[:-1]
        st = np.asarray([s for s, _ in sat], np.int64)
        ln = np.asarray([n for _, n in sat], np.int64)
        write_copies(codes, htab, hoff, np.asarray([len(h) for h in hors]),
                     True, st, ln, np.zeros(len(st), bool),
                     np.full(len(st), ALPHA_DIV), np.zeros(len(st), np.int64),
                     rng)
        copies["alpha"] = dict(start=st, length=ln,
                               rc=np.zeros(len(st), bool))
        bases["alpha"] = int(ln.sum())

    # segmental duplications, one block at a time (later ones copy what
    # earlier ones wrote); free of blocks and `forbid`, not of genes
    slo, shi = _complement_intervals(G, np.concatenate(bad))
    cap = min(SD_LEN[1], max(G // 500, SD_LEN[0] + 1))
    want = SD_FRAC * G
    lens = []
    while sum(lens) < want:
        lens.append(int(np.exp(rng.uniform(np.log(SD_LEN[0]),
                                           np.log(cap)))))
    tgt, tl = _sites(rng, slo, shi, lens)
    chrom_of = lambda p: np.searchsorted(cs, p, side="right") - 1  # noqa
    src = np.empty(len(tgt), np.int64)
    for i in range(len(tgt)):
        c = chrom_of(tgt[i])
        if rng.random() < SD_INTRA:
            a = cs[c]
            b = cs[c + 1] if c + 1 < len(cs) else G
            m = (slo < b) & (shi > a)
            s, n = _sites(rng, np.maximum(slo[m], a), np.minimum(shi[m], b),
                          [tl[i]])
        else:
            s, n = _sites(rng, slo, shi, [tl[i]])
        src[i] = s[0]
        tl[i] = min(tl[i], n[0])
    sd_rc = rng.random(len(tgt)) < 0.5
    sd_div = np.exp(rng.uniform(np.log(SD_DIV[0]), np.log(SD_DIV[1]),
                                len(tgt)))
    for i in range(len(tgt)):
        seg = codes[src[i]:src[i] + tl[i]].copy()
        if sd_rc[i]:
            seg = 3 - seg[::-1]
        _mutate(seg, _thr(sd_div[i]), rng)
        codes[tgt[i]:tgt[i] + tl[i]] = seg
    copies["sd"] = dict(start=tgt, length=tl, rc=sd_rc, source=src,
                        div=sd_div)
    bases["sd"] = int(tl.sum())

    out = dict(copies=copies, bases=bases, alu_tables=alu_tables, l1=l1,
               paralogs=None, exon_repeat=None, clean=None)
    if len(gs):
        span = np.stack([gs - L, gs + GENE_SPAN + L], 1)
        touched = np.zeros(len(gs), bool)
        for a, n in ((tgt, tl), (src, tl)):
            mlo, mhi = _merge(np.stack([a, a + n], 1))
            touched |= _interval_hits(span[:, 0], span[:, 1], mlo, mhi)
        clean = ~touched
        out.update(_gene_plants(codes, cs, gs, clean, blk, forbid,
                                alu_tables, l1, rng, L))
    # N gaps last
    for c, bl in enumerate(blocks):
        for a, e, kind in bl:
            if kind == "N":
                codes[cs[c] + a:cs[c] + e] = 4
    bases["N"] = int(sum(e - a for bl in blocks for a, e, k in bl
                         if k == "N"))
    return out


def _gene_plants(codes, cs, gs, clean, blk, forbid, alu_tables, l1, rng,
                 L) -> dict:
    """Gene paralogs and exon-2 repeat copies over the clean '+' genes
    whose reach (a paralog's flanks and a read on each side) is clear of
    the blocks and `forbid` (see the module docstring); returns them and
    the genes left clean."""
    n = len(gs)
    bl = np.concatenate([blk, np.asarray(forbid, np.int64).reshape(-1, 2)])
    blo, bhi = _merge(bl)
    reach = PARALOG_FLANK + L          # what a plant may write around a gene
    free = ~_interval_hits(gs - reach, gs + GENE_SPAN + reach, blo, bhi)
    plus = np.flatnonzero(clean & free & (np.arange(n) % 2 == 0))
    n_par = min(max(4, n // 150), len(plus) // 8)
    n_er = min(max(8, n // 40), len(plus) // 4)
    pick = rng.permutation(plus)
    par_src = pick[:n_par]
    genic = np.arange(n_par) % 2 == 0             # half onto another gene
    par_tgt_gene = np.full(n_par, -1)
    par_tgt_gene[genic] = pick[n_par:n_par + int(genic.sum())]
    used = set(pick[:n_par + int(genic.sum())].tolist())
    pre, span = PARALOG_FLANK, GENE_SPAN + 2 * PARALOG_FLANK
    # an intergenic twin: the middle of the stretch after a clean gene
    # whose next gene is far enough, on its chromosome, clear of blocks
    # and `forbid`
    nxt = np.concatenate([gs[1:], [gs[-1] + 10 * span]])
    room = nxt - (gs + GENE_SPAN)
    mid = gs + GENE_SPAN + room // 2 - span // 2
    chrom = np.searchsorted(cs, gs, side="right")
    ok = ((room >= span + 4 * L) & clean
          & (np.searchsorted(cs, mid + span + L, side="right") == chrom)
          & ~_interval_hits(mid - L, mid + span + L, blo, bhi))
    ok[list(used)] = False
    ok[n - 1] = False
    site_gene = rng.permutation(np.flatnonzero(ok))[:int((~genic).sum())]
    tgt = np.empty(n_par, np.int64)
    tgt[genic] = gs[par_tgt_gene[genic]] - pre
    tgt[~genic] = mid[site_gene]
    keep = np.ones(n_par, bool)
    keep[~genic] = np.arange(int((~genic).sum())) < len(site_gene)
    par_src, par_tgt_gene, tgt = par_src[keep], par_tgt_gene[keep], tgt[keep]
    div = np.exp(rng.uniform(np.log(PARALOG_DIV[0]), np.log(PARALOG_DIV[1]),
                             len(par_src)))
    for g, t, d in zip(par_src, tgt, div):
        seg = codes[gs[g] - pre:gs[g] - pre + span].copy()
        _mutate(seg, _thr(d), rng)
        codes[t:t + span] = seg
    clean = clean.copy()
    clean[par_src] = False
    clean[par_tgt_gene[par_tgt_gene >= 0]] = False
    # exon-2 repeat copies in other clean '+' genes
    rest = np.asarray([g for g in pick[n_par + int(genic.sum()):]
                       if clean[g]], np.int64)[:n_er]
    is_l1 = rng.random(len(rest)) < 0.2
    cls = rng.choice(len(ALU_CLASSES), len(rest),
                     p=[s for _, _, s in ALU_CLASSES])
    ln = np.where(is_l1, rng.integers(300, 800, len(rest)), ALU_LEN)
    room = EXON_REPEAT_AT[1] - EXON_REPEAT_AT[0] - ln
    st = gs[rest] + EXON_REPEAT_AT[0] + (rng.random(len(rest))
                                         * room).astype(np.int64)
    table = np.concatenate(alu_tables + [l1])
    base = np.where(is_l1, len(alu_tables) * ALU_LEN + L1_LEN - ln,
                    cls * ALU_LEN)
    div = np.where(is_l1, rng.uniform(*L1_DIV, len(rest)),
                   np.asarray([d for _, d, _ in ALU_CLASSES])[cls])
    rc = rng.random(len(rest)) < 0.5
    ni = np.where(div >= OLD_DIV, rng.integers(1, 4, len(rest)), 0)
    write_copies(codes, table, base, ln, False, st, ln, rc, div, ni, rng)
    return dict(
        clean=clean,
        paralogs=dict(gene=par_src, twin_gene=par_tgt_gene, twin_start=tgt,
                      start=gs[par_src] - pre, length=np.full(
                          len(par_src), span), div=div),
        exon_repeat=dict(gene=rest, start=st, length=ln, rc=rc, l1=is_l1))
