"""Deterministic synthetic run fixtures — the cellranger_tiny_fastq /
cellranger_tiny_ref analog (third-party/cellranger_tiny_ref.BUILD).

The reference ships a tiny but complete dataset that `cellranger testrun`
drives end-to-end (cr_wrap/src/bin/cellranger.rs:579-639); our equivalent
is generated: a seeded RNG builds a spliced 2-gene reference package,
whitelist, and gzipped FASTQs with known per-cell ground truth (cells x
molecules x duplicate reads, barcode errors, N-base junk reads).  The same
seed always produces byte-identical inputs, so golden snapshots of the
outputs gate regressions (tests/test_conformance.py).

Copied from cellranger_tpu/testing/fixtures.py (`build_synthetic_run`,
`build_rich_run`) and bench.py (the 1M-read e2e generator); all build
their reference through the port's ReferencePackage, so a machine without
JAX makes its own data, byte for byte the JAX package's.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import time

import numpy as np

READ_LEN = 91

EXONS = {
    "G1": [(10_000, 12_000), (15_000, 17_000)],   # spliced, + strand
    "G2": [(60_000, 64_000)],                      # single exon, - strand
}
STRANDS = {"G1": "+", "G2": "-"}


def build_synthetic_run(tmp: str, seed: int = 11, genome_len: int = 120_000,
                        n_wl: int = 2000, n_cells: int = 40,
                        mols_per_cell: int = 25, dup_reads: int = 2,
                        read_len: int = READ_LEN) -> dict:
    """Build reference package + whitelist + FASTQs under `tmp`.

    Returns dict(ref, wl, fq1, fq2, truth [2 x n_cells molecule counts],
    cells [whitelist indices], wl_seqs, n_reads).
    """
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome_codes = rng.integers(0, 4, genome_len).astype(np.uint8)
    genome = bases[genome_codes].tobytes().decode()

    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "genome.fa")
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, genome_len, 80):
            f.write(genome[i:i + 80] + "\n")
    gtf = os.path.join(tmp, "genes.gtf")
    with open(gtf, "w") as f:
        for gname, exs in EXONS.items():
            s = STRANDS[gname]
            lo, hi = exs[0][0] + 1, exs[-1][1]
            attr = (f'gene_id "{gname}"; gene_name "{gname}"; '
                    f'transcript_id "T_{gname}";')
            f.write(f"chr1\tsyn\tgene\t{lo}\t{hi}\t.\t{s}\t.\t{attr}\n")
            f.write(f"chr1\tsyn\ttranscript\t{lo}\t{hi}\t.\t{s}\t.\t{attr}\n")
            for (a, b) in exs:
                f.write(f"chr1\tsyn\texon\t{a + 1}\t{b}\t.\t{s}\t.\t{attr}\n")

    from ..io.reference import ReferencePackage
    ref_dir = os.path.join(tmp, "ref")
    ReferencePackage.build(fasta, gtf, ref_dir, genome_name="synth",
                           device=None)

    wl_seqs = sorted({"".join(rng.choice(list("ACGT"), 16))
                      for _ in range(n_wl + 200)})[:n_wl]
    wl_path = os.path.join(tmp, "whitelist.txt")
    with open(wl_path, "w") as f:
        f.write("\n".join(wl_seqs) + "\n")

    cells = rng.choice(n_wl, n_cells, replace=False)
    r1s, r2s = [], []
    truth = np.zeros((2, n_cells), np.int64)  # gene x cell molecules

    def tx_seq(gname):
        s = "".join(genome[a:b] for (a, b) in EXONS[gname])
        if STRANDS[gname] == "-":
            comp = str.maketrans("ACGT", "TGCA")
            s = s.translate(comp)[::-1]
        return s

    txs = {g: tx_seq(g) for g in EXONS}
    seen_umi = set()
    for ci, c in enumerate(cells):
        bc = wl_seqs[c]
        for m in range(mols_per_cell):
            gname = "G1" if (ci + m) % 2 == 0 else "G2"
            gi_ = 0 if gname == "G1" else 1
            while True:
                umi = "".join(rng.choice(list("ACGT"), 12))
                if (c, gi_, umi) not in seen_umi:
                    seen_umi.add((c, gi_, umi))
                    break
            t = txs[gname]
            # 3' assay: cDNA read sense = transcript sense for SC3Pv3 R2
            start = int(rng.integers(0, len(t) - read_len))
            cdna = t[start:start + read_len]
            truth[gi_, ci] += 1
            for d in range(dup_reads):
                # sprinkle: a barcode error on some duplicate reads
                bc_obs = bc
                if d == 1 and m % 5 == 0:
                    p = int(rng.integers(16))
                    alt = "ACGT"[(("ACGT".index(bc[p])) + 1) % 4]
                    bc_obs = bc[:p] + alt + bc[p + 1:]
                r1s.append(bc_obs + umi)
                r2s.append(cdna)
    # junk reads: N bases, garbage barcodes
    for _ in range(50):
        r1s.append("N" * 16 + "A" * 12)
        r2s.append("".join(rng.choice(list("ACGT"), read_len)))

    order = rng.permutation(len(r1s))
    fq1 = os.path.join(tmp, "sample_S1_L001_R1_001.fastq.gz")
    fq2 = os.path.join(tmp, "sample_S1_L001_R2_001.fastq.gz")
    # fixed mtime so the gzip payload is byte-stable across rebuilds
    with open(fq1, "wb") as h1, gzip.GzipFile(fileobj=h1, mode="wb",
                                              mtime=0) as f1, \
            open(fq2, "wb") as h2, gzip.GzipFile(fileobj=h2, mode="wb",
                                                 mtime=0) as f2:
        for i, oi in enumerate(order):
            f1.write(f"@read{i}\n{r1s[oi]}\n+\n{'I' * len(r1s[oi])}\n"
                     .encode())
            f2.write(f"@read{i}\n{r2s[oi]}\n+\n{'I' * len(r2s[oi])}\n"
                     .encode())

    return dict(ref=ref_dir, wl=wl_path, fq1=fq1, fq2=fq2, truth=truth,
                cells=cells, wl_seqs=wl_seqs, n_reads=len(r1s))


# ---------------------------------------------------------------------------
# Rich golden fixture (VERDICT r4 item 10): engineered multimapper
# families, an unannotated splice junction, TSO/polyA adapter edges, UMI
# 1-off correction pairs, and a second (Antibody Capture) library — the
# regression classes the tiny fixture cannot reach.  Deterministic
# (seeded RNG + mtime-0 gzip) so golden snapshots stay byte-stable.
# ---------------------------------------------------------------------------

RICH_AB_SEQS = ["ACGTACGTACGTACG", "TTTTGGGGCCCCAAA",
                "GACGACGACGACGAC", "CTCTCTCTCTCTCTC"]


def build_rich_run(tmp: str, seed: int = 23, genome_len: int = 300_000,
                   n_wl: int = 4000, n_cells: int = 100,
                   read_len: int = READ_LEN) -> dict:
    """Reference package + whitelist + dual-library FASTQs under `tmp`.

    Engineered content (each case present hundreds of times):
      * a 700bp segment repeated at 3 loci; gene GR sits on copy 0 —
        multimapped reads exercise MAPQ buckets, gene promotion, and
        secondary BAM records;
      * gene GN reads half exonic, half spliced over an UNANNOTATED
        junction (900bp gap inside the annotated exon) — novel SJ
        discovery rows in junctions.tsv;
      * TSO prefixes on part of GA's reads and polyA tails on part of
        GB's (ops/trim paths visible in the BAM ts/pa behavior);
      * per-molecule UMI 1-off shadow reads (correction + dup marking);
      * 1-base barcode errors on duplicate reads; N-base junk reads;
      * an Antibody Capture library (4 features, 5PNNNNNNNNNN(BC)
        pattern, including 1-mismatch corrected feature barcodes).
    """
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome_codes = rng.integers(0, 4, genome_len).astype(np.uint8)
    rep = rng.integers(0, 4, 700).astype(np.uint8)
    REP_AT = (40_000, 80_000, 120_000)
    for p in REP_AT:
        genome_codes[p:p + 700] = rep
    genome = bases[genome_codes].tobytes().decode()

    exons = {
        "GA": [(10_000, 10_600), (12_000, 12_600)],
        "GB": [(30_000, 31_500)],
        "GR": [(40_050, 40_650)],            # on repeat copy 0
        "GN": [(150_000, 151_200)],          # novel junction inside
    }
    strands = {"GA": "+", "GB": "-", "GR": "+", "GN": "+"}
    gene_ids = list(exons)

    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "genome.fa")
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, genome_len, 80):
            f.write(genome[i:i + 80] + "\n")
    gtf = os.path.join(tmp, "genes.gtf")
    with open(gtf, "w") as f:
        for gname, exs in exons.items():
            s = strands[gname]
            lo, hi = exs[0][0] + 1, exs[-1][1]
            attr = (f'gene_id "{gname}"; gene_name "{gname}"; '
                    f'transcript_id "T_{gname}";')
            f.write(f"chr1\tsyn\tgene\t{lo}\t{hi}\t.\t{s}\t.\t{attr}\n")
            f.write(f"chr1\tsyn\ttranscript\t{lo}\t{hi}\t.\t{s}\t.\t{attr}\n")
            for (a, b) in exs:
                f.write(f"chr1\tsyn\texon\t{a + 1}\t{b}\t.\t{s}\t.\t{attr}\n")

    from ..io.reference import ReferencePackage
    ref_dir = os.path.join(tmp, "ref")
    ReferencePackage.build(fasta, gtf, ref_dir, genome_name="synthrich",
                           device=None)

    wl_seqs = sorted({"".join(rng.choice(list("ACGT"), 16))
                      for _ in range(n_wl + 300)})[:n_wl]
    wl_path = os.path.join(tmp, "whitelist.txt")
    with open(wl_path, "w") as f:
        f.write("\n".join(wl_seqs) + "\n")

    def tx_seq(gname):
        s = "".join(genome[a:b] for (a, b) in exons[gname])
        if strands[gname] == "-":
            comp = str.maketrans("ACGT", "TGCA")
            s = s.translate(comp)[::-1]
        return s

    txs = {g: tx_seq(g) for g in exons}
    TSO = "AAGCAGTGGTATCAACGCAGAGTACATGGG"   # ops/trim.TSO_SEQ
    # novel-junction read template: 50bp left of 150_050..150_100 spliced
    # to 41bp starting at 151_000 (900bp unannotated intron inside GN)
    novel_cdna = genome[150_050:150_100] + genome[151_000:151_041]

    cells = rng.choice(n_wl, n_cells, replace=False)
    r1s, r2s = [], []
    truth = np.zeros((len(gene_ids), n_cells), np.int64)
    seen_umi = set()

    def emit(bc_obs, umi, cdna):
        r1s.append(bc_obs + umi)
        r2s.append(cdna)

    for ci, c in enumerate(cells):
        bc = wl_seqs[c]
        for m in range(36):
            gi_ = (ci + m) % 4
            gname = gene_ids[gi_]
            while True:
                umi = "".join(rng.choice(list("ACGT"), 12))
                if (c, gi_, umi) not in seen_umi:
                    seen_umi.add((c, gi_, umi))
                    break
            t = txs[gname]
            kind = m % 6
            if gname == "GN" and m % 2 == 0:
                cdna = novel_cdna
            elif gname == "GR":
                start = int(rng.integers(0, len(t) - (read_len - 30)))
                cdna = t[start:start + read_len]
                if len(cdna) < read_len:   # repeat gene is short: pad with
                    cdna = cdna + "A" * (read_len - len(cdna))  # polyA tail
            elif kind == 1 and gname == "GA":
                cdna = TSO + t[:read_len - len(TSO)]
            elif kind == 2 and gname == "GB":
                start = int(rng.integers(0, len(t) - (read_len - 30)))
                cdna = t[start:start + read_len - 30] + "A" * 30
            else:
                start = int(rng.integers(0, max(len(t) - read_len, 1)))
                cdna = t[start:start + read_len]
                if len(cdna) < read_len:
                    cdna = cdna + "A" * (read_len - len(cdna))
            truth[gi_, ci] += 1
            for d in range(3):
                bc_obs = bc
                if d == 1 and m % 5 == 0:  # correctable barcode error
                    p = int(rng.integers(16))
                    alt = "ACGT"[(("ACGT".index(bc[p])) + 1) % 4]
                    bc_obs = bc[:p] + alt + bc[p + 1:]
                emit(bc_obs, umi, cdna)
            if m % 7 == 0:
                # UMI 1-off shadow read (corrected + duplicate-marked)
                p = int(rng.integers(12))
                alt = "ACGT"[(("ACGT".index(umi[p])) + 1) % 4]
                emit(bc, umi[:p] + alt + umi[p + 1:], cdna)
    for _ in range(300):   # junk: bad barcodes / N bases
        r1s.append("N" * 16 + "A" * 12)
        r2s.append("".join(rng.choice(list("ACGT"), read_len)))

    order = rng.permutation(len(r1s))
    fq1 = os.path.join(tmp, "rich_S1_L001_R1_001.fastq.gz")
    fq2 = os.path.join(tmp, "rich_S1_L001_R2_001.fastq.gz")
    with open(fq1, "wb") as h1, gzip.GzipFile(fileobj=h1, mode="wb",
                                              mtime=0) as f1, \
            open(fq2, "wb") as h2, gzip.GzipFile(fileobj=h2, mode="wb",
                                                 mtime=0) as f2:
        for i, oi in enumerate(order):
            f1.write(f"@rich{i}\n{r1s[oi]}\n+\n{'I' * len(r1s[oi])}\n"
                     .encode())
            f2.write(f"@rich{i}\n{r2s[oi]}\n+\n{'I' * len(r2s[oi])}\n"
                     .encode())

    # ---- antibody library ----
    fcsv = os.path.join(tmp, "features.csv")
    with open(fcsv, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for i, s in enumerate(RICH_AB_SEQS):
            f.write(f"AB{i},Ab{i},R2,5PNNNNNNNNNN(BC),{s},"
                    "Antibody Capture\n")
    a1s, a2s = [], []
    ab_truth = np.zeros((4, n_cells), np.int64)
    for ci, c in enumerate(cells[:60]):
        bc = wl_seqs[c]
        ab = ci % 4
        k = 4 + ci % 7
        ab_truth[ab, ci] = k
        for u in range(k):
            umi = "".join(rng.choice(list("ACGT"), 12))
            seq = RICH_AB_SEQS[ab]
            if u == 0:  # 1-mismatch feature barcode (corrected)
                seq = ("T" if seq[7] != "T" else "G").join(
                    [seq[:7], seq[8:]])
            a1s.append(bc + umi)
            a2s.append("T" * 10 + seq + "A" * (read_len - 10 - len(seq)))
    af1 = os.path.join(tmp, "ab_S1_L001_R1_001.fastq.gz")
    af2 = os.path.join(tmp, "ab_S1_L001_R2_001.fastq.gz")
    with open(af1, "wb") as h1, gzip.GzipFile(fileobj=h1, mode="wb",
                                              mtime=0) as f1, \
            open(af2, "wb") as h2, gzip.GzipFile(fileobj=h2, mode="wb",
                                                 mtime=0) as f2:
        for i in range(len(a1s)):
            f1.write(f"@ab{i}\n{a1s[i]}\n+\n{'I' * len(a1s[i])}\n".encode())
            f2.write(f"@ab{i}\n{a2s[i]}\n+\n{'I' * len(a2s[i])}\n".encode())

    return dict(ref=ref_dir, wl=wl_path, fq1=fq1, fq2=fq2,
                ab_fq1=af1, ab_fq2=af2, feature_ref=fcsv,
                truth=truth, ab_truth=ab_truth, cells=cells,
                wl_seqs=wl_seqs, n_reads=len(r1s) + len(a1s),
                n_gex_reads=len(r1s))


# ---------------------------------------------------------------------------
# 1M-read e2e fixture (bench.py `_gen_e2e_fixture`)
# ---------------------------------------------------------------------------

E2E_GENOME_LEN = 8_000_000
E2E_GENES = 800
E2E_CELLS = 2000
E2E_DUP = 2


def _e2e_whitelist(n_wl: int):
    """The e2e fixtures' whitelist (seed 4): (sorted barcode strings, the
    same as a [n_wl, 16] matrix of base bytes)."""
    wl_rng = np.random.default_rng(4)
    wl = sorted({"".join(wl_rng.choice(list("ACGT"), 16))
                 for _ in range(n_wl + n_wl // 5)})[:n_wl]
    return wl, np.asarray([list(w.encode()) for w in wl], np.uint8)


def _e2e_genome_draw(rng, genome_len: int) -> np.ndarray:
    """The e2e genome: genome_len ASCII bases, `rng`'s next draw."""
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, genome_len).astype(np.uint8)]


def _e2e_reference(tmp: str, rng, genome_len: int, n_genes: int,
                   n_wl: int | None, ref: dict | None = None):
    """The e2e fixtures' shared inputs: a random genome drawn from `rng`
    (its first draw), `n_genes` two-exon genes alternating strands, the
    reference package and a whitelist of `n_wl` barcodes (seed 4; none,
    and None in its places, when n_wl is None).  With
    `ref` (an earlier fixture's dict over the same genome) the files on
    disk are reused and only the arrays are rebuilt.
    Returns (genome bytes array, gene spacing, whitelist byte matrix,
    ref_dir, wl_path)."""
    from ..io.gtf import write_fasta
    from ..io.reference import ReferencePackage

    os.makedirs(tmp, exist_ok=True)
    garr = _e2e_genome_draw(rng, genome_len)
    spacing = genome_len // n_genes
    wl, wl_arr = _e2e_whitelist(n_wl) if n_wl is not None else (None, None)
    if ref is not None:
        return garr, spacing, wl_arr, ref["ref"], ref["wl"]
    write_fasta(os.path.join(tmp, "g.fa"), {"chr1": garr.tobytes()})
    _human_gtf(os.path.join(tmp, "g.gtf"), n_genes, spacing)
    ref_dir = os.path.join(tmp, "ref")
    ReferencePackage.build(os.path.join(tmp, "g.fa"),
                           os.path.join(tmp, "g.gtf"), ref_dir, device=None)
    if wl is None:
        return garr, spacing, None, ref_dir, None
    wl_path = os.path.join(tmp, "wl.txt")
    with open(wl_path, "w") as f:
        f.writelines(w + "\n" for w in wl)
    return garr, spacing, wl_arr, ref_dir, wl_path


def _fastq_block(seqmat: np.ndarray, qualmat: np.ndarray | None = None
                 ) -> bytes:
    """FASTQ text of a [n, w] matrix of base bytes: fixed names, 'F'
    qualities (or the quality bytes `qualmat`, [n, w]), uncompressed
    (generation stays cheap)."""
    n_, w_ = seqmat.shape
    name = np.frombuffer(b"@readxxxxxxxxxx\n", np.uint8)
    rows = np.empty((n_, len(name) + 2 * w_ + 4), np.uint8)
    rows[:, :len(name)] = name
    rows[:, len(name):len(name) + w_] = seqmat
    o = len(name) + w_
    rows[:, o] = ord("\n")
    rows[:, o + 1] = ord("+")
    rows[:, o + 2] = ord("\n")
    rows[:, o + 3:o + 3 + w_] = ord("F") if qualmat is None else qualmat
    rows[:, -1] = ord("\n")
    return rows.tobytes()


def _write_fastq_pair(r1p: str, r2p: str, r1: np.ndarray, r2: np.ndarray,
                      q1: np.ndarray | None = None,
                      q2: np.ndarray | None = None):
    with open(r1p, "wb") as f1, open(r2p, "wb") as f2:
        C = 1 << 19
        for i in range(0, len(r1), C):
            f1.write(_fastq_block(r1[i:i + C],
                                  None if q1 is None else q1[i:i + C]))
            f2.write(_fastq_block(r2[i:i + C],
                                  None if q2 is None else q2[i:i + C]))


def build_e2e_run(tmp: str, n_reads: int = 1_000_000) -> dict:
    """Vectorized synthetic run: n_reads reads = molecules emitted
    E2E_DUP times each, drawn from '+'-strand exons, 2% barcode errors;
    seed 11, 8 Mb genome, 800 genes, 2000 cells, 20k whitelist.
    Uncompressed FASTQ so generation stays cheap.  Draw for draw the
    generator of bench.py `_gen_e2e_fixture`."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    garr, spacing, wl_arr, ref_dir, wl_path = _e2e_reference(
        tmp, rng, E2E_GENOME_LEN, E2E_GENES, 20_000)

    n_mol = n_reads // E2E_DUP
    cell_idx = rng.integers(0, E2E_CELLS, n_mol)
    bc = wl_arr[cell_idx]
    umi = bases[rng.integers(0, 4, (n_mol, 12))]
    gene = rng.integers(0, E2E_GENES // 2, n_mol) * 2   # '+' strand only
    off = rng.integers(0, 600 - READ_LEN - 8, n_mol)
    pos = gene * spacing + 1000 + off
    cdna = garr[pos[:, None] + np.arange(READ_LEN)[None, :]]
    # duplicate each molecule E2E_DUP times, shuffle read order
    order = rng.permutation(n_mol * E2E_DUP)
    rep = lambda a: np.repeat(a, E2E_DUP, axis=0)[order]
    bc, umi, cdna = rep(bc), rep(umi), rep(cdna)
    # 2% of reads carry one barcode base error (exercises correction)
    n_err = len(bc) // 50
    bc[np.arange(n_err), rng.integers(0, 16, n_err)] = bases[
        rng.integers(0, 4, n_err)]

    r1p = os.path.join(tmp, "e2e_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "e2e_S1_L001_R2_001.fastq")
    _write_fastq_pair(r1p, r2p, np.concatenate([bc, umi], axis=1), cdna)
    return dict(ref=ref_dir, wl=wl_path, fq1=r1p, fq2=r2p,
                n_reads=len(bc), n_molecules=n_mol)


# ---------------------------------------------------------------------------
# Fixtures whose expected counts hold by construction
# ---------------------------------------------------------------------------

def _coded_umis(cell_idx: np.ndarray, length: int, rng) -> np.ndarray:
    """One UMI per molecule as base codes [n, length]: within a cell any
    two UMIs differ in at least two bases (length - 1 data digits that are
    distinct per molecule of the cell, plus a check base), so UMI
    correction never merges two molecules, and the check base (digit sum
    + 1 mod 4) rules out homopolymers."""
    n = len(cell_idx)
    order = np.argsort(cell_idx, kind="stable")
    sorted_cells = cell_idx[order]
    first = np.r_[True, sorted_cells[1:] != sorted_cells[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - start            # index within the cell
    space = 4 ** (length - 1)
    assert rank.max() < space
    # an odd multiplier and a per-cell offset spread the data words
    offset = rng.integers(0, space, cell_idx.max() + 1)
    data = (rank * 2_654_435_761 + offset[cell_idx]) % space
    digits = (data[:, None] >> (2 * np.arange(length - 1))[None, :]) & 3
    check = (digits.sum(1) + 1) % 4
    return np.concatenate([digits, check[:, None]], 1).astype(np.uint8)


def _barcode_errors(bc: np.ndarray, rows: np.ndarray, wl_arr: np.ndarray,
                    rng) -> None:
    """Give each listed row one substituted barcode base, in place; a
    substitution that lands on another whitelist barcode is undone, so
    every error stays correctable to its own cell."""
    pos = rng.integers(0, 16, len(rows))
    bases = np.frombuffer(b"ACGT", np.uint8)
    old = bc[rows, pos].copy()
    bc[rows, pos] = bases[rng.integers(0, 4, len(rows))]
    wl_keys = {w.tobytes() for w in wl_arr}
    for r, p, o in zip(rows.tolist(), pos.tolist(), old.tolist()):
        if bc[r, p] != o and bc[r].tobytes() in wl_keys:
            bc[r, p] = o


PE_UMI_LEN = 10          # SC5P-PE
PE_DISCORDANT_GAP = 5000  # mate-2 displacement of a discordant pair


def build_pe_run(tmp: str, n_pairs: int = 1_000_000,
                 discordant_frac: float = 0.1, seed: int = 17,
                 genome_len: int = E2E_GENOME_LEN, n_genes: int = E2E_GENES,
                 n_cells: int = E2E_CELLS, n_wl: int = 20_000,
                 ref: dict | None = None) -> dict:
    """Paired-end (SC5P-PE) run on the e2e fixture's genome, genes and
    whitelist: n_pairs read pairs = molecules emitted E2E_DUP times each.
    R1 = barcode + 10 bp UMI + mate 1 (sense, inside exon 1 of a '+'
    gene); R2 = mate 2, the reverse complement of a fragment 100-300 bp
    downstream in the same exon.  A `discordant_frac` share of molecules
    places mate 2 PE_DISCORDANT_GAP bases further (beyond the insert
    bound, intergenic): both mates map, the pair is improper.  One read of
    every 25th molecule carries a barcode error that stays correctable.

    Expected by construction (returned): total reads, confidently mapped
    pairs (the proper ones), improper pairs, molecules (UMIs are coded so
    that none merge).  `ref`: an e2e/pe fixture dict over the same genome
    and whitelist, to reuse its reference package."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    garr, spacing, wl_arr, ref_dir, wl_path = _e2e_reference(
        tmp, np.random.default_rng(11), genome_len, n_genes, n_wl, ref)
    rng = np.random.default_rng(seed)
    n_mol = n_pairs // E2E_DUP
    cell_idx = rng.integers(0, n_cells, n_mol)
    bc = wl_arr[cell_idx]
    umi = bases[_coded_umis(cell_idx, PE_UMI_LEN, rng)]
    gene = rng.integers(0, n_genes // 2, n_mol) * 2      # '+' strand only
    p1 = gene * spacing + 1000 + rng.integers(0, 200, n_mol)
    discordant = rng.random(n_mol) < discordant_frac
    p2 = (p1 + rng.integers(100, 300, n_mol)
          + np.where(discordant, PE_DISCORDANT_GAP, 0))
    ar = np.arange(READ_LEN)
    mate1 = garr[p1[:, None] + ar[None, :]]
    mate2 = comp[garr[p2[:, None] + ar[None, ::-1]]]
    order = rng.permutation(n_mol * E2E_DUP)
    rep = lambda a: np.repeat(a, E2E_DUP, axis=0)[order]  # noqa: E731
    bc, umi, mate1, mate2 = rep(bc), rep(umi), rep(mate1), rep(mate2)
    # the first emitted copy of every 25th molecule gets the barcode error
    copy_no = (np.arange(n_mol * E2E_DUP) % E2E_DUP)[order]
    mol_no = (np.arange(n_mol * E2E_DUP) // E2E_DUP)[order]
    _barcode_errors(bc, np.flatnonzero((copy_no == 0) & (mol_no % 25 == 0)),
                    wl_arr, rng)
    r1p = os.path.join(tmp, "pe_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "pe_S1_L001_R2_001.fastq")
    _write_fastq_pair(r1p, r2p, np.concatenate([bc, umi, mate1], axis=1),
                      mate2)
    n_disc = int(discordant.sum())
    return dict(ref=ref_dir, wl=wl_path, fq1=r1p, fq2=r2p,
                n_reads=n_mol * E2E_DUP,
                expected=dict(
                    total_reads=n_mol * E2E_DUP,
                    conf_mapped_reads=(n_mol - n_disc) * E2E_DUP,
                    improper_pair_reads=n_disc * E2E_DUP,
                    total_molecules=n_mol - n_disc))


# RTL probe run at the scale of a whole-transcriptome probe set
RTL_PROBES = 54_000
RTL_GENES = 18_000
RTL_PROBE_LEN = 50
RTL_HALF = RTL_PROBE_LEN // 2
RTL_UMI_LEN = 12
RTL_R2_LEN = 76              # probe 50 + filler 18 + probe barcode 8
# molecule kinds and their shares; the first three are usable
RTL_KINDS = ("exact", "one_mm", "rescued", "excluded", "junk")
RTL_SHARES = (0.60, 0.15, 0.10, 0.05, 0.10)
RTL_EXCLUDED_EVERY = 20      # every 20th probe is included=FALSE


def rtl_probe_barcodes() -> list[str]:
    """16 probe barcodes of 8 bp, any two at least 3 bases apart (so one
    mismatch still names its barcode)."""
    out = []
    for a in range(4):
        for b in range(4):
            word = [a, b, a, b, a, b, (a + b) % 4, (a + 2 * b) % 4]
            out.append("".join("ACGT"[x] for x in word))
    return out


def _rtl_probe_codes(n_probes: int, rng):
    """Probe sequences [n, 50] as base codes, and per half the position of
    every coded slot.  A half holds the probe's index as 8 base-4 digits
    three times over (slots 0-7, 8-15, 16-23) plus one random base (slot
    24), under a fixed slot -> position shuffle and a per-slot base
    rotation.  Two probes differ in at least one digit, so in at least 3
    bases of either half: a read within one mismatch of a probe half is
    at least two mismatches from every other probe's."""
    assert n_probes <= 4 ** 8
    digits = (np.arange(n_probes)[:, None] >> (2 * np.arange(8))[None, :]) & 3
    seq = np.zeros((n_probes, RTL_PROBE_LEN), np.uint8)
    slot_pos = []
    for h in range(2):
        v = np.concatenate([digits, digits, digits,
                            rng.integers(0, 4, (n_probes, 1))], 1)
        v = (v + rng.integers(0, 4, RTL_HALF)[None, :]) % 4
        pos = rng.permutation(RTL_HALF) + h * RTL_HALF
        seq[:, pos] = v
        slot_pos.append(pos)
    return seq, np.stack(slot_pos)


def build_rtl_run(tmp: str, n_reads: int = 1_000_000, seed: int = 29,
                  n_probes: int = RTL_PROBES, n_genes: int = RTL_GENES,
                  n_cells: int = E2E_CELLS, n_wl: int = 20_000) -> dict:
    """RTL (MFRP-RNA) run at the scale of a whole-transcriptome probe set:
    `n_probes` 50 bp probes over `n_genes` genes (every 20th probe
    excluded), 16 probe barcodes, the e2e whitelist, n_reads reads =
    molecules emitted E2E_DUP times each.  R1 = barcode + 12 bp UMI;
    R2 = 50 probe bases + 18 filler + the cell's probe barcode (cell index
    mod 16; one copy of every 25th molecule with one mismatch in it).

    Molecule kinds, in the shares of RTL_SHARES: exact; one mismatch in
    one half; one half with 3 mismatches inside one copy of the coded
    index (its lookup fails, the other half rescues it: score 25 + 19);
    exact on an excluded probe (mapped, not confident); junk (both halves
    at least 4 mismatches from every probe).

    Expected by construction (returned): usable and confidently mapped
    reads (the first three kinds), mapped reads (those plus excluded),
    molecules (UMIs are coded so that none merge), per-region reads."""
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes, slot_pos = _rtl_probe_codes(n_probes, rng)
    probe_gene = np.arange(n_probes) * n_genes // n_probes
    included = np.arange(n_probes) % RTL_EXCLUDED_EVERY != 0
    region = np.where(np.arange(n_probes) % 3 == 0, "unspliced", "spliced")
    pcsv = os.path.join(tmp, "probes.csv")
    seq_txt = bases[codes].view(f"S{RTL_PROBE_LEN}").ravel()
    with open(pcsv, "w") as f:
        f.write("#probe_set_file_format=1.0\n#panel_name=synthetic "
                "whole transcriptome\n#reference_genome=synth\n")
        f.write("gene_id,probe_seq,probe_id,included,region\n")
        f.writelines(
            f"GENE{g:05d},{s.decode()},GENE{g:05d}|p{i},"
            f"{'TRUE' if inc else 'FALSE'},{r}\n"
            for i, (g, s, inc, r) in enumerate(zip(
                probe_gene.tolist(), seq_txt.tolist(), included.tolist(),
                region.tolist())))
    pbcs = rtl_probe_barcodes()
    pbc_csv = os.path.join(tmp, "probe_barcodes.csv")
    with open(pbc_csv, "w") as f:
        f.write("id,sequence\n")
        f.writelines(f"BC{i + 1:03d},{s}\n" for i, s in enumerate(pbcs))
    pbc_arr = np.asarray([list(s.encode()) for s in pbcs], np.uint8)
    wl, wl_arr = _e2e_whitelist(n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    with open(wl_path, "w") as f:
        f.writelines(w + "\n" for w in wl)

    n_mol = n_reads // E2E_DUP
    cell_idx = rng.integers(0, n_cells, n_mol)
    umi = bases[_coded_umis(cell_idx, RTL_UMI_LEN, rng)]
    kind = rng.choice(len(RTL_KINDS), n_mol, p=RTL_SHARES)
    inc_idx, exc_idx = np.flatnonzero(included), np.flatnonzero(~included)
    is_exc = kind == RTL_KINDS.index("excluded")
    probe = np.where(is_exc, exc_idx[rng.integers(0, len(exc_idx), n_mol)],
                     inc_idx[rng.integers(0, len(inc_idx), n_mol)])
    read = codes[probe].copy()
    rows = np.arange(n_mol)

    def bump(sel, pos):
        """Substitute the base at read[sel, pos] by another one."""
        read[sel, pos] = (read[sel, pos] + rng.integers(1, 4, len(sel))) % 4

    sel = rows[kind == RTL_KINDS.index("one_mm")]
    bump(sel, rng.integers(0, RTL_PROBE_LEN, len(sel)))
    sel = rows[kind == RTL_KINDS.index("rescued")]
    half = rng.integers(0, 2, len(sel))
    copy = rng.integers(0, 3, len(sel))
    for k in range(3):              # digits k, k+3 ... of the chosen copy
        slot = 8 * copy + (rng.integers(0, 2, len(sel)) * 3 + k)
        bump(sel, slot_pos[half, slot])
    sel = rows[kind == RTL_KINDS.index("junk")]
    for h in range(2):              # copies 1 and 2 each lose two digits
        for slot in (8, 9, 18, 19):
            bump(sel, np.full(len(sel), slot_pos[h, slot]))

    r2 = np.empty((n_mol, RTL_R2_LEN), np.uint8)
    r2[:, :RTL_PROBE_LEN] = bases[read]
    r2[:, RTL_PROBE_LEN:68] = bases[rng.integers(0, 4, (n_mol, 18))]
    r2[:, 68:] = pbc_arr[cell_idx % len(pbcs)]
    r1 = np.concatenate([wl_arr[cell_idx], umi], axis=1)
    order = rng.permutation(n_mol * E2E_DUP)
    r1 = np.repeat(r1, E2E_DUP, axis=0)[order]
    r2 = np.repeat(r2, E2E_DUP, axis=0)[order]
    copy_no = (np.arange(n_mol * E2E_DUP) % E2E_DUP)[order]
    mol_no = (np.arange(n_mol * E2E_DUP) // E2E_DUP)[order]
    err = np.flatnonzero((copy_no == 1) & (mol_no % 25 == 0))
    pos = 68 + rng.integers(0, 8, len(err))
    r2[err, pos] = bases[(np.searchsorted(bases, r2[err, pos])
                          + rng.integers(1, 4, len(err))) % 4]
    r1p = os.path.join(tmp, "rtl_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "rtl_S1_L001_R2_001.fastq")
    _write_fastq_pair(r1p, r2p, r1, r2)

    usable = kind <= RTL_KINDS.index("rescued")
    n_usable = int(usable.sum())
    regions = {}
    for name in ("spliced", "unspliced"):
        regions[f"probe_reads_{name}"] = E2E_DUP * int(
            (usable & (region[probe] == name)).sum())
    return dict(probes=pcsv, probe_barcodes=pbc_csv, wl=wl_path, fq1=r1p,
                fq2=r2p, n_reads=n_mol * E2E_DUP, n_probe_bcs=len(pbcs),
                n_wl=n_wl,
                expected=dict(
                    total_reads=n_mol * E2E_DUP,
                    usable_reads=n_usable * E2E_DUP,
                    conf_mapped_reads=n_usable * E2E_DUP,
                    mapped_reads=(n_usable + int(is_exc.sum())) * E2E_DUP,
                    total_molecules=n_usable, **regions))


MULTI_CMOS = {"CMO301": "AAAACCCCGGGGTTT", "CMO302": "TTTTGGGGCCCCAAA"}
MULTI_CMO_UMIS = 25          # tag molecules of a sample's first cell


def build_multi_run(tmp: str, n_cells: int = 40, seed: int = 31) -> dict:
    """A `multi` config over the tiny synthetic run: its Gene Expression
    library, a Multiplexing Capture library (the first half of the cells
    carry CMO301, the rest CMO302; the k-th cell of a sample carries
    MULTI_CMO_UMIS + 3k tag molecules, so that no two cells of a sample
    are the same point to its secondary analysis) and a [samples] section
    mapping one tag to each of two samples.  Returns the config path, the
    whitelist and the cells built per sample."""
    fx = build_synthetic_run(os.path.join(tmp, "gex"), n_cells=n_cells)
    rng = np.random.default_rng(seed)
    fref = os.path.join(tmp, "cmo_features.csv")
    with open(fref, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for cid, seq in MULTI_CMOS.items():
            f.write(f"{cid},{cid},R2,5PNNNNNNNNNN(BC),{seq},"
                    "Multiplexing Capture\n")
    cdir = os.path.join(tmp, "cmo")
    os.makedirs(cdir, exist_ok=True)
    names = list(MULTI_CMOS)
    built = {"sampleA": 0, "sampleB": 0}
    n = 0
    with gzip.open(os.path.join(cdir, "cmo_S1_L001_R1_001.fastq.gz"),
                   "wt") as f1, \
            gzip.open(os.path.join(cdir, "cmo_S1_L001_R2_001.fastq.gz"),
                      "wt") as f2:
        for ci, c in enumerate(fx["cells"]):
            which = 0 if ci < n_cells // 2 else 1
            built["sampleA" if which == 0 else "sampleB"] += 1
            r2 = "T" * 10 + MULTI_CMOS[names[which]] + "A" * 46
            for _ in range(MULTI_CMO_UMIS + 3 * (ci % (n_cells // 2))):
                umi = "".join(rng.choice(list("ACGT"), 12))
                f1.write(f"@c{n}\n{fx['wl_seqs'][c]}{umi}\n+\n{'F' * 28}\n")
                f2.write(f"@c{n}\n{r2}\n+\n{'F' * len(r2)}\n")
                n += 1
    csv = os.path.join(tmp, "multi.csv")
    with open(csv, "w") as f:
        f.write(f"""[gene-expression]
reference,{fx['ref']}
chemistry,SC3Pv3

[feature]
reference,{fref}

[libraries]
fastq_id,fastqs,feature_types
sample,{os.path.dirname(fx['fq1'])},Gene Expression
cmo,{cdir},Multiplexing Capture

[samples]
sample_id,cmo_ids
sampleA,{names[0]}
sampleB,{names[1]}
""")
    return dict(csv=csv, wl=fx["wl"], built=built, n_cells=n_cells,
                n_reads=fx["n_reads"] + n, gex=fx)


def sw_inputs(seed: int, B: int, L: int):
    """Random reads against windows that hold the read (sometimes with a
    planted 1-3 bp indel) at a random band offset, random masked cells on
    both sides, and a few all-masked rows."""
    from ..align.sw import BAND

    rng = np.random.default_rng(seed)
    W = L + BAND
    read = rng.integers(0, 4, (B, L)).astype(np.uint8)
    win = rng.integers(0, 4, (B, W)).astype(np.uint8)
    for b in range(B):
        kind = b % 4
        off = int(rng.integers(0, BAND - 4))
        if kind == 0:                      # exact placement
            win[b, off:off + L] = read[b]
        elif kind == 1:                    # deletion from the read
            cut, n = int(rng.integers(5, L - 5)), int(rng.integers(1, 4))
            src = np.concatenate([read[b, :cut],
                                  rng.integers(0, 4, n).astype(np.uint8),
                                  read[b, cut:]])
            win[b, off:off + min(len(src), W - off)] = src[:W - off]
        elif kind == 2:                    # insertion in the read
            cut, n = int(rng.integers(5, L - 5)), int(rng.integers(1, 4))
            src = np.concatenate([read[b, :cut], read[b, cut + n:]])
            win[b, off:off + len(src)] = src
    rmask = np.ones((B, L), bool)
    wmask = np.ones((B, W), bool)
    noisy = np.arange(B) % 5 == 4           # random masked cells
    rmask[noisy] = rng.random((noisy.sum(), L)) > 0.1
    wmask[noisy] = rng.random((noisy.sum(), W)) > 0.1
    rmask[3 % B] = False                    # all-masked read
    wmask[7 % B] = False                    # all-masked window
    rmask[11 % B, L // 2:] = False          # masked tail
    return read, rmask, win, wmask


def sw_adversarial_inputs(seed: int, B: int, L: int):
    """Inputs that lean on the kernel's edge rules, eight kinds in turn:
    reads with a planted deletion or insertion of 1-7 bases, fully masked
    reads, windows masked at their start or at their end (the window of a
    locus near a contig's end), reads and windows of one base throughout
    (ties in every row), all-equal bases under random masks, and exact
    placements at the band's two edges."""
    from ..align.sw import BAND

    rng = np.random.default_rng(seed)
    W = L + BAND
    read = rng.integers(0, 4, (B, L)).astype(np.uint8)
    win = rng.integers(0, 4, (B, W)).astype(np.uint8)
    rmask = np.ones((B, L), bool)
    wmask = np.ones((B, W), bool)
    for b in range(B):
        kind = b % 8
        off = int(rng.integers(0, BAND))
        n = int(rng.integers(1, 8))
        cut = int(rng.integers(1, max(L - n, 2)))
        if kind == 0:                      # deletion of n bases from the read
            src = np.concatenate([read[b, :cut],
                                  rng.integers(0, 4, n).astype(np.uint8),
                                  read[b, cut:]])
            k = min(len(src), W - off)
            win[b, off:off + k] = src[:k]
        elif kind == 1:                    # insertion of n bases in the read
            src = np.concatenate([read[b, :cut], read[b, cut + n:]])
            k = min(len(src), W - off)
            win[b, off:off + k] = src[:k]
        elif kind == 2:                    # fully masked read
            win[b, off:off + min(L, W - off)] = read[b, :W - off]
            rmask[b] = False
        elif kind == 3:                    # window masked at its start
            win[b, BAND // 2:BAND // 2 + L] = read[b]
            wmask[b, :int(rng.integers(1, L))] = False
        elif kind == 4:                    # window masked at its end
            win[b, BAND // 2:BAND // 2 + L] = read[b]
            wmask[b, W - int(rng.integers(1, L)):] = False
        elif kind == 5:                    # one base throughout
            read[b] = win[b] = b % 4
        elif kind == 6:                    # one base, random masks
            read[b] = win[b] = b % 4
            rmask[b] = rng.random(L) > 0.2
            wmask[b] = rng.random(W) > 0.2
        else:                              # exact, at an edge of the band
            e = (b // 8) % 2 * (BAND - 1)
            win[b, e:e + L] = read[b, :W - e]
    return read, rmask, win, wmask


ANALYSIS_BACKGROUND_MEAN = 0.1   # ~10% of genes detected per cell, as PBMC
ANALYSIS_MARKERS = 50            # marker genes per population
ANALYSIS_MARKER_MEAN = 5.0


def build_analysis_matrix(n_cells: int, n_genes: int, n_pops: int,
                          seed: int = 0):
    """Planted-population count matrix for secondary analysis.

    Every gene of every cell draws Poisson(0.1) background counts; the
    cells of population q add Poisson(5) counts to their own 50 marker
    genes (genes 50q .. 50q + 49).  Populations are balanced and shuffled.
    The background is drawn as one Poisson total per cell spread
    uniformly over the genes, which is the same distribution and costs
    draws in proportion to the counts rather than to the matrix size.
    Returns (CountMatrix with a csc genes x cells matrix, truth [n_cells]).
    """
    import scipy.sparse as sp
    from ..io.matrix_io import CountMatrix, FeatureDef, FeatureReference

    if n_genes < ANALYSIS_MARKERS * n_pops:
        raise ValueError(f"{n_pops} populations need at least "
                         f"{ANALYSIS_MARKERS * n_pops} genes")
    rng = np.random.default_rng(seed)
    truth = rng.permutation(np.arange(n_cells) % n_pops)
    per_cell = rng.poisson(ANALYSIS_BACKGROUND_MEAN * n_genes, n_cells)
    bg_cells = np.repeat(np.arange(n_cells), per_cell)
    bg_genes = rng.integers(0, n_genes, len(bg_cells))
    mk_cells = np.repeat(np.arange(n_cells), ANALYSIS_MARKERS)
    mk_genes = (truth[mk_cells] * ANALYSIS_MARKERS
                + np.tile(np.arange(ANALYSIS_MARKERS), n_cells))
    mk_counts = rng.poisson(ANALYSIS_MARKER_MEAN, len(mk_cells))
    rows = np.concatenate([bg_genes, mk_genes])
    cols = np.concatenate([bg_cells, mk_cells])
    vals = np.concatenate([np.ones(len(bg_cells), np.int32),
                           mk_counts.astype(np.int32)])
    m = sp.csc_matrix((vals, (rows, cols)), shape=(n_genes, n_cells),
                      dtype=np.int32)
    m.eliminate_zeros()
    bases = np.frombuffer(b"ACGT", np.uint8)
    bc_codes = rng.integers(0, 4, (n_cells, 16))
    barcodes = [bases[c].tobytes() + b"-1" for c in bc_codes]
    features = FeatureReference([FeatureDef(f"GENE{g:05d}", f"G{g}")
                                 for g in range(n_genes)])
    return CountMatrix(m, barcodes, features), truth


# ---------------------------------------------------------------------------
# V(D)J fixtures
# ---------------------------------------------------------------------------

def _rand_nt(n: int, rng) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def build_vdj_single_world(tmp: str, barcodes: list[str] | None = None
                           ) -> dict:
    """The single-end V(D)J world of tests/test_vdj.py, draw for draw: a
    TRB locus (two V genes ending in the conserved Cys, one J starting
    with the FGxG motif, one C; rng 42) and 6 cells (4 of clonotype A, 2
    of clonotype B) x 8 UMIs x 3 reads of 120 bases in SCVDJ-R2 layout
    (R1 = barcode + 10 bp UMI, R2 = the read, sense; rng 9), gzipped, with
    a 64-barcode whitelist.  With `barcodes` the cells take those instead
    and no whitelist is written (the caller's holds them)."""
    from ..io.gtf import write_fasta

    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(42)
    v_seq = _rand_nt(147, rng) + "TGT"
    j_seq = "TTTGGAACAGGG" + _rand_nt(38, rng)
    c_seq = _rand_nt(90, rng)
    v2_seq = _rand_nt(147, rng) + "TGT"
    fa = os.path.join(tmp, "regions.fa")
    write_fasta(fa, {
        "1|TRBV1-1|TRBV1-1|TRBV1-1|L-REGION+V-REGION|TRB|None|00":
            v_seq.encode(),
        "2|TRBV2-1|TRBV2-1|TRBV2-1|L-REGION+V-REGION|TRB|None|00":
            v2_seq.encode(),
        "3|TRBJ1-1|TRBJ1-1|TRBJ1-1|J-REGION|TRB|None|00": j_seq.encode(),
        "4|TRBC1|TRBC1|TRBC1|C-REGION|TRB|None|00": c_seq.encode(),
    })
    tx_a = v_seq + "GCTGCAGCG" + j_seq + c_seq
    tx_b = v_seq + "GATCGTGAA" + j_seq + c_seq
    rng = np.random.default_rng(9)
    wl_path = None
    if barcodes is None:
        barcodes = sorted({_rand_nt(16, rng) for _ in range(64)})
        wl_path = os.path.join(tmp, "wl.txt")
        with open(wl_path, "w") as f:
            f.writelines(s + "\n" for s in barcodes)
    r1p = os.path.join(tmp, "v_S1_L001_R1_001.fastq.gz")
    r2p = os.path.join(tmp, "v_S1_L001_R2_001.fastq.gz")
    n = 0
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for ci in range(6):
            tx = tx_a if ci < 4 else tx_b
            for u in range(8):
                umi = _rand_nt(10, rng)
                for _ in range(3):
                    p = int(rng.integers(0, len(tx) - 120))
                    f1.write(f"@v{n}\n{barcodes[ci]}{umi}\n+\n{'F' * 26}\n")
                    f2.write(f"@v{n}\n{tx[p:p + 120]}\n+\n{'F' * 120}\n")
                    n += 1
    return dict(fa=fa, wl=wl_path, fq1=r1p, fq2=r2p, n_reads=n,
                chemistry="SCVDJ-R2", read_len=120, batch_size=1024,
                cdr3_a=v_seq[147:] + "GCTGCAGCG" + "TTT",
                expected=dict(total_reads=n, estimated_cells=6,
                              n_clonotypes=2))


def build_vdj_paired_world(tmp: str) -> dict:
    """The paired-end SCVDJ world of tests/test_vdj.py, draw for draw (rng
    33): a 220-base V, a CDR3-like core and an 80-base J; 60 read pairs
    over 3 barcodes of a 30-barcode whitelist, R1 = barcode + 10 bp UMI +
    15 bp TSO + mate 1 from the 5' end, R2 = mate 2 (antisense) from 90-110
    bases further, gzipped."""
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(33)
    v_seq = _rand_nt(220, rng)
    j_seq = _rand_nt(80, rng)
    tx = v_seq + "TGTGCCAGCAGC" + j_seq
    fa = os.path.join(tmp, "regions.fa")
    with open(fa, "w") as f:
        f.write(f">1|TRBV1 TRBV1|L-REGION+V-REGION|TR|TRB|None|00\n{v_seq}\n"
                f">2|TRBJ1 TRBJ1|J-REGION|TR|TRB|None|00\n{j_seq}\n")
    wl = sorted({_rand_nt(16, rng) for _ in range(30)})
    wl_path = os.path.join(tmp, "wl.txt")
    with open(wl_path, "w") as f:
        f.write("\n".join(wl) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    r1p = os.path.join(tmp, "v_S1_L001_R1_001.fastq.gz")
    r2p = os.path.join(tmp, "v_S1_L001_R2_001.fastq.gz")
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for i in range(60):
            umi = _rand_nt(10, rng)
            p1 = int(rng.integers(0, 10))
            mate1 = tx[p1:p1 + 120]
            p2 = int(rng.integers(90, 110))
            mate2 = tx[p2:p2 + 120].translate(comp)[::-1]
            r1 = wl[i % 3] + umi + "ACGTACGTACGTACG" + mate1
            f1.write(f"@v{i}\n{r1}\n+\n{'F' * len(r1)}\n")
            f2.write(f"@v{i}\n{mate2}\n+\n{'F' * len(mate2)}\n")
    return dict(fa=fa, wl=wl_path, fq1=r1p, fq2=r2p, n_reads=60,
                chemistry="SCVDJ", read_len=120, batch_size=256,
                expected=dict(total_reads=60))


VDJ_READ_LEN = 120
VDJ_UMI_LEN = 10
VDJ_TSO = "TTTCTTATATGGGAG"      # 15 bp between the UMI and mate 1
VDJ_UTR = 30                     # 5' UTR ahead of the leader + V region
VDJ_V_LEN = 300                  # L-REGION+V-REGION, ends in the Cys codon
VDJ_J_LEN = 50
VDJ_C_LEN = 180
VDJ_V_GENES = 4                  # per chain
VDJ_J_GENES = 2
VDJ_INSERT = {"TRA": 12, "TRB": 15}   # N/D additions: CDR3 of 18 / 21 nt
VDJ_UMIS_PER_CHAIN = 20          # molecules of each chain in a cell
VDJ_MATE1_START = 20             # mate 1 starts in the first 20 bases
VDJ_FRAGMENT = (150, 450)        # fragment length range (mate-2 end)
VDJ_WL = 2000
# codons of the N/D additions: no Cys (a later anchor), no Phe/Trp (a J
# motif), no stop
_VDJ_CODONS = ["GCT", "GAT", "GAA", "GGT", "CAT", "ATT", "AAA", "CTG",
               "ATG", "AAC", "CCT", "CAG", "CGT", "AGC", "ACC", "GTT",
               "TAT"]


def _vdj_segments(rng) -> dict:
    """A TRA + TRB segment reference: per chain VDJ_V_GENES V genes
    (random, ending in TGT), VDJ_J_GENES J genes (F-G-x-G codons, then
    random) and one C gene, each with a random 5' UTR for its transcripts.
    Returns {chain: dict(v=[...], j=[...], c=str, utr=[...])}."""
    out = {}
    for chain in ("TRA", "TRB"):
        v = [_rand_nt(VDJ_V_LEN - 3, rng) + "TGT" for _ in range(VDJ_V_GENES)]
        j = ["TTT" + "GG" + _rand_nt(1, rng) + "AAA" + "GG" + _rand_nt(1, rng)
             + _rand_nt(VDJ_J_LEN - 12, rng) for _ in range(VDJ_J_GENES)]
        out[chain] = dict(v=v, j=j, c=_rand_nt(VDJ_C_LEN, rng),
                          utr=[_rand_nt(VDJ_UTR, rng)
                               for _ in range(VDJ_V_GENES)])
    return out


def _vdj_insert(chain: str, rng) -> str:
    """N/D additions that keep the V-end Cys the last Cys codon before the
    J motif in any frame, with no stop codon."""
    while True:
        ins = "".join(rng.choice(_VDJ_CODONS, VDJ_INSERT[chain] // 3))
        if not any(m in "GT" + ins + "TT" for m in ("TGT", "TGC")):
            return ins


def _vdj_design(n_cells: int, seed: int) -> dict:
    """Segments, clonotypes and cells of a V(D)J run.  Clonotypes 1 and 2
    hold (n_cells - 1) // 2 + (n_cells - 1) % 2 and (n_cells - 1) // 2
    cells, clonotype 3 one cell, and with more than 5 cells every further
    clonotype one cell; clonotype k takes V gene k % VDJ_V_GENES and J gene
    k % VDJ_J_GENES of each chain and its own N/D additions.  Transcript
    2k (TRA) and 2k + 1 (TRB) of clonotype k: UTR + V + additions + J + C."""
    if n_cells < 5:
        raise ValueError("a V(D)J run needs at least 5 cells (two shared "
                         "clonotypes and a singleton)")
    rng = np.random.default_rng(seed)
    seg = _vdj_segments(rng)
    big = (n_cells - 1) // 2
    sizes = [n_cells - 1 - big, big, 1]
    if n_cells > 5:
        sizes = [2, 2, 1] + [1] * (n_cells - 5)
    clono = np.repeat(np.arange(len(sizes)), sizes)
    tx, cdr3 = [], []
    for k in range(len(sizes)):
        per = {}
        for chain in ("TRA", "TRB"):
            s = seg[chain]
            vi, ji = k % VDJ_V_GENES, k % VDJ_J_GENES
            ins = _vdj_insert(chain, rng)
            tx.append(s["utr"][vi] + s["v"][vi] + ins + s["j"][ji] + s["c"])
            per[chain] = ("TGT" + ins + s["j"][ji][:3],
                          f"{chain}V{vi + 1}", f"{chain}J{ji + 1}")
        cdr3.append(per)
    wl, wl_arr = _e2e_whitelist(VDJ_WL)
    cell_wl = np.sort(rng.choice(VDJ_WL, n_cells, replace=False))
    return dict(seg=seg, clono=rng.permutation(clono), tx=tx, cdr3=cdr3,
                wl=wl, wl_arr=wl_arr, cell_wl=cell_wl, rng=rng)


# A T-cell library at the width users run (build_vdj_run's keywords; see
# vdj_library_kw): IMGT's functional human TRAV / TRAJ / TRBV / TRBJ gene
# counts, V genes drawn in families so that a contig's 16-mers reach
# several V genes as in a real reference, 10x's 737K-august-2016 5'
# whitelist size, non-cell barcodes of one ambient molecule each, expanded
# clonotypes, and binned NovaSeq qualities with N at Q2.
VDJ_IMGT_GENES = {"TRA": (45, 50), "TRB": (48, 13)}   # (V, J) genes a chain
VDJ_FAMILY_SIZE = (1, 5)            # V genes a family: a founder + 0-4
VDJ_FAMILY_IDENTITY = (0.85, 0.95)  # a member's identity to its founder
VDJ_WL_5P = 737_280
VDJ_BACKGROUND_SHARE = 0.10         # of all read pairs, on non-cell barcodes
VDJ_BACKGROUND_PER_CELL = 20        # non-cell barcodes a cell
VDJ_EXPANDED_PER_CELL = 50          # one expanded clonotype per 50 cells
VDJ_EXPANDED_SIZES = (3, 30)        # its cells, drawn log-uniform
VDJ_QUAL_BINS = b"#,:F"             # Q2 (the base an N), Q11, Q25, Q37
VDJ_QUAL_SHARES = (0.002, 0.01, 0.05, 0.938)
VDJ_PRIMER_EVERY = 2                # every 2nd V gene's UTR carries the
VDJ_PRIMER_AT = 5                   # reverse complement of an inner primer
                                    # at this offset, so that mate 1 of
                                    # its transcripts is primer-trimmed
VDJ_CDR3_MIN_DIST = 3               # Hamming distance of CDR3s of one V and J


def vdj_library_kw(n_cells: int) -> dict:
    """build_vdj_run's keywords for a T-cell library at the width users
    run: the IMGT gene counts, 20 non-cell barcodes a cell holding
    VDJ_BACKGROUND_SHARE of the pairs, the 737,280-barcode whitelist."""
    return dict(genes=VDJ_IMGT_GENES,
                background=VDJ_BACKGROUND_PER_CELL * n_cells,
                n_wl=VDJ_WL_5P)


def _vdj_families(n: int, rng) -> list[str]:
    """n V genes of VDJ_V_LEN bases ending in the Cys codon TGT, drawn in
    families: a random founder, then members that differ from it at a
    share of positions drawn from 1 - VDJ_FAMILY_IDENTITY."""
    out = []
    while len(out) < n:
        size = min(int(rng.integers(VDJ_FAMILY_SIZE[0],
                                    VDJ_FAMILY_SIZE[1] + 1)), n - len(out))
        founder = rng.integers(0, 4, VDJ_V_LEN - 3)
        out.append(founder)
        for _ in range(size - 1):
            ident = rng.uniform(*VDJ_FAMILY_IDENTITY)
            m = founder.copy()
            mut = rng.random(len(m)) >= ident
            m[mut] = (m[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
            out.append(m)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[g].tobytes().decode() + "TGT" for g in out]


def _vdj_t_segments(genes: dict, rng) -> dict:
    """Per chain of `genes` ({chain: (V genes, J genes)}) its V genes in
    families (_vdj_families), J genes opening with F-G-x-G, one C gene
    and a 5' UTR a V gene, every VDJ_PRIMER_EVERY-th carrying the reverse
    complement of the chain's human TCR inner primer at VDJ_PRIMER_AT."""
    from ..vdj.assembly import INNER_PRIMERS, _revcomp_b

    seg = {}
    for ci, (chain, (nv, nj)) in enumerate(genes.items()):
        primer = _revcomp_b(INNER_PRIMERS[("human", "tcr")][ci]).decode()
        utr = [_rand_nt(VDJ_UTR, rng) for _ in range(nv)]
        for i in range(0, nv, VDJ_PRIMER_EVERY):
            utr[i] = (utr[i][:VDJ_PRIMER_AT] + primer
                      + utr[i][VDJ_PRIMER_AT + len(primer):])
        seg[chain] = dict(
            v=_vdj_families(nv, rng),
            j=["TTT" + "GG" + _rand_nt(1, rng) + "AAA" + "GG"
               + _rand_nt(1, rng) + _rand_nt(VDJ_J_LEN - 12, rng)
               for _ in range(nj)],
            c=_rand_nt(VDJ_C_LEN, rng), utr=utr)
    return seg


def _vdj_t_records(seg: dict) -> dict:
    """regions.fa's records {header: sequence bytes} of a T reference:
    per chain its V, J and C genes, named TRAV1.., TRAJ1.., TRAC1."""
    recs, n = {}, 0
    for chain, s in seg.items():
        for kind, region, seqs in (("V", "L-REGION+V-REGION", s["v"]),
                                   ("J", "J-REGION", s["j"]),
                                   ("C", "C-REGION", [s["c"]])):
            for i, seq in enumerate(seqs):
                n += 1
                g = f"{chain}{kind}{i + 1}"
                recs[f"{n}|{g}|{g}|{g}|{region}|{chain}|None|00"] = \
                    seq.encode()
    return recs


def _vdj_design_wide(n_cells: int, seed: int, genes: dict, n_wl: int,
                     background: int) -> dict:
    """_vdj_design at a library's width: per chain genes[chain] = (V, J)
    genes (V in families) and one C gene, the 5' UTR of every
    VDJ_PRIMER_EVERY-th V gene carrying the reverse complement of one of
    the human TCR inner primers at VDJ_PRIMER_AT; one expanded clonotype
    of VDJ_EXPANDED_SIZES cells per VDJ_EXPANDED_PER_CELL cells (at least
    one) and every other cell its own
    clonotype, each clonotype a random V and J gene per chain and N/D
    additions whose CDR3 is at least VDJ_CDR3_MIN_DIST from every other
    clonotype's of that chain, V and J, and no (K-1)-mer of its
    transcripts twice; an n_wl-barcode whitelist (packed),
    the cells' and `background` non-cell barcodes drawn from it."""
    from ..vdj.assembly import K

    rng = np.random.default_rng(seed)
    seg = _vdj_t_segments(genes, rng)
    lo, hi = VDJ_EXPANDED_SIZES
    expanded = max(1, n_cells // VDJ_EXPANDED_PER_CELL)
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), expanded))
    sizes = np.minimum(sizes.astype(np.int64), max(lo, n_cells // 5))
    if sizes.sum() > n_cells:
        raise ValueError(f"{expanded} expanded clonotypes need "
                         f"{sizes.sum()} of {n_cells} cells")
    sizes = list(sizes) + [1] * int(n_cells - sizes.sum())
    clono = np.repeat(np.arange(len(sizes)), sizes)
    def kmers(t):          # (K-1)-mers: the assembly graph's overlaps
        return [t[i:i + K - 1] for i in range(len(t) - K + 2)]

    tx, cdr3, seen = [], [], {}
    for _ in range(len(sizes)):
        per, taken = {}, set()
        for chain, (nv, nj) in genes.items():
            s = seg[chain]
            vi, ji = int(rng.integers(nv)), int(rng.integers(nj))
            near = seen.setdefault((chain, vi, ji), [])
            while True:
                ins = _vdj_insert(chain, rng)
                nt = "TGT" + ins + s["j"][ji][:3]
                t = s["utr"][vi] + s["v"][vi] + ins + s["j"][ji] + s["c"]
                # no 19-mer twice in a cell's transcripts, which would join
                # them in its assembly graph (the J genes' FGxG motif and
                # N additions can line up across chains)
                km = kmers(t)
                if (all(sum(a != b for a, b in zip(nt, o))
                        >= VDJ_CDR3_MIN_DIST for o in near)
                        and len(set(km)) == len(km) and not taken & set(km)):
                    break
            near.append(nt)
            taken.update(km)
            tx.append(t)
            per[chain] = (nt, f"{chain}V{vi + 1}", f"{chain}J{ji + 1}")
        cdr3.append(per)
    wl = _human_whitelist(rng, n_wl)
    picks = rng.choice(n_wl, n_cells + background, replace=False)
    return dict(seg=seg, clono=rng.permutation(clono), tx=tx, cdr3=cdr3,
                wl_packed=wl, cell_wl=np.sort(picks[:n_cells]),
                bg_wl=np.sort(picks[n_cells:]), rng=rng)


def _vdj_background(d: dict, n_pairs: int):
    """The non-cell barcodes' pairs: each barcode one molecule of a random
    cell's TRA or TRB transcript, n_pairs split evenly over them (the
    first n_pairs % n barcodes one more).  Returns the arrays of
    _vdj_pairs, barcode index in place of cell."""
    rng = d["rng"]
    n = len(d["bg_wl"])
    n_cells = len(d["clono"])
    tx = 2 * d["clono"][rng.integers(0, n_cells, n)] + rng.integers(0, 2, n)
    umi = _coded_umis(np.arange(n), VDJ_UMI_LEN, rng)
    per = np.full(n, n_pairs // n)
    per[:n_pairs % n] += 1
    bgi = np.repeat(np.arange(n), per)
    p1 = rng.integers(0, VDJ_MATE1_START, len(bgi))
    end = p1 + rng.integers(VDJ_FRAGMENT[0], VDJ_FRAGMENT[1] + 1, len(bgi))
    return bgi, umi[bgi], tx[bgi], p1, end


def _binned_quals(rng, shape) -> np.ndarray:
    """Quality bytes [n, w] drawn from VDJ_QUAL_BINS at VDJ_QUAL_SHARES,
    in blocks of rows (bounds the float draws)."""
    bins = np.frombuffer(VDJ_QUAL_BINS, np.uint8)
    edges = np.cumsum(VDJ_QUAL_SHARES)[:-1]
    out = np.empty(shape, np.uint8)
    block = 1 << 18
    for s in range(0, shape[0], block):
        u = rng.random((min(block, shape[0] - s), shape[1]))
        out[s:s + block] = bins[np.searchsorted(edges, u, side="right")]
    return out


def _build_vdj_wide(tmp: str, n_cells: int, pairs_per_cell: int, seed: int,
                    genes: dict, background: int, n_wl: int) -> dict:
    """build_vdj_run past its defaults (see there)."""
    from ..io.gtf import write_fasta

    os.makedirs(tmp, exist_ok=True)
    d = _vdj_design_wide(n_cells, seed, genes, n_wl, background)
    rng = d["rng"]
    cell, umi, t, p1, end = _vdj_pairs(d, pairs_per_cell)
    bc = d["wl_packed"][d["cell_wl"][cell]]
    n_bg = 0
    if background:
        n_bg = int(round(len(cell) * VDJ_BACKGROUND_SHARE
                         / (1 - VDJ_BACKGROUND_SHARE)))
        if n_bg < background:
            raise ValueError(f"{n_bg} background pairs for {background} "
                             "barcodes")
        bgi, bumi, bt, bp1, bend = _vdj_background(d, n_bg)
        order = rng.permutation(len(cell) + n_bg)
        bc = np.concatenate([bc, d["wl_packed"][d["bg_wl"][bgi]]])[order]
        umi = np.concatenate([umi, bumi])[order]
        t = np.concatenate([t, bt])[order]
        p1 = np.concatenate([p1, bp1])[order]
        end = np.concatenate([end, bend])[order]
    fa = os.path.join(tmp, "regions.fa")
    write_fasta(fa, _vdj_t_records(d["seg"]))
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, d["wl_packed"])
    r1p, r2p = _write_vdj_fastqs(tmp, d, bc, umi, t, p1, end)
    P = len(t)
    bcs = lambda idx: [b.tobytes().decode() + "-1" for b in
                       _unpack_barcodes(d["wl_packed"][idx])]
    cell_bc = bcs(d["cell_wl"])
    cdr3s, genes_of, clonos = {}, {}, {}
    for c, b in enumerate(cell_bc):
        per = d["cdr3"][d["clono"][c]]
        cdr3s[b] = sorted([ch, per[ch][0]] for ch in per)
        genes_of[b] = sorted([ch, per[ch][1], per[ch][2]] for ch in per)
        clonos.setdefault(int(d["clono"][c]), []).append(b)
    expected = dict(total_reads=P, estimated_cells=n_cells,
                    n_clonotypes=len(d["cdr3"]), cdr3s=cdr3s,
                    bc_umi_pairs=n_cells * 2 * VDJ_UMIS_PER_CHAIN
                    + len(d["bg_wl"]))
    truth = dict(genes=genes_of,
                 clonotypes=sorted(sorted(v) for v in clonos.values()),
                 background=bcs(d["bg_wl"]), background_pairs=n_bg)
    return dict(fa=fa, wl=wl_path, fq1=r1p, fq2=r2p, n_reads=P,
                chemistry="SCVDJ", read_len=VDJ_READ_LEN, expected=expected,
                truth=truth)


VDJ_WRITE_BLOCK = 1 << 18       # read pairs made and written at once


def _advanced(rng, n: int):
    """A generator that starts where `rng` will be after n float64 draws
    (each takes one step of its PCG64)."""
    bg = np.random.PCG64()
    bg.state = rng.bit_generator.state
    return np.random.Generator(bg.advance(n))


def _write_vdj_fastqs(tmp: str, d: dict, bc, umi, t, p1, end):
    """The read pairs (packed barcode, UMI codes, transcript of d["tx"],
    mate-1 start, mate-2 end) as SCVDJ FASTQs: one barcode in 50 with a
    correctable error, R1 = barcode + UMI + TSO + mate 1, binned
    qualities with N at Q2.  The bases, qualities and text are made
    VDJ_WRITE_BLOCK pairs at a time; the qualities are those of one draw
    of every mate 1's, then every mate 2's, whatever the blocks.  Returns
    the R1 and R2 paths."""
    rng = d["rng"]
    bases = np.frombuffer(b"ACGT", np.uint8)
    P = len(t)
    _human_barcode_errors(bc, np.arange(0, P, 50), d["wl_packed"], rng)
    rng2 = _advanced(rng, P * VDJ_READ_LEN)      # where mate 2's draws begin
    codes = _vdj_tx_codes(d)
    tso = np.frombuffer(VDJ_TSO.encode(), np.uint8)
    ar = np.arange(VDJ_READ_LEN, dtype=np.int32)
    r1p = os.path.join(tmp, "vdj_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "vdj_S1_L001_R2_001.fastq")
    with open(r1p, "wb") as f1, open(r2p, "wb") as f2:
        for s in range(0, P, VDJ_WRITE_BLOCK):
            e = min(P, s + VDJ_WRITE_BLOCK)
            mate1 = bases[codes[t[s:e, None], p1[s:e, None] + ar]]
            mate2 = bases[3 - codes[t[s:e, None], (end[s:e] - VDJ_READ_LEN)
                                    [:, None] + ar][:, ::-1]]  # reverse
            head = np.concatenate([_unpack_barcodes(bc[s:e]), bases[umi[s:e]],
                                   np.broadcast_to(tso, (e - s, len(tso)))],
                                  1)
            q1 = np.concatenate([np.full(head.shape, ord("F"), np.uint8),
                                 _binned_quals(rng, mate1.shape)], 1)
            q2 = _binned_quals(rng2, mate2.shape)
            mate1[q1[:, head.shape[1]:] == ord("#")] = ord("N")
            mate2[q2 == ord("#")] = ord("N")
            f1.write(_fastq_block(np.concatenate([head, mate1], 1), q1))
            f2.write(_fastq_block(mate2, q2))
    return r1p, r2p


def _vdj_pairs(d: dict, pairs_per_cell: int):
    """Read pairs of the design `d`, shuffled: each cell holds
    2 x VDJ_UMIS_PER_CHAIN molecules (the first half TRA), every molecule
    at least one pair.  Mate 1 starts in the first VDJ_MATE1_START bases
    of its transcript; mate 2 ends VDJ_FRAGMENT bases after mate 1's
    start.  Returns (cell [P], UMI codes [P, 10], transcript [P], mate-1
    start [P], mate-2 end [P])."""
    rng = d["rng"]
    n_cells = len(d["clono"])
    n_mol = 2 * VDJ_UMIS_PER_CHAIN
    if pairs_per_cell < n_mol:
        raise ValueError(f"{pairs_per_cell} pairs cannot cover {n_mol} "
                         "molecules a cell")
    mol_cell = np.repeat(np.arange(n_cells), n_mol)
    mol_umi = _coded_umis(mol_cell, VDJ_UMI_LEN, rng)
    mol_tx = (2 * d["clono"][mol_cell]
              + (np.arange(n_cells * n_mol) % n_mol >= VDJ_UMIS_PER_CHAIN))
    per_cell = np.concatenate([np.arange(n_mol), rng.integers(
        0, n_mol, pairs_per_cell - n_mol)])
    mol = (np.arange(n_cells)[:, None] * n_mol + per_cell[None, :]).ravel()
    mol = mol[rng.permutation(len(mol))]
    p1 = rng.integers(0, VDJ_MATE1_START, len(mol))
    end = p1 + rng.integers(VDJ_FRAGMENT[0], VDJ_FRAGMENT[1] + 1, len(mol))
    return mol_cell[mol], mol_umi[mol], mol_tx[mol], p1, end


def _vdj_expected(d: dict, n_pairs: int) -> dict:
    n_cells = len(d["clono"])
    cdr3s = {}
    for c in range(n_cells):
        bc = d["wl"][d["cell_wl"][c]] + "-1"
        per = d["cdr3"][d["clono"][c]]
        cdr3s[bc] = sorted([ch, per[ch][0]] for ch in per)
    return dict(total_reads=n_pairs, estimated_cells=n_cells,
                n_clonotypes=len(d["cdr3"]), cdr3s=cdr3s,
                bc_umi_pairs=n_cells * 2 * VDJ_UMIS_PER_CHAIN)


def _vdj_tx_codes(d: dict) -> np.ndarray:
    """The base codes of d["tx"], a transcript a row, zero-padded."""
    L = max(len(s) for s in d["tx"])
    codes = np.zeros((len(d["tx"]), L), np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[list(b"ACGT")] = [0, 1, 2, 3]
    for i, s in enumerate(d["tx"]):
        codes[i, :len(s)] = lut[np.frombuffer(s.encode(), np.uint8)]
    return codes


def _vdj_mates(d: dict, t, p1, end) -> np.ndarray:
    """Base codes [2P, 120] on the transcript strand: the P mate-1 reads,
    then the P fragment ends that mate 2 reads in reverse complement."""
    codes = _vdj_tx_codes(d)
    P = len(t)
    out = np.empty((2 * P, VDJ_READ_LEN), np.uint8)
    ar = np.arange(VDJ_READ_LEN, dtype=np.int32)
    block = 1 << 18                 # bounds the [block, 120] index planes
    for s in range(0, P, block):
        e = min(P, s + block)
        out[s:e] = codes[t[s:e, None], p1[s:e, None] + ar]
        out[P + s:P + e] = codes[t[s:e, None],
                                 (end[s:e] - VDJ_READ_LEN)[:, None] + ar]
    return out


def vdj_kmer_inputs(n_cells: int, pairs_per_cell: int, seed: int = 37
                    ) -> dict:
    """The reads of build_vdj_run(n_cells, pairs_per_cell, seed) as the
    V(D)J pipeline hands them to `count_bc_umi_kmers`, made in memory (no
    FASTQ): barcode = whitelist index, UMI = packed u32, and two rows per
    pair, mate 1 and the reverse complement of mate 2 (both on the
    transcript strand), every base valid.  Also returns the distinct
    (barcode, UMI) pairs by construction and the number of 20-mers."""
    from ..ops.encode import pack_codes_np
    d = _vdj_design(n_cells, seed)
    cell, umi, t, p1, end = _vdj_pairs(d, pairs_per_cell)
    rna = _vdj_mates(d, t, p1, end)
    P = len(cell)
    bc = d["cell_wl"][cell].astype(np.uint32)
    umi_p = pack_codes_np(umi, VDJ_UMI_LEN)
    exp = _vdj_expected(d, P)
    return dict(bc=np.concatenate([bc, bc]), umi=np.concatenate([umi_p, umi_p]),
                rna=rna, nmask=np.ones(rna.shape, bool),
                bc_umi_pairs=exp["bc_umi_pairs"],
                n_kmers=2 * P * (VDJ_READ_LEN - 19))


def build_vdj_run(tmp: str, n_cells: int = 5, pairs_per_cell: int = 5000,
                  seed: int = 37, *, genes: dict | None = None,
                  background: int = 0, n_wl: int = VDJ_WL) -> dict:
    """A paired-end SCVDJ run of T cells whose outcome holds by
    construction.  Reference: TRA and TRB, VDJ_V_GENES V, VDJ_J_GENES J
    and one C gene each (regions.fa).  Cells: clonotypes of 2, 2 and 1
    cells at 5 cells (`_vdj_design`), each cell one TRA and one TRB
    transcript, 2 x VDJ_UMIS_PER_CHAIN molecules, `pairs_per_cell` read
    pairs (10x's recommended V(D)J depth is 5,000).  R1 = barcode + 10 bp
    UMI + 15 bp TSO + mate 1 (120 bases, sense, from the transcript's 5'
    end); R2 = mate 2 (120 bases, antisense) ending 150-450 bases after
    mate 1's start, so the mates cover UTR, V, CDR3, J and the start of
    C.  One pair in 50 carries a barcode error that stays correctable.
    Plain FASTQ with 'F' qualities, a 2,000-barcode whitelist.

    Expected (returned): reads, cells, clonotypes, each cell's CDR3
    nucleotides per chain, distinct (barcode, UMI) pairs.

    With `genes` ({chain: (V genes, J genes)}, e.g. VDJ_IMGT_GENES; see
    vdj_library_kw) the run is drawn at a library's width instead
    (_vdj_design_wide): V genes in families, a planted inner primer in
    some 5' UTRs, an expanded clonotype of 3-30 cells per 50 cells,
    `background` non-cell barcodes holding VDJ_BACKGROUND_SHARE of the
    pairs, one ambient molecule each, an n_wl-barcode whitelist, binned
    qualities with N at Q2.  It also returns
    "truth": each cell's V and J gene per chain, the clonotypes as a
    partition of the cell barcodes, the non-cell barcodes."""
    from ..io.gtf import write_fasta

    if genes is not None:
        return _build_vdj_wide(tmp, n_cells, pairs_per_cell, seed, genes,
                               background, n_wl)
    if background or n_wl != VDJ_WL:
        raise ValueError("background and n_wl draw a library's width: "
                         "give its genes too")
    os.makedirs(tmp, exist_ok=True)
    d = _vdj_design(n_cells, seed)
    cell, umi, t, p1, end = _vdj_pairs(d, pairs_per_cell)
    fa = os.path.join(tmp, "regions.fa")
    recs, n = {}, 0
    for chain in ("TRA", "TRB"):
        s = d["seg"][chain]
        for kind, region, seqs in (("V", "L-REGION+V-REGION", s["v"]),
                                   ("J", "J-REGION", s["j"]),
                                   ("C", "C-REGION", [s["c"]])):
            for i, seq in enumerate(seqs):
                n += 1
                g = f"{chain}{kind}{i + 1}"
                recs[f"{n}|{g}|{g}|{g}|{region}|{chain}|None|00"] = \
                    seq.encode()
    write_fasta(fa, recs)
    wl_path = os.path.join(tmp, "wl.txt")
    with open(wl_path, "w") as f:
        f.writelines(w + "\n" for w in d["wl"])
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes = _vdj_mates(d, t, p1, end)
    mate1 = bases[codes[:len(t)]]
    mate2 = bases[3 - codes[len(t):, ::-1]]      # reverse complement
    bc = d["wl_arr"][d["cell_wl"][cell]]
    _barcode_errors(bc, np.arange(0, len(bc), 50), d["wl_arr"], d["rng"])
    tso = np.frombuffer(VDJ_TSO.encode(), np.uint8)
    r1 = np.concatenate([bc, bases[umi], np.broadcast_to(tso, (len(bc), 15)),
                         mate1], axis=1)
    r1p = os.path.join(tmp, "vdj_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "vdj_S1_L001_R2_001.fastq")
    _write_fastq_pair(r1p, r2p, r1, mate2)
    return dict(fa=fa, wl=wl_path, fq1=r1p, fq2=r2p, n_reads=len(bc),
                chemistry="SCVDJ", read_len=VDJ_READ_LEN,
                expected=_vdj_expected(d, len(bc)))


# ---------------------------------------------------------------------------
# A B-cell V(D)J library (build_vdj_b_run)
# ---------------------------------------------------------------------------

# IMGT's functional human gene counts (IMGT Repertoire (IG and TR), "Gene
# tables" of the human IGH, IGK and IGL loci, functional genes): (V, J)
# genes a chain, and the IGHD genes
VDJ_B_GENES = {"IGH": (40, 6), "IGK": (35, 5), "IGL": (30, 5)}
VDJ_B_IGHD = 23
VDJ_B_D_LEN = (15, 31)              # IGHD genes run 11-37 bases
VDJ_B_D_TRIM = 4                    # bases trimmed off either end: 0-4
# the J motif's first codon and its x: IGHJ W-G-Q-G, IGKJ F-G-Q-G, IGLJ
# F-G-G-G (TTT or TTC for F)
VDJ_B_J_MOTIF = {"IGH": ("TGG", "CAG"), "IGK": ("TT", "CAA"),
                 "IGL": ("TT", "GGA")}
VDJ_B_CDR3_AA = {"IGH": (10, 25), "IGK": (8, 12), "IGL": (8, 12)}
# constant genes: the nine heavy isotypes, IGKC and the four functional
# IGLC genes (IGLJ i splices to IGLC i % 4); IGHG1-4, IGHA1-2 and the IGLC
# genes are near copies of a founder each, as in the real loci
VDJ_B_CONSTANTS = {
    "IGH": ("IGHM", "IGHD", "IGHG1", "IGHG2", "IGHG3", "IGHG4", "IGHA1",
            "IGHA2", "IGHE"),
    "IGK": ("IGKC",),
    "IGL": ("IGLC1", "IGLC2", "IGLC3", "IGLC7")}
VDJ_B_C_FAMILIES = (("IGHG1", "IGHG2", "IGHG3", "IGHG4"),
                    ("IGHA1", "IGHA2"), VDJ_B_CONSTANTS["IGL"])
VDJ_B_C_IDENTITY = (0.90, 0.95)     # a near copy's identity to its founder
VDJ_B_C_LEN = 260
VDJ_B_C_HEAD = 60                   # any two constant genes of a chain
VDJ_B_C_HEAD_DIFF = 5               # differ in 5 of their first 60 bases
VDJ_B_KINDS = {"naive": 0.60, "memory": 0.38, "plasma": 0.02}
VDJ_B_KAPPA = 0.60                  # cells with IGK, the rest IGL
VDJ_B_ISOTYPES = {
    "naive": {"IGHM": 0.7, "IGHD": 0.3},
    "memory": {"IGHM": 0.30, "IGHG1": 0.25, "IGHG2": 0.15, "IGHG3": 0.05,
               "IGHG4": 0.03, "IGHA1": 0.15, "IGHA2": 0.07},
    "plasma": {"IGHG1": 0.6, "IGHA1": 0.4}}
VDJ_B_NAIVE_SUBS = (0, 1)           # V substitutions of a naive cell
VDJ_B_SHM = {"memory": (0.02, 0.08), "plasma": (0.04, 0.08)}  # of V bases
VDJ_B_SHM_MARGIN = 20               # substitutions at V bases [20, 280)
VDJ_B_FAMILY_PER_CELL = 100         # one expanded family per 100 cells
VDJ_B_FAMILY_SIZES = (3, 15)
VDJ_B_TRUNK = (4, 12)               # V substitutions a family shares
VDJ_B_PRIVATE = (0, 6)              # a family cell's own on top
VDJ_B_PLASMA_FOLD = 20              # a plasma cell's molecules and pairs
VDJ_B_PAIRS_PER_CELL = 4000
VDJ_B_FRAGMENT = (150, 600)         # mate-2 end past mate 1's start: the
                                    # contigs reach 60 bases into C
VDJ_B_SEED = 41
VDJ_B_ATTEMPTS = 2000               # draws of a clone before giving up
VDJ_B_REDRAWS = 50                  # mutation draws on one clone's chains


def vdj_b_library_kw(n_cells: int) -> dict:
    """build_vdj_b_run's keywords for a B-cell library at the width users
    run: 20 non-cell barcodes a cell holding VDJ_BACKGROUND_SHARE of the
    pairs, the 737,280-barcode whitelist."""
    return dict(background=VDJ_BACKGROUND_PER_CELL * n_cells,
                n_wl=VDJ_WL_5P)


def _vdj_b_constants(rng) -> dict:
    """{chain: {name: sequence}}: VDJ_B_C_LEN random bases a gene, the
    members of a VDJ_B_C_FAMILIES family drawn from its founder at
    VDJ_B_C_IDENTITY, each redrawn until it differs from every earlier
    gene of its chain in VDJ_B_C_HEAD_DIFF of the first VDJ_B_C_HEAD."""
    family = {g: f for f in VDJ_B_C_FAMILIES for g in f}
    founders = {f: rng.integers(0, 4, VDJ_B_C_LEN) for f in VDJ_B_C_FAMILIES}
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = {}
    for chain, names in VDJ_B_CONSTANTS.items():
        genes = {}
        for g in names:
            for _ in range(VDJ_B_ATTEMPTS):
                if g in family:
                    s = founders[family[g]].copy()
                    mut = rng.random(len(s)) >= rng.uniform(*VDJ_B_C_IDENTITY)
                    s[mut] = (s[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
                else:
                    s = rng.integers(0, 4, VDJ_B_C_LEN)
                if all((s[:VDJ_B_C_HEAD] != o[:VDJ_B_C_HEAD]).sum()
                       >= VDJ_B_C_HEAD_DIFF for o in genes.values()):
                    break
            else:
                raise ValueError(f"no {g} apart from the other constants")
            genes[g] = s
        out[chain] = {g: acgt[s].tobytes().decode() for g, s in genes.items()}
    return out


def _vdj_b_reference(rng) -> dict:
    """The IGH, IGK and IGL segments: per chain V genes in families
    (_vdj_families), every VDJ_PRIMER_EVERY-th 5' UTR carrying the reverse
    complement of a human BCR inner primer at VDJ_PRIMER_AT (the seven in
    turn), each UTR drawn so that the alignment of UTR + V to V starts at
    V's first base, J genes opening with the chain's VDJ_B_J_MOTIF, the constant
    genes (_vdj_b_constants) and, for IGH, VDJ_B_IGHD D genes."""
    from ..vdj.assembly import INNER_PRIMERS, _revcomp_b

    from ..native.vdj_host import local_align

    primers = [_revcomp_b(p).decode()
               for p in INNER_PRIMERS[("human", "bcr")]]
    seg, k = {}, 0
    for chain, (nv, nj) in VDJ_B_GENES.items():
        v = _vdj_families(nv, rng)
        utr = []
        for i in range(nv):
            p = ""
            if i % VDJ_PRIMER_EVERY == 0:
                p = primers[k % len(primers)]
                k += 1
            # the local alignment's traceback of UTR + V against V must
            # start at V's first base: where the UTR's last bases match
            # V's first, it climbs into the UTR and SegmentHit.variants
            # walks the V off by as many bases (ROADMAP.md, "Found in
            # the reference")
            for _ in range(VDJ_B_ATTEMPTS):
                u = _rand_nt(VDJ_UTR, rng)
                u = u[:VDJ_PRIMER_AT] + p + u[VDJ_PRIMER_AT + len(p):]
                _, cs, _, ss, _ = local_align(u + v[i], v[i])
                if (cs, ss) == (VDJ_UTR, 0):
                    break
            else:
                raise ValueError(f"no 5' UTR for {chain}V{i + 1}")
            utr.append(u)
        first, x = VDJ_B_J_MOTIF[chain]
        j = []
        for _ in range(nj):
            f = first if len(first) == 3 else first + "TC"[rng.integers(2)]
            j.append(f + "GG" + _rand_nt(1, rng) + x + "GG"
                     + _rand_nt(1, rng) + _rand_nt(VDJ_J_LEN - 12, rng))
        seg[chain] = dict(v=v, j=j, utr=utr)
    seg["IGH"]["d"] = [_rand_nt(int(rng.integers(VDJ_B_D_LEN[0],
                                                 VDJ_B_D_LEN[1] + 1)), rng)
                       for _ in range(VDJ_B_IGHD)]
    for chain, genes in _vdj_b_constants(rng).items():
        seg[chain]["c"] = genes
    return seg


def _vdj_b_plan(n_cells: int, rng, families) -> list[dict]:
    """The clones of a drawn library: VDJ_B_KINDS' shares of naive, memory
    and plasma cells (at least one plasma cell); expanded families of
    `families` cells (None: one of VDJ_B_FAMILY_SIZES cells per
    VDJ_B_FAMILY_PER_CELL cells, at least one, none larger than its share
    of the memory and plasma cells) drawn among the memory and
    plasma cells, family k with a CDR3 subclone of a third of its cells
    when k % 3 == 0 and a class-switched third when k % 3 == 1; every
    other cell a clone of its own.  See _vdj_b_design for a clone's keys."""
    n_plasma = max(1, int(round(VDJ_B_KINDS["plasma"] * n_cells)))
    n_memory = int(round(VDJ_B_KINDS["memory"] * n_cells))
    n_naive = n_cells - n_plasma - n_memory
    if n_naive < 0:
        raise ValueError(f"{n_cells} cells are too few for a B library")
    pool = rng.permutation(["memory"] * n_memory
                           + ["plasma"] * n_plasma).tolist()
    if families is None:
        lo, hi = VDJ_B_FAMILY_SIZES
        n_fam = max(1, n_cells // VDJ_B_FAMILY_PER_CELL)
        families = np.minimum(rng.integers(lo, hi + 1, n_fam),
                              max(lo, len(pool) // n_fam)).tolist()
    if sum(families) > len(pool):
        raise ValueError(f"families of {sum(families)} cells among "
                         f"{len(pool)} memory and plasma cells")
    plan = []
    for k, size in enumerate(families):
        kinds, pool = pool[:size], pool[size:]
        plan.append(dict(kinds=kinds,
                         sub=max(1, size // 3) if k % 3 == 0 else 0,
                         switch=max(1, size // 3) if k % 3 == 1 else 0))
    return plan + [dict(kinds=[k]) for k in pool + ["naive"] * n_naive]


def _cdr3_ok(mid: str, j: str) -> bool:
    """A CDR3 of TGT + mid + the J motif's first codon: no stop codon in
    frame and no Cys codon in any frame from the V end into the J (so the
    V-end Cys stays the last anchor before the motif)."""
    from ..vdj.annotate import translate

    s = "GT" + mid + j[:3]
    return (len(mid) % 3 == 0 and "*" not in translate(mid)
            and "TGT" not in s and "TGC" not in s)


def _vdj_b_mid(chain: str, seg: dict, ji: int, rng) -> str:
    """The CDR3's bases between the V-end Cys codon and the J motif: for
    IGH N1 + an IGHD gene trimmed VDJ_B_D_TRIM bases at most at either end
    + N2, for IGK and IGL N additions; VDJ_B_CDR3_AA[chain] codons with
    the Cys and the motif's first codon, redrawn until _cdr3_ok."""
    lo, hi = VDJ_B_CDR3_AA[chain]
    for _ in range(VDJ_B_ATTEMPTS):
        n = 3 * int(rng.integers(lo, hi + 1)) - 6
        if chain == "IGH":
            d = seg["d"][int(rng.integers(len(seg["d"])))]
            a, b = rng.integers(0, VDJ_B_D_TRIM + 1, 2)
            d = d[a:len(d) - b][:n]
            n1 = int(rng.integers(0, n - len(d) + 1))
            mid = _rand_nt(n1, rng) + d + _rand_nt(n - len(d) - n1, rng)
        else:
            mid = _rand_nt(n, rng)
        if _cdr3_ok(mid, seg["j"][ji]):
            return mid
    raise ValueError(f"no {chain} CDR3 drawn")


def _one_nt_off(mid: str, j: str, rng) -> str:
    """mid with one base substituted, still _cdr3_ok."""
    for _ in range(VDJ_B_ATTEMPTS):
        i = int(rng.integers(len(mid)))
        b = "ACGT"[("ACGT".index(mid[i]) + int(rng.integers(1, 4))) % 4]
        out = mid[:i] + b + mid[i + 1:]
        if _cdr3_ok(out, j):
            return out
    raise ValueError("no one-base variant of a CDR3")


def _draw_subs(v: str, n: int, rng, avoid=()) -> dict:
    """n substitutions {V position: base} at V bases
    [VDJ_B_SHM_MARGIN, len - VDJ_B_SHM_MARGIN) outside `avoid`, each base
    another than the germline's."""
    free = np.setdiff1d(np.arange(VDJ_B_SHM_MARGIN,
                                  len(v) - VDJ_B_SHM_MARGIN),
                        np.fromiter(avoid, np.int64, len(avoid)))
    pos = np.sort(rng.choice(free, n, replace=False))
    shift = rng.integers(1, 4, n)
    return {int(p): "ACGT"[("ACGT".index(v[p]) + int(s)) % 4]
            for p, s in zip(pos, shift)}


def _mutated(v: str, subs: dict) -> str:
    s = list(v)
    for p, b in subs.items():
        s[p] = b
    return "".join(s)


def _draw_isotype(kind: str, rng, but: str | None = None) -> str:
    """A heavy constant gene at VDJ_B_ISOTYPES[kind]'s shares, `but` out."""
    w = {g: p for g, p in VDJ_B_ISOTYPES[kind].items() if g != but}
    p = np.array(list(w.values()))
    return str(rng.choice(list(w), p=p / p.sum()))


def _vdj_b_subs(spec: dict, kinds: list, chains: dict, seg: dict, rng,
                partner: list | None) -> list[dict]:
    """A clone's V substitutions, per cell {chain: {position: base}} (see
    _vdj_b_design); with `partner` (a "same" clone's first cell's) each
    of its positions with a third base."""
    multi = len(kinds) > 1
    trunk = {}
    for chain, (vi, _, _) in chains.items():
        n = spec.get("trunk")
        if n is None:
            n = (int(rng.integers(VDJ_B_TRUNK[0], VDJ_B_TRUNK[1] + 1))
                 if multi and "naive" not in kinds else 0)
        trunk[chain] = _draw_subs(seg[chain]["v"][vi], n, rng)
    out = []
    for kind in kinds:
        per = {}
        for chain, (vi, _, _) in chains.items():
            v = seg[chain]["v"][vi]
            if partner is not None:
                per[chain] = {p: str(rng.choice([x for x in "ACGT"
                                                 if x not in (v[p], b)]))
                              for p, b in partner[chain].items()}
                continue
            n = spec.get("private")
            if n is None and kind == "naive":
                n = int(rng.integers(VDJ_B_NAIVE_SUBS[0],
                                     VDJ_B_NAIVE_SUBS[1] + 1))
            elif n is None:
                total = int(round(rng.uniform(*VDJ_B_SHM[kind]) * len(v)))
                n = (total if not multi else
                     int(rng.integers(VDJ_B_PRIVATE[0], VDJ_B_PRIVATE[1] + 1))
                     if kind == "memory" else
                     max(total - len(trunk[chain]), 0))
            per[chain] = {**trunk[chain],
                          **_draw_subs(v, n, rng, avoid=trunk[chain])}
        out.append(per)
    return out


def _subclone_joins(main: list, sub: list) -> bool:
    """Whether group_clonotypes joins a CDR3 subclone one nucleotide off
    to its clone: each side's heavy V evidence (its cells' substitutions,
    united) by the shared-mutation model where both carry
    JOIN_MIN_MUTATIONS, else the frequency gate on their cells."""
    from ..vdj.annotate import (JOIN_LOG10_P_MAX, JOIN_MIN_MUTATIONS,
                                shared_mutation_join_log10p)

    ea, eb = frozenset().union(*main), frozenset().union(*sub)
    if min(len(ea), len(eb)) >= JOIN_MIN_MUTATIONS:
        return shared_mutation_join_log10p(ea, eb, 1) <= JOIN_LOG10_P_MAX
    return min(len(main), len(sub)) <= max(1, max(len(main), len(sub)) // 4)


def _vdj_b_records(seg: dict) -> dict:
    """regions.fa's records {header: sequence}: per chain its V, D (IGH),
    J and C genes, named IGHV1.., IGHD1.., IGHJ1.. and the constants'."""
    recs, n = {}, 0
    for chain in VDJ_B_GENES:
        s = seg[chain]
        parts = [("L-REGION+V-REGION",
                  [(f"{chain}V{i + 1}", x) for i, x in enumerate(s["v"])]),
                 ("D-REGION",
                  [(f"{chain}D{i + 1}", x) for i, x in enumerate(s.get(
                      "d", ()))]),
                 ("J-REGION",
                  [(f"{chain}J{i + 1}", x) for i, x in enumerate(s["j"])]),
                 ("C-REGION", list(s["c"].items()))]
        for region, genes in parts:
            for g, x in genes:
                n += 1
                recs[f"{n}|{g}|{g}|{g}|{region}|{chain}|None|00"] = x
    return recs


def _combined_records(*parts: dict) -> dict:
    """One regions.fa's records {header: sequence str} from several
    references' (str or bytes sequences), in order, each header's record
    number renumbered from 1."""
    out = {}
    for recs in parts:
        for h, x in recs.items():
            out[f"{len(out) + 1}|" + h.split("|", 1)[1]] = (
                x.decode() if isinstance(x, bytes) else x)
    return out


def _vdj_b_annotation(annotator, seq: str, want: dict):
    """The annotation of a planted transcript's `seq` when it is what the
    design wants -- chain, V, J and C gene, CDR3 nucleotides, productive,
    the V's somatic variants (SegmentHit.variants) exactly the planted
    substitutions, and every other V gene sharing a 16-mer scoring below
    the planted one under the local alignment -- else None."""
    from ..native.vdj_host import local_align
    from ..vdj.annotate import _kmers

    a = annotator.annotate(seq)
    name = lambda h: h.segment.gene_name if h is not None else None
    if not (a.productive and a.chain == want["chain"]
            and (name(a.v), name(a.j), name(a.c), a.cdr3_nt)
            == (want["v"], want["j"], want["c"], want["nt"])
            and a.v.variants(seq) == frozenset(want["subs"].items())):
        return None
    segs, seqs, index = annotator.regions["V"]
    for i in sorted({i for km in _kmers(seq) for i in index.get(km, ())}):
        if segs[i].gene_name != want["v"] \
                and local_align(seq, seqs[i])[0] >= a.v.score:
            return None
    return a


def _vdj_b_design(n_cells: int, n_wl: int, background: int,
                  families=None, plan=None, ahead: dict | None = None,
                  barcodes: bool = True) -> dict:
    """Segments, clones and cells of a B-cell library.  A clone (`plan`,
    else _vdj_b_plan) is a dict: "kinds", its cells' kinds; "sub", how
    many of its last cells carry a heavy CDR3 one nucleotide off the
    others'; "switch", how many of its memory cells take another isotype
    than the clone's; optional "trunk" and "private", the substitutions
    shared by its cells and a cell's own on each chain (drawn: a clone of
    several cells shares VDJ_B_TRUNK, each adding VDJ_B_PRIVATE, a plasma
    cell enough to reach VDJ_B_SHM; a single cell VDJ_B_SHM of its V
    bases, a naive cell VDJ_B_NAIVE_SUBS); "near", (an earlier clone,
    "IGH" or "light"): that chain's V, J and CDR3 of that clone, taken
    with one nucleotide off; "same", an
    earlier clone whose chains it takes whole, its cells substituted at
    that clone's first cell's positions with other bases; "light2",
    both an IGK and an IGL chain; "drop", how many of its last cells hold
    one molecule of their IGL transcript (under MIN_UMIS_PER_CONTIG, so
    that the subset merge joins them to the clone).

    Each clone takes a heavy chain and, VDJ_B_KAPPA of them, an IGK else
    an IGL chain (both with "light2"), a random V and J each; its CDR3s
    differ from every
    other clone's of a (chain, V, J, length) bucket in at least
    max(1, length // 10) + 2 bases (a near or same partner apart).  A
    cell's transcripts are UTR + V with its substitutions + CDR3 + J + C,
    no (K-1)-mer twice in them.  Each transcript is annotated as the
    pipeline annotates a contig (vdj/support.py Annotator, to 60 bases
    into C) and the clone's mutations are redrawn until _vdj_b_annotation
    holds for every cell and a CDR3 subclone's join holds: by the shared
    mutations where both sides carry JOIN_MIN_MUTATIONS, else by the
    frequency gate.  Last, group_clonotypes of those annotations (a
    dropped transcript's left out) must give the clones as its partition.
    With `ahead` (another reference's records) the annotator holds a
    combined reference, those records and then the B reference's,
    numbered in that order ("ref_recs"), so that the other segments are
    in its way too.  With `barcodes` false no whitelist is drawn."""
    from ..vdj import annotate
    from ..vdj.assembly import INNER_PRIMERS, K, _revcomp_b
    from ..vdj.reference import REGION_MAP, Segment, VdjReference
    from ..vdj.support import Annotator

    rng = np.random.default_rng(VDJ_B_SEED)
    seg = _vdj_b_reference(rng)
    plan = _vdj_b_plan(n_cells, rng, families) if plan is None else plan
    if sum(len(c["kinds"]) for c in plan) != n_cells:
        raise ValueError(f"the plan holds other than {n_cells} cells")
    recs = _vdj_b_records(seg)
    held = recs if ahead is None else _combined_records(ahead, recs)
    fields = [h.split("|") for h in held]
    annotator = Annotator(VdjReference(
        [Segment(f[0], f[3], REGION_MAP[f[4]], f[5], s.encode())
         for f, s in zip(fields, held.values())]))
    primers = [_revcomp_b(p).decode() for v in INNER_PRIMERS.values()
               for p in v]
    seen: dict = {}
    clones, cells, anns = [], [], {}
    lv = len(seg["IGH"]["v"][0])

    def bucket_ok(chain, vi, ji, mid, partner):
        """mid's CDR3 at least max(1, length // 10) + 2 bases from every
        other clone's of its bucket (the CDR3s share TGT and the J's
        first codon, so their middles' distance is theirs)."""
        mm = max(1, (len(mid) + 6) // 10) + 2
        return all(sum(a != b for a, b in zip(mid, o)) >= mm
                   for c, o in seen.get((chain, vi, ji, len(mid)), ())
                   if c != partner)

    def kmers(t):
        return [t[i:i + K - 1] for i in range(len(t) - K + 2)]

    def draw_chains(spec, ci):
        """(chains {chain: (V, J, CDR3 middle)}, the subclone's heavy
        middle or None), each CDR3 apart in its bucket."""
        if "same" in spec:
            return dict(clones[spec["same"]]["chains"]), None
        partner, on = spec.get("near", (None, None))
        light = "IGK" if rng.random() < VDJ_B_KAPPA else "IGL"
        if on == "light":
            light = [c for c in clones[partner]["chains"] if c != "IGH"][0]
        chains = {}
        for chain in (("IGH", "IGK", "IGL") if spec.get("light2") else
                      ("IGH", light)):
            nv, nj = VDJ_B_GENES[chain]
            near = partner if (chain == "IGH") == (on == "IGH") else None
            for _ in range(VDJ_B_ATTEMPTS):
                if near is None:
                    vi, ji = int(rng.integers(nv)), int(rng.integers(nj))
                    mid = _vdj_b_mid(chain, seg[chain], ji, rng)
                else:
                    vi, ji, mid = clones[near]["chains"][chain]
                    mid = _one_nt_off(mid, seg[chain]["j"][ji], rng)
                if bucket_ok(chain, vi, ji, mid, near):
                    break
            else:
                raise ValueError(f"clone {ci}: no {chain} CDR3 apart")
            chains[chain] = (vi, ji, mid)
        if not spec.get("sub"):
            return chains, None
        hv, hj, hmid = chains["IGH"]
        for _ in range(VDJ_B_ATTEMPTS):
            sub = _one_nt_off(hmid, seg["IGH"]["j"][hj], rng)
            if bucket_ok("IGH", hv, hj, sub, ci):
                return chains, sub
        raise ValueError(f"clone {ci}: no subclone CDR3 apart")

    def draw_isotypes(spec, kinds):
        """The clone's isotype, a plasma cell's IgG1 or IgA1, a switched
        share of its memory cells another memory isotype."""
        main_kind = ("plasma" if set(kinds) == {"plasma"} else
                     "naive" if "naive" in kinds else "memory")
        iso = _draw_isotype(main_kind, rng)
        isos = [iso if k != "plasma" or iso in VDJ_B_ISOTYPES["plasma"]
                else _draw_isotype("plasma", rng) for k in kinds]
        memory = [i for i, k in enumerate(kinds) if k == "memory"]
        for i in memory[:spec.get("switch", 0)]:
            isos[i] = _draw_isotype("memory", rng, but=iso)
        return isos

    def transcripts(spec, kinds, chains, sub, isos):
        """Per cell its two transcripts and (wanted, annotation) pairs
        under newly drawn mutations, or None where a check fails."""
        subs = _vdj_b_subs(spec, kinds, chains, seg, rng, None if
                           "same" not in spec else
                           clones[spec["same"]]["subs0"])
        if sub is not None:
            ev = [frozenset(s["IGH"].items()) for s in subs]
            n = spec["sub"]
            if not _subclone_joins(ev[:-n], ev[-n:]):
                return None
        out = []
        for i, kind in enumerate(kinds):
            taken, cell = set(), []
            for chain, (vi, ji, mid) in chains.items():
                if chain == "IGH" and sub is not None \
                        and i >= len(kinds) - spec["sub"]:
                    mid = sub
                s = seg[chain]
                c = isos[i] if chain == "IGH" else list(
                    s["c"])[ji % len(s["c"])]
                t = (s["utr"][vi] + _mutated(s["v"][vi], subs[i][chain])
                     + mid + s["j"][ji] + s["c"][c])
                km = kmers(t)
                if (len(set(km)) != len(km) or taken & set(km)
                        or not all(t.find(p) in (-1, VDJ_PRIMER_AT)
                                   and t.find(p, VDJ_PRIMER_AT + 1) < 0
                                   for p in primers)):
                    return None
                taken.update(km)
                want = dict(chain=chain, v=f"{chain}V{vi + 1}",
                            j=f"{chain}J{ji + 1}", c=c,
                            nt="TGT" + mid + s["j"][ji][:3],
                            subs=subs[i][chain])
                c_at = VDJ_UTR + lv + len(mid) + VDJ_J_LEN
                a = _vdj_b_annotation(annotator, t[:c_at + VDJ_B_C_HEAD],
                                      want)
                if a is None:
                    return None
                cell.append((t, want, a))
            out.append(cell)
        return out, subs

    for ci, spec in enumerate(plan):
        kinds = list(spec["kinds"])
        for _ in range(VDJ_B_ATTEMPTS // VDJ_B_REDRAWS):
            chains, sub = draw_chains(spec, ci)
            isos = draw_isotypes(spec, kinds)
            for _ in range(VDJ_B_REDRAWS):
                drawn = transcripts(spec, kinds, chains, sub, isos)
                if drawn is not None:
                    break
            if drawn is not None:
                break
        else:
            raise ValueError(f"clone {ci} ({spec}): no draw holds")
        drawn, subs = drawn
        clone = dict(chains=chains, cells=[], subs0=subs[0])
        for i, (kind, cell) in enumerate(zip(kinds, drawn)):
            low = [w["chain"] == "IGL" and i >= len(kinds) - spec.get(
                "drop", 0) for _, w, _ in cell]
            anns[str(len(cells))] = [a for (_, _, a), x in zip(cell, low)
                                     if not x]
            clone["cells"].append(len(cells))
            cells.append(dict(clone=ci, kind=kind, tx=[t for t, _, _ in cell],
                              want=[w for _, w, _ in cell], low=low))
        for chain, (vi, ji, mid) in chains.items():
            seen.setdefault((chain, vi, ji, len(mid)), []).append((ci, mid))
        if sub is not None:
            seen[("IGH", *chains["IGH"][:2], len(sub))].append((ci, sub))
        clones.append(clone)
    got = sorted(sorted(c["barcodes"], key=int)
                 for c in annotate.group_clonotypes(anns))
    want = sorted([str(i) for i in c["cells"]] for c in clones)
    if sorted(got) != sorted(want):
        raise ValueError("group_clonotypes of the planted annotations "
                         "does not give the planned clones")
    out = dict(seg=seg, recs=recs, ref_recs=held, clones=clones,
               cells=cells, anns=anns,
               tx=[t for c in cells for t in c["tx"]])
    if not barcodes:
        return out
    wl = _human_whitelist(rng, n_wl)
    picks = rng.choice(n_wl, n_cells + background, replace=False)
    return dict(out, slot=rng.permutation(n_cells), wl_packed=wl,
                cell_wl=np.sort(picks[:n_cells]),
                bg_wl=np.sort(picks[n_cells:]), rng=rng)


def _vdj_b_pairs(d: dict, pairs_per_cell: int, plasma_pairs: int):
    """Read pairs of the B design `d`, shuffled: a cell holds
    2 x VDJ_UMIS_PER_CHAIN molecules (a plasma cell VDJ_B_PLASMA_FOLD
    times as many and plasma_pairs pairs), the first half of them its
    heavy transcript, every molecule at least one pair.  Mate 1 starts
    in the first VDJ_MATE1_START bases; mate 2 ends VDJ_B_FRAGMENT bases
    after mate 1's start.  Returns the arrays of _vdj_pairs."""
    rng = d["rng"]
    plasma = np.array([c["kind"] == "plasma" for c in d["cells"]])
    n_mol = 2 * VDJ_UMIS_PER_CHAIN * np.where(plasma, VDJ_B_PLASMA_FOLD, 1)
    pairs = np.where(plasma, plasma_pairs, pairs_per_cell)
    if (pairs < n_mol).any():
        raise ValueError(f"{pairs.min()} pairs cannot cover a cell's "
                         "molecules")
    short = min(len(t) for t in d["tx"])
    if VDJ_MATE1_START - 1 + VDJ_B_FRAGMENT[1] > short:
        raise ValueError(f"a {short}-base transcript is shorter than a "
                         "fragment")
    first = np.r_[0, np.cumsum(n_mol)[:-1]]
    mol_cell = np.repeat(np.arange(len(n_mol)), n_mol)
    mol_umi = _coded_umis(mol_cell, VDJ_UMI_LEN, rng)
    rank = np.arange(len(mol_cell)) - first[mol_cell]
    mol_tx = 2 * mol_cell + (rank >= n_mol[mol_cell] // 2)
    extra_cell = np.repeat(np.arange(len(n_mol)), pairs - n_mol)
    mol = np.concatenate([np.arange(len(mol_cell)), first[extra_cell] + (
        rng.random(len(extra_cell)) * n_mol[extra_cell]).astype(np.int64)])
    mol = mol[rng.permutation(len(mol))]
    p1 = rng.integers(0, VDJ_MATE1_START, len(mol))
    end = p1 + rng.integers(VDJ_B_FRAGMENT[0], VDJ_B_FRAGMENT[1] + 1,
                            len(mol))
    return mol_cell[mol], mol_umi[mol], mol_tx[mol], p1, end


def build_vdj_b_run(tmp: str, n_cells: int = 12,
                    pairs_per_cell: int = VDJ_B_PAIRS_PER_CELL, *,
                    background: int = 0,
                    n_wl: int = VDJ_WL_5P, plasma_pairs: int | None = None,
                    families=None, plan=None) -> dict:
    """A paired-end SCVDJ run of B cells whose outcome holds by
    construction (_vdj_b_design).  Reference (regions.fa): IGH, IGK and
    IGL at IMGT's functional human gene counts (VDJ_B_GENES, V genes in
    families), the 23 IGHD genes as D-REGION, IGHJ genes opening with
    W-G-x-G and IGKJ / IGLJ genes with F-G-x-G, the nine heavy isotypes,
    IGKC and four IGLC genes, near copies where the loci have them, and
    the seven human BCR inner primers planted in every second 5' UTR.
    Cells: VDJ_B_KINDS' shares of naive (IgM or IgD, 0-1 V substitution),
    memory (IgM, IgG1-4 or IgA1-2, 2-8% of V bases substituted) and plasma
    cells (IgG1 or IgA1, 4-8%, VDJ_B_PLASMA_FOLD times the molecules, at
    plasma_pairs pairs, default VDJ_B_PLASMA_FOLD x pairs_per_cell); one
    heavy and one light transcript each, IGK in VDJ_B_KAPPA of the clones,
    heavy CDR3s of 10-25 codons (N1 + a trimmed IGHD + N2), light of 8-12;
    one expanded family of 3-15 memory and plasma cells per 100 cells
    (`families`: their sizes instead) sharing VDJ_B_TRUNK V substitutions,
    a third of the families with a one-nucleotide CDR3 subclone and a
    third with class-switched cells (`plan` gives the clones instead).
    `background` non-cell barcodes hold VDJ_BACKGROUND_SHARE of the pairs,
    one ambient molecule each from a plasma cell's transcripts; an
    n_wl-barcode whitelist, binned qualities with N at Q2, mates laid out
    as build_vdj_run's with the fragment to VDJ_B_FRAGMENT.

    Returns the paths, "expected" (as build_vdj_run's) and "truth": each
    cell's V and J genes per chain ("genes") and C gene ("c_genes"), the
    clonotypes as a partition of the cell barcodes (each family one,
    its subclones included), the non-cell barcodes, each cell's kind,
    the cells of CDR3 subclones and of class switches, and per plasma
    barcode its rows (two a pair), its pairs' indices in the FASTQs and
    their packed UMIs in that order."""
    from ..io.gtf import write_fasta
    from ..ops.encode import pack_codes_np

    os.makedirs(tmp, exist_ok=True)
    d = _vdj_b_design(n_cells, n_wl, background, families, plan)
    rng = d["rng"]
    if plasma_pairs is None:
        plasma_pairs = VDJ_B_PLASMA_FOLD * pairs_per_cell
    cell, umi, t, p1, end = _vdj_b_pairs(d, pairs_per_cell, plasma_pairs)
    cell_wl = d["cell_wl"][d["slot"]]               # cell -> whitelist index
    bc = d["wl_packed"][cell_wl[cell]]
    n_bg = 0
    plasma = [i for i, c in enumerate(d["cells"]) if c["kind"] == "plasma"]
    if background:
        n_bg = int(round(len(cell) * VDJ_BACKGROUND_SHARE
                         / (1 - VDJ_BACKGROUND_SHARE)))
        if n_bg < background:
            raise ValueError(f"{n_bg} background pairs for {background} "
                             "barcodes")
        # transcripts 2i and 2i + 1 are cell i's: the ambient molecules
        # come from the plasma cells'
        bgi, bumi, bt, bp1, bend = _vdj_background(
            dict(rng=rng, bg_wl=d["bg_wl"], clono=np.array(plasma)), n_bg)
        order = rng.permutation(len(cell) + n_bg)
        bc = np.concatenate([bc, d["wl_packed"][d["bg_wl"][bgi]]])[order]
        cell = np.concatenate([cell, np.full(n_bg, -1)])[order]
        umi = np.concatenate([umi, bumi])[order]
        t = np.concatenate([t, bt])[order]
        p1 = np.concatenate([p1, bp1])[order]
        end = np.concatenate([end, bend])[order]
    fa = os.path.join(tmp, "regions.fa")
    write_fasta(fa, {h: s.encode() for h, s in d["recs"].items()})
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, d["wl_packed"])
    r1p, r2p = _write_vdj_fastqs(tmp, d, bc, umi, t, p1, end)
    P = len(t)
    bcs = lambda idx: [b.tobytes().decode() + "-1" for b in
                       _unpack_barcodes(d["wl_packed"][idx])]
    cell_bc = bcs(cell_wl)
    cdr3s, genes, c_genes, kinds = {}, {}, {}, {}
    for i, c in enumerate(d["cells"]):
        b = cell_bc[i]
        cdr3s[b] = sorted([w["chain"], w["nt"]] for w in c["want"])
        genes[b] = sorted([w["chain"], w["v"], w["j"]] for w in c["want"])
        c_genes[b] = sorted([w["chain"], w["c"]] for w in c["want"])
        kinds[b] = c["kind"]
    clonotypes = sorted(sorted(cell_bc[i] for i in c["cells"])
                        for c in d["clones"])
    heavy = {b: dict(cdr3s[b])["IGH"] for b in cell_bc}
    iso = {b: dict(c_genes[b])["IGH"] for b in cell_bc}
    subclones = [cl for cl in clonotypes if len({heavy[b] for b in cl}) > 1]
    switched = [cl for cl in clonotypes if len({iso[b] for b in cl}) > 1]
    plasma_truth = {}
    for i in plasma:
        at = np.flatnonzero(cell == i)
        plasma_truth[cell_bc[i]] = dict(
            rows=2 * len(at), pairs=at,
            umi=pack_codes_np(umi[at], VDJ_UMI_LEN))
    n_mol = sum(2 * VDJ_UMIS_PER_CHAIN * (VDJ_B_PLASMA_FOLD
                                          if c["kind"] == "plasma" else 1)
                for c in d["cells"])
    expected = dict(total_reads=P, estimated_cells=n_cells,
                    n_clonotypes=len(d["clones"]), cdr3s=cdr3s,
                    bc_umi_pairs=n_mol + len(d["bg_wl"]))
    truth = dict(genes=genes, c_genes=c_genes, clonotypes=clonotypes,
                 background=bcs(d["bg_wl"]), background_pairs=n_bg,
                 kinds=kinds, subclones=subclones, switched=switched,
                 plasma=plasma_truth)
    return dict(fa=fa, wl=wl_path, fq1=r1p, fq2=r2p, n_reads=P,
                chemistry="SCVDJ", read_len=VDJ_READ_LEN, expected=expected,
                truth=truth)


# ---------------------------------------------------------------------------
# 5' immune profiling: GEX, VDJ-T and VDJ-B of one well (build_immune_run)
# ---------------------------------------------------------------------------

IMMUNE_CELLS = 10_000
# A PBMC well's cells: T, B and the rest (NK cells, monocytes, dendritic
# cells), GEX only.  Inside the usual ranges of adult human PBMCs
# (Kleiveland, "Peripheral Blood Mononuclear Cells", in The Impact of Food
# Bioactives on Health, Springer 2015, ch. 15: lymphocytes 70-90% of
# PBMCs, of them T cells 70-85% and B cells up to 15%).
IMMUNE_SHARES = {"T": 0.60, "B": 0.15, "other": 0.25}
# GEX read pairs a cell.  10x's 5' v2 GEX guide asks for 20,000; cut ten
# times because count ran 200M reads of one well on its own already
# (chip_smoke.depth_run): 20M pairs for 10,000 cells.
IMMUNE_GEX_PAIRS = 2_000
IMMUNE_VDJ_PAIRS = 5_000            # 10x's V(D)J depth, T and B alike
# Dual-alpha T cells: up to a third of human T cells express two TCR alpha
# chains (Padovan et al., Science 1993, "Expression of two T cell receptor
# alpha chains: dual receptor T cells"); a tenth of the clones here.
IMMUNE_TWO_ALPHA = 0.10
# Kappa + lambda B cells: a small share of human blood B cells carries both
# (Giachino, Padovan and Lanzavecchia, J Exp Med 1995, "kappa+lambda+ dual
# receptor B cells are present in the human peripheral repertoire"); set
# to 5% of the clones so that a 1,500-cell library holds dozens of them.
IMMUNE_TWO_LIGHT = 0.05
IMMUNE_T_DROPS = 3          # two-alpha clones with a cell whose second
                            # alpha falls under MIN_UMIS_PER_CONTIG
IMMUNE_B_DROPS = 3          # two-light families with a cell whose IGL does
IMMUNE_BETA_ONLY = 2        # cells of one of those T clones that lose both
                            # alphas: {TRB} is then a subset of two chain
                            # sets of its clone, of unequal sizes (the
                            # "dominant superset" branch of the merge)
IMMUNE_LOW_UMIS = 1         # molecules of a transcript under the threshold
                            # (of a beta-only cell's first alpha; its second
                            # has none: two one-molecule alphas would share
                            # their C gene's reads and so reach 2 UMIs)
IMMUNE_R2_OVERHANG = 60     # R2 starts drawn on [-60, L - 60] and clipped
                            # to the transcript: its ends are covered
IMMUNE_SEED = 53


def _immune_t_plan(n_t: int, rng) -> list[dict]:
    """The T clones of a drawn library: sizes as _vdj_design_wide draws
    them (an expanded clone of VDJ_EXPANDED_SIZES cells per
    VDJ_EXPANDED_PER_CELL cells, the rest one cell each), IMMUNE_TWO_ALPHA
    of them with two alphas; the largest two-alpha clone a cell whose
    second alpha drops and IMMUNE_BETA_ONLY cells whose both do (where no
    two-alpha clone is that large, the largest clone takes two alphas),
    the next IMMUNE_T_DROPS - 1 two-alpha clones of 3 or more cells one
    cell whose second alpha drops.  A clone is dict(cells, alphas, drop,
    beta_only); its full cells come first."""
    lo, hi = VDJ_EXPANDED_SIZES
    expanded = max(1, n_t // VDJ_EXPANDED_PER_CELL)
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), expanded))
    sizes = np.minimum(sizes.astype(np.int64), max(lo, n_t // 5))
    if sizes.sum() > n_t:
        raise ValueError(f"{expanded} expanded clones need {sizes.sum()} "
                         f"of {n_t} T cells")
    sizes = list(sizes) + [1] * int(n_t - sizes.sum())
    two = rng.random(len(sizes)) < IMMUNE_TWO_ALPHA
    plan = [dict(cells=int(s), alphas=2 if x else 1, drop=0, beta_only=0)
            for s, x in zip(sizes, two)]
    big = sorted((k for k, c in enumerate(plan)
                  if c["alphas"] == 2 and c["cells"] >= 3),
                 key=lambda k: -plan[k]["cells"])
    need = 3 + IMMUNE_BETA_ONLY
    if not big or plan[big[0]]["cells"] < need:
        # too few clones to draw one: the largest clone takes two alphas
        k = int(np.argmax(sizes))
        if sizes[k] < need:
            raise ValueError(f"no clone of {need} T cells for the "
                             "dominant-superset case")
        plan[k]["alphas"] = 2
        big.insert(0, k)
    plan[big[0]].update(drop=1, beta_only=IMMUNE_BETA_ONLY)
    for k in big[1:IMMUNE_T_DROPS]:
        plan[k]["drop"] = 1
    return plan


def _immune_t_design(seg: dict, plan: list[dict], rng) -> dict:
    """The chains, transcripts, cells and planted annotations of a T
    library on the segments `seg` (_vdj_t_segments).  A clone takes a
    TRB and one or two TRA chains ("alphas"), each a random V and J and
    N additions whose CDR3 is at least VDJ_CDR3_MIN_DIST from every other
    of its (chain, V, J); a second alpha another V and J than the first.
    A cell's transcripts (UTR + V + additions + J + C) share no 19-mer
    but the two alphas' in their common C gene.  A cell is its clone's
    transcripts, each VDJ_UMIS_PER_CHAIN molecules ("mols"); of its last
    cells `drop` hold IMMUNE_LOW_UMIS of the second alpha and `beta_only`
    IMMUNE_LOW_UMIS of the first and none of the second ("low" marks a
    chain under MIN_UMIS_PER_CONTIG).  Each cell's kept chains are
    annotated as the pipeline
    would annotate their contigs (exact V and J hits, no variant), and
    group_clonotypes of those annotations must give the clones."""
    from ..vdj.annotate import (ContigAnnotation, SegmentHit,
                                group_clonotypes, translate)
    from ..vdj.assembly import K
    from ..vdj.reference import Segment

    def kmers(t):
        return {t[i:i + K - 1] for i in range(len(t) - K + 2)}

    c_kmers = kmers(seg["TRA"]["c"])
    segs = {(ch, r, i): Segment(f"{ch}{r}{i + 1}", f"{ch}{r}{i + 1}", r, ch,
                                x.encode())
            for ch, s in seg.items() for r in ("V", "J")
            for i, x in enumerate(s[r.lower()])}
    seen: dict = {}
    clones, tx, cells, anns = [], [], [], {}
    for ci, spec in enumerate(plan):
        chains, taken = [], set()
        for chain in ["TRA"] * spec["alphas"] + ["TRB"]:
            s = seg[chain]
            nv, nj = len(s["v"]), len(s["j"])
            first = chains[0] if chain == "TRA" and chains else None
            for _ in range(VDJ_B_ATTEMPTS):
                vi, ji = int(rng.integers(nv)), int(rng.integers(nj))
                if first is not None and (vi == first[1] or ji == first[2]):
                    continue
                ins = _vdj_insert(chain, rng)
                nt = "TGT" + ins + s["j"][ji][:3]
                t = s["utr"][vi] + s["v"][vi] + ins + s["j"][ji] + s["c"]
                km = [t[i:i + K - 1] for i in range(len(t) - K + 2)]
                shared = taken & set(km)
                if (len(set(km)) == len(km)
                        and (not shared or (first is not None
                                            and shared <= c_kmers))
                        and all(sum(a != b for a, b in zip(nt, o))
                                >= VDJ_CDR3_MIN_DIST
                                for o in seen.get((chain, vi, ji), ()))):
                    break
            else:
                raise ValueError(f"T clone {ci}: no {chain} drawn apart")
            seen.setdefault((chain, vi, ji), []).append(nt)
            taken.update(km)
            chains.append((chain, vi, ji, nt, len(tx)))
            tx.append(t)
        clone = dict(chains=chains, cells=[])
        n = spec["cells"]
        for i in range(n):
            mols = [VDJ_UMIS_PER_CHAIN] * len(chains)
            if spec["alphas"] == 2 and i >= n - spec["beta_only"]:
                mols[:2] = [IMMUNE_LOW_UMIS, 0]
            elif spec["alphas"] == 2 and \
                    i >= n - spec["beta_only"] - spec["drop"]:
                mols[1] = IMMUNE_LOW_UMIS
            low = [x < VDJ_UMIS_PER_CHAIN for x in mols]
            cell = []
            for (chain, vi, ji, nt, k), x in zip(chains, low):
                if x:
                    continue
                v, j = seg[chain]["v"][vi], seg[chain]["j"][ji]
                at = VDJ_UTR + len(v) + len(nt) - 6
                cell.append(ContigAnnotation(
                    contig_seq=tx[k], chain=chain,
                    v=SegmentHit(segs[(chain, "V", vi)], len(v), VDJ_UTR,
                                 VDJ_UTR + len(v), 0, len(v)),
                    j=SegmentHit(segs[(chain, "J", ji)], len(j), at,
                                 at + len(j), 0, len(j)),
                    cdr3_nt=nt, cdr3_aa=translate(nt), productive=True,
                    full_length=True))
            anns[str(len(cells))] = cell
            clone["cells"].append(len(cells))
            cells.append(dict(clone=ci, tx=[c[4] for c in chains], low=low,
                              mols=mols))
        clones.append(clone)
    got = sorted(sorted(c["barcodes"], key=int)
                 for c in group_clonotypes(anns))
    if got != sorted([str(i) for i in c["cells"]] for c in clones):
        raise ValueError("group_clonotypes of the planted T annotations "
                         "does not give the planned clones")
    return dict(clones=clones, tx=tx, cells=cells, anns=anns)


def _immune_b_plan(n_b: int, rng) -> list[dict]:
    """The B clones of a drawn library (_vdj_b_plan), IMMUNE_TWO_LIGHT of
    them with both an IGK and an IGL chain ("light2"), and the first
    IMMUNE_B_DROPS families without a CDR3 subclone two-light clones
    whose last cell's IGL drops ("drop")."""
    plan = _vdj_b_plan(n_b, rng, None)
    two = rng.random(len(plan)) < IMMUNE_TWO_LIGHT
    for spec, x in zip(plan, two):
        if x:
            spec["light2"] = True
    fams = [s for s in plan if len(s["kinds"]) >= 2
            and not s.get("sub")][:IMMUNE_B_DROPS]
    if not fams:
        raise ValueError("no B family for a two-light dropout")
    for spec in fams:
        spec.update(light2=True, drop=1)
    return plan


def _immune_pairs(rng, cell_tx: list, n_mol: list, pairs: np.ndarray):
    """Read pairs of a library's cells, shuffled: cell i holds n_mol[i][k]
    molecules of its transcript cell_tx[i][k], every molecule at least
    one pair, pairs[i] pairs in all.  Returns (cell [P], UMI codes
    [P, 10], transcript [P])."""
    n_mol = [np.asarray(m) for m in n_mol]
    per_cell = np.array([int(m.sum()) for m in n_mol])
    if (pairs < per_cell).any():
        raise ValueError(f"{pairs.min()} pairs cannot cover a cell's "
                         "molecules")
    first = np.r_[0, np.cumsum(per_cell)[:-1]]
    mol_cell = np.repeat(np.arange(len(per_cell)), per_cell)
    mol_tx = np.concatenate([np.repeat(t, m) for t, m in zip(cell_tx, n_mol)])
    mol_umi = _coded_umis(mol_cell, VDJ_UMI_LEN, rng)
    extra_cell = np.repeat(np.arange(len(per_cell)), pairs - per_cell)
    mol = np.concatenate([np.arange(len(mol_cell)), first[extra_cell] + (
        rng.random(len(extra_cell)) * per_cell[extra_cell]).astype(np.int64)])
    mol = mol[rng.permutation(len(mol))]
    return mol_cell[mol], mol_umi[mol], mol_tx[mol]


def _r2_starts(rng, tx_len: np.ndarray, t: np.ndarray) -> np.ndarray:
    """A read start on each pair's transcript: uniform on [-overhang,
    L - 120 + overhang], clipped to [0, L - 120]."""
    span = tx_len[t] - VDJ_READ_LEN + 1 + 2 * IMMUNE_R2_OVERHANG
    return np.clip((rng.random(len(t)) * span).astype(np.int64)
                   - IMMUNE_R2_OVERHANG, 0, tx_len[t] - VDJ_READ_LEN)


def _write_vdj_r2_fastqs(tmp: str, name: str, rng, wl: np.ndarray,
                         bc: np.ndarray, umi: np.ndarray, codes: np.ndarray,
                         t: np.ndarray, start: np.ndarray):
    """A V(D)J library in the SCVDJ-R2 layout that `multi` reads: R1 =
    barcode + 10-base UMI, R2 = 120 bases of the transcript from `start`,
    on its strand, binned qualities with N at Q2; one barcode in 50 with
    a correctable error.  Written VDJ_WRITE_BLOCK pairs at a time.
    Returns the R1 and R2 paths."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    P = len(t)
    _human_barcode_errors(bc, np.arange(0, P, 50), wl, rng)
    ar = np.arange(VDJ_READ_LEN, dtype=np.int64)
    r1p = os.path.join(tmp, f"{name}_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, f"{name}_S1_L001_R2_001.fastq")
    with open(r1p, "wb") as f1, open(r2p, "wb") as f2:
        for s in range(0, P, VDJ_WRITE_BLOCK):
            e = min(P, s + VDJ_WRITE_BLOCK)
            read = bases[codes[t[s:e, None], start[s:e, None] + ar]]
            q = _binned_quals(rng, read.shape)
            read[q == ord("#")] = ord("N")
            f1.write(_fastq_block(np.concatenate(
                [_unpack_barcodes(bc[s:e]), bases[umi[s:e]]], 1)))
            f2.write(_fastq_block(read, q))
    return r1p, r2p


def _immune_library(tmp: str, name: str, rng, wl: np.ndarray,
                    cell_wl: np.ndarray, bg_wl: np.ndarray, tx: list,
                    cell_tx: list, n_mol: list, pairs: np.ndarray,
                    bg_tx: np.ndarray) -> dict:
    """One V(D)J library of a well: its cells' pairs (_immune_pairs), the
    background barcodes' (one molecule each of a transcript drawn from
    bg_tx, VDJ_BACKGROUND_SHARE of all pairs split evenly over them),
    shuffled, written as SCVDJ-R2 FASTQs under tmp/name.  Returns the
    directory, pairs, background pairs."""
    codes = _vdj_tx_codes(dict(tx=tx))
    tx_len = np.array([len(x) for x in tx])
    cell, umi, t = _immune_pairs(rng, cell_tx, n_mol, pairs)
    bc = wl[cell_wl[cell]]
    n_bg = 0
    if len(bg_wl):
        n_bg = int(round(len(cell) * VDJ_BACKGROUND_SHARE
                         / (1 - VDJ_BACKGROUND_SHARE)))
        n = len(bg_wl)
        if n_bg < n:
            raise ValueError(f"{n_bg} background pairs for {n} barcodes")
        bt = bg_tx[rng.integers(0, len(bg_tx), n)]
        bumi = _coded_umis(np.arange(n), VDJ_UMI_LEN, rng)
        per = np.full(n, n_bg // n)
        per[:n_bg % n] += 1
        bgi = np.repeat(np.arange(n), per)
        order = rng.permutation(len(cell) + n_bg)
        bc = np.concatenate([bc, wl[bg_wl[bgi]]])[order]
        umi = np.concatenate([umi, bumi[bgi]])[order]
        t = np.concatenate([t, bt[bgi]])[order]
    start = _r2_starts(rng, tx_len, t)
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    _write_vdj_r2_fastqs(d, name, rng, wl, bc, umi, codes, t, start)
    return dict(dir=d, n_reads=len(t), background_pairs=n_bg)


def _immune_gex(tmp: str, rng, garr: np.ndarray, spacing: int,
                n_genes: int, wl: np.ndarray, cell_packed: np.ndarray,
                n_pairs: int, discordant_frac: float = 0.1) -> dict:
    """The well's 5' GEX library in build_pe_run's SC5P-PE layout on the
    genome `garr`: n_pairs pairs = molecules of the cells emitted
    E2E_DUP times each, a cell drawn for each molecule, mate 1 in exon 1
    of a '+' gene, mate 2 100-300 bases on (PE_DISCORDANT_GAP further in
    a discordant_frac share: improper); the first copy of every 25th
    molecule with a correctable barcode error.  Written a block of
    VDJ_WRITE_BLOCK pairs at a time under tmp/gex.  Returns the
    directory and the expected counts."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    n_mol = n_pairs // E2E_DUP
    cell_idx = rng.integers(0, len(cell_packed), n_mol)
    umi = _coded_umis(cell_idx, PE_UMI_LEN, rng)
    gene = rng.integers(0, n_genes // 2, n_mol) * 2      # '+' strand only
    p1 = gene * spacing + 1000 + rng.integers(0, 200, n_mol)
    discordant = rng.random(n_mol) < discordant_frac
    p2 = (p1 + rng.integers(100, 300, n_mol)
          + np.where(discordant, PE_DISCORDANT_GAP, 0))
    order = rng.permutation(n_mol * E2E_DUP)
    mol = order // E2E_DUP
    bc = cell_packed[cell_idx[mol]]
    _human_barcode_errors(
        bc, np.flatnonzero((order % E2E_DUP == 0) & (mol % 25 == 0)), wl,
        rng)
    ar = np.arange(READ_LEN)
    d = os.path.join(tmp, "gex")
    os.makedirs(d, exist_ok=True)
    r1p = os.path.join(d, "gex_S1_L001_R1_001.fastq")
    r2p = os.path.join(d, "gex_S1_L001_R2_001.fastq")
    with open(r1p, "wb") as f1, open(r2p, "wb") as f2:
        for s in range(0, len(mol), VDJ_WRITE_BLOCK):
            m = mol[s:s + VDJ_WRITE_BLOCK]
            f1.write(_fastq_block(np.concatenate(
                [_unpack_barcodes(bc[s:s + VDJ_WRITE_BLOCK]), bases[umi[m]],
                 garr[p1[m, None] + ar]], 1)))
            f2.write(_fastq_block(comp[garr[p2[m, None] + ar[::-1]]]))
    n_disc = int(discordant.sum())
    return dict(dir=d, n_reads=n_mol * E2E_DUP, expected=dict(
        total_reads=n_mol * E2E_DUP,
        conf_mapped_reads=(n_mol - n_disc) * E2E_DUP,
        improper_pair_reads=n_disc * E2E_DUP,
        total_molecules=n_mol - n_disc))


def _vdj_lib_truth(bcs: list, cells: list, clones: list, chains_of,
                   anns: dict) -> dict:
    """A V(D)J library's truth: "expected" (cells, clonotypes, each cell's
    kept CDR3s) and "truth" (V and J genes per kept chain, the clonotypes
    as a partition of the cell barcodes, the planted annotations by
    barcode) and "merged": per clone holding a cell with a dropped chain,
    its barcodes, the cells with a dropped chain and whether one of their
    chain sets is a subset of two of the clone's."""
    cdr3s, genes, merged = {}, {}, []
    for i, c in enumerate(cells):
        kept = [w for w, x in zip(chains_of(c), c["low"]) if not x]
        cdr3s[bcs[i]] = sorted([w[0], w[3]] for w in kept)
        genes[bcs[i]] = sorted([w[0], w[1], w[2]] for w in kept)
    for cl in clones:
        low = [i for i in cl["cells"] if any(cells[i]["low"])]
        if low:
            sets = {tuple(cells[i]["low"]) for i in cl["cells"]}
            merged.append(dict(
                clone=sorted(bcs[i] for i in cl["cells"]),
                joined=sorted(bcs[i] for i in low),
                dominant=len(sets) >= 3))
    return dict(
        expected=dict(estimated_cells=len(cells), n_clonotypes=len(clones),
                      cdr3s=cdr3s),
        truth=dict(genes=genes, clonotypes=sorted(
            sorted(bcs[i] for i in cl["cells"]) for cl in clones),
            merged=merged),
        anns={bcs[int(k)]: v for k, v in anns.items()})


def build_immune_run(tmp: str, n_cells: int = IMMUNE_CELLS,
                     gex_pairs: int = IMMUNE_GEX_PAIRS,
                     vdj_pairs: int = IMMUNE_VDJ_PAIRS, *,
                     kinds: tuple | None = None, t_plan=None, b_plan=None,
                     background: int = VDJ_BACKGROUND_PER_CELL,
                     genome_len: int = E2E_GENOME_LEN,
                     n_genes: int = E2E_GENES) -> dict:
    """A 5' immune profiling well for `multi` whose outcome holds by
    construction: one drawn whitelist of VDJ_WL_5P barcodes (10x's
    737,280 of the 5' kits) and n_cells cells, IMMUNE_SHARES' T, B and
    other cells
    (`kinds`: their counts instead), three libraries and a multi config:

    - GEX (SC5P-PE, build_pe_run's layout) on the e2e genome and genes:
      every cell, gex_pairs read pairs a cell in all;
    - VDJ-T (_immune_t_design on IMGT's TRA/TRB gene counts) of the T
      cells at vdj_pairs pairs a cell, IMMUNE_TWO_ALPHA of the clones with
      two productive alphas, dropouts planted (`t_plan`: the clones
      instead, see _immune_t_plan);
    - VDJ-B (_vdj_b_design: IGH/IGK/IGL, isotypes, SHM, plasma cells at
      VDJ_B_PLASMA_FOLD times the molecules and pairs, families with
      subclones and switches) of the B cells, IMMUNE_TWO_LIGHT of the
      clones with both
      an IGK and an IGL chain, dropouts planted (`b_plan` instead);
    - each V(D)J library `background` non-cell barcodes a cell holding
      VDJ_BACKGROUND_SHARE of its pairs, one molecule each (a T cell's
      transcript in VDJ-T, a plasma cell's in VDJ-B, a B cell's where
      there is no plasma cell): first the well's
      other cells (B and other cells in VDJ-T), then barcodes of no cell;
    - one vdj_reference/fasta/regions.fa holding the TR genes and then the
      IG genes (D and C regions included), and multi.csv with
      [gene-expression] reference and chemistry SC5P-PE, [vdj] reference
      and [libraries] gex, vdj_t (VDJ-T) and vdj_b (VDJ-B).

    `multi` runs V(D)J libraries as SCVDJ-R2 and takes R2 as it is, so the
    V(D)J libraries hold R1 = barcode + UMI and R2 = 120 bases on the
    transcript's strand (_write_vdj_r2_fastqs).  Returns the paths, the
    GEX "expected" counts and cells, and per V(D)J library
    (_vdj_lib_truth) its expected cells, clonotypes and CDR3s, its truth
    (genes, C genes for B, the clonotype partition with every dropout in
    its clone, the merges) and planted annotations by barcode."""
    from ..io.gtf import write_fasta

    os.makedirs(tmp, exist_ok=True)
    if kinds is None:
        n_t = int(round(IMMUNE_SHARES["T"] * n_cells))
        n_b = int(round(IMMUNE_SHARES["B"] * n_cells))
        kinds = (n_t, n_b, n_cells - n_t - n_b)
    n_t, n_b, n_other = kinds
    n_cells = n_t + n_b + n_other
    rng = np.random.default_rng(IMMUNE_SEED)
    wl = _human_whitelist(rng, VDJ_WL_5P)
    seg_t = _vdj_t_segments(VDJ_IMGT_GENES, rng)
    t_recs = _vdj_t_records(seg_t)
    dt = _immune_t_design(seg_t, _immune_t_plan(n_t, rng) if t_plan is None
                          else t_plan, rng)
    db = _vdj_b_design(n_b, 0, 0, plan=_immune_b_plan(n_b, rng)
                       if b_plan is None else b_plan, ahead=t_recs,
                       barcodes=False)
    bg_t, bg_b = background * n_t, background * n_b
    fresh_t = max(0, bg_t - n_b - n_other)
    fresh_b = max(0, bg_b - n_t - n_other)
    picks = rng.choice(VDJ_WL_5P, n_cells + fresh_t + fresh_b,
                       replace=False)
    well = picks[:n_cells]
    t_wl, b_wl, o_wl = np.split(well, [n_t, n_t + n_b])
    not_t = rng.permutation(np.concatenate([b_wl, o_wl]))[:bg_t]
    not_b = rng.permutation(np.concatenate([t_wl, o_wl]))[:bg_b]
    t_bg = np.sort(np.concatenate([not_t, picks[n_cells:n_cells + fresh_t]]))
    b_bg = np.sort(np.concatenate([not_b, picks[n_cells + fresh_t:]]))
    bcs = lambda idx: [b.tobytes().decode() + "-1" for b in  # noqa: E731
                       _unpack_barcodes(wl[idx])]

    garr, spacing, _, ref_dir, _ = _e2e_reference(
        tmp, np.random.default_rng(11), genome_len, n_genes, None)
    gex = _immune_gex(tmp, rng, garr, spacing, n_genes, wl, wl[np.sort(well)],
                      n_cells * gex_pairs)
    gex["cells"] = sorted(bcs(well))

    m = VDJ_UMIS_PER_CHAIN
    lib_t = _immune_library(
        tmp, "vdj_t", rng, wl, t_wl, t_bg, dt["tx"],
        [c["tx"] for c in dt["cells"]], [c["mols"] for c in dt["cells"]],
        np.full(n_t, vdj_pairs), np.arange(len(dt["tx"])))
    plasma = np.array([c["kind"] == "plasma" for c in db["cells"]])
    fold = np.where(plasma, VDJ_B_PLASMA_FOLD, 1)
    first = np.r_[0, np.cumsum([len(c["tx"]) for c in db["cells"]])]
    b_tx = [list(range(first[i], first[i + 1]))
            for i in range(len(db["cells"]))]
    lib_b = _immune_library(
        tmp, "vdj_b", rng, wl, b_wl, b_bg, db["tx"], b_tx,
        [np.where(c["low"], IMMUNE_LOW_UMIS, m * f)
         for c, f in zip(db["cells"], fold)],
        np.where(plasma, VDJ_B_PLASMA_FOLD * vdj_pairs, vdj_pairs),
        np.concatenate([b_tx[i] for i in (np.flatnonzero(plasma)
                                          if plasma.any() else
                                          range(len(b_tx)))]))

    chains_t = lambda c: [(ch, f"{ch}V{vi + 1}", f"{ch}J{ji + 1}", nt)  # noqa
                          for ch, vi, ji, nt, _ in
                          dt["clones"][c["clone"]]["chains"]]
    t_bcs = bcs(t_wl)
    truth_t = _vdj_lib_truth(t_bcs, dt["cells"], dt["clones"], chains_t,
                             dt["anns"])
    chains_b = lambda c: [(w["chain"], w["v"], w["j"], w["nt"])  # noqa
                          for w in c["want"]]
    b_bcs = bcs(b_wl)
    truth_b = _vdj_lib_truth(b_bcs, db["cells"], db["clones"], chains_b,
                             db["anns"])
    truth_b["truth"]["c_genes"] = {
        b_bcs[i]: sorted([w["chain"], w["c"]] for w, x in
                         zip(c["want"], c["low"]) if not x)
        for i, c in enumerate(db["cells"])}
    truth_b["truth"]["kinds"] = {b_bcs[i]: c["kind"]
                                 for i, c in enumerate(db["cells"])}
    for lib, tr, bg in ((lib_t, truth_t, t_bg), (lib_b, truth_b, b_bg)):
        lib.update(tr)
        lib["expected"]["total_reads"] = lib["n_reads"]
        lib["truth"].update(background=bcs(bg),
                            background_pairs=lib["background_pairs"])
    lib_t["truth"]["two_alpha"] = sorted(
        b for b, v in lib_t["expected"]["cdr3s"].items()
        if [ch for ch, _ in v].count("TRA") == 2)
    lib_b["truth"]["two_light"] = sorted(
        b for b, v in lib_b["expected"]["cdr3s"].items()
        if {ch for ch, _ in v} >= {"IGK", "IGL"})

    vdj_ref = os.path.join(tmp, "vdj_reference")
    os.makedirs(os.path.join(vdj_ref, "fasta"), exist_ok=True)
    write_fasta(os.path.join(vdj_ref, "fasta", "regions.fa"),
                {h: x.encode() for h, x in db["ref_recs"].items()})
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)
    csv = os.path.join(tmp, "multi.csv")
    with open(csv, "w") as f:
        f.write(f"[gene-expression]\nreference,{ref_dir}\n"
                "chemistry,SC5P-PE\n\n"
                f"[vdj]\nreference,{vdj_ref}\n\n"
                "[libraries]\nfastq_id,fastqs,feature_types\n"
                f"gex,{gex['dir']},Gene Expression\n"
                f"vdj_t,{lib_t['dir']},VDJ-T\n"
                f"vdj_b,{lib_b['dir']},VDJ-B\n")
    return dict(csv=csv, wl=wl_path, ref=ref_dir, vdj_reference=vdj_ref,
                kinds=dict(T=n_t, B=n_b, other=n_other), gex=gex,
                vdj_t=lib_t, vdj_b=lib_b,
                n_reads=gex["n_reads"] + lib_t["n_reads"] + lib_b["n_reads"])


# ---------------------------------------------------------------------------
# BCL run fixtures (mkfastq)
# ---------------------------------------------------------------------------

BCL_R1, BCL_I1, BCL_R2 = 28, 8, 50
BCL_IDX_A = "ACGTACGT"
BCL_IDX_A_1MM = "CCGTACGT"          # one mismatch from A: still routes to A
BCL_IDX_B = ("TTTTCCCC", "GGGGAAAA")  # the index set SI-TT-B1
BCL_QUAL = 37                       # classic q37 == CBCL bin 3
BCL_RUN_INFO = (
    '<?xml version="1.0"?><RunInfo><Run Id="240101_M0_0001_FLOW1">'
    '<Flowcell>FLOW1</Flowcell>'
    '<Reads>'
    f'<Read Number="1" NumCycles="{BCL_R1}" IsIndexedRead="N"/>'
    f'<Read Number="2" NumCycles="{BCL_I1}" IsIndexedRead="Y"/>'
    f'<Read Number="3" NumCycles="{BCL_R2}" IsIndexedRead="N"/>'
    '</Reads>'
    '<FlowcellLayout LaneCount="1"/>'
    '</Run></RunInfo>')


def _write_locs(run: str, tile: int, n: int) -> None:
    locd = os.path.join(run, "Data", "Intensities", "L001")
    os.makedirs(locd, exist_ok=True)
    xy = np.zeros((n, 2), "<f4")
    xy[:, 0] = np.arange(n)
    xy[:, 1] = tile
    with open(os.path.join(locd, f"s_1_{tile}.locs"), "wb") as f:
        f.write(struct.pack("<IfI", 1, 1.0, n) + xy.tobytes())


def write_classic_bcl_run(run: str, tiles: dict, quals: int = BCL_QUAL
                          ) -> str:
    """Classic (HiSeq/MiSeq) run directory of lane 1, as make_run of
    tests/test_mkfastq.py writes it: RunInfo.xml, one gzipped BCL per
    cycle and tile (u32 count, then per cluster base | qual << 2, 0 for
    N), a .filter and a .locs per tile.  tiles: {tile: (codes uint8
    [N, cycles] 0-3 or 4 = N, pass_filter bool [N])}."""
    bc = os.path.join(run, "Data", "Intensities", "BaseCalls", "L001")
    os.makedirs(bc, exist_ok=True)
    with open(os.path.join(run, "RunInfo.xml"), "w") as f:
        f.write(BCL_RUN_INFO)
    for tile, (codes, pf) in tiles.items():
        n = len(codes)
        b = np.where(codes == 4, 0, (codes & 3) | (quals << 2)).astype(np.uint8)
        for c in range(codes.shape[1]):
            cdir = os.path.join(bc, f"C{c + 1}.1")
            os.makedirs(cdir, exist_ok=True)
            with gzip.open(os.path.join(cdir, f"s_1_{tile}.bcl.gz"),
                           "wb", compresslevel=1) as f:
                f.write(struct.pack("<I", n) + b[:, c].tobytes())
        with open(os.path.join(bc, f"s_1_{tile}.filter"), "wb") as f:
            f.write(struct.pack("<III", 0, 3, n)
                    + np.asarray(pf, np.uint8).tobytes())
        _write_locs(run, tile, n)
    return run


def write_cbcl_bcl_run(run: str, tiles: dict) -> str:
    """The same clusters in the NovaSeq CBCL layout (io/bcl.py
    `write_cbcl_run`, quality bin 3 = q37), with the classic run's .locs,
    so that both layouts name every read alike."""
    from ..io.bcl import write_cbcl_run
    os.makedirs(run, exist_ok=True)
    write_cbcl_run(run, BCL_RUN_INFO, 1, {
        t: (codes, np.full_like(codes, 3), np.asarray(pf, bool))
        for t, (codes, pf) in tiles.items()})
    for tile, (codes, _) in tiles.items():
        _write_locs(run, tile, len(codes))
    return run


def build_bcl_run(tmp: str, n_clusters: int = 120, seed: int = 5) -> dict:
    """One lane of clusters in both BCL layouts, with a sample sheet that
    routes them: cluster i carries index A (i % 4 == 0), A with one
    mismatch (1), one of the two oligos of set SI-TT-B1 (2), or a random
    index at least two mismatches from every oligo (3, Undetermined);
    every tenth cluster fails the chastity filter; even clusters lie on
    tile 1101, odd ones on 2101 (two CBCL surfaces).  The plan of
    tests/test_mkfastq.py's `bcl_run`, drawn in bulk.

    Returns the classic and CBCL run directories, the sample sheet and
    index kit CSVs, and the passing-filter reads per sample (`truth`)."""
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(seed)
    lut = np.zeros(256, np.uint8)
    lut[list(b"ACGT")] = [0, 1, 2, 3]
    enc = lambda s: lut[np.frombuffer(s.encode(), np.uint8)]  # noqa: E731
    cycles = BCL_R1 + BCL_I1 + BCL_R2
    codes = rng.integers(0, 4, (n_clusters, cycles)).astype(np.uint8)
    i = np.arange(n_clusters)
    pick = i % 4
    idx = codes[:, BCL_R1:BCL_R1 + BCL_I1]
    idx[pick == 0] = enc(BCL_IDX_A)
    idx[pick == 1] = enc(BCL_IDX_A_1MM)
    idx[(pick == 2) & (i % 8 == 2)] = enc(BCL_IDX_B[0])
    idx[(pick == 2) & (i % 8 != 2)] = enc(BCL_IDX_B[1])
    oligos = np.stack([enc(o) for o in (BCL_IDX_A,) + BCL_IDX_B])
    near = ((idx[:, None, :] != oligos[None]).sum(2) <= 1).any(1)
    keep = (pick != 3) | ~near          # drop random indexes that match
    codes, i, pick = codes[keep], i[keep], pick[keep]
    pf = i % 10 != 9
    sample = np.array(["A", "A", "B", "Undetermined"])[pick]
    truth = {s: int(((sample == s) & pf).sum())
             for s in ("A", "B", "Undetermined")}
    tiles = {1101: (codes[i % 2 == 0], pf[i % 2 == 0]),
             2101: (codes[i % 2 == 1], pf[i % 2 == 1])}
    kit = os.path.join(tmp, "kit.csv")
    with open(kit, "w") as f:
        f.write(f"SI-TT-B1,{BCL_IDX_B[0]},{BCL_IDX_B[1]}\n")
    sheet = os.path.join(tmp, "samplesheet.csv")
    with open(sheet, "w") as f:
        f.write(f"Lane,Sample,Index\n1,A,{BCL_IDX_A}\n1,B,SI-TT-B1\n")
    return dict(classic=write_classic_bcl_run(os.path.join(tmp, "classic"),
                                              tiles),
                cbcl=write_cbcl_bcl_run(os.path.join(tmp, "cbcl"), tiles),
                samplesheet=sheet, index_kit=kit, truth=truth,
                n_clusters=len(codes))


# ---------------------------------------------------------------------------
# Multi-device and multi-host runs (the JAX package's __graft_entry__.py and
# tests/test_multihost.py fixtures, draw for draw, built by the port)
# ---------------------------------------------------------------------------

def synthetic_step_setup(read_len: int = READ_LEN, n_wl: int = 512,
                         genome_len: int = 30_000, seed: int = 7):
    """A two-gene 30 kb reference and a 512-barcode whitelist (the JAX
    package's `__graft_entry__._synthetic_setup`).  Returns (make_step,
    wl, genome, rng): make_step(device) is the stream step against that
    reference on `device`."""
    from ..align.aligner import DeviceIndex
    from ..align.annotate import AnnotationIndex
    from ..align.index import GenomeIndex
    from ..io.chemistry import get_chemistry
    from ..io.gtf import Gene, Transcript, Transcriptome
    from ..io.whitelist import Whitelist
    from ..pipeline.count import make_stream_step

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = bases[rng.integers(0, 4, genome_len)].tobytes()
    txome = Transcriptome(
        genes=[Gene("G1", "G1", "chr1", "+", 0),
               Gene("G2", "G2", "chr1", "-", 1)],
        transcripts=[
            Transcript("T1", 0, "chr1", "+", [(1000, 1900), (2500, 3400)]),
            Transcript("T2", 1, "chr1", "-", [(8000, 9500)]),
        ])
    gi = GenomeIndex.build({"chr1": genome}, txome)
    wl_seqs = sorted({"".join(rng.choice(list("ACGT"), 16))
                      for _ in range(n_wl + 64)})
    wl = Whitelist.from_seqs(wl_seqs[:n_wl])
    chem = get_chemistry("SC3Pv3")

    def make_step(device):
        return make_stream_step(DeviceIndex.from_host(gi, device),
                                AnnotationIndex.build(txome, gi, device),
                                chem, read_len)

    return make_step, wl, genome, rng


def synthetic_batch(wl, genome: bytes, rng, B: int,
                    read_len: int = READ_LEN):
    """B reads from the genome with two base errors each, barcodes from
    the whitelist's first 64 (the JAX package's
    `__graft_entry__._synthetic_batch`).  Returns (packed uint32 step
    plane, host views dict(bc_packed, bc_idx, umi))."""
    from types import SimpleNamespace

    from ..io.chemistry import get_chemistry
    from ..ops import encode
    from ..pipeline.count import pack_step_input

    wl_strs = [encode.unpack_str(int(s), 16) for s in wl.sorted_seqs[:64]]
    bcs = [wl_strs[int(rng.integers(len(wl_strs)))] for _ in range(B)]
    bc_codes = np.stack([encode.encode_str(b)[0] for b in bcs])
    bc_packed = encode.pack_codes_np(bc_codes, 16)
    umi = rng.integers(0, 1 << 24, B).astype(np.uint32)
    pos = rng.integers(0, len(genome) - read_len, B)
    rna = np.zeros((B, read_len), np.uint8)
    for i, p in enumerate(pos):
        rna[i] = encode.encode_str(genome[p:p + read_len])[0]
    err = rng.integers(0, read_len, (B, 2))
    for i in range(B):
        rna[i, err[i]] ^= 1
    bc_idx = wl.index_of(bc_packed).astype(np.int32)
    shim = SimpleNamespace(
        batch_size=B, umi_packed=umi, slot_valid=np.ones(B, bool),
        umi_valid=np.ones(B, bool), rna=rna,
        rna_nmask=np.ones((B, read_len), bool), rna2=None, rna2_nmask=None)
    plane = pack_step_input(get_chemistry("SC3Pv3"), read_len, shim, bc_idx)
    return plane, dict(bc_packed=bc_packed, bc_idx=bc_idx, umi=umi)


def build_tiny_mesh_run(tmp: str, read_len: int = READ_LEN) -> dict:
    """240 reads of 8 barcodes over two genes (one per strand) on a 12 kb
    reference (the JAX package's `__graft_entry__._tiny_run_fixture`).
    Returns dict(ref, wl, fq1, fq2, n_reads)."""
    from ..io.gtf import write_fasta
    from ..io.reference import ReferencePackage

    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(13)
    bases = "ACGT"
    genome = "".join(rng.choice(list(bases), 12_000))
    write_fasta(os.path.join(tmp, "genome.fa"), {"chr1": genome.encode()})
    with open(os.path.join(tmp, "genes.gtf"), "w") as f:
        f.write('chr1\tt\texon\t1001\t2400\t.\t+\t.\t'
                'gene_id "GA"; transcript_id "TA"; gene_name "GA";\n')
        f.write('chr1\tt\texon\t5001\t6400\t.\t-\t.\t'
                'gene_id "GB"; transcript_id "TB"; gene_name "GB";\n')
    ReferencePackage.build(os.path.join(tmp, "genome.fa"),
                           os.path.join(tmp, "genes.gtf"),
                           os.path.join(tmp, "ref"), device=None)
    wl = sorted({"".join(rng.choice(list(bases), 16)) for _ in range(64)})
    with open(os.path.join(tmp, "wl.txt"), "w") as f:
        f.writelines(s + "\n" for s in wl)
    comp = str.maketrans(bases, "TGCA")
    r1p = os.path.join(tmp, "t_S1_L001_R1_001.fastq.gz")
    r2p = os.path.join(tmp, "t_S1_L001_R2_001.fastq.gz")
    n_reads = 240
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for i in range(n_reads):
            bc = wl[i % 8]
            umi = "".join(rng.choice(list(bases), 12))
            if i % 2 == 0:
                p = int(rng.integers(1000, 2400 - read_len))
                cdna = genome[p:p + read_len]
            else:
                p = int(rng.integers(5000, 6400 - read_len))
                cdna = genome[p:p + read_len].translate(comp)[::-1]
            f1.write(f"@r{i}\n{bc}{umi}\n+\n{'F' * 28}\n")
            f2.write(f"@r{i}\n{cdna}\n+\n{'F' * read_len}\n")
    return dict(ref=os.path.join(tmp, "ref"), wl=os.path.join(tmp, "wl.txt"),
                fq1=r1p, fq2=r2p, n_reads=n_reads)


def build_lane_run(tmp: str, reads_per_lane=400, n_lanes: int = 4,
                   read_len: int = READ_LEN) -> dict:
    """Lanes of reads over two genes of a 30 kb reference, 16 barcodes
    (the JAX package's `tests/test_multihost.py` `_build_run`).
    reads_per_lane: one count for every lane, or a list of counts (one
    lane each).  Returns dict(pairs [(r1, r2) per lane], ref, wl,
    n_reads)."""
    from ..io.gtf import write_fasta
    from ..io.reference import ReferencePackage

    lane_reads = (reads_per_lane if isinstance(reads_per_lane, list)
                  else [reads_per_lane] * n_lanes)
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(55)
    genome = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000))
    write_fasta(os.path.join(tmp, "g.fa"), {"chr1": genome})
    with open(os.path.join(tmp, "g.gtf"), "w") as f:
        f.write('chr1\tt\texon\t2001\t12000\t.\t+\t.\t'
                'gene_id "GM"; transcript_id "TM"; gene_name "GeneM";\n')
        f.write('chr1\tt\texon\t15001\t25000\t.\t+\t.\t'
                'gene_id "GN"; transcript_id "TN"; gene_name "GeneN";\n')
    ReferencePackage.build(os.path.join(tmp, "g.fa"),
                           os.path.join(tmp, "g.gtf"),
                           os.path.join(tmp, "ref"), device=None)
    wl = sorted({"".join(rng.choice(list("ACGT"), 16)) for _ in range(64)})
    with open(os.path.join(tmp, "wl.txt"), "w") as f:
        f.writelines(s + "\n" for s in wl)
    pairs = []
    n = 0
    for lane, n_lane in enumerate(lane_reads):
        r1p = os.path.join(tmp, f"mh_S1_L00{lane + 1}_R1_001.fastq.gz")
        r2p = os.path.join(tmp, f"mh_S1_L00{lane + 1}_R2_001.fastq.gz")
        with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
            for _ in range(n_lane):
                umi = "".join(rng.choice(list("ACGT"), 12))
                p = int(rng.integers(2000, 24000 - read_len))
                cdna = genome[p:p + read_len].decode()
                f1.write(f"@m{n}\n{wl[n % 16]}{umi}\n+\n{'F' * 28}\n")
                f2.write(f"@m{n}\n{cdna}\n+\n{'F' * read_len}\n")
                n += 1
        pairs.append((r1p, r2p))
    return dict(pairs=pairs, ref=os.path.join(tmp, "ref"),
                wl=os.path.join(tmp, "wl.txt"), n_reads=n)


def split_lanes(fx: dict, n_lanes: int, out_dir: str) -> dict:
    """The fixture `fx` (fq1/fq2, plain or gzipped) with its reads cut
    into n_lanes consecutive lanes of (nearly) equal size, written as
    plain FASTQ pairs.  Returns dict(fx, pairs=[(r1, r2) per lane])."""
    os.makedirs(out_dir, exist_ok=True)
    reads = {}
    for k in ("fq1", "fq2"):
        opener = gzip.open if fx[k].endswith(".gz") else open
        with opener(fx[k], "rb") as f:
            reads[k] = f.readlines()
    n = len(reads["fq1"]) // 4
    cuts = [n * i // n_lanes for i in range(n_lanes + 1)]
    pairs = []
    for lane in range(n_lanes):
        pair = []
        for k, r in (("fq1", "R1"), ("fq2", "R2")):
            path = os.path.join(out_dir,
                                f"lanes_S1_L{lane + 1:03d}_{r}_001.fastq")
            with open(path, "wb") as f:
                f.writelines(reads[k][4 * cuts[lane]:4 * cuts[lane + 1]])
            pair.append(path)
        pairs.append(tuple(pair))
    return dict(fx, pairs=pairs)


# ---------------------------------------------------------------------------
# Human-scale run: a text above 2**31 bases, so the index samples
# minimizers and packs positions by parity
# ---------------------------------------------------------------------------

HUMAN_PAD = 2_000_000_000       # all-N contig ahead of chr1
HUMAN_CHR1_LEN = 280_000_000    # bench.py HUMAN_GENOME_LEN
HUMAN_REPEAT_LEN = 5_000_000    # chr1 opens with 4 copies of one segment
HUMAN_REPEAT_COPIES = 4
HUMAN_GENES = 36_601            # the genes of 10x Genomics' GRCh38-2020-A
HUMAN_WL = 6_794_880            # the barcodes of 10x's 3M-february-2018.txt
HUMAN_CELLS = 10_000
HUMAN_UMI_LEN = 12
# molecule kinds and their shares: exon 1 of a '+' gene off the repeat,
# across a gene's exon 1 -> exon 2 junction, exon 1 of a '+' gene with a
# 2-base deletion, a repeat position intergenic at every copy
HUMAN_KINDS = ("exon", "junction", "deletion", "repeat")
HUMAN_SHARES = (0.70, 0.10, 0.05, 0.15)
# build_grch38_run(repeats=True) adds two kinds (testing/repeats.py): a
# read inside the repeat copy planted in a '+' gene's exon 2, and a read
# of exon 1 of a '+' gene with a paralog (multi-gene, so not counted,
# where its bases equal those of a twin in another gene)
REPEAT_KINDS = HUMAN_KINDS + ("exon_repeat", "paralog")
REPEAT_SHARES = (0.55, 0.09, 0.05, 0.11, 0.12, 0.08)
HUMAN_DELETION = 2
HUMAN_JUNCTION_MIN_SIDE = 20    # bases of a junction read on either exon
HUMAN_DELETION_AT = (25, 36)    # read offsets of the deletion
PAD_PREFIX = 256   # N bases an index is built over in place of a long pad


def padded_index(seqs: dict, txome, pad_name: str, pad_len: int):
    """(GenomeIndex, offset): the minimizer/parity index of the genome
    {pad_name: pad_len N bases, **seqs}, built over PAD_PREFIX N bases in
    place of the pad.  `shift_index(gi, offset)` is then the index of the
    whole genome (its coordinates; `padded_text_rows` gives its text
    rows): no kmer lies in the pad, and the prefix is longer than a
    minimizer window plus a kmer, so every window at the pad's edge sees
    what it sees in the whole genome.  The offset is a multiple of 256:
    whole text rows, and even, which keeps a parity value's strand bit."""
    from ..align.index import DEFAULT_K, MINIMIZER_W, GenomeIndex

    offset = pad_len - PAD_PREFIX
    assert PAD_PREFIX >= MINIMIZER_W + DEFAULT_K and PAD_PREFIX % 2 == 0
    assert offset >= 0 and offset % 256 == 0, pad_len
    gi = GenomeIndex.build({pad_name: b"N" * PAD_PREFIX, **seqs}, txome,
                           sampling="minimizer", pos_mode="parity")
    return gi, offset


def shift_index(gi, offset: int):
    """`gi` (from `padded_index`) with its first contig `offset` bases
    longer: kmer values, contig starts, the genome length and the
    junction contigs' coordinates move by offset.  The text arrays stay
    gi's own (the text of a 2 Gb pad is 4.6 GB of host memory):
    `padded_text_rows` and `_write_human_reference` add the pad."""
    import dataclasses

    assert gi.pos_mode == "parity" and offset % 256 == 0
    assert int(gi.kmer_pos.max(initial=0)) + offset < 2**32
    starts = gi.chrom_starts.copy()
    starts[1:] += offset
    return dataclasses.replace(
        gi, chrom_starts=starts, genome_len=gi.genome_len + offset,
        sj_contig_start=gi.sj_contig_start + offset,
        sj_donor_end=gi.sj_donor_end + offset,
        sj_acceptor_start=gi.sj_acceptor_start + offset,
        kmer_pos=(gi.kmer_pos.astype(np.int64) + offset).astype(np.uint32))


def padded_text_rows(gi, offset: int) -> np.ndarray:
    """The packed text rows of the whole padded genome (the JAX package's
    `packed_rows()` of its whole build), without the pad's text: np.zeros
    (pages that are never written take no memory) with the rows of gi's
    text written at the end."""
    rows = gi.packed_rows()
    out = np.zeros((offset // 256 + len(rows), rows.shape[1]), np.uint32)
    out[offset // 256:] = rows
    return out


def _human_gtf(path: str, n_genes: int, spacing: int) -> None:
    """Two-exon genes on chr1, alternating strands, laid out as the e2e
    fixtures lay them out: gene g's exons are [s, s+600) and [s+1200,
    s+2400), s = g * spacing + 1000 (0-based)."""
    with open(path, "w") as f:
        _write_genes(f, "chr1", 0, np.arange(n_genes) * spacing + 1000)


def _write_genes(f, chrom: str, first: int, starts) -> None:
    """GTF rows of genes G{first}, G{first+1}, ... on `chrom`, exon 1 of
    gene first+j at [starts[j], starts[j]+600) and exon 2 at
    [starts[j]+1200, starts[j]+2400) (0-based), '+' for even numbers."""
    for j, st in enumerate(np.asarray(starts).tolist()):
        g = first + j
        s = "+" if g % 2 == 0 else "-"
        attrs = (f'gene_id "G{g}"; transcript_id "T{g}"; '
                 f'gene_name "G{g}";\n')
        f.write(f"{chrom}\tx\texon\t{st + 1}\t{st + 600}\t.\t{s}\t.\t{attrs}")
        f.write(f"{chrom}\tx\texon\t{st + 1201}\t{st + 2400}\t.\t{s}\t.\t"
                f"{attrs}")


def _human_whitelist(rng, n_wl: int) -> np.ndarray:
    """n_wl distinct packed 16-base barcodes, sorted, drawn as u32s."""
    draw = rng.integers(0, 2**32, n_wl + n_wl // 100 + 1024,
                        dtype=np.uint64).astype(np.uint32)
    u = np.unique(draw)
    assert len(u) >= n_wl
    return np.sort(rng.choice(u, n_wl, replace=False))


def _write_whitelist(path: str, wl: np.ndarray) -> None:
    """Packed barcodes -> a whitelist file, one 16-base line each."""
    lines = np.empty((len(wl), 17), np.uint8)
    lines[:, :16] = _unpack_barcodes(wl)
    lines[:, 16] = ord("\n")
    with open(path, "wb") as f:
        f.write(lines.tobytes())


def _unpack_barcodes(packed: np.ndarray, length: int = 16) -> np.ndarray:
    """Packed barcodes -> [n, length] ASCII bases."""
    from ..ops import encode

    return np.frombuffer(b"ACGT", np.uint8)[encode.unpack_np(packed, length)]


def _listed(wl: np.ndarray, packed: np.ndarray) -> np.ndarray:
    from ..ops.encode import sorted_search

    packed = np.asarray(packed)
    i = np.minimum(sorted_search(wl, packed.ravel()).reshape(packed.shape),
                   len(wl) - 1)
    return wl[i] == packed


def _human_barcode_errors(bc_packed: np.ndarray, rows: np.ndarray,
                          wl: np.ndarray, rng) -> np.ndarray:
    """One substituted base in each listed row's packed barcode, in place,
    kept only where the new barcode is not listed and its one listed
    Hamming-1 neighbour is the original, so that correction takes it
    back; returns the rows that keep their error."""
    pos = rng.integers(0, 16, len(rows)).astype(np.uint32)
    shift = 2 * (15 - pos)
    delta = rng.integers(1, 4, len(rows)).astype(np.uint32)
    old = bc_packed[rows]
    new = old ^ (delta << shift)                       # a different base
    d = np.arange(1, 4, dtype=np.uint32)
    xor = (d[None, :] << (2 * (15 - np.arange(16, dtype=np.uint32)))
           [:, None]).reshape(-1)                      # every neighbour
    n_listed = _listed(wl, new[:, None] ^ xor[None, :]).sum(1)
    keep = ~_listed(wl, new) & (n_listed == 1)
    bc_packed[rows[keep]] = new[keep]
    return rows[keep]


def _intergenic_repeat_starts(spacing: int, repeat_len: int) -> np.ndarray:
    """Read starts p on the repeat whose read overlaps no gene span
    [s, s+2400) at any of its copies (bench.py's `genic` test)."""
    p = np.arange(repeat_len - READ_LEN)
    genic = np.zeros(len(p), bool)
    for c in range(HUMAN_REPEAT_COPIES):
        off = (p + c * repeat_len) % spacing
        genic |= (off > 1000 - READ_LEN) & (off < 3400)
    return p[~genic]


def _write_human_reference(ref_dir: str, gi, offset: int, txome) -> None:
    """index.npz (uncompressed) of shift_index(gi, offset) and
    reference.json; the pad's text is written without its valid mask
    ever being held (offset is a multiple of 8: its validity bits are
    whole zero bytes)."""
    arrays = shift_index(gi, offset).npz_arrays()
    arrays.update(text=np.concatenate([np.zeros(offset, np.uint8), gi.text]),
                  text_valid=np.concatenate([
                      np.zeros(offset // 8, np.uint8),
                      np.packbits(gi.text_valid)]),
                  text_len=offset + len(gi.text))
    np.savez(os.path.join(ref_dir, "index.npz"), **arrays)
    del arrays
    write_reference_json(ref_dir, gi, txome)


def build_human_run(tmp: str, n_reads: int = 1_000_000, **kw) -> dict:
    """`human_run_inputs` and the reference directory they belong to:
    ref/index.npz, uncompressed, of the index shifted over the whole pad
    (the text as zeros and the pad's validity bits as zero bytes, never a
    mask the pad's length) and ref/reference.json beside genes/genes.gtf;
    no fasta/, which count never reads."""
    fx = human_run_inputs(tmp, n_reads, **kw)
    t = time.time()
    gi, offset = fx.pop("index")
    _write_human_reference(fx["ref"], gi, offset, fx.pop("txome"))
    fx["timing"]["npz_write_s"] = time.time() - t
    return fx


def human_run_inputs(tmp: str, n_reads: int = 1_000_000, *,
                     pad_len: int = HUMAN_PAD,
                     chr1_len: int = HUMAN_CHR1_LEN,
                     repeat_len: int = HUMAN_REPEAT_LEN,
                     n_genes: int = HUMAN_GENES, n_wl: int = HUMAN_WL,
                     n_cells: int = HUMAN_CELLS, seed: int = 1) -> dict:
    """A count run on a reference of human size: contig chrPad of pad_len
    N bases, then chr1 (bench.py's human-scale genome: its first 4 x
    repeat_len bases are four copies of one segment, the rest random) with
    n_genes two-exon genes (`_human_gtf`), one annotated junction each;
    a whitelist of n_wl random barcodes, n_cells of them cells; n_reads
    reads, 2 a molecule, of the HUMAN_KINDS in HUMAN_SHARES; 2% of the
    reads carry a barcode error that corrects back uniquely.

    The text (pad + chr1 + junction contigs) is past AUTO_MINIMIZER_LEN
    and, at the default sizes, past 2**31: the index samples minimizers
    and packs positions by parity, and chr1 crosses 2**31, so about half
    its genes and every junction contig lie above it.  The index is built
    over a short pad and shifted (`padded_index`, `shift_index`): equal,
    array for array, to GenomeIndex.build over the whole genome, in a
    fraction of its host time; it is returned, not written
    (`build_human_run` writes it), as `index` = (the index over the short
    pad, the offset), with the transcriptome (`txome`).

    Returns paths, `expected` (total reads, molecules, confidently mapped
    reads, molecules per gene: the repeat molecules map at MAPQ < 255 and
    are never counted), each read's kind, molecule, gene (-1 on the
    repeat), whether it is counted, text start (-1 for a spliced or
    deletion read) and ASCII cDNA (`read_kind`, `read_mol`, `read_gene`,
    `read_counted`, `read_pos`, `cdna`, in FASTQ order; `kinds` names the
    kinds, `reads_by_kind` counts them), the genome's chr1 codes
    (`codes`) and layout
    (`gene_start`, exon 1 of each gene in them) for `human_truth_reads`,
    and the host seconds of each part (`timing`)."""
    from ..io.gtf import Transcriptome

    timing = {}
    t = time.time()
    os.makedirs(tmp, exist_ok=True)
    ref_dir = os.path.join(tmp, "ref")
    os.makedirs(os.path.join(ref_dir, "genes"), exist_ok=True)
    bases = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    rep_end = HUMAN_REPEAT_COPIES * repeat_len
    seg = rng.integers(0, 4, repeat_len).astype(np.uint8)
    codes = np.concatenate([np.tile(seg, HUMAN_REPEAT_COPIES),
                            rng.integers(0, 4, chr1_len - rep_end)
                            .astype(np.uint8)])
    garr = bases[codes]
    spacing = chr1_len // n_genes
    assert spacing >= 3600, "genes need 2400 bases and 1000 ahead"
    gtf = os.path.join(ref_dir, "genes", "genes.gtf")
    _human_gtf(gtf, n_genes, spacing)
    txome = Transcriptome.from_gtf(gtf)
    timing["genome_s"] = time.time() - t

    t = time.time()
    gi, offset = padded_index({"chr1": garr.tobytes()}, txome, "chrPad",
                              pad_len)
    timing["index_build_s"] = time.time() - t

    fx = _human_reads(tmp, rng, seed + 1, n_reads, codes,
                      np.arange(n_genes) * spacing + 1000,
                      -(-(rep_end - 1000) // spacing), n_genes, spacing,
                      repeat_len, n_wl, n_cells, timing)
    return dict(
        fx, ref=ref_dir, text_len=offset + len(gi.text),
        genome_len=int(gi.genome_len) + offset,
        chr1_start=offset + PAD_PREFIX, n_kmers=len(gi.kmer_keys),
        n_junctions=int(gi.n_junctions), chr1_codes=codes, codes=codes,
        chrom_names=["chrPad", "chr1"],
        chrom_starts=np.asarray([0, offset + PAD_PREFIX], np.int64),
        gtf=gtf, index=(gi, offset), txome=txome)


def _human_reads(tmp: str, rng, seed: int, n_reads: int, codes, gene_start,
                 g_first: int, n_genes: int, spacing: int, repeat_len: int,
                 n_wl: int, n_cells: int, timing: dict, plan=None) -> dict:
    """The whitelist (drawn from `rng`) and the reads (seed `seed`) of a
    human-layout run, written under tmp: genes g_first.. lie off chr1's
    repeat, gene g's exon 1 starts at codes[gene_start[g]], the repeat's
    copies start at codes[0] with the genes of chr1 every `spacing`
    bases.  `plan` (repeats.plant's, with gene_start in codes'
    coordinates) draws the exon, junction and deletion reads from the
    genes no copy touches and adds the REPEAT_KINDS.  Returns the run's
    fields of `human_run_inputs`."""
    t = time.time()
    wl = _human_whitelist(rng, n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)
    timing["whitelist_s"] = time.time() - t

    t = time.time()
    L = READ_LEN
    ar = np.arange(L)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rng = np.random.default_rng(seed)
    n_mol = n_reads // E2E_DUP
    kinds, shares = ((HUMAN_KINDS, HUMAN_SHARES) if plan is None
                     else (REPEAT_KINDS, REPEAT_SHARES))
    n_kind = [int(n_mol * s) for s in shares]
    n_kind[0] = n_mol - sum(n_kind[1:])
    kind = np.repeat(np.arange(len(kinds)), n_kind)
    ok = (np.arange(n_genes) >= g_first) & (
        True if plan is None else plan["clean"])
    plus = np.flatnonzero(ok & (np.arange(n_genes) % 2 == 0))
    cdna = np.empty((n_mol, L), np.uint8)
    gene = np.full(n_mol, -1, np.int64)
    pos = np.full(n_mol, -1, np.int64)    # an unspliced read's text start
    counted = kind != HUMAN_KINDS.index("repeat")
    sel = kind == 0                                   # exon 1, '+' gene
    gene[sel] = rng.choice(plus, n_kind[0])
    start = gene_start[gene[sel]] + rng.integers(0, 600 - L - 8, n_kind[0])
    cdna[sel] = bases[codes[start[:, None] + ar]]
    pos[sel] = start
    sel = kind == 1                                   # exon 1 -> exon 2
    g = (rng.integers(g_first, n_genes, n_kind[1]) if plan is None
         else rng.choice(np.flatnonzero(ok), n_kind[1]))
    gene[sel] = g
    m = HUMAN_JUNCTION_MIN_SIDE
    left = rng.integers(m, L - m + 1, n_kind[1])[:, None]
    st = gene_start[g][:, None]
    idx = np.where(ar < left, st + 600 - left + ar, st + 1200 + ar - left)
    seq = bases[codes[idx]]
    minus = g % 2 == 1                                # sense of a '-' gene
    seq[minus] = comp[seq[minus, ::-1]]
    cdna[sel] = seq
    sel = kind == 2                                   # 2-base deletion
    gene[sel] = rng.choice(plus, n_kind[2])
    st = (gene_start[gene[sel]]
          + rng.integers(0, 600 - L - 8, n_kind[2]))[:, None]
    cut = rng.integers(*HUMAN_DELETION_AT, n_kind[2])[:, None]
    cdna[sel] = bases[codes[np.where(ar < cut, st + ar,
                                     st + ar + HUMAN_DELETION)]]
    sel = kind == 3                        # repeat, intergenic at all copies
    p = rng.choice(_intergenic_repeat_starts(spacing, repeat_len), n_kind[3])
    cdna[sel] = bases[codes[p[:, None] + ar]]
    pos[sel] = p
    twin = {}
    if plan is not None:
        from .repeats import PARALOG_FLANK

        sel = kind == REPEAT_KINDS.index("exon_repeat")
        er = plan["exon_repeat"]
        n = int(sel.sum())
        c = rng.integers(0, len(er["gene"]), n)
        gene[sel] = er["gene"][c]
        p = er["start"][c] + (rng.random(n)
                              * (er["length"][c] - L + 1)).astype(np.int64)
        cdna[sel] = bases[codes[p[:, None] + ar]]
        pos[sel] = p
        sel = kind == REPEAT_KINDS.index("paralog")
        pa = plan["paralogs"]
        n = int(sel.sum())
        c = rng.integers(0, len(pa["gene"]), n)
        genic = pa["twin_gene"][c] >= 0
        side = genic & (rng.random(n) < 0.5)   # the twin gene's own reads
        g = np.where(side, pa["twin_gene"][c], pa["gene"][c])
        off = rng.integers(0, 600 - L - 8, n)
        p = gene_start[g] + off
        tw = (np.where(side, pa["start"][c], pa["twin_start"][c])
              + PARALOG_FLANK + off)
        same = (codes[p[:, None] + ar] == codes[tw[:, None] + ar]).all(1)
        cdna[sel] = bases[codes[p[:, None] + ar]]
        pos[sel] = p
        gene[sel] = np.where(same & genic, -1, g)
        counted[sel] = ~(same & genic)
        twin = dict(paralog_twin_identical=int(same.sum()),
                    paralog_multi_gene=int((same & genic).sum()))

    cells = rng.choice(n_wl, n_cells, replace=False)
    cell_idx = rng.integers(0, n_cells, n_mol)
    umi = bases[_coded_umis(cell_idx, HUMAN_UMI_LEN, rng)]
    order = rng.permutation(n_mol * E2E_DUP)
    rep = lambda a: np.repeat(a, E2E_DUP, axis=0)[order]  # noqa: E731
    bc_packed = rep(wl[cells[cell_idx]])
    umi, cdna, read_kind = rep(umi), rep(cdna), rep(kind)
    read_mol = rep(np.arange(n_mol))
    n_err = len(bc_packed) // 50
    err_rows = _human_barcode_errors(
        bc_packed, rng.choice(len(bc_packed), n_err, replace=False), wl, rng)
    r1p = os.path.join(tmp, "human_S1_L001_R1_001.fastq")
    r2p = os.path.join(tmp, "human_S1_L001_R2_001.fastq")
    _write_fastq_pair(r1p, r2p, np.concatenate(
        [_unpack_barcodes(bc_packed), umi], axis=1), cdna)
    timing["reads_s"] = time.time() - t

    return dict(
        wl=wl_path, fq1=r1p, fq2=r2p, n_reads=len(cdna), n_wl=n_wl,
        wl_packed=wl, barcode_errors=len(err_rows), read_kind=read_kind,
        read_mol=read_mol, read_gene=gene[read_mol], cdna=cdna,
        read_counted=counted[read_mol], read_pos=pos[read_mol], kinds=kinds,
        gene_start=gene_start, spacing=spacing, repeat_len=repeat_len,
        plus_genes=plus, timing=timing, reads_by_kind=dict(zip(
            kinds, (np.asarray(n_kind) * E2E_DUP).tolist())), **twin,
        expected=dict(
            total_reads=len(cdna), mapped_reads=len(cdna),
            conf_mapped_reads=int(counted.sum()) * E2E_DUP,
            total_molecules=int(counted.sum()),
            gene_molecules=np.bincount(gene[counted], minlength=n_genes)))


# GRCh38's primary chromosomes and their lengths (GRC's GRCh38 assembly
# report): 3,088,269,832 bases
GRCH38_CHROMS = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415))


def genes_per_chrom(lens, n_genes: int) -> np.ndarray:
    """n_genes spread over chromosomes of lengths `lens` in proportion to
    length (largest remainders take the rest)."""
    lens = np.asarray(lens, np.int64)
    q = lens * n_genes
    n = q // lens.sum()
    rest = n_genes - int(n.sum())
    n[np.argsort(-(q % lens.sum()), kind="stable")[:rest]] += 1
    return n


def write_reference_json(ref_dir: str, gi, txome) -> None:
    with open(os.path.join(ref_dir, "reference.json"), "w") as f:
        json.dump({"genomes": ["genome"], "version": "cellranger-tpu-0.1.0",
                   "input_fasta": "genome.fa", "input_gtf": "genes.gtf",
                   "n_genes": len(txome.genes),
                   "n_transcripts": len(txome.transcripts),
                   "n_junctions": gi.n_junctions, "index_k": gi.k,
                   "index_stride": gi.stride}, f, indent=2)


def build_grch38_run(tmp: str, n_reads: int = 1_000_000, *,
                     chroms=GRCH38_CHROMS,
                     repeat_len: int = HUMAN_REPEAT_LEN,
                     n_genes: int = HUMAN_GENES, n_wl: int = HUMAN_WL,
                     n_cells: int = HUMAN_CELLS, seed: int = 3,
                     device="cuda", sampling: str = "auto",
                     pos_mode: str = "auto", repeats: bool = False) -> dict:
    """A count run on a reference of GRCh38's shape: the 24 `chroms` of
    seeded random bases (chr1, the first, opens with HUMAN_REPEAT_COPIES
    copies of one repeat_len segment), n_genes two-exon genes spread over
    them in proportion to length (`genes_per_chrom`; within a chromosome
    the layout of `_human_gtf` at its own spacing), one annotated
    junction each; then the whitelist, cells and reads of
    `human_run_inputs` (`_human_reads`), truth by construction.

    `repeats` writes GRCh38's structure over the random bases
    (`testing/repeats.py`: Alu, L1, simple repeats, alpha satellite at
    the centromeres, segmental duplications, gene paralogs, repeat copies
    in exon 2, N gaps; copy numbers in proportion to the genome's length);
    the genes are laid out evenly over what the gaps and centromeres
    leave, and the reads are of the REPEAT_KINDS in REPEAT_SHARES, the
    exon, junction and deletion reads from genes no copy touches.  The
    copies come back as `repeat_plan`, their bases by family as
    `repeat_bases`.

    The index is GenomeIndex.build over the whole genome on `device` (no
    pad, no shift), written uncompressed to ref/index.npz beside
    ref/reference.json and genes/genes.gtf.  At the default sizes the text
    is 3,097,054,072 bases (genome and 36,601 junction contigs): minimizer
    sampling and parity positions; chr13 crosses 2**31 and chr13-chrY lie
    above it.  Returns the fields of `human_run_inputs` (the genome's
    text codes as `codes`, exon 1 of each gene in them as `gene_start`,
    chr1's gene spacing as `spacing`), the index's size and sampling, and
    the host seconds of each part (`timing`: genome, repeat model, device
    build, npz write, whitelist, reads)."""
    from ..align.index import GenomeIndex
    from ..io.gtf import Transcriptome

    timing = {}
    t = time.time()
    ref_dir = os.path.join(tmp, "ref")
    os.makedirs(os.path.join(ref_dir, "genes"), exist_ok=True)
    bases = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    names = [c for c, _ in chroms]
    lens = np.asarray([n for _, n in chroms], np.int64)
    n_per = genes_per_chrom(lens, n_genes)
    rep_end = HUMAN_REPEAT_COPIES * repeat_len
    assert rep_end <= lens[0]
    if repeats:
        from . import repeats as rp
        local, blocks, spacing = rp.gene_layout(
            lens, n_per, rp.chrom_blocks(names, lens), floor_first=rep_end)
        spacing = np.asarray(spacing, np.int64)
    else:
        spacing = lens // np.maximum(n_per, 1)
        assert (spacing[n_per > 0] >= 3600).all(), "genes need 3,400 bases"
        local = [np.arange(k) * sp + 1000 for k, sp in zip(n_per, spacing)]
    ascii_of = bases[np.arange(256) & 3]      # a random byte's low 2 bits

    def draw(n):
        return np.frombuffer(rng.bytes(n), np.uint8)

    parts = {}
    for i, (name, n) in enumerate(chroms):
        x = (np.concatenate([np.tile(draw(repeat_len), HUMAN_REPEAT_COPIES),
                             draw(n - rep_end)]) if i == 0 else draw(n))
        parts[name] = x if repeats else ascii_of[x].tobytes()
    plan = None
    if repeats:
        timing["genome_s"] = time.time() - t
        t = time.time()
        cs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        codes = np.concatenate(list(parts.values())) & 3
        del parts
        plan = rp.plant(codes, cs, blocks, [seed, 13], forbid=[(0, rep_end)],
                        gene_start=np.concatenate(
                            [cs[i] + x for i, x in enumerate(local)]))
        five = np.frombuffer(b"ACGTN", np.uint8)
        parts = {name: five[codes[a:a + n]].tobytes()
                 for (name, n), a in zip(chroms, cs)}
        del codes
        timing["repeat_model_s"] = time.time() - t
        t = time.time()
    seqs = parts
    gtf = os.path.join(ref_dir, "genes", "genes.gtf")
    with open(gtf, "w") as f:
        first = 0
        for (name, _), k, x in zip(chroms, n_per, local):
            _write_genes(f, name, first, x)
            first += k
    txome = Transcriptome.from_gtf(gtf)
    timing["genome_s"] = timing.get("genome_s", 0.0) + time.time() - t

    t = time.time()
    gi = GenomeIndex.build(seqs, txome, sampling=sampling,
                           pos_mode=pos_mode, device=device)
    del seqs, parts
    timing["device_build_s"] = time.time() - t

    t = time.time()
    np.savez(os.path.join(ref_dir, "index.npz"), **gi.npz_arrays())
    write_reference_json(ref_dir, gi, txome)
    timing["npz_write_s"] = time.time() - t

    gene_start = np.concatenate(
        [gi.chrom_starts[i] + x for i, x in enumerate(local)])
    fx = _human_reads(tmp, rng, seed + 1, n_reads, gi.text, gene_start,
                      -(-(rep_end - 1000) // int(spacing[0])), n_genes,
                      int(spacing[0]), repeat_len, n_wl, n_cells, timing,
                      plan=plan)
    out = dict(
        fx, ref=ref_dir, text_len=len(gi.text), genome_len=int(gi.genome_len),
        n_kmers=len(gi.kmer_keys), n_junctions=int(gi.n_junctions),
        sampling=gi.sampling, pos_mode=gi.pos_mode, codes=gi.text, gtf=gtf,
        chrom_names=list(gi.chrom_names), chrom_starts=gi.chrom_starts,
        chr1_start=0)
    if plan is not None:
        out.update(repeat_plan=plan, repeat_bases=dict(plan["bases"]),
                   text_valid=gi.text_valid)
    return out


def e2e_genome(tmp: str, genome_len: int = E2E_GENOME_LEN,
               n_genes: int = E2E_GENES):
    """The e2e fixtures' genome and genes (`_e2e_reference`'s first draw
    of seed 11, its GTF written to tmp/g.gtf): ({"chr1": bytes},
    Transcriptome)."""
    from ..io.gtf import Transcriptome

    os.makedirs(tmp, exist_ok=True)
    garr = _e2e_genome_draw(np.random.default_rng(11), genome_len)
    gtf = os.path.join(tmp, "g.gtf")
    _human_gtf(gtf, n_genes, genome_len // n_genes)
    return {"chr1": garr.tobytes()}, Transcriptome.from_gtf(gtf)


def index_genome(tmp: str, genome_len: int, n_chroms: int = 4,
                 n_genes: int = 2000, seed: int = 41,
                 repeats: bool = False):
    """A seeded genome of n_chroms chromosomes, genome_len bases in all,
    with runs of N (each chromosome opens and ends with one, and one of
    1-5,000 N starts in about every 50,000 bases, some across a gene's
    junction flanks) and n_genes two-exon genes, one annotated junction
    each (GTF at tmp/g.gtf): ({name: bytes}, Transcriptome).  `repeats`
    writes the repeat model of `testing/repeats.py` over the random bases
    first (copy numbers in proportion to genome_len; chromosomes chr1..
    take the gaps and centromeres of GRCh38's of those names, scaled; no
    gene is protected), then the N runs."""
    from ..io.gtf import Transcriptome

    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    lens = genes_per_chrom(np.ones(n_chroms, np.int64), genome_len)
    n_per = genes_per_chrom(lens, n_genes)
    chroms, n_masks = [], []
    gtf = os.path.join(tmp, "g.gtf")
    with open(gtf, "w") as f:
        first = 0
        for c, (n, k) in enumerate(zip(lens, n_per)):
            codes = rng.integers(0, 4, n).astype(np.uint8)
            n_runs = max(int(n) // 50_000, 1)
            starts = rng.integers(0, n, n_runs)
            ends = np.minimum(starts + rng.integers(1, 5000, n_runs), n)
            cover = np.zeros(n + 1, np.int64)
            np.add.at(cover, starts, 1)
            np.add.at(cover, ends, -1)
            is_n = np.cumsum(cover[:n]) > 0
            is_n[:rng.integers(1, 300)] = True
            is_n[n - rng.integers(1, 300):] = True
            chroms.append(codes)
            n_masks.append(is_n)
            sp = int(n) // max(int(k), 1)
            assert sp >= 3600 or k == 0, "genes need 3,400 bases"
            _write_genes(f, f"chr{c + 1}", first, np.arange(k) * sp + 1000)
            first += int(k)
    if repeats:
        from . import repeats as rp
        names = [f"chr{c + 1}" for c in range(n_chroms)]
        whole = np.concatenate(chroms)
        cs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        rp.plant(whole, cs, rp.chrom_blocks(names, lens), [seed, 13])
        chroms = [whole[a:a + n] for a, n in zip(cs, lens)]
    seqs = {}
    for c, (codes, is_n) in enumerate(zip(chroms, n_masks)):
        codes[is_n] = 4
        seqs[f"chr{c + 1}"] = bases[codes].tobytes()
    return seqs, Transcriptome.from_gtf(gtf)


def human_truth_reads(fx: dict, n: int, seed: int = 7):
    """bench.py's truth probe over a `build_human_run` or
    `build_grch38_run` genome: n error-free reads, the first half at
    repeat positions intergenic at every copy (an honest aligner reports
    them below MAPQ 255), the rest inside exon 1 of a '+' gene off the
    repeat (each must map to its gene at MAPQ 255).  Returns (ASCII reads
    [n, READ_LEN], true gene or -1, in_repeat bool)."""
    L = READ_LEN
    rng = np.random.default_rng(seed)
    spacing, rl = fx["spacing"], fx["repeat_len"]
    n_rep = n // 2
    p = rng.choice(_intergenic_repeat_starts(spacing, rl), n_rep)
    gene = rng.choice(fx["plus_genes"], n - n_rep)
    pos = np.concatenate([p, fx["gene_start"][gene]
                          + rng.integers(0, 600 - L, n - n_rep)])
    reads = np.frombuffer(b"ACGT", np.uint8)[
        fx["codes"][pos[:, None] + np.arange(L)]]
    true_gene = np.concatenate([np.full(n_rep, -1), gene])
    return reads, true_gene, np.arange(n) < n_rep


def repeat_copy_reads(fx: dict, n: int, seed: int = 9):
    """n error-free reads off the repeat copies of a `build_grch38_run(
    repeats=True)` fixture, as many from each family (Alu, L1, simple
    repeats, alpha satellite, segmental duplications, gene paralogs,
    exon-2 copies, chr1's repeat segment), each inside a copy where the
    copy is long enough (else over it), half of them reverse-complemented;
    N where the text is a gap.  Returns (ASCII reads [n, READ_LEN], the
    family of each)."""
    L = READ_LEN
    rng = np.random.default_rng(seed)
    plan = fx["repeat_plan"]
    fams = {k: (v["start"], v["length"]) for k, v in plan["copies"].items()}
    fams["paralog"] = (plan["paralogs"]["start"],
                       plan["paralogs"]["length"])
    fams["exon_repeat"] = (plan["exon_repeat"]["start"],
                           plan["exon_repeat"]["length"])
    rl = fx["repeat_len"] * HUMAN_REPEAT_COPIES
    fams["chr1_segment"] = (np.zeros(1, np.int64), np.full(1, rl))
    names = sorted(fams)
    fam = np.arange(n) % len(names)
    pos = np.empty(n, np.int64)
    for i, name in enumerate(names):
        st, ln = fams[name]
        m = fam == i
        c = rng.integers(0, len(st), int(m.sum()))
        room = np.maximum(ln[c] - L, 0) + 1
        pos[m] = st[c] + (rng.random(int(m.sum())) * room).astype(np.int64)
    pos = np.clip(pos, 0, fx["genome_len"] - L)
    at = pos[:, None] + np.arange(L)
    codes = np.where(fx["text_valid"][at], fx["codes"][at], 4)
    reads = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rc = rng.random(n) < 0.5
    comp = np.frombuffer(b"TGCAN", np.uint8)
    reads[rc] = comp[codes[rc, ::-1]]
    return reads, np.asarray(names)[fam]


def reads_plane(reads: np.ndarray, bc_idx: np.ndarray, umi: np.ndarray):
    """The SC3Pv3 step plane of ASCII cDNA reads [B, READ_LEN] (every
    read's barcode rank bc_idx, packed UMI umi, every slot valid)."""
    from types import SimpleNamespace

    from ..io.chemistry import get_chemistry
    from ..ops import encode
    from ..pipeline.count import pack_step_input

    codes, valid = encode.encode_seqs(reads)
    B = len(reads)
    shim = SimpleNamespace(
        batch_size=B, umi_packed=np.asarray(umi, np.uint32),
        slot_valid=np.ones(B, bool), umi_valid=np.ones(B, bool), rna=codes,
        rna_nmask=valid, rna2=None, rna2_nmask=None)
    return pack_step_input(get_chemistry("SC3Pv3"), READ_LEN, shim,
                           np.asarray(bc_idx, np.int32))


# a CellPlex GEM well (10x's 12-CMO multiplexing kit, 3' v3.1)
CELLPLEX_TAG_LEN = 15           # CMO301-CMO312's length
CELLPLEX_TAG_MIN_DIST = 5       # pairwise Hamming distance of the drawn tags
CELLPLEX_TAG_LEADER = 10        # the pattern's 5PNNNNNNNNNN ahead of the tag
CELLPLEX_R2_TAIL = b"A" * 46    # R2 after the tag: 71 bases in all
CELLPLEX_KINDS = ("singlet", "multiplet", "blank")
CELLPLEX_SHARES = (0.74, 0.24, 0.02)   # ~0.8% multiplets per 1,000 cells
CELLPLEX_BACKGROUND = 3         # mean tag UMIs of every tag in every barcode
CELLPLEX_SPREAD = 0.25          # log-normal sigma of a cell's tag signal
CELLPLEX_GEX_SPREAD = 0.3       # log-normal sigma of a cell's mRNA
CELLPLEX_TYPES = 8              # cell types, each with its marker genes
CELLPLEX_MARKER_SHARE = 0.5     # of a cell's GEX molecules on its markers
# the TotalSeq-B panel of 10x's "10k PBMCs from a Healthy Donor - Gene
# Expression and Cell Surface Protein" (pbmc_10k_protein_v3, Cell Ranger
# 3.0): 14 markers, then 3 isotype controls
CELLPLEX_AB_PANEL = tuple(f"{a}_TotalSeqB" for a in (
    "CD3", "CD4", "CD8a", "CD14", "CD15", "CD16", "CD56", "CD19", "CD25",
    "CD45RA", "CD45RO", "PD-1", "TIGIT", "CD127", "IgG2a_control",
    "IgG1_control", "IgG2b_control"))
CELLPLEX_AB_MARKERS = 3         # marker antibodies high in each cell type
CELLPLEX_AB_SPREAD = 0.25       # log-normal sigma of a cell's protein
CELLPLEX_AGG_FOLD = 4           # an aggregate's excess on every antibody,
#                                 in mean singlet antibody signals


def _cellplex_tags(n_tags: int, rng, avoid=()) -> np.ndarray:
    """n_tags random CELLPLEX_TAG_LEN-base tags as ASCII rows, every two,
    and each and every row of `avoid`, at least CELLPLEX_TAG_MIN_DIST
    bases apart."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    tags: list = []
    while len(tags) < n_tags:
        t = bases[rng.integers(0, 4, CELLPLEX_TAG_LEN)]
        if all((t != u).sum() >= CELLPLEX_TAG_MIN_DIST
               for u in (*avoid, *tags)):
            tags.append(t)
    return np.asarray(tags)


def _feature_r2(seqs: np.ndarray, rng) -> np.ndarray:
    """R2 rows of a Feature Barcode library, one a molecule: a random
    CELLPLEX_TAG_LEADER-base leader, the feature's sequence (a row of
    `seqs`), then CELLPLEX_R2_TAIL."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    r2 = np.empty((len(seqs), CELLPLEX_TAG_LEADER + CELLPLEX_TAG_LEN
                   + len(CELLPLEX_R2_TAIL)), np.uint8)
    r2[:, :CELLPLEX_TAG_LEADER] = bases[
        rng.integers(0, 4, (len(seqs), CELLPLEX_TAG_LEADER))]
    r2[:, CELLPLEX_TAG_LEADER:CELLPLEX_TAG_LEADER + CELLPLEX_TAG_LEN] = seqs
    r2[:, CELLPLEX_TAG_LEADER + CELLPLEX_TAG_LEN:] = np.frombuffer(
        CELLPLEX_R2_TAIL, np.uint8)
    return r2


def _cellplex_antibodies(rng, n_ab: int, ab_reads: int, n_agg: int,
                         kind: np.ndarray, cell_type: np.ndarray):
    """The antibody UMIs of a CellPlex well [n_cells, n_ab] and the
    planted aggregates (cell indices): CELLPLEX_BACKGROUND Poisson UMIs
    of every antibody in every cell; each cell type's CELLPLEX_AB_MARKERS
    markers (of the panel's non-isotype antibodies) Poisson(signal x
    lognormal / markers) more in a cell of that type, a two-tag
    multiplet's two cells each a singlet's; n_agg singlets are protein
    aggregates with Poisson(CELLPLEX_AGG_FOLD x signal) more of every
    antibody, isotypes included.  signal makes the UMIs ab_reads in
    expectation."""
    n_cells, n_types = len(kind), int(cell_type.max()) + 1
    names = CELLPLEX_AB_PANEL[:n_ab]
    if not n_ab:
        return names, np.zeros((n_cells, 0), np.int64), np.zeros(0, np.int64)
    markers = [i for i, a in enumerate(names) if "_control" not in a]
    agg = np.sort(rng.choice(np.flatnonzero(kind == 0), n_agg,
                             replace=False))
    background = n_cells * n_ab * CELLPLEX_BACKGROUND
    signal = (ab_reads - background) / (
        n_cells + (kind == 1).sum() + n_agg * n_ab * CELLPLEX_AGG_FOLD)
    assert signal > 0, "ab_reads leaves no signal above the background"
    scale = signal / CELLPLEX_AB_MARKERS * rng.lognormal(
        -CELLPLEX_AB_SPREAD ** 2 / 2, CELLPLEX_AB_SPREAD, n_cells)
    high = np.zeros((n_types, n_ab), bool)      # each type's markers
    for t in range(n_types):
        for j in range(CELLPLEX_AB_MARKERS):
            high[t, markers[(t * CELLPLEX_AB_MARKERS + j) % len(markers)]] = 1
    mol = rng.poisson(CELLPLEX_BACKGROUND, (n_cells, n_ab))
    for side, who in ((0, np.arange(n_cells)),
                      (1, np.flatnonzero(kind == 1))):
        mol[who] += rng.poisson(scale[who, None]
                                * high[cell_type[who, side]])
    mol[agg] += rng.poisson(CELLPLEX_AGG_FOLD * signal, (n_agg, n_ab))
    return names, mol, agg


def _shuffled_reads(rng, bc_packed, umi, r2, wl, tmp: str, name: str):
    """One library's reads in a random order, 2% of them with a barcode
    error that corrects back uniquely (`_human_barcode_errors`), written
    as tmp/<name>/<name>_S1_L001_R{1,2}_001.fastq."""
    return _shuffled_library(rng, bc_packed, umi, r2, wl, tmp, name)[0]


def _shuffled_library(rng, bc_packed, umi, r2, wl, tmp: str, name: str):
    """`_shuffled_reads`, returning (its directory, the order of the reads
    in the FASTQs: row i of the files is row order[i] of the inputs)."""
    order = rng.permutation(len(bc_packed))
    bc_packed, umi, r2 = bc_packed[order], umi[order], r2[order]
    n_err = len(bc_packed) // 50
    _human_barcode_errors(
        bc_packed, rng.choice(len(bc_packed), n_err, replace=False), wl, rng)
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    _write_fastq_pair(os.path.join(d, f"{name}_S1_L001_R1_001.fastq"),
                      os.path.join(d, f"{name}_S1_L001_R2_001.fastq"),
                      np.concatenate([_unpack_barcodes(bc_packed), umi], 1),
                      r2)
    return d, order


def _typed_gex(rng, garr, spacing: int, n_genes: int, n_types: int,
               n_cells: int, gex_reads: int, weight, cell_types):
    """The GEX molecules of a well of typed cells: gex_reads // E2E_DUP
    molecules spread over the cells by a log-normal weight (times
    `weight`), CELLPLEX_MARKER_SHARE of each on the marker genes of its
    cell's type, the rest on any '+' gene, each read from exon 1 of its
    gene.  cell_types(rng) draws the [n_cells, 2] types (a multiplet's two
    cells; the same type twice elsewhere) after the molecules' cells.
    Returns (each molecule's cell, the types, the cDNA rows)."""
    n_mol = gex_reads // E2E_DUP
    w = rng.lognormal(0.0, CELLPLEX_GEX_SPREAD, n_cells) * weight
    cell_of = rng.choice(n_cells, n_mol, p=w / w.sum())
    cell_type = cell_types(rng)
    mtype = cell_type[cell_of, rng.integers(0, 2, n_mol)]
    n_plus = n_genes // 2                              # '+' strand only
    n_mark = n_plus // (2 * n_types)
    gene = 2 * np.where(
        rng.random(n_mol) < CELLPLEX_MARKER_SHARE,
        mtype * n_mark + rng.integers(0, n_mark, n_mol),
        rng.integers(0, n_plus, n_mol))
    pos = gene * spacing + 1000 + rng.integers(0, 600 - READ_LEN - 8, n_mol)
    cdna = garr[pos[:, None] + np.arange(READ_LEN)[None, :]]
    return cell_of, cell_type, cdna


def build_cellplex_run(tmp: str, n_cells: int = 30_000, n_tags: int = 12,
                       gex_reads: int = 10_000_000,
                       cmo_reads: int = 3_000_000, seed: int = 41, *,
                       n_wl: int = HUMAN_WL,
                       genome_len: int = E2E_GENOME_LEN,
                       n_genes: int = E2E_GENES,
                       n_types: int = CELLPLEX_TYPES,
                       n_antibodies: int = 0, ab_reads: int = 0,
                       n_aggregates: int = 0) -> dict:
    """A CellPlex GEM well for `multi`: a Gene Expression library on the
    e2e genome and genes (seed 11's draw at genome_len) and a Multiplexing
    Capture library of n_tags drawn CMOs (`_cellplex_tags`, named CMO301..,
    pattern 5PNNNNNNNNNN(BC) on R2), with a [samples] section mapping one
    tag to each of n_tags samples and expect-cells n_cells.  With
    n_antibodies, a third library: Antibody Capture of the first
    n_antibodies of CELLPLEX_AB_PANEL, drawn sequences as far from each
    other and from the CMOs as the tags are, the CMOs' pattern, in the
    same feature reference; ab_reads reads, one a molecule, as
    `_cellplex_antibodies` plants them, n_aggregates of the singlets
    protein aggregates.  The antibody draws take a generator of their own
    (seeded (seed, 2)), so the GEX and CMO libraries are the same with or
    without them.

    n_cells barcodes of a whitelist of n_wl (`_human_whitelist`) are cells,
    CELLPLEX_SHARES of them singlets (one tag, balanced over the tags),
    two-tag multiplets (two distinct tags, twice a singlet's mRNA) and
    blanks (tags at background only).  Every cell holds Poisson
    CELLPLEX_BACKGROUND UMIs of every tag; a singlet's own tag adds
    Poisson(signal x lognormal) more, a multiplet's two tags half that
    each, where signal makes the tag UMIs cmo_reads in expectation.

    GEX: gex_reads // 2 molecules of 2 reads each (as e2e's, exon 1 of a
    '+' gene, every read mapped by construction), spread over the cells
    by a log-normal weight, CELLPLEX_MARKER_SHARE of a cell's molecules on
    the marker genes of its type (one of n_types, each sample's singlets
    over the types in turn; a multiplet's two cells' random types half
    and half), the rest on any '+' gene.  CMO: one read a molecule.
    Within a cell every two UMIs, of either library, differ in two bases
    (`_coded_umis`), so every molecule is counted.  2% of each library's
    reads carry a barcode error that corrects back uniquely.  FASTQs are
    uncompressed.

    Returns the config and whitelist paths, the read counts, the tags, the
    antibodies (name -> sequence, in the feature reference's order), and
    the planted truth in cell order: `barcodes` ("<16 bases>-1"), `kind`
    (index into CELLPLEX_KINDS), `tag1`/`tag2` (tag indices, -1 where
    none), `cell_type` [n_cells, 2] (a multiplet's two cells; the same
    type twice elsewhere), `gex_molecules` [n_cells] and `tag_molecules`
    [n_cells, n_tags], `ab_molecules` [n_cells, n_antibodies] and
    `aggregates` (cell indices); `built` maps each sample to its planted
    singlets that are not aggregates, `timing` the host seconds of each
    part."""
    timing: dict = {}
    t = time.time()
    garr, spacing, _, ref_dir, _ = _e2e_reference(
        tmp, np.random.default_rng(11), genome_len, n_genes, None)
    timing["reference_s"] = time.time() - t

    t = time.time()
    rng = np.random.default_rng(seed)
    wl = _human_whitelist(rng, n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)
    cell_bc = wl[rng.choice(n_wl, n_cells, replace=False)]
    timing["whitelist_s"] = time.time() - t

    t = time.time()
    n_kind = [round(n_cells * s) for s in CELLPLEX_SHARES[:2]]
    n_kind.append(n_cells - sum(n_kind))
    kind = rng.permutation(np.repeat(np.arange(3), n_kind))
    tag1 = np.full(n_cells, -1, np.int64)
    tag2 = np.full(n_cells, -1, np.int64)
    single, multi = kind == 0, kind == 1
    tag1[single] = rng.permutation(np.arange(n_kind[0]) % n_tags)
    tag1[multi] = rng.integers(0, n_tags, n_kind[1])
    tag2[multi] = (tag1[multi] + rng.integers(1, n_tags, n_kind[1])) % n_tags
    signal = (cmo_reads - n_cells * n_tags * CELLPLEX_BACKGROUND) / (
        n_kind[0] + n_kind[1])
    assert signal > 0, "cmo_reads leaves no signal above the background"
    scale = signal * rng.lognormal(-CELLPLEX_SPREAD ** 2 / 2,
                                   CELLPLEX_SPREAD, n_cells)   # mean 1
    tag_mol = rng.poisson(CELLPLEX_BACKGROUND, (n_cells, n_tags))
    rows = np.flatnonzero(single)
    tag_mol[rows, tag1[rows]] += rng.poisson(scale[rows])
    rows = np.flatnonzero(multi)
    for tag in (tag1, tag2):
        tag_mol[rows, tag[rows]] += rng.poisson(scale[rows] / 2)

    bases = np.frombuffer(b"ACGT", np.uint8)

    def sample_types(rng):
        # a multiplet's molecules come from its two cells' types in halves;
        # a sample's singlets take the types in turn, so each sample holds
        # every type in the same share
        cell_type = rng.integers(0, n_types, (n_cells, 2))
        rows = np.flatnonzero(single)
        by_tag = rows[np.argsort(tag1[rows], kind="stable")]
        first = np.searchsorted(tag1[by_tag], tag1[by_tag])
        cell_type[by_tag, 0] = (np.arange(len(by_tag)) - first) % n_types
        cell_type[~multi, 1] = cell_type[~multi, 0]
        return cell_type

    cell_of, cell_type, cdna = _typed_gex(
        rng, garr, spacing, n_genes, n_types, n_cells, gex_reads,
        np.where(multi, 2.0, 1.0), sample_types)
    n_mol = len(cell_of)
    flat = np.repeat(np.arange(n_cells * n_tags), tag_mol.ravel())
    cmo_cell, cmo_tag = flat // n_tags, flat % n_tags
    ab_rng = np.random.default_rng((seed, 2))
    ab_names, ab_mol, aggregates = _cellplex_antibodies(
        ab_rng, n_antibodies, ab_reads, n_aggregates, kind, cell_type)
    ab_flat = np.repeat(np.arange(n_cells * n_antibodies), ab_mol.ravel())
    ab_cell, ab_of = np.divmod(ab_flat, max(n_antibodies, 1))
    # one UMI draw over every library: the dedup keeps one feature of a
    # (barcode, UMI) across libraries, so no two molecules of a cell may
    # share a UMI, whichever library they are in
    umi = bases[_coded_umis(np.concatenate([cell_of, cmo_cell, ab_cell]),
                            12, rng)]
    umi, cmo_umi, ab_umi = np.split(umi, [n_mol, n_mol + len(flat)])
    rep = lambda a: np.repeat(a, E2E_DUP, axis=0)  # noqa: E731
    gex_dir = _shuffled_reads(rng, rep(cell_bc[cell_of]), rep(umi), rep(cdna),
                              wl, tmp, "gex")
    del cdna, umi
    timing["gex_reads_s"] = time.time() - t

    t = time.time()
    tags = _cellplex_tags(n_tags, rng)
    cmo_dir = _shuffled_reads(rng, cell_bc[cmo_cell], cmo_umi,
                              _feature_r2(tags[cmo_tag], rng), wl, tmp,
                              "cmo")
    timing["cmo_reads_s"] = time.time() - t

    t = time.time()
    ab_seqs = _cellplex_tags(n_antibodies, ab_rng, avoid=tags)
    libs = ""
    if n_antibodies:
        ab_dir = _shuffled_reads(ab_rng, cell_bc[ab_cell], ab_umi,
                                 _feature_r2(ab_seqs[ab_of], ab_rng), wl,
                                 tmp, "ab")
        libs = f"ab,{ab_dir},Antibody Capture\n"
    timing["ab_reads_s"] = time.time() - t

    names = [f"CMO{301 + i}" for i in range(n_tags)]
    samples = {f"sample{i + 1}": c for i, c in enumerate(names)}
    fref = os.path.join(tmp, "cmo_features.csv")
    pattern = f"5P{'N' * CELLPLEX_TAG_LEADER}(BC)"
    with open(fref, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for fid, seq, ftype in (
                [(c, s, "Multiplexing Capture") for c, s in zip(names, tags)]
                + [(a, s, "Antibody Capture")
                   for a, s in zip(ab_names, ab_seqs)]):
            f.write(f"{fid},{fid},R2,{pattern},{seq.tobytes().decode()},"
                    f"{ftype}\n")
    csv = os.path.join(tmp, "multi.csv")
    with open(csv, "w") as f:
        f.write(f"""[gene-expression]
reference,{ref_dir}
chemistry,SC3Pv3
expect-cells,{n_cells}

[feature]
reference,{fref}

[libraries]
fastq_id,fastqs,feature_types
gex,{gex_dir},Gene Expression
cmo,{cmo_dir},Multiplexing Capture
{libs}
[samples]
sample_id,cmo_ids
""" + "".join(f"{sid},{cid}\n" for sid, cid in samples.items()))
    barcodes = [b.tobytes().decode() + "-1"
                for b in _unpack_barcodes(cell_bc)]
    return dict(
        csv=csv, wl=wl_path, ref=ref_dir, n_wl=n_wl, n_cells=n_cells,
        gex_reads=n_mol * E2E_DUP, cmo_reads=len(flat),
        ab_reads=len(ab_flat),
        n_reads=n_mol * E2E_DUP + len(flat) + len(ab_flat),
        tags={c: s.tobytes().decode() for c, s in zip(names, tags)},
        antibodies={a: s.tobytes().decode()
                    for a, s in zip(ab_names, ab_seqs)},
        samples=samples, barcodes=barcodes, kind=kind, tag1=tag1, tag2=tag2,
        cell_type=cell_type,
        gex_molecules=np.bincount(cell_of, minlength=n_cells),
        tag_molecules=tag_mol, ab_molecules=ab_mol, aggregates=aggregates,
        built={sid: int((single & (tag1 == i)).sum()
                        - (tag1[aggregates] == i).sum())
               for i, sid in enumerate(samples)},
        timing=timing)


# a Perturb-seq GEM well: CRISPR Guide Capture beside GEX and TotalSeq-B
# antibodies (ECCITE-seq), 3' v3, guides as a genome-scale screen's
PERTURB_GUIDE_LEN = 20          # a protospacer
PERTURB_GUIDE_MIN_DIST = 3      # pairwise Hamming distance of the last 16
PERTURB_GUIDES_PER_GENE = 2
# the reverse complement of the optimised SpCas9 scaffold's first 20 bases
# (GTTTAAGAGCTATGCTGGAA): the read shows it just ahead of the protospacer
PERTURB_PREFIX = "TTCCAGCATAGCTCTTAAAC"
# the reverse complement of the U6 promoter's last 23 bases, read after
# the protospacer
PERTURB_U6_RC = "CGGTGTTTCGTCCTTTCCACAAG"
PERTURB_R2_LEN = 91
PERTURB_MAX_OFFSET = 31         # bases ahead of the prefix: 0-31
PERTURB_CARRY = (1, 2, 0)       # guides a cell carries, in these shares:
PERTURB_CARRY_SHARES = (0.70, 0.10, 0.20)
PERTURB_GUIDE_SPREAD = 1.0      # log-normal sigma of guide representation
PERTURB_GUIDE_UMIS = 50         # median UMIs of a carried guide
PERTURB_UMI_SPREAD = 0.3        # log-normal sigma of a carried guide's UMIs
PERTURB_AMBIENT = 2             # 0..2 ambient UMIs of random guides a cell
# guide reads: the prefix twice (the second copy before another guide),
# one substitution in the guide, an N in the prefix; the rest clean
PERTURB_READ_KINDS = ("clean", "double", "substitution", "n_prefix")
PERTURB_READ_SHARES = (None, 0.01, 0.02, 0.005)
PERTURB_AB_LEADER = CELLPLEX_TAG_LEADER   # the antibodies' 5P leader


def _perturb_guides(rng, n_guides: int) -> np.ndarray:
    """n_guides random PERTURB_GUIDE_LEN-base protospacers as ASCII rows,
    every two at least PERTURB_GUIDE_MIN_DIST apart on their last 16
    bases (the word both packages match on), so a substitution there
    corrects back to its own guide alone."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    tails = np.zeros((0, 16), np.uint8)
    out = []
    while len(out) < n_guides:
        for g in bases[rng.integers(0, 4, (n_guides, PERTURB_GUIDE_LEN))]:
            t = g[-16:]
            if len(out) == n_guides:
                break
            if len(tails) and (tails != t).sum(1).min() \
                    < PERTURB_GUIDE_MIN_DIST:
                continue
            out.append(g)
            tails = np.concatenate([tails, t[None]])
    return np.asarray(out)


def _perturb_library(rng, n_cells: int, n_guides: int):
    """The guides each cell carries and their UMIs: PERTURB_CARRY guides
    in PERTURB_CARRY_SHARES of the cells, drawn by a log-normal
    representation (a cell's two guides distinct), each
    Poisson(PERTURB_GUIDE_UMIS x lognormal) UMIs, at least one; plus 0 to
    PERTURB_AMBIENT ambient UMIs a cell of guides drawn by representation.
    Returns (carried guide [n_cells, 2], -1 where none; the (cell, guide)
    pairs with their UMIs, coalesced and sorted)."""
    n_kind = [round(n_cells * s) for s in PERTURB_CARRY_SHARES[:2]]
    n_kind.append(n_cells - sum(n_kind))
    carry = rng.permutation(np.repeat(PERTURB_CARRY, n_kind))
    rep = rng.lognormal(0.0, PERTURB_GUIDE_SPREAD, n_guides)
    p = rep / rep.sum()
    guide = np.full((n_cells, 2), -1, np.int64)
    one = np.flatnonzero(carry >= 1)
    guide[one, 0] = rng.choice(n_guides, len(one), p=p)
    two = np.flatnonzero(carry == 2)
    guide[two, 1] = rng.choice(n_guides, len(two), p=p)
    same = two[guide[two, 1] == guide[two, 0]]
    while len(same):
        guide[same, 1] = rng.choice(n_guides, len(same), p=p)
        same = same[guide[same, 1] == guide[same, 0]]
    cells, cols = np.nonzero(guide >= 0)
    umis = np.maximum(rng.poisson(PERTURB_GUIDE_UMIS * rng.lognormal(
        0.0, PERTURB_UMI_SPREAD, len(cells))), 1)
    n_amb = rng.integers(0, PERTURB_AMBIENT + 1, n_cells)
    amb_cell = np.repeat(np.arange(n_cells), n_amb)
    amb_guide = rng.choice(n_guides, len(amb_cell), p=p)
    key = np.concatenate([cells * n_guides + guide[cells, cols],
                          amb_cell * n_guides + amb_guide])
    cnt = np.concatenate([umis, np.ones(len(amb_cell), np.int64)])
    pairs, inv = np.unique(key, return_inverse=True)
    return guide, (pairs // n_guides, pairs % n_guides,
                   np.bincount(inv, weights=cnt).astype(np.int64))


def _perturb_r2(rng, guides: np.ndarray, guide: np.ndarray,
                kind: np.ndarray, ab_seqs: np.ndarray):
    """Guide R2 rows, PERTURB_R2_LEN bases: random bases, at an offset of
    0..PERTURB_MAX_OFFSET (0..11 for a doubled prefix) PERTURB_PREFIX and
    the read's guide, then PERTURB_U6_RC; kind "double" puts the prefix
    and another guide after the first copy, "substitution" changes one
    guide base (every position alike), "n_prefix" one prefix base to N.
    A read whose antibody window (the 15 bases after the 5P leader) lies
    within one base of an antibody is drawn again, so the antibodies'
    pattern, searched first, never takes a guide read.  Returns (rows,
    prefix offsets, substituted positions or -1)."""
    n, G = len(guide), len(guides)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pre = np.frombuffer(PERTURB_PREFIX.encode(), np.uint8)
    u6 = np.frombuffer(PERTURB_U6_RC.encode(), np.uint8)
    P, L, R = len(pre), PERTURB_GUIDE_LEN, PERTURB_R2_LEN
    double = kind == PERTURB_READ_KINDS.index("double")
    sub = kind == PERTURB_READ_KINDS.index("substitution")
    npre = kind == PERTURB_READ_KINDS.index("n_prefix")
    # rows drawn wide enough for everything placed, then cut to R bases
    W = R + 2 * (P + L) + len(u6)
    r2 = np.empty((n, R), np.uint8)
    off = np.zeros(n, np.int64)
    sub_pos = np.where(sub, rng.integers(0, L, n), -1)
    sub_by = rng.integers(1, 4, n)
    n_at = rng.integers(0, P, n)
    decoy = (guide + rng.integers(1, G, n)) % G
    todo = np.arange(n)
    while len(todo):
        t = todo
        buf = bases[rng.integers(0, 4, (len(t), W), dtype=np.uint8)]
        off[t] = np.where(double[t], rng.integers(0, R - 2 * (P + L) + 1,
                                                  len(t)),
                          rng.integers(0, PERTURB_MAX_OFFSET + 1, len(t)))
        o = off[t][:, None]
        rows = np.arange(len(t))[:, None]

        def put(start, seq, sel=slice(None)):
            buf[rows[sel], start + np.arange(seq.shape[-1])[None, :]] = seq

        g = guides[guide[t]]
        s = np.flatnonzero(sub[t])
        code = np.searchsorted(bases, g[s, sub_pos[t[s]]])
        g[s, sub_pos[t[s]]] = bases[(code + sub_by[t[s]]) % 4]
        put(o, pre)
        put(o + P, g)
        d = double[t]
        end = o + P + L + np.where(d, P + L, 0)[:, None]
        put(o[d] + P + L, pre, d)
        put(o[d] + 2 * P + L, guides[decoy[t[d]]], d)
        put(end, u6)
        m = np.flatnonzero(npre[t])
        buf[m, off[t[m]] + n_at[t[m]]] = ord("N")
        r2[t] = buf[:, :R]
        if not len(ab_seqs):
            break
        win = r2[t, PERTURB_AB_LEADER:PERTURB_AB_LEADER + ab_seqs.shape[1]]
        near = np.zeros(len(t), bool)
        C = 1 << 16
        for i in range(0, len(t), C):
            near[i:i + C] = ((win[i:i + C, None] != ab_seqs[None])
                             .sum(2) <= 1).any(1)
        todo = t[near]
    return r2, off, sub_pos


def build_perturb_run(tmp: str, n_cells: int = 10_000,
                      n_target_genes: int = 2_000,
                      n_nontargeting: int = 100,
                      gex_reads: int = 10_000_000,
                      guide_reads: int = 3_000_000,
                      n_antibodies: int = 17, ab_reads: int = 2_000_000,
                      seed: int = 43, *, n_wl: int = HUMAN_WL,
                      genome_len: int = E2E_GENOME_LEN,
                      n_genes: int = E2E_GENES,
                      n_types: int = CELLPLEX_TYPES) -> dict:
    """A Perturb-seq GEM well for `count`: Gene Expression on the e2e genome
    and genes (`_typed_gex`: n_types cell types with marker genes, drawn
    per cell), CRISPR Guide Capture of PERTURB_GUIDES_PER_GENE drawn
    20-base guides for each of n_target_genes genes plus n_nontargeting
    non-targeting guides (`_perturb_guides`; pattern PERTURB_PREFIX(BC) on
    R2, unanchored; the feature reference's target_gene_id and
    target_gene_name columns name the target, or Non-Targeting), and
    Antibody Capture of the first n_antibodies of CELLPLEX_AB_PANEL
    (`_cellplex_antibodies`, pattern 5PNNNNNNNNNN(BC), one read a
    molecule).  The antibody rows come first in the feature reference, so
    the antibodies' pattern is searched first in every read and the
    guides' pattern finds the guide: every guide read goes through the
    count's merge of patterns.

    n_cells barcodes of an n_wl-barcode whitelist are cells; their guides
    as `_perturb_library` plants them.  Guide reads: guide_reads over the
    guide molecules, each molecule at least one, the first read of a
    molecule never an n_prefix read; PERTURB_READ_SHARES of them doubled,
    substituted or N-prefixed (`_perturb_r2`).  UMIs are drawn once over
    the three libraries (`_coded_umis`), so no molecule of a cell shares
    its UMI with another and every planted molecule is counted.  2% of
    each library's reads carry a barcode error that corrects back.

    Returns the CountConfig inputs (ref, wl, feature_ref, fastq dirs and
    pairs), the read counts, the guides (id -> sequence, targets) and
    antibodies (id -> sequence) in the feature reference's order, the
    planted truth (`barcodes`, `cell_type`, `gex_molecules` [n_cells],
    `carried` [n_cells, 2] guide indices or -1, `guide_pairs` (cell,
    guide, UMIs), `ab_molecules` [n_cells, n_antibodies],
    `shared_umis`, 0 by construction), the guide reads in FASTQ order
    (`guide_read_kind` index into PERTURB_READ_KINDS, `guide_read_guide`,
    `guide_read_offset` of the guide, `guide_read_sub_pos` or -1) and
    `timing`, the host seconds of each part."""
    timing: dict = {}
    t = time.time()
    garr, spacing, _, ref_dir, _ = _e2e_reference(
        tmp, np.random.default_rng(11), genome_len, n_genes, None)
    timing["reference_s"] = time.time() - t

    t = time.time()
    rng = np.random.default_rng(seed)
    wl = _human_whitelist(rng, n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)
    cell_bc = wl[rng.choice(n_wl, n_cells, replace=False)]
    timing["whitelist_s"] = time.time() - t

    t = time.time()
    bases = np.frombuffer(b"ACGT", np.uint8)

    def random_types(rng):
        return np.repeat(rng.integers(0, n_types, n_cells)[:, None], 2, 1)

    cell_of, cell_type, cdna = _typed_gex(
        rng, garr, spacing, n_genes, n_types, n_cells, gex_reads, 1.0,
        random_types)
    n_mol = len(cell_of)
    n_guides = PERTURB_GUIDES_PER_GENE * n_target_genes + n_nontargeting
    guides = _perturb_guides(rng, n_guides)
    carried, (pair_cell, pair_guide, pair_umis) = _perturb_library(
        rng, n_cells, n_guides)
    g_cell = np.repeat(pair_cell, pair_umis)
    g_of = np.repeat(pair_guide, pair_umis)
    n_gmol = len(g_cell)
    assert guide_reads >= n_gmol, "fewer guide reads than guide molecules"
    ab_rng = np.random.default_rng((seed, 2))
    ab_names, ab_mol, _ = _cellplex_antibodies(
        ab_rng, n_antibodies, ab_reads, 0, np.zeros(n_cells, np.int64),
        cell_type)
    ab_flat = np.repeat(np.arange(n_cells * n_antibodies), ab_mol.ravel())
    ab_cell, ab_of = np.divmod(ab_flat, max(n_antibodies, 1))
    umi = bases[_coded_umis(np.concatenate([cell_of, g_cell, ab_cell]),
                            12, rng)]
    umi, g_umi, ab_umi = np.split(umi, [n_mol, n_mol + n_gmol])
    rep = lambda a: np.repeat(a, E2E_DUP, axis=0)  # noqa: E731
    gex_dir = _shuffled_reads(rng, rep(cell_bc[cell_of]), rep(umi), rep(cdna),
                              wl, tmp, "gex")
    del cdna, umi
    timing["gex_reads_s"] = time.time() - t

    t = time.time()
    ab_seqs = _cellplex_tags(n_antibodies, ab_rng)
    # each guide molecule's reads: one, and the rest spread evenly
    per_mol = 1 + np.bincount(rng.integers(0, n_gmol, guide_reads - n_gmol),
                              minlength=n_gmol)
    read_mol = np.repeat(np.arange(n_gmol), per_mol)
    first = np.r_[0, np.cumsum(per_mol)[:-1]]
    u = rng.random(guide_reads)
    kind = np.zeros(guide_reads, np.int64)
    edge = 0.0
    for k, share in enumerate(PERTURB_READ_SHARES[1:], 1):
        kind[(u >= edge) & (u < edge + share)] = k
        edge += share
    n_prefix = PERTURB_READ_KINDS.index("n_prefix")
    kind[first[kind[first] == n_prefix]] = 0
    r2, off, sub_pos = _perturb_r2(rng, guides, g_of[read_mol], kind,
                                   ab_seqs)
    guide_dir, order = _shuffled_library(
        rng, cell_bc[g_cell[read_mol]], g_umi[read_mol], r2, wl, tmp,
        "crispr")
    del r2
    timing["guide_reads_s"] = time.time() - t

    t = time.time()
    ab_dir = None
    if n_antibodies:
        ab_dir = _shuffled_reads(ab_rng, cell_bc[ab_cell], ab_umi,
                                 _feature_r2(ab_seqs[ab_of], ab_rng), wl,
                                 tmp, "ab")
    timing["ab_reads_s"] = time.time() - t

    targets = [f"TGT{k:04d}" for k in range(n_target_genes)]
    guide_ids = [f"{g}-{i + 1}" for g in targets
                 for i in range(PERTURB_GUIDES_PER_GENE)]
    guide_ids += [f"NT-{k + 1:03d}" for k in range(n_nontargeting)]
    guide_target = [g for g in targets
                    for _ in range(PERTURB_GUIDES_PER_GENE)]
    guide_target += ["Non-Targeting"] * n_nontargeting
    fref = os.path.join(tmp, "perturb_features.csv")
    with open(fref, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type,"
                "target_gene_id,target_gene_name\n")
        ab_pattern = f"5P{'N' * PERTURB_AB_LEADER}(BC)"
        for a, s in zip(ab_names, ab_seqs):
            f.write(f"{a},{a},R2,{ab_pattern},{s.tobytes().decode()},"
                    "Antibody Capture,,\n")
        for gid, s, tg in zip(guide_ids, guides, guide_target):
            f.write(f"{gid},{gid},R2,{PERTURB_PREFIX}(BC),"
                    f"{s.tobytes().decode()},CRISPR Guide Capture,{tg},"
                    f"{tg}\n")
    pair = lambda d, n: (os.path.join(d, f"{n}_S1_L001_R1_001.fastq"),  # noqa
                         os.path.join(d, f"{n}_S1_L001_R2_001.fastq"))
    libraries = [("Gene Expression", pair(gex_dir, "gex")),
                 ("CRISPR Guide Capture", pair(guide_dir, "crispr"))]
    if ab_dir is not None:
        libraries.append(("Antibody Capture", pair(ab_dir, "ab")))
    barcodes = [b.tobytes().decode() + "-1"
                for b in _unpack_barcodes(cell_bc)]
    return dict(
        ref=ref_dir, wl=wl_path, feature_ref=fref, libraries=libraries,
        n_wl=n_wl, n_cells=n_cells, gex_reads=n_mol * E2E_DUP,
        guide_reads=guide_reads, ab_reads=len(ab_flat),
        n_reads=n_mol * E2E_DUP + guide_reads + len(ab_flat),
        guides={i: s.tobytes().decode() for i, s in zip(guide_ids, guides)},
        guide_targets=guide_target,
        antibodies={a: s.tobytes().decode()
                    for a, s in zip(ab_names, ab_seqs)},
        barcodes=barcodes, cell_type=cell_type,
        gex_molecules=np.bincount(cell_of, minlength=n_cells),
        carried=carried, guide_pairs=(pair_cell, pair_guide, pair_umis),
        ab_molecules=ab_mol, shared_umis=0,
        guide_read_kind=kind[order], guide_read_guide=g_of[read_mol][order],
        guide_read_offset=off[order] + len(PERTURB_PREFIX),
        guide_read_sub_pos=sub_pos[order], timing=timing)


# ---------------------------------------------------------------------------
# A 3' well at a real depth: 10,000 cells at 10x's 20,000 reads a cell
# ---------------------------------------------------------------------------

DEPTH_READS = 200_000_000
DEPTH_CELLS = 10_000
DEPTH_SEED = 43
DEPTH_EXTRA_READS = 1.5     # a molecule's reads: 1 + Poisson(1.5)
DEPTH_HOT_GENE = 246        # a '+' gene with DEPTH_HOT_SHARE of the molecules,
DEPTH_HOT_SHARE = 0.08      # its reads in exon 1's 592 bases (as chrM's)
DEPTH_AMBIENT_PER_CELL = 10  # ambient barcodes a cell, 1-5 molecules each
DEPTH_AMBIENT_MOLECULES = 5  # from the soup: gene of rank k at 1 / k
DEPTH_LOW_SHARE = 0.2       # cells at DEPTH_LOW_WEIGHT of the others' depth:
DEPTH_LOW_WEIGHT = 0.07     # under ordmag's cutoff, called by EmptyDrops
DEPTH_ERROR_SHARE = 0.02    # of the reads; those of cells keep theirs
DEPTH_LANES = 4
DEPTH_WRITE_BLOCK = 1 << 20  # reads a worker makes and compresses at once
DEPTH_UMI_BLOCK = 1 << 20   # molecules of whole barcodes a _coded_umis call
DEPTH_ERROR_BLOCK = 1 << 19  # barcode errors drawn at once
DEPTH_NAME = 11             # read names D<10 digits>: the read's number


def build_depth_run(tmp: str, n_reads: int = DEPTH_READS,
                    n_cells: int = DEPTH_CELLS, n_wl: int = HUMAN_WL,
                    seed: int = DEPTH_SEED, block: int = DEPTH_WRITE_BLOCK,
                    workers: int | None = None, ref: dict | None = None,
                    n_ambient: int | None = None,
                    low_share: float = DEPTH_LOW_SHARE) -> dict:
    """An SC3Pv3 well whose counts hold by construction, at any depth:
    n_cells cells drawn from an n_wl-barcode whitelist (`_human_whitelist`;
    10x's 3M-february-2018 list has 6,794,880), reads from '+'-strand
    exon 1 of the e2e reference's genes (`_e2e_reference`: 8 Mb, one
    chromosome, 800 genes; `ref`: an e2e fixture's dict, whose files are
    reused), 91-base R2, R1 = barcode + 12-base UMI.

    Molecules get 1 + Poisson(1.5) reads, drawn until the reads number
    exactly n_reads; n_ambient ambient barcodes (DEPTH_AMBIENT_PER_CELL
    a cell by default) hold 1-5 molecules each from a soup whose genes
    fall off as 1 / rank (Simple Good-Turing, which estimates
    EmptyDrops' background, needs such a tail); the cells hold the rest,
    at one depth but for a low_share of them at DEPTH_LOW_WEIGHT of it;
    one gene (DEPTH_HOT_GENE) carries DEPTH_HOT_SHARE of the cells'
    molecules.  So cell calling finds the planted cells exactly where
    the deep cells hold ten times EmptyDrops' 500 UMIs: ordmag's
    bootstrap count of the barcodes above its cutoff varies by about
    sqrt(barcodes) / 10 around the deep cells and the low ones it takes,
    and EmptyDrops (which needs 90,000 barcodes with a molecule for its
    background) calls the cells it leaves, whose genes are not the
    soup's.  Without EmptyDrops (fewer barcodes) only a well of cells
    alone is called exactly (n_ambient=0, low_share=0).  UMIs come from
    `_coded_umis` a block of whole barcodes at a time, so no two
    molecules of a barcode merge; DEPTH_ERROR_SHARE of the reads are
    drawn for a barcode error, and those of cells keep one where
    `_human_barcode_errors` leaves it correctable to its own cell (a
    6.8M-barcode list puts a listed neighbour of a random error in reach
    of about one read in thirteen).  The reads are shuffled and written
    as gzipped FASTQs in DEPTH_LANES lanes (<tmp>/fastq/depth_S1_L00k_R*),
    each a gzip member a block of `block` reads made by one of `workers`
    spawned processes from the tables in <tmp>/_depth (memory maps), so
    no process holds the reads; the same reads for any block and worker
    count.

    Returns the paths, the counts and the truth: `cells` (whitelist
    indices of the planted cells, sorted) and the molecules sorted by
    (barcode, gene, UMI) as `mol_bc` (whitelist index), `mol_gene`,
    `mol_umi` (packed), `mol_reads`; fixture_s."""
    import multiprocessing as mp

    from ..ops.encode import pack_codes_np

    t0 = time.time()
    gen = os.path.join(tmp, "_depth")
    fq_dir = os.path.join(tmp, "fastq")
    os.makedirs(gen, exist_ok=True)
    os.makedirs(fq_dir, exist_ok=True)
    garr, spacing, _, ref_dir, _ = _e2e_reference(
        tmp, np.random.default_rng(11), E2E_GENOME_LEN, E2E_GENES, None, ref)
    rng = np.random.default_rng(seed)
    wl = _human_whitelist(rng, n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)
    n_amb = DEPTH_AMBIENT_PER_CELL * n_cells if n_ambient is None \
        else n_ambient
    slot_wl = rng.choice(n_wl, n_cells + n_amb, replace=False)

    # molecules: reads each, barcode slot (cells, then ambient), UMI
    draw = int(n_reads / (1 + DEPTH_EXTRA_READS) * 1.05) + 64
    counts = (1 + rng.poisson(DEPTH_EXTRA_READS, draw)).astype(np.int32)
    cs = np.cumsum(counts, dtype=np.int64)
    n_mol = int(np.searchsorted(cs, n_reads)) + 1
    if n_mol > draw:
        raise AssertionError("the draw of molecules fell short of n_reads")
    counts = counts[:n_mol]
    counts[-1] -= np.int32(cs[n_mol - 1] - n_reads)
    del cs
    amb = rng.integers(1, DEPTH_AMBIENT_MOLECULES + 1, n_amb)
    if amb.sum() >= n_mol:
        raise AssertionError("ambient molecules past the reads")
    weight = np.where(np.arange(n_cells) < n_cells - round(
        low_share * n_cells), 1.0, DEPTH_LOW_WEIGHT)
    per_cell = rng.multinomial(n_mol - int(amb.sum()),
                               weight / weight.sum())
    slot = np.concatenate([np.repeat(np.arange(n_cells), per_cell),
                           n_cells + np.repeat(np.arange(n_amb), amb)]
                          ).astype(np.int32)
    umi = np.empty(n_mol, np.uint32)
    a = 0
    while a < n_mol:
        b = int(np.searchsorted(slot, slot[min(a + DEPTH_UMI_BLOCK,
                                               n_mol - 1)], "right"))
        b = n_mol if a + DEPTH_UMI_BLOCK >= n_mol else b
        umi[a:b] = pack_codes_np(_coded_umis(slot[a:b] - slot[a], 12, rng),
                                 12)
        a = b
    plus = np.arange(0, E2E_GENES, 2)
    plus = plus[plus != DEPTH_HOT_GENE]
    gene = np.where(rng.random(n_mol) < DEPTH_HOT_SHARE, DEPTH_HOT_GENE,
                    rng.choice(plus, n_mol)).astype(np.int32)
    soup = slot >= n_cells
    zipf = 1.0 / np.arange(1, len(plus) + 1)
    gene[soup] = rng.choice(rng.permutation(plus), int(soup.sum()),
                            p=zipf / zipf.sum())
    pos = (gene * spacing + 1000
           + rng.integers(0, 600 - READ_LEN - 8, n_mol)).astype(np.int32)

    # reads: each molecule's, shuffled; barcode errors on the cells' reads
    mol_of_read = np.repeat(np.arange(n_mol, dtype=np.int32), counts)
    rng.shuffle(mol_of_read)
    slot_bc = wl[slot_wl]
    rows = np.sort(rng.choice(n_reads, int(n_reads * DEPTH_ERROR_SHARE),
                              replace=False))
    rows = rows[slot[mol_of_read[rows]] < n_cells]
    err_bc = slot_bc[slot[mol_of_read[rows]]]
    kept = []
    for e in range(0, len(rows), DEPTH_ERROR_BLOCK):
        part = err_bc[e:e + DEPTH_ERROR_BLOCK]
        kept.append(e + _human_barcode_errors(
            part, np.arange(len(part)), wl, rng))
    kept = np.concatenate(kept + [np.zeros(0, np.int64)])
    for name, arr in (("mol_of_read", mol_of_read), ("slot", slot),
                      ("slot_bc", slot_bc), ("umi", umi), ("pos", pos),
                      ("gene", gene),
                      ("err_rows", rows[kept]), ("err_bc", err_bc[kept]),
                      ("genome", garr)):
        np.save(os.path.join(gen, name + ".npy"), arr)
    del mol_of_read

    # the truth: molecules by (whitelist barcode, gene, UMI)
    counts_cells = int(counts[~soup].sum())
    mol_bc = slot_wl[slot].astype(np.uint32)
    order = np.lexsort((umi, gene, mol_bc))
    truth = dict(mol_bc=mol_bc[order], mol_gene=gene[order].astype(np.uint32),
                 mol_umi=umi[order], mol_reads=counts[order])
    del order, mol_bc, gene, pos, umi, slot, counts

    # FASTQs: lanes of blocks, made in spawned workers, written in order
    lanes = [(k * n_reads // DEPTH_LANES, (k + 1) * n_reads // DEPTH_LANES)
             for k in range(DEPTH_LANES)]
    pairs = [tuple(os.path.join(fq_dir, f"depth_S1_L{k + 1:03d}_{r}_001"
                                ".fastq.gz") for r in ("R1", "R2"))
             for k in range(DEPTH_LANES)]
    tasks = [(gen, k, a_, min(a_ + block, hi))
             for k, (lo, hi) in enumerate(lanes)
             for a_ in range(lo, hi, block)]
    workers = min(workers or min(8, os.cpu_count() or 1), len(tasks))
    files = [(open(p1, "wb"), open(p2, "wb")) for p1, p2 in pairs]
    try:
        with mp.get_context("spawn").Pool(workers) as pool:
            for (_, k, _, _), (z1, z2) in zip(
                    tasks, pool.imap(_depth_block, tasks)):
                files[k][0].write(z1)
                files[k][1].write(z2)
    finally:
        for f1, f2 in files:
            f1.close()
            f2.close()
    return dict(
        ref=ref_dir, wl=wl_path, fastq_dir=fq_dir, pairs=pairs, gen_dir=gen,
        n_reads=n_reads, n_molecules=n_mol, n_cells=n_cells,
        n_ambient=n_amb, n_wl=n_wl, hot_gene=DEPTH_HOT_GENE,
        ambient_reads=int(n_reads - counts_cells),
        cells=np.sort(slot_wl[:n_cells]).astype(np.int64),
        n_errors=int(len(kept)), fixture_s=time.time() - t0, **truth)


_DEPTH_TABLES: dict = {}


def _depth_tables(gen: str) -> dict:
    """The generator's tables, mapped once a worker process."""
    if gen not in _DEPTH_TABLES:
        _DEPTH_TABLES[gen] = {
            k: np.load(os.path.join(gen, k + ".npy"), mmap_mode="r")
            for k in ("mol_of_read", "slot", "slot_bc", "umi", "pos",
                      "err_rows", "err_bc", "genome")}
    return _DEPTH_TABLES[gen]


def depth_reads(gen: str, a: int, b: int) -> dict:
    """Reads a..b of a `build_depth_run` well as written: molecule, R1's
    packed barcode (its error in), names, R1 and R2 bases."""
    t = _depth_tables(gen)
    mol = np.asarray(t["mol_of_read"][a:b])
    bc = np.asarray(t["slot_bc"])[np.asarray(t["slot"])[mol]]
    er = np.asarray(t["err_rows"])
    lo, hi = np.searchsorted(er, [a, b])
    bc[er[lo:hi] - a] = np.asarray(t["err_bc"])[lo:hi]
    umi = np.asarray(t["umi"])[mol]
    r1 = np.concatenate([_unpack_barcodes(bc), _unpack_barcodes(umi, 12)], 1)
    r2 = np.asarray(t["genome"])[np.asarray(t["pos"])[mol][:, None]
                                 + np.arange(READ_LEN)[None, :]]
    idx = np.arange(a, b, dtype=np.int64)
    digits = (idx[:, None] // 10 ** np.arange(DEPTH_NAME - 2, -1, -1)) % 10
    names = np.concatenate([np.full((b - a, 1), ord("D"), np.uint8),
                            (digits + ord("0")).astype(np.uint8)], 1)
    return dict(mol=mol, bc=bc, umi=umi, names=names, r1=r1, r2=r2)


def _named_fastq(names: np.ndarray, seqmat: np.ndarray) -> bytes:
    """FASTQ text of [n, w] base bytes with the [n, k] name bytes, 'F'
    qualities."""
    n_, w_ = seqmat.shape
    k = names.shape[1]
    rows = np.empty((n_, k + 2 * w_ + 6), np.uint8)
    rows[:, 0] = ord("@")
    rows[:, 1:k + 1] = names
    rows[:, k + 1] = ord("\n")
    rows[:, k + 2:k + 2 + w_] = seqmat
    o = k + 2 + w_
    rows[:, o] = ord("\n")
    rows[:, o + 1] = ord("+")
    rows[:, o + 2] = ord("\n")
    rows[:, o + 3:o + 3 + w_] = ord("F")
    rows[:, -1] = ord("\n")
    return rows.tobytes()


def _depth_block(task) -> tuple[bytes, bytes]:
    """One block of a lane: (R1, R2) as gzip members (level 1)."""
    gen, _lane, a, b = task
    r = depth_reads(gen, a, b)
    return (gzip.compress(_named_fastq(r["names"], r["r1"]), 1, mtime=0),
            gzip.compress(_named_fastq(r["names"], r["r2"]), 1, mtime=0))


# ---------------------------------------------------------------------------
# A multiplexed Flex well: 16 samples in one GEM well, told apart by the
# probe barcode on R2
# ---------------------------------------------------------------------------

FLEX_READS = 160_000_000     # 10x's 10,000 read pairs a cell
FLEX_CELLS = 16_000          # 16 samples of 1,000 cells
FLEX_GEL_BEADS = 15_000      # the cells' beads: ~10,000 of them used
FLEX_SEED = 59
FLEX_EXTRA_READS = 0.3       # a molecule's reads: 1 + Poisson(0.3)
FLEX_AMBIENT_PER_CELL = 30   # ambient product barcodes a cell, 1-5 molecules
FLEX_LOW_SHARE = 0.2         # cells at FLEX_LOW_WEIGHT of the others' depth:
FLEX_LOW_WEIGHT = 0.08       # under ordmag's cutoff, called by EmptyDrops
FLEX_HOT_GENE = 7            # a gene with FLEX_HOT_SHARE of the cells'
FLEX_HOT_SHARE = 0.08        # molecules
FLEX_MIN_SHARED = 0.30       # cells sharing their bead with another sample
# a read's probe barcode: its own; one base off (assigned); two bases off
# its own and at least two off every listed one, or a random 8-mer at least
# two off every listed one (both dropped by assign_probe_bcs)
FLEX_PBC_KINDS = ("exact", "one_mm", "two_mm", "off_list")
FLEX_PBC_SHARES = (0.95, 0.03, 0.01, 0.01)
FLEX_PBC_BLOCK = 1 << 24     # reads whose probe barcode is drawn at once
FLEX_NAME = 11               # read names F<10 digits>: the read's number
_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9),
        np.uint64(0x94D049BB133111EB))


def _mix64(x) -> np.ndarray:
    """splitmix64 of each value: the draws a FASTQ block makes for a
    molecule or a read, the same whichever block makes them."""
    z = np.asarray(x, np.uint64) + _MIX[0]
    z = (z ^ (z >> np.uint64(30))) * _MIX[1]
    z = (z ^ (z >> np.uint64(27))) * _MIX[2]
    return z ^ (z >> np.uint64(31))


def probe_bc_distances(codes: np.ndarray, listed: np.ndarray) -> np.ndarray:
    """Mismatched bases [n, P] between packed 8-base probe barcodes and
    each listed one."""
    x = codes.astype(np.uint32)[:, None] ^ listed.astype(np.uint32)[None, :]
    g = (x | (x >> 1)) & np.uint32(0x5555)
    return np.unpackbits(g.astype(">u2").view(np.uint8).reshape(
        *g.shape, 2), axis=-1).sum(-1)


def _flex_probe_bcs(own: np.ndarray, kind: np.ndarray, listed: np.ndarray,
                    rng) -> np.ndarray:
    """The packed probe barcode each read carries (FLEX_PBC_KINDS)."""
    out = own.astype(np.uint16)
    sel = np.flatnonzero(kind == 1)
    pos = rng.integers(0, 8, len(sel)).astype(np.uint16)
    out[sel] ^= (rng.integers(1, 4, len(sel)).astype(np.uint16)
                 << (2 * (7 - pos)))
    for k in (2, 3):
        todo = np.flatnonzero(kind == k)
        while len(todo):
            if k == 2:
                p1 = rng.integers(0, 8, len(todo))
                p2 = (p1 + rng.integers(1, 8, len(todo))) % 8
                new = own[todo].astype(np.uint16)
                for p in (p1, p2):
                    new ^= (rng.integers(1, 4, len(todo)).astype(np.uint16)
                            << (2 * (7 - p)).astype(np.uint16))
            else:
                new = rng.integers(0, 1 << 16, len(todo)).astype(np.uint16)
            ok = probe_bc_distances(new, listed).min(1) >= 2
            out[todo[ok]] = new[ok]
            todo = todo[~ok]
    return out


def build_flex_run(tmp: str, n_reads: int = FLEX_READS,
                   n_cells: int = FLEX_CELLS, n_wl: int = VDJ_WL_5P,
                   n_gel: int = FLEX_GEL_BEADS,
                   n_probes: int = RTL_PROBES, n_genes: int = RTL_GENES,
                   samples: list | None = None,
                   n_ambient: int | None = None,
                   low_share: float = FLEX_LOW_SHARE, seed: int = FLEX_SEED,
                   block: int = DEPTH_WRITE_BLOCK,
                   workers: int | None = None) -> dict:
    """A multiplexed Fixed RNA Profiling well (MFRP-RNA) whose counts hold
    by construction, at any depth: n_cells cells, n_cells / 16 on each of
    the 16 probe barcodes of `rtl_probe_barcodes` (BC001-BC016, stand-ins
    for 10x's list), each cell on a gel bead drawn from n_gel beads of an
    n_wl-barcode whitelist (`_human_whitelist`; 10x's
    737K-fixed-rna-profiling list has 737,280), the beads of one probe
    barcode distinct, so that cells of several samples share a bead and
    only the probe barcode tells them apart.  The probe set is
    `build_rtl_run`'s: n_probes 50-base probes over n_genes genes, every
    20th excluded, every 3rd probe's region unspliced.  R1 = bead
    barcode + 12-base UMI; R2 = 50 probe bases, 18 filler bases, the
    8-base probe barcode.

    Molecules get 1 + Poisson(FLEX_EXTRA_READS) reads, drawn until the
    reads number exactly n_reads; n_ambient ambient product barcodes
    (FLEX_AMBIENT_PER_CELL a cell by default: with 16 probe barcodes
    EmptyDrops takes its background from the barcodes ranked 360,000 to
    720,000) hold 1-5 molecules each from a soup whose genes fall off as
    1 / rank; the cells hold the rest, at one depth but for a low_share
    of them at FLEX_LOW_WEIGHT of it, and one gene (FLEX_HOT_GENE) has
    FLEX_HOT_SHARE of their molecules.  A molecule's kind is drawn in
    RTL_SHARES (`build_rtl_run`: exact, one mismatch, rescued by the
    other half, on an excluded probe, junk); a read's probe barcode in
    FLEX_PBC_SHARES (FLEX_PBC_KINDS).  UMIs come from `_coded_umis` a
    block of whole product barcodes at a time, so no two molecules of a
    product barcode merge.  So cell calling finds the planted cells
    exactly, as `build_depth_run`'s does: the deep cells hold about ten
    times EmptyDrops' 500 UMIs, ordmag takes them and some of the low
    ones, EmptyDrops the rest.  With few barcodes (no EmptyDrops) only a
    well of cells alone is called exactly (n_ambient=0, low_share=0).

    The reads are shuffled and written as gzipped FASTQs in DEPTH_LANES
    lanes (<tmp>/fastq/flex_S1_L00k_R*), each a gzip member a block of
    `block` reads made by one of `workers` spawned processes from the
    tables in <tmp>/_flex (memory maps): no process holds the reads, and
    the bytes are the same for any block and worker count.  <tmp>/multi.csv
    is the `multi` config: the probe set, the probe barcodes, MFRP-RNA,
    one Gene Expression library and a [samples] row for each entry of
    `samples` ('|'-joined probe barcode ids; one sample a probe barcode
    by default).

    Returns the paths and the truth: `cells` ({sample: product barcode
    names, sorted}), `assignments` ({cell name: its sample, or
    'unassigned'}), the molecules sorted by (product barcode, gene, UMI)
    as `mol_bc` (the product index: whitelist rank * 16 + probe barcode
    rank), `mol_gene`, `mol_umi` (packed), `mol_reads` (the reads whose
    probe barcode is assigned), `expected` (the run's read and molecule
    metrics), `cell_index` ({cell name: product index}), `pbc_reads`
    (reads of each FLEX_PBC_KINDS), the beads, the
    share of cells on a shared bead, fixture_s and fastq_bytes."""
    import multiprocessing as mp

    from ..ops.encode import pack_codes_np

    t0 = time.time()
    gen = os.path.join(tmp, "_flex")
    fq_dir = os.path.join(tmp, "fastq")
    os.makedirs(gen, exist_ok=True)
    os.makedirs(fq_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)

    # the probe set and the probe barcodes, as build_rtl_run writes them
    codes, slot_pos = _rtl_probe_codes(n_probes, rng)
    probe_gene = (np.arange(n_probes) * n_genes // n_probes).astype(np.int32)
    included = np.arange(n_probes) % RTL_EXCLUDED_EVERY != 0
    unspliced = np.arange(n_probes) % 3 == 0
    pcsv = os.path.join(tmp, "probes.csv")
    seq_txt = bases[codes].view(f"S{RTL_PROBE_LEN}").ravel()
    with open(pcsv, "w") as f:
        f.write("#probe_set_file_format=1.0\n#panel_name=synthetic "
                "whole transcriptome\n#reference_genome=synth\n")
        f.write("gene_id,probe_seq,probe_id,included,region\n")
        f.writelines(
            f"GENE{g:05d},{s.decode()},GENE{g:05d}|p{i},"
            f"{'TRUE' if inc else 'FALSE'},"
            f"{'unspliced' if u else 'spliced'}\n"
            for i, (g, s, inc, u) in enumerate(zip(
                probe_gene.tolist(), seq_txt.tolist(), included.tolist(),
                unspliced.tolist())))
    pbcs = rtl_probe_barcodes()
    n_pbc = len(pbcs)
    ids = [f"BC{i + 1:03d}" for i in range(n_pbc)]
    pbc_csv = os.path.join(tmp, "probe_barcodes.csv")
    with open(pbc_csv, "w") as f:
        f.write("id,sequence\n")
        f.writelines(f"{i},{s}\n" for i, s in zip(ids, pbcs))
    pbc_codes = np.asarray([[b"ACGT".index(c) for c in s.encode()]
                            for s in pbcs], np.uint8)
    pbc_packed = pack_codes_np(pbc_codes, 8).astype(np.uint16)
    wl = _human_whitelist(rng, n_wl)
    wl_path = os.path.join(tmp, "wl.txt")
    _write_whitelist(wl_path, wl)

    # cells: n_cells / 16 on each probe barcode, each on its own bead of
    # the pool; ambient product barcodes: any bead, any probe barcode
    if n_cells % n_pbc:
        raise ValueError(f"n_cells must be a multiple of {n_pbc}")
    per_pbc = n_cells // n_pbc
    bead_wl = rng.choice(n_wl, n_gel, replace=False)
    cell_bead = np.concatenate([rng.choice(n_gel, per_pbc, replace=False)
                                for _ in range(n_pbc)])
    cell_pbc = np.repeat(np.arange(n_pbc), per_pbc)
    cell_prod = bead_wl[cell_bead].astype(np.int64) * n_pbc + cell_pbc
    n_amb = FLEX_AMBIENT_PER_CELL * n_cells if n_ambient is None \
        else n_ambient
    amb = rng.choice(n_wl * n_pbc, n_amb + n_cells, replace=False)
    amb = amb[~np.isin(amb, cell_prod)][:n_amb]
    slot_prod = np.concatenate([cell_prod, amb])
    cells_on_bead = np.bincount(cell_bead, minlength=n_gel)
    shared = float((cells_on_bead[cell_bead] > 1).mean())

    # molecules: reads each, product slot (cells, then ambient), UMI,
    # kind, probe
    draw = int(n_reads / (1 + FLEX_EXTRA_READS) * 1.05) + 64
    counts = (1 + rng.poisson(FLEX_EXTRA_READS, draw)).astype(np.int32)
    cs = np.cumsum(counts, dtype=np.int64)
    n_mol = int(np.searchsorted(cs, n_reads)) + 1
    if n_mol > draw:
        raise AssertionError("the draw of molecules fell short of n_reads")
    counts = counts[:n_mol]
    counts[-1] -= np.int32(cs[n_mol - 1] - n_reads)
    del cs
    amb_mol = rng.integers(1, DEPTH_AMBIENT_MOLECULES + 1, n_amb)
    if amb_mol.sum() >= n_mol:
        raise AssertionError("ambient molecules past the reads")
    weight = np.where(np.arange(n_cells) % round(1 / low_share) == 0,
                      FLEX_LOW_WEIGHT, 1.0) if low_share else \
        np.ones(n_cells)
    per_cell = rng.multinomial(n_mol - int(amb_mol.sum()),
                               weight / weight.sum())
    slot = np.concatenate([np.repeat(np.arange(n_cells), per_cell),
                           n_cells + np.repeat(np.arange(n_amb), amb_mol)]
                          ).astype(np.int32)
    umi = np.empty(n_mol, np.uint32)
    a = 0
    while a < n_mol:
        b = int(np.searchsorted(slot, slot[min(a + DEPTH_UMI_BLOCK,
                                               n_mol - 1)], "right"))
        b = n_mol if a + DEPTH_UMI_BLOCK >= n_mol else b
        umi[a:b] = pack_codes_np(_coded_umis(slot[a:b] - slot[a],
                                             RTL_UMI_LEN, rng), RTL_UMI_LEN)
        a = b
    kind = rng.choice(len(RTL_KINDS), n_mol, p=RTL_SHARES).astype(np.uint8)
    inc_idx, exc_idx = np.flatnonzero(included), np.flatnonzero(~included)
    probe = inc_idx[rng.integers(0, len(inc_idx), n_mol)].astype(np.int32)
    is_exc = kind == RTL_KINDS.index("excluded")
    probe[is_exc] = exc_idx[rng.integers(0, len(exc_idx), int(is_exc.sum()))]

    def probe_of(genes):
        """A random included probe of each gene."""
        lo = np.searchsorted(probe_gene[inc_idx], genes, "left")
        hi = np.searchsorted(probe_gene[inc_idx], genes, "right")
        return inc_idx[lo + (rng.random(len(genes)) * (hi - lo)).astype(
            np.int64)].astype(np.int32)

    soup = slot >= n_cells
    hot = ~soup & ~is_exc & (rng.random(n_mol) < FLEX_HOT_SHARE)
    probe[hot] = probe_of(np.full(int(hot.sum()), FLEX_HOT_GENE))
    genes = np.unique(probe_gene[inc_idx])
    zipf = 1.0 / np.arange(1, len(genes) + 1)
    sel = soup & ~is_exc
    probe[sel] = probe_of(rng.choice(rng.permutation(genes), int(sel.sum()),
                                     p=zipf / zipf.sum()))
    del hot, sel

    # reads: each molecule's, shuffled; each read's probe barcode
    mol_of_read = np.repeat(np.arange(n_mol, dtype=np.int32), counts)
    rng.shuffle(mol_of_read)
    slot_pbc = (slot_prod % n_pbc).astype(np.uint8)
    pbc_read = np.empty(n_reads, np.uint16)
    pbc_kind_reads = np.zeros(len(FLEX_PBC_KINDS), np.int64)
    good_reads = np.zeros(n_mol, np.int32)
    for a in range(0, n_reads, FLEX_PBC_BLOCK):
        mol = mol_of_read[a:a + FLEX_PBC_BLOCK]
        pk = rng.choice(len(FLEX_PBC_KINDS), len(mol),
                        p=FLEX_PBC_SHARES).astype(np.uint8)
        own = pbc_packed[slot_pbc[slot[mol]]]
        pbc_read[a:a + len(mol)] = _flex_probe_bcs(own, pk, pbc_packed, rng)
        pbc_kind_reads += np.bincount(pk, minlength=len(FLEX_PBC_KINDS))
        good_reads += np.bincount(mol[pk <= 1], minlength=n_mol).astype(
            np.int32)
    slot_bc = wl[slot_prod // n_pbc]
    for name, arr in (("mol_of_read", mol_of_read), ("slot", slot),
                      ("slot_bc", slot_bc), ("umi", umi), ("kind", kind),
                      ("probe", probe), ("pbc_read", pbc_read),
                      ("codes", codes), ("slot_pos", slot_pos)):
        np.save(os.path.join(gen, name + ".npy"), arr)
    del mol_of_read, pbc_read

    # the truth: molecules of a usable kind with an assigned read, by
    # (product barcode, gene, UMI); the run's metrics
    usable = kind <= RTL_KINDS.index("rescued")
    keep = usable & (good_reads > 0)
    mol_bc = slot_prod[slot[keep]].astype(np.uint32)
    mol_gene = probe_gene[probe[keep]].astype(np.uint32)
    mol_umi, mol_reads = umi[keep], good_reads[keep]
    order = np.lexsort((mol_umi, mol_gene, mol_bc))
    truth = dict(mol_bc=mol_bc[order], mol_gene=mol_gene[order],
                 mol_umi=mol_umi[order], mol_reads=mol_reads[order])
    del mol_bc, mol_gene, mol_umi, mol_reads, order
    uns = unspliced[probe]
    expected = dict(
        total_reads=n_reads,
        mapped_reads=int(counts[usable | is_exc].sum()),
        conf_mapped_reads=int(counts[usable].sum()),
        usable_reads=int(good_reads[usable].sum()),
        probe_reads_spliced=int(good_reads[usable & ~uns].sum()),
        probe_reads_unspliced=int(good_reads[usable & uns].sum()),
        total_molecules=int(keep.sum()))
    del kind, probe, umi, slot, counts, good_reads, usable, keep, uns

    # the samples and their cells, as product barcode names
    rows = samples or ids
    pbc_sample = {p: f"S{i + 1:02d}" for i, r in enumerate(rows)
                  for p in r.split("|")}
    names = barcode_product_names(wl, cell_prod, pbcs)
    cells: dict = {}
    assignments = {}
    for nm, p in zip(names, cell_pbc.tolist()):
        s = pbc_sample.get(ids[p], "unassigned")
        assignments[nm] = s
        if s != "unassigned":
            cells.setdefault(s, []).append(nm)
    cells = {s: sorted(v) for s, v in sorted(cells.items())}
    csv = os.path.join(tmp, "multi.csv")
    with open(csv, "w") as f:
        f.write(f"[gene-expression]\nprobe-set,{pcsv}\n"
                f"probe-barcode-set,{pbc_csv}\nchemistry,MFRP-RNA\n"
                "[libraries]\nfastq_id,fastqs,feature_types\n"
                f"flex,{fq_dir},Gene Expression\n"
                "[samples]\nsample_id,probe_barcode_ids\n")
        f.writelines(f"S{i + 1:02d},{r}\n" for i, r in enumerate(rows))

    # FASTQs: lanes of blocks, made in spawned workers, written in order
    lanes = [(k * n_reads // DEPTH_LANES, (k + 1) * n_reads // DEPTH_LANES)
             for k in range(DEPTH_LANES)]
    pairs = [tuple(os.path.join(fq_dir, f"flex_S1_L{k + 1:03d}_{r}_001"
                                ".fastq.gz") for r in ("R1", "R2"))
             for k in range(DEPTH_LANES)]
    tasks = [(gen, k, a_, min(a_ + block, hi), seed)
             for k, (lo, hi) in enumerate(lanes)
             for a_ in range(lo, hi, block)]
    workers = min(workers or min(8, os.cpu_count() or 1), len(tasks))
    files = [(open(p1, "wb"), open(p2, "wb")) for p1, p2 in pairs]
    try:
        with mp.get_context("spawn").Pool(workers) as pool:
            for (_, k, _, _, _), (z1, z2) in zip(
                    tasks, pool.imap(_flex_block, tasks)):
                files[k][0].write(z1)
                files[k][1].write(z2)
    finally:
        for f1, f2 in files:
            f1.close()
            f2.close()
    return dict(
        csv=csv, wl=wl_path, probes=pcsv, probe_barcodes=pbc_csv,
        fastq_dir=fq_dir, pairs=pairs, gen_dir=gen, n_reads=n_reads,
        n_molecules=expected["total_molecules"], n_cells=n_cells,
        n_ambient=n_amb, n_wl=n_wl, n_probe_bcs=n_pbc, samples=rows,
        cells=cells, assignments=assignments,
        cell_index=dict(zip(names, cell_prod.tolist())), expected=expected,
        pbc_reads=dict(zip(FLEX_PBC_KINDS, pbc_kind_reads.tolist())),
        beads_used=int((cells_on_bead > 0).sum()), shared_bead_share=shared,
        fixture_s=time.time() - t0,
        fastq_bytes=sum(os.path.getsize(p) for pr in pairs for p in pr),
        **truth)


def barcode_product_names(wl: np.ndarray, prod: np.ndarray,
                          pbcs: list[str]) -> list[str]:
    """Names of product barcodes (whitelist rank * len(pbcs) + probe
    barcode rank) as the count pipeline writes them: bead barcode, probe
    barcode, '-1'."""
    beads = _unpack_barcodes(wl[np.asarray(prod) // len(pbcs)])
    tails = np.asarray([list(f"{p}-1".encode()) for p in pbcs],
                       np.uint8)[np.asarray(prod) % len(pbcs)]
    return [r.decode() for r in np.ascontiguousarray(np.concatenate(
        [beads, tails], 1)).view(f"S{16 + tails.shape[1]}").ravel()]


_FLEX_TABLES: dict = {}


def _flex_tables(gen: str) -> dict:
    """The generator's tables, mapped once a worker process."""
    if gen not in _FLEX_TABLES:
        _FLEX_TABLES[gen] = {
            k: np.load(os.path.join(gen, k + ".npy"), mmap_mode="r")
            for k in ("mol_of_read", "slot", "slot_bc", "umi", "kind",
                      "probe", "pbc_read", "codes", "slot_pos")}
    return _FLEX_TABLES[gen]


def flex_reads(gen: str, a: int, b: int, seed: int = FLEX_SEED) -> dict:
    """Reads a..b of a `build_flex_run` well as written: molecule, names,
    R1 and R2 bases.  A molecule's probe bases are its probe's with the
    substitutions of its kind (as `build_rtl_run` makes them), drawn
    from a hash of the molecule's number; the filler from one of the
    read's."""
    t = _flex_tables(gen)
    mol = np.asarray(t["mol_of_read"][a:b])
    slot = np.asarray(t["slot"])[mol]
    r1 = np.concatenate([_unpack_barcodes(np.asarray(t["slot_bc"])[slot]),
                         _unpack_barcodes(np.asarray(t["umi"])[mol],
                                          RTL_UMI_LEN)], 1)
    seq = np.asarray(t["codes"])[np.asarray(t["probe"])[mol]]
    kind = np.asarray(t["kind"])[mol]
    slot_pos = np.asarray(t["slot_pos"])
    h = _mix64((np.uint64(seed) << np.uint64(40)) ^ mol.astype(np.uint64))
    rows = np.arange(len(mol))

    def bump(sel, pos, shift):
        d = ((h[sel] >> np.uint64(shift)) & np.uint64(15)) % np.uint64(3)
        seq[sel, pos] = (seq[sel, pos] + 1 + d.astype(np.uint8)) % 4

    sel = rows[kind == RTL_KINDS.index("one_mm")]
    bump(sel, (h[sel] % np.uint64(RTL_PROBE_LEN)).astype(np.int64), 8)
    sel = rows[kind == RTL_KINDS.index("rescued")]
    half = ((h[sel] >> np.uint64(16)) & np.uint64(1)).astype(np.int64)
    copy = (((h[sel] >> np.uint64(17)) & np.uint64(3)) % np.uint64(3)
            ).astype(np.int64)
    for k in range(3):              # digits k or k+3 of the chosen copy
        pick = ((h[sel] >> np.uint64(20 + k)) & np.uint64(1)).astype(np.int64)
        bump(sel, slot_pos[half, 8 * copy + pick * 3 + k], 24 + 4 * k)
    sel = rows[kind == RTL_KINDS.index("junk")]
    for i, (hh, sl) in enumerate((hh, sl) for hh in range(2)
                                 for sl in (8, 9, 18, 19)):
        bump(sel, np.full(len(sel), slot_pos[hh, sl]), 36 + 3 * i)
    idx = np.arange(a, b, dtype=np.uint64)
    hf = _mix64((np.uint64(seed + 1) << np.uint64(40)) ^ idx)
    filler = ((hf[:, None] >> (2 * np.arange(18, dtype=np.uint64))[None, :])
              & np.uint64(3)).astype(np.uint8)
    pbc = _unpack_barcodes(np.asarray(t["pbc_read"][a:b]).astype(np.uint32),
                           8)
    r2 = np.concatenate([np.frombuffer(b"ACGT", np.uint8)[seq],
                         np.frombuffer(b"ACGT", np.uint8)[filler], pbc], 1)
    digits = (idx.astype(np.int64)[:, None]
              // 10 ** np.arange(FLEX_NAME - 2, -1, -1)) % 10
    names = np.concatenate([np.full((b - a, 1), ord("F"), np.uint8),
                            (digits + ord("0")).astype(np.uint8)], 1)
    return dict(mol=mol, names=names, r1=r1, r2=r2)


def _flex_block(task) -> tuple[bytes, bytes]:
    """One block of a lane: (R1, R2) as gzip members (level 1)."""
    gen, _lane, a, b, seed = task
    r = flex_reads(gen, a, b, seed)
    return (gzip.compress(_named_fastq(r["names"], r["r1"]), 1, mtime=0),
            gzip.compress(_named_fastq(r["names"], r["r2"]), 1, mtime=0))
