"""The port's BAM writer (pipeline/bam_out.py `write`: the native record
encoder of native/bam_host.py and io/bam_fast.py's threaded BGZF and
array-built index) against its plain version (`write_plain`: every record
through `_write_rows` and the copy's IndexingBamWriter), at tolerance 0:
the .bam and .bai bytes.

  * seeded synthetic bands that reach every branch of `_write_rows` and
    `write_record` (unmapped, feature reads with each FB tag empty or
    not, low-support reads, UMI_COUNT winners and their duplicates,
    secondary records, annotated splices, novel junctions,
    gene-discordant reads, mates, strand 1, N bases, odd and even
    lengths, repeated genes, '-' strand transcripts, a transcript on
    another chromosome), one of their records ending exactly on a
    60,000-byte block boundary;
  * whole runs: the e2e fixture at 30,000 reads, the rich run (GEX and
    antibodies), a paired-end run, and a run of two hosts whose spools
    host 0 merges (`sibling_dirs`);
  * the linear join of a band's chunks and the representatives' join,
    each against the form it replaced;
  * the native build raising, and the run's path never reaching the
    plain writer.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from cellranger_tpu_torch.io import bam_index
from cellranger_tpu_torch.io.bam_read import read_bam
from cellranger_tpu_torch.native import bam_host
from cellranger_tpu_torch.pipeline import bam_out
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing import fixtures
from cellranger_tpu_torch.testing.multihost_worker import launch

BAM = "possorted_genome_bam.bam"
W = 61          # read plane width: odd, so odd and even lengths both occur
BC_LEN, UMI_LEN = 16, 12

# four chromosomes, reads on chr1 and chr2 only (chrUn and chrY have no
# record, so the .bai holds 0 bins for them); gene 0 has a '+' and a '-'
# transcript sharing an exon, gene 1 lies on chr2, gene 3 has no
# transcript, gene 4 overlaps gene 0
GI = SimpleNamespace(chrom_names=["chr1", "chrUn", "chr2", "chrY"],
                     chrom_starts=np.array([0, 200_000, 250_000, 350_000,
                                            400_000]))
_TX = [("TA", 0, "chr1", "+", [(1000, 1200), (1500, 1700), (2000, 2300)]),
       ("TB", 0, "chr1", "-", [(1000, 1200), (2000, 2300)]),
       ("TC", 1, "chr2", "+", [(500, 900)]),
       ("TD", 2, "chr1", "-", [(5000, 5300), (5600, 5800)]),
       ("TE", 4, "chr1", "+", [(1000, 1300)]),
       ("TF", 5, "chr2", "-", [(400, 700)])]
TXOME = SimpleNamespace(
    genes=[SimpleNamespace(id=f"ENSG{g:05d}", name=f"Gene{g}")
           for g in range(6)],
    transcripts=[SimpleNamespace(id=i, gene_index=g, chrom=c, strand=s,
                                 exons=e) for i, g, c, s, e in _TX])
# (chrom, first, last) genomic starts the reads are drawn around
ANCHORS = [(0, 990, 1230), (0, 1480, 1720), (0, 1950, 2300),
           (0, 4990, 5800), (2, 390, 900), (0, 50_000, 150_000)]


def _chunk(rng, first: int, n: int, pad: dict) -> dict:
    """n seeded records of every kind; names r<first + k>, lengthened by
    pad[name] bytes."""
    z = lambda dt=np.int64: np.zeros(n, dt)  # noqa: E731
    kind = rng.choice(4, n, p=[0.55, 0.1, 0.15, 0.2])  # mapped, sec, unm, fb
    mapped = kind < 2
    L = np.where(rng.random(n) < 0.85, rng.integers(W - 12, W + 1, n),
                 rng.integers(0, W + 1, n))
    alen = np.minimum(L, rng.integers(20, W + 1, n))
    astart = np.where(rng.random(n) < 0.3,
                      rng.integers(0, 8, n), 0)
    astart = np.minimum(astart, np.maximum(L - alen, 0))
    anchor = rng.integers(0, len(ANCHORS), n)
    chrom = np.array([ANCHORS[a][0] for a in anchor], np.int32)
    lo = np.array([ANCHORS[a][1] for a in anchor])
    hi = np.array([ANCHORS[a][2] for a in anchor])
    gpos = rng.integers(lo, hi)
    # annotated splices: an intron of 300 (TA's first) or 800 (TB's)
    spliced = mapped & (rng.random(n) < 0.2) & (alen >= 2)
    intron = np.where(spliced, rng.choice([0, 300, 800], n), 0)
    donor = np.where(spliced, rng.integers(1, np.maximum(alen, 2)), 0)
    gpos = np.where(spliced & (intron > 0), 1200 - donor, gpos)
    chrom = np.where(spliced & (intron > 0), 0, chrom).astype(np.int32)
    novel = mapped & ~(spliced & (intron > 0)) & (rng.random(n) < 0.1)
    right = np.where(novel, rng.integers(5, 20, n), 0)
    L = np.where(novel, np.minimum(W, np.maximum(L, astart + alen + right)),
                 L)
    right = np.where(novel, np.minimum(right, L - astart - alen), 0)
    sj_donor = np.where(novel, rng.integers(10_000, 20_000, n), 0)
    sj_acceptor = sj_donor + np.where(novel, rng.integers(50, 5000, n), 0)
    gl_pool = np.array([-1, 0, 0, 1, 2, 3, 4, 5])
    gene_list = rng.choice(gl_pool, (n, 4)).astype(np.int32)
    gene_list[rng.random(n) < 0.2] = -1
    anti_list = np.where(rng.random((n, 4)) < 0.7, -1,
                         rng.choice(gl_pool, (n, 4))).astype(np.int32)
    paired = rng.random(n) < 0.3
    pair_flag = np.where(paired, 1 | 2 | rng.choice([64, 128], n)
                         | rng.choice([0, 32], n), 0)
    names = [b"r%06d" % (first + k) for k in range(n)]
    names = [nm + b"x" * pad.get(nm, 0) for nm in names]
    feature = kind == 3

    def fbs():
        return [b"" if rng.random() < 0.4 else
                rng.choice(list(b"ACGTN"), rng.integers(1, 16))
                .astype(np.uint8).tobytes()
                for _ in range(n)]

    strings = {k: [s if f else b"" for s, f in zip(fbs(), feature)]
               for k in ("fr", "fq", "fb", "fx")}
    gene = rng.integers(0, 6, n)
    ch = dict(
        names=names, **strings,
        rna=rng.integers(0, 4, (n, W)).astype(np.uint8),
        rna_qual=rng.integers(20, 75, (n, W)).astype(np.uint8),
        rna_len=L.astype(np.int32),
        nmask=rng.random((n, W)) > 0.03,
        bc_packed=rng.integers(0, 2**32, n, dtype=np.uint64)
        .astype(np.uint32),
        bc_qual=rng.integers(30, 75, (n, BC_LEN)).astype(np.uint8),
        umi_packed=rng.integers(0, 6, n).astype(np.uint32),
        umi_valid=rng.random(n) < 0.9,
        umi_qual=rng.integers(30, 75, (n, UMI_LEN)).astype(np.uint8),
        pos=z(), mapq=np.where(mapped, rng.choice([0, 3, 255], n), 0),
        strand=rng.integers(0, 2, n), aln_len=alen, aln_start=astart,
        mapped=mapped, region=rng.choice([0, 0, 1, 2], n),
        gene=gene, conf_ok=rng.random(n) < 0.75, bc_ok=rng.random(n) < 0.8,
        corrected_bc=rng.integers(0, 2**32, n, dtype=np.uint64)
        .astype(np.uint32),
        bc_idx=rng.integers(0, 4, n), novel_sj=novel.astype(np.int64),
        sj_donor=sj_donor, sj_acceptor=sj_acceptor, sj_right_len=right,
        mm=(rng.random(n) < 0.1).astype(np.int64),
        gene_discordant=(rng.random(n) < 0.15).astype(np.int64),
        gene_unpaired=rng.choice([-1, 0, 2, 5], n),
        gene_list=gene_list, anti_list=anti_list, is_feature=feature,
        gene_lib=gene.astype(np.uint32), pair_flag=pair_flag,
        mate_chrom=np.where(paired, chrom, -1).astype(np.int32),
        mate_gpos=np.where(paired, gpos + rng.integers(-300, 300, n), -1),
        tlen=np.where(paired, rng.integers(-400, 400, n), 0),
        umi_rep=rng.random(n) < 0.9, secondary=kind == 1,
        g_chrom=chrom, g_gpos=gpos, g_spliced=spliced,
        g_intron_len=intron, g_donor_off=donor)
    # a few N codes where the mask says real base, and qualities below 33
    ch["rna"][rng.random((n, W)) < 0.01] = 4
    ch["rna_qual"][rng.random((n, W)) < 0.02] = 10
    ch["rna_qual"][rng.random((n, W)) < 0.01] = 140
    ch["sort_key"] = np.where(mapped, chrom.astype(np.int64) * (1 << 33)
                              + gpos, 2 * (1 << 33))
    return ch


def _views(chunks) -> dict:
    """Raw-triple views of the conf-mapped triples: a tenth low-support,
    a third corrected to another UMI of their (barcode, gene)."""
    rng = np.random.default_rng(7)
    trip = set()
    for c in chunks:
        ok = c["conf_ok"] & c["umi_valid"]
        trip |= set(zip(c["bc_idx"][ok].tolist(), c["gene_lib"][ok].tolist(),
                        c["umi_packed"][ok].tolist()))
    t = np.array(sorted(trip), np.uint32).reshape(-1, 3)
    corr = np.where(rng.random(len(t)) < 0.3, rng.integers(0, 6, len(t)),
                    t[:, 2]).astype(np.uint32)
    return dict(raw_bc=t[:, 0].copy(), raw_gene=t[:, 1].copy(),
                raw_umi=t[:, 2].copy(), raw_corr_umi=corr,
                raw_low=rng.random(len(t)) < 0.1)


def _collector(spool, chunks, n_bands=4) -> bam_out.BamCollector:
    c = bam_out.BamCollector(GI, TXOME, str(spool), read_group="lib1")
    c.n_bands = n_bands
    for ch in chunks:
        n = len(ch["names"])
        c._route(ch, n)
        c.n_reads += n
    return c


def _bands(seed=3, n_chunks=6, per=700, pad=None):
    rng = np.random.default_rng(seed)
    return [_chunk(rng, k * per, per, pad or {}) for k in range(n_chunks)]


def _both(tmp, chunks, views, gem_group=2, spool="spool"):
    c = _collector(tmp / spool, chunks)
    plain, new = str(tmp / "plain.bam"), str(tmp / "new.bam")
    c.write_plain(plain, views, BC_LEN, UMI_LEN, gem_group)
    c.write(new, views, BC_LEN, UMI_LEN, gem_group)
    for a, b in ((plain, new), (plain + ".bai", new + ".bai")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(b)
    return new


def _spans(path):
    """(start, end, name) of each record in the decompressed stream."""
    import gzip
    import struct
    with gzip.open(path, "rb") as f:
        data = f.read()
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    out = []
    while off < len(data):
        size = struct.unpack_from("<i", data, off)[0]
        l_rn = data[off + 12]
        out.append((off, off + 4 + size,
                    data[off + 36:off + 36 + l_rn - 1]))
        off += 4 + size
    return out


def test_every_branch_new_equals_plain(tmp_path):
    chunks = _bands()
    new = _both(tmp_path, chunks, _views(chunks))
    _, recs, _ = read_bam(new)
    assert len(recs) == sum(len(c["names"]) for c in chunks)
    tags = [r["tags"] for r in recs]
    tx = [t.get("TX", "") for t in tags]
    seen = dict(
        unmapped=any(r["flag"] & 4 and "fb" not in r["tags"] for r in recs),
        feature_tags={k for t in tags for k in ("fr", "fq", "fb", "fx")
                      if k in t} == {"fr", "fq", "fb", "fx"},
        feature_no_tags=any(r["flag"] & 4 and t["xf"] & 16 and "fr" not in t
                            for r, t in zip(recs, tags)),
        low_support=any(t["xf"] & 2 for t in tags),
        umi_count=any(t["xf"] & 8 for t in tags),
        duplicate=any(t["xf"] & 1 and not t["xf"] & 10 for t in tags),
        feature_umi_count=any(t["xf"] & 24 == 24 for t in tags),
        secondary_clipped=any(r["flag"] & 256 and r["cigar"][0][1] == "S"
                              for r in recs),
        secondary_plain=any(r["flag"] & 256 and len(r["cigar"]) == 1
                            for r in recs),
        spliced=any([op for _, op in r["cigar"] if op != "S"]
                    == ["M", "N", "M"] for r in recs),
        tx_projected=any(e.startswith("T") for s in tx for e in s.split(";")
                         if s),
        tx_gene_form=any(e.startswith("ENSG") for s in tx
                         for e in s.split(";") if s),
        tx_minus_strand=any(e.split(",")[0] in ("TB", "TD", "TF")
                            for s in tx for e in s.split(";") if s),
        tx_other_chrom=any(e.split(",")[0] in ("TC", "TF")
                           for s in tx for e in s.split(";") if s),
        novel_junction=any(r["ref_id"] >= 0 and len(r["cigar"]) > 2
                           and r["cigar"][-2][1] == "N"
                           and r["cigar"][-2][0] not in (300, 800)
                           for r in recs),
        antisense=any("AN" in t for t in tags),
        repeated_gene=any(len(s.split(";")) != len(set(s.split(";")))
                          for s in tx if s),
        gene_discordant_named=any("gX" in t for t in tags),
        gene_discordant_unnamed=any(t["xf"] & 4 and "gX" not in t
                                    for t in tags),
        mm=any("mm" in t for t in tags),
        negative_tlen=any(r["tlen"] < 0 for r in recs),
        reverse=any(r["flag"] & 16 for r in recs),
        n_base=any("N" in r["seq"] for r in recs),
        odd_and_even=len({len(r["seq"]) % 2 for r in recs}) == 2,
        empty_read=any(len(r["seq"]) == 0 for r in recs),
        cb=any("CB" in t and t["CB"].endswith("-2") for t in tags),
        no_cb=any("CB" not in t for t in tags),
        qual_ff=any(0xFF in r["qual"] for r in recs),
        empty_references={r["ref_id"] for r in recs} == {-1, 0, 2})
    assert all(seen.values()), [k for k, v in seen.items() if not v]


@pytest.mark.parametrize("case", ["no_mapped_record", "no_record"])
def test_no_indexed_record_new_equals_plain(tmp_path, case):
    """A run whose reads are all unmapped, and a run with no read: every
    reference gets 0 bins and 0 windows in the .bai."""
    chunks = _bands(n_chunks=2, per=300) if case == "no_mapped_record" else []
    for c in chunks:
        c["mapped"][:] = False
        c["secondary"][:] = False
        c["sort_key"][:] = 2 * (1 << 33)
    new = _both(tmp_path, chunks, _views(chunks))
    _, recs, _ = read_bam(new)
    assert len(recs) == sum(len(c["names"]) for c in chunks)
    assert all(r["ref_id"] < 0 for r in recs)


def test_block_edges_new_equals_plain(tmp_path):
    """The last indexed record ends exactly on a 60,000-byte boundary of
    the stream (so its chunk in the .bai ends at the next block's offset,
    0) and records span two blocks: both writers' .bam and .bai, and the
    index of the records as laid out in the file
    (chip_smoke.bam_index_check)."""
    B = 60_000
    chunks = _bands(seed=5)
    (tmp_path / "a").mkdir()
    first = _both(tmp_path / "a", chunks, _views(chunks))
    spans = _spans(first)
    k = max(i for i, r in enumerate(read_bam(first)[1]) if r["ref_id"] >= 0)
    short = -spans[k][1] % B
    # lengthen the names of records before it by `short` bytes in all
    pad, left = {}, short
    for _, _, name in spans[:k + 1]:
        pad[name] = min(left, 200)
        left -= pad[name]
    assert not left
    chunks = _bands(seed=5, pad=pad)
    (tmp_path / "b").mkdir()
    new = _both(tmp_path / "b", chunks, _views(chunks))
    spans = _spans(new)
    assert spans[k][1] % B == 0 and spans[k][1] < spans[-1][1]
    assert read_bam(new)[1][k + 1]["ref_id"] < 0
    assert any(s // B != (e - 1) // B for s, e, _ in spans)
    g = chip_smoke.bam_index_check(new, str(tmp_path))
    assert g["indexed_records"] == k + 1


def test_concat_chunks_linear_equals_sum_join():
    rng = np.random.default_rng(1)
    chunks = [dict(a=rng.integers(0, 9, k % 7), names=[b"n%d.%d" % (k, j)
                                                      for j in range(k % 7)],
                   fr=[b""] * (k % 7))
              for k in range(500)]
    want = {k: (np.concatenate([c[k] for c in chunks])
                if isinstance(chunks[0][k], np.ndarray)
                else sum((c[k] for c in chunks), []))
            for k in chunks[0]}
    got = bam_out.concat_chunks([dict(c) for c in chunks])
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["names"] == want["names"] and got["fr"] == want["fr"]


def test_representative_join_equals_rep_dict(tmp_path):
    """Record by record, the UMI_COUNT flags the write files a molecule
    partition at a time (each molecule's winner, then an exact comparison
    of (raw UMI, not_txomic, qname)) decide as the plain version's dict
    of hashes does."""
    chunks = _bands(seed=11)
    views = _views(chunks)
    c = _collector(tmp_path / "spool", chunks)
    rv = bam_out._raw_views(views)
    rep = c._rep_dict(c._select_representatives(*rv))
    work = tmp_path / "work"
    work.mkdir()
    c._file_winners(bam_out._ViewIndex(rv), str(work), c._sources())
    decided = []
    for band in range(c.n_bands + 1):
        r = c._load_band(band, rv)
        if r is None:
            continue
        cat, cu, low = r
        won = work / f"win{band}"
        wins = np.sort(np.fromfile(won, np.int64)) if won.exists() else \
            np.zeros(0, np.int64)
        win_idx, _ = bam_out._band_winners(cat, wins)
        for i in np.flatnonzero(cat["conf_ok"] & ~low):
            ntxo = 0 if int(cat["region"][i]) == 0 else 1
            plain = rep.get(c._rep_key(int(cat["bc_idx"][i]),
                                       int(cat["gene_lib"][i]),
                                       int(cu[i]))) == hash(
                (int(cat["umi_packed"][i]), ntxo, cat["names"][i]))
            decided.append((plain, bool(win_idx[i] >= 0)))
    plain, new = np.array(decided).T
    assert plain.any() and not plain.all()
    np.testing.assert_array_equal(new, plain)


def _run_both(cfg, out):
    with chip_smoke.plain_beside():
        s = tcount.run_count(cfg, out, device="cpu")
    assert not chip_smoke.plain_diffs(out)
    return s


def test_e2e_run_new_equals_plain(tmp_path):
    """chip_smoke's e2e_bam phase at 30,000 reads on the CPU (the MEX of
    a count-only run, records, the index of the records as laid out in
    the file), every BAM write made by both writers."""
    fx = fixtures.build_e2e_run(str(tmp_path / "fx"), 30_000)
    ref = chip_smoke.count_run(fx, str(tmp_path / "ref"), "cpu", 8192)
    with chip_smoke.plain_beside():
        g = chip_smoke.bam_run(fx, str(tmp_path), ref["total_molecules"],
                               chip_smoke.mex_sha256(str(tmp_path / "ref")),
                               device="cpu", batch_size=8192, expected=None)
    assert not chip_smoke.plain_diffs(str(tmp_path / "e2e_bam_out"))
    assert g["records"] >= 30_000 and g["index"]["indexed_records"] > 0
    assert g["bam_split"]["records"] == g["records"]


def test_rich_run_new_equals_plain(tmp_path):
    fx = fixtures.build_rich_run(str(tmp_path / "fx"))
    cfg = tcount.CountConfig(
        fastq_pairs=[], reference_path=fx["ref"], whitelist_path=fx["wl"],
        feature_ref_csv=fx["feature_ref"],
        libraries=[tcount.LibraryDef([(fx["fq1"], fx["fq2"])]),
                   tcount.LibraryDef([(fx["ab_fq1"], fx["ab_fq2"])],
                                     "Antibody Capture")],
        read_len=fixtures.READ_LEN, batch_size=4096, write_bam=True,
        checkpoint=False, secondary_analysis=False)
    out = str(tmp_path / "out")
    _run_both(cfg, out)
    _, recs, _ = read_bam(os.path.join(out, BAM))
    assert any("fb" in r["tags"] for r in recs)
    assert any(r["flag"] & 256 for r in recs)


def test_paired_run_new_equals_plain(tmp_path):
    with chip_smoke.plain_beside():
        g = chip_smoke.pe_parity(str(tmp_path), None, devices=("cpu", "cpu"),
                                 n_pairs=600, batch_size=256,
                                 genome_len=200_000, n_genes=20, n_cells=20,
                                 n_wl=500)
    assert g["bam_records"] == 1200
    assert not chip_smoke.plain_diffs(str(tmp_path / "pe_small_cpu"))


def test_two_host_run_new_equals_plain(tmp_path):
    """Two gloo processes; host 0 merges both hosts' spools (sibling_dirs)
    and writes the BAM twice (tests/bam_plain_worker.py)."""
    fx = fixtures.build_lane_run(str(tmp_path / "fx"))
    cfg = dict(fastq_pairs=fx["pairs"], reference_path=fx["ref"],
               whitelist_path=fx["wl"], chemistry="SC3Pv3", read_len=91,
               batch_size=512, secondary_analysis=False, checkpoint=False,
               write_bam=True)
    out = str(tmp_path / "out")
    res = launch(cfg, out, 2, "cpu", 240,
                 dict(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2"),
                 module="tests.bam_plain_worker")
    for pid, r in enumerate(res):
        assert r["rc"] == 0 and r["out"] is not None, (pid, r["err"])
    assert res[0]["out"]["total_reads"] == 1600
    assert not chip_smoke.plain_diffs(out)


def test_run_path_never_reaches_the_plain_writer(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain writer on the run's path")

    monkeypatch.setattr(bam_out.BamCollector, "_write_rows", refuse)
    monkeypatch.setattr(bam_index.IndexingBamWriter, "write_record", refuse)
    fx = fixtures.build_synthetic_run(str(tmp_path / "fx"), n_cells=12)
    cfg = tcount.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], read_len=fixtures.READ_LEN,
        batch_size=1024, write_bam=True, secondary_analysis=False)
    tcount.run_count(cfg, str(tmp_path / "out"), device="cpu")
    assert bam_out.LAST_SPLIT["records"] >= fx["n_reads"]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bam_host, "_SRC", str(bad))
    monkeypatch.setattr(bam_host, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(bam_host, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(bam_host, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bam_host.get_lib()


def test_bam_expected_shape():
    """chip_smoke.BAM_EXPECTED (tests/bam_reference.py's output): the
    JAX package's payload digest and record count of the 1M-read run."""
    e = chip_smoke.BAM_EXPECTED
    assert set(e) == {"payload_sha256", "records"}
    assert len(e["payload_sha256"]) == 64
    int(e["payload_sha256"], 16)
    assert isinstance(e["records"], int)
    assert e["records"] >= chip_smoke.E2E_BAM_READS
