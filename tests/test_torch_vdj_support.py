"""Port parity for the batched V(D)J host work (cellranger_tpu_torch/
vdj/support.py and the native local alignment), tolerance 0, against the
JAX package's originals: `umi_support`, `contig_base_quals` and
`trim_primer_read` (vdj/assembly.py), `local_align`, `best_hit` and
`annotate_contig` (vdj/annotate.py).

A module fixture runs both packages' `run_vdj` on a 5-cell, 500-pair
library at the widened width (`fixtures.vdj_library_kw`: V genes in
families, non-cell barcodes, binned qualities with N bases, a planted
inner primer; a 20,000-barcode whitelist in place of 737,280 to stay
quick) and records, call by call, the reads and contig that each hands
to its UMI support: every output file equal, the per-barcode read lists
in the original's order, every contig's support and base qualities,
every annotation.  Hypothesis cases cover the pileup's corners; the
primer trim, the local alignment and the per-barcode cap have their own.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from cellranger_tpu import params as jax_params
from cellranger_tpu.pipeline import vdj as jax_vdj
from cellranger_tpu.vdj import annotate as jann
from cellranger_tpu.vdj import assembly as jasm
from cellranger_tpu.vdj.reference import VdjReference as JRef
from cellranger_tpu_torch import params
from cellranger_tpu_torch.native import vdj_host as native
from cellranger_tpu_torch.pipeline import vdj
from cellranger_tpu_torch.testing.fixtures import (build_vdj_run,
                                                   vdj_library_kw)
from cellranger_tpu_torch.vdj import assembly, support
from cellranger_tpu_torch.vdj.reference import VdjReference
from chip_smoke import _plain_reads, tree_diffs, vdj_truth_diffs

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg_kw(fx):
    return dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                vdj_reference_fasta=fx["fa"], whitelist_path=fx["wl"],
                chemistry=fx["chemistry"], read_len=fx["read_len"])


def _both_runs(fx, tmp):
    """run_vdj of both packages on fx; the reads and contig each hands to
    its UMI support, call by call."""
    port, jax = [], []

    class Support(support.BarcodeSupport):
        def umi_support(self, contig, min_frac=0.5):
            port.append((self.reads, contig.seq))
            return super().umi_support(contig, min_frac)

    real_umi_support = jax_vdj.umi_support

    def recorded(contig, reads, *a):
        jax.append((reads, contig.seq))
        return real_umi_support(contig, reads, *a)

    saved = support.BarcodeSupport
    support.BarcodeSupport, jax_vdj.umi_support = Support, recorded
    try:
        got = vdj.run_vdj(vdj.VdjConfig(**_cfg_kw(fx)), str(tmp / "torch"),
                          device="cpu")
        want = jax_vdj.run_vdj(jax_vdj.VdjConfig(**_cfg_kw(fx)),
                               str(tmp / "jax"))
    finally:
        support.BarcodeSupport, jax_vdj.umi_support = saved, real_umi_support
    return dict(fx=fx, got=got, want=want, port=port, jax=jax,
                split=dict(vdj.LAST_SPLIT), t_out=str(tmp / "torch"),
                j_out=str(tmp / "jax"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vdj_support")
    kw = dict(vdj_library_kw(5), n_wl=20_000, background=100)
    fx = build_vdj_run(str(tmp / "fx"), 5, 500, **kw)
    return _both_runs(fx, tmp)


def test_run_vdj_at_library_width_matches_jax(runs):
    assert runs["got"] == runs["want"]
    assert tree_diffs(runs["t_out"], runs["j_out"]) == []
    # the run holds the fixture's truth, and the annotation met V families
    assert vdj_truth_diffs(runs["fx"], runs["t_out"], runs["got"],
                           runs["fx"]["expected"]["bc_umi_pairs"]) == []
    s = runs["split"]
    assert s["annotated"] == 10 and s["alignments"] > 3 * s["annotated"]
    assert s["barcodes"] == 5 + 100


def test_read_lists_are_the_originals(runs):
    """Per barcode the rows are the original's reads_by_bc, in order:
    mate 1 then mate 2 a batch, primer-trimmed, N where masked."""
    assert len(runs["port"]) == len(runs["jax"]) > 100
    trimmed = 0
    for (rd, seq), (reads, jseq) in zip(runs["port"], runs["jax"]):
        assert seq == jseq
        assert _plain_reads(rd) == reads
        trimmed += int((rd.start > 0).sum())     # every read is 120 bases
    assert trimmed > 0
    assert any("N" in r[1] for reads, _ in runs["jax"] for r in reads)


def test_support_and_quals_match_jax_on_every_contig(runs):
    n_quals = 0
    for (rd, seq), (reads, _) in zip(runs["port"], runs["jax"]):
        sup = support.BarcodeSupport(rd, "cpu")
        c, jc = assembly.Contig(seq, 0), jasm.Contig(seq, 0)
        sup.umi_support(c)
        jasm.umi_support(jc, reads)
        assert (c.n_umis, c.n_reads) == (jc.n_umis, jc.n_reads)
        if len(reads) <= 1200:
            got = sup.contig_base_quals(seq)
            want = jasm.contig_base_quals(seq, reads)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            n_quals += 1
    assert n_quals > 100


def _hit_fields(h):
    if h is None:
        return None
    return (h.segment.gene_name, h.segment.chain, h.score, h.contig_start,
            h.contig_end, h.seg_start, h.seg_end)


def _ann_fields(a):
    return (a.contig_seq, a.chain, _hit_fields(a.v), _hit_fields(a.j),
            _hit_fields(a.c), a.cdr3_nt, a.cdr3_aa, a.productive,
            a.full_length)


def test_annotation_matches_jax(runs):
    """annotate_contig on the cells' contigs (their V genes' family
    members pass the 16-mer prefilter too) and on a few non-cell
    barcodes' contigs; best_hit at other floors."""
    fa = runs["fx"]["fa"]
    ann = support.Annotator(VdjReference.from_fasta(fa))
    jref = JRef.from_fasta(fa)
    cells = [seq for rd, seq in runs["port"] if len(rd.umi) > 100]
    other = [seq for rd, seq in runs["port"] if len(rd.umi) <= 100][:4]
    assert len(cells) == 10
    for seq in cells + other:
        before = ann.alignments
        assert _ann_fields(ann.annotate(seq)) \
            == _ann_fields(jann.annotate_contig(seq, jref))
        if seq in cells:
            assert ann.alignments - before > 3
    for seq in cells[:3]:
        for region, floor in (("V", 400), ("J", 60), ("C", 0)):
            assert _hit_fields(ann.best_hit(seq, region, floor)) \
                == _hit_fields(jann.best_hit(seq, jref.by_region(region),
                                             floor))


def _rand(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes().decode()


def test_local_align_matches_jax():
    rng = np.random.default_rng(5)
    pairs = [("", ""), ("ACGT", ""), ("AAAA", "TTTT"), ("A", "A"),
             ("ACGTACGTACGT", "ACGT"), ("ACGT", "ACGTACGTACGT"),
             ("AAAAAAAA", "AAAA"), ("ACACACAC", "CACA"), ("NNNNACGT", "ACGT")]
    for _ in range(40):
        a = _rand(rng, int(rng.integers(10, 200)))
        b = _rand(rng, int(rng.integers(10, 120)))
        pairs.append((a, b))
        # planted: b inside a with substitutions, an insertion, a deletion
        s = a[int(rng.integers(0, len(a) // 2)):]
        s = s[:len(s) // 2] + "G" + s[len(s) // 2 + 2:]
        pairs.append((a, s.replace("A", "C", 2)))
    for a, b in pairs:
        assert native.local_align(a, b) == jann.local_align(a, b), (a, b)
        assert native.local_align(a, b, 1, -1, -1) \
            == jann.local_align(a, b, 1, -1, -1), (a, b)


def test_pileup_sums_add_in_order():
    """Each group's terms added one at a time in observation order onto
    0.0, as the original's loop adds them; out-of-range input refused."""
    rng = np.random.default_rng(3)
    terms = 10.0 ** rng.uniform(-16, 1, (4, 1024)) * rng.choice([-1, 1],
                                                                 (4, 1024))
    obs = rng.integers(0, 1024, 5000).astype(np.int16)
    group = rng.integers(0, 37, 5000)
    got = native.pileup_sums(obs, group, 40, terms)
    want = np.zeros((40, 4))
    for k, g in zip(obs.tolist(), group.tolist()):
        for b in range(4):
            want[g, b] += terms[b, k]
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="out of range"):
        native.pileup_sums(obs, group, 30, terms)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.local_align("ACGT", "ACGT")


def _trim_rows(reads, W=40):
    codes = np.zeros((len(reads), W), np.uint8)
    valid = np.zeros((len(reads), W), bool)
    for i, r in enumerate(reads):
        b = np.frombuffer(r.encode(), np.uint8)
        codes[i, :len(b)] = support._ACGT[b] & 3
        valid[i, :len(b)] = support._ACGT[b] < 4
        codes[i, len(b):] = 2          # padding beyond the read
        valid[i, len(b):] = True
    return codes, valid, np.array([len(r) for r in reads])


def test_primer_trim_matches_jax():
    p1, p2 = b"ACGTTGCA", b"GGATCCAT"
    reads = [
        "ACGTTGCATTTTACGTTGCA",     # first hit at 0, again later: no trim
        "TTACGTTGCATT",             # one hit at 2
        "TTTTTGGATCCATACGTTGCAT",   # both primers: the leftmost kept hit
        "TACGTTGCAGGATCCAT",        # p1 at 1, p2 at 9
        "GGATCCATTTACGTTGCA",       # p2 at 0 (ignored), p1 at 10
        "TTACGTNGCATTACGTTGCA",     # N in the first copy
        "ACGTTGC",                  # a primer's prefix at the read's end
        "",
        "NNNNNNNNNNNN",
    ]
    rng = np.random.default_rng(1)
    for _ in range(200):
        r = list(_rand(rng, int(rng.integers(0, 36))))
        for p in (p1, p2):
            if rng.random() < 0.5 and len(r) >= len(p):
                at = int(rng.integers(0, len(r) - len(p) + 1))
                r[at:at + len(p)] = p.decode()
        for i in rng.integers(0, max(len(r), 1), 2):
            if r and rng.random() < 0.3:
                r[int(i)] = "N"
        reads.append("".join(r)[:36])
    codes, valid, length = _trim_rows(reads)
    got = support.primer_trim_starts(codes, valid, length, [p1, p2], "cpu")
    want = [jasm.trim_primer_read(r, [p1, p2]) for r in reads]
    assert got.tolist() == want
    assert sum(w > 0 for w in want) > 50
    primers = [jasm._revcomp_b(p) for p in jasm.all_inner_primers()]
    got = support.primer_trim_starts(codes, valid, length, primers, "cpu")
    assert got.tolist() == [jasm.trim_primer_read(r, primers) for r in reads]


def test_read_cap_matches_jax(tmp_path, monkeypatch):
    """vdj_max_reads_per_barcode lowered through a parameters file: the
    first reads of each barcode in the original's order, the same
    files."""
    p = tmp_path / "parameters.toml"
    p.write_text("vdj_max_reads_per_barcode = 150\n")
    monkeypatch.setenv(params.ENV_VAR, str(p))
    params.load(refresh=True)
    jax_params.load(refresh=True)
    try:
        fx = build_vdj_run(str(tmp_path / "fx"), 5, 200)
        r = _both_runs(fx, tmp_path)
    finally:
        monkeypatch.delenv(params.ENV_VAR)
        params.load(refresh=True)
        jax_params.load(refresh=True)
    assert r["got"] == r["want"]
    assert tree_diffs(r["t_out"], r["j_out"]) == []
    assert len(r["port"]) == len(r["jax"]) > 0
    for (rd, seq), (reads, jseq) in zip(r["port"], r["jax"]):
        assert seq == jseq and len(reads) == 150
        assert _plain_reads(rd) == reads


# ---- the pileup's corners, hypothesis-drawn ----

@st.composite
def pileups(draw):
    """A contig (random, or a short unit repeated so K-mers repeat) and
    reads drawn from it with substitutions, N bases, quality bytes 33-74,
    quality strings shorter than the read, reads that anchor nowhere, and
    UMIs from a small set (many reads a UMI)."""
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    if draw(st.booleans()):
        contig = _rand(rng, draw(st.integers(20, 160)))
    else:
        unit = _rand(rng, draw(st.integers(1, 12)))
        contig = (unit * 200)[:draw(st.integers(20, 160))]
        if draw(st.booleans()):
            contig = contig[:10] + _rand(rng, 25) + contig[10:]
    reads = []
    n_umis = draw(st.integers(1, 6))
    for _ in range(draw(st.integers(0, 30))):
        if rng.random() < 0.15:
            seq = list(_rand(rng, int(rng.integers(0, 60))))
        else:
            a = int(rng.integers(0, len(contig)))
            seq = list(contig[a:a + int(rng.integers(15, 80))])
            if rng.random() < 0.3 and a > 0:
                seq = list(_rand(rng, int(rng.integers(1, 8)))) + seq
        for i in range(len(seq)):
            u = rng.random()
            if u < 0.03:
                seq[i] = "ACGT"[(("ACGT".index(seq[i]) if seq[i] in "ACGT"
                                  else 0) + 1) % 4]
            elif u < 0.05:
                seq[i] = "N"
        qn = len(seq) if rng.random() < 0.8 else int(rng.integers(0, 20))
        qual = bytes(rng.integers(33, 75, qn).astype(np.uint8))
        reads.append((int(rng.integers(0, n_umis)) * 977, "".join(seq),
                      qual))
    return contig, reads


@settings(max_examples=80, deadline=None)
@given(pileups())
@example(("ACGT" * 10, []))
@example(("ACGTTGCAACGTTGCAACGTTGCAA", [(1, "ACGTTGCAACGTTGCAACGTT",
                                          b"")]))
def test_pileup_matches_jax(case):
    contig, reads = case
    sup = support.BarcodeSupport(support.BarcodeReads.from_tuples(reads),
                                 "cpu")
    got = sup.contig_base_quals(contig)
    want = jasm.contig_base_quals(contig, reads)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    c, jc = assembly.Contig(contig, 0), jasm.Contig(contig, 0)
    sup.umi_support(c)
    jasm.umi_support(jc, reads)
    assert (c.n_umis, c.n_reads) == (jc.n_umis, jc.n_reads)


def test_sums_of_four_are_numpys():
    """The pileup writes its 4- and 3-term sums left to right: numpy's
    np.sum of fewer than 8 values adds them so."""
    rng = np.random.default_rng(2)
    x = 10.0 ** rng.uniform(-17, 0, (20_000, 4))
    x[::7, 0] = 1.0
    for n in (3, 4):
        got = support._logsumexp10(np.log10(x[:, :n]))
        want = [(lambda r: r.max() + np.log10(np.sum(10 ** (r - r.max()))))(
            np.log10(row)) for row in x[:, :n]]
        assert np.array_equal(got, np.array(want))
