"""Port parity on the human-scale layout: minimizer sampling, parity
position packing, junction contigs, text positions at and above 2**31.

  * `fixtures.padded_index` + `shift_index` (the index of a long all-N
    pad built over a short one and shifted) against the JAX package's
    `GenomeIndex.build` over the whole padded genome: every array, the
    packed text rows and the overlapped rows equal; `build_human_run`'s
    uncompressed index.npz loads in both packages;
  * the same small minimizer/parity reference with a GTF through both
    packages' `run_count`: metrics, MEX and the three h5 files equal; the
    port's run, through chip_smoke's `human_scale` on the cpu, counts
    every read the fixture built or accounts for it as one of the
    reference's known losses (ROADMAP.md section 3), and its
    `human_parity` holds cpu against cpu with K1's plain version;
  * a text that crosses 2**31 (a pad of 2**31 - 2**19 N, whose rows are
    np.zeros pages never written): the aligner, the annotator and the
    accumulate and stream steps of both packages on reads from below and
    above 2**31 and on the junction contigs, every output equal; the
    overlapped-row window fetch against the two-row fetch up there.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from cellranger_tpu.align import aligner as jal
from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnIndex
from cellranger_tpu.align.annotate import make_annotator as jax_annotator
from cellranger_tpu.align.index import GenomeIndex as JaxGenomeIndex
from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.io.gtf import Transcriptome as JaxTranscriptome
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.align import aligner as tal
from cellranger_tpu_torch.align.annotate import AnnotationIndex
from cellranger_tpu_torch.align.annotate import make_annotator
from cellranger_tpu_torch.align.index import GenomeIndex
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.io.gtf import Transcriptome
from cellranger_tpu_torch.ops import encode
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.ops.tensor_ops import u32_table
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing import fixtures
from test_torch_hdf5 import h5_parity_diffs

# a 7 Mb minimizer/parity reference: 3 Mb pad, 4 Mb chr1 (a 4 x 250 kb
# repeat), 400 two-exon genes
SMALL = dict(pad_len=3 * 2**20, chr1_len=4_000_000, repeat_len=250_000,
             n_genes=400, n_wl=50_000, n_cells=100)
SMALL_READS = 20_000
SMALL_BATCH = 4096
# chip_smoke.HUMAN_LOSS_CAPS for this layout: 1.25 times the shares lost
# by its run, which equals the JAX package's (test_run_count_matches_jax):
# saturated 10 of 14,000 exon and 110 of 2,000 junction reads, straddling
# 2 exon and 16 of 1,000 deletion reads
SMALL_LOSS_CAPS = {"saturated": {"exon": 0.0009, "junction": 0.069},
                   "contig_straddle": {"exon": 0.00018, "deletion": 0.02}}
# chr1 from 2**31 - 2**19 on: a quarter of it and the repeat below 2**31,
# the rest and every junction contig above
HIGH = dict(pad_len=2**31 - 2**19, chr1_len=2_000_000, repeat_len=100_000,
            n_genes=200, n_wl=5_000, n_cells=20)
HIGH_READS = 1024
L = 91


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return fixtures.build_human_run(str(tmp_path_factory.mktemp("human")),
                                    n_reads=SMALL_READS, **SMALL)


def _chr1(fx) -> bytes:
    return np.frombuffer(b"ACGT", np.uint8)[fx["chr1_codes"]].tobytes()


def test_offset_build_equals_the_whole_build(small):
    """The shifted index (written by build_human_run, uncompressed) is
    the JAX package's build over the whole padded genome, array for
    array; each package loads the file."""
    jgi = JaxGenomeIndex.build(
        {"chrPad": b"N" * SMALL["pad_len"], "chr1": _chr1(small)},
        JaxTranscriptome.from_gtf(small["gtf"]),
        sampling="minimizer", pos_mode="parity")
    path = os.path.join(small["ref"], "index.npz")
    gi, jloaded = GenomeIndex.load(path), JaxGenomeIndex.load(path)
    assert len(gi.text) == small["text_len"]
    assert gi.n_junctions == SMALL["n_genes"] > 0
    for f in ("text", "text_valid", "chrom_starts", "sj_contig_start",
              "sj_chrom", "sj_donor_end", "sj_acceptor_start", "kmer_keys",
              "kmer_pos"):
        want = getattr(jgi, f)
        for got in (getattr(gi, f), getattr(jloaded, f)):
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("chrom_names", "genome_len", "sj_overhang", "k", "stride",
              "sampling", "minimizer_w", "pos_mode"):
        assert getattr(gi, f) == getattr(jgi, f) == getattr(jloaded, f), f
    np.testing.assert_array_equal(gi.packed_rows(), jgi.packed_rows())
    np.testing.assert_array_equal(gi.packed_overlap_rows(),
                                  jgi.packed_overlap_rows())
    # the pad's rows as padded_text_rows writes them (zero pages)
    gi0, off = fixtures.padded_index({"chr1": _chr1(small)},
                                     Transcriptome.from_gtf(small["gtf"]),
                                     "chrPad", SMALL["pad_len"])
    np.testing.assert_array_equal(fixtures.padded_text_rows(gi0, off),
                                  jgi.packed_rows())


def test_run_count_matches_jax(small, tmp_path):
    """Both packages' run_count on the small human layout: equal metrics,
    MEX and h5 files.  The port's run is chip_smoke's human_scale on the
    cpu: exact against the read-by-read account of the fixture."""
    r = chip_smoke.human_scale(small, str(tmp_path / "torch"), device="cpu",
                               batch_size=SMALL_BATCH,
                               loss_caps=SMALL_LOSS_CAPS)
    acct = r["account"]
    assert acct["total_molecules"] > 0.95 * acct["truth_molecules"]
    assert acct["deletion_reads_rescued"] > 0
    lost = acct["lost_reads"]
    assert lost["saturated"]["junction"] > 0
    assert lost["contig_straddle"]["deletion"] > 0
    assert all(v["repeat"] == 0 for v in lost.values())
    cfg = dict(fastq_pairs=[(small["fq1"], small["fq2"])],
               reference_path=small["ref"], whitelist_path=small["wl"],
               chemistry="SC3Pv3", read_len=L, batch_size=SMALL_BATCH,
               secondary_analysis=False, checkpoint=False)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    j_sum = jax_count.run_count(jax_count.CountConfig(**cfg), j_out)
    t_sum = tcount.run_count(tcount.CountConfig(**cfg), t_out, device="cpu")
    assert not cc.check_metrics(t_sum, j_sum)
    assert t_sum["total_molecules"] == acct["total_molecules"]
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            d = cc.check_mtx(os.path.join(t_out, sub, f),
                             os.path.join(j_out, sub, f))
            assert not d, (sub, f, d)
        d = h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                            os.path.join(j_out, sub + ".h5"))
        assert not d, (sub, d)
    d = h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                        os.path.join(j_out, "molecule_info.h5"),
                        molecule_info=True)
    assert not d, d


def test_reference_losses_are_the_jax_packages(small):
    """The reads the reference loses on this layout (chip_smoke's
    known_losses; ROADMAP.md section 3), through both packages' aligners:
    every output equal.  A saturated read has one locus (its genome copy
    and its junction contig's) yet reports more than MAPQ 1 allows; a
    straddling read's best locus on a junction contig starts in the
    contig before it."""
    from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex

    path = os.path.join(small["ref"], "index.npz")
    codes, valid = encode.encode_seqs(small["cdna"])
    didx = tal.DeviceIndex.from_host(GenomeIndex.load(path), "cpu")
    align = tal.make_aligner(didx, L)

    def port(c, v):
        out = align(torch.from_numpy(c), torch.from_numpy(v))
        return {k: x.numpy() for k, x in out.items()}

    got = port(codes, valid)
    counted = small["read_kind"] != fixtures.HUMAN_KINDS.index("repeat")
    loss = chip_smoke.known_losses(
        got, counted, False, didx,
        deletion=small["read_kind"] == fixtures.HUMAN_KINDS.index("deletion"))
    sel = np.flatnonzero(loss["saturated"] | loss["contig_straddle"])
    assert loss["saturated"].any() and loss["contig_straddle"].any()
    # one batch of just these reads through both (rescue capacity is a
    # share of the batch)
    got = port(codes[sel], valid[sel])
    want = jal.make_aligner(
        JaxDeviceIndex.from_host(JaxGenomeIndex.load(path)), L)(
        codes[sel], valid[sel])
    _assert_same(got, want)
    sat = loss["saturated"][sel]
    assert (np.asarray(want["mapq"])[sat] == 0).all()
    assert (np.asarray(want["n_best"])[sat] > 4).all()
    assert (np.asarray(want["pos"])[~sat] >= small["genome_len"]).any()


def test_human_parity_phase_on_cpu(small):
    """chip_smoke's human_parity, cpu against cpu: the step and aligner
    outputs equal, the deletion reads rescued, the truth probe's repeat
    reads never confident and every missed exon read a known loss."""
    r = chip_smoke.human_parity(small, devices=("cpu", "cpu"), n_reads=2048,
                                n_truth=4096)
    assert r["reads"] == 2048 and r["deletion_reads_rescued"] > 0
    assert r["truth"]["repeat_low_mapq"] == 1.0
    assert r["truth"]["repeat_false_confident"] == 0.0
    assert (r["truth"]["off_repeat_correct_gene_mapq255"]
            >= chip_smoke.HUMAN_TRUTH_FLOOR)
    assert r["truth_missed"]["other"] == 0


# the losses of the fixture's 1,000,000 reads measured on an H100
CARD_LOST = {"saturated": {"exon": 4458, "junction": 4100, "deletion": 528},
             "contig_straddle": {"deletion": 152},
             "false_novel_junction": {"deletion": 2}}


@pytest.mark.parametrize("loss,kind,n,over", [
    (None, None, 0, False),
    ("saturated", "exon", 5608, False),
    ("saturated", "exon", 5609, True),
    ("saturated", "junction", 5300, True),
    ("saturated", "deletion", 700, True),
    ("contig_straddle", "deletion", 250, True),
    ("contig_straddle", "exon", 9, True),
    ("false_novel_junction", "deletion", 11, True),
    ("promote_overflow", "repeat", 8, False),
    ("promote_overflow", "exon", 9, True),
])
def test_loss_caps_bound_the_human_run(loss, kind, n, over):
    """chip_smoke's human_scale caps on the reference's known losses pass
    the card's measured losses and flag a class past its cap (share of the
    kind's reads plus the slack), the cap itself passing."""
    kinds = fixtures.HUMAN_KINDS
    fx = dict(read_kind=np.repeat(np.arange(len(kinds)),
                                  [700_000, 100_000, 50_000, 150_000]))
    lost = {name: {k: CARD_LOST.get(name, {}).get(k, 0) for k in kinds}
            for name in chip_smoke.LOSSES}
    if loss is not None:
        lost[loss][kind] = n
    got = chip_smoke.loss_overruns(fx, lost, chip_smoke.HUMAN_LOSS_CAPS)
    assert len(got) == over, got
    assert all(g.startswith(f"{loss} {kind}: {n} > ") for g in got), got


# ---------------------------------------------------------------------------
# text positions at and above 2**31
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def high(tmp_path_factory):
    """Both packages' device tables of a text that crosses 2**31, built
    from one offset index: the pad's text rows are zero pages (the JAX
    package's copy of them is the one real gigabyte), no overlapped rows."""
    fx = fixtures.human_run_inputs(str(tmp_path_factory.mktemp("high")),
                                   n_reads=HIGH_READS, **HIGH)
    gi0, off = fx["index"]
    gi = fixtures.shift_index(gi0, off)
    text_rows = fixtures.padded_text_rows(gi0, off)
    text_len = off + len(gi0.text)
    assert 2**31 < gi.genome_len < text_len < 2**32
    kmer_rows, bits = BucketTable.build_rows(
        gi.kmer_keys, gi.kmer_pos, entries=tal.MAX_HITS_PER_SEED, fields=2)
    sj = np.stack([gi.sj_donor_end, gi.sj_acceptor_start], 1) \
        .astype(np.uint32)
    meta = dict(genome_len=int(gi.genome_len), text_len=text_len,
                sj_overhang=gi.sj_overhang, k=gi.k, pos_mode=gi.pos_mode,
                sampling=gi.sampling, minimizer_w=gi.minimizer_w)
    didx = tal.DeviceIndex(
        text_rows=torch.from_numpy(text_rows.view(np.int32)),
        kmer_table=BucketTable.from_rows(kmer_rows, bits, "cpu",
                                         entries=tal.MAX_HITS_PER_SEED),
        chrom_starts=torch.from_numpy(gi.chrom_starts),
        sj_rows=u32_table(sj, "cpu"), **meta)
    jdidx = jal.DeviceIndex(
        text_rows=jnp.asarray(text_rows),
        kmer_table=JaxBucketTable(rows=jnp.asarray(kmer_rows), bits=bits,
                                  entries=jal.MAX_HITS_PER_SEED, fields=2,
                                  probe_rows=1),
        chrom_starts=jnp.asarray(gi.chrom_starts), sj_rows=jnp.asarray(sj),
        **meta)
    txome = Transcriptome.from_gtf(fx["gtf"])
    ann = AnnotationIndex.build(txome, gi, "cpu")
    jann = JaxAnnIndex.build(JaxTranscriptome.from_gtf(fx["gtf"]), gi)
    codes, valid = encode.encode_seqs(fx["cdna"])
    return dict(fx=fx, gi0=gi0, gi=gi, off=off, didx=didx, jdidx=jdidx,
                ann=ann, jann=jann, codes=codes, valid=valid)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


def _aligned(high):
    want = jal.make_aligner(high["jdidx"], L)(high["codes"], high["valid"])
    got = tal.make_aligner(high["didx"], L)(torch.from_numpy(high["codes"]),
                                            torch.from_numpy(high["valid"]))
    return {k: v.numpy() for k, v in got.items()}, want


def test_aligner_above_2_31_matches_jax(high):
    got, want = _aligned(high)
    _assert_same(got, want)
    pos, mapped = got["pos"], got["mapped"]
    glen = high["gi"].genome_len
    # reads mapped below 2**31, above it on chr1, on the junction contigs
    assert (mapped & (pos < 2**31)).any()
    assert (mapped & (pos >= 2**31) & (pos < glen)).any()
    assert (mapped & (pos >= glen)).any()
    assert (got["sw_score"] > got["score"]).any()
    assert (got["n_best"][mapped] >= 2).any()
    assert got["saturated"].any()


def test_annotator_above_2_31_matches_jax(high):
    got, want = _aligned(high)
    args = [want[k] for k in ("pos", "aln_len", "strand", "mapq", "mapped")]
    jwant = jax_annotator(high["jann"], high["gi"].genome_len,
                          high["gi"].sj_overhang)(*args)
    tgot = make_annotator(high["ann"], high["gi"].genome_len,
                          high["gi"].sj_overhang)(
        *[torch.from_numpy(got[k]) for k in ("pos", "aln_len", "strand",
                                             "mapq", "mapped")])
    _assert_same({k: v.numpy() for k, v in tgot.items()}, jwant)
    assert (np.asarray(jwant["gene"])[got["pos"] >= 2**31] >= 0).any()


def _plane(high):
    fx = high["fx"]
    rng = np.random.default_rng(5)
    return fixtures.reads_plane(
        fx["cdna"], rng.integers(0, HIGH["n_cells"], len(fx["cdna"])),
        rng.integers(0, 4**12, len(fx["cdna"])).astype(np.uint32))


def test_count_step_above_2_31_matches_jax(high):
    plane = _plane(high)
    jstep = jax_count._make_step(high["jdidx"], high["jann"],
                                 jax_get_chemistry("SC3Pv3"), L,
                                 accumulate=True)
    tstep = tcount.make_count_step(high["didx"], high["ann"],
                                   get_chemistry("SC3Pv3"), L)
    B = len(plane)
    jacc = jstep(jnp.asarray(plane), jstep.init_acc(2 * B, 2 * B))
    tacc = tstep.init_acc(2 * B, 2 * B)
    tstep(tcount.upload_plane(plane, "cpu"), tacc)
    n = int(jacc["mol_n"])
    assert int(tacc["mol_n"]) == n > 0
    np.testing.assert_array_equal(tacc["mol"][:n].numpy(),
                                  np.asarray(jacc["mol"])[:n].astype(np.int64))
    nsj = int(jacc["sj_n"])
    assert int(tacc["sj_n"]) == nsj
    np.testing.assert_array_equal(tacc["sj"][:nsj].numpy(),
                                  np.asarray(jacc["sj"])[:nsj])
    for k in ("sjh", "mvec"):
        np.testing.assert_array_equal(tacc[k].numpy(), np.asarray(jacc[k]))
    # annotated-junction hits above 2**31 land in the histogram
    assert tacc["sjh"].sum() > 0


def test_stream_step_above_2_31_matches_jax(high):
    plane = _plane(high)
    jstep = jax_count._make_step(high["jdidx"], high["jann"],
                                 jax_get_chemistry("SC3Pv3"), L,
                                 accumulate=False, emit_secondary=True)
    tstep = tcount.make_stream_step(high["didx"], high["ann"],
                                    get_chemistry("SC3Pv3"), L,
                                    emit_secondary=True)
    want_ho, want_m = jax_count.unpack_step_out(jstep(jnp.asarray(plane)))
    got_ho, got_m = tcount.unpack_step_out(tcount.fetch_step_out(
        tstep(tcount.upload_plane(plane, "cpu"))))
    assert got_m == want_m
    assert set(got_ho) == set(want_ho)
    for k, w in want_ho.items():
        w = np.asarray(w)
        assert got_ho[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got_ho[k], w, err_msg=k)
    # u32 columns above 2**31 come back as their uint32 views
    assert (got_ho["pos"][got_ho["mapped"]] >= 2**31).any()
    assert (got_ho["sec_pos"][got_ho["sec_ok"]] < 2**31).any()


def test_overlap_fetch_above_2_31(high):
    """The overlapped-row fetch (one row a window; the card's layout at
    the human size) equals the two-row fetch and the JAX package's at
    positions on both sides of 2**31 and at the text's end."""
    gi0, off = high["gi0"], high["off"]
    ov0 = gi0.packed_overlap_rows()
    ov = np.zeros((off // 128 + len(ov0), ov0.shape[1]), np.uint32)
    ov[off // 128:] = ov0
    didx_ov = dataclasses.replace(
        high["didx"], text_rows_ov=torch.from_numpy(ov.view(np.int32)))
    G = high["didx"].text_len
    pos = np.concatenate([
        np.arange(2**31 - 300, 2**31 + 300, 7),
        np.random.default_rng(3).integers(off + 256, G - 200, 2000),
        np.arange(G - 120, G + 20)]).astype(np.int64)
    width = L + 4
    fetch = tal.make_window_fetch(didx_ov, width)
    assert fetch.__name__ == "fetch_overlap"
    got = fetch(torch.from_numpy(pos))
    two = tal.make_window_fetch(high["didx"], width)(torch.from_numpy(pos))
    want = jal.make_window_fetch(high["jdidx"], width)(
        high["jdidx"], jnp.asarray(pos.astype(np.uint32)))
    for g, t, w in zip(got, two, want):
        np.testing.assert_array_equal(g.numpy(), t.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# host work at the human scale
# ---------------------------------------------------------------------------

def test_packed_rows_hold_one_block_of_scratch():
    """GenomeIndex.packed_rows equals the JAX package's at odd lengths
    with invalid bases, and builds its rows a block at a time: at 32 Mb
    the host's peak is the rows and one block, not ~3 bytes a base."""
    import tracemalloc

    rng = np.random.default_rng(2)
    for n in (0, 1, 255, 257, 70_001, 4_194_311):
        text = rng.integers(0, 4, n).astype(np.uint8)
        valid = rng.random(n) < 0.9
        kw = dict(text=text, text_valid=valid, chrom_names=[],
                  chrom_starts=np.zeros(1, np.int64), genome_len=n,
                  sj_contig_start=np.zeros(0, np.int64), sj_overhang=120,
                  sj_chrom=np.zeros(0, np.int32),
                  sj_donor_end=np.zeros(0, np.int64),
                  sj_acceptor_start=np.zeros(0, np.int64), k=16, stride=1,
                  kmer_keys=np.zeros(0, np.uint32),
                  kmer_pos=np.zeros(0, np.uint32))
        got, want = GenomeIndex(**kw).packed_rows(), \
            JaxGenomeIndex(**kw).packed_rows()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(n))
    n = 32_000_000
    gi = GenomeIndex(**dict(kw, text=rng.integers(0, 4, n).astype(np.uint8),
                            text_valid=np.ones(n, bool), genome_len=n))
    tracemalloc.start()
    rows = gi.packed_rows()
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < rows.nbytes + (48 << 20), (peak, rows.nbytes)


def test_barcode_names_of_a_whitelist_of_10x_size(monkeypatch):
    """The raw matrix's barcode names: equal to one decode a barcode, and
    built for 10x's 3' v3 whitelist (6,794,880 barcodes) in one
    vectorized pass, never a decode a barcode: decoded one at a time they
    took most of the 124.5 s matrix phase of chip_smoke.py's human_scale
    on the H100's host."""
    wl = fixtures._human_whitelist(np.random.default_rng(3),
                                   fixtures.HUMAN_WL)
    decode = encode.decode_codes

    def refuse(*a, **kw):
        raise AssertionError("barcode_names decoded a barcode at a time")

    monkeypatch.setattr(encode, "decode_codes", refuse)
    names = tcount.barcode_names(wl, 16, b"-1")
    short = tcount.barcode_names(wl[:5], 16)
    monkeypatch.setattr(encode, "decode_codes", decode)
    assert len(names) == fixtures.HUMAN_WL
    sample = np.random.default_rng(4).choice(len(wl), 20_000)
    assert [names[i] for i in sample] == [
        encode.decode_codes(encode.unpack_np(wl[i], 16)) + b"-1"
        for i in sample]
    assert short == [n[:-2] for n in names[:5]]
