"""The port's torch build of the genome index and of the DeviceIndex tables
against the JAX package's numpy build, array for array (tolerance 0), on
the CPU:

  * `GenomeIndex.build(device="cpu")` (the kmer table by
    `index.kmer_table_torch`) against the JAX package's `GenomeIndex.build`
    in every layout, on a seeded genome with N runs, junction contigs and
    a poly-A run (keys at and above 2**31, equal (key, value) pairs under
    parity packing); the minimizer build in several blocks; texts shorter
    than a minimizer window plus a kmer;
  * `BucketTable._place_torch` / `build_rows_torch` against the JAX
    package's `_place` / `build_rows`, dropped entries included;
  * `DeviceIndex.build`'s text rows, overlapped rows and kmer bucket rows
    against the JAX package's `DeviceIndex.from_host`;
  * `run_count` with the device-built tables on a 7 Mb reference of
    GRCh38's shape (`fixtures.build_grch38_run`, minimizer/parity) against
    the JAX package's run; `mkref --device cpu` against the JAX package's
    mkref on the same FASTA and GTF.
"""

import json
import os

import numpy as np
import pytest
import torch

from cellranger_tpu.align import index as jidx
from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.io.gtf import Transcriptome as JaxTranscriptome
from cellranger_tpu.io.reference import ReferencePackage as JaxReference
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.align import aligner as tal
from cellranger_tpu_torch.align import index as tidx
from cellranger_tpu_torch.align.index import GenomeIndex
from cellranger_tpu_torch.cli import main
from cellranger_tpu_torch.io.gtf import Transcriptome, write_fasta
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing import fixtures
from test_torch_hdf5 import h5_parity_diffs

LAYOUTS = [("every", "strand31"), ("minimizer", "parity"),
           ("minimizer", "strand31"), ("every", "parity")]
L = 91
# build_grch38_run at 1/440 of GRCh38's lengths: 7,018,794 bases, 400 genes
SMALLCHROMS = tuple((n, x // 440) for n, x in fixtures.GRCH38_CHROMS)
SMALL = dict(chroms=SMALLCHROMS, repeat_len=100_000, n_genes=400,
             n_wl=50_000, n_cells=100, device="cpu", sampling="minimizer",
             pos_mode="parity")
SMALLREADS = 20_000
SMALLBATCH = 4096
# chip_smoke.HUMAN_LOSS_CAPS for this layout: 1.25 times the shares its
# run loses (saturated 2 of 14,000 exon and 12 of 2,000 junction reads,
# straddling 14 of 1,000 deletion reads), each with HUMAN_LOSS_SLACK
SMALLLOSS_CAPS = {"saturated": {"exon": 0.00018, "junction": 0.0075},
                   "contig_straddle": {"deletion": 0.0175}}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 600 kb genome with N runs and 60 junction contigs, and a contig
    with a 300-base poly-A run: ({name: bytes}, GTF path)."""
    tmp = str(tmp_path_factory.mktemp("genome"))
    seqs, _ = fixtures.index_genome(tmp, 600_000, n_genes=60, seed=5)
    rng = np.random.default_rng(6)
    flank = lambda: bytes(rng.choice(list(b"ACGT"), 500))  # noqa: E731
    seqs["chrPolyA"] = flank() + b"A" * 300 + flank()
    return seqs, os.path.join(tmp, "g.gtf")


def _both(genome, **kw):
    """(the port's build on the cpu, the JAX package's build)."""
    seqs, gtf = genome
    got = GenomeIndex.build(seqs, Transcriptome.from_gtf(gtf), device="cpu",
                            **kw)
    want = jidx.GenomeIndex.build(seqs, JaxTranscriptome.from_gtf(gtf), **kw)
    return got, want


INDEX_FIELDS = ("text", "text_valid", "chrom_names", "chrom_starts",
                "genome_len", "sj_contig_start", "sj_overhang", "sj_chrom",
                "sj_donor_end", "sj_acceptor_start", "k", "stride",
                "kmer_keys", "kmer_pos", "sampling", "minimizer_w",
                "pos_mode")


def _assert_same_index(got, want):
    """Every field of index.npz equal, dtypes included."""
    for f in INDEX_FIELDS:
        x, y = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("sampling,pos_mode", LAYOUTS)
def test_kmer_table_equals_jax_build(genome, sampling, pos_mode):
    got, want = _both(genome, sampling=sampling, pos_mode=pos_mode)
    _assert_same_index(got, want)
    keys, vals = want.kmer_keys, want.kmer_pos
    assert want.n_junctions == 60 and (~want.text_valid).sum() > 10_000
    assert (keys >= 2**31).any() and (keys < 2**31).any()
    if pos_mode == "parity":
        # positions p and p+1 of one strand in the poly-A run
        assert ((keys[1:] == keys[:-1]) & (vals[1:] == vals[:-1])).any()


@pytest.mark.parametrize("block", [997, 10_007, 1 << 16])
def test_minimizer_blocks_equal_one_build(block):
    """Blocks whose edges fall anywhere, each with the numpy build's
    overlap of w + k, against the JAX package's default block."""
    rng = np.random.default_rng(block)
    G = 150_000
    text = rng.integers(0, 4, G).astype(np.uint8)
    valid = rng.random(G) > 0.002
    text[~valid] = 0
    for pos_mode in ("parity", "strand31"):
        want = jidx._build_kmer_table_minimizer(text, valid, 16, 12,
                                                pos_mode)
        got = tidx.kmer_table_torch(torch.from_numpy(text),
                                    torch.from_numpy(valid), 16, 1,
                                    "minimizer", 12, pos_mode, block=block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


@pytest.mark.parametrize("G", [0, 5, 15, 16, 20, 27, 28, 40])
def test_short_texts(G):
    """Texts shorter than w + k: fewer than w kmers take minimizer_mask's
    own short case (every kmer holding the block's minimum)."""
    rng = np.random.default_rng(G)
    text = rng.integers(0, 4, G).astype(np.uint8)
    valid = np.ones(G, bool)
    valid[G // 3:G // 3 + 1] = False
    text[~valid] = 0
    cases = {"minimizer": jidx._build_kmer_table_minimizer(
                 text, valid, 16, 12, "parity"),
             "every": jidx._build_kmer_table(text, valid, 16, 1, "parity")}
    for sampling, want in cases.items():
        got = tidx.kmer_table_torch(torch.from_numpy(text),
                                    torch.from_numpy(valid), 16, 1,
                                    sampling, 12, "parity")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


@pytest.mark.parametrize("bits,n_keys", [(6, 2000), (8, 5000), (10, 900)])
def test_place_equals_jax(bits, n_keys):
    """Keys from a small pool, so that buckets run past their 8 entries
    and the placement drops; the EMPTY key is filtered by build_rows."""
    rng = np.random.default_rng(bits)
    pool = rng.integers(0, 2**32, n_keys // 3, dtype=np.uint64)
    keys = rng.choice(pool, n_keys).astype(np.uint32)
    vals = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    want, want_dropped = JaxBucketTable._place(keys, vals, bits, 8, 2, 1)
    got, dropped = BucketTable._place_torch(
        torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(vals.astype(np.int64)), bits, 8, 2, 1, block=333)
    assert dropped == want_dropped > 0
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    keys[::7] = 0xFFFFFFFF
    want, want_bits = JaxBucketTable.build_rows(keys, vals)
    got, got_bits = BucketTable.build_rows_torch(
        torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(vals.view(np.int32)))
    assert got_bits == want_bits
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(NotImplementedError):
        BucketTable._place_torch(torch.from_numpy(keys.view(np.int32)),
                                 torch.from_numpy(vals.view(np.int32)),
                                 bits, 8, 2, 2)


@pytest.mark.parametrize("sampling,pos_mode", LAYOUTS[:2])
def test_device_tables_equal_jax(genome, sampling, pos_mode):
    """DeviceIndex.build's tables against the JAX package's from_host."""
    got, want = _both(genome, sampling=sampling, pos_mode=pos_mode)
    didx = tal.DeviceIndex.build(got, "cpu")
    jdi = JaxDeviceIndex.from_host(want)
    u32 = lambda t: t.numpy().view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(u32(didx.text_rows), want.packed_rows())
    np.testing.assert_array_equal(u32(didx.text_rows_ov),
                                  want.packed_overlap_rows())
    assert didx.kmer_table.bits == jdi.kmer_table.bits
    np.testing.assert_array_equal(u32(didx.kmer_table.rows),
                                  np.asarray(jdi.kmer_table.rows))
    np.testing.assert_array_equal(u32(didx.sj_rows), np.asarray(jdi.sj_rows))
    np.testing.assert_array_equal(didx.chrom_starts.numpy(),
                                  want.chrom_starts)
    for f in ("genome_len", "text_len", "sj_overhang", "k", "pos_mode",
              "sampling", "minimizer_w"):
        assert getattr(didx, f) == getattr(jdi, f), f
    # the host path of the port gives the same tables
    arrays, meta = tal.DeviceIndex.host_arrays(got)
    np.testing.assert_array_equal(u32(didx.kmer_table.rows),
                                  arrays["kmer_rows"])
    # text rows in blocks of a few rows
    rows = tidx.pack_text_rows_torch(torch.from_numpy(got.text),
                                     torch.from_numpy(got.text_valid),
                                     block=7)
    np.testing.assert_array_equal(u32(rows), want.packed_rows())


def test_overlap_rows_above_the_limit(genome, monkeypatch):
    got, _ = _both(genome, sampling="minimizer", pos_mode="parity")
    monkeypatch.setattr(tal, "OVERLAP_ROWS_MAX_TEXT", len(got.text) - 1)
    assert tal.DeviceIndex.build(got, "cpu").text_rows_ov is None
    assert tal.DeviceIndex.host_arrays(got)[0]["text_rows_ov"] is None


def test_grch38_layout():
    """build_grch38_run's default sizes: GRCh38's 3,088,269,832 bases,
    36,601 genes with room for their layout, a text under 2**32 but past
    2**31 and the minimizer threshold, chr13 crossing 2**31."""
    lens = np.asarray([n for _, n in fixtures.GRCH38_CHROMS])
    assert lens.sum() == 3_088_269_832 and len(lens) == 24
    n = fixtures.genes_per_chrom(lens, fixtures.HUMAN_GENES)
    assert n.sum() == fixtures.HUMAN_GENES and (lens // n >= 3600).all()
    text = lens.sum() + 2 * 120 * fixtures.HUMAN_GENES
    assert text == 3_097_054_072
    assert tidx.AUTO_MINIMIZER_LEN < 2**31 <= text < 2**32
    starts = np.concatenate([[0], np.cumsum(lens)])
    i = [name for name, _ in fixtures.GRCH38_CHROMS].index("chr13")
    assert starts[i] < 2**31 < starts[i + 1]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return fixtures.build_grch38_run(str(tmp_path_factory.mktemp("g38")),
                                     n_reads=SMALLREADS, **SMALL)


def test_grch38_index_equals_jax_build(small):
    """The fixture's index.npz (built by the torch build) is the JAX
    package's build over the same genome, array for array."""
    cs = small["chrom_starts"]
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = {n: bases[small["codes"][cs[i]:cs[i + 1]]].tobytes()
            for i, (n, _) in enumerate(SMALLCHROMS)}
    want = jidx.GenomeIndex.build(seqs, JaxTranscriptome.from_gtf(
        small["gtf"]), sampling="minimizer", pos_mode="parity")
    _assert_same_index(GenomeIndex.load(os.path.join(small["ref"],
                                                     "index.npz")), want)
    assert small["text_len"] == len(want.text)
    assert small["n_junctions"] == SMALL["n_genes"]


def test_run_count_with_device_tables_matches_jax(small, tmp_path):
    """Both packages' run_count on the 7 Mb GRCh38-shaped reference (the
    port's tables built by DeviceIndex.build on the cpu): equal metrics,
    MEX and h5 files; the port's reference split names the device
    steps."""
    cfg = dict(fastq_pairs=[(small["fq1"], small["fq2"])],
               reference_path=small["ref"], whitelist_path=small["wl"],
               chemistry="SC3Pv3", read_len=L, batch_size=SMALLBATCH,
               secondary_analysis=False, checkpoint=False)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    j_sum = jax_count.run_count(jax_count.CountConfig(**cfg), j_out)
    tcount._REF_MEMO.update(key=None, value=None, split=None)
    t_sum = tcount.run_count(tcount.CountConfig(**cfg), t_out, device="cpu")
    assert sorted(tcount._REF_MEMO["split"]) == sorted(
        ["npz_load_s", "upload_s", "text_rows_s", "overlap_rows_s",
         "kmer_rows_s", "annotation_s"])
    assert not cc.check_metrics(t_sum, j_sum)
    assert t_sum["total_molecules"] > 0.95 * small["expected"][
        "total_molecules"]
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


def test_human_phases_on_the_grch38_fixture(small, tmp_path):
    """chip_smoke's human_parity (cpu against copies of its tables) and
    human_scale (the read-by-read account) on the small fixture."""
    import chip_smoke

    g = chip_smoke.human_parity(small, devices=("cpu", "cpu"),
                                n_reads=2048, n_truth=2048)
    assert g["fields"] == 40 and g["deletion_reads_rescued"] > 0, g
    assert g["truth"]["off_repeat_correct_gene_mapq255"] >= \
        chip_smoke.HUMAN_TRUTH_FLOOR, g
    assert sorted(g["load_split_s"]) == sorted(
        ["npz_load_s", "upload_s", "text_rows_s", "overlap_rows_s",
         "kmer_rows_s", "annotation_s"])
    r = chip_smoke.human_scale(small, str(tmp_path / "out"), device="cpu",
                               batch_size=SMALLBATCH,
                               loss_caps=SMALLLOSS_CAPS)
    acct = r["account"]
    assert acct["total_molecules"] > 0.95 * acct["truth_molecules"]
    assert r["device_tables"]["kmer_table"] > 0


def _chance_genome(decoy=None):
    """1 Mb of seeded base codes; `decoy` = (position, bases) written over
    them."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    if decoy is not None:
        at, piece = decoy
        codes[at:at + len(piece)] = piece
    return codes


def _aligners(codes, gtf):
    """(the port's DeviceIndex, its aligner, the JAX package's aligner) of
    the genome `codes` with the genes of `gtf`, minimizer/parity."""
    from cellranger_tpu.align.aligner import make_aligner as jax_make_aligner

    seqs = {"chr1": np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()}
    kw = dict(sampling="minimizer", pos_mode="parity")
    gi = GenomeIndex.build(seqs, Transcriptome.from_gtf(gtf), device="cpu",
                           **kw)
    jgi = jidx.GenomeIndex.build(seqs, JaxTranscriptome.from_gtf(gtf), **kw)
    didx = tal.DeviceIndex.build(gi, "cpu")
    return (didx, tal.make_aligner(didx, L),
            jax_make_aligner(JaxDeviceIndex.from_host(jgi), L))


def test_chance_locus_loss_is_the_jax_packages(tmp_path):
    """The reference's `chance_locus` loss (chip_smoke.known_losses), which
    GRCh38's size brought out: a deletion read whose true window starts
    outside the offsets parity rounding lets the aligner try scores a few
    bases at its true locus; K1 rescues it there while nothing else
    scores more, but a chance match elsewhere (here a planted copy of one
    of the read's minimizer windows, 27 bases) takes the pick, K1 gains
    nothing at it and the read stays unmapped.  Both packages lose the
    read the same way, every output equal."""
    import chip_smoke
    import jax.numpy as jnp

    spacing = 10_000
    gtf = str(tmp_path / "g.gtf")
    fixtures._human_gtf(gtf, 100, spacing)
    codes = _chance_genome()
    didx, align, _ = _aligners(codes, gtf)
    ar = np.arange(L)
    # deletion reads of gene 26's exon 1, as the human fixtures make them
    st = 26 * spacing + 1000 + np.arange(0, 600 - L - 8, 7)
    cut = np.arange(*fixtures.HUMAN_DELETION_AT)
    st, cut = (a.ravel() for a in np.meshgrid(st, cut, indexing="ij"))
    reads = codes[np.where(ar < cut[:, None], st[:, None] + ar,
                           st[:, None] + ar + fixtures.HUMAN_DELETION)]
    ones = torch.ones(reads.shape, dtype=torch.bool)
    al = align(torch.from_numpy(reads), ones)
    low = np.flatnonzero(al["score"].numpy() < 10)
    assert len(low) > 0
    i = int(low[0])
    read = reads[i]
    # alone (every read of that batch wants K1, past its capacity), it is
    # rescued at its true locus while no chance locus competes
    one = align(torch.from_numpy(read[None]), ones[:1])
    assert bool(one["mapped"][0]) and int(one["sw_score"][0]) > 80
    assert abs(int(one["pos"][0]) - int(st[i])) <= 4
    # plant a chance locus: a read window whose minimum is a used seed
    keys = tidx._canonical_kmers_block(read, np.ones(L, bool), 16)[0]
    mh = (keys * tidx.MINIMIZER_HASH).astype(np.uint32)
    picks = np.flatnonzero(tidx.minimizer_mask(mh, tidx.MINIMIZER_W))[:10]
    j = next(j for j in range(len(mh) - 11)
             if j + int(np.argmin(mh[j:j + 12])) in picks)
    decoy_at = 70 * spacing + 5000                   # between two genes
    codes = _chance_genome((decoy_at, read[j:j + 27]))
    didx, align, jalign = _aligners(codes, gtf)
    got = {k: v.numpy() for k, v in align(torch.from_numpy(read[None]),
                                           ones[:1]).items()}
    want = {k: np.asarray(v) for k, v in jalign(
        jnp.asarray(read[None]), jnp.asarray(np.ones((1, L), bool))).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    assert not got["mapped"][0] and got["pos"][0] == decoy_at - j
    assert got["sw_score"][0] <= got["score"][0] < 30
    assert (np.abs(got["loci_pos"][0].astype(np.int64) - int(st[i]))
            <= 4).any()                              # the true locus lost
    loss = chip_smoke.known_losses(got, np.ones(1, bool), False, didx,
                                   deletion=np.ones(1, bool))
    assert [k for k, v in loss.items() if v[0]] == ["chance_locus"]
    # the class takes deletion reads only
    loss = chip_smoke.known_losses(got, np.ones(1, bool), False, didx,
                                   deletion=np.zeros(1, bool))
    assert [k for k, v in loss.items() if v[0]] == ["other"]
    # chip_smoke's report of the pick: the planted 27 bases hold 12 kmers
    fx = dict(codes=codes, chr1_start=0, chrom_names=["chr1"],
              chrom_starts=np.zeros(1, np.int64), read_gene=np.array([26]))
    rep = chip_smoke._chance_read(fx, np.int64(0), read, got, np.int64(0))
    json.dumps(rep)                                  # as chip_smoke prints it
    assert (rep["chrom"], rep["at"], rep["strand"]) == ("chr1",
                                                        decoy_at - j, 0)
    assert 12 <= rep["kmers_on_diagonal"] < 20


@pytest.mark.parametrize("fault", [None, "entry", "bucket", "text_row",
                                   "overlap_row", "missing"])
def test_high_positions_check(genome, fault):
    """chip_smoke.high_positions, which holds the card's tables above
    2**31 against the host text, passes on the torch build's tables and
    fails on each kind of fault: an entry's position moved by two, an
    entry in another bucket, a text row word or an overlapped row word
    flipped, an entry missing from the kmer table."""
    import chip_smoke

    seqs, gtf = genome
    gi = GenomeIndex.build(seqs, Transcriptome.from_gtf(gtf), device="cpu",
                           sampling="minimizer", pos_mode="parity")
    didx = tal.DeviceIndex.build(gi, "cpu")
    above = len(gi.text) // 2
    kw = dict(above=above, window=1 << 14, rows_chunk=1 << 10)
    tab = didx.kmer_table
    E = tab.entries
    pos = tab.rows[:, E:2 * E].to(torch.int64) & 0xFFFFFFFE
    r, s = ((tab.rows[:, :E] != -1) & (pos >= above + 1000)
            & (pos < above + 2000)).nonzero()[0].tolist()
    if fault == "entry":
        tab.rows[r, E + s] += 2
    elif fault == "bucket":
        tab.rows[[r, r - 1]] = tab.rows[[r - 1, r]]
    elif fault == "text_row":
        didx.text_rows[above // 256, 3] ^= 1
    elif fault == "overlap_row":
        didx.text_rows_ov[len(gi.text) // 128 - 4, 20] ^= 1
    elif fault == "missing":
        gone = (gi.kmer_pos & 0xFFFFFFFE) == int(pos[r, s])
        gi.kmer_keys, gi.kmer_pos = gi.kmer_keys[~gone], gi.kmer_pos[~gone]
    if fault is None:
        rep = chip_smoke.high_positions(gi, didx, "cpu", **kw)
        assert rep["entries_checked"] > 1000 and rep["window_entries"] > 100
        assert rep["rows_checked"] > 100
    else:
        with pytest.raises(AssertionError):
            chip_smoke.high_positions(gi, didx, "cpu", **kw)


@pytest.mark.parametrize("n,over", [(18, False), (19, True)])
def test_chance_locus_cap(n, over):
    """chip_smoke's cap on chance_locus: 8 of the GRCh38 fixture's 50,000
    deletion reads measured on an H100, times 1.25, plus the slack."""
    import chip_smoke

    kinds = fixtures.HUMAN_KINDS
    fx = dict(read_kind=np.repeat(np.arange(len(kinds)),
                                  [700_000, 100_000, 50_000, 150_000]))
    lost = {name: {k: 0 for k in kinds} for name in chip_smoke.LOSSES}
    lost["chance_locus"]["deletion"] = n
    got = chip_smoke.loss_overruns(fx, lost, chip_smoke.HUMAN_LOSS_CAPS)
    assert len(got) == over, got


@pytest.mark.parametrize("multi", [False, True])
def test_cli_mkref_on_cpu_equals_jax_mkref(genome, tmp_path, capsys, multi):
    """`mkref --device cpu` writes the index.npz of the JAX package's
    mkref on the same FASTA and GTF (one genome, and two as barnyard)."""
    seqs, gtf = genome
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, seqs)
    t_ref, j_ref = str(tmp_path / "t"), str(tmp_path / "j")
    if multi:
        main(["mkref", "--genome", "a,b", "--fasta", f"{fa},{fa}",
              "--genes", f"{gtf},{gtf}", "--out", t_ref, "--device", "cpu"])
        JaxReference.build_multi([("a", fa, gtf), ("b", fa, gtf)], j_ref)
    else:
        main(["mkref", "--genome", "g", "--fasta", fa, "--genes", gtf,
              "--out", t_ref, "--device", "cpu"])
        JaxReference.build(fa, gtf, j_ref, genome_name="g")
    capsys.readouterr()
    with np.load(os.path.join(t_ref, "index.npz")) as a, \
            np.load(os.path.join(j_ref, "index.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
