"""The port against the JAX package on a reference with GRCh38's repeats
(`fixtures.build_grch38_run(repeats=True)`, the model of
`testing/repeats.py`: Alu, L1, simple repeats, alpha satellite, segmental
duplications, gene paralogs, repeat copies in exon 2, N gaps) at 1/440 of
GRCh38's lengths, minimizer sampling and parity positions forced, all at
tolerance 0 on the CPU:

  * the repeat model's own figures (family shares of the bases, the
    substitution rate of the youngest Alu class, chromosome lengths kept,
    the clean genes' exon 1 free of copies);
  * the port's index build (`GenomeIndex.build(device="cpu")`) against
    the JAX package's numpy build, every array and the dropped entries;
    `_place_torch` against the JAX package's `_place` on a key with 10**5
    copies and the unique keys that share its bucket;
  * the aligner and the annotator on one batch of FASTQ reads and reads
    off every repeat family;
  * `run_count` of both packages: metrics (promote_overflow included),
    MEX bytes, `molecule_info.h5` read through h5py; chip_smoke's
    human_parity and human_scale on the cpu;
  * the loss class the repeats bring out, `copy_crowded`
    (chip_smoke.known_losses), lost alike by both packages.
"""

import gzip
import os

import numpy as np
import pytest
import torch

import chip_smoke
from cellranger_tpu.align import aligner as jal
from cellranger_tpu.align import index as jidx
from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnIndex
from cellranger_tpu.align.annotate import make_annotator as jax_annotator
from cellranger_tpu.io.gtf import Transcriptome as JaxTranscriptome
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.align import aligner as tal
from cellranger_tpu_torch.align.annotate import (AnnotationIndex,
                                                 make_annotator)
from cellranger_tpu_torch.align.index import GenomeIndex
from cellranger_tpu_torch.io.gtf import Transcriptome
from cellranger_tpu_torch.ops import encode
from cellranger_tpu_torch.ops.bucket_table import MIX, BucketTable
from cellranger_tpu_torch.testing import fixtures, repeats
from test_torch_hdf5 import h5_parity_diffs

L = 91
SMALLCHROMS = tuple((n, x // 440) for n, x in fixtures.GRCH38_CHROMS)
SMALL = dict(chroms=SMALLCHROMS, repeat_len=100_000, n_genes=400,
             n_wl=50_000, n_cells=100, device="cpu", sampling="minimizer",
             pos_mode="parity", repeats=True)
SMALLREADS = 20_000
SMALLBATCH = 4096
# chip_smoke.HUMAN_LOSS_CAPS for this layout: 1.25 times the shares its
# run loses, which equals the JAX package's (test_run_count_matches_jax):
# saturated 16 of 1,800 junction and 4 of 1,600 paralog reads;
# straddling 3 of 11,000 exon and 16 of 1,000 deletion reads; promotion
# overflow 78 of 2,400 exon_repeat and 132 paralog reads; copy_crowded
# 132 exon_repeat reads
SMALL_LOSS_CAPS = {
    "saturated": {"junction": 0.0112, "paralog": 0.0032},
    "contig_straddle": {"exon": 0.00035, "deletion": 0.02},
    "promote_overflow": {"exon_repeat": 0.0407, "paralog": 0.1032},
    "copy_crowded": {"exon_repeat": 0.0688}}


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
    return fixtures.build_grch38_run(str(tmp_path_factory.mktemp("rep")),
                                     n_reads=SMALLREADS, **SMALL)


def _seqs(fx) -> dict:
    """The fixture's chromosomes as FASTA bases, N in the gaps."""
    cs, G = fx["chrom_starts"], fx["genome_len"]
    ends = np.concatenate([cs[1:], [G]])
    asc = np.frombuffer(b"ACGTN", np.uint8)[np.where(
        fx["text_valid"][:G], fx["codes"][:G], 4)]
    return {n: asc[a:b].tobytes() for (n, _), a, b in zip(SMALLCHROMS, cs,
                                                          ends)}


@pytest.fixture(scope="module")
def jax_index(small):
    return jidx.GenomeIndex.build(
        _seqs(small), JaxTranscriptome.from_gtf(small["gtf"]),
        sampling="minimizer", pos_mode="parity")


@pytest.fixture(scope="module")
def tables(small, jax_index):
    """(the port's DeviceIndex and annotation index, the JAX package's)."""
    gi = GenomeIndex.load(os.path.join(small["ref"], "index.npz"))
    didx = tal.DeviceIndex.build(gi, "cpu")
    ann = AnnotationIndex.build(Transcriptome.from_gtf(small["gtf"]), gi,
                                "cpu")
    jdidx = jal.DeviceIndex.from_host(jax_index)
    jann = JaxAnnIndex.build(JaxTranscriptome.from_gtf(small["gtf"]),
                             jax_index)
    return didx, ann, jdidx, jann


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in sorted(want):
        w, g = np.asarray(want[k]), np.asarray(got[k])
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)


def test_repeat_model_figures(small):
    """The model's shares of the bases at this size, the youngest Alu
    class's substitution rate, GRCh38's chromosome lengths (over 440)
    kept, every clean gene's exon 1 and junction flanks off the copies."""
    G = small["genome_len"]
    assert G == sum(n for _, n in SMALLCHROMS)
    share = {k: v / G for k, v in small["repeat_bases"].items()}
    assert 0.08 < share["alu"] < 0.13 and 0.14 < share["l1"] < 0.21
    assert 0.02 < share["simple"] < 0.04 and 0.04 < share["sd"] < 0.07
    assert 0.03 < share["N"] < 0.06 and share["alpha"] > 0.01
    plan = small["repeat_plan"]
    alu = plan["copies"]["alu"]
    codes, valid = small["codes"], small["text_valid"]
    cons = plan["alu_tables"][0]                     # AluY, 5%
    fwd = np.flatnonzero(~alu["rc"] & (alu["length"] == repeats.ALU_LEN))
    diff = (codes[alu["start"][fwd, None] + np.arange(repeats.ALU_LEN)]
            != cons).mean(1)
    young = diff[diff < 0.2]                         # copies of AluY
    assert len(young) > 50 and 0.035 < np.median(young) < 0.07
    assert (~valid[:G]).sum() == small["repeat_bases"]["N"]
    gs = small["gene_start"][plan["clean"]]
    cover = np.zeros(G + 1, np.int64)
    for fam in ("alu", "l1", "simple", "sd"):
        c = plan["copies"][fam]
        np.add.at(cover, c["start"], 1)
        np.add.at(cover, c["start"] + c["length"], -1)
    inside = np.cumsum(cover)[:G] > 0
    assert not inside[gs[:, None] + np.arange(-L, 1200 + 120)].any()
    assert plan["clean"].sum() > 0.8 * len(plan["clean"])
    assert len(plan["paralogs"]["gene"]) >= 4
    assert (plan["paralogs"]["twin_gene"] >= 0).any()
    assert (plan["paralogs"]["twin_gene"] < 0).any()
    assert small["paralog_multi_gene"] > 0
    assert small["reads_by_kind"]["exon_repeat"] > 0


def test_index_equals_jax_build(small, jax_index):
    """The fixture's index.npz (the port's torch build) is the JAX
    package's build over the same genome, array for array; the kmer
    bucket rows and the entries dropped past MAX_HITS_PER_SEED equal the
    JAX package's placement."""
    gi = GenomeIndex.load(os.path.join(small["ref"], "index.npz"))
    for f in ("text", "text_valid", "chrom_names", "chrom_starts",
              "genome_len", "sj_contig_start", "sj_overhang", "sj_chrom",
              "sj_donor_end", "sj_acceptor_start", "k", "stride",
              "kmer_keys", "kmer_pos", "sampling", "minimizer_w",
              "pos_mode"):
        x, y = np.asarray(getattr(gi, f)), np.asarray(getattr(jax_index, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    keys, vals = jax_index.kmer_keys, jax_index.kmer_pos
    _, bits = JaxBucketTable.build_rows(keys, vals)
    want, want_dropped = JaxBucketTable._place(keys, vals, bits, 8, 2, 1)
    got, dropped = BucketTable._place_torch(
        torch.from_numpy(gi.kmer_keys.view(np.int32)),
        torch.from_numpy(gi.kmer_pos.view(np.int32)), bits, 8, 2, 1)
    assert dropped == want_dropped > 0.05 * len(keys)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    rows = tal.DeviceIndex.build(gi, "cpu").kmer_table.rows
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  np.asarray(jal.DeviceIndex.from_host(
                                      jax_index).kmer_table.rows))


def _same_bucket(key: int, bits: int, n: int, seed: int) -> np.ndarray:
    """n distinct keys other than `key` in key's bucket."""
    rng = np.random.default_rng(seed)
    want = ((key * int(MIX)) & 0xFFFFFFFF) >> (32 - bits)
    out = []
    while sum(map(len, out)) < n:
        c = rng.integers(0, 2**32 - 1, 1 << 22, dtype=np.uint64) \
            .astype(np.uint32)
        out.append(c[((c * MIX) >> np.uint32(32 - bits)) == want])
    c = np.unique(np.concatenate(out))
    return c[c != key][:n]


@pytest.mark.parametrize("bits", [12, 20])
def test_place_a_key_with_1e5_copies(bits):
    """A key with 10**5 entries (an Alu kmer of GRCh38) and 40 unique
    keys of its bucket, some ahead of it in input order, most after, among
    random keys: the port's placement on the cpu equals the JAX package's
    `_place`, rows and dropped count (the bucket keeps the first 8 in
    input order)."""
    rng = np.random.default_rng(bits)
    key = np.uint32(0x5A5A1234)
    uniq = _same_bucket(int(key), bits, 40, bits)
    other = rng.integers(0, 2**32 - 1, 3 << bits, dtype=np.uint64) \
        .astype(np.uint32)
    keys = np.concatenate([uniq[:3], np.full(100_000, key), uniq[3:], other])
    keys = np.concatenate([keys[:50_000 + 3], other[:50],
                           keys[50_000 + 3:]])
    vals = rng.integers(0, 2**32, len(keys), dtype=np.uint64) \
        .astype(np.uint32)
    want, want_dropped = JaxBucketTable._place(keys, vals, bits, 8, 2, 1)
    got, dropped = BucketTable._place_torch(
        torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(vals.view(np.int32)), bits, 8, 2, 1, block=65_537)
    assert dropped == want_dropped >= 100_000 + 40 - 8
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    row = want[(int(key) * int(MIX) & 0xFFFFFFFF) >> (32 - bits)]
    assert list(row[:3]) == list(uniq[:3]) and (row[3:8] == key).all()


def _batch(small, n: int = 2048):
    """n FASTQ reads of the fixture and n reads off its repeat copies:
    (codes, valid)."""
    reads, _fam = fixtures.repeat_copy_reads(small, n)
    return encode.encode_seqs(np.concatenate([small["cdna"][:n], reads]))


def _aligned(tables, codes, valid):
    didx, _, jdidx, _ = tables
    got = tal.make_aligner(didx, L)(torch.from_numpy(codes),
                                    torch.from_numpy(valid))
    want = jal.make_aligner(jdidx, L)(codes, valid)
    return {k: v.numpy() for k, v in got.items()}, want


def test_aligner_and_annotator_match_jax(small, tables):
    """One batch of FASTQ reads and reads off every repeat family (the
    seed buckets past their cap, tied votes of near-identical copies,
    minimizer ties in tandem repeats): every aligner and annotator output
    of the port equals the JAX package's."""
    codes, valid = _batch(small)
    got, want = _aligned(tables, codes, valid)
    _assert_same(got, want)
    assert got["saturated"].any() and (got["n_best"] >= 2).any()
    assert (got["sw_score"] > got["score"]).any() and got["novel_sj"].any()
    assert (~valid).any(axis=1).any()                # reads over N gaps
    _, ann, _, jann = tables
    gi = tables[0]
    args = [want[k] for k in ("pos", "aln_len", "strand", "mapq", "mapped")]
    jwant = jax_annotator(jann, gi.genome_len, gi.sj_overhang)(*args)
    tgot = make_annotator(ann, gi.genome_len, gi.sj_overhang)(
        *[torch.from_numpy(got[k]) for k in ("pos", "aln_len", "strand",
                                             "mapq", "mapped")])
    _assert_same({k: v.numpy() for k, v in tgot.items()}, jwant)
    assert (np.asarray(jwant["gene"]) >= 0).any()


def _gunzipped(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def test_run_count_matches_jax(small, tmp_path):
    """Both packages' run_count on the repeat-model reference: equal
    metrics (promote_overflow among them, past zero), MEX bytes and
    molecule_info.h5 (read through h5py).  The port's run is chip_smoke's
    human_scale on the cpu, exact against the read-by-read account, each
    loss within SMALL_LOSS_CAPS."""
    r = chip_smoke.human_scale(small, str(tmp_path / "torch"), device="cpu",
                               batch_size=SMALLBATCH,
                               loss_caps=SMALL_LOSS_CAPS)
    acct = r["account"]
    lost = acct["lost_reads"]
    assert lost["copy_crowded"]["exon_repeat"] > 0
    assert lost["promote_overflow"]["paralog"] > 0
    assert all(n == 0 for k, n in lost["copy_crowded"].items()
               if k != "exon_repeat")
    assert all(v["repeat"] == 0 for v in lost.values())
    cfg = dict(fastq_pairs=[(small["fq1"], small["fq2"])],
               reference_path=small["ref"], whitelist_path=small["wl"],
               chemistry="SC3Pv3", read_len=L, batch_size=SMALLBATCH,
               secondary_analysis=False, checkpoint=False)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    j_sum = jax_count.run_count(jax_count.CountConfig(**cfg), j_out)
    assert not cc.check_metrics(_summary(t_out), _summary(j_out))
    assert j_sum["promote_overflow"] == acct["promote_overflow_reads"] > 0
    assert j_sum["total_molecules"] == acct["total_molecules"]
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzipped(os.path.join(t_out, sub, f)) == _gunzipped(
                os.path.join(j_out, sub, f)), (sub, f)
    d = h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                        os.path.join(j_out, "molecule_info.h5"),
                        molecule_info=True)
    assert not d, d


def _summary(out: str) -> dict:
    import json
    with open(os.path.join(out, "metrics_summary.json")) as f:
        return json.load(f)


def test_human_parity_on_the_repeat_model(small):
    """chip_smoke's human_parity on the cpu: FASTQ reads and reads off
    every repeat family equal on both tables, the fullest buckets by the
    JAX rule, the truth probe at its floor."""
    g = chip_smoke.human_parity(small, devices=("cpu", "cpu"),
                                n_reads=1024, n_truth=1024)
    assert g["reads"] == 2048 and g["reads_off_repeat_copies"] >= 1024
    assert sorted(g["repeat_copy_reads"]) == sorted(
        ["alpha", "alu", "chr1_segment", "exon_repeat", "l1", "paralog",
         "sd", "simple"])
    fb = g["fullest_buckets"]
    assert fb["buckets"] == 1000 and fb["dropped"] > 0
    assert fb["fullest"] > 1000
    assert fb["table_dropped"] > fb["dropped"]
    assert g["truth"]["off_repeat_correct_gene_mapq255"] >= \
        chip_smoke.HUMAN_TRUTH_FLOOR


@pytest.mark.parametrize("fault", [None, "moved", "drop"])
def test_fullest_buckets_check(small, tables, fault):
    """chip_smoke.fullest_buckets passes on the port's rows and fails on
    the fullest bucket's row with an entry's position moved by two, or an
    entry emptied."""
    didx = tables[0]
    gi = GenomeIndex.load(os.path.join(small["ref"], "index.npz"))
    tab = didx.kmer_table
    sizes = chip_smoke.bucket_sizes(gi.kmer_keys, tab.bits)
    b = int(np.argmax(sizes))
    rows = tab.rows.clone()
    if fault == "moved":
        rows[b, 8] += 2                            # the first entry's value
    elif fault == "drop":
        rows[b, 7] = -1
    tab = BucketTable(rows=rows, bits=tab.bits, entries=tab.entries,
                      fields=tab.fields, probe_rows=tab.probe_rows)
    if fault is None:
        g = chip_smoke.fullest_buckets(gi, tab)
        assert g["fullest"] == int(sizes.max()) and g["buckets"] == 1000
    else:
        with pytest.raises(AssertionError):
            chip_smoke.fullest_buckets(gi, tab)


def test_copy_crowded_is_the_jax_packages(small, tables):
    """The loss class the repeats bring out (chip_smoke.known_losses'
    `copy_crowded`): exon_repeat reads whose own copy's locus is never a
    candidate.  Every read of its seeds' keys is shared by more copies
    than a bucket row keeps, the first copies by position fill the row,
    and the read is scored, below its length, at one of those: both
    packages do this to the same reads, every output equal."""
    didx = tables[0]
    kind = small["read_kind"]
    sel = np.flatnonzero(kind == fixtures.REPEAT_KINDS.index("exon_repeat"))
    codes, valid = encode.encode_seqs(small["cdna"][sel])
    got, _ = _aligned(tables, codes[:SMALLBATCH], valid[:SMALLBATCH])
    n = len(got["score"])
    true = small["read_pos"][sel[:SMALLBATCH]]
    loss = chip_smoke.known_losses(got, np.ones(n, bool), False, didx,
                                   deletion=np.zeros(n, bool),
                                   in_copy=np.ones(n, bool), true_pos=true)
    crowded = np.flatnonzero(loss["copy_crowded"])
    assert len(crowded) > 0
    # the reads whose own locus is a candidate score their length there
    own = ~chip_smoke.own_locus_absent(got, np.ones(n, bool), true)
    assert (got["score"][own] == L).mean() > 0.95
    got, want = _aligned(tables, codes[crowded], valid[crowded])
    _assert_same(got, want)
    true = true[crowded]
    near = np.abs(got["loci_pos"].astype(np.int64) - true[:, None]) <= 4
    assert not near.any()                          # its own locus absent
    assert (np.maximum(got["score"], got["sw_score"]) < L).any()
    assert (got["mapped"] & (got["mapq"] == 255)).any()
    n = len(crowded)
    loss = chip_smoke.known_losses(got, np.ones(n, bool), False, didx,
                                   deletion=np.zeros(n, bool),
                                   in_copy=np.ones(n, bool), true_pos=true)
    assert loss["copy_crowded"].all()
    # a read not drawn inside a copy is never put in this class
    loss = chip_smoke.known_losses(got, np.ones(n, bool), False, didx,
                                   deletion=np.zeros(n, bool))
    assert not loss["copy_crowded"].any() and loss["other"].all()


@pytest.mark.parametrize("n,over", [(0, False), (1, True)])
def test_new_loss_pairs_take_their_caps(n, over):
    """chip_smoke's caps on the repeat kinds: each (class, kind) pair the
    card measured passes at its cap and fails one read past it."""
    kinds = fixtures.REPEAT_KINDS
    n_kind = [550_000, 90_000, 50_000, 110_000, 120_000, 80_000]
    fx = dict(kinds=kinds,
              read_kind=np.repeat(np.arange(len(kinds)), n_kind))
    caps = chip_smoke.HUMAN_LOSS_CAPS
    lost = {name: {k: 0 for k in kinds} for name in chip_smoke.LOSSES}
    for loss, by in caps.items():
        for kind, share in by.items():
            lost[loss][kind] = int(share * n_kind[kinds.index(kind)]
                                   + chip_smoke.HUMAN_LOSS_SLACK) + n
    got = chip_smoke.loss_overruns(fx, lost, caps)
    assert (len(got) > 0) == over, got


def _crowded_genome(tmp_path):
    """1 Mb of seeded bases, 100 genes (`fixtures._human_gtf`, every
    10,000 bases), a 300-base consensus copied exactly into exon 2 of
    gene 0 (the first copy by position), at 8% substitution between the
    genes 1-60, and with one substitution (copy base 200) into exon 2 of
    gene 80: (codes, gtf, consensus, start of gene 80's copy)."""
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    cons = rng.integers(0, 4, 300).astype(np.uint8)
    spacing = 10_000
    gtf = str(tmp_path / "g.gtf")
    fixtures._human_gtf(gtf, 100, spacing)
    codes[1000 + 1500:1000 + 1800] = cons                  # gene 0
    for g in range(1, 61):
        c = cons.copy()
        hit = rng.random(300) < 0.08
        c[hit] = (c[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        codes[g * spacing + 5000:g * spacing + 5300] = c
    b = 80 * spacing + 1000 + 1500                          # gene 80
    c = cons.copy()
    c[200] = (c[200] + 1) % 4
    codes[b:b + 300] = c
    return codes, gtf, b


def test_copy_crowded_onto_another_gene(tmp_path):
    """A `copy_crowded` read confident on another gene, in both packages
    alike: reads of gene 80's copy whose one private base lies near their
    3' end or past it, so nearly all their seeds are the consensus's; every
    such key's bucket row keeps its first copies by position, gene 0's
    exact copy first, which outvotes the read's own locus.  The read maps
    at MAPQ 255 in gene 0's exon 2 (below its length, or at it where it
    misses the private base) and is counted there: every aligner and
    annotator output equal, and known_losses
    (with the read inside a copy) calls it copy_crowded."""
    codes, gtf, b = _crowded_genome(tmp_path)
    seqs = {"chr1": np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()}
    kw = dict(sampling="minimizer", pos_mode="parity")
    gi = GenomeIndex.build(seqs, Transcriptome.from_gtf(gtf), device="cpu",
                           **kw)
    jgi = jidx.GenomeIndex.build(seqs, JaxTranscriptome.from_gtf(gtf), **kw)
    didx = tal.DeviceIndex.build(gi, "cpu")
    jdidx = jal.DeviceIndex.from_host(jgi)
    tables = (didx, AnnotationIndex.build(Transcriptome.from_gtf(gtf), gi,
                                          "cpu"),
              jdidx, JaxAnnIndex.build(JaxTranscriptome.from_gtf(gtf), jgi))
    starts = b + np.arange(60, 200)     # the private base past the end,
    #                                     then at read offsets 90 .. 10
    reads = codes[starts[:, None] + np.arange(L)]
    valid = np.ones(reads.shape, bool)
    got, want = _aligned(tables, reads, valid)
    _assert_same(got, want)
    args = [want[k] for k in ("pos", "aln_len", "strand", "mapq", "mapped")]
    jann = jax_annotator(tables[3], gi.genome_len, gi.sj_overhang)(*args)
    tann = make_annotator(tables[1], gi.genome_len, gi.sj_overhang)(
        *[torch.from_numpy(got[k]) for k in ("pos", "aln_len", "strand",
                                             "mapq", "mapped")])
    tann = {k: v.numpy() for k, v in tann.items()}
    _assert_same(tann, jann)
    wrong = (got["mapq"] == 255) & (tann["gene"] == 0) & tann["conf_mapped"]
    assert wrong.any()
    near = np.abs(got["loci_pos"].astype(np.int64)
                  - starts[:, None]) <= 4
    assert not (near & got["loci_ok"])[wrong].any()
    # below its length, or at it where the read misses the private base
    # and gene 0's copy equals it
    score = np.maximum(got["score"], got["sw_score"])[wrong]
    assert (score < L).any() and (score == L).any()
    n = int(wrong.sum())
    loss = chip_smoke.known_losses({k: v[wrong] for k, v in got.items()},
                                   np.ones(n, bool), False, didx,
                                   deletion=np.zeros(n, bool),
                                   in_copy=np.ones(n, bool),
                                   true_pos=starts[wrong])
    assert loss["copy_crowded"].all()
    # the reads whose private base sits mid-read map at their own copy
    own = (np.abs(got["pos"].astype(np.int64) - starts) <= 4) & \
        (got["score"] == L)
    assert own.any()
