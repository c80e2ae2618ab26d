"""Port parity for the Feature Barcode device ops of cellranger_tpu_torch:
the exact bucket table with its count column (`build_exact`,
`with_counts`, `membership3`), the device posterior barcode correction
(`correct_barcodes`) and the feature extractor (`make_feature_extractor`)
for anchored-5', anchored-3' and unanchored patterns and on the antibody
library of the rich fixture, and Feature Barcodes of 17-24 bases (CRISPR
protospacers), which both packages match on their last 16 bases.  Same
numpy inputs to both packages; tolerance 0.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.io.feature_ref import \
    FeatureBarcodeReference as JaxFeatureRef
from cellranger_tpu.ops import barcode as jbc
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.ops.features import \
    make_feature_extractor as jax_make_extractor
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.io.fastq import batches_from_fastqs
from cellranger_tpu_torch.io.feature_ref import FeatureBarcodeReference
from cellranger_tpu_torch.ops import barcode as tbc
from cellranger_tpu_torch.ops import encode
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.ops.features import make_feature_extractor
from cellranger_tpu_torch.testing.fixtures import (RICH_AB_SEQS,
                                                   build_rich_run)

AB_SEQS = ["ACGTACGTACGTACG", "TTTTGGGGCCCCAAA", "GACGACGACGACGAC",
           "CTCTCTCTCTCTCTC"]


def _t(a):
    """numpy uint32 -> torch int64 u32 values; other dtypes as they are."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(keys, counts, entries=8):
    vals = np.arange(len(keys), dtype=np.uint32)
    jt = JaxBucketTable.build_exact(keys, vals, entries=entries, fields=3) \
        .with_counts(counts)
    tt = BucketTable.build_exact(keys, vals, "cpu", entries=entries,
                                 fields=3).with_counts(counts)
    return jt, tt


@pytest.mark.parametrize("n,entries", [(300, 8), (5000, 2)])
def test_exact_table_with_counts_and_membership3(n, entries):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                     .astype(np.uint32))
    counts = rng.integers(0, 1000, len(keys)).astype(np.int64)
    jt, tt = _tables(keys, counts, entries)
    assert (tt.bits, tt.probe_rows) == (jt.bits, jt.probe_rows)
    np.testing.assert_array_equal(tt.rows.numpy().view(np.uint32),
                                  np.asarray(jt.rows))
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 32, 200,
                                                dtype=np.uint64)
                        .astype(np.uint32), [0xFFFFFFFF]]).astype(np.uint32)
    q = q.reshape(-1, 1)       # queries of any rank, as candidates are
    want = jt.membership3(jnp.asarray(q))
    got = tt.membership3(_t(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _correction_case(seed, L=16, n_wl=400, B=600):
    rng = np.random.default_rng(seed)
    wl = np.unique(rng.integers(0, 1 << (2 * L), n_wl, dtype=np.uint64)
                   .astype(np.uint32))
    shifts = 2 * (L - 1 - np.arange(L))
    # a tie: two whitelist barcodes two substitutions apart and a query
    # one substitution from each, with equal counts and quals (the
    # larger barcode wins the argmax; the posterior rejects it)
    a = wl[0]
    b = a ^ np.uint32(1 << shifts[2]) ^ np.uint32(2 << shifts[9])
    mid = a ^ np.uint32(1 << shifts[2])
    wl = np.unique(np.concatenate([wl, [b]]).astype(np.uint32))
    counts = rng.integers(0, 50, len(wl)).astype(np.int64)
    counts[np.searchsorted(wl, a)] = counts[np.searchsorted(wl, b)] = 7
    base = wl[rng.integers(0, len(wl), B)]
    pos = rng.integers(0, L, B)
    d = rng.integers(1, 4, B).astype(np.uint32)
    q = base ^ (d << shifts[pos].astype(np.uint32))
    q[:50] = rng.integers(0, 1 << (2 * L), 50, dtype=np.uint64) \
        .astype(np.uint32)
    q[50] = mid
    quals = rng.integers(35, 75, (B, L)).astype(np.uint8)
    quals[50] = 60
    return wl, counts, q.astype(np.uint32), quals


@pytest.mark.parametrize("seed", [0, 1])
def test_correct_barcodes_matches_jax(seed):
    L = 16
    wl, counts, q, quals = _correction_case(seed, L)
    jt, tt = _tables(wl, counts)
    want = jbc.correct_barcodes(jnp.asarray(q), jnp.asarray(quals), jt, L)
    got = tbc.correct_barcodes(_t(q), torch.from_numpy(quals), tt, L)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    acc = got[2].numpy()
    assert 50 < acc.sum() < len(q)
    assert not acc[50]          # a likelihood tie is never 0.975 of total


def _write_csv(tmp_path, pattern, read="R2"):
    p = tmp_path / "features.csv"
    with open(p, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for i, s in enumerate(AB_SEQS):
            f.write(f"AB{i},Ab{i},{read},{pattern},{s},Antibody Capture\n")
    return str(p)


def _extractors(csv, read_len):
    """(jax extract, torch extract) per pattern of the reference."""
    jref = JaxFeatureRef.from_csv(csv)
    tref = FeatureBarcodeReference.from_csv(csv)
    out = []
    for (jp, (js, jf)), (tp, (ts, tf)) in zip(jref.pattern_groups.items(),
                                              tref.pattern_groups.items()):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tf, jf)
        assert tp.__dict__ == jp.__dict__
        ones = np.ones(len(js), np.int64)
        jt = JaxBucketTable.build_exact(
            js, np.arange(len(js), dtype=np.uint32), entries=8,
            fields=3).with_counts(ones)
        tt = BucketTable.build_exact(
            ts, np.arange(len(ts), dtype=np.uint32), "cpu", entries=8,
            fields=3).with_counts(ones)
        out.append((jax_make_extractor(jp, jt, jf, read_len),
                    make_feature_extractor(tp, tt, tf, read_len)))
    return out


def _compare(jex, tex, rna, nm, ln):
    want = jex(jnp.asarray(rna), jnp.asarray(nm), jnp.asarray(ln))
    got = tex(torch.from_numpy(rna), torch.from_numpy(nm),
              torch.from_numpy(ln))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    return got


def _random_reads(seed, read_len, prefix, suffix="", B=300):
    """Reads holding a (sometimes mutated) feature barcode after `prefix`
    at a random offset, with N bases and short reads mixed in."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(B):
        s = AB_SEQS[i % 4]
        if i % 5 == 1:          # one substitution: corrected
            p = int(rng.integers(len(s)))
            s = s[:p] + "ACGT"[("ACGT".index(s[p]) + 1) % 4] + s[p + 1:]
        elif i % 5 == 2:        # not a feature barcode
            s = "".join(rng.choice(list("ACGT"), len(s)))
        lead = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 12))))
        r = lead + prefix + s + suffix
        if not suffix:          # 3'-anchored reads end at the suffix
            r += "".join(rng.choice(list("ACGT"),
                                    max(read_len - len(r), 0)))
        r = r[:read_len]
        if i % 11 == 3:
            j = int(rng.integers(len(r)))
            r = r[:j] + "N" + r[j + 1:]
        if i % 13 == 4:
            r = r[:int(rng.integers(10, 40))]
        reads.append(r)
    rna = np.zeros((B, read_len), np.uint8)
    nm = np.zeros((B, read_len), bool)
    ln = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c, v = encode.encode_str(r)
        rna[i, :len(c)] = c
        nm[i, :len(c)] = v
        ln[i] = len(c)
    return rna, nm, ln


@pytest.mark.parametrize("pattern,prefix,suffix", [
    ("5PNNNNNNNNNN(BC)", "", ""),          # anchored 5'
    ("5PTTGCNNNNNN(BC)", "", ""),          # anchored 5' with fixed bases
    ("(BC)GCTTTAAGGCCGGTCCTAGCAA3P", "", "GCTTTAAGGCCGGTCCTAGCAA"),
    ("TTGCTAGGACC(BC)", "TTGCTAGGACC", ""),  # unanchored
])
def test_feature_extractor_matches_jax(tmp_path, pattern, prefix, suffix):
    read_len = 60
    (jex, tex), = _extractors(_write_csv(tmp_path, pattern), read_len)
    rna, nm, ln = _random_reads(len(pattern), read_len, prefix, suffix)
    if pattern.startswith("5P"):   # anchored reads start at the read
        for i in range(len(rna)):
            if i % 3 == 0:
                rna[i, :10] = encode.encode_str("TTGCAAAAAA")[0]
                rna[i, 10:10 + 15] = encode.encode_str(AB_SEQS[i % 4])[0]
                nm[i, :25] = True
    got = _compare(jex, tex, rna, nm, ln)
    assert got["found"].any() and not got["found"].all()


def test_feature_extractor_rich_antibody_batch(tmp_path):
    fx = build_rich_run(str(tmp_path / "rich"), n_cells=20)
    (jex, tex), = _extractors(fx["feature_ref"], 91)
    chem = get_chemistry("SC3Pv3")
    batch = next(iter(batches_from_fastqs(chem, fx["ab_fq1"], fx["ab_fq2"],
                                          512, 91)))
    got = _compare(jex, tex, batch.rna, batch.rna_nmask, batch.rna_len)
    n = batch.n_reads
    found = got["found"].numpy()[:n]
    assert found.all() and got["corrected"].numpy()[:n].any()
    assert set(got["feature"].numpy()[:n]) == set(range(len(RICH_AB_SEQS)))


def test_run_count_feature_library_without_bam_matches_jax(tmp_path):
    """GEX + Antibody Capture without BAM: accumulate-mode GEX steps whose
    rows spill beside the feature rows, partition dedup with raw-triple
    views, aggregate removal and GEX-only cell calling, against the JAX
    package's run_count."""
    from cellranger_tpu.pipeline import count as jax_count
    from cellranger_tpu_torch.pipeline import count as tcount
    from test_torch_count import _compare_runs

    fx = build_rich_run(str(tmp_path / "fx"), n_cells=40)
    outs, sums = {}, {}
    for name, mod in (("torch", tcount), ("jax", jax_count)):
        cfg = mod.CountConfig(
            fastq_pairs=[], reference_path=fx["ref"],
            whitelist_path=fx["wl"], feature_ref_csv=fx["feature_ref"],
            libraries=[mod.LibraryDef([(fx["fq1"], fx["fq2"])]),
                       mod.LibraryDef([(fx["ab_fq1"], fx["ab_fq2"])],
                                      "Antibody Capture")],
            chemistry="SC3Pv3", read_len=91, batch_size=1024,
            checkpoint=False, secondary_analysis=False)
        outs[name] = str(tmp_path / name)
        kw = dict(device="cpu") if mod is tcount else {}
        sums[name] = mod.run_count(cfg, outs[name], **kw)
    _compare_runs(outs["torch"], outs["jax"], sums["torch"], sums["jax"])
    assert sums["torch"]["total_reads"] == fx["n_reads"]
    assert not os.path.exists(os.path.join(outs["torch"],
                                           "possorted_genome_bam.bam"))


# a CMO sequence at least 5 bases from each of RICH_AB_SEQS
SHARED_CMO_SEQ = "GGAAAAATTAAAAAG"


def test_antibody_library_counts_a_cmo_sequence_under_the_cmo(tmp_path):
    """CMOs and TotalSeq-B antibodies share the pattern
    5PNNNNNNNNNN(BC) on R2, so the feature reference puts both types in
    one pattern group (one bucket table, one extractor), and every Feature
    Barcode library's reads are matched against every group, whatever the
    library's type: an Antibody Capture library's read that carries a
    CMO's sequence is counted under that CMO.  This is the reference's
    behaviour, pinned here; both packages' run_count do it alike."""
    import gzip

    from cellranger_tpu.pipeline import count as jax_count
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.pipeline import count as tcount
    from test_torch_count import _compare_runs

    fx = build_rich_run(str(tmp_path / "fx"), n_cells=40)
    assert all(sum(a != b for a, b in zip(SHARED_CMO_SEQ, s)) >= 5
               for s in RICH_AB_SEQS)
    fref = str(tmp_path / "features.csv")
    with open(fx["feature_ref"]) as f, open(fref, "w") as g:
        g.write(f.read() + f"CMO301,CMO301,R2,5PNNNNNNNNNN(BC),"
                f"{SHARED_CMO_SEQ},Multiplexing Capture\n")
    # the antibody library's reads, then 5 CMO molecules in each of 8 cells
    rng = np.random.default_rng(3)
    cmo_reads = [(fx["wl_seqs"][c] + "".join(rng.choice(list("ACGT"), 12)),
                  "T" * 10 + SHARED_CMO_SEQ + "A" * (91 - 25))
                 for c in fx["cells"][:8] for _ in range(5)]
    fqs = []
    for r, src in enumerate((fx["ab_fq1"], fx["ab_fq2"])):
        with gzip.open(src, "rt") as f:
            text = f.read()
        text += "".join(f"@cmo{i}\n{p[r]}\n+\n{'I' * len(p[r])}\n"
                        for i, p in enumerate(cmo_reads))
        fqs.append(str(tmp_path / f"ab_S1_L001_R{r + 1}_001.fastq.gz"))
        with gzip.open(fqs[-1], "wt") as f:
            f.write(text)

    outs, sums = {}, {}
    for name, mod in (("torch", tcount), ("jax", jax_count)):
        cfg = mod.CountConfig(
            fastq_pairs=[], reference_path=fx["ref"],
            whitelist_path=fx["wl"], feature_ref_csv=fref,
            libraries=[mod.LibraryDef([(fx["fq1"], fx["fq2"])]),
                       mod.LibraryDef([tuple(fqs)], "Antibody Capture")],
            chemistry="SC3Pv3", read_len=91, batch_size=1024,
            checkpoint=False, secondary_analysis=False)
        outs[name] = str(tmp_path / name)
        kw = dict(device="cpu") if mod is tcount else {}
        sums[name] = mod.run_count(cfg, outs[name], **kw)
    _compare_runs(outs["torch"], outs["jax"], sums["torch"], sums["jax"])
    assert sums["torch"]["total_reads"] == fx["n_reads"] + len(cmo_reads)
    raw = CountMatrix.load_h5(os.path.join(outs["torch"],
                                           "raw_feature_bc_matrix.h5"))
    ids = [d.id for d in raw.features.feature_defs]
    per_feature = np.asarray(raw.m.sum(1)).ravel()
    assert per_feature[ids.index("CMO301")] == len(cmo_reads)
    assert [per_feature[ids.index(f"AB{i}")] for i in range(4)] == \
        fx["ab_truth"].sum(1).tolist()


# Feature Barcodes longer than 16 bases (CRISPR protospacers are 19-20):
# both packages pack the barcode into a uint32 word, so the first bc_len -
# 16 bases fall off and a guide is matched on its last 16 bases
GUIDE_PREFIX = "TTCCAGCATAGCTCTTAAAC"   # the SpCas9 scaffold's 5' end, rc
GUIDE_KINDS = ("clean", "substitution", "double", "n_prefix", "random",
               "short")


def _long_guides(bc_len, n=24, seed=7):
    """n random guides of bc_len bases, their last 16 bases at least 3
    apart, so that a substitution there corrects back uniquely."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        g = "".join(rng.choice(list("ACGT"), bc_len))
        if all(sum(a != b for a, b in zip(g[-16:], h[-16:])) >= 3
               for h in out):
            out.append(g)
    return out


def _guide_csv(tmp_path, guides, pattern):
    p = tmp_path / "guides.csv"
    with open(p, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for i, g in enumerate(guides):
            f.write(f"G{i},g{i},R2,{pattern},{g},CRISPR Guide Capture\n")
    return str(p)


def _guide_reads(guides, prefix, anchored, read_len, seed, B=480):
    """Reads of each GUIDE_KINDS in turn: a guide after `prefix` (at an
    offset of 0-31 bases when unanchored), with one substitution at each
    guide position in turn, with the prefix twice (the second copy before
    another guide), with an N in the prefix, a random read, a read cut
    short.  -> (rna, nmask, rna_len, kind, substituted position or -1)."""
    rng = np.random.default_rng(seed)
    bc_len = len(guides[0])
    rand = lambda n: "".join(rng.choice(list("ACGT"), n))  # noqa: E731
    rna = np.zeros((B, read_len), np.uint8)
    nm = np.zeros((B, read_len), bool)
    ln = np.zeros(B, np.int32)
    kinds = np.arange(B) % len(GUIDE_KINDS)
    sub_pos = np.full(B, -1)
    for i in range(B):
        kind = GUIDE_KINDS[kinds[i]]
        g = guides[i % len(guides)]
        if kind == "substitution":
            p = sub_pos[i] = (i // len(GUIDE_KINDS)) % bc_len
            g = g[:p] + "ACGT"[("ACGT".index(g[p]) + 1 + i % 3) % 4] \
                + g[p + 1:]
        pre = prefix
        if kind == "n_prefix":
            j = int(rng.integers(len(pre)))
            pre = pre[:j] + "N" + pre[j + 1:]
        body = pre + g
        if kind == "double":
            body += prefix + guides[(i + 1) % len(guides)]
        room = read_len - len(body)
        lead = "" if anchored else rand(int(rng.integers(0, min(32, room)
                                                         + 1)))
        r = lead + body
        if kind == "random":
            r = rand(read_len)
        r += rand(read_len - len(r))
        if kind == "short":
            r = r[:len(lead) + len(pre) + bc_len - 3]
        c, v = encode.encode_str(r)
        rna[i, :len(c)], nm[i, :len(c)], ln[i] = c, v, len(c)
    return rna, nm, ln, kinds, sub_pos


@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "5P"])
@pytest.mark.parametrize("bc_len", [16, 17, 19, 20, 24])
def test_long_feature_barcode_extractor_matches_jax(tmp_path, bc_len,
                                                    anchored):
    """Guides of 16-24 bases behind the unanchored guide prefix (at offsets
    0-31, twice in some reads, with an N in some) and behind a 5P leader:
    every extractor output equal to the JAX package's, a substitution at
    every guide position included.  A substitution in the first bc_len -
    16 bases is an exact hit on the last 16; one in the last 16 is
    corrected; the first copy of a doubled prefix wins."""
    guides = _long_guides(bc_len)
    prefix = "NNNNNNNNNN" if anchored else GUIDE_PREFIX
    pattern = (f"5P{prefix}(BC)" if anchored else f"{prefix}(BC)")
    read_len = 100
    (jex, tex), = _extractors(_guide_csv(tmp_path, guides, pattern),
                              read_len)
    read_prefix = "ACGTTGCAAC" if anchored else prefix
    rna, nm, ln, kinds, sub_pos = _guide_reads(
        guides, read_prefix, anchored, read_len, seed=bc_len)
    got = {k: v.numpy() for k, v in _compare(jex, tex, rna, nm, ln).items()}
    kind = np.asarray(GUIDE_KINDS)[kinds]
    own = np.arange(len(kinds)) % len(guides)
    sure = np.isin(kind, ("clean", "substitution", "double"))
    assert got["found"][sure].all()
    assert (got["seq_idx"][sure] >= 0).all()
    assert not got["found"][np.isin(kind, ("short",))].any()
    # the feature index is the guide's row in the CSV
    assert (got["feature"][sure] == own[sure]).all()
    sub = kind == "substitution"
    head = sub & (sub_pos < bc_len - 16)
    assert set(sub_pos[sub]) == set(range(bc_len))
    assert not got["corrected"][head].any()
    assert got["corrected"][sub & ~head].all()
    assert not got["corrected"][np.isin(kind, ("clean", "double"))].any()
    if not anchored:
        assert not got["extracted"][kind == "n_prefix"].any()
        starts = np.asarray([bytes(encode.decode_codes(r[:n])).find(
            prefix.encode()) for r, n in zip(rna, ln)])
        assert (got["offset"][sure] == starts[sure] + len(prefix)).all()


def test_long_feature_barcode_words_in_the_table(tmp_path):
    """The feature reference's words of 17-24-base sequences are their last
    16 bases, in both packages; the exact tables built over them answer
    membership alike for the members, for each 20-base read word and for
    words off the table."""
    for bc_len in (17, 19, 20, 24):
        guides = _long_guides(bc_len)
        csv = _guide_csv(tmp_path, guides, f"{GUIDE_PREFIX}(BC)")
        (_, (js, _)), = JaxFeatureRef.from_csv(csv).pattern_groups.items()
        (_, (ts, _)), = FeatureBarcodeReference.from_csv(
            csv).pattern_groups.items()
        np.testing.assert_array_equal(ts, js)
        last16 = sorted(int(encode.pack_codes_np(
            encode.encode_str(g[-16:])[0], 16)) for g in guides)
        assert ts.tolist() == last16
        jt, tt = _tables(ts, np.ones(len(ts), np.int64))
        rng = np.random.default_rng(bc_len)
        q = np.concatenate([ts, rng.integers(0, 1 << 32, 100,
                                             dtype=np.uint64)
                            .astype(np.uint32)])
        want = jt.membership(jnp.asarray(q))
        got = tt.membership(_t(q))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].numpy()[:len(ts)].all()


def test_correct_barcodes_at_20_bases_matches_jax():
    """correct_barcodes at length 20 on words that are not in the table.
    The candidates of the first four positions shift by 32-38 bits: the
    JAX package's uint32 shift gives 0 there (the candidate is the word
    itself, not a member), the port's int64 shift a word above 2**32 (no
    member either), so every output is equal; on a member the two differ
    in `accepted`, which the extractor masks with the exact hit."""
    L = 20
    guides = _long_guides(L, n=200, seed=3)
    words = np.asarray(sorted({int(encode.pack_codes_np(
        encode.encode_str(g)[0], L)) & 0xFFFFFFFF for g in guides}),
        np.uint32)
    counts = np.random.default_rng(1).integers(0, 50, len(words))
    jt, tt = _tables(words, counts.astype(np.int64))
    rng = np.random.default_rng(2)
    B = 600
    shifts = 2 * (L - 1 - np.arange(L))
    pos = rng.integers(4, L, B)         # positions the word holds
    d = rng.integers(1, 4, B).astype(np.uint64)
    q = (words[rng.integers(0, len(words), B)].astype(np.uint64)
         ^ (d << shifts[pos].astype(np.uint64))).astype(np.uint32)
    q[:60] = rng.integers(0, 1 << 32, 60, dtype=np.uint64).astype(np.uint32)
    q = q[~np.isin(q, words)]
    quals = rng.integers(35, 75, (len(q), L)).astype(np.uint8)
    want = jbc.correct_barcodes(jnp.asarray(q), jnp.asarray(quals), jt, L)
    got = tbc.correct_barcodes(_t(q), torch.from_numpy(quals), tt, L)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 400 < got[2].numpy().sum() < len(q)
