"""Port parity for the Feature Barcode device ops of cellranger_tpu_torch:
the exact bucket table with its count column (`build_exact`,
`with_counts`, `membership3`), the device posterior barcode correction
(`correct_barcodes`) and the feature extractor (`make_feature_extractor`)
for anchored-5', anchored-3' and unanchored patterns and on the antibody
library of the rich fixture.  Same numpy inputs to both packages;
tolerance 0.
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
