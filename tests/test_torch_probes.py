"""Port parity for RTL probe alignment and probe-barcode multiplexing,
tolerance 0:

  * `make_probe_aligner` of both packages on seeded reads that cover exact
    hits, one mismatch in the `hi` word and in the `lo` word of either
    half, two mismatches in a half (rescued), an N inside a half, left-only
    and right-only hits with and without rescue, an excluded probe, a
    mutant that hits two probes, duplicate probe sequences and duplicate
    halves, reads shorter than the probe, junk: `probe`, `gene`,
    `conf_mapped`, `score`, `mapped` are equal, at probe lengths 50, 51
    (odd middle base skipped) and 30 (halves that fit one word);
  * the RTL runs of tests/test_probes.py (SFRP) and the MFRP run of
    tests/test_probe_demux.py through both `run_count`s: equal metrics
    (with `probe_reads_*`), MEX bytes, barcodes in the product space,
    molecule_info, and equal `demux_probe_samples` outputs;
  * a killed-and-resumed probe run keeps its per-region tallies;
  * `testing.fixtures.build_rtl_run` at a small size: its probes are as
    far apart as it says, and the counts it expects by construction are
    the counts the port gives.
"""

import filecmp
import gzip
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.io.probe_set import ProbeSet as JaxProbeSet
from cellranger_tpu.ops.probes import make_probe_aligner as jax_make_aligner
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.pipeline.demux import \
    demux_probe_samples as jax_demux_probe_samples
from cellranger_tpu_torch.io.matrix_io import CountMatrix
from cellranger_tpu_torch.io.probe_set import ProbeSet
from cellranger_tpu_torch.ops import encode
from cellranger_tpu_torch.ops.probes import (PROBE_OUT_FIELDS,
                                             make_probe_aligner,
                                             stack_outputs, unstack_outputs)
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.pipeline.demux import demux_probe_samples
from cellranger_tpu_torch.testing import correctness as cc
from cellranger_tpu_torch.testing.fixtures import (build_rtl_run,
                                                   rtl_probe_barcodes)
from test_probe_demux import PBCS, mfrp_run  # noqa: F401  (fixture)
from test_torch_hdf5 import h5_parity_diffs

ACGT = "ACGT"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _other(base, k=1):
    return ACGT[(ACGT.index(base) + k) % 4]


def _mut(s, *positions):
    s = list(s)
    for k, p in enumerate(positions):
        s[p] = _other(s[p], 1 + k % 3)
    return "".join(s)


def _probe_csv(path, plen, seed=11, n=48):
    """A seeded probe set with planted ties: probes 10/11 share a whole
    sequence, 12/13 share the left half, 14/15 have left halves two bases
    apart (one read is 1-Hamming from both), probe n-1 is excluded."""
    rng = np.random.default_rng(seed)
    half, rhs_start = plen // 2, (plen + 1) // 2
    seqs = ["".join(rng.choice(list(ACGT), plen)) for _ in range(n)]
    seqs[11] = seqs[10]
    seqs[13] = seqs[12][:half] + seqs[13][half:]
    seqs[15] = _mut(seqs[14], 3, half - 2)[:half] + seqs[15][half:]
    with open(path, "w") as f:
        f.write("#probe_set_file_format=1.0\n#panel_name=parity\n")
        f.write("gene_id,probe_seq,probe_id,included,region\n")
        for i, s in enumerate(seqs):
            incl = "FALSE" if i == n - 1 else "TRUE"
            region = "spliced" if i % 3 else "unspliced"
            f.write(f"GENE{i // 4},{s},GENE{i // 4}|p{i},{incl},{region}\n")
    return seqs, half, rhs_start


def _reads(seqs, plen, half, rhs_start):
    rng = np.random.default_rng(2)

    def junk(n):
        return "".join(rng.choice(list(ACGT), n))

    lo_l = min(half - 1, 20)              # a base of the lhs `lo` word
    lo_r = rhs_start + min(plen - rhs_start - 1, 20)
    reads = [
        (seqs[0], None),                              # exact
        (_mut(seqs[1], 5), None),                     # 1 mm, lhs hi word
        (_mut(seqs[2], lo_l), None),                  # 1 mm, lhs lo word
        (_mut(seqs[3], rhs_start + 2), None),         # 1 mm, rhs hi word
        (_mut(seqs[4], lo_r), None),                  # 1 mm, rhs lo word
        (_mut(seqs[5], 4, rhs_start + 7), None),      # 1 mm in each half
        (_mut(seqs[6], 3, 9), None),                  # 2 mm lhs: rescued
        (_mut(seqs[7], rhs_start + 1, rhs_start + 8), None),  # 2 mm rhs
        (_mut(seqs[8], *range(min(11, half))), None),  # lhs: rescue too low
        (seqs[9], 7),                                 # N inside the lhs
        (seqs[9], rhs_start + 3),                     # N inside the rhs
        (seqs[16][:half] + junk(plen - half), None),  # left only, no rescue
        (junk(rhs_start) + seqs[17][rhs_start:], None),   # right only
        (seqs[18][:half] + seqs[19][half:], None),    # halves disagree
        (seqs[-1], None),                             # excluded probe
        (seqs[10], None),                             # duplicate sequence
        (_mut(seqs[11], 2), None),                    # duplicate, 1 mm
        (seqs[12], None), (seqs[13], None),           # shared left half
        (_mut(seqs[14], 3), None),                    # mutant hits 14 and 15
        (seqs[0][:20], None),                         # shorter than a half
        (seqs[0][:half + 3], None),                   # left half only
        (seqs[0][:plen - 1], None),                   # one base short
        (junk(plen), None), ("A" * plen, None), ("T" * plen, None),
    ]
    return reads


def _batch(reads, read_len, B):
    rna = np.zeros((B, read_len), np.uint8)
    nm = np.zeros((B, read_len), bool)
    for i, (r, n_at) in enumerate(reads):
        c, v = encode.encode_str(r)
        rna[i, :len(c)] = c
        nm[i, :len(c)] = v
        if n_at is not None:
            rna[i, n_at] = 0
            nm[i, n_at] = False
    return rna, nm


@pytest.mark.parametrize("plen, read_len, min_score", [
    (50, 50, None), (50, 60, 44), (51, 60, None), (30, 40, 20)])
def test_probe_aligner_matches_jax(tmp_path, plen, read_len, min_score):
    p = str(tmp_path / "probes.csv")
    seqs, half, rhs_start = _probe_csv(p, plen)
    reads = _reads(seqs, plen, half, rhs_start)
    # seeded noise on top of the planted cases: every probe with 0-3
    # random mismatches
    rng = np.random.default_rng(plen)
    for s in seqs:
        k = int(rng.integers(0, 4))
        reads.append((_mut(s, *rng.choice(plen, k, replace=False)), None))
    rna, nm = _batch(reads, read_len, 128)
    want = jax_make_aligner(JaxProbeSet.from_csv(p), read_len,
                            min_score=min_score)(jnp.asarray(rna),
                                                 jnp.asarray(nm))
    align = make_probe_aligner(ProbeSet.from_csv(p), read_len, "cpu",
                               min_score=min_score)
    got = align(torch.from_numpy(rna), torch.from_numpy(nm))
    assert set(got) == set(want) == set(PROBE_OUT_FIELDS)
    for k in PROBE_OUT_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the one-transfer packing round-trips
    back = unstack_outputs(stack_outputs(got).numpy())
    for k in PROBE_OUT_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]))
    if (plen, min_score) == (50, None):
        o = back
        assert o["probe"][:8].tolist() == list(range(8))
        assert o["score"][:8].tolist() == [50, 48, 48, 48, 48, 46, 46, 46]
        assert o["conf_mapped"][:8].all()
        assert not o["mapped"][8]                  # 25 + 3 < min score
        assert o["probe"][9] == 9 and o["probe"][10] == 9       # N: rescued
        assert o["score"][9] == 25 + 23
        assert not o["mapped"][11:14].any()
        assert o["probe"][14] == len(seqs) - 1 and not o["conf_mapped"][14]
        assert o["probe"][15] == 10 and o["probe"][16] == 10    # smallest id
        # a shared left half resolves to the smaller id, which then
        # disagrees with probe 13's own right half
        assert o["probe"][17] == 12 and o["probe"][18] == -1
        assert o["probe"][19] == 14     # ambiguous lhs, rhs rescues it
        assert not o["mapped"][20:22].any() and not o["mapped"][23:26].any()


def test_probe_aligner_refuses_short_read_len(tmp_path):
    p = str(tmp_path / "probes.csv")
    _probe_csv(p, 50)
    with pytest.raises(ValueError, match="shorter"):
        make_probe_aligner(ProbeSet.from_csv(p), 40, "cpu")


# ---- run_count on RTL chemistries, both packages ----

def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _run_both(tmp_path, **kw):
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_sum = tcount.run_count(tcount.CountConfig(**kw), t_out, device="cpu")
    j_sum = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    assert not cc.check_metrics(t_sum, j_sum)
    probe_keys = [k for k in j_sum if k.startswith("probe_reads_")]
    assert probe_keys and all(t_sum[k] == j_sum[k] for k in probe_keys)
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzip(os.path.join(t_out, sub, f)) \
                == _gunzip(os.path.join(j_out, sub, f)), (sub, f)
        assert not h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                                   os.path.join(j_out, sub + ".h5"))
    assert not h5_parity_diffs(
        os.path.join(t_out, "molecule_info.h5"),
        os.path.join(j_out, "molecule_info.h5"), molecule_info=True)
    for f in ("filtered_barcodes.csv", "per_barcode_metrics.csv"):
        assert filecmp.cmp(os.path.join(t_out, f), os.path.join(j_out, f),
                           shallow=False), f
    assert not os.path.exists(os.path.join(t_out, "junctions.tsv"))
    return t_sum, t_out, j_out


def _sfrp_fixture(tmp_path, regions=False):
    """The runs of tests/test_probes.py: 40 probes of 50 bp, 4 per gene."""
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list(ACGT), 50)) for _ in range(40)]
    rng = np.random.default_rng(5 if regions else 77)
    wl = sorted({"".join(rng.choice(list(ACGT), 16))
                 for _ in range(50 if regions else 200)})
    wlp = str(tmp_path / "wl.txt")
    open(wlp, "w").writelines(s + "\n" for s in wl)
    pcsv = str(tmp_path / "probes.csv")
    r1p = str(tmp_path / "t_S1_L001_R1_001.fastq.gz")
    r2p = str(tmp_path / "t_S1_L001_R2_001.fastq.gz")
    truth = {}
    n = 0
    with open(pcsv, "w") as f, gzip.open(r1p, "wt") as f1, \
            gzip.open(r2p, "wt") as f2:
        if regions:
            f.write("gene_id,probe_seq,probe_id,included,region\n")
            for i, s in enumerate(seqs[:8]):
                region = "spliced" if i < 5 else "unspliced"
                f.write(f"G{i},{s},G{i}|p,TRUE,{region}\n")
            for i in range(8):
                for _ in range(3):
                    umi = "".join(rng.choice(list(ACGT), 12))
                    f1.write(f"@q{n}\n{wl[0]}{umi}\n+\n{'F' * 28}\n")
                    f2.write(f"@q{n}\n{seqs[i]}\n+\n{'F' * 50}\n")
                    n += 1
        else:
            f.write("#probe_set_file_format=1.0\n")
            f.write("gene_id,probe_seq,probe_id,included,region\n")
            for i, s in enumerate(seqs):
                f.write(f"GENE{i // 4},{s},GENE{i // 4}|p{i},TRUE,spliced\n")
            for ci in range(15):
                for g in range(5):
                    k = int(rng.integers(3, 8))
                    truth[(wl[ci], g)] = k
                    for _ in range(k):
                        umi = "".join(rng.choice(list(ACGT), 12))
                        probe = seqs[g * 4 + int(rng.integers(4))]
                        f1.write(f"@p{n}\n{wl[ci]}{umi}\n+\n{'F' * 28}\n")
                        f2.write(f"@p{n}\n{probe}\n+\n{'F' * 50}\n")
                        n += 1
    return dict(fastq_pairs=[(r1p, r2p)], probe_set_csv=pcsv,
                whitelist_path=wlp, chemistry="SFRP", read_len=50,
                secondary_analysis=False), truth, n


def test_rtl_pipeline_end_to_end_matches_jax(tmp_path):
    kw, truth, n = _sfrp_fixture(tmp_path)
    s, t_out, _ = _run_both(tmp_path, batch_size=1024, **kw)
    assert s["total_reads"] == n and s["conf_mapped_frac"] == 1.0
    raw = CountMatrix.load_h5(os.path.join(t_out,
                                           "raw_feature_bc_matrix.h5"))
    assert raw.features.ids == [f"GENE{i}" for i in range(10)]
    col = {b: i for i, b in enumerate(raw.barcodes)}
    m = raw.m.toarray()
    for (bc, g), k in truth.items():
        assert m[g, col[bc.encode() + b"-1"]] == k
    with open(os.path.join(t_out, "filtered_barcodes.csv")) as f:
        assert f.readline().startswith("probe,")


def test_rtl_region_metrics_match_jax(tmp_path):
    kw, _, n = _sfrp_fixture(tmp_path, regions=True)
    s, _, _ = _run_both(tmp_path, batch_size=128, **kw)
    assert s["probe_reads_spliced"] == 15
    assert s["probe_reads_unspliced"] == 9


def test_rtl_resume_keeps_region_tallies(tmp_path, monkeypatch):
    kw, _, n = _sfrp_fixture(tmp_path, regions=True)
    cfg = tcount.CountConfig(batch_size=128, **kw)
    out = str(tmp_path / "out")
    first = tcount.run_count(cfg, out, device="cpu")

    def no_pass(*a, **k):
        raise AssertionError("FASTQ pass re-executed on resume")

    monkeypatch.setattr(tcount, "batches_from_fastqs", no_pass)
    again = tcount.run_count(cfg, out, device="cpu")
    assert not cc.check_metrics(again, first)
    assert again["probe_reads_spliced"] == 15


def test_mfrp_run_and_demux_match_jax(mfrp_run, tmp_path):  # noqa: F811
    s = mfrp_run
    summary, t_out, j_out = _run_both(
        tmp_path, fastq_pairs=[(s["r1"], s["r2"])],
        probe_set_csv=s["probes"], whitelist_path=s["wl"],
        chemistry="MFRP-RNA", read_len=50, batch_size=1024,
        probe_barcode_csv=s["pbc"], secondary_analysis=False)
    assert summary["total_reads"] == s["n_reads"]
    assert summary["conf_mapped_frac"] == 1.0
    # barcodes live in the (gel bead x probe barcode) product space
    raw = CountMatrix.load_h5(os.path.join(t_out,
                                           "raw_feature_bc_matrix.h5"))
    assert len(raw.barcodes) == len(s["wl_seqs"]) * len(PBCS)
    col = {b: i for i, b in enumerate(raw.barcodes)}
    m = raw.m.toarray()
    for (bc, pi, g), k in s["truth"].items():
        assert m[g, col[(bc + PBCS[pi]).encode() + b"-1"]] == k

    samples = [dict(sample_id="S1", probe_barcode_ids="BC1|BC2"),
               dict(sample_id="S2", probe_barcode_ids="BC3")]
    t_dx, j_dx = str(tmp_path / "tdx"), str(tmp_path / "jdx")
    got = demux_probe_samples(t_out, samples, s["pbc"], t_dx, device="cpu")
    want = jax_demux_probe_samples(j_out, samples, s["pbc"], j_dx)
    assert got == want and set(got["samples"]) == {"S1", "S2"}
    assert filecmp.cmp(os.path.join(t_dx, "probe_assignments.csv"),
                       os.path.join(j_dx, "probe_assignments.csv"),
                       shallow=False)
    for sid in ("S1", "S2"):
        td = os.path.join(t_dx, "per_sample_outs", sid)
        jd = os.path.join(j_dx, "per_sample_outs", sid)
        mex = "sample_filtered_feature_bc_matrix"
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzip(os.path.join(td, mex, f)) \
                == _gunzip(os.path.join(jd, mex, f)), (sid, f)
        assert not h5_parity_diffs(os.path.join(td, mex + ".h5"),
                                   os.path.join(jd, mex + ".h5"))
        assert filecmp.cmp(os.path.join(td, "metrics_summary.json"),
                           os.path.join(jd, "metrics_summary.json"),
                           shallow=False)


def test_mfrp_needs_a_probe_barcode_csv(mfrp_run, tmp_path):  # noqa: F811
    s = mfrp_run
    cfg = tcount.CountConfig(
        fastq_pairs=[(s["r1"], s["r2"])], probe_set_csv=s["probes"],
        whitelist_path=s["wl"], chemistry="MFRP-RNA", read_len=50)
    with pytest.raises(ValueError, match="probe_barcode_csv"):
        tcount.run_count(cfg, str(tmp_path / "o"), device="cpu")


def test_build_rtl_run_counts_hold(tmp_path):
    fx = build_rtl_run(str(tmp_path / "fx"), n_reads=6000, n_probes=600,
                       n_genes=200, n_cells=30, n_wl=500)
    exp = fx["expected"]
    assert 0 < exp["usable_reads"] < exp["mapped_reads"] < 6000
    assert exp["total_molecules"] * 2 == exp["usable_reads"]
    # probe halves at least 3 apart, probe barcodes at least 3 apart
    ps = ProbeSet.from_csv(fx["probes"])
    codes = np.stack([encode.encode_str(s)[0] for s in ps.sequences])
    for half in (codes[:, :25], codes[:, 25:]):
        d = (half[:, None, :] != half[None, :, :]).sum(2)
        assert d[~np.eye(len(d), dtype=bool)].min() >= 3
    pb = np.asarray([list(s) for s in rtl_probe_barcodes()])
    d = (pb[:, None, :] != pb[None, :, :]).sum(2)
    assert len(pb) == 16 and d[~np.eye(16, dtype=bool)].min() >= 3
    assert int((~ps.included).sum()) == 30
    s = tcount.run_count(tcount.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], probe_set_csv=fx["probes"],
        probe_barcode_csv=fx["probe_barcodes"], whitelist_path=fx["wl"],
        chemistry="MFRP-RNA", read_len=50, batch_size=2048,
        secondary_analysis=False, checkpoint=False),
        str(tmp_path / "out"), device="cpu")
    assert {k: s[k] for k in exp} == exp
    assert s["total_reads"] == 6000 and s["valid_barcode_reads"] == 6000
