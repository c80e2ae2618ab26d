"""The port's BAM and Feature Barcode runs against the checked-in golden
snapshots that gate the JAX package (tests/test_conformance.py):

  * the tiny fixture with BAM (tests/e2e_drive.py `run`) against
    tests/golden/e2e;
  * the rich fixture, Gene Expression + Antibody Capture with BAM
    (tests/e2e_drive.py `run_rich`), against tests/golden/e2e_rich;
  * a BAM run killed at BAM write time resumes from its sealed band spool
    without re-reading FASTQs and writes the same records;
  * the port's `build_rich_run` writes the same files as the JAX one.

Metrics, MEX and BAM go through the port's testing.correctness; the
filtered h5 and molecule_info.h5 are read by real h5py (the JAX
package's comparators plus chunks and filters), never by the port's own
HDF5 layer; filtered_barcodes.csv and junctions.tsv byte for byte.
"""

import filecmp
import os

import pytest

from cellranger_tpu.testing import fixtures as jax_fixtures
from cellranger_tpu_torch.io.bam_read import read_bam
from cellranger_tpu_torch.pipeline import bam_out
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing import correctness as cc
from cellranger_tpu_torch.testing.fixtures import (READ_LEN, build_rich_run,
                                                   build_synthetic_run)
from test_torch_hdf5 import h5_parity_diffs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _assert_golden(out, golden):
    cc.assert_metrics(os.path.join(out, "metrics_summary.json"),
                      os.path.join(golden, "metrics_summary.json"))
    for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
        cc.assert_mtx(os.path.join(out, "raw_feature_bc_matrix", f),
                      os.path.join(golden, "raw_feature_bc_matrix", f))
    h5 = "filtered_feature_bc_matrix.h5"
    assert not h5_parity_diffs(os.path.join(out, h5), os.path.join(golden, h5))
    h5 = "molecule_info.h5"
    assert not h5_parity_diffs(os.path.join(out, h5), os.path.join(golden, h5),
                               molecule_info=True)
    cc.assert_bam(os.path.join(out, "possorted_genome_bam.bam"),
                  os.path.join(golden, "possorted_genome_bam.bam"))
    for f in ("filtered_barcodes.csv", "junctions.tsv"):
        with open(os.path.join(out, f)) as fa, \
                open(os.path.join(golden, f)) as fe:
            assert fa.read() == fe.read(), f"{f} differs from golden"


def test_tiny_bam_run_matches_golden(tmp_path):
    fx = build_synthetic_run(str(tmp_path / "fx"))
    cfg = tcount.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], chemistry="SC3Pv3", read_len=READ_LEN,
        batch_size=4096, write_bam=True, secondary_analysis=False)
    out = str(tmp_path / "outs")
    s = tcount.run_count(cfg, out, device="cpu")
    assert s["total_molecules"] == int(fx["truth"].sum())
    _assert_golden(out, os.path.join(GOLDEN, "e2e"))


def _rich_cfg(fx, **kw):
    return tcount.CountConfig(
        fastq_pairs=[], reference_path=fx["ref"], whitelist_path=fx["wl"],
        feature_ref_csv=fx["feature_ref"],
        libraries=[tcount.LibraryDef([(fx["fq1"], fx["fq2"])]),
                   tcount.LibraryDef([(fx["ab_fq1"], fx["ab_fq2"])],
                                     "Antibody Capture")],
        chemistry="SC3Pv3", read_len=READ_LEN, batch_size=4096,
        write_bam=True, checkpoint=False, secondary_analysis=False, **kw)


def test_rich_bam_feature_run_matches_golden(tmp_path):
    fx = build_rich_run(str(tmp_path / "fx"))
    out = str(tmp_path / "outs")
    s = tcount.run_count(_rich_cfg(fx), out, device="cpu")
    assert s["total_reads"] == fx["n_reads"]
    _assert_golden(out, os.path.join(GOLDEN, "e2e_rich"))
    _, recs, _ = read_bam(os.path.join(out, "possorted_genome_bam.bam"))
    assert any(r["flag"] & 256 for r in recs), "no secondary records"
    assert any("fb" in r["tags"] for r in recs), "no feature records"


def _records(out):
    _, recs, _ = read_bam(os.path.join(out, "possorted_genome_bam.bam"))
    return [(r["name"], r["flag"], r["ref_id"], r["pos"], r["mapq"],
             tuple(r["cigar"]), r["seq"], tuple(sorted(r["tags"].items())))
            for r in recs]


def test_bam_run_resumes_from_sealed_spool(tmp_path, monkeypatch):
    fx = build_synthetic_run(str(tmp_path / "fx"), seed=21, n_cells=30,
                             mols_per_cell=20)
    cfg = tcount.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], read_len=READ_LEN, batch_size=1024,
        write_bam=True, secondary_analysis=False, checkpoint=True)
    out_ref = str(tmp_path / "ref_run")
    tcount.run_count(cfg, out_ref, device="cpu")
    ref_records = _records(out_ref)
    assert ref_records

    # attempt 1 dies at BAM write time: checkpoint + sealed spool on disk
    real_write = bam_out.BamCollector.write

    def boom(self, *a, **k):
        raise RuntimeError("killed mid-run")

    out2 = str(tmp_path / "resumed_run")
    monkeypatch.setattr(bam_out.BamCollector, "write", boom)
    with pytest.raises(RuntimeError, match="killed"):
        tcount.run_count(cfg, out2, device="cpu")
    monkeypatch.setattr(bam_out.BamCollector, "write", real_write)
    assert os.path.isdir(os.path.join(out2, "_bam_spool"))

    # attempt 2 must not re-read the FASTQs
    def no_pass(*a, **k):
        raise AssertionError("FASTQ pass re-executed on resume")

    monkeypatch.setattr(tcount, "batches_from_fastqs", no_pass)
    s = tcount.run_count(cfg, out2, device="cpu")
    assert s["total_reads"] == fx["n_reads"]
    assert _records(out2) == ref_records
    assert not os.path.isdir(os.path.join(out2, "_bam_spool"))


def test_build_rich_run_matches_jax(tmp_path):
    kw = dict(n_cells=12)
    t = build_rich_run(str(tmp_path / "torch"), **kw)
    j = jax_fixtures.build_rich_run(str(tmp_path / "jax"), **kw)
    for k in ("fq1", "fq2", "ab_fq1", "ab_fq2", "feature_ref", "wl"):
        assert filecmp.cmp(t[k], j[k], shallow=False), k
    for name in ("genome.fa", "genes.gtf"):
        assert filecmp.cmp(str(tmp_path / "torch" / name),
                           str(tmp_path / "jax" / name), shallow=False)
    cmp = filecmp.dircmp(t["ref"], j["ref"])
    assert sorted(cmp.left_list) == sorted(cmp.right_list)
    assert not cmp.diff_files, cmp.diff_files
    for k in ("n_reads", "n_gex_reads", "wl_seqs"):
        assert t[k] == j[k]
    assert (t["truth"] == j["truth"]).all()
    assert (t["ab_truth"] == j["ab_truth"]).all()
    assert (t["cells"] == j["cells"]).all()


def test_cli_count_bam(tmp_path, capsys):
    """`python -m cellranger_tpu_torch count --bam` writes the BAM."""
    from cellranger_tpu_torch import cli

    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=10)
    cli.main(["count", "--id", "S", "--fastqs", str(tmp_path / "fx"),
              "--reference", fx["ref"], "--whitelist", fx["wl"],
              "--chemistry", "SC3Pv3", "--batch-size", "512", "--bam",
              "--device", "cpu", "--output-dir", str(tmp_path)])
    out = tmp_path / "S" / "outs"
    assert (out / "possorted_genome_bam.bam").exists()
    assert len(read_bam(str(out / "possorted_genome_bam.bam"))[1]) \
        >= fx["n_reads"]
    assert '"total_reads"' in capsys.readouterr().out


CRISPR_SEQS = ["ACGTACGTACGTACG", "TTTTGGGGCCCCAAA", "GACGACGACGACGAC",
               "CTCTCTCTCTCTCTC"]
# 20-base protospacers, as real guides are: matched on their last 16 bases
CRISPR_SEQS_20 = ["GTCAACGTACGTACGTACGA", "CAGTTTTTGGGGCCCCAAAC",
                  "AGCTGACGACGACGACGACG", "TGCACTCTCTCTCTCTCTCA"]


def _write_crispr_library(tmp_path, fx, seed=5, seqs=CRISPR_SEQS):
    """A CRISPR Guide Capture library with one R1 pattern and one R2
    pattern: guides 0/1 sit in R1 after bc + umi + a fixed anchor, guides
    2/3 at a fixed offset in R2; some reads carry both."""
    import gzip
    import numpy as np

    g = len(seqs[0])
    fcsv = str(tmp_path / "guides.csv")
    with open(fcsv, "w") as f:
        f.write("id,name,read,pattern,sequence,feature_type\n")
        for i, sq in enumerate(seqs):
            read, pat = (("R1", "TTGCTAGGACC(BC)") if i < 2
                         else ("R2", "5PNNNNNNNNNN(BC)"))
            f.write(f"GUIDE{i},g{i},{read},{pat},{sq},"
                    "CRISPR Guide Capture\n")
    rng = np.random.default_rng(seed)
    rand = lambda n: "".join(rng.choice(list("ACGT"), n))  # noqa: E731
    r1p = str(tmp_path / "cr_S1_L001_R1_001.fastq.gz")
    r2p = str(tmp_path / "cr_S1_L001_R2_001.fastq.gz")
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        n = 0
        for ci, c in enumerate(fx["cells"][:30]):
            bc = fx["wl_seqs"][c]
            for u in range(24):
                umi = rand(12)
                r1 = bc + umi + rand(4) + "TTGCTAGGACC" + seqs[ci % 2]
                r2 = "T" * 10 + seqs[2 + ci % 2] + rand(61 - g)
                if u % 3 == 0:      # R1 guide only
                    r2 = rand(71)
                elif u % 3 == 1:    # R2 guide only
                    r1 = bc + umi + rand(15 + g)
                f1.write(f"@c{n}\n{r1}\n+\n{'F' * len(r1)}\n")
                f2.write(f"@c{n}\n{r2}\n+\n{'F' * len(r2)}\n")
                n += 1
    return fcsv, r1p, r2p


def _crispr_two_pattern_run(tmp_path, seqs):
    """Both packages' run_count with BAM on the rich fixture and a CRISPR
    library of `seqs` (`_write_crispr_library`): outputs, BAM and the
    protospacer calls held equal; returns the port's BAM records."""
    from cellranger_tpu.pipeline import count as jax_count
    from test_torch_count import _compare_runs

    fx = build_rich_run(str(tmp_path / "fx"), n_cells=40)
    fcsv, r1p, r2p = _write_crispr_library(tmp_path, fx, seqs=seqs)
    outs, sums = {}, {}
    for name, mod in (("torch", tcount), ("jax", jax_count)):
        cfg = mod.CountConfig(
            fastq_pairs=[], reference_path=fx["ref"],
            whitelist_path=fx["wl"], feature_ref_csv=fcsv,
            libraries=[mod.LibraryDef([(fx["fq1"], fx["fq2"])]),
                       mod.LibraryDef([(r1p, r2p)], "CRISPR Guide Capture")],
            chemistry="SC3Pv3", read_len=READ_LEN, batch_size=1024,
            write_bam=True, checkpoint=False, secondary_analysis=False)
        outs[name] = str(tmp_path / name)
        kw = dict(device="cpu") if mod is tcount else {}
        sums[name] = mod.run_count(cfg, outs[name], **kw)
    _compare_runs(outs["torch"], outs["jax"], sums["torch"], sums["jax"])
    cc.assert_bam(os.path.join(outs["torch"], "possorted_genome_bam.bam"),
                  os.path.join(outs["jax"], "possorted_genome_bam.bam"))
    sub = os.path.join("crispr_analysis", "protospacer_calls_per_cell.csv")
    with open(os.path.join(outs["torch"], sub), "rb") as a, \
            open(os.path.join(outs["jax"], sub), "rb") as b:
        assert a.read() == b.read()
    _, recs, _ = read_bam(os.path.join(outs["torch"],
                                       "possorted_genome_bam.bam"))
    fx_tags = {r["tags"].get("fx") for r in recs}
    assert {"GUIDE0", "GUIDE1", "GUIDE2", "GUIDE3"} <= fx_tags
    return recs


def test_crispr_two_pattern_bam_run_matches_jax(tmp_path):
    """R1 and R2 feature patterns in one library (the R1-remainder view,
    one feature per read across patterns), CRISPR feature assignment and
    the feature BAM tags, against the JAX package's run_count."""
    _crispr_two_pattern_run(tmp_path, CRISPR_SEQS)


def test_crispr_two_pattern_bam_run_20_base_guides_matches_jax(tmp_path):
    """The same run with 20-base guides: the port extracts them (it
    refused more than 16 bases before), both packages match them on their
    last 16 bases, and the `fb` tag, the matched sequence unpacked at 20
    bases from its 16-base word, leads with AAAA in both BAMs; `fr`, the
    bases read, is the whole guide."""
    recs = _crispr_two_pattern_run(tmp_path, CRISPR_SEQS_20)
    fb = {r["tags"]["fb"] for r in recs if "fb" in r["tags"]}
    assert fb == {"AAAA" + s[4:] for s in CRISPR_SEQS_20}
    fr = {r["tags"]["fr"] for r in recs if "fb" in r["tags"]}
    assert set(CRISPR_SEQS_20) <= fr
