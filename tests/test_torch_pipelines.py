"""Port parity for the host pipelines above `run_count`, tolerance 0:

  * `detect_chemistry` of both packages on the cases of
    tests/test_pipeline_extras.py (v3 vs v2, TSO endedness, paired-end vs
    R2-only, MFRP probe barcodes and member resolution, overhang, SC5P-R1,
    failure): equal result dicts, or the same error;
  * `preflight_count` and the `check_*` helpers: equal problem lists;
  * `run_count_gem_wells` (two wells of different depth) and `run_aggr`
    over the two wells: equal summaries, MEX bytes, h5 matrices and
    molecule_info;
  * `demux_overhang_samples` on an SC3Pv3-OH run of both packages;
  * the port's CLI: `mkref`, `mkgtf`, `count --chemistry auto` (detection
    + preflight), `aggr` and `testrun --device cpu` through `main([...])`.

Each package gets its inputs through its own classes; files on disk are
shared.
"""

import filecmp
import gzip
import json
import os

import numpy as np
import pytest
import torch

from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.io.whitelist import Whitelist as JaxWhitelist
from cellranger_tpu.pipeline import aggr as jax_aggr
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.pipeline import preflight as jax_pf
from cellranger_tpu.pipeline.demux import \
    demux_overhang_samples as jax_demux_overhang
from cellranger_tpu.pipeline.detect_chemistry import \
    detect_chemistry as jax_detect
from cellranger_tpu.pipeline.multi_gem import \
    run_count_gem_wells as jax_gem_wells
from cellranger_tpu_torch.cli import main
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.io.reference import ReferencePackage
from cellranger_tpu_torch.io.whitelist import Whitelist
from cellranger_tpu_torch.pipeline import aggr as taggr
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.pipeline import preflight as tpf
from cellranger_tpu_torch.pipeline.demux import demux_overhang_samples
from cellranger_tpu_torch.pipeline.detect_chemistry import detect_chemistry
from cellranger_tpu_torch.pipeline.multi_gem import run_count_gem_wells
from cellranger_tpu_torch.testing import correctness as cc
from cellranger_tpu_torch.testing.fixtures import build_synthetic_run
from test_torch_hdf5 import h5_parity_diffs

ACGT = list("ACGT")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seqs(rng, n, k):
    return sorted({"".join(rng.choice(ACGT, k)) for _ in range(n)})


def _rand(rng, k):
    return "".join(rng.choice(ACGT, k))


def _write(path, seqs):
    with gzip.open(path, "wt") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'F' * len(s)}\n")
    return path


# ---- detect_chemistry cases: (r1, whitelists as name -> seqs, kwargs) ----

def _case_v3(t, v2=False):
    rng = np.random.default_rng(3)
    v3, v2s = _seqs(rng, 200, 16), _seqs(rng, 200, 16)
    src, ul = (v2s, 10) if v2 else (v3, 12)
    r1 = _write(str(t / "r1.fastq.gz"),
                [src[int(rng.integers(200))] + _rand(rng, ul)
                 for _ in range(500)])
    return r1, {"3M-february-2018": v3, "737K-august-2016": v2s}, \
        dict(n_sample=500)


def _case_v2(t):
    return _case_v3(t, v2=True)


def _case_junk(t):
    rng = np.random.default_rng(5)
    wl = _seqs(rng, 50, 16)
    r1 = _write(str(t / "junk.fastq.gz"),
                [_rand(rng, 28) for _ in range(300)])
    return r1, {"3M-february-2018": wl}, dict(n_sample=300)


def _case_tso(t, with_tso=True):
    rng = np.random.default_rng(3)
    wl = _seqs(rng, 100, 16)
    r1 = _write(str(t / "five_S1_L001_R1_001.fastq.gz"),
                [wl[i % 50] + _rand(rng, 10)
                 + ("TTTCTTATATGGG" if with_tso else _rand(rng, 13))
                 + _rand(rng, 40) for i in range(400)])
    return r1, {"737K-august-2016": wl}, \
        dict(candidates=("SC3Pv2", "SC5P-R2"))


def _case_no_tso(t):
    return _case_tso(t, with_tso=False)


def _case_mfrp(t, probe_hit=True, member="rna"):
    rng = np.random.default_rng(5)
    wl = _seqs(rng, 300, 16)
    rna, ab = _seqs(rng, 24, 8), _seqs(rng, 24, 8)
    ab = sorted(set(ab) - set(rna))
    pbcs = rna if member == "rna" else ab
    r1 = _write(str(t / "m_r1.fastq.gz"),
                [wl[i % 300] + _rand(rng, 12) for i in range(400)])
    r2 = _write(str(t / "m_r2.fastq.gz"),
                [_rand(rng, 68) + (pbcs[i % len(pbcs)] if probe_hit
                                   else _rand(rng, 12))
                 for i in range(400)])
    return r1, {"737K-fixed-rna-profiling": wl,
                "probe-barcodes-fixed-rna-profiling-rna": rna,
                "probe-barcodes-fixed-rna-profiling-ab": ab}, \
        dict(candidates=("SFRP", "MFRP-RNA", "MFRP-Ab"), n_sample=400,
             r2_path=r2)


def _case_sfrp(t):
    return _case_mfrp(t, probe_hit=False)


def _case_mfrp_ab(t):
    return _case_mfrp(t, member="ab")


def _case_pe(t, long_r1=True):
    rng = np.random.default_rng(6)
    wl = _seqs(rng, 300, 16)
    r1 = _write(str(t / "pe_r1.fastq.gz"),
                [wl[i % 300] + _rand(rng, 10)
                 + (_rand(rng, 80) if long_r1 else "") for i in range(400)])
    r2 = _write(str(t / "pe_r2.fastq.gz"),
                [_rand(rng, 80) for _ in range(400)])
    return r1, {"737K-august-2016": wl}, \
        dict(candidates=("SC5P-R2", "SC5P-PE"), n_sample=400, r2_path=r2)


def _case_r2_only(t):
    return _case_pe(t, long_r1=False)


def _case_overhang(t, n_bc=1200, oh=True):
    rng = np.random.default_rng(9)
    oh_set = ["AC", "GT", "CA", "TG"]
    wl = sorted({_rand(rng, 7) + (oh_set[i % 4] if oh else _rand(rng, 2))
                 + _rand(rng, 7) for i in range(n_bc)})
    r1 = _write(str(t / "oh_S1_L001_R1_001.fastq.gz"),
                [wl[i % len(wl)] + _rand(rng, 12) for i in range(1500)])
    return r1, {"3M-february-2018": wl}, \
        dict(candidates=("SC3Pv3",), n_sample=1500)


def _case_plain(t):
    return _case_overhang(t, oh=False)


def _case_low_complexity(t):
    return _case_overhang(t, n_bc=40)


def _case_sc5p_r1(t, with_r2=False):
    rng = np.random.default_rng(13)
    wl = _seqs(rng, 200, 16)
    cdna = [_rand(rng, 60) for _ in range(400)]
    r1 = _write(str(t / "r1only_S1_L001_R1_001.fastq.gz"),
                [wl[i % 200] + _rand(rng, 10) + "TTTCTTATATGGG" + cdna[i]
                 for i in range(400)])
    kw = dict(candidates=("SC3Pv2", "SC5P-R2", "SC5P-R1"), n_sample=400)
    if with_r2:
        kw["r2_path"] = _write(str(t / "r1only_S1_L001_R2_001.fastq.gz"),
                               cdna)
    return r1, {"737K-august-2016": wl}, kw


def _case_sc5p_with_r2(t):
    return _case_sc5p_r1(t, with_r2=True)


@pytest.mark.parametrize("case, chemistry", [
    (_case_v3, "SC3Pv3"), (_case_v2, "SC3Pv2"), (_case_junk, None),
    (_case_tso, "SC5P-R2"), (_case_no_tso, "SC3Pv2"),
    (_case_mfrp, "MFRP-RNA"), (_case_sfrp, "SFRP"),
    (_case_mfrp_ab, "MFRP-Ab"), (_case_pe, "SC5P-PE"),
    (_case_r2_only, "SC5P-R2"), (_case_overhang, "SC3Pv3-OH"),
    (_case_plain, "SC3Pv3"), (_case_low_complexity, "SC3Pv3"),
    (_case_sc5p_r1, "SC5P-R1"), (_case_sc5p_with_r2, "SC5P-R2"),
], ids=lambda v: v.__name__[6:] if callable(v) else None)
def test_detect_chemistry_matches_jax(tmp_path, case, chemistry):
    r1, wls, kw = case(tmp_path)
    jwls = {k: JaxWhitelist.from_seqs(v) for k, v in wls.items()}
    twls = {k: Whitelist.from_seqs(v) for k, v in wls.items()}
    if chemistry is None:
        with pytest.raises(ValueError, match="unable to detect") as je:
            jax_detect(r1, jwls, **kw)
        with pytest.raises(ValueError, match="unable to detect") as te:
            detect_chemistry(r1, twls, **kw)
        assert str(te.value) == str(je.value)
        return
    want = jax_detect(r1, jwls, **kw)
    got = detect_chemistry(r1, twls, **kw)
    assert got == want
    assert got["chemistry"] == chemistry


# ---- preflight ----

def _bad_cfg(mod, t):
    return mod.CountConfig(
        fastq_pairs=[(str(t / "no_R1_.fastq.gz"), None)],
        reference_path=str(t / "noref"), whitelist_path=str(t / "nowl.txt"),
        chemistry="BOGUS")


def _short_r1_cfg(mod, t):
    r1 = _write(str(t / "short_R1_.fastq.gz"), ["ACGTACGTACGT"])
    return mod.CountConfig(fastq_pairs=[(r1, None)], chemistry="SC3Pv3",
                           feature_ref_csv=str(t / "nofeat.csv"))


def _no_target_cfg(mod, t):
    r1 = _write(str(t / "ok_R1_.fastq.gz"), ["A" * 28])
    return mod.CountConfig(fastq_pairs=[(r1, None)], chemistry="SC3Pv1")


@pytest.mark.parametrize("make", [_bad_cfg, _short_r1_cfg, _no_target_cfg],
                         ids=lambda f: f.__name__[1:-4])
def test_preflight_count_matches_jax(tmp_path, make):
    with pytest.raises(jax_pf.PreflightError) as je:
        jax_pf.preflight_count(make(jax_count, tmp_path))
    with pytest.raises(tpf.PreflightError) as te:
        tpf.preflight_count(make(tcount, tmp_path))
    assert te.value.problems == je.value.problems
    assert len(te.value.problems) >= 2 and str(te.value) == str(je.value)


def test_preflight_helpers_match_jax(tmp_path):
    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=4)
    good = dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                reference_path=fx["ref"], whitelist_path=fx["wl"])
    tpf.preflight_count(tcount.CountConfig(**good))
    jax_pf.preflight_count(jax_count.CountConfig(**good))
    feat = str(tmp_path / "f.csv")
    open(feat, "w").write("id,name,read\nA,B,R2\n")
    samples = [dict(sample_id="a", probe_barcode_ids="BC1"),
               dict(sample_id="a", probe_barcode_ids="BC3"),
               dict(sample_id="b", probe_barcode_ids="BC1|BC2")]
    for name, args in (("check_chemistry", ("SC3PV3",)),
                       ("check_chemistry", ("auto",)),
                       ("check_feature_ref", (feat,)),
                       ("check_samples", (samples,)),
                       ("check_reference", (str(tmp_path / "none"),)),
                       ("check_whitelist", (fx["wl"],))):
        got = getattr(tpf, name)(*args)
        assert got == getattr(jax_pf, name)(*args), name
    assert tpf.check_chemistry("SC3PV3") and not tpf.check_chemistry("auto")


# ---- multi-GEM-well and aggr ----

def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _same_matrices(t_out, j_out, subs=("raw_feature_bc_matrix",
                                       "filtered_feature_bc_matrix")):
    for sub in subs:
        if os.path.isdir(os.path.join(j_out, sub)):
            for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
                assert _gunzip(os.path.join(t_out, sub, f)) \
                    == _gunzip(os.path.join(j_out, sub, f)), (sub, f)
        assert not h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                                   os.path.join(j_out, sub + ".h5")), sub
    assert not h5_parity_diffs(
        os.path.join(t_out, "molecule_info.h5"),
        os.path.join(j_out, "molecule_info.h5"), molecule_info=True)


@pytest.fixture(scope="module")
def gem_wells(tmp_path_factory):
    """Two wells over one reference, overlapping barcodes, 12 and 9
    molecules per cell, through both packages' run_count_gem_wells."""
    t = tmp_path_factory.mktemp("wells")
    rng = np.random.default_rng(99)
    genome = "".join(rng.choice(ACGT, 10_000))
    with open(t / "g.fa", "w") as f:
        f.write(">chr1\n" + genome + "\n")
    with open(t / "g.gtf", "w") as f:
        f.write('chr1\tt\texon\t1001\t6000\t.\t+\t.\t'
                'gene_id "GW"; transcript_id "TW"; gene_name "GW";\n')
    ReferencePackage.build(str(t / "g.fa"), str(t / "g.gtf"), str(t / "ref"),
                           device=None)
    wl = _seqs(rng, 40, 16)
    open(t / "wl.txt", "w").writelines(s + "\n" for s in wl)

    def make_well(name, bcs, n_mols):
        r1s, r2s = [], []
        for bc in bcs:
            for _ in range(n_mols):
                p = int(rng.integers(1000, 6000 - 91))
                r1s.append(bc + _rand(rng, 12))
                r2s.append(genome[p:p + 91])
        return (_write(str(t / f"{name}_S1_L001_R1_001.fastq.gz"), r1s),
                _write(str(t / f"{name}_S1_L001_R2_001.fastq.gz"), r2s))

    w1, w2 = make_well("w1", wl[:4], 12), make_well("w2", wl[2:8], 9)
    base = dict(reference_path=str(t / "ref"),
                whitelist_path=str(t / "wl.txt"), chemistry="SC3Pv3",
                read_len=91, batch_size=256, checkpoint=False)

    def cfgs(mod):
        return [mod.CountConfig(fastq_pairs=[w1], gem_group=1,
                                force_cells=4, **base),
                mod.CountConfig(fastq_pairs=[w2], gem_group=2,
                                force_cells=6, **base)]

    t_out, j_out = str(t / "torch"), str(t / "jax")
    torch.set_num_threads(2)
    got = run_count_gem_wells(cfgs(tcount), t_out, secondary_analysis=False,
                              device="cpu")
    want = jax_gem_wells(cfgs(jax_count), j_out, secondary_analysis=False)
    return dict(t_out=t_out, j_out=j_out, got=got, want=want, wl=wl, root=t)


def test_gem_wells_match_jax(gem_wells):
    g = gem_wells
    assert g["got"] == g["want"]
    assert g["got"]["n_gem_wells"] == 2
    assert g["got"]["total_molecules"] == 4 * 12 + 6 * 9
    assert g["got"]["estimated_cells"] == 10
    assert g["got"]["per_well"]["gw2"]["estimated_cells"] == 6
    _same_matrices(g["t_out"], g["j_out"])
    with open(os.path.join(g["t_out"], "metrics_summary.json")) as a, \
            open(os.path.join(g["j_out"], "metrics_summary.json")) as b:
        assert json.load(a) == json.load(b)
    with gzip.open(os.path.join(g["t_out"], "raw_feature_bc_matrix",
                                "barcodes.tsv.gz"), "rt") as f:
        bcs = f.read().split()
    shared = g["wl"][2]
    assert shared + "-1" in bcs and shared + "-2" in bcs


def _aggr_csv(path, out_dir, batch=False):
    with open(path, "w") as f:
        f.write("sample_id,molecule_h5" + (",batch" if batch else "") + "\n")
        for i in (1, 2):
            f.write(f"s{i},"
                    + os.path.join(out_dir, "gem_wells", f"gw{i}",
                                   "molecule_info.h5")
                    + (f",b{i}" if batch else "") + "\n")
    return str(path)


def test_aggr_matches_jax(gem_wells, tmp_path):
    """The two wells differ in depth, so the deeper one is downsampled
    (seeded binomial thinning)."""
    g = gem_wells
    t_csv = _aggr_csv(tmp_path / "t.csv", g["t_out"])
    j_csv = _aggr_csv(tmp_path / "j.csv", g["j_out"])
    assert [r["sample_id"] for r in taggr.parse_aggr_csv(t_csv)] \
        == [r["sample_id"] for r in jax_aggr.parse_aggr_csv(j_csv)]
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = taggr.run_aggr(t_csv, t_out, secondary_analysis=False,
                         device="cpu")
    want = jax_aggr.run_aggr(j_csv, j_out, secondary_analysis=False)
    assert got == want
    assert got["samples"] == ["s1", "s2"] and got["total_cells"] == 10
    assert min(got["normalization_rates"]) < 1.0
    _same_matrices(t_out, j_out)
    for f in ("summary.json", "metrics_summary.json"):
        assert filecmp.cmp(os.path.join(t_out, f), os.path.join(j_out, f),
                           shallow=False), f


# ---- overhang sample demux ----

def test_overhang_demux_matches_jax(tmp_path):
    """SC3Pv3-OH: demux splits the filtered matrix by barcode bases
    [7:9] (the run of tests/test_chemistry_paths.py)."""
    rng = np.random.default_rng(82)
    acgt = list("ACGT")
    genome = "".join(rng.choice(acgt, 8000))
    with open(tmp_path / "g.fa", "w") as f:
        f.write(">chr1\n" + genome + "\n")
    with open(tmp_path / "g.gtf", "w") as f:
        f.write('chr1\tt\texon\t1001\t5000\t.\t+\t.\t'
                'gene_id "G1"; transcript_id "T1"; gene_name "G1";\n')
    ReferencePackage.build(str(tmp_path / "g.fa"), str(tmp_path / "g.gtf"),
                           str(tmp_path / "ref"), device=None)
    base = ["".join(rng.choice(acgt, 16)) for _ in range(12)]
    wl = sorted({b[:7] + oh + b[9:] for b in base for oh in ("AT", "GG")})
    open(tmp_path / "wl.txt", "w").writelines(s + "\n" for s in wl)
    r1p = str(tmp_path / "oh_S1_L001_R1_001.fastq.gz")
    r2p = str(tmp_path / "oh_S1_L001_R2_001.fastq.gz")
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        i = 0
        for oh in ("AT", "GG"):
            for bc in [s for s in wl if s[7:9] == oh][:4]:
                for _ in range(8):
                    umi = "".join(rng.choice(acgt, 12))
                    p = int(rng.integers(1000, 5000 - 91))
                    f1.write(f"@o{i}\n{bc}{umi}\n+\n{'F' * 28}\n")
                    f2.write(f"@o{i}\n{genome[p:p + 91]}\n+\n{'F' * 91}\n")
                    i += 1
    kw = dict(fastq_pairs=[(r1p, r2p)], reference_path=str(tmp_path / "ref"),
              whitelist_path=str(tmp_path / "wl.txt"), chemistry="SC3Pv3-OH",
              read_len=91, batch_size=256, secondary_analysis=False,
              checkpoint=False, force_cells=8)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    ts = tcount.run_count(tcount.CountConfig(**kw), t_out, device="cpu")
    js = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    assert not cc.check_metrics(ts, js) and ts["estimated_cells"] == 8
    samples = [dict(sample_id="sA", overhang_ids="AT"),
               dict(sample_id="sB", overhang_ids="GG")]
    got = demux_overhang_samples(
        t_out, samples, get_chemistry("SC3Pv3-OH"), str(tmp_path / "tdx"),
        device="cpu")
    want = jax_demux_overhang(
        j_out, samples, jax_get_chemistry("SC3Pv3-OH"),
        str(tmp_path / "jdx"))
    assert got == want == dict(samples={"sA": 4, "sB": 4}, n_unassigned=0)
    assert filecmp.cmp(tmp_path / "tdx" / "overhang_assignments.csv",
                       tmp_path / "jdx" / "overhang_assignments.csv",
                       shallow=False)
    mex = "sample_filtered_feature_bc_matrix"
    for sid in ("sA", "sB"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzip(str(tmp_path / "tdx" / "per_sample_outs" / sid
                               / mex / f)) \
                == _gunzip(str(tmp_path / "jdx" / "per_sample_outs" / sid
                               / mex / f))
    with pytest.raises(ValueError, match="no overhang"):
        demux_overhang_samples(
            t_out, samples, get_chemistry("SC3Pv3"), str(tmp_path / "x"),
            device="cpu")


# ---- the port's CLI ----

def test_cli_mkref_and_mkgtf(tmp_path, capsys):
    rng = np.random.default_rng(1)
    fa, gtf = str(tmp_path / "g.fa"), str(tmp_path / "g.gtf")
    with open(fa, "w") as f:
        f.write(">chr1\n" + "".join(rng.choice(ACGT, 6000)) + "\n")
    with open(gtf, "w") as f:
        f.write('chr1\tx\texon\t1001\t2000\t.\t+\t.\tgene_id "A"; '
                'transcript_id "TA"; gene_biotype "protein_coding";\n'
                'chr1\tx\texon\t3001\t4000\t.\t+\t.\tgene_id "B"; '
                'transcript_id "TB"; gene_biotype "lncRNA";\n')
    kept = str(tmp_path / "kept.gtf")
    main(["mkgtf", gtf, kept, "--attribute", "gene_biotype:protein_coding"])
    text = open(kept).read()
    assert 'gene_id "A"' in text and 'gene_id "B"' not in text
    main(["mkref", "--genome", "tiny", "--fasta", fa, "--genes", kept,
          "--out", str(tmp_path / "ref"), "--device", "cpu"])
    assert '"tiny"' in capsys.readouterr().out
    ref = ReferencePackage.load(str(tmp_path / "ref"))
    assert ref.transcriptome.gene_ids == ["A"]
    with pytest.raises(SystemExit, match="matching counts"):
        main(["mkref", "--genome", "a,b", "--fasta", fa, "--genes", kept,
              "--out", str(tmp_path / "ref2")])


def test_cli_count_detects_chemistry_and_runs_preflight(tmp_path, capsys):
    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=12)
    args = ["count", "--id", "S", "--fastqs", str(tmp_path / "fx"),
            "--reference", fx["ref"], "--whitelist", fx["wl"],
            "--chemistry", "auto", "--batch-size", "256", "--device", "cpu",
            "--output-dir", str(tmp_path)]
    main(args)
    out = capsys.readouterr().out
    # one user whitelist applies to every candidate geometry, so the 3'
    # candidates tie; both packages break the tie alike within one process
    # (the tie-break walks a set of names, whose order follows the hash
    # seed), so the name is held against the JAX package's, not a constant
    jwl = JaxWhitelist.load(fx["wl"])
    want = jax_detect(fx["fq1"], {jwl.name: jwl}, r2_path=fx["fq2"])
    assert f"detected chemistry: {want['chemistry']} " in out
    with open(tmp_path / "S" / "outs" / "metrics_summary.json") as f:
        s = json.load(f)
    assert s["chemistry"] == want["chemistry"]
    assert s["total_reads"] == fx["n_reads"]
    # preflight reports every problem and stops before any work
    bad = [a if a != fx["ref"] else str(tmp_path / "noref") for a in args]
    bad[bad.index("auto")] = "SC3PV3"
    bad[bad.index("S")] = "T"
    with pytest.raises(SystemExit) as e:
        main(bad)
    assert "SC3Pv3" in str(e.value) and "noref" in str(e.value)
    assert not os.path.exists(tmp_path / "T")


def test_run_count_points_auto_at_detect_chemistry(tmp_path):
    cfg = tcount.CountConfig(fastq_pairs=[], chemistry="auto")
    with pytest.raises(NotImplementedError, match="detect_chemistry"):
        tcount.run_count(cfg, str(tmp_path / "o"), device="cpu")


def test_cli_aggr(gem_wells, tmp_path, capsys):
    csv = _aggr_csv(tmp_path / "a.csv", gem_wells["t_out"], batch=True)
    main(["aggr", "--id", "A", "--csv", csv, "--device", "cpu",
          "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert '"total_cells": 10' in out
    outs = tmp_path / "A" / "outs"
    assert (outs / "filtered_feature_bc_matrix" / "matrix.mtx.gz").exists()
    assert (outs / "analysis" / "pca" / "projection.csv").exists() \
        or (outs / "analysis").exists()


def test_cli_testrun(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main(["testrun", "--out", str(tmp_path / "tr"), "--device", "cpu"])
    assert e.value.code == 0
    assert "testrun: PASS" in capsys.readouterr().out
    assert (tmp_path / "tr" / "outs" / "possorted_genome_bam.bam").exists()
