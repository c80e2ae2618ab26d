"""Port parity for `multi` and sample demultiplexing, tolerance 0:

  * `run_multi` of both packages on a Gene Expression + Multiplexing
    Capture config with a [samples] section (CMO demux through JIBES,
    `demux_samples`) and on a Gene Expression + Antibody Capture config:
    equal summaries, MEX and CSV bytes, per-sample matrices and metrics;
  * a Gene Expression + VDJ-T config: the V(D)J library through each
    package's `run_vdj`, equal vdj/ outputs and metrics;
  * sample demux with h5py out of reach reads the count run's h5 and
    writes each sample's h5 through io/hdf5.py, equal to the JAX run's
    by the JAX package's own check_h5 (real h5py);
  * the port's CLI `multi` through `main([...])`.
"""

import filecmp
import gzip
import json
import os
import sys

import pytest
import torch

from cellranger_tpu.io.multi_config import run_multi as jax_run_multi
from cellranger_tpu_torch.cli import main
from cellranger_tpu_torch.io import multi_config as tmulti
from cellranger_tpu_torch.io.matrix_io import CountMatrix
from cellranger_tpu_torch.pipeline import demux as tdemux
from cellranger_tpu_torch.testing import analysis_check as check
from cellranger_tpu_torch.testing.fixtures import (build_multi_run,
                                                   build_rich_run,
                                                   build_synthetic_run,
                                                   build_vdj_single_world)
from chip_smoke import file_tree, tree_diffs
from test_torch_hdf5 import h5_parity_diffs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _same_mex(a, b):
    for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
        assert _gunzip(os.path.join(a, f)) == _gunzip(os.path.join(b, f)), \
            (a, f)


def _strip(summary):
    """A run_multi summary without its wall-clock entries."""
    s = json.loads(json.dumps(summary, default=float))
    s.get("count", {}).pop("wall_time_s", None)
    return s


def _same_count_outs(t_out, j_out):
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        _same_mex(os.path.join(t_out, sub), os.path.join(j_out, sub))
    assert not h5_parity_diffs(
        os.path.join(t_out, "molecule_info.h5"),
        os.path.join(j_out, "molecule_info.h5"), molecule_info=True)
    for f in ("filtered_barcodes.csv", "per_barcode_metrics.csv"):
        assert filecmp.cmp(os.path.join(t_out, f), os.path.join(j_out, f),
                           shallow=False), f


def _same_sample_analysis(t_sdir, j_sdir):
    """The demux writer runs the sample's secondary analysis and only
    notes a failure: all 16 files are there and agree with the JAX
    package's."""
    ja, ta = os.path.join(j_sdir, "analysis"), os.path.join(t_sdir,
                                                            "analysis")
    assert len(check.analysis_files(ja)) == 16
    diffs, _ = check.compare_analysis(ja, ta)
    assert not diffs, diffs


@pytest.fixture(scope="module")
def cmo_multi(tmp_path_factory):
    t = tmp_path_factory.mktemp("cmo")
    fx = build_multi_run(str(t / "fx"))
    torch.set_num_threads(2)
    t_out, j_out = str(t / "torch"), str(t / "jax")
    got = tmulti.run_multi(fx["csv"], t_out, fx["wl"], read_len=91,
                           batch_size=2048, device="cpu")
    want = jax_run_multi(fx["csv"], j_out, fx["wl"], read_len=91,
                         batch_size=2048)
    return dict(fx=fx, t_out=t_out, j_out=j_out, got=got, want=want)


def test_multi_cmo_demux_matches_jax(cmo_multi):
    m = cmo_multi
    assert _strip(m["got"]) == _strip(m["want"])
    d = m["got"]["demux"]
    # every cell carries one clean tag: all land in the sample as built
    assert d["samples"] == m["fx"]["built"]
    assert d["n_blank"] == 0 and d["n_multiplet"] == 0
    _same_count_outs(os.path.join(m["t_out"], "count"),
                     os.path.join(m["j_out"], "count"))
    td, jd = os.path.join(m["t_out"], "demux"), os.path.join(m["j_out"],
                                                             "demux")
    assert filecmp.cmp(os.path.join(td, "assignments.csv"),
                       os.path.join(jd, "assignments.csv"), shallow=False)
    for sid in ("sampleA", "sampleB"):
        ts = os.path.join(td, "per_sample_outs", sid)
        js = os.path.join(jd, "per_sample_outs", sid)
        mex = "sample_filtered_feature_bc_matrix"
        _same_mex(os.path.join(ts, mex), os.path.join(js, mex))
        assert not h5_parity_diffs(os.path.join(ts, mex + ".h5"),
                                   os.path.join(js, mex + ".h5"))
        # the genome column, which only the h5 reader can hand on
        genomes = [[f.genome for f in CountMatrix.load_h5(
            os.path.join(d_, mex + ".h5")).features.feature_defs]
            for d_ in (ts, js)]
        assert genomes[0] == genomes[1] and "synth" in genomes[0]
        assert not h5_parity_diffs(
            os.path.join(ts, "sample_molecule_info.h5"),
            os.path.join(js, "sample_molecule_info.h5"),
            molecule_info=True)
        with open(os.path.join(ts, "metrics_summary.json")) as a, \
                open(os.path.join(js, "metrics_summary.json")) as b:
            sa, sb = json.load(a), json.load(b)
        assert sa == sb and sa["cells"] == d["samples"][sid]
        assert os.path.exists(os.path.join(ts, "web_summary.html"))
        _same_sample_analysis(ts, js)
    with open(os.path.join(m["t_out"], "metrics_summary.json")) as a, \
            open(os.path.join(m["j_out"], "metrics_summary.json")) as b:
        ta, tb = json.load(a), json.load(b)
    ta.pop("wall_time_s"), tb.pop("wall_time_s")
    assert ta == tb and ta["cells_sampleA"] == d["samples"]["sampleA"]
    assert os.path.exists(os.path.join(m["t_out"], "web_summary.html"))


def test_demux_writes_sample_h5_without_h5py(cmo_multi, tmp_path,
                                             monkeypatch):
    """With the import of h5py refused, sample demux reads the count run's
    filtered h5 and writes each sample's h5 and sample_molecule_info.h5
    through io/hdf5.py: the genome column is there, and the JAX package's
    own comparators (real h5py) find both equal to the JAX run's."""
    import h5py

    m = cmo_multi
    count_dir = os.path.join(m["t_out"], "count")
    samples = [dict(sample_id="sampleA", cmo_ids="CMO301"),
               dict(sample_id="sampleB", cmo_ids="CMO302")]
    out = str(tmp_path / "dx")
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)     # `import h5py` raises
        with pytest.raises(ImportError):
            import h5py  # noqa: F401,F811
        got = tdemux.demux_samples(count_dir, samples, out, device="cpu")
    assert got == m["want"]["demux"]
    ref = os.path.join(m["j_out"], "demux")
    assert filecmp.cmp(os.path.join(out, "assignments.csv"),
                       os.path.join(ref, "assignments.csv"), shallow=False)
    mex = "sample_filtered_feature_bc_matrix"
    for sid in ("sampleA", "sampleB"):
        ts = os.path.join(out, "per_sample_outs", sid)
        js = os.path.join(ref, "per_sample_outs", sid)
        _same_mex(os.path.join(ts, mex), os.path.join(js, mex))
        assert not h5_parity_diffs(os.path.join(ts, mex + ".h5"),
                                   os.path.join(js, mex + ".h5"))
        with h5py.File(os.path.join(ts, mex + ".h5"), "r") as f:
            genomes = set(f["matrix/features/genome"][:].tolist())
        assert b"synth" in genomes
        assert not h5_parity_diffs(
            os.path.join(ts, "sample_molecule_info.h5"),
            os.path.join(js, "sample_molecule_info.h5"),
            molecule_info=True)


def test_multi_gex_and_antibody_matches_jax(tmp_path):
    fx = build_rich_run(str(tmp_path / "fx"), n_cells=30)
    gdir, adir = tmp_path / "gexfq", tmp_path / "abfq"
    os.makedirs(gdir), os.makedirs(adir)
    for src, dst in ((fx["fq1"], gdir), (fx["fq2"], gdir),
                     (fx["ab_fq1"], adir), (fx["ab_fq2"], adir)):
        os.link(src, os.path.join(dst, os.path.basename(src)))
    csv = str(tmp_path / "multi.csv")
    with open(csv, "w") as f:
        f.write(f"""[gene-expression]
reference,{fx['ref']}
chemistry,SC3Pv3
expect-cells,30

[feature]
reference,{fx['feature_ref']}

[libraries]
fastq_id,fastqs,feature_types
rich,{gdir},Gene Expression
ab,{adir},Antibody Capture
""")
    cfg = tmulti.MultiConfig.from_csv(csv)
    assert [r["feature_types"] for r in cfg.libraries] \
        == ["Gene Expression", "Antibody Capture"]
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = tmulti.run_multi(csv, t_out, fx["wl"], batch_size=4096,
                           device="cpu")
    want = jax_run_multi(csv, j_out, fx["wl"], batch_size=4096)
    assert _strip(got) == _strip(want)
    assert got["count"]["total_reads"] == fx["n_reads"]
    assert "demux" not in got
    _same_count_outs(os.path.join(t_out, "count"),
                     os.path.join(j_out, "count"))
    raw = CountMatrix.load_h5(os.path.join(t_out, "count",
                                           "raw_feature_bc_matrix.h5"))
    assert [d.feature_type for d in raw.features.feature_defs[-4:]] \
        == ["Antibody Capture"] * 4


def test_multi_gex_and_vdj_matches_jax(tmp_path):
    """A Gene Expression + VDJ-T config: the V(D)J library runs through
    each package's run_vdj (the port's on the device run_multi was given)
    with the count run's whitelist; equal summaries, vdj/ trees and
    top-level metrics."""
    fx = build_synthetic_run(str(tmp_path / "gex"))
    cells = [fx["wl_seqs"][c] for c in fx["cells"][:6]]
    vw = build_vdj_single_world(str(tmp_path / "vdjfq"), barcodes=cells)
    csv = str(tmp_path / "multi.csv")
    with open(csv, "w") as f:
        f.write(f"""[gene-expression]
reference,{fx['ref']}
chemistry,SC3Pv3

[vdj]
reference,{vw['fa']}

[libraries]
fastq_id,fastqs,feature_types
sample,{os.path.dirname(fx['fq1'])},Gene Expression
v,{os.path.dirname(vw['fq1'])},VDJ-T
""")
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = tmulti.run_multi(csv, t_out, fx["wl"], batch_size=2048,
                           device="cpu")
    want = jax_run_multi(csv, j_out, fx["wl"], batch_size=2048)
    assert _strip(got) == _strip(want)
    assert got["vdj"]["v"]["estimated_cells"] == 6
    assert got["vdj"]["v"]["n_clonotypes"] == 2
    assert got["count"]["total_reads"] == fx["n_reads"]
    assert tree_diffs(os.path.join(t_out, "vdj"),
                      os.path.join(j_out, "vdj")) == []
    assert len(file_tree(os.path.join(t_out, "vdj"))) >= 15
    _same_count_outs(os.path.join(t_out, "count"),
                     os.path.join(j_out, "count"))
    with open(os.path.join(t_out, "metrics_summary.json")) as a, \
            open(os.path.join(j_out, "metrics_summary.json")) as b:
        ta, tb = json.load(a), json.load(b)
    ta.pop("wall_time_s"), tb.pop("wall_time_s")
    assert ta == tb
    assert ta["vdj_v_estimated_cells"] == 6 and ta["vdj_v_n_clonotypes"] == 2


def test_multi_config_rejects_bad_csv(tmp_path):
    csv = str(tmp_path / "multi.csv")
    for bad, msg in (("[nope]\nx,y\n", "unknown section"),
                     ("[gene-expression]\nreference,x\n", "libraries")):
        open(csv, "w").write(bad)
        with pytest.raises(ValueError, match=msg):
            tmulti.MultiConfig.from_csv(csv)


def test_cli_multi(cmo_multi, tmp_path, capsys):
    fx = cmo_multi["fx"]
    main(["multi", "--id", "M", "--csv", fx["csv"], "--whitelist", fx["wl"],
          "--batch-size", "2048", "--device", "cpu",
          "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert '"sampleA": 20' in out and '"sampleB": 20' in out
    outs = tmp_path / "M" / "outs"
    assert (outs / "demux" / "per_sample_outs" / "sampleB"
            / "sample_filtered_feature_bc_matrix" / "matrix.mtx.gz").exists()
    _same_mex(str(outs / "count" / "filtered_feature_bc_matrix"),
              os.path.join(cmo_multi["t_out"], "count",
                           "filtered_feature_bc_matrix"))
