"""Port parity for the count-only slice of cellranger_tpu_torch.

  * the accumulate-mode device step against the JAX package's
    `_make_step(..., accumulate=True)` on the `__graft_entry__` synthetic
    reference: the accumulators after two batches are equal;
  * the default `run_count` (secondary analysis on) of both packages on
    the same FASTQs (the tiny synthetic run, and the GEX library of the
    rich run with multimappers, a novel junction, TSO/polyA reads and UMI
    errors): metrics (except wall_time_s), raw and filtered MEX and h5,
    molecule_info.h5 and filtered_barcodes.csv are equal, via
    cellranger_tpu.testing.correctness; analysis/ holds the same 16 files,
    held by `testing.analysis_check.compare_analysis` (labels, hierarchy
    and diff-exp equal byte for byte, PCA within 1e-3, t-SNE/UMAP by
    10-NN preservation).  The tiny run's 2 genes make many cells
    identical, but no label there hangs on a tie: every clusters.csv is
    equal;
  * what the port does not run raises: chemistry "auto" (which
    `detect_chemistry` resolves before `run_count`, NotImplementedError)
    and a mesh inside a multi-host run (ValueError); secondary analysis,
    BAM, Feature Barcode, multi-library, paired-end, probe and
    `shard_index` configs pass the check.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import __graft_entry__ as graft
from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu.testing.fixtures import build_rich_run
from cellranger_tpu_torch.align.aligner import DeviceIndex
from cellranger_tpu_torch.align.annotate import AnnotationIndex
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.parallel import distributed
from cellranger_tpu_torch.parallel.mesh import make_mesh
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing.analysis_check import (analysis_files,
                                                         compare_analysis)
from cellranger_tpu_torch.testing.fixtures import build_synthetic_run


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_accumulate_step_matches_jax():
    jstep, wl, genome, rng = graft._synthetic_setup()
    didx, ann = jstep.bound_args
    chem = get_chemistry("SC3Pv3")
    jacc_step = jax_count._make_step(didx, ann, jax_get_chemistry("SC3Pv3"),
                                     91, accumulate=True)
    tstep = tcount.make_count_step(DeviceIndex.from_jax(didx, "cpu"),
                                   AnnotationIndex.from_jax(ann, "cpu"),
                                   chem, 91)
    B = 256
    jacc = jacc_step.init_acc(4 * B, 4 * B)
    tacc = tstep.init_acc(4 * B, 4 * B)
    for i in range(2):
        buf, _host = graft._synthetic_batch(wl, genome, rng, B)
        plane = np.asarray(buf)
        assert plane.dtype == np.uint32
        jacc = jacc_step(jnp.asarray(plane), jacc, lib_tag=i << 24)
        tstep(tcount.upload_plane(plane, "cpu"), tacc, lib_tag=i << 24)
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


def test_pack_step_input_matches_jax():
    _step, wl, genome, rng = graft._synthetic_setup()
    buf, host = graft._synthetic_batch(wl, genome, rng, 64)
    # same shim the graft entry builds, through the port's packer
    from types import SimpleNamespace
    chem = get_chemistry("SC3Pv3")
    plane = np.asarray(buf)
    rw = (91 + 15) // 16
    codes = torch.from_numpy(plane.view(np.int32)).to(torch.int64) \
        & 0xFFFFFFFF
    rna, nmask = tcount._unpack_codes(codes, 3, 91)
    shim = SimpleNamespace(batch_size=64, umi_packed=host["umi"],
                           slot_valid=np.ones(64, bool),
                           umi_valid=np.ones(64, bool), rna=rna.numpy(),
                           rna_nmask=nmask.numpy())
    np.testing.assert_array_equal(
        tcount.pack_step_input(chem, 91, shim, host["bc_idx"]), plane)
    assert plane.shape[1] == tcount.packed_width(chem, 91) == 3 + rw + 3


def _compare_runs(t_out, j_out, t_sum, j_sum):
    diffs = cc.check_metrics(t_sum, j_sum)
    assert not diffs, diffs
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            d = cc.check_mtx(os.path.join(t_out, sub, f),
                             os.path.join(j_out, sub, f))
            assert not d, (sub, f, d)
        d = cc.check_h5(os.path.join(t_out, sub + ".h5"),
                        os.path.join(j_out, sub + ".h5"))
        assert not d, (sub, d)
    d = cc.check_molecule_info(os.path.join(t_out, "molecule_info.h5"),
                               os.path.join(j_out, "molecule_info.h5"))
    assert not d, d
    for f in ("filtered_barcodes.csv", "per_barcode_metrics.csv"):
        with open(os.path.join(t_out, f), "rb") as a, \
                open(os.path.join(j_out, f), "rb") as b:
            assert a.read() == b.read(), f
    tj = os.path.join(t_out, "junctions.tsv")
    jj = os.path.join(j_out, "junctions.tsv")
    assert os.path.exists(tj) == os.path.exists(jj)
    if os.path.exists(jj):
        with open(tj) as a, open(jj) as b:
            assert a.read() == b.read()
    ja, ta = os.path.join(j_out, "analysis"), os.path.join(t_out, "analysis")
    assert os.path.exists(ta) == os.path.exists(ja)
    if os.path.exists(ja):
        diffs, _ = compare_analysis(ja, ta)
        assert not diffs, diffs


def _run_both(tmp_path, fq1, fq2, ref, wl, batch_size):
    kw = dict(fastq_pairs=[(fq1, fq2)], reference_path=ref,
              whitelist_path=wl, chemistry="SC3Pv3", read_len=91,
              batch_size=batch_size)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_sum = tcount.run_count(tcount.CountConfig(**kw), t_out, device="cpu")
    j_sum = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    # the default count writes the 16 analysis/ files
    assert len(analysis_files(os.path.join(j_out, "analysis"))) == 16
    _compare_runs(t_out, j_out, t_sum, j_sum)
    return t_sum


def test_run_count_tiny_matches_jax(tmp_path):
    fx = build_synthetic_run(str(tmp_path / "fx"))
    s = _run_both(tmp_path, fx["fq1"], fx["fq2"], fx["ref"], fx["wl"], 256)
    assert s["total_reads"] == fx["n_reads"]
    assert s["total_molecules"] == int(fx["truth"].sum())


def test_run_count_rich_gex_matches_jax(tmp_path):
    fx = build_rich_run(str(tmp_path / "fx"), n_cells=40)
    s = _run_both(tmp_path, fx["fq1"], fx["fq2"], fx["ref"], fx["wl"], 512)
    assert s["total_reads"] == fx["n_gex_reads"]
    assert s["mapped_frac"] > 0.9 and s["tso_reads"] > 0
    assert s["polya_trimmed_reads"] > 0
    assert os.path.exists(str(tmp_path / "torch" / "junctions.tsv"))


def test_run_count_loads_the_reference_once(tmp_path, monkeypatch):
    """Two run_count calls on one reference in one process load it and
    build its device tables once (the memo of the JAX package's
    count.py), and give equal outputs; another device loads it anew."""
    from cellranger_tpu_torch.io import matrix_io

    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=10)
    loads = []
    real_load = tcount.ReferencePackage.load
    monkeypatch.setattr(tcount.ReferencePackage, "load", staticmethod(
        lambda path: loads.append(path) or real_load(path)))
    monkeypatch.setattr(tcount, "_REF_MEMO", {"key": None, "value": None})
    cfg = tcount.CountConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                             reference_path=fx["ref"], whitelist_path=fx["wl"],
                             batch_size=256, secondary_analysis=False)
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    sums = [tcount.run_count(cfg, o, device="cpu") for o in outs]
    assert loads == [fx["ref"]]
    assert not cc.check_metrics(sums[0], sums[1])
    for name in ("raw_feature_bc_matrix.h5", "filtered_feature_bc_matrix.h5",
                 "molecule_info.h5"):
        assert not cc.check_h5(*(os.path.join(o, name) for o in outs))
    m = matrix_io.CountMatrix.load_h5(os.path.join(outs[0],
                                                   "raw_feature_bc_matrix.h5"))
    assert int(m.m.sum()) == sums[0]["total_molecules"]
    memo = tcount._REF_MEMO["value"]
    assert tcount._load_reference_cached(fx["ref"], torch.device("cpu")) \
        is memo
    # another device key (the tables are computed on the device, so the
    # meta device, which holds no data, cannot stand in for one)
    tcount._load_reference_cached(fx["ref"], "cpu:0")
    assert len(loads) == 2


def test_run_count_resumes_from_checkpoint(tmp_path):
    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=10)
    cfg = tcount.CountConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                             reference_path=fx["ref"],
                             whitelist_path=fx["wl"], batch_size=256,
                             secondary_analysis=False)
    out = str(tmp_path / "out")
    first = tcount.run_count(cfg, out, device="cpu")
    again = tcount.run_count(cfg, out, device="cpu")
    assert not cc.check_metrics(again, first)
    with open(os.path.join(out, "_perf.json")) as f:
        assert "resume_checkpoint" in f.read()


@pytest.mark.parametrize("change, match", [
    (dict(shard_index=True), "ROADMAP"),
    (dict(chemistry="auto"), "detect_chemistry"),
])
def test_unsupported_configs_raise(change, match, tmp_path, monkeypatch):
    """shard_index runs on a mesh; what is refused is a mesh (sharded
    index or not) inside a multi-host run, here a process that counts
    two hosts."""
    base = tcount.CountConfig(fastq_pairs=[], secondary_analysis=False)
    kw = {}
    if change.get("shard_index"):
        monkeypatch.setattr(distributed, "process_count", lambda: 2)
        kw["mesh"] = make_mesh(devices=["cpu"] * 2)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tcount.run_count(dataclasses.replace(base, **change),
                         str(tmp_path / "o"), device="cpu", **kw)


@pytest.mark.parametrize("change", [
    dict(secondary_analysis=True),
    dict(chemistry="MFRP-RNA", probe_barcode_csv="pbc.csv"),
    dict(chemistry="SFRP", probe_set_csv="probes.csv"),
    dict(chemistry="SC5P-PE"), dict(chemistry="SC5P-PE", write_bam=True),
    dict(write_bam=True), dict(feature_ref_csv="f.csv"),
    dict(libraries=[tcount.LibraryDef([]),
                    tcount.LibraryDef([], "Antibody Capture")]),
    dict(write_bam=True, feature_ref_csv="f.csv",
         libraries=[tcount.LibraryDef([]),
                    tcount.LibraryDef([], "Antibody Capture")]),
    dict(shard_index=True),
])
def test_supported_configs_pass_the_check(change):
    cfg = dataclasses.replace(
        tcount.CountConfig(fastq_pairs=[], secondary_analysis=False),
        **change)
    tcount._check_supported(cfg)
