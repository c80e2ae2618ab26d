"""Port parity for `multi` on a CellPlex GEM well, tolerance 0.

`testing.fixtures.build_cellplex_run` at a small size (480 cells, 12 CMOs
and 12 samples, 17 TotalSeq-B antibodies with 3 planted protein
aggregates, a 20,000-barcode whitelist, 74% singlets, 24% two-tag
multiplets, 2% blanks: Gene Expression, Multiplexing Capture and Antibody
Capture libraries in one GEM well) goes through the JAX package's
`run_multi` and through chip_smoke's `cellplex_run`, the card's phase, on
the cpu (the port's `run_multi` with its stage timers).  The two runs are
held equal:

  * the count outputs (MEX, molecule_info.h5 through h5py, CSVs) and the
    run's metrics;
  * `aggregate_barcodes.csv`, byte for byte, with every planted aggregate
    in it and none called as a cell;
  * `assignments.csv`, byte for byte, and the demux summary;
  * each sample's MEX bytes, h5 and `sample_molecule_info.h5` (through
    real h5py, `h5_parity_diffs`), `metrics_summary.json`, and its
    analysis by `testing/analysis_check.py`'s rules;
  * `chip_smoke.cellplex_outputs` of both, which is what the card's phase
    holds against `CELLPLEX_EXPECTED`.

The fixture itself is tested too: its planted tag, antibody and GEX
molecules read back from the FASTQs, and the phase's comparators fail on
planted faults.  So is the rule that made the fixture draw its UMIs over
every library at once: the dedup keeps one feature of a (barcode, UMI)
across libraries
(the library sits in the gene column's high bits), so a CMO molecule that
shares its cell's UMI with a GEX molecule of more reads is dropped, alike
in both packages.
"""

import copy
import filecmp
import gzip
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellranger_tpu.io.multi_config import run_multi as jax_run_multi
from cellranger_tpu.ops.dedup import dedup_molecules as jax_dedup
from cellranger_tpu.pipeline import demux as jax_demux
from cellranger_tpu_torch.ops.dedup import dedup_molecules
from cellranger_tpu_torch.pipeline.count import LIB_SHIFT
from cellranger_tpu_torch.testing.fixtures import (CELLPLEX_AB_PANEL,
                                                   CELLPLEX_KINDS,
                                                   CELLPLEX_SHARES,
                                                   CELLPLEX_TAG_LEADER,
                                                   CELLPLEX_TAG_LEN,
                                                   CELLPLEX_TAG_MIN_DIST,
                                                   build_cellplex_run)
from chip_smoke import (E2E_BATCH, SAMPLE_MEX, cellplex_diffs,
                        cellplex_outputs, cellplex_run, recorded,
                        sample_out_diffs)
from test_torch_hdf5 import h5_parity_diffs
from test_torch_multi import (_same_count_outs, _same_mex,
                              _same_sample_analysis, _strip)

# three cell types, so that a sample's ~30 singlets fall in three groups
# of ~10 and each cell's 10 nearest neighbours, which the t-SNE and UMAP
# rule reads, are its own type's 9 and one other, not a draw among iid
# cells (whose 10-NN preservation differed between two runs of either
# package by up to 0.06 at this size)
# an antibody library as deep as the CMO library, and 3 aggregates: the
# detector runs once 5 antibodies reach 1,000 UMIs in all, which the
# background of 480 cells alone gives every one of the 17
SMALL = dict(n_cells=480, n_tags=12, gex_reads=160_000, cmo_reads=48_000,
             n_wl=20_000, genome_len=2_000_000, n_genes=200, n_types=3,
             n_antibodies=17, ab_reads=48_000, n_aggregates=3)
SAMPLES = [f"sample{i + 1}" for i in range(SMALL["n_tags"])]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cellplex(tmp_path_factory):
    t = tmp_path_factory.mktemp("cellplex")
    fx = build_cellplex_run(str(t / "fx"), **SMALL)
    torch.set_num_threads(2)
    j_out = str(t / "jax")
    with recorded((jax_demux, "fit_jibes")) as rec:
        want = jax_run_multi(fx["csv"], j_out, fx["wl"],
                             batch_size=E2E_BATCH)
    t_out = str(t / "torch")
    report = cellplex_run(fx, t_out, "cpu")
    return dict(fx=fx, t_out=t_out, j_out=j_out, want=want, report=report,
                expected=cellplex_outputs(fx, j_out, rec["fit_jibes"][0][1]))


def _feature_of(fx: dict, r2: np.ndarray, seqs: dict) -> np.ndarray:
    """Index into `seqs` (name -> sequence) of the feature sequence each
    Feature Barcode R2 row carries after its leader."""
    of = {s.encode(): i for i, s in enumerate(seqs.values())}
    return np.asarray([of[bytes(r)] for r in r2[
        :, CELLPLEX_TAG_LEADER:CELLPLEX_TAG_LEADER + CELLPLEX_TAG_LEN]])


def _fastq_rows(path: str, width: int) -> np.ndarray:
    """The sequences of a fixture FASTQ (fixed 16-byte names, one length)."""
    with open(path, "rb") as f:
        rows = np.frombuffer(f.read(), np.uint8)
    return rows.reshape(-1, 16 + 2 * width + 4)[:, 16:16 + width]


def _read_back(fx: dict, lib: str, r2_width: int):
    """(cell index, UMI bytes, R2 rows) of every read of library `lib`,
    each barcode with an error taken back to the one cell barcode one base
    away (asserted unique)."""
    d = os.path.join(os.path.dirname(fx["csv"]), lib)
    r1 = _fastq_rows(os.path.join(d, f"{lib}_S1_L001_R1_001.fastq"), 28)
    r2 = _fastq_rows(os.path.join(d, f"{lib}_S1_L001_R2_001.fastq"),
                     r2_width)
    cells = np.asarray([b[:16].encode() for b in fx["barcodes"]])
    cell_rows = cells.view(np.uint8).reshape(len(cells), 16)
    bcs = np.ascontiguousarray(r1[:, :16]).view("S16").ravel()
    order = np.argsort(cells)
    pos = np.minimum(np.searchsorted(cells[order], bcs), len(cells) - 1)
    cell = np.where(cells[order][pos] == bcs, order[pos], -1)
    for i in np.flatnonzero(cell < 0):
        near = np.flatnonzero((cell_rows != r1[i, :16]).sum(1) == 1)
        assert len(near) == 1, (lib, i, near)
        cell[i] = near[0]
    return cell, np.ascontiguousarray(r1[:, 16:]).view("S12").ravel(), r2


def test_fixture_reads_back_the_planted_truth(cellplex):
    """Every planted tag and GEX molecule is in the FASTQs: one read per
    tag molecule at its cell and tag, two reads per GEX molecule, every
    UMI distinct within a cell and library; the kinds in their shares,
    the singlets balanced over the tags, the tags CELLPLEX_TAG_MIN_DIST
    apart."""
    fx = cellplex["fx"]
    n, T = SMALL["n_cells"], SMALL["n_tags"]
    kinds = np.bincount(fx["kind"], minlength=len(CELLPLEX_KINDS))
    assert kinds[:2].tolist() == [round(n * s) for s in CELLPLEX_SHARES[:2]]
    assert kinds.sum() == n
    per_tag = np.bincount(fx["tag1"][fx["kind"] == 0], minlength=T)
    assert per_tag.sum() == kinds[0] and per_tag.max() - per_tag.min() <= 1
    agg_tags = np.bincount(fx["tag1"][fx["aggregates"]], minlength=T)
    assert list(fx["built"].values()) == (per_tag - agg_tags).tolist()
    multi = fx["kind"] == 1
    assert (fx["tag2"][multi] != fx["tag1"][multi]).all()
    assert (fx["tag2"][~multi] == -1).all()
    seqs = np.asarray([list(s.encode()) for s in fx["tags"].values()])
    dist = (seqs[:, None] != seqs[None, :]).sum(-1)
    assert dist[~np.eye(T, dtype=bool)].min() >= CELLPLEX_TAG_MIN_DIST

    cell, umi, r2 = _read_back(fx, "cmo", 71)
    tag = _feature_of(fx, r2, fx["tags"])
    got = np.zeros((n, T), np.int64)
    np.add.at(got, (cell, tag), 1)
    assert (got == fx["tag_molecules"]).all()
    assert len(cell) == fx["cmo_reads"] == fx["tag_molecules"].sum()
    assert len(set(zip(cell.tolist(), umi.tolist()))) == len(cell)

    cell, umi, _ = _read_back(fx, "gex", 91)
    assert len(cell) == fx["gex_reads"] == 2 * fx["gex_molecules"].sum()
    mols = np.asarray(sorted(set(zip(cell.tolist(), umi.tolist()))))
    assert (np.bincount(mols[:, 0].astype(np.int64), minlength=n)
            == fx["gex_molecules"]).all()


def test_fixture_antibodies_read_back(cellplex):
    """The antibody library: one read per planted antibody molecule at its
    cell and antibody, the panel's 17 names, sequences
    CELLPLEX_TAG_MIN_DIST from each other and from every CMO, every UMI
    distinct within a cell across all three libraries; the planted
    aggregates singlets many times any other cell on every antibody,
    isotype controls included, and out of `built`."""
    fx = cellplex["fx"]
    n, A = SMALL["n_cells"], SMALL["n_antibodies"]
    assert list(fx["antibodies"]) == list(CELLPLEX_AB_PANEL)
    seqs = np.asarray([list(s.encode()) for s in (
        *fx["tags"].values(), *fx["antibodies"].values())])
    dist = (seqs[:, None] != seqs[None, :]).sum(-1)
    assert dist[~np.eye(len(seqs), dtype=bool)].min() >= \
        CELLPLEX_TAG_MIN_DIST

    cell, umi, r2 = _read_back(fx, "ab", 71)
    got = np.zeros((n, A), np.int64)
    np.add.at(got, (cell, _feature_of(fx, r2, fx["antibodies"])), 1)
    assert (got == fx["ab_molecules"]).all()
    assert len(cell) == fx["ab_reads"] == fx["ab_molecules"].sum()
    seen = set(zip(cell.tolist(), umi.tolist()))
    for lib in ("cmo", "gex"):
        c, u, _ = _read_back(fx, lib, 71 if lib == "cmo" else 91)
        seen_lib = set(zip(c.tolist(), u.tolist()))
        assert not seen & seen_lib, lib
        seen |= seen_lib

    agg = fx["aggregates"]
    assert len(agg) == SMALL["n_aggregates"]
    assert (fx["kind"][agg] == 0).all()
    rest = np.delete(fx["ab_molecules"], agg, axis=0)
    assert (fx["ab_molecules"][agg].min(0) > 2 * rest.max(0)).all()
    assert sum(fx["built"].values()) == (fx["kind"] == 0).sum() - len(agg)


def test_count_outs_match_jax(cellplex):
    c = cellplex
    t_count = os.path.join(c["t_out"], "count")
    j_count = os.path.join(c["j_out"], "count")
    _same_count_outs(t_count, j_count)
    with open(os.path.join(t_count, "metrics_summary.json")) as a, \
            open(os.path.join(j_count, "metrics_summary.json")) as b:
        ta, tb = json.load(a), json.load(b)
    ta.pop("wall_time_s"), tb.pop("wall_time_s")
    assert ta == tb
    assert ta["total_reads"] == c["fx"]["n_reads"]
    with open(os.path.join(c["t_out"], "metrics_summary.json")) as a, \
            open(os.path.join(c["j_out"], "metrics_summary.json")) as b:
        ta, tb = json.load(a), json.load(b)
    ta.pop("wall_time_s"), tb.pop("wall_time_s")
    assert ta == tb


def test_assignments_match_jax(cellplex):
    c = cellplex
    assert filecmp.cmp(os.path.join(c["t_out"], "demux", "assignments.csv"),
                       os.path.join(c["j_out"], "demux", "assignments.csv"),
                       shallow=False)
    got = c["report"]["outputs"]
    assert sum(got["tag_calls"].values()) == got["estimated_cells"]
    want = _strip(c["want"])["demux"]
    assert sorted(want["samples"]) == sorted(SAMPLES)
    assert want["n_blank"] == got["tag_calls"]["Blank"]
    assert want["n_multiplet"] == got["tag_calls"]["Multiplet"]


@pytest.mark.parametrize("sid", SAMPLES)
def test_sample_outs_match_jax(cellplex, sid):
    ts = os.path.join(cellplex["t_out"], "demux", "per_sample_outs", sid)
    js = os.path.join(cellplex["j_out"], "demux", "per_sample_outs", sid)
    _same_mex(os.path.join(ts, SAMPLE_MEX), os.path.join(js, SAMPLE_MEX))
    assert not h5_parity_diffs(os.path.join(ts, SAMPLE_MEX + ".h5"),
                               os.path.join(js, SAMPLE_MEX + ".h5"))
    assert not h5_parity_diffs(
        os.path.join(ts, "sample_molecule_info.h5"),
        os.path.join(js, "sample_molecule_info.h5"), molecule_info=True)
    with open(os.path.join(ts, "metrics_summary.json")) as a, \
            open(os.path.join(js, "metrics_summary.json")) as b:
        sa, sb = json.load(a), json.load(b)
    assert sa == sb
    assert sa["cells"] == cellplex["want"]["demux"]["samples"][sid]
    assert "secondary_analysis_error" not in sa
    _same_sample_analysis(ts, js)


def test_aggregates_match_jax(cellplex):
    """aggregate_barcodes.csv byte for byte the JAX run's; every planted
    aggregate in it, called a cell by neither package, in no sample."""
    c = cellplex
    t_csv, j_csv = (os.path.join(o, "count", "aggregate_barcodes.csv")
                    for o in (c["t_out"], c["j_out"]))
    assert filecmp.cmp(t_csv, j_csv, shallow=False)
    with open(t_csv) as f:
        flagged = {ln.split(",")[0] for ln in f.read().splitlines()[1:]}
    planted = {c["fx"]["barcodes"][i] for i in c["fx"]["aggregates"]}
    assert planted <= flagged
    for out in (c["t_out"], c["j_out"]):
        with gzip.open(os.path.join(out, "count", "filtered_feature_bc_matrix",
                                    "barcodes.tsv.gz"), "rt") as f:
            assert not planted & set(f.read().split())
        with open(os.path.join(out, "demux", "assignments.csv")) as f:
            assert not planted & {ln.split(",")[0] for ln in f}
    got = c["report"]["outputs"]
    assert got["number_aggregate_GEMs"] == len(flagged)
    assert got["planted_aggregates_flagged"] == len(planted)
    assert got["planted_aggregates_called"] == 0


def test_chip_phase_report_matches_jax(cellplex):
    """What the card's phase holds: cellplex_outputs equal to the JAX
    run's (JIBES' floats within CELLPLEX_TOL, all else exactly), every
    sample's files there, and the planted truth recovered; its timers
    filled."""
    rep, want = cellplex["report"], cellplex["expected"]
    assert cellplex_diffs(rep["outputs"], want) == []
    assert sample_out_diffs(os.path.join(cellplex["t_out"], "demux"),
                            SAMPLES) == []
    truth = rep["outputs"]["truth"]
    assert truth["barcodes_off_planted_molecules"] == 0
    assert truth["stray_barcodes"] == 0
    assert truth["singlets_own_sample"] >= 0.99
    assert truth["multiplets_called_multiplet"] >= 0.9
    assert truth["blanks_called_blank"] >= 0.9
    assert rep["outputs"]["gex_molecules"] == SMALL["gex_reads"] // 2
    assert rep["outputs"]["cmo_molecules"] == cellplex["fx"]["cmo_reads"]
    assert rep["outputs"]["ab_molecules"] == cellplex["fx"]["ab_reads"]
    assert rep["jibes_iters"] == want["jibes"]["n_iters"]
    for k in ("run_count_s", "jibes_s", "sample_outs_s", "slowest_sample_s",
              "subset_molecule_info_s", "sample_analysis_s",
              "web_summaries_s", "fb_pass2_s", "cmo_pass2_s", "ab_pass2_s",
              "aggregate_s"):
        assert rep[k] > 0, k
    assert rep["slowest_sample_s"] <= rep["sample_outs_s"] < rep["wall_s"]
    assert rep["peak_host_rss_bytes"] > 0


def _set(keys: tuple, value):
    """A fault: the field at `keys` of a cellplex_outputs dict replaced by
    value(old)."""
    def plant(o: dict) -> None:
        for k in keys[:-1]:
            o = o[k]
        o[keys[-1]] = value(o[keys[-1]])
    return plant


@pytest.mark.parametrize("fault,caught", [
    (_set(("mex_sha256", "filtered_feature_bc_matrix/matrix.mtx.gz"),
          lambda v: "0" * 64), True),
    (_set(("samples", "sample3", "cells"), lambda v: v + 1), True),
    (_set(("tag_call_sha256",), lambda v: v[::-1]), True),
    (_set(("truth", "singlets_own_sample"), lambda v: v - 1 / 480), True),
    (_set(("jibes", "n_iters"), lambda v: v + 1), True),
    (_set(("jibes", "posterior_sum"), lambda v: v + 2e-6), True),
    (_set(("jibes", "posterior_sum"), lambda v: v + 5e-7), False),
    (_set(("jibes", "background"), lambda v: v[:5] + [v[5] - 2e-6] + v[6:]),
     True),
    (_set(("jibes", "std_devs"), lambda v: v[:-1] + [v[-1] + 5e-7]), False),
    (_set(("ab_molecules",), lambda v: v - 1), True),
    (_set(("aggregate_barcodes_sha256",), lambda v: None), True),
    (_set(("number_aggregate_GEMs",), lambda v: v + 1), True),
    (_set(("planted_aggregates_flagged",), lambda v: v - 1), True),
    (_set(("planted_aggregates_called",), lambda v: v + 1), True),
    (_set(("truth", "barcodes_off_planted_molecules"), lambda v: v + 1),
     True),
], ids=["mex", "sample_cells", "tag_calls", "truth", "iters",
        "posterior_2e-6", "posterior_5e-7", "background_2e-6",
        "std_devs_5e-7", "ab_molecules", "aggregate_csv", "aggregate_gems",
        "aggregates_flagged", "aggregates_called", "off_planted"])
def test_cellplex_diffs_catch_faults(cellplex, fault, caught):
    """The phase's comparator against planted faults: every field exact
    but JIBES' floats, which may move by CELLPLEX_TOL = 1e-6."""
    want = cellplex["expected"]
    got = copy.deepcopy(want)
    fault(got)
    assert bool(cellplex_diffs(got, want)) == caught


def test_sample_out_diffs_catch_faults(cellplex, tmp_path):
    """A sample's analysis error, a missing file and a missing analysis
    file each fail the phase."""
    demux = str(tmp_path / "demux")
    shutil.copytree(os.path.join(cellplex["t_out"], "demux"), demux)
    assert sample_out_diffs(demux, SAMPLES) == []
    s1 = os.path.join(demux, "per_sample_outs", "sample1")
    with open(os.path.join(s1, "metrics_summary.json")) as f:
        m = json.load(f)
    m["secondary_analysis_error"] = "PCA failed"
    with open(os.path.join(s1, "metrics_summary.json"), "w") as f:
        json.dump(m, f)
    os.remove(os.path.join(demux, "per_sample_outs", "sample2",
                           "sample_molecule_info.h5"))
    shutil.rmtree(os.path.join(demux, "per_sample_outs", "sample3",
                               "analysis", "tsne"))
    diffs = sample_out_diffs(demux, SAMPLES)
    assert len(diffs) == 3, diffs
    assert "secondary_analysis_error" in diffs[0]
    assert "sample_molecule_info.h5" in diffs[1]
    assert diffs[2].startswith("sample3:")


@pytest.mark.parametrize("gex_reads,molecules", [(2, 1), (1, 0)])
def test_a_umi_shared_across_libraries_keeps_one_feature(gex_reads,
                                                         molecules):
    """One barcode, one UMI: a GEX molecule of gex_reads reads and a CMO
    molecule of one.  Low-support marking holds the (barcode, UMI) to its
    feature of most reads, across libraries: the CMO molecule goes when
    the GEX one has more reads, and both go on a tie; the two packages
    agree row for row."""
    umi = 0b01_10_11_00_01_10_11_00_01_10_11_00
    gene = [7] * gex_reads + [(200 + 3) | (1 << LIB_SHIFT)]
    n, N = len(gene), 8
    pad = lambda a: np.pad(np.asarray(a, np.uint32), (0, N - n))  # noqa
    bc, gene, umis = pad([5] * n), pad(gene), pad([umi] * n)
    valid = np.arange(N) < n
    want = jax_dedup(jnp.asarray(bc), jnp.asarray(gene), jnp.asarray(umis),
                     jnp.asarray(valid), 12)
    got = dedup_molecules(*(torch.from_numpy(a.astype(np.int64))
                            for a in (bc, gene, umis)),
                          torch.from_numpy(valid), 12)
    for k in sorted(want):
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    assert int(got["n_molecules"]) == molecules
    kept = got["mol_gene"].numpy()[got["mol_valid"].numpy()]
    assert kept.tolist() == [7] * molecules
