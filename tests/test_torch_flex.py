"""Port parity for multiplexed Flex (MFRP-RNA through `multi`), tolerance 0.

One small well of `fixtures.build_flex_run` (chip_smoke.FLEX_HELD: 48
cells, 3 on each of the 16 probe barcodes, beads shared between samples,
BC001 and BC002 one sample's, BC016 no sample's, every probe-barcode
kind) goes through the JAX package's `run_multi` and the port's
`run_multi(device="cpu")`:

  * equal summaries and every output file equal: the h5 files by the JAX
    package's own comparators (h5_parity_diffs, real h5py), gz files by
    their content, CSV and JSON files byte for byte (the
    metrics_summary.json files but their wall time), each sample's
    analysis files (3 or 6 cells, too few for analysis_check's kNN
    rules): the same names, clustering and diff-exp byte for byte, PCA to
    1e-4 of its largest value up to sign (t-SNE and UMAP of a few cells
    are not held); chip_smoke.flex_digest of both
    runs equal to FLEX_EXPECTED, which chip_smoke's `flex_held` holds the
    card's run to;
  * both runs held to the well's truth (chip_smoke.flex_truth_diffs);
  * a bead holding cells of two samples gives two cells in two samples'
    outs;
  * the generator: the same reads for two block and worker counts, its
    truth read back from the FASTQs.
"""

import filecmp
import gzip
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from cellranger_tpu.io.multi_config import run_multi as jax_run_multi
from cellranger_tpu_torch.io import multi_config as tmulti
from cellranger_tpu_torch.ops.encode import pack_codes_np
from cellranger_tpu_torch.testing import analysis_check as check
from cellranger_tpu_torch.testing.fixtures import (FLEX_PBC_KINDS,
                                                   build_flex_run,
                                                   probe_bc_distances,
                                                   rtl_probe_barcodes)
from test_torch_hdf5 import h5_parity_diffs
from test_torch_multi import _strip

SMALL = dict(n_reads=6_000, n_cells=32, n_wl=512, n_gel=16, n_probes=600,
             n_genes=200, n_ambient=40, low_share=0.0)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def well(tmp_path_factory):
    """The flex_held well through both packages' run_multi."""
    tmp = tmp_path_factory.mktemp("flex")
    fx = build_flex_run(str(tmp / "fx"), **chip_smoke.FLEX_HELD, workers=2)
    t_out, j_out = str(tmp / "torch"), str(tmp / "jax")
    kw = dict(read_len=chip_smoke.RTL_READ_LEN,
              batch_size=chip_smoke.FLEX_HELD_BATCH)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = tmulti.run_multi(fx["csv"], t_out, fx["wl"], device="cpu",
                               **kw)
    finally:
        torch.set_num_threads(n)
    want = jax_run_multi(fx["csv"], j_out, fx["wl"], **kw)
    return dict(fx=fx, t_out=t_out, j_out=j_out, got=got, want=want)


def _files(root):
    """Every file under root but the run's own state and the analysis."""
    out = []
    for d, subs, files in os.walk(root):
        subs[:] = [x for x in subs if x != "analysis"
                   and not x.startswith("_")]
        out += [os.path.relpath(os.path.join(d, f), root) for f in files
                if f != "_perf.json"]
    return sorted(out)


def test_summaries_match_jax(well):
    assert _strip(well["got"]) == _strip(well["want"])
    assert well["got"]["demux_probe"]["n_unassigned"] == 3


def test_every_output_file_matches_jax(well):
    t_out, j_out = well["t_out"], well["j_out"]
    names = _files(t_out)
    assert names == _files(j_out)
    for rel in names:
        a, b = os.path.join(t_out, rel), os.path.join(j_out, rel)
        if rel.endswith(".h5"):
            assert not h5_parity_diffs(
                a, b, molecule_info="molecule_info" in rel), rel
        elif rel.endswith(".gz"):
            with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
        elif rel.endswith("metrics_summary.json"):
            with open(a) as fa, open(b) as fb:
                ma, mb = json.load(fa), json.load(fb)
            ma.pop("wall_time_s", None), mb.pop("wall_time_s", None)
            assert ma == mb, rel
        elif not rel.endswith("web_summary.html"):
            assert filecmp.cmp(a, b, shallow=False), rel
    samples = sorted(well["fx"]["cells"])
    assert samples == sorted(os.listdir(os.path.join(
        t_out, "demux", "per_sample_outs")))
    for sid in samples:
        ja, ta = (os.path.join(o, "demux", "per_sample_outs", sid,
                               "analysis") for o in (j_out, t_out))
        names = check.analysis_files(ja)
        assert names and names == check.analysis_files(ta), sid
        for rel in names:
            a, b = os.path.join(ta, rel), os.path.join(ja, rel)
            if rel.startswith(("clustering", "diffexp")):
                assert check.same_bytes(a, b), (sid, rel)
            elif rel.startswith("pca"):
                x, y = (np.abs(np.genfromtxt(p, delimiter=",",
                                             skip_header=1)) for p in (a, b))
                assert np.allclose(x, y, rtol=0, atol=1e-4 * np.nanmax(y),
                                   equal_nan=True), (sid, rel)


def test_digests_equal_flex_expected(well):
    for out in (well["t_out"], well["j_out"]):
        assert chip_smoke.flex_digest(out) == chip_smoke.FLEX_EXPECTED


@pytest.mark.parametrize("pkg", ["t_out", "j_out"])
def test_runs_hold_the_wells_truth(well, pkg):
    assert chip_smoke.flex_truth_diffs(well["fx"], well[pkg]) == []


def test_truth_diffs_catch_a_lost_cell(well, tmp_path):
    """A cell missing from its sample's outs and from the assignments is
    found."""
    import shutil

    out = str(tmp_path / "out")
    shutil.copytree(well["t_out"], out)
    sid = sorted(well["fx"]["cells"])[0]
    path = os.path.join(out, "demux", "per_sample_outs", sid,
                        chip_smoke.SAMPLE_MEX, "barcodes.tsv.gz")
    with gzip.open(path, "rt") as f:
        cells = f.read().split()
    with gzip.open(path, "wt") as f:
        f.write("\n".join(cells[1:]) + "\n")
    csv = os.path.join(out, "demux", "probe_assignments.csv")
    with open(csv) as f:
        rows = f.read().split()
    with open(csv, "w") as f:
        f.write("\n".join(r for r in rows if not r.startswith(cells[0]))
                + "\n")
    diffs = chip_smoke.flex_truth_diffs(well["fx"], out)
    assert any(d.startswith(f"{sid}: ") for d in diffs)
    assert any("probe_assignments.csv" in d for d in diffs)


def test_a_shared_bead_gives_cells_in_two_samples(well):
    """Cells of two samples on one bead are two cells, each in its own
    sample's outs."""
    fx = well["fx"]
    on_bead: dict = {}
    for name, sid in fx["assignments"].items():
        if sid != "unassigned":
            on_bead.setdefault(name[:16], []).append((sid, name))
    shared = {b: v for b, v in on_bead.items()
              if len({s for s, _ in v}) > 1}
    assert shared
    per = os.path.join(well["t_out"], "demux", "per_sample_outs")
    for bead, cells in shared.items():
        for sid, name in cells:
            with gzip.open(os.path.join(per, sid, chip_smoke.SAMPLE_MEX,
                                        "barcodes.tsv.gz"), "rt") as f:
                assert name in f.read().split(), (bead, sid)
    assert chip_smoke._flex_shared_beads(fx, well["t_out"]) == len(shared)


def _reads(fx):
    """Every read pair of a build, decompressed, lane by lane."""
    out = []
    for p1, p2 in fx["pairs"]:
        with gzip.open(p1, "rb") as f1, gzip.open(p2, "rb") as f2:
            out.append((f1.read(), f2.read()))
    return out


def test_build_flex_run_same_reads_any_blocks(tmp_path):
    a = build_flex_run(str(tmp_path / "a"), **SMALL, block=700, workers=1)
    b = build_flex_run(str(tmp_path / "b"), **SMALL, block=2_000,
                       workers=3)
    assert _reads(a) == _reads(b)
    for k in ("mol_bc", "mol_gene", "mol_umi", "mol_reads"):
        assert np.array_equal(a[k], b[k]), k
    assert a["expected"] == b["expected"]


def test_build_flex_run_truth_reads_back(tmp_path):
    """The FASTQs hold what the truth says: every read's probe barcode of
    its kind, and each planted molecule's reads with an assigned probe
    barcode under its (product barcode, UMI)."""
    fx = build_flex_run(str(tmp_path / "fx"), **SMALL, block=1_000,
                        workers=2)
    r1, r2 = [], []
    for a, b in _reads(fx):
        r1 += a.split(b"\n")[1::4]
        r2 += b.split(b"\n")[1::4]
    assert len(r1) == fx["n_reads"] == fx["expected"]["total_reads"]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq1 = np.frombuffer(b"".join(r1), np.uint8).reshape(len(r1), -1)
    seq2 = np.frombuffer(b"".join(r2), np.uint8).reshape(len(r2), -1)
    assert seq1.shape[1] == 28 and seq2.shape[1] == 76
    codes = lambda s: np.searchsorted(acgt, s)  # noqa: E731
    listed = pack_codes_np(codes(np.asarray(
        [list(p.encode()) for p in rtl_probe_barcodes()], np.uint8)), 8)
    pbc = pack_codes_np(codes(seq2[:, 68:]), 8)
    dist = probe_bc_distances(pbc, listed)
    best = dist.min(1)
    ties = (dist == best[:, None]).sum(1) > 1
    assert not ties[best <= 1].any()
    assert (best == 0).sum() == fx["pbc_reads"]["exact"]
    assert (best == 1).sum() == fx["pbc_reads"]["one_mm"]
    assert (best >= 2).sum() == sum(fx["pbc_reads"][k]
                                    for k in FLEX_PBC_KINDS[2:])
    with open(fx["wl"], "rb") as f:
        wl = np.frombuffer(f.read(), np.uint8).reshape(-1, 17)[:, :16]
    bead = pack_codes_np(codes(seq1[:, :16]), 16)
    rank = np.searchsorted(pack_codes_np(codes(wl), 16), bead)
    umi = pack_codes_np(codes(seq1[:, 16:]), 12)
    ok = best <= 1
    prod = rank[ok].astype(np.int64) * 16 + dist[ok].argmin(1)
    keys, n = np.unique(np.stack([prod, umi[ok].astype(np.int64)]),
                        axis=1, return_counts=True)
    reads = dict(zip(map(tuple, keys.T.tolist()), n.tolist()))
    assert [reads.get((int(b), int(u))) for b, u in zip(
        fx["mol_bc"], fx["mol_umi"])] == fx["mol_reads"].tolist()
    assert fx["expected"]["usable_reads"] == int(fx["mol_reads"].sum())
