"""Port parity for `count` on a Perturb-seq GEM well, tolerance 0.

`testing.fixtures.build_perturb_run` at a small size (300 cells, 400
20-base guides drawn with a skewed representation, 17 TotalSeq-B
antibodies, a 20,000-barcode whitelist: Gene Expression, CRISPR Guide
Capture and Antibody Capture libraries in one GEM well, ~110,000 reads,
secondary analysis off) goes through the JAX package's `run_count` and
through chip_smoke's `perturb_run`, the card's phase, on the cpu.  The two
runs are held equal:

  * every count output (MEX, h5 files through h5py, CSVs) and the
    metrics, the protospacer metrics among them;
  * `crispr_analysis/protospacer_calls_per_cell.csv` and
    `protospacer_calls_summary.csv`, byte for byte;
  * `chip_smoke.perturb_outputs` of both, which is what the card's phase
    holds against `PERTURB_EXPECTED`, with both branches of
    `call_features` taken in both packages.

The guide reads go through the antibodies' pattern first and the guides'
unanchored pattern second, so every found guide read is taken by
`process_fb`'s merge of patterns; `chip_smoke.perturb_reads` holds each
read's extraction to the fixture's construction (a substitution in the
first four guide bases an exact hit on the last 16, one after them
corrected, a doubled prefix found at its first copy, an N-prefixed read
not extracted).  The fixture's reads are read back from the FASTQs, and
the phase's comparators fail on planted faults.
"""

import copy
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from cellranger_tpu.analysis import feature_assigner as jax_assigner
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu_torch.testing.fixtures import (PERTURB_CARRY_SHARES,
                                                   PERTURB_GUIDE_LEN,
                                                   PERTURB_GUIDE_MIN_DIST,
                                                   PERTURB_PREFIX,
                                                   PERTURB_READ_KINDS,
                                                   build_perturb_run)
from chip_smoke import (perturb_config, perturb_diffs, perturb_outputs,
                        perturb_run, recorded)
from test_torch_count import _compare_runs

SMALL = dict(n_cells=300, n_target_genes=200, n_nontargeting=0,
             gex_reads=60_000, guide_reads=30_000, n_antibodies=17,
             ab_reads=20_000, n_wl=20_000, genome_len=2_000_000,
             n_genes=200, n_types=3)
BATCH = 4096            # several batches of each library
CSVS = ("protospacer_calls_per_cell.csv", "protospacer_calls_summary.csv")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def perturb(tmp_path_factory):
    t = tmp_path_factory.mktemp("perturb")
    fx = build_perturb_run(str(t / "fx"), **SMALL)
    torch.set_num_threads(2)
    j_out = str(t / "jax")
    with recorded((jax_assigner, "_fit_two_gaussians")) as rec:
        jax_count.run_count(perturb_config(
            fx, jax_count, BATCH, secondary_analysis=False), j_out)
    t_out = str(t / "torch")
    report = perturb_run(fx, t_out, "cpu", batch_size=BATCH,
                         secondary_analysis=False)
    got, want = (_metrics(o) for o in (t_out, j_out))
    return dict(fx=fx, t_out=t_out, j_out=j_out, want=want, got=got,
                report=report, expected=perturb_outputs(
                    fx, j_out, [r for _, r in rec["_fit_two_gaussians"]]))


def _metrics(out: str) -> dict:
    """A run's metrics_summary.json without its wall time."""
    with open(os.path.join(out, "metrics_summary.json")) as f:
        m = json.load(f)
    m.pop("wall_time_s")
    return m


def _fastq_rows(path: str, width: int) -> np.ndarray:
    with open(path, "rb") as f:
        rows = np.frombuffer(f.read(), np.uint8)
    return rows.reshape(-1, 16 + 2 * width + 4)[:, 16:16 + width]


def _cells_of(fx: dict, r1: np.ndarray) -> np.ndarray:
    """The cell of each read's barcode, a barcode with an error taken back
    to the one cell barcode a base away (asserted unique)."""
    cells = np.asarray([b[:16].encode() for b in fx["barcodes"]])
    rows = cells.view(np.uint8).reshape(len(cells), 16)
    bcs = np.ascontiguousarray(r1[:, :16]).view("S16").ravel()
    order = np.argsort(cells)
    pos = np.minimum(np.searchsorted(cells[order], bcs), len(cells) - 1)
    cell = np.where(cells[order][pos] == bcs, order[pos], -1)
    for i in np.flatnonzero(cell < 0):
        near = np.flatnonzero((rows != r1[i, :16]).sum(1) == 1)
        assert len(near) == 1, i
        cell[i] = near[0]
    return cell


def test_fixture_reads_back_the_planted_truth(perturb):
    """The guides are 20 bases, their last 16 PERTURB_GUIDE_MIN_DIST
    apart; cells carry one, two or no guides in PERTURB_CARRY_SHARES; the
    guide FASTQ holds each read's prefix and guide where the fixture says,
    with its substitution or N, and the doubled prefix; every guide
    molecule has a read that is not N-prefixed, and every UMI is distinct
    within a cell across the three libraries; the feature reference lists
    the antibodies first and carries the guides' targets."""
    fx = perturb["fx"]
    n, G = SMALL["n_cells"], len(fx["guides"])
    seqs = np.asarray([list(s.encode()) for s in fx["guides"].values()],
                      np.uint8)
    assert seqs.shape == (G, PERTURB_GUIDE_LEN)
    tails = seqs[:, -16:]
    dist = (tails[:, None] != tails[None]).sum(-1)
    assert dist[~np.eye(G, dtype=bool)].min() >= PERTURB_GUIDE_MIN_DIST
    carried = fx["carried"]
    n_carry = (carried >= 0).sum(1)
    assert [int((n_carry == k).sum()) for k in (1, 2)] == \
        [round(n * s) for s in PERTURB_CARRY_SHARES[:2]]
    assert (carried[n_carry == 2, 0] != carried[n_carry == 2, 1]).all()

    (_, (r1p, r2p)) = fx["libraries"][1]
    r2 = _fastq_rows(r2p, 91)
    r1 = _fastq_rows(r1p, 28)
    assert len(r2) == fx["guide_reads"]
    kind = np.asarray(PERTURB_READ_KINDS)[fx["guide_read_kind"]]
    off = fx["guide_read_offset"]
    pre = np.frombuffer(PERTURB_PREFIX.encode(), np.uint8)
    P, L = len(pre), PERTURB_GUIDE_LEN
    rows = np.arange(len(r2))[:, None]
    got_pre = r2[rows, off[:, None] - P + np.arange(P)]
    got_g = r2[rows, off[:, None] + np.arange(L)]
    want_g = seqs[fx["guide_read_guide"]]
    npre = kind == "n_prefix"
    assert ((got_pre == pre).all(1) == ~npre).all()
    assert ((got_pre == ord("N")).sum(1) == npre).all()
    sub = kind == "substitution"
    diff = (got_g != want_g).sum(1)
    assert (diff[sub] == 1).all() and (diff[~sub] == 0).all()
    pos = fx["guide_read_sub_pos"]
    assert (got_g[sub, pos[sub]] != want_g[sub, pos[sub]]).all()
    assert set(pos[sub]) == set(range(L))
    dbl = np.flatnonzero(kind == "double")
    assert (r2[dbl[:, None], off[dbl, None] + L + np.arange(P)] == pre).all()
    # the reads of a (cell, UMI) are one molecule of one guide, and at
    # least one of them carries its prefix intact
    key = np.char.add(_cells_of(fx, r1).astype("S8"),
                      np.ascontiguousarray(r1[:, 16:]).view("S12").ravel())
    order = np.argsort(key, kind="stable")
    k, first = np.unique(key[order], return_index=True)
    g_of = fx["guide_read_guide"][order]
    assert (g_of == np.repeat(g_of[first], np.diff(np.r_[first,
                                                         len(order)]))).all()
    ok = np.zeros(len(k), bool)
    np.logical_or.at(ok, np.searchsorted(k, key), ~npre)
    assert ok.all()
    assert len(k) == fx["guide_pairs"][2].sum()
    with open(fx["feature_ref"]) as f:
        lines = f.read().splitlines()
    assert lines[0].endswith(",target_gene_id,target_gene_name")
    assert lines[1].split(",")[5] == "Antibody Capture"
    assert lines[-1].split(",")[5:] == ["CRISPR Guide Capture"] + \
        [fx["guide_targets"][-1]] * 2


def test_count_outs_match_jax(perturb):
    """Every count output equal to the JAX run's, the protospacer metrics
    and both crispr_analysis CSVs included."""
    p = perturb
    _compare_runs(p["t_out"], p["j_out"], p["got"], p["want"])
    for name in CSVS:
        assert filecmp.cmp(os.path.join(p["t_out"], "crispr_analysis", name),
                           os.path.join(p["j_out"], "crispr_analysis", name),
                           shallow=False), name
    assert p["got"]["total_reads"] == p["fx"]["n_reads"]
    for k in ("one", "multiple", "no"):
        key = f"cells_with_{k}_protospacer_frac"
        assert p["got"][key] == p["want"][key]


def test_chip_phase_report_matches_jax(perturb):
    """What the card's phase holds: perturb_outputs equal to the JAX run's,
    both call_features branches taken, every planted molecule counted,
    every guide read extracted as it was built and taken by the merge of
    patterns; its timers filled."""
    rep, want = perturb["report"], perturb["expected"]
    got = rep["outputs"]
    assert perturb_diffs(got, want) == []
    assert got["em_guides"] > 0 and got["fallback_guides"] > 0
    assert got["em_guides"] + got["fallback_guides"] == \
        len(perturb["fx"]["guides"])
    truth = got["truth"]
    assert truth["barcodes_off_planted_molecules"] == 0
    assert truth["stray_barcodes"] == 0
    assert truth["shared_umi_loss"] == 0
    assert truth["single_guide_cells_own_guide"] >= 0.95
    assert got["guide_molecules"] == int(perturb["fx"]["guide_pairs"][2]
                                         .sum())
    for k, v in rep["reads"].items():
        assert v["got"] == v["built"], k
    assert rep["reads"]["merged"]["got"] > 0.99 * SMALL["guide_reads"]
    assert rep["reads"]["head_substitutions_exact"]["got"] > 0
    assert rep["reads"]["double_prefix_first_copy"]["got"] > 0
    for k in ("crispr_pass2_s", "ab_pass2_s", "feature_assignment_s"):
        assert rep[k] > 0, k
    assert rep["peak_host_rss_bytes"] > 0


def _set(keys: tuple, value):
    def plant(o: dict) -> None:
        for k in keys[:-1]:
            o = o[k]
        o[keys[-1]] = value(o[keys[-1]])
    return plant


@pytest.mark.parametrize("fault", [
    _set(("mex_sha256", "raw_feature_bc_matrix/matrix.mtx.gz"),
         lambda v: "0" * 64),
    _set(("protospacer_calls_per_cell_sha256",), lambda v: v[::-1]),
    _set(("protospacer_calls_summary_sha256",), lambda v: None),
    _set(("cells_with_no_protospacer_frac",), lambda v: v + 1e-12),
    _set(("usable_reads_by_library",), lambda v: v[:1] + [v[1] - 1]
         + v[2:]),
    _set(("em_guides",), lambda v: v + 1),
    _set(("truth", "single_guide_cells_own_guide"), lambda v: v - 1 / 300),
    _set(("truth", "shared_umi_loss"), lambda v: v + 1),
], ids=["mex", "calls_csv", "summary_csv", "frac", "library_reads", "em",
        "own_guide", "loss"])
def test_perturb_diffs_catch_faults(perturb, fault):
    """The phase's comparator against planted faults: every field exact."""
    want = perturb["expected"]
    got = copy.deepcopy(want)
    fault(got)
    assert perturb_diffs(got, want)
    assert not perturb_diffs(copy.deepcopy(want), want)
