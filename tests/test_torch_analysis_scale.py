"""The port's kNN searches a block of rows at a time, against the JAX
package's whole-plane searches, on the CPU.

`graphclust.knn_search` takes the rows of a block from a byte budget
(KNN_BLOCK_BYTES at KNN_BYTES_PER_PAIR a candidate); the tests force
blocks of 1, 7 and 64 rows and the whole matrix by setting the budget to
that many rows.  Exact data (integer coordinates, every cell four times)
gives the JAX package's indices and distances exactly, ties in
`lax.top_k`'s order; the 2,000-cell 8-population projection differs only
at near-ties (`analysis_check.non_tie_slots`, the rule of
tests/test_torch_analysis.py).  Past `max_cells_tsne`,
`run_secondary_analysis` of both packages writes the same files and the
same CSVs.  `analysis_check.sampled_knn_check`, the card's float64 check
of a kNN result, passes on the port's and fails on one planted wrong
neighbour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellranger_tpu.analysis import batch_correction as jbc
from cellranger_tpu.analysis import graphclust as jgc
from cellranger_tpu.analysis import run as jrun
from cellranger_tpu_torch.analysis import batch_correction as tbc
from cellranger_tpu_torch.analysis import graphclust as tgc
from cellranger_tpu_torch.analysis import run as trun
from cellranger_tpu_torch.testing import analysis_check as check
from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix
from test_torch_analysis import _duplicate_cells, _inputs
from test_torch_analysis_run import _jax_matrix

BLOCKS = (1, 7, 64, None)   # None: all of a's rows in one block


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _force_rows(monkeypatch, rows, m):
    """A budget that puts `rows` rows in a block of a search against m
    candidates (None: 10**6 rows, more than any test's)."""
    monkeypatch.setattr(tgc, "KNN_BLOCK_BYTES",
                        (rows or 10**6) * m * tgc.KNN_BYTES_PER_PAIR)


def _blocks_seen(monkeypatch) -> list:
    """The [rows, m] shape of every distance block knn_search makes."""
    shapes, sq = [], tgc.sq_dists

    def recording(a, b):
        shapes.append((a.shape[0], b.shape[0]))
        return sq(a, b)

    monkeypatch.setattr(tgc, "sq_dists", recording)
    return shapes


def _cases():
    x, proj = _duplicate_cells(), _inputs("8pop")[1]
    return ((x, True), (proj, False))


@pytest.mark.parametrize("rows", BLOCKS)
def test_blocked_knn_graph_equal_jax(monkeypatch, rows):
    """Exact ties: indices and distances equal to the JAX package's.  The
    8-population projection: equal but at near-ties, as the whole-plane
    search was (26 of 60,000 slots at k = 30), at the graph's k too."""
    for x, exact in _cases():
        n = len(x)
        _force_rows(monkeypatch, rows, n)
        shapes = _blocks_seen(monkeypatch)
        ks = (3, 10, 30, tgc.default_knn_k(n))
        for k in ks:
            ji, jd = (np.asarray(v) for v in jgc.knn_graph(jnp.asarray(x), k))
            ti, td = (v.numpy() for v in tgc.knn_graph(torch.from_numpy(x),
                                                       k))
            if exact:
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(td, jd)
            assert not check.non_tie_slots(x, x, ji, ti), (rows, k)
            assert (ji != ti).sum() <= 0.001 * ji.size, (rows, k)
        assert {m for _, m in shapes} == {n}
        assert max(r for r, _ in shapes) == min(rows or n, n)
        assert sum(r for r, _ in shapes) == n * len(ks)
        monkeypatch.undo()


@pytest.mark.parametrize("rows", BLOCKS)
def test_blocked_cross_knn_equal_jax(monkeypatch, rows):
    """aggr's cross-batch search, batches of unequal size both ways, k
    above the smaller batch included (it then takes all of that batch)."""
    for x, exact in _cases():
        for a, b in ((x[:100], x[100:]), (x[100:], x[:100]),
                     (x[:15], x[15:]), (x[15:], x[:15])):
            _force_rows(monkeypatch, rows, len(b))
            shapes = _blocks_seen(monkeypatch)
            j = jbc._cross_knn(a, b, 20)
            t = tbc._cross_knn(a, b, 20, "cpu")
            assert t.shape == j.shape == (len(a), min(20, len(b)))
            if exact:
                np.testing.assert_array_equal(t, j)
            assert not check.non_tie_slots(a, b, j, t), rows
            assert (t != j).sum() <= 0.001 * j.size, rows
            assert max(r for r, _ in shapes) == min(rows or len(a), len(a))
            monkeypatch.undo()


def test_knn_block_rows_within_budget(monkeypatch):
    """Never over the budget, at least one row, and a budget that cannot
    hold one row raises; the default budget's rows at the card's sizes."""
    per = tgc.KNN_BYTES_PER_PAIR
    assert tgc.knn_block_rows(68_579) == 1_565
    assert tgc.knn_block_rows(20_000) == 5_368
    for m in (1, 7, 160, 2_000, 68_579, 10**6):
        for budget in (m * per, m * per + 1, 3 * m * per - 1, 4 << 30):
            if budget < m * per:
                continue
            monkeypatch.setattr(tgc, "KNN_BLOCK_BYTES", budget)
            r = tgc.knn_block_rows(m)
            assert r >= 1 and r * m * per <= budget
            assert (r + 1) * m * per > budget
        monkeypatch.setattr(tgc, "KNN_BLOCK_BYTES", m * per - 1)
        with pytest.raises(ValueError, match="over the budget"):
            tgc.knn_block_rows(m)
        with pytest.raises(ValueError, match="over the budget"):
            tgc.knn_graph(torch.zeros((m, 2)), 1)


def test_secondary_analysis_past_max_cells_tsne_matches_jax(tmp_path):
    """300 cells with max_cells_tsne = 200 in both packages: 14 files, no
    tsne/ or umap/, and the CSVs under analysis_check's rules (labels,
    hierarchy and diff-exp byte for byte)."""
    mat, truth = build_analysis_matrix(300, 1000, 3, seed=1)
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = jrun.run_secondary_analysis(_jax_matrix(mat), j_out,
                                     max_cells_tsne=200)
    tr = trun.run_secondary_analysis(mat, t_out, max_cells_tsne=200,
                                     device="cpu")
    files = check.analysis_files(t_out)
    assert files == check.analysis_files(j_out)
    assert not check.embedding_rule_diffs(files, 300, 200)
    assert check.embedding_rule_diffs(files, 200, 200)
    assert "tsne" not in tr and "umap" not in tr and "tsne" not in jr
    diffs, _ = check.compare_analysis(j_out, t_out, truth)
    assert not diffs, diffs
    np.testing.assert_array_equal(tr["clusterings"]["graphclust"],
                                  jr["clusterings"]["graphclust"])
    assert check.cluster_purity(tr["clusterings"]["graphclust"], truth) == 1


def test_sampled_knn_check_catches_a_planted_neighbour():
    """The float64 check passes on the port's kNN graph and cross search
    and fails on one planted wrong neighbour, on the row itself, and on
    one swap of two neighbours that are not a near-tie."""
    proj = _inputs("8pop")[1]
    k = tgc.default_knn_k(len(proj))
    idx = tgc.knn_graph(torch.from_numpy(proj), k)[0].numpy()
    bad, seen = check.sampled_knn_check(proj, proj, idx, 500,
                                        exclude_self=True)
    assert not bad and seen["rows"] == 500 and seen["k"] == k
    rows = check.sampled_knn_check(proj, proj, idx, 2000,
                                   exclude_self=True)[1]
    assert rows["slots_differ"] >= seen["slots_differ"]
    far = int(np.argmax(((proj - proj[5]) ** 2).sum(1)))
    for plant, slot in ((far, 3), (5, 0), (int(idx[5, k - 1]), 0)):
        wrong = idx.copy()
        wrong[5, slot] = plant
        bad = check.sampled_knn_check(proj, proj, wrong, 2000,
                                      exclude_self=True)[0]
        assert bad == [(5, slot)], (plant, bad)
    # the rule's edge: two neighbours swapped at half and at twice the
    # near-tie's width (|a|^2 = 0, |b|^2 ~ 1)
    for gap, flagged in ((0.5, False), (2.0, True)):
        b = np.asarray([[1.0, 0.0],
                        [np.sqrt(1 + gap * check.KNN_TIE_EPS), 0.0],
                        [3.0, 0.0]])
        got = np.asarray([[1, 0]])
        assert bool(check.sampled_knn_check(np.zeros((1, 2)), b, got, 1)[0]) \
            == flagged, gap
    a, b = proj[:1200], proj[1200:]
    cross = tbc._cross_knn(a, b, 20, "cpu")
    assert not check.sampled_knn_check(a, b, cross, 1200)[0]
    cross[7, 19] = int(np.argmax(((b - a[7]) ** 2).sum(1)))
    assert check.sampled_knn_check(a, b, cross, 1200)[0] == [(7, 19)]


def test_analysis_68k_beside_in_a_child_process(tmp_path, monkeypatch):
    """chip_smoke runs analysis_68k in a child process beside the human
    phases: its report comes back, at a small size on the cpu, and a
    child that fails raises with its output.  The child gets two threads,
    as this suite's processes do: with one a core beside the suite's
    workers, its thousand small t-SNE steps crawl."""
    import chip_smoke

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "2")
    with chip_smoke.phase_beside("analysis_68k", str(tmp_path), 300,
                                 str(tmp_path), 300, 400, "cpu",
                                 100) as report:
        g = report()
    assert g["cells"] == 300 and g["sw_launches"] == 0, g
    assert g["knn_check"] == dict(rows=100, k=9, slots_differ=g[
        "knn_check"]["slots_differ"], non_tie_mismatches=0)
    with pytest.raises(AssertionError, match="child process: exit 1"):
        with chip_smoke.phase_beside("analysis_68k", str(tmp_path), 300,
                                     str(tmp_path), 300, 10, "cpu",
                                     100) as report:
            report()
