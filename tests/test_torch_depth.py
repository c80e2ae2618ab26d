"""A 3' well at depth (testing/fixtures.py `build_depth_run`) and the BAM
writer bounded by records (pipeline/bam_out.py BAND_RECORDS, the spool of
pipeline/bam_spool.py), at small sizes on the CPU:

  * the well at 30,000 reads, 60 cells and a 20,000-barcode whitelist
    through both packages' run_count, count-only and with BAM: metrics,
    MEX, the three h5 files and the decompressed BAM equal, and the
    port's outputs the fixture's truth (chip_smoke.depth_truth_diffs,
    depth_bam_diffs).  The whitelist cannot hold the 90,000 barcodes
    EmptyDrops needs for its background, so the well has no ambient
    barcode and no low cell: ordmag alone calls them, exactly;
  * the writer at a band budget of a few hundred records on that
    one-chromosome run, whose hot gene's band passes the budget: .bam and
    .bai equal to `write_plain`'s and to the one-band run's, every part
    within the budget; across two hosts' spools; after a resume from a
    sealed spool;
  * the generator's lanes: the same reads for any block size and worker
    count;
  * the writer's pieces: `_ViewIndex` against `lex3_join_np` on views in
    partition order (not sorted), `_cut_parts`, `Strings`.
"""

import gzip
import hashlib
import os

import numpy as np
import pytest
import torch

import chip_smoke
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as jax_cc
from cellranger_tpu_torch.io.fastq import find_fastqs
from cellranger_tpu_torch.pipeline import bam_out
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.native.strings import Strings
from cellranger_tpu_torch.pipeline.spill import lex3_join_np
from cellranger_tpu_torch.testing.fixtures import READ_LEN, build_depth_run
from cellranger_tpu_torch.testing.multihost_worker import launch
from test_torch_hdf5 import h5_parity_diffs

BAM = "possorted_genome_bam.bam"
READS, CELLS, WL = 30_000, 60, 20_000
BATCH = 8192
BUDGET = 400            # BAM records held at once in the bounded runs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _well(tmp, **kw):
    return build_depth_run(str(tmp), READS, n_cells=CELLS, n_wl=WL,
                           n_ambient=0, low_share=0, workers=2, **kw)


@pytest.fixture(scope="module")
def well(tmp_path_factory):
    return _well(tmp_path_factory.mktemp("depth") / "fx")


def _cfg(fx, **kw):
    return dict(dict(fastq_pairs=find_fastqs(fx["fastq_dir"]),
                     reference_path=fx["ref"], whitelist_path=fx["wl"],
                     chemistry="SC3Pv3", read_len=READ_LEN, batch_size=BATCH,
                     secondary_analysis=False, checkpoint=False), **kw)


@pytest.fixture(scope="module")
def one_band_bam(well, tmp_path_factory):
    """The port's BAM run of the well at the real budget: one band."""
    out = str(tmp_path_factory.mktemp("one_band") / "out")
    s = tcount.run_count(tcount.CountConfig(**_cfg(well, write_bam=True)),
                         out, device="cpu")
    assert bam_out.LAST_SPLIT["parts"] == 1        # every read mapped
    return out, s


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("bam", [False, True], ids=["count", "bam"])
def test_depth_well_matches_jax_and_truth(bam, well, one_band_bam, tmp_path):
    kw = _cfg(well, write_bam=bam)
    j_out = str(tmp_path / "jax")
    j_sum = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    if bam:
        t_out, t_sum = one_band_bam
    else:
        t_out = str(tmp_path / "torch")
        t_sum = tcount.run_count(tcount.CountConfig(**kw), t_out,
                                 device="cpu")
    assert not jax_cc.check_metrics(t_sum, j_sum)
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert not jax_cc.check_mtx(os.path.join(t_out, sub, f),
                                        os.path.join(j_out, sub, f)), (sub, f)
        assert not h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                                   os.path.join(j_out, sub + ".h5")), sub
    assert not h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                               os.path.join(j_out, "molecule_info.h5"),
                               molecule_info=True)
    # both packages call exactly the planted cells, and the port's outputs
    # are the fixture's truth
    assert j_sum["estimated_cells"] == CELLS
    assert not chip_smoke.depth_truth_diffs(well, t_out, t_sum)
    if bam:
        assert (chip_smoke.bam_payload(os.path.join(t_out, BAM))
                == chip_smoke.bam_payload(os.path.join(j_out, BAM)))
        diffs, rep = chip_smoke.depth_bam_diffs(well, t_out, str(tmp_path),
                                                n_sample=2_000)
        assert not diffs, diffs
        assert rep["primary_records"] == READS


def test_bounded_writer_equals_plain_and_one_band(well, one_band_bam,
                                                  tmp_path, monkeypatch):
    """The one-chromosome well at a budget of BUDGET records: its hot
    gene's band (8% of the reads in 592 bases) and others pass it, so
    they are spooled again and loaded in parts; the BAM equals the plain
    writer's from the same spool and the one-band run's."""
    monkeypatch.setattr(bam_out, "BAND_RECORDS", BUDGET)
    out = str(tmp_path / "out")
    with chip_smoke.plain_beside():
        tcount.run_count(tcount.CountConfig(**_cfg(well, write_bam=True)),
                         out, device="cpu")
    split = dict(bam_out.LAST_SPLIT)
    assert not chip_smoke.plain_diffs(out)
    one = os.path.join(one_band_bam[0], BAM)
    assert _bytes(os.path.join(out, BAM)) == _bytes(one)
    assert _bytes(os.path.join(out, BAM + ".bai")) == _bytes(one + ".bai")
    assert split["band_rows_max"] <= BUDGET
    hot = well["mol_gene"] == well["hot_gene"]
    assert split["respooled_rows"] >= well["mol_reads"][hot].sum() > 0
    assert split["parts"] > READS // BUDGET
    assert split["bands"] == -(-2 * READS // BUDGET) + 1


def test_two_host_bounded_run_equals_plain(well, tmp_path):
    """Two gloo processes at the budget, each with its own spool of the
    bands both cut from the run's read count; host 0 merges both in parts
    and writes the BAM twice (tests/bam_bounded_worker.py)."""
    cfg = _cfg(well, batch_size=2048, write_bam=True)
    out = str(tmp_path / "out")
    res = launch(cfg, out, 2, "cpu", 240,
                 dict(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
                      TEST_BAND_RECORDS=str(BUDGET)),
                 module="tests.bam_bounded_worker")
    for pid, r in enumerate(res):
        assert r["rc"] == 0 and r["out"] is not None, (pid, r["err"])
    assert res[0]["out"]["total_reads"] == READS
    assert not chip_smoke.plain_diffs(out)
    assert chip_smoke.bam_records(os.path.join(out, BAM)) >= READS


def test_bounded_run_resumes_from_sealed_spool(well, one_band_bam, tmp_path,
                                               monkeypatch):
    """A checkpointed BAM run at the budget killed at BAM write time: the
    rerun reopens the sealed spool (its bands from spool.json), reads no
    FASTQ, and writes the one-band run's BAM."""
    monkeypatch.setattr(bam_out, "BAND_RECORDS", BUDGET)
    cfg = tcount.CountConfig(**_cfg(well, write_bam=True, checkpoint=True))
    out = str(tmp_path / "out")
    real_write = bam_out.BamCollector.write

    def boom(self, *a, **k):
        raise RuntimeError("killed at BAM write")

    monkeypatch.setattr(bam_out.BamCollector, "write", boom)
    with pytest.raises(RuntimeError, match="killed"):
        tcount.run_count(cfg, out, device="cpu")
    monkeypatch.setattr(bam_out.BamCollector, "write", real_write)

    def no_pass(*a, **k):
        raise AssertionError("FASTQ pass re-executed on resume")

    monkeypatch.setattr(tcount, "batches_from_fastqs", no_pass)
    s = tcount.run_count(cfg, out, device="cpu")
    assert s["total_reads"] == READS
    assert bam_out.LAST_SPLIT["band_rows_max"] <= BUDGET
    assert bam_out.LAST_SPLIT["bands"] == -(-2 * READS // BUDGET) + 1
    one = os.path.join(one_band_bam[0], BAM)
    assert _bytes(os.path.join(out, BAM)) == _bytes(one)
    assert _bytes(os.path.join(out, BAM + ".bai")) == _bytes(one + ".bai")


def _fastq_digests(fx) -> list[str]:
    out = []
    for pair in fx["pairs"]:
        for path in pair:
            with gzip.open(path, "rb") as f:
                out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def test_generator_blocks_and_lanes_give_the_same_reads(well, tmp_path):
    """The well's FASTQs at blocks of 1,000 and 333 reads by one worker
    and by three: the same reads (decompressed), the same truth; every
    lane a quarter of the reads, every read name its number."""
    want = _fastq_digests(well)
    for block, workers in ((1000, 1), (333, 3)):
        fx = build_depth_run(str(tmp_path / f"b{block}"), READS,
                             n_cells=CELLS, n_wl=WL, n_ambient=0,
                             low_share=0, block=block, workers=workers,
                             ref=well)
        assert _fastq_digests(fx) == want, block
        for k in ("mol_bc", "mol_gene", "mol_umi", "mol_reads", "cells"):
            np.testing.assert_array_equal(fx[k], well[k])
    with gzip.open(well["pairs"][2][0], "rb") as f:
        lines = f.read().split(b"\n")
    assert len(lines) == 4 * READS // 4 + 1
    assert lines[0] == b"@D%010d" % (READS // 2)
    assert int(well["mol_reads"].sum()) == READS


def test_view_index_equals_lex3_join_on_unsorted_views():
    """The views as the dedup gives them (partitions concatenated, each
    sorted, not sorted overall) with duplicate-free triples; queries that
    hit, miss, and fall before and after every view: `_ViewIndex.lookup`
    gives lex3_join_np's (idx, found) where found, and the same found."""
    rng = np.random.default_rng(5)
    parts = []
    for p in range(4):
        bc = rng.integers(0, 50, 3000).astype(np.uint32) * 4 + p
        t = np.unique(np.stack([bc, rng.integers(0, 9, 3000),
                                rng.integers(0, 64, 3000)], 1).astype(
                                    np.uint32), axis=0)
        parts.append(t)
    t = np.concatenate(parts)
    views = (t[:, 0].copy(), t[:, 1].copy(), t[:, 2].copy(),
             rng.integers(0, 64, len(t)).astype(np.uint32),
             rng.random(len(t)) < 0.2)
    q = np.concatenate([t[rng.integers(0, len(t), 5000)],
                        rng.integers(0, 210, (5000, 3)).astype(np.uint32),
                        np.array([[0, 0, 0], [2**32 - 1] * 3], np.uint32)])
    vi = bam_out._ViewIndex(views)
    idx, found = vi.lookup(q[:, 0], q[:, 1], q[:, 2])
    jidx, jfound = lex3_join_np(*views[:3], q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_array_equal(idx[found], jidx[jfound])
    assert found.any() and not found.all()


def test_cut_parts_and_strings():
    """`_cut_parts` keeps every part within the budget unless one key
    alone passes it; `Strings` takes, joins and orders rows as lists of
    bytes and numpy's 'S' order do."""
    rng = np.random.default_rng(2)
    cnt = rng.integers(1, 60, 500)
    cnt[[7, 100, 101]] = [900, 300, 51]
    for budget in (1, 100, 250, 1000):
        part = bam_out._cut_parts(cnt, budget)
        assert part[0] == 0 and np.all(np.diff(part) >= 0)
        rows = np.bincount(part, weights=cnt)
        keys = np.bincount(part)
        assert np.all((rows <= budget) | (keys == 1))
    items = [bytes(rng.integers(0, 256, rng.integers(0, 20)).astype(np.uint8))
             for _ in range(300)] + [b"", b"a", b"a\x01", b"ab"]
    s = Strings.of(items)
    idx = rng.integers(0, len(items), 200)
    assert s.take(idx).tolist() == [items[i] for i in idx]
    assert Strings.concat([s.take(idx[:50]), Strings.empty(0),
                           s.take(idx[50:])]).tolist() \
        == [items[i] for i in idx]
    w = s.words()
    order = np.lexsort([w[:, j] for j in reversed(range(w.shape[1]))])
    ref = np.argsort(np.asarray(items, dtype=bytes), kind="stable")
    assert [items[i] for i in order] == [items[i] for i in ref]
