"""V(D)J at a full well's size, on the CPU at a few cells, tolerance 0
against the JAX package:

  * the kmer spectrum taken a block of whole (barcode[, UMI]) ranks at a
    time (`vdj/assembly.py` `_kmer_spectrum`): `count_bc_kmers` and
    `count_bc_umi_kmers` against the JAX package's on reads whose ranks
    hold hundreds of reads, with blocks of a few reads, blocks smaller
    than one read's windows, and few ranks a block; the largest block
    within `chunk` unless it is one rank;
  * `ReadStore.distinct_umis` against a loop over `ReadStore.reads`;
  * `run_vdj` of both packages on a library whose non-cell barcodes hold
    one UMI or two: every output file equal with the graph pool at 1 and
    at 3 workers, the one-UMI barcodes skipped (`barcodes_skipped`) and
    the two-UMI ones assembled; a worker that raises or dies ends the run
    with an error;
  * the fixture written a block of pairs at a time: the FASTQs of the
    5-cell library (and of tests/test_torch_vdj_b.py's B-cell world)
    equal to the digests of the unblocked writer, and a run over several
    blocks held to the fixture's truth.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from cellranger_tpu.pipeline import vdj as jax_vdj
from cellranger_tpu.vdj import assembly as jasm
from cellranger_tpu_torch.pipeline import vdj
from cellranger_tpu_torch.testing import fixtures
from cellranger_tpu_torch.vdj import assembly as tasm
from cellranger_tpu_torch.vdj import support
from chip_smoke import _barcode_names, tree_diffs, vdj_truth_diffs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reads(seed, n, n_bc=4, n_umi=6, L=60):
    """n reads over n_bc barcodes and n_umi UMIs (so a rank holds about
    n / (n_bc * n_umi) reads), a few source sequences, N bases and short
    reads; barcodes over the whole u32 range."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 4, (5, L + 20)).astype(np.uint8)
    off = rng.integers(0, 20, n)
    rna = src[rng.integers(0, 5, n)[:, None], off[:, None] + np.arange(L)]
    nmask = rng.random((n, L)) >= 0.01
    nmask[rng.random(n) < 0.1, L // 2:] = False
    bcs = np.array([0, 7, 0x80000000, 0xFFFFFFFF], np.uint32)[:n_bc]
    bc = bcs[rng.integers(0, n_bc, n)]
    umi = (rng.integers(0, n_umi, n).astype(np.uint32)
           * np.uint32(0x9E3779B9))
    return bc, umi, rna, nmask


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# (chunk in kmer rows, ranks a block): one block; about three reads a
# block, so that a rank's reads fall in many blocks; fewer than one
# read's 41 windows, so every block is one rank past its chunk; a few
# hundred reads a block but one or two ranks
BLOCKINGS = [(1 << 20, None), (3 * 41, None), (20, None), (41 * 400, 2),
             (41 * 400, 1)]          # 41 windows a 60-base read


@pytest.mark.parametrize("chunk,ranks", BLOCKINGS)
@pytest.mark.parametrize("umis", [False, True], ids=["bc", "bc_umi"])
def test_blocked_spectrum_matches_jax(chunk, ranks, umis, monkeypatch):
    bc, umi, rna, nmask = _reads(11 + umis, 1200)
    if ranks:
        monkeypatch.setattr(tasm, "RANKS_PER_KEY", ranks)
    stats = {}
    if umis:
        want = jasm.count_bc_umi_kmers(bc, umi, rna, nmask)
        got = tasm.count_bc_umi_kmers(bc, umi, rna, nmask, chunk=chunk,
                                      device="cpu", stats=stats)
        key = (bc.astype(np.uint64) << np.uint64(32)) | umi
    else:
        want = jasm.count_bc_kmers(bc, rna, nmask)
        got = tasm.count_bc_kmers(bc, rna, nmask, chunk=chunk,
                                  device="cpu", stats=stats)
        key = bc
    _same(got, want)
    assert (want[-1] > 1).any()
    n_ranks = len(np.unique(key))
    # a block past chunk is one rank; every rank here holds more reads
    # than three, so each of the small chunks' blocks is one rank, and a
    # barcode's reads (its UMIs' ranks) fall in several blocks
    assert stats["largest_block_rows"] <= chunk \
        or stats["largest_block_ranks"] == 1
    want_blocks = {1 << 20: 1, 3 * 41: n_ranks, 20: n_ranks}.get(
        chunk, n_ranks if ranks == 1 else None)
    if want_blocks is not None:
        assert stats["blocks"] == want_blocks
    assert stats["blocks"] >= -(-n_ranks // (ranks or n_ranks))


def test_blocked_spectrum_of_no_read():
    z = np.zeros(0, np.uint32)
    stats = {}
    got = tasm.count_bc_umi_kmers(z, z, np.zeros((0, 60), np.uint8),
                                  np.zeros((0, 60), bool), chunk=100,
                                  device="cpu", stats=stats)
    _same(got, (z, z, np.zeros(0, np.uint64), np.zeros(0, np.int32)))
    assert stats == dict(blocks=0, largest_block_rows=0,
                         largest_block_ranks=0)


@pytest.mark.parametrize("cap", [1, 3, 40, 10_000])
def test_distinct_umis_of_the_capped_rows(cap):
    rng = np.random.default_rng(cap)
    n = 3000
    bc = rng.choice(np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 77],
                             np.uint32), n)
    umi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    umi[rng.random(n) < 0.8] = 3
    z = np.zeros((n, 4), np.uint8)
    store = support.ReadStore(bc, umi, z, z.astype(bool), z,
                              np.zeros(n, np.int64), np.zeros(n, np.int64),
                              cap)
    got_bc, got_n = store.distinct_umis("cpu")
    want = {b: len(np.unique(store.reads(b).umi))
            for b in np.unique(bc).tolist()}
    assert got_bc.dtype == np.uint32
    assert got_bc.tolist() == sorted(want)
    assert got_n.tolist() == [want[b] for b in sorted(want)]


# ---------------------------------------------------------------------------
# run_vdj with non-cell barcodes of one and of two UMIs
# ---------------------------------------------------------------------------

CELLS, PAIRS, BACKGROUND = 5, 200, 40
TWO_UMI = 6                 # non-cell barcodes given a second molecule
SECOND_UMI = b"GATTACAGCA"


def _records(path):
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    return [lines[i:i + 4] for i in range(0, len(lines), 4)]


def _second_molecule(fx, k):
    """Give k of the fixture's non-cell barcodes a second molecule: each
    of their read pairs again under SECOND_UMI, appended to the FASTQs.
    Returns those barcodes."""
    r1, r2 = _records(fx["fq1"]), _records(fx["fq2"])
    background = sorted(b[:-2].encode() for b in fx["truth"]["background"])
    chosen = set(background[:k])
    extra1, extra2 = [], []
    for a, b in zip(r1, r2):
        if a[1][:16] in chosen:
            a = list(a)
            a[1] = a[1][:16] + SECOND_UMI + a[1][26:]
            extra1 += a
            extra2 += b
    with open(fx["fq1"], "ab") as f:
        f.writelines(extra1)
    with open(fx["fq2"], "ab") as f:
        f.writelines(extra2)
    return sorted(c.decode() + "-1" for c in chosen)


def _cfg_kw(fx):
    return dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                vdj_reference_fasta=fx["fa"], whitelist_path=fx["wl"],
                chemistry=fx["chemistry"], read_len=fx["read_len"],
                batch_size=1024)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The library and the JAX package's run of it."""
    tmp = tmp_path_factory.mktemp("vdj_scale")
    fx = fixtures.build_vdj_run(str(tmp / "fx"), CELLS, PAIRS,
                                **dict(fixtures.vdj_library_kw(CELLS),
                                       n_wl=20_000, background=BACKGROUND))
    two = _second_molecule(fx, TWO_UMI)
    want = jax_vdj.run_vdj(jax_vdj.VdjConfig(**_cfg_kw(fx)),
                           str(tmp / "jax"))
    return dict(fx=fx, two=two, want=want, j_out=str(tmp / "jax"))


@pytest.mark.parametrize("workers", [1, 3])
def test_run_vdj_skips_one_umi_barcodes(library, workers, tmp_path,
                                        monkeypatch):
    """Every file the JAX package's; the one-UMI non-cell barcodes
    skipped, the two-UMI ones and the cells assembled, in tasks of a
    barcode or two over `workers` processes."""
    monkeypatch.setattr(vdj, "GRAPH_WORKERS", workers)
    monkeypatch.setattr(vdj, "GRAPH_TASK_ROWS", 2000)
    got = vdj.run_vdj(vdj.VdjConfig(**_cfg_kw(library["fx"])),
                      str(tmp_path / "torch"), device="cpu")
    split = dict(vdj.LAST_SPLIT)
    assert got == library["want"]
    assert tree_diffs(str(tmp_path / "torch"), library["j_out"]) == []
    assert split["barcodes_skipped"] == BACKGROUND - TWO_UMI
    assert split["barcodes"] == CELLS + TWO_UMI
    assert split["graph_workers"] == workers
    names = set(_barcode_names(library["fx"]["wl"],
                               split["by_barcode"]["barcode"]))
    assert set(library["two"]) <= names
    assert len(split["by_barcode"]["graph_s"]) == CELLS + TWO_UMI
    # a two-UMI barcode can keep a contig: some are in the outputs
    with open(str(tmp_path / "torch" / "all_contig_annotations.csv")) as f:
        listed = {line.split(",")[0] for line in f.readlines()[1:]}
    assert listed & set(library["two"])


def _raises(spectra):
    raise RuntimeError("planted fault in a graph worker")


def _dies(spectra):
    os._exit(3)


@pytest.mark.parametrize("fault", [_raises, _dies], ids=["raises", "dies"])
def test_a_failed_worker_fails_the_run(library, fault, tmp_path,
                                       monkeypatch):
    from concurrent.futures.process import BrokenProcessPool

    monkeypatch.setattr(vdj, "GRAPH_WORKERS", 2)
    monkeypatch.setattr(vdj, "_assemble_spectra", fault)
    want = (RuntimeError, "planted fault") if fault is _raises \
        else (BrokenProcessPool, None)
    with pytest.raises(want[0], match=want[1]):
        vdj.run_vdj(vdj.VdjConfig(**_cfg_kw(library["fx"])),
                    str(tmp_path / "torch"), device="cpu")


# ---------------------------------------------------------------------------
# the fixture, a block of pairs at a time
# ---------------------------------------------------------------------------

# sha256 of the R1 and R2 FASTQs the unblocked writer made (the commit
# before the blocked one): build_vdj_run(dir, 5, 5000,
# **vdj_library_kw(5)), and tests/test_torch_vdj_b.py's world
DIGESTS = {
    "t5": ("73fe9c80743f5b32acd731db733586c49b2c8954dad95b5e6d0d67d13ed97181",
           "0696188d2d963aca7e0e30059006eae7ea40e5b464cf2e879c6179e2971a4b96"),
    "b8": ("1b18905ae8d8ce25a22b6a8ecbccea3ca1fd6ac4e3c71088ca47a8f31777f6af",
           "453effe1416ab67aadf547e97a0937b1e1f7bbb5536113b362ea23b1cb6e8029"),
}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("block", [fixtures.VDJ_WRITE_BLOCK, 1000, 333])
@pytest.mark.parametrize("world", ["t5", "b8"])
def test_fixture_fastqs_are_the_unblocked_writers(world, block, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(fixtures, "VDJ_WRITE_BLOCK", block)
    if world == "t5":
        fx = fixtures.build_vdj_run(str(tmp_path), 5, 5000,
                                    **fixtures.vdj_library_kw(5))
    else:
        from test_torch_vdj_b import BRANCH_PLAN, CELLS as B_CELLS, PAIRS
        fx = fixtures.build_vdj_b_run(str(tmp_path), B_CELLS, PAIRS,
                                      n_wl=20_000, background=40,
                                      plan=BRANCH_PLAN)
    assert fx["n_reads"] > 3 * block or block == fixtures.VDJ_WRITE_BLOCK
    assert (_sha256(fx["fq1"]), _sha256(fx["fq2"])) == DIGESTS[world]


def test_run_over_fixture_blocks_holds_the_truth(tmp_path, monkeypatch):
    """8 cells written 1,000 pairs at a time (3 blocks and a part): the
    port's run holds the fixture's truth."""
    monkeypatch.setattr(fixtures, "VDJ_WRITE_BLOCK", 1000)
    fx = fixtures.build_vdj_run(str(tmp_path / "fx"), 8, 400,
                                **dict(fixtures.vdj_library_kw(8),
                                       n_wl=20_000))
    assert 3 * 1000 < fx["n_reads"] < 4 * 1000
    got = vdj.run_vdj(vdj.VdjConfig(**_cfg_kw(fx)), str(tmp_path / "out"),
                      device="cpu")
    assert vdj_truth_diffs(fx, str(tmp_path / "out"), got,
                           fx["expected"]["bc_umi_pairs"]) == []
    assert vdj.LAST_SPLIT["barcodes_skipped"] == 8 * 20
