"""Count past the molecule state's cap with the port's partition dedup
bounded in device memory (pipeline/count.py DEDUP_CHUNK_LIMIT,
parallel/molecule_state.py split_partition, MoleculeState.bound_dedup):

  * a partition built so that one barcode-hash bucket sits one row over
    the limit: split_partition splits that bucket again, every piece holds
    whole barcodes and at most `limit` rows, and dedup_partitions of the
    pieces pads no device call past _pow2(limit) and gives the molecules
    of the JAX package's Executor(None).dedup_partitions over the whole
    partition;
  * run_count of both packages on a small build_e2e_run (the generator of
    chip_smoke's `deep`), the port with DEDUP_CHUNK_LIMIT lowered, once
    with MOLECULE_STATE_CAP and MOLECULE_BUFFER_ROWS lowered too (the
    state flushes mid-run and at the end) and once at the real cap (the
    state flushes at the end because its rows exceed the limit), the JAX
    package with its own constants: metrics, MEX and the three h5 files
    equal; every dedup_molecules call within _pow2(limit) rows;
  * build_synthetic_run through the spill with the limit under a spill
    partition's rows, so the partitions sub-split: with BAM on one device
    (BAM bytes and index equal too) and count-only on a mesh of 4 cpu
    entries (the mesh's partition dedup, a piece a device);
  * chip_smoke's `deep` on the cpu at that small size with the cap
    lowered, against the JAX run's reads, molecules and MEX digests.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from cellranger_tpu.parallel.executor import Executor as JaxExecutor
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.parallel import mesh, molecule_state
from cellranger_tpu_torch.parallel.molecule_state import (_mix32, _pow2,
                                                          dedup_partitions,
                                                          split_partition)
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing.fixtures import (READ_LEN, build_e2e_run,
                                                   build_synthetic_run)
from test_torch_hdf5 import h5_parity_diffs

UMI_LEN = 12
# the small deep run: 6,000 molecules over 2,000 cells, 6 steps; the
# port's state holds 8,192 rows and drains its buffer every 3 steps, so it
# flushes mid-run; dedup calls of 1,024 rows
SMALL_READS = 12_000
SMALL_BATCH = 2048
SMALL_CAP = 1 << 13
SMALL_BUFFER = 4096
SMALL_LIMIT = 1 << 10


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(fx, **kw):
    return dict(dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                     reference_path=fx["ref"], whitelist_path=fx["wl"],
                     chemistry="SC3Pv3", read_len=READ_LEN,
                     batch_size=SMALL_BATCH, secondary_analysis=False,
                     checkpoint=False), **kw)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """build_e2e_run at SMALL_READS and the JAX package's run of it, with
    that package's own constants."""
    tmp = tmp_path_factory.mktemp("deep")
    fx = build_e2e_run(str(tmp / "fx"), n_reads=SMALL_READS)
    j_out = str(tmp / "jax")
    j_sum = jax_count.run_count(jax_count.CountConfig(**_cfg(fx)), j_out)
    return dict(fx=fx, j_out=j_out, j_sum=j_sum)


@pytest.fixture
def recorded(monkeypatch):
    """Record the rows of every dedup_molecules call of molecule_state.py
    and the rows of every flush of the molecule state."""
    rec = dict(calls=[], flushes=[])
    dedup = molecule_state.dedup_molecules
    flush = molecule_state.MoleculeState.flush_to_host

    def counted_dedup(bc, *a, **kw):
        rec["calls"].append(int(bc.shape[0]))
        return dedup(bc, *a, **kw)

    def counted_flush(self):
        flush(self)
        rec["flushes"].append(len(self.flushed[-1]))

    monkeypatch.setattr(molecule_state, "dedup_molecules", counted_dedup)
    monkeypatch.setattr(molecule_state.MoleculeState, "flush_to_host",
                        counted_flush)
    return rec


def _one_over_partition(limit: int):
    """(bc, gene, umi, reads) of one partition of 2 x limit - 23 rows,
    25 rows a barcode, whose first hash split (k = 2) puts limit + 1 rows
    in bucket 0."""
    cand = np.arange(1, 4000, dtype=np.uint32) * np.uint32(7919)
    side = _mix32(cand, 0) % np.uint32(2)
    n0 = (limit + 1) // 25
    n1 = (2 * limit - 23) // 25 - n0
    bcs = np.concatenate([cand[side == 0][:n0], cand[side == 1][:n1]])
    rng = np.random.default_rng(3)
    bc = np.repeat(bcs, 25)
    n = len(bc)
    base = rng.integers(0, 1 << 24, n // 2).astype(np.uint32)
    umi = base[rng.integers(0, len(base), n)]
    flip = rng.random(n) < 0.3              # 1-base UMI errors
    pos = rng.integers(0, UMI_LEN, n).astype(np.uint32)
    umi = np.where(flip, umi ^ (np.uint32(1) << (2 * pos)), umi)
    return (bc, rng.integers(0, 3, n).astype(np.uint32), umi.astype(np.uint32),
            rng.integers(1, 4, n).astype(np.uint32))


@pytest.mark.parametrize("keep_raw", [False, True])
def test_split_partition_holds_the_limit_one_row_over(keep_raw, monkeypatch):
    limit = 1024
    part = _one_over_partition(limit)
    n = len(part[0])
    assert limit < n <= 2 * limit
    first = _mix32(part[0], 0) % np.uint32(2)
    assert (first == 0).sum() == limit + 1     # k buckets alone pad to 2048
    pieces = split_partition(part, limit)
    assert len(pieces) > 2 and all(len(p[0]) <= limit for p in pieces)
    seen = [set(p[0].tolist()) for p in pieces]
    assert sum(map(len, seen)) == len(set().union(*seen))   # whole barcodes
    assert sorted(zip(*[np.concatenate([p[c] for p in pieces]).tolist()
                        for c in range(4)])) \
        == sorted(zip(*[c.tolist() for c in part]))
    padded = []
    host = molecule_state._dedup_host

    def counted(bc, gene, umi, umi_len, N, *a):
        padded.append(N)
        return host(bc, gene, umi, umi_len, N, *a)

    monkeypatch.setattr(molecule_state, "_dedup_host", counted)
    got = list(dedup_partitions(pieces, UMI_LEN, "cpu", chunk_limit=limit,
                                keep_raw=keep_raw))
    assert padded and max(padded) <= _pow2(limit)
    want = list(JaxExecutor(None).dedup_partitions([part], UMI_LEN,
                                                   keep_raw=keep_raw))
    groups = [("mol_bc", "mol_gene", "mol_umi", "mol_reads")] + (
        [("raw_bc", "raw_gene", "raw_umi", "raw_corr_umi", "raw_low",
          "raw_reads")] if keep_raw else [])

    def rows(dds, keys):
        return sorted(zip(*[np.concatenate(
            [np.asarray(d[k]).astype(np.int64) for d in dds]).tolist()
            for k in keys]))

    for keys in groups:
        assert rows(got, keys) == rows(want, keys), keys


def test_split_partition_keeps_one_barcode_whole():
    bc = np.full(3000, 77, np.uint32)
    part = (bc, np.arange(3000, dtype=np.uint32), bc)
    assert split_partition(part, 1024) == [part]


@pytest.mark.parametrize("state", ["cap", "limit_only"])
def test_run_count_bounded_matches_jax(state, small, recorded, tmp_path,
                                       monkeypatch):
    """The port with the dedup limit lowered (and, for "cap", the state's
    cap and buffer) against the JAX package with its own constants."""
    monkeypatch.setattr(tcount, "DEDUP_CHUNK_LIMIT", SMALL_LIMIT)
    if state == "cap":
        monkeypatch.setattr(tcount, "MOLECULE_STATE_CAP", SMALL_CAP)
        monkeypatch.setattr(tcount, "MOLECULE_BUFFER_ROWS", SMALL_BUFFER)
    t_out = str(tmp_path / "torch")
    t_sum = tcount.run_count(tcount.CountConfig(**_cfg(small["fx"])), t_out,
                             device="cpu")
    j_out, j_sum = small["j_out"], small["j_sum"]
    assert not cc.check_metrics(t_sum, j_sum)
    assert t_sum["total_molecules"] == j_sum["total_molecules"] > 0
    assert t_sum["conf_mapped_frac"] == 1.0
    # "cap": a flush in pass 2 and one at the end; "limit_only": the
    # state never reaches its cap, and bound_dedup flushes it at the end
    assert recorded["flushes"] and recorded["flushes"][0] > 0
    assert sum(recorded["flushes"]) > SMALL_LIMIT
    assert len(recorded["calls"]) > 1
    assert max(recorded["calls"]) <= _pow2(SMALL_LIMIT)
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            d = cc.check_mtx(os.path.join(t_out, sub, f),
                             os.path.join(j_out, sub, f))
            assert not d, (sub, f, d)
        d = h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                            os.path.join(j_out, sub + ".h5"))
        assert not d, (sub, d)
    d = h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                        os.path.join(j_out, "molecule_info.h5"),
                        molecule_info=True)
    assert not d, d


@pytest.mark.parametrize("mode", ["bam", "mesh"])
def test_spill_partitions_sub_split(mode, tmp_path, monkeypatch):
    """Runs through the spill and the partition dedup with the limit under
    a spill partition's rows: "bam" on one device (BAM bytes and index
    equal too), "mesh" count-only on a mesh of 4 cpu entries
    (`make_sharded_part_dedup`, one piece a device).  Partitions sub-split,
    every dedup call within _pow2(limit), and metrics, MEX and h5 equal to
    the JAX package's one-device run with its own limit."""
    limit = 64
    monkeypatch.setattr(tcount, "DEDUP_CHUNK_LIMIT", limit)
    pieces, padded = [], []
    split = tcount.split_partition
    dedup_one = molecule_state.dedup_molecules
    dedup_mesh = mesh.dedup_molecules

    def counted_split(part, lim):
        out = split(part, lim)
        pieces.append(len(out))
        return out

    def counted(dedup):
        def f(bc, *a, **kw):
            padded.append(int(bc.shape[0]))
            return dedup(bc, *a, **kw)
        return f

    monkeypatch.setattr(tcount, "split_partition", counted_split)
    monkeypatch.setattr(molecule_state, "dedup_molecules", counted(dedup_one))
    monkeypatch.setattr(mesh, "dedup_molecules", counted(dedup_mesh))
    fx = build_synthetic_run(str(tmp_path / "fx"))
    kw = _cfg(fx, batch_size=256, write_bam=mode == "bam")
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_sum = tcount.run_count(
        tcount.CountConfig(**kw), t_out, device="cpu",
        mesh=mesh.make_mesh(devices=["cpu"] * 4) if mode == "mesh" else None)
    j_sum = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    assert max(pieces) > 1 and len(padded) > 1
    assert max(padded) <= _pow2(limit)
    assert not cc.check_metrics(t_sum, j_sum)
    assert t_sum["total_molecules"] == int(fx["truth"].sum())
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert not cc.check_mtx(os.path.join(t_out, sub, f),
                                    os.path.join(j_out, sub, f)), (sub, f)
        assert not h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                                   os.path.join(j_out, sub + ".h5")), sub
    assert not h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                               os.path.join(j_out, "molecule_info.h5"),
                               molecule_info=True)
    if mode == "bam":
        for f in ("possorted_genome_bam.bam", "possorted_genome_bam.bam.bai"):
            with open(os.path.join(t_out, f), "rb") as a, \
                    open(os.path.join(j_out, f), "rb") as b:
                assert a.read() == b.read(), f


def test_deep_phase_on_cpu(small, tmp_path, monkeypatch):
    """chip_smoke's deep at SMALL_READS on the cpu, the cap lowered: the
    JAX run's reads, molecules and MEX digests; a flush at the cap; every
    dedup call within the limit; the fixture's directory removed."""
    monkeypatch.setattr(tcount, "DEDUP_CHUNK_LIMIT", SMALL_LIMIT)
    monkeypatch.setattr(tcount, "MOLECULE_BUFFER_ROWS", SMALL_BUFFER)
    j = small["j_sum"]
    expected = dict(total_reads=j["total_reads"],
                    total_molecules=j["total_molecules"],
                    conf_mapped_frac=j["conf_mapped_frac"],
                    mex_sha256=chip_smoke.mex_sha256(small["j_out"]))
    r = chip_smoke.deep(str(tmp_path), n_reads=SMALL_READS, expected=expected,
                        device="cpu", batch_size=SMALL_BATCH, cap=SMALL_CAP)
    assert r["reads"] == SMALL_READS and r["sw_launches"] == 0
    assert [f["at"] for f in r["flushes"]][0] == "cap"
    assert r["flushes"][0]["rows"] > 0
    assert len(r["dedup_calls"]) > 1
    assert max(r["dedup_calls"]) <= _pow2(SMALL_LIMIT)
    assert sorted(r["h5"]) == sorted(tcount.H5_OUTPUTS)
    assert tcount.MOLECULE_STATE_CAP == 1 << 23      # restored
    assert not os.path.exists(tmp_path / "deep")


def test_dedup_memory_phase_on_cpu(monkeypatch):
    """chip_smoke's dedup_memory on the cpu at small sizes: one call at
    each size and at the limit's padded rows, every seeded row a molecule
    or merged into one; no device memory is claimed off the card."""
    monkeypatch.setattr(tcount, "DEDUP_CHUNK_LIMIT", 1500)
    r = chip_smoke.dedup_memory("cpu", sizes=(1024,))
    assert r["limit_rows"] == 2048
    assert [c["padded_rows"] for c in r["calls"]] == [1024, 2048]
    for c in r["calls"]:
        assert c["rows"] == int(0.6 * c["padded_rows"])
        assert 0 < c["molecules"] <= c["rows"]
        assert c["peak_bytes"] is None and c["bytes_per_row"] is None
    assert "reckoned_2_24_bytes" not in r
