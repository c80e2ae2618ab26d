"""Port parity for the sharded kmer table:
cellranger_tpu_torch.parallel.index_shard against the JAX package's (its
all_to_all seed-query exchange under shard_map on the 8 virtual CPU
devices of tests/conftest.py), at the three levels of
tests/test_index_shard.py: the lookup ((hit, val, overflow) of every
slice equal, with a slack that fits and with one that overflows), the
aligner (every output equal to the JAX sharded aligner's and to the
port's unsharded aligner's), and run_count(shard_index=True) on the tiny
mesh run (equal to the port's one-device run and to the JAX package's
sharded-index mesh run).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.align.aligner import make_aligner as jax_make_aligner
from cellranger_tpu.align.index import GenomeIndex as JaxGenomeIndex
from cellranger_tpu.io.gtf import Gene, Transcript, Transcriptome
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.parallel import index_shard as jax_index_shard
from cellranger_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.align.aligner import DeviceIndex, make_aligner
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.parallel.index_shard import (
    shard_device_index, shard_table, sharded_kmer_lookup)
from cellranger_tpu_torch.parallel.mesh import make_mesh, split
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing.fixtures import build_tiny_mesh_run

N_DEV = 8
READ_LEN = 91


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_mesh():
    return make_mesh(devices=["cpu"] * N_DEV)


def _sharded(mesh, a):
    return jax.device_put(np.asarray(a), NamedSharding(mesh, P("data")))


@pytest.mark.parametrize("slack", [2.0, 0.5])
def test_sharded_lookup_matches_jax(slack):
    """Half the queries are table keys, half random; at slack 0.5 every
    owner's bucket overflows and the dropped queries become misses."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    jt = JaxBucketTable.build(keys, vals, entries=8, fields=2)
    B, S = 64 * N_DEV, 7
    q = np.concatenate([
        np.tile(keys, -(-B * S // (2 * len(keys))))[:B * S // 2],
        rng.integers(0, 1 << 32, B * S - B * S // 2,
                     dtype=np.uint64).astype(np.uint32)])
    rng.shuffle(q)
    q = np.ascontiguousarray(q.reshape(B, S))

    jm = jax_make_mesh(N_DEV)
    jts = jax_index_shard.strip_pad_row(jt)

    def local(rows, ql):
        tl = JaxBucketTable(rows=rows, bits=jts.bits, entries=jts.entries,
                            fields=jts.fields, probe_rows=1)
        hit, val, ov = jax_index_shard.sharded_kmer_lookup(tl, ql, "data",
                                                           slack=slack)
        return hit, val, ov[None]

    fn = jax.jit(jax.shard_map(
        local, mesh=jm, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    jhit, jval, jov = (np.asarray(x) for x in fn(
        _sharded(jm, np.asarray(jts.rows)), _sharded(jm, q)))

    mesh = _cpu_mesh()
    table = BucketTable.from_rows(np.asarray(jt.rows), jt.bits, "cpu",
                                  entries=8, fields=2, probe_rows=1)
    shards = shard_table(table, mesh)
    outs = [sharded_kmer_lookup(shards, qs, slack=slack)
            for qs in split(mesh, q.astype(np.int64))]
    hit = torch.cat([o[0] for o in outs]).numpy()
    val = torch.cat([o[1] for o in outs]).numpy()
    ov = np.array([int(o[2]) for o in outs])
    np.testing.assert_array_equal(ov, jov)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(val, jval.astype(np.int64))
    if slack >= 2.0:
        assert ov.sum() == 0
        hit0, val0 = table.lookup(torch.from_numpy(q.astype(np.int64)))
        np.testing.assert_array_equal(hit, hit0.numpy())
        np.testing.assert_array_equal(np.where(hit, val, 0),
                                      np.where(hit, val0.numpy(), 0))
    else:
        assert ov.sum() > 0


def _small_index(seed=7, genome_len=30_000):
    """tests/test_index_shard.py's index: a 30 kb genome, one spliced
    gene."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome_codes = rng.integers(0, 4, genome_len).astype(np.uint8)
    genome = bases[genome_codes].tobytes()
    txome = Transcriptome(
        genes=[Gene("G1", "G1", "chr1", "+", 0)],
        transcripts=[Transcript("T1", 0, "chr1", "+",
                                [(1000, 1900), (2500, 3400)])])
    gi = JaxGenomeIndex.build({"chr1": genome}, txome)
    return JaxDeviceIndex.from_host(gi), genome_codes, rng


def test_sharded_aligner_matches_jax():
    jidx, genome_codes, rng = _small_index()
    B = 64 * N_DEV
    pos = rng.integers(0, len(genome_codes) - READ_LEN, B)
    rna = genome_codes[pos[:, None] + np.arange(READ_LEN)[None, :]]
    nmask = np.ones((B, READ_LEN), bool)

    jm = jax_make_mesh(N_DEV)
    didx_sh, spec = jax_index_shard.shard_device_index(jidx, jm)
    impl = jax_make_aligner(didx_sh, READ_LEN, bind=False, shard_axis="data")
    fn = jax.jit(jax.shard_map(
        impl, mesh=jm, in_specs=(spec, P("data"), P("data")),
        out_specs=P("data"), check_vma=False))
    jout = jax.tree.map(np.asarray, fn(didx_sh, _sharded(jm, rna),
                                       _sharded(jm, nmask)))

    tidx = DeviceIndex.from_jax(jidx, "cpu")
    one = make_aligner(tidx, READ_LEN)(torch.from_numpy(rna),
                                       torch.from_numpy(nmask))
    mesh = _cpu_mesh()
    sh = shard_device_index(tidx, mesh)
    align = make_aligner(sh.replicas[torch.device("cpu")], READ_LEN,
                         seed_lookup=sh.lookup)
    parts = [align(r, m) for r, m in zip(split(mesh, rna),
                                         split(mesh, nmask))]
    out = {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}
    assert set(out) == set(one)
    for k in sorted(out):
        np.testing.assert_array_equal(out[k], one[k].numpy(), err_msg=k)
        if k in jout:
            np.testing.assert_array_equal(
                out[k], np.asarray(jout[k]).astype(out[k].dtype),
                err_msg=f"jax {k}")
    assert {"pos", "mapq", "strand", "mapped", "aln_len"} <= set(jout)


def test_shard_index_run_count_matches_jax(tmp_path):
    fx = build_tiny_mesh_run(str(tmp_path / "fx"))
    kw = dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
              reference_path=fx["ref"], whitelist_path=fx["wl"],
              chemistry="SC3Pv3", read_len=91, batch_size=128,
              secondary_analysis=False, checkpoint=False, shard_index=True)
    outs = {k: str(tmp_path / k) for k in ("jax", "one", "shard")}
    j = jax_count.run_count(jax_count.CountConfig(**kw), outs["jax"],
                            mesh=jax_make_mesh(N_DEV))
    one = tcount.run_count(tcount.CountConfig(**kw), outs["one"],
                           device="cpu")
    sh = tcount.run_count(tcount.CountConfig(**kw), outs["shard"],
                          device="cpu", mesh=_cpu_mesh())
    assert sh["total_reads"] == fx["n_reads"] and sh["total_molecules"] > 0
    for ref, ref_sum in (("one", one), ("jax", j)):
        assert not cc.check_metrics(sh, ref_sum), ref
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            f = os.path.join("raw_feature_bc_matrix", f)
            assert not cc.check_mtx(os.path.join(outs["shard"], f),
                                    os.path.join(outs[ref], f))
        assert not cc.check_h5(
            os.path.join(outs["shard"], "raw_feature_bc_matrix.h5"),
            os.path.join(outs[ref], "raw_feature_bc_matrix.h5"))
        assert not cc.check_molecule_info(
            os.path.join(outs["shard"], "molecule_info.h5"),
            os.path.join(outs[ref], "molecule_info.h5"))
