"""Port parity for the mesh: cellranger_tpu_torch.parallel.{mesh,executor}
against the JAX package's sharded execution, at tolerance 0.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port on a mesh of ["cpu"] * 8 (one process driving eight mesh entries, as
shard_map drives eight devices):

  * the sharded stream step == the one-device step == the JAX sharded
    step, every plane and the metrics (tests/test_multichip.py);
  * the sharded pass-1 histogram and the sharded partition dedup;
  * Executor.dedup_partitions on a mesh, a short last group included, and
    round_batch;
  * run_count of the tiny mesh run: the port's mesh run == its one-device
    run == the JAX package's mesh run (summary, MEX, h5, molecule_info);
  * a batch whose multimappers fill the per-slice promotion capacity of
    some slices only: the sharded step differs from the one-device step
    there, and equals the JAX sharded step;
  * testing.multichip.dryrun_multichip over ["cpu"] * 8.
"""

import gzip
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnotationIndex
from cellranger_tpu.align.index import GenomeIndex as JaxGenomeIndex
from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.io.gtf import Gene, Transcript, Transcriptome
from cellranger_tpu.ops import barcode as jax_bcops
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.parallel import executor as jax_executor
from cellranger_tpu.parallel import mesh as jax_mesh
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.align.aligner import DeviceIndex
from cellranger_tpu_torch.align.annotate import AnnotationIndex
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.ops import barcode as bcops
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.parallel import mesh as tmesh
from cellranger_tpu_torch.parallel.executor import Executor
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing.fixtures import build_tiny_mesh_run
from cellranger_tpu_torch.testing.multichip import dryrun_multichip

N_DEV = 8
UMI_LEN = 12


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_mesh():
    return tmesh.make_mesh(devices=["cpu"] * N_DEV)


def _jax_sharded(mesh, a):
    return jax.device_put(np.asarray(a), NamedSharding(mesh, P("data")))


def _port_stream_step(jstep, dev):
    """The port's stream step on the JAX step's own index tables."""
    didx, ann = jstep.bound_args
    return tcount.make_stream_step(DeviceIndex.from_jax(didx, dev),
                                   AnnotationIndex.from_jax(ann, dev),
                                   get_chemistry("SC3Pv3"), 91)


def _assert_same_planes(ho_a, m_a, ho_b, m_b, what):
    assert m_a == m_b, (what, m_a, m_b)
    assert set(ho_a) == set(ho_b), what
    for k in sorted(ho_a):
        np.testing.assert_array_equal(np.asarray(ho_a[k]),
                                      np.asarray(ho_b[k]),
                                      err_msg=f"{what}: {k}")


def _three_ways(jstep, buf):
    """(JAX sharded, port one-device, port sharded) step outputs of one
    packed batch, each as unpack_step_out's (host arrays, metrics)."""
    jm = jax_mesh.make_mesh(N_DEV)
    j = jax_count.unpack_step_out(jax_mesh.make_sharded_step(jstep, jm)(
        _jax_sharded(jm, buf)))
    plane = np.asarray(buf)
    one = tcount.unpack_step_out(tcount.fetch_step_out(
        _port_stream_step(jstep, "cpu")(tcount.upload_plane(plane, "cpu"))))
    mesh = _cpu_mesh()
    sharded = tmesh.make_sharded_step(
        lambda d: _port_stream_step(jstep, d).planes, mesh)
    sh = tcount.unpack_step_out(sharded(tmesh.split(mesh, plane)))
    return j, one, sh


def test_sharded_step_matches_single_and_jax():
    jstep, wl, genome, rng = graft._synthetic_setup()
    buf, _host = graft._synthetic_batch(wl, genome, rng, 64 * N_DEV)
    (jho, jm), (oho, om), (sho, sm) = _three_ways(jstep, buf)
    assert sm["n_mapped"] > 0
    _assert_same_planes(sho, sm, oho, om, "port sharded vs one device")
    _assert_same_planes(sho, sm, jho, jm, "port sharded vs JAX sharded")


def test_sharded_histogram_matches_jax():
    _step, wl, genome, rng = graft._synthetic_setup()
    B = 64 * N_DEV
    _buf, host = graft._synthetic_batch(wl, genome, rng, B)
    slot = np.ones(B, bool)
    slot[::7] = False
    jt = JaxBucketTable.build_exact(
        wl.sorted_seqs, np.arange(wl.size, dtype=np.uint32), entries=8,
        fields=3)
    _hit, jidx = jax_bcops.whitelist_lookup(jnp.asarray(host["bc_packed"]),
                                            jt)
    jm = jax_mesh.make_mesh(N_DEV)
    jhist = np.asarray(jax_mesh.make_sharded_bc_histogram(jm, wl.size)(
        _jax_sharded(jm, jidx), _jax_sharded(jm, slot)))

    tt = BucketTable.build_exact(
        wl.sorted_seqs, np.arange(wl.size, dtype=np.uint32), "cpu",
        entries=8, fields=3)
    _hit, tidx = bcops.whitelist_lookup(
        torch.from_numpy(host["bc_packed"].astype(np.int64)), tt)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    mesh = _cpu_mesh()
    sb = tmesh.shard_batch_arrays(mesh, {"idx": tidx.numpy(), "valid": slot})
    thist = tmesh.make_sharded_bc_histogram(mesh, wl.size)(sb["idx"],
                                                           sb["valid"])
    assert thist.dtype == torch.int32
    np.testing.assert_array_equal(thist.numpy(), jhist)
    assert int(thist.sum()) == int(slot.sum())


def _molecule_rows(rng, n, n_bc=40, n_gene=5):
    bc = rng.integers(0, n_bc, n).astype(np.uint32)
    gene = rng.integers(0, n_gene, n).astype(np.uint32)
    # few distinct UMIs with many one-mismatch neighbours
    umi = (rng.integers(0, 1 << (2 * UMI_LEN), n).astype(np.uint32)
           & np.uint32(0xCCCCCC))
    return bc, gene, umi


def test_sharded_part_dedup_matches_jax():
    rng = np.random.default_rng(3)
    N = 256
    bc, gene, umi = _molecule_rows(rng, N_DEV * N)
    valid = rng.random(N_DEV * N) < 0.8
    valid[:N] = False                     # one partition holds no row
    jm = jax_mesh.make_mesh(N_DEV)
    jplane = np.asarray(jax_mesh.make_sharded_part_dedup(jm, UMI_LEN)(
        *(_jax_sharded(jm, a) for a in (bc, gene, umi, valid))))
    mesh = _cpu_mesh()
    tplane = tmesh.make_sharded_part_dedup(mesh, UMI_LEN)(
        *(tmesh.split(mesh, a.astype(np.int64)) for a in (bc, gene, umi)),
        tmesh.split(mesh, valid))
    assert tplane.dtype == torch.int32 and tplane.shape == jplane.shape
    np.testing.assert_array_equal(tplane.numpy(), jplane)


def _partitions(rng, n_parts):
    """Barcode-disjoint partitions (bc % n_parts == p), one of them empty
    and one ten times the others."""
    parts = []
    for p in range(n_parts):
        n = 0 if p == 2 else (600 if p == 5 else int(rng.integers(1, 80)))
        bc, gene, umi = _molecule_rows(rng, n, n_bc=60)
        bc = bc - bc % np.uint32(n_parts) + np.uint32(p)
        parts.append((bc, gene, umi))
    return parts


@pytest.mark.parametrize("n_parts", [11, 16])
def test_executor_dedup_partitions_mesh_matches_jax(n_parts):
    """11 partitions: a group of 8 and a short group of 3 padded with
    empty partitions; 16: two full groups."""
    parts = _partitions(np.random.default_rng(n_parts), n_parts)
    jex = jax_executor.Executor(jax_mesh.make_mesh(N_DEV))
    tex = Executor(_cpu_mesh(), "cpu")
    got = list(tex.dedup_partitions(parts, UMI_LEN, keep_raw=False))
    want = list(jex.dedup_partitions(parts, UMI_LEN, keep_raw=False))
    assert len(got) == len(want) == n_parts
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("batch", [1, 100, 128, 32768])
def test_round_batch_matches_jax(batch):
    jex = jax_executor.Executor(jax_mesh.make_mesh(N_DEV))
    tex = Executor(_cpu_mesh(), "cpu")
    assert tex.round_batch(batch) == jex.round_batch(batch)
    assert tex.round_batch(batch) % N_DEV == 0
    one = Executor(tmesh.make_mesh(devices=["cpu"]), "cpu")
    assert one.mesh is None and one.round_batch(batch) == batch


def _gz_text(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_run_count_mesh_matches_single_and_jax(tmp_path):
    fx = build_tiny_mesh_run(str(tmp_path / "fx"))
    # the port's fixture is the JAX package's, draw for draw
    (tmp_path / "jfx").mkdir()
    jfx = graft._tiny_run_fixture(str(tmp_path / "jfx"))
    for a, b in ((fx["fq1"], jfx["r1"]), (fx["fq2"], jfx["r2"])):
        assert _gz_text(a) == _gz_text(b)
    kw = dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
              reference_path=fx["ref"], whitelist_path=fx["wl"],
              chemistry="SC3Pv3", read_len=91, batch_size=128,
              secondary_analysis=False, checkpoint=False)
    outs = {k: str(tmp_path / k) for k in ("jax", "one", "mesh")}
    j = jax_count.run_count(jax_count.CountConfig(**kw), outs["jax"],
                            mesh=jax_mesh.make_mesh(N_DEV))
    one = tcount.run_count(tcount.CountConfig(**kw), outs["one"],
                           device="cpu")
    sh = tcount.run_count(tcount.CountConfig(**kw), outs["mesh"],
                          device="cpu", mesh=_cpu_mesh())
    assert sh["total_reads"] == fx["n_reads"] and sh["total_molecules"] > 0
    for ref, ref_sum in (("one", one), ("jax", j)):
        assert not cc.check_metrics(sh, ref_sum), ref
        for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
            for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
                assert not cc.check_mtx(os.path.join(outs["mesh"], sub, f),
                                        os.path.join(outs[ref], sub, f))
            assert not cc.check_h5(os.path.join(outs["mesh"], sub + ".h5"),
                                   os.path.join(outs[ref], sub + ".h5"))
        assert not cc.check_molecule_info(
            os.path.join(outs["mesh"], "molecule_info.h5"),
            os.path.join(outs[ref], "molecule_info.h5"))


def _repeat_batch(n_multi, B, seed=5, read_len=91):
    """A one-gene reference whose two exons hold the same 600 bp segment
    (reads from it map equally well to both copies, both in the gene, so
    they are promoted to confident when the promotion capacity has room),
    and a batch of B reads whose first n_multi come from that segment.
    Returns (JAX stream step, packed uint32 plane)."""
    from cellranger_tpu.ops import encode
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = bytearray(bases[rng.integers(0, 4, 30_000)].tobytes())
    g[20_000:20_600] = g[2000:2600]
    genome = bytes(g)
    txome = Transcriptome(
        genes=[Gene("G1", "G1", "chr1", "+", 0)],
        transcripts=[Transcript("T1", 0, "chr1", "+",
                                [(1500, 3100), (19_500, 21_100)])])
    gi = JaxGenomeIndex.build({"chr1": genome}, txome)
    jstep = jax_count._make_step(JaxDeviceIndex.from_host(gi),
                                 JaxAnnotationIndex.build(txome, gi),
                                 jax_get_chemistry("SC3Pv3"), read_len)
    pos = np.concatenate([
        2000 + rng.integers(0, 600 - read_len, n_multi),
        5000 + rng.integers(0, 10_000, B - n_multi)])
    rna = np.stack([encode.encode_str(genome[p:p + read_len])[0]
                    for p in pos])
    shim = SimpleNamespace(
        batch_size=B, umi_packed=rng.integers(0, 1 << 24, B).astype(
            np.uint32),
        slot_valid=np.ones(B, bool), umi_valid=np.ones(B, bool), rna=rna,
        rna_nmask=np.ones((B, read_len), bool), rna2=None, rna2_nmask=None)
    plane = tcount.pack_step_input(get_chemistry("SC3Pv3"), read_len, shim,
                                   np.arange(B, dtype=np.int32) % 50)
    return jstep, plane


def test_promote_overflow_batch_matches_jax_mesh():
    """Half the batch multimapped: the first four slices overflow their
    own promotion capacity (B / 8 / 4 pairs each) and the one-device step
    does not overflow in the same way; the port's sharded step is the JAX
    sharded step, exactly."""
    B = 64 * N_DEV
    jstep, plane = _repeat_batch(B // 2, B)
    (jho, jm), (oho, om), (sho, sm) = _three_ways(jstep, plane)
    _assert_same_planes(sho, sm, jho, jm, "port sharded vs JAX sharded")
    assert sm["n_promote_overflow"] > om["n_promote_overflow"] > 0
    assert sm["n_promote_overflow"] == 4 * (B // N_DEV - B // N_DEV // 4)
    jone = jax_count.unpack_step_out(jstep(jnp.asarray(plane)))
    _assert_same_planes(oho, om, *jone, "port one device vs JAX")
    assert (sho["mm"] != oho["mm"]).any()


def test_dryrun_multichip_cpu_mesh():
    r = dryrun_multichip(N_DEV, ["cpu"] * N_DEV)
    assert r["devices"] == ["cpu"] * N_DEV
    assert r["molecules"] > 0 and r["shuffle_molecules"] > 0
