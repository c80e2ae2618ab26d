"""Sharded genome kmer table: each device owns a range of bucket rows.

Port of cellranger_tpu/parallel/index_shard.py.  At multi-species or
custom-reference scale the kmer table outgrows one device's memory, so
the mesh shards it by bucket row and each batch slice exchanges its seed
queries with the owning devices instead of reading a replicated table:

  * the BucketTable's rows [R, W] split evenly over the mesh (R = 2^bits;
    the owner of global row h is h >> log2(R/n));
  * a slice buckets its canonical seed hashes by owner into fixed-
    capacity slots (stable sort, rank within the owner's group), the same
    layout the JAX package sends through `all_to_all`;
  * each owner gathers its local rows for its bucket on its own device,
    and the rows are copied back to the slice's device;
  * the slice unpacks the rows into query order and compares keys
    exactly as the local lookup does.

Queries past a bucket's capacity become seed misses and are counted.
Everything else of the index (text rows, junctions) is replicated.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.bucket_table import MIX, BucketTable
from ..ops.tensor_ops import U32_MASK, U32_MAX, scatter_drop, widen
from .mesh import Mesh, to_device
from .shuffle import rank_in_group


def strip_pad_row(table: BucketTable) -> BucketTable:
    """Drop the spill pad row so the row count is the power of two R
    (shardable evenly).  Only valid for probe_rows=1 tables: the genome
    kmer table never probes row h+1."""
    assert table.probe_rows == 1, "sharding requires probe_rows=1"
    R = 1 << table.bits
    return BucketTable(rows=table.rows[:R], bits=table.bits,
                       entries=table.entries, fields=table.fields,
                       probe_rows=1)


@dataclass(frozen=True)
class ShardedIndex:
    """A DeviceIndex whose kmer-table rows are split over a mesh.

    shards[i] holds rows [i*R/n, (i+1)*R/n) on mesh.devices[i]; replicas
    maps each distinct device to the rest of the index (its kmer table
    keeps bits and widths but no rows, so only `lookup` reads kmers)."""

    shards: tuple[BucketTable, ...]
    replicas: dict

    def lookup(self, q: torch.Tensor):
        """The aligner's seed lookup: (hit, val) [B, S, E]."""
        hit, val, _overflow = sharded_kmer_lookup(self.shards, q)
        return hit, val


def shard_table(table: BucketTable, mesh: Mesh) -> tuple[BucketTable, ...]:
    """A probe_rows=1 table's rows [i*R/n, (i+1)*R/n) on mesh.devices[i],
    one BucketTable each."""
    kt = strip_pad_row(table)
    n = mesh.size
    R = 1 << kt.bits
    assert R % n == 0, "mesh size must divide 2^bits"
    Rn = R // n
    return tuple(
        dataclasses.replace(kt, rows=kt.rows[i * Rn:(i + 1) * Rn].to(dev))
        for i, dev in enumerate(mesh.devices))


def shard_device_index(didx, mesh: Mesh) -> ShardedIndex:
    """Shard didx's kmer-table rows over the mesh and replicate the rest
    of it once per distinct device."""
    kt = didx.kmer_table
    rowless = dataclasses.replace(
        didx, kmer_table=dataclasses.replace(kt, rows=kt.rows[:0]))
    return ShardedIndex(shard_table(kt, mesh),
                        {dev: to_device(rowless, dev)
                         for dev in mesh.distinct})


def sharded_kmer_lookup(shards, q: torch.Tensor, slack: float = 2.0):
    """Look up canonical kmers q [B, S] (u32 values, on the source
    slice's device) against the row-sharded table.  Returns (hit, val)
    [B, S, E] exactly like BucketTable.lookup, plus the number of queries
    dropped by bucket capacity."""
    n = len(shards)
    t = shards[0]
    E = t.entries
    Rn = int(t.rows.shape[0])             # local rows = R / n, a power of 2
    lg = Rn.bit_length() - 1
    Bq, S = q.shape
    M = Bq * S
    cap = -(-int(np.ceil(M / n * slack)) // 8) * 8
    dev = q.device

    h = (((q * int(MIX)) & U32_MASK) >> (32 - t.bits)).reshape(-1)
    owner = h >> lg
    local = h & (Rn - 1)
    # fixed-capacity bucketing by owner (stable sort + rank in group)
    order = torch.argsort(owner, stable=True)
    own_s = owner[order]
    rank = rank_in_group(own_s)
    ok = rank < cap
    overflow = (~ok).sum()
    slot_s = torch.where(ok, own_s * cap + rank, n * cap)   # n*cap: trash
    send = scatter_drop(torch.zeros(n * cap, dtype=torch.int64, device=dev),
                        slot_s, torch.where(ok, local[order], 0)
                        ).reshape(n, cap)
    # queries -> owners; each owner gathers its rows; rows come back
    back = torch.stack([sh.rows[send[d].to(sh.rows.device)].to(dev)
                        for d, sh in enumerate(shards)])     # [n, cap, W]
    # slot of the original query i: scatter through the sort order
    slot = torch.empty(M, dtype=torch.int64, device=dev)
    slot[order] = slot_s
    got = slot < n * cap
    res = widen(back.reshape(n * cap, -1)[torch.clamp_max(slot, n * cap - 1)])
    keys = res[..., :E].reshape(Bq, S, E)
    vals = res[..., E:2 * E].reshape(Bq, S, E)
    hit = ((keys == q[..., None]) & (q != U32_MAX)[..., None]
           & got.reshape(Bq, S)[..., None])
    return hit, vals, overflow
