"""Cross-device barcode shuffle + sharded dedup, the shardio analog.

Port of cellranger_tpu/parallel/shuffle.py.  Each device routes its
confidently mapped molecule rows to the device that owns the barcode
(bc % n), then runs the sorted-segment dedup on what it received;
barcode ownership makes the per-device dedup globally correct.  The JAX
package exchanges with one `all_to_all`, which needs equal splits, so
rows go into fixed-capacity (source, destination) buckets and rows past
the capacity are dropped and counted; the port keeps the buckets, and
the exchange is a copy of bucket d of source s to device d.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dedup import dedup_molecules
from ..ops.tensor_ops import scatter_drop
from .mesh import Mesh, gather


def rank_in_group(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Position of each entry of a sorted key vector within its run of
    equal keys."""
    n = keys_sorted.shape[0]
    pos = torch.arange(n, device=keys_sorted.device)
    new_g = torch.ones(n, dtype=torch.bool, device=keys_sorted.device)
    new_g[1:] = keys_sorted[1:] != keys_sorted[:-1]
    gstart = torch.cummax(torch.where(new_g, pos, 0), 0).values
    return pos - gstart


def make_sharded_dedup(mesh: Mesh, n_rows_per_chip: int, umi_len: int,
                       slack: float = 2.0):
    """Sharded dedup over the mesh.

    Inputs are the per-device slices of [n * n_rows_per_chip] (bc, gene,
    umi, valid) rows.  Capacity per (source, destination) bucket = ceil(
    n_rows_per_chip / n * slack).  Returns fn(bc, gene, umi, valid) ->
    dict of per-device outputs concatenated in device order (each device
    owns bc % n == its index): the dedup_molecules arrays of its [n * cap]
    received rows, n_molecules [n] and overflow [n] (rows device i could
    not send; > 0 means the slack was too small)."""
    n = mesh.size
    cap = int(np.ceil(n_rows_per_chip / n * slack))

    def buckets(bc, gene, umi, valid):
        """On the source device: rows -> [n, cap] buckets by destination,
        in a stable sort's order, and the overflow count."""
        dst = torch.where(valid, bc % n, n)     # invalid rows: nowhere
        order = torch.argsort(dst, stable=True)
        dst_s = dst[order]
        rank = rank_in_group(dst_s)
        real = dst_s < n
        ok = (rank < cap) & real
        overflow = ((rank >= cap) & real).sum()
        slot = torch.where(ok, dst_s * cap + rank, n * cap)   # n*cap: trash
        zero = torch.zeros(n * cap, dtype=torch.int64, device=bc.device)
        cols = [scatter_drop(zero, slot, torch.where(ok, x[order], 0))
                .reshape(n, cap) for x in (bc, gene, umi)]
        cols.append(scatter_drop(zero, slot, ok.to(torch.int64))
                    .reshape(n, cap))
        return cols, overflow

    def fn(bc, gene, umi, valid):
        sent = [buckets(*rows) for rows in zip(bc, gene, umi, valid)]
        outs = []
        for d, dev in enumerate(mesh.devices):
            # bucket d of every source, source-major
            rb, rg, ru, rv = (torch.cat([c[j][d].to(dev) for c, _ in sent])
                              for j in range(4))
            dd = dedup_molecules(rb, rg, ru, rv > 0, umi_len)
            dd["n_molecules"] = dd["n_molecules"][None]
            dd["overflow"] = sent[d][1][None].to(dev)
            outs.append(dd)
        return {k: gather([o[k] for o in outs]) for k in outs[0]}

    return fn
