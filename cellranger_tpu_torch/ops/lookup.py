"""Bucketed sorted-array lookup: a sorted u32 key array plus a prefix table
over the top `bits` bits of a key, so a query costs one bucket range and a
short binary search inside the bucket.

Port of cellranger_tpu/ops/lookup.py.  The host build is the JAX package's
numpy code; the query is torch over u32 values held in int64 tensors
(ops/tensor_ops.py), its `n_iters` search rounds a Python loop (the
original's `fori_loop`), the round count derived at build time from the
largest bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _ceil_log2(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


@dataclass(frozen=True)
class SortedTable:
    """Device tensors for bucketed lookup over sorted u32 keys."""

    keys: torch.Tensor           # u32 values (int64) [P], ascending
    bucket_starts: torch.Tensor  # int64 [2^bits + 1]
    bits: int = 22
    n_iters: int = 13

    @staticmethod
    def build(sorted_keys: np.ndarray, device, bits: int = 22,
              max_search: int = 4096) -> "SortedTable":
        sorted_keys = np.asarray(sorted_keys, np.uint32)
        nb = 1 << bits
        buckets = sorted_keys >> np.uint32(32 - bits)
        starts = np.searchsorted(buckets, np.arange(nb + 1, dtype=np.uint64)
                                 ).astype(np.uint32)
        occupancy = np.diff(starts)
        max_occ = int(occupancy.max()) if len(sorted_keys) else 1
        n_iters = _ceil_log2(min(max(max_occ, 1), max_search)) + 1
        return SortedTable(
            keys=torch.from_numpy(sorted_keys.astype(np.int64)).to(device),
            bucket_starts=torch.from_numpy(starts.astype(np.int64)).to(device),
            bits=bits, n_iters=n_iters)

    def lower_bound(self, q: torch.Tensor) -> torch.Tensor:
        """Leftmost index i with keys[i] >= q; int32, same shape as q
        (u32 values in int64)."""
        P = self.keys.shape[0]
        if P == 0:
            return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        b = q >> (32 - self.bits)
        lo, hi = self.bucket_starts[b], self.bucket_starts[b + 1]
        for _ in range(self.n_iters):
            mid = (lo + hi) >> 1
            v = self.keys[mid.clamp(0, P - 1)]
            go = (v < q) & (mid < hi)
            lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
        return lo.to(torch.int32)

    def membership(self, q: torch.Tensor):
        """(is_member bool, index int32 (-1 on miss)) for each query."""
        P = self.keys.shape[0]
        if P == 0:
            return (torch.zeros(q.shape, dtype=torch.bool, device=q.device),
                    torch.full(q.shape, -1, dtype=torch.int32,
                               device=q.device))
        loc = self.lower_bound(q).to(torch.int64).clamp(0, P - 1)
        hit = self.keys[loc] == q
        return hit, torch.where(hit, loc, -1).to(torch.int32)
