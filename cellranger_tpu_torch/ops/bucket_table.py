"""Bucket-row hash table: ONE aligned row gather per query.

Port of cellranger_tpu/ops/bucket_table.py.  Layout: R = 2^bits rows,
each row = E entries stored columnar [key*E | val*E | (cnt*E) | pad],
padded to a power-of-two u32 width.  bucket(key) = (key * 0x9E3779B9) >>
(32-bits), with the product wrapping mod 2^32.  Entries land in their
bucket row in input order; an overflowing bucket spills to the NEXT row
when `probe_rows`=2, or is dropped (counted).  The all-ones key is
reserved as EMPTY.

The host build (`_place`, `build_rows`, `build_exact`, `with_counts`) is
the numpy code of the JAX package, copied; `_place_torch` and
`build_rows_torch` are its torch counterparts for the kmer table's layout
(probe_rows=1), the same rows bit for bit on any device; the query half
(`_fetch`, `lookup`, `membership`, `membership3`) is torch over the rows
kept as an int32 bit-view on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tensor_ops import U32_MASK, U32_MAX, u32_table, widen

EMPTY = np.uint32(0xFFFFFFFF)
MIX = np.uint32(0x9E3779B9)


def _pad_width(e: int, f: int) -> int:
    w = 1
    while w < e * f:
        w *= 2
    return w


@dataclass(frozen=True)
class BucketTable:
    rows: torch.Tensor  # int32 bit-view of uint32 [R(+1), W]
    bits: int = 16
    entries: int = 8
    fields: int = 2
    probe_rows: int = 1

    @property
    def n_rows(self) -> int:
        return 1 << self.bits

    # ---------- build (host) ----------
    @staticmethod
    def _place(keys: np.ndarray, vals: np.ndarray, bits: int, entries: int,
               fields: int, probe_rows: int, cnts: np.ndarray | None = None):
        """Vectorized placement; returns (rows, n_dropped)."""
        R = 1 << bits
        E = entries
        W = _pad_width(E, fields)
        h = ((keys * MIX) >> np.uint32(32 - bits)).astype(np.int64)
        order = np.argsort(h, kind="stable")
        hs, ks, vs = h[order], keys[order], vals[order]
        cs = cnts[order] if cnts is not None else None
        n = len(ks)
        newb = np.concatenate([[True], hs[1:] != hs[:-1]]) if n else np.zeros(0, bool)
        start = np.maximum.accumulate(np.where(newb, np.arange(n), 0)) if n else hs
        rank = np.arange(n) - start

        row = hs.copy()
        slot = rank.copy()
        if probe_rows == 2:
            # overflow entries spill to the next row, stacked after that
            # row's native entries (single-step spill; deeper overflow drops)
            over = rank >= E
            if over.any():
                nxt = hs + 1  # no wrap: row R is the dedicated spill pad row
                native = np.bincount(hs[~over], minlength=R + 1)[: R + 1]
                native = np.minimum(native, E)
                # per-next-row running index among spilled entries
                o_idx = np.flatnonzero(over)
                o_next = nxt[o_idx]
                o_order = np.argsort(o_next, kind="stable")
                o_sorted = o_next[o_order]
                nb = np.concatenate([[True], o_sorted[1:] != o_sorted[:-1]])
                st = np.maximum.accumulate(np.where(nb, np.arange(len(o_sorted)), 0))
                spill_rank = np.arange(len(o_sorted)) - st
                row_o = o_sorted
                slot_o = native[o_sorted] + spill_rank
                row[o_idx[o_order]] = row_o
                slot[o_idx[o_order]] = slot_o
        keep = slot < E
        n_dropped = int((~keep).sum())
        rows = np.zeros((R + 1, W), np.uint32)
        rows[:, :E] = EMPTY
        r_k, s_k = row[keep], slot[keep]
        rows[r_k, s_k] = ks[keep]
        rows[r_k, E + s_k] = vs[keep]
        if fields >= 3:
            if cs is not None:
                rows[r_k, 2 * E + s_k] = cs[keep]
        return rows, n_dropped

    @staticmethod
    def _place_torch(keys: torch.Tensor, vals: torch.Tensor, bits: int,
                     entries: int, fields: int, probe_rows: int,
                     block: int = 1 << 26):
        """`_place` on the keys' device (u32 values or int32 bit-views):
        a stable sort by bucket, each entry's rank within its bucket, the
        entries past `entries` dropped, the rest scattered into their
        rows `block` entries at a time.  Returns (rows int32 bit-view
        [R + 1, W], n_dropped)."""
        if probe_rows != 1:
            raise NotImplementedError("the torch placement has no spill "
                                      "row (probe_rows=1 only)")
        R = 1 << bits
        E = entries
        W = _pad_width(E, fields)
        dev = keys.device
        h = ((widen(keys) * int(MIX)) & U32_MASK) >> (32 - bits)
        hs, order = torch.sort(h, stable=True)
        del h
        counts = torch.bincount(hs, minlength=R)
        first = torch.cumsum(counts, 0) - counts   # each bucket's first slot
        del counts
        rows = torch.zeros((R + 1, W), dtype=torch.int32, device=dev)
        rows[:, :E] = -1                           # EMPTY's bits
        flat = rows.view(-1)
        n_dropped = 0
        for i in range(0, hs.shape[0], block):
            b = hs[i:i + block]
            rank = torch.arange(i, i + b.shape[0], device=dev) - first[b]
            keep = rank < E
            n_dropped += int((~keep).sum())
            at = (b * W + rank)[keep]
            o = order[i:i + block][keep]
            flat[at] = keys[o].to(torch.int32)
            flat[at + E] = vals[o].to(torch.int32)
        return rows, n_dropped

    @staticmethod
    def build_rows_torch(keys: torch.Tensor, vals: torch.Tensor,
                         entries: int = 8, fields: int = 2,
                         load: float = 0.5, probe_rows: int = 1,
                         min_bits: int = 8):
        """`build_rows` on the keys' device: -> (rows int32 bit-view
        tensor, bits)."""
        keep = widen(keys) != U32_MAX
        if not bool(keep.all()):
            keys, vals = keys[keep], vals[keep]
        del keep
        n = max(int(keys.shape[0]), 1)
        bits = max(min_bits, int(np.ceil(np.log2(n / (entries * load)))))
        rows, _ = BucketTable._place_torch(keys, vals, bits, entries, fields,
                                           probe_rows)
        return rows, bits

    @staticmethod
    def build_rows(keys: np.ndarray, vals: np.ndarray, entries: int = 8,
                   fields: int = 2, load: float = 0.5, probe_rows: int = 1,
                   min_bits: int = 8):
        """Host placement only: -> (rows numpy uint32, bits)."""
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        keep = keys != EMPTY
        keys, vals = keys[keep], vals[keep]
        n = max(len(keys), 1)
        bits = max(min_bits, int(np.ceil(np.log2(n / (entries * load)))))
        rows, _ = BucketTable._place(keys, vals, bits, entries, fields,
                                     probe_rows)
        return rows, bits

    @staticmethod
    def from_rows(rows: np.ndarray, bits: int, device, entries: int = 8,
                  fields: int = 2, probe_rows: int = 1) -> "BucketTable":
        return BucketTable(rows=u32_table(rows, device), bits=bits,
                           entries=entries, fields=fields,
                           probe_rows=probe_rows)

    @staticmethod
    def build(keys: np.ndarray, vals: np.ndarray, device, entries: int = 8,
              fields: int = 2, load: float = 0.5, probe_rows: int = 1,
              min_bits: int = 8) -> "BucketTable":
        """Best-effort build on `device`: bucket overflow beyond capacity
        is dropped (degrades like the seed hit cap)."""
        rows, bits = BucketTable.build_rows(keys, vals, entries, fields,
                                            load, probe_rows, min_bits)
        return BucketTable.from_rows(rows, bits, device, entries, fields,
                                     probe_rows)

    @staticmethod
    def build_exact(keys: np.ndarray, vals: np.ndarray, device,
                    entries: int = 8, fields: int = 3, load: float = 0.5,
                    max_bytes: int = 2 << 30) -> "BucketTable":
        """Grow (then widen to probe_rows=2) until every key is placed —
        required for whitelist membership."""
        keys = np.asarray(keys, np.uint32)
        vals = np.asarray(vals, np.uint32)
        keep = keys != EMPTY
        keys, vals = keys[keep], vals[keep]
        n = max(len(keys), 1)
        W = _pad_width(entries, fields)
        bits = max(8, int(np.ceil(np.log2(n / (entries * load)))))
        for probe_rows in (1, 2):
            b = bits
            while ((1 << b) + 1) * W * 4 <= max_bytes:
                rows, dropped = BucketTable._place(
                    keys, vals, b, entries, fields, probe_rows)
                if dropped == 0:
                    return BucketTable.from_rows(rows, b, device, entries,
                                                 fields, probe_rows)
                b += 1
        raise ValueError("bucket table could not be made exact within "
                         f"max_bytes={max_bytes}")

    def with_counts(self, counts: np.ndarray) -> "BucketTable":
        """Fill the count column from `counts` indexed by the val column
        (the prior counts of posterior correction).  Host op, once per
        run."""
        assert self.fields >= 3
        E = self.entries
        rows = self.rows.cpu().numpy().view(np.uint32).copy()
        valid = rows[:, :E] != EMPTY
        idx = np.where(valid, rows[:, E:2 * E], 0).astype(np.int64)
        counts = np.asarray(counts)
        idx = np.minimum(idx, max(len(counts) - 1, 0))
        rows[:, 2 * E:3 * E] = np.where(valid, counts[idx], 0) \
            .astype(np.uint32)
        return BucketTable.from_rows(rows, self.bits, self.rows.device,
                                     self.entries, self.fields,
                                     self.probe_rows)

    # ---------- query (device) ----------
    def _fetch(self, q: torch.Tensor):
        """q u32 values (int64) [...] -> (keys, vals, cnts) each
        [..., P*E] as u32 values."""
        E = self.entries
        h = ((q * int(MIX)) & U32_MASK) >> (32 - self.bits)
        rows = widen(self.rows[h])                # [..., W] one gather
        keys, vals = rows[..., :E], rows[..., E:2 * E]
        cnts = rows[..., 2 * E:3 * E] if self.fields >= 3 else None
        if self.probe_rows == 2:
            rows2 = widen(self.rows[h + 1])       # second gather (spill row)
            keys = torch.cat([keys, rows2[..., :E]], -1)
            vals = torch.cat([vals, rows2[..., E:2 * E]], -1)
            if cnts is not None:
                cnts = torch.cat([cnts, rows2[..., 2 * E:3 * E]], -1)
        return keys, vals, cnts

    def lookup(self, q: torch.Tensor):
        """-> (hit bool [..., P*E], vals u32 [..., P*E])."""
        keys, vals, _ = self._fetch(q)
        hit = (keys == q[..., None]) & (q != U32_MAX)[..., None]
        return hit, vals

    def membership(self, q: torch.Tensor):
        """Unique-key tables: (is_member bool, val int32 -- -1 on miss)."""
        hit, vals = self.lookup(q)
        any_hit = hit.any(-1)
        vals_i32 = vals.to(torch.int32)           # u32 -> int32 bits
        val = torch.where(hit, vals_i32, -1).amax(-1)
        return any_hit, val

    def membership3(self, q: torch.Tensor):
        """(is_member bool, val int32 -- -1 on miss, count int32) -- the
        count column from the same row."""
        keys, vals, cnts = self._fetch(q)
        hit = (keys == q[..., None]) & (q != U32_MAX)[..., None]
        any_hit = hit.any(-1)
        val = torch.where(hit, vals.to(torch.int32), -1).amax(-1)
        cnt = torch.where(hit, cnts.to(torch.int32), 0).amax(-1)
        return any_hit, val, cnt
