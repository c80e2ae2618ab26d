"""Molecule dedup on one device: the device-resident molecule state of
count-only runs and the partition dedup of host rows.

Port of cellranger_tpu/parallel/executor.py `_absorb_append`,
`_dedup_state`, `MoleculeState` and the single-device branch of
`Executor.dedup_partitions`.  The accumulate-mode step keeps its
confidently mapped (bc, gene, umi) rows on the device; `MoleculeState`
keeps them there through dedup: each drained append buffer is appended
(not merged) to a persistent [C, 4] state of u32 values (bc, gene, umi,
reads), `exact_merge` reclaims the space that duplicate triples waste
only under capacity pressure and once at finalize, and the final dedup
runs on the state.  A run whose distinct triples exceed the capacity
flushes the merged state to the host; its rows, like the spilled rows of
BAM and Feature Barcode runs, are deduplicated by `dedup_partitions` over
barcode-disjoint partitions, which also returns the raw-triple views the
BAM writer joins against.  `split_partition` cuts a partition into
barcode-complete pieces so that no device call of the dedup pads past the
caller's limit (count.py DEDUP_CHUNK_LIMIT), and `MoleculeState.
bound_dedup` sends a state larger than that limit the same way.

The state is updated in place (index_copy_ into a preallocated buffer),
which takes the place of the JAX package's buffer donation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dedup import dedup_molecules, exact_merge
from ..ops.tensor_ops import U32_MAX, lexsort


def _pow2(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _absorb_append(state_rows, state_n, mol, mol_n):
    """Write a drained [P, 3] buffer (live rows [0, mol_n)) into the
    [C, 4] state at row state_n as weight-1 rows, without merging;
    dead rows are written as sentinels.  Returns the new device count.
    The caller guarantees state_n + P <= C."""
    P = mol.shape[0]
    dev = mol.device
    live = torch.arange(P, device=dev) < mol_n
    new_rows = torch.cat(
        [torch.where(live[:, None], mol, U32_MAX), live[:, None].to(
            torch.int64)], 1)
    state_rows.index_copy_(0, state_n + torch.arange(P, device=dev),
                           new_rows)
    return state_n + mol_n


def _dedup_state(rows, n, umi_len: int):
    """Final dedup of the merged state: valid molecules first.  Returns
    ([C, 4] (bc, gene, umi, reads) u32 values, n_valid)."""
    C = rows.shape[0]
    live = torch.arange(C, device=rows.device) < n
    dd = dedup_molecules(rows[:, 0], rows[:, 1], rows[:, 2], live,
                         umi_len, reads=rows[:, 3])
    inval = (~dd["mol_valid"]).to(torch.int64)
    o = lexsort(inval)
    plane = torch.stack([dd["mol_bc"][o], dd["mol_gene"][o],
                         dd["mol_umi"][o], dd["mol_reads"][o]], 1)
    return plane, dd["mol_valid"].sum()


class MoleculeState:
    """Host handle on the device-resident merged molecule table.

    Capacity grows geometrically (pow2 up to max_capacity, then host
    flush), so tiny runs sort tiny buffers."""

    def __init__(self, max_capacity: int, umi_len: int, device,
                 min_capacity: int = 1024):
        self.max_cap = max_capacity
        self.umi_len = umi_len
        self.device = torch.device(device)
        self.cap = min_capacity
        self.rows = torch.full((self.cap, 4), U32_MAX, dtype=torch.int64,
                               device=self.device)
        self._n_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n = 0          # host UPPER BOUND on live rows (see absorb)
        self.flushed: list = []  # host [k, 4] uint32 overflow arrays

    def _grow(self, need: int) -> None:
        cap = _pow2(need, minimum=self.cap)
        if cap == self.cap:
            return
        self.rows = torch.cat(
            [self.rows, torch.full((cap - self.cap, 4), U32_MAX,
                                   dtype=torch.int64, device=self.device)])
        self.cap = cap

    def absorb(self, mol: torch.Tensor, mol_n: torch.Tensor,
               upper: int) -> None:
        """Append a drained device [B, 3] buffer; `upper` is the
        host-known bound on mol_n.  Non-blocking: the host tracks only the
        additive upper bound, so no device count is fetched unless the
        bound says capacity is short."""
        P = _pow2(max(min(upper, int(mol.shape[0])), 1), minimum=1024)
        if self.n + P > self.max_cap:
            self.merge_now()             # compact + tighten the bound
            if self.n + P > self.max_cap:
                self.flush_to_host()
        self._grow(self.n + P)
        if self.n + P > self.cap:
            raise RuntimeError("molecule state append window out of bounds")
        self._n_dev = _absorb_append(self.rows, self._n_dev, mol[:P], mol_n)
        self.n = min(self.n + int(upper), self.cap)

    def merge_now(self) -> None:
        """Exact-merge duplicate triples in place and tighten the host
        bound to the exact merged count (one scalar fetch)."""
        self.rows, self._n_dev = exact_merge(self.rows, self._n_dev)
        self.n = int(self._n_dev)

    def flush_to_host(self) -> None:
        """Overflow path (runs whose distinct triples exceed capacity):
        merge, fetch the rows, and reset.  The final dedup then runs over
        host partitions (reads-weighted)."""
        self.rows, self._n_dev = exact_merge(self.rows, self._n_dev)
        self.n = int(self._n_dev)   # exact count before the host slice
        self.flushed.append(
            self.rows[:self.n].cpu().numpy().astype(np.uint32))
        self.rows = torch.full((self.cap, 4), U32_MAX, dtype=torch.int64,
                               device=self.device)
        self._n_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n = 0

    def bound_dedup(self, limit: int) -> None:
        """Before `finalize`: a state whose merged rows would pad past
        _pow2(limit) flushes to the host, so that its final dedup, too,
        runs over host partitions of at most `limit` rows."""
        if self.flushed or self.n <= _pow2(limit):
            return
        self.merge_now()
        if self.n > _pow2(limit):
            self.flush_to_host()

    def finalize(self):
        """-> (bc, gene, umi, reads) uint32 host arrays.  Without a flush:
        the valid molecules, deduplicated on the device (shrink to the
        tightest pow2 over the live rows, exact-merge once, shrink again,
        dedup).  After a flush: every merged (bc, gene, umi, reads) row,
        for `dedup_partitions`."""
        if self.flushed:
            self.flush_to_host()
            self.rows = None        # free the card for the partition dedup
            allr = np.concatenate(self.flushed, axis=0)
            self.flushed = []
            return allr[:, 0], allr[:, 1], allr[:, 2], allr[:, 3]
        self.n = int(self._n_dev)
        C2 = _pow2(max(self.n, 1), minimum=1024)
        rows = self.rows[:C2] if C2 < self.cap else self.rows
        rows, n_dev = exact_merge(rows, self._n_dev)
        self.n = int(n_dev)
        C3 = _pow2(max(self.n, 1), minimum=1024)
        if C3 < C2:
            rows = rows[:C3]
        plane, n_valid = _dedup_state(rows, n_dev, self.umi_len)
        self.rows = None
        nv = int(n_valid)
        out = plane[:nv].cpu().numpy().astype(np.uint32)
        return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


# dedup output columns: u32 values come back as uint32, the rest as int32
# (the dtypes of the JAX package's unpacked dedup plane)
DD_U32 = frozenset(("mol_bc", "mol_gene", "mol_umi", "raw_bc", "raw_gene",
                    "raw_umi", "raw_corr_umi"))


def _mix32(x: np.ndarray, salt: int) -> np.ndarray:
    """murmur3's 32-bit finalizer of x ^ salt: every output bit depends on
    every input bit, so a partition whose barcodes share their low bits
    (bc % n_parts is fixed in a spill partition) still spreads."""
    h = np.asarray(x, np.uint32) ^ np.uint32(salt)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def split_partition(part: tuple, limit: int, salt: int = 0) -> list:
    """One barcode-complete partition (equal-length column arrays, bc
    first) -> barcode-complete pieces of at most `limit` rows each.  Rows
    go to ceil(n / limit) buckets by a hash of the barcode; a bucket still
    over the limit (hash variance) splits again under another salt.  The
    rows of one barcode are never split, so a piece that holds a single
    barcode may exceed the limit."""
    bc = part[0]
    n = len(bc)
    if n <= limit or bc.min() == bc.max():
        return [part]
    k = max(2, -(-n // limit))
    sub = _mix32(bc, salt) % np.uint32(k)
    pieces = []
    for j in range(k):
        msk = sub == j
        if msk.any():
            pieces += split_partition(tuple(c[msk] for c in part), limit,
                                      salt + 1)
    return pieces


def dedup_partitions(parts, umi_len: int, device, chunk_limit: int = 1 << 21,
                     keep_raw: bool = True):
    """Dedup barcode-disjoint molecule partitions on one device.

    parts: iterable of (bc, gene, umi[, reads]) numpy uint32 row arrays;
    each partition holds complete barcodes.  Partitions coalesce into
    device calls of at most chunk_limit rows, each padded to one common
    power-of-two length.  Yields one host dict per call: mol_bc/gene/umi/
    reads of the valid molecules and, with keep_raw, the raw-triple views
    raw_bc/gene/umi/corr_umi/low/reads of the distinct raw triples."""
    parts = list(parts)
    groups: list[list] = []
    cur: list = []
    cur_n = 0
    for p in parts:
        n = len(p[0])
        if cur and cur_n + n > chunk_limit:
            groups.append(cur)
            cur, cur_n = [], 0
        cur.append(p)
        cur_n += n
    if cur:
        groups.append(cur)
    N = _pow2(max((sum(len(p[0]) for p in g) for g in groups), default=1))
    for g in groups:
        cols = [np.concatenate([p[c] for p in g]) for c in range(3)]
        reads = (np.concatenate([p[3] for p in g]) if len(g[0]) >= 4
                 else None)
        yield _dedup_host(*cols, umi_len, N, device, keep_raw, reads)


def _dedup_host(bc, gene, umi, umi_len: int, N: int, device,
                keep_raw: bool, reads=None) -> dict:
    n = len(bc)

    def up(a):
        a = np.pad(np.asarray(a, np.uint32).astype(np.int64), (0, N - n))
        return torch.from_numpy(a).to(device)

    valid = torch.arange(N, device=device) < n
    dd = dedup_molecules(up(bc), up(gene), up(umi), valid, umi_len,
                         reads=None if reads is None else up(reads))
    keys = (("mol_bc", "mol_gene", "mol_umi", "mol_reads", "mol_valid")
            + (("raw_bc", "raw_gene", "raw_umi", "raw_corr_umi", "raw_low",
                "raw_is_repr", "raw_reads") if keep_raw else ()))
    host = {}
    for k in keys:
        a = dd[k].cpu().numpy()
        host[k] = a.astype(np.uint32 if k in DD_U32 else np.int32)
    return _compact(host)


def _compact(dd: dict) -> dict:
    mv = dd["mol_valid"].astype(bool)
    out = dict(mol_bc=dd["mol_bc"][mv], mol_gene=dd["mol_gene"][mv],
               mol_umi=dd["mol_umi"][mv], mol_reads=dd["mol_reads"][mv])
    if "raw_is_repr" in dd:
        rr = dd["raw_is_repr"].astype(bool)
        out.update(raw_bc=dd["raw_bc"][rr], raw_gene=dd["raw_gene"][rr],
                   raw_umi=dd["raw_umi"][rr],
                   raw_corr_umi=dd["raw_corr_umi"][rr],
                   raw_low=dd["raw_low"][rr].astype(bool),
                   raw_reads=dd["raw_reads"][rr])
    return out
