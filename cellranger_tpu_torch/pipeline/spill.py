"""Disk spill for streaming, bounded-memory pipeline execution.

The reference streams every large intermediate through sorted spill files:
SpillVec keeps <=N items in RAM then spills (lib/rust/cr_types/src/
spill_vec.rs), and shardio files carry barcode-sorted records between
stages (lib/rust/cr_lib/src/stages/barcode_sort.rs:97-113).  The TPU
pipeline's equivalents live here:

  * MoleculeSpill — conf-mapped molecule rows (bc, gene, umi) are routed to
    one of P barcode-hash partition files as they stream off the device.
    Every read of a barcode lands in one partition, so partitions dedup
    independently — the ALIGN_AND_COUNT barcode-range chunking analog
    (lib/rust/cr_lib/src/stages/align_and_count.rs:518-524).  Peak RAM for
    dedup is one partition, not the run.

  * BamSpool — per-batch BAM-relevant arrays are bucketed by genome
    position band and appended to bucket files; the final position-sorted
    write loads one band at a time (the WRITE_POS_BAM per-chunk BAM +
    samtools-cat analog, write_pos_bam.rs:65-101).

Rows are raw little-endian numpy bytes; files are append-only and
self-describing via the fixed dtype.

Verbatim copy of cellranger_tpu/pipeline/spill.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np


class MoleculeSpill:
    """Partitioned on-disk spill of molecule rows (bc, gene, umi) uint32.

    Partition of a row = bc % n_parts, so dedup per partition is globally
    correct (all reads of a barcode share a partition).
    """

    def __init__(self, directory: str, n_parts: int = 32, prefix: str = "",
                 append: bool = False):
        self.dir = directory
        self.n_parts = n_parts
        self.prefix = prefix  # per-host prefix on shared filesystems
        os.makedirs(directory, exist_ok=True)
        # append mode preserves a prior run's completed spill (multihost
        # resume reopens the directory without truncating)
        mode = "ab" if append else "wb"
        self._files = [open(self.part_path(p), mode) for p in range(n_parts)]
        self.n_rows = 0

    def append(self, bc: np.ndarray, gene: np.ndarray, umi: np.ndarray):
        if len(bc) == 0:
            return
        bc = np.ascontiguousarray(bc, np.uint32)
        gene = np.ascontiguousarray(gene, np.uint32)
        umi = np.ascontiguousarray(umi, np.uint32)
        part = bc % np.uint32(self.n_parts)
        order = np.argsort(part, kind="stable")
        part_s = part[order]
        rows = np.column_stack([bc[order], gene[order], umi[order]])
        bounds = np.searchsorted(part_s, np.arange(self.n_parts + 1))
        for p in range(self.n_parts):
            lo, hi = bounds[p], bounds[p + 1]
            if hi > lo:
                self._files[p].write(rows[lo:hi].tobytes())
        self.n_rows += len(bc)

    def flush(self):
        for f in self._files:
            f.flush()

    def part_path(self, p: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}part{p}.mol")

    def load_part(self, p: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Load one partition's rows -> (bc, gene, umi)."""
        self._files[p].flush()
        rows = np.fromfile(self.part_path(p), dtype=np.uint32).reshape(-1, 3)
        return rows[:, 0].copy(), rows[:, 1].copy(), rows[:, 2].copy()

    @staticmethod
    def load_union(directory: str, n_parts: int, p: int):
        """Union of partition p across every host's spill in `directory`
        (multi-host merge: partition = bc % n_parts on every host, so the
        union still holds complete barcodes)."""
        import glob
        cols = [[], [], []]
        for path in sorted(glob.glob(
                os.path.join(directory, f"*part{p}.mol"))):
            rows = np.fromfile(path, dtype=np.uint32).reshape(-1, 3)
            for c in range(3):
                cols[c].append(rows[:, c])
        if not cols[0]:
            return (np.zeros(0, np.uint32),) * 3
        return tuple(np.concatenate(c) for c in cols)

    def part_sizes(self) -> list[int]:
        self.flush()
        return [os.path.getsize(self.part_path(p)) // 12
                for p in range(self.n_parts)]

    def close(self, remove: bool = True):
        for f in self._files:
            f.close()
        if remove:
            shutil.rmtree(self.dir, ignore_errors=True)


def lex3_join_np(tb, tg, tu, qb, qg, qu):
    """Vectorized host join of query triples against a table of distinct
    triples (any order).  Returns (idx int64 into table, found bool) per
    query.  O((n+m) log(n+m)) via one shared lexsort — replaces the former
    per-read Python dict lookup for BAM UB tags."""
    nt, nq = len(tb), len(qb)
    if nt == 0 or nq == 0:
        return np.zeros(nq, np.int64), np.zeros(nq, bool)
    b = np.concatenate([tb, qb]).astype(np.uint64)
    g = np.concatenate([tg, qg]).astype(np.uint64)
    u = np.concatenate([tu, qu]).astype(np.uint64)
    tag = np.concatenate([np.zeros(nt, np.uint8), np.ones(nq, np.uint8)])
    row = np.concatenate([np.arange(nt, dtype=np.int64),
                          np.arange(nq, dtype=np.int64)])
    order = np.lexsort((tag, u, g, b))   # table rows before queries on ties
    bs, gs, us = b[order], g[order], u[order]
    tag_s, row_s = tag[order], row[order]
    tbl_row = np.where(tag_s == 0, row_s, -1)
    last_tbl = np.maximum.accumulate(tbl_row)
    is_q = tag_s == 1
    cand = last_tbl[is_q]
    qrow = row_s[is_q]
    cc = np.maximum(cand, 0)
    found = (cand >= 0) & (tb[cc].astype(np.uint64) == bs[is_q]) & \
        (tg[cc].astype(np.uint64) == gs[is_q]) & \
        (tu[cc].astype(np.uint64) == us[is_q])
    idx = np.zeros(nq, np.int64)
    fnd = np.zeros(nq, bool)
    idx[qrow] = cc
    fnd[qrow] = found
    return idx, fnd


class BamSpool:
    """Position-banded spool of per-batch BAM record arrays.

    add(band_of_row, chunk_dict) appends each band's row subset (pickled)
    to that band's file; iter_band(b) yields the chunk sub-dicts back.
    Band 0..n_bands-1 are genome position ranges; band n_bands holds
    unmapped reads (emitted last, like pos-sorted BAMs place unmapped).
    """

    def __init__(self, directory: str, n_bands: int = 64,
                 fresh: bool = True):
        self.dir = directory
        self.n_bands = n_bands
        os.makedirs(directory, exist_ok=True)
        if fresh:
            # "wb": a retried run must not replay a prior attempt's bands
            self._files = [
                open(os.path.join(directory, f"band{b}.pkl"), "wb")
                for b in range(n_bands + 1)]
            # sidecar: lightweight per-band UMI_COUNT-candidate rows, so
            # the representative pass never re-deserializes the full bands
            self._rep_files = [
                open(os.path.join(directory, f"band{b}.rep.pkl"), "wb")
                for b in range(n_bands + 1)]
        else:
            # read-only reopen of a SEALED spool (BAM-run resume: the
            # band spool is the journal, VERDICT r3 item 7)
            self._files = []
            self._rep_files = []

    def add(self, band: np.ndarray, chunk: dict):
        """Route chunk rows (dict of per-row arrays / lists) into bands."""
        for b in np.unique(band):
            sel = band == b
            sub = {}
            for k, v in chunk.items():
                if isinstance(v, np.ndarray):
                    sub[k] = v[sel]
                elif isinstance(v, list):
                    sub[k] = [x for x, s in zip(v, sel) if s]
                else:
                    sub[k] = v
            pickle.dump(sub, self._files[int(b)],
                        protocol=pickle.HIGHEST_PROTOCOL)

    def iter_band(self, b: int):
        if self._files and not self._files[b].closed:
            self._files[b].flush()
        yield from self._iter_pkl(os.path.join(self.dir, f"band{b}.pkl"))

    def add_rep(self, band: np.ndarray, sub: dict):
        """Append UMI_COUNT-candidate sidecar rows (already filtered to
        eligible reads): dict of per-row arrays {bc, gl, umi, txo} + a
        'names' list, routed by band like add()."""
        for b in np.unique(band):
            sel = band == b
            out = {k: (v[sel] if isinstance(v, np.ndarray)
                       else [x for x, s in zip(v, sel) if s])
                   for k, v in sub.items()}
            pickle.dump(out, self._rep_files[int(b)],
                        protocol=pickle.HIGHEST_PROTOCOL)

    def iter_rep(self, b: int):
        if self._rep_files and not self._rep_files[b].closed:
            self._rep_files[b].flush()
        yield from self._iter_pkl(
            os.path.join(self.dir, f"band{b}.rep.pkl"))

    @staticmethod
    def iter_dir_rep(directory: str, b: int):
        yield from BamSpool._iter_pkl(
            os.path.join(directory, f"band{b}.rep.pkl"))

    @staticmethod
    def _iter_pkl(path: str):
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                try:
                    yield pickle.load(f)
                except EOFError:
                    return

    def seal(self):
        """Close write handles WITHOUT removing files — the multihost
        worker handoff (host 0 reads every host's bands after the
        barrier)."""
        for f in self._files + self._rep_files:
            if not f.closed:
                f.close()

    @staticmethod
    def iter_dir_band(directory: str, b: int):
        """Yield the chunks of band b spooled under another host's
        directory (absent file = empty band)."""
        path = os.path.join(directory, f"band{b}.pkl")
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                try:
                    yield pickle.load(f)
                except EOFError:
                    return

    def close(self, remove: bool = True):
        for f in self._files + self._rep_files:
            if not f.closed:
                f.close()
        if remove:
            shutil.rmtree(self.dir, ignore_errors=True)
