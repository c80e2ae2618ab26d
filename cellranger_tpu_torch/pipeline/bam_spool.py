"""The BAM writer's record spool: per-batch record columns appended to
band files on disk as they stream off the device, each band a range of
sort keys, read back a band (or a part of one) at a time by
pipeline/bam_out.py `BamCollector.write`.

A chunk is a dict of per-record columns (numpy arrays, `Strings`, or
scalars).  A batch's rows are put in file order once and held in
memory, a file at a time, until FLUSH_ROWS have gathered; then they
are joined, pickled and compressed (zlib level 1) on a small thread
pool and appended to the file behind a length prefix.  So a batch that
spreads over a hundred bands costs one gather a column, not one a band,
and the run's consumer thread does neither the pickling nor the
compression.
Files are append-only; `seal` drains the pool, closes every file and
writes `spool.json` (the band count and rows), which a resumed run or
another host reads.  Rows keep their spool order within a file, so a
band's records with equal sort keys come back in the order they came.

The port's own module: the JAX package spools through pipeline/spill.py
`BamSpool` (its bands are one a genomic span, its chunks hold read names
as Python lists); the copy of that module stays verbatim.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import pickle
import shutil
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..native.strings import Strings

META = "spool.json"
FLUSH_ROWS = 1 << 16        # rows a file gathers before they are packed
THREADS = 4                 # threads that pack, and that unpack a file
_LEN = struct.Struct("<Q")


def take_rows(chunk: dict, idx: np.ndarray) -> dict:
    """The rows idx (in that order) of every per-row column of a chunk;
    other values pass through."""
    out = {}
    for k, v in chunk.items():
        if isinstance(v, np.ndarray):
            out[k] = v[idx]
        elif isinstance(v, Strings):
            out[k] = v.take(idx)
        elif isinstance(v, list):
            out[k] = [v[i] for i in idx]
        else:
            out[k] = v
    return out


def slice_rows(chunk: dict, a: int, b: int) -> dict:
    """Rows a..b of every per-row column of a chunk (views)."""
    out = {}
    for k, v in chunk.items():
        if isinstance(v, np.ndarray):
            out[k] = v[a:b]
        elif isinstance(v, Strings):
            out[k] = v.slice(a, b)
        elif isinstance(v, list):
            out[k] = v[a:b]
        else:
            out[k] = v
    return out


def concat_chunks(chunks: list[dict]) -> dict:
    """One dict of the chunks' columns, in chunk order: arrays
    concatenated, string columns and lists joined in linear time.  Each
    chunk gives up its columns as they are joined, so a band is held
    about once."""
    cat = {}
    for k in list(chunks[0]):
        parts = [c.pop(k) for c in chunks]
        if isinstance(parts[0], np.ndarray):
            cat[k] = np.concatenate(parts)
        elif isinstance(parts[0], Strings):
            cat[k] = Strings.concat(parts)
        elif isinstance(parts[0], list):
            cat[k] = list(itertools.chain.from_iterable(parts))
        else:
            cat[k] = parts[0]
    return cat


def group_rows(key: np.ndarray):
    """(value, row indices) of each distinct value of key, in value
    order, each group's rows in their order."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    cut = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1], True])
    for a, b in zip(cut[:-1], cut[1:]):
        yield int(ks[a]), order[a:b]


class RecordSpool:
    """Append-only files of compressed record chunks under one directory.

    fresh=True empties the directory's spool files (a retried run must
    not replay an earlier attempt's rows); fresh=False reopens a sealed
    spool read-only (its `spool.json`)."""

    def __init__(self, directory: str, fresh: bool = True):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._files: dict = {}
        self._held: dict[str, list] = {}     # file -> row pieces not packed
        self._held_rows: dict[str, int] = {}
        self._pending: deque = deque()
        self._pool = None
        self.rows: dict[str, int] = {}
        self.meta: dict = {}
        if fresh:
            for path in glob.glob(os.path.join(directory, "*.spl")):
                os.remove(path)
            for path in glob.glob(os.path.join(directory, META)):
                os.remove(path)
        else:
            self.meta = self.read_meta(directory)
            self.rows = dict(self.meta.get("rows", {}))

    @staticmethod
    def read_meta(directory: str) -> dict:
        with open(os.path.join(directory, META)) as f:
            return json.load(f)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.spl")

    def append(self, name: str, chunk: dict, n: int) -> None:
        """Hold a chunk of n rows for the file `name`; packed (pickled and
        compressed on the pool) with the rows held before it once
        FLUSH_ROWS have gathered, written in the order of the calls."""
        self._held.setdefault(name, []).append(chunk)
        self._held_rows[name] = self._held_rows.get(name, 0) + n
        self.rows[name] = self.rows.get(name, 0) + n
        if self._held_rows[name] >= FLUSH_ROWS:
            self._pack(name)

    def _pack(self, name: str) -> None:
        pieces = self._held.pop(name)
        self._held_rows.pop(name)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(THREADS)
        chunk = pieces[0] if len(pieces) == 1 else concat_chunks(pieces)
        self._pending.append((name, self._pool.submit(_pack, chunk)))
        while len(self._pending) > 4 * THREADS:
            self._write_one()

    def add(self, prefix: str, group: np.ndarray, chunk: dict) -> None:
        """Route each row of chunk to the file `{prefix}{group}`: the rows
        put in group order once, each group's a slice of them."""
        group = np.asarray(group)
        if not len(group):
            return
        order = np.argsort(group, kind="stable")
        gs = group[order]
        cut = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1], True])
        if len(cut) > 2:
            chunk = take_rows(chunk, order)
        for a, b in zip(cut[:-1].tolist(), cut[1:].tolist()):
            self.append(f"{prefix}{gs[a]}",
                        dict(chunk) if len(cut) == 2
                        else slice_rows(chunk, a, b), b - a)

    def _write_one(self) -> None:
        name, fut = self._pending.popleft()
        f = self._files.get(name)
        if f is None:
            f = self._files[name] = open(self.path(name), "ab")
        f.write(fut.result())

    def flush(self) -> None:
        for name in list(self._held):
            self._pack(name)
        while self._pending:
            self._write_one()
        for f in self._files.values():
            f.flush()

    def bytes_on_disk(self) -> int:
        self.flush()
        return sum(os.path.getsize(p)
                   for p in glob.glob(os.path.join(self.dir, "*.spl")))

    def iter(self, name: str):
        """The chunks of file `name`, in order."""
        self.flush()
        yield from iter_file(self.path(name))

    def seal(self, meta: dict | None = None) -> None:
        """Write every queued chunk, close the files and record `meta`
        (plus the rows of each file) in spool.json: the spool is then
        complete on disk for a resumed run or for host 0."""
        self.flush()
        for f in self._files.values():
            f.close()
        self._files.clear()
        self.meta.update(meta or {}, rows=self.rows)
        tmp = os.path.join(self.dir, META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, os.path.join(self.dir, META))

    def close(self, remove: bool = True) -> None:
        if remove:
            self._held.clear()
            self._held_rows.clear()
        else:
            self.flush()
        if self._pool is not None:
            for _, fut in self._pending:
                fut.cancel()
            self._pending.clear()
            self._pool.shutdown(wait=True)
            self._pool = None
        for f in self._files.values():
            f.close()
        self._files.clear()
        if remove:
            shutil.rmtree(self.dir, ignore_errors=True)


def _pack(chunk: dict) -> bytes:
    blob = zlib.compress(pickle.dumps(chunk, pickle.HIGHEST_PROTOCOL), 1)
    return _LEN.pack(len(blob)) + blob


def _unpack(blob: bytes) -> dict:
    # only files this program wrote are read back
    return pickle.loads(zlib.decompress(blob))


def iter_file(path: str):
    """The chunks of one spool file, in order, decompressed on THREADS
    threads a few chunks ahead (nothing for a missing file)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f, ThreadPoolExecutor(THREADS) as pool:
        ahead: deque = deque()
        while True:
            head = f.read(_LEN.size)
            if head:
                (n,) = _LEN.unpack(head)
                ahead.append(pool.submit(_unpack, f.read(n)))
            if ahead and (not head or len(ahead) > 2 * THREADS):
                yield ahead.popleft().result()
            elif not head:
                return
