"""The BAM writer of the port's `count`: the stream and index that
io/bam_index.py IndexingBamWriter writes, from records encoded in bulk.

The caller hands it whole buffers of records already laid out as
io/bam.py BamWriter.write_record lays them out (native/bam_host.py
encodes them), each with its offset in the buffer, reference, position
and index end.  The stream (header, then the buffers in order) is cut at
the same fixed 60,000-byte offsets BamWriter._write cuts at; the blocks
are compressed on a thread pool, GROUP blocks a task, by the copy's own
`_bgzf_block` (Python's zlib, which releases the interpreter lock) and
written in order, so the caller encodes the next buffer while the pool
compresses this one.

The BAI is built from arrays.  A record at stream offset X has the
virtual offset (file offset of block X // 60,000) << 16 | X % 60,000,
which is what IndexingBamWriter._voffset gives before and after the
record's write: a record ending on a block boundary ends at the next
block's offset, 0.  The bins, the chunk coalescing and the linear
windows follow `_write_bai` and `_merge_chunks`, computed once at close,
when every block's file offset is known.
"""

from __future__ import annotations

import os
import struct
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bam import BGZF_EOF, BamWriter, _bgzf_block

BLOCK = 60000            # BamWriter._write's cut of the stream
GROUP = 16               # blocks a compression task takes (fewer hand-offs
                         # of the interpreter lock to the writing thread)
_LEVELS = ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1))  # _reg2bin


def _compress(blocks: list) -> tuple[list[bytes], float]:
    """The BGZF blocks of `blocks` and the thread's seconds for them."""
    t = time.thread_time()
    out = [_bgzf_block(b) for b in blocks]
    return out, time.thread_time() - t


def reg2bins(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """io/bam.py `_reg2bin` of each (beg, end), int64 arrays."""
    last = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, first in _LEVELS:
        hit = ~done & ((beg >> shift) == (last >> shift))
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def merge_chunks(ref, bin_, vs, ve):
    """Each (ref, bin)'s chunks coalesced as `_merge_chunks` does, sorted by
    (ref, bin, vs).  The chunks are disjoint ranges of one stream, so in
    vs order their ends rise too, and a chunk joins the one before it when
    it starts at or before that one's end."""
    o = np.lexsort((ve, vs, bin_, ref))
    ref, bin_, vs, ve = ref[o], bin_[o], vs[o], ve[o]
    same = (ref[1:] == ref[:-1]) & (bin_[1:] == bin_[:-1])
    if np.any(same & (ve[1:] < ve[:-1])):
        raise RuntimeError("BAI chunks overlap: records out of stream order")
    new = np.ones(len(ref), bool)
    new[1:] = ~same | (vs[1:] > ve[:-1])
    first = np.flatnonzero(new)
    if not len(first):
        return ref, bin_, vs, ve
    return ref[first], bin_[first], vs[first], np.maximum.reduceat(ve, first)


def least_per_window(ref, win, vs):
    """The least vs of each (ref, 16 kb window), sorted by (ref, window)."""
    o = np.lexsort((vs, win, ref))
    ref, win, vs = ref[o], win[o], vs[o]
    first = np.ones(len(ref), bool)
    first[1:] = (ref[1:] != ref[:-1]) | (win[1:] != win[:-1])
    return ref[first], win[first], vs[first]


def windows(ref, beg, end, vs):
    """Every (ref, window, vs) of records spanning windows beg >> 14 ..
    (end - 1) >> 14."""
    w0 = beg >> 14
    nw = ((end - 1) >> 14) - w0 + 1
    rows = np.repeat(np.arange(len(beg)), nw)
    starts = np.repeat(np.cumsum(nw) - nw, nw)
    return ref[rows], w0[rows] + (np.arange(len(rows)) - starts), vs[rows]


def bai_bytes(n_ref: int, chunks, wins) -> bytes:
    """The .bai of `_write_bai` from merged chunks (ref, bin, vs, ve) and
    per-window least offsets (ref, window, vs), both sorted."""
    cref, cbin, cvs, cve = chunks
    wref, win, wvs = wins
    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    cb = np.searchsorted(cref, np.arange(n_ref + 1))
    wb = np.searchsorted(wref, np.arange(n_ref + 1))
    for r in range(n_ref):
        b = cbin[cb[r]:cb[r + 1]]
        pairs = np.stack([cvs[cb[r]:cb[r + 1]], cve[cb[r]:cb[r + 1]]],
                         axis=1).astype("<u8")
        # a reference with no indexed record has 0 bins
        edges = (np.flatnonzero(np.r_[True, b[1:] != b[:-1], True])
                 if len(b) else np.zeros(1, np.int64))
        out.append(struct.pack("<i", len(edges) - 1))
        for lo, hi in zip(edges[:-1], edges[1:]):
            out.append(struct.pack("<Ii", int(b[lo]), int(hi - lo)))
            out.append(pairs[lo:hi].tobytes())
        w = win[wb[r]:wb[r + 1]]
        if len(w):
            n_win = int(w[-1]) + 1
            filled = np.zeros(n_win, "<u8")
            filled[w] = wvs[wb[r]:wb[r + 1]]
            known = np.zeros(n_win, bool)
            known[w] = True
            # forward fill from 0, as `last = linear.get(w, last)`
            src = np.maximum.accumulate(np.where(known, np.arange(n_win), 0))
            out.append(struct.pack("<i", n_win))
            out.append(filled[src].tobytes())
        else:
            out.append(struct.pack("<i", 0))
    return b"".join(out)


class BgzfBamWriter(BamWriter):
    """BamWriter's header and stream, IndexingBamWriter's .bai, from
    buffers of encoded records; blocks compressed on a thread a core."""

    def __init__(self, path: str, ref_names, ref_lens, extra_header: str = ""):
        self.threads = len(os.sched_getaffinity(0))
        self._pool = ThreadPoolExecutor(self.threads)
        self._pending: deque = deque()   # group futures, in stream order
        self._group: list = []           # full blocks not yet submitted
        self._tail = bytearray()         # the stream's unfilled block
        self._stream = 0                 # stream bytes so far
        self._block_at = [0]             # file offset of each block written
        self._records: list = []         # (ref, pos, end, start, stop) of
                                         # each buffer's indexed records
        self._n_ref = len(ref_names)
        self._vpath = path + ".bai"
        # seconds: the writing thread waiting for the pool, the blocks'
        # thread time, the index's reduction and the .bai write
        self.wait_s = self.compress_cpu_s = self.index_s = 0.0
        super().__init__(path, ref_names, ref_lens, extra_header)

    def _write(self, data):
        mv = memoryview(data).cast("B")
        at = 0
        if self._tail:
            at = min(BLOCK - len(self._tail), len(mv))
            self._tail += mv[:at]
            if len(self._tail) == BLOCK:
                self._add(bytes(self._tail))
                self._tail = bytearray()
        while len(mv) - at >= BLOCK:
            self._add(mv[at:at + BLOCK])   # a view: the caller's buffer
            at += BLOCK                    # stays alive in the task
        self._tail += mv[at:]
        self._stream += len(mv)

    def _add(self, block):
        self._group.append(block)
        if len(self._group) == GROUP:
            self._submit()

    def _submit(self):
        if self._group:
            self._pending.append(self._pool.submit(_compress, self._group))
            self._group = []

    def _flush(self, keep: int):
        """Writes finished groups of blocks in order, waiting while more
        than `keep` are pending."""
        while self._pending and (len(self._pending) > keep
                                 or self._pending[0].done()):
            t = time.perf_counter()
            blocks, cpu = self._pending.popleft().result()
            self.wait_s += time.perf_counter() - t
            self.compress_cpu_s += cpu
            for block in blocks:
                self._f.write(block)
                self._block_at.append(self._block_at[-1] + len(block))

    def write_records(self, buf: np.ndarray, rec_end: np.ndarray,
                      ref: np.ndarray, pos: np.ndarray, end: np.ndarray):
        """Appends the records of buf (record k ends at rec_end[k]); those
        with ref >= 0 go into the index with [pos, end)."""
        base = self._stream
        self._write(buf)
        keep = ref >= 0
        if keep.any():
            stop = base + rec_end
            start = np.concatenate(([base], stop[:-1]))
            self._records.append((ref[keep], pos[keep], end[keep],
                                  start[keep], stop[keep]))
        # one buffer's blocks compress while the caller encodes the next
        self._flush(keep=2 * self.threads)

    def close(self):
        if self._tail:
            self._group.append(bytes(self._tail))
            self._tail = bytearray()
        self._submit()
        self._flush(keep=0)
        self._f.write(BGZF_EOF)
        self._f.close()
        self._pool.shutdown()
        t = time.perf_counter()
        ref, pos, end, start, stop = (
            np.concatenate([r[k] for r in self._records]).astype(np.int64)
            if self._records else np.zeros(0, np.int64) for k in range(5))
        self._records = []
        at = np.asarray(self._block_at, np.int64)
        vs = (at[start // BLOCK] << 16) | (start % BLOCK)
        ve = (at[stop // BLOCK] << 16) | (stop % BLOCK)
        chunks = merge_chunks(ref, reg2bins(pos, end), vs, ve)
        wins = least_per_window(*windows(ref, pos, end, vs))
        with open(self._vpath, "wb") as f:
            f.write(bai_bytes(self._n_ref, chunks, wins))
        self.index_s += time.perf_counter() - t
