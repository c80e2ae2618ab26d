"""A column of byte strings as one uint8 buffer and int64 offsets: the
form the BAM writer's spool (pipeline/bam_spool.py) keeps read names
and other per-record strings in, and the native record encoder
(native/bam_host.py) reads without a Python object a row.
"""

from __future__ import annotations

import numpy as np


class Strings:
    """A column of byte strings as one uint8 buffer and int64 offsets:
    what a list of bytes holds, without a Python object a row."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: np.ndarray, off: np.ndarray):
        self.buf = buf
        self.off = off

    @classmethod
    def of(cls, items) -> "Strings":
        if isinstance(items, Strings):
            return items
        off = np.zeros(len(items) + 1, np.int64)
        np.cumsum(np.fromiter(map(len, items), np.int64, len(items)),
                  out=off[1:])
        return cls(np.frombuffer(b"".join(items), np.uint8), off)

    @classmethod
    def empty(cls, n: int) -> "Strings":
        return cls(np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i) -> bytes:
        return self.buf[self.off[i]:self.off[i + 1]].tobytes()

    def lengths(self) -> np.ndarray:
        return np.diff(self.off)

    def _spans(self, idx: np.ndarray):
        """(start of each taken row, lengths, new offsets)."""
        idx = np.asarray(idx, np.int64)
        start = self.off[idx]
        lens = self.off[idx + 1] - start
        off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        return start, lens, off

    def take(self, idx) -> "Strings":
        start, lens, off = self._spans(idx)
        if not off[-1]:
            return Strings(np.zeros(0, np.uint8), off)
        src = (np.repeat(start - off[:-1], lens)
               + np.arange(off[-1], dtype=np.int64))
        return Strings(self.buf[src], off)

    @classmethod
    def concat(cls, parts) -> "Strings":
        off = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            off.append(p.off[1:] - p.off[0] + base)
            base += int(p.off[-1] - p.off[0])
        return cls(np.concatenate([p.buf[p.off[0]:p.off[-1]]
                                   for p in parts] + [np.zeros(0, np.uint8)]),
                   np.concatenate(off))

    def words(self) -> np.ndarray:
        """[n, W] uint64: each string's bytes big-endian in 8-byte words,
        zero-padded, so that a lexsort on the words (last word the least
        significant key) orders rows as numpy's bytes ('S') order does."""
        lens = self.lengths()
        width = max(1, -(-int(lens.max(initial=0)) // 8))
        mat = np.zeros((len(self), width * 8), np.uint8)
        if len(self.buf):
            row = np.repeat(np.arange(len(self)), lens)
            col = (np.arange(self.off[-1] - self.off[0], dtype=np.int64)
                   - np.repeat(self.off[:-1] - self.off[0], lens))
            mat[row, col] = self.buf[self.off[0]:self.off[-1]]
        return mat.view(">u8").astype(np.uint64)

    def slice(self, a: int, b: int) -> "Strings":
        """Rows a..b, sharing this column's buffer."""
        return Strings(self.buf, self.off[a:b + 1])

    def tolist(self) -> list[bytes]:
        return [self[i] for i in range(len(self))]
