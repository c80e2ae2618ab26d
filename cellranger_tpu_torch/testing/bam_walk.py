"""One pass over a BGZF BAM of any size, for checks that cannot hold
the file or a Python object a record: the BGZF blocks are read and
inflated a group at a time on threads, a few groups ahead of the walk,
and native/bam_walk.cpp walks the records of each group (built with g++
at first use into build/native/, as native/build.py builds the port's
other host libraries).

`walk_bam` returns each record's reference id, position, end, flag and
virtual offsets (of a writer that fills every BGZF block but the last,
60,000 bytes, which it checks), and the tags of the records whose read
number is asked for.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..native import BUILD_DIR, build

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "bam_walk.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libbam_walk.so")
_lock = threading.Lock()
_lib = None
BLOCK = 60_000              # a full BGZF block's payload
GROUP_BLOCKS = 64           # blocks a thread inflates at once (~3.8 MB)


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load(_SRC, _LIB_PATH, BUILD_DIR)
            lib.crt_bam_walk.restype = ctypes.c_int64
            lib.crt_bam_walk.argtypes = (
                [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64] + [ctypes.c_void_p] * 8)
            _lib = lib
        return _lib


def _blocks(path: str):
    """(file offset, compressed bytes, inflated size) of each BGZF block,
    reading the file sequentially."""
    with open(path, "rb") as f:
        at = 0
        while True:
            head = f.read(18)
            if len(head) < 18:
                return
            bsize = struct.unpack_from("<H", head, 16)[0] + 1
            rest = f.read(bsize - 18)
            isize = struct.unpack_from("<I", rest, len(rest) - 4)[0]
            yield at, rest[:-8], isize
            at += bsize


def _tags(data: bytes, o: int, end: int) -> dict:
    """The aux tags of a record's bytes data[o:end] (io/bam_read.py's
    parse of them)."""
    tags = {}
    while o < end:
        tag = data[o:o + 2].decode()
        tc = chr(data[o + 2])
        o += 3
        if tc == "Z":
            z = data.index(b"\x00", o)
            tags[tag] = data[o:z].decode()
            o = z + 1
        elif tc in "iIcCsS":
            fmt = {"i": "<i", "I": "<I", "c": "<b", "C": "<B", "s": "<h",
                   "S": "<H"}[tc]
            tags[tag] = struct.unpack_from(fmt, data, o)[0]
            o += struct.calcsize(fmt)
        elif tc == "A":
            tags[tag] = chr(data[o])
            o += 1
        else:
            raise ValueError(f"unhandled tag type {tc}")
    return tags


def _record_tags(buf: bytes, off: int, end: int) -> dict:
    l_rn, n_cig, l_seq = (buf[off + 12],
                          struct.unpack_from("<H", buf, off + 16)[0],
                          struct.unpack_from("<i", buf, off + 20)[0])
    o = off + 36 + l_rn + 4 * n_cig + (l_seq + 1) // 2 + l_seq
    return _tags(buf, o, end)


def walk_bam(path: str, sample=None, threads: int = 8) -> dict:
    """Every record of the BAM at `path`: ref, pos, end (int32), flag
    (uint16), vstart and vend (virtual offsets, int64), in file order;
    n_ref and ref_lens from the header; `tags`: {read number: [tags of
    each of its records, with its "flag"]} for the read numbers in
    `sample` (sorted int64);
    blocks, stream bytes."""
    lib = get_lib()
    sample = np.zeros(0, np.int64) if sample is None else np.asarray(
        sample, np.int64)
    cols = {k: [] for k in ("ref", "pos", "end", "flag", "vstart", "vend")}
    tags: dict = {}
    starts: list[int] = []
    sizes: list[int] = []
    carry = b""
    base = 0             # stream offset of carry's first byte
    header = None
    blocks = _blocks(path)

    def inflate(group):
        return b"".join(zlib.decompress(g[1], -15) for g in group)

    with ThreadPoolExecutor(threads) as pool:
        ahead: deque = deque()
        while True:
            while len(ahead) < 4 * threads:
                group = list(itertools.islice(blocks, GROUP_BLOCKS))
                if not group:
                    break
                starts += [g[0] for g in group]
                sizes += [g[2] for g in group]
                ahead.append(pool.submit(inflate, group))
            if not ahead:
                break
            buf = carry + ahead.popleft().result()
            off = 0
            if header is None:
                if len(buf) < 12:
                    carry = buf
                    continue
                l_text = struct.unpack_from("<i", buf, 4)[0]
                o = 8 + l_text
                if len(buf) < o + 4:
                    carry = buf
                    continue
                n_ref = struct.unpack_from("<i", buf, o)[0]
                o += 4
                lens = []
                for _ in range(n_ref):
                    ln = struct.unpack_from("<i", buf, o)[0]
                    lens.append(struct.unpack_from("<i", buf, o + 4 + ln)[0])
                    o += 8 + ln
                header = dict(n_ref=n_ref, ref_lens=lens)
                off = o
            arr = np.frombuffer(buf, np.uint8)
            cap = max(1, len(buf) // 36 + 1)
            ro, re_, rn = (np.empty(cap, np.int64) for _ in range(3))
            ref, pos, end = (np.empty(cap, np.int32) for _ in range(3))
            flag = np.empty(cap, np.uint16)
            stop = ctypes.c_int64(0)
            k = lib.crt_bam_walk(
                arr.ctypes.data, len(buf), off, cap, ro.ctypes.data,
                re_.ctypes.data, ref.ctypes.data, pos.ctypes.data,
                end.ctypes.data, flag.ctypes.data, rn.ctypes.data,
                ctypes.byref(stop))
            if k < 0:
                raise ValueError(f"{path}: a record shorter than its fields")
            for name, v in (("ref", ref), ("pos", pos), ("end", end),
                            ("flag", flag)):
                cols[name].append(v[:k].copy())
            cols["vstart"].append(base + ro[:k])
            cols["vend"].append(base + re_[:k])
            if len(sample):
                hit = np.flatnonzero(np.isin(rn[:k], sample))
                for i in hit.tolist():
                    tags.setdefault(int(rn[i]), []).append(dict(
                        _record_tags(buf, int(ro[i]), int(re_[i])),
                        flag=int(flag[i])))
            carry = buf[stop.value:]
            base += stop.value
    if carry:
        raise ValueError(f"{path}: {len(carry)} bytes after the last record")
    full = [s for s in sizes if s]
    if any(s != BLOCK for s in full[:-1]):
        raise ValueError(f"{path}: a BGZF block other than the last is not "
                         f"{BLOCK} bytes")
    at = np.asarray(starts, np.int64)
    out = {k: (np.concatenate(v) if v else np.zeros(0, np.int64))
           for k, v in cols.items()}
    for k in ("vstart", "vend"):
        p = out[k]
        out[k] = (at[p // BLOCK] << 16) | (p % BLOCK)
    out.update(header or dict(n_ref=0, ref_lens=[]), tags=tags,
               blocks=len(starts), stream_bytes=int(base))
    return out
