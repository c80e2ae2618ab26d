"""HDF5 files in numpy, struct and zlib: the subset of h5py the port uses.

The port's copies of the JAX package's h5 writers and readers
(io/matrix_io.py, io/molecule_info.py, testing/correctness.py) import this
module as `h5py`, so the port reads and writes `.h5` the same way on every
machine, whether or not h5py is installed there.

The API is the part of h5py 3 those copies call, with h5py 3's return
types: `File(path, "w" | "r")` (a context manager and a `Group`),
`Group.create_group`, `Group.create_dataset(name, data=, chunks=,
compression="gzip", compression_opts=, shuffle=)`, `g[name]` and
`g["a/b"]`, `keys()`, `items()`, `in`, `Group.copy(name, dest)`, `attrs`
as a mutable mapping, and `Dataset[()]`, `Dataset[:]`, `.shape`, `.dtype`,
`.chunks`, `.compression`, `.compression_opts`, `.shuffle`.  A Python
`int` attribute is stored as int64, a `str` as a variable-length UTF-8
string (read back as `str`), `bytes` as a variable-length ASCII string; a
scalar variable-length string dataset reads back as `bytes`.

On disk it is what h5py writes with its default `libver="earliest"`:
superblock 0, version-1 object headers (continuation blocks followed on
read), symbol-table groups (a version-1 B-tree of type 0 over `SNOD` nodes
and a local heap), dataspace 1, little-endian integers, IEEE floats,
fixed-length `NULLPAD` ASCII strings, variable-length strings in global
heap collections, layout 3 (contiguous and chunked; compact on read),
filter pipeline 1 with shuffle and deflate, and a version-1 B-tree of type
1 over the chunks, as many levels deep as it needs.  Chunk shapes follow
h5py's own rule (`guess_chunk`), and edge chunks are stored whole, so a
file written here reads back through h5py with the same `.chunks`,
`.compression`, `.compression_opts` and `.shuffle` as h5py's own.  No
modification times are written.  Whatever is outside this subset raises.
"""

from __future__ import annotations

import collections
import math
import mmap
import os
import struct
import zlib
from collections.abc import MutableMapping
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_DATATYPE = 0x0, 0x1, 0x3
MSG_FILL, MSG_LAYOUT, MSG_PIPELINE = 0x5, 0x8, 0xB
MSG_ATTRIBUTE, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xC, 0x10, 0x11
MSG_FLAG_CONSTANT = 0x1
MSG_FLAG_SHARED = 0x2

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
FILTER_OPTIONAL = 0x1

GROUP_LEAF_K = 4         # a SNOD holds 2K symbols
GROUP_INTERNAL_K = 16    # a group B-tree node holds 2K children
CHUNK_K = 32             # a chunk B-tree node holds 2K children
GCOL_MIN = 4096          # the least size of a global heap collection
HEAP_FREE_NULL = 1       # end of a local heap's free list

# h5py's chunk rule (h5py/_hl/filters.py guess_chunk)
CHUNK_BASE = 16 * 1024
CHUNK_MIN = 8 * 1024
CHUNK_MAX = 1024 * 1024
DEFAULT_GZIP = 4

# a variable-length element on disk: length, collection address, index
_VLEN_RAW = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
VLEN_UTF8 = np.dtype("O", metadata={"vlen": str})
VLEN_ASCII = np.dtype("O", metadata={"vlen": bytes})


def _ordered_map(fn, items: list):
    """fn over items, the results in their order, on threads when there is
    more than one item: zlib lets go of the GIL, so a dataset's chunks are
    deflated and inflated on every core, and the file's bytes stay those of
    one thread.  At most two results a thread are held at once, so a
    dataset's chunks pass through in a bounded window."""
    if len(items) < 2:
        yield from map(fn, items)
        return
    n = min(len(items), os.cpu_count() or 1)
    with ThreadPoolExecutor(n) as ex:
        window = collections.deque()
        for item in items:
            window.append(ex.submit(fn, item))
            if len(window) == 2 * n:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _align8(n: int) -> int:
    return n + (-n % 8)


def _vlen_kind(dt: np.dtype):
    """str or bytes for a variable-length string dtype, else None."""
    if dt.kind != "O":
        return None
    kind = (dt.metadata or {}).get("vlen")
    if kind not in (str, bytes):
        raise TypeError(f"object dtype without a string kind: {dt!r}")
    return kind


def guess_chunk(shape: tuple, typesize: int) -> tuple:
    """h5py's chunk shape for a dataset of `shape` and element size
    `typesize`: halve the axes in turn until the chunk is within half of a
    target that grows with the dataset (8 KiB to 1 MiB)."""
    if not shape:
        raise ValueError("chunks are not allowed for scalar datasets")
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    dset_size = float(np.prod(chunks)) * typesize
    target = CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * typesize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5) \
                and chunk_bytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _as_array(data, dtype=None) -> np.ndarray:
    """h5py's conversion of a value for a new dataset or attribute: `bytes`
    becomes a variable-length ASCII string, `str` a variable-length UTF-8
    one, everything else `np.asarray`."""
    if dtype is None and type(data) is bytes:
        dtype = VLEN_ASCII
    elif dtype is None and type(data) is str:
        dtype = VLEN_UTF8
    if dtype is not None:
        dtype = np.dtype(dtype)
        if _vlen_kind(dtype) is not None:
            out = np.empty(np.shape(data), dtype=dtype)
            out[...] = data
            return out
    return np.asarray(data, dtype=dtype, order="C")


# ------------------------------------------------------------- datatypes
def _encode_dtype(dt: np.dtype) -> bytes:
    kind = _vlen_kind(dt)
    if kind is not None:
        utf8 = kind is str
        # class 9, string, null-terminated, charset; base: unsigned char
        base = _encode_dtype(np.dtype("u1"))
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01 if utf8 else 0x00, 0,
                           16) + base
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        signed = 0x08 if dt.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        if dt.itemsize == 4:
            sign, exp_loc, exp_size, mant_size, bias = 31, 23, 8, 23, 127
        else:
            sign, exp_loc, exp_size, mant_size, bias = 63, 52, 11, 52, 1023
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, dt.itemsize,
                           0, 8 * dt.itemsize, exp_loc, exp_size, 0,
                           mant_size, bias)
    if dt.kind == "S":
        # null-padded ASCII
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)
    raise TypeError(f"no HDF5 datatype for numpy dtype {dt!r}")


def _decode_dtype(buf, p: int) -> tuple[np.dtype, int]:
    """(numpy dtype, bytes consumed) of the datatype message at `p`."""
    cv, b0, b1, _b2, size = struct.unpack_from("<BBBBI", buf, p)
    cls, version = cv & 0x0F, cv >> 4
    if version not in (1, 2, 3):
        raise NotImplementedError(f"datatype version {version}")
    order = ">" if b0 & 0x01 else "<"
    if cls == 0:                                   # fixed-point
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"integer of {size} bytes")
        kind = "i" if b0 & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}"), 12
    if cls == 1:                                   # floating point
        if size not in (4, 8):
            raise NotImplementedError(f"float of {size} bytes")
        return np.dtype(f"{order}f{size}"), 20
    if cls == 3:                                   # fixed-length string
        return np.dtype(f"S{size}"), 8
    if cls == 9:                                   # variable-length
        if b0 & 0x0F != 1:
            raise NotImplementedError("variable-length sequences")
        _base, n = _decode_dtype(buf, p + 8)
        return (VLEN_UTF8 if b1 & 0x0F == 1 else VLEN_ASCII), 8 + n
    raise NotImplementedError(f"datatype class {cls}")


def _raw_dtype(dt: np.dtype) -> np.dtype:
    """The dtype of an element as it lies on disk."""
    return _VLEN_RAW if dt.kind == "O" else dt


# ------------------------------------------------------------ dataspaces
def _encode_space(shape: tuple) -> bytes:
    """Version 1; rank 0 is a scalar.  Maximum dimensions equal the
    dimensions, as the library writes them for a fixed-size space."""
    head = struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0)
    return head + struct.pack(f"<{2 * len(shape)}Q", *shape, *shape)


def _decode_space(buf, p: int) -> tuple:
    version, rank = struct.unpack_from("<BB", buf, p)
    if version != 1:
        raise NotImplementedError(f"dataspace version {version}")
    return tuple(int(x) for x in struct.unpack_from(f"<{rank}Q", buf, p + 8))


# --------------------------------------------------------------- filters
def _shuffle(b: bytes, size: int) -> bytes:
    if size == 1:
        return b
    n = len(b) // size
    a = np.frombuffer(b, np.uint8, n * size).reshape(n, size)
    return a.T.tobytes() + b[n * size:]


def _unshuffle(b: bytes, size: int) -> bytes:
    if size == 1:
        return b
    n = len(b) // size
    a = np.frombuffer(b, np.uint8, n * size).reshape(size, n)
    return a.T.tobytes() + b[n * size:]


def _encode_pipeline(filters: list[tuple[int, tuple]]) -> bytes:
    out = [struct.pack("<BB6x", 1, len(filters))]
    for fid, cd in filters:
        name = {FILTER_DEFLATE: b"deflate", FILTER_SHUFFLE: b"shuffle"}[fid]
        name = _pad8(name + b"\0")
        out.append(struct.pack("<HHHH", fid, len(name), FILTER_OPTIONAL,
                               len(cd)) + name)
        out.append(struct.pack(f"<{len(cd)}I", *cd) + bytes(4 * (len(cd) % 2)))
    return b"".join(out)


def _decode_pipeline(buf) -> list[tuple[int, tuple]]:
    version, n = buf[0], buf[1]
    if version != 1:
        raise NotImplementedError(f"filter pipeline version {version}")
    p, out = 8, []
    for _ in range(n):
        fid, name_len, _flags, ncd = struct.unpack_from("<HHHH", buf, p)
        p += 8 + name_len
        cd = struct.unpack_from(f"<{ncd}I", buf, p)
        p += 4 * (ncd + ncd % 2)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise NotImplementedError(f"HDF5 filter {fid}")
        out.append((fid, tuple(cd)))
    return out


# ================================================================ objects
class AttributeManager(MutableMapping):
    """`obj.attrs`: names to values, iterated in name order as h5py does.
    Values are held as h5py would convert them when written, and read back
    as h5py returns them."""

    def __init__(self, writable: bool):
        self._writable = writable
        self._arrays: dict[str, np.ndarray] = {}

    def __getitem__(self, name):
        return _attr_value(self._arrays[name])

    def __setitem__(self, name, value):
        if not self._writable:
            raise OSError("the file is open read-only")
        arr = _as_array(value)
        _encode_dtype(arr.dtype)              # refuse what cannot be stored
        self._arrays[name] = arr

    def __delitem__(self, name):
        if not self._writable:
            raise OSError("the file is open read-only")
        del self._arrays[name]

    def __iter__(self):
        return iter(sorted(self._arrays, key=lambda k: k.encode()))

    def __len__(self):
        return len(self._arrays)


def _attr_value(arr: np.ndarray):
    if arr.dtype.kind == "O":
        arr = np.array([b.decode("utf-8", "surrogateescape")
                        if isinstance(b, bytes) else b for b in arr.flat],
                       dtype=arr.dtype).reshape(arr.shape)
    return arr[()] if arr.ndim == 0 else arr


class Group:
    """A group: a mapping of names to groups and datasets."""

    def __init__(self, file: "File", name: str):
        self.file = file
        self.name = name
        self._children: dict[str, Group | Dataset] = {}
        self.attrs = AttributeManager(file.mode == "w")

    # ------------------------------------------------------------ lookup
    def _walk(self, path: str):
        node = self.file if path.startswith("/") else self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._children:
                raise KeyError(f"{path!r} is not in {self.name!r}")
            node = node._children[part]
        return node

    def __getitem__(self, path: str):
        return self._walk(path)

    def __contains__(self, path: str) -> bool:
        try:
            self._walk(path)
        except KeyError:
            return False
        return True

    def keys(self) -> list[str]:
        return sorted(self._children, key=lambda k: k.encode())

    def items(self) -> list:
        return [(k, self._children[k]) for k in self.keys()]

    # ------------------------------------------------------------ create
    def _parent_of(self, path: str) -> tuple["Group", str]:
        if self.file.mode != "w":
            raise OSError("the file is open read-only")
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"bad name {path!r}")
        node = self.file if path.startswith("/") else self
        for part in parts[:-1]:
            node = node._children[part] if part in node._children \
                else node.create_group(part)
        if parts[-1] in node._children:
            raise ValueError(f"{path!r} already exists in {node.name!r}")
        return node, parts[-1]

    def _child_name(self, leaf: str) -> str:
        return (self.name.rstrip("/") + "/" + leaf)

    def create_group(self, path: str) -> "Group":
        parent, leaf = self._parent_of(path)
        g = Group(self.file, parent._child_name(leaf))
        parent._children[leaf] = g
        return g

    def create_dataset(self, path: str, data=None, dtype=None, chunks=None,
                       compression=None, compression_opts=None,
                       shuffle=None) -> "Dataset":
        if data is None:
            raise TypeError("create_dataset needs data")
        parent, leaf = self._parent_of(path)
        arr = _as_array(data, dtype)
        ds = self.file._writer.dataset(self.file, parent._child_name(leaf),
                                       arr, chunks, compression,
                                       compression_opts, shuffle)
        parent._children[leaf] = ds
        return ds

    def copy(self, source, dest: "Group", name: str | None = None):
        """Copy `source` (a path under this group, or a group or dataset)
        into `dest` under `name` (its own name by default), with its
        attributes, chunk shape and filters."""
        src = self._walk(source) if isinstance(source, str) else source
        name = name or src.name.rstrip("/").rsplit("/", 1)[-1]
        if isinstance(src, Dataset):
            new = dest.create_dataset(
                name, data=src[()], dtype=src.dtype, chunks=src.chunks,
                compression=src.compression,
                compression_opts=src.compression_opts, shuffle=src.shuffle)
        else:
            new = dest.create_group(name)
            for k, child in src.items():
                src.copy(child, new, k)
        for k, v in src.attrs._arrays.items():
            new.attrs._arrays[k] = v
        return new


class Dataset:
    """A dataset: its shape, dtype, storage and filters. `ds[()]`, `ds[...]`
    and `ds[:]` read all of it; no other selection is offered, since every
    read decodes the whole dataset."""

    def __init__(self, file: "File", name: str, shape: tuple,
                 dtype: np.dtype, chunks: tuple | None,
                 filters: list[tuple[int, tuple]]):
        self.file = file
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.chunks = chunks
        self._filters = filters
        self.attrs = AttributeManager(file.mode == "w")
        self._layout: tuple = ("contiguous", UNDEF, 0)

    @property
    def compression(self):
        return "gzip" if self.compression_opts is not None else None

    @property
    def compression_opts(self):
        """The deflate level, None without deflate."""
        return next((cd[0] for fid, cd in self._filters
                     if fid == FILTER_DEFLATE), None)

    @property
    def shuffle(self) -> bool:
        return any(fid == FILTER_SHUFFLE for fid, _ in self._filters)

    def __getitem__(self, key):
        whole = key is Ellipsis or (isinstance(key, tuple) and not key)
        if not whole and not (isinstance(key, slice)
                              and key == slice(None)):
            raise TypeError(f"selection {key!r}: only [()], [...] and [:] "
                            "are supported")
        arr = self.file._reader_for(self).read(self)
        if whole:
            return arr[()] if arr.ndim == 0 else arr
        if arr.ndim == 0:
            raise ValueError("a scalar dataset is read with [()]")
        return arr


class File(Group):
    """An HDF5 file opened to read ("r") or to write anew ("w")."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")
        self.mode = mode
        self.filename = os.fspath(path)
        self._reader = self._writer = None
        super().__init__(self, "/")
        if mode == "w":
            self._writer = _Writer(self.filename)
        else:
            self._reader = _Reader(self.filename)
            try:
                self._reader.load_root(self)
            except BaseException:
                self._reader.close()
                raise

    def _reader_for(self, ds: Dataset) -> "_Reader":
        if self._reader is None:
            raise OSError(f"{ds.name}: datasets are read from a file "
                          "opened with mode 'r'")
        if self._reader.buf is None:
            raise ValueError(f"{ds.name}: the file is closed")
        return self._reader

    def close(self):
        if self._writer is not None:
            w, self._writer = self._writer, None
            w.finish(self)
        if self._reader is not None:
            self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ================================================================ reading
class _Reader:
    def __init__(self, path: str):
        self._fh = open(path, "rb")
        try:
            self.buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file (empty)") from None
        self.path = path
        self._gcols: dict[int, dict[int, bytes]] = {}

    def close(self):
        if self.buf is not None:
            self.buf.close()
            self.buf = None
            self._fh.close()

    def _fail(self, what: str):
        raise OSError(f"{self.path}: {what}")

    def load_root(self, root: File):
        b = self.buf
        if b[:8] != SIGNATURE:
            self._fail("no HDF5 signature at offset 0")
        if b[8] != 0:
            raise NotImplementedError(f"{self.path}: superblock version "
                                      f"{b[8]}")
        if b[13] != 8 or b[14] != 8:
            raise NotImplementedError(f"{self.path}: offsets of {b[13]} "
                                      f"bytes, lengths of {b[14]}")
        base, = struct.unpack_from("<Q", b, 24)
        if base != 0:
            raise NotImplementedError(f"{self.path}: base address {base}")
        root_ohdr, = struct.unpack_from("<Q", b, 64)
        self._load(root, self.messages(root_ohdr), root_ohdr)

    # -------------------------------------------------- object headers
    def messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        """(type, flags, body) of every message of the object header at
        `addr`, continuation blocks followed."""
        b, p = self.buf, addr
        if b[p] != 1:
            raise NotImplementedError(f"{self.path}: object header version "
                                      f"{b[p]} at {addr}")
        size, = struct.unpack_from("<I", b, p + 8)
        blocks, out = [(p + 16, size)], []
        while blocks:
            q, length = blocks.pop(0)
            end = q + length
            while q + 8 <= end:
                mtype, msize, flags = struct.unpack_from("<HHB", b, q)
                body = b[q + 8:q + 8 + msize]
                q += 8 + msize
                if flags & MSG_FLAG_SHARED:
                    raise NotImplementedError(f"{self.path}: shared message")
                if mtype == MSG_CONTINUATION:
                    off, ln = struct.unpack_from("<QQ", body)
                    blocks.append((off, ln))
                elif mtype != MSG_NIL:
                    out.append((mtype, flags, body))
        return out

    def _load(self, node: Group, msgs: list, addr: int):
        for mtype, _f, body in msgs:
            if mtype == MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", body)
                for name, child_addr in self._symbols(btree, heap):
                    node._children[name] = self._object(
                        node.file, node._child_name(name), child_addr)
            elif mtype == MSG_ATTRIBUTE:
                name, arr = self._attribute(body)
                node.attrs._arrays[name] = arr
            elif mtype in (0x2, 0x6, 0xA):
                raise NotImplementedError(f"{self.path}: new-style group "
                                          f"at {addr}")

    def _object(self, file: File, name: str, addr: int):
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        if MSG_LAYOUT not in types:
            if MSG_SYMBOL_TABLE not in types:
                self._fail(f"object at {addr} is neither group nor dataset")
            g = Group(file, name)
            self._load(g, msgs, addr)
            return g
        shape, dtype, filters, layout = (), None, [], None
        attrs = {}
        for mtype, _f, body in msgs:
            if mtype == MSG_DATASPACE:
                shape = _decode_space(body, 0)
            elif mtype == MSG_DATATYPE:
                dtype, _ = _decode_dtype(body, 0)
            elif mtype == MSG_PIPELINE:
                filters = _decode_pipeline(body)
            elif mtype == MSG_FILL:
                _check_fill(body, name)
            elif mtype == MSG_LAYOUT:
                layout = self._layout(body)
            elif mtype == MSG_ATTRIBUTE:
                k, arr = self._attribute(body)
                attrs[k] = arr
        if dtype is None:
            self._fail(f"dataset {name} has no datatype")
        chunks = tuple(layout[2][:-1]) if layout[0] == "chunked" else None
        ds = Dataset(file, name, shape, dtype, chunks, filters)
        ds._layout = layout
        ds.attrs._arrays.update(attrs)
        return ds

    def _layout(self, body) -> tuple:
        version, cls = body[0], body[1]
        if version != 3:
            raise NotImplementedError(f"{self.path}: layout version {version}")
        if cls == 0:
            size, = struct.unpack_from("<H", body, 2)
            return ("compact", bytes(body[4:4 + size]))
        if cls == 1:
            addr, size = struct.unpack_from("<QQ", body, 2)
            return ("contiguous", addr, size)
        if cls == 2:
            ndims = body[2]
            addr, = struct.unpack_from("<Q", body, 3)
            dims = struct.unpack_from(f"<{ndims}I", body, 11)
            return ("chunked", addr, dims)
        raise NotImplementedError(f"{self.path}: layout class {cls}")

    # ---------------------------------------------------------- groups
    def _symbols(self, btree: int, heap: int) -> list[tuple[str, int]]:
        b = self.buf
        if b[heap:heap + 4] != b"HEAP":
            self._fail(f"no local heap at {heap}")
        dsize, _free, daddr = struct.unpack_from("<QQQ", b, heap + 8)
        names = bytes(b[daddr:daddr + dsize])
        out = []
        for snod in self._btree_children(btree, 0, 8):
            if b[snod:snod + 4] != b"SNOD":
                self._fail(f"no symbol table node at {snod}")
            n, = struct.unpack_from("<H", b, snod + 6)
            for i in range(n):
                off, ohdr = struct.unpack_from("<QQ", b, snod + 8 + 40 * i)
                name = names[off:names.index(b"\0", off)]
                out.append((name.decode("utf-8", "surrogateescape"), ohdr))
        return out

    def _btree_children(self, addr: int, ntype: int, key_size: int):
        """(child addresses of the leaves) of the version-1 B-tree at
        `addr`, in key order; for chunk trees each comes with its key."""
        b = self.buf
        if b[addr:addr + 4] != b"TREE" or b[addr + 4] != ntype:
            self._fail(f"no B-tree node of type {ntype} at {addr}")
        level = b[addr + 5]
        n, = struct.unpack_from("<H", b, addr + 6)
        q = addr + 24
        out = []
        for i in range(n):
            key = bytes(b[q:q + key_size])
            child, = struct.unpack_from("<Q", b, q + key_size)
            q += key_size + 8
            if level:
                out += self._btree_children(child, ntype, key_size)
            else:
                out.append(child if ntype == 0 else (key, child))
        return out

    # ------------------------------------------------------ attributes
    def _attribute(self, body) -> tuple[str, np.ndarray]:
        if body[0] != 1:
            raise NotImplementedError(f"attribute message version {body[0]}")
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", body, 2)
        p = 8
        name = bytes(body[p:p + name_size]).rstrip(b"\0").decode("utf-8")
        p += _align8(name_size)
        dtype, _ = _decode_dtype(body, p)
        p += _align8(dt_size)
        shape = _decode_space(body, p)
        p += _align8(ds_size)
        raw = _raw_dtype(dtype)
        n = math.prod(shape)
        arr = np.frombuffer(body, raw, n, p).reshape(shape)
        return name, self._to_memory(arr, dtype)

    # ---------------------------------------------------------- data
    def _to_memory(self, raw: np.ndarray, dtype: np.dtype) -> np.ndarray:
        if dtype.kind != "O":
            return raw.astype(dtype.newbyteorder("="), copy=True)
        out = np.empty(raw.shape, dtype=dtype)
        flat = out.reshape(-1)
        for i, (ln, addr, idx) in enumerate(raw.reshape(-1).tolist()):
            flat[i] = self._gheap(addr, idx)[:ln] if ln else b""
        return out

    def _gheap(self, addr: int, idx: int) -> bytes:
        col = self._gcols.get(addr)
        if col is None:
            b = self.buf
            if b[addr:addr + 4] != b"GCOL":
                self._fail(f"no global heap collection at {addr}")
            size, = struct.unpack_from("<Q", b, addr + 8)
            end, q, col = addr + size, addr + 16, {}
            while q + 16 <= end:
                i, _refs, osize = struct.unpack_from("<HH4xQ", b, q)
                if i == 0:
                    break
                col[i] = bytes(b[q + 16:q + 16 + osize])
                q += 16 + _align8(osize)
            self._gcols[addr] = col
        if idx not in col:
            self._fail(f"no object {idx} in the global heap at {addr}")
        return col[idx]

    def read(self, ds: Dataset) -> np.ndarray:
        raw_dt = _raw_dtype(ds.dtype)
        n = math.prod(ds.shape)
        kind = ds._layout[0]
        if kind == "compact":
            raw = np.frombuffer(ds._layout[1], raw_dt, n).reshape(ds.shape)
        elif kind == "contiguous":
            addr = ds._layout[1]
            if addr == UNDEF or n == 0:
                raw = np.zeros(ds.shape, raw_dt)
            else:
                raw = np.frombuffer(self.buf, raw_dt, n, addr
                                    ).reshape(ds.shape)
        else:
            raw = self._read_chunked(ds, raw_dt)
        return self._to_memory(raw, ds.dtype)

    def _read_chunked(self, ds: Dataset, raw_dt: np.dtype) -> np.ndarray:
        _, btree, dims = ds._layout
        out = np.zeros(ds.shape, raw_dt)
        if btree == UNDEF or out.size == 0:
            return out
        rank = len(ds.shape)
        cshape = tuple(dims[:rank])
        csize = math.prod(cshape) * raw_dt.itemsize
        key_size = 8 + 8 * (rank + 1)

        def inflate(child):
            key, addr = child
            nbytes, mask = struct.unpack_from("<II", key)
            data = bytes(self.buf[addr:addr + nbytes])
            for i, (fid, cd) in reversed(list(enumerate(ds._filters))):
                if mask & (1 << i):
                    continue
                if fid == FILTER_DEFLATE:
                    data = zlib.decompress(data)
                else:
                    data = _unshuffle(data, cd[0])
            return struct.unpack_from(f"<{rank}Q", key, 8), addr, data

        for offs, addr, data in _ordered_map(inflate, list(
                self._btree_children(btree, 1, key_size))):
            if len(data) != csize:
                self._fail(f"{ds.name}: chunk at {addr} holds {len(data)} "
                           f"bytes, not {csize}")
            chunk = np.frombuffer(data, raw_dt).reshape(cshape)
            sel = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, cshape, ds.shape))
            out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out


def _check_fill(body, name: str):
    """Storage not written reads as zeros: refuse a fill value message
    (version 1 or 2) that defines a fill value other than zeros."""
    if body[0] not in (1, 2):
        raise NotImplementedError(f"{name}: fill value message version "
                                  f"{body[0]}")
    if body[3]:
        size, = struct.unpack_from("<I", body, 4)
        if any(body[8:8 + size]):
            raise NotImplementedError(f"{name}: a fill value other than 0")


# ================================================================ writing
class _Writer:
    """Writes data blocks as datasets are created and the metadata (object
    headers, group tables, the superblock) when the file is closed."""

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "wb")
        self.eof = 0
        self._gcol: list | None = None     # [addr, size, objects, used]
        self.append(bytes(96))              # superblock, written last

    def append(self, data: bytes) -> int:
        addr = self.eof
        data = _pad8(data)
        self.fh.write(data)
        self.eof += len(data)
        return addr

    # ------------------------------------------------- global heap
    def vlen(self, payload: bytes) -> tuple[int, int, int]:
        """Put `payload` in a global heap collection: (length, collection
        address, index)."""
        need = 16 + _align8(len(payload))
        g = self._gcol
        if g is None or g[3] + need > g[1]:
            self._flush_gcol()
            size = max(GCOL_MIN, 16 + need)
            g = self._gcol = [self.append(bytes(size)), size, [], 16]
        g[2].append(payload)
        g[3] += need
        return len(payload), g[0], len(g[2])

    def _flush_gcol(self):
        if self._gcol is None:
            return
        addr, size, objs, used = self._gcol
        out = [b"GCOL", struct.pack("<B3xQ", 1, size)]
        for i, payload in enumerate(objs, 1):
            out.append(struct.pack("<HH4xQ", i, 0, len(payload)))
            out.append(_pad8(payload))
        if size - used >= 16:                # the free-space object
            out.append(struct.pack("<HH4xQ", 0, 0, size - used))
        blob = b"".join(out)
        self.fh.seek(addr)
        self.fh.write(blob)
        self.fh.seek(self.eof)
        self._gcol = None

    def _raw(self, arr: np.ndarray) -> np.ndarray:
        """`arr` as it lies on disk: little-endian, strings' heap IDs."""
        if arr.dtype.kind != "O":
            return np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
        raw = np.empty(arr.shape, _VLEN_RAW)
        flat = raw.reshape(-1)
        for i, v in enumerate(arr.reshape(-1).tolist()):
            if isinstance(v, str):
                v = v.encode("utf-8", "surrogateescape")
            elif not isinstance(v, bytes):
                raise TypeError(f"variable-length string element {v!r}")
            flat[i] = self.vlen(v)
        return raw

    # ----------------------------------------------------- datasets
    def dataset(self, file: File, name: str, arr: np.ndarray, chunks,
                compression, level, shuffle) -> Dataset:
        dtype = arr.dtype
        if dtype.kind == "O":
            _vlen_kind(dtype)
        else:
            dtype = dtype.newbyteorder("=")
        type_msg = _encode_dtype(dtype)
        shape = arr.shape
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r}: only gzip")
        if compression is None and level is not None:
            raise TypeError("compression_opts without compression")
        if compression == "gzip":
            level = DEFAULT_GZIP if level is None else level
            if level not in range(10):
                raise ValueError(f"gzip level {level!r}")
        filters = []
        if shuffle:
            filters.append((FILTER_SHUFFLE,
                            (_raw_dtype(dtype).itemsize,)))
        if compression:
            filters.append((FILTER_DEFLATE, (level,)))
        if not shape and (filters or chunks is not None):
            raise TypeError("scalar datasets take no chunks or filters")
        if chunks is True or (chunks is None and filters):
            chunks = guess_chunk(shape, dtype.itemsize)
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(shape) or min(chunks) < 1:
                raise ValueError(f"chunks {chunks} for shape {shape}")
        ds = Dataset(file, name, shape, dtype, chunks, filters)
        raw = self._raw(arr)
        if chunks is None:
            ds._layout = ("contiguous",
                          self.append(raw.tobytes()) if raw.size else UNDEF,
                          raw.nbytes)
        else:
            ds._layout = ("chunked", self._write_chunks(raw, chunks, filters),
                          chunks + (raw.itemsize,))
        ds._type_msg = type_msg
        return ds

    def _write_chunks(self, raw: np.ndarray, chunks: tuple,
                      filters: list) -> int:
        """Every chunk of `raw`, edge chunks padded to the full chunk shape
        with zeros, shuffled and deflated; the address of the B-tree over
        them (UNDEF when there is none)."""
        if raw.size == 0:
            return UNDEF
        grid = [-(-s // c) for s, c in zip(raw.shape, chunks)]
        entries = []

        def deflate(idx):
            offs = tuple(i * c for i, c in zip(idx, chunks))
            block = raw[tuple(slice(o, o + c) for o, c in zip(offs, chunks))]
            if block.shape != chunks:
                full = np.zeros(chunks, raw.dtype)
                full[tuple(slice(0, s) for s in block.shape)] = block
                block = full
            data = block.tobytes()
            for fid, cd in filters:
                data = _shuffle(data, cd[0]) if fid == FILTER_SHUFFLE \
                    else zlib.compress(data, cd[0])
            return offs, data

        for offs, data in _ordered_map(deflate, list(np.ndindex(*grid))):
            key = struct.pack(f"<II{len(offs) + 1}Q", len(data), 0, *offs, 0)
            entries.append((key, self.append(data)))
        # the right key of the last chunk, as the library writes it: the
        # last chunk's offsets, one chunk further in every dimension but
        # the first (the element dimension included)
        offs = struct.unpack_from(f"<{raw.ndim}Q", entries[-1][0], 8)
        final = struct.pack(f"<II{raw.ndim + 1}Q", 0, 0, offs[0],
                            *(o + c for o, c in zip(offs[1:], chunks[1:])),
                            raw.itemsize)
        return self._btree(1, entries, final, 2 * CHUNK_K)

    def _btree(self, ntype: int, entries: list, final: bytes,
               two_k: int) -> int:
        """Version-1 B-tree nodes over `entries` ((left key, child
        address) in key order, `final` the right key of the last), level by
        level, 2K children a node, siblings linked; the root's address."""
        key_size = len(final)
        node_size = 24 + two_k * 8 + (two_k + 1) * key_size
        level = 0
        while True:
            groups = [entries[i:i + two_k]
                      for i in range(0, max(len(entries), 1), two_k)]
            base = self.eof
            nodes = []
            for gi, grp in enumerate(groups):
                left = base + (gi - 1) * node_size if gi else UNDEF
                right = base + (gi + 1) * node_size \
                    if gi + 1 < len(groups) else UNDEF
                rkey = groups[gi + 1][0][0] if gi + 1 < len(groups) else final
                parts = [b"TREE", struct.pack("<BBHQQ", ntype, level,
                                              len(grp), left, right)]
                for key, child in grp:
                    parts += [key, struct.pack("<Q", child)]
                parts.append(rkey)
                node = b"".join(parts)
                node += bytes(node_size - len(node))
                nodes.append((grp[0][0] if grp else final, self.append(node)))
            if len(nodes) == 1:
                return nodes[0][1]
            entries, level = nodes, level + 1

    # ----------------------------------------------------- metadata
    def _attr_msgs(self, attrs: AttributeManager) -> list:
        out = []
        for name in attrs:
            arr = attrs._arrays[name]
            dt = arr.dtype if arr.dtype.kind == "O" \
                else arr.dtype.newbyteorder("=")
            name_b = name.encode("utf-8") + b"\0"
            dtm, spm = _encode_dtype(dt), _encode_space(arr.shape)
            body = struct.pack("<BBHHH", 1, 0, len(name_b), len(dtm),
                               len(spm)) + _pad8(name_b) + _pad8(dtm) \
                + _pad8(spm) + self._raw(arr).tobytes()
            if _align8(len(body)) > 0xFFFF:
                raise ValueError(f"attribute {name!r} is larger than 64 KiB")
            out.append((MSG_ATTRIBUTE, 0, body))
        return out

    def _ohdr(self, msgs: list) -> int:
        body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), f) + _pad8(m)
                        for t, f, m in msgs)
        return self.append(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                       len(body)) + body)

    def _dataset_ohdr(self, ds: Dataset) -> int:
        chunked = ds._layout[0] == "chunked"
        # fill value message version 2 as the library writes it: allocation
        # late (contiguous) or incremental (chunked); written at allocation
        # for strings, else if set; defined, of size 0 (the default)
        fill = struct.pack("<BBBBI", 2, 3 if chunked else 2,
                           0 if ds.dtype.kind == "O" else 2, 1, 0)
        if chunked:
            _, addr, dims = ds._layout
            layout = struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims), addr,
                                 *dims)
        else:
            _, addr, size = ds._layout
            layout = struct.pack("<BBQQ", 3, 1, addr, size)
        msgs = [(MSG_DATASPACE, 0, _encode_space(ds.shape)),
                (MSG_DATATYPE, MSG_FLAG_CONSTANT, ds._type_msg),
                (MSG_FILL, MSG_FLAG_CONSTANT, fill)]
        if ds._filters:
            msgs.append((MSG_PIPELINE, MSG_FLAG_CONSTANT,
                         _encode_pipeline(ds._filters)))
        msgs.append((MSG_LAYOUT, 0, layout))
        return self._ohdr(msgs + self._attr_msgs(ds.attrs))

    def _group(self, g: Group) -> tuple[int, int, int]:
        """Write `g` and everything under it: (object header, B-tree,
        local heap) addresses."""
        names = sorted(g._children, key=lambda k: k.encode())
        entries = []
        for k in names:
            child = g._children[k]
            if isinstance(child, Group):
                oh, bt, hp = self._group(child)
                entries.append((k, oh, struct.pack("<IIQQ", 1, 0, bt, hp)))
            else:
                entries.append((k, self._dataset_ohdr(child), bytes(24)))
        heap, offsets = bytearray(8), []
        for k, _, _ in entries:
            offsets.append(len(heap))
            heap += _pad8(k.encode("utf-8", "surrogateescape") + b"\0")
        two_k = 2 * GROUP_LEAF_K
        snods = []
        for i in range(0, len(entries), two_k):
            part = entries[i:i + two_k]
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQ", offsets[i + j], oh) + scratch
                for j, (_, oh, scratch) in enumerate(part))
            node += bytes(8 + two_k * 40 - len(node))
            last = struct.pack("<Q", offsets[i + len(part) - 1])
            left = snods[-1][2] if snods else struct.pack("<Q", 0)
            snods.append((left, self.append(node), last))
        btree = self._btree(0, [(left, addr) for left, addr, _ in snods],
                            snods[-1][2] if snods else struct.pack("<Q", 0),
                            2 * GROUP_INTERNAL_K)
        hp = self.append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap),
                                               HEAP_FREE_NULL,
                                               self.eof + 32) + bytes(heap))
        stab = struct.pack("<QQ", btree, hp)
        oh = self._ohdr([(MSG_SYMBOL_TABLE, 0, stab)]
                        + self._attr_msgs(g.attrs))
        return oh, btree, hp

    def finish(self, root: File):
        try:
            oh, btree, heap = self._group(root)
            self._flush_gcol()
            sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) \
                + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0) \
                + struct.pack("<QQQQ", 0, UNDEF, self.eof, UNDEF) \
                + struct.pack("<QQIIQQ", 0, oh, 1, 0, btree, heap)
            self.fh.seek(0)
            self.fh.write(sb)
        finally:
            self.fh.close()
