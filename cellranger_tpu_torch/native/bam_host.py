"""The BAM writer's record encoder (native/bam_host.cpp), bound via
ctypes: a band's records, in its sorted order, encoded into contiguous
buffers as io/bam.py BamWriter.write_record would write them, with the
tags pipeline/bam_out.py `_write_rows` gives each kind of record.

Built at first use by native/build.py; a failed build or load raises: the
BAM writer has no other version on the run's path.  ctypes releases the
interpreter lock during the call, so the writer's compression threads
run beside it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import BUILD_DIR, build
from .strings import Strings

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bam_host.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libbam_host.so")
_lock = threading.Lock()
_lib = None

# the band's per-record scalar columns, in bam_host.cpp's enum order;
# corr_umi, low_sup and win_idx are computed by the writer, the rest are
# the spooled columns
SCALAR_COLUMNS = (
    "rna_len", "strand", "bc_packed", "umi_packed", "corrected_bc", "bc_ok",
    "is_feature", "conf_ok", "umi_valid", "pair_flag", "mate_chrom",
    "mate_gpos", "tlen", "mapped", "secondary", "g_chrom", "g_gpos",
    "aln_len", "aln_start", "mapq", "g_spliced", "g_intron_len",
    "g_donor_off", "novel_sj", "sj_donor", "sj_acceptor", "sj_right_len",
    "gene", "region", "mm", "gene_discordant", "gene_unpaired", "umi_rep",
    "corr_umi", "low_sup", "win_idx")
_CODES = {np.dtype(np.uint8): 0, np.dtype(bool): 0, np.dtype(np.int8): 1,
          np.dtype(np.int16): 2, np.dtype(np.uint16): 3,
          np.dtype(np.int32): 4, np.dtype(np.uint32): 5,
          np.dtype(np.int64): 6, np.dtype(np.uint64): 7}
_ERRORS = {-1: "a base code above 4 where the mask marks a base",
           -2: "a read length outside its sequence planes",
           -3: "a value that does not fit its BAM field",
           -4: "a gene index outside the gene table",
           -5: "a region code other than 0, 1, 2",
           -6: "a column of a dtype the encoder does not read"}
BUFFER_BYTES = 32 << 20     # one encoder call's buffer
SLICE_RECORDS = 1 << 16     # records a thread encodes at a time


class _Col(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("code", ctypes.c_int64)]


class _Mat(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("code", ctypes.c_int64),
                ("width", ctypes.c_int64)]


class _Str(ctypes.Structure):
    _fields_ = [("buf", ctypes.c_void_p), ("off", ctypes.c_void_p)]


class _Band(ctypes.Structure):
    _fields_ = ([("col", _Col * len(SCALAR_COLUMNS))]
                + [(k, _Mat) for k in ("rna", "nmask", "rna_qual", "bc_qual",
                                       "umi_qual", "gene_list", "anti_list")]
                + [(k, _Str) for k in ("names", "fr", "fq", "fb", "fx",
                                       "read_group", "gem_suffix")]
                + [(k, ctypes.c_int64) for k in ("bc_len", "umi_len",
                                                 "n_genes")]
                + [("gene_ids", _Str), ("gene_names", _Str),
                   ("gene_tx", ctypes.c_void_p), ("tx_ids", _Str)]
                + [(k, ctypes.c_void_p) for k in (
                    "tx_chrom", "tx_rev", "tx_len", "tx_exon", "ex_start",
                    "ex_end", "ex_cum", "win_umi", "win_ntxo")]
                + [("win_name", _Str)])


def get_lib():
    """The loaded library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(_SRC, _LIB_PATH, BUILD_DIR)
        lib.crt_bam_n_cols.restype = ctypes.c_int64
        lib.crt_bam_n_cols.argtypes = []
        if lib.crt_bam_n_cols() != len(SCALAR_COLUMNS):
            raise RuntimeError(f"{_LIB_PATH} reads another column list")
        lib.crt_bam_encode.restype = ctypes.c_int64
        lib.crt_bam_encode.argtypes = [
            ctypes.POINTER(_Band), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def _utf8(items) -> list[bytes]:
    return [x.encode() if isinstance(x, str) else bytes(x) for x in items]


class Band:
    """The native encoder's view of one band: numpy arrays it reads in
    place (this object keeps them alive while the encoder may use them)."""

    def __init__(self):
        self.s = _Band()
        self._keep: list = []

    def _arr(self, a, dtype=None) -> int:
        a = np.ascontiguousarray(a, dtype)
        self._keep.append(a)
        return a.ctypes.data

    def col(self, k: int, a: np.ndarray):
        a = np.ascontiguousarray(a)
        if a.dtype not in _CODES:
            raise TypeError(f"BAM column {SCALAR_COLUMNS[k]} has dtype "
                            f"{a.dtype}")
        self.s.col[k] = _Col(self._arr(a), _CODES[a.dtype])

    def mat(self, name: str, a: np.ndarray, one_byte: bool = False):
        """A 2-D plane; one_byte: read as its bytes (uint8)."""
        a = np.ascontiguousarray(a)
        if one_byte and a.dtype.itemsize == 1:
            a = a.view(np.uint8)
        if a.dtype not in _CODES or (one_byte and a.dtype != np.uint8):
            raise TypeError(f"BAM plane {name} has dtype {a.dtype}")
        setattr(self.s, name, _Mat(self._arr(a), _CODES[a.dtype],
                                   a.shape[1]))

    def strings(self, name: str, items):
        """items: bytes of each row (a list, or native/strings.py's
        Strings), as one buffer plus offsets."""
        items = Strings.of(items)
        setattr(self.s, name, _Str(self._arr(items.buf, np.uint8),
                                   self._arr(items.off, np.int64)))

    def ints(self, name: str, a):
        setattr(self.s, name, self._arr(a, np.int64))


def run_tables(read_group: str, gem_group: int, bc_len: int, umi_len: int,
               gene_ids, gene_names, gene_txs: dict) -> Band:
    """The fields of every band of one run: tags, the gene and transcript
    tables of TX/AN (bam_out.py `_build_tx_tables`)."""
    t = Band()
    t.strings("read_group", [read_group.encode()])
    t.strings("gem_suffix", [b"-%d" % gem_group])
    t.s.bc_len, t.s.umi_len, t.s.n_genes = bc_len, umi_len, len(gene_ids)
    t.strings("gene_ids", _utf8(gene_ids))
    t.strings("gene_names", _utf8(gene_names))
    txs = [gene_txs.get(g, ()) for g in range(len(gene_ids))]
    flat = [rec for recs in txs for rec in recs]
    t.ints("gene_tx", np.r_[0, np.cumsum([len(r) for r in txs])])
    t.strings("tx_ids", [str(rec[0]).encode() for rec in flat])
    t.ints("tx_chrom", [rec[1] for rec in flat])
    t.ints("tx_rev", [rec[2] for rec in flat])
    t.ints("tx_len", [rec[6] for rec in flat])
    t.ints("tx_exon", np.r_[0, np.cumsum([len(rec[3]) for rec in flat])])
    for name, k in (("ex_start", 3), ("ex_end", 4), ("ex_cum", 5)):
        t.ints(name, np.concatenate(
            [np.asarray(rec[k], np.int64)[:len(rec[3])] for rec in flat]
            + [np.zeros(0, np.int64)]))
    return t


def _encode(lib, b: Band, order: np.ndarray) -> list:
    """The records `order` of band b in buffers of BUFFER_BYTES (more
    where one record needs it): [(buf, rec_end, ref, pos, end)]."""
    parts = []
    err = ctypes.c_int64(-1)
    done, cap = 0, BUFFER_BYTES
    while done < len(order):
        m = min(len(order) - done, cap // 36 + 1)   # a record >= 36 bytes
        out = np.empty(cap, np.uint8)
        rec_end, ref, pos, end = (np.empty(m, np.int64) for _ in range(4))
        k = lib.crt_bam_encode(
            ctypes.byref(b.s), order[done:].ctypes.data, m, out.ctypes.data,
            cap, rec_end.ctypes.data, ref.ctypes.data, pos.ctypes.data,
            end.ctypes.data, ctypes.byref(err))
        if k < 0:
            raise ValueError(f"BAM record of spooled row {err.value}: "
                             f"{_ERRORS.get(k, k)}")
        if k == 0:
            cap *= 2
            continue
        parts.append((out[:rec_end[k - 1]], rec_end[:k], ref[:k], pos[:k],
                      end[:k]))
        done += k
    return parts


def encode_band(tables: Band, cat: dict, corr_umi, low_sup, win_idx,
                order: np.ndarray, threads: int, winners: tuple):
    """Yields (buf, rec_end, ref, pos, end), in order, for the records
    order[...] of the band `cat` (bam_out.py's spooled columns): slices of
    at most SLICE_RECORDS records, at least one a thread, encoded on
    `threads` threads, a few slices ahead of the consumer.  winners:
    the (raw UMI, not_txomic, qname) rows that win_idx points into
    (bam_out.py `_band_winners`)."""
    lib = get_lib()
    b = Band()
    b.s = _Band.from_buffer_copy(tables.s)
    b._keep = [tables]
    um, ntxo, names = winners
    b.ints("win_umi", um)
    b.ints("win_ntxo", ntxo)
    b.strings("win_name", names)
    cols = dict(cat, corr_umi=corr_umi, low_sup=low_sup, win_idx=win_idx)
    for k, name in enumerate(SCALAR_COLUMNS):
        b.col(k, cols[name])
    rna = np.asarray(cat["rna"])
    nmask = np.asarray(cat["nmask"])
    # ops/encode.py decode_codes: codes as uint8, the mask as bool
    b.mat("rna", rna if rna.dtype == np.uint8 else rna.astype(np.uint8),
          one_byte=True)
    b.mat("nmask", nmask if nmask.dtype == bool else nmask.astype(bool),
          one_byte=True)
    for name in ("rna_qual", "bc_qual", "umi_qual"):
        b.mat(name, cat[name], one_byte=True)
    b.mat("gene_list", cat["gene_list"])
    b.mat("anti_list", cat["anti_list"])
    for name in ("names", "fr", "fq", "fb", "fx"):
        b.strings(name, cat[name])
    order = np.ascontiguousarray(order, np.int64)
    # a small band still spreads over every thread
    step = max(1024, min(SLICE_RECORDS, -(-len(order) // threads)))
    slices = [order[i:i + step] for i in range(0, len(order), step)]
    with ThreadPoolExecutor(threads) as pool:
        ahead: deque = deque()
        for sl in slices:
            ahead.append(pool.submit(_encode, lib, b, sl))
            if len(ahead) > 2 * threads:
                yield from ahead.popleft().result()
        while ahead:
            yield from ahead.popleft().result()
