"""Native (C++) runtime components, bound via ctypes.

Compiled lazily on first use with the system toolchain (g++ -O3 -lz); when
no toolchain is available consumers fall back to pure-python paths.

Copy of cellranger_tpu/native/__init__.py with one change: the library is
built into the git-ignored `build/native/` directory beside the package
(next to `build/kernels/`), never into a package directory, and is rebuilt
when the hash of its source and flags changes (the stamp scheme of
kernels.py).  `NativeFastqReader` is verbatim.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastq_reader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libfastq_reader.so")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _up_to_date(digest: str) -> bool:
    try:
        with open(_LIB_PATH + ".sha256") as f:
            return f.read().strip() == digest and os.path.exists(_LIB_PATH)
    except OSError:
        return False


def _build(digest: str) -> bool:
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        with open(_LIB_PATH + ".sha256", "w") as f:
            f.write(digest)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        digest = _digest()
        if not _up_to_date(digest) and not _build(digest):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.fq_open.restype = ctypes.c_void_p
        lib.fq_open.argtypes = [ctypes.c_char_p]
        lib.fq_next_batch.restype = ctypes.c_int
        lib.fq_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
        lib.fq_close.argtypes = [ctypes.c_void_p]
        lib.fq_error.restype = ctypes.c_char_p
        lib.fq_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeFastqReader:
    """Batch FASTQ reader over the native library.

    read_batch(n, max_len) -> (seqs uint8 [m, max_len], quals, lens int32,
    names list[bytes] | None) with m <= n; m == 0 at EOF.
    """

    NAME_STRIDE = 64

    def __init__(self, path: str, keep_names: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastq reader unavailable")
        self._lib = lib
        self._h = lib.fq_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self._keep_names = keep_names

    def read_batch(self, n: int, max_len: int):
        seqs = np.zeros((n, max_len), np.uint8)
        quals = np.zeros((n, max_len), np.uint8)
        lens = np.zeros(n, np.int32)
        names_buf = (ctypes.create_string_buffer(n * self.NAME_STRIDE)
                     if self._keep_names else None)
        got = self._lib.fq_next_batch(
            self._h, n, max_len,
            seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            names_buf, self.NAME_STRIDE if names_buf else 0)
        if got < 0:
            raise ValueError(
                f"malformed FASTQ: {self._lib.fq_error(self._h).decode()}")
        names = None
        if self._keep_names and got:
            raw = names_buf.raw
            names = [raw[i * self.NAME_STRIDE:(i + 1) * self.NAME_STRIDE]
                     .split(b"\x00", 1)[0] for i in range(got)]
        return seqs[:got], quals[:got], lens[:got], names

    def close(self):
        if self._h:
            self._lib.fq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
