"""The V(D)J pipeline's native host routines (native/vdj_host.cpp),
bound via ctypes: the annotation's local alignment and the base-quality
pileup's sums.

Built at first use with g++ into the git-ignored `build/native/` beside
the FASTQ reader's library, and rebuilt when the hash of its source and
flags changes (the stamp scheme of native/__init__.py).  Unlike the FASTQ
reader, which has a Python fallback, a failed build or load raises: the
V(D)J pipeline has no other version of these on its path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from . import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "vdj_host.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libvdj_host.so")
_FLAGS = ["-O2", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _build(digest: str) -> None:
    """Compile the library under BUILD_DIR; raises with the compiler's
    output when g++ fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                         capture_output=True, text=True, timeout=120)
    if res.returncode:
        raise RuntimeError(f"g++ failed to build {_SRC}: {res.stderr}")
    os.replace(tmp, _LIB_PATH)
    with open(_LIB_PATH + ".sha256", "w") as f:
        f.write(digest)


def get_lib():
    """The loaded library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = _digest()
        try:
            with open(_LIB_PATH + ".sha256") as f:
                fresh = f.read().strip() == digest
        except OSError:
            fresh = False
        if not (fresh and os.path.exists(_LIB_PATH)):
            _build(digest)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.crt_local_align.restype = ctypes.c_int
        lib.crt_local_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.crt_pileup_sums.restype = None
        lib.crt_pileup_sums.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def local_align(a: str, b: str, match=2, mismatch=-2, gap=-3):
    """vdj/annotate.py `local_align`: (score, a_start, a_end, b_start,
    b_end) of the best local alignment of a and b."""
    lib = get_lib()
    ab, bb = a.encode("ascii"), b.encode("ascii")
    out = (ctypes.c_int32 * 5)()
    if lib.crt_local_align(ab, len(ab), bb, len(bb), match, mismatch, gap,
                           out):
        raise MemoryError(f"local_align: no room for a {len(ab) + 1} x "
                          f"{len(bb) + 1} score matrix")
    return tuple(int(x) for x in out)


def pileup_sums(obs: np.ndarray, group: np.ndarray, n_groups: int,
                terms: np.ndarray) -> np.ndarray:
    """[n_groups, 4]: per group and base b, the sum of terms[b, obs[i]]
    over the observations i of the group, added in order onto 0.0."""
    obs = np.ascontiguousarray(obs, np.int16)
    group = np.ascontiguousarray(group, np.int64)
    terms = np.ascontiguousarray(terms, np.float64)
    if (terms.ndim != 2 or terms.shape[0] != 4 or len(obs) != len(group)
            or (len(obs) and not (0 <= obs.min() and obs.max() < terms.shape[1]
                                  and 0 <= group.min()
                                  and group.max() < n_groups))):
        raise ValueError("pileup_sums: observations out of range")
    out = np.zeros((n_groups, 4))
    get_lib().crt_pileup_sums(obs.ctypes.data, group.ctypes.data, len(obs),
                              terms.ctypes.data, terms.shape[1],
                              out.ctypes.data)
    return out
