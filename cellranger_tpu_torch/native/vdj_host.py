"""The V(D)J pipeline's native host routines (native/vdj_host.cpp),
bound via ctypes: the annotation's local alignment and the base-quality
pileup's sums.

Built at first use by native/build.py; a failed build or load raises: the
V(D)J pipeline has no other version of these on its path.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import BUILD_DIR, build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "vdj_host.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libvdj_host.so")
_lock = threading.Lock()
_lib = None


def get_lib():
    """The loaded library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(_SRC, _LIB_PATH, BUILD_DIR)
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
