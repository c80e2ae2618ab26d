"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` compiles with nvcc for sm_90a into one shared library
with a plain C interface (`build/kernels/libcrt_kernels.so`, beside the
package), loaded through ctypes.  The build runs at first use and again
whenever the sources change: a stamp file next to the library holds the
hash of the sources and flags it was built from.  Nothing here runs at
import time; a machine without nvcc can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_NAME = "libcrt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nvcc's output of the build this process made (ptxas -v: registers, shared
# memory and spills of every kernel); empty when the library was up to date
BUILD_LOG = ""

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only on a machine with the "
                           "CUDA toolkit")
    return found


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; returns
    the library path.  Raises with nvcc's output if the build fails."""
    global BUILD_LOG
    srcs = _sources()
    digest = _digest(srcs)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    try:
        with open(stamp) as f:
            if f.read().strip() == digest and os.path.exists(lib_path):
                return lib_path
    except OSError:
        pass
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    BUILD_LOG = res.stdout + res.stderr
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.crt_banded_sw.argtypes = [p, p, p, p, i, i, p, p, p, p]
            lib.crt_banded_sw.restype = ctypes.c_int
            _lib = lib
        return _lib
