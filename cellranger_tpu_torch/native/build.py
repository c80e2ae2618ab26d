"""Builds the port's native host libraries (native/*.cpp) with g++ at
first use, into the git-ignored `build/native/` beside the FASTQ
reader's library, and rebuilds one when the sha256 of its source and
flags changes (the stamp scheme of native/__init__.py).  Unlike the FASTQ
reader, which has a Python fallback, these libraries have no other
version on their paths: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

FLAGS = ["-O2", "-shared", "-fPIC"]


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def load(src: str, lib_path: str, build_dir: str) -> ctypes.CDLL:
    """The library built from src at lib_path, compiled first if missing
    or stale; raises with the compiler's output when g++ fails."""
    digest = _digest(src)
    try:
        with open(lib_path + ".sha256") as f:
            fresh = f.read().strip() == digest
    except OSError:
        fresh = False
    if not (fresh and os.path.exists(lib_path)):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", *FLAGS, src, "-o", tmp],
                             capture_output=True, text=True, timeout=120)
        if res.returncode:
            raise RuntimeError(f"g++ failed to build {src}: {res.stderr}")
        os.replace(tmp, lib_path)
        with open(lib_path + ".sha256", "w") as f:
            f.write(digest)
    return ctypes.CDLL(lib_path)
