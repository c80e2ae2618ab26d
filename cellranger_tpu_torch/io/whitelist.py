"""Barcode whitelist loading and packed representation.

The reference resolves named whitelists from a barcodes folder with optional
translation files (lib/rust/barcodes_folder/src/lib.rs:12-31,
lib/rust/barcode/src/whitelist.rs:25,453). We represent a whitelist as a
*sorted* array of 2-bit-packed uint32 barcodes, which on device supports
O(log W) vectorized membership via binary search; the sort order equals
lexicographic sequence order (see ops.encode).

Copied from cellranger_tpu/io/whitelist.py, over the port's encode.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from ..ops import encode


@dataclass
class Whitelist:
    """Sorted packed whitelist (+ optional translation mapping).

    sorted_seqs: uint32 [W], sorted ascending (== lexicographic order).
    translation: uint32 [W] or None — translated barcode emitted downstream
        (whitelist.rs Plain vs WithTranslation).
    length: barcode length in bases.
    name: registry name, e.g. "737K-august-2016".
    """

    sorted_seqs: np.ndarray
    length: int
    name: str = "custom"
    translation: np.ndarray | None = None

    @property
    def size(self) -> int:
        return len(self.sorted_seqs)

    def contains(self, packed: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.sorted_seqs, packed)
        idx_c = np.minimum(idx, self.size - 1)
        return self.sorted_seqs[idx_c] == packed

    def index_of(self, packed: np.ndarray) -> np.ndarray:
        """Index into sorted_seqs, or -1 if absent."""
        idx = encode.sorted_search(self.sorted_seqs, packed)
        idx_c = np.minimum(idx, self.size - 1)
        hit = self.sorted_seqs[idx_c] == packed
        return np.where(hit, idx_c, -1)

    @staticmethod
    def from_seqs(seqs: list[str | bytes], name: str = "custom",
                  translations: list[str | bytes] | None = None) -> "Whitelist":
        length = len(seqs[0])
        codes, valid = encode.encode_seqs(
            np.frombuffer(b"".join(s.encode() if isinstance(s, str) else s for s in seqs),
                          dtype=np.uint8).reshape(len(seqs), length))
        if not valid.all():
            raise ValueError("whitelist contains non-ACGT bases")
        packed = encode.pack_codes_np(codes, length)
        order = np.argsort(packed, kind="stable")
        trans = None
        if translations is not None:
            tcodes, _ = encode.encode_seqs(
                np.frombuffer(b"".join(s.encode() if isinstance(s, str) else s
                                       for s in translations),
                              dtype=np.uint8).reshape(len(translations), length))
            trans = encode.pack_codes_np(tcodes, length)[order]
        u = packed[order]
        if len(u) > 1 and (u[1:] == u[:-1]).any():
            raise ValueError("duplicate barcodes in whitelist")
        return Whitelist(u, length, name=name, translation=trans)

    @staticmethod
    def load(path: str, name: str | None = None) -> "Whitelist":
        """Load a whitelist text file (one barcode per line; optional second
        TSV column = translated barcode; .gz supported)."""
        opener = gzip.open if path.endswith(".gz") else open
        seqs, trans = [], []
        with opener(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                seqs.append(parts[0])
                if len(parts) > 1:
                    trans.append(parts[1])
        return Whitelist.from_seqs(
            seqs, name=name or os.path.basename(path).split(".")[0],
            translations=trans if trans else None)


def resolve_named_whitelist(name: str, barcodes_dir: str | None = None) -> Whitelist:
    """Resolve a named whitelist from a barcodes directory
    (CELLRANGER_TPU_BARCODES env var or explicit path), mirroring
    barcodes_folder/src/lib.rs semantics."""
    barcodes_dir = barcodes_dir or os.environ.get("CELLRANGER_TPU_BARCODES")
    if not barcodes_dir:
        raise FileNotFoundError(
            f"whitelist {name!r}: set CELLRANGER_TPU_BARCODES to a directory "
            "containing whitelist files")
    for ext in (".txt", ".txt.gz", ""):
        p = os.path.join(barcodes_dir, name + ext)
        if os.path.exists(p):
            return Whitelist.load(p, name=name)
    raise FileNotFoundError(f"whitelist {name!r} not found in {barcodes_dir}")
