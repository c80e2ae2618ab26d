"""2-bit nucleotide encoding, host (numpy) and device (torch) variants.

Design notes (TPU-first):
  * Bases are encoded A=0, C=1, G=2, T=3 and packed MSB-first so that the
    packed integer order equals byte-wise lexicographic order of the ACGT
    string. The reference relies on lexicographic sequence comparisons for
    deterministic tie-breaking (e.g. UMI correction picks the
    lexicographically larger UMI on count ties, tx_annotation/src/
    mark_dups.rs:44), so order preservation lets us compare packed u32s.
  * A 16bp barcode packs into a uint32; UMIs up to 16bp pack into a uint32
    (molecule_info.h5 stores UMIs 2-bit packed in a u32 as well,
    lib/python/cellranger/molecule_counter.py:90-104).
  * 'N' (or any non-ACGT byte) maps to code 0 with a separate validity mask;
    device arrays are fixed-shape [B, L] uint8 code planes + masks.
"""

from __future__ import annotations

import numpy as np
import torch

# ASCII -> 2-bit code lookup (host). Non-ACGT -> 4 (invalid sentinel).
_ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ASCII_TO_CODE[b] = i
    _ASCII_TO_CODE[ord(chr(b).lower())] = i
_CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


def encode_seqs(seqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ASCII uint8 array [..., L] -> (codes uint8 in 0..3, valid bool mask)."""
    codes = _ASCII_TO_CODE[seqs]
    valid = codes < 4
    return np.where(valid, codes, 0).astype(np.uint8), valid


def encode_str(seq: str | bytes) -> tuple[np.ndarray, np.ndarray]:
    """Single sequence string -> (codes uint8 [L], valid mask [L])."""
    if isinstance(seq, str):
        seq = seq.encode()
    return encode_seqs(np.frombuffer(seq, dtype=np.uint8))


def decode_codes(codes: np.ndarray, valid: np.ndarray | None = None) -> bytes:
    """codes uint8 [L] (+ optional valid mask) -> ACGTN bytes."""
    c = np.asarray(codes, dtype=np.uint8).copy()
    if valid is not None:
        c[~np.asarray(valid, bool)] = 4
    return _CODE_TO_ASCII[c].tobytes()


def pack_codes_np(codes: np.ndarray, length: int) -> np.ndarray:
    """Host: pack [..., length] 2-bit codes MSB-first into uint32 (length<=16)
    or uint64 (length<=32)."""
    assert length <= 32
    dtype = np.uint32 if length <= 16 else np.uint64
    out = np.zeros(codes.shape[:-1], dtype=dtype)
    for i in range(length):
        out = (out << np.uint8(2)) | codes[..., i].astype(dtype)
    return out


def unpack_np(packed: np.ndarray, length: int) -> np.ndarray:
    """Host: uint packed -> [..., length] codes, MSB-first."""
    packed = np.asarray(packed)
    shifts = np.arange(length - 1, -1, -1, dtype=np.uint64) * 2
    return ((packed[..., None].astype(np.uint64) >> shifts) & 3).astype(np.uint8)


def pack_str(seq: str | bytes) -> int:
    codes, valid = encode_str(seq)
    assert valid.all(), f"non-ACGT base in {seq!r}"
    return int(pack_codes_np(codes, len(codes)))


def unpack_str(packed: int, length: int) -> str:
    return decode_codes(unpack_np(np.uint64(packed), length)).decode()


def pack_codes(codes: torch.Tensor, length: int) -> torch.Tensor:
    """Device: pack [..., length] uint8 codes MSB-first into u32 values
    carried in int64 (length <= 16)."""
    assert length <= 16
    out = torch.zeros(codes.shape[:-1], dtype=torch.int64, device=codes.device)
    for i in range(length):
        out = (out << 2) | codes[..., i].to(torch.int64)
    return out


def unpack_codes(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device: u32 values [...] -> uint8 codes [..., length] MSB-first."""
    shifts = torch.arange(length - 1, -1, -1, dtype=torch.int64,
                          device=packed.device) * 2
    return ((packed.to(torch.int64)[..., None] >> shifts) & 3).to(torch.uint8)


def revcomp_codes_np(codes: np.ndarray) -> np.ndarray:
    """Host reverse complement in code space: comp(x) = 3 - x, then reverse."""
    return (3 - codes[..., ::-1]).astype(np.uint8)


def revcomp_packed(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device reverse-complement of packed kmers (u32 values in int64;
    complement = bitwise NOT in 2-bit space, then reverse the groups)."""
    x = (~packed.to(torch.int64)) & ((1 << (2 * length)) - 1)
    out = torch.zeros_like(x)
    for i in range(length):
        out = out | (((x >> (2 * i)) & 3) << (2 * (length - 1 - i)))
    return out


def sorted_search(table: np.ndarray, keys: np.ndarray,
                  side: str = "left") -> np.ndarray:
    """np.searchsorted(table, keys, side), the keys searched in sorted
    order: a search of a large table (the 6,794,880-barcode whitelist)
    walks it once instead of missing the cache at every key."""
    keys = np.asarray(keys)
    if keys.ndim != 1 or len(keys) < 2:
        return np.searchsorted(table, keys, side)
    order = np.argsort(keys, kind="stable")
    out = np.empty(len(keys), np.int64)
    out[order] = np.searchsorted(table, keys[order], side)
    return out
