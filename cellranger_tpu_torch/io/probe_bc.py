"""RTL probe barcode (sample multiplexing) handling.

The reference models the MFRP probe barcode as a second barcode segment
(cr_types/src/chemistry/chemistry_defs.json MFRP-RNA "right_probe", 8bp on
R2) corrected against the probe-barcode whitelist, and demuxes samples by
the [samples] config's probe_barcode_ids column
(lib/rust/multi/src/config/mod.rs SamplesCsv; DEMUX_PROBE_BC_MATRIX in
mro/rna/_basic_sc_rna_counter.mro:233). Whitelist files are user-provided
(they are not shipped in the reference repo either).

Verbatim copy of cellranger_tpu/io/probe_bc.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from ..ops import encode


def load_probe_barcodes(path: str):
    """Probe barcode CSV: `id,sequence` rows (header optional) or bare
    sequences (auto-named BC001..). Returns (ids, packed uint32 [P], length).
    """
    ids, seqs = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if parts[0].lower() in ("id", "probe_barcode_id"):
                continue
            if len(parts) == 1:
                seqs.append(parts[0].upper())
                ids.append("BC%03d" % len(seqs))
            else:
                ids.append(parts[0])
                seqs.append(parts[1].upper())
    if not seqs:
        raise ValueError(f"no probe barcodes in {path}")
    lens = {len(s) for s in seqs}
    if len(lens) != 1:
        raise ValueError(f"probe barcodes must share a length, got {lens}")
    L = lens.pop()
    arr = np.frombuffer("".join(seqs).encode(), np.uint8).reshape(len(seqs), L)
    codes, valid = encode.encode_seqs(arr)
    if not valid.all():
        raise ValueError("probe barcodes must be ACGT only")
    packed = encode.pack_codes_np(codes, L)
    return ids, packed, L


def assign_probe_bcs(read_packed: np.ndarray, wl_packed: np.ndarray,
                     length: int, max_mm: int = 1):
    """Nearest-probe assignment with <=max_mm base mismatches; ties are
    invalid (no confident sample). Vectorized popcount over 2-bit packing.

    Returns (idx int32 [B] into wl (or -1), ok bool [B]).
    """
    x = read_packed[:, None] ^ wl_packed[None, :]          # [B, P]
    g = ((x >> 1) | x) & np.uint32(0x55555555)             # 1 per mismatched base
    # popcount of g (<=16 set bits)
    g = g - ((g >> 1) & np.uint32(0x55555555))
    g = (g & np.uint32(0x33333333)) + ((g >> 2) & np.uint32(0x33333333))
    mm = ((((g + (g >> 4)) & np.uint32(0x0F0F0F0F)) * np.uint32(0x01010101))
          >> 24).astype(np.int32)
    best = mm.min(axis=1)
    idx = mm.argmin(axis=1).astype(np.int32)
    n_best = (mm == best[:, None]).sum(axis=1)
    ok = (best <= max_mm) & (n_best == 1)
    return np.where(ok, idx, -1).astype(np.int32), ok
