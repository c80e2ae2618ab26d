"""Barcode-filtered BAM copy — the per-sample BAM of multi
(mro/rna/_basic_sc_rna_counter.mro:258-276 MULTI_WRITE_PER_SAMPLE_BAM):
stream the run-level position-sorted BAM and copy the raw record bytes of
reads whose CB tag belongs to one sample, preserving sort order, so each
demuxed sample gets its own indexed BAM without re-encoding records.

Verbatim copy of cellranger_tpu/io/bam_filter.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import struct

from .bam_index import IndexingBamWriter

_TAG_SIZES = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
              "f": 4}


def _find_cb(raw: bytes) -> str | None:
    """Walk a raw BAM record's aux tags and return the CB:Z value."""
    l_rn = raw[8]
    n_cig = struct.unpack_from("<H", raw, 12)[0]
    l_seq = struct.unpack_from("<i", raw, 16)[0]
    o = 32 + l_rn + 4 * n_cig + (l_seq + 1) // 2 + l_seq
    while o < len(raw):
        tag = raw[o:o + 2]
        tc = chr(raw[o + 2])
        o += 3
        if tc == "Z" or tc == "H":
            z = raw.index(b"\x00", o)
            if tag == b"CB":
                return raw[o:z].decode()
            o = z + 1
        elif tc == "B":
            sub = chr(raw[o])
            cnt = struct.unpack_from("<I", raw, o + 1)[0]
            o += 5 + _TAG_SIZES[sub] * cnt
        else:
            o += _TAG_SIZES[tc]
    return None


def iter_raw_records(path: str):
    """Yield (refs, text) once, then each raw record's bytes (no block
    size prefix) from a BAM file.  Streams BGZF blocks through a
    sequential gzip reader (multi-member) — peak RAM is one record, not
    the decompressed file."""
    with gzip.open(path, "rb") as f:
        def need(n: int) -> bytes:
            b = f.read(n)
            if len(b) != n:
                raise EOFError("truncated BAM")
            return b

        assert need(4) == b"BAM\x01"
        l_text = struct.unpack("<i", need(4))[0]
        text = need(l_text).decode()
        n_ref = struct.unpack("<i", need(4))[0]
        refs = []
        for _ in range(n_ref):
            ln = struct.unpack("<i", need(4))[0]
            name = need(ln)[:-1].decode()
            rlen = struct.unpack("<i", need(4))[0]
            refs.append((name, rlen))
        yield refs, text
        while True:
            hd = f.read(4)
            if len(hd) < 4:  # EOF (a BGZF EOF block yields b"")
                return
            sz = struct.unpack("<i", hd)[0]
            yield need(sz)


def filter_bam_by_cb(src: str, dst: str, barcodes: set[str],
                     read_group: str | None = None) -> int:
    """Copy records whose CB is in `barcodes` into an indexed BAM at dst.
    Returns the number of records written."""
    it = iter_raw_records(src)
    refs, _text = next(it)
    rg = f"@RG\tID:{read_group}\tSM:{read_group}\n" if read_group else ""
    w = IndexingBamWriter(dst, [n for n, _ in refs],
                          [l for _, l in refs], extra_header=rg)
    n = 0
    for raw in it:
        cb = _find_cb(raw)
        if cb is not None and cb in barcodes:
            w.write_raw(raw)
            n += 1
    w.close()
    return n
