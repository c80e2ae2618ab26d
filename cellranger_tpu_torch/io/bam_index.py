"""BAI index writer for our BGZF BAM output (the `samtools index` role in
WRITE_POS_BAM, write_pos_bam.rs:65-101, without the subprocess).

BAI format (SAM spec §5.2): per reference, binning index (bins of R-tree
levels over [0, 2^29), each bin a list of (chunk_beg, chunk_end) virtual
offsets) + linear index (16kb windows -> smallest virtual offset).
Virtual offset = (BGZF block file offset << 16) | offset within block.

To produce exact virtual offsets the writer records them per record, so
indexing happens during the position-sorted write (io.bam.BamWriter
coordination) rather than by re-parsing.

Verbatim copy of cellranger_tpu/io/bam_index.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import struct

from .bam import BamWriter, _reg2bin


class IndexingBamWriter(BamWriter):
    """BamWriter that tracks virtual offsets and emits a .bai alongside."""

    def __init__(self, path: str, ref_names, ref_lens, extra_header: str = ""):
        self._vpath = path + ".bai"
        self._records = []       # (ref_id, pos, end, voff_start, voff_end)
        self._flushed_blocks = 0  # file offset of the next block to write
        super().__init__(path, ref_names, ref_lens, extra_header)
        self._n_ref = len(ref_names)

    # --- virtual offset tracking: BamWriter flushes in 60000-byte chunks ---
    def _write(self, data: bytes):
        super()._write(data)

    def _voffset(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._file_offset() << 16) | (len(self._buf) & 0xFFFF)

    def _file_offset(self) -> int:
        return self._f.tell()

    def write_raw(self, raw: bytes):
        """Append one already-encoded record (no block-size prefix),
        tracking its virtual offsets for the index."""
        import struct as _struct
        start = self._voffset()
        self._write(_struct.pack("<i", len(raw)) + raw)
        end = self._voffset()
        ref_id, pos = _struct.unpack_from("<ii", raw, 0)
        if ref_id >= 0:
            l_rn = raw[8]
            n_cig = _struct.unpack_from("<H", raw, 12)[0]
            rlen = 0
            for k in range(n_cig):
                v = _struct.unpack_from("<I", raw, 32 + l_rn + 4 * k)[0]
                if (v & 0xF) in (0, 2, 3):
                    rlen += v >> 4
            self._records.append((ref_id, pos, pos + (rlen or 1), start, end))

    def write_record(self, name, flag, ref_id, pos, mapq, cigar, seq, qual,
                     tags, next_ref=-1, next_pos=-1, tlen=0):
        start = self._voffset()
        super().write_record(name, flag, ref_id, pos, mapq, cigar, seq, qual,
                             tags, next_ref, next_pos, tlen)
        end = self._voffset()
        if ref_id >= 0:
            rlen = sum(l for l, op in cigar if op in (0, 2, 3)) or 1
            self._records.append((ref_id, pos, pos + rlen, start, end))

    def close(self):
        super().close()
        self._write_bai()

    def _write_bai(self):
        # group records per reference into bins + linear index
        per_ref = {}
        for ref_id, pos, end, vs, ve in self._records:
            bins, linear = per_ref.setdefault(ref_id, ({}, {}))
            b = _reg2bin(pos, end)
            bins.setdefault(b, []).append((vs, ve))
            for w in range(pos >> 14, ((end - 1) >> 14) + 1):
                if w not in linear or vs < linear[w]:
                    linear[w] = vs
        out = [b"BAI\x01", struct.pack("<i", self._n_ref)]
        for r in range(self._n_ref):
            bins, linear = per_ref.get(r, ({}, {}))
            out.append(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = _merge_chunks(bins[b])
                out.append(struct.pack("<I", b))
                out.append(struct.pack("<i", len(chunks)))
                for vs, ve in chunks:
                    out.append(struct.pack("<QQ", vs, ve))
            if linear:
                n_win = max(linear) + 1
                out.append(struct.pack("<i", n_win))
                filled = []
                last = 0
                for w in range(n_win):
                    last = linear.get(w, last)
                    filled.append(last)
                out.append(struct.pack(f"<{n_win}Q", *filled))
            else:
                out.append(struct.pack("<i", 0))
        with open(self._vpath, "wb") as f:
            f.write(b"".join(out))


def _merge_chunks(chunks):
    """Adjacent record chunks coalesce (standard BAI optimization)."""
    chunks = sorted(chunks)
    out = [list(chunks[0])]
    for vs, ve in chunks[1:]:
        if vs <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ve)
        else:
            out.append([vs, ve])
    return [tuple(c) for c in out]
