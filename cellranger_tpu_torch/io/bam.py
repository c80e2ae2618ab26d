"""BAM output with the 10x tag dialect.

Pure-python BGZF/BAM encoder (no htslib dependency) producing
position-sorted BAM with the reference's tag spec
(lib/rust/cr_bam/src/bam_tags.rs:3-39): CB/CR/CY corrected/raw/qual cell
barcode, UB/UR/UY UMI, GX/GN gene ids/names, RE region (E/N/I), xf extra
flags, MAPQ per STAR semantics. Spliced alignments (junction-contig hits)
are emitted as M-N-M CIGARs against genomic coordinates, matching how the
reference's BAM represents STAR spliced alignments.

Verbatim copy of cellranger_tpu/io/bam.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BAM_CMATCH = 0      # M
BAM_CREF_SKIP = 3   # N
BAM_CSOFT_CLIP = 4  # S

FLAG_PAIRED = 1
FLAG_PROPER_PAIR = 2
FLAG_UNMAPPED = 4
FLAG_MATE_UNMAPPED = 8
FLAG_REVERSE = 16
FLAG_MATE_REVERSE = 32
FLAG_FIRST_MATE = 64
FLAG_SECOND_MATE = 128
FLAG_SECONDARY = 256

# xf bitmask — exact ExtraFlags values (cr_bam/src/bam_tags.rs:41-59).
# A duplicate read is simply CONF_MAPPED without UMI_COUNT/LOW_SUPPORT.
XF_CONF_MAPPED = 1          # confidently mapped to transcriptome
XF_LOW_SUPPORT_UMI = 2      # (bc,umi,feature) discarded for a better one
XF_GENE_DISCORDANT = 4      # mates mapped to incompatible gene sets
XF_UMI_COUNT = 8            # molecule representative (counts as a UMI)
XF_CONF_FEATURE = 16        # confidently assigned feature barcode
XF_FILTERED_TARGET_UMI = 32  # dropped only by targeted read-count filter


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block (gzip member with BC extra subfield)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1))
    return (header + comp
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)))


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BamWriter:
    """Streaming BGZF BAM writer."""

    def __init__(self, path: str, ref_names: list[str], ref_lens: list[int],
                 extra_header: str = ""):
        self._f = open(path, "wb")
        self._buf = bytearray()
        header_text = "@HD\tVN:1.6\tSO:coordinate\n"
        for n, l in zip(ref_names, ref_lens):
            header_text += f"@SQ\tSN:{n}\tLN:{l}\n"
        header_text += "@PG\tID:cellranger-tpu\tPN:cellranger-tpu\tVN:0.1.0\n"
        header_text += extra_header
        ht = header_text.encode()
        blob = b"BAM\x01" + struct.pack("<i", len(ht)) + ht
        blob += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            blob += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self._write(blob)

    def _write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= 60000:
            self._f.write(_bgzf_block(bytes(self._buf[:60000])))
            del self._buf[:60000]

    def close(self):
        if self._buf:
            self._f.write(_bgzf_block(bytes(self._buf)))
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._f.close()

    def write_record(self, name: bytes, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar: list[tuple[int, int]],
                     seq: bytes, qual: bytes, tags: list[tuple[str, str, object]],
                     next_ref: int = -1, next_pos: int = -1, tlen: int = 0):
        """cigar: [(op_len, op_code)]; tags: [(tag, type_char, value)]."""
        nb = name + b"\x00"
        l_seq = len(seq)
        # 4-bit encode seq (=ACMGRSVTWYHKDBN)
        nib = [_SEQ_NIBBLE[b] for b in seq]
        if l_seq % 2:
            nib.append(0)
        packed = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
        q = bytes((min(x - 33, 93) if x >= 33 else 0xFF) for x in qual) \
            if qual else b"\xff" * l_seq
        end = pos + sum(l for l, op in cigar if op in (0, 2, 3)) if cigar else pos + 1
        bin_ = _reg2bin(pos, max(end, pos + 1))
        rec = struct.pack("<iiBBHHHiiii", ref_id, pos, len(nb), mapq, bin_,
                          len(cigar), flag, l_seq, next_ref, next_pos, tlen)
        rec += nb
        for (ln, op) in cigar:
            rec += struct.pack("<I", (ln << 4) | op)
        rec += packed + q
        for tag, tc, val in tags:
            rec += tag.encode()
            if tc == "Z":
                rec += b"Z" + (val.encode() if isinstance(val, str) else val) + b"\x00"
            elif tc == "i":
                rec += b"i" + struct.pack("<i", int(val))
            elif tc == "A":
                rec += b"A" + (val.encode() if isinstance(val, str) else val)
            else:
                raise ValueError(f"tag type {tc}")
        self._write(struct.pack("<i", len(rec)) + rec)


_SEQ_NIBBLE = {ord(c): i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
for _c in "acmgrsvtwyhkdbn":
    _SEQ_NIBBLE[ord(_c)] = _SEQ_NIBBLE[ord(_c.upper())]
_SEQ_NIBBLE.setdefault(ord("n"), 15)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0
