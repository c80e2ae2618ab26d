"""Minimal BAM reader (BGZF = multi-member gzip): parses headers, records,
CIGAR, and aux tags.  Used by the conformance comparators
(cellranger_tpu/testing/correctness.py) and the test suite; the reference's
counterpart is rust_htslib::bam::Reader driven by
lib/rust/cr_lib/src/testing/correctness.rs:272.

Verbatim copy of cellranger_tpu/io/bam_read.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

import gzip
import struct

CIGAR_OPS = "MIDNSHP=X"
SEQ_CHARS = "=ACMGRSVTWYHKDBN"


def read_bam(path):
    """Returns (refs [(name, len)], records [dict])."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"BAM\x01", "bad magic"
    off = 4
    l_text = struct.unpack_from("<i", data, off)[0]; off += 4
    text = data[off:off + l_text].decode(); off += l_text
    n_ref = struct.unpack_from("<i", data, off)[0]; off += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", data, off)[0]; off += 4
        name = data[off:off + ln - 1].decode(); off += ln
        rlen = struct.unpack_from("<i", data, off)[0]; off += 4
        refs.append((name, rlen))
    records = []
    while off < len(data):
        block_size = struct.unpack_from("<i", data, off)[0]; off += 4
        end = off + block_size
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
         _nr, _np, _tl) = struct.unpack_from("<iiBBHHHiiii", data, off)
        o = off + 32
        name = data[o:o + l_rn - 1]; o += l_rn
        cigar = []
        for _ in range(n_cig):
            v = struct.unpack_from("<I", data, o)[0]; o += 4
            cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
        nbytes = (l_seq + 1) // 2
        seq = ""
        for i in range(l_seq):
            b = data[o + i // 2]
            seq += SEQ_CHARS[(b >> 4) if i % 2 == 0 else (b & 0xF)]
        o += nbytes
        qual = data[o:o + l_seq]; o += l_seq
        tags = {}
        while o < end:
            tag = data[o:o + 2].decode(); tc = chr(data[o + 2]); o += 3
            if tc == "Z":
                z = data.index(b"\x00", o)
                tags[tag] = data[o:z].decode(); o = z + 1
            elif tc == "i":
                tags[tag] = struct.unpack_from("<i", data, o)[0]; o += 4
            elif tc == "A":
                tags[tag] = chr(data[o]); o += 1
            elif tc == "C":
                tags[tag] = data[o]; o += 1
            elif tc == "c":
                tags[tag] = struct.unpack_from("<b", data, o)[0]; o += 1
            elif tc == "S":
                tags[tag] = struct.unpack_from("<H", data, o)[0]; o += 2
            elif tc == "s":
                tags[tag] = struct.unpack_from("<h", data, o)[0]; o += 2
            else:
                raise ValueError(f"unhandled tag type {tc}")
        records.append(dict(name=name.decode(), flag=flag, ref_id=ref_id,
                            pos=pos, mapq=mapq, cigar=cigar, seq=seq,
                            qual=qual, tags=tags, next_ref=_nr, next_pos=_np,
                            tlen=_tl))
        off = end
    return refs, records, text
