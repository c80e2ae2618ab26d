"""Host-side FASTQ ingestion: parse gzip FASTQs into fixed-shape numpy
batches with chemistry-driven barcode/UMI/cDNA extraction.

TPU-first design: the device pipeline consumes *fixed-shape* batches
(ReadBatch), so this module owns all ragged-to-rectangular conversion:
reads are clipped/padded to a static length, short/empty slots masked.
Mirrors the semantics of the reference's read model (RnaRead extraction per
ChemistryDef, lib/rust/cr_types/src/rna_read.rs:276,525) without its
per-read object model: everything is columnar numpy, ready for
the device upload.

Copied from cellranger_tpu/io/fastq.py (which reaches jax through its
encode import); the native zlib reader is the port's copy
(native/), built under build/native/.
"""

from __future__ import annotations

import gzip
import io as _io
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..ops import encode
from ..io.chemistry import Chemistry, Span


def _open(path: str):
    if path.endswith(".gz"):
        # 1 MiB decompression buffering; dominates pure-python readline cost.
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


def iter_fastq_records(path: str) -> Iterator[tuple[bytes, bytes, bytes]]:
    """Yield (name, seq, qual) byte tuples from a (gzipped) FASTQ."""
    with _open(path) as f:
        reader = _io.BufferedReader(f, buffer_size=1 << 20) if path.endswith(".gz") else f
        while True:
            name = reader.readline()
            if not name:
                return
            seq = reader.readline().rstrip(b"\n")
            plus = reader.readline()
            qual = reader.readline().rstrip(b"\n")
            if not qual and not seq:
                return
            yield name[1:].split(b" ", 1)[0].rstrip(b"\n"), seq, qual


@dataclass
class ReadBatch:
    """A fixed-shape batch of extracted reads (host numpy, columnar).

    All arrays share leading dim B = batch size; `n_reads` <= B rows are
    real, the rest are padding (mask semantics: slot_valid).
    """

    # barcode
    bc_packed: np.ndarray        # uint32 [B] 2-bit packed (MSB-first)
    bc_qual: np.ndarray          # uint8 [B, bc_len] phred+33
    bc_exact: np.ndarray         # bool [B] all-ACGT barcode bases
    # umi
    umi_packed: np.ndarray       # uint32 [B]
    umi_valid: np.ndarray        # bool [B] no-N and not homopolymer (umi/src/lib.rs:57-62)
    umi_qual: np.ndarray         # uint8 [B, umi_len]
    # cDNA
    rna: np.ndarray              # uint8 [B, L] 2-bit codes (0 where pad/N)
    rna_nmask: np.ndarray        # bool [B, L] true where real ACGT base
    rna_len: np.ndarray          # int32 [B] clipped length
    rna_qual: np.ndarray         # uint8 [B, L]
    # bookkeeping
    slot_valid: np.ndarray       # bool [B] row holds a real read
    read_id: np.ndarray          # int64 [B] global ordinal of the read
    n_reads: int
    names: list[bytes] | None = None  # read names (BAM output only)
    # RTL multiplexing: per-sample probe barcode (chem.probe_bc span)
    probe_bc_packed: np.ndarray | None = None  # uint32 [B]
    probe_bc_exact: np.ndarray | None = None   # bool [B]
    probe_bc_qual: np.ndarray | None = None    # uint8 [B, plen]
    # paired-end mate (chem.rna2, SC5P-PE / SCVDJ): second cDNA read
    rna2: np.ndarray | None = None             # uint8 [B, L]
    rna2_nmask: np.ndarray | None = None       # bool [B, L]
    rna2_len: np.ndarray | None = None         # int32 [B]
    rna2_qual: np.ndarray | None = None        # uint8 [B, L]
    # OH multiplexing: overhang sample barcode view (chem.overhang)
    overhang_packed: np.ndarray | None = None  # uint32 [B]
    overhang_exact: np.ndarray | None = None   # bool [B]
    # R1 remainder past bc+umi (feature-barcode patterns declared on R1;
    # the reference's REST_R1 view, bam_tags.rs:22)
    r1_rest: np.ndarray | None = None          # uint8 [B, L]
    r1_rest_nmask: np.ndarray | None = None    # bool [B, L]
    r1_rest_len: np.ndarray | None = None      # int32 [B]
    r1_rest_qual: np.ndarray | None = None     # uint8 [B, L]

    @property
    def batch_size(self) -> int:
        return len(self.bc_packed)


def _extract_span(seqs: np.ndarray, quals: np.ndarray, lens: np.ndarray, span: Span,
                  max_len: int | None = None):
    """Slice a Span out of rectangularized read arrays.

    seqs/quals: uint8 [B, Lmax] ASCII; lens: actual lengths.
    Returns (ascii uint8 [B, n], qual uint8 [B, n], span_len int32 [B]).
    """
    if span.length is not None:
        n = span.length
    else:
        n = seqs.shape[1] - span.offset
        if max_len is not None:
            n = min(n, max_len)
    sl = seqs[:, span.offset:span.offset + n]
    ql = quals[:, span.offset:span.offset + n]
    span_len = np.clip(lens - span.offset, 0, n).astype(np.int32)
    return sl, ql, span_len


def _rectangularize(records: list[tuple[bytes, bytes]], width: int):
    """[(seq, qual)] -> ascii uint8 [B, width] (0-padded), quals, lens."""
    B = len(records)
    seqs = np.zeros((B, width), dtype=np.uint8)
    quals = np.full((B, width), ord("!"), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, (s, q) in enumerate(records):
        L = min(len(s), width)
        lens[i] = L
        seqs[i, :L] = np.frombuffer(s[:L], dtype=np.uint8)
        quals[i, :L] = np.frombuffer(q[:L], dtype=np.uint8)
    return seqs, quals, lens


def r1_rest_offset(chem: Chemistry) -> int:
    """Where the R1 remainder starts: past every structured span on R1."""
    end = 0
    for span in (chem.barcode[0].span, chem.umi, chem.probe_bc):
        if span is not None and span.read == "R1" and span.length:
            end = max(end, span.offset + span.length)
    return end


def required_widths(chem: Chemistry, read_len: int,
                    keep_r1_rest: bool = False,
                    barcode_only: bool = False) -> dict[str, int]:
    """Rectangular buffer width each physical read needs, keyed by read
    name ("R1"/"R2"/"I1"); 0 when the chemistry never touches that read.

    barcode_only: pass-1 mode — only the barcode + UMI spans are needed, so
    the cDNA read (usually the whole of R2) is never decoded and R2 often
    needn't be opened at all (halves pass-1 IO)."""
    w = {"R1": 0, "R2": 0, "I1": 0}

    def need(span: Span | None, full=False):
        if span is None:
            return
        end = span.offset + (read_len if (span.length is None or full)
                             else span.length)
        w[span.read] = max(w[span.read], end)

    need(chem.barcode[0].span)
    need(chem.umi)
    if barcode_only:
        return w
    need(chem.rna, full=True)
    need(chem.rna2, full=True)
    need(chem.probe_bc)
    need(chem.overhang)
    if keep_r1_rest:
        w["R1"] = max(w["R1"], r1_rest_offset(chem) + read_len)
    return w  # w["R2"] may be 0: R2 unused (e.g. SC5P-R1)


def extract_batch(chem: Chemistry, r1: list[tuple[bytes, bytes]],
                  r2: list[tuple[bytes, bytes]] | None,
                  read_len: int, batch_size: int,
                  start_read_id: int = 0,
                  names: list[bytes] | None = None,
                  i1: list[tuple[bytes, bytes]] | None = None,
                  keep_r1_rest: bool = False,
                  barcode_only: bool = False) -> ReadBatch:
    """Extract barcode/UMI/cDNA planes from raw R1 (+R2, +I1) record lists."""
    w = required_widths(chem, read_len, keep_r1_rest, barcode_only)
    r1_arrays = _rectangularize(r1, max(w["R1"], 1))
    r2_arrays = _rectangularize(r2, max(w["R2"], 1)) if r2 is not None else None
    i1_arrays = _rectangularize(i1, max(w["I1"], 1)) if i1 is not None else None
    return extract_batch_arrays(chem, r1_arrays, r2_arrays, read_len,
                                batch_size, start_read_id, names,
                                i1_arrays=i1_arrays,
                                keep_r1_rest=keep_r1_rest,
                                barcode_only=barcode_only)


def extract_batch_arrays(chem: Chemistry, r1_arrays, r2_arrays,
                         read_len: int, batch_size: int,
                         start_read_id: int = 0,
                         names: list[bytes] | None = None,
                         i1_arrays=None, keep_r1_rest: bool = False,
                         barcode_only: bool = False) -> ReadBatch:
    """Extraction core over rectangular (seqs, quals, lens) arrays — the
    zero-copy path fed by the native reader."""
    r1seq, r1qual, r1len = r1_arrays
    n = len(r1seq)
    assert n <= batch_size
    bc_span = chem.barcode[0].span
    umi_span = chem.umi

    reads = {"R1": (r1seq, r1qual, r1len)}
    if r2_arrays is not None:
        reads["R2"] = r2_arrays
    if i1_arrays is not None:
        reads["I1"] = i1_arrays

    def span_arrays(span: Span, max_len=None):
        s, q, l = reads[span.read]
        return _extract_span(s, q, l, span, max_len=max_len)

    # Barcode
    bseq, bqual, blen = span_arrays(bc_span)
    bcodes, bvalid = encode.encode_seqs(bseq)
    bc_exact = bvalid.all(axis=1) & (blen == bc_span.length)
    bc_packed = encode.pack_codes_np(bcodes, bc_span.length)

    # UMI
    useq, uqual, ulen = span_arrays(umi_span)
    ucodes, uvalid_b = encode.encode_seqs(useq)
    min_u = chem.umi_min_length
    umi_len_arr = np.asarray(ulen)
    # bases beyond actual length are pad: treat as invalid
    pos = np.arange(umi_span.length)[None, :]
    in_len = pos < umi_len_arr[:, None]
    has_bad = ((~uvalid_b) & in_len).any(axis=1)
    long_enough = umi_len_arr >= min_u
    # homopolymer check over the real span
    first = ucodes[:, :1]
    homo = np.logical_or.reduce(
        [(ucodes == first).all(axis=1)]) if umi_span.length > 1 else np.ones(n, bool)
    same = (ucodes == first) | ~in_len
    homo = same.all(axis=1)
    umi_valid = (~has_bad) & long_enough & (~homo)
    # pack with pad bases zeroed (A); length-12 packing of shorter UMIs keeps
    # the real bases in the high bits.
    umi_packed = encode.pack_codes_np(np.where(in_len, ucodes, 0), umi_span.length)

    # cDNA
    if barcode_only:
        # pass-1 mode: barcode+UMI only; 1-wide placeholders keep the
        # ReadBatch shape contract without decoding the cDNA read
        ccodes = np.zeros((n, 1), np.uint8)
        nmask = np.zeros((n, 1), bool)
        clen = np.zeros(n, np.int32)
        cqual = np.full((n, 1), ord("!"), np.uint8)
    else:
        cseq, cqual, clen = span_arrays(chem.rna, max_len=read_len)
        ccodes, cvalid = encode.encode_seqs(cseq)
        W = cseq.shape[1]
        if W < read_len:
            padw = read_len - W
            ccodes = np.pad(ccodes, ((0, 0), (0, padw)))
            cvalid = np.pad(cvalid, ((0, 0), (0, padw)))
            cqual = np.pad(cqual, ((0, 0), (0, padw)), constant_values=ord("!"))
        cpos = np.arange(read_len)[None, :]
        nmask = cvalid & (cpos < clen[:, None])

    def padb(a, fill=0):
        if len(a) == batch_size:
            return a
        pad_shape = (batch_size - len(a),) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])

    # paired-end mate (chem.rna2): same clip/pad treatment as the cDNA
    rna2 = rna2_nmask = rna2_len = rna2_qual = None
    if chem.rna2 is not None and not barcode_only:
        c2seq, c2qual, c2len = span_arrays(chem.rna2, max_len=read_len)
        c2codes, c2valid = encode.encode_seqs(c2seq)
        W2 = c2seq.shape[1]
        if W2 < read_len:
            pw = read_len - W2
            c2codes = np.pad(c2codes, ((0, 0), (0, pw)))
            c2valid = np.pad(c2valid, ((0, 0), (0, pw)))
            c2qual = np.pad(c2qual, ((0, 0), (0, pw)),
                            constant_values=ord("!"))
        c2pos = np.arange(read_len)[None, :]
        rna2_nmask = c2valid & (c2pos < c2len[:, None])
        rna2, rna2_len, rna2_qual = c2codes, c2len, c2qual

    # R1 remainder (feature-barcode patterns on R1)
    rr = rr_nmask = rr_len = rr_qual = None
    if keep_r1_rest:
        rest_span = Span("R1", r1_rest_offset(chem), None)
        rseq, rqual, rlen = span_arrays(rest_span, max_len=read_len)
        rcodes, rvalid = encode.encode_seqs(rseq)
        WR = rseq.shape[1]
        if WR < read_len:
            pw = read_len - WR
            rcodes = np.pad(rcodes, ((0, 0), (0, pw)))
            rvalid = np.pad(rvalid, ((0, 0), (0, pw)))
            rqual = np.pad(rqual, ((0, 0), (0, pw)), constant_values=ord("!"))
        rpos = np.arange(read_len)[None, :]
        rr_nmask = rvalid & (rpos < rlen[:, None])
        rr, rr_len, rr_qual = rcodes, rlen, rqual

    # overhang sample barcode (OH multiplexing): a 2bp view into R1
    oh_packed = oh_exact = None
    if chem.overhang is not None and not barcode_only:
        oseq, _oq, olen = span_arrays(chem.overhang)
        ocodes, ovalid = encode.encode_seqs(oseq)
        oh_exact = padb((ovalid.all(axis=1)
                         & (olen == chem.overhang.length)).astype(bool))
        oh_packed = padb(encode.pack_codes_np(ocodes, chem.overhang.length))

    # probe barcode (RTL multiplexing)
    probe_packed = probe_exact = probe_qual = None
    if chem.probe_bc is not None and not barcode_only:
        pseq, pqual, plen = span_arrays(chem.probe_bc)
        pcodes, pvalid = encode.encode_seqs(pseq)
        probe_exact = padb((pvalid.all(axis=1)
                            & (plen == chem.probe_bc.length)).astype(bool))
        probe_packed = padb(encode.pack_codes_np(pcodes, chem.probe_bc.length))
        probe_qual = padb(pqual)

    slot_valid = np.zeros(batch_size, bool)
    slot_valid[:n] = True
    return ReadBatch(
        probe_bc_packed=probe_packed, probe_bc_exact=probe_exact,
        probe_bc_qual=probe_qual,
        overhang_packed=oh_packed, overhang_exact=oh_exact,
        r1_rest=padb(rr[:, :read_len]) if rr is not None else None,
        r1_rest_nmask=(padb(rr_nmask[:, :read_len])
                       if rr_nmask is not None else None),
        r1_rest_len=padb(rr_len) if rr_len is not None else None,
        r1_rest_qual=(padb(rr_qual[:, :read_len])
                      if rr_qual is not None else None),
        rna2=padb(rna2[:, :read_len]) if rna2 is not None else None,
        rna2_nmask=(padb(rna2_nmask[:, :read_len])
                    if rna2_nmask is not None else None),
        rna2_len=padb(rna2_len) if rna2_len is not None else None,
        rna2_qual=(padb(rna2_qual[:, :read_len])
                   if rna2_qual is not None else None),
        bc_packed=padb(bc_packed), bc_qual=padb(bqual), bc_exact=padb(bc_exact.astype(bool)),
        umi_packed=padb(umi_packed), umi_valid=padb(umi_valid.astype(bool)),
        umi_qual=padb(uqual),
        rna=padb(ccodes[:, :read_len]), rna_nmask=padb(nmask[:, :read_len]),
        rna_len=padb(clen), rna_qual=padb(cqual[:, :read_len]),
        slot_valid=slot_valid,
        read_id=padb(np.arange(start_read_id, start_read_id + n, dtype=np.int64), -1),
        n_reads=n, names=names,
    )


def batches_from_fastqs(chem: Chemistry, r1_path: str, r2_path: str | None,
                        batch_size: int, read_len: int,
                        keep_names: bool = False,
                        use_native: bool = True,
                        i1_path: str | None = None,
                        keep_r1_rest: bool = False,
                        barcode_only: bool = False) -> Iterator[ReadBatch]:
    """Stream ReadBatches from a (R1, R2[, I1]) FASTQ set; prefers the
    native (C++/zlib) reader, falling back to the pure-python parser.
    I1 carries the barcode for SC3Pv1 (chemistry_defs.json SC3Pv1).
    barcode_only skips decoding (and, when possible, even opening) every
    read the barcode+UMI don't live on — the pass-1 fast path."""
    w = required_widths(chem, read_len, keep_r1_rest, barcode_only)
    needs_i1 = w["I1"] > 0
    if needs_i1 and not i1_path:
        raise ValueError(
            f"chemistry {chem.name} reads the barcode from I1; pass the "
            "_I1_ FASTQ (find_fastqs discovers it alongside R1/R2)")
    if barcode_only and w["R2"] == 0:
        r2_path = None
    if use_native:
        try:
            yield from _batches_native(chem, r1_path, r2_path, batch_size,
                                       read_len, keep_names, i1_path,
                                       keep_r1_rest, barcode_only)
            return
        except RuntimeError:
            pass  # no toolchain: python fallback
    it1 = iter_fastq_records(r1_path)
    it2 = iter_fastq_records(r2_path) if r2_path else None
    iti = iter_fastq_records(i1_path) if i1_path else None
    next_id = 0
    while True:
        r1, r2 = [], ([] if it2 else None)
        i1 = [] if iti else None
        names = [] if keep_names else None
        for rec in it1:
            r1.append((rec[1], rec[2]))
            if keep_names:
                names.append(rec[0])
            if it2 is not None:
                rec2 = next(it2, None)
                if rec2 is None:
                    raise ValueError("R1/R2 FASTQ length mismatch")
                r2.append((rec2[1], rec2[2]))
            if iti is not None:
                reci = next(iti, None)
                if reci is None:
                    raise ValueError("R1/I1 FASTQ length mismatch")
                i1.append((reci[1], reci[2]))
            if len(r1) == batch_size:
                break
        if not r1:
            return
        yield extract_batch(chem, r1, r2, read_len, batch_size, next_id,
                            names=names, i1=i1, keep_r1_rest=keep_r1_rest,
                            barcode_only=barcode_only)
        next_id += len(r1)
        if len(r1) < batch_size:
            return


def _batches_native(chem: Chemistry, r1_path: str, r2_path: str | None,
                    batch_size: int, read_len: int,
                    keep_names: bool,
                    i1_path: str | None = None,
                    keep_r1_rest: bool = False,
                    barcode_only: bool = False) -> Iterator[ReadBatch]:
    from ..native import NativeFastqReader

    w = required_widths(chem, read_len, keep_r1_rest, barcode_only)
    if barcode_only and w["R2"] == 0:
        r2_path = None
    rd1 = NativeFastqReader(r1_path, keep_names=keep_names)
    rd2 = NativeFastqReader(r2_path) if r2_path else None
    rdi = NativeFastqReader(i1_path) if i1_path else None
    next_id = 0
    try:
        while True:
            s1, q1, l1, names = rd1.read_batch(batch_size, max(w["R1"], 1))
            n = len(s1)
            if n == 0:
                return
            r2_arrays = None
            if rd2 is not None:
                s2, q2, l2, _ = rd2.read_batch(batch_size, max(w["R2"], 1))
                if len(s2) != n:
                    raise ValueError("R1/R2 FASTQ length mismatch")
                r2_arrays = (s2, q2, l2)
            i1_arrays = None
            if rdi is not None:
                si, qi, li, _ = rdi.read_batch(batch_size, max(w["I1"], 1))
                if len(si) != n:
                    raise ValueError("R1/I1 FASTQ length mismatch")
                i1_arrays = (si, qi, li)
            yield extract_batch_arrays(chem, (s1, q1, l1), r2_arrays,
                                       read_len, batch_size, next_id, names,
                                       i1_arrays=i1_arrays,
                                       keep_r1_rest=keep_r1_rest,
                                       barcode_only=barcode_only)
            next_id += n
            if n < batch_size:
                return
    finally:
        rd1.close()
        if rd2 is not None:
            rd2.close()
        if rdi is not None:
            rdi.close()


def find_fastqs(directory: str, sample: str | None = None,
                include_index: bool = False):
    """Discover Illumina bcl2fastq-style FASTQ pairs in a directory
    (mirrors cr_wrap/src/fastqs.rs discovery: <sample>_S*_L*_R{1,2}_*.fastq.gz).
    include_index=True returns (r1, r2, i1) triples for I1-barcode
    chemistries (SC3Pv1)."""
    out = []
    for fn in sorted(os.listdir(directory)):
        if "_R1_" in fn and (fn.endswith(".fastq.gz") or fn.endswith(".fastq")):
            if sample and not fn.startswith(sample + "_"):
                continue
            r2p = os.path.join(directory, fn.replace("_R1_", "_R2_"))
            r2p = r2p if os.path.exists(r2p) else None
            if include_index:
                i1p = os.path.join(directory, fn.replace("_R1_", "_I1_"))
                out.append((os.path.join(directory, fn), r2p,
                            i1p if os.path.exists(i1p) else None))
            else:
                out.append((os.path.join(directory, fn), r2p))
    return out
