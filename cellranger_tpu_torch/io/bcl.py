"""Illumina BCL flowcell reading — the input side of mkfastq.

The reference shells out to bcl2fastq and post-routes with a Go demuxer
(mro/tenkit/make_fastqs.mro:37-98, lib/go/cmd/godemux/main.go:170); here the
conversion is native: per-cycle BCL decoding is a vectorized numpy
transpose (cycle-major -> cluster-major), so a tile converts in one pass.

Formats (classic HiSeq/MiSeq layout, also written by our test generator):
  RunInfo.xml                          read structure (NumCycles, IsIndexedRead)
  Data/Intensities/BaseCalls/L00<lane>/C<cycle>.1/s_<lane>_<tile>.bcl[.gz]
      u32 LE cluster count, then 1 byte/cluster:
      0 => N (qual 2-ish -> '#'), else base = b & 3 (ACGT), qual = b >> 2
  Data/Intensities/BaseCalls/L00<lane>/s_<lane>_<tile>.filter
      u32 0, u32 version, u32 count, then u8 pass-filter flags
  Data/Intensities/L00<lane>/s_<lane>_<tile>.locs
      u32 1, f32 1.0, u32 count, then (f32 x, f32 y) per cluster

Verbatim copy of cellranger_tpu/io/bcl.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import glob
import gzip
import os
import re
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


@dataclass(frozen=True)
class ReadSegment:
    number: int
    num_cycles: int
    is_index: bool


@dataclass
class RunInfo:
    run_id: str
    flowcell: str
    lanes: int
    reads: list[ReadSegment]

    @property
    def total_cycles(self) -> int:
        return sum(r.num_cycles for r in self.reads)

    def segments(self):
        """[(segment, first_cycle_1based)] in cycle order."""
        out, c = [], 1
        for r in self.reads:
            out.append((r, c))
            c += r.num_cycles
        return out


def parse_run_info(run_dir: str) -> RunInfo:
    root = ET.parse(os.path.join(run_dir, "RunInfo.xml")).getroot()
    run = root.find("Run")
    reads = [ReadSegment(int(r.get("Number")), int(r.get("NumCycles")),
                         r.get("IsIndexedRead", "N").upper() == "Y")
             for r in run.find("Reads").findall("Read")]
    reads.sort(key=lambda r: r.number)
    fc = run.findtext("Flowcell", default="FC")
    lanes = int(run.find("FlowcellLayout").get("LaneCount", "1")) \
        if run.find("FlowcellLayout") is not None else 1
    return RunInfo(run.get("Id", "run"), fc, lanes, reads)


def _read_bcl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (codes uint8 [N] 0..3, quals uint8 [N] phred; N-calls get base
    code 4)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        raw = f.read()
    n = struct.unpack_from("<I", raw, 0)[0]
    b = np.frombuffer(raw, np.uint8, count=n, offset=4)
    codes = np.where(b == 0, np.uint8(4), (b & 3).astype(np.uint8))
    quals = np.where(b == 0, np.uint8(2), (b >> 2).astype(np.uint8))
    return codes, quals


def _read_filter(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    n = struct.unpack_from("<I", raw, 8)[0]
    return np.frombuffer(raw, np.uint8, count=n, offset=12).astype(bool)


def _read_locs(path: str) -> np.ndarray:
    """-> int32 [N, 2] Illumina name coordinates (x, y)."""
    with open(path, "rb") as f:
        raw = f.read()
    n = struct.unpack_from("<I", raw, 8)[0]
    xy = np.frombuffer(raw, "<f4", count=2 * n, offset=12).reshape(n, 2)
    return np.round(xy * 10.0 + 1000.0).astype(np.int32)


def tiles_of_lane(run_dir: str, lane: int) -> list[int]:
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    c1 = os.path.join(base, "C1.1")
    tiles = set()
    for p in glob.glob(os.path.join(c1, f"s_{lane}_*.bcl*")):
        m = re.match(rf"s_{lane}_(\d+)\.bcl", os.path.basename(p))
        if m:
            tiles.add(int(m.group(1)))
    return sorted(tiles)


def read_tile(run_dir: str, info: RunInfo, lane: int, tile: int):
    """Decode one tile -> dict per read segment: (seq uint8 ASCII [N, C],
    qual uint8 ASCII [N, C]) for PASSING-FILTER clusters, plus names.

    Cycle-major BCL bytes become cluster-major planes with one stack +
    transpose — the whole tile is a few numpy ops.
    """
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    fpath = os.path.join(base, f"s_{lane}_{tile}.filter")
    keep = _read_filter(fpath) if os.path.exists(fpath) else None
    lpath = os.path.join(run_dir, "Data", "Intensities", f"L{lane:03d}",
                         f"s_{lane}_{tile}.locs")

    out = {}
    n_clusters = None
    for seg, c0 in info.segments():
        codes_c, quals_c = [], []
        for c in range(c0, c0 + seg.num_cycles):
            cdir = os.path.join(base, f"C{c}.1")
            p = os.path.join(cdir, f"s_{lane}_{tile}.bcl")
            if not os.path.exists(p):
                p += ".gz"
            cd, qd = _read_bcl(p)
            codes_c.append(cd)
            quals_c.append(qd)
        codes = np.stack(codes_c, axis=1)      # [N, C]
        quals = np.stack(quals_c, axis=1)
        n_clusters = len(codes)
        if keep is not None:
            codes, quals = codes[keep], quals[keep]
        seq = np.where(codes == 4, np.uint8(ord("N")),
                       BASES[np.minimum(codes, 3)])
        out[seg.number] = (seq, quals + 33)
    if keep is None:
        keep = np.ones(n_clusters, bool)
    if os.path.exists(lpath):
        locs = _read_locs(lpath)[keep]
    else:
        idx = np.arange(int(keep.sum()), dtype=np.int32)
        locs = np.stack([idx + 1000, np.full_like(idx, 1000)], axis=1)
    names = [b"%s:%d:%s:%d:%d:%d:%d" % (
        info.run_id.encode().split(b"_")[0], 1, info.flowcell.encode(),
        lane, tile, int(x), int(y)) for x, y in locs]
    return out, names


# ---------------------------------------------------------------------------
# CBCL (NovaSeq-class) decoding.  Layout per cycle directory:
#   L00<lane>/C<cycle>.1/L00<lane>_<surface>.cbcl
# Header: u16 version, u32 header_size, u8 bits_per_basecall,
# u8 bits_per_qscore, u32 n_bins + n_bins x (u32 from, u32 to) qscore map,
# u32 n_tiles + per tile (u32 tile, u32 n_clusters, u32 uncompressed_size,
# u32 compressed_size), u8 non_PF_clusters_excluded; then per-tile gzip
# blocks concatenated in tile order.  With 2+2 bits, a byte holds two
# clusters: low nibble first (bits 0-1 base, 2-3 qscore bin); qscore bin
# mapping to 0 marks a no-call (N).
# ---------------------------------------------------------------------------


@dataclass
class CbclCycle:
    path: str
    bits_bc: int
    bits_q: int
    qbins: np.ndarray                  # bin index -> qscore
    tiles: dict                        # tile -> (offset, comp, n_clusters)
    excludes_nonpf: bool


def _read_cbcl_header(path: str) -> CbclCycle:
    with open(path, "rb") as f:
        version, header_size = struct.unpack("<HI", f.read(6))
        bits_bc, bits_q = struct.unpack("<BB", f.read(2))
        (n_bins,) = struct.unpack("<I", f.read(4))
        qbins = np.zeros(max(n_bins, 1), np.uint8)
        for i in range(n_bins):
            _frm, to = struct.unpack("<II", f.read(8))
            qbins[i] = to
        (n_tiles,) = struct.unpack("<I", f.read(4))
        recs = []
        for _ in range(n_tiles):
            recs.append(struct.unpack("<IIII", f.read(16)))
        (excl,) = struct.unpack("<B", f.read(1))
        tiles = {}
        off = header_size
        for tile, n_clusters, _unc, comp in recs:
            tiles[tile] = (off, comp, n_clusters)
            off += comp
    return CbclCycle(path, bits_bc, bits_q, qbins, tiles, excl != 0)


def _read_cbcl_tile(cyc: CbclCycle, tile: int):
    """-> (codes uint8 [N] 0-3 or 4=N, quals uint8 [N])."""
    import zlib
    off, comp, n_clusters = cyc.tiles[tile]
    with open(cyc.path, "rb") as f:
        f.seek(off)
        blob = f.read(comp)
    raw = zlib.decompress(blob, wbits=31)  # gzip member
    data = np.frombuffer(raw, np.uint8)
    # two clusters per byte: low nibble then high nibble
    nibbles = np.empty(len(data) * 2, np.uint8)
    nibbles[0::2] = data & 0x0F
    nibbles[1::2] = data >> 4
    nibbles = nibbles[:n_clusters]
    codes = nibbles & 3
    qbin = nibbles >> 2
    quals = cyc.qbins[np.minimum(qbin, len(cyc.qbins) - 1)]
    # RTA3 convention: qscore bin 0 is the no-call bin (bcl2fastq emits N)
    codes = np.where(qbin == 0, np.uint8(4), codes)
    return codes, quals.astype(np.uint8)


def _cbcl_cycle_path(base: str, cycle: int, lane: int,
                     surface: int) -> str:
    return os.path.join(base, f"C{cycle}.1", f"L{lane:03d}_{surface}.cbcl")


def is_cbcl_run(run_dir: str, lane: int) -> bool:
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    return bool(glob.glob(os.path.join(base, "C1.1", "*.cbcl")))


def tiles_of_lane_cbcl(run_dir: str, lane: int) -> list[int]:
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    tiles = set()
    for p in glob.glob(os.path.join(base, "C1.1", "*.cbcl")):
        tiles.update(_read_cbcl_header(p).tiles)
    return sorted(tiles)


def read_tile_cbcl(run_dir: str, info: RunInfo, lane: int, tile: int,
                   _hdr_cache: dict | None = None):
    """CBCL twin of read_tile: one tile across all cycles -> per-segment
    (seq, qual) planes + names.  Tile surface = leading digit of the tile
    number (NovaSeq tile naming: surface-swath-tile)."""
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    surface = int(str(tile)[0])
    fpath = os.path.join(base, f"s_{lane}_{tile}.filter")
    keep = _read_filter(fpath) if os.path.exists(fpath) else None

    cache = _hdr_cache if _hdr_cache is not None else {}
    out = {}
    n_out = None
    for seg, c0 in info.segments():
        codes_c, quals_c = [], []
        for c in range(c0, c0 + seg.num_cycles):
            p = _cbcl_cycle_path(base, c, lane, surface)
            if p not in cache:
                cache[p] = _read_cbcl_header(p)
            cyc = cache[p]
            cd, qd = _read_cbcl_tile(cyc, tile)
            if keep is not None and not cyc.excludes_nonpf:
                cd, qd = cd[keep], qd[keep]
            codes_c.append(cd)
            quals_c.append(qd)
        codes = np.stack(codes_c, axis=1)
        quals = np.stack(quals_c, axis=1)
        n_out = len(codes)
        seq = np.where(codes == 4, np.uint8(ord("N")),
                       BASES[np.minimum(codes, 3)])
        out[seg.number] = (seq, quals + 33)

    idx = np.arange(n_out, dtype=np.int32)
    lpath = os.path.join(run_dir, "Data", "Intensities", f"L{lane:03d}",
                         f"s_{lane}_{tile}.locs")
    if os.path.exists(lpath):
        locs = _read_locs(lpath)
        if keep is not None and len(locs) == len(keep):
            locs = locs[keep]
        locs = locs[:n_out]
    else:
        locs = np.stack([idx + 1000, np.full_like(idx, 1000)], axis=1)
    names = [b"%s:%d:%s:%d:%d:%d:%d" % (
        info.run_id.encode().split(b"_")[0], 1, info.flowcell.encode(),
        lane, tile, int(x), int(y)) for x, y in locs]
    return out, names


def write_cbcl_run(run_dir: str, info_xml: str, lane: int,
                   tiles: dict,
                   qscore_map=((2, 2), (12, 12), (26, 26), (37, 37)),
                   exclude_nonpf: bool = False):
    """Test/generator utility: write a minimal CBCL run directory.

    tiles: {tile_number: (codes uint8 [N, total_cycles] 0-4,
                          qbin uint8 [N, total_cycles],
                          pass_filter bool [N])}.
    """
    import zlib
    base = os.path.join(run_dir, "Data", "Intensities", "BaseCalls",
                        f"L{lane:03d}")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(run_dir, "RunInfo.xml"), "w") as f:
        f.write(info_xml)
    info = parse_run_info(run_dir)
    total = info.total_cycles
    for tile, (codes, qbin, pf) in tiles.items():
        with open(os.path.join(base, f"s_{lane}_{tile}.filter"), "wb") as f:
            f.write(struct.pack("<III", 0, 3, len(pf)))
            f.write(np.asarray(pf, np.uint8).tobytes())
    surfaces = {int(str(t)[0]) for t in tiles}
    for c in range(1, total + 1):
        cdir = os.path.join(base, f"C{c}.1")
        os.makedirs(cdir, exist_ok=True)
        for surface in surfaces:
            s_tiles = sorted(t for t in tiles if int(str(t)[0]) == surface)
            blocks = []
            recs = []
            for t in s_tiles:
                codes, qbin, pf = tiles[t]
                cd = codes[:, c - 1].copy()
                qb = qbin[:, c - 1].copy()
                if exclude_nonpf:
                    cd, qb = cd[pf], qb[pf]
                qb = np.where(cd == 4, 0, qb)      # no-call -> bin 0
                nib = (np.minimum(cd, 3) | (qb << 2)).astype(np.uint8)
                if len(nib) % 2:
                    nib = np.append(nib, 0)
                packed = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
                # wrap as gzip member
                co = zlib.compressobj(6, zlib.DEFLATED, 31)
                blob = co.compress(packed.tobytes()) + co.flush()
                n_cl = int(pf.sum()) if exclude_nonpf else len(codes)
                recs.append((t, n_cl, len(packed), len(blob)))
                blocks.append(blob)
            n_bins = len(qscore_map)
            header = struct.pack("<HI", 1, 0)  # size patched below
            body = struct.pack("<BB", 2, 2)
            body += struct.pack("<I", n_bins)
            for frm, to in qscore_map:
                body += struct.pack("<II", frm, to)
            body += struct.pack("<I", len(recs))
            for r in recs:
                body += struct.pack("<IIII", *r)
            body += struct.pack("<B", 1 if exclude_nonpf else 0)
            header_size = 6 + len(body)
            with open(_cbcl_cycle_path(base, c, lane, surface), "wb") as f:
                f.write(struct.pack("<HI", 1, header_size))
                f.write(body)
                for b in blocks:
                    f.write(b)
