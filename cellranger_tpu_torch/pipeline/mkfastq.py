"""mkfastq — BCL flowcell -> per-sample FASTQs.

The reference's MAKE_FASTQS pipeline (mro/tenkit/make_fastqs.mro:37-98)
expands 10x sample-index set names into an Illumina samplesheet
(lib/python/tenkit/samplesheet.py), runs bcl2fastq as a subprocess, and
routes shared-index reads with a Go demuxer (lib/go/cmd/godemux/main.go:170).
Here conversion + demux are one native pass: vectorized per-tile BCL
decoding (io/bcl.py), numpy index matching with 1-mismatch tolerance, and
streaming gzip writers per (sample, lane, read).

Sample sheet (CSV): Lane,Sample,Index — Index is a raw i7 oligo or a
sample-index set name resolved from a kit CSV (`name,oligo1[,oligo2...]`
rows; 10x kits put 4 oligos per set). Kit oligo tables are data files the
user supplies, as with barcode whitelists.

Verbatim copy of cellranger_tpu/pipeline/mkfastq.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from ..io.bcl import (is_cbcl_run, parse_run_info, read_tile,
                      read_tile_cbcl, tiles_of_lane, tiles_of_lane_cbcl)


@dataclass
class SampleSheetRow:
    lane: int | None  # None = all lanes
    sample: str
    indexes: list[str]  # expanded oligos


def parse_samplesheet(path: str, index_kit_csv: str | None = None):
    """-> list[SampleSheetRow]; expands SI- set names via the kit CSV."""
    kit = {}
    if index_kit_csv:
        with open(index_kit_csv) as f:
            for line in f:
                parts = [p.strip() for p in line.strip().split(",") if p.strip()]
                if len(parts) >= 2 and parts[0].lower() not in ("name", "id"):
                    kit[parts[0]] = [o.upper() for o in parts[1:]]
    rows = []
    with open(path) as f:
        header = None
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if header is None and parts[0].lower() in ("lane",):
                header = [p.lower() for p in parts]
                continue
            if header is None:
                header = ["lane", "sample", "index"]
            row = dict(zip(header, parts))
            idx = row["index"]
            if idx.upper().startswith("SI-") or idx in kit:
                if idx not in kit:
                    raise ValueError(
                        f"sample index set {idx!r} needs an index kit CSV "
                        "(name,oligo1,oligo2,... rows)")
                oligos = kit[idx]
            else:
                oligos = [idx.upper()]
            lane = None if row["lane"] in ("", "*", "all") else int(row["lane"])
            rows.append(SampleSheetRow(lane, row["sample"], oligos))
    if not rows:
        raise ValueError(f"no samples in {path}")
    return rows


def _match_index(i1_seq: np.ndarray, oligos_by_sample: list[list[str]],
                 max_mm: int = 1):
    """i1_seq: ASCII uint8 [N, C]. Returns sample assignment int32 [N]
    (-1 = undetermined): nearest oligo with <= max_mm mismatches, ties ->
    undetermined."""
    N = len(i1_seq)
    flat = []
    owner = []
    for si, oligos in enumerate(oligos_by_sample):
        for o in oligos:
            flat.append(np.frombuffer(o.encode(), np.uint8))
            owner.append(si)
    L = min(i1_seq.shape[1], min(len(x) for x in flat))
    mat = np.stack([x[:L] for x in flat])                 # [K, L]
    mm = (i1_seq[:, None, :L] != mat[None, :, :]).sum(axis=2)  # [N, K]
    best = mm.min(axis=1)
    ties = (mm == best[:, None]).sum(axis=1)
    owner = np.asarray(owner, np.int32)
    # ties across DIFFERENT samples are ambiguous; same-sample ties fine
    arg = mm.argmin(axis=1)
    same_owner = np.ones(N, bool)
    if len(mat) > 1:
        # a tie is OK only when every tying oligo belongs to the same sample
        tying_other = ((mm == best[:, None])
                       & (owner[None, :] != owner[arg][:, None])).any(axis=1)
        same_owner = ~tying_other
    ok = (best <= max_mm) & same_owner
    return np.where(ok, owner[arg], -1).astype(np.int32)


def run_mkfastq(run_dir: str, samplesheet_csv: str, out_dir: str,
                index_kit_csv: str | None = None, max_mm: int = 1) -> dict:
    """Convert + demux a BCL run directory. Returns per-sample read counts."""
    info = parse_run_info(run_dir)
    rows = parse_samplesheet(samplesheet_csv, index_kit_csv)
    os.makedirs(out_dir, exist_ok=True)

    # read-segment naming: non-index reads R1, R2...; index reads I1, I2...
    rnames, inames = {}, {}
    ri = ii = 0
    for seg in info.reads:
        if seg.is_index:
            ii += 1
            inames[seg.number] = f"I{ii}"
        else:
            ri += 1
            rnames[seg.number] = f"R{ri}"
    if ii == 0:
        raise ValueError("run has no index read; cannot demux")
    i1_seg = [n for n, v in inames.items() if v == "I1"][0]

    counts: dict[str, int] = {r.sample: 0 for r in rows}
    counts["Undetermined"] = 0
    writers: dict[tuple, gzip.GzipFile] = {}

    def writer(sample, s_num, lane, rname):
        key = (sample, lane, rname)
        if key not in writers:
            sd = os.path.join(out_dir, sample) if sample != "Undetermined" \
                else out_dir
            os.makedirs(sd, exist_ok=True)
            writers[key] = gzip.open(os.path.join(
                sd, f"{sample}_S{s_num}_L{lane:03d}_{rname}_001.fastq.gz"),
                "wb", compresslevel=4)
        return writers[key]

    sample_order = [r.sample for r in rows]
    try:
        for lane in range(1, info.lanes + 1):
            lane_rows = [r for r in rows if r.lane in (None, lane)]
            if not lane_rows:
                continue
            oligos = [r.indexes for r in lane_rows]
            cbcl = is_cbcl_run(run_dir, lane)
            hdr_cache: dict = {}
            tile_list = (tiles_of_lane_cbcl(run_dir, lane) if cbcl
                         else tiles_of_lane(run_dir, lane))
            for tile in tile_list:
                if cbcl:
                    planes, names = read_tile_cbcl(run_dir, info, lane,
                                                   tile, hdr_cache)
                else:
                    planes, names = read_tile(run_dir, info, lane, tile)
                assign = _match_index(planes[i1_seg][0], oligos, max_mm)
                for local_si in range(-1, len(lane_rows)):
                    sel = np.flatnonzero(assign == local_si) if local_si >= 0 \
                        else np.flatnonzero(assign < 0)
                    if not len(sel):
                        continue
                    if local_si >= 0:
                        sample = lane_rows[local_si].sample
                        s_num = sample_order.index(sample) + 1
                    else:
                        sample, s_num = "Undetermined", 0
                    counts[sample] += len(sel)
                    for segno, rname in list(rnames.items()) + \
                            list(inames.items()):
                        seq, qual = planes[segno]
                        w = writer(sample, s_num, lane, rname)
                        chunks = []
                        for i in sel:
                            chunks.append(b"@%s\n%s\n+\n%s\n" % (
                                names[i], seq[i].tobytes(),
                                qual[i].tobytes()))
                        w.write(b"".join(chunks))
    finally:
        for w in writers.values():
            w.close()
    return dict(samples=counts, lanes=info.lanes,
                reads={**rnames, **inames})
