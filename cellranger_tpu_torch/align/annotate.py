"""Gene annotation of alignments (the reference's TranscriptAnnotator,
tx_annotation/src/transcript.rs:268-571).

Port of cellranger_tpu/align/annotate.py.  `AnnotationIndex.build` makes
the same numpy tables as the JAX package (a 128-base grid mapping a
read's end to its window in a packed, deduplicated interval table, plus a
per-junction (gene, strand) table); `make_annotator` is its
`annotate_impl` in torch.  Semantics: EXONIC when >= 50% of the read
overlaps an exon, INTRONIC when contained in a transcript span, sense vs
antisense by chemistry strandedness, exonic-sense genes beat
intronic-sense ones, and confidently mapped = MAPQ 255 with exactly one
gene.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import REGION_MIN_OVERLAP
from ..io.gtf import Transcriptome
from ..ops.tensor_ops import U32_MASK, u32_table, widen
from .index import GenomeIndex

GRID_SHIFT = 7       # 128-base annotation grid bins
ROW_E = 16           # intervals per packed table row

REGION_EXONIC = 0
REGION_INTRONIC = 1
REGION_INTERGENIC = 2

GENE_NONE = -1
GENE_MULTI = -2

_PAD_START = np.uint32(0xFFFFFFFF)  # never < any query end
KG = 4  # genes kept per read for the gene lists


def _pack_interval_rows(start, end, gene, strand, is_tx):
    """Sorted combined interval table (exons + transcript spans) ->
    [R+2, 3*ROW_E] uint32 rows: start*16 | end*16 | meta*16 with
    meta = gene | is_tx<<29 | strand<<30."""
    n = len(start)
    R = (n + ROW_E - 1) // ROW_E + 2
    rows = np.zeros((R, 3 * ROW_E), np.uint32)
    flat_s = np.full(R * ROW_E, _PAD_START, np.uint32)
    flat_e = np.zeros(R * ROW_E, np.uint32)
    flat_m = np.zeros(R * ROW_E, np.int32)
    flat_s[:n] = start.astype(np.uint32)
    flat_e[:n] = end.astype(np.uint32)
    flat_m[:n] = (gene | (is_tx.astype(np.int32) << 29)
                  | (strand.astype(np.int32) << 30))
    rows[:, :ROW_E] = flat_s.reshape(R, ROW_E)
    rows[:, ROW_E:2 * ROW_E] = flat_e.reshape(R, ROW_E)
    rows[:, 2 * ROW_E:3 * ROW_E] = flat_m.reshape(R, ROW_E).astype(np.uint32)
    return rows


def _build_grid(starts: np.ndarray, text_span: int) -> np.ndarray:
    """grid[g] = count of intervals with start < (g+1)*BIN."""
    gb = (text_span >> GRID_SHIFT) + 2
    bin_ends = (np.arange(gb, dtype=np.int64) + 1) << GRID_SHIFT
    return np.searchsorted(starts, bin_ends, side="left").astype(np.int32)


@dataclass(frozen=True)
class AnnotationIndex:
    """Annotation tables on one device (absolute text coordinates)."""

    iv_rows: torch.Tensor   # int32 bit-view of uint32 [R+2, 48]
    iv_grid: torch.Tensor   # int32 [GB]
    sj_rows: torch.Tensor   # int32 [J, 2]: (gene or GENE_MULTI, strand)
    n_genes: int = 0

    @staticmethod
    def host_arrays(txome: Transcriptome, gi: GenomeIndex) -> dict:
        """The numpy tables, built exactly as the JAX package builds them."""
        cidx = {n: i for i, n in enumerate(gi.chrom_names)}
        exs, exe, exg, exstr = [], [], [], []
        txs, txe, txg, txstr = [], [], [], []
        for t in txome.transcripts:
            if t.chrom not in cidx:
                continue
            c0 = int(gi.chrom_starts[cidx[t.chrom]])
            strand = 0 if t.strand == "+" else 1
            txs.append(c0 + t.start)
            txe.append(c0 + t.end)
            txg.append(t.gene_index)
            txstr.append(strand)
            for (s, e) in t.exons:
                exs.append(c0 + s)
                exe.append(c0 + e)
                exg.append(t.gene_index)
                exstr.append(strand)

        all_s = np.asarray(exs + txs, np.int64)
        all_e = np.asarray(exe + txe, np.int64)
        all_g = np.asarray(exg + txg, np.int64)
        all_st = np.asarray(exstr + txstr, np.int64)
        all_tx = np.concatenate([np.zeros(len(exs), np.int64),
                                 np.ones(len(txs), np.int64)])
        if len(all_s):
            arr = np.unique(np.stack(
                [all_s, all_e, all_g, all_st, all_tx], axis=1), axis=0)
            arr = arr[np.argsort(arr[:, 0], kind="stable")]
        else:
            arr = np.zeros((0, 5), np.int64)
        iv_start = arr[:, 0].astype(np.uint32)
        span = int(gi.genome_len)

        j_gene, j_strand = [], []
        txl = txome.transcripts
        by_key = dict(sorted(txome.junctions().items()))
        for i in range(gi.n_junctions):
            key = (gi.chrom_names[gi.sj_chrom[i]],
                   int(gi.sj_donor_end[i] - gi.chrom_starts[gi.sj_chrom[i]]),
                   int(gi.sj_acceptor_start[i] - gi.chrom_starts[gi.sj_chrom[i]]))
            tids = by_key.get(key, [])
            genes = {txl[t].gene_index for t in tids}
            strands = {txl[t].strand for t in tids}
            j_gene.append(genes.pop() if len(genes) == 1 else GENE_MULTI)
            j_strand.append(0 if strands == {"+"} else (1 if strands == {"-"} else 0))
        sj = np.stack([np.asarray(j_gene, np.int32),
                       np.asarray(j_strand, np.int32)], axis=1) \
            if j_gene else np.zeros((0, 2), np.int32)
        return dict(
            iv_rows=_pack_interval_rows(
                iv_start, arr[:, 1].astype(np.uint32),
                arr[:, 2].astype(np.int32), arr[:, 3].astype(np.int32),
                arr[:, 4].astype(np.int32)),
            iv_grid=_build_grid(iv_start, span),
            sj_rows=sj,
            n_genes=len(txome.genes))

    @staticmethod
    def from_numpy(arrays: dict, device) -> "AnnotationIndex":
        return AnnotationIndex(
            iv_rows=u32_table(arrays["iv_rows"], device),
            iv_grid=torch.from_numpy(
                np.asarray(arrays["iv_grid"], np.int32)).to(device),
            sj_rows=torch.from_numpy(
                np.asarray(arrays["sj_rows"], np.int32)).to(device),
            n_genes=int(arrays["n_genes"]))

    @staticmethod
    def build(txome: Transcriptome, gi: GenomeIndex,
              device) -> "AnnotationIndex":
        return AnnotationIndex.from_numpy(
            AnnotationIndex.host_arrays(txome, gi), device)

    @staticmethod
    def from_jax(jann, device) -> "AnnotationIndex":
        """The tables of a cellranger_tpu AnnotationIndex."""
        return AnnotationIndex.from_numpy(
            dict(iv_rows=np.asarray(jann.iv_rows),
                 iv_grid=np.asarray(jann.iv_grid),
                 sj_rows=np.asarray(jann.sj_rows), n_genes=jann.n_genes),
            device)


def _window_fetch(rows, grid, s, e):
    """Query intervals [s, e): (start, end, gene, strand, is_tx, valid)
    each [B, 2*ROW_E] -- the last <= 32 table intervals with start < e,
    masked to those overlapping [s, e).  Three row gathers."""
    GB = grid.shape[0]
    hi = grid[torch.clamp(e >> GRID_SHIFT, 0, GB - 1)].to(torch.int64)
    r = hi >> 4                                         # ROW_E = 16
    ra = widen(rows[torch.clamp_min(r - 1, 0)])         # [B, 48]
    rb = widen(rows[r])
    starts = torch.cat([ra[:, :ROW_E], rb[:, :ROW_E]], -1)
    ends = torch.cat([ra[:, ROW_E:2 * ROW_E], rb[:, ROW_E:2 * ROW_E]], -1)
    meta = torch.cat([ra[:, 2 * ROW_E:], rb[:, 2 * ROW_E:]], -1)
    j = torch.arange(2 * ROW_E, device=s.device)[None, :]
    eidx = (r[:, None] - 1) * ROW_E + j                 # global interval idx
    ok = (eidx >= 0) & (eidx < hi[:, None]) \
        & (starts < e[:, None]) & (ends > s[:, None])
    gene = meta & ((1 << 29) - 1)
    is_tx = (meta >> 29) & 1
    strand = (meta >> 30) & 1
    return starts, ends, gene, strand, is_tx, ok


def _distinct_sorted(vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-sort [B, W] gene ids; flag the first of each run of real genes."""
    gs = torch.sort(vals, 1).values
    distinct = torch.ones_like(gs, dtype=torch.bool)
    distinct[:, 1:] = gs[:, 1:] != gs[:, :-1]
    return gs, distinct & (gs != GENE_NONE)


def make_annotator(ann: AnnotationIndex, gi_genome_len: int, sj_overhang: int,
                   chemistry_strandedness: str = "+"):
    """Build annotate(pos, aln_len, strand, mapq, mapped) -> dict of gene,
    region, antisense, conf_mapped, gene_list, anti_list."""
    contig_len = 2 * sj_overhang
    n_sj = int(ann.sj_rows.shape[0])
    flip = chemistry_strandedness != "+"

    def annotate(pos, aln_len, strand, mapq, mapped):
        B = pos.shape[0]
        dev = pos.device
        s = pos.to(torch.int64) & U32_MASK      # full u32 coordinate space
        e = (s + aln_len) & U32_MASK
        strand = strand.to(torch.int64)

        # ---- genomic alignments: ONE combined interval window probe ----
        iv_s, iv_e, iv_g, iv_str, iv_tx, iov = _window_fetch(
            ann.iv_rows, ann.iv_grid, s, e)
        is_ex = iov & (iv_tx == 0)
        is_txs = iov & (iv_tx == 1)
        ov_len = torch.minimum(iv_e, e[:, None]) \
            - torch.maximum(iv_s, s[:, None])
        exonic_hit = is_ex & (ov_len.to(torch.float32)
                              >= REGION_MIN_OVERLAP
                              * aln_len[:, None].to(torch.float32))
        # sense: antisense iff (read_strand != tx_strand) xor chem '-'
        iv_sense = (iv_str == strand[:, None]) ^ flip
        exonic_sense = exonic_hit & iv_sense
        any_exonic = exonic_hit.any(1)
        ex_genes = torch.where(exonic_sense, iv_g, GENE_NONE)

        # intronic requires full containment in the transcript span
        intronic_hit = is_txs & (iv_s <= s[:, None]) & (iv_e >= e[:, None])
        any_intronic = intronic_hit.any(1)
        in_genes = torch.where(intronic_hit & iv_sense, iv_g, GENE_NONE)

        # exonic-sense genes win; intronic-sense genes count only without
        # an exonic-sense hit (include-introns mode)
        any_ex_sense = (ex_genes != GENE_NONE).any(1)
        none = torch.full_like(ex_genes, GENE_NONE)
        genes_all = torch.where(any_ex_sense[:, None],
                                torch.cat([ex_genes, none], 1),
                                torch.cat([none, in_genes], 1))
        gs, distinct = _distinct_sorted(genes_all)
        is_gene = gs != GENE_NONE
        n_genes = distinct.sum(1)
        first_gene = torch.where(is_gene, gs, GENE_NONE).amax(1)
        gene_genomic = torch.where(
            n_genes == 1, first_gene,
            torch.where(n_genes > 1, GENE_MULTI, GENE_NONE))
        region_genomic = torch.where(
            any_exonic, REGION_EXONIC,
            torch.where(any_intronic, REGION_INTRONIC, REGION_INTERGENIC))
        any_sense = n_genes > 0
        anti_ex = (exonic_hit & ~iv_sense).any(1)
        antisense_genomic = ~any_sense & anti_ex

        # ---- junction-contig alignments: one row gather ----
        in_sj = s >= gi_genome_len
        if n_sj > 0:
            j = torch.clamp(torch.where(in_sj, s - gi_genome_len, 0)
                            // contig_len, 0, n_sj - 1)
            sjr = ann.sj_rows[j].to(torch.int64)          # [B, 2]
            sjg = sjr[:, 0]
            sj_sense = (sjr[:, 1] == strand) ^ flip
            gene_sj = torch.where(sj_sense & (sjg >= 0), sjg, GENE_NONE)
            anti_sj = ~sj_sense
        else:
            gene_sj = torch.full((B,), GENE_NONE, dtype=torch.int64,
                                 device=dev)
            anti_sj = torch.zeros(B, dtype=torch.bool, device=dev)

        gene = torch.where(in_sj, gene_sj, gene_genomic)
        region = torch.where(in_sj, REGION_EXONIC, region_genomic)
        antisense = torch.where(in_sj, anti_sj, antisense_genomic)

        # ---- per-read gene lists (BAM TX/AN tag payloads) ----
        sense_vals = torch.where(distinct, gs, GENE_NONE)
        sense_top = torch.topk(sense_vals, KG, 1).values      # [B, KG] desc
        anti_hits = (exonic_hit | intronic_hit) & ~iv_sense
        ga, anti_distinct = _distinct_sorted(
            torch.where(anti_hits, iv_g, GENE_NONE))
        anti_top = torch.topk(torch.where(anti_distinct, ga, GENE_NONE),
                              KG, 1).values
        sj_col = torch.where(in_sj & (gene >= 0), gene, GENE_NONE)
        if n_sj > 0:
            sj_anti_col = torch.where(in_sj & anti_sj & (sjg >= 0), sjg,
                                      GENE_NONE)
        else:
            sj_anti_col = torch.full((B,), GENE_NONE, dtype=torch.int64,
                                     device=dev)
        pad = torch.full((B, KG - 1), GENE_NONE, dtype=torch.int64,
                         device=dev)
        sense_top = torch.where(in_sj[:, None],
                                torch.cat([sj_col[:, None], pad], 1),
                                sense_top)
        anti_top = torch.where(in_sj[:, None],
                               torch.cat([sj_anti_col[:, None], pad], 1),
                               anti_top)

        conf_mapped = mapped & (mapq == 255) & (gene >= 0)
        return dict(gene=gene, region=region, antisense=antisense,
                    conf_mapped=conf_mapped,
                    gene_list=sense_top, anti_list=anti_top)

    return annotate
