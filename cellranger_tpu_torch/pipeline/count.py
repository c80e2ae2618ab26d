"""The `count` pipeline: FASTQ -> filtered feature x barcode matrix, BAM.

Port of cellranger_tpu/pipeline/count.py `run_count`, on one device, on
a mesh of devices (parallel/mesh.py) and across hosts
(parallel/distributed.py):

  pass 1 (== MAKE_SHARD): host barcode histogram over the whitelist (the
      correction prior);
  pass 2 (== BARCODE_CORRECTION + ALIGN_AND_COUNT): a producer thread
      decodes FASTQs, resolves barcodes on the host and packs each Gene
      Expression batch into one u32 plane; the device step trims, aligns
      (SW rescue through the CUDA kernel on the card), annotates and
      promotes multimappers; paired-end chemistries (SC5P-PE) carry the
      mate in the same plane, align it too and combine the pair.
      Count-only runs step in accumulate mode
      (confidently mapped (bc, gene, umi) rows appended into device
      buffers that the host drains in bulk); BAM runs step in stream mode
      (per-read outputs fetched every batch into the BAM band spool).
      Feature Barcode libraries are extracted and matched on the device.
      RTL runs (probe_set_csv) have no genome index: each batch is aligned
      to the probe set on the device (ops/probes.py) and, for MFRP
      chemistries, lands in the (gel-bead x probe-barcode) product
      barcode space;
  dedup (== mark_dups.rs): count-only rows dedup in the device molecule
      state; BAM and Feature Barcode rows, and count-only runs past the
      state's capacity, spill to barcode-hash partitions deduplicated one
      group at a time, keeping the raw-triple views the BAM joins against;
  outputs: raw/filtered matrices (MEX and h5, io/hdf5.py), aggregate
      removal and cell calls, possorted BAM, molecule_info.h5,
      junctions, feature assignment, secondary analysis
      (analysis/, on the run's device), metrics JSON.

On a mesh, each batch splits over the devices and every slice runs the
stream step on its own device (the kmer table sharded over the mesh with
`shard_index`); the molecule rows spill and the partition dedup runs one
partition per device.  Across hosts (the CRTPU_* environment contract),
each host counts its share of the FASTQ pairs, the pass-1 histogram is
summed over hosts, and host 0 merges every host's spill and metrics.
Chemistry "auto" is resolved by pipeline/detect_chemistry.py before
run_count, as in the JAX package.  The host stages are the port's
verbatim copies of the JAX package's jax-free modules.
"""

from __future__ import annotations

import glob
import json
import os
import queue as _queue
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis import cell_calling
from ..io.chemistry import get_chemistry
from ..io.matrix_io import CountMatrix, FeatureDef, FeatureReference
from .spill import MoleculeSpill
from ..align.aligner import DeviceIndex, make_aligner
from ..align.annotate import (GENE_MULTI, GENE_NONE, REGION_EXONIC,
                              REGION_INTERGENIC, REGION_INTRONIC,
                              AnnotationIndex, make_annotator)
from ..io.fastq import batches_from_fastqs
from ..io.feature_ref import FeatureBarcodeReference
from ..io.reference import ReferencePackage
from ..io.whitelist import Whitelist
from ..ops import barcode as bcops
from ..ops import encode
from ..ops.bucket_table import BucketTable
from ..ops.features import make_feature_extractor
from ..ops.tensor_ops import U32_MASK, compact_indices, scatter_drop, widen
from ..ops.trim import make_trimmer
from ..parallel import distributed as dist
from ..parallel.executor import Executor
from ..parallel.index_shard import shard_device_index
from ..parallel.mesh import to_device
from ..parallel.molecule_state import MoleculeState, split_partition
from .bam_out import BamCollector


@dataclass
class LibraryDef:
    """One sequencing library of a run (LibrariesCsv row)."""

    fastq_pairs: list[tuple[str, str | None]]
    library_type: str = "Gene Expression"


@dataclass
class CountConfig:
    """The JAX package's CountConfig, field for field."""

    fastq_pairs: list[tuple[str, str | None]]
    reference_path: str | None = None
    whitelist_path: str | None = None
    probe_set_csv: str | None = None
    feature_ref_csv: str | None = None
    libraries: list[LibraryDef] | None = None
    chemistry: str = "SC3Pv3"
    read_len: int = 91
    batch_size: int = 8192
    recovered_cells: int | None = None
    force_cells: int | None = None
    cell_calling_mode: str = "auto"
    max_mito_percent: float = 100.0
    global_minimum_umis: int = 0
    sample_id: str = "sample"
    gem_group: int = 1
    write_bam: bool = False
    secondary_analysis: bool = True
    probe_barcode_csv: str | None = None
    checkpoint: bool = True
    shard_index: bool = False


@dataclass
class CountMetrics:
    total_reads: int = 0
    valid_barcode_reads: int = 0
    corrected_barcode_reads: int = 0
    valid_umi_reads: int = 0
    mapped_reads: int = 0
    conf_mapped_reads: int = 0
    exonic_reads: int = 0
    intronic_reads: int = 0
    intergenic_reads: int = 0
    antisense_reads: int = 0
    usable_reads: int = 0  # valid bc + valid umi + conf mapped
    total_molecules: int = 0
    q30_bc_bases: int = 0
    bc_bases: int = 0
    q30_umi_bases: int = 0
    umi_bases: int = 0
    q30_rna_bases: int = 0
    rna_bases: int = 0
    correction_capacity_overflow: int = 0
    correction_retries: int = 0
    tso_reads: int = 0
    polya_trimmed_reads: int = 0
    improper_pair_reads: int = 0
    promote_overflow: int = 0
    sj_capacity_overflow: int = 0

    def to_dict(self, extra: dict | None = None) -> dict:
        d = dict(self.__dict__)
        t = max(self.total_reads, 1)
        d["valid_barcode_frac"] = self.valid_barcode_reads / t
        d["valid_umi_frac"] = self.valid_umi_reads / t
        d["mapped_frac"] = self.mapped_reads / t
        d["conf_mapped_frac"] = self.conf_mapped_reads / t
        d["antisense_frac"] = self.antisense_reads / t
        d["sequencing_saturation"] = (
            1.0 - self.total_molecules / self.usable_reads
            if self.usable_reads else 0.0)
        d["q30_barcode_frac"] = self.q30_bc_bases / max(self.bc_bases, 1)
        d["q30_umi_frac"] = self.q30_umi_bases / max(self.umi_bases, 1)
        d["q30_rna_frac"] = self.q30_rna_bases / max(self.rna_bases, 1)
        d["tso_frac"] = self.tso_reads / t
        if extra:
            d.update(extra)
        return d


# the molecule gene column carries the library index in its high bits, so
# molecules stay distinct per library through dedup (stripped after)
LIB_SHIFT = 24
LIB_MASK = np.uint32((1 << LIB_SHIFT) - 1)

# ---- stream-mode step output: three planes, one fetch each per batch ----
# every [B] integer column rides one [B, NI] int32 plane (u32 columns as
# their int32 bits), booleans one [B, NB] bool plane, scalar metrics one
# [NM] int32 vector; the layout of the JAX package
I32_FIELDS = ("gene", "pos", "mapq", "strand", "aln_len", "aln_start",
              "region", "sj_donor", "sj_acceptor", "sj_right_len",
              "gene_unpaired")
# mate-2 columns appended for paired-end chemistries (presence inferred
# from the i32 plane width in unpack_step_out)
PE_I32_FIELDS = ("pos2", "mapq2", "strand2", "aln_len2", "aln_start2")
U32_FIELDS = frozenset(("gene", "pos", "sj_donor", "sj_acceptor", "pos2"))
BOOL_FIELDS = ("conf_ok", "mapped", "antisense", "novel_sj", "mm",
               "gene_discordant")
METRIC_FIELDS = ("n_mapped", "n_conf", "n_exonic", "n_intronic",
                 "n_intergenic", "n_antisense", "n_usable",
                 "n_promote_overflow", "n_tso", "n_polya_trimmed",
                 "n_improper_pair")
KG_LIST = 4  # gene_list/anti_list columns appended after I32_FIELDS

SECOND_CAP_FRAC = 4    # 2nd-locus / novel-SJ annotation capacity = B // 4
MAX_INSERT = 2000      # max genomic span of a proper read pair
# distinct (bc, gene, umi) rows the device molecule state holds before it
# flushes to the host (read at run time, so a caller may lower it)
MOLECULE_STATE_CAP = 1 << 23
# rows of the step's molecule buffer, drained into the state when the next
# batch might not fit (read at run time: a small value drains often)
MOLECULE_BUFFER_ROWS = 1 << 20
# Rows of one device call of the partition dedup (ops/dedup.py
# dedup_molecules, padded to _pow2(DEDUP_CHUNK_LIMIT) rows) and the device
# memory that call may take.  Eager torch keeps every intermediate of the
# sort pipeline that XLA fuses: 2,976 bytes a padded row at 2**20-2**23
# rows on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (chip_smoke.py
# dedup_memory), so 12.48 GB at 2**22, where the JAX package's 1 << 26
# would need ~200 GB
DEDUP_CHUNK_LIMIT = 1 << 22
DEDUP_BUDGET_BYTES = 16 * 10**9
SPILL_PARTS = 8              # barcode-hash spill partitions
# the HDF5 outputs (written through io/hdf5.py)
H5_OUTPUTS = ("raw_feature_bc_matrix.h5", "filtered_feature_bc_matrix.h5",
              "molecule_info.h5")


def unpack_step_out(out) -> tuple[dict, dict]:
    """Host stream-step output (numpy planes, `fetch_step_out`) -> (ho:
    named host arrays, m: metrics), with the JAX package's dtypes: uint32
    views for U32_FIELDS and sec_pos, int32 for the other columns, bool
    flags.

    Plane width decides the layout: [I32_FIELDS, (PE_I32_FIELDS), 2 x
    KG_LIST gene lists, (4 x S secondary-locus columns)].  Single-end and
    paired widths differ by 5 and secondary blocks come in multiples of 4,
    so the widths never collide."""
    i32 = np.asarray(out["i32"])
    flags = np.asarray(out["flags"])
    mvec = np.asarray(out["mvec"])
    ho: dict = {}
    w = i32.shape[1]
    base_se = len(I32_FIELDS) + 2 * KG_LIST
    base_pe = base_se + len(PE_I32_FIELDS)
    if (w - base_se) % 4 == 0:
        names, n_sec = I32_FIELDS, (w - base_se) // 4
    else:
        names, n_sec = I32_FIELDS + PE_I32_FIELDS, (w - base_pe) // 4
    n = len(names)
    for j, k in enumerate(names):
        col = i32[:, j]
        ho[k] = col.view(np.uint32) if k in U32_FIELDS else col
    ho["gene_list"] = i32[:, n:n + KG_LIST]
    ho["anti_list"] = i32[:, n + KG_LIST:n + 2 * KG_LIST]
    if n_sec > 0:
        o = n + 2 * KG_LIST
        ho["sec_pos"] = np.ascontiguousarray(
            i32[:, o:o + n_sec]).view(np.uint32)
        ho["sec_len"] = i32[:, o + n_sec:o + 2 * n_sec]
        ho["sec_start"] = i32[:, o + 2 * n_sec:o + 3 * n_sec]
        ho["sec_strand"] = i32[:, o + 3 * n_sec:o + 4 * n_sec]
        ho["sec_ok"] = flags[:, len(BOOL_FIELDS):len(BOOL_FIELDS) + n_sec]
    for j, k in enumerate(BOOL_FIELDS):
        ho[k] = flags[:, j]
    m = {k: int(v) for k, v in zip(METRIC_FIELDS, mvec)}
    return ho, m


def fetch_step_out(out: dict) -> dict:
    """Stream-step output -> numpy planes.  On the card the planes were
    copied into pinned host buffers behind the step (`make_stream_step`);
    this waits for that copy only, not for work queued after it."""
    ev = out.get("event")
    if ev is not None:
        ev.synchronize()
    return {k: out[k].numpy() for k in ("i32", "flags", "mvec")}


# ---- packed step input: ONE u32 plane per batch ----
# Per-read words: 0 bc_idx (int32 bits; whitelist rank or -1), 1 umi
# 2-bit packed, 2 flags (bit0 slot_valid, bit1 umi_valid), 3.. cDNA codes
# 2-bit packed (16 bases/word) then nmask bits (32/word); paired-end
# chemistries append the mate's codes + mask.
def _codes_words(read_len: int) -> tuple[int, int]:
    """(code words, nmask words) per read for a packed cDNA plane."""
    return (read_len + 15) // 16, (read_len + 31) // 32


def packed_width(chem, read_len: int) -> int:
    rw, nw = _codes_words(read_len)
    return 3 + (rw + nw) * (2 if chem.rna2 is not None else 1)


def _pack_codes_into(buf: np.ndarray, o: int, codes, nmask, L: int) -> int:
    """2-bit-pack codes [B, L] + bit-pack nmask into buf columns at o."""
    rw, nw = _codes_words(L)
    B = len(codes)
    c = codes
    if c.shape[1] < rw * 16:
        c = np.pad(c, ((0, 0), (0, rw * 16 - c.shape[1])))
    c = c.reshape(B, rw, 16).astype(np.uint32)
    w = np.zeros((B, rw), np.uint32)
    for k in range(16):
        w |= c[:, :, k] << np.uint32(2 * (15 - k))
    buf[:, o:o + rw] = w
    mb = np.packbits(np.ascontiguousarray(nmask[:, :L]), axis=1,
                     bitorder="little")
    if mb.shape[1] < nw * 4:
        mb = np.pad(mb, ((0, 0), (0, nw * 4 - mb.shape[1])))
    buf[:, o + rw:o + rw + nw] = np.ascontiguousarray(mb).view(np.uint32)
    return o + rw + nw


def pack_step_input(chem, read_len: int, batch,
                    bc_idx: np.ndarray) -> np.ndarray:
    """Host: assemble the single uint32 input plane for one batch."""
    B = batch.batch_size
    buf = np.zeros((B, packed_width(chem, read_len)), np.uint32)
    buf[:, 0] = np.asarray(bc_idx, np.int32).view(np.uint32)
    buf[:, 1] = batch.umi_packed
    buf[:, 2] = (batch.slot_valid.astype(np.uint32)
                 | (batch.umi_valid.astype(np.uint32) << 1))
    o = _pack_codes_into(buf, 3, batch.rna, batch.rna_nmask, read_len)
    if chem.rna2 is not None:
        _pack_codes_into(buf, o, batch.rna2, batch.rna2_nmask, read_len)
    return buf


def upload_plane(buf: np.ndarray, device) -> torch.Tensor:
    """uint32 plane -> int32 bit-view tensor on the device."""
    return torch.from_numpy(buf.view(np.int32)).to(device)


def _unpack_codes(buf: torch.Tensor, o: int, L: int):
    """Packed u32 columns at o -> (codes uint8 [B, L], nmask bool)."""
    rw, nw = _codes_words(L)
    B = buf.shape[0]
    dev = buf.device
    w = buf[:, o:o + rw]
    shifts = 2 * (15 - torch.arange(16, device=dev))
    codes = ((w[:, :, None] >> shifts) & 3).to(torch.uint8) \
        .reshape(B, rw * 16)[:, :L]
    mw = buf[:, o + rw:o + rw + nw]
    bits = ((mw[:, :, None] >> torch.arange(32, device=dev)) & 1) \
        .to(torch.bool).reshape(B, nw * 32)[:, :L]
    return codes, bits


def _make_body(didx: DeviceIndex, ann_idx: AnnotationIndex, chem,
               read_len: int, emit_secondary: bool = False,
               seed_lookup=None):
    """The fused per-batch device work shared by both step modes (port of
    `_make_step`'s `_body`): unpack, trim, align (SW rescue through the
    CUDA kernel on the card), annotate, novel-junction right segments,
    multi-locus promotion and, for paired-end chemistries, the mate
    combination (mate 2 goes through the same aligner, so the SW kernel
    launches twice per batch).  Returns body(plane) -> dict of [B] tensors
    (u32 values in int64) + metrics.

    emit_secondary (single-end BAM runs): also output the other distinct
    best-score loci of multimapped reads (sec_*) for the BAM's secondary
    records (tx_annotation/src/read.rs:155,224-226).  seed_lookup: the
    aligner's kmer lookup when the kmer table is sharded over a mesh."""
    align = make_aligner(didx, read_len, seed_lookup=seed_lookup)
    annotate = make_annotator(ann_idx, didx.genome_len, didx.sj_overhang,
                              chem.strandedness)
    trim = make_trimmer(read_len)
    dev = didx.text_rows.device
    paired = chem.rna2 is not None
    glen = didx.genome_len
    rw, nw = _codes_words(read_len)

    def body(plane):
        B = plane.shape[0]
        buf = widen(plane)
        bc_idx = plane[:, 0].to(torch.int64)          # signed: -1 = none
        umi_packed = buf[:, 1]
        flags_in = buf[:, 2]
        slot_valid = (flags_in & 1) > 0
        umi_valid = (flags_in & 2) > 0
        rna, rna_nmask = _unpack_codes(buf, 3, read_len)
        if paired:
            rna2, rna2_nmask = _unpack_codes(buf, 3 + rw + nw, read_len)
        bc_ok = (bc_idx >= 0) & slot_valid

        # ---- TSO/polyA trimming: mask, don't move ----
        tr = trim(rna, rna_nmask)
        rna_nmask = tr["nmask"]

        aln = align(rna, rna_nmask)
        ann = annotate(aln["pos"], aln["aln_len"], aln["strand"],
                       aln["mapq"], aln["mapped"])

        # ---- novel-splice right-segment annotation (compacted) ----
        C3 = max(B // SECOND_CAP_FRAC, 1)
        nsj = aln["novel_sj"] & aln["mapped"]
        nsel = compact_indices(nsj, C3, B)
        nsel_c = torch.clamp_max(nsel, B - 1)
        ann_r = annotate(aln["sj_acceptor"][nsel_c],
                         aln["sj_right_len"][nsel_c], aln["strand"][nsel_c],
                         torch.full((C3,), 255, device=dev),
                         torch.ones(C3, dtype=torch.bool, device=dev))
        gr = scatter_drop(torch.full((B,), -1, dtype=torch.int64, device=dev),
                          nsel, ann_r["gene"])
        rr = scatter_drop(torch.full((B,), REGION_INTERGENIC,
                                     dtype=torch.int64, device=dev),
                          nsel, ann_r["region"])
        gl = ann["gene"]
        g_comb = torch.where((gl >= 0) & ((gr == gl) | (gr < 0)), gl,
                             torch.where((gl < 0) & (gr >= 0), gr, -1))
        gene_n = torch.where(nsj, g_comb, gl)
        # read region = worst segment region (exonic only if both are)
        region_n = torch.where(nsj, torch.maximum(ann["region"], rr),
                               ann["region"])
        conf_n = torch.where(nsj, (aln["mapq"] == 255) & (gene_n >= 0),
                             ann["conf_mapped"])
        ann = dict(ann, gene=gene_n, region=region_n, conf_mapped=conf_n)

        # ---- compacted multi-locus annotation (gene promotion,
        # tx_annotation/src/read.rs:117-149) over (read, locus) pairs ----
        ND = aln["loci_pos"].shape[1]
        C2 = max(B // SECOND_CAP_FRAC, 1)
        need2 = (aln["mapped"] & (aln["n_best"] >= 2) & ~ann["conf_mapped"]
                 & ~aln["saturated"])
        pair_ok = need2[:, None] & aln["loci_ok"][:, 1:]     # [B, ND-1]
        NP = B * (ND - 1)
        selp = compact_indices(pair_ok.reshape(-1), C2, NP)
        selp_c = torch.clamp_max(selp, NP - 1)
        lp = aln["loci_pos"][:, 1:].reshape(-1)[selp_c]
        ll = aln["loci_len"][:, 1:].reshape(-1)[selp_c]
        lst = aln["loci_strand"][:, 1:].reshape(-1)[selp_c]
        ann2_c = annotate(lp, ll, lst, torch.full((C2,), 255, device=dev),
                          torch.ones(C2, dtype=torch.bool, device=dev))
        g_loci = scatter_drop(
            torch.full((NP,), GENE_NONE, dtype=torch.int64, device=dev),
            selp, ann2_c["gene"]).reshape(B, ND - 1)
        # a read takes part only if ALL its pairs got slots
        fits = torch.cumsum(pair_ok.sum(1), 0) <= C2
        genes_all = torch.cat([ann["gene"][:, None], g_loci], 1)
        any_multi = (genes_all == GENE_MULTI).any(1)
        gs2 = torch.sort(genes_all, 1).values
        isg = gs2 >= 0
        dist2 = torch.ones_like(isg)
        dist2[:, 1:] = gs2[:, 1:] != gs2[:, :-1]
        n_genes2 = (dist2 & isg).sum(1)
        mm_gene = torch.where(isg, gs2, -1).amax(1)
        promoted = need2 & fits & (n_genes2 == 1) & ~any_multi
        gene_eff = torch.where(promoted, mm_gene, ann["gene"])
        conf_eff = ann["conf_mapped"] | promoted
        mapq_eff = torch.where(promoted, 255, aln["mapq"])

        # ---- paired-end mate combination (aligner.rs:422 align_read_pair,
        # read.rs:88-104 annotate_read_pe, transcript.rs:27 from_pair) ----
        # mate 2 aligns independently; a PROPER pair = both mates mapped,
        # opposite genomic strands, within the insert bound (or either on
        # a junction contig).  Pair gene = the non-empty mate's gene, or
        # the agreement when both are non-empty.  An improper pair is
        # unmapped as a whole (read.rs:1142-1152).
        gene_discordant = torch.zeros(B, dtype=torch.bool, device=dev)
        gene_unpaired = gene_eff
        n_improper = torch.zeros((), dtype=torch.int64, device=dev)
        pe_out = {}
        if paired:
            # mate 2 is NOT adapter-trimmed (aligner.rs:399-402) and reads
            # toward the 5' end: its sense is the flip of its own strand
            aln2 = align(rna2, rna2_nmask)
            ann2 = annotate(aln2["pos"], aln2["aln_len"],
                            aln2["strand"] ^ 1, aln2["mapq"], aln2["mapped"])
            p1, p2 = aln["pos"], aln2["pos"]      # u32 values in int64
            on_contig = (p1 >= glen) | (p2 >= glen)
            proper = (aln["mapped"] & aln2["mapped"]
                      & (aln2["strand"] != aln["strand"])
                      & (on_contig | ((p2 - p1).abs() <= MAX_INSERT)))
            g1, g2 = gene_eff, ann2["gene"]
            pair_gene = torch.where(
                g2 == GENE_NONE, g1,
                torch.where(g1 == GENE_NONE, g2,
                            torch.where(g1 == g2, g1,
                                        torch.where(g1 == GENE_MULTI, g2,
                                                    torch.where(
                                                        g2 == GENE_MULTI, g1,
                                                        GENE_NONE)))))
            n_improper = ((aln["mapped"] | aln2["mapped"]) & ~proper
                          & slot_valid).sum()
            gene_eff = torch.where(proper, pair_gene, GENE_NONE)
            conf_eff = proper & (mapq_eff == 255) & (gene_eff >= 0)
            # mates each hit a specific gene but disagree -> xf
            # GENE_DISCORDANT + per-mate gX/gN tags (read.rs:1311-1319)
            gene_discordant = proper & (g1 >= 0) & (g2 >= 0) & (g1 != g2)
            aln = dict(aln, mapped=proper)
            mapq_eff = torch.where(proper, mapq_eff, 0)
            # mate-2 coordinates for the paired BAM records; an improper
            # pair is unmapped as a whole, so its mate-2 MAPQ is 0 too
            pe_out = dict(
                pos2=p2, mapq2=torch.where(proper, aln2["mapq"], 0),
                strand2=aln2["strand"], aln_len2=aln2["aln_len"],
                aln_start2=aln2["aln_start"])

        conf_ok = conf_eff & bc_ok & umi_valid & slot_valid
        mapped = aln["mapped"] & slot_valid
        region = ann["region"]
        m = dict(
            n_mapped=mapped.sum(),
            n_conf=(conf_eff & slot_valid).sum(),
            n_exonic=(mapped & (region == REGION_EXONIC)).sum(),
            n_intronic=(mapped & (region == REGION_INTRONIC)).sum(),
            n_intergenic=(mapped & (region == REGION_INTERGENIC)).sum(),
            n_antisense=(mapped & ann["antisense"]).sum(),
            n_usable=conf_ok.sum(),
            n_promote_overflow=(need2 & ~fits).sum(),
            n_tso=(tr["matched_tso"] & slot_valid).sum(),
            n_polya_trimmed=((tr["polya_trimmed"] > 0) & slot_valid).sum(),
            n_improper_pair=n_improper,
        )
        out = dict(
            bc=bc_idx & U32_MASK, umi=umi_packed,
            gene=torch.clamp_min(gene_eff, 0), conf_ok=conf_ok,
            pos=aln["pos"], mapq=mapq_eff, strand=aln["strand"],
            mapped=mapped, aln_len=aln["aln_len"],
            aln_start=aln["aln_start"], region=region,
            antisense=ann["antisense"], novel_sj=aln["novel_sj"],
            sj_donor=aln["sj_donor"], sj_acceptor=aln["sj_acceptor"],
            sj_right_len=aln["sj_right_len"],
            # BAM tag payloads: mm (rescued multimapper), TX/AN gene lists,
            # paired-end gene discordance + unpaired gene (gX/gN)
            mm=promoted, gene_list=ann["gene_list"],
            anti_list=ann["anti_list"],
            gene_discordant=gene_discordant, gene_unpaired=gene_unpaired,
            metrics=m, **pe_out)
        if emit_secondary and not paired and ND > 1:
            # other distinct best-score loci of multimapped reads, one
            # secondary BAM record each; promoted reads keep theirs
            # (demoted to MAPQ 0 by the writer, read.rs:152-156)
            out.update(
                sec_pos=aln["loci_pos"][:, 1:], sec_len=aln["loci_len"][:, 1:],
                sec_start=aln["loci_start"][:, 1:],
                sec_strand=aln["loci_strand"][:, 1:],
                sec_ok=(aln["loci_ok"][:, 1:] & mapped[:, None]
                        & (aln["n_best"] >= 2)[:, None]))
        return out

    return body


def make_count_step(didx: DeviceIndex, ann_idx: AnnotationIndex, chem,
                    read_len: int):
    """The accumulate-mode device step (port of `_make_step(...,
    accumulate=True)`).

    Returns step(plane, acc, lib_tag) which runs one packed batch and
    appends into the device buffers of `acc` IN PLACE (the JAX package
    donates them instead); step.init_acc(mol_cap, sj_cap) makes them.
    The caller keeps acc['mol_n'] + B <= mol_cap and acc['sj_n'] +
    max(B // 4, 64) <= sj_cap."""
    body = _make_body(didx, ann_idx, chem, read_len)
    dev = didx.text_rows.device
    n_sj = int(didx.sj_rows.shape[0])
    glen = didx.genome_len
    contig2 = 2 * didx.sj_overhang

    def step(plane, acc, lib_tag: int = 0):
        out = body(plane)
        m = out["metrics"]
        B = plane.shape[0]
        ar = torch.arange(B, device=dev)
        conf = out["conf_ok"]
        sel = torch.clamp_max(compact_indices(conf, B, B), B - 1)
        rows = torch.stack([out["bc"][sel], out["gene"][sel] | lib_tag,
                            out["umi"][sel]], 1)
        acc["mol"].index_copy_(0, acc["mol_n"] + ar, rows)
        acc["mol_n"] += conf.sum()
        # novel splice junctions: one row per unique-mapper read (capped)
        m255 = out["mapped"] & (out["mapq"] == 255)
        nsj = out["novel_sj"] & m255
        SJB = max(B // 4, 64)
        seljc = torch.clamp_max(compact_indices(nsj, SJB, B), B - 1)
        sj_rows = torch.stack([out["sj_donor"][seljc],
                               out["sj_acceptor"][seljc],
                               out["strand"][seljc]], 1)
        acc["sj"].index_copy_(
            0, acc["sj_n"] + torch.arange(SJB, device=dev), sj_rows)
        n_nsj = nsj.sum()
        acc["sj_n"] += torch.clamp_max(n_nsj, SJB)
        n_sj_over = torch.clamp_min(n_nsj - SJB, 0)
        # annotated-junction contig hits: histogram over (junction, strand)
        on_contig = m255 & (out["pos"] >= glen) & ~nsj
        ji = torch.where(on_contig, out["pos"] - glen, 0) // contig2
        hidx = torch.where(on_contig, ji * 2 + out["strand"], 0)
        acc["sjh"].index_add_(0, hidx, on_contig.to(torch.int64))
        acc["mvec"] += torch.stack([m[k] for k in METRIC_FIELDS]
                                   + [n_sj_over])

    def init_acc(mol_cap: int, sj_cap: int) -> dict:
        z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)  # noqa
        return dict(mol=z(mol_cap, 3), mol_n=z(), sj=z(sj_cap, 3), sj_n=z(),
                    sjh=z(max(2 * n_sj, 1)), mvec=z(len(METRIC_FIELDS) + 1))

    step.init_acc = init_acc
    return step


def _pack_stream(out: dict) -> dict:
    """Step outputs -> the three stream planes (int32 bits of u32 values;
    int64 -> int32 keeps the low 32 bits)."""
    i32 = lambda a: a.to(torch.int32)  # noqa: E731
    names = I32_FIELDS + (PE_I32_FIELDS if "pos2" in out else ())
    cols = [i32(out[k])[:, None] for k in names]
    cols += [i32(out["gene_list"]), i32(out["anti_list"])]
    if "sec_pos" in out:
        cols += [i32(out[k]) for k in ("sec_pos", "sec_len", "sec_start",
                                       "sec_strand")]
    flags = torch.stack([out[k] for k in BOOL_FIELDS], 1)
    if "sec_ok" in out:
        flags = torch.cat([flags, out["sec_ok"]], 1)
    m = out["metrics"]
    mvec = torch.stack([m[k] for k in METRIC_FIELDS]).to(torch.int32)
    return dict(i32=torch.cat(cols, 1), flags=flags, mvec=mvec)


def host_copy(planes: dict) -> dict:
    """Stream planes -> host.  On the card the planes are copied into
    pinned host buffers on the device stream and an event marks the copy
    (`fetch_step_out` waits for it), so the host can read batch i while
    batch i+1 runs; CPU planes are returned as they are."""
    dev = planes["i32"].device
    if dev.type != "cuda":
        return planes
    host = {}
    with torch.cuda.device(dev):
        for k, v in planes.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        host["event"] = torch.cuda.Event()
        host["event"].record()
    return host


def make_stream_step(didx: DeviceIndex, ann_idx: AnnotationIndex, chem,
                     read_len: int, emit_secondary: bool = False,
                     seed_lookup=None):
    """The stream-mode device step (port of `_make_step(...,
    accumulate=False, emit_secondary=...)`): step(plane) -> dict(i32,
    flags, mvec) planes on the host (`host_copy`), read back per batch
    with `fetch_step_out` and named by `unpack_step_out`.  step.planes is
    the same step with its planes left on the device, the form a mesh
    concatenates (parallel/mesh.make_sharded_step)."""
    body = _make_body(didx, ann_idx, chem, read_len, emit_secondary,
                      seed_lookup)

    def planes(plane):
        return _pack_stream(body(plane))

    def step(plane):
        return host_copy(planes(plane))

    step.planes = planes
    return step


def _check_supported(cfg: CountConfig, mesh=None,
                     multihost: bool = False) -> None:
    """Refuse what run_count does not run: chemistry "auto" (resolved by
    detect_chemistry first), and a mesh inside a multi-host run, which the
    JAX package never runs either (its multi-host runs pass no mesh)."""
    if cfg.chemistry == "auto":
        raise NotImplementedError(
            "cellranger_tpu_torch: run_count does not resolve chemistry "
            "'auto' itself; call pipeline.detect_chemistry.detect_chemistry "
            "first (as the CLI does) and pass the chemistry it names")
    if mesh is not None and multihost:
        raise ValueError(
            "cellranger_tpu_torch: a mesh inside a multi-host run is not "
            "supported: across hosts only host arrays travel (gloo), so "
            "each host runs on one device (ROADMAP, multi-host)")


@dataclass
class Hosts:
    """This process's place in a multi-host run."""

    pid: int
    nproc: int
    resume: bool                 # every host's pass 2 is durable on disk
    fingerprint: str | None      # count_fingerprint, when resumable


def _join_hosts(cfg: CountConfig, out_dir: str) -> Hosts:
    """The multi-host prologue, the same collectives in the same order on
    every host.  Resume is unanimous: a host whose partial
    (_spill/host{pid}.json, written after its spill flushed) carries this
    run's fingerprint votes yes, and the votes are summed, since a fresh
    run's clean below would delete the spill of hosts that finished.
    BAM, Feature Barcode and probe runs keep per-read state outside the
    spill and always rerun.  A fresh run has host 0 clear stale spill
    files and BAM spools (a smaller host set would otherwise leave files
    that `load_union` merges) behind a barrier."""
    pid, nproc = dist.process_index(), dist.process_count()
    spill_dir = os.path.join(out_dir, "_spill")
    fp, resume = None, False
    if (cfg.checkpoint and not cfg.write_bam and not cfg.probe_set_csv
            and not cfg.feature_ref_csv):
        from .checkpoint import count_fingerprint
        fp = count_fingerprint(cfg)
        try:
            with open(os.path.join(spill_dir, f"host{pid}.json")) as f:
                mine_ok = json.load(f).get("fingerprint") == fp
        except (OSError, ValueError):
            mine_ok = False
        votes = dist.allsum_array(np.array([1 if mine_ok else 0]))
        resume = int(votes[0]) == nproc
    if not resume:
        if pid == 0:
            for f in glob.glob(os.path.join(spill_dir, "*")):
                os.remove(f)
            shutil.rmtree(os.path.join(out_dir, "_bam_spool"),
                          ignore_errors=True)
        dist.barrier("spill-clean")
    return Hosts(pid, nproc, resume, fp)


@dataclass
class ProbeRun:
    """What an RTL run carries instead of a genome index: the probe set,
    its device aligner and the per-region usable-read tallies."""

    probe_set: object
    align: object
    region_names: list
    region_of_probe: np.ndarray
    region_reads: np.ndarray


def _load_probe_run(cfg: CountConfig, device) -> ProbeRun:
    from ..io.probe_set import ProbeSet
    from ..ops.probes import make_probe_aligner
    ps = ProbeSet.from_csv(cfg.probe_set_csv)
    names = sorted({r or "unknown" for r in ps.regions})
    return ProbeRun(
        ps, make_probe_aligner(ps, cfg.read_len, device), names,
        np.asarray([names.index(r or "unknown") for r in ps.regions],
                   np.int32),
        np.zeros(len(names), np.int64))


def _load_probe_barcodes(cfg: CountConfig, chem):
    """RTL sample multiplexing: the probe-barcode whitelist of an MFRP
    chemistry as packed u32 sequences, else None."""
    if chem.probe_bc is None:
        return None
    if not cfg.probe_barcode_csv:
        raise ValueError(
            f"chemistry {chem.name} carries a probe barcode; pass "
            "probe_barcode_csv (id,sequence rows)")
    from ..io.probe_bc import load_probe_barcodes
    _ids, packed, pbl = load_probe_barcodes(cfg.probe_barcode_csv)
    if pbl != chem.probe_bc.length:
        raise ValueError(f"probe barcodes are {pbl}bp; chemistry expects "
                         f"{chem.probe_bc.length}bp")
    return packed


def _fb_tag_lists(pat, src, fo, fb_ref, features, n_genes: int, n: int):
    """Per-read fr/fq/fb/fx BAM tag payloads for one feature pattern
    (read.rs:1335-1360): fr/fq = raw extracted barcode seq/qual, fb = the
    matched whitelist sequence, fx = the feature id.  b'' = omit."""
    fr = [b""] * n
    fq = [b""] * n
    fb = [b""] * n
    fx = [b""] * n
    src_codes, src_nmask, _, src_qual = src
    off = fo["offset"]
    sidx = fo["seq_idx"]
    feat = fo["feature"]
    seqs_packed = fb_ref.pattern_groups[pat][0]
    bl = pat.bc_len
    for i in np.flatnonzero(fo["extracted"][:n]):
        o = int(off[i])
        fr[i] = encode.decode_codes(src_codes[i][o:o + bl],
                                    src_nmask[i][o:o + bl])
        fq[i] = bytes(src_qual[i][o:o + bl])
        if sidx[i] >= 0:
            fb[i] = encode.decode_codes(
                encode.unpack_np(np.uint32(seqs_packed[sidx[i]]), bl))
            fid = features.feature_defs[n_genes + int(feat[i])].id
            fx[i] = fid.encode() if isinstance(fid, str) else fid
    return fr, fq, fb, fx


def _tally_sj(sj_counts: dict, ho: dict, n: int, gi) -> None:
    """Splice-junction read tallies (SJ.out.tab analog) of one stream
    batch: novel junctions from split alignments, annotated ones from
    junction-contig placements; unique mappers only."""
    m255 = ho["mapped"][:n] & (ho["mapq"][:n] == 255)
    nsj = ho["novel_sj"][:n] & m255
    if nsj.any():
        dn = ho["sj_donor"][:n][nsj].astype(np.int64)
        an = ho["sj_acceptor"][:n][nsj].astype(np.int64)
        st = ho["strand"][:n][nsj].astype(np.int64)
        uniq, cnt = np.unique(np.stack([dn, an, st], 1), axis=0,
                              return_counts=True)
        for (d, a, s), c in zip(uniq.tolist(), cnt.tolist()):
            key = (d, a, s, 0)
            sj_counts[key] = sj_counts.get(key, 0) + c
    pos = ho["pos"][:n].astype(np.int64)
    on_contig = m255 & (pos >= gi.genome_len) & ~nsj
    if on_contig.any():
        ji = (pos[on_contig] - gi.genome_len) // (2 * gi.sj_overhang)
        st = ho["strand"][:n][on_contig].astype(np.int64)
        uniq, cnt = np.unique(np.stack([ji, st], 1), axis=0,
                              return_counts=True)
        for (j, s), c in zip(uniq.tolist(), cnt.tolist()):
            key = (int(gi.sj_donor_end[j]), int(gi.sj_acceptor_start[j]),
                   int(s), 1)
            sj_counts[key] = sj_counts.get(key, 0) + c


def _add_step_metrics(metrics: CountMetrics, m: dict) -> None:
    metrics.mapped_reads += m["n_mapped"]
    metrics.conf_mapped_reads += m["n_conf"]
    metrics.exonic_reads += m["n_exonic"]
    metrics.intronic_reads += m["n_intronic"]
    metrics.intergenic_reads += m["n_intergenic"]
    metrics.antisense_reads += m["n_antisense"]
    metrics.usable_reads += m["n_usable"]
    metrics.promote_overflow += m["n_promote_overflow"]
    metrics.tso_reads += m["n_tso"]
    metrics.polya_trimmed_reads += m["n_polya_trimmed"]
    metrics.improper_pair_reads += m["n_improper_pair"]


# the most recent reference and its device tables, so that run_count calls
# against one reference in one process (multi's samples, multi-GEM wells)
# load and upload it once, as the JAX package's _REF_MEMO does; keyed on
# the reference's real path, its index's mtime and the device
_REF_MEMO: dict = {"key": None, "value": None}


def _load_reference_cached(path: str, device):
    """(ReferencePackage, DeviceIndex, AnnotationIndex) of `path` on
    `device`, loaded once for a run of calls with the same key; the index
    tables are built on `device` (`DeviceIndex.build`).  A load leaves
    the seconds of each step in _REF_MEMO["split"] (the device
    synchronized at each step's end): index.npz and the GTF, the upload,
    the text rows, the overlapped rows, the kmer bucket rows, the
    annotation tables."""
    try:
        mtime = os.path.getmtime(os.path.join(path, "index.npz"))
    except OSError:
        mtime = 0.0
    key = (os.path.realpath(path), mtime, str(torch.device(device)))
    if _REF_MEMO["key"] != key:
        # free the old tables first
        _REF_MEMO.update(key=None, value=None, split=None)
        split = {}
        t = time.time()

        def lap(name):
            nonlocal t
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            split[name] = time.time() - t
            t = time.time()

        ref = ReferencePackage.load(path)
        gi = ref.genome_index
        lap("npz_load_s")
        didx = DeviceIndex.build(gi, device, lap)
        ann = AnnotationIndex.build(ref.transcriptome, gi, device)
        lap("annotation_s")
        _REF_MEMO.update(key=key, value=(ref, didx, ann), split=split)
    return _REF_MEMO["value"]


def run_count(cfg: CountConfig, out_dir: str,
              whitelist: Whitelist | None = None, *, device,
              mesh=None) -> dict:
    """Run the count pipeline on `device` ("cuda" or "cpu"); writes
    outputs into out_dir and returns the metrics dict.

    mesh: a parallel.mesh.Mesh; pass 2's step and the partition dedup run
    over its devices (batch slices in parallel, the index replicated per
    distinct device or, with cfg.shard_index, its kmer table sharded), the
    rest on `device`.  The outputs equal the one-device run's.

    Multi-host (the CRTPU_* variables of parallel/distributed.py): every
    host runs this function over a shared out_dir; the FASTQ pairs are
    dealt round-robin, molecule rows spill under out_dir, and host 0
    merges every host's partial after a barrier and writes the outputs.
    The other hosts return {"worker": pid, "total_reads": ...}."""
    dist.init_from_env()   # no-op without the CRTPU_* contract
    executor = Executor(mesh, device)
    multihost = dist.process_count() > 1
    _check_supported(cfg, executor.mesh, multihost)
    chem = get_chemistry(cfg.chemistry)
    device = executor.device
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    from ..params import get as _param
    from ..perf import PerfTrace
    perf = PerfTrace()
    batch_size = executor.round_batch(
        int(_param("batch_size") or cfg.batch_size))
    if whitelist is None:
        whitelist = Whitelist.load(cfg.whitelist_path)

    probe = None
    if cfg.probe_set_csv:
        # RTL run: align to the probe set (Hurtle analog); no genome index
        probe = _load_probe_run(cfg, device)
        ref = (ReferencePackage.load(cfg.reference_path)
               if cfg.reference_path else None)
        gi = didx = ann_idx = None
        n_genes = len(probe.probe_set.genes)
        features = FeatureReference(
            [FeatureDef(g, g, "Gene Expression")
             for g in probe.probe_set.genes])
    else:
        ref, didx, ann_idx = _load_reference_cached(cfg.reference_path,
                                                    device)
        gi = ref.genome_index
        n_genes = len(ref.transcriptome.genes)
        if len(ref.genomes) > 1:
            features = FeatureReference(
                [FeatureDef(i, n_, "Gene Expression", gn)
                 for i, n_, gn in zip(ref.transcriptome.gene_ids,
                                      ref.transcriptome.gene_names,
                                      ref.genome_of_gene())])
        else:
            features = FeatureReference.from_transcriptome(
                ref.transcriptome.gene_ids, ref.transcriptome.gene_names,
                ref.genome_name)
    probe_bc_packed = _load_probe_barcodes(cfg, chem)

    fb_ref = None
    fb_extractors = {}
    if cfg.feature_ref_csv:
        fb_ref = FeatureBarcodeReference.from_csv(cfg.feature_ref_csv)
        features = FeatureReference(features.feature_defs
                                    + list(fb_ref.feature_defs))
        for pat, (seqs, fidx) in fb_ref.pattern_groups.items():
            ft = BucketTable.build_exact(
                seqs, np.arange(len(seqs), dtype=np.uint32), device,
                entries=8, fields=3).with_counts(np.ones(len(seqs), np.int64))
            fb_extractors[pat] = make_feature_extractor(pat, ft, fidx,
                                                        cfg.read_len)

    libraries = cfg.libraries or [LibraryDef(cfg.fastq_pairs)]
    if len(features.feature_defs) >= (1 << LIB_SHIFT) or len(libraries) > 255:
        raise ValueError("feature reference / library count exceeds the "
                         "24-bit gene + 8-bit library packing")
    metrics = CountMetrics()
    perf.lap("load_reference_index")

    # ---- checkpoint/resume (pipeline/checkpoint.py, host code) ----
    ckpt = None
    resume = None
    hosts = _join_hosts(cfg, out_dir) if multihost else None
    spool_dir = os.path.join(out_dir, "_bam_spool")
    if cfg.checkpoint and hosts is None:
        from .checkpoint import CountCheckpoint, count_fingerprint
        ckpt = CountCheckpoint(out_dir, count_fingerprint(cfg))
        resume = ckpt.load("molecules")
        if resume is not None and cfg.write_bam:
            # a BAM run resumes only when its sealed band spool (the
            # journal) AND the raw-triple views survive with the table
            if not (resume["__meta__"].get("bam_spool_sealed")
                    and os.path.isdir(spool_dir) and "rv_raw_bc" in resume):
                resume = None
    if resume is not None:
        mbc, mgene = resume["mbc"], resume["mgene"]
        mumi, mreads = resume["mumi"], resume["mreads"]
        mlib = resume.get("mlib", np.zeros(len(mbc), np.uint16))
        sj_counts = {tuple(int(x) for x in k): int(v)
                     for k, v in zip(resume["sj_keys"], resume["sj_vals"])}
        if probe is not None and "probe_region_reads" in resume:
            probe.region_reads = resume["probe_region_reads"]
        metrics = CountMetrics(**resume["__meta__"]["metrics"])
        bam_collector = None
        raw_views = None
        if cfg.write_bam and gi is not None:
            # reopen the sealed band spool read-only; the FASTQ passes
            # are skipped and the run goes straight to band merge
            bam_collector = BamCollector(gi, ref.transcriptome, spool_dir,
                                         read_group=cfg.sample_id,
                                         fresh=False)
            bam_collector.n_reads = int(
                resume["__meta__"].get("bam_n_reads", 0))
            raw_views = {k[3:]: resume[k] for k in resume
                         if k.startswith("rv_")}
        perf.lap("resume_checkpoint")
    else:
        bam_collector = None
        if cfg.write_bam and gi is not None:
            # multi-host: a band spool per host under the shared out dir;
            # host 0 merges every host's bands at write time
            bam_collector = BamCollector(
                gi, ref.transcriptome,
                spool_dir if hosts is None
                else os.path.join(spool_dir, f"host{hosts.pid}"),
                read_group=cfg.sample_id)
        n_parts = int(_param("spill_partitions")
                      or max(SPILL_PARTS, executor.n_devices))
        passed = _count_pass(
            cfg, chem, whitelist, libraries, gi, didx, ann_idx, batch_size,
            metrics, perf, out_dir, fb_ref, fb_extractors, features,
            n_genes, bam_collector, n_parts, executor, probe,
            probe_bc_packed, hosts)
        if passed is None:       # a worker host: host 0 writes the outputs
            return {"worker": hosts.pid, "total_reads": metrics.total_reads}
        mbc, mgene, mumi, mreads, mlib, sj_counts, raw_views = passed
        if ckpt is not None:
            sj_items = sorted(sj_counts.items())
            save = dict(mbc=mbc, mgene=mgene, mumi=mumi, mreads=mreads,
                        mlib=mlib,
                        sj_keys=np.asarray([k for k, _ in sj_items],
                                           np.int64).reshape(-1, 4),
                        sj_vals=np.asarray([v for _, v in sj_items],
                                           np.int64))
            if probe is not None:
                save["probe_region_reads"] = probe.region_reads
            meta = dict(metrics=dict(metrics.__dict__))
            if bam_collector is not None:
                # the band spool becomes the journal: seal it and persist
                # the raw-triple views so a killed BAM run resumes
                # straight to band merge
                bam_collector.seal()
                for k_, v_ in (raw_views or {}).items():
                    save[f"rv_{k_}"] = v_
                meta.update(bam_spool_sealed=True,
                            bam_n_reads=bam_collector.n_reads)
            ckpt.save("molecules", save, meta=meta)
    return _finalize(cfg, chem, out_dir, whitelist, libraries, ref, gi,
                     features, n_genes, metrics, mbc, mgene, mumi, mreads,
                     mlib, sj_counts, perf, t0, fb_ref, bam_collector,
                     raw_views, device, probe, probe_bc_packed)


def _count_pass(cfg, chem, whitelist, libraries, gi, didx, ann_idx,
                batch_size, metrics, perf, out_dir, fb_ref, fb_extractors,
                features, n_genes, bam_collector, n_parts, executor,
                probe=None, probe_bc_packed=None, hosts=None):
    """Passes 1 and 2 and the dedup.  Returns the molecule table (bc, gene,
    umi, reads, library) sorted by (bc, gene, umi), the splice-junction
    tallies and, for BAM and Feature Barcode runs, the raw-triple views;
    None on a worker host of a multi-host run, once its spill and partial
    are on disk.

    Count-only runs step in accumulate mode and dedup in the device
    molecule state (host flush + partition dedup past MOLECULE_STATE_CAP
    distinct triples).  BAM runs step in stream mode: every batch's
    per-read outputs come back to the host for the BAM spool, and the
    molecule rows spill to barcode-hash partition files.  Feature Barcode
    runs without BAM keep accumulate mode but spill too; their FB
    libraries are extracted batch by batch on the device.  RTL runs
    (`probe`) have no fused step: each Gene Expression batch is resolved
    on the host, probe-aligned on the device and spilled, synchronously;
    with probe barcodes (MFRP) the barcode column is the product index
    gel-bead rank * n_probe + probe-barcode rank.

    On a mesh the step streams (its outputs are split over the devices)
    and the rows spill; across hosts every host spills (host 0 reads them
    all), so neither keeps the device molecule state."""
    device = executor.device
    accumulate = (probe is None and not cfg.write_bam
                  and executor.mesh is None)
    if probe is not None:
        step = None
    elif accumulate:
        step = make_count_step(didx, ann_idx, chem, cfg.read_len)
    else:
        sharded = None
        if cfg.shard_index and executor.mesh is not None:
            sharded = shard_device_index(didx, executor.mesh)

        def step_for(dev):
            return make_stream_step(
                sharded.replicas[dev] if sharded else to_device(didx, dev),
                to_device(ann_idx, dev), chem, cfg.read_len,
                emit_secondary=cfg.write_bam,
                seed_lookup=sharded.lookup if sharded else None).planes

        planes = executor.wrap_step(step_for)

        def step(plane):
            return host_copy(planes(plane))

    work = [(li, pair) for li, lib in enumerate(libraries)
            for pair in lib.fastq_pairs]
    if hosts is not None:
        # this host's share; none when every host's pass 2 is on disk
        work = [] if hosts.resume else dist.host_shard(work, hosts.pid,
                                                       hosts.nproc)
    # feature patterns declared on R1 need the R1-remainder view
    need_r1_rest = any(pat.read == "R1" for pat in fb_extractors)

    def my_batches(barcode_only: bool = False):
        for li, pair in work:
            i1 = pair[2] if len(pair) > 2 else None
            is_fb = libraries[li].library_type != "Gene Expression"
            for batch in batches_from_fastqs(
                    chem, pair[0], pair[1], batch_size, cfg.read_len,
                    keep_names=cfg.write_bam and not barcode_only,
                    i1_path=i1,
                    keep_r1_rest=need_r1_rest and is_fb and not barcode_only,
                    barcode_only=barcode_only):
                yield li, batch

    # ---- pass 1: host barcode histogram (the correction prior) ----
    wl_counts = np.zeros(whitelist.size, np.int64)
    pass1_reads = 0
    for _li, batch in my_batches(barcode_only=True):
        idx = whitelist.index_of(batch.bc_packed[:batch.n_reads])
        np.add.at(wl_counts, idx[idx >= 0], 1)
        pass1_reads += batch.n_reads
    # every host needs the global prior for pass 2
    wl_counts = dist.allsum_array(wl_counts)
    if bam_collector is not None:
        # the BAM spool's bands, the same on every host: from the run's
        # reads (two records a read pair)
        total = int(dist.allsum_array(np.array([pass1_reads], np.int64))[0])
        bam_collector.plan(total * (2 if chem.rna2 is not None else 1))
    perf.lap("pass1_extract_whitelist")

    def resolve_bc(batch):
        """Host membership + posterior correction with the pass-1 prior;
        returns (bc_idx, hit, corrected, corrected_bc)."""
        return bcops.host_resolve_barcodes(
            batch.bc_packed, batch.bc_qual, batch.slot_valid,
            whitelist.sorted_seqs, wl_counts, chem.barcode_length)

    # ---- pass 2: producer thread (decode, host barcode resolve, pack,
    # upload) feeding the device on this thread ----
    def prep(item):
        li, batch = item
        if (libraries[li].library_type != "Gene Expression"
                or probe is not None):
            return li, batch, None, None
        bc_idx, hit, corrected, corr_bc = resolve_bc(batch)
        plane = executor.put(
            pack_step_input(chem, cfg.read_len, batch, bc_idx))
        hi = dict(bc_idx=bc_idx, corr_bc=corr_bc,
                  n_valid_bc=int(hit.sum()),
                  n_corrected=int(corrected.sum()),
                  n_valid_umi=int((batch.umi_valid & batch.slot_valid).sum()))
        return li, batch, hi, plane

    bq: _queue.Queue = _queue.Queue(maxsize=3)
    stop = threading.Event()

    def _producer():
        try:
            for item in my_batches():
                if stop.is_set():
                    return
                bq.put(prep(item))
            bq.put(None)
        except BaseException as e:  # re-raised on the main thread
            bq.put(e)

    producer = threading.Thread(target=_producer, daemon=True)
    producer.start()

    spill_dir = os.path.join(out_dir, "_spill")
    spill = MoleculeSpill(
        spill_dir, n_parts, prefix=f"host{hosts.pid}_" if hosts else "",
        append=bool(hosts and hosts.resume))
    sj_counts: dict = {}
    mol_cap = max(4 * batch_size, MOLECULE_BUFFER_ROWS)
    sj_cap = max(4 * batch_size, 1 << 18)
    sjb_per_batch = max(batch_size // 4, 64)
    acc = step.init_acc(mol_cap, sj_cap) if accumulate else None
    acc_rows = 0
    acc_sj_rows = 0
    sjh_total = None
    sj_capacity_overflow = 0
    # device-resident dedup for count-only runs; BAM and Feature Barcode
    # runs need the raw-triple views and spill their rows instead
    keep_raw = bam_collector is not None or fb_ref is not None
    mol_state = None
    if accumulate and not keep_raw and hosts is None:
        mol_state = MoleculeState(MOLECULE_STATE_CAP, chem.umi_length,
                                  device)

    def drain_acc():
        """Absorb or spill the molecule rows, fetch the SJ rows/histogram
        and metrics, and reset the buffers."""
        nonlocal acc, acc_rows, acc_sj_rows, sjh_total, sj_capacity_overflow
        if mol_state is not None:
            mol_state.absorb(acc["mol"], acc["mol_n"], acc_rows)
        else:
            rows = acc["mol"][:int(acc["mol_n"])].cpu().numpy()
            spill.append(rows[:, 0], rows[:, 1], rows[:, 2])
        nsj = int(acc["sj_n"])
        if nsj:
            sj = acc["sj"][:nsj].cpu().numpy()
            u, c = np.unique(sj, axis=0, return_counts=True)
            for (d, a, s), cnt in zip(u.tolist(), c.tolist()):
                key = (d, a, s, 0)
                sj_counts[key] = sj_counts.get(key, 0) + cnt
        sjh = acc["sjh"].cpu().numpy()
        sjh_total = sjh if sjh_total is None else sjh_total + sjh
        mv = acc["mvec"].cpu().numpy()
        sj_capacity_overflow += int(mv[-1])
        _add_step_metrics(metrics, {k: int(v)
                                    for k, v in zip(METRIC_FIELDS, mv)})
        acc = step.init_acc(mol_cap, sj_cap)
        acc_rows = 0
        acc_sj_rows = 0

    def process_gex(li, batch, hi, out):
        """Host consumer of one stream batch: metrics, molecule spill,
        junction tallies, BAM spool."""
        ho, m = unpack_step_out(fetch_step_out(out))
        lib_bits = np.uint32(li << LIB_SHIFT)
        metrics.total_reads += batch.n_reads
        metrics.valid_barcode_reads += hi["n_valid_bc"] + hi["n_corrected"]
        metrics.corrected_barcode_reads += hi["n_corrected"]
        metrics.valid_umi_reads += hi["n_valid_umi"]
        _add_step_metrics(metrics, m)
        conf = ho["conf_ok"]
        spill.append(hi["bc_idx"].view(np.uint32)[conf],
                     ho["gene"][conf] | lib_bits, batch.umi_packed[conf])
        _tally_sj(sj_counts, ho, batch.n_reads, gi)
        if bam_collector is not None:
            # merge the host-resolved barcode view into the step output
            ho["bc_idx"] = hi["bc_idx"]
            ho["bc_ok"] = hi["bc_idx"] >= 0
            ho["corrected_bc"] = hi["corr_bc"]
            ho["umi"] = batch.umi_packed
            # library-tagged gene: the dedup raw-triple join key
            ho["gene_lib"] = ho["gene"] | lib_bits
            bam_collector.add_batch(batch, ho)

    def process_probe(li, batch):
        """RTL batch: host cell-barcode resolve, probe alignment on the
        device (inputs uploaded once, the five outputs fetched as one
        array), probe-barcode assignment, molecule spill."""
        from ..ops.probes import stack_outputs, unstack_outputs
        bc_idx, _hit, corrected, _corr_bc = resolve_bc(batch)
        bc_ok = bc_idx >= 0
        pa = unstack_outputs(stack_outputs(probe.align(
            torch.from_numpy(batch.rna).to(device),
            torch.from_numpy(batch.rna_nmask).to(device))).cpu().numpy())
        conf = pa["conf_mapped"] & bc_ok & batch.umi_valid
        bc_combined = bc_idx.astype(np.int64)
        if probe_bc_packed is not None:
            from ..io.probe_bc import assign_probe_bcs
            pidx, pok = assign_probe_bcs(
                batch.probe_bc_packed, probe_bc_packed, chem.probe_bc.length)
            conf = conf & pok
            bc_combined = (bc_combined * len(probe_bc_packed)
                           + np.maximum(pidx, 0))
        metrics.total_reads += batch.n_reads
        metrics.valid_barcode_reads += int(bc_ok.sum())
        metrics.corrected_barcode_reads += int(corrected.sum())
        metrics.valid_umi_reads += int(
            (batch.umi_valid & batch.slot_valid).sum())
        metrics.mapped_reads += int(pa["mapped"].sum())
        metrics.conf_mapped_reads += int(pa["conf_mapped"].sum())
        metrics.usable_reads += int(conf.sum())
        np.add.at(probe.region_reads,
                  probe.region_of_probe[pa["probe"][conf]], 1)
        spill.append(bc_combined.astype(np.uint32)[conf],
                     pa["gene"][conf].astype(np.uint32)
                     | np.uint32(li << LIB_SHIFT),
                     np.asarray(batch.umi_packed)[conf])

    def process_fb(li, batch):
        """Feature-barcode library batch: cell barcode resolve + feature
        extraction over every declared pattern (R1 patterns read the R1
        remainder, R2 patterns the cDNA read), one feature per read."""
        bc_idx, hit, corrected, corr_bc = resolve_bc(batch)
        bc_ok = bc_idx >= 0
        metrics.total_reads += batch.n_reads
        metrics.valid_barcode_reads += int(bc_ok.sum())
        metrics.corrected_barcode_reads += int(corrected.sum())
        metrics.valid_umi_reads += int(
            (batch.umi_valid & batch.slot_valid).sum())
        n = batch.n_reads
        lib_bits = np.uint32(li << LIB_SHIFT)
        fb_rows = None  # per-read best extraction across patterns
        for pat, extract in fb_extractors.items():
            if pat.read == "R1":
                if batch.r1_rest is None:
                    continue
                src = (batch.r1_rest, batch.r1_rest_nmask,
                       batch.r1_rest_len, batch.r1_rest_qual)
            else:
                src = (batch.rna, batch.rna_nmask, batch.rna_len,
                       batch.rna_qual)
            fo = extract(*(torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) for a in src[:3]))
            fo = {k: v.cpu().numpy() for k, v in fo.items()}
            found_n = fo["found"][:n]
            ext = fo["extracted"][:n]
            gene_n = (fo["feature"][:n] + n_genes).astype(np.uint32)
            if bam_collector is not None:
                fr, fq, fbs, fx = _fb_tag_lists(pat, src, fo, fb_ref,
                                                features, n_genes, n)
            else:
                fr = fq = fbs = fx = [b""] * n
            if fb_rows is None:
                fb_rows = dict(fr=fr, fq=fq, fb=fbs, fx=fx,
                               found=found_n.copy(), extracted=ext.copy(),
                               gene=gene_n.copy())
            else:
                # a pattern that FOUND a whitelist match beats one that
                # merely extracted bases; otherwise first extraction wins
                use = (found_n & ~fb_rows["found"]) \
                    | (ext & ~fb_rows["extracted"])
                for i in np.flatnonzero(use):
                    fb_rows["fr"][i] = fr[i]
                    fb_rows["fq"][i] = fq[i]
                    fb_rows["fb"][i] = fbs[i]
                    fb_rows["fx"][i] = fx[i]
                fb_rows["gene"] = np.where(use, gene_n, fb_rows["gene"])
                fb_rows["found"] |= found_n
                fb_rows["extracted"] |= ext
        if fb_rows is None:
            return
        conf = fb_rows["found"] & bc_ok[:n] & batch.umi_valid[:n]
        metrics.usable_reads += int(conf.sum())
        metrics.conf_mapped_reads += int(conf.sum())
        spill.append(bc_idx.astype(np.uint32)[:n][conf],
                     fb_rows["gene"][conf] | lib_bits,
                     np.asarray(batch.umi_packed)[:n][conf])
        if bam_collector is not None:
            bam_collector.add_feature_batch(
                batch, conf, bc_ok, bc_idx, corr_bc, fb_rows["gene"],
                fb_rows["fr"], fb_rows["fq"], fb_rows["fb"], fb_rows["fx"],
                gene_lib=fb_rows["gene"] | lib_bits)

    # stream mode: a 1-deep pending slot reads batch i back while batch
    # i+1 runs on the device
    pending: tuple | None = None
    try:
        while True:
            item = bq.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            li, batch, hi, plane = item
            n0 = batch.n_reads
            metrics.q30_bc_bases += int((batch.bc_qual[:n0] >= 63).sum())
            metrics.bc_bases += int(batch.bc_qual[:n0].size)
            metrics.q30_umi_bases += int((batch.umi_qual[:n0] >= 63).sum())
            metrics.umi_bases += int(batch.umi_qual[:n0].size)
            in_len = batch.rna_qual[:n0][batch.rna_nmask[:n0]]
            metrics.q30_rna_bases += int((in_len >= 63).sum())
            metrics.rna_bases += int(in_len.size)
            if batch.rna2 is not None:   # paired-end: the mate counts too
                in2 = batch.rna2_qual[:n0][batch.rna2_nmask[:n0]]
                metrics.q30_rna_bases += int((in2 >= 63).sum())
                metrics.rna_bases += int(in2.size)
            if libraries[li].library_type != "Gene Expression":
                if pending is not None:       # keep batch order
                    process_gex(*pending)
                    pending = None
                process_fb(li, batch)
            elif probe is not None:
                process_probe(li, batch)
            elif accumulate:
                if (acc_rows + batch.batch_size > mol_cap
                        or acc_sj_rows + sjb_per_batch > sj_cap):
                    drain_acc()
                step(plane, acc, lib_tag=li << LIB_SHIFT)
                acc_rows += batch.batch_size
                acc_sj_rows += sjb_per_batch
                metrics.total_reads += batch.n_reads
                metrics.valid_barcode_reads += (hi["n_valid_bc"]
                                                + hi["n_corrected"])
                metrics.corrected_barcode_reads += hi["n_corrected"]
                metrics.valid_umi_reads += hi["n_valid_umi"]
            else:
                out = step(plane)
                if pending is not None:
                    process_gex(*pending)
                pending = (li, batch, hi, out)
            perf.lap("pass2_correct_align_annotate")
        if pending is not None:
            process_gex(*pending)
            pending = None
    finally:
        stop.set()
        while producer.is_alive():   # unblock a producer waiting on put()
            try:
                bq.get(timeout=0.1)
            except _queue.Empty:
                pass
        producer.join()
    if accumulate:
        drain_acc()
        # annotated-junction contig hits -> (donor, acceptor, strand, 1)
        for h in np.flatnonzero(sjh_total):
            ji, s = int(h) // 2, int(h) % 2
            key = (int(gi.sj_donor_end[ji]), int(gi.sj_acceptor_start[ji]),
                   s, 1)
            sj_counts[key] = sj_counts.get(key, 0) + int(sjh_total[h])
        metrics.sj_capacity_overflow += sj_capacity_overflow
    perf.lap("pass2_correct_align_annotate")

    spill.flush()
    if hosts is not None and not _hand_off(
            hosts, metrics, sj_counts, probe, bam_collector, spill,
            out_dir):
        return None

    # ---- dedup ----
    raw_parts = []
    if mol_state is not None:
        mol_state.bound_dedup(DEDUP_CHUNK_LIMIT)
    if mol_state is not None and not mol_state.flushed:
        # device-resident path: one dedup + one valid-molecule fetch
        mbc, mgene, mumi, mreads = mol_state.finalize()
    else:
        # barcode-hash partitions (bounded memory): each spill partition
        # holds complete barcodes; oversized ones sub-split by a second
        # barcode hash (split_partition), so a device call stays within
        # _pow2(DEDUP_CHUNK_LIMIT) padded rows
        parts = []
        if mol_state is not None:
            # overflow path: the merged state flushed to the host; dedup
            # its reads-weighted rows over bc-hash partitions
            parts += split_partition(mol_state.finalize(), DEDUP_CHUNK_LIMIT)
        for p in range(n_parts):
            b, g, u = (MoleculeSpill.load_union(spill_dir, n_parts, p)
                       if hosts is not None else spill.load_part(p))
            if len(b):
                parts += split_partition((b, g, u), DEDUP_CHUNK_LIMIT)
        parts_out = []
        for dd in executor.dedup_partitions(parts, chem.umi_length,
                                            keep_raw=keep_raw,
                                            chunk_limit=DEDUP_CHUNK_LIMIT):
            parts_out.append((dd["mol_bc"], dd["mol_gene"], dd["mol_umi"],
                              dd["mol_reads"]))
            if keep_raw:
                raw_parts.append(dd)
        empty = (np.zeros(0, np.uint32),) * 3 + (np.zeros(0, np.int32),)
        mbc, mgene, mumi, mreads = (
            np.concatenate([x[c] for x in parts_out]) if parts_out
            else empty[c] for c in range(4))
    # strip the library tag out of the gene column (set at spill time so
    # dedup ran per library)
    mlib = (mgene >> np.uint32(LIB_SHIFT)).astype(np.uint16)
    mgene = mgene & LIB_MASK
    order = np.lexsort((mumi, mgene, mbc))
    mbc, mgene, mumi, mreads, mlib = (mbc[order], mgene[order],
                                      mumi[order], mreads[order],
                                      mlib[order])
    metrics.total_molecules = int(len(mbc))
    raw_views = None
    if keep_raw:
        raw_views = {k: (np.concatenate([rp[k] for rp in raw_parts])
                         if raw_parts else np.zeros(0, np.uint32))
                     for k in ("raw_bc", "raw_gene", "raw_umi",
                               "raw_corr_umi", "raw_low", "raw_reads")}
    spill.close(remove=True)
    perf.lap("dedup")
    return mbc, mgene, mumi, mreads, mlib, sj_counts, raw_views


def _hand_off(hosts: Hosts, metrics: CountMetrics, sj_counts: dict, probe,
              bam_collector, spill, out_dir: str) -> bool:
    """The multi-host join, after this host's spill is flushed: publish
    this host's partial (metrics, junction tallies, probe-region reads)
    atomically, seal its BAM spool, and wait for every host.  A worker
    closes its spill and returns False.  Host 0 folds every host's
    partial into metrics, sj_counts and the probe tallies (in place),
    points its BAM collector at the other hosts' spools, and returns
    True."""
    spill_dir = os.path.join(out_dir, "_spill")
    if not hosts.resume:
        partial = dict(
            metrics=dict(metrics.__dict__),
            sj=[[list(k), v] for k, v in sorted(sj_counts.items())],
            fingerprint=hosts.fingerprint)
        if probe is not None:
            partial["probe_region_reads"] = probe.region_reads.tolist()
        # the partial is the durable "my pass 2 is complete" marker
        pj = os.path.join(spill_dir, f"host{hosts.pid}.json")
        with open(pj + ".tmp", "w") as f:
            json.dump(partial, f)
        os.replace(pj + ".tmp", pj)
    if bam_collector is not None:
        bam_collector.seal()
    dist.barrier("count-spill")
    if os.environ.get("CRTPU_TEST_DIE_AFTER_PASS2"):
        # test hook: a whole-job crash at the point where every host's
        # pass-2 state is durable (covers the resume)
        raise SystemExit(42)
    if hosts.pid != 0:
        spill.close(remove=False)
        return False
    if bam_collector is not None:
        bam_collector.sibling_dirs = sorted(
            d for d in glob.glob(os.path.join(out_dir, "_bam_spool",
                                              "host*"))
            if os.path.basename(d) != f"host{hosts.pid}")
    for k in metrics.__dict__:
        setattr(metrics, k, 0)
    sj_counts.clear()
    if probe is not None:
        probe.region_reads = np.zeros_like(probe.region_reads)
    for path in sorted(glob.glob(os.path.join(spill_dir, "host*.json"))):
        with open(path) as f:
            part = json.load(f)
        for k, v in part["metrics"].items():
            setattr(metrics, k, getattr(metrics, k) + v)
        for k, v in part["sj"]:
            key = tuple(k)
            sj_counts[key] = sj_counts.get(key, 0) + v
        if probe is not None:
            probe.region_reads += np.asarray(part["probe_region_reads"],
                                             np.int64)
    return True


def barcode_names(packed: np.ndarray, length: int,
                  suffix: bytes = b"") -> list[bytes]:
    """The ASCII name (+ suffix) of each packed barcode, decoded in one
    vectorized pass: a decode a barcode takes minutes over a 6.8M-barcode
    whitelist (10x's 3' v3 list)."""
    ascii_ = np.frombuffer(b"ACGT", np.uint8)[
        encode.unpack_np(np.asarray(packed), length)]
    names = np.concatenate(
        [ascii_, np.broadcast_to(np.frombuffer(suffix, np.uint8),
                                 (len(ascii_), len(suffix)))], 1)
    return np.ascontiguousarray(names).view(f"S{names.shape[1]}") \
        .ravel().tolist()


def _finalize(cfg, chem, out_dir, whitelist, libraries, ref, gi, features,
              n_genes, metrics, mbc, mgene, mumi, mreads, mlib, sj_counts,
              perf, t0, fb_ref, bam_collector, raw_views, device,
              probe=None, probe_bc_packed=None):
    """Matrices, aggregate removal, cell calls, BAM, junctions, molecule
    info, feature assignment, secondary analysis (on `device`), metrics."""
    n_probe = len(probe_bc_packed) if probe_bc_packed is not None else 1
    out_seqs = (whitelist.translation if whitelist.translation is not None
                else whitelist.sorted_seqs)
    suffix = f"-{cfg.gem_group}".encode()
    if probe_bc_packed is not None:
        # product barcode space: gel-bead barcode ++ probe barcode
        # (DEMUX_PROBE_BC_MATRIX barcode composition)
        probe_strs = [encode.decode_codes(encode.unpack_np(
            np.uint32(p), chem.probe_bc.length)) for p in probe_bc_packed]
        barcodes = [bc + ps + suffix
                    for bc in barcode_names(out_seqs, whitelist.length)
                    for ps in probe_strs]
    else:
        barcodes = barcode_names(out_seqs, whitelist.length, suffix)
    raw = CountMatrix.from_molecules(mbc.astype(np.int64),
                                     mgene.astype(np.int64), barcodes,
                                     features)
    raw.save_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"),
                chemistry_description=chem.description)
    raw.save_mex(os.path.join(out_dir, "raw_feature_bc_matrix"))
    perf.lap("matrix_assembly")

    # ---- antibody/antigen aggregate-GEM removal (FILTER_BARCODES step 1,
    # cell_calling_helpers.py:188-272) ----
    agg_metrics: dict = {}
    agg_bcs = np.zeros(0, np.int64)
    if fb_ref is not None:
        agg_bcs = _aggregate_barcodes(raw, features, n_genes,
                                      whitelist.size * n_probe, n_probe,
                                      raw_views, agg_metrics, out_dir)

    # ---- cell calling (on Gene Expression counts only when FB is
    # present, filter_barcodes semantics) ----
    if fb_ref is not None and n_genes > 0:
        gex_m = raw.m[:n_genes]
        umis_per_bc = np.asarray(gex_m.sum(axis=0)).ravel()
        call_matrix = gex_m
    else:
        umis_per_bc = raw.counts_per_bc()
        call_matrix = raw.m
    if len(agg_bcs):
        # aggregates never become cells: their calling weight is zeroed so
        # raw-matrix barcode indexing stays stable
        umis_per_bc = umis_per_bc.copy()
        umis_per_bc[agg_bcs] = 0
    if cfg.cell_calling_mode == "gradient" and cfg.force_cells is None:
        cells_idx, call_metrics = cell_calling.call_cells_gradient(
            umis_per_bc, recovered_cells=cfg.recovered_cells)
    else:
        cells_idx, call_metrics = cell_calling.call_cells(
            call_matrix, umis_per_bc, cfg.chemistry,
            recovered_cells=cfg.recovered_cells, force_cells=cfg.force_cells,
            num_probe_bcs=n_probe if n_probe > 1 else None)
    if len(agg_bcs):
        cells_idx = np.setdiff1d(np.asarray(cells_idx), agg_bcs)
        call_metrics.update(agg_metrics)
    cells_idx = cell_calling.apply_min_umi_filter(
        umis_per_bc, cells_idx, cfg.global_minimum_umis)
    if cfg.max_mito_percent < 100.0 and n_genes > 0:
        mt_rows = cell_calling.mito_gene_rows(
            [d.id for d in features.feature_defs[:n_genes]])
        cells_idx, mito_removed, _pct = cell_calling.apply_mito_filter(
            raw.m[:n_genes] if fb_ref is not None else raw.m, cells_idx,
            mt_rows, cfg.max_mito_percent)
        call_metrics["cells_removed_mito_filter"] = int(len(mito_removed))
    filtered = raw.select_barcodes(cells_idx)
    filtered.save_h5(os.path.join(out_dir, "filtered_feature_bc_matrix.h5"),
                     chemistry_description=chem.description)
    filtered.save_mex(os.path.join(out_dir, "filtered_feature_bc_matrix"))
    perf.lap("cell_calling")

    # ---- BAM: UB tags and low-support flags join against the raw-triple
    # views of every dedup partition ----
    if bam_collector is not None:
        bam_collector.write(
            os.path.join(out_dir, "possorted_genome_bam.bam"),
            raw_views or {}, chem.barcode_length, chem.umi_length,
            gem_group=cfg.gem_group)
        perf.lap("bam_write")

    # ---- splice junction table (STAR SJ.out.tab analog) ----
    if sj_counts and gi is not None:
        _write_junctions(os.path.join(out_dir, "junctions.tsv"), sj_counts,
                         gi)

    # ---- molecule_info.h5 ----
    from ..io.molecule_info import save_molecule_info
    library_info = [
        {"library_type": lib.library_type, "library_id": str(i),
         "gem_group": cfg.gem_group}
        for i, lib in enumerate(libraries)]
    save_molecule_info(
        os.path.join(out_dir, "molecule_info.h5"),
        barcode_idx=mbc, feature_idx=mgene, umi=mumi, count=mreads,
        library_idx=mlib, library_info=library_info,
        barcodes=barcodes, features=features, gem_group=cfg.gem_group,
        pass_filter_bc_idx=np.asarray(cells_idx, np.uint64),
        metrics={"total_reads": metrics.total_reads,
                 "usable_read_pairs": metrics.usable_reads,
                 "chemistry": cfg.chemistry,
                 "sample_id": cfg.sample_id})
    perf.lap("bam_junctions_molinfo")

    # ---- barnyard GEM classification (multi-genome references) ----
    if ref is not None and len(ref.genomes) > 1 and len(cells_idx):
        from ..analysis.multigenome import classify_gems
        genome_per_gene = ref.genome_of_gene()
        per_genome_counts = np.zeros((len(cells_idx), len(ref.genomes)))
        for gidx, gname in enumerate(ref.genomes):
            rows = [i for i, gn in enumerate(genome_per_gene) if gn == gname]
            per_genome_counts[:, gidx] = np.asarray(
                filtered.m[rows, :].sum(axis=0)).ravel()
        calls, mg_summary = classify_gems(per_genome_counts, ref.genomes)
        with open(os.path.join(out_dir, "gem_classification.csv"), "w") as f:
            f.write("barcode," + ",".join(ref.genomes) + ",call\n")
            for i, b in enumerate(filtered.barcodes):
                f.write(b.decode() + "," + ",".join(
                    str(int(x)) for x in per_genome_counts[i]) +
                    f",{calls[i]}\n")
        call_metrics.update({f"multigenome_{k}": v
                             for k, v in mg_summary.items()})

    # ---- CRISPR / antigen feature assignment on called cells ----
    if fb_ref is not None and len(cells_idx):
        from ..analysis.feature_assigner import run_feature_assignment
        for ftype, sub, prefix in (
                ("CRISPR Guide Capture", "crispr_analysis", "protospacer"),
                ("Antigen Capture", "antigen_analysis", "antigen")):
            call_metrics.update(run_feature_assignment(
                filtered, ftype, os.path.join(out_dir, sub), prefix))

    # ---- secondary analysis (SC_RNA_ANALYZER analog) ----
    if cfg.secondary_analysis and len(cells_idx) >= 2:
        from ..analysis.run import run_secondary_analysis
        run_secondary_analysis(filtered, os.path.join(out_dir, "analysis"),
                               device=device)
    perf.lap("analysis_reporting")

    # ---- summary metrics ----
    bc_space = whitelist.size * n_probe
    cell_mask = np.zeros(bc_space, bool)
    cell_mask[cells_idx] = True
    in_cell = cell_mask[mbc]
    umis_in_cells = raw.counts_per_bc()[cells_idx]
    genes_per_cell = np.asarray((filtered.m > 0).sum(axis=0)).ravel()
    extra = dict(call_metrics)
    extra.update({
        "estimated_cells": int(len(cells_idx)),
        "mean_reads_per_cell": float(metrics.total_reads
                                     / max(len(cells_idx), 1)),
        "median_umis_per_cell": (float(np.median(umis_in_cells))
                                 if len(cells_idx) else 0.0),
        "median_genes_per_cell": (float(np.median(genes_per_cell))
                                  if len(cells_idx) else 0.0),
        "total_genes_detected": int((raw.counts_per_feature() > 0).sum()),
        "reads_in_cells_frac": float(mreads[in_cell].sum()
                                     / max(mreads.sum(), 1)),
        "wall_time_s": time.time() - t0,
        "sample_id": cfg.sample_id,
        "chemistry": cfg.chemistry,
    })
    perf.lap("report_summary")
    if len(mbc):
        from ..analysis.subsample import subsample_metrics
        ss = subsample_metrics(mbc, mgene, mreads, cells_idx)
        extra.update({k: v for k, v in ss.items() if k != "curves"})
        extra["subsample_curves"] = {str(r): c
                                     for r, c in ss["curves"].items()}
    perf.lap("report_subsample")

    from ..metrics import SimpleHistogram
    h_rpm = SimpleHistogram()
    if len(mreads):
        h_rpm.observe_array(mreads)
    extra["reads_per_molecule_hist"] = {
        int(k): int(v) for k, v in h_rpm.report().items()}
    if len(cells_idx):
        h_upc = SimpleHistogram()
        h_upc.observe_array(umis_in_cells)
        extra["umis_per_cell_p50"] = int(h_upc.quantile(0.5))
        extra["umis_per_cell_p90"] = int(h_upc.quantile(0.9))
    if probe is not None:
        # per-probe-region usable read tallies (targeted/RTL metrics)
        extra.update({f"probe_reads_{nm}": int(c) for nm, c in
                      zip(probe.region_names, probe.region_reads)})
    summary = metrics.to_dict(extra)
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)

    # per-barcode metrics (COLLATE_METRICS analog)
    if len(mbc):
        reads_per_bc = np.zeros(bc_space, np.int64)
        np.add.at(reads_per_bc, mbc, mreads)
        genes_per_bc_all = np.asarray((raw.m > 0).sum(axis=0)).ravel()
        with open(os.path.join(out_dir, "per_barcode_metrics.csv"), "w") as f:
            f.write("barcode,is_cell,reads,umis,genes\n")
            for ci in np.flatnonzero(umis_per_bc):
                f.write(f"{barcodes[ci].decode()},{int(cell_mask[ci])},"
                        f"{reads_per_bc[ci]},{int(umis_per_bc[ci])},"
                        f"{genes_per_bc_all[ci]}\n")
    perf.lap("report_per_barcode")
    if ref is not None:
        genome_name = ref.genome_name
    elif probe is not None:
        genome_name = probe.probe_set.metadata.get("reference_genome",
                                                   "probe")
    else:
        genome_name = "genome"
    with open(os.path.join(out_dir, "filtered_barcodes.csv"), "w") as f:
        for b in filtered.barcodes:
            f.write(genome_name + "," + b.decode() + "\n")

    from .websummary import build_web_summary
    build_web_summary(out_dir, cfg.sample_id)
    perf.lap("report_websummary")
    perf.lap("reporting")
    perf.write(os.path.join(out_dir, "_perf.json"))
    return summary


def _aggregate_barcodes(raw, features, n_genes, space: int, n_probe: int,
                        raw_views, agg_metrics: dict,
                        out_dir: str) -> np.ndarray:
    """Antibody aggregates, antigen UMI outliers and highly corrected
    barcodes (antibody/analysis.py:91-99); writes aggregate_barcodes.csv
    and fills agg_metrics when any is found."""
    from ..analysis.aggregates import (
        detect_antibody_aggregates, detect_highly_corrected_bcs,
        detect_outlier_umi_bcs)
    agg_bcs = np.zeros(0, np.int64)
    fdefs = features.feature_defs
    ab_rows = [i for i, d in enumerate(fdefs)
               if d.feature_type == "Antibody Capture"]
    ag_rows = [i for i, d in enumerate(fdefs)
               if d.feature_type == "Antigen Capture"]
    if ab_rows:
        agg_bcs = detect_antibody_aggregates(
            np.asarray(raw.m[ab_rows, :].todense()),
            num_probe_barcodes=n_probe if n_probe > 1 else None)
    if ag_rows:
        agg_bcs = np.union1d(agg_bcs, detect_outlier_umi_bcs(
            np.asarray(raw.m[ag_rows, :].todense())))
    # highly-corrected-reads signal: a barcode whose FB reads are mostly
    # UMI corrections is an aggregate
    if raw_views is not None and len(raw_views["raw_bc"]):
        fb_mask = (raw_views["raw_gene"] & LIB_MASK) >= np.uint32(n_genes)
        rb = raw_views["raw_bc"][fb_mask].astype(np.int64)
        rreads = raw_views["raw_reads"][fb_mask].astype(np.int64)
        rcorr = (raw_views["raw_corr_umi"] != raw_views["raw_umi"])[fb_mask]
        reads_per = np.bincount(rb, weights=rreads, minlength=space)
        corr_per = np.bincount(rb[rcorr], weights=rreads[rcorr],
                               minlength=space)
        agg_bcs = np.union1d(agg_bcs, detect_highly_corrected_bcs(
            reads_per, corr_per))
    if len(agg_bcs):
        per_bc_all = raw.counts_per_bc()
        agg_metrics["number_aggregate_GEMs"] = int(len(agg_bcs))
        agg_metrics["reads_lost_to_aggregate_GEMs"] = float(
            per_bc_all[agg_bcs].sum() / max(per_bc_all.sum(), 1))
        with open(os.path.join(out_dir, "aggregate_barcodes.csv"), "w") as f:
            f.write("barcode,umis\n")
            for b in agg_bcs:
                bc = raw.barcodes[b]
                f.write(f"{bc.decode() if isinstance(bc, bytes) else bc},"
                        f"{int(per_bc_all[b])}\n")
    return agg_bcs


def _write_junctions(path: str, sj_counts: dict, gi) -> None:
    agg: dict = {}
    for (d, a, _s, annot), c in sj_counts.items():
        prev = agg.get((d, a), (0, 0))
        agg[(d, a)] = (prev[0] + c, max(prev[1], annot))
    with open(path, "w") as f:
        f.write("chrom\tintron_first\tintron_last\tstrand\tmotif\t"
                "annotated\tunique_reads\n")
        for (d, a) in sorted(agg):
            c, annot = agg[(d, a)]
            ci = int(np.searchsorted(gi.chrom_starts, d, side="right") - 1)
            c0 = int(gi.chrom_starts[ci])
            t = gi.text
            d0, d1 = int(t[d]), int(t[d + 1]) if d + 1 < len(t) else -1
            a0 = int(t[a - 2]) if a >= 2 else -1
            a1 = int(t[a - 1]) if a >= 1 else -1
            if (d0, d1, a0, a1) == (2, 3, 0, 2):     # GT..AG
                strand_c, motif = "+", 1
            elif (d0, d1, a0, a1) == (1, 3, 0, 1):   # CT..AC
                strand_c, motif = "-", 2
            else:
                strand_c, motif = ".", 0
            f.write(f"{gi.chrom_names[ci]}\t{d - c0 + 1}\t{a - c0}\t"
                    f"{strand_c}\t{motif}\t{annot}\t{c}\n")
