"""The `count` pipeline, count-only slice: FASTQ -> filtered matrix.

Port of the accumulate-mode branch of cellranger_tpu/pipeline/count.py
`run_count` (single library, single-end gene expression, no BAM, one
device):

  pass 1 (== MAKE_SHARD): host barcode histogram over the whitelist (the
      correction prior);
  pass 2 (== BARCODE_CORRECTION + ALIGN_AND_COUNT): a producer thread
      decodes FASTQs, resolves barcodes on the host and packs each batch
      into one u32 plane; the device step trims, aligns (SW rescue through
      the CUDA kernel on the card), annotates, promotes multimappers and
      appends confidently mapped (bc, gene, umi) rows into device buffers
      that the host drains in bulk;
  dedup (== mark_dups.rs): the drained rows live on the device in a
      MoleculeState and are deduplicated there;
  outputs: raw/filtered matrices (MEX, and h5 where h5py is installed),
      cell calls, molecule_info.h5 (h5py), junctions, metrics JSON.

Everything outside this slice raises NotImplementedError naming its
ROADMAP item.  The host stages reuse the JAX package's jax-free modules.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from cellranger_tpu.analysis import cell_calling
from cellranger_tpu.io.chemistry import get_chemistry
from cellranger_tpu.io.matrix_io import CountMatrix, FeatureReference
from ..align.aligner import DeviceIndex, make_aligner
from ..align.annotate import (GENE_MULTI, GENE_NONE, REGION_EXONIC,
                              REGION_INTERGENIC, REGION_INTRONIC,
                              AnnotationIndex, make_annotator)
from ..io.fastq import batches_from_fastqs
from ..io.reference import ReferencePackage
from ..io.whitelist import Whitelist
from ..ops import barcode as bcops
from ..ops import encode
from ..ops.tensor_ops import U32_MASK, compact_indices, scatter_drop, widen
from ..ops.trim import make_trimmer


@dataclass
class LibraryDef:
    """One sequencing library of a run (LibrariesCsv row)."""

    fastq_pairs: list[tuple[str, str | None]]
    library_type: str = "Gene Expression"


@dataclass
class CountConfig:
    """The JAX package's CountConfig, field for field; the port runs the
    subset documented in run_count and raises on the rest."""

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


# the molecule gene column carries the library index in its high bits
LIB_SHIFT = 24
LIB_MASK = np.uint32((1 << LIB_SHIFT) - 1)

METRIC_FIELDS = ("n_mapped", "n_conf", "n_exonic", "n_intronic",
                 "n_intergenic", "n_antisense", "n_usable",
                 "n_promote_overflow", "n_tso", "n_polya_trimmed",
                 "n_improper_pair")

SECOND_CAP_FRAC = 4    # 2nd-locus / novel-SJ annotation capacity = B // 4
MOLECULE_STATE_CAP = 1 << 23
# outputs written through h5py; skipped where h5py is not installed
H5_OUTPUTS = ("raw_feature_bc_matrix.h5", "filtered_feature_bc_matrix.h5",
              "molecule_info.h5")


# ---- packed step input: ONE u32 plane per batch ----
# Per-read words: 0 bc_idx (int32 bits; whitelist rank or -1), 1 umi
# 2-bit packed, 2 flags (bit0 slot_valid, bit1 umi_valid), 3.. cDNA codes
# 2-bit packed (16 bases/word) then nmask bits (32/word).
def _codes_words(read_len: int) -> tuple[int, int]:
    """(code words, nmask words) per read for a packed cDNA plane."""
    return (read_len + 15) // 16, (read_len + 31) // 32


def packed_width(read_len: int) -> int:
    rw, nw = _codes_words(read_len)
    return 3 + rw + nw


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


def pack_step_input(read_len: int, batch, bc_idx: np.ndarray) -> np.ndarray:
    """Host: assemble the uint32 input plane for one single-end batch."""
    B = batch.batch_size
    buf = np.zeros((B, packed_width(read_len)), np.uint32)
    buf[:, 0] = np.asarray(bc_idx, np.int32).view(np.uint32)
    buf[:, 1] = batch.umi_packed
    buf[:, 2] = (batch.slot_valid.astype(np.uint32)
                 | (batch.umi_valid.astype(np.uint32) << 1))
    _pack_codes_into(buf, 3, batch.rna, batch.rna_nmask, read_len)
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


def make_count_step(didx: DeviceIndex, ann_idx: AnnotationIndex, chem,
                    read_len: int):
    """The accumulate-mode device step (port of `_make_step(...,
    accumulate=True)` without the paired-end branch).

    Returns step(plane, acc, lib_tag) which runs one packed batch and
    appends into the device buffers of `acc` IN PLACE (the JAX package
    donates them instead); step.init_acc(mol_cap, sj_cap) makes them.
    The caller keeps acc['mol_n'] + B <= mol_cap and acc['sj_n'] +
    max(B // 4, 64) <= sj_cap."""
    align = make_aligner(didx, read_len)
    annotate = make_annotator(ann_idx, didx.genome_len, didx.sj_overhang,
                              chem.strandedness)
    trim = make_trimmer(read_len)
    dev = didx.text_rows.device
    n_sj = int(didx.sj_rows.shape[0])
    glen = didx.genome_len
    contig2 = 2 * didx.sj_overhang

    def body(plane):
        B = plane.shape[0]
        buf = widen(plane)
        bc_idx = plane[:, 0].to(torch.int64)          # signed: -1 = none
        umi_packed = buf[:, 1]
        flags_in = buf[:, 2]
        slot_valid = (flags_in & 1) > 0
        umi_valid = (flags_in & 2) > 0
        rna, rna_nmask = _unpack_codes(buf, 3, read_len)
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
            n_improper_pair=torch.zeros((), dtype=torch.int64, device=dev),
        )
        return dict(
            bc=bc_idx & U32_MASK, umi=umi_packed,
            gene=torch.clamp_min(gene_eff, 0), conf_ok=conf_ok,
            pos=aln["pos"], mapq=mapq_eff, strand=aln["strand"],
            mapped=mapped, novel_sj=aln["novel_sj"],
            sj_donor=aln["sj_donor"], sj_acceptor=aln["sj_acceptor"],
            metrics=m)

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


def _check_supported(cfg: CountConfig, chem) -> None:
    """Raise NotImplementedError for what this slice does not run yet."""
    todo = [
        (cfg.probe_set_csv, "probe_set_csv: RTL probe alignment "
         "(ROADMAP queue 1, RTL probes)"),
        (chem.probe_bc is not None or cfg.probe_barcode_csv,
         "probe-barcode multiplexing (ROADMAP queue 1, RTL probes)"),
        (cfg.feature_ref_csv, "feature_ref_csv: Feature Barcode libraries "
         "(ROADMAP queue 1, Feature Barcode)"),
        (cfg.libraries and (len(cfg.libraries) > 1
                            or cfg.libraries[0].library_type
                            != "Gene Expression"),
         "more than one library / non-GEX libraries "
         "(ROADMAP queue 1, Feature Barcode)"),
        (cfg.write_bam, "write_bam: BAM output in stream mode "
         "(ROADMAP queue 1, stream mode and BAM)"),
        (cfg.shard_index, "shard_index: multi-GPU (ROADMAP queue 1, "
         "multi-GPU)"),
        (chem.rna2 is not None, f"paired chemistry {chem.name} "
         "(ROADMAP queue 1, paired-end)"),
        (cfg.secondary_analysis, "secondary_analysis=True (ROADMAP "
         "queue 1, secondary analysis); pass secondary_analysis=False"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"cellranger_tpu_torch: {what}")


def _h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def run_count(cfg: CountConfig, out_dir: str,
              whitelist: Whitelist | None = None, *, device) -> dict:
    """Run the count-only pipeline on `device` ("cuda" or "cpu"); writes
    outputs into out_dir and returns the metrics dict.  Where h5py is not
    installed the h5 outputs (H5_OUTPUTS) are not written."""
    if cfg.chemistry == "auto":
        raise NotImplementedError(
            "cellranger_tpu_torch: chemistry auto-detection (ROADMAP "
            "queue 1, chemistry auto-detect); pass an explicit chemistry")
    chem = get_chemistry(cfg.chemistry)
    _check_supported(cfg, chem)
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    from cellranger_tpu.params import get as _param
    from cellranger_tpu.perf import PerfTrace
    perf = PerfTrace()
    batch_size = int(_param("batch_size") or cfg.batch_size)
    if whitelist is None:
        whitelist = Whitelist.load(cfg.whitelist_path)

    ref = ReferencePackage.load(cfg.reference_path)
    gi = ref.genome_index
    didx = DeviceIndex.from_host(gi, device)
    ann_idx = AnnotationIndex.build(ref.transcriptome, gi, device)
    n_genes = len(ref.transcriptome.genes)
    if len(ref.genomes) > 1:
        from cellranger_tpu.io.matrix_io import FeatureDef
        features = FeatureReference(
            [FeatureDef(i, n_, "Gene Expression", gn)
             for i, n_, gn in zip(ref.transcriptome.gene_ids,
                                  ref.transcriptome.gene_names,
                                  ref.genome_of_gene())])
    else:
        features = FeatureReference.from_transcriptome(
            ref.transcriptome.gene_ids, ref.transcriptome.gene_names,
            ref.genome_name)
    libraries = cfg.libraries or [LibraryDef(cfg.fastq_pairs)]
    if len(features.feature_defs) >= (1 << LIB_SHIFT):
        raise ValueError("feature reference exceeds the 24-bit gene packing")
    metrics = CountMetrics()
    perf.lap("load_reference_index")

    # ---- checkpoint/resume (pipeline/checkpoint.py, host code) ----
    ckpt = None
    resume = None
    if cfg.checkpoint:
        from cellranger_tpu.pipeline.checkpoint import (CountCheckpoint,
                                                        count_fingerprint)
        ckpt = CountCheckpoint(out_dir, count_fingerprint(cfg))
        resume = ckpt.load("molecules")
    if resume is not None:
        mbc, mgene = resume["mbc"], resume["mgene"]
        mumi, mreads = resume["mumi"], resume["mreads"]
        mlib = resume.get("mlib", np.zeros(len(mbc), np.uint16))
        sj_counts = {tuple(int(x) for x in k): int(v)
                     for k, v in zip(resume["sj_keys"], resume["sj_vals"])}
        metrics = CountMetrics(**resume["__meta__"]["metrics"])
        perf.lap("resume_checkpoint")
    else:
        mbc, mgene, mumi, mreads, mlib, sj_counts = _count_pass(
            cfg, chem, whitelist, libraries, gi, didx, ann_idx, batch_size,
            metrics, perf)
        if ckpt is not None:
            sj_items = sorted(sj_counts.items())
            ckpt.save("molecules", dict(
                mbc=mbc, mgene=mgene, mumi=mumi, mreads=mreads, mlib=mlib,
                sj_keys=np.asarray([k for k, _ in sj_items],
                                   np.int64).reshape(-1, 4),
                sj_vals=np.asarray([v for _, v in sj_items], np.int64)),
                meta=dict(metrics=dict(metrics.__dict__)))
    return _finalize(cfg, chem, out_dir, whitelist, libraries, ref, gi,
                     features, n_genes, metrics, mbc, mgene, mumi, mreads,
                     mlib, sj_counts, perf, t0)


def _count_pass(cfg, chem, whitelist, libraries, gi, didx, ann_idx,
                batch_size, metrics, perf):
    """Passes 1 and 2 and the device dedup.  Returns the molecule table
    (bc, gene, umi, reads, library) sorted by (bc, gene, umi) and the
    splice-junction tallies."""
    from ..parallel.molecule_state import MoleculeState

    device = didx.text_rows.device
    step = make_count_step(didx, ann_idx, chem, cfg.read_len)
    work = [(li, pair) for li, lib in enumerate(libraries)
            for pair in lib.fastq_pairs]

    def my_batches(barcode_only: bool = False):
        for li, pair in work:
            i1 = pair[2] if len(pair) > 2 else None
            for batch in batches_from_fastqs(
                    chem, pair[0], pair[1], batch_size, cfg.read_len,
                    i1_path=i1, barcode_only=barcode_only):
                yield li, batch

    # ---- pass 1: host barcode histogram (the correction prior) ----
    wl_counts = np.zeros(whitelist.size, np.int64)
    for _li, batch in my_batches(barcode_only=True):
        idx = whitelist.index_of(batch.bc_packed[:batch.n_reads])
        np.add.at(wl_counts, idx[idx >= 0], 1)
    perf.lap("pass1_extract_whitelist")

    # ---- pass 2: producer thread (decode, host barcode resolve, pack,
    # upload) feeding the device step on this thread ----
    def prep(item):
        li, batch = item
        bc_idx, hit, corrected, _corr_bc = bcops.host_resolve_barcodes(
            batch.bc_packed, batch.bc_qual, batch.slot_valid,
            whitelist.sorted_seqs, wl_counts, chem.barcode_length)
        plane = upload_plane(pack_step_input(cfg.read_len, batch, bc_idx),
                             device)
        hi = dict(n_valid_bc=int(hit.sum()),
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

    mol_cap = max(4 * batch_size, 1 << 20)
    sj_cap = max(4 * batch_size, 1 << 18)
    sjb_per_batch = max(batch_size // 4, 64)
    acc = step.init_acc(mol_cap, sj_cap)
    acc_rows = 0
    acc_sj_rows = 0
    sjh_total = None
    sj_capacity_overflow = 0
    sj_counts: dict = {}
    mol_state = MoleculeState(MOLECULE_STATE_CAP, chem.umi_length, device)

    def drain_acc():
        """Absorb the molecule rows into the device state, fetch the SJ
        rows/histogram and metrics, and reset the buffers."""
        nonlocal acc, acc_rows, acc_sj_rows, sjh_total, sj_capacity_overflow
        mol_state.absorb(acc["mol"], acc["mol_n"], acc_rows)
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
        m = {k: int(v) for k, v in zip(METRIC_FIELDS, mv)}
        sj_capacity_overflow += int(mv[-1])
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
        acc = step.init_acc(mol_cap, sj_cap)
        acc_rows = 0
        acc_sj_rows = 0

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
            if (acc_rows + batch.batch_size > mol_cap
                    or acc_sj_rows + sjb_per_batch > sj_cap):
                drain_acc()
            step(plane, acc, lib_tag=li << LIB_SHIFT)
            acc_rows += batch.batch_size
            acc_sj_rows += sjb_per_batch
            metrics.total_reads += batch.n_reads
            metrics.valid_barcode_reads += hi["n_valid_bc"] + hi["n_corrected"]
            metrics.corrected_barcode_reads += hi["n_corrected"]
            metrics.valid_umi_reads += hi["n_valid_umi"]
            perf.lap("pass2_correct_align_annotate")
    finally:
        stop.set()
        while producer.is_alive():   # unblock a producer waiting on put()
            try:
                bq.get(timeout=0.1)
            except _queue.Empty:
                pass
        producer.join()
    drain_acc()
    # annotated-junction contig hits -> (donor, acceptor, strand, 1) keys
    for h in np.flatnonzero(sjh_total):
        ji, s = int(h) // 2, int(h) % 2
        key = (int(gi.sj_donor_end[ji]), int(gi.sj_acceptor_start[ji]), s, 1)
        sj_counts[key] = sj_counts.get(key, 0) + int(sjh_total[h])
    metrics.sj_capacity_overflow += sj_capacity_overflow
    perf.lap("pass2_correct_align_annotate")

    # ---- dedup on the device (everything already resident) ----
    mbc, mgene, mumi, mreads = mol_state.finalize()
    mlib = (mgene >> np.uint32(LIB_SHIFT)).astype(np.uint16)
    mgene = mgene & LIB_MASK
    order = np.lexsort((mumi, mgene, mbc))
    mbc, mgene, mumi, mreads, mlib = (mbc[order], mgene[order],
                                      mumi[order], mreads[order],
                                      mlib[order])
    metrics.total_molecules = int(len(mbc))
    perf.lap("dedup")
    return mbc, mgene, mumi, mreads, mlib, sj_counts


def _finalize(cfg, chem, out_dir, whitelist, libraries, ref, gi, features,
              n_genes, metrics, mbc, mgene, mumi, mreads, mlib, sj_counts,
              perf, t0):
    """Matrices, cell calls, junctions, molecule info, metrics (host)."""
    have_h5 = _h5py_available()
    out_seqs = (whitelist.translation if whitelist.translation is not None
                else whitelist.sorted_seqs)
    suffix = f"-{cfg.gem_group}".encode()
    barcodes = [encode.decode_codes(encode.unpack_np(s, whitelist.length))
                + suffix for s in out_seqs]
    raw = CountMatrix.from_molecules(mbc.astype(np.int64),
                                     mgene.astype(np.int64), barcodes,
                                     features)
    if have_h5:
        raw.save_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"),
                    chemistry_description=chem.description)
    raw.save_mex(os.path.join(out_dir, "raw_feature_bc_matrix"))
    perf.lap("matrix_assembly")

    # ---- cell calling ----
    umis_per_bc = raw.counts_per_bc()
    if cfg.cell_calling_mode == "gradient" and cfg.force_cells is None:
        cells_idx, call_metrics = cell_calling.call_cells_gradient(
            umis_per_bc, recovered_cells=cfg.recovered_cells)
    else:
        cells_idx, call_metrics = cell_calling.call_cells(
            raw.m, umis_per_bc, cfg.chemistry,
            recovered_cells=cfg.recovered_cells, force_cells=cfg.force_cells,
            num_probe_bcs=None)
    cells_idx = cell_calling.apply_min_umi_filter(
        umis_per_bc, cells_idx, cfg.global_minimum_umis)
    if cfg.max_mito_percent < 100.0 and n_genes > 0:
        mt_rows = cell_calling.mito_gene_rows(
            [d.id for d in features.feature_defs[:n_genes]])
        cells_idx, mito_removed, _pct = cell_calling.apply_mito_filter(
            raw.m, cells_idx, mt_rows, cfg.max_mito_percent)
        call_metrics["cells_removed_mito_filter"] = int(len(mito_removed))
    filtered = raw.select_barcodes(cells_idx)
    if have_h5:
        filtered.save_h5(
            os.path.join(out_dir, "filtered_feature_bc_matrix.h5"),
            chemistry_description=chem.description)
    filtered.save_mex(os.path.join(out_dir, "filtered_feature_bc_matrix"))
    perf.lap("cell_calling")

    # ---- splice junction table (STAR SJ.out.tab analog) ----
    if sj_counts:
        _write_junctions(os.path.join(out_dir, "junctions.tsv"), sj_counts,
                         gi)

    # ---- molecule_info.h5 ----
    if have_h5:
        from cellranger_tpu.io.molecule_info import save_molecule_info
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
    if len(ref.genomes) > 1 and len(cells_idx):
        from cellranger_tpu.analysis.multigenome import classify_gems
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
    perf.lap("analysis_reporting")

    # ---- summary metrics ----
    bc_space = whitelist.size
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
        from cellranger_tpu.analysis.subsample import subsample_metrics
        ss = subsample_metrics(mbc, mgene, mreads, cells_idx)
        extra.update({k: v for k, v in ss.items() if k != "curves"})
        extra["subsample_curves"] = {str(r): c
                                     for r, c in ss["curves"].items()}
    perf.lap("report_subsample")

    from cellranger_tpu.metrics import SimpleHistogram
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
    with open(os.path.join(out_dir, "filtered_barcodes.csv"), "w") as f:
        for b in filtered.barcodes:
            f.write(ref.genome_name + "," + b.decode() + "\n")

    from cellranger_tpu.pipeline.websummary import build_web_summary
    build_web_summary(out_dir, cfg.sample_id)
    perf.lap("report_websummary")
    perf.lap("reporting")
    perf.write(os.path.join(out_dir, "_perf.json"))
    return summary


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
