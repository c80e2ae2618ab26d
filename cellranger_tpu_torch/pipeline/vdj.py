"""V(D)J pipeline: FASTQ -> per-cell contigs, annotations, clonotypes
(the SC_VDJ_ASSEMBLER_CS analog, mro/rna/sc_vdj_assembler_cs.mro:27 ->
MAKE_SHARD/BARCODE_CORRECTION -> ASSEMBLE_VDJ -> RUN_ENCLONE chain).

Flow: barcode extraction/correction reuses the count machinery; the
(barcode, kmer) spectrum is counted on device (vdj.assembly.count_bc_kmers);
contig assembly walks unitigs per barcode on host; V/J annotation + CDR3 +
clonotype grouping per vdj.annotate. Cell calling: barcodes with a
productive, UMI-supported contig (asm_call_cells.rs simplification).

Port of cellranger_tpu/pipeline/vdj.py: `run_vdj` takes the device its
device half runs on -- the whitelist membership and pass-1 histogram
(ops/barcode.py `whitelist_lookup`, `count_valid_barcodes`), the posterior
barcode correction (`correct_barcodes`) and the kmer spectrum
(vdj/assembly.py `count_bc_umi_kmers`) -- and raises rather than move to
another.  The per-barcode host work is batched (vdj/support.py): pass 2
keeps each barcode's reads as rows of the arrays handed to the kmer
spectrum, trims primers for a whole batch at once, and the UMI support,
base qualities and annotation of a barcode's contigs take those rows,
with the original's results bit for bit.  Graph cleaning, assembly,
clonotypes and every output file are the original's code.  `LAST_SPLIT`
holds the seconds of the last run's stages.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..io.chemistry import get_chemistry
from ..io.fastq import batches_from_fastqs
from ..io.gtf import write_fasta
from ..io.whitelist import Whitelist
from ..ops import barcode as bcops
from ..ops import encode
from ..vdj import support
from ..vdj.annotate import group_clonotypes
from ..vdj.assembly import (BarcodeGraph, all_inner_primers,
                            assemble_barcode, count_bc_umi_kmers, _revcomp_b)
from ..vdj.reference import VdjReference

MIN_UMIS_PER_CONTIG = 2
from ..params import get as _param

# seconds and counts of the last run_vdj's stages: pass1_s, pass2_s
# (correction, primer trim, read rows; the kmer spectrum apart), kmers_s,
# graph_s (graph, cleaning, assembly), support_s, annotation_s, quals_s,
# outputs_s (clonotypes and every file); barcodes (with a spectrum),
# contigs (support computed), annotated, alignments
LAST_SPLIT: dict = {}


def _u32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host array -> u32 values (int64) on `device`."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


@dataclass
class VdjConfig:
    fastq_pairs: list[tuple[str, str | None]]
    vdj_reference_fasta: str
    whitelist_path: str
    chemistry: str = "SCVDJ-R2"
    read_len: int = 120
    batch_size: int = 4096
    sample_id: str = "vdj_sample"


def run_vdj(cfg: VdjConfig, out_dir: str, *, device) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    # read the site tunable per RUN (not at import) so a parameters.toml /
    # CRTPU_PARAMETERS override loaded after this module imports applies
    _VDJ_MAX_READS_PER_BC = int(_param("vdj_max_reads_per_barcode"))
    chem = get_chemistry(cfg.chemistry)
    wl = Whitelist.load(cfg.whitelist_path)
    from ..ops.bucket_table import BucketTable
    wl_table = BucketTable.build_exact(
        wl.sorted_seqs, np.arange(wl.size, dtype=np.uint32), device,
        entries=8, fields=3)
    ref = VdjReference.from_fasta(cfg.vdj_reference_fasta)
    annotator = support.Annotator(ref)
    split = dict(pass1_s=0.0, pass2_s=0.0, kmers_s=0.0, graph_s=0.0,
                 support_s=0.0, annotation_s=0.0, quals_s=0.0,
                 outputs_s=0.0, barcodes=0, contigs=0, annotated=0)
    LAST_SPLIT.clear()
    tick = time.perf_counter()

    # pass 1: extract, count valid bcs
    cached = []
    wl_counts = torch.zeros(wl.size, dtype=torch.int32, device=device)
    for (r1, r2) in cfg.fastq_pairs:
        for b in batches_from_fastqs(chem, r1, r2, cfg.batch_size, cfg.read_len):
            hit, idx = bcops.whitelist_lookup(_u32(b.bc_packed, device),
                                              wl_table)
            wl_counts = wl_counts + bcops.count_valid_barcodes(
                idx, torch.from_numpy(b.slot_valid).to(device), wl.size)
            cached.append(b)

    # pass 2: correct, trim enrichment primers, collect per-read
    # (bc_idx, umi, seq, qual) as rows.  Primer trimming
    # (process.rs:730-758): bases 5' of a reverse-complemented
    # inner-primer hit are primer-derived — masked out of both kmer
    # counting and the pileup.
    split["pass1_s"] = time.perf_counter() - tick
    tick = time.perf_counter()
    primers_rc = [_revcomp_b(p) for p in all_inner_primers()]
    all_bc, all_umi, all_rna, all_nmask = [], [], [], []
    all_qual, all_start, all_end = [], [], []
    total_reads = valid_bc_reads = trimmed_reads = 0
    wl_table = wl_table.with_counts(wl_counts.cpu().numpy())
    for b in cached:
        packed = _u32(b.bc_packed, device)
        hit, idx = bcops.whitelist_lookup(packed, wl_table)
        corr_bc, corr_idx, corrected = bcops.correct_barcodes(
            packed, torch.from_numpy(b.bc_qual).to(device), wl_table,
            chem.barcode_length)
        bc_ok = (hit | corrected).cpu().numpy() & b.slot_valid
        bc_idx = torch.where(hit, idx, corr_idx).cpu().numpy()
        total_reads += b.n_reads
        valid_bc_reads += int(bc_ok.sum())
        sel = bc_ok & b.umi_valid
        # a read is columns [t, rna_len) of its row: t its trim start
        t = support.primer_trim_starts(b.rna[sel], b.rna_nmask[sel],
                                       b.rna_len[sel], primers_rc, device)
        trimmed_reads += int((t > 0).sum())
        W = b.rna.shape[1]
        all_bc.append(bc_idx[sel].astype(np.uint32))
        all_umi.append(b.umi_packed[sel].astype(np.uint32))
        all_rna.append(b.rna[sel])
        all_nmask.append(b.rna_nmask[sel] & (np.arange(W) >= t[:, None]))
        all_qual.append(b.rna_qual[sel])
        all_start.append(t)
        all_end.append(b.rna_len[sel].astype(np.int64))
        if b.rna2 is not None:
            # paired-end SCVDJ: mate 2 reads the opposite strand — add its
            # reverse complement so kmers land on the transcript strand
            # (process.rs "double end case" assembles both mates)
            rc = (3 - b.rna2[sel][:, ::-1]).astype(np.uint8)
            rc_mask = b.rna2_nmask[sel][:, ::-1]
            all_bc.append(bc_idx[sel].astype(np.uint32))
            all_umi.append(b.umi_packed[sel].astype(np.uint32))
            all_rna.append(rc)
            all_nmask.append(rc_mask)
            # mate 2's read is the last rna2_len columns of its reversed row
            all_qual.append(b.rna2_qual[sel][:, ::-1])
            all_start.append(W - b.rna2_len[sel].astype(np.int64))
            all_end.append(np.full(int(sel.sum()), W, np.int64))

    store = None
    if all_bc and len(np.concatenate(all_bc)):
        bcs = np.concatenate(all_bc)
        umis_arr = np.concatenate(all_umi)
        rna = np.concatenate(all_rna)
        nmask = np.concatenate(all_nmask)
        del all_rna, all_nmask
        store = support.ReadStore(
            bcs, umis_arr, rna, nmask, np.concatenate(all_qual),
            np.concatenate(all_start), np.concatenate(all_end),
            _VDJ_MAX_READS_PER_BC)
        del all_qual
        split["pass2_s"] = time.perf_counter() - tick
        tick = time.perf_counter()
        kb, ku, kk, kc = count_bc_umi_kmers(bcs, umis_arr, rna, nmask,
                                            device=device)
        split["kmers_s"] = time.perf_counter() - tick
    else:
        kb = np.zeros(0, np.uint32)
        split["pass2_s"] = time.perf_counter() - tick

    # host: per-barcode spectra -> contigs -> annotation
    contigs_by_bc = {}
    cells = {}
    contig_rows = []
    # each barcode's rows of the spectrum: [i, j)
    bounds = np.flatnonzero(np.diff(kb.astype(np.int64), prepend=-1,
                                    append=-1))
    for i, j in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        bc = int(kb[i])
        tick = time.perf_counter()
        # UMI-aware graph + the cleaning suite (ref_free.rs:422-810
        # analogs), then greedy strong-path unitigs over what survives
        graph = BarcodeGraph.from_triples(kk[i:j], ku[i:j], kc[i:j]).clean()
        spectrum = graph.spectrum()
        contigs = assemble_barcode(spectrum)
        split["barcodes"] += 1
        t_graph = time.perf_counter()
        split["graph_s"] += t_graph - tick
        if not contigs:
            continue
        sup = support.BarcodeSupport(store.reads(bc), device)
        split["support_s"] += time.perf_counter() - t_graph
        anns = []
        for ci, contig in enumerate(contigs[:10]):
            tick = time.perf_counter()
            sup.umi_support(contig)
            split["contigs"] += 1
            t_sup = time.perf_counter()
            split["support_s"] += t_sup - tick
            if contig.n_umis < MIN_UMIS_PER_CONTIG:
                continue
            ann = annotator.annotate(contig.seq)
            split["annotation_s"] += time.perf_counter() - t_sup
            anns.append((contig, ann))
        if not anns:
            continue
        bc_str = encode.decode_codes(
            encode.unpack_np(np.uint32(wl.sorted_seqs[bc]), wl.length)
        ).decode() + "-1"
        contigs_by_bc[bc_str] = anns
        productive = [a for _, a in anns if a.productive]
        if productive:
            cells[bc_str] = [a for _, a in anns]
        tick = time.perf_counter()
        split["annotated"] += len(anns)
        for ci, (contig, ann) in enumerate(anns):
            contig_rows.append(dict(
                barcode=bc_str, contig_id=f"{bc_str}_contig_{ci + 1}",
                length=len(contig.seq), umis=contig.n_umis,
                reads=contig.n_reads,
                chain=ann.chain or "None",
                v_gene=ann.v.segment.gene_name if ann.v else "None",
                j_gene=ann.j.segment.gene_name if ann.j else "None",
                c_gene=ann.c.segment.gene_name if ann.c else "None",
                cdr3=ann.cdr3_aa or "None", cdr3_nt=ann.cdr3_nt or "None",
                full_length=ann.full_length, productive=ann.productive,
                is_cell=bc_str in cells,
                sequence=contig.seq, _ann=ann, _contig=contig,
                _quals=sup.contig_base_quals(contig.seq)))
        split["quals_s"] += time.perf_counter() - tick

    tick = time.perf_counter()
    clonotypes = group_clonotypes(cells)
    clonotype_of_bc = {}
    for c in clonotypes:
        for bc in c["barcodes"]:
            clonotype_of_bc[bc] = c["clonotype_id"]

    # outputs (reference vdj outs, _sc_vdj_clonotype_assigner.mro:3 chain:
    # all/filtered contig annotations + fasta/fastq, cell_barcodes.json,
    # consensus + concat_ref, clonotypes.csv, AIRR TSV)
    def write_contig_csv(path, rows):
        cols = ["barcode", "is_cell", "contig_id", "length", "chain",
                "v_gene", "j_gene", "c_gene", "cdr3", "cdr3_nt",
                "reads", "umis", "full_length", "productive"]
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for r in rows:
                f.write(",".join(str(r[c]) for c in cols) + "\n")

    def write_fastq(path, rows):
        # per-base qualities from the Bayesian read pileup
        # (vdj_asm_utils/src/sw.rs:59 pos_base_quals analog)
        with open(path, "w") as f:
            for r in rows:
                q = r.get("_quals")
                qs = ("".join(chr(min(int(x), 60) + 33) for x in q)
                      if q is not None else "F" * len(r["sequence"]))
                f.write(f"@{r['contig_id']}\n{r['sequence']}\n+\n{qs}\n")

    filt_rows = [r for r in contig_rows if r["is_cell"]]
    write_contig_csv(os.path.join(out_dir, "all_contig_annotations.csv"),
                     contig_rows)
    write_contig_csv(os.path.join(out_dir, "filtered_contig_annotations.csv"),
                     filt_rows)
    write_fasta(os.path.join(out_dir, "all_contig.fasta"),
                {r["contig_id"]: r["sequence"].encode() for r in contig_rows})
    write_fasta(os.path.join(out_dir, "filtered_contig.fasta"),
                {r["contig_id"]: r["sequence"].encode() for r in filt_rows})
    write_fastq(os.path.join(out_dir, "all_contig.fastq"), contig_rows)
    write_fastq(os.path.join(out_dir, "filtered_contig.fastq"), filt_rows)
    with open(os.path.join(out_dir, "cell_barcodes.json"), "w") as f:
        json.dump(sorted(cells), f, indent=2)

    # all_contig_annotations.json: contig records with segment alignment
    # coordinates (reference writes these from the vdj_proto contig protos)
    def seg_json(hit, region):
        if hit is None:
            return None
        return dict(feature=dict(region_type=f"{region}-REGION",
                                 gene_name=hit.segment.gene_name,
                                 chain=hit.segment.chain),
                    contig_match_start=hit.contig_start,
                    contig_match_end=hit.contig_end,
                    score=hit.score)
    with open(os.path.join(out_dir, "all_contig_annotations.json"), "w") as f:
        json.dump([dict(
            barcode=r["barcode"], contig_name=r["contig_id"],
            sequence=r["sequence"], length=r["length"],
            chain=r["chain"], cdr3=r["cdr3"], cdr3_seq=r["cdr3_nt"],
            umi_count=r["umis"], read_count=r["reads"],
            productive=r["productive"], full_length=r["full_length"],
            is_cell=r["is_cell"], high_confidence=r["is_cell"],
            clonotype=clonotype_of_bc.get(r["barcode"]),
            annotations=[a for a in (seg_json(r["_ann"].v, "V"),
                                     seg_json(r["_ann"].j, "J"),
                                     seg_json(r["_ann"].c, "C")) if a],
        ) for r in contig_rows], f, indent=1)

    # consensus per (clonotype, chain): the member contig with the highest
    # UMI support (deterministic medoid stand-in for the reference's
    # pileup consensus); concat_ref = its germline V[+C] segment splice
    consensus_fa, concat_fa, cons_rows = {}, {}, []
    for c in clonotypes:
        member_anns = []
        for bc in c["barcodes"]:
            member_anns.extend(contigs_by_bc.get(bc, []))
        for i, ch in enumerate(c["chains"]):
            cand = [(ct, an) for ct, an in member_anns
                    if an.productive and an.chain == ch["chain"]
                    and (an.v and an.v.segment.gene_name == ch["v_gene"])
                    and (an.j and an.j.segment.gene_name == ch["j_gene"])]
            if not cand:
                continue
            ct, an = max(cand, key=lambda p: (p[0].n_umis, p[0].seq))
            cid = f"{c['clonotype_id']}_consensus_{i + 1}"
            consensus_fa[cid] = ct.seq.encode()
            germ = an.v.segment.seq + an.j.segment.seq
            if an.c:
                germ += an.c.segment.seq
            concat_fa[f"{cid}_concat_ref"] = germ
            cons_rows.append(dict(
                clonotype_id=c["clonotype_id"], consensus_id=cid,
                length=len(ct.seq), chain=ch["chain"],
                v_gene=ch["v_gene"], j_gene=ch["j_gene"],
                c_gene=an.c.segment.gene_name if an.c else "None",
                cdr3=an.cdr3_aa or "None", cdr3_nt=ch["cdr3_nt"],
                umis=sum(x.n_umis for x, a2 in cand),
                reads=sum(x.n_reads for x, a2 in cand)))
    write_fasta(os.path.join(out_dir, "consensus.fasta"), consensus_fa)
    write_fasta(os.path.join(out_dir, "concat_ref.fasta"), concat_fa)
    with open(os.path.join(out_dir, "consensus_annotations.csv"), "w") as f:
        cols = ["clonotype_id", "consensus_id", "length", "chain", "v_gene",
                "j_gene", "c_gene", "cdr3", "cdr3_nt", "reads", "umis"]
        f.write(",".join(cols) + "\n")
        for r in cons_rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")

    # vdj_reference/ copy (clonotype_assigner/copy_vdj_reference.rs analog)
    refdir = os.path.join(out_dir, "vdj_reference", "fasta")
    os.makedirs(refdir, exist_ok=True)
    import shutil
    shutil.copyfile(cfg.vdj_reference_fasta,
                    os.path.join(refdir, "regions.fa"))
    with open(os.path.join(out_dir, "clonotypes.csv"), "w") as f:
        f.write("clonotype_id,frequency,proportion,cdr3s_nt\n")
        for c in clonotypes:
            cdr3s = ";".join(f"{ch['chain']}:{ch['cdr3_nt']}"
                             for ch in c["chains"])
            f.write(f"{c['clonotype_id']},{c['frequency']},"
                    f"{c['frequency'] / max(len(cells), 1):.4f},{cdr3s}\n")

    # AIRR rearrangement TSV (CREATE_AIRR_TSV analog; AIRR schema core cols)
    with open(os.path.join(out_dir, "airr_rearrangement.tsv"), "w") as f:
        cols = ["cell_id", "clone_id", "sequence_id", "sequence", "productive",
                "v_call", "j_call", "c_call", "junction", "junction_aa",
                "consensus_count", "duplicate_count", "locus"]
        f.write("\t".join(cols) + "\n")
        for r in contig_rows:
            f.write("\t".join(str(x) for x in [
                r["barcode"], clonotype_of_bc.get(r["barcode"], ""),
                r["contig_id"], r["sequence"],
                "T" if r["productive"] else "F",
                r["v_gene"], r["j_gene"], r["c_gene"],
                r["cdr3_nt"], r["cdr3"], r["umis"], r["reads"],
                r["chain"]]) + "\n")

    from ..stats import n50
    cell_lens = [r["length"] for r in contig_rows if r["is_cell"]]
    summary = dict(
        total_reads=total_reads,
        valid_barcode_frac=valid_bc_reads / max(total_reads, 1),
        barcodes_with_contigs=len(contigs_by_bc),
        estimated_cells=len(cells),
        n_clonotypes=len(clonotypes),
        # contig length N50s (vdj metrics parity; stats crate nx.rs)
        all_contig_n50=n50([r["length"] for r in contig_rows]),
        cell_contig_n50=n50(cell_lens),
        median_cell_contig_length=(float(np.median(cell_lens))
                                   if cell_lens else 0.0),
        sample_id=cfg.sample_id,
    )
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    from .websummary import build_web_summary
    build_web_summary(out_dir, cfg.sample_id, pipeline="vdj")
    split["outputs_s"] = time.perf_counter() - tick
    split["alignments"] = annotator.alignments
    LAST_SPLIT.update(split)
    return summary
