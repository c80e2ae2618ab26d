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
reads the FASTQs again and writes each read once, into rows of the
arrays handed to the kmer spectrum, so the host holds one copy of the
reads; it trims primers for a whole batch at once, and the UMI support,
base qualities and annotation of a barcode's contigs take those rows,
with the original's results bit for bit.  A barcode whose rows (the first vdj_max_reads_per_barcode)
hold fewer than MIN_UMIS_PER_CONTIG distinct UMIs can keep no contig, so
its graph is never built.  Graph cleaning and assembly, the original's
code, run in a pool of `spawn` worker processes, a task of barcodes at a
time; this process takes their contigs in barcode order and does the
support, annotation and base qualities meanwhile.  Clonotypes and every
output file are the original's code.  `LAST_SPLIT` holds the seconds of
the last run's stages.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
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
from ..vdj.assembly import (_assemble_spectra, all_inner_primers,
                            count_bc_umi_kmers, _revcomp_b)
from ..vdj.reference import VdjReference

MIN_UMIS_PER_CONTIG = 2
from ..params import get as _param

# seconds and counts of the last run_vdj's stages: pass1_s, pass2_s
# (correction, primer trim, read rows; the kmer spectrum apart), kmers_s,
# skip_s (the distinct UMIs of every barcode), graph_s (graph, cleaning,
# assembly, summed over the workers), graph_wait_s (this process waiting
# for them), support_s, annotation_s, quals_s, outputs_s (clonotypes and
# every file); barcodes (graphs built), barcodes_skipped (too few UMIs),
# graph_workers, contigs (support computed), annotated, alignments;
# kmer_blocks, kmer_block_rows_max and kmer_block_ranks_max of the
# spectrum; by_barcode: per barcode assembled, in order, its whitelist
# index, spectrum rows, graph seconds (in its worker) and this process's
# seconds on it
LAST_SPLIT: dict = {}

# graph and assembly worker processes; None: one a CPU this process may
# run on
GRAPH_WORKERS: int | None = None
GRAPH_TASK_ROWS = 1 << 17       # spectrum rows sent to a worker at once, about


def _graph_tasks(bounds: np.ndarray, keep: np.ndarray) -> list:
    """The kept barcodes (indices into bounds[:-1]) in order, cut into
    runs of about GRAPH_TASK_ROWS spectrum rows, at least one barcode a
    run."""
    tasks, cur, rows = [], [], 0
    for b in np.flatnonzero(keep).tolist():
        n = int(bounds[b + 1] - bounds[b])
        if cur and rows + n > GRAPH_TASK_ROWS:
            tasks.append(cur)
            cur, rows = [], 0
        cur.append(b)
        rows += n
    return tasks + [cur] if cur else tasks


def _in_order(tasks: list, done, split: dict):
    """(barcode index, (contigs, seconds)) of each task's barcodes as its
    worker's result arrives, the tasks in order; the wait is added to
    split["graph_wait_s"]."""
    for task in tasks:
        tick = time.perf_counter()
        assembled = next(done)
        split["graph_wait_s"] += time.perf_counter() - tick
        yield from zip(task, assembled)


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


def _annotated(contigs: list, store, bc: int, device, annotator,
               split: dict):
    """A barcode's contigs from its worker: the UMI support of the first
    ten and the annotation of those that keep MIN_UMIS_PER_CONTIG UMIs.
    Returns the barcode's support and [(contig, annotation)]."""
    tick = time.perf_counter()
    sup = support.BarcodeSupport(store.reads(bc), device)
    split["support_s"] += time.perf_counter() - tick
    anns = []
    for contig in contigs[:10]:
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
    return sup, anns


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
    split = dict(pass1_s=0.0, pass2_s=0.0, kmers_s=0.0, skip_s=0.0,
                 graph_s=0.0, graph_wait_s=0.0, support_s=0.0,
                 annotation_s=0.0, quals_s=0.0, outputs_s=0.0, barcodes=0,
                 barcodes_skipped=0, graph_workers=0, contigs=0, annotated=0,
                 by_barcode=dict(barcode=[], spectrum_rows=[], graph_s=[],
                                 host_s=[]))
    LAST_SPLIT.clear()
    tick = time.perf_counter()

    def batches():
        for (r1, r2) in cfg.fastq_pairs:
            yield from batches_from_fastqs(chem, r1, r2, cfg.batch_size,
                                           cfg.read_len)

    # pass 1: extract, count valid bcs and the rows pass 2 may write
    wl_counts = torch.zeros(wl.size, dtype=torch.int32, device=device)
    n_rows, W = 0, None
    for b in batches():
        hit, idx = bcops.whitelist_lookup(_u32(b.bc_packed, device),
                                          wl_table)
        wl_counts = wl_counts + bcops.count_valid_barcodes(
            idx, torch.from_numpy(b.slot_valid).to(device), wl.size)
        n_rows += b.n_reads * (1 if b.rna2 is None else 2)
        if W is not None and b.rna.shape[1] != W:
            raise ValueError(f"a batch of {b.rna.shape[1]}-column reads "
                             f"among {W}-column ones")
        W = b.rna.shape[1]

    # pass 2: the FASTQs read again (a cache of pass 1's batches would be
    # a second copy of the reads: one batch at a time is held), correct,
    # trim enrichment primers, write each read's (bc_idx, umi, seq,
    # nmask, qual, start, end) into one row of arrays sized by pass 1
    # (trimmed after).  Primer trimming (process.rs:730-758): bases 5' of
    # a reverse-complemented inner-primer hit are primer-derived — masked
    # out of both kmer counting and the pileup.
    split["pass1_s"] = time.perf_counter() - tick
    tick = time.perf_counter()
    primers_rc = [_revcomp_b(p) for p in all_inner_primers()]
    total_reads = valid_bc_reads = trimmed_reads = 0
    wl_table = wl_table.with_counts(wl_counts.cpu().numpy())
    W = W or 0
    bcs = np.empty(n_rows, np.uint32)
    umis_arr = np.empty(n_rows, np.uint32)
    rna = np.empty((n_rows, W), np.uint8)
    nmask = np.empty((n_rows, W), bool)
    qual = np.empty((n_rows, W), np.uint8)
    start = np.empty(n_rows, np.int64)
    end = np.empty(n_rows, np.int64)
    n = 0
    for b in batches():
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
        m = int(sel.sum())
        # a read is columns [t, rna_len) of its row: t its trim start
        t = support.primer_trim_starts(b.rna[sel], b.rna_nmask[sel],
                                       b.rna_len[sel], primers_rc, device)
        trimmed_reads += int((t > 0).sum())
        rows = slice(n, n + m)
        bcs[rows] = bc_idx[sel]
        umis_arr[rows] = b.umi_packed[sel]
        rna[rows] = b.rna[sel]
        nmask[rows] = b.rna_nmask[sel] & (np.arange(W) >= t[:, None])
        qual[rows] = b.rna_qual[sel]
        start[rows] = t
        end[rows] = b.rna_len[sel]
        n += m
        if b.rna2 is not None:
            # paired-end SCVDJ: mate 2 reads the opposite strand — add its
            # reverse complement so kmers land on the transcript strand
            # (process.rs "double end case" assembles both mates)
            rows = slice(n, n + m)
            bcs[rows] = bc_idx[sel]
            umis_arr[rows] = b.umi_packed[sel]
            rna[rows] = 3 - b.rna2[sel][:, ::-1]
            nmask[rows] = b.rna2_nmask[sel][:, ::-1]
            # mate 2's read is the last rna2_len columns of its reversed row
            qual[rows] = b.rna2_qual[sel][:, ::-1]
            start[rows] = W - b.rna2_len[sel]
            end[rows] = W
            n += m
    bcs, umis_arr, rna, nmask = bcs[:n], umis_arr[:n], rna[:n], nmask[:n]

    store = None
    if n:
        store = support.ReadStore(bcs, umis_arr, rna, nmask, qual[:n],
                                  start[:n], end[:n], _VDJ_MAX_READS_PER_BC)
        split["pass2_s"] = time.perf_counter() - tick
        tick = time.perf_counter()
        spec = {}
        kb, ku, kk, kc = count_bc_umi_kmers(bcs, umis_arr, rna, nmask,
                                            device=device, stats=spec)
        split.update(kmers_s=time.perf_counter() - tick,
                     kmer_blocks=spec["blocks"],
                     kmer_block_rows_max=spec["largest_block_rows"],
                     kmer_block_ranks_max=spec["largest_block_ranks"])
    else:
        kb = np.zeros(0, np.uint32)
        split["pass2_s"] = time.perf_counter() - tick
    del qual, start, end

    # host: per-barcode spectra -> contigs -> annotation
    contigs_by_bc = {}
    cells = {}
    contig_rows = []
    # each barcode's rows of the spectrum: [bounds[b], bounds[b + 1])
    bounds = np.flatnonzero(np.diff(kb.astype(np.int64), prepend=-1,
                                    append=-1))
    tick = time.perf_counter()
    keep = np.zeros(len(bounds) - 1, bool)
    if len(keep):
        # a contig needs MIN_UMIS_PER_CONTIG distinct UMIs among the rows
        # its support is given: skip a barcode whose rows hold fewer
        ubc, n_umi = store.distinct_umis(device)
        keep = n_umi[np.searchsorted(ubc, kb[bounds[:-1]])] \
            >= MIN_UMIS_PER_CONTIG
    split["barcodes_skipped"] = int((~keep).sum())
    split["skip_s"] = time.perf_counter() - tick
    tasks = _graph_tasks(bounds, keep)
    n_workers = min(GRAPH_WORKERS or len(os.sched_getaffinity(0)),
                    len(tasks))
    split["graph_workers"] = n_workers
    by_bc = split["by_barcode"]
    pool = (ProcessPoolExecutor(n_workers, multiprocessing.get_context(
        "spawn")) if tasks else None)
    try:
        done = iter(pool.map(_assemble_spectra, [
            [(kk[bounds[b]:bounds[b + 1]], ku[bounds[b]:bounds[b + 1]],
              kc[bounds[b]:bounds[b + 1]]) for b in task] for task in tasks])
            if tasks else ())
        for b, (contigs, graph_s) in _in_order(tasks, done, split):
            bc = int(kb[bounds[b]])
            t_bc = time.perf_counter()
            split["barcodes"] += 1
            split["graph_s"] += graph_s
            by_bc["barcode"].append(bc)
            by_bc["spectrum_rows"].append(int(bounds[b + 1] - bounds[b]))
            by_bc["graph_s"].append(graph_s)
            anns = []
            if contigs:
                sup, anns = _annotated(contigs, store, bc, device,
                                       annotator, split)
            if anns:
                bc_str = encode.decode_codes(encode.unpack_np(
                    np.uint32(wl.sorted_seqs[bc]), wl.length)
                ).decode() + "-1"
                contigs_by_bc[bc_str] = anns
                if any(a.productive for _, a in anns):
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
                        cdr3=ann.cdr3_aa or "None",
                        cdr3_nt=ann.cdr3_nt or "None",
                        full_length=ann.full_length, productive=ann.productive,
                        is_cell=bc_str in cells,
                        sequence=contig.seq, _ann=ann, _contig=contig,
                        _quals=sup.contig_base_quals(contig.seq)))
                split["quals_s"] += time.perf_counter() - tick
            by_bc["host_s"].append(time.perf_counter() - t_bc)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)

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
