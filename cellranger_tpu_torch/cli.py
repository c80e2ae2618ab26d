"""cellranger-tpu-torch CLI: the subcommands of `cellranger_tpu`; those
that compute on a device run on `--device` (default cuda).

    python -m cellranger_tpu_torch count --id S --fastqs DIR \
        --reference REF --whitelist WL [--chemistry SC3Pv3|auto] [--bam]
    python -m cellranger_tpu_torch multi --id S --csv CONFIG --whitelist WL
    python -m cellranger_tpu_torch vdj --id S --fastqs DIR \
        --reference regions.fa --whitelist WL [--chemistry SCVDJ-R2]
    python -m cellranger_tpu_torch aggr --id S --csv RUNS.csv
    python -m cellranger_tpu_torch reanalyze --id S \
        --matrix filtered_feature_bc_matrix.h5
    python -m cellranger_tpu_torch mkref --genome NAME --fasta F --genes G \
        --out DIR
    python -m cellranger_tpu_torch mkvdjref --genome NAME --seqs regions.fa \
        --out DIR
    python -m cellranger_tpu_torch mkgtf IN.gtf OUT.gtf --attribute K:V
    python -m cellranger_tpu_torch mkfastq --run BCL_DIR \
        --samplesheet SHEET.csv [--index-kit KIT.csv] --out DIR
    python -m cellranger_tpu_torch testrun --out DIR

`count` mirrors `cellranger_tpu count`: `--chemistry auto` detects the
chemistry from the first FASTQ pair and the whitelist, and preflight checks
run before any work.  `reanalyze` and `aggr` read h5 files (io/hdf5.py).
`mkref` builds its kmer table on `--device`; `mkvdjref`, `mkgtf` and
`mkfastq` run on the host only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_count(args):
    from .io.fastq import find_fastqs
    from .pipeline.count import CountConfig, run_count

    pairs = find_fastqs(args.fastqs, sample=args.sample)
    if not pairs:
        sys.exit(f"error: no FASTQs found in {args.fastqs}"
                 + (f" for sample {args.sample}" if args.sample else ""))
    if args.chemistry == "auto":
        from .io.whitelist import Whitelist
        from .pipeline.detect_chemistry import detect_chemistry
        wl = Whitelist.load(args.whitelist)
        det = detect_chemistry(pairs[0][0], {wl.name: wl},
                               r2_path=pairs[0][1])
        args.chemistry = det["chemistry"]
        print(f"detected chemistry: {args.chemistry} "
              f"(whitelist hit frac {det['frac']:.3f})")
    cfg = CountConfig(
        fastq_pairs=pairs,
        reference_path=args.reference,
        whitelist_path=args.whitelist,
        chemistry=args.chemistry,
        read_len=args.read_len,
        batch_size=args.batch_size,
        recovered_cells=args.expect_cells,
        force_cells=args.force_cells,
        sample_id=args.id,
        write_bam=args.bam,
    )
    # fail fast with every problem at once (preflight.rs analog)
    from .pipeline.preflight import PreflightError, preflight_count
    try:
        preflight_count(cfg)
    except PreflightError as e:
        sys.exit(f"error: {e}")
    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    from .pipeline.runtime import run_with_retry
    summary = run_with_retry(run_count, cfg, out_dir, device=args.device,
                             retries=args.autoretry)
    print(json.dumps({k: summary[k] for k in
                      ["total_reads", "valid_barcode_frac", "mapped_frac",
                       "conf_mapped_frac", "estimated_cells",
                       "total_molecules", "median_umis_per_cell"]}, indent=2))
    print(f"outputs: {out_dir}")


def _cmd_multi(args):
    from .io.multi_config import run_multi

    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    summary = run_multi(args.csv, out_dir, args.whitelist,
                        read_len=args.read_len, batch_size=args.batch_size,
                        sample_id=args.id, device=args.device)
    print(json.dumps({k: v for k, v in summary.items()
                      if k in ("count", "demux", "demux_probe")},
                     indent=2, default=str))
    print(f"outputs: {out_dir}")


def _cmd_vdj(args):
    from .io.fastq import find_fastqs
    from .pipeline.vdj import VdjConfig, run_vdj

    pairs = find_fastqs(args.fastqs, sample=args.sample)
    if not pairs:
        sys.exit(f"error: no FASTQs found in {args.fastqs}")
    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    summary = run_vdj(VdjConfig(
        fastq_pairs=pairs, vdj_reference_fasta=args.reference,
        whitelist_path=args.whitelist, chemistry=args.chemistry,
        read_len=args.read_len, sample_id=args.id), out_dir,
        device=args.device)
    print(json.dumps(summary, indent=2, default=float))
    print(f"outputs: {out_dir}")


def _cmd_aggr(args):
    from .pipeline.aggr import run_aggr

    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    summary = run_aggr(args.csv, out_dir, device=args.device)
    print(json.dumps(summary, indent=2, default=float))
    print(f"outputs: {out_dir}")


def _cmd_reanalyze(args):
    from .io.matrix_io import CountMatrix
    from .analysis.run import run_secondary_analysis

    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    matrix = CountMatrix.load_h5(args.matrix)
    os.makedirs(out_dir, exist_ok=True)
    run_secondary_analysis(matrix, os.path.join(out_dir, "analysis"),
                           device=args.device)
    print(f"outputs: {out_dir}/analysis")


def _cmd_mkvdjref(args):
    import shutil

    from .vdj.reference import VdjReference

    ref = VdjReference.from_fasta(args.seqs)  # validates headers
    os.makedirs(os.path.join(args.out, "fasta"), exist_ok=True)
    shutil.copyfile(args.seqs, os.path.join(args.out, "fasta", "regions.fa"))
    meta = dict(genome=args.genome, n_segments=len(ref.segments),
                regions={r: sum(1 for s_ in ref.segments if s_.region == r)
                         for r in ("V", "D", "J", "C", "UTR")},
                version="cellranger-tpu-0.1.0")
    with open(os.path.join(args.out, "reference.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta, indent=2))


def _cmd_mkref(args):
    from .io.reference import ReferencePackage

    genomes = args.genome.split(",")
    fastas = args.fasta.split(",")
    gtfs = args.genes.split(",")
    if not (len(genomes) == len(fastas) == len(gtfs)):
        sys.exit("error: --genome/--fasta/--genes need matching counts")
    if len(genomes) == 1:
        ref = ReferencePackage.build(fastas[0], gtfs[0], args.out,
                                     genome_name=genomes[0],
                                     device=args.device)
    else:
        ref = ReferencePackage.build_multi(
            list(zip(genomes, fastas, gtfs)), args.out, device=args.device)
    print(json.dumps(ref.metadata, indent=2))


def _cmd_mkfastq(args):
    from .pipeline.mkfastq import run_mkfastq

    summary = run_mkfastq(args.run, args.samplesheet, args.out,
                          index_kit_csv=args.index_kit)
    print(json.dumps(summary, indent=2))


def _cmd_testrun(args):
    """Synthetic end-to-end smoke test (the `cellranger testrun` analog,
    cr_wrap/src/bin/cellranger.rs:579-639) — generates a miniature run and
    counts it."""
    import gzip

    import numpy as np

    from .io.gtf import write_fasta
    from .io.reference import ReferencePackage
    from .pipeline.count import CountConfig, run_count

    out = args.out
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = bases[rng.integers(0, 4, 50_000)].tobytes()
    write_fasta(os.path.join(out, "genome.fa"), {"chr1": genome})
    with open(os.path.join(out, "genes.gtf"), "w") as f:
        f.write('chr1\tt\texon\t1001\t2000\t.\t+\t.\t'
                'gene_id "G1"; transcript_id "T1"; gene_name "GeneOne";\n')
        f.write('chr1\tt\texon\t30001\t31000\t.\t-\t.\t'
                'gene_id "G2"; transcript_id "T2"; gene_name "GeneTwo";\n')
    ReferencePackage.build(os.path.join(out, "genome.fa"),
                           os.path.join(out, "genes.gtf"),
                           os.path.join(out, "ref"), device=args.device)
    wl = sorted({"".join(rng.choice(list("ACGT"), 16)) for _ in range(256)})
    with open(os.path.join(out, "wl.txt"), "w") as f:
        f.writelines(s + "\n" for s in wl)

    def rc(s):
        return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]

    r1 = gzip.open(os.path.join(out, "t_S1_L001_R1_001.fastq.gz"), "wt")
    r2 = gzip.open(os.path.join(out, "t_S1_L001_R2_001.fastq.gz"), "wt")
    n = 0
    for ci in range(25):
        for u in range(12):
            umi = "".join(rng.choice(list("ACGT"), 12))
            if u % 2 == 0:
                p = int(rng.integers(1000, 2000 - 91))
                cdna = genome[p:p + 91].decode()
            else:
                p = int(rng.integers(30000, 31000 - 91))
                cdna = rc(genome[p:p + 91]).decode()
            r1.write(f"@t{n}\n{wl[ci]}{umi}\n+\n{'F' * 28}\n")
            r2.write(f"@t{n}\n{cdna}\n+\n{'F' * 91}\n")
            n += 1
    r1.close(); r2.close()

    cfg = CountConfig(
        fastq_pairs=[(os.path.join(out, "t_S1_L001_R1_001.fastq.gz"),
                      os.path.join(out, "t_S1_L001_R2_001.fastq.gz"))],
        reference_path=os.path.join(out, "ref"),
        whitelist_path=os.path.join(out, "wl.txt"),
        chemistry="SC3Pv3", read_len=91, batch_size=512, write_bam=True)
    summary = run_count(cfg, os.path.join(out, "outs"), device=args.device)
    ok = (summary["total_reads"] == n
          and summary["mapped_frac"] > 0.99
          and summary["estimated_cells"] in range(24, 28))
    print(f"testrun: {'PASS' if ok else 'FAIL'} — "
          f"{summary['total_reads']} reads, "
          f"{summary['estimated_cells']} cells, "
          f"mapped {summary['mapped_frac']:.3f}")
    sys.exit(0 if ok else 1)


def _cmd_mkgtf(args):
    """mkgtf (bin/rna/mkgtf_lib.py analog): attribute-filtered GTF copy."""
    import collections

    from .io.gtf import filter_gtf

    attributes = collections.defaultdict(set)
    for a in args.attribute:
        parts = a.split(":")
        if len(parts) != 2:
            sys.exit(f"error: attribute option must have format KEY:VALUE: {a}")
        attributes[parts[0]].add(parts[1])
    n = filter_gtf(args.input_gtf, args.output_gtf, attributes)
    print(f"wrote {n} feature rows to {args.output_gtf}")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cellranger_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("count", help="count GEX reads from FASTQs")
    c.add_argument("--id", required=True, help="run id (output dir name)")
    c.add_argument("--fastqs", required=True, help="directory with FASTQs")
    c.add_argument("--sample", help="sample name prefix filter")
    c.add_argument("--reference", required=True, help="reference package dir")
    c.add_argument("--whitelist", required=True, help="barcode whitelist file")
    c.add_argument("--chemistry", default="SC3Pv3",
                   help="chemistry name, or auto to detect it")
    c.add_argument("--expect-cells", type=int, dest="expect_cells")
    c.add_argument("--force-cells", type=int, dest="force_cells")
    c.add_argument("--read-len", type=int, default=91, dest="read_len")
    c.add_argument("--batch-size", type=int, default=8192, dest="batch_size")
    c.add_argument("--bam", action="store_true", help="write possorted BAM")
    _add_device(c)
    c.add_argument("--autoretry", type=int, default=0,
                   help="retry transient failures N times")
    c.add_argument("--output-dir", dest="output_dir")
    c.set_defaults(fn=_cmd_count)
    r = sub.add_parser("reanalyze",
                       help="re-run secondary analysis on a matrix")
    r.add_argument("--id", required=True)
    r.add_argument("--matrix", required=True, help="filtered matrix .h5")
    _add_device(r)
    r.add_argument("--output-dir", dest="output_dir")
    r.set_defaults(fn=_cmd_reanalyze)

    mu = sub.add_parser("multi", help="CSV-config multi-library analysis "
                        "(GEX + FB + VDJ + sample multiplexing)")
    mu.add_argument("--id", required=True)
    mu.add_argument("--csv", required=True, help="multi config CSV")
    mu.add_argument("--whitelist", required=True)
    mu.add_argument("--read-len", type=int, default=91, dest="read_len")
    mu.add_argument("--batch-size", type=int, default=8192, dest="batch_size")
    _add_device(mu)
    mu.add_argument("--output-dir", dest="output_dir")
    mu.set_defaults(fn=_cmd_multi)

    v = sub.add_parser("vdj", help="V(D)J contig assembly + clonotypes")
    v.add_argument("--id", required=True)
    v.add_argument("--fastqs", required=True)
    v.add_argument("--sample")
    v.add_argument("--reference", required=True, help="V(D)J regions.fa")
    v.add_argument("--whitelist", required=True)
    v.add_argument("--chemistry", default="SCVDJ-R2")
    v.add_argument("--read-len", type=int, default=120, dest="read_len")
    _add_device(v)
    v.add_argument("--output-dir", dest="output_dir")
    v.set_defaults(fn=_cmd_vdj)

    a = sub.add_parser("aggr", help="aggregate multiple count runs")
    a.add_argument("--id", required=True)
    a.add_argument("--csv", required=True, help="sample_id,molecule_h5 CSV")
    _add_device(a)
    a.add_argument("--output-dir", dest="output_dir")
    a.set_defaults(fn=_cmd_aggr)

    m = sub.add_parser("mkref", help="build a reference package")
    m.add_argument("--genome", required=True,
                   help="name (comma-separate for barnyard refs)")
    m.add_argument("--fasta", required=True)
    m.add_argument("--genes", required=True)
    m.add_argument("--out", required=True)
    _add_device(m)
    m.set_defaults(fn=_cmd_mkref)

    mv = sub.add_parser("mkvdjref", help="build a V(D)J reference package")
    mv.add_argument("--genome", required=True, help="reference name")
    mv.add_argument("--seqs", required=True,
                    help="regions.fa with V/D/J/C segments")
    mv.add_argument("--out", required=True)
    mv.set_defaults(fn=_cmd_mkvdjref)

    mf = sub.add_parser("mkfastq", help="demultiplex a BCL run to FASTQs")
    mf.add_argument("--run", required=True, help="BCL run directory")
    mf.add_argument("--samplesheet", required=True,
                    help="CSV: Lane,Sample,Index")
    mf.add_argument("--index-kit", default=None,
                    help="CSV mapping SI- set names to oligos")
    mf.add_argument("--out", required=True)
    mf.set_defaults(fn=_cmd_mkfastq)

    t = sub.add_parser("testrun", help="synthetic end-to-end smoke test")
    t.add_argument("--out", required=True)
    _add_device(t)
    t.set_defaults(fn=_cmd_testrun)

    mg = sub.add_parser("mkgtf", help="filter a GTF by attribute values "
                        "for mkref (e.g. gene_biotype:protein_coding)")
    mg.add_argument("input_gtf")
    mg.add_argument("output_gtf")
    mg.add_argument("--attribute", action="append", default=[],
                    metavar="KEY:VALUE",
                    help="attribute value to KEEP; repeatable")
    mg.set_defaults(fn=_cmd_mkgtf)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
