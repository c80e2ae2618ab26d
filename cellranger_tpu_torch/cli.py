"""cellranger-tpu-torch CLI: the `count` and `reanalyze` subcommands of
the port.

    python -m cellranger_tpu_torch count --id S --fastqs DIR \
        --reference REF --whitelist WL --chemistry SC3Pv3 [--bam] \
        [--device cuda]
    python -m cellranger_tpu_torch reanalyze --id S \
        --matrix filtered_feature_bc_matrix.h5 [--device cuda]

Mirrors `cellranger_tpu count` for the slice the port runs: the
chemistry must be named (no auto-detection) and preflight checks are not
run; secondary analysis runs on the same device, as in the JAX package.
`reanalyze` reads its matrix with h5py.
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
    out_dir = os.path.join(args.output_dir or ".", args.id, "outs")
    from .pipeline.runtime import run_with_retry
    summary = run_with_retry(run_count, cfg, out_dir, device=args.device,
                             retries=args.autoretry)
    print(json.dumps({k: summary[k] for k in
                      ["total_reads", "valid_barcode_frac", "mapped_frac",
                       "conf_mapped_frac", "estimated_cells",
                       "total_molecules", "median_umis_per_cell"]}, indent=2))
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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cellranger_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("count", help="count GEX reads from FASTQs")
    c.add_argument("--id", required=True, help="run id (output dir name)")
    c.add_argument("--fastqs", required=True, help="directory with FASTQs")
    c.add_argument("--sample", help="sample name prefix filter")
    c.add_argument("--reference", required=True, help="reference package dir")
    c.add_argument("--whitelist", required=True, help="barcode whitelist file")
    c.add_argument("--chemistry", required=True,
                   help="chemistry name, e.g. SC3Pv3 (no auto-detection)")
    c.add_argument("--expect-cells", type=int, dest="expect_cells")
    c.add_argument("--force-cells", type=int, dest="force_cells")
    c.add_argument("--read-len", type=int, default=91, dest="read_len")
    c.add_argument("--batch-size", type=int, default=8192, dest="batch_size")
    c.add_argument("--bam", action="store_true", help="write possorted BAM")
    c.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    c.add_argument("--autoretry", type=int, default=0,
                   help="retry transient failures N times")
    c.add_argument("--output-dir", dest="output_dir")
    c.set_defaults(fn=_cmd_count)
    r = sub.add_parser("reanalyze",
                       help="re-run secondary analysis on a matrix")
    r.add_argument("--id", required=True)
    r.add_argument("--matrix", required=True, help="filtered matrix .h5")
    r.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    r.add_argument("--output-dir", dest="output_dir")
    r.set_defaults(fn=_cmd_reanalyze)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
