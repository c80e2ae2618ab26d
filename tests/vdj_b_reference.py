"""The JAX package's outputs for chip_smoke's `vdj_b_held` phase: the
{file: sha256} dict that chip_smoke.VDJ_B_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/vdj_b_reference.py WORK_DIR

builds `build_vdj_b_run(WORK_DIR/fx, chip_smoke.VDJ_B_HELD_CELLS,
chip_smoke.VDJ_B_PAIRS_PER_CELL, plasma_pairs=VDJ_B_HELD_PLASMA_PAIRS,
families=VDJ_B_HELD_FAMILIES, **vdj_b_library_kw(VDJ_B_HELD_CELLS))` (12
B cells at 4,000 read pairs a cell, one plasma cell at 45,000 pairs, so
90,000 rows past the 80,000-row cap, a family of 3 cells with a CDR3
subclone, 240 non-cell barcodes, the 737,280-barcode whitelist) with the
port's generator, runs the JAX package's run_vdj on it at batch
chip_smoke.VDJ_BATCH on the CPU, checks the run against the fixture's
truth (chip_smoke.vdj_b_truth_diffs), and prints the seconds and peak
RSS, and last the sha256 of every output file as one JSON line.
WORK_DIR is left in place.  At the JAX package's speed this takes about
eight minutes (run_vdj 465.7 s on an 8-core CPU host).  The port's CPU
run of the same build, `chip_smoke.vdj_b_held(DIR, "cpu")`, gives the
same 16 files in about half a minute.
"""

import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from cellranger_tpu.pipeline import vdj  # noqa: E402
from cellranger_tpu_torch.testing.fixtures import (  # noqa: E402
    build_vdj_b_run, vdj_b_library_kw)


def main(work: str) -> dict:
    n = chip_smoke.VDJ_B_HELD_CELLS
    t = time.time()
    fx = build_vdj_b_run(os.path.join(work, "fx"), n,
                         chip_smoke.VDJ_B_PAIRS_PER_CELL,
                         plasma_pairs=chip_smoke.VDJ_B_HELD_PLASMA_PAIRS,
                         families=chip_smoke.VDJ_B_HELD_FAMILIES,
                         **vdj_b_library_kw(n))
    print(f"fixture_s {time.time() - t:.1f}", flush=True)
    out = os.path.join(work, "jax_out")
    spectra = []
    real = vdj.count_bc_umi_kmers

    def counted(*a, **kw):
        spectra.append(real(*a, **kw))
        return spectra[-1]

    vdj.count_bc_umi_kmers = counted
    try:
        t = time.time()
        s = vdj.run_vdj(vdj.VdjConfig(
            fastq_pairs=[(fx["fq1"], fx["fq2"])],
            vdj_reference_fasta=fx["fa"], whitelist_path=fx["wl"],
            chemistry=fx["chemistry"], read_len=fx["read_len"],
            batch_size=chip_smoke.VDJ_BATCH), out)
        print(f"run_vdj_s {time.time() - t:.1f}", flush=True)
    finally:
        vdj.count_bc_umi_kmers = real
    print("peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    diffs = chip_smoke.vdj_b_truth_diffs(
        fx, out, s, chip_smoke._pairs(*(np.asarray(a)
                                        for a in spectra[0][:2])))
    if diffs:
        raise SystemExit(f"the JAX package's run misses the truth: {diffs}")
    return chip_smoke.tree_sha256(out)


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
