"""The JAX package's BAM for chip_smoke's `e2e_bam` phase: the sha256 of
the decompressed BGZF payload and the record count that
chip_smoke.BAM_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/bam_reference.py WORK_DIR [N_READS]

builds `build_e2e_run(WORK_DIR/fx, N_READS)` (default chip_smoke.E2E_READS)
with the port's generator, runs the JAX package's run_count on it with the
phase's CountConfig (SC3Pv3, read length 91, batch chip_smoke.E2E_BATCH,
BAM on, no checkpoint, no secondary analysis) on the CPU, prints the
seconds, peak RSS and phase split, and last the BAM_EXPECTED dict as one
JSON line.  The batch is the phase's own: a batch's secondary records are
spooled after its primaries, so records with equal sort keys can come in
another order at another batch size.  Compressed bytes and the index are
not held: zlib's output may differ between machines.  WORK_DIR is left in
place.  At 1,000,000 reads this takes about five minutes on an 8-core
CPU, most of it the JAX package's per-record BAM writer.
"""

import gzip
import hashlib
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from cellranger_tpu.pipeline.count import CountConfig, run_count  # noqa: E402
from cellranger_tpu_torch.testing.fixtures import build_e2e_run  # noqa: E402


def main(work: str, n_reads: int) -> dict:
    t = time.time()
    fx = build_e2e_run(os.path.join(work, "fx"), n_reads=n_reads)
    print(f"fixture_s {time.time() - t:.1f}", flush=True)
    cfg = CountConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                      reference_path=fx["ref"], whitelist_path=fx["wl"],
                      chemistry="SC3Pv3", read_len=91,
                      batch_size=chip_smoke.E2E_BATCH, checkpoint=False,
                      secondary_analysis=False, write_bam=True)
    out = os.path.join(work, "jax_out")
    t = time.time()
    run_count(cfg, out)
    print(f"run_count_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    phases: dict = {}
    with open(os.path.join(out, "_perf.json")) as f:
        for ph in json.load(f)["phases"]:
            phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    print("phases", json.dumps(phases))
    bam = os.path.join(out, "possorted_genome_bam.bam")
    with gzip.open(bam, "rb") as f:
        payload = f.read()
    return dict(payload_sha256=hashlib.sha256(payload).hexdigest(),
                records=chip_smoke.bam_records(bam))


if __name__ == "__main__":
    n = int(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.E2E_READS
    print(json.dumps(main(sys.argv[1], n)))
