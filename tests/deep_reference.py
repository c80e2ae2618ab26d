"""The JAX package's outputs for chip_smoke's `deep` phase: the reads,
molecules, conf_mapped_frac and MEX digests that chip_smoke.DEEP_EXPECTED
holds.

    JAX_PLATFORMS=cpu python tests/deep_reference.py WORK_DIR [N_READS]

builds `build_e2e_run(WORK_DIR/fx, N_READS)` (default chip_smoke.DEEP_READS)
with the port's generator, runs the JAX package's run_count on it with the
phase's CountConfig (SC3Pv3, read length 91, batch 32768, count-only, no
checkpoint) on the CPU, prints the seconds, peak RSS and phase split, and
last the DEEP_EXPECTED dict as one JSON line.  WORK_DIR is left in place.
`make_fixture` alone gives the fixture's seconds and host memory.
At 20,000,000 reads: 5.3 GB of FASTQ and ~7 GB of disk in all, ~28 GB of
RAM, ~1,700 s on an 8-core CPU.
"""

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


def make_fixture(work: str, n_reads: int) -> dict:
    """The phase's fixture under work/fx; prints its seconds and the
    process's peak RSS after it."""
    t = time.time()
    fx = build_e2e_run(os.path.join(work, "fx"), n_reads=n_reads)
    print(f"fixture_s {time.time() - t:.1f}", flush=True)
    print("fixture_peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    return fx


def main(work: str, n_reads: int) -> dict:
    fx = make_fixture(work, n_reads)
    cfg = CountConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                      reference_path=fx["ref"], whitelist_path=fx["wl"],
                      chemistry="SC3Pv3", read_len=91,
                      batch_size=chip_smoke.E2E_BATCH, checkpoint=False,
                      secondary_analysis=False)
    out = os.path.join(work, "jax_out")
    t = time.time()
    s = run_count(cfg, out)
    print(f"run_count_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    phases: dict = {}
    with open(os.path.join(out, "_perf.json")) as f:
        for ph in json.load(f)["phases"]:
            phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    print("phases", json.dumps(phases))
    return dict(total_reads=s["total_reads"],
                total_molecules=s["total_molecules"],
                conf_mapped_frac=s["conf_mapped_frac"],
                mex_sha256=chip_smoke.mex_sha256(out))


if __name__ == "__main__":
    n = int(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.DEEP_READS
    print(json.dumps(main(sys.argv[1], n)))
