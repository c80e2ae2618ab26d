"""The JAX package's outputs for chip_smoke's `flex_held` phase: the
{path: sha256} dict that chip_smoke.FLEX_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/flex_reference.py WORK_DIR

builds `build_flex_run(WORK_DIR/fx, **chip_smoke.FLEX_HELD)` (a 48-cell
multiplexed Flex well: 3 cells on each of 16 probe barcodes, beads shared
between samples, BC001 and BC002 one sample's, BC016 no sample's, every
probe-barcode kind) with the port's generator, runs the JAX package's
run_multi on it at batch chip_smoke.FLEX_HELD_BATCH and read length
chip_smoke.RTL_READ_LEN on the CPU, checks the run against the well's
truth (chip_smoke.flex_truth_diffs), prints the seconds and peak RSS, and
last chip_smoke.flex_digest of the output as one JSON line.  WORK_DIR is
left in place.  It takes well under a minute.  The port's CPU run of
the same build, `chip_smoke.flex_held(DIR, "cpu")`, gives the same
digest.
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
from cellranger_tpu.io.multi_config import run_multi  # noqa: E402
from cellranger_tpu_torch.testing.fixtures import build_flex_run  # noqa: E402


def main(work: str) -> dict:
    t = time.time()
    fx = build_flex_run(os.path.join(work, "fx"), **chip_smoke.FLEX_HELD,
                        workers=2)
    print(f"fixture_s {time.time() - t:.1f}", flush=True)
    out = os.path.join(work, "jax_out")
    t = time.time()
    run_multi(fx["csv"], out, fx["wl"], read_len=chip_smoke.RTL_READ_LEN,
              batch_size=chip_smoke.FLEX_HELD_BATCH)
    print(f"run_multi_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    diffs = chip_smoke.flex_truth_diffs(fx, out)
    if diffs:
        raise SystemExit(f"the JAX package's run misses the truth: {diffs}")
    return chip_smoke.flex_digest(out)


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
