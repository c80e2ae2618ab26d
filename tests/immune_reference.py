"""The JAX package's outputs for chip_smoke's `immune_held` phase: the
{path: sha256} dict that chip_smoke.IMMUNE_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/immune_reference.py WORK_DIR

builds `build_immune_run(WORK_DIR/fx, **chip_smoke.IMMUNE_HELD,
t_plan=chip_smoke.IMMUNE_HELD_T_PLAN, b_plan=chip_smoke.IMMUNE_HELD_B_PLAN)`
(a 30-cell 5' well: 12 T cells with two-alpha clones and planted
dropouts, 8 B cells with a two-light clone and its dropout sibling, one
combined TR + IG reference, the 737,280-barcode whitelist) with the
port's generator, runs the JAX package's run_multi on it at batch
chip_smoke.IMMUNE_HELD_BATCH on the CPU, checks the run against the
well's truth (chip_smoke.immune_truth_diffs), prints the seconds and
peak RSS, and last chip_smoke.immune_digest of the output as one JSON
line.  WORK_DIR is left in place.  It takes about three minutes, nearly
all of it the JAX package's plain-Python contig annotation and base
qualities.  The port's CPU run of the same build,
`chip_smoke.immune_held(DIR, "cpu")`, gives the same digest.
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
from cellranger_tpu_torch.testing.fixtures import (  # noqa: E402
    build_immune_run)


def main(work: str) -> dict:
    t = time.time()
    fx = build_immune_run(os.path.join(work, "fx"), **chip_smoke.IMMUNE_HELD,
                          t_plan=chip_smoke.IMMUNE_HELD_T_PLAN,
                          b_plan=chip_smoke.IMMUNE_HELD_B_PLAN)
    print(f"fixture_s {time.time() - t:.1f}", flush=True)
    out = os.path.join(work, "jax_out")
    t = time.time()
    s = run_multi(fx["csv"], out, fx["wl"],
                  batch_size=chip_smoke.IMMUNE_HELD_BATCH)
    print(f"run_multi_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes",
          resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    diffs = chip_smoke.immune_truth_diffs(fx, out, s)
    if diffs:
        raise SystemExit(f"the JAX package's run misses the truth: {diffs}")
    return chip_smoke.immune_digest(out)


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
