"""The JAX package's outputs for chip_smoke's `perturb` phase: the
perturb_outputs dict that chip_smoke.PERTURB_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/perturb_reference.py WORK_DIR

builds `build_perturb_run(WORK_DIR/fx, **chip_smoke.PERTURB)` (10,000
cells, 4,100 twenty-base guides, 17 antibodies, the 6,794,880-barcode
whitelist, 10,000,000 GEX, 3,000,000 guide and ~2,000,000 antibody reads)
with the port's generator, runs the JAX package's run_count on it with the
phase's config (chip_smoke.perturb_config: batch 32768, secondary analysis
on) on the CPU, with call_features' two-Gaussian fits caught, and prints
the seconds, peak RSS and stage split, and last chip_smoke.perturb_outputs
of the run as one JSON line.  WORK_DIR is left in place.
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
from cellranger_tpu.analysis import feature_assigner  # noqa: E402
from cellranger_tpu.analysis import run as analysis_mod  # noqa: E402
from cellranger_tpu.pipeline import count  # noqa: E402
from cellranger_tpu_torch.testing.fixtures import (  # noqa: E402
    build_perturb_run)


def peak_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main(work: str) -> dict:
    t = time.time()
    fx = build_perturb_run(os.path.join(work, "fx"), **chip_smoke.PERTURB)
    print(f"fixture_s {time.time() - t:.1f}", json.dumps(fx["timing"]),
          flush=True)
    print("fixture_peak_rss_bytes", peak_rss(), flush=True)
    out = os.path.join(work, "jax_out")
    with chip_smoke.recorded(
            (count, "run_count"),
            (feature_assigner, "run_feature_assignment"),
            (feature_assigner, "_fit_two_gaussians"),
            (analysis_mod, "run_secondary_analysis")) as rec:
        t = time.time()
        count.run_count(chip_smoke.perturb_config(fx, count), out)
        print(f"run_count_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes", peak_rss())
    print("stage_s", json.dumps({
        k: round(sum(s for s, _ in v), 2) for k, v in rec.items()}))
    return chip_smoke.perturb_outputs(
        fx, out, [r for _, r in rec["_fit_two_gaussians"]])


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
