"""The JAX package's outputs for chip_smoke's `cellplex` phase: the
cellplex_outputs dict that chip_smoke.CELLPLEX_EXPECTED holds.

    JAX_PLATFORMS=cpu python tests/cellplex_reference.py WORK_DIR

builds `build_cellplex_run(WORK_DIR/fx, **chip_smoke.CELLPLEX)` (30,000
cells, 12 CMOs and 12 samples, 17 antibodies with 20 planted aggregates,
the 6,794,880-barcode whitelist, 10,000,000 GEX, ~3,000,000 CMO and
~3,000,000 antibody reads) with the port's generator, runs the JAX
package's run_multi on it with the phase's batch (32768) on the CPU, with
fit_jibes' result caught, and prints the seconds, peak RSS and stage
split, and last chip_smoke.cellplex_outputs of the run as one JSON line.
WORK_DIR is left in place.
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
from cellranger_tpu.analysis import run as analysis_mod  # noqa: E402
from cellranger_tpu.io.multi_config import run_multi  # noqa: E402
from cellranger_tpu.pipeline import count, demux  # noqa: E402
from cellranger_tpu_torch.testing.fixtures import (  # noqa: E402
    build_cellplex_run)


def peak_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main(work: str) -> dict:
    t = time.time()
    fx = build_cellplex_run(os.path.join(work, "fx"), **chip_smoke.CELLPLEX)
    print(f"fixture_s {time.time() - t:.1f}", json.dumps(fx["timing"]),
          flush=True)
    print("fixture_peak_rss_bytes", peak_rss(), flush=True)
    out = os.path.join(work, "jax_out")
    with chip_smoke.recorded((count, "run_count"), (demux, "fit_jibes"),
                             (demux, "write_sample_outs"),
                             (analysis_mod, "run_secondary_analysis")) as rec:
        t = time.time()
        run_multi(fx["csv"], out, fx["wl"], batch_size=chip_smoke.E2E_BATCH)
        print(f"run_multi_s {time.time() - t:.1f}", flush=True)
    print("peak_rss_bytes", peak_rss())
    print("stage_s", json.dumps({k: [round(s, 2) for s, _ in v]
                                 for k, v in rec.items()}))
    return chip_smoke.cellplex_outputs(fx, out, rec["fit_jibes"][0][1])


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
