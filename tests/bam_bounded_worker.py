"""One host of a multi-host count whose BAM writer holds at most
TEST_BAND_RECORDS records at once (pipeline/bam_out.py BAND_RECORDS,
from the environment) and writes its BAM twice, by the plain writer and
by the run's (chip_smoke.plain_beside).  The arguments and CRTPU_*
variables are those of cellranger_tpu_torch.testing.multihost_worker:

    TEST_BAND_RECORDS=400 python -m tests.bam_bounded_worker cfg.json out_dir --device cpu

run from the repository's root, or through that module's `launch(...,
module="tests.bam_bounded_worker")`.
"""

import os

import chip_smoke
from cellranger_tpu_torch.pipeline import bam_out
from cellranger_tpu_torch.testing import multihost_worker

if __name__ == "__main__":
    bam_out.BAND_RECORDS = int(os.environ["TEST_BAND_RECORDS"])
    with chip_smoke.plain_beside():
        multihost_worker.main()
