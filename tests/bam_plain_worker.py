"""One host of a multi-host count whose BAM write is made twice from its
spool: by the plain writer (BamCollector.write_plain) to <bam>.plain, then
by the run's (chip_smoke.plain_beside).  The arguments and CRTPU_*
variables are those of cellranger_tpu_torch.testing.multihost_worker:

    python -m tests.bam_plain_worker cfg.json out_dir --device cpu

run from the repository's root, or through that module's `launch(...,
module="tests.bam_plain_worker")`.
"""

import chip_smoke
from cellranger_tpu_torch.testing import multihost_worker

if __name__ == "__main__":
    with chip_smoke.plain_beside():
        multihost_worker.main()
