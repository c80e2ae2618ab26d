"""Pipeline runtime helpers: stage retry + resume — the slice of Martian's
mrp that the in-process engine needs (SURVEY §5.3/§5.4: stage-level retry,
pipestance restart/resume from journaled outputs; mrp --autoretry).

The heavy lifting is already structural: every pipeline phase writes
durable outputs and `pipeline.checkpoint` fingerprints the molecule table,
so a rerun of run_count skips completed passes.  `run_with_retry` adds the
mrp-style automatic retry loop for transient failures (preemptions, tunnel
drops), preserving the checkpoint between attempts so work is never
repeated — attempt N+1 resumes where N stopped.

Verbatim copy of cellranger_tpu/pipeline/runtime.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import sys
import time
import traceback

# errors that retrying cannot fix — fail fast like mrp does on assertion
# failures vs. rerunning on node failures
_PERMANENT = (ValueError, FileNotFoundError, KeyError, TypeError,
              AssertionError)


def run_with_retry(fn, *args, retries: int = 0, backoff_s: float = 5.0,
                   log=print, **kwargs):
    """Call fn(*args, **kwargs); on a TRANSIENT failure retry up to
    `retries` times with linear backoff.  Permanent error classes
    (config/input mistakes) propagate immediately."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except _PERMANENT:
            raise
        except Exception as e:  # transient: runtime/backend/IO
            attempt += 1
            if attempt > retries:
                raise
            log(f"stage failed (attempt {attempt}/{retries}): "
                f"{type(e).__name__}: {e}; retrying in "
                f"{backoff_s * attempt:.0f}s", file=sys.stderr)
            traceback.print_exc()
            time.sleep(backoff_s * attempt)
