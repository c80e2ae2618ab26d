"""Per-phase performance tracing — the pipestance `_perf` + LogPerf
analog (SURVEY §5.1: mrp records per-stage wall/CPU/mem;
lib/python/cellranger/logperf.py prints RSS deltas around blocks).

`PerfTrace` times named phases and samples RSS around them; `run_count`
wraps its phases and writes `<out_dir>/_perf.json` so every run carries
a breakdown (pass1/pass2/dedup/matrix/cells/secondary/...). For device-
side kernel timing use tools/profile_step.py (jax profiler traces);
this module is the cheap always-on host-side layer.

Usage:
    perf = PerfTrace()
    with perf.phase("pass2"):
        ...
    perf.write(os.path.join(out_dir, "_perf.json"))

Verbatim copy of cellranger_tpu/perf.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class PerfTrace:
    def __init__(self):
        self._t0 = time.time()
        self.phases: list[dict] = []

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        r0 = _rss_mb()
        try:
            yield
        finally:
            self.phases.append(dict(
                name=name,
                wall_s=round(time.time() - t, 4),
                start_s=round(t - self._t0, 4),
                rss_start_mb=round(r0, 1),
                rss_delta_mb=round(_rss_mb() - r0, 1)))

    def lap(self, name: str):
        """Record the span since the previous lap (or construction) as a
        phase — the one-line alternative to the context manager for
        straight-line pipeline code."""
        t = time.time()
        last = (self._lap_t if hasattr(self, "_lap_t") else self._t0)
        self.phases.append(dict(
            name=name, wall_s=round(t - last, 4),
            start_s=round(last - self._t0, 4),
            rss_start_mb=round(getattr(self, "_lap_rss", _rss_mb()), 1),
            rss_delta_mb=round(_rss_mb()
                               - getattr(self, "_lap_rss", _rss_mb()), 1)))
        self._lap_t = t
        self._lap_rss = _rss_mb()

    def to_dict(self) -> dict:
        return dict(total_wall_s=round(time.time() - self._t0, 4),
                    rss_mb=round(_rss_mb(), 1), phases=self.phases)

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
