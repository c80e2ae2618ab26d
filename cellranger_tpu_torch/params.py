"""Site-tunable runtime parameters — the parameters.toml analog
(lib/rust/parameters_toml + lib/bin/parameters.toml).

A deployment can override pipeline tunables without code changes by
placing a `parameters.toml` next to the package (or pointing
CRTPU_PARAMETERS at one).  Keys mirror the reference file; consumers pull
values through `get(name)` so the default table documents every knob in
one place.  Parsing is a minimal TOML subset (key = value scalars,
comments) to avoid a dependency — the reference file uses nothing more.

Verbatim copy of cellranger_tpu/params.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import os

# Defaults mirror lib/bin/parameters.toml (values are shared constants of
# the assay/pipeline, not code).
DEFAULTS: dict = {
    "detect_chemistry_sample_reads": 100_000,
    "detect_chemistry_total_reads": 2_000_000,
    "min_fraction_whitelist_match": 0.1,
    "min_barcode_similarity": 0.1,
    "align_extra_parameters": "",   # star_parameters analog (free-form)
    "vdj_max_reads_per_barcode": 80_000,
    "max_multiplexing_tags": 12,
    "fiveprime_multiplexing": True,
    "threeprime_lt_multiplexing": False,
    "min_major_probe_bc_frac": 0.7,
    # TPU-engine-specific site knobs
    # x expected winnowing density; 0.85 = S=10 seeds at L=91/w=12.  The
    # r4 TPU sweep (tools/step_tune.py) measured 1.5->0.85 as 78.6->52.4ms
    # per 32k-read step with the truth probe PERFECT (off-repeat recall
    # 1.0, zero false-confident in repeats); raise at sites that see
    # pick-rich reads losing seeds
    "minimizer_seed_headroom": 0.85,
    "umi_min_read_length": None,    # override chemistry UMI min length
    "batch_size": None,             # override CountConfig.batch_size
    "spill_partitions": None,       # override pipeline SPILL_PARTS
    # max text length that still builds the overlapped window-row table
    # (~0.9B/base extra HBM for one-gather candidate windows); lower it
    # on chips without the headroom (align/aligner.OVERLAP_ROWS_MAX_TEXT)
    "overlap_rows_max_text": None,
}

ENV_VAR = "CRTPU_PARAMETERS"
_cache: dict | None = None


def _parse_scalar(v: str):
    v = v.strip()
    if v.startswith('"') and v.endswith('"'):
        return v[1:-1]
    if v in ("true", "false"):
        return v == "true"
    v2 = v.replace("_", "")
    try:
        return int(v2)
    except ValueError:
        pass
    try:
        return float(v2)
    except ValueError:
        return v


def _load_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = _parse_scalar(v)
    return out


def _site_path() -> str | None:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "parameters.toml")
    return here if os.path.exists(here) else None


def load(refresh: bool = False) -> dict:
    """The effective parameter table (defaults overlaid by the site file)."""
    global _cache
    if _cache is None or refresh:
        table = dict(DEFAULTS)
        p = _site_path()
        if p and os.path.exists(p):
            for k, v in _load_file(p).items():
                table[k] = v
        _cache = table
    return _cache


def get(name: str):
    table = load()
    if name not in table:
        raise KeyError(f"unknown parameter {name!r}; known: "
                       f"{sorted(table)}")
    return table[name]
