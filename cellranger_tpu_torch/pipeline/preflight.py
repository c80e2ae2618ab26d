"""Preflight validation: fail fast, before any compute, with precise
user-facing messages.

The reference runs dedicated preflight stages up front
(mro/rna/stages/common/cellranger_preflight, multi/src/config/preflight.rs)
whose messages are DUI-tested (stage_fail_dui_test!).  This module is the
analog: every check returns a list of human-readable problems; run_count /
the CLI call `preflight_count` and raise PreflightError joining them all,
so the user sees every problem at once instead of one per run.

Verbatim copy of cellranger_tpu/pipeline/preflight.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import os

from ..io.chemistry import CHEMISTRY_DEFS
from ..io.fastq import required_widths


class PreflightError(Exception):
    """All preflight problems, joined (one per line)."""

    def __init__(self, problems: list[str]):
        self.problems = problems
        super().__init__(
            "Preflight checks failed:\n  - " + "\n  - ".join(problems))


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def check_fastqs(pairs, chem=None, read_len: int = 91) -> list[str]:
    """FASTQ files exist, are readable FASTQ, R1 long enough for the
    chemistry's barcode+UMI."""
    problems = []
    if not pairs:
        problems.append("no FASTQ files given; use --fastqs with a "
                        "directory containing <sample>_S*_R1_*.fastq.gz")
        return problems
    for pair in pairs:
        for p in pair:
            if p is None:
                continue
            if not os.path.exists(p):
                problems.append(f"FASTQ not found: {p}")
                continue
            if os.path.getsize(p) == 0:
                problems.append(f"FASTQ is empty: {p}")
                continue
            try:
                opener = gzip.open if _is_gzip(p) else open
                with opener(p, "rt") as f:
                    first = f.readline()
                    if first and not first.startswith("@"):
                        problems.append(
                            f"not a FASTQ (first line must start with "
                            f"'@'): {p}")
            except OSError as e:
                problems.append(f"cannot read {p}: {e}")
        if chem is not None and os.path.exists(pair[0]):
            w = required_widths(chem, read_len)
            need_r1 = max(w["R1"], chem.barcode[0].span.offset
                          + (chem.barcode[0].span.length or 0))
            try:
                opener = gzip.open if _is_gzip(pair[0]) else open
                with opener(pair[0], "rt") as f:
                    f.readline()
                    seq = f.readline().strip()
                bc_umi = (chem.umi.offset + (chem.umi.min_length
                                             or chem.umi.length or 0)
                          if chem.umi.read == "R1" else 0)
                # every structured span on R1 must fit (probe barcodes on
                # R1 sit past the UMI for MFRP-*-R1 chemistries)
                structured = max(
                    [bc_umi] + [sp.offset + sp.length
                                for sp in (chem.barcode[0].span,
                                           chem.probe_bc, chem.overhang)
                                if sp is not None and sp.read == "R1"
                                and sp.length])
                if seq and len(seq) < structured:
                    problems.append(
                        f"R1 reads in {pair[0]} are {len(seq)}bp but "
                        f"chemistry {chem.name} needs at least "
                        f"{structured}bp (barcode/UMI/probe spans); was "
                        f"the right chemistry selected?")
            except OSError:
                pass
            if w["I1"] > 0 and (len(pair) < 3 or pair[2] is None):
                problems.append(
                    f"chemistry {chem.name} reads the barcode from the I1 "
                    f"index read; no _I1_ FASTQ found next to {pair[0]}")
    return problems


def check_chemistry(name: str) -> list[str]:
    if name in ("auto", "custom") or name in CHEMISTRY_DEFS:
        return []
    import difflib
    close = difflib.get_close_matches(name, CHEMISTRY_DEFS, n=3)
    hint = f"; did you mean {', '.join(close)}?" if close else ""
    return [f"unknown chemistry {name!r}{hint} (known: "
            f"{', '.join(sorted(CHEMISTRY_DEFS))})"]


def check_reference(path: str | None) -> list[str]:
    if path is None:
        return []
    if not os.path.isdir(path):
        return [f"reference path is not a directory: {path}"]
    problems = []
    for rel in ("reference.json",):
        if not os.path.exists(os.path.join(path, rel)):
            problems.append(
                f"reference package at {path} is missing {rel}; build it "
                f"with `cellranger-tpu mkref`")
    return problems


def check_whitelist(path: str | None) -> list[str]:
    if path is None:
        return []
    if not os.path.exists(path):
        return [f"barcode whitelist not found: {path}"]
    if os.path.getsize(path) == 0:
        return [f"barcode whitelist is empty: {path}"]
    return []


def check_feature_ref(path: str | None) -> list[str]:
    if path is None:
        return []
    if not os.path.exists(path):
        return [f"feature reference CSV not found: {path}"]
    import csv
    with open(path) as f:
        fields = set(csv.DictReader(f).fieldnames or [])
    required = {"id", "name", "read", "pattern", "sequence", "feature_type"}
    missing = required - fields
    if missing:
        return [f"feature reference {path} is missing required columns: "
                f"{', '.join(sorted(missing))} "
                f"(feature_reference.rs:41 schema)"]
    return []


def check_probe_set(path: str | None) -> list[str]:
    if path is None:
        return []
    if not os.path.exists(path):
        return [f"probe set CSV not found: {path}"]
    with open(path) as f:
        header = None
        for line in f:
            if not line.startswith("#"):
                header = line.strip().split(",")
                break
    required = {"gene_id", "probe_seq", "probe_id"}
    missing = required - set(header or [])
    if missing:
        return [f"probe set {path} is missing required columns: "
                f"{', '.join(sorted(missing))} (probe_set.rs:423 schema)"]
    return []


def check_samples(samples: list[dict]) -> list[str]:
    """Multi-config [samples] rows: unique ids, no double-assigned tags."""
    problems = []
    ids = [r.get("sample_id", "") for r in samples]
    dupes = {x for x in ids if ids.count(x) > 1}
    if dupes:
        problems.append(
            f"duplicate sample_id in [samples]: {', '.join(sorted(dupes))}")
    for key in ("probe_barcode_ids", "cmo_ids", "overhang_ids"):
        seen: dict[str, str] = {}
        for r in samples:
            for t in (r.get(key) or "").split("|"):
                t = t.strip()
                if not t:
                    continue
                if t in seen and seen[t] != r.get("sample_id"):
                    problems.append(
                        f"{key} {t!r} is assigned to both "
                        f"{seen[t]!r} and {r.get('sample_id')!r}")
                seen[t] = r.get("sample_id")
    return problems


def preflight_count(cfg) -> None:
    """Validate a CountConfig before running; raises PreflightError."""
    from ..io.chemistry import get_chemistry
    problems = []
    problems += check_chemistry(cfg.chemistry)
    chem = None
    if not problems and cfg.chemistry in CHEMISTRY_DEFS:
        chem = get_chemistry(cfg.chemistry)
    problems += check_fastqs(cfg.fastq_pairs, chem, cfg.read_len)
    problems += check_reference(cfg.reference_path)
    problems += check_whitelist(cfg.whitelist_path)
    problems += check_feature_ref(cfg.feature_ref_csv)
    problems += check_probe_set(cfg.probe_set_csv)
    if cfg.reference_path is None and cfg.probe_set_csv is None:
        problems.append("neither a reference package nor a probe set was "
                        "given; one is required to map reads")
    if problems:
        raise PreflightError(problems)
