"""Feature reference CSV parsing + pattern compilation.

Reference semantics: feature_reference.rs:40-44 (required columns id, name,
read, pattern, sequence, feature_type) and feature_extraction.rs:306-330
(pattern = optional '5P' prefix, optional '3P' suffix, exactly one '(BC)',
ACGTN literals/wildcards elsewhere).

We compile each pattern to a positional extractor the device can run:
  * 5P-anchored: barcode offset = len(prefix) from read start;
  * 3P-anchored: offset = read_len - len(suffix) - bc_len from the end;
  * unanchored with a fixed prefix: rolling anchor search on device.
Fixed prefix/suffix bases are verified (N = wildcard).

Copied from cellranger_tpu/io/feature_ref.py, which reaches jax through its
encode import; this copy imports the port's encode.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field

import numpy as np

from ..io.matrix_io import FeatureDef
from ..ops import encode


@dataclass(frozen=True)
class CompiledPattern:
    read: str                 # R1 | R2
    bc_len: int
    anchor5p: bool
    anchor3p: bool
    prefix_codes: tuple       # codes of bases before (BC); 255 = N wildcard
    suffix_codes: tuple

    @property
    def prefix_len(self) -> int:
        return len(self.prefix_codes)


@dataclass
class FeatureBarcodeReference:
    """Parsed feature reference: defs + per-pattern packed sequence tables."""

    feature_defs: list[FeatureDef]
    sequences: list[str]              # aligned with feature_defs
    patterns: list[CompiledPattern]   # aligned
    pattern_groups: dict = field(default_factory=dict)
    # {CompiledPattern: (sorted packed seqs uint32, feature_index int32)}

    @staticmethod
    def from_csv(path: str) -> "FeatureBarcodeReference":
        defs, seqs, pats = [], [], []
        with open(path) as f:
            reader = csv.DictReader(f)
            required = {"id", "name", "read", "pattern", "sequence", "feature_type"}
            missing = required - set(reader.fieldnames or [])
            if missing:
                raise ValueError(
                    f"feature reference CSV missing columns: {sorted(missing)}")
            for row in reader:
                seq = row["sequence"].strip().upper()
                pat = compile_pattern(row["pattern"].strip(), row["read"].strip(),
                                      len(seq))
                # extra columns ride as tags (mhc_allele etc.,
                # feature_reference.rs FeatureDef.tags)
                extra = {k: v.strip() for k, v in row.items()
                         if k not in required and v and v.strip()}
                defs.append(FeatureDef(row["id"].strip(), row["name"].strip(),
                                       row["feature_type"].strip(),
                                       tags=extra))
                seqs.append(seq)
                pats.append(pat)
        ref = FeatureBarcodeReference(defs, seqs, pats)
        ref._build_groups()
        return ref

    def _build_groups(self):
        groups: dict[CompiledPattern, list[int]] = {}
        for i, p in enumerate(self.patterns):
            groups.setdefault(p, []).append(i)
        self.pattern_groups = {}
        for p, idxs in groups.items():
            packed = []
            for i in idxs:
                codes, valid = encode.encode_str(self.sequences[i])
                if not valid.all():
                    raise ValueError(f"feature sequence has non-ACGT base: "
                                     f"{self.sequences[i]}")
                if len(codes) != p.bc_len:
                    raise ValueError("feature sequences within a pattern must "
                                     "share one length")
                packed.append(encode.pack_codes_np(codes, p.bc_len))
            packed = np.asarray(packed, np.uint32)
            order = np.argsort(packed, kind="stable")
            if len(packed) > 1 and (np.diff(packed[order]) == 0).any():
                raise ValueError("duplicate feature barcode sequence in pattern")
            self.pattern_groups[p] = (packed[order],
                                      np.asarray(idxs, np.int32)[order])


def compile_pattern(pattern: str, read: str, bc_len: int) -> CompiledPattern:
    p = pattern
    anchor5 = p.startswith("5P")
    if anchor5:
        p = p[2:].lstrip("-")
    anchor3 = p.upper().endswith("3P")
    if anchor3:
        p = p[:-2].rstrip("-")
    if p.count("(BC)") != 1:
        raise ValueError(
            f"invalid pattern {pattern!r}: must contain exactly one '(BC)'")
    pre, suf = p.split("(BC)")
    for part in (pre, suf):
        bad = set(part.upper()) - set("ACGTN")
        if bad:
            raise ValueError(f"invalid pattern chars {bad} in {pattern!r}")

    def codes(s):
        out = []
        for ch in s.upper():
            out.append(255 if ch == "N" else "ACGT".index(ch))
        return tuple(out)

    if not anchor5 and not anchor3 and not any(c != 255 for c in codes(pre)):
        raise ValueError(
            f"unanchored pattern {pattern!r} needs fixed bases before (BC)")
    return CompiledPattern(read=read or "R2", bc_len=bc_len,
                           anchor5p=anchor5, anchor3p=anchor3,
                           prefix_codes=codes(pre), suffix_codes=codes(suf))
