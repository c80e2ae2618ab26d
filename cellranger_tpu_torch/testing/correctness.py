"""Conformance comparators for pipeline outputs — the golden-output differ.

Re-implements the semantics of the reference's purpose-built correctness
checks (lib/rust/cr_lib/src/testing/correctness.rs):

  * check_metrics   (:24)  — metric maps; floats with tolerance, the rest
                             exact; keys restricted to the shared set plus
                             explicit ignore lists (the reference prunes
                             version-skew keys the same way, tools.rs:67).
  * check_mtx       (:93)  — gzipped MatrixMarket line-by-line, with the
                             %metadata_json line compared by presence only.
  * check_h5        (:120) — full structural h5 compare (the h5diff -cr
                             analog): same groups/datasets/attrs, equal
                             values.
  * check_bam       (:272) — records sorted by (ref, pos), compared
                             field-by-field; CIGAR may differ only up to
                             folded operation counts (equal-score alignment
                             tie-breaks, :223); aux tags compared from the
                             fixed tag list with ints widened (:158-210);
                             UB skipped on secondary alignments.

Every checker returns a list of human-readable difference strings (empty ==
conformant) so callers can report all diffs at once; assert_* wrappers
raise with the joined report.  These comparators are aimed at our own
golden snapshots today and at real cellranger tiny-ref outputs the moment
fixtures are obtainable (the tag list and tolerances match that goal).

Verbatim copy of cellranger_tpu/testing/correctness.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import json
import math
import os

import numpy as np

# the reference's tags_to_check (correctness.rs:164-189, names from
# cr_bam/src/bam_tags.rs)
BAM_TAGS_TO_CHECK = [
    "RG", "CB", "UB", "fr", "fq", "fb", "fx", "xf", "UR", "UY", "CR", "CY",
    "TX", "GX", "GN", "RE", "mm", "AN", "gx", "gn",
]

FLOAT_REL_TOL = 1e-6
FLOAT_ABS_TOL = 1e-9


# ---------------------------------------------------------------- metrics
def _num_eq(a, b, rel_tol, abs_tol):
    if isinstance(a, bool) or isinstance(b, bool):
        return a == b
    fa, fb = float(a), float(b)
    if math.isnan(fa) and math.isnan(fb):
        return True
    return math.isclose(fa, fb, rel_tol=rel_tol, abs_tol=abs_tol)


def _value_diff(key, a, e, rel_tol, abs_tol, out):
    if isinstance(e, dict) and isinstance(a, dict):
        for k in sorted(set(a) | set(e)):
            if k not in a:
                out.append(f"{key}.{k}: missing in actual")
            elif k not in e:
                out.append(f"{key}.{k}: unexpected in actual")
            else:
                _value_diff(f"{key}.{k}", a[k], e[k], rel_tol, abs_tol, out)
    elif isinstance(e, (list, tuple)) and isinstance(a, (list, tuple)):
        if len(a) != len(e):
            out.append(f"{key}: length {len(a)} != {len(e)}")
        else:
            for i, (x, y) in enumerate(zip(a, e)):
                _value_diff(f"{key}[{i}]", x, y, rel_tol, abs_tol, out)
    elif isinstance(e, (int, float)) and isinstance(a, (int, float)):
        if not _num_eq(a, e, rel_tol, abs_tol):
            out.append(f"{key}: actual {a!r} != expected {e!r}")
    elif a != e:
        out.append(f"{key}: actual {a!r} != expected {e!r}")


def check_metrics(actual: dict | str, expected: dict | str,
                  ignore: tuple = ("wall_time_s",),
                  rel_tol: float = FLOAT_REL_TOL,
                  abs_tol: float = FLOAT_ABS_TOL,
                  require_same_keys: bool = True) -> list[str]:
    """Compare metric-summary maps (JSON paths or dicts)."""
    if isinstance(actual, str):
        with open(actual) as f:
            actual = json.load(f)
    if isinstance(expected, str):
        with open(expected) as f:
            expected = json.load(f)
    diffs: list[str] = []
    a = {k: v for k, v in actual.items() if k not in ignore}
    e = {k: v for k, v in expected.items() if k not in ignore}
    for k in sorted(e):
        if k not in a:
            diffs.append(f"{k}: missing in actual")
        else:
            _value_diff(k, a[k], e[k], rel_tol, abs_tol, diffs)
    if require_same_keys:
        for k in sorted(set(a) - set(e)):
            diffs.append(f"{k}: unexpected in actual")
    return diffs


# -------------------------------------------------------------------- mtx
def check_mtx(actual_path: str, expected_path: str) -> list[str]:
    """Gzipped MatrixMarket compare; %metadata_json compared by presence
    only (its payload carries version strings — correctness.rs:101-108)."""
    op = gzip.open if actual_path.endswith(".gz") else open
    oe = gzip.open if expected_path.endswith(".gz") else open
    diffs = []
    with op(actual_path, "rt") as fa, oe(expected_path, "rt") as fe:
        for i, (a, e) in enumerate(_zip_strict(fa, fe, diffs, "mtx lines")):
            a, e = a.rstrip("\n"), e.rstrip("\n")
            if a.startswith("%metadata_json"):
                if not e.startswith("%metadata_json"):
                    diffs.append(f"line {i}: metadata_json placement differs")
            elif a != e:
                diffs.append(f"line {i}: {a!r} != {e!r}")
            if len(diffs) > 20:
                diffs.append("... (truncated)")
                break
    return diffs


def _zip_strict(it_a, it_b, diffs, what):
    sa, sb = iter(it_a), iter(it_b)
    while True:
        a = next(sa, None)
        b = next(sb, None)
        if a is None and b is None:
            return
        if a is None or b is None:
            diffs.append(f"{what}: unequal lengths")
            return
        yield a, b


# --------------------------------------------------------------------- h5
def check_h5(actual_path: str, expected_path: str,
             ignore_attrs: tuple = ("software_version",),
             rel_tol: float = FLOAT_REL_TOL) -> list[str]:
    """Structural h5 compare (h5diff -cr analog): identical tree of groups/
    datasets/attributes with equal contents (floats within tolerance)."""
    from ..io import hdf5 as h5py
    diffs: list[str] = []

    def walk(ga, ge, path):
        ka, ke = set(ga.keys()), set(ge.keys())
        for k in sorted(ke - ka):
            diffs.append(f"{path}/{k}: missing in actual")
        for k in sorted(ka - ke):
            diffs.append(f"{path}/{k}: unexpected in actual")
        for k in sorted(ka & ke):
            oa, oe_ = ga[k], ge[k]
            p = f"{path}/{k}"
            if isinstance(oe_, h5py.Group):
                if not isinstance(oa, h5py.Group):
                    diffs.append(f"{p}: group vs dataset")
                else:
                    walk(oa, oe_, p)
            else:
                if isinstance(oa, h5py.Group):
                    diffs.append(f"{p}: dataset vs group")
                    continue
                va, ve = oa[()], oe_[()]
                if np.asarray(va).shape != np.asarray(ve).shape:
                    diffs.append(f"{p}: shape {np.asarray(va).shape} != "
                                 f"{np.asarray(ve).shape}")
                elif np.asarray(ve).dtype.kind == "f":
                    if not np.allclose(va, ve, rtol=rel_tol, equal_nan=True):
                        diffs.append(f"{p}: float data differs")
                elif not np.array_equal(np.asarray(va), np.asarray(ve)):
                    diffs.append(f"{p}: data differs")
            _attrs(oa, oe_, p)

    def _attrs(oa, oe_, p):
        aa = {k: v for k, v in oa.attrs.items() if k not in ignore_attrs}
        ae = {k: v for k, v in oe_.attrs.items() if k not in ignore_attrs}
        for k in sorted(set(aa) | set(ae)):
            if k not in aa:
                diffs.append(f"{p}@{k}: attr missing in actual")
            elif k not in ae:
                diffs.append(f"{p}@{k}: attr unexpected in actual")
            elif not np.array_equal(np.asarray(aa[k]), np.asarray(ae[k])):
                diffs.append(f"{p}@{k}: attr {aa[k]!r} != {ae[k]!r}")

    with h5py.File(actual_path, "r") as fa, \
            h5py.File(expected_path, "r") as fe:
        walk(fa, fe, "")
        _attrs(fa, fe, "")
    return diffs


# ------------------------------------------------------- molecule_info.h5
def check_molecule_info(actual_path: str, expected_path: str) -> list[str]:
    """molecule_info compare over the column arrays (barcode_idx,
    feature_idx, umi, count, library_idx) and pass-filter set."""
    from ..io.molecule_info import load_molecule_info
    a = load_molecule_info(actual_path)
    e = load_molecule_info(expected_path)
    diffs = []
    for k in ("barcode_idx", "feature_idx", "umi", "count", "library_idx"):
        if k not in a or k not in e:
            if (k in a) != (k in e):
                diffs.append(f"{k}: present in only one file")
            continue
        if not np.array_equal(np.asarray(a[k]), np.asarray(e[k])):
            diffs.append(f"{k}: differs")
    return diffs


# -------------------------------------------------------------------- BAM
def _fold_cigar(cigar) -> dict:
    out: dict = {}
    for n, op in cigar:
        out[op] = out.get(op, 0) + n
    return out


def check_bam(actual_path: str, expected_path: str,
              tags: list[str] = BAM_TAGS_TO_CHECK,
              max_diffs: int = 20) -> list[str]:
    """BAM compare modulo equal-score alignment tie-breaking
    (correctness.rs:235-296): header SQ lines, then records sorted by
    (ref_id, pos) compared on qname/flag/pos/mapq/seq/qual, CIGAR up to
    folded op counts, and the fixed aux tag list (UB skipped on secondary
    alignments, ints compared as ints)."""
    from ..io.bam_read import read_bam
    refs_a, recs_a, _ = read_bam(actual_path)
    refs_e, recs_e, _ = read_bam(expected_path)
    diffs: list[str] = []
    if refs_a != refs_e:
        diffs.append(f"header refs differ: {refs_a} != {refs_e}")
        return diffs

    def key(r):
        ref = r["ref_id"] if r["ref_id"] >= 0 else 1 << 30
        return (ref, r["pos"], r["name"])

    # secondary alignments ARE compared (correctness.rs compares them and
    # skips only their UB tag — the branch below); prior rounds filtered
    # them out here, leaving that skip dead code
    recs_a = sorted(recs_a, key=key)
    recs_e = sorted(recs_e, key=key)
    if len(recs_a) != len(recs_e):
        diffs.append(f"record count {len(recs_a)} != {len(recs_e)}")
        return diffs
    for ra, re_ in zip(recs_a, recs_e):
        name = ra["name"]
        for f in ("name", "flag", "ref_id", "pos", "mapq"):
            if ra[f] != re_[f]:
                diffs.append(f"{name}: {f} {ra[f]!r} != {re_[f]!r}")
        if ra["cigar"] != re_[
                "cigar"] and _fold_cigar(ra["cigar"]) != _fold_cigar(
                re_["cigar"]):
            diffs.append(f"{name}: cigar {ra['cigar']} !~ {re_['cigar']}")
        if ra["seq"] != re_["seq"]:
            diffs.append(f"{name}: seq differs")
        if bytes(ra["qual"]) != bytes(re_["qual"]):
            diffs.append(f"{name}: qual differs")
        secondary = bool(ra["flag"] & 0x100)
        for t in tags:
            if secondary and t == "UB":
                continue
            va, ve = ra["tags"].get(t), re_["tags"].get(t)
            if isinstance(va, (int, np.integer)):
                va = int(va)
            if isinstance(ve, (int, np.integer)):
                ve = int(ve)
            if va != ve:
                diffs.append(f"{name}: tag {t} {va!r} != {ve!r}")
        if len(diffs) >= max_diffs:
            diffs.append("... (truncated)")
            return diffs
    return diffs


# --------------------------------------------------------------- asserts
def _raise_if(diffs: list[str], what: str):
    if diffs:
        raise AssertionError(
            f"{what} conformance failed ({len(diffs)} diffs):\n  "
            + "\n  ".join(diffs))


def assert_metrics(actual, expected, **kw):
    _raise_if(check_metrics(actual, expected, **kw), "metrics")


def assert_mtx(actual, expected):
    _raise_if(check_mtx(actual, expected), "mtx")


def assert_h5(actual, expected, **kw):
    _raise_if(check_h5(actual, expected, **kw), "h5")


def assert_bam(actual, expected, **kw):
    _raise_if(check_bam(actual, expected, **kw), "bam")


def assert_molecule_info(actual, expected):
    _raise_if(check_molecule_info(actual, expected), "molecule_info")
