"""Chemistry auto-detection (DETECT_CHEMISTRY analog,
lib/rust/cr_lib/src/stages/detect_chemistry.rs; sample floor of 10k reads
per detect_chemistry.rs:44).

Strategy mirrors the reference's core signal: sample reads, extract the
candidate chemistry's barcode span, and measure the whitelist hit fraction;
the winning chemistry must clear an absolute floor and beat alternatives.
Chemistries sharing a whitelist+geometry (3'v2 vs 5') are disambiguated by
R1 length and, when a reference index is supplied, by transcript sense vs
antisense mapped fractions (the reference's endedness probe).

Verbatim copy of cellranger_tpu/pipeline/detect_chemistry.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from ..constants import DETECT_CHEMISTRY_MIN_READS
from ..io.chemistry import CHEMISTRY_DEFS, get_chemistry
from ..io.fastq import iter_fastq_records
from ..io.whitelist import Whitelist
from ..ops import encode

MIN_WHITELIST_FRAC = 0.10  # below this no chemistry is credible
# one representative per whitelist-distinct family (DETECT_CHEMISTRY's
# candidate matrix, detect_chemistry.rs); HT variants share their base
# chemistry's geometry and are user-declared, like the reference
DEFAULT_CANDIDATES = ("SC3Pv4", "SC3Pv3", "SC3Pv2", "SC3Pv3LT", "SC5P-R2",
                      "SC5P-R2-v3", "SC5P-PE", "SC5P-R1", "ARC-v1", "SFRP",
                      "MFRP-RNA", "MFRP-Ab")
PROBE_BC_MIN_FRAC = 0.30   # R2 probe-barcode hit fraction marking MFRP
# OH multiplexing: the 2bp overhang view (R1[7:9]) of a multiplexed run
# draws from the small per-well overhang set, so the top-4 2-mers cover
# ~all whitelist-valid reads (16 would be uniform for a non-OH run)
OH_TOP4_MIN_FRAC = 0.95
OH_MIN_DISTINCT_BC = 500  # distinct barcodes, not reads (low-complexity guard)

# base chemistry -> its overhang-multiplexed sibling (suffix order is not
# uniform across the registry: SC5P-R2-v3's sibling is SC5P-R2-OH-v3)
OH_SIBLING = {
    "SC3Pv3": "SC3Pv3-OH",
    "SC3Pv4": "SC3Pv4-OH",
    "SC5P-R2": "SC5P-R2-OH",
    "SC5P-R2-v3": "SC5P-R2-OH-v3",
}

# 10x template-switch oligo: 5' chemistries carry it on R1 right after the
# barcode+UMI (cr_types chemistry geometry: SC5P rna starts at R1 offset
# 26+13); its presence separates SC5P-* from SC3Pv2, which share the
# 737K-august-2016 whitelist and a 10bp UMI.
TSO = b"TTTCTTATATGGG"
TSO_OFFSET = 26
TSO_MAX_MM = 2
TSO_MIN_FRAC = 0.25


def tso_frac(r1_seqs: list[bytes]) -> float:
    """Fraction of R1 reads carrying the TSO motif at offset 26."""
    tso = np.frombuffer(TSO, np.uint8)
    n = hit = 0
    for s in r1_seqs:
        if len(s) < TSO_OFFSET + len(TSO):
            continue
        w = np.frombuffer(s[TSO_OFFSET:TSO_OFFSET + len(TSO)], np.uint8)
        n += 1
        hit += int((w != tso).sum()) <= TSO_MAX_MM
    return hit / n if n else 0.0


def sample_reads(r1_path: str, n: int = DETECT_CHEMISTRY_MIN_READS):
    seqs = []
    for i, (_, seq, _) in enumerate(iter_fastq_records(r1_path)):
        if i >= n:
            break
        seqs.append(seq)
    return seqs


def whitelist_hit_frac(r1_seqs: list[bytes], chem_name: str,
                       whitelists: dict[str, Whitelist]) -> float:
    chem = get_chemistry(chem_name)
    seg = chem.barcode[0]
    wl = whitelists.get(seg.whitelist)
    if wl is None and len(whitelists) == 1:
        # a single user-supplied whitelist applies to every candidate
        # geometry (the CLI --whitelist path case)
        wl = next(iter(whitelists.values()))
    if wl is None:
        return 0.0
    span = seg.span
    hits = total = 0
    step_codes = []
    for s in r1_seqs:
        if len(s) < span.offset + span.length:
            continue
        codes, valid = encode.encode_str(s[span.offset:span.offset + span.length])
        if not valid.all():
            continue
        step_codes.append(codes)
    if not step_codes:
        return 0.0
    packed = encode.pack_codes_np(np.stack(step_codes), span.length)
    return float(wl.contains(packed).mean())


def probe_bc_frac(r2_seqs: list[bytes], chem_name: str,
                  probe_wl: Whitelist) -> float:
    """Fraction of R2 reads whose probe-barcode span hits the probe
    whitelist (MFRP marker; chemistry_defs.json right_probe segments)."""
    chem = get_chemistry(chem_name)
    span = chem.probe_bc
    if span is None or span.read != "R2":
        return 0.0
    hits = []
    for s in r2_seqs:
        if len(s) < span.offset + span.length:
            continue
        codes, valid = encode.encode_str(
            s[span.offset:span.offset + span.length])
        if not valid.all():
            continue
        hits.append(codes)
    if not hits:
        return 0.0
    packed = encode.pack_codes_np(np.stack(hits), span.length)
    return float(probe_wl.contains(packed).mean())


def overhang_top4_frac(r1_seqs: list[bytes], span_off: int = 7,
                       span_len: int = 2,
                       bc_len: int = 16) -> tuple[float, int]:
    """(fraction of DISTINCT barcodes covered by the 4 most frequent
    overhang 2-mers, distinct-barcode count) at the OH view R1[7:9] — the
    OH auto-detect signal (detect_chemistry candidate matrix: *-OH defs
    share the base geometry, so only the overhang-set restriction
    distinguishes them).  Counting distinct barcodes, not reads, keeps a
    low-complexity run (few cells dominating the read mass) from faking
    the restricted per-well overhang set."""
    from collections import Counter
    cnt: Counter = Counter()
    seen: set = set()
    for s in r1_seqs:
        if len(s) >= max(span_off + span_len, bc_len):
            bc = bytes(s[:bc_len])
            if bc in seen:
                continue
            seen.add(bc)
            oh = s[span_off:span_off + span_len]
            if all(b in b"ACGT" for b in oh):
                cnt[bytes(oh)] += 1
    n = sum(cnt.values())
    if not n:
        return 0.0, 0
    top4 = sum(c for _, c in cnt.most_common(4))
    return top4 / n, n


def detect_chemistry(r1_path: str, whitelists: dict[str, Whitelist],
                     candidates=DEFAULT_CANDIDATES,
                     n_sample: int | None = None,
                     r2_path: str | None = None) -> dict:
    """Returns dict(chemistry, frac, per_candidate). Raises ValueError when
    nothing clears the floor (the reference's preflight failure).

    whitelists maps whitelist NAMES (gel-bead and, for MFRP detection,
    probe-barcode whitelists keyed by their chemistry_defs names) to
    loaded Whitelist objects; r2_path enables the probe-barcode and
    paired-end signals."""
    if n_sample is None:
        # site tunable (parameters.toml detect_chemistry_sample_reads)
        from ..params import get as param
        n_sample = int(param("detect_chemistry_sample_reads"))
    seqs = sample_reads(r1_path, n_sample)
    if not seqs:
        raise ValueError(f"no reads in {r1_path}")
    r2_seqs = sample_reads(r2_path, n_sample) if r2_path else []
    fracs = {}
    for c in candidates:
        if c not in CHEMISTRY_DEFS:
            continue
        fracs[c] = whitelist_hit_frac(seqs, c, whitelists)
    if not fracs:
        raise ValueError("no candidate chemistries available")
    # R1-length disambiguation: a 26bp R1 cannot carry a 12bp UMI chemistry
    r1_len = int(np.median([len(s) for s in seqs]))
    viable = {}
    for c, f in fracs.items():
        chem = get_chemistry(c)
        need = chem.umi.offset + chem.umi_min_length
        if r1_len >= need:
            viable[c] = f
    if not viable:
        viable = fracs
    best = max(viable, key=lambda c: viable[c])
    from ..params import get as param
    min_frac = float(param("min_fraction_whitelist_match"))
    if viable[best] < min_frac:
        raise ValueError(
            "unable to detect chemistry: best whitelist hit fraction "
            f"{viable[best]:.3f} ({best}); check inputs/whitelists. "
            f"Per-candidate: { {k: round(v, 3) for k, v in fracs.items()} }")

    # endedness disambiguation among near-tied candidates sharing a
    # whitelist (SC3Pv2 vs SC5P-*): the TSO motif marks 5' libraries
    tf = tso_frac(seqs)
    near = {c for c, f in viable.items() if f >= viable[best] - 0.02}
    five = [c for c in near if get_chemistry(c).endedness == "five_prime"]
    three = [c for c in near if get_chemistry(c).endedness == "three_prime"]
    if five and three:
        pool = five if tf >= TSO_MIN_FRAC else three
        best = max(pool, key=lambda c: viable[c])
        near = {c for c in near if c in pool}

    # probe-barcode disambiguation (SFRP vs MFRP family): an MFRP run's R2
    # carries a probe barcode hitting its probe whitelist.  MEMBER
    # resolution: each MFRP variant names its own probe whitelist
    # (probe_bc offset/length differ across members), so the member whose
    # whitelist actually matches wins (detect_chemistry/ probe-bc matrix)
    pf = 0.0
    mfrp = [c for c in near if get_chemistry(c).probe_bc is not None]
    plain = [c for c in near if get_chemistry(c).probe_bc is None]
    if mfrp and r2_seqs:
        member_pf = {}
        for c in mfrp:
            pwl_name = get_chemistry(c).probe_bc_whitelist
            pwl = whitelists.get(pwl_name) if pwl_name else None
            if pwl is not None:
                member_pf[c] = probe_bc_frac(r2_seqs, c, pwl)
        if member_pf:
            pf = max(member_pf.values())
        if pf >= PROBE_BC_MIN_FRAC:
            best = max(member_pf, key=lambda c: (member_pf[c], viable[c]))
        elif plain:
            best = max(plain, key=lambda c: viable[c])

    # single-read vs paired disambiguation among the 5' family
    # (SC5P-PE vs SC5P-R2 vs SC5P-R1, detect_chemistry.rs candidate
    # matrix): PE needs cDNA on R1 beyond bc+umi (long R1) AND an R2 mate;
    # a run with NO R2 at all is the R1-only chemistry
    pe = [c for c in near if get_chemistry(c).rna2 is not None]
    se = [c for c in near if get_chemistry(c).rna2 is None]
    if pe and se:
        ch = get_chemistry(pe[0])
        long_r1 = r1_len >= ch.rna.offset + 25
        pool = pe if (long_r1 and r2_seqs) else se
        best = max(pool, key=lambda c: viable[c])
    r1_only = [c for c in near if get_chemistry(c).rna.read == "R1"
               and get_chemistry(c).rna2 is None]
    if not r2_seqs:
        if r1_only:
            best = max(r1_only, key=lambda c: viable[c])
    elif best in r1_only:
        # an R2 mate exists: prefer the R2-based sibling over R1-only
        r2_based = [c for c in near if get_chemistry(c).rna.read == "R2"]
        if r2_based:
            best = max(r2_based, key=lambda c: viable[c])

    # OH (overhang-multiplexed) auto-detect: a *-OH sibling of the winner
    # exists and the overhang view shows the restricted per-well set
    oh_frac, oh_n = overhang_top4_frac(seqs)
    oh_name = OH_SIBLING.get(best, "")
    if (oh_name in CHEMISTRY_DEFS and oh_n >= OH_MIN_DISTINCT_BC
            and oh_frac >= OH_TOP4_MIN_FRAC):
        viable[oh_name] = viable[best]   # same geometry/whitelist as base
        best = oh_name
    return dict(chemistry=best, frac=viable[best],
                per_candidate={k: round(v, 4) for k, v in fracs.items()},
                r1_len=r1_len, tso_frac=round(tf, 4),
                probe_bc_frac=round(pf, 4),
                overhang_top4_frac=round(oh_frac, 4))
