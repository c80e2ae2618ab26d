"""Antibody/antigen aggregate-GEM detection
(lib/python/cellranger/feature/antibody/analysis.py analog; invoked by
FILTER_BARCODES before cell calling, cell_calling_helpers.py:188-272).

Protein aggregates trap many antibodies at once, producing GEMs that are
simultaneously enriched in most of the panel. The reference flags:
  1) barcodes in the top-25 by total antibody UMIs that also rank top-25
     for >= a panel-size-dependent fraction of the signal antibodies
     (panels under 5 signal antibodies cannot be called);
  2) (antigen) barcodes among the top 100 whose UMI totals exceed
     Q3 + 3*IQR of the top-100, with a 1000-UMI floor.
  3) barcodes whose feature-barcode reads are >50% UMI-corrected with
     >10k reads (detect_highly_corrected_bcs, analysis.py:91-99) — fed by
     the dedup raw-triple views' per-triple read counts.

Verbatim copy of cellranger_tpu/analysis/aggregates.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

BACKGROUND_ANTIBODY_UMI_THRESHOLD = 1000
TOP_UMI_BCS = 25
MIN_SIGNAL_ANTIBODIES = 5
OUTLIER_IQR_MULTIPLIER = 3
OUTLIER_MIN_UMIS = 1000
OUTLIER_TOP_N = 100


def _fraction_to_use(n_signal: int) -> float:
    """Linear panel-size model: 100% of a 5-antibody panel, 60% at >=25."""
    return max(0.6, min(1.0, -0.02 * n_signal + 1.1))


def detect_antibody_aggregates(ab_counts: np.ndarray,
                               num_probe_barcodes: int | None = None
                               ) -> np.ndarray:
    """ab_counts: [F_ab, N] antibody UMI counts over all barcodes.
    Returns barcode indices called as aggregates."""
    totals_per_ab = ab_counts.sum(axis=1)
    signal = np.flatnonzero(totals_per_ab >= BACKGROUND_ANTIBODY_UMI_THRESHOLD)
    if len(signal) < MIN_SIGNAL_ANTIBODIES:
        return np.zeros(0, np.int64)
    sig = ab_counts[signal]
    top_n = (num_probe_barcodes or 1) * TOP_UMI_BCS
    per_bc = sig.sum(axis=0)
    cand = np.argsort(per_bc, kind="stable")[-top_n:]
    # membership of each candidate in each antibody's own top-N
    need = int(np.round(len(signal) * _fraction_to_use(len(signal))))
    hits = np.zeros(len(cand), np.int64)
    for f in range(sig.shape[0]):
        top_f = np.argsort(sig[f], kind="stable")[-top_n:]
        hits += np.isin(cand, top_f)
    return np.sort(cand[hits >= need])


def detect_outlier_umi_bcs(counts: np.ndarray,
                           multiplier: int = OUTLIER_IQR_MULTIPLIER
                           ) -> np.ndarray:
    """counts: [F, N] (antigen) UMI counts. IQR outliers among the top-100
    barcodes by totals; 1000-UMI floor. Returns barcode indices."""
    per_bc = counts.sum(axis=0)
    top = np.argsort(-per_bc, kind="stable")[:OUTLIER_TOP_N]
    q1, q3 = np.quantile(per_bc[top], [0.25, 0.75])
    thresh = q3 + (q3 - q1) * multiplier
    if thresh < OUTLIER_MIN_UMIS:
        return np.zeros(0, np.int64)
    return np.sort(top[per_bc[top] >= thresh])


HIGH_UMI_CORRECTION_THRESHOLD = 0.5   # analysis.py:18
NUM_READS_THRESHOLD = 10_000          # analysis.py:19


def detect_highly_corrected_bcs(reads_per_bc: np.ndarray,
                                corrected_reads_per_bc: np.ndarray
                                ) -> np.ndarray:
    """Barcodes whose reads are mostly UMI corrections — an aggregate
    signature (antibody/analysis.py:91-99: frac_corrected > 0.5 AND
    reads > 10k).  Returns barcode indices."""
    frac = corrected_reads_per_bc / np.maximum(reads_per_bc, 1)
    return np.flatnonzero((frac > HIGH_UMI_CORRECTION_THRESHOLD)
                          & (reads_per_bc > NUM_READS_THRESHOLD))
