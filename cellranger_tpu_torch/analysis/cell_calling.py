"""Cell calling: ordmag initial calls + EmptyDrops-style rescue.

Host-side numpy with fixed seeds — the reference pins exact reproducibility
of these statistics to seeded CPU RNG (np.random.RandomState(0) in
cell_calling_helpers.py:900, np.random.seed(0) in stats.py:113), so this
subsystem deliberately stays off-device; the heavy upstream reductions
(counts per barcode) arrive from the TPU pipeline.

Spec sources:
  * ordmag: cell_calling_helpers.py:863-960 (find_within_ordmag,
    estimate_recovered_cells_ordmag, filter_cellular_barcodes_ordmag)
  * EmptyDrops-like rescue: cell_calling.py:144-263 (ambient profile via SGT
    over barcodes ranked [N/2, N), candidates >= max(500, max_ambient+1)
    UMIs, multinomial log-likelihood vs ambient, Monte Carlo p-values via
    the Lun et al. incremental simulation, Benjamini-Hochberg at FDR 0.01)

Verbatim copy of cellranger_tpu/analysis/cell_calling.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.special import gammaln

from .sgt import SGTError, sgt_proportions

ORDMAG_BOOTSTRAPS = 100
ORDMAG_QUANTILE = 0.99
MIN_RECOVERED_CELLS = 50
MAX_RECOVERED_CELLS = 1 << 18
EMPTYDROPS_MIN_UMIS = 500
EMPTYDROPS_NUM_SIMS = 10000


def n_partitions(chemistry_name: str, num_probe_bcs: int | None = None) -> int:
    """Empty-drops background partition count per chemistry
    (cell_calling.py:122-141)."""
    if chemistry_name == "SC3Pv3LT":
        return 9000
    if chemistry_name in ("SC3Pv4", "SC5P-R2-v3", "SC5P-PE-v3", "SC5P-R1-v3"):
        return 80000 * num_probe_bcs if num_probe_bcs and num_probe_bcs > 1 else 160000
    return 45000 * num_probe_bcs if num_probe_bcs and num_probe_bcs > 1 else 90000


def empty_drops_fdr(chemistry_name: str) -> float:
    if chemistry_name in ("SC3Pv4", "SC5P-R2-v3", "SC5P-PE-v3", "SC5P-R1-v3"):
        return 0.001
    return 0.01


def find_within_ordmag(counts: np.ndarray, baseline_idx) -> int | np.ndarray:
    """#barcodes with count >= max(1, round(0.1 * counts[baseline_idx]))
    where baseline_idx ranks from the top; vectorized over baseline_idx
    (helpers.py:863-871)."""
    asc = np.sort(counts)
    baseline = asc[-(np.asarray(baseline_idx) + 1)]
    cutoff = np.maximum(1, np.round(0.1 * baseline)).astype(int)
    return len(asc) - np.searchsorted(asc, cutoff)


def estimate_recovered_cells_ordmag(counts: np.ndarray, max_expected: int):
    """Search recovered_cells minimizing (obs-exp)^2/exp over a log2 grid
    (helpers.py:873-887)."""
    grid = np.linspace(1, np.log2(max_expected), 2000)
    grid = np.unique(np.round(np.power(2, grid)).astype(int))
    baseline_idx = np.minimum(
        np.round(grid * (1 - ORDMAG_QUANTILE)).astype(int), len(counts) - 1)
    filtered = find_within_ordmag(counts, baseline_idx)
    loss = (filtered - grid) ** 2 / grid
    i = int(np.argmin(loss))
    return int(grid[i]), float(loss[i])


@dataclass
class OrdmagResult:
    filtered_idx: np.ndarray      # indices into bc_counts of called cells
    recovered_cells: int
    filtered_bcs: int
    cutoff: int = 0


def call_initial_cells_ordmag(bc_counts: np.ndarray,
                              recovered_cells: int | None = None,
                              chemistry_name: str | None = None,
                              num_probe_bcs: int | None = None) -> OrdmagResult:
    """The ordmag method over per-barcode UMI counts (helpers.py:890-960)."""
    rs = np.random.RandomState(0)
    nonzero = bc_counts[bc_counts > 0]
    if len(nonzero) == 0:
        return OrdmagResult(np.zeros(0, int), 0, 0)

    if recovered_cells is None:
        max_expected = MAX_RECOVERED_CELLS
        if chemistry_name is not None:
            max_expected = min(n_partitions(chemistry_name, num_probe_bcs) // 2,
                               MAX_RECOVERED_CELLS)
        ests = [estimate_recovered_cells_ordmag(
                    rs.choice(nonzero, len(nonzero)), max_expected)
                for _ in range(ORDMAG_BOOTSTRAPS)]
        recovered_cells = max(int(np.round(np.mean([e[0] for e in ests]))),
                              MIN_RECOVERED_CELLS)
    else:
        recovered_cells = max(recovered_cells, MIN_RECOVERED_CELLS)

    baseline_idx = min(int(np.round(recovered_cells * (1 - ORDMAG_QUANTILE))),
                       len(nonzero) - 1)
    boot = np.asarray([
        find_within_ordmag(rs.choice(nonzero, len(nonzero)), baseline_idx)
        for _ in range(ORDMAG_BOOTSTRAPS)])

    n = int(np.round(boot.mean()))
    cutoff = 0
    if n > 0:
        # extend to include all barcodes tied with the cutoff count, bailing
        # to the estimate if that inflates the call >20% (helpers.py:846-859)
        sorted_desc = np.sort(nonzero)[::-1]
        cutoff = sorted_desc[n - 1]
        i = n - 1
        n_ext = n
        while i + 1 < len(sorted_desc) and sorted_desc[i] == cutoff:
            i += 1
            if (i + 1 - n) > 0.20 * n:
                n_ext = n
                break
            n_ext = i + 1
        n = n_ext
    top_idx = np.sort(np.argsort(bc_counts, kind="stable")[::-1][:n])
    return OrdmagResult(top_idx, recovered_cells, n, int(cutoff))


# ---------------------------------------------------------------------------
# EmptyDrops-style rescue of non-ambient barcodes
# ---------------------------------------------------------------------------

@dataclass
class NonAmbientResult:
    eval_bc_idx: np.ndarray
    log_likelihood: np.ndarray
    pvalues: np.ndarray
    pvalues_adj: np.ndarray
    is_nonambient: np.ndarray
    min_umis: int


def est_background_profile_sgt(matrix, use_bcs):
    """SGT-smoothed ambient profile over `use_bcs` columns of a feature x
    barcode sparse matrix. Returns (use_features, profile)."""
    use_feats = np.flatnonzero(np.asarray(matrix.sum(axis=1)).ravel())
    counts = np.asarray(matrix[use_feats][:, use_bcs].sum(axis=1)).ravel().astype(int)
    nz = np.flatnonzero(counts)
    p_sm, p0 = sgt_proportions(counts[nz])
    n0 = len(counts) - len(nz)
    if n0 == 0:
        profile = p_sm / p_sm.sum()
        out = np.zeros(len(counts))
        out[nz] = profile
    else:
        out = np.full(len(counts), p0 / n0)
        out[nz] = p_sm
    return use_feats, out


def eval_multinomial_loglikelihoods(dense_cols: np.ndarray, profile: np.ndarray):
    """log PMF of multinomial(n_b, profile) at columns [F, B] (stats.py:24).
    xlogy gives 0*log(0) = 0, matching scipy's multinomial.logpmf on
    zero-probability features with zero counts."""
    from scipy.special import xlogy
    n = dense_cols.sum(axis=0)
    return (gammaln(n + 1) - gammaln(dense_cols + 1).sum(axis=0)
            + xlogy(dense_cols, profile[:, None]).sum(axis=0))


def simulate_multinomial_loglikelihoods(profile: np.ndarray, umis_per_bc: np.ndarray,
                                        num_sims: int = EMPTYDROPS_NUM_SIMS,
                                        seed: int = 0):
    """Monte Carlo null log-likelihoods at each distinct N (Lun et al.
    incremental scheme, stats.py:81-198, re-vectorized).

    For each simulation, draw features one at a time from `profile`; when
    draw t lands on feature j for the k-th time the log-likelihood update is
    log p_j + log(t) - log(k). A full draw sequence therefore yields the
    log PMF at every prefix length in one vectorized pass, which we read out
    at the distinct N values.

    Returns (distinct_ns, loglk [len(distinct_ns), num_sims]).
    """
    rng = np.random.RandomState(seed)
    distinct_n = np.unique(umis_per_bc.astype(int))
    n_max = int(distinct_n.max())
    loglk = np.zeros((len(distinct_n), num_sims))
    log_p = np.log(profile)
    # lgamma(n+1) term shared across sims
    log_t_cum = np.cumsum(np.log(np.arange(1, n_max + 1)))

    chunk = max(1, min(num_sims, int(2e7) // max(n_max, 1)))
    for s0 in range(0, num_sims, chunk):
        s1 = min(num_sims, s0 + chunk)
        ns = s1 - s0
        draws = rng.choice(len(profile), size=(ns, n_max), p=profile)
        # occurrence rank of each draw within its sim/feature: count of equal
        # features among earlier draws + 1, via sorted ranking
        order = np.argsort(draws, axis=1, kind="stable")
        sorted_feats = np.take_along_axis(draws, order, axis=1)
        new_run = np.concatenate(
            [np.ones((ns, 1), bool), sorted_feats[:, 1:] != sorted_feats[:, :-1]],
            axis=1)
        pos = np.arange(n_max)[None, :]
        run_start = np.maximum.accumulate(np.where(new_run, pos, 0), axis=1)
        rank_sorted = pos - run_start + 1
        rank = np.empty_like(rank_sorted)
        np.put_along_axis(rank, order, rank_sorted, axis=1)
        incr = log_p[draws] - np.log(rank)
        cum = np.cumsum(incr, axis=1) + log_t_cum[None, :]
        loglk[:, s0:s1] = cum[:, distinct_n - 1].T
    return distinct_n, loglk


def compute_ambient_pvalues(umis_per_bc, obs_loglk, sim_n, sim_loglk):
    """P(null loglk < observed) with +1 smoothing (stats.py:205-233)."""
    idx = np.searchsorted(sim_n, umis_per_bc)
    num_sims = sim_loglk.shape[1]
    lower = (sim_loglk[idx, :] < obs_loglk[:, None]).sum(axis=1)
    return (1 + lower) / (1 + num_sims)


def adjust_pvalue_bh(p):
    """Benjamini-Hochberg FDR adjustment."""
    order = np.argsort(p)
    ranked = p[order] * len(p) / (np.arange(len(p)) + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty_like(adj)
    out[order] = np.minimum(adj, 1.0)
    return out


def find_nonambient_barcodes(matrix, umis_per_bc: np.ndarray,
                             orig_cell_idx: np.ndarray,
                             chemistry_name: str = "SC3Pv3",
                             num_probe_bcs: int | None = None,
                             min_umis: int = EMPTYDROPS_MIN_UMIS,
                             num_sims: int = EMPTYDROPS_NUM_SIMS
                             ) -> NonAmbientResult | None:
    """EmptyDrops-like rescue (cell_calling.py:144-263). `matrix` is the raw
    feature x barcode scipy sparse matrix."""
    N = n_partitions(chemistry_name, num_probe_bcs)
    low, high = N // 2, N
    bc_order = np.argsort(umis_per_bc, kind="stable")
    empty_bcs = np.sort(bc_order[::-1][low:high])
    nz_bcs = np.sort(np.flatnonzero(umis_per_bc))
    use_bcs = np.intersect1d(empty_bcs, nz_bcs, assume_unique=True)
    if len(use_bcs) == 0:
        return None
    try:
        eval_features, ambient_p = est_background_profile_sgt(matrix, use_bcs)
    except SGTError:
        return None

    if len(orig_cell_idx) == 0:
        return None
    max_bg = int(umis_per_bc[empty_bcs].max(initial=0))
    min_umis = max(min_umis, 1 + max_bg)

    is_cell = np.zeros(len(umis_per_bc), bool)
    is_cell[orig_cell_idx] = True
    eval_mask = (~is_cell) & (umis_per_bc >= min_umis)
    eval_bcs = np.sort(np.flatnonzero(eval_mask))
    if len(eval_bcs) == 0:
        return None

    eval_mat = np.asarray(
        matrix[eval_features][:, eval_bcs].todense())
    obs_loglk = eval_multinomial_loglikelihoods(eval_mat, ambient_p)
    distinct_n, sim_loglk = simulate_multinomial_loglikelihoods(
        ambient_p, umis_per_bc[eval_bcs], num_sims=num_sims)
    pvals = compute_ambient_pvalues(
        umis_per_bc[eval_bcs], obs_loglk, distinct_n, sim_loglk)
    padj = adjust_pvalue_bh(pvals)
    return NonAmbientResult(
        eval_bc_idx=eval_bcs, log_likelihood=obs_loglk, pvalues=pvals,
        pvalues_adj=padj, is_nonambient=padj <= empty_drops_fdr(chemistry_name),
        min_umis=min_umis)


def call_cells(matrix, umis_per_bc: np.ndarray, chemistry_name: str = "SC3Pv3",
               recovered_cells: int | None = None, force_cells: int | None = None,
               num_probe_bcs: int | None = None):
    """Full cell calling: ordmag + EmptyDrops rescue. Returns (cell_idx
    sorted, dict of metrics)."""
    if force_cells is not None:
        nz = int((umis_per_bc > 0).sum())
        n = min(force_cells, nz)
        idx = np.sort(np.argsort(umis_per_bc, kind="stable")[::-1][:n])
        return idx, {"cells_method": "fixed_cutoff", "filtered_bcs": n}

    om = call_initial_cells_ordmag(umis_per_bc, recovered_cells, chemistry_name,
                                   num_probe_bcs=num_probe_bcs)
    rescue = find_nonambient_barcodes(
        matrix, umis_per_bc, om.filtered_idx, chemistry_name,
        num_probe_bcs=num_probe_bcs)
    extra = (rescue.eval_bc_idx[rescue.is_nonambient]
             if rescue is not None else np.zeros(0, int))
    cells = np.union1d(om.filtered_idx, extra)
    return cells, {
        "cells_method": "ordmag_nonambient",
        "recovered_cells": om.recovered_cells,
        "initial_cells": int(om.filtered_bcs),
        "rescued_cells": int(len(extra)),
        "filtered_bcs": int(len(cells)),
    }


# ---------------------------------------------------------------------------
# Gradient (targeted) cell calling — filter_cellular_barcodes_gradient
# (cell_calling_helpers.py:992-1083): take all barcodes above the steepest
# descent of the spline-smoothed log-log barcode rank plot, searched between
# the ordmag-baseline knee and a bounded number of additional candidates.
# ---------------------------------------------------------------------------
N_CANDIDATE_BARCODES_GRADIENT = 20_000     # helpers.py:36
TARGETED_CC_MIN_UMIS_ADDITIONAL = 10       # cell_calling.py:41
ORDMAG_QUANTILE = 0.99                     # helpers.py:34


def _spline_num_knots(n: int) -> int:
    """Knot-count heuristic for progressive smoothing (helpers.py:1085)."""
    if n < 50:
        return int(n)
    a = [np.log2(50), np.log2(100), np.log2(140), np.log2(200)]
    if n < 200:
        return int(2 ** (a[0] + (a[1] - a[0]) * (n - 50) / 150))
    if n < 800:
        return int(2 ** (a[1] + (a[2] - a[1]) * (n - 200) / 600))
    if n < 3200:
        return int(2 ** (a[2] + (a[3] - a[2]) * (n - 800) / 2400))
    return int(200 + (n - 3200) ** 0.2)


def call_cells_gradient(bc_counts: np.ndarray,
                        recovered_cells: int | None = None,
                        max_additional: int = N_CANDIDATE_BARCODES_GRADIENT,
                        min_umis_additional: int =
                        TARGETED_CC_MIN_UMIS_ADDITIONAL,
                        infer_throughput: bool = False):
    """Returns (sorted barcode indices called as cells, metrics dict)."""
    from scipy import interpolate

    if recovered_cells is None:
        recovered_cells = 3000  # DEFAULT_RECOVERED_CELLS_PER_GEM_GROUP
    recovered_cells = max(recovered_cells, 10)
    nz = np.sort(bc_counts[bc_counts > 0])[::-1]
    if len(nz) == 0:
        return np.zeros(0, np.int64), {"cells_method": "gradient",
                                       "filtered_bcs": 0}
    base_idx = min(int(np.round(recovered_cells * (1 - ORDMAG_QUANTILE))),
                   len(nz) - 1)
    base_thresh = nz[base_idx]
    if infer_throughput:
        lower = 0
        max_additional, min_umis_additional = 150_000, 3
    else:
        lower = min(int((nz >= base_thresh / 10.0).sum()) - 1, len(nz) - 1)
    upper = min(lower + max_additional,
                int((nz >= min_umis_additional).sum()))
    upper = min(max(upper, lower), len(nz) - 1)

    uniq = np.unique(nz)[::-1]
    log_y = np.log10(uniq.astype(float))
    x_vals = np.asarray([(nz >= v).sum() for v in uniq])
    log_x = np.log10(x_vals.astype(float))
    log_x = np.append(log_x, np.log10(1 + nz.sum()))
    log_y = np.append(log_y, 0.0)

    k = min(3, len(log_y) - 1)
    spl = interpolate.UnivariateSpline(x=log_x, y=log_y, k=k, s=0,
                                       check_finite=True)
    if len(log_x) > 50:
        want = _spline_num_knots(len(log_x))
        knots = spl.get_knots()
        if want < len(knots):
            t = [knots[i] for i in np.linspace(1, len(knots) - 2, want - 2,
                                               dtype=int)]
            spl = interpolate.LSQUnivariateSpline(x=log_x, y=log_y, t=t,
                                                  k=k, check_finite=True)
    grads = spl(log_x[:-1], 1)
    in_range = (x_vals >= lower) & (x_vals <= upper)
    grads = np.where(in_range, grads, 0.0)
    cutoff = np.round(10 ** log_y[np.argmin(grads)], 0)
    n_cells = max(int((nz > cutoff).sum()), lower + 1)
    n_cells = min(n_cells, len(nz))
    idx = np.sort(np.argsort(bc_counts, kind="stable")[::-1][:n_cells])
    return idx, {"cells_method": "gradient", "filtered_bcs": int(n_cells),
                 "gradient_count_cutoff": float(cutoff)}


# ---------------------------------------------------------------------------
# Post-call filters (filter_barcodes/__init__.py:553-575 via
# cell_calling_helpers.py:671-785)
# ---------------------------------------------------------------------------
# Human + mouse mitochondrial gene Ensembl ids (helpers.py:66-97); feature
# ids are matched on their post-underscore suffix for barnyard prefixes.
MT_ENSEMBL_IDS = frozenset([
    "ENSG00000198888", "ENSG00000198763", "ENSG00000198804",
    "ENSG00000198712", "ENSG00000228253", "ENSG00000198899",
    "ENSG00000198938", "ENSG00000198840", "ENSG00000212907",
    "ENSG00000198886", "ENSG00000198786", "ENSG00000198695",
    "ENSG00000198727",
    "ENSMUSG00000064341", "ENSMUSG00000064345", "ENSMUSG00000064351",
    "ENSMUSG00000064354", "ENSMUSG00000064356", "ENSMUSG00000064357",
    "ENSMUSG00000064358", "ENSMUSG00000064360", "ENSMUSG00000065947",
    "ENSMUSG00000064363", "ENSMUSG00000064367", "ENSMUSG00000064368",
    "ENSMUSG00000064370",
])


def mito_gene_rows(feature_ids: list) -> np.ndarray:
    """Indices of mitochondrial genes among feature ids (suffix match)."""
    rows = []
    for i, fid in enumerate(feature_ids):
        if isinstance(fid, bytes):
            fid = fid.decode()
        if fid.split("_")[-1] in MT_ENSEMBL_IDS:
            rows.append(i)
    return np.asarray(rows, np.int64)


def apply_mito_filter(gex_matrix, cells_idx: np.ndarray,
                      mt_rows: np.ndarray, max_mito_percent: float):
    """Drop called cells whose mito UMI percentage exceeds the threshold
    (helpers.py:671-746).  Returns (kept cells, removed cells, mt_pct)."""
    cells_idx = np.asarray(cells_idx)
    if len(mt_rows) == 0 or len(cells_idx) == 0 or max_mito_percent >= 100:
        return cells_idx, np.zeros(0, np.int64), np.zeros(len(cells_idx))
    total = np.asarray(gex_matrix[:, cells_idx].sum(axis=0)).ravel()
    mt = np.asarray(gex_matrix[mt_rows][:, cells_idx].sum(axis=0)).ravel()
    pct = 100.0 * mt / np.maximum(total, 1)
    drop = pct > max_mito_percent
    return cells_idx[~drop], cells_idx[drop], pct


def apply_min_umi_filter(umis_per_bc: np.ndarray, cells_idx: np.ndarray,
                         minimum_umis: int) -> np.ndarray:
    """Global minimum-UMI threshold on cell calls (helpers.py:749-785)."""
    cells_idx = np.asarray(cells_idx)
    if minimum_umis <= 0 or len(cells_idx) == 0:
        return cells_idx
    return cells_idx[umis_per_bc[cells_idx] >= minimum_umis]
