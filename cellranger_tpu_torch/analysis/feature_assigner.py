"""Feature-barcode assignment: CRISPR protospacer / antibody tag calling
(lib/python/cellranger/feature/feature_assigner.py analog).

The reference assigns each cell the set of guides (or tags) whose UMI
counts fall in the HIGH component of a per-feature two-component mixture
fit on log10 UMI counts over cells (GuideAssigner; CMO tags instead use
the JIBES model, analysis/jibes.py here). Cells are then bucketed as
none / single / multiple, which drives `protospacer_calls_per_cell.csv`
and the CRISPR metrics block of the web summary.

Host-side numpy: the per-feature EM runs over #cells-length vectors
(tens of thousands), trivially fast and deterministic; device offload
would only add transfer latency.

Verbatim copy of cellranger_tpu/analysis/feature_assigner.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import os

import numpy as np

MIN_UMI = 3            # reference's minimum evidence for a call
MIN_POSITIVE_CELLS = 10
EM_ITERS = 100
EM_TOL = 1e-6


def _fit_two_gaussians(x: np.ndarray):
    """1-D two-component Gaussian mixture EM on x; returns (mu, sd, w)
    arrays of shape [2] sorted so component 1 is the HIGH mode."""
    mu = np.percentile(x, [25.0, 75.0]).astype(np.float64)
    if mu[0] == mu[1]:
        mu[1] = mu[0] + 1.0
    sd = np.full(2, max(x.std(), 1e-3))
    w = np.array([0.5, 0.5])
    ll_old = -np.inf
    for _ in range(EM_ITERS):
        # E step: responsibilities of each component
        z = -0.5 * ((x[:, None] - mu[None, :]) / sd[None, :]) ** 2 \
            - np.log(sd[None, :]) + np.log(w[None, :])
        zmax = z.max(axis=1, keepdims=True)
        p = np.exp(z - zmax)
        tot = p.sum(axis=1, keepdims=True)
        r = p / tot
        ll = float((np.log(tot).ravel() + zmax.ravel()).sum())
        # M step
        n = r.sum(axis=0) + 1e-12
        mu = (r * x[:, None]).sum(axis=0) / n
        sd = np.sqrt((r * (x[:, None] - mu[None, :]) ** 2).sum(axis=0) / n)
        sd = np.maximum(sd, 1e-3)
        w = n / len(x)
        if abs(ll - ll_old) < EM_TOL:
            break
        ll_old = ll
    order = np.argsort(mu)
    return mu[order], sd[order], w[order]


def call_features(counts: np.ndarray, min_umi: int = MIN_UMI) -> np.ndarray:
    """counts: [F, C] UMI counts (features x cells). Returns bool [F, C]:
    cell c is positive for feature f. Per feature, a two-component
    Gaussian mixture on log10(count) over cells with count>0 separates
    ambient from expressing; positives are posterior-majority members of
    the high component with count >= min_umi. Features with too few
    positive cells fall back to the min_umi threshold alone."""
    F, C = counts.shape
    out = np.zeros((F, C), bool)
    for f in range(F):
        c = counts[f]
        nz = c >= 1
        if int(nz.sum()) < MIN_POSITIVE_CELLS:
            out[f] = c >= min_umi
            continue
        x = np.log10(c[nz].astype(np.float64))
        mu, sd, w = _fit_two_gaussians(x)
        if mu[1] - mu[0] < 1e-6:
            out[f] = c >= min_umi
            continue
        z = -0.5 * ((x[:, None] - mu[None, :]) / sd[None, :]) ** 2 \
            - np.log(sd[None, :]) + np.log(np.maximum(w[None, :], 1e-12))
        hi = z[:, 1] > z[:, 0]
        pos = np.zeros(C, bool)
        pos[np.flatnonzero(nz)[hi]] = True
        out[f] = pos & (c >= min_umi)
    return out


def assignment_table(assigned: np.ndarray, counts: np.ndarray,
                     feature_ids: list[str], barcodes: list) -> list[dict]:
    """Per-cell call rows (protospacer_calls_per_cell.csv schema:
    cell_barcode, num_features, feature_call, num_umis; multi-calls are
    '|'-joined like the reference)."""
    rows = []
    F, C = assigned.shape
    for ci in range(C):
        fs = np.flatnonzero(assigned[:, ci])
        if len(fs) == 0:
            continue
        bc = barcodes[ci]
        bc = bc.decode() if isinstance(bc, bytes) else bc
        rows.append(dict(
            cell_barcode=bc,
            num_features=len(fs),
            feature_call="|".join(feature_ids[f] for f in fs),
            num_umis="|".join(str(int(counts[f, ci])) for f in fs)))
    return rows


def run_feature_assignment(filtered_matrix, feature_type: str,
                           out_dir: str, prefix: str) -> dict:
    """Call features of `feature_type` on a filtered CountMatrix; writes
    {prefix}_calls_per_cell.csv + {prefix}_calls_summary.csv under
    out_dir and returns the summary metrics dict."""
    fdefs = filtered_matrix.features.feature_defs
    sel = [i for i, d in enumerate(fdefs) if d.feature_type == feature_type]
    if not sel:
        return {}
    os.makedirs(out_dir, exist_ok=True)
    counts = np.asarray(filtered_matrix.m[sel, :].todense())
    ids = [fdefs[i].id for i in sel]
    assigned = call_features(counts)
    rows = assignment_table(assigned, counts, ids, filtered_matrix.barcodes)

    n_cells = counts.shape[1]
    per_cell_n = assigned.sum(axis=0)
    n_single = int((per_cell_n == 1).sum())
    n_multi = int((per_cell_n > 1).sum())
    with open(os.path.join(out_dir, f"{prefix}_calls_per_cell.csv"), "w") as f:
        f.write("cell_barcode,num_features,feature_call,num_umis\n")
        for r in rows:
            f.write(f"{r['cell_barcode']},{r['num_features']},"
                    f"{r['feature_call']},{r['num_umis']}\n")
    # per-feature summary (reference: protospacer_calls_summary.csv)
    with open(os.path.join(out_dir, f"{prefix}_calls_summary.csv"), "w") as f:
        f.write("feature_call,num_cells,pct_cells,median_umis\n")
        for fi, fid in enumerate(ids):
            cells = assigned[fi]
            n = int(cells.sum())
            med = float(np.median(counts[fi, cells])) if n else 0.0
            f.write(f"{fid},{n},{100.0 * n / max(n_cells, 1):.2f},{med}\n")
    summary = {
        f"cells_with_one_{prefix}_frac": n_single / max(n_cells, 1),
        f"cells_with_multiple_{prefix}_frac": n_multi / max(n_cells, 1),
        f"cells_with_no_{prefix}_frac":
            (n_cells - n_single - n_multi) / max(n_cells, 1),
    }
    return summary


# ---------------------------------------------------------------------------
# Antigen specificity (BEAM) — cellranger/feature/antigen/specificity.py:
# per cell, each antigen scores (1 - BetaCDF(0.925; S+1, N+3)) * 100 where
# S = antigen UMIs and N = the matched negative-control antigen's UMIs
# (matched by mhc_allele; a single control serves the no-allele case);
# antigens with score >= 75 are assigned.
# ---------------------------------------------------------------------------
SIGNAL_PRIOR = 1          # specificity.py:22
NOISE_PRIOR = 3           # specificity.py:23
SPECIFICITY_CUTOFF = 0.925
ASSIGN_THRESHOLD = 75.0   # specificity.py:598
NO_ALLELE = "no_allele"


def antigen_specificity(filtered_matrix, spec_rows: list[dict],
                        out_dir: str) -> dict:
    """spec_rows: [antigen-specificity] config rows (control_id +
    optional mhc_allele).  Writes antigen_specificity_scores.csv and
    antigen_assignment.csv; returns summary metrics."""
    from scipy.stats import beta

    fdefs = filtered_matrix.features.feature_defs
    ag_rows = [i for i, d in enumerate(fdefs)
               if d.feature_type == "Antigen Capture"]
    if not ag_rows or not spec_rows:
        return {}
    id_of = {fdefs[i].id: i for i in ag_rows}
    control_of_allele = {}
    for row in spec_rows:
        cid = row["control_id"].strip()
        if cid not in id_of:
            raise ValueError(
                f"[antigen-specificity] control_id {cid!r} is not an "
                f"Antigen Capture feature")
        control_of_allele[row.get("mhc_allele", "").strip()
                          or NO_ALLELE] = cid
    controls = set(control_of_allele.values())

    # antigen -> its allele's control (feature tags carry mhc_allele)
    antigen_to_control = {}
    for i in ag_rows:
        fid = fdefs[i].id
        if fid in controls:
            continue
        allele = (fdefs[i].tags or {}).get("mhc_allele", "") or NO_ALLELE
        ctrl = control_of_allele.get(allele)
        if ctrl is None and len(control_of_allele) == 1:
            ctrl = next(iter(control_of_allele.values()))
        if ctrl is None:
            raise ValueError(
                f"antigen {fid!r} (allele {allele!r}) has no matching "
                f"control in [antigen-specificity]")
        antigen_to_control[fid] = ctrl

    os.makedirs(out_dir, exist_ok=True)
    counts = {fdefs[i].id: np.asarray(
        filtered_matrix.m[i, :].todense()).ravel() for i in ag_rows}
    bcs = filtered_matrix.barcodes
    n_assigned = 0
    with open(os.path.join(out_dir, "antigen_specificity_scores.csv"),
              "w") as f, \
            open(os.path.join(out_dir, "antigen_assignment.csv"),
                 "w") as fa:
        f.write("barcode,antigen,antigen_umi,control,control_umi,score,"
                "mhc_allele\n")
        fa.write("barcode,assigned_antigen\n")
        score_cache: dict = {}
        for c in range(len(bcs)):
            bc = bcs[c].decode() if isinstance(bcs[c], bytes) else bcs[c]
            assigned = []
            any_umi = 0
            for ag, ctrl in antigen_to_control.items():
                S = int(counts[ag][c])
                N = int(counts[ctrl][c])
                any_umi += S
                key = (S, N)
                if key not in score_cache:
                    score_cache[key] = float(
                        (1 - beta.cdf(SPECIFICITY_CUTOFF,
                                      S + SIGNAL_PRIOR,
                                      N + NOISE_PRIOR)) * 100)
                sc = score_cache[key]
                allele = (fdefs[id_of[ag]].tags or {}).get(
                    "mhc_allele", "") or NO_ALLELE
                f.write(f"{bc},{ag},{S},{ctrl},{N},{sc:.4f},{allele}\n")
                if sc >= ASSIGN_THRESHOLD:
                    assigned.append(ag)
            if assigned:
                n_assigned += 1
                fa.write(f"{bc},{'|'.join(assigned)}\n")
            else:
                fa.write(f"{bc},{'Blank' if any_umi == 0 else 'Unassigned'}\n")
    return {
        "antigen_specificity_cells_assigned": n_assigned,
        "antigen_specificity_frac_assigned":
            n_assigned / max(len(bcs), 1),
        "antigen_specificity_n_antigens": len(antigen_to_control),
    }
