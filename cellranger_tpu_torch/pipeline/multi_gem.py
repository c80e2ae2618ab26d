"""Multi-gem-well processing: per-well counting + merge — the
MERGE_GEM_WELLS_AND_SLICE_CELLS analog (mro/rna/_sc_multi_defs.mro:1825)
and the MRO `map call` fan-out over gem wells (SURVEY §2.7 P6).

Each gem well is an independent emulsion: barcode correction, counting,
and CELL CALLING run per well (the reference calls cells per gem group,
filter_barcodes/__init__.py groups by gem_group), then outputs merge:

  * raw/filtered matrices concatenate column-wise; barcodes already carry
    the "-<gem_group>" suffix so the merged space is disjoint;
  * molecule_info concatenates with per-well gem_group values and
    barcode_idx offsets (fast_utils concatenate_molecule_infos analog);
  * scalar metrics fold with the Metric::merge monoid semantics;
  * secondary analysis runs once over the merged filtered matrix.

Copy of cellranger_tpu/pipeline/multi_gem.py with a keyword `device` passed down
to the port's run_count / run_secondary_analysis, which need one.
The merge reads and writes h5 files through io/hdf5.py.
"""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp

from ..io.matrix_io import CountMatrix
from ..io.molecule_info import load_molecule_info, save_molecule_info
from .count import CountConfig, run_count

# metrics that merge by sum (counters); fractions recompute from sums
_SUM_KEYS = (
    "total_reads", "valid_barcode_reads", "corrected_barcode_reads",
    "valid_umi_reads", "mapped_reads", "conf_mapped_reads", "exonic_reads",
    "intronic_reads", "intergenic_reads", "antisense_reads", "usable_reads",
    "total_molecules", "q30_bc_bases", "bc_bases", "q30_umi_bases",
    "umi_bases", "q30_rna_bases", "rna_bases", "estimated_cells",
    "tso_reads", "polya_trimmed_reads", "improper_pair_reads",
)


def _merge_matrices(paths: list[str]) -> CountMatrix:
    mats = [CountMatrix.load_h5(p) for p in paths]
    f0 = mats[0].features.ids
    for m in mats[1:]:
        if m.features.ids != f0:
            raise ValueError("gem wells disagree on the feature list; "
                             "they must share one reference")
    merged = sp.hstack([m.m for m in mats]).tocsc()
    barcodes = [b for m in mats for b in m.barcodes]
    return CountMatrix(merged, barcodes, mats[0].features)


def run_count_gem_wells(cfgs: list[CountConfig], out_dir: str,
                        secondary_analysis: bool = True, *, device) -> dict:
    """Run count per gem well, then merge. cfgs: one CountConfig per well
    (gem_group must be distinct; set 1..N if not)."""
    os.makedirs(out_dir, exist_ok=True)
    seen = set()
    for i, cfg in enumerate(cfgs):
        if cfg.gem_group in seen:
            cfg.gem_group = max(seen) + 1
        seen.add(cfg.gem_group)
        # per-well outputs keep their own cell calls; merged analysis runs
        # once at the end
        cfg.secondary_analysis = False

    well_dirs = []
    summaries = []
    for cfg in cfgs:
        wdir = os.path.join(out_dir, "gem_wells", f"gw{cfg.gem_group}")
        summaries.append(run_count(cfg, wdir, device=device))
        well_dirs.append(wdir)

    # ---- merge matrices ----
    raw = _merge_matrices([os.path.join(d, "raw_feature_bc_matrix.h5")
                           for d in well_dirs])
    filt = _merge_matrices([os.path.join(d, "filtered_feature_bc_matrix.h5")
                            for d in well_dirs])
    raw.save_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"))
    raw.save_mex(os.path.join(out_dir, "raw_feature_bc_matrix"))
    filt.save_h5(os.path.join(out_dir, "filtered_feature_bc_matrix.h5"))
    filt.save_mex(os.path.join(out_dir, "filtered_feature_bc_matrix"))

    # ---- merge molecule_info (barcode_idx offsets per well) ----
    offs = 0
    cols = {k: [] for k in ("gem_group", "barcode_idx", "feature_idx",
                            "library_idx", "umi", "count")}
    pass_filter = []
    for cfg, d in zip(cfgs, well_dirs):
        mi = load_molecule_info(os.path.join(d, "molecule_info.h5"))
        n_bc = len(mi["barcodes"])
        cols["gem_group"].append(
            np.full(len(mi["barcode_idx"]), cfg.gem_group, np.uint16))
        cols["barcode_idx"].append(mi["barcode_idx"].astype(np.uint64)
                                   + offs)
        for k in ("feature_idx", "library_idx", "umi", "count"):
            cols[k].append(mi[k])
        if "pass_filter_bc_idx" in mi:
            pass_filter.append(mi["pass_filter_bc_idx"].astype(np.uint64)
                               + offs)
        offs += n_bc
    save_molecule_info(
        os.path.join(out_dir, "molecule_info.h5"),
        barcode_idx=np.concatenate(cols["barcode_idx"]),
        feature_idx=np.concatenate(cols["feature_idx"]),
        umi=np.concatenate(cols["umi"]),
        count=np.concatenate(cols["count"]),
        library_idx=np.concatenate(cols["library_idx"]),
        barcodes=raw.barcodes, features=raw.features,
        gem_group=int(cfgs[0].gem_group),
        gem_group_per_mol=np.concatenate(cols["gem_group"]),
        pass_filter_bc_idx=(np.concatenate(pass_filter)
                            if pass_filter else np.zeros(0, np.uint64)),
        metrics={"n_gem_wells": len(cfgs)})

    # ---- merge metrics (Metric::merge monoid) ----
    merged: dict = {"n_gem_wells": len(cfgs)}
    for k in _SUM_KEYS:
        vals = [s.get(k) for s in summaries if k in s]
        if vals:
            merged[k] = type(vals[0])(sum(vals))
    t = max(merged.get("total_reads", 0), 1)
    merged["valid_barcode_frac"] = merged.get("valid_barcode_reads", 0) / t
    merged["mapped_frac"] = merged.get("mapped_reads", 0) / t
    merged["conf_mapped_frac"] = merged.get("conf_mapped_reads", 0) / t
    u = merged.get("usable_reads", 0)
    merged["sequencing_saturation"] = (
        1.0 - merged.get("total_molecules", 0) / u if u else 0.0)
    merged["per_well"] = {
        f"gw{cfg.gem_group}": {k: s[k] for k in
                               ("total_reads", "estimated_cells",
                                "conf_mapped_frac") if k in s}
        for cfg, s in zip(cfgs, summaries)}
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(merged, f, indent=2, default=float)

    # ---- secondary analysis over the merged cells ----
    if secondary_analysis and filt.m.shape[1] >= 2:
        from ..analysis.run import run_secondary_analysis
        run_secondary_analysis(filt, os.path.join(out_dir, "analysis"),
                               device=device)

    return merged
