"""aggr: aggregate multiple count runs (SC_RNA_AGGREGATOR analog,
mro/rna/sc_rna_aggregator.mro:10).

Stages re-expressed in-process:
  * parse aggr CSV (sample_id, molecule_h5) — PARSE_AGGR_CSV
  * merge molecule_info files with per-run gem groups — MERGE_MOLECULES
    (cr_aggr/src/merge_molecules.rs; barcode_idx remap like
    fast_utils concatenate_molecule_infos)
  * depth normalization — NORMALIZE_DEPTH (stages/aggregator/normalize_depth:
    subsample every library's molecules to the minimum usable reads per cell
    across libraries; seeded RNG for reproducibility)
  * matrix rebuild + cell union + secondary analysis — WRITE_MATRICES +
    SC_RNA_ANALYZER.

Copy of cellranger_tpu/pipeline/aggr.py with a keyword `device` passed down
to the port's run_count / run_secondary_analysis, which need one.
It reads and writes h5 files through io/hdf5.py.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from ..io.matrix_io import CountMatrix, FeatureDef, FeatureReference
from ..io.molecule_info import load_molecule_info, save_molecule_info


def parse_aggr_csv(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        reader = csv.DictReader(f)
        cols = set(reader.fieldnames or [])
        if "sample_id" not in cols or "molecule_h5" not in cols:
            raise ValueError(
                "aggr CSV must have columns sample_id,molecule_h5")
        for row in reader:
            entry = dict(sample_id=row["sample_id"].strip(),
                         molecule_h5=row["molecule_h5"].strip())
            if row.get("batch"):
                entry["batch"] = row["batch"].strip()
            out.append(entry)
    if not out:
        raise ValueError("aggr CSV has no rows")
    return out


def check_invariants(out_dir: str, summary: dict) -> None:
    """Post-merge invariants (CHECK_INVARIANTS stage analog): raw matrix
    sums equal molecule counts; filtered is a column subset of raw; every
    filtered barcode carries a known gem-group suffix."""
    from ..io.matrix_io import CountMatrix
    from ..io.molecule_info import load_molecule_info

    raw = CountMatrix.load_h5(os.path.join(out_dir,
                                           "raw_feature_bc_matrix.h5"))
    filt = CountMatrix.load_h5(os.path.join(out_dir,
                                            "filtered_feature_bc_matrix.h5"))
    mi = load_molecule_info(os.path.join(out_dir, "molecule_info.h5"))
    n_mol = len(mi["barcode_idx"])
    if int(raw.m.sum()) != n_mol:
        raise AssertionError(
            f"aggr invariant violated: raw matrix total {int(raw.m.sum())} "
            f"!= molecule_info rows {n_mol}")
    raw_set = set(raw.barcodes)
    missing = [b for b in filt.barcodes if b not in raw_set]
    if missing:
        raise AssertionError(
            f"aggr invariant violated: {len(missing)} filtered barcodes "
            f"absent from the raw matrix (e.g. {missing[:3]})")
    bad = [b for b in filt.barcodes
           if b"-" not in (b if isinstance(b, bytes) else b.encode())]
    if bad:
        raise AssertionError(
            f"aggr invariant violated: barcodes without gem-group suffix "
            f"(e.g. {bad[:3]})")
    if summary["total_cells"] != filt.m.shape[1]:
        raise AssertionError(
            "aggr invariant violated: summary cell count "
            f"{summary['total_cells']} != filtered matrix columns "
            f"{filt.m.shape[1]}")


def run_aggr(csv_path: str, out_dir: str, normalize: str = "mapped",
             seed: int = 0, secondary_analysis: bool = True,
             *, device) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    samples = parse_aggr_csv(csv_path)
    infos = [load_molecule_info(s["molecule_h5"]) for s in samples]

    # feature space must match across runs
    f0 = [x.decode() for x in infos[0]["features_id"]]
    for mi in infos[1:]:
        if [x.decode() for x in mi["features_id"]] != f0:
            raise ValueError("aggr inputs have mismatched feature references")

    # usable reads per cell per library
    rrpc = []
    for mi in infos:
        n_cells = max(len(mi["pass_filter"]), 1)
        usable = int(mi["count"].sum())
        rrpc.append(usable / n_cells)
    target = min(rrpc)
    rates = [target / r if r > 0 else 1.0 for r in rrpc]

    rng = np.random.RandomState(seed)
    mol_bc, mol_feat, mol_umi, mol_cnt, mol_gg = [], [], [], [], []
    barcodes_all: list[bytes] = []
    pass_filter_all = []
    for g, (mi, rate) in enumerate(zip(infos, rates), start=1):
        cnt = mi["count"].astype(np.int64)
        if rate < 1.0:
            cnt = rng.binomial(cnt, rate)
        keep = cnt > 0
        base = len(barcodes_all)
        # library barcodes get this run's gem group suffix
        lib_bcs = [b.rsplit(b"-", 1)[0] + b"-%d" % g for b in mi["barcodes"]]
        barcodes_all.extend(lib_bcs)
        mol_bc.append(mi["barcode_idx"][keep].astype(np.int64) + base)
        mol_feat.append(mi["feature_idx"][keep])
        mol_umi.append(mi["umi"][keep])
        mol_cnt.append(cnt[keep])
        mol_gg.append(np.full(int(keep.sum()), g, np.uint16))
        pass_filter_all.append(mi["pass_filter"][:, 0].astype(np.int64) + base)

    bc_idx = np.concatenate(mol_bc)
    feat = np.concatenate(mol_feat)
    umi = np.concatenate(mol_umi)
    cnt = np.concatenate(mol_cnt)
    cells = np.concatenate(pass_filter_all)

    features = FeatureReference([FeatureDef(i, i) for i in f0])
    raw = CountMatrix.from_molecules(bc_idx, feat.astype(np.int64),
                                     barcodes_all, features)
    raw.save_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"))
    filtered = raw.select_barcodes(np.sort(cells))
    filtered.save_h5(os.path.join(out_dir, "filtered_feature_bc_matrix.h5"))
    filtered.save_mex(os.path.join(out_dir, "filtered_feature_bc_matrix"))

    save_molecule_info(
        os.path.join(out_dir, "molecule_info.h5"),
        barcode_idx=bc_idx, feature_idx=feat, umi=umi, count=cnt,
        barcodes=barcodes_all, features=features,
        pass_filter_bc_idx=np.sort(cells).astype(np.uint64),
        library_info=[{"library_type": "Gene Expression",
                       "library_id": s["sample_id"], "gem_group": g + 1}
                      for g, s in enumerate(samples)],
        metrics={"aggr_samples": [s["sample_id"] for s in samples],
                 "normalization_rates": rates})

    if secondary_analysis and filtered.shape[1] >= 2:
        from ..analysis.run import run_secondary_analysis
        # optional per-sample `batch` column drives MNN chemistry-batch
        # correction; default: each input run is its own batch only when
        # requested
        batch_of_sample = {s_["sample_id"]: s_.get("batch")
                           for s_ in samples}
        batch_labels = None
        if any(batch_of_sample.values()):
            gem_of_cell = [b.rsplit(b"-", 1)[1].decode()
                           for b in filtered.barcodes]
            sample_of_gem = {str(g + 1): s_["sample_id"]
                             for g, s_ in enumerate(samples)}
            batch_labels = [batch_of_sample[sample_of_gem[g]] or
                            sample_of_gem[g] for g in gem_of_cell]
        run_secondary_analysis(filtered, os.path.join(out_dir, "analysis"),
                               batch_labels=batch_labels, device=device)

    summary = dict(
        samples=[s["sample_id"] for s in samples],
        usable_reads_per_cell=rrpc,
        normalization_rates=rates,
        total_molecules_post_norm=int(len(bc_idx)),
        total_cells=int(len(cells)),
        estimated_cells=int(len(cells)),
        total_molecules=int(len(bc_idx)),
        median_umis_per_cell=float(np.median(np.asarray(
            filtered.m.sum(axis=0)).ravel())) if filtered.shape[1] else 0.0,
        median_genes_per_cell=float(np.median(np.asarray(
            (filtered.m > 0).sum(axis=0)).ravel())) if filtered.shape[1] else 0.0,
    )
    # CHECK_INVARIANTS (sc_rna_aggregator.mro:179): the merged outputs
    # must be self-consistent — fail loudly rather than write bad aggr outs
    check_invariants(out_dir, summary)

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    from .websummary import build_web_summary
    build_web_summary(out_dir, sample_id="aggr", pipeline="aggr")
    return summary
