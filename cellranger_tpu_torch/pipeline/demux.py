"""Sample demultiplexing for CMO-multiplexed runs — the _ASSIGN_TAGS +
DEMUX stages analog (mro/rna/_basic_sc_rna_counter.mro:209-302): fit the
JIBES tag model on Multiplexing Capture counts of called cells, map tags to
samples per the [samples] config, and emit per-sample filtered matrices +
an assignment CSV.

Copy of cellranger_tpu/pipeline/demux.py with a keyword `device` passed down
to the port's run_count / run_secondary_analysis, which need one.
"""

from __future__ import annotations

import os

import numpy as np

from ..analysis.jibes import fit_jibes
from ..io.matrix_io import CountMatrix, MULTIPLEXING


def write_sample_outs(sub: CountMatrix, sdir: str, sample_id: str,
                      secondary: bool = True,
                      count_out_dir: str | None = None, *, device) -> dict:
    """Per-sample outs (SAMPLE_ANALYZER + SAMPLE_REPORTER analog,
    mro/rna/sc_multi_core.mro:230,273): matrix h5 + MEX, sample metrics
    JSON, secondary analysis, web summary — plus, when the run-level outs
    exist in count_out_dir, a per-sample BAM and per-sample molecule_info
    (MULTI_WRITE_PER_SAMPLE_BAM / MULTI_WRITE_PER_SAMPLE_MOLECULE_INFO,
    mro/rna/_basic_sc_rna_counter.mro:258-294)."""
    import json

    os.makedirs(sdir, exist_ok=True)
    sub.save_h5(os.path.join(sdir, "sample_filtered_feature_bc_matrix.h5"))
    sub.save_mex(os.path.join(sdir, "sample_filtered_feature_bc_matrix"))
    sample_bcs = {b.decode() if isinstance(b, bytes) else b
                  for b in sub.barcodes}
    if count_out_dir:
        mol = os.path.join(count_out_dir, "molecule_info.h5")
        if os.path.exists(mol):
            from ..io.molecule_info import subset_molecule_info
            subset_molecule_info(
                mol, os.path.join(sdir, "sample_molecule_info.h5"),
                sub.barcodes)
        bam = os.path.join(count_out_dir, "possorted_genome_bam.bam")
        if os.path.exists(bam):
            from ..io.bam_filter import filter_bam_by_cb
            filter_bam_by_cb(
                bam, os.path.join(sdir, "sample_alignments.bam"),
                sample_bcs, read_group=sample_id)
    umis = sub.counts_per_bc()
    genes_per_cell = np.asarray((sub.m > 0).sum(axis=0)).ravel()
    metrics = dict(
        sample_id=sample_id,
        cells=int(sub.m.shape[1]),
        total_umis=int(umis.sum()),
        median_umis_per_cell=float(np.median(umis)) if len(umis) else 0.0,
        median_genes_per_cell=(float(np.median(genes_per_cell))
                               if len(genes_per_cell) else 0.0),
        total_features_detected=int((sub.counts_per_feature() > 0).sum()))
    with open(os.path.join(sdir, "metrics_summary.json"), "w") as f:
        json.dump(metrics, f, indent=2, default=float)
    if secondary and sub.m.shape[1] >= 2:
        from ..analysis.run import run_secondary_analysis
        try:
            run_secondary_analysis(sub, os.path.join(sdir, "analysis"),
                                   device=device)
        except Exception as e:  # tiny samples can defeat PCA/clustering
            metrics["secondary_analysis_error"] = str(e)
    from .websummary import build_web_summary
    try:
        build_web_summary(sdir, sample_id, pipeline="count")
    except Exception:
        pass
    return metrics


def demux_samples(count_out_dir: str, samples: list[dict], out_dir: str,
                  *, device) -> dict:
    """samples: rows with sample_id + cmo_ids ('|'-separated tag feature
    names). Returns summary dict."""
    filtered = CountMatrix.load_h5(
        os.path.join(count_out_dir, "filtered_feature_bc_matrix.h5"))
    tag_rows = [i for i, f in enumerate(filtered.features.feature_defs)
                if f.feature_type == MULTIPLEXING]
    if not tag_rows:
        raise ValueError("no Multiplexing Capture features in the matrix; "
                         "CMO demux needs a multiplexing library")
    tag_names = [filtered.features.feature_defs[i].id for i in tag_rows]
    counts = np.asarray(filtered.m[tag_rows, :].todense()).T
    res = fit_jibes(counts, tag_names)

    tag_to_sample = {}
    for row in samples:
        for cmo in row.get("cmo_ids", "").split("|"):
            if cmo:
                tag_to_sample[cmo.strip()] = row["sample_id"]
    unknown = set(tag_names) - set(tag_to_sample)

    os.makedirs(out_dir, exist_ok=True)
    per_sample_cols: dict[str, list[int]] = {}
    rows_csv = []
    for ci, (bc, call) in enumerate(zip(filtered.barcodes, res.assignments)):
        sample = tag_to_sample.get(call, call)  # Blank/Multiplet keep label
        rows_csv.append((bc.decode(), call, sample, res.posteriors[ci]))
        if call in tag_to_sample:
            per_sample_cols.setdefault(tag_to_sample[call], []).append(ci)

    with open(os.path.join(out_dir, "assignments.csv"), "w") as f:
        f.write("barcode,tag_call,sample,posterior\n")
        for bc, call, sample, post in rows_csv:
            f.write(f"{bc},{call},{sample},{post:.4f}\n")

    summary = dict(samples={}, n_blank=sum(1 for r in rows_csv if r[1] == "Blank"),
                   n_multiplet=sum(1 for r in rows_csv if r[1] == "Multiplet"),
                   unmapped_tags=sorted(unknown))
    for sample_id, cols in per_sample_cols.items():
        sub = filtered.select_barcodes(np.asarray(cols))
        sdir = os.path.join(out_dir, "per_sample_outs", sample_id)
        write_sample_outs(sub, sdir, sample_id,
                          count_out_dir=count_out_dir, device=device)
        summary["samples"][sample_id] = len(cols)
    return summary


def demux_overhang_samples(count_out_dir: str, samples: list[dict],
                           chem, out_dir: str, *, device) -> dict:
    """OH (overhang) sample demux: the 2bp overhang sample barcode is a
    VIEW into the gel-bead barcode (chemistry_defs.json *-OH defs,
    R1[7:9]), so sample assignment is a deterministic split of the
    filtered matrix columns by those barcode bases.  samples rows carry
    `overhang_ids`: '|'-separated overhang sequences (or ids resolved
    upstream)."""
    filtered = CountMatrix.load_h5(
        os.path.join(count_out_dir, "filtered_feature_bc_matrix.h5"))
    if chem.overhang is None:
        raise ValueError(f"chemistry {chem.name} has no overhang segment")
    o0 = chem.overhang.offset
    o1 = o0 + chem.overhang.length
    oh_to_sample = {}
    for row in samples:
        for oid in row.get("overhang_ids", "").split("|"):
            if oid:
                oh_to_sample[oid.strip().upper()] = row["sample_id"]

    per_sample_cols: dict[str, list[int]] = {}
    rows_csv = []
    for ci, bc in enumerate(filtered.barcodes):
        s = bc.decode()
        oh = s[o0:o1]
        rows_csv.append((s, oh))
        if oh in oh_to_sample:
            per_sample_cols.setdefault(oh_to_sample[oh], []).append(ci)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "overhang_assignments.csv"), "w") as f:
        f.write("barcode,overhang,sample\n")
        for s, oh in rows_csv:
            f.write(f"{s},{oh},{oh_to_sample.get(oh, 'unassigned')}\n")
    summary = dict(samples={}, n_unassigned=sum(
        1 for _, oh in rows_csv if oh not in oh_to_sample))
    for sample_id, cols in per_sample_cols.items():
        sub = filtered.select_barcodes(np.asarray(cols))
        sdir = os.path.join(out_dir, "per_sample_outs", sample_id)
        write_sample_outs(sub, sdir, sample_id,
                          count_out_dir=count_out_dir, device=device)
        summary["samples"][sample_id] = len(cols)
    return summary


def demux_probe_samples(count_out_dir: str, samples: list[dict],
                        probe_barcode_csv: str, out_dir: str,
                        *, device) -> dict:
    """RTL (MFRP) sample demux — DEMUX_PROBE_BC_MATRIX analog
    (mro/rna/_basic_sc_rna_counter.mro:233): the probe barcode is PART of
    the cell barcode (last probe_bc_len bases before the gem-group suffix),
    so demux is a deterministic split of the filtered matrix columns by the
    probe component; samples map probe_barcode_ids ('|'-separated)."""
    from ..io.probe_bc import load_probe_barcodes
    from ..ops import encode

    filtered = CountMatrix.load_h5(
        os.path.join(count_out_dir, "filtered_feature_bc_matrix.h5"))
    ids, packed, plen = load_probe_barcodes(probe_barcode_csv)
    seq_to_id = {
        encode.decode_codes(encode.unpack_np(np.uint32(p), plen)).decode(): i
        for i, p in zip(ids, packed)}
    id_to_sample = {}
    for row in samples:
        for pid in row.get("probe_barcode_ids", "").split("|"):
            if pid:
                id_to_sample[pid.strip()] = row["sample_id"]

    # the count pipeline wrote barcodes as gel ++ probe ++ "-<gem>"
    per_sample_cols: dict[str, list[int]] = {}
    rows_csv = []
    for ci, bc in enumerate(filtered.barcodes):
        s = bc.decode()
        core = s.rsplit("-", 1)[0]
        pid = seq_to_id.get(core[-plen:], "unknown")
        rows_csv.append((s, pid))
        if pid in id_to_sample:
            per_sample_cols.setdefault(id_to_sample[pid], []).append(ci)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "probe_assignments.csv"), "w") as f:
        f.write("barcode,probe_barcode_id,sample\n")
        for s, pid in rows_csv:
            f.write(f"{s},{pid},{id_to_sample.get(pid, 'unassigned')}\n")
    summary = dict(samples={}, n_unassigned=sum(
        1 for _, p in rows_csv if p not in id_to_sample))
    for sample_id, cols in per_sample_cols.items():
        sub = filtered.select_barcodes(np.asarray(cols))
        sdir = os.path.join(out_dir, "per_sample_outs", sample_id)
        write_sample_outs(sub, sdir, sample_id,
                          count_out_dir=count_out_dir, device=device)
        summary["samples"][sample_id] = len(cols)
    return summary
