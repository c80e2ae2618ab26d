"""`multi` config CSV parsing (the multi crate analog,
lib/rust/multi/src/config/mod.rs: sectioned INI-ish CSV with
[gene-expression] / [feature] / [vdj] / [libraries] / [samples] sections).

Supported today: gene-expression params (reference, probe-set, expect/force
cells, chemistry), feature reference, vdj reference, libraries rows
(fastq_id, fastqs, feature_types), and [samples]-driven CMO demultiplexing
(JIBES tag model -> per-sample matrices, pipeline.demux).

Copy of cellranger_tpu/io/multi_config.py with a keyword `device` passed down
to the port's run_count, run_vdj and the demux stages, which need one.
"""

from __future__ import annotations

from dataclasses import dataclass, field


KNOWN_SECTIONS = {"gene-expression", "feature", "vdj", "libraries",
                  "samples", "antigen-specificity"}

LIBRARY_TYPES = {
    "gene expression": "Gene Expression",
    "antibody capture": "Antibody Capture",
    "crispr guide capture": "CRISPR Guide Capture",
    "multiplexing capture": "Multiplexing Capture",
    "vdj": "VDJ",
    "vdj-t": "VDJ-T",
    "vdj-b": "VDJ-B",
}


@dataclass
class MultiConfig:
    gene_expression: dict = field(default_factory=dict)
    feature: dict = field(default_factory=dict)
    vdj: dict = field(default_factory=dict)
    libraries: list[dict] = field(default_factory=list)
    samples: list[dict] = field(default_factory=list)
    # [antigen-specificity] rows: control_id (+ optional mhc_allele) per
    # antigen feature (multi/src/config/mod.rs:2164 AntigenSpecificityRow)
    antigen_specificity: list[dict] = field(default_factory=list)

    @staticmethod
    def from_csv(path: str) -> "MultiConfig":
        cfg = MultiConfig()
        section = None
        header: list[str] | None = None
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                first = line.split(",")[0].strip().lower()
                if first.startswith("[") and first.endswith("]"):
                    name = first[1:-1]
                    if name not in KNOWN_SECTIONS:
                        raise ValueError(f"unknown section [{name}] in multi config")
                    section = name
                    header = None
                    continue
                if section is None:
                    raise ValueError(
                        f"content before any [section] in multi config: {line!r}")
                cells = [c.strip() for c in line.split(",")]
                if section in ("gene-expression", "feature", "vdj"):
                    key = cells[0].strip().lower().replace("_", "-")
                    val = cells[1] if len(cells) > 1 else ""
                    getattr(cfg, section.replace("-", "_"))[key] = val
                else:
                    if header is None:
                        header = [c.lower() for c in cells]
                        continue
                    row = dict(zip(header, cells))
                    if section == "antigen-specificity":
                        if "control_id" not in row:
                            raise ValueError(
                                "[antigen-specificity] rows need a "
                                "control_id column")
                        cfg.antigen_specificity.append(row)
                    elif section == "libraries":
                        ft = row.get("feature_types", "Gene Expression")
                        canon = LIBRARY_TYPES.get(ft.strip().lower())
                        if canon is None:
                            raise ValueError(f"unknown feature_types {ft!r}")
                        row["feature_types"] = canon
                        cfg.libraries.append(row)
                    else:
                        cfg.samples.append(row)
        if not cfg.libraries:
            raise ValueError("multi config must declare a [libraries] section")
        for row in cfg.libraries:
            if "fastqs" not in row or "fastq_id" not in row:
                raise ValueError(
                    "[libraries] rows need fastq_id and fastqs columns")
        return cfg


def run_multi(config_csv: str, out_dir: str, whitelist_path: str,
              read_len: int = 91, batch_size: int = 8192,
              sample_id: str = "multi", *, device) -> dict:
    """Execute a multi config on `device`: count for GEX(+FB) libraries,
    vdj for VDJ libraries (SC_MULTI_CS analog, mro/rna/sc_multi_cs.mro:173)."""
    import os

    from ..io.fastq import find_fastqs
    from ..pipeline.count import CountConfig, LibraryDef, run_count

    cfg = MultiConfig.from_csv(config_csv)
    gex = cfg.gene_expression
    summary: dict = {}

    count_libs = []
    vdj_libs = []
    for row in cfg.libraries:
        pairs = find_fastqs(row["fastqs"], sample=row.get("fastq_id") or None)
        if not pairs:
            raise FileNotFoundError(
                f"no FASTQs for library {row.get('fastq_id')} in {row['fastqs']}")
        if row["feature_types"].startswith("VDJ"):
            vdj_libs.append((row, pairs))
        else:
            count_libs.append(LibraryDef(pairs, row["feature_types"]))

    if count_libs:
        ccfg = CountConfig(
            fastq_pairs=[], libraries=count_libs,
            reference_path=gex.get("reference") or None,
            probe_set_csv=gex.get("probe-set") or None,
            feature_ref_csv=cfg.feature.get("reference") or None,
            whitelist_path=whitelist_path,
            chemistry=gex.get("chemistry", "SC3Pv3"),
            recovered_cells=int(gex["expect-cells"]) if gex.get("expect-cells") else None,
            force_cells=int(gex["force-cells"]) if gex.get("force-cells") else None,
            probe_barcode_csv=gex.get("probe-barcode-set") or None,
            read_len=read_len, batch_size=batch_size, sample_id=sample_id)
        summary["count"] = run_count(ccfg, os.path.join(out_dir, "count"),
                                     device=device)

    # antigen specificity scoring ([antigen-specificity] + Antigen Capture
    # library; specificity.py beta-score semantics)
    if count_libs and cfg.antigen_specificity:
        from ..analysis.feature_assigner import antigen_specificity
        from .matrix_io import CountMatrix
        filt = CountMatrix.load_h5(os.path.join(
            out_dir, "count", "filtered_feature_bc_matrix.h5"))
        summary["antigen_specificity"] = antigen_specificity(
            filt, cfg.antigen_specificity,
            os.path.join(out_dir, "count", "antigen_analysis"))

    # CMO sample demux when a multiplexing library + [samples] are present
    if count_libs and cfg.samples and any(
            l.library_type == "Multiplexing Capture" for l in count_libs):
        from ..pipeline.demux import demux_samples
        summary["demux"] = demux_samples(
            os.path.join(out_dir, "count"), cfg.samples,
            os.path.join(out_dir, "demux"), device=device)

    # RTL probe-barcode sample demux ([samples] with probe_barcode_ids)
    if count_libs and cfg.samples and ccfg.probe_barcode_csv and any(
            r.get("probe_barcode_ids") for r in cfg.samples):
        from ..pipeline.demux import demux_probe_samples
        summary["demux_probe"] = demux_probe_samples(
            os.path.join(out_dir, "count"), cfg.samples,
            ccfg.probe_barcode_csv, os.path.join(out_dir, "demux"),
            device=device)

    for row, pairs in vdj_libs:
        from ..pipeline.vdj import VdjConfig, run_vdj
        vcfg = VdjConfig(
            fastq_pairs=pairs,
            vdj_reference_fasta=os.path.join(cfg.vdj.get("reference", ""),
                                             "fasta", "regions.fa")
            if os.path.isdir(cfg.vdj.get("reference", "")) else
            cfg.vdj.get("reference", ""),
            whitelist_path=whitelist_path, sample_id=sample_id)
        summary.setdefault("vdj", {})[row.get("fastq_id", "vdj")] = run_vdj(
            vcfg, os.path.join(out_dir, "vdj", row.get("fastq_id", "vdj")),
            device=device)

    # top-level combined summary + web summary (MULTI_WEBSUMMARY_BUILDER
    # analog, mro/rna/sc_multi_core.mro:346): flatten the per-pipeline
    # summaries into one metrics file at the run root
    import json
    flat: dict = {"sample_id": sample_id}
    for k, v in (summary.get("count") or {}).items():
        if not isinstance(v, (dict, list)):
            flat[k] = v
    for dkey in ("demux", "demux_probe"):
        d = summary.get(dkey)
        if d:
            for sname, n in d.get("samples", {}).items():
                flat[f"cells_{sname}"] = n
    for vid, vs in (summary.get("vdj") or {}).items():
        for k in ("estimated_cells", "n_clonotypes"):
            if k in vs:
                flat[f"vdj_{vid}_{k}"] = vs[k]
    with open(os.path.join(out_dir, "metrics_summary.json"), "w") as f:
        json.dump(flat, f, indent=2, default=float)
    from ..pipeline.websummary import build_web_summary
    try:
        build_web_summary(out_dir, sample_id, pipeline="multi")
    except Exception:
        pass
    return summary
