"""Web summary: single-file HTML run report.

The reference inlines a React bundle + JSON data into web_summary.html
(lib/python/websummary/summarize.py:20-43, cr_websummary tab constructors). In a
zero-dependency re-design we emit self-contained HTML with inline CSS and
hand-rolled SVG charts (barcode rank plot, embedding scatter) plus the
metric tables the reference shows (sequencing, mapping, cells, analysis).

Verbatim copy of cellranger_tpu/pipeline/websummary.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import html
import json
import os

import numpy as np

CSS = """
.alerts{margin:12px 0}
.alert{padding:10px 14px;border-radius:6px;margin:6px 0;font-size:14px}
.alert.warn{background:#fff6e0;border:1px solid #e8c76a;color:#6b5410}
.alert.error{background:#fde8e8;border:1px solid #e07a7a;color:#7a1f1f}

body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif;
       margin: 0; background: #f6f7f9; color: #1e2430; }
.header { background: #14365c; color: white; padding: 18px 32px; }
.header h1 { margin: 0; font-size: 20px; font-weight: 600; }
.header .sub { opacity: .75; font-size: 13px; margin-top: 4px; }
.wrap { max-width: 1100px; margin: 24px auto; padding: 0 16px; }
.cards { display: flex; gap: 16px; flex-wrap: wrap; margin-bottom: 24px; }
.card { background: white; border-radius: 8px; padding: 18px 22px;
        box-shadow: 0 1px 3px rgba(20,30,50,.08); flex: 1; min-width: 180px; }
.card .big { font-size: 28px; font-weight: 700; color: #14365c; }
.card .label { font-size: 12px; color: #66707f; margin-top: 4px;
               text-transform: uppercase; letter-spacing: .04em; }
.panel { background: white; border-radius: 8px; padding: 20px 24px;
         box-shadow: 0 1px 3px rgba(20,30,50,.08); margin-bottom: 24px; }
.panel h2 { font-size: 15px; margin: 0 0 12px; color: #14365c; }
table.metrics { border-collapse: collapse; width: 100%; font-size: 13px; }
table.metrics td { padding: 6px 10px; border-bottom: 1px solid #eef0f3; }
table.metrics td:last-child { text-align: right; font-variant-numeric:
                              tabular-nums; font-weight: 600; }
.row { display: flex; gap: 24px; flex-wrap: wrap; }
.row > div { flex: 1; min-width: 320px; }
.footnote { color: #8a93a2; font-size: 11px; margin: 16px 0 40px; }
"""

CLUSTER_COLORS = ["#4472c4", "#ed7d31", "#70ad47", "#ffc000", "#5b9bd5",
                  "#c00000", "#7030a0", "#2e75b6", "#548235", "#bf9000",
                  "#264478", "#9e480e", "#43682b", "#7f6000", "#255e91"]


def _fmt(v, pct=False):
    if v is None:
        return "—"
    if pct:
        return f"{100 * v:.1f}%"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:,.2f}"
    return f"{int(v):,}"


def _table(rows):
    out = ['<table class="metrics">']
    for name, val in rows:
        out.append(f"<tr><td>{html.escape(str(name))}</td>"
                   f"<td>{html.escape(str(val))}</td></tr>")
    out.append("</table>")
    return "".join(out)


# QC alert thresholds — the cr_websummary alert system analog
# (lib/rust/cr_websummary/src/alert.rs): each rule yields a WARN/ERROR
# banner in the summary when its metric crosses the threshold.
ALERT_RULES = [
    ("valid_barcode_frac", "<", 0.75, "error",
     "Fraction of valid barcodes is very low",
     "Check the barcode whitelist and chemistry setting."),
    ("valid_barcode_frac", "<", 0.85, "warn",
     "Fraction of valid barcodes is low",
     "May indicate sequencing quality or chemistry mismatch."),
    ("conf_mapped_frac", "<", 0.30, "warn",
     "Low fraction of reads confidently mapped to transcriptome",
     "Check that the reference matches the sample species."),
    ("antisense_frac", ">", 0.10, "warn",
     "High fraction of antisense reads",
     "May indicate an unsupported chemistry orientation."),
    ("reads_in_cells_frac", "<", 0.70, "warn",
     "Low fraction of reads in cells",
     "High ambient RNA or failed cell calling."),
    ("q30_rna_frac", "<", 0.65, "warn",
     "Low Q30 base fraction in RNA reads",
     "Sequencing quality issue."),
    ("q30_barcode_frac", "<", 0.55, "warn",
     "Low Q30 base fraction in barcodes",
     "Sequencing quality issue."),
    ("estimated_cells", "<", 100, "warn",
     "Very few cells detected",
     "Sample quality or cell-calling issue."),
    ("estimated_cells", ">", 100_000, "warn",
     "Unusually many cells detected",
     "Possible barcode whitelist or multiplet issue."),
]


def alerts_for(m: dict) -> list[dict]:
    """Evaluate ALERT_RULES against a metrics dict; first matching rule per
    metric wins (error outranks warn by ordering)."""
    out, seen = [], set()
    for key, op, thr, level, title, detail in ALERT_RULES:
        v = m.get(key)
        if v is None or key in seen:
            continue
        hit = v < thr if op == "<" else v > thr
        if hit:
            seen.add(key)
            out.append(dict(level=level, title=title, detail=detail,
                            metric=key, value=v, threshold=thr))
    return out


def line_svg(xs, ys, title: str, xlabel: str, ylabel: str,
             w=440, h=320, ymax_hint=None) -> str:
    """Simple line chart (saturation / genes-per-cell curves)."""
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    if len(xs) == 0:
        return "<svg/>"
    xmax = max(xs.max(), 1e-9)
    ymax = max(ys.max() if ymax_hint is None else ymax_hint, 1e-9)
    pad = 46

    def X(x):
        return pad + (x / xmax) * (w - pad - 12)

    def Y(y):
        return h - 30 - (y / ymax) * (h - 44)

    pts = "M" + " L".join(f"{X(x):.1f} {Y(y):.1f}" for x, y in zip(xs, ys))
    ticks = []
    for f in (0.0, 0.5, 1.0):
        ticks.append(f'<text x="{X(f * xmax):.0f}" y="{h-12}" font-size="10" '
                     f'fill="#66707f" text-anchor="middle">{f * xmax:.2g}</text>')
        ticks.append(f'<text x="{pad-6}" y="{Y(f * ymax)+3:.0f}" font-size="10" '
                     f'fill="#66707f" text-anchor="end">{f * ymax:.2g}</text>')
    return f"""<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}">
<rect width="{w}" height="{h}" fill="white"/>
<path d="{pts}" stroke="#4472c4" stroke-width="2.5" fill="none"/>
{''.join(ticks)}
<text x="{w/2}" y="{h-1}" font-size="11" fill="#444" text-anchor="middle">{html.escape(xlabel)}</text>
<text x="12" y="{h/2}" font-size="11" fill="#444" transform="rotate(-90 12 {h/2})" text-anchor="middle">{html.escape(ylabel)}</text>
<text x="{w/2}" y="14" font-size="12" fill="#222" text-anchor="middle">{html.escape(title)}</text>
</svg>"""


def barcode_rank_svg(umis_per_bc: np.ndarray, n_cells: int,
                     w=440, h=320) -> str:
    """Log-log barcode rank plot with the cell fraction highlighted."""
    counts = np.sort(umis_per_bc[umis_per_bc > 0])[::-1]
    if len(counts) == 0:
        return "<svg/>"
    n = len(counts)
    # subsample for svg size
    idx = np.unique(np.clip(np.geomspace(1, n, 400).astype(int) - 1, 0, n - 1))
    xs = np.log10(idx + 1)
    ys = np.log10(counts[idx])
    xmax = max(np.log10(n), 1e-6)
    ymax = max(ys.max(), 1e-6)
    pad = 40

    def X(x):
        return pad + (x / xmax) * (w - pad - 12)

    def Y(y):
        return h - 30 - (y / ymax) * (h - 44)

    cell_pts = [(X(x), Y(y)) for x, y, i in zip(xs, ys, idx) if i < n_cells]
    bg_pts = [(X(x), Y(y)) for x, y, i in zip(xs, ys, idx) if i >= n_cells]
    def path(pts):
        if not pts:
            return ""
        return "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
    axes = []
    for e in range(int(np.ceil(xmax)) + 1):
        axes.append(f'<text x="{X(e):.0f}" y="{h-12}" font-size="10" '
                    f'fill="#66707f" text-anchor="middle">10^{e}</text>')
    for e in range(int(np.ceil(ymax)) + 1):
        axes.append(f'<text x="{pad-6}" y="{Y(e)+3:.0f}" font-size="10" '
                    f'fill="#66707f" text-anchor="end">10^{e}</text>')
    return f"""<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}">
<rect width="{w}" height="{h}" fill="white"/>
<path d="{path(cell_pts)}" stroke="#4472c4" stroke-width="2.5" fill="none"/>
<path d="{path(bg_pts)}" stroke="#c3c9d4" stroke-width="2" fill="none"/>
{''.join(axes)}
<text x="{w/2}" y="{h-1}" font-size="11" fill="#444" text-anchor="middle">Barcode rank</text>
<text x="12" y="{h/2}" font-size="11" fill="#444" transform="rotate(-90 12 {h/2})" text-anchor="middle">UMI counts</text>
</svg>"""


def scatter_svg(xy: np.ndarray, labels: np.ndarray, title: str,
                w=440, h=360) -> str:
    if len(xy) == 0:
        return "<svg/>"
    mn = xy.min(axis=0)
    mx = xy.max(axis=0)
    span = np.maximum(mx - mn, 1e-9)
    pts = []
    for (x, y), c in zip(xy, labels):
        px = 20 + (x - mn[0]) / span[0] * (w - 40)
        py = h - 40 - (y - mn[1]) / span[1] * (h - 60)
        color = CLUSTER_COLORS[(int(c) - 1) % len(CLUSTER_COLORS)]
        pts.append(f'<circle cx="{px:.1f}" cy="{py:.1f}" r="2.4" '
                   f'fill="{color}" fill-opacity="0.75"/>')
    legend = []
    for i, c in enumerate(sorted(set(int(l) for l in labels))[:15]):
        color = CLUSTER_COLORS[(c - 1) % len(CLUSTER_COLORS)]
        legend.append(
            f'<circle cx="{24 + (i % 8) * 52}" cy="{h - 14 - (i // 8) * 14}" r="4" fill="{color}"/>'
            f'<text x="{31 + (i % 8) * 52}" y="{h - 10 - (i // 8) * 14}" font-size="10" fill="#444">{c}</text>')
    return f"""<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}">
<rect width="{w}" height="{h}" fill="white"/>
{''.join(pts)}
{''.join(legend)}
<text x="{w/2}" y="14" font-size="12" fill="#14365c" text-anchor="middle" font-weight="600">{html.escape(title)}</text>
</svg>"""


def _read_projection(path):
    if not os.path.exists(path):
        return None, None
    rows = open(path).read().strip().splitlines()[1:]
    bcs, xy = [], []
    for r in rows:
        parts = r.split(",")
        bcs.append(parts[0])
        xy.append([float(parts[1]), float(parts[2])])
    return bcs, np.asarray(xy)


def _read_clusters(path):
    if not os.path.exists(path):
        return None
    return {r.split(",")[0]: int(r.split(",")[1])
            for r in open(path).read().strip().splitlines()[1:]}


def build_web_summary(out_dir: str, sample_id: str = "sample",
                      pipeline: str = "count") -> str:
    """Assemble web_summary.html from the run outputs in out_dir."""
    with open(os.path.join(out_dir, "metrics_summary.json")) as f:
        m = json.load(f)

    cards = [
        (_fmt(m.get("estimated_cells")), "Estimated cells"),
        (_fmt(m.get("mean_reads_per_cell")), "Mean reads per cell"),
        (_fmt(m.get("median_genes_per_cell")), "Median genes per cell"),
        (_fmt(m.get("median_umis_per_cell")), "Median UMIs per cell"),
    ]
    seq_rows = [
        ("Number of reads", _fmt(m.get("total_reads"))),
        ("Valid barcodes", _fmt(m.get("valid_barcode_frac"), pct=True)),
        ("Valid UMIs", _fmt(m.get("valid_umi_frac"), pct=True)),
        ("Sequencing saturation", _fmt(m.get("sequencing_saturation"), pct=True)),
    ]
    map_rows = [
        ("Reads mapped to genome", _fmt(m.get("mapped_frac"), pct=True)),
        ("Reads mapped confidently to transcriptome",
         _fmt(m.get("conf_mapped_frac"), pct=True)),
        ("Exonic reads", _fmt(m.get("exonic_reads"))),
        ("Intronic reads", _fmt(m.get("intronic_reads"))),
        ("Intergenic reads", _fmt(m.get("intergenic_reads"))),
        ("Antisense reads", _fmt(m.get("antisense_frac"), pct=True)),
    ]
    cell_rows = [
        ("Estimated number of cells", _fmt(m.get("estimated_cells"))),
        ("Fraction reads in cells", _fmt(m.get("reads_in_cells_frac"), pct=True)),
        ("Total genes detected", _fmt(m.get("total_genes_detected"))),
        ("Cell calling method", m.get("cells_method", "—")),
        ("Total molecules", _fmt(m.get("total_molecules"))),
    ]

    # QC alerts banner (cr_websummary alert.rs analog)
    alerts = alerts_for(m)
    alert_html = ""
    if alerts:
        items = "".join(
            f'<div class="alert {a["level"]}"><b>{html.escape(a["title"])}'
            f'</b> — {html.escape(a["detail"])} '
            f'({a["metric"]}={_fmt(a["value"])})</div>' for a in alerts)
        alert_html = f'<div class="alerts">{items}</div>'

    # depth-subsampling curves (SUBSAMPLE_READS plots)
    curves_html = ""
    sc = m.get("subsample_curves") or {}
    if sc:
        rates = sorted(float(r) for r in sc)
        reads = [sc[str(r)]["subsampled_reads"] for r in rates]
        sats = [sc[str(r)]["saturation"] for r in rates]
        genes = [sc[str(r)]["median_genes_per_cell"] for r in rates]
        curves_html = (
            "<div class='row'><div class='panel'>"
            + line_svg(reads, sats, "Sequencing saturation",
                       "Reads", "Saturation", ymax_hint=1.0)
            + "</div><div class='panel'>"
            + line_svg(reads, genes, "Median genes per cell",
                       "Reads", "Genes")
            + "</div></div>")

    # barcode rank plot from raw matrix
    rank_svg = "<svg/>"
    try:
        from ..io.matrix_io import CountMatrix
        raw = CountMatrix.load_h5(os.path.join(out_dir, "raw_feature_bc_matrix.h5"))
        rank_svg = barcode_rank_svg(raw.counts_per_bc(),
                                    int(m.get("estimated_cells", 0)))
    except Exception:
        pass

    # embedding scatter colored by graphclust
    analysis_html = ""
    adir = os.path.join(out_dir, "analysis")
    clusters = _read_clusters(os.path.join(adir, "clustering", "graphclust",
                                           "clusters.csv"))
    for name, sub in (("t-SNE", "tsne"), ("UMAP", "umap")):
        bcs, xy = _read_projection(os.path.join(adir, sub, "2_components",
                                                "projection.csv"))
        if bcs and clusters:
            labels = np.asarray([clusters.get(b, 1) for b in bcs])
            analysis_html += f"<div>{scatter_svg(xy, labels, f'{name} — graph clusters')}</div>"

    page = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(sample_id)} — cellranger-tpu {pipeline}</title>
<style>{CSS}</style></head><body>
<div class="header"><h1>{html.escape(sample_id)}</h1>
<div class="sub">cellranger-tpu {pipeline} · {html.escape(str(m.get('chemistry', '')))}</div></div>
<div class="wrap">
{alert_html}
<div class="cards">{''.join(f'<div class="card"><div class="big">{v}</div><div class="label">{l}</div></div>' for v, l in cards)}</div>
<div class="row">
<div class="panel"><h2>Sequencing</h2>{_table(seq_rows)}</div>
<div class="panel"><h2>Mapping</h2>{_table(map_rows)}</div>
</div>
<div class="row">
<div class="panel"><h2>Cells</h2>{_table(cell_rows)}</div>
<div class="panel"><h2>Barcode rank</h2>{rank_svg}</div>
</div>
{curves_html}
{f'<div class="panel"><h2>Clustering</h2><div class="row">{analysis_html}</div></div>' if analysis_html else ''}
<div class="footnote">Generated by cellranger-tpu 0.1.0 — a TPU-native
single-cell engine. Metrics definitions follow the reference pipeline.</div>
</div></body></html>"""
    out_path = os.path.join(out_dir, "web_summary.html")
    with open(out_path, "w") as f:
        f.write(page)
    return out_path
