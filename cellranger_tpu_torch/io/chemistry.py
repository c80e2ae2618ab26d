"""Chemistry registry: read-component geometry for 10x assay chemistries.

Re-expresses the factual geometry constants of the reference's chemistry
registry (lib/rust/cr_types/src/chemistry/chemistry_defs.json and enum
ChemistryName at cr_types/src/chemistry/mod.rs:175) in our own model:
a chemistry is a set of typed spans over the physical reads (R1/R2/I1/I2),
naming where the cell barcode, UMI, and cDNA ("rna") live, which whitelist
constrains the barcode, and library strandedness/endedness.

Verbatim copy of cellranger_tpu/io/chemistry.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    """A located component on a physical read. length None = to end of read."""

    read: str  # "R1" | "R2" | "I1" | "I2"
    offset: int
    length: int | None
    min_length: int | None = None


@dataclass(frozen=True)
class BarcodeSegment:
    span: Span
    whitelist: str  # named whitelist (resolved by io.whitelist)
    kind: str = "gel_bead"  # gel_bead | overhang | probe (RTL sample bc)


@dataclass(frozen=True)
class Chemistry:
    name: str
    description: str
    barcode: tuple[BarcodeSegment, ...]
    umi: Span
    rna: Span
    rna2: Span | None = None  # paired-end cDNA mate (5' PE)
    strandedness: str = "+"  # read orientation vs transcript: + sense, - antisense
    endedness: str = "three_prime"  # three_prime | five_prime
    # RTL multiplexing: per-sample probe barcode segment (chemistry_defs.json
    # MFRP-RNA "right_probe": R2 offset 68 len 8). Kept separate from the
    # gel-bead barcode; downstream forms the product barcode space.
    probe_bc: Span | None = None
    # named whitelist constraining the probe barcode (MFRP variants each
    # carry their own probe-barcode set, chemistry_defs.json)
    probe_bc_whitelist: str | None = None
    # OH multiplexing: the overhang sample barcode is a VIEW into the
    # gel-bead barcode (R1[7:9] in every *-OH def) used for sample demux;
    # it does not extend the barcode length
    overhang: Span | None = None

    @property
    def barcode_length(self) -> int:
        return sum(b.span.length for b in self.barcode)

    @property
    def umi_length(self) -> int:
        return self.umi.length

    @property
    def umi_min_length(self) -> int:
        return self.umi.min_length if self.umi.min_length is not None else self.umi.length


def _gb(whitelist: str, length: int = 16, read: str = "R1", offset: int = 0):
    return (BarcodeSegment(Span(read, offset, length), whitelist),)


_R = "737K-august-2016"  # 3'v2 + 5' gel-bead whitelist
_V3 = "3M-february-2018"  # 3'v3
_V4 = "3M-3pgex-may-2023"  # 3'v4
_FRP = "737K-fixed-rna-profiling"  # RTL
_ARC = "737K-arc-v1"  # multiome GEX

# Geometry facts per chemistry_defs.json; field-by-field semantics match the
# reference (barcode/umi/rna spans, whitelist names, strandedness, endedness).
CHEMISTRY_DEFS: dict[str, Chemistry] = {}


def _reg(c: Chemistry):
    CHEMISTRY_DEFS[c.name] = c
    return c


_V5P3 = "3M-5pgex-jan-2023"  # 5' v3 gel-bead whitelist
_OH = Span("R1", 7, 2)  # overhang sample barcode view (all *-OH defs)

# ---- 3' gene expression family ----
_reg(Chemistry("SC3Pv1", "Single Cell 3' v1",
               _gb("737K-april-2014_rc", length=14, read="I1"),
               umi=Span("R2", 0, 10), rna=Span("R1", 0, None),
               strandedness="+"))
_reg(Chemistry("SC3Pv2", "Single Cell 3' v2", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv3", "Single Cell 3' v3", _gb(_V3),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv3LT", "Single Cell 3' v3 LT", _gb("9K-LT-march-2021"),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv3HT", "Single Cell 3' v3 HT", _gb("3M-february-2018"),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv4", "Single Cell 3' v4", _gb(_V4),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv4HT", "Single Cell 3' v4 HT", _gb(_V4),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SC3Pv3-OH", "Single Cell 3' v3 OH", _gb(_V3),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None),
               strandedness="+", overhang=_OH))
_reg(Chemistry("SC3Pv4-OH", "Single Cell 3' v4 OH", _gb(_V4),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None),
               strandedness="+", overhang=_OH))

# ---- 5' gene expression family ----
_reg(Chemistry("SC5P-PE", "Single Cell 5' PE", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R1", 26, None),
               rna2=Span("R2", 0, None), strandedness="+", endedness="five_prime"))
_reg(Chemistry("SC5P-PE-v3", "Single Cell 5' PE v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R1", 28, None),
               rna2=Span("R2", 0, None), strandedness="+", endedness="five_prime"))
_reg(Chemistry("SC5P-R2", "Single Cell 5' R2-only", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SC5P-R2-v3", "Single Cell 5' R2-only v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SC5P-R2-OH", "Single Cell 5' R2-only OH", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime", overhang=_OH))
_reg(Chemistry("SC5P-R2-OH-v3", "Single Cell 5' R2-only OH v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime", overhang=_OH))
_reg(Chemistry("SC5P-R1", "Single Cell 5' R1-only", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R1", 41, None),
               strandedness="+", endedness="five_prime"))
_reg(Chemistry("SC5P-R1-v3", "Single Cell 5' R1-only v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R1", 43, None),
               strandedness="+", endedness="five_prime"))
_reg(Chemistry("SC5PHT", "Single Cell 5' HT", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SC5PHT-v3", "Single Cell 5' HT v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SC-FB", "Single Cell 3' v2 or 5' Feature Barcode", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))

# ---- RTL (fixed RNA profiling) family ----
_reg(Chemistry("SFRP", "Fixed RNA Profiling (Singleplex)", _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 30),
               strandedness="-", endedness="three_prime"))
_reg(Chemistry("MFRP-RNA", "Fixed RNA Profiling (Multiplexed)", _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 50),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 68, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-rna"))
CHEMISTRY_DEFS["MFRP"] = CHEMISTRY_DEFS["MFRP-RNA"]  # common alias
_reg(Chemistry("MFRP-Ab", "Fixed RNA Profiling (Antibody)", _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 50),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 68, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-ab"))
_reg(Chemistry("MFRP-RNA-R1", "Fixed RNA Profiling (probe barcode on R1)",
               _gb(_FRP),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, 50, 30),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R1", 40, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-rna-r1"))
_reg(Chemistry("MFRP-Ab-R1",
               "Fixed RNA Profiling (Antibody, probe barcode on R1)",
               _gb(_FRP),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, 50, 30),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R1", 40, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-ab-r1"))
_reg(Chemistry("MFRP-R1-48-uncollapsed",
               "Fixed RNA profiling (probeBC on R1, 192 uncollapsed)",
               _gb(_FRP),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, 50, 30),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R1", 40, 8),
               probe_bc_whitelist=
               "probe-barcodes-fixed-rna-profiling-r1-48-uncollapsed"))
_reg(Chemistry("MFRP-47", "Fixed RNA profiling (47 probe barcodes)",
               _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 50),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 68, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-47"))
_reg(Chemistry("MFRP-uncollapsed",
               "Multiplex fixed RNA profiling (uncollapsed barcodes)",
               _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 50),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 68, 8),
               probe_bc_whitelist=
               "probe-barcodes-fixed-rna-profiling-uncollapsed"))
_reg(Chemistry("MFRP-Ab-R2pos50",
               "Fixed RNA Profiling (Antibody, probe barcode at R2:50)",
               _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, 50, 50),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 49, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-ab"))
_reg(Chemistry("MFRP-CRISPR", "Fixed RNA Profiling (CRISPR)", _gb(_FRP),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="three_prime",
               probe_bc=Span("R2", 0, 8),
               probe_bc_whitelist="probe-barcodes-fixed-rna-profiling-crispr"))

# ---- multiome / V(D)J ----
_reg(Chemistry("ARC-v1", "Multiome GEX", _gb(_ARC),
               umi=Span("R1", 16, 12, 10), rna=Span("R2", 0, None), strandedness="+"))
_reg(Chemistry("SCVDJ", "Single Cell V(D)J", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R1", 41, None),
               rna2=Span("R2", 0, None), strandedness="+", endedness="five_prime"))
_reg(Chemistry("SCVDJ-v3", "Single Cell V(D)J v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R1", 43, None),
               rna2=Span("R2", 0, None), strandedness="+", endedness="five_prime"))
_reg(Chemistry("SCVDJ-R2", "Single Cell V(D)J R2-only", _gb(_R),
               umi=Span("R1", 16, 10), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SCVDJ-R2-v3", "Single Cell V(D)J R2-only v3", _gb(_V5P3),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, None),
               strandedness="-", endedness="five_prime"))
_reg(Chemistry("SCVDJ-Splint-R2-FRP", "Splint ligation for VDJ FRP R2-only",
               _gb(_FRP),
               umi=Span("R1", 16, 12), rna=Span("R2", 0, None),
               strandedness="+", endedness="three_prime"))


def get_chemistry(name: str) -> Chemistry:
    try:
        return CHEMISTRY_DEFS[name]
    except KeyError:
        raise ValueError(
            f"unknown chemistry {name!r}; known: {sorted(CHEMISTRY_DEFS)}"
        ) from None
