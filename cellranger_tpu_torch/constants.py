"""Global algorithm constants.

Each constant cites the reference location that defines the behavior we match
(reference = Schaudge/cellranger; cited as file:line).

Verbatim copy of cellranger_tpu/constants.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

# Base codes. A<C<G<T so that MSB-first 2-bit packing preserves byte-wise
# lexicographic order of ACGT strings (the reference compares UMI/barcode
# sequences byte-lexicographically, e.g. tx_annotation/src/mark_dups.rs:44).
BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
BASE_N = 4  # host-side sentinel; device arrays carry an explicit N mask

# Barcode correction (lib/rust/barcode/src/corrector.rs)
BARCODE_CONFIDENCE_THRESHOLD = 0.975  # corrector.rs:83
BC_MAX_QV = 66  # Illumina max quality value used in correction, corrector.rs:8
ILLUMINA_QUAL_OFFSET = 33  # corrector.rs:169-173

# Minimum reads for a corrected barcode candidate to count (the reference
# applies Laplace +1 smoothing to whitelist counts; corrector.rs:138-141).

# Alignment (lib/rust/cr_lib/src/stages/align_and_count.rs)
HIGH_CONF_MAPQ = 255  # cr_types/src/rna_read.rs:32
DEFAULT_ALIGN_SCORE_MIN = 30  # align_and_count.rs:63 (--outFilterScoreMin=30)
MAX_ALIGN_MAPQ_LOCI = {1: 255, 2: 3, 3: 1, 4: 1}  # >4 loci -> MAPQ 0 (STAR rule)

# Alignment scoring, matching STAR defaults used by the reference build:
# match +1, mismatch -1, gap open -2 (STAR scoreGapNoncan aside), gap extend -2.
SW_MATCH_SCORE = 1
SW_MISMATCH_SCORE = -1
SW_GAP_OPEN = -2
SW_GAP_EXTEND = -2

# Annotation (lib/rust/tx_annotation/src/transcript.rs)
REGION_MIN_OVERLAP = 0.5  # fraction of read bases inside exons to call exonic
# (transcript.rs: AnnotationParams.region_min_overlap used by annotate_alignment)

# Cell calling (lib/python/cellranger/cell_calling*.py)
ORDMAG_NUM_BOOTSTRAP = 100  # cell_calling_helpers.py ordmag bootstrap count
ORDMAG_QUANTILE = 0.99
ORDMAG_RATIO = 10.0  # cutoff = count at 99th pct index / 10
EMPTYDROPS_MIN_UMI = 500  # cell_calling.py: min UMIs for candidate barcodes
EMPTYDROPS_FDR = 0.01
EMPTYDROPS_NUM_SIMS = 10000
N_PARTITIONS_3P = 90000  # cell_calling.py:122-141 (chemistry-dependent)
N_PARTITIONS_5P = 90000
N_PARTITIONS_V1 = 9000

# Chemistry detection
DETECT_CHEMISTRY_MIN_READS = 10000  # cr_lib/src/stages/detect_chemistry.rs:44

# Default read batch geometry for the device pipeline (fixed shapes for XLA).
DEFAULT_READ_LEN = 128  # padded read length in bases
DEFAULT_BATCH_READS = 4096  # reads per device batch

# UMI
UMI_MIN_READ_LENGTH_DEFAULT = 10  # chemistry min_length semantics

# BAM tag names (lib/rust/cr_bam/src/bam_tags.rs:3-39)
TAG_CB = "CB"  # corrected cell barcode (+ gem group suffix)
TAG_CR = "CR"  # raw barcode sequence
TAG_CY = "CY"  # barcode quality
TAG_UB = "UB"  # corrected UMI
TAG_UR = "UR"  # raw UMI
TAG_UY = "UY"  # UMI quality
TAG_GX = "GX"  # gene ids (semicolon sep)
TAG_GN = "GN"  # gene names
TAG_TX = "TX"  # transcript alignments
TAG_AN = "AN"  # antisense transcript alignments
TAG_RE = "RE"  # region: E (exonic), N (intergenic), I (intronic)
TAG_XF = "xf"  # extra flags bitmask
TAG_MM = "mm"  # multi-mapper flag
TAG_FB = "fb"  # corrected feature barcode
TAG_FR = "fr"  # raw feature barcode
TAG_FQ = "fq"  # feature barcode quality
TAG_FX = "fx"  # feature ids
TAG_LI = "li"  # library index
TAG_PR = "pr"  # probe id

# xf bitmask flags (cr_bam/src/bam_tags.rs)
# xf ExtraFlags, exact reference values (cr_bam/src/bam_tags.rs:41-59)
XF_UMI_COUNT = 8  # read counted as a UMI (representative read)
XF_LOW_SUPPORT_UMI = 2
XF_FILTERED_TARGET_UMI = 32
XF_CONF_MAPPED = 1  # confidently mapped to transcriptome

# Matrix H5 (lib/python/cellranger/matrix.py:70-79, h5_constants.py:25-45)
MATRIX_H5_VERSION = 2
MATRIX_H5_FILETYPE = "matrix"
