"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

  device       require CUDA; print the card, its capability and power limit
  build        compile the hand-written kernels (csrc/*.cu) and the native
               FASTQ reader from the checkout, into build/
  sw_kernel    the banded Smith-Waterman kernel against its plain torch
               version, all three outputs equal on every row: seeded random
               inputs at (B, L) = (8192, 91), (8191, 91), (1, 91),
               (2048, 91), (8192, 150), (257, 33); adversarial inputs at
               (8192, 91) (indels of 1-7 bases, fully masked reads, windows
               masked at either end, one base throughout); row slices whose
               codes and masks are aligned differently; B = 0.  Times at
               (8192, 91), (2048, 91), (8192, 150): the device time of a
               launch (CUDA events around a CUDA graph of 10 launches,
               median of 20, spread printed), the time of one eager call,
               the bound computed from the same shapes and the share of
               it reached; the plain version's time as information
  index_build  GenomeIndex.build with its kmer table built on cuda against
               the numpy build, every index.npz array equal, and
               DeviceIndex.build's text rows, overlapped rows and kmer
               bucket rows against the host tables: on the e2e fixture's
               genome (every/strand31) and on a seeded 64 Mb genome with
               N runs and 2,000 junction contigs forced to minimizer
               sampling and parity positions; both builds' seconds
  tiny_parity  the synthetic run through the default run_count (secondary
               analysis on) on cuda and on cpu: identical metrics (except
               wall_time_s) and MEX matrices; analysis/ under the
               tolerances of testing/analysis_check.py
  golden_tiny  the synthetic run with BAM on cuda against the checked-in
               snapshot tests/golden/e2e (metrics, MEX, BAM, barcode CSV,
               junctions, filtered_feature_bc_matrix.h5 and
               molecule_info.h5, both written by h5py there)
  golden_rich  the rich run (GEX + Antibody Capture, BAM) on cuda and on
               cpu against tests/golden/e2e_rich (the h5 files too);
               identical BAM bytes
  e2e          the 1M-read fixture through run_count on cuda at batch
               32768, secondary analysis on: read and molecule counts
               against the JAX package's values for this fixture, wall
               time, phase split (analysis_reporting apart), memory; the
               three h5 outputs (io/hdf5.py): size and seconds of each
               write, each read back to the arrays that were written
  e2e_bam      the whole 1M-read fixture with BAM (stream mode, spill +
               partition dedup, the BAM writer: native record encoder,
               BGZF on threads, an index built from arrays): every read
               confidently mapped, the molecules and MEX bytes of e2e's
               count-only run, a record at least for every read, the
               decompressed BAM's sha256 and record count the JAX
               package's (BAM_EXPECTED), and its .bai equal to what the
               copy's _write_bai builds from the records as laid out in
               the file; wall, bam_write and its split
               (pipeline.bam_out.LAST_SPLIT), records a second, bytes,
               peak host RSS and device memory
  bam_held     the first 50,000 reads with BAM, each BAM write made twice
               from one spool, by the plain writer (bam_out.write_plain:
               a record at a time through io/bam_index.py) and by the
               run's: .bam and .bai byte-equal; both writers' seconds
  overflow     the count-only e2e run with the device molecule state
               capped at 1 << 19 rows, which forces the host flush and the
               partition dedup: the same molecules and MEX bytes as e2e
  dedup_memory the partition dedup's device call (parallel/molecule_state.py
               _dedup_host) on seeded weighted rows at 2**20 and 2**22
               padded rows and at the port's limit, _pow2(count.
               DEDUP_CHUNK_LIMIT): peak device memory, seconds and bytes
               per padded row of each; the limit's call must stay within
               count.DEDUP_BUDGET_BYTES
  deep         20,000,000 reads of the e2e generator (10,000,000 molecules
               at 2 reads, 2,000 cells; 5.3 GB of FASTQ, deleted after)
               through run_count on cuda, count-only, batch 32768, at the
               real MOLECULE_STATE_CAP: the JAX package's reads, molecules,
               conf_mapped_frac and the sha256 of each decompressed MEX
               file (DEEP_EXPECTED); at least one flush of the molecule
               state at its cap; every dedup_molecules call within
               _pow2(DEDUP_CHUNK_LIMIT) padded rows; one K1 launch a step;
               peak device memory under DEEP_PEAK_BYTES; the three h5
               files read back; fixture seconds, wall, phase split,
               flushes, dedup calls, peak host RSS
  pe_parity    a small SC5P-PE run (4,096 pairs on the e2e reference, a
               tenth of them discordant, with BAM) on cuda and on cpu:
               identical metrics, MEX and BAM bytes; two SW launches a step
  pe           the full-width paired-end path: 1,000,000 read pairs
               (testing/fixtures.build_pe_run on the e2e genome, genes and
               whitelist), SC5P-PE, batch 32768, count-only: exactly the
               fixture's molecules, confidently mapped pairs and improper
               pairs; SW launches = 2 x batches; wall, phase split, memory
  rtl_parity   a small MFRP-RNA run on cuda and on cpu: identical metrics
               and MEX; the probe aligner alone on one batch of that run,
               all five outputs equal between the devices
  rtl          a probe run at the scale of a whole-transcriptome probe set
               (testing/fixtures.build_rtl_run: 54,000 probes of 50 bp over
               18,000 genes, 16 probe barcodes, 320,000 barcode columns,
               1,000,000 reads, batch 32768): exactly the fixture's usable
               reads, molecules and per-region reads; no SW launch; wall,
               phase split, memory, the probe aligner's device time a batch
  h5_pipelines the h5 readers and writers above count, on cuda:
               run_aggr over the e2e and overflow runs' molecule_info.h5
               (equal depth, so nothing is subsampled: twice e2e's
               molecules, each half of the raw matrix e2e's, GEM groups 1
               and 2); run_count_gem_wells over the first two of the e2e
               reads' four lanes (fixtures.split_lanes): the merged raw
               matrix is the wells' side by side, the merged
               molecule_info their rows; CLI reanalyze of e2e's
               filtered h5: 16 analysis/ files
  multi        run_multi of a Gene Expression + Multiplexing Capture config
               with [samples] on cuda: per-sample outputs present with 16
               analysis files and no secondary_analysis_error, every cell
               in the sample it was built for
  analysis     secondary analysis of a planted 8-population matrix
               (20,000 cells x 20,000 genes, the JAX package's
               max_cells_tsne) on cuda: 16 files, finite embeddings that
               separate the populations, stage times, peak memory, ms a
               t-SNE step and a UMAP epoch; TF32 must be off.  It runs in
               a child process (analysis_both) beside the phases from
               h5_pipelines to multi, next to depth_small; its line comes
               after flex_held's
  analysis_parity  cuda against cpu at 2,000 cells x 1,000 genes (the
               files, the clusterings of one projection, and the t-SNE/UMAP
               steps over a short horizon) under testing/analysis_check.py's
               tolerances; a second cuda run with identical analysis/ bytes.
               In analysis's child process, after it
  analysis_68k the same fixture at 68,579 cells (10x's "Fresh 68k PBMCs",
               past max_cells_tsne) written as a filtered h5 and analyzed
               by the CLI's reanalyze on cuda: 14 files, no tsne/ or
               umap/; graph clusters each within one planted population
               and k-means 8 agreeing with the populations on at least
               0.99 of the cells; each cluster's top 10 diff-exp genes
               among its population's markers; the kNN graph (k = 131)
               and aggr's cross-batch search (k = 20, the projection's
               halves) with no mismatch but near-ties against float64
               neighbours of 1,000 seeded rows, the search's device
               memory within graphclust.KNN_BLOCK_BYTES; stage and Louvain
               seconds, h5 write and read seconds, peak device memory and
               host RSS.  It runs in a child process (phase_beside)
               beside the phases from vdj_parity to human_scale, so its
               host seconds and theirs include each other's load on the
               machine's cores; its line comes after human_scale's
  cellplex     a CellPlex GEM well with an antibody panel at the width
               users run it (testing/fixtures.build_cellplex_run: 30,000
               cells superloaded, 12 CMOs and 12 samples, 17 TotalSeq-B
               antibodies with 20 planted protein aggregates, the
               6,794,880-barcode whitelist, 10,000,000 GEX, ~3,000,000
               CMO and ~3,000,000 antibody reads, 74% singlets, 24%
               two-tag multiplets, 2% blanks) through run_multi on cuda,
               batch 32768: the JAX package's reads, molecules, cells,
               MEX digests of the run and of every sample, tag calls,
               assignments.csv and aggregate_barcodes.csv bytes and
               JIBES' fit within 1e-6 (CELLPLEX_EXPECTED); the planted
               truth's shares, every planted aggregate flagged and none
               called, and every barcode's GEX, tag and antibody
               molecules the planted counts; every sample's files, 16
               analysis files and no secondary_analysis_error; one K1
               launch a GEX step.  Wall seconds split into run_count (its
               phases, each Feature Barcode library's pass-2 seconds and
               the aggregate detection apart), JIBES, per-sample outs (total,
               slowest, molecule-info subsets, analyses) and web
               summaries; peak device memory and host RSS.  It runs in a
               child process (phase_beside) from index_build to multi
               and the children beside them, so its seconds and theirs
               include each other's load; its line comes after
               analysis_parity's
  immune_held  a 30-cell 5' immune profiling well (testing/fixtures.
               build_immune_run at IMMUNE_HELD: 12 T cells with two-alpha
               clones, 8 B cells with a two-light clone, dropouts joined
               by the subset merge, one TR + IG regions.fa, the
               737,280-barcode whitelist; GEX SC5P-PE) through run_multi
               on cuda: the well's truth (immune_truth_diffs) and
               immune_digest equal to the JAX package's CPU run
               (IMMUNE_EXPECTED, tests/immune_reference.py); two K1
               launches a GEX step.  It runs in a child process beside
               the phases from h5_pipelines to multi, next to
               depth_small; its line comes after depth_small's.  At a
               10,000-cell well alone: immune_run
  flex_held    a 48-cell multiplexed Flex well (testing/fixtures.
               build_flex_run at FLEX_HELD: 3 cells on each of the 16
               probe barcodes, on beads shared between samples, 2,000
               probes, BC001 and BC002 one sample's, BC016 no sample's,
               reads with a probe barcode one base off, two off and on no
               list) through run_multi on cuda: the well's truth
               (flex_truth_diffs) and flex_digest equal to the JAX
               package's CPU run (FLEX_EXPECTED, tests/flex_reference.py);
               no K1 launch.  It runs in a child process beside the
               phases from h5_pipelines to multi; its line comes after
               immune_held's.  At a 16,000-cell well alone: flex_run
  vdj_parity   run_vdj on the single-end and the paired-end worlds of
               tests/test_vdj.py on cuda and on cpu: every output file
               equal; count_bc_umi_kmers on the rows run_vdj handed it,
               split into blocks of a few hundred kmer rows, equal to the
               pipeline's arrays on both devices
  vdj          a T-cell library at the width users run it
               (testing/fixtures.build_vdj_run with vdj_library_kw: 1,000
               cells at 5,000 read pairs a cell; expanded clonotypes;
               IMGT's functional human TRAV, TRAJ, TRBV and TRBJ gene
               counts with V genes drawn in families; 20,000 non-cell
               barcodes of one ambient molecule holding 10% of the pairs;
               the 737,280-barcode 5' whitelist; binned qualities with N
               at Q2; 5,555,556 pairs)
               through run_vdj on cuda, batch 32768: exactly the
               fixture's cells (no non-cell barcode among them),
               clonotypes as a partition of the cells, each cell's CDR3s
               and V and J genes per chain; fixture seconds, wall, pass 1,
               pass 2, the kmer spectrum's device-synchronized seconds,
               its blocks and largest block, the host assembly split into
               graph and assembly (in the worker processes), support,
               annotation, quals and clonotypes plus outputs, seconds a
               cell, the barcodes assembled and those skipped for too
               few UMIs, local alignments a contig, peak device memory,
               host RSS and MemTotal.  It runs in a
               child process beside the phases
               from vdj_parity to human_scale, next to analysis_68k and
               perturb, and vdj_b_held after it in that process; both
               lines come after perturb's
  vdj_b_held   12 B cells of vdj_b's design, one a plasma cell at 45,000
               pairs (90,000 rows, past the real 80,000-row cap), a
               3-cell family with a CDR3 subclone, 240 non-cell barcodes
               (98,889 pairs) through run_vdj on cuda: the sha256 of
               every output file the JAX package's CPU run's
               (VDJ_B_EXPECTED, tests/vdj_b_reference.py), and the
               fixture's truth as vdj_b holds it
  vdj_b        a B-cell library at the width users run it
               (testing/fixtures.build_vdj_b_run with vdj_b_library_kw:
               1,000 cells at 4,000 read pairs a cell; IGH, IGK and IGL at
               IMGT's functional human gene counts with V genes in
               families, the 23 IGHD genes, nine heavy isotypes, IGKC and
               four IGLC genes, near copies where the loci have them, the
               seven human BCR inner primers; 60% naive, 38% memory with
               2-8% of V bases substituted, 2% plasma cells, IgG1 or
               IgA1, at 20 times a cell's molecules and 80,000 pairs, so
               160,000 rows, twice the cap; 10 expanded families sharing
               trunk mutations, with CDR3 subclones and class switches;
               20,000 non-cell barcodes of one ambient molecule from a
               plasma cell; the 737,280-barcode whitelist) through
               run_vdj on cuda, batch 32768: the cells (no non-cell
               barcode among them), each cell's CDR3s and V, J and C
               gene per chain, the clonotypes as the fixture's partition
               (each family one, its subclones included) and every plasma
               barcode's support built from exactly its first 80,000 rows
               in the original's order (vdj_b_truth_diffs); vdj's
               figures, and the clonotypes joined across a subclone, the
               plasma rows, the heaviest barcode's spectrum rows, reads,
               graph and support seconds, and host seconds a cell (its
               graph in a worker and this process's seconds on it) for
               the plasma cells and the others apart.  It runs in a
               child process beside the phases from index_build to
               multi, next to cellplex; its line comes after
               cellplex's
  vdj_held     20 cells of the same design (400 non-cell barcodes)
               through run_vdj on cuda: the sha256 of every output file
               the JAX package's CPU run's (VDJ_EXPECTED,
               tests/vdj_reference.py), and the fixture's truth
  vdj_fast_parity  5 cells at 2,000 pairs of the same design through
               run_vdj on cuda, every barcode's reads and contigs
               recorded: each contig's UMI support, base qualities and
               annotation from vdj/support.py (the batched per-barcode
               work, the native local alignment) equal to the plain
               versions' on the barcode's read list; both sides' seconds
  vdj_kmers    count_bc_umi_kmers alone on the reads of a 400-cell run at
               5,000 pairs a cell (4,000,000 reads with mates, made in
               memory): device time, the spectrum's blocks and largest
               block, peak memory; the fixture's distinct (barcode, UMI)
               pairs, counts summing to the valid 20-mers, keys strictly
               increasing; the first 200,000 reads give equal arrays on
               cuda in blocks of about 2**20 kmer rows, on cuda in one
               block and on cpu
  mkfastq      a lane of 200,000 clusters in the classic and in the CBCL
               BCL layout through run_mkfastq: reads per sample as built,
               equal decompressed FASTQs from both layouts
  mesh         the e2e fixture count-only through run_count on a mesh of 4
               entries (4 distinct cards where the machine has them, else
               cuda:0 four times: the sharded code path on one card, not a
               multi-GPU speedup): every batch split in 4 slices, each
               stepped on its device, rows spilled, partitions deduplicated
               one per device; the same metrics (wall excluded) and MEX
               bytes as e2e, 499,995 molecules, four SW launches a batch
  mesh_shard_index  the same with the kmer table sharded over the mesh
               (each slice's seed queries gathered by the owning entry)
  multihost    the e2e reads cut into 4 lanes of 250,000, counted by 2
               processes (testing/multihost_worker.py on cuda, gloo over a
               free local port): host 0's metrics and MEX equal one
               process's run of the same lanes, host 1 reports only its
               own lanes' 500,000 reads
  human_parity a reference of GRCh38's shape (testing/fixtures.
               build_grch38_run: its 24 primary chromosomes at their
               lengths, 3,088,269,832 random bases, chr1 opening with 4
               copies of a 5 Mb segment, 36,601 two-exon genes; the index
               built on cuda over the whole genome, text 3,097,054,072,
               so minimizer sampling, parity positions and chr13-chrY
               above 2**31; 6,794,880 whitelist barcodes; 1,000,000
               reads), its tables built on cuda through run_count's
               reference memo (load split, table bytes, peak memory):
               its first 4,096 reads through the stream step and the
               aligner on cuda and on cpu (the cpu's tables copies of the
               cuda tables), every output equal, the deletion reads
               rescued by K1; bench.py's truth probe on 32,768 error-free
               reads, every miss one of the reference's known losses and
               the off-repeat reads' score at least HUMAN_TRUTH_FLOOR
  human_scale  those reads through run_count on cuda, count-only, batch
               32768: the molecules, confidently mapped reads and
               molecules per gene of an account of every read (counted
               under its gene or a known loss of the reference, each loss
               within HUMAN_LOSS_CAPS), one K1 launch a step; the
               fixture's seconds (genome, device build, npz write), the
               reference load's split, each device table's bytes, peak
               device memory, peak host RSS and MemTotal
  perturb      a Perturb-seq GEM well at a genome-scale screen's width
               (testing/fixtures.build_perturb_run: 10,000 cells, 4,100
               drawn 20-base guides, two for each of 2,000 genes and 100
               non-targeting, behind the unanchored pattern
               TTCCAGCATAGCTCTTAAAC(BC) at offsets 0-31; 17 TotalSeq-B
               antibodies, searched first; the 6,794,880-barcode
               whitelist; 10,000,000 GEX, 3,000,000 guide and ~2,000,000
               antibody reads; 70% of the cells with one guide, 10% two,
               20% none) through run_count on cuda, batch 32768, secondary
               analysis on: the JAX package's reads, usable reads per
               library, molecules, cells, MEX digests, both
               crispr_analysis CSVs' bytes, the protospacer fractions and
               how many guides took call_features' EM branch and how many
               its fallback (PERTURB_EXPECTED; both above 0); every planted
               molecule counted and the single-guide cells' calls; each
               guide read extracted as built (found at its guide and
               offset, a substitution in the first four bases an exact
               hit, after them corrected, a doubled prefix at its first
               copy, an N-prefixed read not extracted) and taken by
               process_fb's merge of patterns; one K1 launch a GEX step.
               Wall, run_count's phases, each Feature Barcode library's
               pass-2 seconds, the feature assignment's seconds, peak
               device memory and host RSS.  It runs in a child process
               beside the phases from vdj_parity to human_scale, as
               analysis_68k does; its line comes after analysis_68k's

Every path resets the SW kernel's launch count before it runs and reads
it after; the kernel report counts the e2e path's launches and lists
every path's (`pe`: two a batch, one per mate; `mesh` and
`mesh_shard_index`: one a slice; `multihost`: the sum of both processes'
counts; `h5_pipelines`: one a step of each GEM well; `deep`: one a
step, 611 at 20,000,000 reads; `human_parity`:
its cuda step, aligner call and truth-probe step and aligner call;
`cellplex` and `perturb`: one a GEX step, 306, and none for the CMO,
guide and antibody libraries; `immune_held`: two a GEX step, none for
the V(D)J libraries;
`rtl`, the V(D)J paths (`vdj_fast_parity` reads no count), `mkfastq`, `index_build`, `analysis` and
`analysis_68k`: none, no genome aligner runs).  Before the kernel
report a `[timeline]` line gives the seconds from the script's start at
which each phase printed its line.  The line before the last is the
kernel report (JSON); the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

E2E_READS = 1_000_000
E2E_BATCH = 32768
# the BAM run takes the whole e2e fixture: its writer encodes records in
# bulk and compresses on threads (the per-record writer took 0.17-0.41 ms
# a record, so the run had been cut to 50,000 reads)
E2E_BAM_READS = E2E_READS
# bam_held: the reads written by both writers (the plain one is the slow one)
BAM_HELD_READS = 50_000
# The JAX package's BAM for build_e2e_run(dir, E2E_BAM_READS) at batch
# E2E_BATCH, made by `JAX_PLATFORMS=cpu python tests/bam_reference.py DIR`
# (that package's run_count on the CPU with BAM, no checkpoint, no
# secondary analysis) with cellranger_tpu as of commit 4d72afc: the sha256
# of the decompressed BGZF payload and the record count.  The compressed
# bytes and the index depend on the machine's zlib and are not held.
BAM_EXPECTED = dict(
    payload_sha256=(
        "e7c36f042b5176b41d46396811da7bc53168c9b5520289f136b7a7307fd40a50"),
    records=1_000_558)
GOLDEN_BATCH = 4096
OVERFLOW_STATE_CAP = 1 << 19
PE_PAIRS = 1_000_000
PE_PARITY_PAIRS = 4096
PE_PARITY_BATCH = 1024
RTL_READS = 1_000_000
RTL_READ_LEN = 50
# the small probe run of rtl_parity: reads, probes, genes, cells, whitelist
RTL_PARITY = dict(n_reads=20_000, n_probes=3_000, n_genes=1_000, n_cells=50,
                  n_wl=2_000)
RTL_PARITY_BATCH = 4096
PROBE_TIMING_SAMPLES = 30     # samples of each clock of the probe aligner
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
MEX_FILES = [os.path.join(sub, f)
             for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix")
             for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz")]
# the JAX package's outputs for this fixture (BENCH_r05.json, e2e)
E2E_TOTAL_MOLECULES = 499_995
E2E_CONF_MAPPED_FRAC = 1.0
# deep: the e2e generator at sequencing depth, 10,000 reads a cell
# (10x recommends 20,000 read pairs a cell; 2,000 cells here): ~10M
# distinct (barcode, gene, UMI) triples, past MOLECULE_STATE_CAP = 2**23
DEEP_READS = 20_000_000
# The JAX package's outputs for build_e2e_run(dir, DEEP_READS), made by
# `JAX_PLATFORMS=cpu python tests/deep_reference.py DIR` (that package's
# run_count on the CPU: SC3Pv3, read length 91, batch 32768, count-only,
# no checkpoint) with cellranger_tpu as of commit 852ac7f; the digests are
# sha256 of each decompressed MEX file.
DEEP_EXPECTED = dict(
    total_reads=20_000_000,
    total_molecules=9_996_895,
    conf_mapped_frac=1.0,
    mex_sha256={
        "raw_feature_bc_matrix/matrix.mtx.gz":
            "11caaac82676f3e6171fa55eaec7d3e17014eb8b9fd77806a05dfb0098427f6b",
        "raw_feature_bc_matrix/barcodes.tsv.gz":
            "dea523a5aa907b8277bf893eae22dac728ab917ce512ac37c6db6ab7a72a91ee",
        "raw_feature_bc_matrix/features.tsv.gz":
            "18e89285353dcefb4222050217c50f40595c3a8c37122627d04269ead1830aad",
        "filtered_feature_bc_matrix/matrix.mtx.gz":
            "fffa5e60f4945ef096cf3dd222fcce51adce64b2288e96d4bb7f6912bd11e1c1",
        "filtered_feature_bc_matrix/barcodes.tsv.gz":
            "daea9c8407a1ecdc10b03bc875dcf727ddc6f4c8c6a50f49d2049a0e0b6342a5",
        "filtered_feature_bc_matrix/features.tsv.gz":
            "18e89285353dcefb4222050217c50f40595c3a8c37122627d04269ead1830aad",
    })
# the phase's peak device memory: the dedup's budget
# (count.DEDUP_BUDGET_BYTES) plus ~1.2 GB of molecule state and merge and
# ~1.8 GB of e2e's tables and step buffers, with room
DEEP_PEAK_BYTES = 24e9
# depth: testing/fixtures.py build_depth_run, a 3' well of 10,000 cells
# at 10x's 20,000 reads a cell (200M reads), the 3M-february-2018
# whitelist's 6,794,880 barcodes; alone through `depth_run`
DEPTH_READS = 200_000_000
DEPTH_SAMPLE_READS = 100_000      # reads whose CB, UB, GN are held
DEPTH_SEED_SAMPLE = 47
DEPTH_PLAIN_INDEX = 1_000_000     # records the plain .bai rebuild takes
# depth_small in main: the fixture at 2M reads, 50 cells among 100,000
# ambient barcodes (EmptyDrops needs 90,000 barcodes with a molecule),
# count-only with the state flushing and with BAM at a band budget the
# hot gene's band passes; its reads written by 3 workers, as it runs
# beside other phases
DEPTH_SMALL = dict(n_reads=2_000_000, n_cells=50, n_ambient=100_000,
                   n_wl=200_000, workers=3)
DEPTH_SMALL_BAND_RECORDS = 1 << 16
DEPTH_SMALL_STATE_CAP = 1 << 18
DEPTH_SMALL_BUFFER_ROWS = 1 << 17
# it runs in a child process beside h5_pipelines..multi
DEPTH_SMALL_TIMEOUT_S = 600
# padded rows of the dedup_memory phase, besides the port's limit
DEDUP_MEMORY_ROWS = (1 << 20, 1 << 22)
DEDUP_MEMORY_SEED = 5
# (B, L) of the SW kernel check; B = batch // RESCUE_CAP_FRAC: 8192 at the
# e2e batch of 32768, 2048 at batch 8192; L = 150 is a 150-base R2
SW_SHAPES = ((8192, 91), (8191, 91), (1, 91), (2048, 91), (8192, 150),
             (257, 33))
SW_TIMED_SHAPES = ((8192, 91), (2048, 91), (8192, 150))
# what the kernel report's `ms` holds; `call_ms` and `plain_ms` are medians
# of single eager calls, as `ms` itself was before the kernel's redesign
SW_MS_IS = ("device time of one launch: CUDA events around a CUDA graph of "
            "10 launches, over 10, median of 20")
# The card's peak rates for the kernel's bound.  Memory: 3.35 TB/s (NVIDIA
# H100 SXM data sheet).  int32: 16.75 T operations/s, a quarter of the data
# sheet's 67 TFLOP/s fp32: an SM has 64 int32 lanes to its 128 fp32 lanes
# (Hopper architecture white paper), and an FMA counts as two.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# integer operations of one band cell: mask and, match compare, score
# select, diagonal add, vertical add, three max (diag, vert, 0), the scan's
# add and max, the activity select, the running-best max.  Each counts as
# one, although a DPX instruction (__viaddmax_s32_relu) issues three of
# them in one slot: the card's real ceiling for this recurrence is above
# the rate used here, and the share of the bound reads high by that much.
SW_OPS_PER_CELL = 12
# secondary analysis: the JAX package's max_cells_tsne, the largest
# matrix that gets t-SNE and UMAP
ANALYSIS_CELLS = 20_000
ANALYSIS_GENES = 20_000
ANALYSIS_POPS = 8
# past max_cells_tsne: the cell count of 10x's "Fresh 68k PBMCs (Donor A)"
# (Zheng et al. 2017); genes cut from its 32,738 to the fixture's 20,000
ANALYSIS_68K_CELLS = 68_579
KNN_CHECK_ROWS = 1_000      # seeded rows held to float64 neighbours
# analysis_68k runs in a child process beside the V(D)J, mkfastq and human
# phases: its host Louvain and their host assembly, fixture and matrix
# gzip overlap on the machine's cores
ANALYSIS_68K_TIMEOUT_S = 900
CROSS_KNN_K = 20            # find_mnn_pairs' k in aggr's batch correction
MIN_TRUTH_AGREEMENT = 0.99
DIFFEXP_TOP = 10            # top genes by log2 fold change, each a marker
# cuda against cpu on the 8-population matrix of tests/test_torch_analysis.py
ANALYSIS_PARITY_CELLS = 2_000
ANALYSIS_PARITY_GENES = 1_000
ANALYSIS_TIMEOUT_S = 900        # analysis and analysis_parity in one child
# cellplex: a CellPlex GEM well as 10x's 12-CMO example runs it ("30k
# Mouse E18 Combined Cortex, Hippocampus and Subventricular Zone Cells,
# Multiplexed, 12 CMOs", Cell Ranger 6.0): 30,000 cells superloaded, one
# CMO a sample, the 6,794,880-barcode whitelist; beside the CMOs, in the
# same well, the 17 TotalSeq-B antibodies (14 markers, 3 isotype
# controls) of 10x's "10k PBMCs from a Healthy Donor - Gene Expression
# and Cell Surface Protein" (pbmc_10k_protein_v3, Cell Ranger 3.0), with
# 20 planted protein aggregates; depth cut from 10x's 20,000 GEX and
# 5,000 CMO and 5,000 antibody read pairs a cell for the script's time
# limit (about 100 antibody reads a cell)
CELLPLEX = dict(n_cells=30_000, n_tags=12, gex_reads=10_000_000,
                cmo_reads=3_000_000, n_antibodies=17, ab_reads=3_000_000,
                n_aggregates=20)
CELLPLEX_TIMEOUT_S = 900
CELLPLEX_TOL = 1e-6         # JIBES' fitted floats against the JAX run's
# The JAX package's cellplex_outputs for build_cellplex_run(dir,
# **CELLPLEX), made by `JAX_PLATFORMS=cpu python tests/cellplex_reference.py
# DIR` (that package's run_multi on the CPU, batch 32768) with
# cellranger_tpu as of commit bd8cdd2, on the three-library well (GEX,
# 12 CMOs, 17 antibodies with 20 planted aggregates)
CELLPLEX_EXPECTED = {
    "total_reads": 15_989_753,
    "total_molecules": 10_989_753,
    "gex_molecules": 5_000_000,
    "cmo_molecules": 2_994_270,
    "ab_molecules": 2_995_483,
    "estimated_cells": 29_969,
    "mex_sha256": {
        "raw_feature_bc_matrix/matrix.mtx.gz":
            "4cbb325fa310d5302ec8ac150b365b4c035cc5cf3c6350ea8d709c147cc5bb08",
        "raw_feature_bc_matrix/barcodes.tsv.gz":
            "354138b5eebfbdfdf8518fe76b4e5500101a8d3e58223768b5c9d076b3dca1ba",
        "raw_feature_bc_matrix/features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
        "filtered_feature_bc_matrix/matrix.mtx.gz":
            "938f88ae8a7c993aaf2816fad98a0a5e569091e5b4e90abd10d090bfe39df28d",
        "filtered_feature_bc_matrix/barcodes.tsv.gz":
            "2cbd7aaf3ee5dce41e85c91bc73ca5d138f1c9e3a4eb3864dc8928be3e4f2728",
        "filtered_feature_bc_matrix/features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
    },
    "aggregate_barcodes_sha256":
        "a0bc4dd81bf39b6fb4dacc6776a9d9ee3c733bdbbc6fc7a9ce6e00a373ff8acd",
    "number_aggregate_GEMs": 20,
    "planted_aggregates_flagged": 20,
    "planted_aggregates_called": 0,
    "assignments_sha256":
        "d2ac91be5cb4f6685749efbc59d9257f4a4b75578ee07267636ed329de057f6e",
    "tag_call_sha256":
        "183f3897287744339c646b2dcc472fcc2a1eec9f0464259a0ffc6221466e7f6a",
    "tag_calls": {
        "Blank": 601,
        "CMO301": 1865,
        "CMO302": 1858,
        "CMO303": 1855,
        "CMO304": 1860,
        "CMO305": 1867,
        "CMO306": 1860,
        "CMO307": 1858,
        "CMO308": 1860,
        "CMO309": 1864,
        "CMO310": 1866,
        "CMO311": 1859,
        "CMO312": 1857,
        "Multiplet": 7039,
    },
    "samples": {
        "sample1": {
            "cells": 1865,
            "mex_sha256": {
                "matrix.mtx.gz":
            "5f0487f9449e852216c2b6a850c54cf0f459b64e7d2d541eeff2b6f64db9127e",
                "barcodes.tsv.gz":
            "a653e9b968b86a6cbeb6e67d96c837e7dab201911a8679153de9a1f837fe8387",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample2": {
            "cells": 1858,
            "mex_sha256": {
                "matrix.mtx.gz":
            "bc8b46ac856b3be3681f62cad41cb7b8756b256105eabf37a4af9087a15c2e81",
                "barcodes.tsv.gz":
            "a7850f11da56f1acda80d8108265c5beb3c20c0b3f4d6b33f80661ca0245f668",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample3": {
            "cells": 1855,
            "mex_sha256": {
                "matrix.mtx.gz":
            "91c13178dac51b214c33db70bf9896f5700a7ebfc1448eea0662c2d6d233566c",
                "barcodes.tsv.gz":
            "f65613be7221a83c35c76b171ff5784383e468cdb7c83b23e5bb4c401d5642fd",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample4": {
            "cells": 1860,
            "mex_sha256": {
                "matrix.mtx.gz":
            "86be3688a71e4011843b87e46cb2a2982b8e57c1e78b0143f16c5d8b47779956",
                "barcodes.tsv.gz":
            "808d3fcb6f800de61521a29b5e8de8c6bb0bdfec5ae801e4e4526d64ff6b69ff",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample5": {
            "cells": 1867,
            "mex_sha256": {
                "matrix.mtx.gz":
            "c9ebd25bba29f8832db6013885b0126718f28198eea8624446c325b74c520e25",
                "barcodes.tsv.gz":
            "b78215dab17090d20cf002a8dfac7e22e460ce8aeb2074f75df996a648c9cd29",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample6": {
            "cells": 1860,
            "mex_sha256": {
                "matrix.mtx.gz":
            "c34ba348b9a1c59c7b627c8ba58467e9391747c0b87560170705cd0b8ae1f280",
                "barcodes.tsv.gz":
            "5946e98bb14da0dd0046a1ce4a7fe69622524812890a9063ab049fe64143f738",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample7": {
            "cells": 1858,
            "mex_sha256": {
                "matrix.mtx.gz":
            "68cb5b2200247db4c61118d11f6272e8417e9ad9ccc4e8c289cb9b4c84fced88",
                "barcodes.tsv.gz":
            "60065c250806bb9d7a2071dc07ec97c972212f7e82e554a6eaf7475971cffaad",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample8": {
            "cells": 1860,
            "mex_sha256": {
                "matrix.mtx.gz":
            "5a95724943b1601c55fff3c805567d5da4b4c9e2b23872f847283bc8772b8bc0",
                "barcodes.tsv.gz":
            "a79283bc5388abc2838d32c06b8710212b44e0402114faff140367fc126aa45c",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample9": {
            "cells": 1864,
            "mex_sha256": {
                "matrix.mtx.gz":
            "41d31f33ebc67aa7e10d12a048920aaff0e2452546fb99bcda6807b41830637e",
                "barcodes.tsv.gz":
            "d1595c256a45e0e1e1ab59bcf868ce007a9eb7e151fe4e53952da7aba7aa506a",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample10": {
            "cells": 1866,
            "mex_sha256": {
                "matrix.mtx.gz":
            "9f6054554d9fc8bdba47fa8abad2a6020a1400df7e65fb45c6d74dfb79abddc6",
                "barcodes.tsv.gz":
            "fb34dd88cf63bf8e6a87264bbc997954da3720bd8d51299c1febb5d0803059c2",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample11": {
            "cells": 1859,
            "mex_sha256": {
                "matrix.mtx.gz":
            "48a9938ec9db6973e72e5145dc86ef61c57e17a0c199fb39d4482cea099f3498",
                "barcodes.tsv.gz":
            "be7be91c0055a456eceff0bc048da9211fb6222bec24041c28d9db9ddbed3059",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
        "sample12": {
            "cells": 1857,
            "mex_sha256": {
                "matrix.mtx.gz":
            "a7260b1ad5e60846067bf4d75e23ec9c04ccf733cc9e8c58b59c9f2b717b72c6",
                "barcodes.tsv.gz":
            "31ef498a635e4ee7a12f10af8c8ad240945879138ad25b1e5b4e751978661965",
                "features.tsv.gz":
            "5557819f4c01cd2f0d5cfc738ec81ebcc95352511d1f54b32274179f842284a7",
            },
        },
    },
    "jibes": {
        "n_iters": 4,
        "converged": True,
        "posterior_sum": 29774.53153348647,
        "posterior_min": 0.43410826405481084,
        "background": [
            0.5582200703145672, 0.5544502998003054, 0.5553630167193799,
            0.5577368408336056, 0.5569377623143424, 0.5575289936236962,
            0.5543822544061315, 0.5569096343759139, 0.5546645215492161,
            0.5562662704837655, 0.5546061719870294, 0.5562244349027421,
        ],
        "foreground": [
            1.1543653138067436, 1.1676326145242324, 1.1624070144739957,
            1.1599525151524022, 1.1569361352239773, 1.157952793924751,
            1.166541759132465, 1.1646796791725609, 1.1643443347015796,
            1.162549822249865, 1.1661128665385814, 1.1657195367911617,
        ],
        "std_devs": [
            0.20813282012097364, 0.20901846165755483, 0.20907935701764246,
            0.20925070869900178, 0.20850396894883333, 0.20823013783087296,
            0.20869815385285184, 0.2076837019600896, 0.20728633169084654,
            0.2090387029501537, 0.2082265588947461, 0.20779667576420527,
        ],
    },
    "truth": {
        "singlets_own_sample": 0.9995040577096483,
        "multiplets_called_multiplet": 0.9776388888888888,
        "blanks_called_blank": 1.0,
        "barcodes_off_planted_molecules": 0,
        "stray_barcodes": 0,
    },
    "off_planted": [],
}

# Perturb-seq: a genome-scale CRISPR screen's guide library (Replogle et
# al. 2022, Cell 185:2559, the K562 essential-scale screen: ~2,000 target
# genes, two protospacers each, plus non-targeting controls) with surface
# proteins in the same well (ECCITE-seq, Mimitou et al. 2019, Nat Methods
# 16:409; the 17 TotalSeq-B antibodies of 10x's pbmc_10k_protein_v3), 3'
# v3 at 10x's standard load of 10,000 cells; 20-base guides behind the
# unanchored scaffold prefix; depth cut from 10x's 20,000 GEX and 5,000
# guide and 5,000 antibody read pairs a cell for the script's time limit
PERTURB = dict(n_cells=10_000, n_target_genes=2_000, n_nontargeting=100,
               gex_reads=10_000_000, guide_reads=3_000_000,
               n_antibodies=17, ab_reads=2_000_000)
PERTURB_TIMEOUT_S = 600
# The JAX package's perturb_outputs for build_perturb_run(dir, **PERTURB),
# made by `JAX_PLATFORMS=cpu python tests/perturb_reference.py DIR` (that
# package's run_count on the CPU, chip_smoke.perturb_config: batch 32768,
# secondary analysis on) with cellranger_tpu as of commit b1b190b
PERTURB_EXPECTED = {
    "total_reads": 14_995_064,
    "total_molecules": 7_475_337,
    "usable_reads_by_library": [10000000, 2987468, 1995064],
    "gex_molecules": 5_000_000,
    "guide_molecules": 480_273,
    "ab_molecules": 1_995_064,
    "estimated_cells": 10_000,
    "mex_sha256": {
        "raw_feature_bc_matrix/matrix.mtx.gz":
            "395134839ae92413d42433e12ca5d221b5f44ab90f61e71d129671aca5e878cb",
        "raw_feature_bc_matrix/barcodes.tsv.gz":
            "0f46f2e498b189beacddd00262e640d0d165c33d5660d514b5f594a3d0f3668c",
        "raw_feature_bc_matrix/features.tsv.gz":
            "6fc4a73e3f52a650405e83ae86518d259e70a04b6e720330b9b2de433e81d3c2",
        "filtered_feature_bc_matrix/matrix.mtx.gz":
            "ca4d0b624b5c8eb9502b850eaf9ea8e5b0b27bbfe9e53e36ee2d2fa9354e7901",
        "filtered_feature_bc_matrix/barcodes.tsv.gz":
            "6c29927e7fd5da3f48208977899e858877cb849204c9e31a3aee3fc3a3d0469d",
        "filtered_feature_bc_matrix/features.tsv.gz":
            "6fc4a73e3f52a650405e83ae86518d259e70a04b6e720330b9b2de433e81d3c2",
    },
    "cells_with_one_protospacer_frac": 0.7,
    "cells_with_multiple_protospacer_frac": 0.0999,
    "cells_with_no_protospacer_frac": 0.2001,
    "protospacer_calls_per_cell_sha256":
        "3b9713c27576b4fb63ff1932cec1b6417e3af28c1747ee7b744fb359107605ca",
    "protospacer_calls_summary_sha256":
        "dd4b35aed48327bf4f39b2d5e5f0ff927ac8ff75b50d64611c1fb4e6a8fa9550",
    "em_guides": 519,
    "fallback_guides": 3_581,
    "truth": {
        "single_guide_cells": 7_000,
        "single_guide_cells_called": 7_000,
        "single_guide_cells_own_guide": 0.9998571428571429,
        "shared_umi_loss": 0,
        "barcodes_off_planted_molecules": 0,
        "stray_barcodes": 0,
    },
    "off_planted": [],
}

# V(D)J: a T-cell library at the width users run it
# (fixtures.vdj_library_kw: IMGT's functional TRAV/TRAJ/TRBV/TRBJ gene
# counts with V genes in families, 20 non-cell barcodes a cell holding 10%
# of the pairs, the 737,280-barcode 5' whitelist, one expanded clonotype
# per 50 cells, binned qualities).  `vdj`: 1,000 cells, the low end of
# what a 5' GEM well recovers, at 10x's recommended 5,000 read pairs a
# cell, in a child process; `vdj_held`: 20 cells of the same design, every
# output file the JAX package's (VDJ_EXPECTED, written by
# tests/vdj_reference.py); `vdj_fast_parity`: 5 cells at 2,000 pairs, the
# batched per-barcode work (vdj/support.py) against the plain versions on
# every contig.  The kmer spectrum holds one block of about 2**26 kmer
# rows on the card at a time, so a V(D)J run's device peak no longer
# grows with its cells (on an H100: 3.5 GB at 1,000 T or B cells and 5.5
# GB at 10,000 T cells, against 25.17 and 37.15 GB at 1,000 before):
# beside it the human phases, perturb (12.7) and analysis_68k (4.0)
# leave room for 1,000 T cells again
VDJ_CELLS = 1_000
VDJ_PAIRS_PER_CELL = 5_000
VDJ_BATCH = 32768
VDJ_TIMEOUT_S = 900             # vdj and vdj_b_held in one child
VDJ_HELD_CELLS = 20
VDJ_FAST_PARITY_CELLS = 5
VDJ_FAST_PARITY_PAIRS = 2_000
# sha256 of every file the JAX package's run_vdj writes for
# build_vdj_run(dir, VDJ_HELD_CELLS, VDJ_PAIRS_PER_CELL,
# **vdj_library_kw(VDJ_HELD_CELLS)) at batch VDJ_BATCH
VDJ_EXPECTED = {
    "airr_rearrangement.tsv":
        "10427c6bfa0cd9dcdab12c3b830464f62ea85fdd87411b3de9a592080b3286de",
    "all_contig.fasta":
        "ff6bdcc6217a58b3c6234d152523afd6276e16b96ebb954f191b8ca660c5d8f3",
    "all_contig.fastq":
        "1d397ac0ed30fb2c9bf14322c537996277b89ed58e0076bc5c0058d149a7020e",
    "all_contig_annotations.csv":
        "f738f6e56cad59c58da898107c322d7536ac4a263da703db75bf4b3671d2b7a1",
    "all_contig_annotations.json":
        "1febc31d5260fe23c5f0b76a837edb15ec5cc88d5862ed6d675ed5c0781af257",
    "cell_barcodes.json":
        "e1b08c56ddf7091b2febdf3f896983b07e9a4e0f0e8f4eb46a7ae5ef50b67989",
    "clonotypes.csv":
        "11620c17b99ebe2fdd2169984819c7e16cfaf756beb919c08cd3ade92e7e6b75",
    "concat_ref.fasta":
        "f92da3df001127183c1b483a05ec1d63226e9d6f407d54b75ee910bfd0eb618a",
    "consensus.fasta":
        "3905a161a29a00e4703bc4bd8a75be02cf254e845c0b9a4a6fead3bc3b47883e",
    "consensus_annotations.csv":
        "03ab7aff367598acd8ee8f0101422ac5b905e013d2830afa85821fcf9c51f8be",
    "filtered_contig.fasta":
        "ff6bdcc6217a58b3c6234d152523afd6276e16b96ebb954f191b8ca660c5d8f3",
    "filtered_contig.fastq":
        "1d397ac0ed30fb2c9bf14322c537996277b89ed58e0076bc5c0058d149a7020e",
    "filtered_contig_annotations.csv":
        "f738f6e56cad59c58da898107c322d7536ac4a263da703db75bf4b3671d2b7a1",
    "metrics_summary.json":
        "b6d1d9044f8114646b4f0f48146d3abb30206f65b289cef9c94e0559c356e1af",
    "vdj_reference/fasta/regions.fa":
        "37237a3e50ad330357fe52471e54a93f37417b48b3d78e04e669b23121f9fd8b",
    "web_summary.html":
        "dc5a0eff2a96bd3975f19ba2bdccddeaf54a9d55e69c768a60c0e7f3586a8f13",
}
VDJ_B_CELLS = 1_000
VDJ_B_TIMEOUT_S = 900
VDJ_B_PAIRS_PER_CELL = 4_000     # a plasma cell 20 x: 160,000 rows
VDJ_B_HELD_CELLS = 12
VDJ_B_HELD_PLASMA_PAIRS = 45_000  # 90,000 rows, past the 80,000 cap
VDJ_B_HELD_FAMILIES = (3,)
# the JAX package's run_vdj on the vdj_b_held build, on the CPU
# (tests/vdj_b_reference.py): {file: sha256}
VDJ_B_EXPECTED = {
    "airr_rearrangement.tsv":
        "f4378d1fbaabcfd8289e961b999d853b21c1d9982b217bd4da53605bf77d68e6",
    "all_contig.fasta":
        "63596089eaf33f064f86b78af8210dfe271c73f2a2bc5df52b1165d8377dcaee",
    "all_contig.fastq":
        "b64f95c1deb962d1868d0d32cd46f5dd6ec0ff36e59b956952abaf44a7376519",
    "all_contig_annotations.csv":
        "441506f4a49067d6932e1b95d1581a7ca049e800e306b53eaeceb466eb92b5b8",
    "all_contig_annotations.json":
        "f0644ed6768b2634259615b0626344b2d9f092b27033086ed0d7ba1d2d3325f7",
    "cell_barcodes.json":
        "177e1579bb4741ca0aeb7eb83d77afe9d14a2e76d3c7ead4001337a7aeee62b5",
    "clonotypes.csv":
        "1c2c059f5b9ff479906c33b6cf01db885d3b7e312b94e0ea98fb825bc1039375",
    "concat_ref.fasta":
        "60d910de5c8b5e0aa0ad5d5bea202ea433c9045b9b2805fc99ff409526da6ba0",
    "consensus.fasta":
        "de1277a54d0e0ffc72a58bac5bfbde013fb6deb8f82051bf1769053548c12f28",
    "consensus_annotations.csv":
        "20912a2fe1200d10f9ead325558b2ad90f9e77443335e493ab761bed997e568d",
    "filtered_contig.fasta":
        "63596089eaf33f064f86b78af8210dfe271c73f2a2bc5df52b1165d8377dcaee",
    "filtered_contig.fastq":
        "b64f95c1deb962d1868d0d32cd46f5dd6ec0ff36e59b956952abaf44a7376519",
    "filtered_contig_annotations.csv":
        "441506f4a49067d6932e1b95d1581a7ca049e800e306b53eaeceb466eb92b5b8",
    "metrics_summary.json":
        "5c723721c45f41c6059df3032ece3fb06e30497a8a86e9b7a3eeaba553423c39",
    "vdj_reference/fasta/regions.fa":
        "8a07f0a2c9cc9210a186ccee1b6831dca023f8e67d6a331f6d668815629aa21c",
    "web_summary.html":
        "57c1977acba811851761d513617e9420ca2d4ba7ea310a77b2560c721dcb99ab",
}
IMMUNE_CELLS = 10_000           # immune_run's well: a 10x 5' run's cells
# immune_held's well (testing/fixtures.build_immune_run): 12 T, 8 B and
# 10 other cells, 200 GEX and 200 V(D)J read pairs a cell, 2 non-cell
# barcodes a V(D)J cell, the 737,280-barcode whitelist, a 400 kb genome of
# 40 genes; the T clones: two alphas in 5 cells (one losing its second
# alpha, two both: {TRB} a subset of two chain sets of unequal size) and in
# 2 cells (one losing its second alpha), one alpha in 2 cells and in 3
# single cells; the B clones: IGK and IGL in 2 memory cells (one losing
# its IGL) and in a naive cell, a memory family of 2, 4 single cells
IMMUNE_HELD = dict(kinds=(12, 8, 10), gex_pairs=200, vdj_pairs=200,
                   background=2, genome_len=400_000, n_genes=40)
IMMUNE_HELD_T_PLAN = (
    [dict(cells=5, alphas=2, drop=1, beta_only=2),
     dict(cells=2, alphas=2, drop=1, beta_only=0),
     dict(cells=2, alphas=1, drop=0, beta_only=0)]
    + [dict(cells=1, alphas=1, drop=0, beta_only=0)] * 3)
IMMUNE_HELD_B_PLAN = [
    dict(kinds=["memory", "memory"], light2=True, drop=1),
    dict(kinds=["memory"]), dict(kinds=["memory", "memory"]),
    dict(kinds=["naive"], light2=True),
    dict(kinds=["naive"]), dict(kinds=["naive"])]
IMMUNE_HELD_BATCH = 4096
IMMUNE_HELD_TIMEOUT_S = 600
IMMUNE_RSS_SHARE = 0.75         # PERF.md section 2's V(D)J limits
IMMUNE_DEVICE_BYTES = 16e9
# immune_digest of the JAX package's run_multi of the immune_held build on
# the CPU (tests/immune_reference.py, batch IMMUNE_HELD_BATCH)
IMMUNE_EXPECTED = {
    "count/filtered_barcodes.csv":
        "8fd26c49772e638f60f07b254fc43ca8f5f67859217d0fa65c172ffc861329cf",
    "count/filtered_feature_bc_matrix/barcodes.tsv.gz":
        "8219d47509ee6f0f9b70d1feec3163c8c4d39ebf27f1fe2e056b422523e39601",
    "count/filtered_feature_bc_matrix/features.tsv.gz":
        "b39db9a1c18b84b9a4dc0a7aa24b92bf417d496b6d3a473145f3b27fa6a32b15",
    "count/filtered_feature_bc_matrix/matrix.mtx.gz":
        "87b32668990768f1fb40d0265dc9bc62d221ddf5245500dd08d284206b5c80c7",
    "count/metrics_summary.json":
        "13e937b199f7a65836477c6aa74ba1a4ade3c87fd8857ec4f36df5862b5e0377",
    "count/per_barcode_metrics.csv":
        "96af1069a62388863a2b4747f6de1cc06d4df706d70903dcefbbbb855d904fde",
    "count/raw_feature_bc_matrix/barcodes.tsv.gz":
        "1e890ec2a60ed95727179787927506e709c6c1bbccd1a9f272ca69c24b872eaa",
    "count/raw_feature_bc_matrix/features.tsv.gz":
        "b39db9a1c18b84b9a4dc0a7aa24b92bf417d496b6d3a473145f3b27fa6a32b15",
    "count/raw_feature_bc_matrix/matrix.mtx.gz":
        "e98bdef75428e12d7c5a68a2e2a24825511dd5ae2769cc5f9e995e0a96548b27",
    "metrics_summary.json":
        "a2547e5e939537965a54f2c2559e6dace5919da946eff96f1fb7e038575085dd",
    "vdj/vdj_b/airr_rearrangement.tsv":
        "0ac55d696509300816b4ce17b58243bc4b2c25ff8141c1f41722da687499909b",
    "vdj/vdj_b/all_contig.fasta":
        "60ef6f16b31a8148222638d268a6175bd4553cb23fff0e0726ef3c34609e7f03",
    "vdj/vdj_b/all_contig.fastq":
        "bbc52691d43d96bfb1bd695c13922f0cb2d47be43e1787e2314c9c5f2bc35991",
    "vdj/vdj_b/all_contig_annotations.csv":
        "aae3f9bccb009a2806454ee7ccb32fe1be3048f898c133599f9c8219a74f6d56",
    "vdj/vdj_b/all_contig_annotations.json":
        "6537283cc2a6a64e3f743e1f43879f151c54655da8ab41c9c89333ca8e1ab1c8",
    "vdj/vdj_b/cell_barcodes.json":
        "deaf3bafcdc30eb6eac50f2b4dff294f9972641865e125e9946c4ddd08f23940",
    "vdj/vdj_b/clonotypes.csv":
        "498f29edf69e2bd0efbc1a37dcf2cb54e06ce1064e1261bd9691cf4935d23d9f",
    "vdj/vdj_b/concat_ref.fasta":
        "26f1954da4a9bdb72c0092294e3886f27befa832bf39389481aec3e70fe0bdfe",
    "vdj/vdj_b/consensus.fasta":
        "47fb70ce9f5a39800deca3756b7e77ba0411e1699f6a949b8061adc318464d1e",
    "vdj/vdj_b/consensus_annotations.csv":
        "9de95a47d8bfb92d96face4e415225d19dd2ea5615da1b3995fb825d7ce550b7",
    "vdj/vdj_b/filtered_contig.fasta":
        "60ef6f16b31a8148222638d268a6175bd4553cb23fff0e0726ef3c34609e7f03",
    "vdj/vdj_b/filtered_contig.fastq":
        "bbc52691d43d96bfb1bd695c13922f0cb2d47be43e1787e2314c9c5f2bc35991",
    "vdj/vdj_b/filtered_contig_annotations.csv":
        "aae3f9bccb009a2806454ee7ccb32fe1be3048f898c133599f9c8219a74f6d56",
    "vdj/vdj_b/metrics_summary.json":
        "c5ddbf0b184f99f0875b2dee94fdcfdbaf6c6361ff007f19a6d5668429438130",
    "vdj/vdj_b/vdj_reference/fasta/regions.fa":
        "502eef1fcdb0a04fdac2b297817866fee37f141f400bdc78aa490e327528150e",
    "vdj/vdj_b/web_summary.html":
        "52fdd041c937ad51424b55dd24685f9373798dcfc7a300b09fc36644cf713364",
    "vdj/vdj_t/airr_rearrangement.tsv":
        "f8026eca4b965c76c7f27ef2982519b42e73cc8c63b9d4fb66ee18e55224fa03",
    "vdj/vdj_t/all_contig.fasta":
        "d6d14525c4c74e547112ae26782a5d4b36f9f06167ec276dbc938391340f6f8d",
    "vdj/vdj_t/all_contig.fastq":
        "12ebc96c953afdab2ffc582a74df9ff284d975b1357603c3d0e16cf18d845f44",
    "vdj/vdj_t/all_contig_annotations.csv":
        "8f3ce95e61837b719c890456c4b7edf4fcc9137385cbd3a6942f16b989cd4f83",
    "vdj/vdj_t/all_contig_annotations.json":
        "819009d33a2397c6d24a50d9100b9cfa108bc6f730b26fc74fb881c1bd8cde28",
    "vdj/vdj_t/cell_barcodes.json":
        "364f1fa470f93a7d9039960f7ecd426f7540d36372a5f3f90ba42dfc10b894b0",
    "vdj/vdj_t/clonotypes.csv":
        "2a68cdcc2d3220ed72b44162b1b50501e2d60dbefa033509c6e7286b0db18bb9",
    "vdj/vdj_t/concat_ref.fasta":
        "96130d56e23f9d3203bbd1cdf03661dc3b6894ca5b1ce2aaff6b2977803cf37b",
    "vdj/vdj_t/consensus.fasta":
        "6a64444f973ab3ff9c4cdd5ffc4a6867f824f171af5080e14edc8433ebde7e85",
    "vdj/vdj_t/consensus_annotations.csv":
        "099887c302943a13a75edb27a54a5dc3e2420c5badc72b805a7c4c58387bd90b",
    "vdj/vdj_t/filtered_contig.fasta":
        "d6d14525c4c74e547112ae26782a5d4b36f9f06167ec276dbc938391340f6f8d",
    "vdj/vdj_t/filtered_contig.fastq":
        "12ebc96c953afdab2ffc582a74df9ff284d975b1357603c3d0e16cf18d845f44",
    "vdj/vdj_t/filtered_contig_annotations.csv":
        "8f3ce95e61837b719c890456c4b7edf4fcc9137385cbd3a6942f16b989cd4f83",
    "vdj/vdj_t/metrics_summary.json":
        "1562985ccb3c8bbdf54b1ca3b828736ae2a7eedb00e825ff294a7e5bbe28b473",
    "vdj/vdj_t/vdj_reference/fasta/regions.fa":
        "502eef1fcdb0a04fdac2b297817866fee37f141f400bdc78aa490e327528150e",
    "vdj/vdj_t/web_summary.html":
        "daf847643f0beea39c6ca2b1b88b5c5940f5e2793dc085ed7b6b0cc92892d851",
}
VDJ_PARITY_CHUNK = 500          # kmer rows a block: splits every world
VDJ_KMER_CELLS = 400            # 2,000,000 pairs, 4,000,000 reads
VDJ_KMER_PARITY_READS = 200_000
VDJ_KMER_PARITY_CHUNK = 1 << 20  # kmer rows a block of the parity reads
MKFASTQ_CLUSTERS = 200_000
MESH_ENTRIES = 4
MULTIHOST_PROCS = 2
MULTIHOST_LANES = 4
MULTIHOST_TIMEOUT_S = 600
# index_build: the seeded genome with N runs and junction contigs built
# minimizer/parity on both sides (fixtures.index_genome)
INDEX_BUILD_LEN = 64_000_000
INDEX_BUILD_GENES = 2_000
# the GRCh38-shaped reference (testing/fixtures.build_grch38_run): its
# 1,000,000 reads at the e2e batch; its parity batch; bench.py's
# truth-probe batch
HUMAN_BATCH = 32768
HUMAN_PARITY_READS = 4096
HUMAN_TRUTH_READS = 32768
# The reference's known losses on the human layout (known_losses,
# ROADMAP.md section 3), bounded: the truth probe's off-repeat reads must
# score at least HUMAN_TRUTH_FLOOR (0.99072 measured on an H100), and in
# human_scale each loss may take at most its share of each kind's reads
# plus HUMAN_LOSS_SLACK reads.  The shares are 1.25 times those of the
# fixture's 1,000,000 reads measured on an H100 (PERF.md section 6):
# saturated 4,458 of 700,000 exon, 4,100 of 100,000 junction and 528 of
# 50,000 deletion reads; straddling 152 and false novel junction 2
# deletion reads (build_human_run's 2 Gb pad and 280 Mb chr1).  The
# GRCh38-shaped fixture that replaced it loses fewer of each and adds
# chance_locus: 8 of 50,000 deletion reads.  Its repeat model
# adds the kinds exon_repeat (120,000 reads) and paralog (80,000), whose
# pairs take 1.25 times the shares measured on an H100: saturated 24
# exon_repeat and 2,480 paralog reads; a false novel junction 292
# exon_repeat reads; copy_crowded 49,042 exon_repeat reads.  A pair
# absent here may take the slack only.
HUMAN_TRUTH_FLOOR = 0.985
HUMAN_LOSS_CAPS = {
    "saturated": {"exon": 0.0080, "junction": 0.052, "deletion": 0.0133,
                  "exon_repeat": 0.00025, "paralog": 0.03875},
    "contig_straddle": {"deletion": 0.0038},
    "false_novel_junction": {"deletion": 0.00005, "exon_repeat": 0.00305},
    "chance_locus": {"deletion": 0.0002},
    "copy_crowded": {"exon_repeat": 0.511},
}
HUMAN_LOSS_SLACK = 8


# seconds from the script's start at which each phase printed its line
# (main prints them as one `[timeline]` line before the kernel report)
_T0 = time.time()
TIMELINE: dict = {}


def phase(name: str, msg: str) -> None:
    TIMELINE[name] = round(time.time() - _T0, 1)
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def sw_bound(B: int, L: int) -> dict:
    """The least time the card could take for one banded SW call: every
    input byte read once and every output written once over the memory
    rate, against the band's integer operations, counted one by one
    (no DPX fusion), over the int32 rate."""
    n_bytes = B * (2 * L + 2 * (L + 16)) + 3 * 4 * B
    n_ops = B * L * 16 * SW_OPS_PER_CELL
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return dict(bytes=n_bytes, operations=n_ops, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes > by_ops else "operations")


def _sw_equal(sw, args, what: str) -> int:
    """Kernel == plain version, all three outputs on every row (tolerance
    0: the recurrence is integer); returns the largest difference seen."""
    import torch
    got = sw.banded_sw(*args)
    torch.cuda.synchronize()
    want = sw.banded_sw_ref(*args)
    err = 0
    for name, g, w in zip(("score", "end_i", "end_d"), got, want):
        if g.shape != w.shape:
            raise AssertionError(f"sw kernel {name} on {what}: shape "
                                 f"{tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.long() - w.long()).abs()
        if d.numel() and int(d.max()):
            raise AssertionError(
                f"sw kernel {name} differs on {what}: max abs err "
                f"{int(d.max())}, rows {d.nonzero().flatten()[:5].tolist()}")
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_sw_kernel() -> dict:
    """Kernel vs plain version on the card; returns the report entry."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.testing.fixtures import (sw_adversarial_inputs,
                                                       sw_inputs)
    from cellranger_tpu_torch.testing.sw_timing import both_clocks, time_calls

    def on_card(arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    by_shape, errs = {}, []
    for B, L in SW_SHAPES:
        args = on_card(sw_inputs(B, B, L))
        errs.append(_sw_equal(sw, args, f"random inputs B={B} L={L}"))
        if (B, L) in SW_TIMED_SHAPES:
            t = both_clocks(lambda: sw.banded_sw(*args))
            t.update(sw_bound(B, L))
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
            by_shape[f"{B}x{L}"] = t
        if (B, L) == SW_SHAPES[0]:
            plain_ms = time_calls(lambda: sw.banded_sw_ref(*args),
                                  warmup=2)["ms"]
    B, L = SW_SHAPES[0]
    adv = on_card(sw_adversarial_inputs(7, B, L))
    errs.append(_sw_equal(sw, adv, f"adversarial inputs B={B} L={L}"))
    # row slices: contiguous, but each tensor starts at another offset
    # within its 16-byte line, so the kernel's per-byte staging runs
    big = on_card(sw_inputs(3, 1030, L))
    views = [big[0][1:1025], big[1][2:1026], big[2][3:1027], big[3][5:1029]]
    rows = [big[0][1:1025], big[1][1:1025], big[2][1:1025], big[3][1:1025]]
    errs.append(_sw_equal(sw, views, "misaligned row slices"))
    errs.append(_sw_equal(sw, rows, "row slices off the 16-byte line"))
    errs.append(_sw_equal(sw, [t[:0] for t in big], "B = 0"))
    main = by_shape[f"{B}x{L}"]
    report = dict(max_abs_err=max(errs), ms=main["ms"],
                  call_ms=main["call_ms"], plain_ms=plain_ms,
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                  by_shape=by_shape)
    phase("sw_kernel", f"equal to the plain version at {SW_SHAPES}, on "
          "adversarial inputs, on misaligned slices and at B = 0; rates: "
          f"{HBM_BYTES_PER_S:.3g} B/s, {INT32_OPS_PER_S:.4g} int32 op/s, "
          f"{SW_OPS_PER_CELL} ops per cell; plain {plain_ms:.4f} ms at "
          f"B={B} L={L}; " + json.dumps(by_shape))
    return report


def _count_cfg(fx: dict, batch_size: int, **kw):
    """The fixture's CountConfig; secondary analysis off unless asked."""
    from cellranger_tpu_torch.pipeline.count import CountConfig
    kw = dict(dict(checkpoint=False, secondary_analysis=False,
                   chemistry="SC3Pv3", read_len=91,
                   reference_path=fx.get("ref")), **kw)
    return CountConfig(
        fastq_pairs=fx.get("pairs") or [(fx["fq1"], fx["fq2"])],
        whitelist_path=fx["wl"], batch_size=batch_size, **kw)


def _rtl_kw(fx: dict) -> dict:
    """CountConfig fields of a build_rtl_run fixture."""
    return dict(chemistry="MFRP-RNA", read_len=RTL_READ_LEN,
                probe_set_csv=fx["probes"],
                probe_barcode_csv=fx["probe_barcodes"])


def _mex_diffs(out_a: str, out_b: str) -> list[str]:
    diffs = []
    for f in MEX_FILES:
        with gzip.open(os.path.join(out_a, f)) as fa, \
                gzip.open(os.path.join(out_b, f)) as fb:
            if fa.read() != fb.read():
                diffs.append(f)
    return diffs


def tiny_parity(tmp: str, devices=("cuda", "cpu"), batch_size: int = 256):
    """The synthetic run, default count (secondary analysis on), on each
    device: identical metrics and MEX, analysis/ held by
    `analysis_check.compare_analysis`; SW launches grow on cuda by at
    least the number of steps and not on cpu."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import run_count
    from cellranger_tpu_torch.testing import analysis_check as check
    from cellranger_tpu_torch.testing.fixtures import build_synthetic_run

    fx = build_synthetic_run(os.path.join(tmp, "tiny"))
    n_steps = -(-fx["n_reads"] // batch_size)
    sums, outs = {}, {}
    for dev in devices:
        before = sw.LAUNCHES
        outs[dev] = os.path.join(tmp, f"tiny_{dev}")
        sums[dev] = run_count(
            _count_cfg(fx, batch_size, secondary_analysis=True), outs[dev],
            device=dev)
        grew = sw.LAUNCHES - before
        if dev == "cuda" and grew < n_steps:
            raise AssertionError(f"cuda run launched the SW kernel {grew} "
                                 f"times for {n_steps} steps")
        if dev == "cpu" and grew != 0:
            raise AssertionError("cpu run launched the SW kernel")
    a, b = devices
    diffs = _metric_diffs(sums[a], sums[b]) + _mex_diffs(outs[a], outs[b])
    an = [os.path.join(outs[d], "analysis") for d in (b, a)]
    if len(check.analysis_files(an[0])) != 16:
        raise AssertionError(f"tiny {b} run wrote "
                             f"{check.analysis_files(an[0])} in analysis/")
    diffs += check.compare_analysis(*an)[0]
    if diffs:
        raise AssertionError(f"{a} and {b} runs differ: {diffs[:10]}")
    if sums[a]["total_molecules"] != int(fx["truth"].sum()):
        raise AssertionError("tiny run molecule count is off")
    return sums[a], n_steps


def _golden_diffs(out: str, golden: str) -> list[str]:
    """Differences of a run's outputs from a golden snapshot, through the
    repo's comparators."""
    from cellranger_tpu_torch.testing import correctness as cc

    j = lambda d, f: os.path.join(d, f)  # noqa: E731
    diffs = cc.check_metrics(j(out, "metrics_summary.json"),
                             j(golden, "metrics_summary.json"))
    for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
        f = os.path.join("raw_feature_bc_matrix", f)
        diffs += cc.check_mtx(j(out, f), j(golden, f))
    diffs += cc.check_bam(j(out, "possorted_genome_bam.bam"),
                          j(golden, "possorted_genome_bam.bam"))
    for f in ("filtered_barcodes.csv", "junctions.tsv"):
        with open(j(out, f), "rb") as fa, open(j(golden, f), "rb") as fe:
            if fa.read() != fe.read():
                diffs.append(f"{f} differs from golden")
    diffs += cc.check_h5(j(out, "filtered_feature_bc_matrix.h5"),
                         j(golden, "filtered_feature_bc_matrix.h5"))
    diffs += cc.check_molecule_info(j(out, "molecule_info.h5"),
                                    j(golden, "molecule_info.h5"))
    return diffs


def golden(tmp: str, which: str, devices=("cuda",)) -> dict:
    """The tiny ("e2e") or rich ("e2e_rich") fixture with BAM on each
    device, each against its golden snapshot; with two devices the BAM
    bytes must be identical too."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import LibraryDef, run_count
    from cellranger_tpu_torch.testing import fixtures

    if which == "e2e":
        fx = fixtures.build_synthetic_run(os.path.join(tmp, which))
        cfg = _count_cfg(fx, GOLDEN_BATCH, write_bam=True, checkpoint=True)
    else:
        fx = fixtures.build_rich_run(os.path.join(tmp, which))
        cfg = _count_cfg(fx, GOLDEN_BATCH, write_bam=True,
                         feature_ref_csv=fx["feature_ref"], libraries=[
                             LibraryDef([(fx["fq1"], fx["fq2"])]),
                             LibraryDef([(fx["ab_fq1"], fx["ab_fq2"])],
                                        "Antibody Capture")])
    # Gene Expression steps (feature libraries do not align)
    n_steps = -(-fx.get("n_gex_reads", fx["n_reads"]) // GOLDEN_BATCH)
    res, bams = {}, []
    for dev in devices:
        out = os.path.join(tmp, f"{which}_{dev}")
        sw.LAUNCHES = 0
        t = time.time()
        summary = run_count(cfg, out, device=dev)
        res[f"wall_s_{dev}"] = time.time() - t
        launches = sw.LAUNCHES
        diffs = _golden_diffs(out, os.path.join(GOLDEN_DIR, which))
        if diffs:
            raise AssertionError(f"{which} on {dev} differs from the golden "
                                 f"snapshot: {diffs[:10]}")
        if dev == "cuda" and launches < n_steps:
            raise AssertionError(f"{which} on cuda launched the SW kernel "
                                 f"{launches} times in {n_steps} steps")
        with open(os.path.join(out, "possorted_genome_bam.bam"), "rb") as f:
            bams.append(f.read())
        res.update(reads=summary["total_reads"],
                   molecules=summary["total_molecules"],
                   h5_compared=True, bam_bytes=len(bams[-1]))
        res[f"sw_launches_{dev}"] = launches
    if len(bams) == 2 and bams[0] != bams[1]:
        raise AssertionError(f"{which}: {devices[0]} and {devices[1]} BAMs "
                             "differ")
    return res


def bam_records(path: str) -> int:
    """Number of alignment records in a BAM."""
    import struct
    with gzip.open(path, "rb") as f:
        data = f.read()
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    n = 0
    while off < len(data):
        off += 4 + struct.unpack_from("<i", data, off)[0]
        n += 1
    return n


def count_run(fx: dict, out: str, device: str = "cuda",
              batch_size: int = E2E_BATCH, mesh=None, **kw) -> dict:
    """One run_count of a fixture (on `mesh` when one is given); returns
    counts, wall, phase split, SW launches (reset before the run) and peak
    device memory (the largest of the mesh's cards)."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import run_count

    cards = ([d for d in mesh.distinct if d.type == "cuda"] if mesh
             else [torch.device(device)] if device == "cuda" else [])
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    sw.LAUNCHES = 0                 # count this path's launches only
    t1 = time.time()
    summary = run_count(_count_cfg(fx, batch_size, **kw), out, device=device,
                        mesh=mesh)
    wall = time.time() - t1
    launches = sw.LAUNCHES
    with open(os.path.join(out, "_perf.json")) as f:
        phases: dict = {}
        for ph in json.load(f)["phases"]:
            phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    return dict(
        reads=summary["total_reads"], wall_s=wall,
        reads_per_s=summary["total_reads"] / wall,
        total_molecules=summary["total_molecules"],
        conf_mapped_frac=summary["conf_mapped_frac"],
        summary=summary,
        estimated_cells=summary["estimated_cells"],
        sw_launches=launches, n_steps=-(-summary["total_reads"]
                                         // batch_size),
        phase_s=phases,
        peak_mem_bytes=(max(torch.cuda.max_memory_allocated(d)
                            for d in cards) if cards else None))


@contextlib.contextmanager
def h5_writes():
    """Record every h5 write of the port's matrix and molecule_info
    writers inside the block: [{path, write_s, written}], `written` the
    CountMatrix or the keyword arguments that were written."""
    from cellranger_tpu_torch.io import matrix_io, molecule_info

    rec: list[dict] = []
    save_h5 = matrix_io.CountMatrix.save_h5
    save_mi = molecule_info.save_molecule_info

    def timed_save_h5(self, path, *a, **kw):
        t = time.time()
        save_h5(self, path, *a, **kw)
        rec.append(dict(path=path, write_s=time.time() - t, written=self))

    def timed_save_mi(path, **kw):
        t = time.time()
        save_mi(path, **kw)
        rec.append(dict(path=path, write_s=time.time() - t, written=kw))

    matrix_io.CountMatrix.save_h5 = timed_save_h5
    molecule_info.save_molecule_info = timed_save_mi
    try:
        yield rec
    finally:
        matrix_io.CountMatrix.save_h5 = save_h5
        molecule_info.save_molecule_info = save_mi


def h5_read_back(rec: list[dict]) -> dict:
    """Each file `h5_writes` recorded, read back through io/hdf5.py and
    held to what was written: {file name: bytes, write_s, read_s}."""
    import numpy as np
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.io.molecule_info import load_molecule_info

    out = {}
    for r in rec:
        name, want = os.path.basename(r["path"]), r["written"]
        t = time.time()
        if isinstance(want, CountMatrix):
            got = CountMatrix.load_h5(r["path"])
            read_s = time.time() - t
            defs = [[(d.id, d.name, d.feature_type, d.genome)
                     for d in m.features.feature_defs] for m in (got, want)]
            same = (got.m.shape == want.m.shape
                    and (got.m != want.m).nnz == 0
                    and got.barcodes == [b if isinstance(b, bytes)
                                         else str(b).encode()
                                         for b in want.barcodes]
                    and defs[0] == defs[1])
        else:
            got = load_molecule_info(r["path"])
            read_s = time.time() - t
            order = np.argsort(want["barcode_idx"], kind="stable")
            same = all(np.array_equal(got[k], want[k][order])
                       for k in ("barcode_idx", "feature_idx", "umi",
                                 "count")) \
                and len(got["pass_filter"]) == len(want["pass_filter_bc_idx"])
        if not same:
            raise AssertionError(f"{r['path']} does not read back to the "
                                 "arrays that were written")
        out[name] = dict(bytes=os.path.getsize(r["path"]),
                         write_s=r["write_s"], read_s=read_s)
    return out


def h5_pipelines(fx: dict, tmp: str, e2e_out: str, other_out: str,
                 device: str = "cuda", n_lanes: int = 4,
                 batch_size: int = E2E_BATCH) -> dict:
    """The h5 readers and writers above count: run_aggr over the
    molecule_info.h5 of two count-only runs of `fx` (e2e_out, other_out:
    equal depth, so nothing is subsampled), run_count_gem_wells over the
    first two of n_lanes lanes of fx's reads, CLI reanalyze of
    e2e_out's filtered matrix; every check raises."""
    import numpy as np
    import scipy.sparse as sp
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.cli import main as cli_main
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.io.molecule_info import load_molecule_info
    from cellranger_tpu_torch.pipeline.aggr import run_aggr
    from cellranger_tpu_torch.pipeline.count import CountConfig
    from cellranger_tpu_torch.pipeline.multi_gem import run_count_gem_wells
    from cellranger_tpu_torch.testing.analysis_check import analysis_files
    from cellranger_tpu_torch.testing.fixtures import split_lanes

    j = os.path.join
    t0 = time.time()
    sw.LAUNCHES = 0
    rep: dict = {}
    # aggr over two runs of the same reads
    csv = j(tmp, "h5_aggr.csv")
    with open(csv, "w") as f:
        f.write("sample_id,molecule_h5\n"
                f"a,{j(e2e_out, 'molecule_info.h5')}\n"
                f"b,{j(other_out, 'molecule_info.h5')}\n")
    out = j(tmp, "h5_aggr_out")
    t = time.time()
    s = run_aggr(csv, out, secondary_analysis=False, device=device)
    rep["aggr_s"] = time.time() - t
    one = CountMatrix.load_h5(j(e2e_out, "raw_feature_bc_matrix.h5"))
    raw = CountMatrix.load_h5(j(out, "raw_feature_bc_matrix.h5"))
    n_mol = int(one.m.sum())
    n_bc = one.m.shape[1]
    gem_groups = {b.rsplit(b"-", 1)[1] for b in raw.barcodes}
    if s["normalization_rates"] != [1.0, 1.0] \
            or s["total_molecules"] != 2 * n_mol \
            or len(load_molecule_info(j(out, "molecule_info.h5"))["umi"]) \
            != 2 * n_mol or gem_groups != {b"1", b"2"} \
            or (raw.m[:, :n_bc] != one.m).nnz \
            or (raw.m[:, n_bc:] != one.m).nnz:
        raise AssertionError(f"aggr of two equal runs: {s}, GEM groups "
                             f"{gem_groups}, {n_mol} molecules a run")
    rep.update(aggr_molecules=s["total_molecules"],
               aggr_cells=s["total_cells"])
    # two GEM wells, a lane each
    t = time.time()
    lanes = split_lanes(fx, n_lanes, j(tmp, "h5_lanes"))["pairs"][:2]
    rep["split_s"] = time.time() - t
    cfgs = [CountConfig(fastq_pairs=[pair], reference_path=fx["ref"],
                        whitelist_path=fx["wl"], chemistry="SC3Pv3",
                        read_len=91, batch_size=batch_size, gem_group=g)
            for g, pair in enumerate(lanes, 1)]
    out = j(tmp, "h5_wells_out")
    t = time.time()
    s = run_count_gem_wells(cfgs, out, secondary_analysis=False,
                            device=device)
    rep["gem_wells_s"] = time.time() - t
    wells = [j(out, "gem_wells", f"gw{g}") for g in (1, 2)]
    parts = [CountMatrix.load_h5(j(w, "raw_feature_bc_matrix.h5"))
             for w in wells]
    merged = CountMatrix.load_h5(j(out, "raw_feature_bc_matrix.h5"))
    mols = [load_molecule_info(j(d, "molecule_info.h5"))
            for d in wells + [out]]
    if merged.barcodes != parts[0].barcodes + parts[1].barcodes \
            or (merged.m != sp.hstack([p.m for p in parts]).tocsc()).nnz \
            or len(mols[2]["umi"]) != len(mols[0]["umi"]) \
            + len(mols[1]["umi"]) \
            or set(np.unique(mols[2]["gem_group"]).tolist()) != {1, 2}:
        raise AssertionError("gem wells: the merged raw matrix or "
                             "molecule_info is not the wells' joined")
    rep.update(gem_wells_reads=s["total_reads"],
               gem_wells_molecules=len(mols[2]["umi"]))
    # reanalyze the e2e run's filtered matrix through the CLI
    t = time.time()
    cli_main(["reanalyze", "--id", "h5_re", "--matrix",
              j(e2e_out, "filtered_feature_bc_matrix.h5"),
              "--device", device, "--output-dir", tmp])
    rep["reanalyze_s"] = time.time() - t
    rep["reanalyze_files"] = len(analysis_files(
        j(tmp, "h5_re", "outs", "analysis")))
    if rep["reanalyze_files"] != 16:
        raise AssertionError(f"reanalyze wrote {rep['reanalyze_files']} "
                             "analysis files")
    rep.update(sw_launches=sw.LAUNCHES, wall_s=time.time() - t0)
    return rep


def check_e2e_counts(name: str, r: dict, reads: int = E2E_READS,
                     molecules: int = E2E_TOTAL_MOLECULES,
                     per_step: int = 1) -> None:
    """The JAX package's values for the e2e fixture (or the given ones),
    and per_step SW launches at least per step (one a slice on a mesh; 0
    where the run is on the CPU)."""
    if r["reads"] != reads:
        raise AssertionError(f"{name} total_reads {r['reads']}")
    if r["total_molecules"] != molecules:
        raise AssertionError(f"{name} total_molecules "
                             f"{r['total_molecules']} != {molecules}")
    if r["conf_mapped_frac"] != E2E_CONF_MAPPED_FRAC:
        raise AssertionError(f"{name} conf_mapped_frac "
                             f"{r['conf_mapped_frac']}")
    if r["sw_launches"] < per_step * r["n_steps"]:
        raise AssertionError(f"{name} launched the SW kernel "
                             f"{r['sw_launches']} times in {r['n_steps']} "
                             f"steps ({per_step} a step expected)")


def first_reads(fx: dict, n_reads: int, out_dir: str) -> dict:
    """The fixture `fx` with FASTQs (plain or gzipped, as its own) that
    hold its first n_reads reads."""
    os.makedirs(out_dir, exist_ok=True)
    cut = dict(fx, n_reads=n_reads)
    for k in ("fq1", "fq2"):
        cut[k] = os.path.join(out_dir, os.path.basename(fx[k]))
        opener = gzip.open if fx[k].endswith(".gz") else open
        with opener(fx[k], "rb") as src, opener(cut[k], "wb") as dst:
            for _ in range(4 * n_reads):
                dst.write(src.readline())
    return cut


def bam_payload(path: str) -> dict:
    """sha256 of a BAM's decompressed BGZF payload, and its records."""
    with gzip.open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return dict(payload_sha256=digest, records=bam_records(path))


def bam_index_records(path: str) -> tuple[int, list[tuple]]:
    """The BAM's reference count, and (ref_id, pos, end, voffset start,
    voffset end) of each record with ref_id >= 0, rebuilt from the BAM as laid out in the file: its BGZF
    blocks' file offsets and sizes (every block but the last full, 60,000
    bytes: a position p of the stream is block p // 60,000, the convention
    of a writer that flushes full blocks) and each record's CIGAR."""
    import struct
    import zlib
    with open(path, "rb") as f:
        raw = f.read()
    starts, sizes, parts = [], [], []
    off = 0
    while off < len(raw):
        bsize = struct.unpack_from("<H", raw, off + 16)[0] + 1
        isize = struct.unpack_from("<I", raw, off + bsize - 4)[0]
        starts.append(off)
        sizes.append(isize)
        parts.append(zlib.decompress(raw[off + 18:off + bsize - 8], -15))
        off += bsize
    data = b"".join(parts)
    block = 60000
    full = [s for s in sizes if s]
    if any(s != block for s in full[:-1]):
        raise AssertionError(f"{path}: a BGZF block other than the last "
                             "is not 60,000 bytes")
    voff = lambda p: (starts[p // block] << 16) | (p % block)  # noqa: E731
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    recs = []
    while off < len(data):
        size = struct.unpack_from("<i", data, off)[0]
        ref_id, pos, l_rn, _, _, n_cig = struct.unpack_from("<iiBBHH", data,
                                                            off + 4)
        if ref_id >= 0:
            cig = struct.unpack_from(f"<{n_cig}I", data, off + 36 + l_rn)
            rlen = sum(v >> 4 for v in cig if v & 0xF in (0, 2, 3))
            recs.append((ref_id, pos, pos + (rlen or 1), voff(off),
                         voff(off + 4 + size)))
        off += 4 + size
    return n_ref, recs


def bam_index_check(path: str, tmp: str) -> dict:
    """The run's .bai against the one the copy's IndexingBamWriter
    _write_bai writes from bam_index_records(path)."""
    from cellranger_tpu_torch.io.bam_index import IndexingBamWriter

    t = time.time()
    plain = IndexingBamWriter.__new__(IndexingBamWriter)
    plain._n_ref, plain._records = bam_index_records(path)
    plain._vpath = os.path.join(tmp, "rebuilt.bai")
    plain._write_bai()
    with open(plain._vpath, "rb") as fa, open(path + ".bai", "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{path}.bai differs from the index of "
                                 "its records")
    return dict(indexed_records=len(plain._records),
                bai_bytes=os.path.getsize(path + ".bai"),
                check_s=time.time() - t)


def bam_run(fx: dict, tmp: str, ref_molecules: int, ref_mex: dict,
            n_reads: int | None = None, device: str = "cuda",
            batch_size: int = E2E_BATCH,
            expected: dict | None = BAM_EXPECTED) -> dict:
    """The first n_reads reads of the e2e fixture (all of them by default)
    with BAM (stream mode, spill, partition dedup, BAM writer): every read
    confidently mapped, the molecules (ref_molecules) and MEX digests
    (ref_mex, of `mex_sha256`) of the count-only run, a BAM record at
    least for every read; the decompressed BAM and its record count
    `expected` (the JAX package's); the .bai that of the records as laid
    out in the file.  Reports wall, bam_write and its split (spool bytes
    on disk included), BAM bytes, peak host RSS and device memory.

    The BAM writer at `deep`'s depth is this function on deep's fixture,
    held to DEEP_EXPECTED (about 10 minutes at 20,000,000 reads on one
    H100's host; not a phase of main):

        python3 -c "import chip_smoke as c, json, tempfile;
        from cellranger_tpu_torch import kernels;
        from cellranger_tpu_torch.testing.fixtures import build_e2e_run;
        kernels.build(); t = tempfile.mkdtemp(); e = c.DEEP_EXPECTED;
        fx = build_e2e_run(t + '/fx', e['total_reads']);
        print(json.dumps(c.bam_run(fx, t, e['total_molecules'],
                                   e['mex_sha256'], expected=None)))"
    """
    import torch
    from cellranger_tpu_torch.pipeline import bam_out

    n_reads = n_reads or fx["n_reads"]
    if n_reads < fx["n_reads"]:
        fx = first_reads(fx, n_reads, os.path.join(tmp, "e2e_bam_fq"))
    bam_out_dir = os.path.join(tmp, "e2e_bam_out")
    with rss_peak() as rss:
        rb = count_run(fx, bam_out_dir, device, batch_size, write_bam=True)
    rb.pop("summary")
    check_e2e_counts("e2e_bam", rb, n_reads, ref_molecules,
                     per_step=int(device == "cuda"))
    if mex_sha256(bam_out_dir) != ref_mex:
        raise AssertionError("e2e_bam MEX differs from count-only")
    bam = os.path.join(bam_out_dir, "possorted_genome_bam.bam")
    split = dict(bam_out.LAST_SPLIT)
    rb.update(bam_payload(bam), bam_bytes=os.path.getsize(bam),
              bam_write_s=rb["phase_s"]["bam_write"], bam_split=split,
              peak_host_rss_bytes=rss["bytes"],
              device=(torch.cuda.get_device_name(0) if device == "cuda"
                      else device))
    rb["records_per_s"] = rb["records"] / rb["bam_write_s"]
    rb["stream_bytes_per_record"] = split["stream_bytes"] / rb["records"]
    rb["bam_bytes_per_record"] = rb["bam_bytes"] / rb["records"]
    if rb["records"] < n_reads or split["records"] != rb["records"]:
        raise AssertionError(f"e2e_bam wrote {rb['records']} records "
                             f"for {n_reads} reads")
    if expected is not None:
        got = {k: rb[k] for k in expected}
        if got != expected:
            raise AssertionError(f"e2e_bam BAM {got} is not the JAX "
                                 f"package's {expected}")
    rb["index"] = bam_index_check(bam, tmp)
    return rb


@contextlib.contextmanager
def plain_beside(record: list | None = None):
    """Every BamCollector.write in the block first writes its spool through
    the plain writer (BamCollector.write_plain) to <path>.plain and
    <path>.plain.bai, then writes <path> as the run does; the seconds of
    both go into `record`."""
    from cellranger_tpu_torch.pipeline import bam_out

    real = bam_out.BamCollector.write

    def both(self, path, *a, **kw):
        t = time.perf_counter()
        self.write_plain(path + ".plain", *a, **kw)
        t1 = time.perf_counter()
        real(self, path, *a, **kw)
        if record is not None:
            record.append(dict(plain_s=t1 - t,
                               new_s=time.perf_counter() - t1))

    bam_out.BamCollector.write = both
    try:
        yield
    finally:
        bam_out.BamCollector.write = real


def plain_diffs(out: str) -> list[str]:
    """Files of out's BAM and index that differ from the plain writer's."""
    bam = os.path.join(out, "possorted_genome_bam.bam")
    diffs = []
    for a, b in ((bam, bam + ".plain"), (bam + ".bai", bam + ".plain.bai")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                diffs.append(os.path.basename(a))
    return diffs


def bam_held(fx: dict, tmp: str, n_reads: int = BAM_HELD_READS,
             device: str = "cuda", batch_size: int = E2E_BATCH) -> dict:
    """The first n_reads reads of the e2e fixture with BAM, the BAM write
    made by the plain writer and by the run's from one spool, in one
    process (one zlib): .bam and .bai byte-equal."""
    cut = first_reads(fx, n_reads, os.path.join(tmp, "bam_held_fq"))
    out = os.path.join(tmp, "bam_held_out")
    seconds: list = []
    with plain_beside(seconds):
        r = count_run(cut, out, device, batch_size, write_bam=True)
    diffs = plain_diffs(out)
    if diffs:
        raise AssertionError(f"bam_held: {diffs} differ from the plain "
                             "writer's")
    bam = os.path.join(out, "possorted_genome_bam.bam")
    return dict(reads=r["reads"], sw_launches=r["sw_launches"],
                records=bam_records(bam), bam_bytes=os.path.getsize(bam),
                plain_write_s=seconds[0]["plain_s"],
                write_s=seconds[0]["new_s"])


def overflow_run(fx: dict, out: str, ref_out: str, device: str = "cuda",
                 batch_size: int = E2E_BATCH,
                 cap: int = OVERFLOW_STATE_CAP) -> dict:
    """A count-only run with the device molecule state capped at `cap`
    rows: the host flush and the partition dedup must run, and the MEX
    bytes must equal those of the uncapped run in ref_out."""
    from cellranger_tpu_torch.parallel import molecule_state
    from cellranger_tpu_torch.pipeline import count

    flushes = []
    real_flush = molecule_state.MoleculeState.flush_to_host
    real_cap = count.MOLECULE_STATE_CAP

    def flush(self):
        flushes.append(self.n)
        real_flush(self)

    count.MOLECULE_STATE_CAP = cap
    molecule_state.MoleculeState.flush_to_host = flush
    try:
        r = count_run(fx, out, device, batch_size)
        r.pop("summary")
    finally:
        count.MOLECULE_STATE_CAP = real_cap
        molecule_state.MoleculeState.flush_to_host = real_flush
    if not flushes:
        raise AssertionError("the capped run never flushed its molecule "
                             "state")
    diffs = _mex_diffs(out, ref_out)
    if diffs:
        raise AssertionError(f"capped run MEX differs: {diffs}")
    r["flushes"] = len(flushes)
    return r


def mex_sha256(out: str) -> dict:
    """sha256 of each decompressed MEX file under out: {path: hex}."""
    digests = {}
    for f in MEX_FILES:
        with gzip.open(os.path.join(out, f), "rb") as fh:
            digests[f] = hashlib.sha256(fh.read()).hexdigest()
    return digests


def dedup_rows(n_rows: int, seed: int = DEDUP_MEMORY_SEED) -> tuple:
    """Seeded weighted rows as the flushed molecule state holds them:
    (bc, gene, umi, reads) uint32, 2,000 barcodes, 400 genes, random
    12-base UMIs, 1-3 reads a row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2000, n_rows, dtype=np.uint32) * 7919,
            rng.integers(0, 400, n_rows, dtype=np.uint32),
            rng.integers(0, 1 << 24, n_rows, dtype=np.uint32),
            rng.integers(1, 4, n_rows, dtype=np.uint32))


def dedup_memory(device: str = "cuda", sizes=DEDUP_MEMORY_ROWS,
                 fill: float = 0.6) -> dict:
    """One device call of the partition dedup (`_dedup_host`, count-only
    as the main path calls it) at each padded size N, on fill x N seeded
    rows, and at the port's limit: seconds, peak device memory above what
    was allocated before, bytes per padded row.  The limit's call must
    stay within count.DEDUP_BUDGET_BYTES (on the card)."""
    import torch
    from cellranger_tpu_torch.parallel.molecule_state import (_dedup_host,
                                                              _pow2)
    from cellranger_tpu_torch.pipeline import count

    limit_rows = _pow2(count.DEDUP_CHUNK_LIMIT)
    calls = []
    for N in sorted(set(sizes) | {limit_rows}):
        bc, gene, umi, reads = dedup_rows(int(fill * N))
        on_card = device == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        dd = _dedup_host(bc, gene, umi, 12, N, device, False, reads)
        if on_card:
            torch.cuda.synchronize()
        sec = time.time() - t
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        calls.append(dict(padded_rows=N, rows=len(bc), seconds=sec,
                          molecules=len(dd["mol_bc"]), peak_bytes=peak,
                          bytes_per_row=None if peak is None else peak / N))
    at_limit = calls[[c["padded_rows"] for c in calls].index(limit_rows)]
    r = dict(calls=calls, limit_rows=limit_rows,
             budget_bytes=count.DEDUP_BUDGET_BYTES)
    if at_limit["peak_bytes"] is not None:
        r["reckoned_2_24_bytes"] = at_limit["bytes_per_row"] * (1 << 24)
        if at_limit["peak_bytes"] > count.DEDUP_BUDGET_BYTES:
            raise AssertionError(
                f"dedup at the limit's {limit_rows} padded rows took "
                f"{at_limit['peak_bytes']} bytes of the card, over the "
                f"budget of {count.DEDUP_BUDGET_BYTES}: " + json.dumps(r))
    return r


def deep(tmp: str, n_reads: int = DEEP_READS,
         expected: dict = DEEP_EXPECTED, device: str = "cuda",
         batch_size: int = E2E_BATCH, cap: int | None = None,
         peak_limit: float = DEEP_PEAK_BYTES) -> dict:
    """build_e2e_run at n_reads through run_count on `device`, count-only,
    with the molecule state at its real cap (or `cap`): reads, molecules,
    conf_mapped_frac and MEX digests equal to `expected` (the JAX
    package's); at least one flush of the state during pass 2; every
    dedup_molecules call of molecule_state.py within
    _pow2(DEDUP_CHUNK_LIMIT) padded rows; one K1 launch a step on cuda;
    peak device memory under peak_limit; the h5 files read back.  The
    fixture's directory is deleted at the end."""
    import resource

    from cellranger_tpu_torch.parallel import molecule_state
    from cellranger_tpu_torch.pipeline import count
    from cellranger_tpu_torch.testing.fixtures import build_e2e_run

    fx_dir = os.path.join(tmp, "deep")
    t = time.time()
    fx = build_e2e_run(fx_dir, n_reads=n_reads)
    fixture_s = time.time() - t
    flushes, dedup_calls = [], []
    at_end = []                  # set once the run reaches its dedup
    MS = molecule_state.MoleculeState
    real_flush, real_bound = MS.flush_to_host, MS.bound_dedup
    real_dedup = molecule_state.dedup_molecules
    real_cap = count.MOLECULE_STATE_CAP

    def flush(self):
        real_flush(self)
        flushes.append(dict(rows=len(self.flushed[-1]),
                            at="end" if at_end else "cap"))

    def bound_dedup(self, limit):
        at_end.append(True)
        real_bound(self, limit)

    def dedup_molecules(bc, *a, **kw):
        dedup_calls.append(int(bc.shape[0]))
        return real_dedup(bc, *a, **kw)

    MS.flush_to_host, MS.bound_dedup = flush, bound_dedup
    molecule_state.dedup_molecules = dedup_molecules
    if cap is not None:
        count.MOLECULE_STATE_CAP = cap
    try:
        with h5_writes() as written:
            r = count_run(fx, os.path.join(fx_dir, "out"), device,
                          batch_size)
        r["h5"] = h5_read_back(written)
        digests = mex_sha256(os.path.join(fx_dir, "out"))
    finally:
        MS.flush_to_host, MS.bound_dedup = real_flush, real_bound
        molecule_state.dedup_molecules = real_dedup
        count.MOLECULE_STATE_CAP = real_cap
        shutil.rmtree(fx_dir, ignore_errors=True)
    r.pop("summary")
    limit_rows = molecule_state._pow2(count.DEDUP_CHUNK_LIMIT)
    r.update(fixture_s=fixture_s, state_cap=cap or real_cap,
             flushes=flushes, dedup_calls=dedup_calls,
             dedup_limit_rows=limit_rows,
             peak_host_rss_bytes=resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss * 1024)
    diffs = [f"{k} {r[k]} != {expected[k]}"
             for k in ("total_molecules", "conf_mapped_frac")
             if r[k] != expected[k]]
    if r["reads"] != expected["total_reads"] or r["reads"] != n_reads:
        diffs.append(f"reads {r['reads']}")
    diffs += [f"{f} sha256 {digests[f]}" for f in MEX_FILES
              if digests[f] != expected["mex_sha256"][f]]
    if r["total_molecules"] > n_reads // 2:
        diffs.append("more molecules than the fixture built")
    if not any(f["at"] == "cap" and f["rows"] for f in flushes):
        diffs.append(f"the molecule state never flushed at its cap "
                     f"{r['state_cap']}")
    if not dedup_calls or max(dedup_calls) > limit_rows:
        diffs.append(f"dedup calls {dedup_calls} past {limit_rows} rows")
    if r["sw_launches"] != (r["n_steps"] if device == "cuda" else 0):
        diffs.append(f"{r['sw_launches']} K1 launches in {r['n_steps']} "
                     f"steps on {device}")
    if r["peak_mem_bytes"] is not None and r["peak_mem_bytes"] > peak_limit:
        diffs.append(f"peak device memory {r['peak_mem_bytes']}")
    if diffs:
        raise AssertionError(f"deep: {diffs}: " + json.dumps(r))
    return r


def mem_total() -> int:
    """MemTotal of this machine, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemTotal in /proc/meminfo")


@contextlib.contextmanager
def disk_peak(path: str):
    """The most bytes used on path's filesystem inside the block, less
    those used when it began, read every second by a thread: yields a
    dict whose "bytes" holds it when the block ends."""
    import threading

    first = shutil.disk_usage(path).used
    out, stop = {"bytes": 0}, threading.Event()

    def sample():
        while True:
            out["bytes"] = max(out["bytes"],
                               shutil.disk_usage(path).used - first)
            if stop.wait(1.0):
                return

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()


def mex_entries(out: str, sub: str = "raw_feature_bc_matrix"):
    """(feature, barcode, count) of a MEX matrix, 0-based, as read."""
    import numpy as np

    with gzip.open(os.path.join(out, sub, "matrix.mtx.gz"), "rb") as f:
        data = f.read()
    at = 0
    while data.startswith(b"%", at):
        at = data.index(b"\n", at) + 1
    at = data.index(b"\n", at) + 1          # rows cols entries
    m = np.array(data[at:].split(), np.int64).reshape(-1, 3)
    return m[:, 0] - 1, m[:, 1] - 1, m[:, 2]


def depth_truth_diffs(fx: dict, out: str, summary: dict) -> list[str]:
    """What a run of a `build_depth_run` well wrote, against what the
    fixture built: reads, molecules, conf_mapped_frac 1.0, the raw matrix
    (read back from the MEX), the filtered barcodes (the planted cells)
    and each molecule's reads in molecule_info.h5."""
    import numpy as np

    from cellranger_tpu_torch.io import hdf5

    diffs = []
    for k, want in (("total_reads", fx["n_reads"]),
                    ("total_molecules", fx["n_molecules"]),
                    ("conf_mapped_frac", 1.0)):
        if summary[k] != want:
            diffs.append(f"{k} {summary[k]} != {want}")
    bc, gene = fx["mol_bc"].astype(np.int64), fx["mol_gene"].astype(np.int64)
    new = np.r_[True, (bc[1:] != bc[:-1]) | (gene[1:] != gene[:-1])]
    first = np.flatnonzero(new)
    want = (gene[first], bc[first], np.diff(np.r_[first, len(bc)]))
    feat, col, cnt = mex_entries(out)
    o = np.lexsort((feat, col))
    if not (len(o) == len(first) and all(
            np.array_equal(a[o], b) for a, b in zip((feat, col, cnt), want))):
        diffs.append(f"raw matrix: {len(o)} entries, {len(first)} planted, "
                     "not the fixture's counts")
    with open(fx["wl"], "rb") as f:
        wl = np.frombuffer(f.read(), np.uint8).reshape(-1, 17)[:, :16]
    planted = {wl[i].tobytes() + b"-1" for i in fx["cells"].tolist()}
    with gzip.open(os.path.join(out, "filtered_feature_bc_matrix",
                                "barcodes.tsv.gz"), "rb") as f:
        called = set(f.read().split())
    if called != planted:
        diffs.append(f"called {len(called)} cells, planted {len(planted)}, "
                     f"{len(called & planted)} of them called")
    with hdf5.File(os.path.join(out, "molecule_info.h5"), "r") as f:
        got = [f[k][:] for k in ("barcode_idx", "feature_idx", "umi",
                                 "count")]
    o = np.lexsort((got[2], got[1], got[0]))
    if not (len(o) == len(bc) and all(
            np.array_equal(g[o].astype(np.int64), w.astype(np.int64))
            for g, w in zip(got, (fx["mol_bc"], fx["mol_gene"],
                                  fx["mol_umi"], fx["mol_reads"])))):
        diffs.append("molecule_info.h5: molecules or their reads differ "
                     "from the fixture's")
    return diffs


def depth_bam_diffs(fx: dict, out: str, tmp: str,
                    n_sample: int = DEPTH_SAMPLE_READS) -> tuple:
    """The BAM of a run of a `build_depth_run` well: a primary record a
    read, positions sorted (unmapped records last), the .bai that of the
    records as laid out in the file (`bam_index_check`'s plain index up
    to DEPTH_PLAIN_INDEX records, beyond that io/bam_fast.py's builder
    from the walked records), and the CB, UB and GN of a seeded sample
    of reads' primary records those the fixture built.  Returns (diffs,
    report)."""
    import numpy as np

    from cellranger_tpu_torch.io import bam_fast
    from cellranger_tpu_torch.testing.bam_walk import walk_bam

    bam = os.path.join(out, "possorted_genome_bam.bam")
    n = fx["n_reads"]
    sample = np.sort(np.random.default_rng(DEPTH_SEED_SAMPLE).choice(
        n, min(n_sample, n), replace=False))
    t = time.time()
    w = walk_bam(bam, sample)
    rep = dict(records=len(w["ref"]), walk_s=time.time() - t,
               blocks=w["blocks"], stream_bytes=w["stream_bytes"])
    diffs = []
    primary = (w["flag"] & 0x900) == 0
    rep["primary_records"] = int(primary.sum())
    if rep["primary_records"] != n:
        diffs.append(f"{rep['primary_records']} primary records, {n} reads")
    ref, pos = w["ref"].astype(np.int64), w["pos"].astype(np.int64)
    mapped = ref >= 0
    if mapped.any() and not mapped[:np.flatnonzero(mapped)[-1] + 1].all():
        diffs.append("an unmapped record before a mapped one")
    key = (ref[mapped] << 32) | pos[mapped]
    if np.any(key[1:] < key[:-1]):
        diffs.append("mapped records out of position order")
    t = time.time()
    if len(w["ref"]) <= DEPTH_PLAIN_INDEX:
        rep["index"] = bam_index_check(bam, tmp)
    else:
        vs, ve, end = w["vstart"][mapped], w["vend"][mapped], \
            w["end"][mapped].astype(np.int64)
        chunks = bam_fast.merge_chunks(ref[mapped], bam_fast.reg2bins(
            pos[mapped], end), vs, ve)
        wins = bam_fast.least_per_window(*bam_fast.windows(
            ref[mapped], pos[mapped], end, vs))
        with open(bam + ".bai", "rb") as f:
            if f.read() != bam_fast.bai_bytes(w["n_ref"], chunks, wins):
                diffs.append(".bai differs from the index of its records")
        rep["index"] = dict(indexed_records=int(mapped.sum()),
                            bai_bytes=os.path.getsize(bam + ".bai"),
                            check_s=time.time() - t, built_by="io/bam_fast.py")
    del w["ref"], w["pos"], w["end"], w["vstart"], w["vend"]
    gen = fx["gen_dir"]
    tables = {k: np.load(os.path.join(gen, k + ".npy"), mmap_mode="r")
              for k in ("mol_of_read", "slot", "slot_bc", "umi", "gene")}
    mol = np.asarray(tables["mol_of_read"][sample])
    slot = np.asarray(tables["slot"])[mol]
    bc = np.frombuffer(b"ACGT", np.uint8)[unpack_codes(
        np.asarray(tables["slot_bc"])[slot], 16)]
    umi = np.frombuffer(b"ACGT", np.uint8)[unpack_codes(
        np.asarray(tables["umi"])[mol], 12)]
    gene = np.asarray(tables["gene"])[mol]
    bad = 0
    for i, r in enumerate(sample.tolist()):
        recs = [tg for tg in w["tags"].get(r, []) if not tg["flag"] & 0x900]
        want = dict(CB=bc[i].tobytes().decode() + "-1",
                    UB=umi[i].tobytes().decode(), GN=f"G{gene[i]}")
        got = [{k: tg.get(k) for k in want} for tg in recs]
        if got != [want]:
            bad += 1
            if bad <= 3:
                diffs.append(f"read {r}: {got} != {want}")
    rep["sampled_reads"] = len(sample)
    rep["sample_mismatches"] = bad
    return diffs, rep


def unpack_codes(packed, length: int):
    """Packed 2-bit bases -> [n, length] codes, first base highest."""
    from cellranger_tpu_torch.ops.encode import unpack_np
    return unpack_np(packed, length)


def depth_count(fx: dict, out: str, write_bam: bool, tmp: str,
                device: str = "cuda", analysis: bool = True,
                band_records: int | None = None,
                state_cap: int | None = None,
                buffer_rows: int | None = None,
                peak_limit: float = DEEP_PEAK_BYTES) -> dict:
    """run_count of a `build_depth_run` well (its FASTQ lanes as
    find_fastqs finds them), count-only or with BAM, on `device`, with
    the BAM writer's band budget, the molecule state's cap and the step's
    molecule buffer at their real values or those given; held to the
    fixture by `depth_truth_diffs` and, with BAM, `depth_bam_diffs`; one
    K1 launch a step on cuda; every dedup_molecules call within
    _pow2(DEDUP_CHUNK_LIMIT) rows; peak device memory under peak_limit.
    Reports wall, the phase split, bam_write's split, records a second,
    peak RSS against MemTotal, peak device memory, flushes, dedup calls,
    K1 launches, spool and FASTQ bytes, the disk used at its peak, and
    the MEX digests."""
    from cellranger_tpu_torch.io.fastq import find_fastqs
    from cellranger_tpu_torch.parallel import molecule_state
    from cellranger_tpu_torch.pipeline import bam_out, count

    flushes, dedup_calls = [], []
    MS = molecule_state.MoleculeState
    real = (MS.flush_to_host, molecule_state.dedup_molecules,
            count.MOLECULE_STATE_CAP, count.MOLECULE_BUFFER_ROWS,
            bam_out.BAND_RECORDS)

    def flush(self):
        real[0](self)
        flushes.append(len(self.flushed[-1]))

    def dedup_molecules(bc, *a, **kw):
        dedup_calls.append(int(bc.shape[0]))
        return real[1](bc, *a, **kw)

    MS.flush_to_host = flush
    molecule_state.dedup_molecules = dedup_molecules
    count.MOLECULE_STATE_CAP = state_cap or real[2]
    count.MOLECULE_BUFFER_ROWS = buffer_rows or real[3]
    bam_out.BAND_RECORDS = band_records or real[4]
    run_fx = dict(fx, pairs=find_fastqs(fx["fastq_dir"]))
    try:
        with rss_peak() as rss, disk_peak(tmp) as disk:
            r = count_run(run_fx, out, device, write_bam=write_bam,
                          secondary_analysis=analysis)
    finally:
        (MS.flush_to_host, molecule_state.dedup_molecules,
         count.MOLECULE_STATE_CAP, count.MOLECULE_BUFFER_ROWS,
         bam_out.BAND_RECORDS) = real
    summary = r.pop("summary")
    limit_rows = molecule_state._pow2(count.DEDUP_CHUNK_LIMIT)
    # a batch never spans two lanes: each lane's reads step on their own
    lanes = len(run_fx["pairs"])
    r["n_steps"] = sum(-(-((k + 1) * fx["n_reads"] // lanes
                          - k * fx["n_reads"] // lanes) // E2E_BATCH)
                       for k in range(lanes))
    r.update(write_bam=write_bam, lanes=lanes,
             flushes=flushes, dedup_calls=len(dedup_calls),
             dedup_rows_max=max(dedup_calls, default=0),
             dedup_limit_rows=limit_rows,
             state_cap=count.MOLECULE_STATE_CAP if state_cap is None
             else state_cap, peak_host_rss_bytes=rss["bytes"],
             mem_total_bytes=mem_total(), disk_peak_bytes=disk["bytes"],
             fastq_bytes=sum(os.path.getsize(p) for pr in run_fx["pairs"]
                             for p in pr),
             estimated_cells=summary["estimated_cells"],
             mex_sha256=mex_sha256(out))
    r["rss_share"] = r["peak_host_rss_bytes"] / r["mem_total_bytes"]
    diffs = depth_truth_diffs(fx, out, summary)
    if r["sw_launches"] != (r["n_steps"] if device == "cuda" else 0):
        diffs.append(f"{r['sw_launches']} K1 launches in {r['n_steps']} "
                     f"steps on {device}")
    if not dedup_calls or max(dedup_calls) > limit_rows:
        diffs.append(f"dedup calls of up to {r['dedup_rows_max']} rows, "
                     f"the limit {limit_rows}")
    if r["peak_mem_bytes"] is not None and r["peak_mem_bytes"] > peak_limit:
        diffs.append(f"peak device memory {r['peak_mem_bytes']}")
    if write_bam:
        split = dict(bam_out.LAST_SPLIT)
        r.update(bam_write_s=r["phase_s"]["bam_write"], bam_split=split,
                 bam_bytes=os.path.getsize(os.path.join(
                     out, "possorted_genome_bam.bam")))
        r["records_per_s"] = split["records"] / r["bam_write_s"]
        r["spool_bytes_per_record"] = split["spool_bytes"] / split["records"]
        if split["band_rows_max"] > split["band_records"]:
            diffs.append(f"a BAM part of {split['band_rows_max']} records, "
                         f"the budget {split['band_records']}")
        bam_diffs, r["bam_check"] = depth_bam_diffs(fx, out, tmp)
        diffs += bam_diffs
    elif not any(flushes):
        diffs.append(f"the molecule state never flushed at its cap "
                     f"{r['state_cap']}")
    if diffs:
        raise AssertionError(f"depth ({'BAM' if write_bam else 'count-only'}"
                             f", {fx['n_reads']} reads): {diffs}: "
                             + json.dumps(r))
    return r


def depth_run(tmp: str, n_reads: int = DEPTH_READS, write_bam: bool = False,
              expected_mex: dict | None = None, device: str = "cuda",
              **kw) -> dict:
    """`build_depth_run` at n_reads (a 10,000-cell 3' well at 10x's
    20,000 reads a cell by default) through the port's run_count,
    count-only or with BAM (`depth_count`), the MEX digests equal to
    `expected_mex` where given (the other mode's run).  The fixture and
    the outputs are deleted at the end.  Not a phase of main: at 200M
    reads count-only took about half an hour on one H100's machine with
    its fixture (10.5 GB of FASTQ); with BAM it takes longer (PERF.md
    §6).  Alone, a mode a call:

        python3 -c "import chip_smoke as c, json, tempfile;
        from cellranger_tpu_torch import kernels; kernels.build();
        print(json.dumps(c.depth_run(tempfile.mkdtemp(), write_bam=False)))"
    """
    from cellranger_tpu_torch.testing.fixtures import build_depth_run

    kw_fx = {k: kw.pop(k) for k in ("n_cells", "n_wl", "ref", "workers",
                                    "n_ambient") if k in kw}
    with rss_peak() as rss:
        fx = build_depth_run(os.path.join(tmp, "depth"), n_reads, **kw_fx)
    try:
        r = depth_count(fx, os.path.join(tmp, "depth_out"), write_bam, tmp,
                        device, **kw)
    finally:
        shutil.rmtree(os.path.join(tmp, "depth"), ignore_errors=True)
        shutil.rmtree(os.path.join(tmp, "depth_out"), ignore_errors=True)
    r.update(fixture_s=fx["fixture_s"], fixture_rss_bytes=rss["bytes"],
             ambient_reads=fx["ambient_reads"],
             molecules=fx["n_molecules"], cells=fx["n_cells"],
             ambient_barcodes=fx["n_ambient"], whitelist=fx["n_wl"],
             barcode_errors=fx["n_errors"])
    if expected_mex is not None and r["mex_sha256"] != expected_mex:
        raise AssertionError(f"depth MEX {r['mex_sha256']} differs from "
                             f"the other run's {expected_mex}")
    return r


def depth_small(tmp: str, ref: dict | None = None, device: str = "cuda",
                **kw) -> dict:
    """The depth fixture at DEPTH_SMALL's size, built once, run count-only
    with the molecule state's cap and buffer lowered (the state flushes
    during pass 2) and with BAM at a band budget of
    DEPTH_SMALL_BAND_RECORDS (the hot gene's band loaded in parts); both
    held to `depth_count`'s checks, their MEX digests equal.  ref: the
    paths "ref" and "wl" of an e2e fixture, reused.  Its files stay under
    tmp/depth_small (the disk it reports is the filesystem's, other
    phases' files included)."""
    from cellranger_tpu_torch.testing.fixtures import build_depth_run

    size = dict(DEPTH_SMALL, **kw)
    n_reads = size.pop("n_reads")
    root = os.path.join(tmp, "depth_small")
    fx = build_depth_run(os.path.join(root, "fixture"), n_reads, ref=ref,
                         **size)
    try:
        c = depth_count(fx, os.path.join(root, "count"), False, root,
                        device, analysis=False,
                        state_cap=DEPTH_SMALL_STATE_CAP,
                        buffer_rows=DEPTH_SMALL_BUFFER_ROWS)
        b = depth_count(fx, os.path.join(root, "bam"), True, root, device,
                        analysis=False, band_records=DEPTH_SMALL_BAND_RECORDS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if c["mex_sha256"] != b["mex_sha256"]:
        raise AssertionError("depth_small: the BAM run's MEX differs from "
                             "the count-only run's")
    if b["bam_split"]["respooled_rows"] == 0:
        raise AssertionError("depth_small: no band past the budget")
    return dict(reads=n_reads, fixture_s=fx["fixture_s"],
                sw_launches=c["sw_launches"] + b["sw_launches"],
                count_only=c, bam=b)


def mesh_devices(n: int = MESH_ENTRIES) -> list[str]:
    """n distinct cards where the machine has them, else cuda:0 n times."""
    import torch
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def mesh_run(fx: dict, out: str, ref_out: str, ref_summary: dict, devices,
             shard_index: bool = False, device: str = "cuda",
             batch_size: int = E2E_BATCH,
             molecules: int = E2E_TOTAL_MOLECULES) -> dict:
    """The fixture count-only on a mesh of `devices`: the same metrics
    (wall excluded) and MEX bytes as the one-device run in ref_out, one
    SW launch a slice of every batch."""
    from cellranger_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=devices)
    r = count_run(fx, out, device, batch_size, mesh=mesh,
                  shard_index=shard_index)
    summary = r.pop("summary")
    diffs = _metric_diffs(summary, ref_summary) + _mex_diffs(out, ref_out)
    if diffs:
        raise AssertionError(f"mesh run (shard_index={shard_index}) differs "
                             f"from the one-device run: {diffs[:10]}")
    check_e2e_counts("mesh", r, fx["n_reads"], molecules,
                     mesh.size if device == "cuda" else 0)
    r.update(devices=[str(d) for d in mesh.devices], shard_index=shard_index,
             distinct_cards=len(mesh.distinct))
    return r


def multihost_run(fx: dict, tmp: str, device: str = "cuda",
                  n_procs: int = MULTIHOST_PROCS,
                  n_lanes: int = MULTIHOST_LANES,
                  batch_size: int = E2E_BATCH,
                  molecules: int = E2E_TOTAL_MOLECULES,
                  timeout: float = MULTIHOST_TIMEOUT_S) -> dict:
    """The fixture's reads cut into n_lanes lanes, counted by n_procs
    processes of testing/multihost_worker.py (gloo, a free local port,
    every process killed past `timeout`): host 0's metrics (wall
    excluded) and MEX equal one process's run of the same lanes, and
    every other host reports only its own lanes' reads."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.parallel.distributed import host_shard
    from cellranger_tpu_torch.pipeline.count import CountConfig, run_count
    from cellranger_tpu_torch.testing.fixtures import split_lanes
    from cellranger_tpu_torch.testing.multihost_worker import launch

    t = time.time()
    lanes = split_lanes(fx, n_lanes, os.path.join(tmp, "mh_lanes"))
    t_split = time.time() - t
    cfg = dict(fastq_pairs=lanes["pairs"], reference_path=fx["ref"],
               whitelist_path=fx["wl"], chemistry="SC3Pv3", read_len=91,
               batch_size=batch_size, secondary_analysis=False,
               checkpoint=False)
    one_out = os.path.join(tmp, "mh_one_out")
    sw.LAUNCHES = 0
    t = time.time()
    one = run_count(CountConfig(**cfg), one_out, device=device)
    t_one = time.time() - t
    one_launches = sw.LAUNCHES
    out = os.path.join(tmp, "mh_out")
    t = time.time()
    res = launch(cfg, out, n_procs, device, timeout)
    wall = time.time() - t
    bad = [(pid, r["rc"], r["err"]) for pid, r in enumerate(res)
           if r["rc"] != 0 or r["out"] is None]
    if bad:
        raise AssertionError(f"multihost: hosts failed: {bad}")
    per_lane = [fx["n_reads"] * (i + 1) // n_lanes - fx["n_reads"] * i
                // n_lanes for i in range(n_lanes)]
    for pid, r in enumerate(res):
        want = (fx["n_reads"] if pid == 0 else
                sum(host_shard(per_lane, pid, n_procs)))
        if r["out"]["total_reads"] != want:
            raise AssertionError(f"multihost: host {pid} reports "
                                 f"{r['out']['total_reads']} reads, not "
                                 f"{want}")
    with open(os.path.join(out, "metrics_summary.json")) as f:
        summary = json.load(f)
    diffs = _metric_diffs(summary, one) + _mex_diffs(out, one_out)
    if diffs:
        raise AssertionError(f"multihost: host 0's outputs differ from one "
                             f"process's: {diffs[:10]}")
    launches = sum(r["out"]["sw_launches"] for r in res)
    rep = dict(reads=summary["total_reads"],
               total_molecules=summary["total_molecules"],
               conf_mapped_frac=summary["conf_mapped_frac"],
               n_steps=sum(-(-n // batch_size) for n in per_lane),
               sw_launches=launches, wall_s=wall,
               hosts=[r["out"] for r in res],
               peak_mem_bytes=max((r["out"]["peak_mem_bytes"] or 0)
                                  for r in res) if device == "cuda" else None,
               devices=[device] * n_procs, lanes=per_lane,
               one_process_wall_s=t_one, one_process_sw_launches=one_launches,
               split_s=t_split)
    check_e2e_counts("multihost", rep, fx["n_reads"], molecules,
                     int(device == "cuda"))
    return rep


def _metric_diffs(a: dict, b: dict) -> list[str]:
    return [k for k in sorted(set(a) | set(b)) if k != "wall_time_s"
            and json.dumps(a.get(k)) != json.dumps(b.get(k))]


def _check_expected(name: str, r: dict, expected: dict) -> None:
    """A fixture's counts, known by construction, against the run's."""
    got = r.pop("summary")
    off = {k: (got.get(k), v) for k, v in expected.items()
           if got.get(k) != v}
    if off:
        raise AssertionError(f"{name}: (got, expected) {off}")
    r["expected"] = expected


def pe_parity(tmp: str, ref: dict | None, devices=("cuda", "cpu"),
              n_pairs: int = PE_PARITY_PAIRS,
              batch_size: int = PE_PARITY_BATCH, **fixture_kw) -> dict:
    """A small SC5P-PE run with BAM on each device: identical metrics, MEX
    and BAM bytes, the fixture's counts, two SW launches a step on cuda."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import run_count
    from cellranger_tpu_torch.testing.fixtures import build_pe_run

    fx = build_pe_run(os.path.join(tmp, "pe_small"), n_pairs=n_pairs,
                      ref=ref, **fixture_kw)
    n_steps = -(-fx["n_reads"] // batch_size)
    sums, outs, res = {}, {}, {}
    for dev in devices:
        outs[dev] = os.path.join(tmp, f"pe_small_{dev}")
        sw.LAUNCHES = 0
        sums[dev] = run_count(
            _count_cfg(fx, batch_size, chemistry="SC5P-PE", write_bam=True),
            outs[dev], device=dev)
        res[f"sw_launches_{dev}"] = sw.LAUNCHES
        if sw.LAUNCHES != (2 * n_steps if dev == "cuda" else 0):
            raise AssertionError(f"pe_parity on {dev}: {sw.LAUNCHES} SW "
                                 f"launches in {n_steps} steps")
    a, b = devices
    diffs = _metric_diffs(sums[a], sums[b]) + _mex_diffs(outs[a], outs[b])
    bams = []
    for dev in devices:
        with open(os.path.join(outs[dev], "possorted_genome_bam.bam"),
                  "rb") as f:
            bams.append(f.read())
    if bams[0] != bams[1]:
        diffs.append("possorted_genome_bam.bam")
    if diffs:
        raise AssertionError(f"pe_parity: {a} and {b} differ: {diffs[:10]}")
    res.update(pairs=fx["n_reads"], steps=n_steps, bam_bytes=len(bams[0]),
               bam_records=bam_records(os.path.join(
                   outs[a], "possorted_genome_bam.bam")),
               summary=sums[a])
    _check_expected("pe_parity", res, fx["expected"])
    if res["bam_records"] != 2 * fx["n_reads"]:
        raise AssertionError(f"pe_parity BAM holds {res['bam_records']} "
                             f"records for {fx['n_reads']} pairs")
    return res


def pe_run(tmp: str, ref: dict, n_pairs: int = PE_PAIRS) -> dict:
    """The full-width paired-end path on cuda, count-only."""
    from cellranger_tpu_torch.testing.fixtures import build_pe_run

    t = time.time()
    fx = build_pe_run(os.path.join(tmp, "pe"), n_pairs=n_pairs, ref=ref)
    t_fix = time.time() - t
    r = count_run(fx, os.path.join(tmp, "pe_out"), chemistry="SC5P-PE")
    _check_expected("pe", r, fx["expected"])
    if r["sw_launches"] != 2 * r["n_steps"]:
        raise AssertionError(f"pe launched the SW kernel {r['sw_launches']} "
                             f"times in {r['n_steps']} steps")
    r["fixture_s"] = t_fix
    return r


def _first_batch(fx: dict, batch_size: int):
    from cellranger_tpu_torch.io.chemistry import get_chemistry
    from cellranger_tpu_torch.io.fastq import batches_from_fastqs
    return next(iter(batches_from_fastqs(
        get_chemistry("MFRP-RNA"), fx["fq1"], fx["fq2"], batch_size,
        RTL_READ_LEN)))


def probe_aligner_outputs(fx: dict, batch, device: str, time_it: int = 0):
    """The probe aligner of a fixture's probe set on `device`, on one
    batch -> (its five outputs as one host array; with `time_it`, the
    aligner's two clocks over that many samples as `testing/sw_timing`
    takes the SW kernel's: `ms`, the device time of one call replayed
    from a CUDA graph, with no host work between its ~1,700 launches, and
    `call_ms`, one eager call between CUDA events, which waits on the
    host that issues the launches)."""
    import torch
    from cellranger_tpu_torch.io.probe_set import ProbeSet
    from cellranger_tpu_torch.ops.probes import (make_probe_aligner,
                                                 stack_outputs)
    from cellranger_tpu_torch.testing import sw_timing

    align = make_probe_aligner(ProbeSet.from_csv(fx["probes"]),
                               RTL_READ_LEN, device)
    rna = torch.from_numpy(batch.rna).to(device)
    nmask = torch.from_numpy(batch.rna_nmask).to(device)
    out = stack_outputs(align(rna, nmask)).cpu().numpy()
    ms = None
    if time_it:
        def fn():
            return align(rna, nmask)
        ms = sw_timing.time_on_device(fn, samples=time_it, per_sample=1)
        calls = sw_timing.time_calls(fn, samples=time_it)
        ms.update(call_ms=calls["ms"], call_min_ms=calls["min_ms"],
                  call_max_ms=calls["max_ms"], samples=time_it)
    return out, ms


def rtl_parity(tmp: str, devices=("cuda", "cpu"),
               batch_size: int = RTL_PARITY_BATCH) -> dict:
    """A small MFRP-RNA run on each device: identical metrics and MEX and
    the fixture's counts; the probe aligner alone on the run's first
    batch: all five outputs equal between the devices."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.ops.probes import PROBE_OUT_FIELDS
    from cellranger_tpu_torch.pipeline.count import run_count
    from cellranger_tpu_torch.testing.fixtures import build_rtl_run

    fx = build_rtl_run(os.path.join(tmp, "rtl_small"), **RTL_PARITY)
    sums, outs = {}, {}
    sw.LAUNCHES = 0
    for dev in devices:
        outs[dev] = os.path.join(tmp, f"rtl_small_{dev}")
        sums[dev] = run_count(_count_cfg(fx, batch_size, **_rtl_kw(fx)),
                              outs[dev], device=dev)
    a, b = devices
    diffs = _metric_diffs(sums[a], sums[b]) + _mex_diffs(outs[a], outs[b])
    batch = _first_batch(fx, batch_size)
    pa = [probe_aligner_outputs(fx, batch, dev)[0] for dev in devices]
    diffs += [f"probe aligner {k}" for j, k in enumerate(PROBE_OUT_FIELDS)
              if (pa[0][:, j] != pa[1][:, j]).any()]
    if diffs:
        raise AssertionError(f"rtl_parity: {a} and {b} differ: {diffs[:10]}")
    res = dict(reads=fx["n_reads"], sw_launches=sw.LAUNCHES,
               aligner_batch=int(pa[0].shape[0]),
               aligner_mapped=int(pa[0][:, PROBE_OUT_FIELDS.index(
                   "mapped")].sum()), summary=sums[a])
    _check_expected("rtl_parity", res, fx["expected"])
    if res["sw_launches"]:
        raise AssertionError("a probe run launched the SW kernel")
    return res


def rtl_run(tmp: str, n_reads: int = RTL_READS) -> dict:
    """The probe run at full scale on cuda; the probe aligner's device
    two clocks on one batch of it, taken before the run and again after
    it (the run leaves the allocator in another state)."""
    from cellranger_tpu_torch.testing.fixtures import build_rtl_run

    t = time.time()
    fx = build_rtl_run(os.path.join(tmp, "rtl"), n_reads=n_reads)
    t_fix = time.time() - t
    batch = _first_batch(fx, E2E_BATCH)
    _, ms_before = probe_aligner_outputs(fx, batch, "cuda",
                                         time_it=PROBE_TIMING_SAMPLES)
    r = count_run(fx, os.path.join(tmp, "rtl_out"), **_rtl_kw(fx))
    _check_expected("rtl", r, fx["expected"])
    if r["sw_launches"]:
        raise AssertionError("the probe run launched the SW kernel")
    r["fixture_s"] = t_fix
    r["barcode_columns"] = fx["n_wl"] * fx["n_probe_bcs"]
    _, ms_after = probe_aligner_outputs(fx, batch, "cuda",
                                        time_it=PROBE_TIMING_SAMPLES)
    r["probe_aligner_ms_per_batch"] = ms_after["ms"]
    r["probe_aligner_call_ms_per_batch"] = ms_after["call_ms"]
    r["probe_aligner_ms"] = dict(before_run=ms_before, after_run=ms_after)
    r["probe_aligner_ms_is"] = (
        f"one call at batch {E2E_BATCH}, medians of {PROBE_TIMING_SAMPLES} "
        "samples: ms = device time replayed from a CUDA graph, call_ms = "
        "an eager call between CUDA events, host launch time included")
    return r


def multi_run(tmp: str, device: str = "cuda") -> dict:
    """run_multi of a Gene Expression + Multiplexing Capture config with a
    [samples] section: every cell lands in the sample it was built for
    and each sample's outputs are there (sample_out_diffs), its secondary
    analysis (which the demux writer runs on `device` and whose failure
    it would only note) with all of its files and no error."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.testing import analysis_check as check
    from cellranger_tpu_torch.testing.fixtures import build_multi_run

    fx = build_multi_run(os.path.join(tmp, "multi"))
    out = os.path.join(tmp, "multi_out")
    sw.LAUNCHES = 0
    t = time.time()
    summary = run_multi(fx["csv"], out, fx["wl"], batch_size=GOLDEN_BATCH,
                        device=device)
    res = dict(wall_s=time.time() - t, sw_launches=sw.LAUNCHES,
               reads=summary["count"]["total_reads"],
               estimated_cells=summary["count"]["estimated_cells"],
               samples=summary["demux"]["samples"], built=fx["built"])
    if res["samples"] != fx["built"] or res["reads"] != fx["n_reads"]:
        raise AssertionError(f"multi: {res}")
    diffs = sample_out_diffs(os.path.join(out, "demux"), fx["built"])
    for sid, n in fx["built"].items():
        with open(os.path.join(out, "demux", "per_sample_outs", sid,
                               "metrics_summary.json")) as f:
            if json.load(f)["cells"] != n:
                diffs.append(f"{sid} cell count is off")
    if diffs:
        raise AssertionError(f"multi: {diffs}")
    res["analysis_files_per_sample"] = check.N_FILES
    return res



SAMPLE_MEX = "sample_filtered_feature_bc_matrix"
SAMPLE_FILES = (SAMPLE_MEX + ".h5", "sample_molecule_info.h5",
                "metrics_summary.json", "web_summary.html") + tuple(
    os.path.join(SAMPLE_MEX, f)
    for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"))


def sample_out_diffs(demux_dir: str, samples) -> list[str]:
    """Each sample's outs under demux_dir/per_sample_outs: every file of
    SAMPLE_FILES, all 16 analysis files, and no secondary_analysis_error
    (which the demux writer notes in metrics_summary.json and lets
    pass)."""
    from cellranger_tpu_torch.testing import analysis_check as check

    diffs = []
    for sid in samples:
        sdir = os.path.join(demux_dir, "per_sample_outs", sid)
        diffs += [f"{sid} lacks {f}" for f in SAMPLE_FILES
                  if not os.path.exists(os.path.join(sdir, f))]
        mpath = os.path.join(sdir, "metrics_summary.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                err = json.load(f).get("secondary_analysis_error")
            if err is not None:
                diffs.append(f"{sid}: secondary_analysis_error {err}")
        n = len(check.analysis_files(os.path.join(sdir, "analysis")))
        if n != check.N_FILES:
            diffs.append(f"{sid}: {n} analysis files")
    return diffs


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _feature_rows(mat, defs, types, ftype: str, ids) -> tuple:
    """Each barcode's total molecules of feature type `ftype` in the raw
    matrix `mat` (features x barcodes, csr), and the matrix of those rows
    in the fixture's order `ids` [len(ids), barcodes]."""
    import numpy as np

    rows = np.flatnonzero(types == ftype)
    own = {defs[i].id: j for j, i in enumerate(rows)}
    sub = mat[rows].tocsc()
    return (np.asarray(sub.sum(0)).ravel(),
            sub[[own[i] for i in ids]].tocsc())


def _planted_columns(barcodes, planted) -> tuple:
    """The column of each planted barcode ("<16 bases>-1") among a
    matrix's `barcodes`, and whether it is there."""
    import numpy as np

    bcs = np.asarray(barcodes).astype("S")
    by = (np.arange(len(bcs)) if (bcs[1:] >= bcs[:-1]).all()
          else np.argsort(bcs, kind="stable"))
    want = np.asarray(planted).astype("S")
    col = by[np.minimum(np.searchsorted(bcs[by], want), len(bcs) - 1)]
    return col, bcs[col] == want


def cellplex_outputs(fx: dict, out: str, jibes=None) -> dict:
    """What the cellplex phase holds of a run_multi output directory `out`
    of the fixture `fx` (testing.fixtures.build_cellplex_run): reads,
    molecules by library and cells called; sha256 of each decompressed
    MEX file of the run and of each sample; the tag_call column and the
    bytes of assignments.csv; with `jibes` (fit_jibes' result) its
    iterations and fitted floats; the bytes of aggregate_barcodes.csv
    (None where the run wrote none), the aggregates the run counted, and
    how many of the planted aggregates it flagged and called as cells;
    and the planted truth read back: the share of planted singlets that
    are not aggregates called to their own sample, of two-tag multiplets
    called Multiplet and of blanks called Blank, and the barcodes whose
    GEX, tag or antibody molecules in the raw matrix differ from the
    planted counts (any barcode with molecules that is not a cell counts
    as one)."""
    import numpy as np
    from cellranger_tpu_torch.io.matrix_io import (ANTIBODY_CAPTURE,
                                                   GENE_EXPRESSION,
                                                   MULTIPLEXING, CountMatrix)

    count_dir = os.path.join(out, "count")
    with open(os.path.join(count_dir, "metrics_summary.json")) as f:
        m = json.load(f)
    raw = CountMatrix.load_h5(os.path.join(count_dir,
                                           "raw_feature_bc_matrix.h5"))
    defs = raw.features.feature_defs
    types = np.asarray([f.feature_type for f in defs])
    mat = raw.m.tocsr()
    gex = np.asarray(mat[types == GENE_EXPRESSION].sum(0)).ravel()
    tag_total, tagm = _feature_rows(mat, defs, types, MULTIPLEXING,
                                    fx["tags"])
    ab_total, abm = _feature_rows(mat, defs, types, ANTIBODY_CAPTURE,
                                  fx["antibodies"])
    col, found = _planted_columns(raw.barcodes, fx["barcodes"])
    # each planted cell's tag and antibody molecules, in the fixture's
    # order
    cell_tags = np.zeros((len(found), len(fx["tags"])), np.int64)
    cell_tags[found] = tagm[:, col[found]].toarray().T
    cell_abs = np.zeros((len(found), len(fx["antibodies"])), np.int64)
    cell_abs[found] = abm[:, col[found]].toarray().T
    off = ~found
    off[found] = ((gex[col[found]] != fx["gex_molecules"][found])
                  | (cell_tags[found] != fx["tag_molecules"][found]).any(1)
                  | (cell_abs[found] != fx["ab_molecules"][found]).any(1))
    stray = np.ones(len(raw.barcodes), bool)
    stray[col[found]] = False
    n_stray = int((stray & ((gex > 0) | (tag_total > 0)
                            | (ab_total > 0))).sum())
    rep = dict(
        total_reads=m["total_reads"], total_molecules=m["total_molecules"],
        gex_molecules=int(gex.sum()), cmo_molecules=int(tag_total.sum()),
        ab_molecules=int(ab_total.sum()),
        estimated_cells=m["estimated_cells"],
        mex_sha256=mex_sha256(count_dir))
    agg_path = os.path.join(count_dir, "aggregate_barcodes.csv")
    flagged = set()
    rep["aggregate_barcodes_sha256"] = None
    if os.path.exists(agg_path):
        with open(agg_path, "rb") as f:
            text = f.read()
        rep["aggregate_barcodes_sha256"] = _sha256(text)
        flagged = {ln.split(",")[0]
                   for ln in text.decode().splitlines()[1:]}
    with gzip.open(os.path.join(count_dir, "filtered_feature_bc_matrix",
                                "barcodes.tsv.gz"), "rt") as f:
        called = set(f.read().split())
    planted = [fx["barcodes"][i] for i in fx["aggregates"]]
    rep["number_aggregate_GEMs"] = m.get("number_aggregate_GEMs", 0)
    rep["planted_aggregates_flagged"] = sum(b in flagged for b in planted)
    rep["planted_aggregates_called"] = sum(b in called for b in planted)

    demux_dir = os.path.join(out, "demux")
    with open(os.path.join(demux_dir, "assignments.csv"), "rb") as f:
        text = f.read()
    rows = [ln.split(",") for ln in text.decode().splitlines()[1:]]
    calls = {r[0]: r[1] for r in rows}
    rep["assignments_sha256"] = _sha256(text)
    rep["tag_call_sha256"] = _sha256("\n".join(r[1] for r in rows).encode())
    rep["tag_calls"] = {c: sum(r[1] == c for r in rows)
                        for c in sorted({r[1] for r in rows})}
    rep["samples"] = {}
    for sid in fx["samples"]:
        sdir = os.path.join(demux_dir, "per_sample_outs", sid)
        if not os.path.isdir(sdir):
            continue
        with open(os.path.join(sdir, "metrics_summary.json")) as f:
            cells = json.load(f)["cells"]
        digests = {}
        for name in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            with gzip.open(os.path.join(sdir, SAMPLE_MEX, name), "rb") as f:
                digests[name] = _sha256(f.read())
        rep["samples"][sid] = dict(cells=cells, mex_sha256=digests)
    if jibes is not None:
        rep["jibes"] = dict(
            n_iters=int(jibes.n_iters), converged=bool(jibes.converged),
            posterior_sum=float(np.sum(jibes.posteriors)),
            posterior_min=float(np.min(jibes.posteriors)),
            background=[float(x) for x in jibes.background],
            foreground=[float(x) for x in jibes.foreground],
            std_devs=[float(x) for x in jibes.std_devs])

    names = list(fx["tags"])
    call = np.asarray([calls.get(b, "") for b in fx["barcodes"]])
    kind, tag1 = fx["kind"], fx["tag1"]
    own = np.asarray([names[t] if t >= 0 else "" for t in tag1])
    singlet = kind == 0
    singlet[fx["aggregates"]] = False
    rep["truth"] = dict(
        singlets_own_sample=float((call == own)[singlet].mean()),
        multiplets_called_multiplet=float(
            (call == "Multiplet")[kind == 1].mean()),
        blanks_called_blank=float((call == "Blank")[kind == 2].mean()),
        barcodes_off_planted_molecules=int(off.sum()),
        stray_barcodes=n_stray)
    # (barcode, planted GEX, counted GEX, planted tags, counted tags,
    # planted antibodies, counted antibodies)
    rep["off_planted"] = [
        [fx["barcodes"][i], int(fx["gex_molecules"][i]),
         int(gex[col[i]]) if found[i] else None,
         fx["tag_molecules"][i].tolist(),
         cell_tags[i].tolist() if found[i] else None,
         fx["ab_molecules"][i].tolist(),
         cell_abs[i].tolist() if found[i] else None]
        for i in np.flatnonzero(off)[:10]]
    return rep


def cellplex_diffs(got: dict, want: dict) -> list[str]:
    """Keys of cellplex_outputs where got differs from want: JIBES' floats
    within CELLPLEX_TOL, all else exactly."""
    diffs = [k for k in sorted(set(got) | set(want))
             if k != "jibes" and json.dumps(got.get(k), sort_keys=True)
             != json.dumps(want.get(k), sort_keys=True)]
    gj, wj = got.get("jibes"), want.get("jibes")
    if (gj is None) != (wj is None):
        diffs.append("jibes")
    elif gj is not None:
        for k in sorted(set(gj) | set(wj)):
            a, b = gj.get(k), wj.get(k)
            if isinstance(b, (float, list)) and not isinstance(b, bool):
                a_, b_ = (a, b) if isinstance(b, list) else ([a], [b])
                if a_ is None or len(a_) != len(b_) or any(
                        abs(x - y) > CELLPLEX_TOL for x, y in zip(a_, b_)):
                    diffs.append(f"jibes.{k}")
            elif a != b:
                diffs.append(f"jibes.{k}")
    return diffs


def cellplex_run(fx: dict, out: str, device: str = "cuda",
                 expected: dict | None = None) -> dict:
    """run_multi of a CellPlex fixture on `device` (count, JIBES demux,
    per-sample outs, web summaries): wall seconds split by stage, K1
    launches, peak device memory and host RSS, cellplex_outputs and
    sample_out_diffs; a planted aggregate not flagged, or called as a
    cell, raises; with `expected` (the JAX package's cellplex_outputs of
    the same fixture) every difference raises.  On the card the step
    launches K1 once a GEX batch."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.analysis import run as analysis_mod
    from cellranger_tpu_torch.io import molecule_info
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.pipeline import count, demux, websummary

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sw.LAUNCHES = 0
    with rss_peak() as rss, recorded(
            (count, "run_count"), (count, "_aggregate_barcodes"),
            (demux, "fit_jibes"), (demux, "write_sample_outs"),
            (molecule_info, "subset_molecule_info"),
            (analysis_mod, "run_secondary_analysis"),
            (websummary, "build_web_summary")) as rec:
        t = time.time()
        run_multi(fx["csv"], out, fx["wl"], batch_size=E2E_BATCH,
                  device=device)
        wall = time.time() - t
    launches = sw.LAUNCHES
    rep = dict(cells=fx["n_cells"], tags=len(fx["tags"]),
               antibodies=len(fx["antibodies"]),
               aggregates=len(fx["aggregates"]), whitelist=fx["n_wl"],
               gex_reads=fx["gex_reads"], cmo_reads=fx["cmo_reads"],
               ab_reads=fx["ab_reads"], wall_s=wall, sw_launches=launches,
               peak_device_bytes=(torch.cuda.max_memory_allocated()
                                  if cuda else None),
               peak_host_rss_bytes=rss["bytes"])
    with open(os.path.join(out, "count", "_perf.json")) as f:
        laps = json.load(f)["phases"]
    phases: dict = {}
    for ph in laps:
        phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    # pass 2 laps once a batch, library by library in [libraries] order
    # (GEX, CMO, antibodies); the last lap closes the pass
    gex_batches, cmo_batches, ab_batches = (
        -(-fx[k] // E2E_BATCH) for k in ("gex_reads", "cmo_reads",
                                         "ab_reads"))
    pass2 = [ph["wall_s"] for ph in laps
             if ph["name"] == "pass2_correct_align_annotate"][:-1]
    if len(pass2) != gex_batches + cmo_batches + ab_batches:
        raise AssertionError(f"cellplex: {len(pass2)} pass-2 laps for "
                             f"{gex_batches} + {cmo_batches} + {ab_batches}"
                             " batches")
    cmo_s = sum(pass2[gex_batches:gex_batches + cmo_batches])
    ab_s = sum(pass2[gex_batches + cmo_batches:])
    sample_s = [s for s, _ in rec["write_sample_outs"]]
    rep.update(
        run_count_s=rec["run_count"][0][0], run_count_phase_s=phases,
        fb_pass2_s=cmo_s + ab_s, cmo_pass2_s=cmo_s,
        cmo_pass2_s_per_million_reads=cmo_s / (fx["cmo_reads"] / 1e6),
        ab_pass2_s=ab_s, ab_pass2_s_per_million_reads=(
            ab_s / (fx["ab_reads"] / 1e6) if fx["ab_reads"] else None),
        aggregate_s=sum(s for s, _ in rec["_aggregate_barcodes"]),
        jibes_s=rec["fit_jibes"][0][0],
        jibes_iters=int(rec["fit_jibes"][0][1].n_iters),
        sample_outs_s=sum(sample_s), slowest_sample_s=max(sample_s),
        subset_molecule_info_s=sum(s for s, _ in
                                   rec["subset_molecule_info"]),
        # the first analysis is the run's, inside run_count
        sample_analysis_s=sum(s for s, _ in
                              rec["run_secondary_analysis"][1:]),
        web_summaries_s=sum(s for s, _ in rec["build_web_summary"]))
    rep["outputs"] = got = cellplex_outputs(fx, out,
                                            rec["fit_jibes"][0][1])
    diffs = sample_out_diffs(os.path.join(out, "demux"), fx["samples"])
    if got["planted_aggregates_flagged"] != len(fx["aggregates"]):
        diffs.append(f"{got['planted_aggregates_flagged']} of "
                     f"{len(fx['aggregates'])} planted aggregates flagged")
    if got["planted_aggregates_called"]:
        diffs.append(f"{got['planted_aggregates_called']} planted "
                     "aggregates called as cells")
    if cuda and launches != gex_batches:
        diffs.append(f"{launches} K1 launches for {gex_batches} GEX steps")
    if expected is not None:
        diffs += [f"{k} differs from the JAX package's"
                  for k in cellplex_diffs(got, expected)]
    if diffs:
        raise AssertionError(f"cellplex: {diffs}; measured "
                             f"{json.dumps(rep)}; expected "
                             f"{json.dumps(expected)}")
    return rep


def cellplex(tmp: str) -> dict:
    """The cellplex phase: build_cellplex_run at CELLPLEX under tmp, its
    seconds apart as set-up, then cellplex_run on cuda held to
    CELLPLEX_EXPECTED; the fixture and outputs are deleted after."""
    from cellranger_tpu_torch.testing.fixtures import build_cellplex_run

    root = os.path.join(tmp, "cellplex")
    try:
        t = time.time()
        fx = build_cellplex_run(os.path.join(root, "fx"), **CELLPLEX)
        fixture_s = time.time() - t
        rep = cellplex_run(fx, os.path.join(root, "out"), "cuda",
                           CELLPLEX_EXPECTED)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep.update(fixture_s=fixture_s, fixture_split=fx["timing"])
    return rep


def perturb_outputs(fx: dict, out: str, fits=None) -> dict:
    """What the perturb phase holds of a run_count output directory `out`
    of the fixture `fx` (testing.fixtures.build_perturb_run): reads,
    usable reads by library (molecule_info.h5's read counts), molecules by
    feature type, cells called, sha256 of each decompressed MEX file and
    of crispr_analysis/protospacer_calls_per_cell.csv and
    protospacer_calls_summary.csv, the cells_with_{one,multiple,no}_
    protospacer_frac metrics; with `fits` (the results of call_features'
    two-Gaussian fits, one per guide that took the EM branch) how many
    guides took the EM branch and how many the MIN_UMI fallback; and the
    planted truth read back: the share of single-guide cells that are
    called and called with exactly their guide, the planted molecules
    that the run lost (`shared_umi_loss`, the fixture's `shared_umis`
    where it counts every molecule), and the barcodes whose GEX, guide or
    antibody molecules in the raw matrix differ from the planted counts
    (any barcode with molecules that is not a planted cell counts as
    one)."""
    import numpy as np
    import scipy.sparse as sp
    from cellranger_tpu_torch.io import hdf5
    from cellranger_tpu_torch.io.matrix_io import (ANTIBODY_CAPTURE,
                                                   GENE_EXPRESSION,
                                                   CountMatrix)

    with open(os.path.join(out, "metrics_summary.json")) as f:
        m = json.load(f)
    raw = CountMatrix.load_h5(os.path.join(out, "raw_feature_bc_matrix.h5"))
    defs = raw.features.feature_defs
    types = np.asarray([d.feature_type for d in defs])
    mat = raw.m.tocsr()
    gex = np.asarray(mat[types == GENE_EXPRESSION].sum(0)).ravel()
    guide_total, guidem = _feature_rows(mat, defs, types,
                                        "CRISPR Guide Capture", fx["guides"])
    ab_total, abm = _feature_rows(mat, defs, types, ANTIBODY_CAPTURE,
                                  fx["antibodies"])
    col, found = _planted_columns(raw.barcodes, fx["barcodes"])
    n, G = len(found), len(fx["guides"])
    pc, pg, pu = fx["guide_pairs"]
    planted = sp.csr_matrix((pu, (pc, pg)), shape=(n, G))
    # each planted cell's guide molecules, in the fixture's order
    cell_guides = sp.csr_matrix(guidem[:, col].T.multiply(found[:, None]))
    cell_abs = np.zeros((n, len(fx["antibodies"])), np.int64)
    cell_abs[found] = abm[:, col[found]].toarray().T
    guide_off = np.asarray((cell_guides != planted).sum(1)).ravel() > 0
    off = ~found | guide_off
    off[found] |= ((gex[col[found]] != fx["gex_molecules"][found])
                   | (cell_abs[found] != fx["ab_molecules"][found]).any(1))
    stray = np.ones(len(raw.barcodes), bool)
    stray[col[found]] = False
    n_stray = int((stray & ((gex > 0) | (guide_total > 0)
                            | (ab_total > 0))).sum())
    planted_total = (int(fx["gex_molecules"].sum()) + int(pu.sum())
                     + int(fx["ab_molecules"].sum()))
    counted = (int(gex[col[found]].sum()) + int(cell_guides.sum())
               + int(cell_abs.sum()))
    with hdf5.File(os.path.join(out, "molecule_info.h5"), "r") as f:
        lib = f["library_idx"][:].astype(np.int64)
        reads = f["count"][:].astype(np.int64)
    rep = dict(
        total_reads=m["total_reads"], total_molecules=m["total_molecules"],
        usable_reads_by_library=np.bincount(
            lib, weights=reads, minlength=len(fx["libraries"]))
        .astype(np.int64).tolist(),
        gex_molecules=int(gex.sum()), guide_molecules=int(guide_total.sum()),
        ab_molecules=int(ab_total.sum()),
        estimated_cells=m["estimated_cells"], mex_sha256=mex_sha256(out))
    for k in ("one", "multiple", "no"):
        key = f"cells_with_{k}_protospacer_frac"
        rep[key] = m[key]
    text = {}
    for name in ("protospacer_calls_per_cell", "protospacer_calls_summary"):
        with open(os.path.join(out, "crispr_analysis", name + ".csv"),
                  "rb") as f:
            text[name] = f.read()
        rep[name + "_sha256"] = _sha256(text[name])
    calls = {r.split(",")[0]: r.split(",")[2] for r in
             text["protospacer_calls_per_cell"].decode().splitlines()[1:]}
    if fits is not None:
        rep["em_guides"] = sum(float(mu[1] - mu[0]) >= 1e-6
                               for mu, _, _ in fits)
        rep["fallback_guides"] = G - rep["em_guides"]
    with gzip.open(os.path.join(out, "filtered_feature_bc_matrix",
                                "barcodes.tsv.gz"), "rt") as f:
        called = set(f.read().split())
    ids = list(fx["guides"])
    single = np.flatnonzero((fx["carried"][:, 0] >= 0)
                            & (fx["carried"][:, 1] < 0))
    rep["truth"] = dict(
        single_guide_cells=len(single),
        single_guide_cells_called=sum(fx["barcodes"][i] in called
                                      for i in single),
        single_guide_cells_own_guide=float(np.mean([
            calls.get(fx["barcodes"][i]) == ids[fx["carried"][i, 0]]
            for i in single])),
        shared_umi_loss=planted_total - counted,
        barcodes_off_planted_molecules=int(off.sum()),
        stray_barcodes=n_stray)
    rep["off_planted"] = [
        [fx["barcodes"][i], int(fx["gex_molecules"][i]),
         int(gex[col[i]]) if found[i] else None,
         planted[i].nnz, cell_guides[i].nnz,
         fx["ab_molecules"][i].tolist(),
         cell_abs[i].tolist() if found[i] else None]
        for i in np.flatnonzero(off)[:10]]
    return rep


def perturb_diffs(got: dict, want: dict) -> list[str]:
    """Keys of perturb_outputs where got differs from want (all exact)."""
    return [k for k in sorted(set(got) | set(want))
            if json.dumps(got.get(k), sort_keys=True)
            != json.dumps(want.get(k), sort_keys=True)]


@contextlib.contextmanager
def extractor_calls():
    """Record every call of the Feature Barcode extractors that run_count
    builds inside the block: yields a list of (pattern, outputs as numpy)
    in call order (process_fb calls each pattern in the feature
    reference's order, batch by batch, library by library)."""
    from cellranger_tpu_torch.pipeline import count

    made = count.make_feature_extractor
    calls: list = []

    def make(pattern, *a, **kw):
        extract = made(pattern, *a, **kw)

        def kept(rna, nmask, rna_len):
            fo = extract(rna, nmask, rna_len)
            calls.append((pattern, {k: v.cpu().numpy()
                                    for k, v in fo.items()}))
            return fo
        return kept

    count.make_feature_extractor = make
    try:
        yield calls
    finally:
        count.make_feature_extractor = made


def perturb_reads(fx: dict, calls: list, batch_size: int = E2E_BATCH
                  ) -> dict:
    """The guide library's reads through the extractors, read for read
    against the fixture's construction (`calls` of extractor_calls over a
    run whose libraries are GEX, guides, antibodies, in that order, and
    whose feature reference lists the antibodies first): each count
    {"got", "built"}.  found: every read but the N-prefixed, each at its
    guide's feature and offset; head_substitutions_exact: a substitution
    in the first bases that the 16-base word drops, found and not
    corrected; tail_substitutions_corrected; double_prefix_first_copy: a
    doubled prefix found at its first copy, with its own guide;
    n_prefix_not_extracted; merged: reads whose feature the guides'
    pattern, second, took from the antibodies' in process_fb's merge of
    patterns (every found read).  ab_library_merged: the same count over
    the antibody library, where the guides' pattern finds nothing."""
    import numpy as np
    from cellranger_tpu_torch.testing.fixtures import (PERTURB_GUIDE_LEN,
                                                       PERTURB_READ_KINDS)

    def library(first: int, n_reads: int) -> tuple:
        """Both patterns' outputs over a library's reads, batch by batch
        from call `first`; -> (antibody pattern's, guide pattern's, the
        next call)."""
        n_batches = -(-n_reads // batch_size)
        pats = [[], []]
        for b in range(n_batches):
            n = min(batch_size, n_reads - b * batch_size)
            for j in range(2):
                pats[j].append({k: v[:n] for k, v in
                                calls[first + 2 * b + j][1].items()})
        cat = [{k: np.concatenate([x[k] for x in p]) for k in p[0]}
               for p in pats]
        return cat[0], cat[1], first + 2 * n_batches

    if {p.bc_len for p, _ in calls[:2]} != {15, PERTURB_GUIDE_LEN}:
        raise AssertionError("perturb: the first calls are not the two "
                             "patterns")
    ab, g, nxt = library(0, fx["guide_reads"])
    ab2, g2, nxt = library(nxt, fx["ab_reads"])
    if nxt != len(calls):
        raise AssertionError(f"perturb: {len(calls)} extractor calls, "
                             f"{nxt} expected")
    kind = np.asarray(PERTURB_READ_KINDS)[fx["guide_read_kind"]]
    pos = fx["guide_read_sub_pos"]
    n_ab = len(fx["antibodies"])
    own = (g["feature"] == n_ab + fx["guide_read_guide"]) \
        & (g["offset"] == fx["guide_read_offset"])
    head = (kind == "substitution") & (pos >= 0) \
        & (pos < PERTURB_GUIDE_LEN - 16)
    tail = (kind == "substitution") & (pos >= PERTURB_GUIDE_LEN - 16)
    npre = kind == "n_prefix"
    merged = lambda a, b: int(((b["found"] & ~a["found"])  # noqa: E731
                               | (b["extracted"] & ~a["extracted"])).sum())
    return dict(
        found=dict(got=int((g["found"] & own).sum()),
                   built=int((~npre).sum())),
        found_any=dict(got=int(g["found"].sum()), built=int((~npre).sum())),
        head_substitutions_exact=dict(
            got=int((g["found"] & own & ~g["corrected"])[head].sum()),
            built=int(head.sum())),
        tail_substitutions_corrected=dict(
            got=int((g["found"] & own & g["corrected"])[tail].sum()),
            built=int(tail.sum())),
        corrected=dict(got=int(g["corrected"].sum()), built=int(tail.sum())),
        double_prefix_first_copy=dict(
            got=int((g["found"] & own)[kind == "double"].sum()),
            built=int((kind == "double").sum())),
        n_prefix_not_extracted=dict(got=int((~g["extracted"])[npre].sum()),
                                    built=int(npre.sum())),
        antibody_pattern_found=dict(got=int(ab["found"].sum()), built=0),
        merged=dict(got=merged(ab, g), built=int((~npre).sum())),
        ab_library_merged=dict(got=merged(ab2, g2), built=0),
        ab_library_found=dict(got=int(ab2["found"].sum()),
                              built=fx["ab_reads"]))


def perturb_run(fx: dict, out: str, device: str = "cuda",
                expected: dict | None = None, batch_size: int = E2E_BATCH,
                secondary_analysis: bool = True) -> dict:
    """run_count of a Perturb-seq fixture on `device` (GEX, CRISPR Guide
    Capture and Antibody Capture libraries, secondary analysis on): wall
    seconds and run_count's phases with each Feature Barcode library's
    pass-2 seconds and the feature assignment apart, K1 launches (one a
    GEX step on the card), peak device memory and host RSS,
    perturb_outputs (with the two-Gaussian fits caught) and perturb_reads;
    any read count off its construction, a planted barcode off its
    molecules, a call_features branch never taken or, with `expected`
    (the JAX package's perturb_outputs of the same fixture), any
    difference raises."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.analysis import feature_assigner
    from cellranger_tpu_torch.pipeline import count

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = perturb_config(fx, count, batch_size,
                         secondary_analysis=secondary_analysis)
    sw.LAUNCHES = 0
    with rss_peak() as rss, extractor_calls() as calls, recorded(
            (feature_assigner, "run_feature_assignment"),
            (feature_assigner, "_fit_two_gaussians")) as rec:
        t = time.time()
        count.run_count(cfg, out, device=device)
        wall = time.time() - t
    launches = sw.LAUNCHES
    with open(os.path.join(out, "_perf.json")) as f:
        laps = json.load(f)["phases"]
    phases: dict = {}
    for ph in laps:
        phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    gex_b, guide_b, ab_b = (-(-fx[k] // batch_size) for k in (
        "gex_reads", "guide_reads", "ab_reads"))
    pass2 = [ph["wall_s"] for ph in laps
             if ph["name"] == "pass2_correct_align_annotate"][:-1]
    if len(pass2) != gex_b + guide_b + ab_b:
        raise AssertionError(f"perturb: {len(pass2)} pass-2 laps for "
                             f"{gex_b} + {guide_b} + {ab_b} batches")
    crispr_s = sum(pass2[gex_b:gex_b + guide_b])
    ab_s = sum(pass2[gex_b + guide_b:])
    rep = dict(
        cells=fx["n_cells"], guides=len(fx["guides"]),
        antibodies=len(fx["antibodies"]), whitelist=fx["n_wl"],
        gex_reads=fx["gex_reads"], guide_reads=fx["guide_reads"],
        ab_reads=fx["ab_reads"], wall_s=wall, sw_launches=launches,
        run_count_phase_s=phases, crispr_pass2_s=crispr_s,
        crispr_pass2_s_per_million_reads=crispr_s / (fx["guide_reads"]
                                                     / 1e6),
        ab_pass2_s=ab_s, ab_pass2_s_per_million_reads=(
            ab_s / (fx["ab_reads"] / 1e6) if fx["ab_reads"] else None),
        feature_assignment_s=sum(s for s, _ in
                                 rec["run_feature_assignment"]),
        peak_device_bytes=(torch.cuda.max_memory_allocated()
                           if cuda else None),
        peak_host_rss_bytes=rss["bytes"])
    rep["reads"] = reads = perturb_reads(fx, calls, batch_size)
    rep["outputs"] = got = perturb_outputs(
        fx, out, [r for _, r in rec["_fit_two_gaussians"]])
    diffs = [f"{k}: {v['got']} of {v['built']}" for k, v in reads.items()
             if v["got"] != v["built"]]
    truth = got["truth"]
    if truth["barcodes_off_planted_molecules"] or truth["stray_barcodes"]:
        diffs.append(f"{truth['barcodes_off_planted_molecules']} barcodes "
                     f"off their planted molecules, {truth['stray_barcodes']}"
                     " stray")
    if truth["shared_umi_loss"] != fx["shared_umis"]:
        diffs.append(f"{truth['shared_umi_loss']} molecules lost")
    if not (got["em_guides"] and got["fallback_guides"]):
        diffs.append(f"call_features: {got['em_guides']} EM and "
                     f"{got['fallback_guides']} fallback guides")
    if cuda and launches != gex_b:
        diffs.append(f"{launches} K1 launches for {gex_b} GEX steps")
    if expected is not None:
        diffs += [f"{k} differs from the JAX package's"
                  for k in perturb_diffs(got, expected)]
    if diffs:
        raise AssertionError(f"perturb: {diffs}; measured "
                             f"{json.dumps(rep)}; expected "
                             f"{json.dumps(expected)}")
    return rep


def perturb_config(fx: dict, count, batch_size: int = E2E_BATCH,
                   secondary_analysis: bool = True):
    """The CountConfig of a build_perturb_run fixture for a package's
    count module: its three libraries, its cells expected."""
    return count.CountConfig(
        fastq_pairs=[], reference_path=fx["ref"], whitelist_path=fx["wl"],
        feature_ref_csv=fx["feature_ref"],
        libraries=[count.LibraryDef([pair], t)
                   for t, pair in fx["libraries"]],
        chemistry="SC3Pv3", read_len=91, batch_size=batch_size,
        recovered_cells=fx["n_cells"], checkpoint=False,
        secondary_analysis=secondary_analysis)


def perturb(tmp: str) -> dict:
    """The perturb phase: build_perturb_run at PERTURB under tmp, its
    seconds apart as set-up, then perturb_run on cuda held to
    PERTURB_EXPECTED; the fixture and outputs are deleted after."""
    from cellranger_tpu_torch.testing.fixtures import build_perturb_run

    root = os.path.join(tmp, "perturb")
    try:
        t = time.time()
        fx = build_perturb_run(os.path.join(root, "fx"), **PERTURB)
        fixture_s = time.time() - t
        rep = perturb_run(fx, os.path.join(root, "out"), "cuda",
                          PERTURB_EXPECTED)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep.update(fixture_s=fixture_s, fixture_split=fx["timing"])
    return rep


@contextlib.contextmanager
def recorded(*targets):
    """Record every call of each (owner, name) function inside the block:
    {name: [(seconds, result)]}, the device synchronized at both ends of
    a call where there is a card."""
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def wrap(name, fn):
        def timed(*a, **kw):
            sync()
            t = time.time()
            r = fn(*a, **kw)
            sync()
            rec[name].append((time.time() - t, r))
            return r
        return timed

    rec = {name: [] for _, name in targets}
    saved = [(owner, name, vars(owner)[name]) for owner, name in targets]
    for owner, name, _ in saved:
        setattr(owner, name, wrap(name, getattr(owner, name)))
    try:
        yield rec
    finally:
        for owner, name, raw in saved:
            setattr(owner, name, raw)


def analysis_run(mat, out: str, device: str) -> tuple[dict, dict]:
    """run_secondary_analysis of `mat` on `device` -> (its results; wall
    seconds, stage seconds and peak device memory)."""
    import torch
    from cellranger_tpu_torch.analysis.run import run_secondary_analysis

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    res = run_secondary_analysis(mat, out, device=device)
    return res, dict(
        wall_s=time.time() - t, stage_s=res["stage_s"],
        peak_mem_bytes=(torch.cuda.max_memory_allocated()
                        if device == "cuda" else None))


def _require_fp32_matmuls() -> None:
    import torch
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on; the analysis is float32")


def analysis(tmp: str, n_cells: int = ANALYSIS_CELLS,
             n_genes: int = ANALYSIS_GENES, dev: str = "cuda") -> dict:
    """Secondary analysis of a planted-population matrix on `dev`: 16
    files, embeddings finite and separating the populations; stage
    times, peak memory, ms a t-SNE step and a UMAP epoch (its optimizing
    loops, the device synchronized at both ends, over their steps).  The
    rerun with identical bytes is analysis_parity's, at its size."""
    import numpy as np
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.analysis import tsne, umap_tpu
    from cellranger_tpu_torch.testing import analysis_check as check
    from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix

    _require_fp32_matmuls()
    sw.LAUNCHES = 0
    t = time.time()
    mat, truth = build_analysis_matrix(n_cells, n_genes, ANALYSIS_POPS,
                                       seed=0)
    rep = dict(cells=n_cells, genes=n_genes, populations=ANALYSIS_POPS,
               fixture_s=time.time() - t)
    out = os.path.join(tmp, "analysis")
    with recorded((tsne, "_tsne_optimize"), (umap_tpu, "_optimize")) as rec:
        res, rep["run"] = analysis_run(mat, out, dev)
    rep["tsne_step_ms"] = 1e3 * rec["_tsne_optimize"][0][0] \
        / tsne.TSNE_MAX_ITER
    rep["umap_epoch_ms"] = 1e3 * rec["_optimize"][0][0] / umap_tpu.UMAP_EPOCHS
    files = check.analysis_files(out)
    if len(files) != check.N_FILES:
        raise AssertionError(f"analysis wrote {files}")
    proj = res["pca"]["transformed_pca_matrix"]
    for k in ("tsne", "umap"):
        y = res[k]
        if y.shape != (n_cells, 2) or not np.isfinite(y).all():
            raise AssertionError(f"{k}: shape {y.shape} or not finite")
        rep[f"{k}_centroid_acc"] = check.centroid_accuracy(y, truth)
        rep[f"{k}_knn_preservation"] = check.knn_preservation(proj, y,
                                                              device=dev)
        if rep[f"{k}_centroid_acc"] < check.MIN_CENTROID_ACC:
            raise AssertionError(f"{k} centroid accuracy "
                                 f"{rep[f'{k}_centroid_acc']}")
    cl = res["clusterings"]
    rep["graph_clusters"] = int(len(np.unique(cl["graphclust"])))
    rep["kmeans_8_truth_agreement"] = check.label_agreement(
        cl["kmeans_8_clusters"], truth)
    rep["sw_launches"] = sw.LAUNCHES
    return rep


def off_marker_genes(de: dict, labels, truth) -> dict:
    """{graph cluster: genes among its DIFFEXP_TOP by log2 fold change
    that are not markers of its population (most of its cells')}."""
    import numpy as np
    from cellranger_tpu_torch.testing.fixtures import ANALYSIS_MARKERS

    off = {}
    for c, r in de.items():
        pop = np.bincount(truth[labels == c]).argmax()
        top = np.argsort(-np.asarray(r["log2_fold_change"]),
                         kind="stable")[:DIFFEXP_TOP]
        off[int(c)] = int((top // ANALYSIS_MARKERS != pop).sum())
    return off


@contextlib.contextmanager
def phase_beside(name: str, log_dir: str, timeout: float, *args):
    """Run chip_smoke.<name>(*args) in a child process while the block
    runs; yields a function that waits for it (at most `timeout` seconds
    from its start) and returns its report.  The child writes its output
    to log_dir/<name>.log and is killed if the block leaves first."""
    code = (f"import json, sys, chip_smoke; r = chip_smoke.{name}("
            "*json.loads(sys.argv[1])); print('PHASE_RESULT ' + "
            "json.dumps(r), flush=True)")
    t0 = time.time()
    with open(os.path.join(log_dir, f"{name}.log"), "w+b") as log:
        p = subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(args)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)

        def result() -> dict:
            rc = p.wait(timeout=max(1.0, t0 + timeout - time.time()))
            log.seek(0)
            text = log.read().decode(errors="replace")
            found = [ln for ln in text.splitlines()
                     if ln.startswith("PHASE_RESULT ")]
            if rc or not found:
                raise AssertionError(f"{name} in a child process: exit "
                                     f"{rc}: {text[-4000:]}")
            return json.loads(found[-1][len("PHASE_RESULT "):])

        try:
            yield result
        finally:
            if p.poll() is None:
                p.kill()
            p.wait()


@contextlib.contextmanager
def rss_peak():
    """The largest resident set of this process inside the block, read
    from /proc/self/statm every 50 ms by a thread: yields a dict whose
    "bytes" holds it when the block ends."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    out, stop = {"bytes": 0}, threading.Event()

    def sample():
        while True:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page
            out["bytes"] = max(out["bytes"], rss)
            if stop.wait(0.05):
                return

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()


def analysis_68k(tmp: str, n_cells: int = ANALYSIS_68K_CELLS,
                 n_genes: int = ANALYSIS_GENES, dev: str = "cuda",
                 check_rows: int = KNN_CHECK_ROWS) -> dict:
    """The planted 8-population matrix past max_cells_tsne written as a
    filtered-matrix h5 and analyzed by the CLI's reanalyze on `dev`: the
    JAX package's file rule (no tsne/, no umap/ past it); graph clusters
    and k-means 8 against the planted populations; each graph cluster's
    top diff-exp genes among its population's markers; the kNN graph of
    the run's projection (the run's k) and _cross_knn (k = CROSS_KNN_K)
    between its two halves, each against float64 neighbours of
    check_rows seeded rows, the search's device memory within its
    budget.  Stage seconds, Louvain's seconds, h5 write and read seconds,
    peak device memory and host RSS; every check raises."""
    from cellranger_tpu_torch.align import sw

    _require_fp32_matmuls()
    t0 = time.time()
    sw.LAUNCHES = 0
    with rss_peak() as rss:
        rep = _analysis_68k(tmp, n_cells, n_genes, dev, check_rows)
    rep.update(sw_launches=sw.LAUNCHES, peak_host_rss_bytes=rss["bytes"],
               wall_s=time.time() - t0)
    diffs = rep.pop("diffs")
    if diffs:
        raise AssertionError(f"analysis_68k at {n_cells} cells: {diffs}; "
                             f"measured {json.dumps(rep)}")
    return rep


def _analysis_68k(tmp: str, n_cells: int, n_genes: int, dev: str,
                  check_rows: int) -> dict:
    """analysis_68k's run and checks: (measured, with "diffs")."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.analysis import graphclust
    from cellranger_tpu_torch.analysis import run as analysis_mod
    from cellranger_tpu_torch.analysis.batch_correction import _cross_knn
    from cellranger_tpu_torch.cli import main as cli_main
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.testing import analysis_check as check
    from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix

    cuda = torch.device(dev).type == "cuda"
    t0 = time.time()
    mat, truth = build_analysis_matrix(n_cells, n_genes, ANALYSIS_POPS,
                                       seed=0)
    rep = dict(cells=n_cells, genes=n_genes, populations=ANALYSIS_POPS,
               nonzeros=int(mat.m.nnz), fixture_s=time.time() - t0)
    h5 = os.path.join(tmp, "analysis_68k.h5")
    t = time.time()
    mat.save_h5(h5)
    rep.update(h5_write_s=time.time() - t, h5_bytes=os.path.getsize(h5))
    del mat
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with recorded((CountMatrix, "load_h5"),
                  (analysis_mod, "run_secondary_analysis"),
                  (graphclust, "louvain")) as rec:
        t = time.time()
        cli_main(["reanalyze", "--id", "analysis_68k", "--matrix", h5,
                  "--device", dev, "--output-dir", tmp])
        rep["reanalyze_s"] = time.time() - t
    rep["h5_read_s"] = rec["load_h5"][0][0]
    res = rec["run_secondary_analysis"][0][1]
    rep["stage_s"] = res["stage_s"]
    rep["louvain_s"] = rec["louvain"][0][0]
    rep["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else None)
    files = check.analysis_files(os.path.join(tmp, "analysis_68k", "outs",
                                              "analysis"))
    diffs = check.embedding_rule_diffs(files, n_cells,
                                       analysis_mod.MAX_CELLS_TSNE)
    rep["analysis_files"] = len(files)
    cl = res["clusterings"]
    rep["graph_clusters"] = int(len(np.unique(cl["graphclust"])))
    # Louvain splits a planted population into several clusters (14 for
    # 8 here), so graph clusters are held by purity and their one-to-one
    # agreement with the populations is only reported
    for key in ("graphclust", "kmeans_8_clusters"):
        rep[f"{key}_truth_agreement"] = check.label_agreement(cl[key], truth)
    rep["graphclust_purity"] = check.cluster_purity(cl["graphclust"], truth)
    for key in ("graphclust_purity", "kmeans_8_clusters_truth_agreement"):
        if rep[key] < MIN_TRUTH_AGREEMENT:
            diffs.append(f"{key} {rep[key]:.4f}")
    off = off_marker_genes(res["diffexp"]["graphclust"], cl["graphclust"],
                           truth)
    rep["off_marker_top_genes"] = sum(off.values())
    if any(off.values()):
        diffs.append(f"top diff-exp genes off their markers: {off}")
    # the run's kNN graph again, on its projection, and aggr's cross-batch
    # search between the projection's halves, against float64
    proj = res["pca"]["transformed_pca_matrix"].astype(np.float32)
    x = torch.from_numpy(proj).to(dev)
    k = min(graphclust.default_knn_k(n_cells), n_cells - 1)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t = time.time()
    idx, _ = graphclust.knn_graph(x, k)
    idx = idx.cpu().numpy()
    rep["knn_s"] = time.time() - t
    rep["knn_block_rows"] = graphclust.knn_block_rows(n_cells)
    if cuda:
        above = rep["knn_peak_bytes"] = torch.cuda.max_memory_allocated() \
            - base
        rep["knn_bytes_per_pair"] = above / (
            min(rep["knn_block_rows"], n_cells) * n_cells)
        # the budget, and the result's int64 indices and float32 distances
        if above > graphclust.KNN_BLOCK_BYTES + idx.nbytes * 3 // 2:
            diffs.append(f"the kNN search took {above} bytes of the card, "
                         f"over its budget {graphclust.KNN_BLOCK_BYTES}")
    bad, rep["knn_check"] = check.sampled_knn_check(
        proj, proj, idx, check_rows, exclude_self=True)
    if bad:
        diffs.append(f"knn_graph (k = {k}) differs from float64 at "
                     f"{bad[:10]}")
    half = n_cells // 2
    t = time.time()
    cidx = _cross_knn(proj[:half], proj[half:], CROSS_KNN_K, dev)
    rep["cross_knn_s"] = time.time() - t
    bad, rep["cross_knn_check"] = check.sampled_knn_check(
        proj[:half], proj[half:], cidx, check_rows)
    if bad:
        diffs.append(f"_cross_knn (k = {CROSS_KNN_K}) differs from float64 "
                     f"at {bad[:10]}")
    rep["diffs"] = diffs
    return rep


def analysis_parity(tmp: str, n_cells: int = ANALYSIS_PARITY_CELLS,
                    n_genes: int = ANALYSIS_PARITY_GENES,
                    devices=("cuda", "cpu")) -> dict:
    """Secondary analysis on devices[0] against devices[1] under
    testing.analysis_check's tolerances: the analysis/ files, the
    clusterings of one projection on both devices, and the t-SNE and
    UMAP steps over a short horizon; a second run on devices[0] writes
    identical analysis/ bytes."""
    from cellranger_tpu_torch.testing import analysis_check as check
    from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix

    _require_fp32_matmuls()
    dev, ref = devices
    mat, truth = build_analysis_matrix(n_cells, n_genes, ANALYSIS_POPS,
                                       seed=0)
    rep = dict(cells=n_cells, genes=n_genes, populations=ANALYSIS_POPS)
    outs = [os.path.join(tmp, f"analysis_parity_{i}") for i in (0, 1, 2)]
    res, rep[f"run_{ref}"] = analysis_run(mat, outs[0], ref)
    _, rep[f"run_{dev}"] = analysis_run(mat, outs[1], dev)
    _, rep[f"rerun_{dev}"] = analysis_run(mat, outs[2], dev)
    diffs, rep["files"] = check.compare_analysis(
        outs[0], outs[1], truth, device=dev,
        min_label_agreement=check.DEVICE_AGREEMENT)
    files = check.analysis_files(outs[1])
    if check.analysis_files(outs[2]) != files or [
            f for f in files if not check.same_bytes(
                os.path.join(outs[1], f), os.path.join(outs[2], f))]:
        diffs.append(f"two {dev} runs wrote different analysis/ bytes")
    proj = res["pca"]["transformed_pca_matrix"]
    d2, rep["same_projection"] = check.same_projection_labels(proj, ref, dev)
    d3, rep["short_horizon"] = check.short_horizon(proj, ref, dev)
    if diffs + d2 + d3:
        raise AssertionError(f"{dev} against {ref} at {n_cells} cells: "
                             f"{diffs + d2 + d3}; measured {json.dumps(rep)}")
    return rep


def analysis_both(tmp: str) -> dict:
    """`analysis` and then `analysis_parity`, in one child process of
    main, each report under its name."""
    return dict(analysis=analysis(tmp), analysis_parity=analysis_parity(tmp))


def file_tree(root: str, gunzip: bool = False) -> dict:
    """{relative path: bytes} of every file under root (decompressed with
    `gunzip`: gzip headers carry a time stamp)."""
    opener = gzip.open if gunzip else open
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with opener(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def tree_diffs(a: str, b: str) -> list[str]:
    """Files present under one root only, then files whose bytes differ."""
    ta, tb = file_tree(a), file_tree(b)
    return (sorted(set(ta) ^ set(tb))
            + sorted(k for k in set(ta) & set(tb) if ta[k] != tb[k]))


def _equal_arrays(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or (g != w).any():
            raise AssertionError(f"{what}: output {i} differs ({g.dtype} "
                                 f"{g.shape} against {w.dtype} {w.shape})")


class _Recorder:
    """Wraps pipeline/vdj.py's count_bc_umi_kmers for one run: keeps the
    rows it was handed and its device-synchronized seconds."""

    def __init__(self, device: str):
        from cellranger_tpu_torch.pipeline import vdj
        self.vdj, self.real, self.device = vdj, vdj.count_bc_umi_kmers, device
        self.calls, self.seconds, self.end = [], 0.0, None

    def __call__(self, *args, **kw):
        import torch
        sync = (torch.cuda.synchronize if self.device == "cuda"
                else (lambda: None))
        sync()
        t = time.time()
        out = self.real(*args, **kw)
        sync()
        self.end = time.time()
        self.seconds += self.end - t
        self.calls.append((args, out))
        return out

    def __enter__(self):
        self.vdj.count_bc_umi_kmers = self
        return self

    def __exit__(self, *exc):
        self.vdj.count_bc_umi_kmers = self.real


def _vdj_cfg(fx: dict, **kw):
    from cellranger_tpu_torch.pipeline.vdj import VdjConfig
    return VdjConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                     vdj_reference_fasta=fx["fa"], whitelist_path=fx["wl"],
                     chemistry=fx["chemistry"], read_len=fx["read_len"],
                     **kw)


def vdj_parity(tmp: str, devices=("cuda", "cpu"),
               chunk: int = VDJ_PARITY_CHUNK) -> dict:
    """run_vdj of the tests' single-end and paired-end worlds on each
    device: every output file equal; count_bc_umi_kmers on the rows the
    first device's run handed it, in blocks of `chunk` kmer rows, equal to
    that run's arrays on both devices."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.vdj import run_vdj
    from cellranger_tpu_torch.testing import fixtures
    from cellranger_tpu_torch.vdj.assembly import K, count_bc_umi_kmers

    res = dict(sw_launches=0)
    for name, build in (("single", fixtures.build_vdj_single_world),
                        ("paired", fixtures.build_vdj_paired_world)):
        fx = build(os.path.join(tmp, f"vdj_{name}"))
        sums, outs = [], []
        for i, dev in enumerate(devices):
            outs.append(os.path.join(tmp, f"vdj_{name}_{i}_{dev}"))
            sw.LAUNCHES = 0
            with _Recorder(dev) as rec:
                sums.append(run_vdj(_vdj_cfg(fx, batch_size=fx["batch_size"]),
                                    outs[-1], device=dev))
            res["sw_launches"] += sw.LAUNCHES
            if i == 0:
                (rows, want), = rec.calls
        diffs = tree_diffs(*outs)
        if sums[0] != sums[1] or diffs:
            raise AssertionError(f"vdj_parity {name}: {devices[0]} and "
                                 f"{devices[1]} differ: {diffs[:10]}")
        reads_per_block = max(1, chunk // (rows[2].shape[1] - K + 1))
        for dev in devices:
            _equal_arrays(count_bc_umi_kmers(*rows, chunk=chunk, device=dev),
                          want, f"vdj_parity {name} kmers in blocks on {dev}")
        res[name] = dict(reads=sums[0]["total_reads"],
                         cells=sums[0]["estimated_cells"],
                         clonotypes=sums[0]["n_clonotypes"],
                         files=len(file_tree(outs[0])),
                         kmer_rows=len(want[0]),
                         kmers=int(want[3].sum()),
                         blocks=-(-len(rows[0]) // reads_per_block))
    if res["sw_launches"]:
        raise AssertionError("a V(D)J run launched the SW kernel")
    return res


def _cell_cdr3s(out: str) -> dict:
    """{barcode: sorted [chain, cdr3_nt]} of the productive contigs of the
    cells in filtered_contig_annotations.csv."""
    import csv
    got: dict = {}
    with open(os.path.join(out, "filtered_contig_annotations.csv")) as f:
        for r in csv.DictReader(f):
            if r["productive"] == "True":
                got.setdefault(r["barcode"], []).append(
                    [r["chain"], r["cdr3_nt"]])
    return {b: sorted(v) for b, v in got.items()}


def _pairs(b, u) -> int:
    """Distinct (barcode, UMI) pairs of a kmer spectrum."""
    import numpy as np
    return len(np.unique((b.astype(np.uint64) << np.uint64(32)) | u))


def tree_sha256(root: str) -> dict:
    """{relative path: sha256} of every file under root."""
    return {k: _sha256(v) for k, v in sorted(file_tree(root).items())}


def _per_barcode_diffs(what: str, got: dict, want: dict) -> list[str]:
    """One line naming the barcodes (the first 5) whose values differ."""
    off = sorted(b for b in set(got) | set(want) if got.get(b) != want.get(b))
    return [f"{what} of {len(off)} barcodes differ: " + "; ".join(
        f"{b} got {got.get(b)}, expected {want.get(b)}" for b in off[:5])
            ] if off else []


def vdj_truth_diffs(fx: dict, out: str, summary: dict,
                    bc_umi_pairs: int) -> list[str]:
    """A V(D)J run's outputs against its fixture's truth: the cells (and
    no non-cell barcode among them), reads, clonotypes as a partition of
    the cells, each cell's CDR3 nucleotides and its V and J gene per
    chain, the (barcode, UMI) pairs of the kmer spectrum."""
    exp = fx["expected"]
    got = dict(total_reads=summary["total_reads"],
               estimated_cells=summary["estimated_cells"],
               n_clonotypes=summary["n_clonotypes"], cdr3s=_cell_cdr3s(out),
               bc_umi_pairs=bc_umi_pairs)
    diffs = [f"{k}: got {got[k]}, expected {v}" for k, v in exp.items()
             if k != "cdr3s" and got[k] != v]
    diffs += _per_barcode_diffs("CDR3s", got["cdr3s"], exp["cdr3s"])
    with open(os.path.join(out, "cell_barcodes.json")) as f:
        cells = json.load(f)
    if cells != sorted(exp["cdr3s"]):
        diffs.append("cell barcodes are not the fixture's")
    truth = fx.get("truth")
    if truth is None:
        return diffs
    if set(cells) & set(truth["background"]):
        diffs.append("a non-cell barcode was called a cell")
    with open(os.path.join(out, "all_contig_annotations.json")) as f:
        contigs = json.load(f)
    genes, clono = {}, {}
    for r in contigs:
        if not r["is_cell"]:
            continue
        clono.setdefault(r["clonotype"], []).append(r["barcode"])
        if r["productive"]:
            names = {a["feature"]["region_type"]: a["feature"]["gene_name"]
                     for a in r["annotations"]}
            genes.setdefault(r["barcode"], []).append(
                [r["chain"], names.get("V-REGION"), names.get("J-REGION")])
    diffs += _per_barcode_diffs(
        "V and J genes", {b: sorted(v) for b, v in genes.items()},
        truth["genes"])
    if sorted(sorted(set(v)) for v in clono.values()) \
            != truth["clonotypes"]:
        diffs.append("clonotypes are not the fixture's partition")
    return diffs


def _vdj_split_report(split: dict) -> dict:
    """The figures of pipeline.vdj.LAST_SPLIT that vdj_run and vdj_b_run
    report."""
    return dict(
        host_split_s={k: split[k] for k in (
            "skip_s", "graph_s", "graph_wait_s", "support_s",
            "annotation_s", "quals_s", "outputs_s")},
        graph_workers=split["graph_workers"],
        kmer_blocks=split.get("kmer_blocks"),
        kmer_block_rows_max=split.get("kmer_block_rows_max"),
        barcodes_assembled=split["barcodes"],
        barcodes_skipped=split["barcodes_skipped"],
        contigs_supported=split["contigs"],
        contigs_annotated=split["annotated"],
        alignments=split["alignments"],
        alignments_per_contig=(split["alignments"]
                               / max(split["annotated"], 1)))


def vdj_run(tmp: str, n_cells: int = VDJ_CELLS,
            pairs_per_cell: int = VDJ_PAIRS_PER_CELL, device: str = "cuda",
            batch_size: int = VDJ_BATCH, keep: bool = False) -> dict:
    """A T-cell library (fixtures.vdj_library_kw) through run_vdj on
    `device`, held to the fixture's truth (vdj_truth_diffs).  Reports the
    fixture's seconds and peak RSS, wall, pass 1 and pass 2
    (reads_to_kmers_s), the kmer spectrum's device-synchronized seconds,
    blocks and largest block, the host assembly's seconds split into
    graph and assembly (summed over the worker processes, and this
    process's wait for them), support, annotation, quals and clonotypes
    plus outputs, seconds a cell, the barcodes assembled and skipped,
    local alignments a contig, peak device memory, peak host RSS (of
    this process: the graph workers hold a task's spectrum rows each)
    and MemTotal.  The fixture and outputs are deleted after unless
    `keep`."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline import vdj
    from cellranger_tpu_torch.testing.fixtures import (build_vdj_run,
                                                       vdj_library_kw)

    root = os.path.join(tmp, f"vdj_{n_cells}")
    try:
        t = time.time()
        with rss_peak() as fix_rss:
            fx = build_vdj_run(os.path.join(root, "fx"), n_cells,
                               pairs_per_cell, **vdj_library_kw(n_cells))
        t_fix = time.time() - t
        out = os.path.join(root, "out")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sw.LAUNCHES = 0
        with rss_peak() as rss, _Recorder(device) as rec:
            t = time.time()
            s = vdj.run_vdj(_vdj_cfg(fx, batch_size=batch_size), out,
                            device=device)
            t_end = time.time()
        split = dict(vdj.LAST_SPLIT)
        diffs = vdj_truth_diffs(fx, out, s, _pairs(*rec.calls[0][1][:2]))
        files = tree_sha256(out) if keep else None
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    host = t_end - rec.end
    rep = dict(cells=n_cells, pairs_per_cell=pairs_per_cell,
               reads=s["total_reads"], clonotypes=s["n_clonotypes"],
               background_barcodes=len(fx["truth"]["background"]),
               background_pairs=fx["truth"]["background_pairs"],
               sw_launches=sw.LAUNCHES, fixture_s=t_fix,
               fixture_peak_rss_bytes=fix_rss["bytes"], wall_s=t_end - t,
               kmers_s=rec.seconds,
               reads_to_kmers_s=rec.end - rec.seconds - t,
               pass1_s=split["pass1_s"], pass2_s=split["pass2_s"],
               host_assembly_s=host, **_vdj_split_report(split),
               host_s_per_cell=host / n_cells,
               kmer_rows=len(rec.calls[0][1][0]),
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
               peak_host_rss_bytes=rss["bytes"],
               mem_total_bytes=memory_report(device)["mem_total_bytes"])
    if files is not None:
        rep["files"] = files
    if diffs:
        raise AssertionError(f"vdj at {n_cells} cells: {diffs}; measured "
                             f"{json.dumps(rep)}")
    if sw.LAUNCHES:
        raise AssertionError("the V(D)J run launched the SW kernel")
    return rep


def vdj_held(tmp: str, device: str = "cuda") -> dict:
    """vdj_run of VDJ_HELD_CELLS cells of the same design, every output
    file's sha256 equal to the JAX package's run (VDJ_EXPECTED)."""
    rep = vdj_run(tmp, VDJ_HELD_CELLS, VDJ_PAIRS_PER_CELL, device, keep=True)
    files = rep.pop("files")
    off = sorted(k for k in set(files) | set(VDJ_EXPECTED)
                 if files.get(k) != VDJ_EXPECTED.get(k))
    if off:
        raise AssertionError(f"vdj_held: files differ from the JAX "
                             f"package's run: {off}; got {files}")
    rep["files_equal"] = len(files)
    return rep


def _expected_rows(plasma: dict, batch_size: int, cap: int):
    """The packed UMIs of a barcode's first `cap` rows in the original's
    order: per batch of batch_size pairs its pairs' mate-1 rows, then
    their mate-2 rows (plasma: the fixture's "pairs" indices, ascending,
    and their "umi")."""
    import numpy as np

    batch = plasma["pairs"] // batch_size
    cut = np.flatnonzero(np.diff(batch)) + 1
    return np.concatenate([np.concatenate([u, u]) for u in np.split(
        plasma["umi"], cut)])[:cap]


def _barcode_names(wl_path: str, idx) -> list[str]:
    """The names run_vdj gives whitelist indices: "<16 bases>-1"."""
    import numpy as np
    from cellranger_tpu_torch.io.whitelist import Whitelist
    from cellranger_tpu_torch.ops import encode

    wl = Whitelist.load(wl_path)
    codes = encode.unpack_np(np.asarray(wl.sorted_seqs)[list(idx)],
                             wl.length)
    return [encode.decode_codes(c).decode() + "-1" for c in codes]


def vdj_b_truth_diffs(fx: dict, out: str, summary: dict, bc_umi_pairs: int,
                      rows: dict | None = None,
                      batch_size: int = VDJ_BATCH,
                      cap: int | None = None) -> list[str]:
    """vdj_truth_diffs of a B-cell run (fixtures.build_vdj_b_run), and
    each cell's C gene per chain; with `rows` ({whitelist index: packed
    UMIs of the rows the port's support was built from}) every plasma
    barcode's rows exactly its first `cap` (default
    vdj_max_reads_per_barcode) in the original's order at batch_size."""
    import numpy as np
    from cellranger_tpu_torch import params

    diffs = vdj_truth_diffs(fx, out, summary, bc_umi_pairs)
    with open(os.path.join(out, "all_contig_annotations.json")) as f:
        contigs = json.load(f)
    c_genes: dict = {}
    for r in contigs:
        if r["is_cell"] and r["productive"]:
            names = {a["feature"]["region_type"]: a["feature"]["gene_name"]
                     for a in r["annotations"]}
            c_genes.setdefault(r["barcode"], []).append(
                [r["chain"], names.get("C-REGION")])
    diffs += _per_barcode_diffs("C genes",
                                {b: sorted(v) for b, v in c_genes.items()},
                                fx["truth"]["c_genes"])
    if rows is None:
        return diffs
    cap = int(params.get("vdj_max_reads_per_barcode")) if cap is None \
        else cap
    name = dict(zip(_barcode_names(fx["wl"], rows), rows))
    for b, p in sorted(fx["truth"]["plasma"].items()):
        got = rows.get(name.get(b))
        want = _expected_rows(p, batch_size, cap)
        if got is None or not np.array_equal(got, want):
            diffs.append(f"plasma barcode {b}: support built from "
                         f"{None if got is None else len(got)} rows, not "
                         f"its first {len(want)} of {p['rows']}")
    return diffs


@contextlib.contextmanager
def vdj_barcode_clock(keep_rows: int = 0):
    """Per barcode assembled by a run_vdj inside the block, in the order
    pipeline/vdj.py takes them (whitelist order): its whitelist index
    ("barcode"), spectrum rows, graph seconds (graph, cleaning and
    assembly, in a worker process) and host seconds (those and this
    process's seconds on it), from LAST_SPLIT["by_barcode"]; and
    {whitelist index: value} dicts of the seconds of its support (the
    BarcodeSupport's K-mers and UMI support), its rows, and the packed
    UMIs of those rows where it has more than `keep_rows`.  Yields a dict
    with lists "barcode", "graph_s", "host_s", "spectrum_rows", and
    dicts "support_s", "reads", "rows"."""
    from cellranger_tpu_torch.pipeline import vdj
    from cellranger_tpu_torch.vdj import support

    out = dict(support_s={}, reads={}, rows={})
    cur = {}

    class Store(support.ReadStore):
        def reads(self, bc):
            rd = super().reads(bc)
            cur["bc"] = bc
            out["reads"][bc] = len(rd.umi)
            if len(rd.umi) > keep_rows:
                out["rows"][bc] = rd.umi.copy()
            return rd

    class Support(support.BarcodeSupport):
        def __init__(self, *a, **kw):
            t = time.perf_counter()
            super().__init__(*a, **kw)
            self._bc = cur["bc"]
            out["support_s"][self._bc] = time.perf_counter() - t

        def umi_support(self, *a, **kw):
            t = time.perf_counter()
            super().umi_support(*a, **kw)
            out["support_s"][self._bc] += time.perf_counter() - t

    saved = support.ReadStore, support.BarcodeSupport
    support.ReadStore, support.BarcodeSupport = Store, Support
    try:
        yield out
    finally:
        support.ReadStore, support.BarcodeSupport = saved
        by = vdj.LAST_SPLIT.get("by_barcode", {})
        out.update(barcode=by.get("barcode", []),
                   spectrum_rows=by.get("spectrum_rows", []),
                   graph_s=by.get("graph_s", []),
                   host_s=[g + h for g, h in zip(by.get("graph_s", []),
                                                 by.get("host_s", []))])


def vdj_b_run(tmp: str, n_cells: int = VDJ_B_CELLS,
              pairs_per_cell: int = VDJ_B_PAIRS_PER_CELL,
              device: str = "cuda", plasma_pairs: int | None = None,
              families=None, keep: bool = False) -> dict:
    """A B-cell library (fixtures.build_vdj_b_run with vdj_b_library_kw)
    through run_vdj on `device`, held to the fixture's truth
    (vdj_b_truth_diffs: cells, CDR3s, V, J and C genes, the clonotype
    partition, every plasma barcode's support from its first
    vdj_max_reads_per_barcode rows).  Reports what vdj_run reports, and
    the clonotypes joined across a CDR3 subclone or a class switch, the
    plasma barcodes and their rows, the heaviest barcode's spectrum
    rows, reads, graph and support seconds, and host seconds a cell for
    the plasma cells and the other cells apart."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline import vdj
    from cellranger_tpu_torch.testing.fixtures import (build_vdj_b_run,
                                                       vdj_b_library_kw)

    root = os.path.join(tmp, f"vdj_b_{n_cells}")
    try:
        t = time.time()
        fx = build_vdj_b_run(os.path.join(root, "fx"), n_cells,
                             pairs_per_cell, plasma_pairs=plasma_pairs,
                             families=families, **vdj_b_library_kw(n_cells))
        t_fix = time.time() - t
        out = os.path.join(root, "out")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sw.LAUNCHES = 0
        with rss_peak() as rss, _Recorder(device) as rec, \
                vdj_barcode_clock(keep_rows=2 * pairs_per_cell) as clock:
            t = time.time()
            s = vdj.run_vdj(_vdj_cfg(fx, batch_size=VDJ_BATCH), out,
                            device=device)
            t_end = time.time()
        split = dict(vdj.LAST_SPLIT)
        kb = rec.calls[0][1][0]
        diffs = vdj_b_truth_diffs(fx, out, s, _pairs(*rec.calls[0][1][:2]),
                                  rows=clock["rows"])
        files = tree_sha256(out) if keep else None
        order = clock["barcode"]                # the barcodes assembled
        names = _barcode_names(fx["wl"], order)
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    truth = fx["truth"]
    host = dict(zip(names, clock["host_s"]))
    plasma = sorted(truth["plasma"])
    other = sorted(set(truth["kinds"]) - set(plasma))
    k = int(np.argmax(clock["spectrum_rows"]))
    heavy = order[k]
    t_host = t_end - rec.end
    rep = dict(cells=n_cells, pairs_per_cell=pairs_per_cell,
               reads=s["total_reads"], clonotypes=s["n_clonotypes"],
               kinds={x: list(truth["kinds"].values()).count(x)
                      for x in ("naive", "memory", "plasma")},
               families=sum(len(c) > 1 for c in truth["clonotypes"]),
               joined_across_cdr3_subclone=len(truth["subclones"]),
               joined_across_class_switch=len(truth["switched"]),
               background_barcodes=len(truth["background"]),
               background_pairs=truth["background_pairs"],
               plasma_cells=len(plasma),
               plasma_rows={b: truth["plasma"][b]["rows"] for b in plasma},
               plasma_support_rows=sorted({clock["reads"].get(bc) for bc, n
                                           in zip(order, names)
                                           if n in truth["plasma"]}),
               sw_launches=sw.LAUNCHES, fixture_s=t_fix, wall_s=t_end - t,
               kmers_s=rec.seconds,
               reads_to_kmers_s=rec.end - rec.seconds - t,
               pass1_s=split["pass1_s"], pass2_s=split["pass2_s"],
               host_assembly_s=t_host, **_vdj_split_report(split),
               host_s_per_cell=t_host / n_cells,
               host_s_per_plasma_cell=(sum(host.get(b, 0.0) for b in plasma)
                                       / len(plasma)),
               host_s_per_other_cell=(sum(host.get(b, 0.0) for b in other)
                                      / len(other)),
               host_s_background=sum(v for b, v in host.items()
                                     if b not in truth["kinds"]),
               heaviest_barcode=dict(
                   barcode=names[k], plasma=names[k] in truth["plasma"],
                   spectrum_rows=clock["spectrum_rows"][k],
                   reads=clock["reads"].get(heavy),
                   graph_s=clock["graph_s"][k],
                   support_s=clock["support_s"].get(heavy),
                   host_s=clock["host_s"][k]),
               kmer_rows=len(kb),
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
               peak_host_rss_bytes=rss["bytes"])
    if files is not None:
        rep["files"] = files
    if diffs:
        raise AssertionError(f"vdj_b at {n_cells} cells: {diffs}; measured "
                             f"{json.dumps(rep)}")
    if sw.LAUNCHES:
        raise AssertionError("the V(D)J run launched the SW kernel")
    return rep


def vdj_t_and_held(tmp: str, device: str = "cuda") -> dict:
    """The vdj and vdj_b_held phases, one after the other (a child process
    beside vdj_parity..human_scale): their reports."""
    return dict(vdj=vdj_run(tmp, device=device),
                vdj_b_held=vdj_b_held(tmp, device))


def vdj_b_held(tmp: str, device: str = "cuda") -> dict:
    """vdj_b_run of VDJ_B_HELD_CELLS cells of the same design, one plasma
    cell at VDJ_B_HELD_PLASMA_PAIRS pairs (past the real read cap) and a
    family of VDJ_B_HELD_FAMILIES cells with a CDR3 subclone: every
    output file's sha256 equal to the JAX package's run (VDJ_B_EXPECTED,
    tests/vdj_b_reference.py)."""
    rep = vdj_b_run(tmp, VDJ_B_HELD_CELLS, VDJ_B_PAIRS_PER_CELL, device,
                    plasma_pairs=VDJ_B_HELD_PLASMA_PAIRS,
                    families=VDJ_B_HELD_FAMILIES, keep=True)
    files = rep.pop("files")
    off = sorted(k for k in set(files) | set(VDJ_B_EXPECTED)
                 if files.get(k) != VDJ_B_EXPECTED.get(k))
    if off:
        raise AssertionError(f"vdj_b_held: files differ from the JAX "
                             f"package's run: {off}; got {files}")
    rep["files_equal"] = len(files)
    return rep


def immune_truth_diffs(fx: dict, out: str, summary: dict) -> list[str]:
    """A run_multi of fixtures.build_immune_run against the well's truth:
    the GEX library's reads, confidently mapped and improper pairs,
    molecules and cells (every cell of the well, no other barcode); each
    V(D)J library's reads, cells, clonotypes as the fixture's partition
    (every planted dropout in its clone, by the subset merge), each
    cell's CDR3s and V and J genes per chain, two alphas or two lights
    where planted (vdj_truth_diffs), and the B library's C genes
    (vdj_b_truth_diffs)."""
    with open(os.path.join(out, "count", "metrics_summary.json")) as f:
        m = json.load(f)
    with gzip.open(os.path.join(out, "count", "filtered_feature_bc_matrix",
                                "barcodes.tsv.gz"), "rt") as f:
        cells = sorted(f.read().split())
    diffs = [f"gex {k}: got {m.get(k)}, expected {v}"
             for k, v in fx["gex"]["expected"].items() if m.get(k) != v]
    if cells != fx["gex"]["cells"]:
        diffs.append(f"gex cells: {len(cells)} called, not the well's "
                     f"{len(fx['gex']['cells'])}")
    for lib, check in (("vdj_t", vdj_truth_diffs),
                       ("vdj_b", vdj_b_truth_diffs)):
        diffs += [f"{lib}: {d}" for d in check(
            fx[lib], os.path.join(out, "vdj", lib), summary["vdj"][lib],
            None)]
    return diffs


def immune_merges(fx: dict, out: str) -> dict:
    """Per V(D)J library, the planted dropout cells the run put in one
    clonotype with the rest of their clone, against the fixture's
    count, and the clones of those with a dominant-superset case."""
    rep = {}
    for lib in ("vdj_t", "vdj_b"):
        with open(os.path.join(out, "vdj", lib,
                               "all_contig_annotations.json")) as f:
            clono = {r["barcode"]: r["clonotype"] for r in json.load(f)
                     if r["is_cell"]}
        merged = fx[lib]["truth"]["merged"]
        joined = sum(
            sum(clono.get(b) is not None and clono.get(b) == clono.get(
                next(x for x in m["clone"] if x not in m["joined"]))
                for b in m["joined"]) for m in merged)
        rep[lib] = dict(planted=sum(len(m["joined"]) for m in merged),
                        joined=joined, clones=len(merged),
                        dominant=sum(m["dominant"] for m in merged))
    return rep


def immune_digest(out: str) -> dict:
    """{path: sha256} of what a run_multi of an immune well must write
    alike on every device and in both packages: every file under vdj/,
    the count's MEX files decompressed (gzip headers carry a time),
    filtered_barcodes.csv and per_barcode_metrics.csv, and both
    metrics_summary.json files read back without wall_time_s.  Not held
    here: the count's h5 files (h5py and io/hdf5.py lay out equal data in
    other bytes; the tests hold them by h5_parity_diffs), analysis/
    (floats held by tolerance between devices), _perf.json and the web
    summaries of count and multi (times)."""
    count = os.path.join(out, "count")
    got = {f"vdj/{k}": v for k, v in tree_sha256(os.path.join(
        out, "vdj")).items()}
    got.update({f"count/{k}": v for k, v in mex_sha256(count).items()})
    for f in ("filtered_barcodes.csv", "per_barcode_metrics.csv"):
        with open(os.path.join(count, f), "rb") as fh:
            got[f"count/{f}"] = _sha256(fh.read())
    for f in ("count/metrics_summary.json", "metrics_summary.json"):
        with open(os.path.join(out, f)) as fh:
            m = json.load(fh)
        m.pop("wall_time_s", None)
        got[f] = _sha256(json.dumps(m, sort_keys=True).encode())
    return dict(sorted(got.items()))


def immune_held(tmp: str, device: str = "cuda") -> dict:
    """The small immune well (IMMUNE_HELD, plans IMMUNE_HELD_T_PLAN and
    IMMUNE_HELD_B_PLAN: two-alpha T clones with a dominant-superset case,
    a two-light B clone with a dropout sibling) through the port's
    run_multi on `device`: the fixture's truth (immune_truth_diffs) and
    immune_digest equal to the JAX package's CPU run (IMMUNE_EXPECTED,
    tests/immune_reference.py); the GEX library's K1 launches, two a
    step on cuda."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.testing.fixtures import build_immune_run

    root = os.path.join(tmp, "immune_held")
    try:
        t = time.time()
        fx = build_immune_run(os.path.join(root, "fx"), **IMMUNE_HELD,
                              t_plan=IMMUNE_HELD_T_PLAN,
                              b_plan=IMMUNE_HELD_B_PLAN)
        t_fix = time.time() - t
        out = os.path.join(root, "out")
        sw.LAUNCHES = 0
        t = time.time()
        s = run_multi(fx["csv"], out, fx["wl"], batch_size=IMMUNE_HELD_BATCH,
                      device=device)
        wall = time.time() - t
        launches = sw.LAUNCHES
        diffs = immune_truth_diffs(fx, out, s)
        merges = immune_merges(fx, out)
        files = immune_digest(out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    off = sorted(k for k in set(files) | set(IMMUNE_EXPECTED)
                 if files.get(k) != IMMUNE_EXPECTED.get(k))
    if off:
        diffs.append(f"files differ from the JAX package's run: {off}")
    steps = -(-fx["gex"]["n_reads"] // IMMUNE_HELD_BATCH)
    if launches != (2 * steps if device == "cuda" else 0):
        diffs.append(f"{launches} K1 launches in {steps} GEX steps")
    rep = dict(cells=fx["kinds"], reads=dict(
        gex=fx["gex"]["n_reads"], vdj_t=fx["vdj_t"]["n_reads"],
        vdj_b=fx["vdj_b"]["n_reads"]), merges=merges,
        clonotypes={lib: s["vdj"][lib]["n_clonotypes"]
                    for lib in ("vdj_t", "vdj_b")},
        sw_launches=launches, fixture_s=t_fix, wall_s=wall,
        files_equal=len(files) - len(off))
    if diffs:
        raise AssertionError(f"immune_held: {diffs}; got {files}; "
                             f"measured {json.dumps(rep)}")
    return rep


def _tree_rss(root: int, page: int) -> int:
    """The summed resident sets of process `root` and of every process
    below it (the graph workers), from /proc."""
    kids: dict = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    total, todo = 0, [root]
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/statm") as f:
                total += int(f.read().split()[1]) * page
        except (OSError, IndexError, ValueError):
            pass
        todo.extend(kids.get(p, ()))
    return total


@contextlib.contextmanager
def stage_rss(every: float = 0.25):
    """The summed resident set of this process and its children (_tree_rss)
    sampled every `every` seconds by a thread, its peak kept per stage:
    yields a dict whose "stage" the caller sets and whose "peaks"
    ({stage: bytes}) and "bytes" (the peak of all) it fills."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    out, stop = {"stage": None, "peaks": {}, "bytes": 0}, threading.Event()

    def sample():
        while True:
            rss = _tree_rss(os.getpid(), page)
            st = out["stage"]
            out["peaks"][st] = max(out["peaks"].get(st, 0), rss)
            out["bytes"] = max(out["bytes"], rss)
            if stop.wait(every):
                return

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield out
    finally:
        stop.set()
        th.join()


def _immune_fixture(root: str, n_cells: int, kw: dict) -> dict:
    """build_immune_run in a child process (immune_run): the fixture
    without its planted annotations, with its seconds and the child's
    peak RSS."""
    import resource

    from cellranger_tpu_torch.testing.fixtures import build_immune_run

    t = time.time()
    fx = build_immune_run(root, n_cells, **kw)
    for lib in ("vdj_t", "vdj_b"):
        fx[lib].pop("anns")
    fx["fixture_s"] = time.time() - t
    fx["fixture_peak_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return fx


def immune_run(tmp: str, n_cells: int = IMMUNE_CELLS, device: str = "cuda",
               **fixture_kw) -> dict:
    """A 5' immune profiling well (fixtures.build_immune_run: n_cells of
    PBMC shares; GEX at 2,000 SC5P-PE pairs a cell, VDJ-T and VDJ-B at
    5,000 pairs a cell, two-alpha and two-light clones, planted dropouts,
    one combined TR + IG reference, the 737,280-barcode whitelist) built
    in a child process, then through the port's run_multi on `device`
    (GEX at batch E2E_BATCH; the V(D)J libraries at VdjConfig's own):
    held to the well's truth (immune_truth_diffs).  Reports each
    library's wall, the GEX phases and K1 launches (two a step), each
    V(D)J library's pipeline.vdj.LAST_SPLIT with host seconds a cell,
    cells and clonotypes, the planted dropouts joined by the subset
    merge, peak device memory and peak summed RSS (this process and the
    graph workers) per library against MemTotal, this process's RSS as
    immune_run starts and
    its children's when each library starts (a torn-down pool leaves
    none) and the summed RSS when it ends, the fixture's seconds, peak
    RSS and FASTQ bytes.  Fails
    where the truth is missed, peak RSS reaches IMMUNE_RSS_SHARE of
    MemTotal or a library's device peak IMMUNE_DEVICE_BYTES.  The fixture
    and outputs are deleted after.  `fixture_kw` goes to
    build_immune_run.  Alone on a machine with one card (about 22
    minutes with its fixture, 24 GB of FASTQ under tmp):

        python3 -c "import chip_smoke as c, json, tempfile; from
        cellranger_tpu_torch import kernels; kernels.build();
        print(json.dumps(c.immune_run(tempfile.mkdtemp())))"
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.pipeline import count, vdj

    root = os.path.join(tmp, f"immune_{n_cells}")
    page = os.sysconf("SC_PAGE_SIZE")
    libs: dict = {}
    real = dict(count=count.run_count, vdj=vdj.run_vdj)

    def timed(name, fn, cfg, out_dir, **kw):
        with open("/proc/self/statm") as f:
            rss0 = int(f.read().split()[1]) * page
        kids0 = _tree_rss(os.getpid(), page) - rss0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sw.LAUNCHES = 0
        rss["stage"] = name
        t = time.time()
        s = fn(cfg, out_dir, **kw)
        lib = dict(wall_s=time.time() - t, sw_launches=sw.LAUNCHES,
                   rss_before_bytes=rss0, children_rss_before_bytes=kids0,
                   rss_after_bytes=_tree_rss(os.getpid(), page),
                   peak_device_bytes=(torch.cuda.max_memory_allocated()
                                      if device == "cuda" else None))
        rss["stage"] = None
        libs[name] = lib
        return s

    def run_count(cfg, out_dir, **kw):
        return timed("gex", real["count"], cfg, out_dir, **kw)

    def run_vdj(cfg, out_dir, **kw):
        name = os.path.basename(out_dir)
        s = timed(name, real["vdj"], cfg, out_dir, **kw)
        libs[name]["split"] = dict(vdj.LAST_SPLIT)
        return s

    with open("/proc/self/statm") as f:
        rss_start = int(f.read().split()[1]) * page
    try:
        with ProcessPoolExecutor(1, multiprocessing.get_context(
                "spawn")) as ex:
            fx = ex.submit(_immune_fixture, os.path.join(root, "fx"),
                           n_cells, fixture_kw).result()
        fastq_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for d in (fx["gex"]["dir"], fx["vdj_t"]["dir"],
                                    fx["vdj_b"]["dir"])
                          for f in os.listdir(d))
        out = os.path.join(root, "out")
        count.run_count, vdj.run_vdj = run_count, run_vdj
        try:
            with stage_rss() as rss:
                t = time.time()
                s = run_multi(fx["csv"], out, fx["wl"], batch_size=E2E_BATCH,
                              device=device)
                wall = time.time() - t
        finally:
            count.run_count, vdj.run_vdj = real["count"], real["vdj"]
        diffs = immune_truth_diffs(fx, out, s)
        merges = immune_merges(fx, out)
        with open(os.path.join(out, "count", "_perf.json")) as f:
            phases: dict = {}
            for ph in json.load(f)["phases"]:
                phases[ph["name"]] = phases.get(ph["name"], 0.0) \
                    + ph["wall_s"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = mem_total()
    gex = libs["gex"]
    gex.update(reads=s["count"]["total_reads"],
               molecules=s["count"]["total_molecules"],
               cells=s["count"]["estimated_cells"], phase_s=phases,
               steps=-(-s["count"]["total_reads"] // E2E_BATCH),
               peak_rss_bytes=rss["peaks"].get("gex"))
    if device == "cuda" and gex["sw_launches"] != 2 * gex["steps"]:
        diffs.append(f"{gex['sw_launches']} K1 launches in {gex['steps']} "
                     "GEX steps")
    for name in ("vdj_t", "vdj_b"):
        lib, sp = libs[name], libs[name].pop("split")
        cells = s["vdj"][name]["estimated_cells"]
        host = lib["wall_s"] - sp["pass1_s"] - sp["pass2_s"] - sp["kmers_s"]
        lib.update(reads=s["vdj"][name]["total_reads"], cells=cells,
                   clonotypes=s["vdj"][name]["n_clonotypes"],
                   pass1_s=sp["pass1_s"], pass2_s=sp["pass2_s"],
                   kmers_s=sp["kmers_s"], host_assembly_s=host,
                   host_s_per_cell=host / max(cells, 1),
                   **_vdj_split_report(sp),
                   peak_rss_bytes=rss["peaks"].get(name),
                   background_pairs=fx[name]["background_pairs"],
                   background_barcodes=len(fx[name]["truth"]["background"]),
                   merges=merges[name])
        if lib["sw_launches"]:
            diffs.append(f"{name} launched the SW kernel")
    libs["vdj_t"]["two_alpha_cells"] = len(fx["vdj_t"]["truth"]["two_alpha"])
    libs["vdj_b"]["two_light_cells"] = len(fx["vdj_b"]["truth"]["two_light"])
    libs["vdj_b"]["plasma_cells"] = list(
        fx["vdj_b"]["truth"]["kinds"].values()).count("plasma")
    rep = dict(cells=fx["kinds"], wall_s=wall, libraries=libs,
               rss_start_bytes=rss_start,
               peak_rss_bytes=rss["bytes"], mem_total_bytes=total,
               peak_rss_share=rss["bytes"] / total,
               peak_device_bytes=(max(v["peak_device_bytes"]
                                      for v in libs.values())
                                  if device == "cuda" else None),
               sw_launches=gex["sw_launches"], fixture_s=fx["fixture_s"],
               fixture_peak_rss_bytes=fx["fixture_peak_rss_bytes"],
               fastq_bytes=fastq_bytes)
    if rep["peak_rss_share"] >= IMMUNE_RSS_SHARE:
        diffs.append(f"peak RSS {rss['bytes']} bytes, "
                     f"{rep['peak_rss_share']:.3f} of MemTotal")
    if device == "cuda" and rep["peak_device_bytes"] >= IMMUNE_DEVICE_BYTES:
        diffs.append(f"peak device memory {rep['peak_device_bytes']} bytes")
    if diffs:
        raise AssertionError(f"immune at {n_cells} cells: {diffs[:20]}; "
                             f"measured {json.dumps(rep)}")
    return rep


FLEX_CELLS = 16_000             # flex_run's well: 16 samples of 1,000
FLEX_READS = 160_000_000        # 10x's 10,000 read pairs a cell
# flex_held's well (testing/fixtures.build_flex_run): 48 cells, 3 on each
# of the 16 probe barcodes, on beads drawn from 32 of a 4,096-barcode
# list; 2,000 probes over 600 genes; BC001 and BC002 one sample's, BC016
# no sample's; no ambient barcodes (no EmptyDrops at this size)
FLEX_HELD = dict(n_reads=10_000, n_cells=48, n_wl=4_096, n_gel=32,
                 n_probes=2_000, n_genes=600, n_ambient=0, low_share=0.0,
                 samples=["BC001|BC002"] + [f"BC{i:03d}"
                                            for i in range(3, 16)])
FLEX_HELD_BATCH = 4096
FLEX_HELD_TIMEOUT_S = 600
FLEX_RSS_SHARE = 0.5            # PERF.md section 2's Flex limit
FLEX_DEVICE_BYTES = 16e9
# flex_digest of the JAX package's run_multi of the flex_held build on the
# CPU (tests/flex_reference.py, batch FLEX_HELD_BATCH)
FLEX_EXPECTED = {
    "count/filtered_barcodes.csv":
        "930252ba5373c43ed87887788777b86cfff94c2a59f7339f6f298147cb99486b",
    "count/filtered_feature_bc_matrix.h5":
        "b29bfdcfdc46998c1a1e1bab0b6f6d076af02c51a052f92253250f64394ea698",
    "count/filtered_feature_bc_matrix/barcodes.tsv.gz":
        "2acd81351ab663b2979da614558316101fbc2b9768f7f09c5360ad9105aa4c63",
    "count/filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "count/filtered_feature_bc_matrix/matrix.mtx.gz":
        "cdaf2fb2452376b06a435614b82d01008953d778f4ebcf17bcb8b2151bef2afc",
    "count/metrics_summary.json":
        "62e5c4d8782ebe165f6c24a94479a4be45cdfdcbcda8a200651a12e3245b2669",
    "count/molecule_info.h5":
        "0e80f75caa179a669fee57e3d0a2fafea78b361bea89c21376212a3db7e017c1",
    "count/per_barcode_metrics.csv":
        "1f1a7b9bf96bfdcffd8214386a49c1ffac1b6fdec0a41b078c7f78009eea5fb0",
    "count/raw_feature_bc_matrix.h5":
        "a21c022392fb6dee05c8a35533001f113fa60d8de892823e6e2e342b4937baa0",
    "count/raw_feature_bc_matrix/barcodes.tsv.gz":
        "056eb8c067dd128cfe30f4b938027863c5aab4c027b7c294b6b195d1a9c85f48",
    "count/raw_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "count/raw_feature_bc_matrix/matrix.mtx.gz":
        "ffb3038610b45ac2559c271114d428a90faa96630ee2414cd8789459d2a9a6ef",
    "demux/per_sample_outs/S01/metrics_summary.json":
        "107172dcc4f0d0f42708bfde913232de783527d288101b9b340ab56448b03a8d",
    "demux/per_sample_outs/S01/sample_filtered_feature_bc_matrix.h5":
        "3d9fbb4cffbf4f13c6a6f3801705fe9b801fdb50ceed074a2ff7966283e1d03d",
    "demux/per_sample_outs/S01/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "37a39dc599dc43391084a7749be89c5e62417b8361f8cf6e6bf68bc947128b42",
    "demux/per_sample_outs/S01/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S01/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "5d5476163981d243f5a55f29d7fc50bacc6a62d933020a12ba94b1ce16c1034d",
    "demux/per_sample_outs/S01/sample_molecule_info.h5":
        "113409c7e5935552245684668bc2ea8221e35c058a3178e3ea2f9e6895d43c77",
    "demux/per_sample_outs/S02/metrics_summary.json":
        "725837bc5bb705f0aeefe30094b5b940a0efe6d7a67ec08a48a2dda0250271ae",
    "demux/per_sample_outs/S02/sample_filtered_feature_bc_matrix.h5":
        "fd43a578400b01eea6f2642e901074a5ba9f9ad5ddc7d90c65da86bd32561bdb",
    "demux/per_sample_outs/S02/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "6fd4c92762e6960f7caaec8d0101c307eafacc760eb2cc2cd766c36fbdbccaa3",
    "demux/per_sample_outs/S02/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S02/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "5c037aee96d1617bfd68930a0f0efffb1d6386d1a31f290d72b65805693cf4da",
    "demux/per_sample_outs/S02/sample_molecule_info.h5":
        "223bee7f6cffaf2fca892acbee76f01284f2f9a016ec706d357bc20a71772338",
    "demux/per_sample_outs/S03/metrics_summary.json":
        "a42756adab14f8776a7ff63fde6a3aa831b3a4f9f719d27c863cb6e1e472fe22",
    "demux/per_sample_outs/S03/sample_filtered_feature_bc_matrix.h5":
        "50468e03a4e427ac6bb082ced8dc979df70c6d67f332c3e2f477951a9cbd0f88",
    "demux/per_sample_outs/S03/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "419bee0d9a4c4982edbe11f3a3d340588ca2aad8e3c817316ec694c834f99416",
    "demux/per_sample_outs/S03/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S03/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "bd53bb2eb08e800527d944527451d83a1457b06415645751a32551142f36d4c1",
    "demux/per_sample_outs/S03/sample_molecule_info.h5":
        "2035d9a427021feceb1f5b52a61d227a08788624efd1555a8f349c82314bb0e5",
    "demux/per_sample_outs/S04/metrics_summary.json":
        "f8af34a143d1fcb5e76e73faa141057029464177d7c8ba95eb1e8227a84595df",
    "demux/per_sample_outs/S04/sample_filtered_feature_bc_matrix.h5":
        "ac6e4243c4848e3409b1c7885608a1ca0e401268d0df6b66d0e2e54063de3327",
    "demux/per_sample_outs/S04/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "9740f21f5cbcaf2655e5cd4d730f26541159f80ef6f8375759bf462e3687c162",
    "demux/per_sample_outs/S04/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S04/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "0dcce5e628cf33f62de4b016681b3e9713dbcbe093f33a89cc7b9a6e60476b45",
    "demux/per_sample_outs/S04/sample_molecule_info.h5":
        "76a334cc0b734e4257296c737370eeebcef65e1ebb8721e79ce4a66ce1156e3c",
    "demux/per_sample_outs/S05/metrics_summary.json":
        "b53be05776a0581bf0cee9bbf3bb4866e112ebfdb574b3724b0def2514c7da93",
    "demux/per_sample_outs/S05/sample_filtered_feature_bc_matrix.h5":
        "d0c2f1589c62b68f45ae4ccf0f1c622b5468aa272e958e166a68821d09f2bcea",
    "demux/per_sample_outs/S05/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "48ddb7be2f9ed805075355e0bbaf1dba0d8e8339b7ddc97e7ec01625d313a72e",
    "demux/per_sample_outs/S05/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S05/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "4a6af9e442ca7a58694fb12fc1a5b1f6f5b29b3c4e3e0e2475d1ad463b1b0030",
    "demux/per_sample_outs/S05/sample_molecule_info.h5":
        "6bff2d67bd3f4b679cef4fc55f2c4babe7951c28b488ff94c0161d9665a331a6",
    "demux/per_sample_outs/S06/metrics_summary.json":
        "913bc9e38c053cba861e5593ccaa5f0eb0025d4cb72df31d169eab4cc20aa85e",
    "demux/per_sample_outs/S06/sample_filtered_feature_bc_matrix.h5":
        "7346b95372d277c766dac34b8e5eaa5c6e06b90ca09bf868ac10c350b466e8c0",
    "demux/per_sample_outs/S06/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "cd8617fc6331f82e85dd8e9112f7b8d39c2a904a53ed217f3569a17e4c37b76b",
    "demux/per_sample_outs/S06/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S06/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "235e503fa79814a29538b5ab729ea0707d78f8b2f6a1a4303420d84162e42a60",
    "demux/per_sample_outs/S06/sample_molecule_info.h5":
        "242065e3741e0feb64f0282967419b773112343ed6607f267a8da9579f0947e5",
    "demux/per_sample_outs/S07/metrics_summary.json":
        "85f171632d3f353924e4d69f79a2b5f46265d0c4f889ae6e09b35af1d1636ee9",
    "demux/per_sample_outs/S07/sample_filtered_feature_bc_matrix.h5":
        "4c089c564a72684ca545c3827a2b88c2216a770b60eb87ca4df8b69bda89758c",
    "demux/per_sample_outs/S07/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "888573d9e3f31498719532d0e77d477760c91f7c3f2b2ff50e9e8bc02751c8a3",
    "demux/per_sample_outs/S07/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S07/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "b37c627a57018ab364c4cf0c25db17597316edaf075c482650acc3c517119320",
    "demux/per_sample_outs/S07/sample_molecule_info.h5":
        "1d33c6a1c2d330386ed6cdfcd50188b690249d9099740135490af1117d9932d2",
    "demux/per_sample_outs/S08/metrics_summary.json":
        "f121eb2452c154dd07f428019968e853fadbf1509e40ce1e08634f1b9ab59251",
    "demux/per_sample_outs/S08/sample_filtered_feature_bc_matrix.h5":
        "d5f6a93163422b1d1208ba5a7e5ef3bdec2948dcd3442be16776e39c638d2f83",
    "demux/per_sample_outs/S08/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "0dcf879dfbfa3350af2cc0ff416adef62762441bfa42a267acfdea838ed38feb",
    "demux/per_sample_outs/S08/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S08/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "097afd1f532910498e466523fbefd0e83a59a66248fbc5d86c201f46ec385c89",
    "demux/per_sample_outs/S08/sample_molecule_info.h5":
        "0888d1361d7b4012f9ef0e000b51b29a6c5ce9cba191346c5fc4e62fcb4e4087",
    "demux/per_sample_outs/S09/metrics_summary.json":
        "7497113069736663df038fef67e345b6c945bb21c7347f7de766ed53682f0f0e",
    "demux/per_sample_outs/S09/sample_filtered_feature_bc_matrix.h5":
        "f72794671270c462d7671c3557ccb58edd614cda810ff7885a6129cab0e1d0d1",
    "demux/per_sample_outs/S09/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "883b6dc02821a2dc23fd899aa5b4c88de944a92f6f999b8acbc7ddef3d1830d6",
    "demux/per_sample_outs/S09/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S09/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "3a411619ec59897d9426226a4e5ad7bc0eaa840da43472a8f9a960c5948701a6",
    "demux/per_sample_outs/S09/sample_molecule_info.h5":
        "e417b3d952d848f6df0028dc5d0ce690a664b816f05a204e817813fa797dd0fd",
    "demux/per_sample_outs/S10/metrics_summary.json":
        "33642103daa023bbd1d0aaedc839ab6650566cac9aa53f891e93b80d01a5b91c",
    "demux/per_sample_outs/S10/sample_filtered_feature_bc_matrix.h5":
        "00a4a362982c981f4bb80d8ea97626c01524665058600ed089041c206546b0e8",
    "demux/per_sample_outs/S10/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "34febe04ab7a305912ef70018e1cb2af8c371901cbcdf5c9966272c257172f79",
    "demux/per_sample_outs/S10/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S10/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "4575291ee8d68898f7c1b2df0377e2d0879ef0a2f3cfa8dbc23c43c58d0ec2b4",
    "demux/per_sample_outs/S10/sample_molecule_info.h5":
        "d518e95f55aefcb3b90d6367cef5761a9239625131aa548408a5cec11fc3b550",
    "demux/per_sample_outs/S11/metrics_summary.json":
        "64e087e2a5ee88c5f9e64cf5b19a8610ede214e2e805c9dff9e3de9ee06ddc92",
    "demux/per_sample_outs/S11/sample_filtered_feature_bc_matrix.h5":
        "7d808c801ea96aced36329d10c52aa4620b92ff4e4e2ddaea384409d2c93855d",
    "demux/per_sample_outs/S11/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "f6a305686cd3149e7eaecdad6f5e4332f2853a795ccb2c603f93d75f034bcb5d",
    "demux/per_sample_outs/S11/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S11/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "bef54ff86e8b07a14a248de787721c6d15d2331b13388e125cf4d5e9258daabf",
    "demux/per_sample_outs/S11/sample_molecule_info.h5":
        "559bfa124cf40ab9ef37ba8b999e4907f48104b20d0f5208b0181835f476c81e",
    "demux/per_sample_outs/S12/metrics_summary.json":
        "43645775b7eaa1cd018998a9a692d20e2988f62d3976c40d077dec3e53a37502",
    "demux/per_sample_outs/S12/sample_filtered_feature_bc_matrix.h5":
        "6b0aa1390db3706a7b3d2190eef0917b6a18ed1a12fadf477b303a6a1be796a5",
    "demux/per_sample_outs/S12/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "c5938834c9bc861a8df23b24f585db95fa77f80a274a359e0e3c86a9b41781f9",
    "demux/per_sample_outs/S12/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S12/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "976d1b04b7ce326e44367382fde4cb8fae6e9a64d95869b313e6fab4a3604dd3",
    "demux/per_sample_outs/S12/sample_molecule_info.h5":
        "2f868b58c0ec7b31dbdb24b06b0c53e231deca9e9b0f46b483d68f2f00e969e6",
    "demux/per_sample_outs/S13/metrics_summary.json":
        "dffb17caa218c1ca3769af325448ebc9db480d893986ac3c19630dcfbe06d411",
    "demux/per_sample_outs/S13/sample_filtered_feature_bc_matrix.h5":
        "779ca9617c23df5862a04cf02b6a5a00f5632f0e594a287b58d612a394510cb2",
    "demux/per_sample_outs/S13/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "72715342008abb4fb7adb4969d594fd2097e500bc4a92e88a2bff49cd46c1362",
    "demux/per_sample_outs/S13/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S13/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "345fa6a79cb71f284ace3a5ca336fd21dca06dd962a246572bb40d9022085522",
    "demux/per_sample_outs/S13/sample_molecule_info.h5":
        "7600cfd90efdbae37d168d028692d4187e7bf18d37dfd7ac2bcd839e38f51c3d",
    "demux/per_sample_outs/S14/metrics_summary.json":
        "9843d47d4a1c945be65c8c0f24784c97c80027818a7f668ccd97da048ef67e05",
    "demux/per_sample_outs/S14/sample_filtered_feature_bc_matrix.h5":
        "b785182e05633ef78642109a2e469a67dbe78fc650443deccbedc3265a437b29",
    "demux/per_sample_outs/S14/sample_filtered_feature_bc_matrix/barcodes.tsv.gz":
        "7fe0e0c9e7d66444718c70848ed6c47eb682dd7dae30d60faaa9fd2a8779dd94",
    "demux/per_sample_outs/S14/sample_filtered_feature_bc_matrix/features.tsv.gz":
        "4efcc2da65b1ad79e21eb5c1ee1dc61aed044cd99aab77b19bcd25705a25f2d8",
    "demux/per_sample_outs/S14/sample_filtered_feature_bc_matrix/matrix.mtx.gz":
        "22a9dc46ccf81a945909909f804a2d3ec826ad6d146cb0834b3cc03e3f74240d",
    "demux/per_sample_outs/S14/sample_molecule_info.h5":
        "075b36d40ff25d9a1e380b9b120e67aec9af4f404f87c24cbdac44cbe8268355",
    "demux/probe_assignments.csv":
        "b39330e28d71a41f3266521c732185a1fa02b21d243e2415f528b5218068944e",
    "metrics_summary.json":
        "7a7fde06a7a9348115fef57866fdb94d90b5371614c412d24f37dbba13aaa3a2",
}


def h5_sha256(path: str) -> str:
    """sha256 of an h5 file's content as io/hdf5.py reads it back: every
    group, dataset (dtype, shape, values) and attribute in name order, so
    that h5py's file and io/hdf5.py's of equal data agree."""
    import hashlib

    import numpy as np
    from cellranger_tpu_torch.io import hdf5

    h = hashlib.sha256()

    def put(x) -> None:
        a = np.asarray(x)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(repr(a.tolist()).encode() if a.dtype == object
                 else a.tobytes())

    def walk(node, at: str) -> None:
        for k in sorted(node.attrs):
            h.update(f"{at}@{k}".encode())
            put(node.attrs[k])
        if isinstance(node, hdf5.Dataset):
            put(node[()])
            return
        for k in sorted(node.keys()):
            h.update(f"{at}/{k}".encode())
            walk(node[k], f"{at}/{k}")

    with hdf5.File(path, "r") as f:
        walk(f, "")
    return h.hexdigest()


def flex_digest(out: str) -> dict:
    """{path: sha256} of every file a run_multi of a Flex well writes but
    analysis/ (floats held by tolerance between devices), the web
    summaries and _perf.json (times) and the run's own state (_checkpoint/,
    which the JAX package keeps and the port does not): gz files decompressed (gzip headers
    carry a time), h5 files by content (h5_sha256), metrics_summary.json
    files read back without wall_time_s, the rest as written."""
    got = {}
    for d, subs, files in os.walk(out):
        subs[:] = sorted(x for x in subs
                         if x != "analysis" and not x.startswith("_"))
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, out)
            if name in ("web_summary.html", "_perf.json"):
                continue
            if name.endswith(".h5"):
                got[rel] = h5_sha256(path)
                continue
            if name.endswith(".gz"):
                with gzip.open(path, "rb") as fh:
                    data = fh.read()
            else:
                with open(path, "rb") as fh:
                    data = fh.read()
            if name == "metrics_summary.json":
                m = json.loads(data)
                m.pop("wall_time_s", None)
                data = json.dumps(m, sort_keys=True).encode()
            got[rel] = _sha256(data)
    return dict(sorted(got.items()))


def flex_truth_diffs(fx: dict, out: str) -> list[str]:
    """A run_multi of a fixtures.build_flex_run well against the well's
    truth: the read and molecule metrics (probe_reads_* among them),
    every molecule and its reads in molecule_info.h5, the raw matrix's
    barcodes (the whole product space), each sample's called cells and
    its sample_filtered_feature_bc_matrix (the UMIs of each cell and
    gene), no sample dir for a sample of no cell, and the sample each
    cell has in probe_assignments.csv."""
    import numpy as np
    from cellranger_tpu_torch.io import hdf5

    count = os.path.join(out, "count")
    with open(os.path.join(count, "metrics_summary.json")) as f:
        m = json.load(f)
    diffs = [f"{k}: got {m.get(k)}, expected {v}"
             for k, v in fx["expected"].items() if m.get(k) != v]
    with hdf5.File(os.path.join(count, "raw_feature_bc_matrix.h5"),
                   "r") as f:
        n_bc = int(f["matrix/shape"][:][1])
    if n_bc != fx["n_wl"] * fx["n_probe_bcs"]:
        diffs.append(f"raw matrix: {n_bc} barcodes, not "
                     f"{fx['n_wl']} x {fx['n_probe_bcs']}")
    with hdf5.File(os.path.join(count, "molecule_info.h5"), "r") as f:
        got = [f[k][:] for k in ("barcode_idx", "feature_idx", "umi",
                                 "count")]
    o = np.lexsort((got[2], got[1], got[0]))
    if not (len(o) == len(fx["mol_bc"]) and all(
            np.array_equal(g[o].astype(np.int64), w.astype(np.int64))
            for g, w in zip(got, (fx["mol_bc"], fx["mol_gene"],
                                  fx["mol_umi"], fx["mol_reads"])))):
        diffs.append(f"molecule_info.h5: {len(o)} molecules, not the "
                     f"fixture's {len(fx['mol_bc'])} or their reads")
    # UMIs of each (product barcode, gene) of the truth, by cell name
    bc, gene = fx["mol_bc"].astype(np.int64), fx["mol_gene"].astype(np.int64)
    new = np.r_[True, (bc[1:] != bc[:-1]) | (gene[1:] != gene[:-1])]
    first = np.flatnonzero(new)
    umis = np.diff(np.r_[first, len(bc)])
    demux = os.path.join(out, "demux")
    for sid, names in fx["cells"].items():
        sdir = os.path.join(demux, "per_sample_outs", sid, SAMPLE_MEX)
        if not os.path.isdir(sdir):
            diffs.append(f"{sid}: no {SAMPLE_MEX}")
            continue
        with gzip.open(os.path.join(sdir, "barcodes.tsv.gz"), "rt") as f:
            called = f.read().split()
        if sorted(called) != names:
            diffs.append(f"{sid}: {len(called)} cells called, "
                         f"{len(set(called) & set(names))} of its "
                         f"{len(names)}")
            continue
        prod = np.asarray([fx["cell_index"][c] for c in called], np.int64)
        feat, col, cnt = mex_entries(os.path.join(demux, "per_sample_outs",
                                                  sid), SAMPLE_MEX)
        o = np.lexsort((feat, prod[col]))
        sel = np.isin(bc[first], prod)
        if not (o.size == int(sel.sum()) and np.array_equal(
                prod[col][o], bc[first][sel])
                and np.array_equal(feat[o], gene[first][sel])
                and np.array_equal(cnt[o], umis[sel])):
            diffs.append(f"{sid}: {SAMPLE_MEX} is not the truth's UMIs")
    extra = set(os.listdir(os.path.join(demux, "per_sample_outs"))) \
        - set(fx["cells"])
    if extra:
        diffs.append(f"sample dirs of no planted cell: {sorted(extra)}")
    with open(os.path.join(demux, "probe_assignments.csv")) as f:
        rows = [ln.split(",") for ln in f.read().split()[1:]]
    got_as = {r[0]: r[2] for r in rows}
    if got_as != fx["assignments"]:
        off = [b for b in set(got_as) | set(fx["assignments"])
               if got_as.get(b) != fx["assignments"].get(b)]
        diffs.append(f"probe_assignments.csv: {len(off)} cells off, "
                     f"e.g. {sorted(off)[:3]}")
    return diffs


def _flex_shared_beads(fx: dict, out: str) -> int:
    """Beads whose cells went to two or more samples' outs."""
    seen: dict = {}
    per = os.path.join(out, "demux", "per_sample_outs")
    for sid in os.listdir(per):
        with gzip.open(os.path.join(per, sid, SAMPLE_MEX, "barcodes.tsv.gz"),
                       "rt") as f:
            for b in f.read().split():
                seen.setdefault(b[:16], set()).add(sid)
    return sum(len(v) > 1 for v in seen.values())


def flex_held(tmp: str, device: str = "cuda") -> dict:
    """The small Flex well (FLEX_HELD: every probe-barcode kind, one
    sample of two probe barcodes, one probe barcode of no sample, beads
    shared between samples) through the port's run_multi on `device`:
    the fixture's truth (flex_truth_diffs) and flex_digest equal to the
    JAX package's CPU run (FLEX_EXPECTED, tests/flex_reference.py); no
    K1 launch."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.testing.fixtures import build_flex_run

    root = os.path.join(tmp, "flex_held")
    try:
        t = time.time()
        fx = build_flex_run(os.path.join(root, "fx"), **FLEX_HELD,
                            workers=2)
        t_fix = time.time() - t
        out = os.path.join(root, "out")
        sw.LAUNCHES = 0
        t = time.time()
        s = run_multi(fx["csv"], out, fx["wl"], read_len=RTL_READ_LEN,
                      batch_size=FLEX_HELD_BATCH, device=device)
        wall = time.time() - t
        launches = sw.LAUNCHES
        diffs = flex_truth_diffs(fx, out)
        files = flex_digest(out)
        shared = _flex_shared_beads(fx, out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    off = sorted(k for k in set(files) | set(FLEX_EXPECTED)
                 if files.get(k) != FLEX_EXPECTED.get(k))
    if off:
        diffs.append(f"files differ from the JAX package's run: {off}")
    if launches:
        diffs.append(f"{launches} K1 launches in a probe run")
    if not shared:
        diffs.append("no bead's cells in two samples' outs")
    rep = dict(cells=fx["n_cells"], reads=fx["n_reads"],
               molecules=fx["n_molecules"], samples=s["demux_probe"],
               pbc_reads=fx["pbc_reads"], beads_in_two_samples=shared,
               sw_launches=launches, fixture_s=t_fix, wall_s=wall,
               files_equal=len(files) - len(off))
    if diffs:
        raise AssertionError(f"flex_held: {diffs}; got {files}; "
                             f"measured {json.dumps(rep)}")
    return rep


def _flex_fixture(root: str, n_reads: int, n_cells: int, kw: dict) -> dict:
    """build_flex_run in a child process (flex_run): the fixture with its
    seconds and the child's peak RSS."""
    import resource

    from cellranger_tpu_torch.testing.fixtures import build_flex_run

    fx = build_flex_run(root, n_reads, n_cells, **kw)
    fx["fixture_peak_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return fx


def flex_run(tmp: str, n_reads: int = FLEX_READS, n_cells: int = FLEX_CELLS,
             device: str = "cuda", **fixture_kw) -> dict:
    """A multiplexed Flex well (fixtures.build_flex_run: n_cells cells,
    1/16 of them on each of 16 probe barcodes, a sample each, on about
    10,000 shared beads of the 737,280-barcode list; 54,000 probes;
    n_reads read pairs) built in a child process, then through the
    port's run_multi on `device` at batch E2E_BATCH, read length
    RTL_READ_LEN: held to the well's truth (flex_truth_diffs).  Reports
    the wall split (count's passes, dedup, the product barcode names,
    matrix assembly, the raw MEX on its thread, cell calling, molecule
    info; the demux: each sample's outs, subset_molecule_info, analysis
    and web summary), the probe aligner's (K8's) ms a batch between CUDA
    events around each of its calls in the run and its batches, the
    spill's rows and bytes, the disk at its peak, peak RSS against
    MemTotal and peak device memory; fails where the truth is missed,
    K1 launches, peak RSS reaches FLEX_RSS_SHARE of MemTotal or the
    device's peak FLEX_DEVICE_BYTES, or fewer than FLEX_MIN_SHARED of the
    cells share their bead with another sample's.  The fixture and outputs are
    deleted after.  `fixture_kw` goes to build_flex_run.  Alone on a
    machine with one card:

        python3 -c "import chip_smoke as c, json, tempfile; from
        cellranger_tpu_torch import kernels; kernels.build();
        print(json.dumps(c.flex_run(tempfile.mkdtemp())))"
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.analysis import run as analysis_mod
    from cellranger_tpu_torch.io import molecule_info
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.io.multi_config import run_multi
    from cellranger_tpu_torch.pipeline import count, demux, spill, websummary
    from cellranger_tpu_torch.testing.fixtures import FLEX_MIN_SHARED

    root = os.path.join(tmp, f"flex_{n_reads}")
    cuda = device == "cuda"
    k8, spilled = [], {"rows": 0, "bytes": 0}
    real_load, real_append = count._load_probe_run, spill.MoleculeSpill.append

    def load_probe_run(cfg, dev):
        pr = real_load(cfg, dev)
        align = pr.align

        def timed(*a):
            if not cuda:
                return align(*a)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            r = align(*a)
            ev[1].record()
            k8.append(ev)
            return r
        pr.align = timed
        return pr

    def append(self, bc, gene, umi):
        spilled["rows"] += len(bc)
        spilled["bytes"] += bc.nbytes + gene.nbytes + umi.nbytes
        return real_append(self, bc, gene, umi)

    try:
        with ProcessPoolExecutor(1, multiprocessing.get_context(
                "spawn")) as ex:
            fx = ex.submit(_flex_fixture, os.path.join(root, "fx"), n_reads,
                           n_cells, fixture_kw).result()
        out = os.path.join(root, "out")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sw.LAUNCHES = 0
        count._load_probe_run = load_probe_run
        spill.MoleculeSpill.append = append
        try:
            with rss_peak() as rss, disk_peak(tmp) as disk, recorded(
                    (count, "run_count"), (CountMatrix, "save_mex"),
                    (demux, "write_sample_outs"),
                    (molecule_info, "subset_molecule_info"),
                    (analysis_mod, "run_secondary_analysis"),
                    (websummary, "build_web_summary")) as rec:
                t = time.time()
                s = run_multi(fx["csv"], out, fx["wl"],
                              read_len=RTL_READ_LEN, batch_size=E2E_BATCH,
                              device=device)
                wall = time.time() - t
        finally:
            count._load_probe_run = real_load
            spill.MoleculeSpill.append = real_append
        launches = sw.LAUNCHES
        diffs = flex_truth_diffs(fx, out)
        shared = _flex_shared_beads(fx, out)
        with open(os.path.join(out, "count", "_perf.json")) as f:
            phases: dict = {}
            for ph in json.load(f)["phases"]:
                phases[ph["name"]] = phases.get(ph["name"], 0.0) \
                    + ph["wall_s"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if cuda:
        torch.cuda.synchronize()
    k8_ms = [a.elapsed_time(b) for a, b in k8]
    total = mem_total()
    run_count_s = rec["run_count"][0][0]
    sample_s = [x for x, _ in rec["write_sample_outs"]]
    rep = dict(
        cells=n_cells, reads=n_reads, molecules=fx["n_molecules"],
        samples=len(fx["cells"]), whitelist=fx["n_wl"],
        barcode_columns=fx["n_wl"] * fx["n_probe_bcs"],
        beads_used=fx["beads_used"],
        shared_bead_share=fx["shared_bead_share"],
        beads_in_two_samples=shared, ambient_barcodes=fx["n_ambient"],
        pbc_reads=fx["pbc_reads"], wall_s=wall, run_count_s=run_count_s,
        count_phase_s=phases,
        raw_mex_s=rec["save_mex"][0][0] if rec["save_mex"] else None,
        demux_s=wall - run_count_s, sample_outs_s=sum(sample_s),
        slowest_sample_s=max(sample_s, default=0.0),
        subset_molecule_info_s=sum(x for x, _ in
                                   rec["subset_molecule_info"]),
        # the first analysis is the run's, inside run_count
        sample_analysis_s=sum(x for x, _ in
                              rec["run_secondary_analysis"][1:]),
        web_summaries_s=sum(x for x, _ in rec["build_web_summary"]),
        k8_batches=len(k8_ms) if cuda else None,
        k8_ms_per_batch=(sorted(k8_ms)[len(k8_ms) // 2] if k8_ms
                         else None),
        k8_ms_total=sum(k8_ms) if k8_ms else None,
        k8_ms_is=("median of the probe aligner's calls in the run, CUDA "
                  "events around each (host launch time included)"),
        spill_rows=spilled["rows"], spill_bytes=spilled["bytes"],
        disk_peak_bytes=disk["bytes"], fastq_bytes=fx["fastq_bytes"],
        peak_rss_bytes=rss["bytes"], mem_total_bytes=total,
        peak_rss_share=rss["bytes"] / total,
        peak_device_bytes=(torch.cuda.max_memory_allocated() if cuda
                           else None),
        sw_launches=launches, fixture_s=fx["fixture_s"],
        fixture_peak_rss_bytes=fx["fixture_peak_rss_bytes"])
    if launches:
        diffs.append(f"{launches} K1 launches in a probe run")
    if fx["shared_bead_share"] < FLEX_MIN_SHARED:
        diffs.append(f"{fx['shared_bead_share']:.3f} of the cells share "
                     "their bead with another sample's")
    if rep["peak_rss_share"] >= FLEX_RSS_SHARE:
        diffs.append(f"peak RSS {rss['bytes']} bytes, "
                     f"{rep['peak_rss_share']:.3f} of MemTotal")
    if cuda and rep["peak_device_bytes"] >= FLEX_DEVICE_BYTES:
        diffs.append(f"peak device memory {rep['peak_device_bytes']} bytes")
    if diffs:
        raise AssertionError(f"flex at {n_reads} reads: {diffs[:20]}; "
                             f"measured {json.dumps(rep)}")
    return rep


def _plain_reads(rd) -> list:
    """The originals' read list, (umi, seq, qual bytes), of a
    support.BarcodeReads."""
    import numpy as np

    out = []
    for i in range(len(rd.umi)):
        s, e = int(rd.start[i]), int(rd.end[i])
        seq = np.frombuffer(b"ACGT", np.uint8)[rd.codes[i, s:e] & 3]
        seq[~rd.valid[i, s:e]] = ord("N")
        out.append((int(rd.umi[i]), seq.tobytes().decode(),
                    bytes(rd.qual[i, s:s + int(rd.qlen[i])])))
    return out


def vdj_fast_parity(tmp: str, n_cells: int = VDJ_FAST_PARITY_CELLS,
                    pairs_per_cell: int = VDJ_FAST_PARITY_PAIRS,
                    device: str = "cuda") -> dict:
    """A small library through run_vdj on `device`, every barcode's reads
    and contigs recorded: each contig's UMI support (n_umis, n_reads),
    base qualities (also of the contigs the run drops for support, taken
    after it) and annotation (every field) from vdj/support.py equal to
    the plain versions' (vdj/assembly.py umi_support, contig_base_quals,
    vdj/annotate.py annotate_contig) on the barcode's read list.  Both
    sides' seconds over what the run computed."""
    import numpy as np
    from cellranger_tpu_torch.pipeline import vdj
    from cellranger_tpu_torch.testing.fixtures import (build_vdj_run,
                                                       vdj_library_kw)
    from cellranger_tpu_torch.vdj import assembly, support
    from cellranger_tpu_torch.vdj.annotate import annotate_contig
    from cellranger_tpu_torch.vdj.reference import VdjReference

    got: list = []

    class Support(support.BarcodeSupport):
        def umi_support(self, contig, min_frac=0.5):
            super().umi_support(contig, min_frac)
            got.append([self.reads, contig.seq,
                        (contig.n_umis, contig.n_reads), None, None])

        def contig_base_quals(self, contig_seq):
            q = super().contig_base_quals(contig_seq)
            hit, = [g for g in got if g[0] is self.reads
                    and g[1] == contig_seq]
            hit[3] = q
            return q

    class Annotator(support.Annotator):
        def annotate(self, contig):
            a = super().annotate(contig)
            got[-1][4] = a
            return a

    root = os.path.join(tmp, "vdj_fast_parity")
    saved = support.BarcodeSupport, support.Annotator
    support.BarcodeSupport, support.Annotator = Support, Annotator
    try:
        fx = build_vdj_run(os.path.join(root, "fx"), n_cells, pairs_per_cell,
                           **vdj_library_kw(n_cells))
        vdj.run_vdj(_vdj_cfg(fx, batch_size=VDJ_BATCH),
                    os.path.join(root, "out"), device=device)
    finally:
        support.BarcodeSupport, support.Annotator = saved
    split = dict(vdj.LAST_SPLIT)
    ref = VdjReference.from_fasta(fx["fa"])
    shutil.rmtree(root, ignore_errors=True)
    diffs, plain = [], dict(support_s=0.0, annotation_s=0.0, quals_s=0.0)
    for rd, seq, sup, quals, ann in got:
        reads = _plain_reads(rd)
        t = time.time()
        c = assembly.Contig(seq, 0)
        assembly.umi_support(c, reads)
        plain["support_s"] += time.time() - t
        if (c.n_umis, c.n_reads) != sup:
            diffs.append(f"support {(c.n_umis, c.n_reads)} != {sup}")
        t = time.time()
        q = assembly.contig_base_quals(seq, reads)
        if quals is None:
            quals = support.BarcodeSupport(rd, device).contig_base_quals(seq)
        else:
            plain["quals_s"] += time.time() - t
        if q.dtype != quals.dtype or not np.array_equal(q, quals):
            diffs.append(f"quals of a {len(seq)}-base contig")
        if ann is not None:
            t = time.time()
            a = annotate_contig(seq, ref)
            plain["annotation_s"] += time.time() - t
            if a != ann:
                diffs.append(f"annotation {a} != {ann}")
    rep = dict(cells=n_cells, pairs_per_cell=pairs_per_cell,
               contigs=len(got),
               quals_in_run=sum(g[3] is not None for g in got),
               annotations_compared=sum(g[4] is not None for g in got),
               alignments=split["alignments"],
               new_s={k: split[k] for k in plain}, plain_s=plain)
    if diffs or not rep["quals_in_run"]:
        raise AssertionError(f"vdj_fast_parity: {diffs[:10]}; {rep}")
    return rep


def vdj_kmers(tmp: str, n_cells: int = VDJ_KMER_CELLS,
              pairs_per_cell: int = VDJ_PAIRS_PER_CELL,
              parity_reads: int = VDJ_KMER_PARITY_READS,
              devices=("cuda", "cpu")) -> dict:
    """count_bc_umi_kmers alone on the reads of a build_vdj_run(n_cells,
    pairs_per_cell), on devices[0], twice (the first call pays the
    allocator's growth), its blocks and largest block; its first
    `parity_reads` reads on devices[0] in blocks of about
    VDJ_KMER_PARITY_CHUNK kmer rows (a quarter of theirs if fewer), there
    in one block and on devices[1], equal."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.testing.fixtures import vdj_kmer_inputs
    from cellranger_tpu_torch.vdj.assembly import count_bc_umi_kmers

    dev = devices[0]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t = time.time()
    x = vdj_kmer_inputs(n_cells, pairs_per_cell)
    rows = (x["bc"], x["umi"], x["rna"], x["nmask"])
    rep = dict(cells=n_cells, reads=len(x["bc"]), fixture_s=time.time() - t)
    sw.LAUNCHES = 0
    secs = []
    for _ in range(2):
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        sync()
        t = time.time()
        spec = {}
        b, u, k, c = count_bc_umi_kmers(*rows, device=dev, stats=spec)
        sync()
        secs.append(time.time() - t)
    rep.update(first_s=secs[0], s=secs[1], rows=len(b),
               blocks=spec["blocks"],
               largest_block_rows=spec["largest_block_rows"],
               largest_block_ranks=spec["largest_block_ranks"],
               sw_launches=sw.LAUNCHES,
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if dev == "cuda" else None))
    pairs = _pairs(b, u)
    if pairs != x["bc_umi_pairs"] or int(c.sum(dtype=np.int64)) \
            != x["n_kmers"]:
        raise AssertionError(f"vdj_kmers: {pairs} (barcode, UMI) pairs, "
                             f"{int(c.sum(dtype=np.int64))} kmers; expected "
                             f"{x['bc_umi_pairs']}, {x['n_kmers']}")
    up = ((b[1:] > b[:-1]) | ((b[1:] == b[:-1]) & ((u[1:] > u[:-1])
          | ((u[1:] == u[:-1]) & (k[1:] > k[:-1])))))
    if not up.all():
        raise AssertionError("vdj_kmers: keys not strictly increasing")
    head = tuple(a[:parity_reads] for a in rows)
    blocked, one = {}, {}
    n_rows = parity_reads * (head[2].shape[1] - 19)
    want = count_bc_umi_kmers(*head, chunk=min(VDJ_KMER_PARITY_CHUNK,
                                               n_rows // 4),
                              device=dev, stats=blocked)
    for what, got in (
            (f"in one block on {dev}", count_bc_umi_kmers(
                *head, chunk=n_rows, device=dev, stats=one)),
            (f"on {devices[1]}", count_bc_umi_kmers(*head,
                                                    device=devices[1]))):
        _equal_arrays(got, want, f"vdj_kmers first {parity_reads} reads in "
                      f"{blocked['blocks']} blocks on {dev} and {what}")
    if one["blocks"] != 1 or blocked["blocks"] < 2:
        raise AssertionError(f"vdj_kmers parity: {blocked['blocks']} and "
                             f"{one['blocks']} blocks")
    if sw.LAUNCHES:
        raise AssertionError("count_bc_umi_kmers launched the SW kernel")
    rep.update(parity_reads=parity_reads, parity_blocks=blocked["blocks"],
               bc_umi_pairs=pairs, kmers=x["n_kmers"])
    return rep


def mkfastq_run(tmp: str, n_clusters: int = MKFASTQ_CLUSTERS) -> dict:
    """A lane in the classic and the CBCL layouts through run_mkfastq:
    reads per sample as built, equal decompressed FASTQs."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.mkfastq import run_mkfastq
    from cellranger_tpu_torch.testing.fixtures import build_bcl_run

    t = time.time()
    fx = build_bcl_run(os.path.join(tmp, "bcl"), n_clusters)
    rep = dict(clusters=fx["n_clusters"], fixture_s=time.time() - t)
    sw.LAUNCHES = 0
    fastqs = []
    for layout in ("classic", "cbcl"):
        out = os.path.join(tmp, f"bcl_{layout}_out")
        t = time.time()
        s = run_mkfastq(fx[layout], fx["samplesheet"], out,
                        index_kit_csv=fx["index_kit"])
        rep[f"{layout}_s"] = time.time() - t
        if s["samples"] != fx["truth"]:
            raise AssertionError(f"mkfastq {layout}: {s['samples']} != "
                                 f"{fx['truth']}")
        fastqs.append(file_tree(out, gunzip=True))
    if fastqs[0] != fastqs[1]:
        raise AssertionError("mkfastq: classic and CBCL FASTQs differ")
    rep.update(samples=fx["truth"], fastqs=len(fastqs[0]),
               sw_launches=sw.LAUNCHES)
    if sw.LAUNCHES:
        raise AssertionError("mkfastq launched the SW kernel")
    return rep


def memory_report(device) -> dict:
    """Peak device memory since the last reset (None off the card), peak
    host RSS of this process and the machine's MemTotal, in bytes."""
    import resource

    import torch
    total = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
    return dict(
        peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                           if torch.device(device).type == "cuda" else None),
        peak_host_rss_bytes=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        mem_total_bytes=total)


def bucket_sizes(keys, bits: int):
    """Entries each kmer bucket row is given before the cap (the bucket
    of each key, as BucketTable places it), an int64 [2**bits] array."""
    import numpy as np
    from cellranger_tpu_torch.ops.bucket_table import MIX

    h = (np.asarray(keys, np.uint32) * MIX) >> np.uint32(32 - bits)
    return np.bincount(h, minlength=1 << bits)


def fullest_buckets(gi, table, n: int = 1000) -> dict:
    """The JAX package's placement rule (`BucketTable._place`, the numpy
    copy) over the entries of the n fullest buckets, in the build's input
    order, against the rows of `table` (a BucketTable on any device) at
    those buckets: equal, or AssertionError.  Returns their sizes and
    the entries the whole table dropped."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.ops.bucket_table import MIX, BucketTable

    t = time.time()
    bits, E = table.bits, table.entries
    keys, vals = gi.kmer_keys, gi.kmer_pos
    sizes = bucket_sizes(keys, bits)
    top = np.argpartition(sizes, -n)[-n:] if len(sizes) > n else \
        np.arange(len(sizes))
    top = np.sort(top)
    want = np.zeros(len(sizes), bool)
    want[top] = True
    h = (keys * MIX) >> np.uint32(32 - bits)
    sel = np.flatnonzero(want[h])
    rows, dropped = BucketTable._place(keys[sel], vals[sel], bits, E,
                                       table.fields, 1)
    got = table.rows[torch.from_numpy(top).to(table.rows.device)]
    got = got.cpu().numpy()
    if not np.array_equal(got.view(np.uint32), rows[top]):
        bad = top[(got.view(np.uint32) != rows[top]).any(1)]
        raise AssertionError(f"bucket rows {bad[:5].tolist()} differ from "
                             "the JAX rule over their entries")
    placed = int((table.rows[:, :E] != -1).sum())
    return dict(buckets=len(top), entries=int(len(sel)), dropped=dropped,
                fullest=int(sizes[top].max(initial=0)),
                least_of_them=int(sizes[top].min()) if len(top) else 0,
                table_entries=len(keys), table_dropped=len(keys) - placed,
                seconds=time.time() - t)


def index_build(tmp: str, device: str = "cuda",
                genome_len: int = INDEX_BUILD_LEN,
                n_genes: int = INDEX_BUILD_GENES,
                e2e_len: int | None = None) -> dict:
    """GenomeIndex.build on `device` against the numpy build, array for
    array (every array of index.npz), and DeviceIndex.build's tables
    (text rows, overlapped rows, kmer bucket rows and their bits, the
    entries dropped) against those of DeviceIndex.host_arrays: on the e2e
    fixture's genome (every/strand31) and on a seeded genome of
    genome_len bases with the repeat model (testing/repeats.py, copy
    numbers in proportion to its length), N runs and n_genes junction
    contigs (fixtures.index_genome) forced to minimizer sampling and
    parity positions.  Seconds of both builds and of both table builds
    (the device's synchronized), entries, dropped entries, the fullest
    bucket's entries before the cap, peak device memory.  Launches no SW
    kernel."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.align.aligner import (MAX_HITS_PER_SEED,
                                                    DeviceIndex)
    from cellranger_tpu_torch.align.index import GenomeIndex
    from cellranger_tpu_torch.testing import fixtures

    e2e_kw = ({} if e2e_len is None
              else dict(genome_len=e2e_len, n_genes=e2e_len // 10_000))
    cases = {
        "e2e": (fixtures.e2e_genome(os.path.join(tmp, "ib_e2e"), **e2e_kw),
                {}),
        "n_runs": (fixtures.index_genome(os.path.join(tmp, "ib_n"),
                                         genome_len, n_genes=n_genes,
                                         repeats=True),
                   dict(sampling="minimizer", pos_mode="parity"))}
    sw.LAUNCHES = 0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    rep = {}
    for name, ((seqs, txome), kw) in cases.items():
        t = time.time()
        host = GenomeIndex.build(seqs, txome, **kw)
        t_host = time.time() - t
        t = time.time()
        dev = GenomeIndex.build(seqs, txome, device=device, **kw)
        t_dev = time.time() - t
        want, got = host.npz_arrays(), dev.npz_arrays()
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            if w.dtype != g.dtype or w.shape != g.shape or (w != g).any():
                raise AssertionError(f"index_build {name}: {k} differs")
        t = time.time()
        arrays, meta = DeviceIndex.host_arrays(host)
        t_host_tables = time.time() - t
        t = time.time()
        didx = DeviceIndex.build(dev, device)
        if on_card:
            torch.cuda.synchronize(device)
        t_dev_tables = time.time() - t
        if didx.kmer_table.bits != meta["kmer_bits"]:
            raise AssertionError(f"index_build {name}: kmer bits differ")
        ov = arrays["text_rows_ov"]
        _equal_arrays(
            [didx.text_rows.cpu().numpy(), didx.kmer_table.rows.cpu().numpy()]
            + ([] if ov is None else [didx.text_rows_ov.cpu().numpy()]),
            [arrays["text_rows"].view(np.int32),
             arrays["kmer_rows"].view(np.int32)]
            + ([] if ov is None else [ov.view(np.int32)]),
            f"index_build {name} tables (text rows, kmer rows, overlapped)")
        E = MAX_HITS_PER_SEED
        placed = int((didx.kmer_table.rows[:, :E] != -1).sum())
        host_placed = int((arrays["kmer_rows"][:, :E] != 0xFFFFFFFF).sum())
        if placed != host_placed:
            raise AssertionError(f"index_build {name}: {placed} entries "
                                 f"placed on {device}, {host_placed} by numpy")
        rep[name] = dict(
            text_len=len(host.text), sampling=host.sampling,
            pos_mode=host.pos_mode, entries=len(host.kmer_keys),
            kmer_bits=meta["kmer_bits"],
            dropped_entries=len(host.kmer_keys) - placed,
            fullest_bucket_entries=int(bucket_sizes(
                host.kmer_keys, meta["kmer_bits"]).max(initial=0)),
            junctions=host.n_junctions,
            invalid_bases=int((~host.text_valid).sum()),
            numpy_build_s=t_host, device_build_s=t_dev,
            numpy_tables_s=t_host_tables, device_tables_s=t_dev_tables)
        del didx, dev, host, arrays
    rep.update(memory_report(device), sw_launches=sw.LAUNCHES)
    if sw.LAUNCHES:
        raise AssertionError("index_build launched the SW kernel")
    return rep


def human_fixture(tmp: str, device: str = "cuda", **kw) -> dict:
    """build_grch38_run under tmp, with the repeat model unless kw says
    otherwise, its index built on `device`; its host seconds in
    fx["timing"], with the peak device memory of the build."""
    import torch
    from cellranger_tpu_torch.testing.fixtures import build_grch38_run

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.time()
    kw.setdefault("repeats", True)
    fx = build_grch38_run(os.path.join(tmp, "human"), device=device, **kw)
    fx["timing"]["total_s"] = time.time() - t
    fx["timing"].update(memory_report(device))
    return fx


def _human_planes(fx: dict, batch_size: int):
    """(first read's index, ReadBatch, packed plane) of fx's FASTQs in run
    order, barcodes resolved on the host as pass 2 resolves them (a flat
    prior: every barcode error of the fixture corrects back uniquely)."""
    import numpy as np
    from cellranger_tpu_torch.io.chemistry import get_chemistry
    from cellranger_tpu_torch.io.fastq import batches_from_fastqs
    from cellranger_tpu_torch.ops.barcode import host_resolve_barcodes
    from cellranger_tpu_torch.pipeline.count import pack_step_input

    chem = get_chemistry("SC3Pv3")
    ones = np.ones(len(fx["wl_packed"]), np.int64)
    first = 0
    for batch in batches_from_fastqs(chem, fx["fq1"], fx["fq2"], batch_size,
                                     91):
        bc_idx = host_resolve_barcodes(batch.bc_packed, batch.bc_qual,
                                       batch.slot_valid, fx["wl_packed"],
                                       ones, 16)[0]
        yield first, batch, pack_step_input(chem, 91, batch, bc_idx)
        first += batch.n_reads


def _human_reads(didx, ann, dev: str, plane, rna, nmask) -> tuple:
    """The stream step's named outputs and metrics of one plane, and the
    aligner's outputs on its reads (codes `rna`, mask `nmask`), all on
    `dev`, back as numpy."""
    import torch
    from cellranger_tpu_torch.align.aligner import make_aligner
    from cellranger_tpu_torch.io.chemistry import get_chemistry
    from cellranger_tpu_torch.pipeline import count

    step = count.make_stream_step(didx, ann, get_chemistry("SC3Pv3"), 91)
    ho, m = count.unpack_step_out(count.fetch_step_out(
        step(count.upload_plane(plane, dev))))
    al = make_aligner(didx, 91)(torch.from_numpy(rna).to(dev),
                                torch.from_numpy(nmask).to(dev))
    return ho, m, {k: v.cpu().numpy() for k, v in al.items()}


def _deletions_rescued(fx: dict, first: int, al: dict, loss: dict) -> int:
    """The fixture's 2-base deletion reads among the aligned rows whose
    picked locus is on the genome: each must get a K1 score above its
    ungapped score and at least that of the read aligned whole with one
    2-base gap.  (A pick on a junction contig's copy, the reference's
    `contig_straddle` loss of `known_losses`, gets a window cut at the
    contig's start; a read that `loss`, known_losses' classes of these
    rows, puts under `chance_locus` has its pick, and K1's window, at the
    chance locus.)  Returns their count."""
    from cellranger_tpu_torch.align.sw import GAP
    from cellranger_tpu_torch.testing.fixtures import (HUMAN_DELETION,
                                                       HUMAN_KINDS)
    n = len(al["score"])
    d = fx["read_kind"][first:first + n] == HUMAN_KINDS.index("deletion")
    d &= (al["pos"] < fx["genome_len"]) & ~loss["chance_locus"][:n]
    floor = 91 - GAP * HUMAN_DELETION
    bad = d & ~((al["sw_score"] > al["score"]) & (al["sw_score"] >= floor))
    if bad.any():
        i = int(bad.nonzero()[0][0])
        raise AssertionError(
            f"deletion read {first + i} not rescued by K1: score "
            f"{al['score'][i]}, sw_score {al['sw_score'][i]} (floor {floor})")
    return int(d.sum())


def high_positions(gi, didx, device, above: int = 2**31,
                   window: int = 1 << 21, rows_chunk: int = 1 << 20) -> dict:
    """The device tables at text positions `above` and beyond, held
    against the host-encoded text by code that shares nothing with their
    build (whose casts to int32 bit-views wrap above 2**31):
      * every kmer bucket-row entry at such a position: its k bases,
        gathered from the text, give its canonical key, its strand bit and
        its bucket (parity: at one of the two positions its value rounds);
      * the text rows and overlapped rows of the `window` bases on each
        side of `above`, and of the text's last `window` bases, against
        the numpy packing of those bases;
      * the kmer entries of the bases on each side of `above` against the
        numpy build of those bases alone, positions offset.
    Returns the counts checked and the seconds."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.align import index as tidx
    from cellranger_tpu_torch.ops.bucket_table import MIX
    from cellranger_tpu_torch.ops.tensor_ops import U32_MASK, widen

    t0 = time.time()
    k, G = gi.k, len(gi.text)
    parity = gi.pos_mode == "parity"
    tab = didx.kmer_table
    E, bits = tab.entries, tab.bits
    text = torch.from_numpy(gi.text).to(device)
    valid = torch.from_numpy(gi.text_valid).to(device)
    ar = torch.arange(k, device=device)
    sh = 2 * (k - 1 - ar)
    n_entries = 0
    for r0 in range(0, tab.rows.shape[0], rows_chunk):
        blk = tab.rows[r0:r0 + rows_chunk]
        key, val = widen(blk[:, :E]), widen(blk[:, E:2 * E])
        row = torch.arange(r0, r0 + blk.shape[0],
                           device=device)[:, None].expand_as(key)
        pos = val & (0xFFFFFFFE if parity else 0x7FFFFFFF)
        strand = val & 1 if parity else val >> 31
        sel = (key != U32_MASK) & (pos >= above)
        key, pos, strand, row = key[sel], pos[sel], strand[sel], row[sel]
        ok = ((key * int(MIX)) & U32_MASK) >> (32 - bits) == row
        found = torch.zeros_like(ok)
        for p in (pos, pos + 1) if parity else (pos,):
            inb = p + k <= G
            at = torch.where(inb, p, 0)[:, None] + ar
            c = text[at].to(torch.int64)
            fwd = (c << sh).sum(1)
            rc = ((3 - c.flip(1)) << sh).sum(1)
            is_rc = rc < fwd
            found |= (inb & valid[at].all(1)
                      & (torch.where(is_rc, rc, fwd) == key)
                      & (is_rc.to(torch.int64) == strand))
        ok &= found
        if not bool(ok.all()):
            i = int((~ok).nonzero()[0, 0])
            raise AssertionError(
                f"kmer entry at text position {int(pos[i])} (row "
                f"{int(row[i])}, key {int(key[i])}, strand "
                f"{int(strand[i])}) is not the text's")
        n_entries += int(key.shape[0])
    del text, valid
    entries_s = time.time() - t0

    t = time.time()
    n_rows = 0
    a_mid = max(above - window, 0) // 256 * 256
    for a, b in ((a_mid, min(a_mid + 2 * window, G)),
                 (max(G - window, 0) // 256 * 256, G)):
        want = tidx._pack_text_rows(gi.text[a:b], gi.text_valid[a:b])
        if b < G:
            want = want[:(b - a) // 256]
        got = didx.text_rows[a // 256:a // 256 + len(want)]
        if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
            raise AssertionError(f"text rows of bases [{a}, {b}) differ "
                                 "from their numpy packing")
        n_rows += len(want)
        if didx.text_rows_ov is not None:
            from numpy.lib.stride_tricks import sliding_window_view
            tw = sliding_window_view(want[:, :16].reshape(-1), 14)[::8]
            vw = sliding_window_view(want[:, 16:].reshape(-1), 14)[::8]
            got = didx.text_rows_ov[a // 128:a // 128 + len(tw)]
            got = got.cpu().numpy().view(np.uint32)
            if not np.array_equal(got, np.concatenate([tw, vw], 1)[
                    :len(got)]):
                raise AssertionError(f"overlapped rows of bases [{a}, {b}) "
                                     "differ from their numpy packing")
    rows_s = time.time() - t

    t = time.time()
    a, b = a_mid, min(a_mid + 2 * window, G)
    lo, hi = max(a - 256, 0), min(b + 256, G)
    if gi.sampling == "minimizer":
        keys, vals = tidx._build_kmer_table_minimizer(
            gi.text[lo:hi], gi.text_valid[lo:hi], k, gi.minimizer_w,
            gi.pos_mode)
    else:
        assert lo % gi.stride == 0
        keys, vals = tidx._build_kmer_table(
            gi.text[lo:hi], gi.text_valid[lo:hi], k, gi.stride, gi.pos_mode)
    pmask = np.uint32(0xFFFFFFFE if parity else 0x7FFFFFFF)
    vals = (vals & ~pmask) | ((vals & pmask) + np.uint32(lo))

    def in_window(keys, vals):
        p = vals & pmask
        m = (p >= a) & (p < b)
        keys, vals = keys[m], vals[m]
        order = np.lexsort((vals, keys))
        return keys[order], vals[order]

    want = in_window(keys, vals)
    got = in_window(gi.kmer_keys, gi.kmer_pos)
    if not all(np.array_equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"kmer entries of bases [{a}, {b}): "
                             f"{len(got[0])} in the table, {len(want[0])} "
                             "in their numpy build")
    return dict(above=above, entries_checked=n_entries,
                entries_s=entries_s, rows_checked=n_rows, rows_s=rows_s,
                window_entries=len(want[0]), window_s=time.time() - t)


def human_parity(fx: dict, devices=("cuda", "cpu"),
                 n_reads: int = HUMAN_PARITY_READS,
                 n_truth: int = HUMAN_TRUTH_READS) -> dict:
    """The first n_reads reads of the human-scale fixture through the
    fused stream step and the aligner on both devices (devices[0]'s tables
    built through run_count's reference memo, as human_scale then finds
    them, with their bytes, the load's split and peak memory;
    devices[1]'s copies of them, which index_build and the tests hold
    equal to the host build's): every output equal;
    the deletion reads among them rescued by K1 on both.  On the repeat
    model, n_reads more reads off its repeat copies, every family alike
    (`repeat_copy_reads`), equal on both devices too, and the rows of the
    1,000 fullest kmer buckets held to the JAX package's placement rule
    over their entries (`fullest_buckets`).  Then bench.py's truth probe
    on devices[0]: n_truth error-free reads, half intergenic at every
    copy of chr1's repeat segment, half in exon 1 of a '+' gene that no
    repeat copy touches."""
    import numpy as np
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.align.annotate import AnnotationIndex
    from cellranger_tpu_torch.ops import encode
    from cellranger_tpu_torch.parallel.mesh import to_device
    from cellranger_tpu_torch.pipeline import count
    from cellranger_tpu_torch.testing.fixtures import (human_truth_reads,
                                                       reads_plane,
                                                       repeat_copy_reads)

    a, b = devices
    if torch.device(a).type == "cuda":
        torch.cuda.reset_peak_memory_stats(a)
    t = time.time()
    ref, didx_a, ann_a = count._load_reference_cached(fx["ref"], a)
    rep = dict(load_reference_s=time.time() - t,
               load_split_s=dict(count._REF_MEMO["split"]),
               device_tables=human_tables(didx_a, ann_a),
               load=memory_report(a))
    gi = ref.genome_index
    rep["high_positions"] = high_positions(
        gi, didx_a, a,
        above=2**31 if len(gi.text) > 2**31 else len(gi.text) // 2)
    rep["fullest_buckets"] = fullest_buckets(gi, didx_a.kmer_table)
    t = time.time()
    tables = {a: (didx_a, ann_a),
              b: (to_device(didx_a, b),
                  AnnotationIndex.build(ref.transcriptome, gi, b))}
    rep[f"{b}_tables_s"] = time.time() - t
    sw.LAUNCHES = 0
    first, batch, plane = next(_human_planes(fx, n_reads))
    planes = [("fastq", plane, batch.rna, batch.rna_nmask)]
    if "repeat_plan" in fx:
        reads, fam = repeat_copy_reads(fx, n_reads)
        planes.append(("repeat_copies", reads_plane(
            reads, np.zeros(n_reads, np.int32),
            np.arange(n_reads, dtype=np.uint32)),
            *encode.encode_seqs(reads)))
        rep["repeat_copy_reads"] = {f: int((fam == f).sum())
                                    for f in np.unique(fam)}
    for name, pl, rna, nmask in planes:
        got = {dev: _human_reads(*tables[dev], dev, pl, rna, nmask)
               for dev in devices}
        (ho_a, m_a, al_a), (ho_b, m_b, al_b) = got[a], got[b]
        if m_a != m_b:
            raise AssertionError(f"human_parity {name} metrics: {m_a} != "
                                 f"{m_b}")
        for what, x, y in (("step", ho_a, ho_b), ("aligner", al_a, al_b)):
            if sorted(x) != sorted(y):
                raise AssertionError(f"human_parity {name} {what} fields "
                                     "differ")
            _equal_arrays([x[k] for k in sorted(x)],
                          [y[k] for k in sorted(y)],
                          f"human_parity {name} {what} ({sorted(x)})")
        if name == "fastq":
            fastq = (ho_a, m_a, al_a)
    ho_a, m_a, al_a = fastq
    k = batch.n_reads
    kind = fx["read_kind"][first:first + k]
    counted = fx["read_counted"]
    loss = known_losses({f: v[:k] for f, v in al_a.items()},
                        ~ho_a["conf_ok"][:k] & counted[first:first + k],
                        m_a["n_promote_overflow"] > 0, didx_a,
                        deletion=kind == _kind("deletion"),
                        in_copy=_in_copy(kind),
                        true_pos=fx["read_pos"][first:first + k])
    copy_reads = n_reads if len(planes) > 1 else 0
    rep.update(reads=k + copy_reads,
               reads_off_repeat_copies=copy_reads + int(np.isin(kind, [
                   _kind(x) for x in ("repeat", "exon_repeat", "paralog")])
                   .sum()),
               fields=len(ho_a) + len(al_a),
               deletion_reads_rescued=_deletions_rescued(
                   fx, first, {f: v[:k] for f, v in al_a.items()}, loss),
               conf=int(ho_a["conf_ok"].sum()),
               above_2_31=int((ho_a["pos"] >= 2**31).sum()))
    del tables[b]

    reads, true_gene, in_rep = human_truth_reads(fx, n_truth)
    plane = reads_plane(reads, np.zeros(n_truth, np.int32),
                        np.arange(n_truth, dtype=np.uint32))
    ho, _m, al = _human_reads(didx_a, ann_a, a, plane,
                              *encode.encode_seqs(reads))
    off = ~in_rep
    gene_ok = (ho["gene"].astype(np.int64) == true_gene) & ho["conf_ok"]
    truth = dict(
        off_repeat_correct_gene_mapq255=float(
            (gene_ok & (ho["mapq"] == 255))[off].mean()),
        repeat_low_mapq=float((ho["mapped"] & (ho["mapq"] < 255))[in_rep]
                              .mean()),
        repeat_false_confident=float(
            (ho["conf_ok"] & (ho["mapq"] == 255))[in_rep].mean()))
    # an off-repeat read may only be missed as the reference misses it
    loss = known_losses(al, off & ~(gene_ok & (ho["mapq"] == 255)),
                        _m["n_promote_overflow"] > 0, didx_a,
                        deletion=np.zeros(n_truth, bool))
    rep.update(truth=truth, truth_reads=n_truth,
               truth_missed={k: int(v.sum()) for k, v in loss.items()},
               sw_launches=sw.LAUNCHES)
    bad = loss["other"] | (in_rep & ~(ho["mapped"] & (ho["mapq"] < 255)))
    if (truth["repeat_low_mapq"] != 1.0
            or truth["repeat_false_confident"] != 0.0
            or truth["off_repeat_correct_gene_mapq255"] < HUMAN_TRUTH_FLOOR
            or bad.any()):
        i = int(bad.argmax())
        raise AssertionError("human truth probe: " + json.dumps(rep) + " "
                             + json.dumps({f: np.asarray(v[i]).tolist()
                                           for f, v in al.items()}))
    return rep


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def human_tables(didx, ann) -> dict:
    """Bytes of each device table of the human reference.  The whitelist
    has none: pass 2 resolves barcodes on the host."""
    return dict(text_rows=_nbytes(didx.text_rows),
                overlap_rows=_nbytes(didx.text_rows_ov),
                kmer_table=_nbytes(didx.kmer_table.rows),
                junction_rows=_nbytes(didx.sj_rows),
                annotation=(_nbytes(ann.iv_rows) + _nbytes(ann.iv_grid)
                            + _nbytes(ann.sj_rows)),
                whitelist_table=0)


LOSSES = ("saturated", "contig_straddle", "false_novel_junction",
          "promote_overflow", "chance_locus", "copy_crowded")


def _in_copy(kind):
    """bool per read: of a kind the fixture draws inside a repeat copy,
    error-free (the reads `copy_crowded` takes)."""
    import numpy as np
    return np.isin(kind, [_kind("exon_repeat"), _kind("paralog")])


def _kind(name: str) -> int:
    from cellranger_tpu_torch.testing.fixtures import REPEAT_KINDS
    return REPEAT_KINDS.index(name)


def _kinds(fx: dict) -> tuple:
    from cellranger_tpu_torch.testing.fixtures import HUMAN_KINDS
    return fx.get("kinds", HUMAN_KINDS)


def known_losses(al: dict, miss, overflow: bool, didx, *, deletion,
                 in_copy=None, true_pos=None) -> dict:
    """The reference's known losses among the reads `miss` (bool), from
    the aligner's outputs `al` on the device index `didx` (ROADMAP.md
    section 3), each read in the first class it fits, the rest under
    "other".  `deletion` (bool) marks the fixture's deletion reads, the
    only kind `chance_locus` takes; `in_copy` (bool, default none) the
    reads the fixture drew inside a repeat copy, the only ones
    `copy_crowded` takes, and `true_pos` their text starts:
      saturated        parity rounding splits one locus over two vote
                       keys, so a read seen on a locus and on its
                       junction contig copy passes the candidate cap with
                       one canonical locus and is reported as a repeat;
      contig_straddle  a best locus on a junction contig whose alignment
                       runs past the contig's end (the read starts in the
                       contig before it): canonical_pos and the
                       annotation read the wrong junction;
      false_novel_junction  an unspliced read (a deletion read) whose
                       low ungapped score lets a chance seed match far
                       away pair with its true locus into a novel
                       junction, whose left segment annotates elsewhere;
      promote_overflow a multi-locus read of a batch whose promotion
                       capacity overflowed (`overflow`);
      chance_locus     an unmapped deletion read whose pick gains nothing
                       from K1 (sw_score <= score): its true window
                       starts outside the offsets that parity
                       rounding lets the aligner try scores a few bases
                       there, and a chance seed match elsewhere (most
                       reads have one in 3 Gb of text) scores more, so the
                       pick and K1's rescue go to the chance locus;
      copy_crowded     a read inside a repeat copy whose own locus is
                       none of its candidates (no `loci_pos` within 4
                       bases of `true_pos`).  Its seeds' keys are shared
                       by more copies than a bucket row holds
                       (MAX_HITS_PER_SEED); the first copies by position
                       take the row, every read of the family votes for
                       them, and they and chance hits outvote the few
                       seeds private to the read's own copy.  The read is
                       scored at another copy: below its length there, or
                       at its length where that copy equals it (a copy
                       in another gene counts it there); or, at chance
                       hits only, it stays unmapped."""
    import numpy as np

    contig_len = 2 * didx.sj_overhang
    on = al["loci_ok"] & (al["loci_pos"] >= didx.genome_len)
    off = (al["loci_pos"] - didx.genome_len) % contig_len
    straddle = (on & (off + al["loci_start"] + al["loci_len"]
                      > contig_len)).any(1)
    out, left = {}, np.asarray(miss, bool).copy()
    for name, hit in (("saturated", al["saturated"]),
                      ("contig_straddle", straddle),
                      ("false_novel_junction", al["novel_sj"]),
                      ("promote_overflow", (al["n_best"] >= 2) & overflow),
                      ("chance_locus", np.asarray(deletion, bool)
                       & ~al["mapped"] & (al["sw_score"] <= al["score"])),
                      ("copy_crowded", own_locus_absent(al, in_copy,
                                                        true_pos))):
        out[name] = left & hit
        left &= ~hit
    out["other"] = left
    return out


def own_locus_absent(al: dict, in_copy, true_pos):
    """bool per read: drawn inside a repeat copy (`in_copy`) and no
    candidate locus of the aligner's (`loci_pos`, all of them) within 4
    bases of its text start `true_pos` (parity rounding moves a locus by
    at most that)."""
    import numpy as np

    n = len(al["score"])
    if in_copy is None:
        return np.zeros(n, bool)
    near = np.abs(al["loci_pos"].astype(np.int64)
                  - np.asarray(true_pos, np.int64)[:, None]) <= 4
    return np.asarray(in_copy, bool) & ~near.any(1)


def _chance_read(fx: dict, read: int, codes, al: dict, i: int) -> dict:
    """Where read `read` (its codes `codes`, row i of the aligner's
    outputs `al`), a `chance_locus` loss, was picked: chromosome and
    offset, strand, scores, and how many of its kmers (16 bases) equal
    the text on the pick's diagonal, from the fixture's host text."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    pos, strand = int(al["pos"][i]), int(al["strand"][i])
    r = codes if strand == 0 else 3 - codes[::-1]
    at = pos - fx["chr1_start"]
    eq = fx["codes"][at:at + len(r)] == r[:max(len(fx["codes"]) - at, 0)]
    c = int(np.searchsorted(fx["chrom_starts"], pos, side="right")) - 1
    return dict(read=int(read), gene=int(fx["read_gene"][read]),
                chrom=str(fx["chrom_names"][c]),
                at=pos - int(fx["chrom_starts"][c]), strand=strand,
                score=int(al["score"][i]), aln_len=int(al["aln_len"][i]),
                sw_score=int(al["sw_score"][i]),
                kmers_on_diagonal=int(sliding_window_view(eq, 16).all(1)
                                      .sum()) if len(eq) >= 16 else 0)


def human_account(fx: dict, didx, ann, device: str,
                  batch_size: int = HUMAN_BATCH) -> dict:
    """Every read of the fixture through the stream step and the aligner
    in run_count's batches, on `device`, held against what the fixture
    built.  A read the fixture counts (`read_counted`) that is not
    confidently mapped must be one of the reference's known losses
    (`known_losses`, from the aligner's outputs of the same batch); a
    confident read must have its own gene, unless it is a `copy_crowded`
    read (counted, then, under the gene of the copy it was scored at);
    the reads of the chr1 repeat and the multi-gene paralog reads must be
    mapped below MAPQ 255 and never counted.  Anything else fails.
    Returns the counts a run of the same batches must give and the losses
    by kind."""
    import numpy as np

    kinds = _kinds(fx)
    n = fx["n_reads"]
    counted = fx["read_counted"]
    conf = np.zeros(n, bool)
    run_gene = np.full(n, -1, np.int64)
    lost = {c: np.zeros(n, bool) for c in LOSSES}
    rep = dict(deletion_reads_rescued=0, promote_overflow_reads=0,
               chance_locus_reads=[], copy_crowded_other_gene=0,
               saturated_reads=0, multi_mapped_reads=0)
    for first, batch, plane in _human_planes(fx, batch_size):
        ho, m, al = _human_reads(didx, ann, device, plane, batch.rna,
                                 batch.rna_nmask)
        k = batch.n_reads
        sl = slice(first, first + k)
        ho = {f: v[:k] for f, v in ho.items()}
        al = {f: v[:k] for f, v in al.items()}
        kind, gene, cnt = (fx["read_kind"][sl], fx["read_gene"][sl],
                           counted[sl])
        c = ho["conf_ok"]
        if c.sum() != m["n_conf"]:
            raise AssertionError("a read lost its barcode or UMI")
        if (c & ~cnt).any() or not (
                ho["mapped"] & (ho["mapq"] < 255))[~cnt].all():
            raise AssertionError("a repeat or multi-gene paralog read is "
                                 "unmapped or confident")
        deletion = kind == _kind("deletion")
        in_copy, true_pos = _in_copy(kind), fx["read_pos"][sl]
        crowded = own_locus_absent(al, in_copy, true_pos)
        other_gene = c & (ho["gene"].astype(np.int64) != gene)
        if (other_gene & ~crowded).any():
            i = int((other_gene & ~crowded).nonzero()[0][0])
            raise AssertionError(
                f"read {first + i} ({kinds[kind[i]]}) is confident on gene "
                f"{int(ho['gene'][i])}, not {int(gene[i])}: "
                + json.dumps({f: np.asarray(v[i]).tolist()
                              for f, v in al.items()}))
        conf[sl] = c
        run_gene[sl] = ho["gene"]
        loss = known_losses(al, (~c & cnt) | other_gene,
                            m["n_promote_overflow"] > 0, didx,
                            deletion=deletion, in_copy=in_copy,
                            true_pos=true_pos)
        if loss["other"].any():
            i = int(loss["other"].nonzero()[0][0])
            raise AssertionError(
                f"read {first + i} ({kinds[kind[i]]}) lost: "
                + json.dumps({f: np.asarray(v[i]).tolist()
                              for f, v in al.items()}))
        for name in LOSSES:
            lost[name][sl] = loss[name]
        rep["copy_crowded_other_gene"] += int(other_gene.sum())
        rep["saturated_reads"] += int(al["saturated"].sum())
        rep["multi_mapped_reads"] += int((ho["mapped"]
                                          & (al["n_best"] >= 2)).sum())
        rep["chance_locus_reads"] += [
            _chance_read(fx, first + i, batch.rna[i], al, i)
            for i in np.flatnonzero(loss["chance_locus"])]
        rep["deletion_reads_rescued"] += _deletions_rescued(fx, first, al,
                                                            loss)
        rep["promote_overflow_reads"] += m["n_promote_overflow"]
    mols, at = np.unique(fx["read_mol"][conf], return_index=True)
    e = fx["expected"]
    rep.update(
        conf_mapped_reads=int(conf.sum()), total_molecules=len(mols),
        gene_molecules=np.bincount(run_gene[conf][at],
                                   minlength=len(e["gene_molecules"])),
        truth_molecules=e["total_molecules"],
        truth_conf_mapped_reads=e["conf_mapped_reads"],
        lost_reads={name: {kn: int((x & (fx["read_kind"] == i)).sum())
                           for i, kn in enumerate(kinds)}
                    for name, x in lost.items()})
    return rep


def loss_overruns(fx: dict, lost_reads: dict, caps: dict) -> list:
    """The (loss, kind) pairs of `lost_reads` (human_account's) past their
    cap: caps[loss][kind] times the fixture's reads of that kind, plus
    HUMAN_LOSS_SLACK reads."""
    import numpy as np

    kinds = _kinds(fx)
    n_kind = np.bincount(fx["read_kind"], minlength=len(kinds))
    over = []
    for loss, by_kind in lost_reads.items():
        for i, kind in enumerate(kinds):
            cap = (caps.get(loss, {}).get(kind, 0.0) * n_kind[i]
                   + HUMAN_LOSS_SLACK)
            if by_kind[kind] > cap:
                over.append(f"{loss} {kind}: {by_kind[kind]} > {cap:.1f}")
    return over


def human_scale(fx: dict, out: str, device: str = "cuda",
                batch_size: int = HUMAN_BATCH,
                loss_caps: dict = HUMAN_LOSS_CAPS) -> dict:
    """The fixture's reads through run_count on `device`, count-only:
    wall, phases, the reference load's split, device tables and peak
    memory; the run must give exactly the molecules, confidently mapped
    reads and molecules per gene that `human_account` finds read by read
    (each read the fixture built either counted under its own gene or one
    of the reference's known losses), each loss within `loss_caps`
    (`loss_overruns`), and launch K1 once a step."""
    import numpy as np
    from cellranger_tpu_torch.io.matrix_io import CountMatrix
    from cellranger_tpu_torch.pipeline import count

    r = count_run(fx, out, device=device, batch_size=batch_size)
    s = r.pop("summary")
    _ref, didx, ann = count._load_reference_cached(fx["ref"], device)
    r.update(device_tables=human_tables(didx, ann),
             load_split_s=dict(count._REF_MEMO["split"] or {}),
             memory=memory_report(device),
             conf_mapped_reads=s["conf_mapped_reads"],
             promote_overflow=s["promote_overflow"])
    t = time.time()
    acct = human_account(fx, didx, ann, device, batch_size)
    r["account_s"] = time.time() - t
    m = CountMatrix.load_h5(os.path.join(out, "raw_feature_bc_matrix.h5"))
    per_gene = np.asarray(m.m.sum(1)).ravel()
    diffs = [k for k in ("total_molecules", "conf_mapped_reads")
             if r[k] != acct[k]]
    if not np.array_equal(per_gene, acct["gene_molecules"]):
        diffs.append("molecules per gene")
    if r["reads"] != fx["n_reads"]:
        diffs.append("reads")
    if r["sw_launches"] != (r["n_steps"] if device == "cuda" else 0):
        diffs.append(f"{r['sw_launches']} K1 launches in {r['n_steps']} "
                     f"steps on {device}")
    diffs += loss_overruns(fx, acct["lost_reads"], loss_caps)
    acct.pop("gene_molecules")
    r["account"] = acct
    if diffs:
        raise AssertionError(f"human_scale: {diffs}: " + json.dumps(r))
    return r


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false)")
    from cellranger_tpu_torch import kernels, native   # the port must be here
    from cellranger_tpu_torch.testing.analysis_check import analysis_files
    from cellranger_tpu_torch.pipeline.count import H5_OUTPUTS
    from cellranger_tpu_torch.testing.fixtures import build_e2e_run
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    phase("device", f"{name} sm_{cap[0]}{cap[1]}, torch {torch.__version__}"
          f" cuda {torch.version.cuda}; nvidia-smi: {smi}")

    t = time.time()
    lib = kernels.build()
    t_kernels = time.time() - t
    fastq_lib = ("the native FASTQ reader under "
                 f"{os.path.relpath(native.BUILD_DIR)}"
                 if native.get_lib() is not None else
                 "no native FASTQ reader (no g++ or zlib): python reader")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                       kernels.BUILD_LOG)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill",
                                         kernels.BUILD_LOG)]
    phase("build", f"{os.path.relpath(lib)} in {t_kernels:.3f} s, "
          f"{len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{sum(spills)} bytes spilled; {fastq_lib}")

    sw_report = check_sw_kernel()

    tmp = tempfile.mkdtemp(prefix="crt_smoke_")
    launches = {}
    try:
        with phase_beside("cellplex", tmp, CELLPLEX_TIMEOUT_S,
                          tmp) as cellplex_report, phase_beside(
                              "vdj_b_run", tmp, VDJ_B_TIMEOUT_S,
                              tmp) as vdj_b_report:
            g = index_build(tmp)
            launches["index_build"] = g["sw_launches"]
            phase("index_build", f"{smi}: cuda == numpy, every index.npz "
                  "array and the text, overlapped and kmer rows: "
                  + json.dumps(g))
            s, n_steps = tiny_parity(tmp)
            phase("tiny_parity", f"cuda == cpu over {n_steps} steps: "
                  f"{s['total_reads']} reads, {s['total_molecules']} "
                  "molecules")

            g = golden(tmp, "e2e")
            launches["golden_tiny"] = g["sw_launches_cuda"]
            phase("golden_tiny", "equal to tests/golden/e2e: " + json.dumps(g))
            g = golden(tmp, "e2e_rich", devices=("cuda", "cpu"))
            launches["golden_rich"] = g["sw_launches_cuda"]
            phase("golden_rich", "equal to tests/golden/e2e_rich, cuda BAM == "
                  "cpu BAM: " + json.dumps(g))

            t0 = time.time()
            fx = build_e2e_run(os.path.join(tmp, "e2e"), n_reads=E2E_READS)
            t_fix = time.time() - t0
            e2e_out = os.path.join(tmp, "e2e_out")
            with h5_writes() as written:
                r = count_run(fx, e2e_out, secondary_analysis=True)
            r["h5"] = h5_read_back(written)
            if sorted(r["h5"]) != sorted(H5_OUTPUTS):
                raise AssertionError("e2e wrote the h5 files "
                                     f"{sorted(r['h5'])}")
            e2e_summary = r.pop("summary")
            check_e2e_counts("e2e", r)
            r["fixture_s"] = t_fix
            # analysis apart, so the count-only figures stay comparable
            r["analysis_reporting_s"] = r["phase_s"]["analysis_reporting"]
            r["count_wall_s"] = r["wall_s"] - r["analysis_reporting_s"]
            r["analysis_files"] = len(analysis_files(
                os.path.join(e2e_out, "analysis")))
            if r["analysis_files"] != 16:
                raise AssertionError(f"e2e analysis/ has {r['analysis_files']}"
                                     " files")
            launches["e2e"] = r["sw_launches"]
            phase("e2e", json.dumps(r))

            rb = bam_run(fx, tmp, r["total_molecules"], mex_sha256(e2e_out),
                         n_reads=E2E_BAM_READS)
            launches["e2e_bam"] = rb["sw_launches"]
            phase("e2e_bam", f"{smi}: the JAX package's BAM payload and "
                  "records, the index of its records: " + json.dumps(rb))
            g = bam_held(fx, tmp)
            launches["bam_held"] = g["sw_launches"]
            phase("bam_held", "the run's .bam and .bai == the plain "
                  "writer's: " + json.dumps(g))

            ovf_out = os.path.join(tmp, "overflow_out")
            ro = overflow_run(fx, ovf_out, e2e_out)
            check_e2e_counts("overflow", ro)
            launches["overflow"] = ro["sw_launches"]
            phase("overflow", f"state cap {OVERFLOW_STATE_CAP}: same "
                  "molecules and MEX bytes as e2e: " + json.dumps(ro))
            g = dedup_memory()
            phase("dedup_memory", f"{smi}: " + json.dumps(g))
            g = deep(tmp)
            launches["deep"] = g["sw_launches"]
            phase("deep", f"{g['reads']} reads, the JAX package's molecules "
                  "and MEX bytes, the state flushed at its cap, every dedup "
                  "call within the limit: " + json.dumps(g))
            with phase_beside("depth_small", tmp, DEPTH_SMALL_TIMEOUT_S, tmp,
                              {"ref": fx["ref"], "wl": fx["wl"]}
                              ) as depth_small_report, phase_beside(
                                  "immune_held", tmp, IMMUNE_HELD_TIMEOUT_S,
                                  tmp) as immune_held_report, phase_beside(
                                  "flex_held", tmp, FLEX_HELD_TIMEOUT_S,
                                  tmp) as flex_held_report, phase_beside(
                                  "analysis_both", tmp, ANALYSIS_TIMEOUT_S,
                                  tmp) as analysis_report:
                g = h5_pipelines(fx, tmp, e2e_out, ovf_out)
                launches["h5_pipelines"] = g["sw_launches"]
                phase("h5_pipelines", "aggr, GEM wells and reanalyze "
                      "through io/hdf5.py: " + json.dumps(g))

                devs = mesh_devices()
                for path, shard in (("mesh", False),
                                    ("mesh_shard_index", True)):
                    rm = mesh_run(fx, os.path.join(tmp, f"{path}_out"),
                                  e2e_out, e2e_summary, devs,
                                  shard_index=shard)
                    launches[path] = rm["sw_launches"]
                    phase(path, ("4 distinct cards"
                                 if rm["distinct_cards"] > 1 else
                                 "cuda:0 four times: the code path, not a "
                                 "multi-GPU speedup") + "; same metrics and "
                          "MEX bytes as e2e: " + json.dumps(rm))
                rh = multihost_run(fx, tmp)
                launches["multihost"] = rh["sw_launches"]
                phase("multihost", "host 0 == one process on the same lanes: "
                      + json.dumps(rh))

                g = pe_parity(tmp, fx)
                launches["pe_parity"] = g["sw_launches_cuda"]
                phase("pe_parity", "cuda == cpu, metrics, MEX and BAM bytes: "
                      + json.dumps(g))
                rp = pe_run(tmp, fx)
                launches["pe"] = rp["sw_launches"]
                phase("pe", json.dumps(rp))

                g = rtl_parity(tmp)
                launches["rtl_parity"] = g["sw_launches"]
                phase("rtl_parity", "cuda == cpu, metrics, MEX and the probe "
                      "aligner's five outputs: " + json.dumps(g))
                rr = rtl_run(tmp)
                launches["rtl"] = rr["sw_launches"]
                phase("rtl", json.dumps(rr))

                g = multi_run(tmp)
                launches["multi"] = g["sw_launches"]
                phase("multi", "cells in the samples they were built for: "
                      + json.dumps(g))

                g = depth_small_report()
                immune = immune_held_report()
                flex = flex_held_report()
                both = analysis_report()
            launches["depth_small"] = g["sw_launches"]
            phase("depth_small", f"{smi}: {g['reads']} reads of the depth "
                  "fixture in a child process beside "
                  "h5_pipelines..multi, count-only with the state "
                  "flushing and with BAM in parts of at most "
                  f"{g['bam']['bam_split']['band_records']} records: the "
                  "fixture's truth, the same MEX: " + json.dumps(g))
            launches["immune_held"] = immune["sw_launches"]
            phase("immune_held", f"{smi}: run_multi of a 5' well (GEX, "
                  "VDJ-T with two-alpha clones and VDJ-B with a two-light "
                  "clone, planted dropouts, one TR + IG reference) in a "
                  "child process beside h5_pipelines..multi: "
                  f"{immune['files_equal']} digests the JAX package's "
                  "and the well's truth: " + json.dumps(immune))
            launches["flex_held"] = flex["sw_launches"]
            phase("flex_held", f"{smi}: run_multi of a multiplexed Flex "
                  "well (16 probe barcodes, beads shared between samples, "
                  "one sample of two probe barcodes, one probe barcode of "
                  "no sample) in a child process beside "
                  f"h5_pipelines..multi: {flex['files_equal']} digests "
                  "the JAX package's and the well's truth: "
                  + json.dumps(flex))
            launches["analysis"] = both["analysis"]["sw_launches"]
            # its times share the host's cores with the phases beside it,
            # so they do not compare with a serial run's
            both["analysis"]["timed_beside"] = [
                "h5_pipelines..multi", "depth_small", "immune_held",
                "flex_held"]
            phase("analysis", f"{smi}: in a child process beside "
                  "h5_pipelines..multi, depth_small, immune_held and "
                  "flex_held, its times taken under their load: "
                  + json.dumps(both["analysis"]))
            phase("analysis_parity", "cuda against cpu, two cuda runs "
                  "identical, in the same child process after analysis: "
                  + json.dumps(both["analysis_parity"]))

            g = cellplex_report()
            launches["cellplex"] = g["sw_launches"]
            phase("cellplex", f"{smi}: run_multi of a CellPlex GEM well, 12 "
                  "CMOs and 17 antibodies, "
                  "in a child process beside index_build..multi, "
                  "held to the JAX package's run and the planted truth: "
                  + json.dumps(g))
            g = vdj_b_report()
        launches["vdj_b"] = g["sw_launches"]
        phase("vdj_b", f"{smi}: run_vdj of {g['cells']} B cells (IGH with "
              "IGK or IGL, isotypes, somatic hypermutation, "
              f"{g['plasma_cells']} plasma cells past the 80,000-row cap) "
              "in a child process beside index_build..multi, "
              "held to the fixture's truth: " + json.dumps(g))

        with phase_beside("analysis_68k", tmp, ANALYSIS_68K_TIMEOUT_S,
                          tmp) as analysis_68k_report, phase_beside(
                              "perturb", tmp, PERTURB_TIMEOUT_S,
                              tmp) as perturb_report, phase_beside(
                              "vdj_t_and_held", tmp, VDJ_TIMEOUT_S,
                              tmp) as vdj_report:
            g = vdj_parity(tmp)
            launches["vdj_parity"] = g["sw_launches"]
            phase("vdj_parity", "cuda == cpu, every output file; kmers in "
                  "blocks equal: " + json.dumps(g))
            g = vdj_held(tmp)
            launches["vdj_held"] = g["sw_launches"]
            phase("vdj_held", f"{smi}: every output file the JAX package's "
                  "and the fixture's truth: " + json.dumps(g))
            g = vdj_fast_parity(tmp)
            phase("vdj_fast_parity", "vdj/support.py == the plain versions "
                  "on every contig: " + json.dumps(g))
            g = vdj_kmers(tmp)
            launches["vdj_kmers"] = g["sw_launches"]
            phase("vdj_kmers", json.dumps(g))
            g = mkfastq_run(tmp)
            launches["mkfastq"] = g["sw_launches"]
            phase("mkfastq", "reads per sample as built, classic == CBCL: "
                  + json.dumps(g))

            fx = human_fixture(tmp)
            g = human_parity(fx)
            launches["human_parity"] = g["sw_launches"]
            phase("human_parity", f"{smi}: {fx['text_len']}-base text; "
                  "cuda == cpu, every step and aligner output, FASTQ reads"
                  " and reads off every repeat family; the fullest buckets"
                  " by the JAX rule; truth probe: " + json.dumps(dict(
                      g, fixture_s=fx["timing"],
                      repeat_bases=fx.get("repeat_bases"),
                      reads_by_kind=fx["reads_by_kind"])))
            g = human_scale(fx, os.path.join(tmp, "human_out"))
            launches["human_scale"] = g["sw_launches"]
            phase("human_scale", "the fixture's reads counted or lost as "
                  "the reference loses them: " + json.dumps(g))
            g = analysis_68k_report()
            launches["analysis_68k"] = g["sw_launches"]
            phase("analysis_68k", f"{smi}: reanalyze past max_cells_tsne "
                  "in a child process beside vdj_parity..human_scale, the "
                  "kNN searches held to float64: " + json.dumps(g))
            g = perturb_report()
            launches["perturb"] = g["sw_launches"]
            phase("perturb", f"{smi}: run_count of a Perturb-seq GEM well, "
                  "4,100 twenty-base guides and 17 antibodies, in a child "
                  "process beside vdj_parity..human_scale, held to the JAX "
                  "package's run, the planted truth and each guide read's "
                  "construction: " + json.dumps(g))
            chain = vdj_report()
        g = chain["vdj"]
        launches["vdj"] = g["sw_launches"]
        phase("vdj", f"{smi}: run_vdj of {g['cells']} T cells at "
              f"{g['pairs_per_cell']} read pairs a cell, the widened "
              "reference, non-cell barcodes and the 737,280-barcode "
              "whitelist, in a child process beside "
              "vdj_parity..human_scale, held to the fixture's truth: "
              + json.dumps(g))
        g = chain["vdj_b_held"]
        launches["vdj_b_held"] = g["sw_launches"]
        phase("vdj_b_held", f"{smi}: {g['cells']} B cells, a plasma cell "
              "past the 80,000-row cap, in the same child process after "
              "vdj: every output file the JAX package's and the fixture's "
              "truth: " + json.dumps(g))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase("timeline", json.dumps(TIMELINE))
    print(json.dumps({"kernels": [{
        "name": "banded_sw", "route": "cuda",
        "source": "cellranger_tpu_torch/csrc/sw.cu",
        "replaces": "cellranger_tpu/align/sw.py:131",
        "launches": launches["e2e"], "launches_by_path": launches,
        "max_abs_err": sw_report["max_abs_err"],
        "ms": sw_report["ms"], "ms_is": SW_MS_IS,
        "call_ms": sw_report["call_ms"], "plain_ms": sw_report["plain_ms"],
        "bound_ms": sw_report["bound_ms"],
        "bound_by": sw_report["bound_by"], "library_ms": None,
        "by_shape": sw_report["by_shape"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
