"""The port runs without JAX, without the JAX package and without h5py: in
a subprocess whose import system refuses jax, jaxlib, cellranger_tpu and
h5py (the port reads and writes HDF5 through its own io/hdf5.py), import
cellranger_tpu_torch, its count pipeline and the modules of its BAM,
Feature Barcode, probe, demux, multi, secondary-analysis, mesh and
multi-host paths, its CLI and chip_smoke, then build the synthetic run and
count it on the CPU (secondary analysis on, as by default: the three h5
outputs written and read back to what was written) and on a mesh of two
CPU entries (with and without the kmer table sharded), run secondary
analysis on a planted-population matrix, and run chip_smoke's parity,
golden (the h5 files against the h5py-written snapshots), overflow,
the BAM writer against its plain version (bam_held),
h5_pipelines (aggr over two runs' molecule_info.h5, two GEM wells, CLI
reanalyze), analysis, paired-end (a tiny SC5P-PE count with BAM), probe
(a tiny MFRP-RNA count), multi, cellplex (a 240-cell well of 12 CMOs
and 17 antibodies), perturb (a 200-cell Perturb-seq well of 220
twenty-base guides and 17 antibodies), V(D)J (the tests' worlds, and
the kmer spectrum of a tiny run), mkfastq and index_build (the torch index build
against the numpy one) phases with the CPU as the device.
A second, static test walks the port's sources and chip_smoke.py and
refuses any import of jax, jaxlib, cellranger_tpu or h5py, lazy imports
inside functions included."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import os, sys

    BLOCKED = ("jax", "jaxlib", "cellranger_tpu", "h5py")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Refuse())

    import torch
    torch.set_num_threads(2)   # the suite's other workers share the cores

    import cellranger_tpu_torch
    import cellranger_tpu_torch.pipeline.count as count
    import cellranger_tpu_torch.pipeline.bam_out
    import cellranger_tpu_torch.io.bam_fast
    import cellranger_tpu_torch.native.bam_host
    import cellranger_tpu_torch.io.feature_ref
    import cellranger_tpu_torch.ops.features
    import cellranger_tpu_torch.parallel.molecule_state
    import cellranger_tpu_torch.cli
    import cellranger_tpu_torch.ops.probes
    import cellranger_tpu_torch.io.probe_set
    import cellranger_tpu_torch.io.probe_bc
    import cellranger_tpu_torch.io.bam_filter
    import cellranger_tpu_torch.io.hdf5
    import cellranger_tpu_torch.io.multi_config
    import cellranger_tpu_torch.analysis.jibes
    import cellranger_tpu_torch.pipeline.detect_chemistry
    import cellranger_tpu_torch.pipeline.preflight
    import cellranger_tpu_torch.pipeline.demux
    import cellranger_tpu_torch.pipeline.multi_gem
    import cellranger_tpu_torch.pipeline.aggr
    import cellranger_tpu_torch.analysis.batch_correction
    import cellranger_tpu_torch.analysis.run as analysis_run
    import cellranger_tpu_torch.stats
    import cellranger_tpu_torch.ops.lookup
    import cellranger_tpu_torch.vdj.reference
    import cellranger_tpu_torch.vdj.annotate
    import cellranger_tpu_torch.vdj.assembly
    import cellranger_tpu_torch.pipeline.vdj
    import cellranger_tpu_torch.io.bcl
    import cellranger_tpu_torch.pipeline.mkfastq
    import cellranger_tpu_torch.parallel.distributed
    import cellranger_tpu_torch.parallel.executor
    import cellranger_tpu_torch.parallel.shuffle
    import cellranger_tpu_torch.parallel.index_shard
    import cellranger_tpu_torch.testing.multichip
    import cellranger_tpu_torch.testing.multihost_worker
    from cellranger_tpu_torch.parallel.mesh import make_mesh
    import cellranger_tpu_torch.testing.analysis_check as check
    import chip_smoke
    from cellranger_tpu_torch.testing.fixtures import (build_analysis_matrix,
                                                       build_synthetic_run)

    tmp = sys.argv[1]
    fx = build_synthetic_run(os.path.join(tmp, "fx"), n_cells=12)
    cfg = count.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], batch_size=256)
    out = os.path.join(tmp, "out")
    with chip_smoke.h5_writes() as written:
        s = count.run_count(cfg, out, device="cpu")
    assert s["total_reads"] == fx["n_reads"], s["total_reads"]
    assert s["total_molecules"] == int(fx["truth"].sum())
    for f in count.H5_OUTPUTS:
        assert os.path.exists(os.path.join(out, f)), f
    assert sorted(chip_smoke.h5_read_back(written)) \
        == sorted(count.H5_OUTPUTS)
    assert os.path.exists(os.path.join(out, "filtered_feature_bc_matrix",
                                       "matrix.mtx.gz"))
    assert len(check.analysis_files(os.path.join(out, "analysis"))) == 16
    # the same run on a mesh of two CPU entries, and with the kmer table
    # sharded over it: the one-device run's metrics and MEX bytes
    for shard in (False, True):
        m_out = os.path.join(tmp, f"mesh_{shard}")
        sm = count.run_count(
            count.CountConfig(**dict(cfg.__dict__, secondary_analysis=False,
                                     shard_index=shard)),
            m_out, device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
        assert not chip_smoke._metric_diffs(sm, s), shard
        assert not chip_smoke._mex_diffs(m_out, out), shard
    mat, truth = build_analysis_matrix(150, 400, 3, seed=2)
    a_out = os.path.join(tmp, "analysis")
    r = analysis_run.run_secondary_analysis(mat, a_out, device="cpu")
    assert len(check.analysis_files(a_out)) == 16
    for k in ("tsne", "umap"):
        assert check.centroid_accuracy(r[k], truth) >= 0.9, k
    # chip_smoke's analysis phase, small and cpu against cpu
    ra = chip_smoke.analysis(os.path.join(tmp, "an"), n_cells=240,
                             n_genes=400, dev="cpu")
    assert ra["tsne_centroid_acc"] >= 0.9, ra
    rp = chip_smoke.analysis_parity(os.path.join(tmp, "an"), n_cells=160,
                                    n_genes=400, devices=("cpu", "cpu"))
    assert rp["short_horizon"]["tsne_10"] == 0.0, rp
    # chip_smoke's reanalyze phase past max_cells_tsne, small: the CLI on
    # an h5 it wrote, the float64 kNN checks, no K1 launch
    g = chip_smoke.analysis_68k(tmp, n_cells=300, n_genes=400, dev="cpu",
                                check_rows=100)
    assert g["sw_launches"] == 0 and g["knn_check"]["rows"] == 100, g
    # chip_smoke's cpu/cpu parity phase runs here too
    chip_smoke.tiny_parity(os.path.join(tmp, "smoke"), devices=("cpu", "cpu"))
    # the golden phases (the h5 files against the h5py-written snapshots),
    # the BAM record counter, the overflow phase and the h5 pipelines, on
    # the CPU
    for which in ("e2e", "e2e_rich"):
        g = chip_smoke.golden(os.path.join(tmp, "g"), which,
                              devices=("cpu",))
        assert g["h5_compared"] and g["sw_launches_cpu"] == 0, g
    from cellranger_tpu_torch.io.bam_read import read_bam
    bam = os.path.join(tmp, "g", "e2e_rich_cpu", "possorted_genome_bam.bam")
    assert chip_smoke.bam_records(bam) == len(read_bam(bam)[1])
    r = chip_smoke.overflow_run(fx, os.path.join(tmp, "ovf"), out,
                                device="cpu", batch_size=256, cap=512)
    assert r["flushes"] and r["total_molecules"] == s["total_molecules"]
    g = chip_smoke.h5_pipelines(fx, tmp, out, os.path.join(tmp, "ovf"),
                                device="cpu", batch_size=256)
    assert g["aggr_molecules"] == 2 * s["total_molecules"], g
    assert g["reanalyze_files"] == 16 and g["gem_wells_molecules"] > 0, g
    # the cut of a fixture to its first reads that the BAM phase runs on
    cut = chip_smoke.first_reads(fx, 500, os.path.join(tmp, "cut"))
    rc = chip_smoke.count_run(cut, os.path.join(tmp, "cut_out"),
                              device="cpu", batch_size=256)
    assert rc["reads"] == 500 and 0 < rc["total_molecules"] <= 500, rc
    # the BAM phase's held write: the native encoder and the threaded
    # BGZF writer against the plain writer, byte for byte
    g = chip_smoke.bam_held(fx, os.path.join(tmp, "held"), n_reads=500,
                            device="cpu", batch_size=256)
    assert g["records"] == 500, g
    # a tiny SC5P-PE count with BAM and a tiny MFRP-RNA count, each held to
    # its fixture's counts; then multi with sample demux, which reads the
    # count run's filtered h5 through io/hdf5.py
    g = chip_smoke.pe_parity(os.path.join(tmp, "pe"), None,
                             devices=("cpu", "cpu"), n_pairs=600,
                             batch_size=256, genome_len=200_000, n_genes=20,
                             n_cells=20, n_wl=500)
    assert g["expected"]["improper_pair_reads"] > 0, g
    assert g["bam_records"] == 2 * 600, g
    g = chip_smoke.rtl_parity(os.path.join(tmp, "rtl"),
                              devices=("cpu", "cpu"))
    assert g["expected"]["total_molecules"] > 0 and g["aligner_mapped"], g
    g = chip_smoke.multi_run(os.path.join(tmp, "multi"), device="cpu")
    assert g["samples"] == {"sampleA": 20, "sampleB": 20}, g
    # the cellplex phase's run and checks on a small well of 12 CMOs and
    # 17 antibodies with 2 planted aggregates
    from cellranger_tpu_torch.testing.fixtures import build_cellplex_run
    fx = build_cellplex_run(os.path.join(tmp, "cellplex"), n_cells=240,
                            gex_reads=80_000, cmo_reads=24_000, n_wl=2_000,
                            genome_len=400_000, n_genes=40, n_types=2,
                            n_antibodies=17, ab_reads=24_000,
                            n_aggregates=2)
    g = chip_smoke.cellplex_run(fx, os.path.join(tmp, "cellplex_out"), "cpu")
    assert g["outputs"]["truth"]["barcodes_off_planted_molecules"] == 0, g
    assert len(g["outputs"]["samples"]) == 12, g
    assert g["outputs"]["planted_aggregates_flagged"] == 2, g
    # the perturb phase's run and checks on a small Perturb-seq well: 220
    # twenty-base guides behind the unanchored prefix, 17 antibodies
    from cellranger_tpu_torch.testing.fixtures import build_perturb_run
    fx = build_perturb_run(os.path.join(tmp, "perturb"), n_cells=200,
                           n_target_genes=100, n_nontargeting=20,
                           gex_reads=40_000, guide_reads=16_000,
                           ab_reads=14_000, n_wl=2_000, genome_len=400_000,
                           n_genes=40, n_types=2)
    g = chip_smoke.perturb_run(fx, os.path.join(tmp, "perturb_out"), "cpu",
                               batch_size=4096)
    assert g["outputs"]["truth"]["barcodes_off_planted_molecules"] == 0, g
    assert g["outputs"]["em_guides"] and g["outputs"]["fallback_guides"], g
    assert g["reads"]["merged"]["got"] == g["reads"]["found"]["got"], g
    # V(D)J: the tests' worlds cpu against cpu, kmers in blocks; the kmer
    # spectrum of a tiny build_vdj_run; mkfastq on both BCL layouts
    g = chip_smoke.vdj_parity(os.path.join(tmp, "vdj"),
                              devices=("cpu", "cpu"))
    assert g["single"]["cells"] == 6 and g["single"]["blocks"] > 1, g
    g = chip_smoke.vdj_kmers(os.path.join(tmp, "vdjk"), n_cells=5,
                             pairs_per_cell=100, parity_reads=300,
                             devices=("cpu", "cpu"))
    assert g["bc_umi_pairs"] == 200 and g["reads"] == 1000, g
    # the batched per-barcode work (vdj/support.py, the native local
    # alignment) against the plain versions, and a tiny library run
    g = chip_smoke.vdj_fast_parity(os.path.join(tmp, "vdjf"), n_cells=5,
                                   pairs_per_cell=200, device="cpu")
    assert g["annotations_compared"] == 10, g
    g = chip_smoke.vdj_run(os.path.join(tmp, "vdjr"), 5, 200, "cpu")
    assert g["cells"] == 5 and g["background_barcodes"] == 100, g
    # a tiny B-cell library: isotypes, SHM, a plasma cell, a family with
    # a CDR3 subclone, held to its truth by vdj_b_truth_diffs
    g = chip_smoke.vdj_b_run(os.path.join(tmp, "vdjb"), 12, 100, "cpu",
                             plasma_pairs=2_000, families=(3,))
    assert g["plasma_cells"] == 1 and g["plasma_support_rows"] == [4000], g
    assert g["joined_across_cdr3_subclone"] == 1, g
    g = chip_smoke.mkfastq_run(os.path.join(tmp, "bcl"), n_clusters=400)
    assert g["samples"]["A"] == 180 and g["fastqs"] == 9, g
    # the index build on the device (here the cpu) against the numpy build
    g = chip_smoke.index_build(os.path.join(tmp, "ib"), device="cpu",
                               genome_len=400_000, n_genes=30,
                               e2e_len=300_000)
    assert g["e2e"]["sampling"] == "every", g
    assert g["n_runs"]["pos_mode"] == "parity" and g["sw_launches"] == 0, g
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NOJAX_OK")
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout


FORBIDDEN = ("cellranger_tpu", "jax", "jaxlib", "h5py")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "cellranger_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_source_imports_jax_or_the_jax_package():
    """No import of jax, jaxlib, cellranger_tpu or h5py anywhere in the
    port or chip_smoke.py."""
    files = _port_sources()
    assert len(files) > 60           # the walk found the package
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno}: {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
