"""Port parity for multi-host count: P processes of
cellranger_tpu_torch.testing.multihost_worker joined by torch.distributed
(gloo, CPU, a free local port per run) over a shared output directory,
against the JAX package's single-host run of the same inputs.  By
tests/test_multihost.py the JAX package's own multi-host run equals that
run, so these hold the port's multi-host outputs to the JAX package's:

  * 2 processes, BAM on, 1,600 reads in 4 lanes: metrics, MEX and h5
    matrices, molecule_info, the BAM's record set (tests/test_multihost.py
    key), position order, and every read's xf flag; host 1 reports only
    its own lanes' reads;
  * 3 processes over skewed lanes (700, 300, 200, 200 reads);
  * both processes killed after pass 2 (CRTPU_TEST_DIE_AFTER_PASS2), the
    FASTQs overwritten with the same size and mtime, then a rerun that
    resumes from the spill and the partials alone.

Every process is killed when its run overruns `launch`'s timeout, so a
hang fails one test.
"""

import json
import os

from cellranger_tpu.io.bam_read import read_bam
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.testing import correctness as cc
from cellranger_tpu_torch.testing.fixtures import build_lane_run
from cellranger_tpu_torch.testing.multihost_worker import launch

TIMEOUT_S = 240
# each process keeps to two threads: the suite's workers share the cores
ENV = dict(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")


def _cfg(fx, **kw):
    return dict(dict(fastq_pairs=fx["pairs"], reference_path=fx["ref"],
                     whitelist_path=fx["wl"], chemistry="SC3Pv3",
                     read_len=91, batch_size=512, secondary_analysis=False,
                     checkpoint=False), **kw)


def _jax_run(cfg: dict, out: str) -> dict:
    return jax_count.run_count(jax_count.CountConfig(**dict(
        cfg, fastq_pairs=[tuple(p) for p in cfg["fastq_pairs"]])), out)


def _hosts_ok(res) -> dict:
    for pid, r in enumerate(res):
        assert r["rc"] == 0 and r["out"] is not None, (pid, r["err"])
    return {r["out"]["pid"]: r["out"]["total_reads"] for r in res}


def _same_counts(out: str, ref: str) -> None:
    m = "metrics_summary.json"
    assert not cc.check_metrics(os.path.join(out, m), os.path.join(ref, m))
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert not cc.check_mtx(os.path.join(out, sub, f),
                                    os.path.join(ref, sub, f)), (sub, f)
        assert not cc.check_h5(os.path.join(out, sub + ".h5"),
                               os.path.join(ref, sub + ".h5")), sub
    assert not cc.check_molecule_info(os.path.join(out, "molecule_info.h5"),
                                      os.path.join(ref, "molecule_info.h5"))


def test_multihost_2proc_bam_matches_jax(tmp_path):
    fx = build_lane_run(str(tmp_path / "fx"))
    cfg = _cfg(fx, write_bam=True)
    ref = str(tmp_path / "jax_single")
    s1 = _jax_run(cfg, ref)
    out = str(tmp_path / "port_2proc")
    by_pid = _hosts_ok(launch(cfg, out, 2, "cpu", TIMEOUT_S, ENV))
    # host 1 streamed 2 of the 4 lanes; host 0 reports the merged run
    assert by_pid == {0: 1600, 1: 800}
    assert s1["total_reads"] == 1600
    _same_counts(out, ref)

    bam = "possorted_genome_bam.bam"
    assert os.path.exists(os.path.join(out, bam + ".bai"))
    assert not cc.check_bam(os.path.join(out, bam), os.path.join(ref, bam))
    _, b1, _ = read_bam(os.path.join(ref, bam))
    _, b2, _ = read_bam(os.path.join(out, bam))
    assert len(b1) == len(b2) == 1600
    key = lambda r: (r["ref_id"], r["pos"], r["name"])  # noqa: E731
    assert sorted(map(key, b1)) == sorted(map(key, b2))
    mapped = [(r["ref_id"], r["pos"]) for r in b2 if not r["flag"] & 4]
    assert mapped == sorted(mapped)
    assert ({r["name"]: r["tags"]["xf"] for r in b1}
            == {r["name"]: r["tags"]["xf"] for r in b2})


def test_multihost_3proc_skewed_shards_matches_jax(tmp_path):
    """Round-robin lanes give host 0 lanes 0 and 3 (700 + 200 reads),
    hosts 1 and 2 one lane each (300, 200)."""
    fx = build_lane_run(str(tmp_path / "fx"),
                        reads_per_lane=[700, 300, 200, 200])
    cfg = _cfg(fx)
    ref = str(tmp_path / "jax_single")
    s1 = _jax_run(cfg, ref)
    out = str(tmp_path / "port_3proc")
    by_pid = _hosts_ok(launch(cfg, out, 3, "cpu", TIMEOUT_S, ENV))
    assert by_pid == {0: 1400, 1: 300, 2: 200}
    assert s1["total_reads"] == 1400
    _same_counts(out, ref)


def test_multihost_resume_after_pass2_kill_matches_jax(tmp_path):
    fx = build_lane_run(str(tmp_path / "fx"), n_lanes=2)
    cfg = _cfg(fx, checkpoint=True)
    ref = str(tmp_path / "jax_single")
    s1 = _jax_run(dict(cfg, checkpoint=False), ref)
    out = str(tmp_path / "port_2proc")

    # run 1: every host dies once its pass-2 state is durable
    for r in launch(cfg, out, 2, "cpu", TIMEOUT_S,
                    dict(ENV, CRTPU_TEST_DIE_AFTER_PASS2="1")):
        assert r["rc"] == 42, (r["rc"], r["err"])
    for pid in (0, 1):
        with open(os.path.join(out, "_spill", f"host{pid}.json")) as f:
            assert json.load(f)["fingerprint"]

    # overwrite the FASTQs in place with the same size and mtime: the
    # fingerprint still matches, and reading them again would fail
    for pair in fx["pairs"]:
        for path in pair:
            st = os.stat(path)
            with open(path, "r+b") as f:
                f.write(b"\xff" * st.st_size)
            os.utime(path, (st.st_atime, st.st_mtime))

    # run 2 resumes from the spill files and the partials
    by_pid = _hosts_ok(launch(cfg, out, 2, "cpu", TIMEOUT_S, ENV))
    assert by_pid == {0: 800, 1: 0}
    assert s1["total_reads"] == 800
    _same_counts(out, ref)
    with open(os.path.join(out, "metrics_summary.json")) as f:
        assert json.load(f)["total_molecules"] == s1["total_molecules"] > 0
