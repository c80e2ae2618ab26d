"""`run_secondary_analysis` of the port against the JAX package's on the
CPU, end to end: the same filtered matrix in, the analysis/ directories
held against each other by `testing.analysis_check.compare_analysis`
(k-means and graph-clustering labels, hierarchy.json and
differential_expression.csv equal byte for byte; PCA within 1e-3 of max
|proj| after sign alignment, variances within rtol 1e-4; full t-SNE and
UMAP runs by quality: nearest-centroid accuracy against the planted
populations at least 0.9 in both packages, and the port's 10-NN
preservation at least the JAX package's - 0.05).  Also the batch
correction path and the port's `reanalyze` command."""

import os

import numpy as np
import pytest
import torch

from cellranger_tpu.analysis import run as jrun
from cellranger_tpu.io import matrix_io as jmio
from cellranger_tpu_torch.analysis import run as trun
from cellranger_tpu_torch.testing.analysis_check import (analysis_files,
                                                         compare_analysis)
from cellranger_tpu_torch.testing.fixtures import build_analysis_matrix

STAGES = {"preprocess", "pca", "write_csv", "kmeans", "graphclust",
          "hclust", "diffexp", "tsne", "umap"}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on one machine's cores;
    torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_matrix(mat):
    """The JAX package's CountMatrix over the same arrays as the port's."""
    feats = jmio.FeatureReference([
        jmio.FeatureDef(f.id, f.name, f.feature_type, f.genome, dict(f.tags))
        for f in mat.features.feature_defs])
    return jmio.CountMatrix(mat.m.copy(), list(mat.barcodes), feats)


@pytest.mark.parametrize("n_cells,n_pops", [(200, 2), (1000, 5)])
def test_run_secondary_analysis_matches_jax(tmp_path, n_cells, n_pops):
    mat, truth = build_analysis_matrix(n_cells, 1000, n_pops, seed=0)
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = jrun.run_secondary_analysis(_jax_matrix(mat), j_out)
    tr = trun.run_secondary_analysis(mat, t_out, device="cpu")
    assert len(analysis_files(j_out)) == 16
    diffs, seen = compare_analysis(j_out, t_out, truth)
    assert not diffs, diffs
    assert min(seen["tsne_centroid_acc"] + seen["umap_centroid_acc"]) >= 0.9
    assert set(tr["stage_s"]) == STAGES
    for k in ("tsne", "umap"):
        assert tr[k].shape == jr[k].shape == (n_cells, 2)
        assert tr[k].dtype == np.float64
    np.testing.assert_array_equal(tr["clusterings"]["graphclust"],
                                  jr["clusterings"]["graphclust"])
    assert tr["hclust"] == jr["hclust"]


def test_batch_corrected_analysis_matches_jax(tmp_path):
    mat, _ = build_analysis_matrix(200, 1000, 2, seed=0)
    batches = np.random.default_rng(5).integers(0, 2, 200)
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr = jrun.run_secondary_analysis(_jax_matrix(mat), j_out,
                                     skip_embeddings=True,
                                     batch_labels=batches)
    tr = trun.run_secondary_analysis(mat, t_out, skip_embeddings=True,
                                     batch_labels=batches, device="cpu")
    assert jr["batch_corrected"] and tr["batch_corrected"]
    assert len(analysis_files(t_out)) == 14
    diffs, _ = compare_analysis(j_out, t_out)
    assert not diffs, diffs


def test_too_few_cells_write_nothing(tmp_path):
    mat, _ = build_analysis_matrix(200, 1000, 2, seed=0)
    one = mat.select_barcodes([0])
    assert trun.run_secondary_analysis(one, str(tmp_path / "a"),
                                       device="cpu") == {}
    assert analysis_files(str(tmp_path / "a")) == []


def test_cli_reanalyze(tmp_path, capsys):
    """`python -m cellranger_tpu_torch reanalyze` on a filtered matrix .h5
    writes what run_secondary_analysis writes."""
    from cellranger_tpu_torch import cli

    mat, _ = build_analysis_matrix(200, 1000, 2, seed=1)
    h5 = str(tmp_path / "filtered_feature_bc_matrix.h5")
    mat.save_h5(h5)
    cli.main(["reanalyze", "--id", "R", "--matrix", h5, "--device", "cpu",
              "--output-dir", str(tmp_path)])
    got = str(tmp_path / "R" / "outs" / "analysis")
    assert "outputs:" in capsys.readouterr().out
    want = str(tmp_path / "direct")
    trun.run_secondary_analysis(mat, want, device="cpu")
    assert analysis_files(got) == analysis_files(want)
    for f in analysis_files(want):
        with open(os.path.join(got, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
