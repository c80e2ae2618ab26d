"""Port parity for the secondary analysis that `run_count_gem_wells` and
`run_aggr` run over their merged matrix: the one place where these two
modules differ from the JAX package's (the keyword `device` handed to
`run_secondary_analysis`).

Two wells of 16 cells over six genes, two planted populations and no two
cells alike, go through both packages with the analysis on; the merged
matrices are equal byte for byte and the analysis/ directories are held
by `testing.analysis_check.compare_analysis` (labels and what derives
from them equal, PCA within its stated tolerance, embeddings by
neighbourhood preservation).  `run_aggr` takes a `batch` column, so its
analysis runs the batch correction too.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from cellranger_tpu.pipeline import aggr as jax_aggr
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu.pipeline.multi_gem import \
    run_count_gem_wells as jax_gem_wells
from cellranger_tpu_torch.io.reference import ReferencePackage
from cellranger_tpu_torch.pipeline import aggr as taggr
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.pipeline.multi_gem import run_count_gem_wells
from cellranger_tpu_torch.testing.analysis_check import (analysis_files,
                                                         compare_analysis)

ACGT = list("ACGT")
N_GENES = 6
CELLS_PER_WELL = 16


def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _same_mex(t_out, j_out, subs=("raw_feature_bc_matrix",
                                  "filtered_feature_bc_matrix")):
    for sub in subs:
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzip(os.path.join(t_out, sub, f)) \
                == _gunzip(os.path.join(j_out, sub, f)), (sub, f)


def _same_analysis(t_out, j_out):
    ja, ta = os.path.join(j_out, "analysis"), os.path.join(t_out, "analysis")
    assert len(analysis_files(ja)) == 16
    diffs, _ = compare_analysis(ja, ta)
    assert not diffs, diffs


@pytest.fixture(scope="module")
def wells(tmp_path_factory):
    t = tmp_path_factory.mktemp("wells_an")
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(ACGT, 4000 * N_GENES + 2000))
    with open(t / "g.fa", "w") as f:
        f.write(">chr1\n" + genome + "\n")
    with open(t / "g.gtf", "w") as f:
        for g in range(N_GENES):
            f.write(f'chr1\tt\texon\t{4000 * g + 1001}\t{4000 * g + 3000}'
                    f'\t.\t+\t.\tgene_id "G{g}"; transcript_id "T{g}"; '
                    f'gene_name "G{g}";\n')
    ReferencePackage.build(str(t / "g.fa"), str(t / "g.gtf"), str(t / "ref"),
                           device=None)
    wl = sorted({"".join(rng.choice(ACGT, 16)) for _ in range(80)})
    open(t / "wl.txt", "w").writelines(s + "\n" for s in wl)

    def make_well(name, bcs, depth):
        """Cell k of the well: population k % 2 (genes 0-2 or 3-5 high),
        gene g with depth * (high 6 / low 1) + (k * (g + 1)) % 5
        molecules."""
        r1p = str(t / f"{name}_S1_L001_R1_001.fastq.gz")
        r2p = str(t / f"{name}_S1_L001_R2_001.fastq.gz")
        i = 0
        with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
            for k, bc in enumerate(bcs):
                for g in range(N_GENES):
                    high = (g < 3) == (k % 2 == 0)
                    for _ in range(depth * (6 if high else 1)
                                   + (k * (g + 1)) % 5):
                        p = 4000 * g + int(rng.integers(1000, 3000 - 91))
                        umi = "".join(rng.choice(ACGT, 12))
                        f1.write(f"@r{i}\n{bc}{umi}\n+\n{'F' * 28}\n")
                        f2.write(f"@r{i}\n{genome[p:p + 91]}\n+\n"
                                 f"{'F' * 91}\n")
                        i += 1
        return r1p, r2p

    w1 = make_well("w1", wl[:CELLS_PER_WELL], 2)
    w2 = make_well("w2", wl[8:8 + CELLS_PER_WELL], 1)
    base = dict(reference_path=str(t / "ref"),
                whitelist_path=str(t / "wl.txt"), chemistry="SC3Pv3",
                read_len=91, batch_size=1024, checkpoint=False,
                force_cells=CELLS_PER_WELL)

    def cfgs(mod):
        return [mod.CountConfig(fastq_pairs=[w1], gem_group=1, **base),
                mod.CountConfig(fastq_pairs=[w2], gem_group=2, **base)]

    t_out, j_out = str(t / "torch"), str(t / "jax")
    torch.set_num_threads(2)
    got = run_count_gem_wells(cfgs(tcount), t_out, device="cpu")
    want = jax_gem_wells(cfgs(jax_count), j_out)
    return dict(t_out=t_out, j_out=j_out, got=got, want=want)


def test_gem_wells_analysis_matches_jax(wells):
    w = wells
    assert w["got"] == w["want"]
    assert w["got"]["estimated_cells"] == 2 * CELLS_PER_WELL
    _same_mex(w["t_out"], w["j_out"])
    _same_analysis(w["t_out"], w["j_out"])


def test_aggr_analysis_matches_jax(wells, tmp_path):
    torch.set_num_threads(2)

    def csv(path, out_dir):
        with open(path, "w") as f:
            f.write("sample_id,molecule_h5,batch\n")
            for i in (1, 2):
                mol = os.path.join(out_dir, "gem_wells", f"gw{i}",
                                   "molecule_info.h5")
                f.write(f"s{i},{mol},b{i}\n")
        return str(path)

    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = taggr.run_aggr(csv(tmp_path / "t.csv", wells["t_out"]), t_out,
                         device="cpu")
    want = jax_aggr.run_aggr(csv(tmp_path / "j.csv", wells["j_out"]), j_out)
    assert got == want
    assert got["total_cells"] == 2 * CELLS_PER_WELL
    assert min(got["normalization_rates"]) < 1.0
    _same_mex(t_out, j_out, subs=("filtered_feature_bc_matrix",))
    _same_analysis(t_out, j_out)
