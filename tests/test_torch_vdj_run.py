"""Port parity for the V(D)J pipeline, tolerance 0: `run_vdj` of the JAX
package and of cellranger_tpu_torch (on the CPU) on the single-end and
the paired-end worlds of tests/test_vdj.py (`testing/fixtures.py` builds
them draw for draw), every output file equal byte for byte; the CLI `vdj`
and `mkvdjref` of both packages, outputs and what they print.
"""

import os

import pytest
import torch

from cellranger_tpu.cli import main as jax_main
from cellranger_tpu.pipeline.vdj import VdjConfig as JVdjConfig
from cellranger_tpu.pipeline.vdj import run_vdj as jax_run_vdj
from cellranger_tpu_torch.cli import main
from cellranger_tpu_torch.pipeline.vdj import VdjConfig, run_vdj
from cellranger_tpu_torch.testing.fixtures import (build_vdj_paired_world,
                                                   build_vdj_single_world)
from chip_smoke import file_tree, tree_diffs


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_tree(a, b):
    assert tree_diffs(a, b) == []
    return file_tree(a)


@pytest.mark.parametrize("world", ["single", "paired"])
def test_run_vdj_matches_jax(world, tmp_path):
    build = dict(single=build_vdj_single_world,
                 paired=build_vdj_paired_world)[world]
    w = build(str(tmp_path / "in"))
    kw = dict(fastq_pairs=[(w["fq1"], w["fq2"])],
              vdj_reference_fasta=w["fa"], whitelist_path=w["wl"],
              chemistry=w["chemistry"], read_len=w["read_len"],
              batch_size=w["batch_size"])
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = run_vdj(VdjConfig(**kw), t_out, device="cpu")
    want = jax_run_vdj(JVdjConfig(**kw), j_out)
    assert got == want
    files = _same_tree(t_out, j_out)
    assert len(files) >= 15
    assert got["total_reads"] == w["n_reads"]
    if world == "single":
        assert got["estimated_cells"] == 6 and got["n_clonotypes"] == 2
        assert w["cdr3_a"].encode() in files["clonotypes.csv"]
    else:
        # the longest contig needs both mates
        lens = [int(r.split(b",")[3]) for r in
                files["all_contig_annotations.csv"].splitlines()[1:]]
        assert max(lens) >= 200


def test_run_vdj_needs_a_device(tmp_path):
    with pytest.raises(TypeError, match="device"):
        run_vdj(VdjConfig(fastq_pairs=[], vdj_reference_fasta="x",
                          whitelist_path="y"), str(tmp_path))


def test_cli_vdj_and_mkvdjref_match_jax(tmp_path, capsys):
    w = build_vdj_single_world(str(tmp_path / "in"))
    fq_dir = os.path.dirname(w["fq1"])
    args = ["vdj", "--id", "V", "--fastqs", fq_dir, "--reference", w["fa"],
            "--whitelist", w["wl"]]
    main(args + ["--device", "cpu", "--output-dir", str(tmp_path / "t")])
    t_say = capsys.readouterr().out
    jax_main(args + ["--output-dir", str(tmp_path / "j")])
    j_say = capsys.readouterr().out
    assert t_say.replace(str(tmp_path / "t"), "") \
        == j_say.replace(str(tmp_path / "j"), "")
    assert '"estimated_cells": 6' in t_say
    _same_tree(str(tmp_path / "t" / "V" / "outs"),
               str(tmp_path / "j" / "V" / "outs"))
    for name, fn in (("t", main), ("j", jax_main)):
        fn(["mkvdjref", "--genome", "synth_trb", "--seqs", w["fa"],
            "--out", str(tmp_path / f"ref_{name}")])
    t_say, j_say = capsys.readouterr().out.split("}\n", 1)
    _same_tree(str(tmp_path / "ref_t"), str(tmp_path / "ref_j"))
    assert '"V": 2' in j_say and t_say + "}\n" == j_say
    with pytest.raises(SystemExit):
        main(["vdj", "--help"])
    assert "--device" in capsys.readouterr().out
