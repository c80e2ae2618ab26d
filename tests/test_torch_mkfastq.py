"""Port parity for mkfastq, tolerance 0: `run_mkfastq` and the CLI
`mkfastq` of the JAX package and of cellranger_tpu_torch on one lane in
the classic and in the CBCL BCL layout (`testing/fixtures.py`
`build_bcl_run`): equal summaries and equal decompressed FASTQ bytes,
reads per sample as built, both layouts alike.  The fixture's classic
writer is held against the generator of tests/test_mkfastq.py.
"""

import os

import numpy as np
import pytest

from cellranger_tpu.cli import main as jax_main
from cellranger_tpu.pipeline.mkfastq import run_mkfastq as jax_run_mkfastq
from cellranger_tpu_torch.cli import main
from cellranger_tpu_torch.io.bcl import parse_run_info, read_tile
from cellranger_tpu_torch.pipeline.mkfastq import run_mkfastq
from cellranger_tpu_torch.testing import fixtures
from chip_smoke import file_tree


def _fastqs(root):
    """{relative path: decompressed bytes} of every FASTQ under root."""
    return file_tree(root, gunzip=True)


@pytest.fixture(scope="module")
def bcl(tmp_path_factory):
    return fixtures.build_bcl_run(str(tmp_path_factory.mktemp("bcl")), 600)


@pytest.mark.parametrize("layout", ["classic", "cbcl"])
def test_run_mkfastq_matches_jax(bcl, layout, tmp_path):
    kw = dict(index_kit_csv=bcl["index_kit"])
    got = run_mkfastq(bcl[layout], bcl["samplesheet"], str(tmp_path / "t"),
                      **kw)
    want = jax_run_mkfastq(bcl[layout], bcl["samplesheet"],
                           str(tmp_path / "j"), **kw)
    assert got == want and got["samples"] == bcl["truth"]
    t, j = _fastqs(str(tmp_path / "t")), _fastqs(str(tmp_path / "j"))
    assert t == j and len(t) == 9
    assert t["A/A_S1_L001_I1_001.fastq.gz"].count(b"\n") \
        == 4 * bcl["truth"]["A"]


def test_classic_and_cbcl_layouts_agree(bcl, tmp_path):
    for layout in ("classic", "cbcl"):
        run_mkfastq(bcl[layout], bcl["samplesheet"],
                    str(tmp_path / layout), index_kit_csv=bcl["index_kit"])
    assert _fastqs(str(tmp_path / "classic")) \
        == _fastqs(str(tmp_path / "cbcl"))


def test_cli_mkfastq_matches_jax(bcl, tmp_path, capsys):
    args = ["mkfastq", "--run", bcl["cbcl"], "--samplesheet",
            bcl["samplesheet"], "--index-kit", bcl["index_kit"]]
    main(args + ["--out", str(tmp_path / "t")])
    t_say = capsys.readouterr().out
    jax_main(args + ["--out", str(tmp_path / "j")])
    assert t_say == capsys.readouterr().out
    assert f'"B": {bcl["truth"]["B"]}' in t_say
    assert _fastqs(str(tmp_path / "t")) == _fastqs(str(tmp_path / "j"))


def test_classic_writer_matches_the_tests_generator(tmp_path):
    """The same clusters through tests/test_mkfastq.py's make_run and the
    fixture's classic writer (at that generator's q35) decode alike."""
    from test_mkfastq import make_run

    rng = np.random.default_rng(8)
    reads_by_tile = {
        tile: [tuple("".join(rng.choice(list("ACGTN"), n)) for n in
                     (fixtures.BCL_R1, fixtures.BCL_I1, fixtures.BCL_R2))
               + (i % 3 != 0,) for i in range(7)]
        for tile in (1101, 1102)}
    theirs = make_run(tmp_path, reads_by_tile)
    code = {c: i for i, c in enumerate("ACGTN")}
    tiles = {t: (np.array([[code[c] for c in "".join(r[:3])] for r in rr],
                          np.uint8), np.array([r[3] for r in rr]))
             for t, rr in reads_by_tile.items()}
    ours = fixtures.write_classic_bcl_run(str(tmp_path / "ours"), tiles,
                                          quals=35)
    info = parse_run_info(ours)
    assert info == parse_run_info(theirs)
    for tile in tiles:
        a, b = read_tile(ours, info, 1, tile), read_tile(theirs, info, 1,
                                                         tile)
        assert a[1] == b[1] and a[0].keys() == b[0].keys()
        for seg in a[0]:
            for x, y in zip(a[0][seg], b[0][seg]):
                np.testing.assert_array_equal(x, y)
