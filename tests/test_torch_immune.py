"""Port parity for 5' immune profiling through `multi`, tolerance 0.

One small well of `fixtures.build_immune_run` (chip_smoke.IMMUNE_HELD: 12
T cells with two two-alpha clones, 8 B cells with a two-light clone and
its dropout sibling, 30 GEX cells; one regions.fa holding the TR and the
IG genes) goes through the JAX package's `run_multi` and the port's
`run_multi(device="cpu")`:

  * equal summaries, equal count/ outputs (MEX, CSVs, the h5 files by
    the JAX package's own comparators) and vdj/ trees, and
    chip_smoke.immune_digest of both runs equal to IMMUNE_EXPECTED, which
    chip_smoke's `immune_held` holds the card's run to;
  * both runs held to the well's truth: GEX molecules and cells, each
    V(D)J library's cells, chains per cell (two alphas, two lights) and
    clonotypes, every planted dropout joined to its clone;
  * the fixture's clonotype truth against the JAX package's
    group_clonotypes on the planted annotations, the subset merge's
    "dominant superset" branch taken;
  * the port's Annotator against the JAX package's annotate_contig on
    every contig of both runs and on T and B contigs that carry a 16-mer
    of the other locus' segments, on the combined reference.
"""

import json
import os

import pytest
import torch

import chip_smoke
from cellranger_tpu.io.multi_config import run_multi as jax_run_multi
from cellranger_tpu.pipeline import vdj as jax_vdj
from cellranger_tpu.vdj import annotate as jann
from cellranger_tpu.vdj.reference import VdjReference as JaxReference
from cellranger_tpu_torch.io import multi_config as tmulti
from cellranger_tpu_torch.testing.fixtures import build_immune_run
from cellranger_tpu_torch.vdj import support
from cellranger_tpu_torch.vdj.reference import VdjReference
from chip_smoke import tree_diffs
from test_torch_hdf5 import h5_parity_diffs
from test_torch_multi import _same_count_outs, _strip


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def well(tmp_path_factory):
    """The small well through both packages' run_multi; the JAX run's
    annotate_contig calls recorded."""
    tmp = tmp_path_factory.mktemp("immune")
    fx = build_immune_run(str(tmp / "fx"), **chip_smoke.IMMUNE_HELD,
                          t_plan=chip_smoke.IMMUNE_HELD_T_PLAN,
                          b_plan=chip_smoke.IMMUNE_HELD_B_PLAN)
    anns = []
    real = jax_vdj.annotate_contig

    def annotate_contig(contig, ref):
        a = real(contig, ref)
        anns.append(a)
        return a

    t_out, j_out = str(tmp / "torch"), str(tmp / "jax")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        got = tmulti.run_multi(fx["csv"], t_out, fx["wl"],
                               batch_size=chip_smoke.IMMUNE_HELD_BATCH,
                               device="cpu")
    finally:
        torch.set_num_threads(n)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_vdj, "annotate_contig", annotate_contig)
    try:
        want = jax_run_multi(fx["csv"], j_out, fx["wl"],
                             batch_size=chip_smoke.IMMUNE_HELD_BATCH)
    finally:
        mp.undo()
    return dict(fx=fx, t_out=t_out, j_out=j_out, got=got, want=want,
                anns=anns)


def test_multi_matches_jax(well):
    t_out, j_out = well["t_out"], well["j_out"]
    assert _strip(well["got"]) == _strip(well["want"])
    assert sorted(well["got"]["vdj"]) == ["vdj_b", "vdj_t"]
    assert tree_diffs(os.path.join(t_out, "vdj"),
                      os.path.join(j_out, "vdj")) == []
    tc, jc = os.path.join(t_out, "count"), os.path.join(j_out, "count")
    _same_count_outs(tc, jc)
    for f in ("raw_feature_bc_matrix.h5", "filtered_feature_bc_matrix.h5"):
        assert not h5_parity_diffs(os.path.join(tc, f),
                                   os.path.join(jc, f)), f
    with open(os.path.join(t_out, "metrics_summary.json")) as a, \
            open(os.path.join(j_out, "metrics_summary.json")) as b:
        ta, tb = json.load(a), json.load(b)
    ta.pop("wall_time_s"), tb.pop("wall_time_s")
    assert ta == tb


def test_digest_is_the_held_one(well):
    """Both runs' immune_digest equal, and equal to IMMUNE_EXPECTED."""
    got = chip_smoke.immune_digest(well["t_out"])
    assert got == chip_smoke.immune_digest(well["j_out"])
    assert got == chip_smoke.IMMUNE_EXPECTED
    assert sum(k.startswith("vdj/vdj_t/") for k in got) \
        == sum(k.startswith("vdj/vdj_b/") for k in got) == 16


@pytest.mark.parametrize("run", ["torch", "jax"])
def test_run_holds_the_truth(well, run):
    fx = well["fx"]
    out = well["t_out" if run == "torch" else "j_out"]
    summary = well["got" if run == "torch" else "want"]
    assert chip_smoke.immune_truth_diffs(fx, out, summary) == []
    merges = chip_smoke.immune_merges(fx, out)
    # two-alpha clone of 5: its dropout and two beta-only cells; of 2: its
    # dropout; the two-light clone's dropout sibling
    assert merges["vdj_t"] == dict(planted=4, joined=4, clones=2,
                                   dominant=1)
    assert merges["vdj_b"] == dict(planted=1, joined=1, clones=1,
                                   dominant=0)
    assert len(fx["vdj_t"]["truth"]["two_alpha"]) == 3
    assert len(fx["vdj_b"]["truth"]["two_light"]) == 2
    assert summary["vdj"]["vdj_t"]["n_clonotypes"] == 6
    assert summary["vdj"]["vdj_b"]["n_clonotypes"] == 6


def test_planted_truth_is_jax_grouping(well, monkeypatch):
    """group_clonotypes of the JAX package on the planted annotations
    gives the fixture's partition; on the T cells the subset merge takes
    its dominant-superset branch (a set under two supersets whose cell
    counts differ) and every dropout cell's chain set is a strict subset
    of its clone's full one."""
    taken = []
    real_sorted = sorted

    def recording_sorted(it, *a, **kw):
        out = real_sorted(it, *a, **kw)
        if kw.get("reverse"):
            taken.append(out)
        return out

    monkeypatch.setattr(jann, "sorted", recording_sorted, raising=False)
    for lib in ("vdj_t", "vdj_b"):
        fx = well["fx"][lib]
        taken.clear()
        got = sorted(sorted(c["barcodes"]) for c in
                     jann.group_clonotypes(fx["anns"]))
        assert got == fx["truth"]["clonotypes"], lib
        dominant = [f for f in taken if len(f) >= 2 and f[0] > f[1]]
        assert len(dominant) == (1 if lib == "vdj_t" else 0), (lib, taken)
        for m in fx["truth"]["merged"]:
            full = {(a.chain, a.cdr3_nt) for b in m["clone"]
                    if b not in m["joined"] for a in fx["anns"][b]}
            for b in m["joined"]:
                assert {(a.chain, a.cdr3_nt) for a in fx["anns"][b]} < full


def _same_annotation(a, b) -> bool:
    def hit(h):
        return None if h is None else (
            h.segment.gene_name, h.segment.chain, h.score, h.contig_start,
            h.contig_end, h.seg_start, h.seg_end)
    return ((a.chain, hit(a.v), hit(a.j), hit(a.c), a.cdr3_nt, a.cdr3_aa,
             a.productive, a.full_length)
            == (b.chain, hit(b.v), hit(b.j), hit(b.c), b.cdr3_nt,
                b.cdr3_aa, b.productive, b.full_length))


def test_annotator_matches_jax_on_combined_reference(well):
    """Every contig the JAX run annotated, T and B, annotated alike by the
    port's Annotator on the combined regions.fa; and T and B transcripts
    with a 16-mer of a segment of the other locus spliced into their 5'
    UTR, so that a segment of the other locus is aligned too."""
    fa = os.path.join(well["fx"]["vdj_reference"], "fasta", "regions.fa")
    ann = support.Annotator(VdjReference.from_fasta(fa))
    chains = {a.chain for a in well["anns"]}
    assert {"TRA", "TRB", "IGH", "IGK", "IGL"} <= chains
    for a in well["anns"]:
        assert _same_annotation(ann.annotate(a.contig_seq), a)
    jref = JaxReference.from_fasta(fa)
    segs = {s.chain: s.seq.decode() for s in jref.by_region("V")}
    done = 0
    for lib, other in (("vdj_t", "IGH"), ("vdj_b", "TRB")):
        cells = well["fx"][lib]["anns"]
        for b in sorted(cells)[:2]:
            t = cells[b][0].contig_seq
            chimera = t[:5] + segs[other][100:116] + t[21:]
            vsegs, _, index = ann.regions["V"]
            assert other in {vsegs[i].chain for km in jann._kmers(chimera)
                             for i in index.get(km, ())}
            got = ann.annotate(chimera)
            want = jann.annotate_contig(chimera, jref)
            assert _same_annotation(got, want), (lib, b)
            assert got.chain == cells[b][0].chain
            done += 1
    assert done == 4


def test_antisense_r2_gives_no_cell(well, tmp_path):
    """Why the fixture writes R2 on the transcript's strand: `multi` runs
    a V(D)J library as SCVDJ-R2 and run_vdj takes R2 as it is (both
    packages; the chemistry's strandedness is not applied), so the T
    library with its R2 reverse-complemented assembles contigs that
    annotate as no productive chain: no cell."""
    from cellranger_tpu_torch.pipeline import vdj

    fx = well["fx"]
    d = fx["vdj_t"]["dir"]
    r1, r2 = (os.path.join(d, f"vdj_t_S1_L001_R{i}_001.fastq")
              for i in (1, 2))
    comp = str.maketrans("ACGTN", "TGCAN")
    with open(r2) as f:
        lines = f.read().splitlines()
    for i in range(1, len(lines), 4):
        lines[i] = lines[i].translate(comp)[::-1]
        lines[i + 2] = lines[i + 2][::-1]
    rc = str(tmp_path / "vdj_t_S1_L001_R2_001.fastq")
    with open(rc, "w") as f:
        f.write("\n".join(lines) + "\n")
    fa = os.path.join(fx["vdj_reference"], "fasta", "regions.fa")
    runs = {}
    for name, pair in (("sense", (r1, r2)), ("antisense", (r1, rc))):
        runs[name] = vdj.run_vdj(vdj.VdjConfig(
            fastq_pairs=[pair], vdj_reference_fasta=fa,
            whitelist_path=fx["wl"]), str(tmp_path / name), device="cpu")
    assert runs["sense"]["estimated_cells"] == 12
    assert runs["antisense"]["barcodes_with_contigs"] == 12
    assert runs["antisense"]["estimated_cells"] == 0
