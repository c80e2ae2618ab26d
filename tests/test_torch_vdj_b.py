"""Port parity for V(D)J of B cells, tolerance 0: `run_vdj` of the JAX
package and of cellranger_tpu_torch (on the CPU) on a small B-cell world
(`fixtures.build_vdj_b_run`: IGH with IGK or IGL at IMGT's gene counts,
isotypes, somatic hypermutation, a plasma cell at 20 times a cell's
molecules), every output file equal while the plasma cell runs past a
per-barcode read cap lowered through a parameters file.

The world plants one case of each branch of the clonotype grouping
(vdj/annotate.py `_cluster_cdr3s`, `_variant_clusters`), each held in
the JAX package's run:

- clone 0, a plasma and a memory cell whose heavy CDR3s are one
  nucleotide apart, joined by their shared V mutations;
- clone 1, a memory cell whose light chain is clone 0's with one
  nucleotide off and disjoint mutations: the join refused;
- clone 2, clone 1's chains in a cell whose V mutations conflict with
  clone 1's at every position: split apart;
- clone 3, two naive cells a heavy CDR3 nucleotide apart, no mutation:
  the frequency gate joins the minor variant;
- clone 4, two naive cells whose light CDR3 is clone 3's one nucleotide
  off: two cells against two, the gate refuses the co-dominant join.

Each contig's annotation by the port's Annotator (native local alignment
over the segments sharing a 16-mer) equals the JAX run's annotate_contig,
SegmentHit coordinates and somatic variants included; the port's batched
primer trim equals trim_primer_read on reads carrying each of the seven
human BCR inner primers.
"""

import numpy as np
import pytest
import torch

from cellranger_tpu import params as jax_params
from cellranger_tpu.pipeline import vdj as jax_vdj
from cellranger_tpu.vdj import annotate as jann
from cellranger_tpu.vdj import assembly as jasm
from cellranger_tpu_torch import params
from cellranger_tpu_torch.pipeline import vdj
from cellranger_tpu_torch.testing.fixtures import build_vdj_b_run
from cellranger_tpu_torch.vdj import support
from cellranger_tpu_torch.vdj.reference import Segment, VdjReference
from chip_smoke import tree_diffs, vdj_b_truth_diffs, vdj_barcode_clock

CELLS = 8
PAIRS = 80                  # a plasma cell 20 times as many: 3,200 rows
CAP = 500                   # rows a barcode, lowered from 80,000
BATCH = 1024
BRANCH_PLAN = [
    dict(kinds=["plasma", "memory"], sub=1),
    dict(kinds=["memory"], near=(0, "light")),
    dict(kinds=["memory"], same=1),
    dict(kinds=["naive", "naive"], sub=1, private=0),
    dict(kinds=["naive", "naive"], private=0, near=(3, "light")),
]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg_kw(fx):
    return dict(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                vdj_reference_fasta=fx["fa"], whitelist_path=fx["wl"],
                chemistry=fx["chemistry"], read_len=fx["read_len"],
                batch_size=BATCH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_vdj on the branch world under the lowered cap;
    recorded: each barcode's rows in the port (packed UMIs), the JAX
    run's read lists, annotations, shared-mutation joins and variant
    splits."""
    tmp = tmp_path_factory.mktemp("vdj_b")
    fx = build_vdj_b_run(str(tmp / "fx"), CELLS, PAIRS, n_wl=20_000,
                         background=40, plan=BRANCH_PLAN)
    rec = dict(reads={}, anns=[], joins=[], splits=[])
    real = dict(umi_support=jax_vdj.umi_support,
                annotate_contig=jax_vdj.annotate_contig,
                join=jann.shared_mutation_join_log10p,
                split=jann._variant_clusters)

    def umi_support(contig, reads, *a):
        rec["reads"][id(reads)] = reads
        return real["umi_support"](contig, reads, *a)

    def annotate_contig(contig, ref):
        a = real["annotate_contig"](contig, ref)
        rec["anns"].append(a)
        return a

    def join(ev_a, ev_b, cdr3_mm, *a):
        p = real["join"](ev_a, ev_b, cdr3_mm, *a)
        rec["joins"].append((len(ev_a), len(ev_b), cdr3_mm, p))
        return p

    def split(key, bcs, cell_vars):
        out = real["split"](key, bcs, cell_vars)
        rec["splits"].append(out)
        return out

    p = tmp / "parameters.toml"
    p.write_text(f"vdj_max_reads_per_barcode = {CAP}\n")
    mp = pytest.MonkeyPatch()
    mp.setenv(params.ENV_VAR, str(p))
    params.load(refresh=True)
    jax_params.load(refresh=True)
    mp.setattr(jax_vdj, "umi_support", umi_support)
    mp.setattr(jax_vdj, "annotate_contig", annotate_contig)
    mp.setattr(jann, "shared_mutation_join_log10p", join)
    mp.setattr(jann, "_variant_clusters", split)
    try:
        with vdj_barcode_clock() as clock:
            got = vdj.run_vdj(vdj.VdjConfig(**_cfg_kw(fx)),
                              str(tmp / "torch"), device="cpu")
        rec["rows"] = clock["rows"]
        want = jax_vdj.run_vdj(jax_vdj.VdjConfig(**_cfg_kw(fx)),
                               str(tmp / "jax"))
    finally:
        mp.undo()
        params.load(refresh=True)
        jax_params.load(refresh=True)
    return dict(fx=fx, got=got, want=want, rec=rec, t_out=str(tmp / "torch"),
                j_out=str(tmp / "jax"))


def test_run_vdj_of_b_cells_matches_jax(runs):
    """Every output file equal; the plasma barcode, 3,200 rows, assembled
    and supported from its first CAP in the original's order."""
    assert runs["got"] == runs["want"]
    assert tree_diffs(runs["t_out"], runs["j_out"]) == []
    fx, rec = runs["fx"], runs["rec"]
    (bc, plasma), = fx["truth"]["plasma"].items()
    assert plasma["rows"] == 2 * 20 * PAIRS > CAP
    assert vdj_b_truth_diffs(fx, runs["t_out"], runs["got"],
                             fx["expected"]["bc_umi_pairs"],
                             rows=rec["rows"], batch_size=BATCH,
                             cap=CAP) == []
    capped = [r for r in rec["reads"].values() if len(r) == CAP]
    assert len(capped) == 1 and max(map(len, rec["reads"].values())) == CAP


def test_jax_run_meets_the_truth(runs):
    fx = runs["fx"]
    assert vdj_b_truth_diffs(fx, runs["j_out"], runs["want"],
                             fx["expected"]["bc_umi_pairs"]) == []
    t = fx["truth"]
    assert sorted(t["kinds"].values()).count("naive") == 4
    assert len(t["clonotypes"]) == 5 == runs["want"]["n_clonotypes"]
    assert len(t["subclones"]) == 2


def _hit_fields(h, contig):
    if h is None:
        return None
    return (h.segment.gene_name, h.segment.chain, h.score, h.contig_start,
            h.contig_end, h.seg_start, h.seg_end, h.variants(contig))


def _ann_fields(a):
    return (a.contig_seq, a.chain, _hit_fields(a.v, a.contig_seq),
            _hit_fields(a.j, a.contig_seq), _hit_fields(a.c, a.contig_seq),
            a.cdr3_nt, a.cdr3_aa, a.productive, a.full_length)


def test_annotator_matches_annotate_contig_on_every_contig(runs):
    """Every contig the JAX run annotated: the port's Annotator gives the
    same fields, hit coordinates and V variants; the mutated cells'
    variants are non-empty."""
    ann = support.Annotator(VdjReference.from_fasta(runs["fx"]["fa"]))
    jax_anns = runs["rec"]["anns"]
    assert len(jax_anns) == 2 * CELLS
    mutated = 0
    for a in jax_anns:
        assert _ann_fields(ann.annotate(a.contig_seq)) == _ann_fields(a)
        v = a.v.variants(a.contig_seq)
        assert v is not None
        mutated += bool(v)
    assert mutated == 2 * 4          # the plasma and the memory cells
    planted = {c for v in runs["fx"]["truth"]["c_genes"].values()
               for _, c in v}
    assert {a.c.segment.gene_name for a in jax_anns} == planted


@pytest.mark.parametrize("primer", jasm.INNER_PRIMERS[("human", "bcr")],
                         ids=lambda p: p.decode())
def test_bcr_primer_trim_matches_jax(primer):
    """Reads carrying the primer's reverse complement at the start, one
    base in, in the middle, at the end, cut short, twice, with an N in
    it, and beside another primer: the port's trim start is the
    original's for every read."""
    rc = jasm._revcomp_b(primer).decode()
    other = jasm._revcomp_b(jasm.INNER_PRIMERS[("human", "tcr")][0]).decode()
    rng = np.random.default_rng(len(primer))
    W = 120
    rand = lambda n: "".join(rng.choice(list("ACGT"), n))
    reads = [rc + rand(W - len(rc)), "A" + rc + rand(W - len(rc) - 1),
             rand(50) + rc + rand(W - 50 - len(rc)), rand(W - len(rc)) + rc,
             rand(W - len(rc) + 3) + rc[:-3],
             rand(10) + rc + rand(20) + rc + rand(W - 30 - 2 * len(rc)),
             rand(30) + rc[:5] + "N" + rc[6:] + rand(W - 30 - len(rc)),
             rand(40) + other + rand(5) + rc
             + rand(W - 45 - len(other) - len(rc)),
             rand(60) + rc + rand(7) + other
             + rand(W - 67 - len(other) - len(rc))]
    codes = np.zeros((len(reads), W), np.uint8)
    valid = np.zeros((len(reads), W), bool)
    for i, r in enumerate(reads):
        b = np.frombuffer(r.encode(), np.uint8)
        codes[i] = support._ACGT[b] & 3
        valid[i] = support._ACGT[b] < 4
    primers = [jasm._revcomp_b(p) for p in jasm.all_inner_primers()]
    got = support.primer_trim_starts(codes, valid, np.full(len(reads), W),
                                     primers, "cpu")
    want = [jasm.trim_primer_read(r, primers) for r in reads]
    assert got.tolist() == want
    assert sum(w > 0 for w in want) >= 6


@pytest.mark.parametrize("branch", ["shared_mutation_join",
                                    "shared_mutation_refusal",
                                    "frequency_gate_join",
                                    "frequency_gate_refusal",
                                    "variant_split"])
def test_clonotype_branch_held_in_the_jax_run(runs, branch):
    """Each planted branch of the grouping, seen in the JAX run: the two
    shared-mutation decisions (one join, one refusal, each at one CDR3
    mismatch), no other (the naive clones go through the frequency
    gate), one variant split into two single cells; and the clonotypes
    the truth's partition."""
    rec, t = runs["rec"], runs["fx"]["truth"]
    joins = rec["joins"]
    assert len(joins) == 2 and all(j[2] == 1 for j in joins)
    assert all(min(j[0], j[1]) >= jann.JOIN_MIN_MUTATIONS for j in joins)
    cells = {b for cl in t["clonotypes"] for b in cl}
    naive = sorted(b for b in cells if t["kinds"][b] == "naive")
    heavy = {b: dict(runs["fx"]["expected"]["cdr3s"][b])["IGH"]
             for b in cells}
    light = {b: [c for ch, c in runs["fx"]["expected"]["cdr3s"][b]
                 if ch != "IGH"][0] for b in cells}
    if branch == "shared_mutation_join":
        assert min(j[3] for j in joins) <= jann.JOIN_LOG10_P_MAX
        (a, b), = [cl for cl in t["subclones"]
                   if "plasma" in {t["kinds"][x] for x in cl}]
        assert heavy[a] != heavy[b]
    elif branch == "shared_mutation_refusal":
        assert max(j[3] for j in joins) > jann.JOIN_LOG10_P_MAX
        far = [cl for cl in t["clonotypes"] if len(cl) == 1]
        assert len(far) == 2
    elif branch == "frequency_gate_join":
        (a, b), = [cl for cl in t["subclones"]
                   if {t["kinds"][x] for x in cl} == {"naive"}]
        assert heavy[a] != heavy[b] and light[a] == light[b]
    elif branch == "frequency_gate_refusal":
        groups = [cl for cl in t["clonotypes"] if set(cl) <= set(naive)]
        assert len(groups) == 2
        one, two = ({light[b] for b in g} for g in groups)
        assert len(one) == len(two) == 1
        assert sum(x != y for x, y in zip(*one, *two)) == 1
    else:
        split = [s for s in rec["splits"] if len(s) > 1]
        assert len(split) == 1 and [len(c) for c in split[0]] == [1, 1]
    got = vdj_b_truth_diffs(runs["fx"], runs["j_out"], runs["want"],
                            runs["fx"]["expected"]["bc_umi_pairs"])
    assert got == []


def test_traceback_into_the_utr_loses_the_variants_in_both_packages():
    """A reference behaviour both packages share: local_align's traceback
    steps to the neighbour of highest score, so where the 5' UTR's last
    base matches the V's first it climbs into the UTR.  The V hit then
    starts a base early on the contig, SegmentHit.variants walks the V
    one base off, finds far more than a tenth of it different and
    claims no evidence (None), though the contig carries six
    substitutions.  With any other last UTR base the evidence is the
    six.  build_vdj_b_run draws its UTRs so that no planted cell loses
    its evidence."""
    rng = np.random.default_rng(3)
    rand = lambda n: "".join(rng.choice(list("ACGT"), n))
    v = rand(297) + "TGT"
    subs = {p: "ACGT"[("ACGT".index(v[p]) + 1) % 4]
            for p in (40, 77, 120, 150, 201, 260)}
    mutated = "".join(subs.get(i, b) for i, b in enumerate(v))
    tail = rand(90)
    other = [b for b in "ACGT" if b != v[0]]
    for last, lost in ((v[0], True), (other[0], False)):
        utr = rand(20) + other[1] * 9 + last
        contig = utr + mutated + tail
        want = jann.best_hit(contig, [jann.Segment("1", "IGHV1", "V", "IGH",
                                                   v.encode())])
        ann = support.Annotator(VdjReference(
            [Segment("1", "IGHV1", "V", "IGH", v.encode())]))
        assert _hit_fields(ann.best_hit(contig, "V"), contig) \
            == _hit_fields(want, contig)
        if lost:
            assert want.contig_start == len(utr) - 1
            assert want.variants(contig) is None
        else:
            assert want.contig_start == len(utr)
            assert want.variants(contig) == frozenset(subs.items())
