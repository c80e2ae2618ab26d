"""Port parity for paired-end chemistries (SC5P-PE), tolerance 0:

  * one packed SC5P-PE batch (proper pairs, a discordant pair, same-strand
    mates, one mate unmapped either way, mate 1 on a junction contig, mates
    on different genes, invalid UMI / barcode rows, padding rows) through
    the JAX package's stream step and the port's: the packed input plane
    and every column of the three output planes are equal, and
    `unpack_step_out` names them alike; the accumulate-mode step leaves
    equal accumulators;
  * `unpack_step_out` tells single-end from paired plane widths, with and
    without secondary-locus blocks, as the JAX package's does;
  * the three runs of tests/test_paired_end.py through both `run_count`s:
    equal metrics, MEX bytes and BAM bytes, matrix h5 and molecule_info.h5
    equal as real h5py reads them, and that file's own assertions hold
    for the port;
  * `testing.fixtures.build_pe_run` at a small size: the counts it
    expects by construction are the counts the port gives.
"""

import gzip
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnIndex
from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.io.gtf import write_fasta
from cellranger_tpu.io.reference import ReferencePackage as JaxRefPackage
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu_torch.align.aligner import DeviceIndex
from cellranger_tpu_torch.align.annotate import AnnotationIndex
from cellranger_tpu_torch.io.bam_read import read_bam
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.ops import encode
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing import correctness as cc
from cellranger_tpu_torch.testing.fixtures import build_pe_run
from test_paired_end import READ_LEN, _build_ref, _revcomp, _write_pe_run
from test_torch_hdf5 import h5_parity_diffs

L = READ_LEN


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pe_index(tmp_path_factory):
    """Two genes 600 bp apart on the + strand; GA has two exons, so the
    index carries a junction contig."""
    root = tmp_path_factory.mktemp("pe_idx")
    rng = np.random.default_rng(5)
    genome = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000))
    write_fasta(str(root / "g.fa"), {"chr1": genome})
    with open(root / "g.gtf", "w") as f:
        for gid, a, b in (("GA", 2001, 3000), ("GA", 4001, 5000),
                          ("GB", 5601, 7000)):
            f.write(f'chr1\tt\texon\t{a}\t{b}\t.\t+\t.\tgene_id "{gid}"; '
                    f'transcript_id "T{gid}"; gene_name "{gid}";\n')
    JaxRefPackage.build(str(root / "g.fa"), str(root / "g.gtf"),
                        str(root / "ref"))
    ref = JaxRefPackage.load(str(root / "ref"))
    gi = ref.genome_index
    assert len(gi.sj_donor_end) >= 1
    return genome, JaxDeviceIndex.from_host(gi), \
        JaxAnnIndex.build(ref.transcriptome, gi)


def _pe_batch(genome, B=64):
    """A ReadBatch-like namespace of mate pairs, one scenario per row."""
    rng = np.random.default_rng(9)

    def junk():
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), L))

    def fwd(p):
        return genome[p:p + L]

    def rc(p):
        return _revcomp(genome[p:p + L])

    pairs = [
        (fwd(2100), rc(2400)),             # proper, both in GA
        (fwd(2200), rc(2650)),             # proper
        (fwd(2100), rc(14_000)),           # discordant: beyond the insert
        (fwd(2100), fwd(2400)),            # same strand
        (fwd(2100), junk()),               # mate 2 unmapped
        (junk(), rc(2400)),                # mate 1 unmapped
        (junk(), junk()),                  # neither maps
        (genome[2950:3000] + genome[4000:4000 + L - 50], rc(4300)),
        # ^ mate 1 spans the GA junction (lands on the junction contig)
        (fwd(4800), rc(5700)),             # GA vs GB: gene discordant
        (fwd(1500), rc(2300)),             # mate 1 intergenic, mate 2 genic
        (fwd(2300), rc(1500)),             # mate 2 upstream, intergenic
        (fwd(20_000), rc(20_300)),         # proper but intergenic
        (rc(2400), fwd(2100)),             # proper, antisense orientation
    ]
    n = len(pairs)
    rna = np.zeros((B, L), np.uint8)
    nm = np.zeros((B, L), bool)
    rna2 = np.zeros((B, L), np.uint8)
    nm2 = np.zeros((B, L), bool)
    for i, (m1, m2) in enumerate(pairs):
        rna[i], nm[i] = encode.encode_str(m1)
        rna2[i], nm2[i] = encode.encode_str(m2)
    nm2[1, 40] = False                         # an N inside mate 2
    slot_valid = np.arange(B) < n
    umi_valid = slot_valid.copy()
    umi_valid[1] = False                       # proper pair, bad UMI
    bc_idx = np.where(slot_valid, np.arange(B) % 7, -1).astype(np.int32)
    bc_idx[0] = -1                             # proper pair, no barcode
    batch = SimpleNamespace(
        batch_size=B, n_reads=n, rna=rna, rna_nmask=nm, rna2=rna2,
        rna2_nmask=nm2, slot_valid=slot_valid, umi_valid=umi_valid,
        umi_packed=rng.integers(0, 1 << 20, B).astype(np.uint32))
    return batch, bc_idx


def test_pe_stream_step_matches_jax(pe_index):
    genome, jdidx, jann = pe_index
    chem, jchem = get_chemistry("SC5P-PE"), jax_get_chemistry("SC5P-PE")
    batch, bc_idx = _pe_batch(genome)
    plane = tcount.pack_step_input(chem, L, batch, bc_idx)
    np.testing.assert_array_equal(
        plane, jax_count.pack_step_input(jchem, L, batch, bc_idx))
    assert plane.shape[1] == tcount.packed_width(chem, L) \
        == jax_count.packed_width(jchem, L) \
        == 2 * tcount.packed_width(get_chemistry("SC3Pv3"), L) - 3
    # emit_secondary is asked for, as BAM runs do; paired steps drop it
    jstep = jax_count._make_step(jdidx, jann, jchem, L, accumulate=False,
                                 emit_secondary=True)
    tstep = tcount.make_stream_step(DeviceIndex.from_jax(jdidx, "cpu"),
                                    AnnotationIndex.from_jax(jann, "cpu"),
                                    chem, L, emit_secondary=True)
    want = jstep(jnp.asarray(plane))
    got = tcount.fetch_step_out(tstep(tcount.upload_plane(plane, "cpu")))
    for k in ("i32", "flags", "mvec"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    want_ho, want_m = jax_count.unpack_step_out(want)
    got_ho, got_m = tcount.unpack_step_out(got)
    assert got_m == want_m and set(got_ho) == set(want_ho)
    assert "pos2" in got_ho and "sec_pos" not in got_ho
    for k, w in want_ho.items():
        assert got_ho[k].dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(got_ho[k], np.asarray(w), err_msg=k)
    # the batch holds what it says: proper and improper pairs, a pair on
    # the junction contig, a gene-discordant pair, rows without bc / UMI
    ho = got_ho
    glen = int(jdidx.genome_len)
    assert ho["mapped"][:2].all() and not ho["mapped"][2:7].any()
    assert got_m["n_improper_pair"] == 4 and got_m["n_mapped"] >= 6
    assert ho["mapped"][7] and int(ho["pos"][7]) >= glen
    assert ho["gene_discordant"][8] and not ho["conf_ok"][8]
    assert ho["conf_ok"][9] and ho["conf_ok"][10]
    assert ho["mapped"][11] and not ho["conf_ok"][11]
    assert not ho["conf_ok"][0] and not ho["conf_ok"][1]
    assert (ho["mapq2"][2:7] == 0).all()


def test_pe_accumulate_step_matches_jax(pe_index):
    genome, jdidx, jann = pe_index
    chem, jchem = get_chemistry("SC5P-PE"), jax_get_chemistry("SC5P-PE")
    batch, bc_idx = _pe_batch(genome)
    plane = tcount.pack_step_input(chem, L, batch, bc_idx)
    jstep = jax_count._make_step(jdidx, jann, jchem, L, accumulate=True)
    tstep = tcount.make_count_step(DeviceIndex.from_jax(jdidx, "cpu"),
                                   AnnotationIndex.from_jax(jann, "cpu"),
                                   chem, L)
    B = plane.shape[0]
    jacc = jstep(jnp.asarray(plane), jstep.init_acc(4 * B, 4 * B),
                 lib_tag=0)
    tacc = tstep.init_acc(4 * B, 4 * B)
    tstep(tcount.upload_plane(plane, "cpu"), tacc, lib_tag=0)
    n = int(jacc["mol_n"])
    assert int(tacc["mol_n"]) == n > 0
    np.testing.assert_array_equal(
        tacc["mol"][:n].numpy(), np.asarray(jacc["mol"])[:n].astype(np.int64))
    for k in ("sjh", "mvec"):
        np.testing.assert_array_equal(tacc[k].numpy(), np.asarray(jacc[k]))


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("n_sec", [0, 3], ids=["nosec", "sec3"])
def test_unpack_step_out_widths(paired, n_sec):
    rng = np.random.default_rng(3)
    n = len(tcount.I32_FIELDS) + (len(tcount.PE_I32_FIELDS) if paired else 0)
    w = n + 2 * tcount.KG_LIST + 4 * n_sec
    out = dict(
        i32=rng.integers(-2**31, 2**31, (17, w)).astype(np.int32),
        flags=rng.random((17, len(tcount.BOOL_FIELDS) + n_sec)) < 0.5,
        mvec=rng.integers(0, 99, len(tcount.METRIC_FIELDS)).astype(np.int32))
    want_ho, want_m = jax_count.unpack_step_out(out)
    got_ho, got_m = tcount.unpack_step_out(out)
    assert got_m == want_m and set(got_ho) == set(want_ho)
    assert ("pos2" in got_ho) == paired
    assert ("sec_pos" in got_ho) == (n_sec > 0)
    for k, v in want_ho.items():
        assert got_ho[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got_ho[k], v, err_msg=k)
    if paired:
        assert got_ho["pos2"].dtype == np.uint32
        np.testing.assert_array_equal(
            got_ho["gene_list"], out["i32"][:, n:n + tcount.KG_LIST])


# ---- the three runs of tests/test_paired_end.py through both packages ----

def _wl(tmp_path, rng):
    wl = sorted({"".join(rng.choice(list("ACGT"), 16)) for _ in range(40)})
    open(tmp_path / "wl.txt", "w").writelines(s + "\n" for s in wl)
    return wl


def _proper(tmp_path):
    rng = np.random.default_rng(71)
    genome = _build_ref(tmp_path, rng)
    return _write_pe_run(tmp_path, genome, rng, _wl(tmp_path, rng)), {}


def _intersection(tmp_path):
    rng = np.random.default_rng(72)
    genome = _build_ref(tmp_path, rng)
    wl = _wl(tmp_path, rng)
    r1p = str(tmp_path / "q_S1_L001_R1_001.fastq.gz")
    r2p = str(tmp_path / "q_S1_L001_R2_001.fastq.gz")
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for i in range(12):
            umi = "".join(rng.choice(list("ACGT"), 10))
            p1 = 1850 + i
            r1 = wl[i % 3] + umi + genome[p1:p1 + L].decode()
            mate2 = _revcomp(genome[p1 + 300:p1 + 300 + L])
            f1.write(f"@q{i}\n{r1}\n+\n{'F' * len(r1)}\n")
            f2.write(f"@q{i}\n{mate2.decode()}\n+\n{'F' * L}\n")
    return (r1p, r2p), {}


def _bam(tmp_path):
    rng = np.random.default_rng(73)
    genome = _build_ref(tmp_path, rng)
    return _write_pe_run(tmp_path, genome, rng, _wl(tmp_path, rng),
                         n_proper=15, n_discordant=5), dict(write_bam=True)


def _check_proper(s, out):
    assert s["total_reads"] == 26
    assert s["conf_mapped_reads"] == 20
    assert s["improper_pair_reads"] == 6
    assert s["mapped_reads"] == 20
    assert s["total_molecules"] == 20


def _check_intersection(s, out):
    assert s["mapped_reads"] == 12
    assert s["conf_mapped_reads"] == 12
    assert s["total_molecules"] == 12


def _check_bam(s, out):
    assert s["conf_mapped_reads"] == 15
    _, records, _ = read_bam(os.path.join(out, "possorted_genome_bam.bam"))
    assert len(records) == 2 * 20
    by_name = {}
    for r in records:
        assert r["flag"] & 0x1
        assert bool(r["flag"] & 0x40) != bool(r["flag"] & 0x80)
        by_name.setdefault(r["name"], []).append(r)
    n_umi_count = 0
    for pair in by_name.values():
        assert len(pair) == 2
        m1 = next(r for r in pair if r["flag"] & 0x40)
        m2 = next(r for r in pair if r["flag"] & 0x80)
        if not (m1["flag"] & 0x4):   # proper pair: both mapped
            for a, b in ((m1, m2), (m2, m1)):
                assert a["flag"] & 0x2
                assert a["next_ref"] == b["ref_id"]
                assert a["next_pos"] == b["pos"]
            assert m1["tlen"] == -m2["tlen"] != 0
            assert bool(m1["flag"] & 0x20) == bool(m2["flag"] & 0x10)
            assert bool(m2["flag"] & 0x20) == bool(m1["flag"] & 0x10)
            if "GX" in m1["tags"]:
                assert m2["tags"].get("GX") == m1["tags"]["GX"]
            n_umi_count += sum(bool(r["tags"]["xf"] & 8) for r in pair)
        else:                        # improper: both unmapped
            assert m2["flag"] & 0x4
            assert m1["flag"] & 0x8 and m2["flag"] & 0x8
            assert not (m1["flag"] & 0x2)
    assert n_umi_count == s["total_molecules"] == 15


def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("build, check", [
    (_proper, _check_proper), (_intersection, _check_intersection),
    (_bam, _check_bam)], ids=["proper_pairs", "pair_gene_intersection",
                              "bam_both_mates"])
def test_sc5p_pe_run_matches_jax(tmp_path, build, check):
    (r1p, r2p), extra = build(tmp_path)
    kw = dict(fastq_pairs=[(r1p, r2p)], reference_path=str(tmp_path / "ref"),
              whitelist_path=str(tmp_path / "wl.txt"), chemistry="SC5P-PE",
              read_len=L, batch_size=256, secondary_analysis=False,
              checkpoint=False, **extra)
    t_out, j_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_sum = tcount.run_count(tcount.CountConfig(**kw), t_out, device="cpu")
    j_sum = jax_count.run_count(jax_count.CountConfig(**kw), j_out)
    check(t_sum, t_out)
    assert not cc.check_metrics(t_sum, j_sum)
    assert t_sum["q30_rna_frac"] == j_sum["q30_rna_frac"]
    assert t_sum["rna_bases"] == j_sum["rna_bases"] == 2 * L * t_sum[
        "total_reads"]
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            assert _gunzip(os.path.join(t_out, sub, f)) \
                == _gunzip(os.path.join(j_out, sub, f)), (sub, f)
        assert not h5_parity_diffs(os.path.join(t_out, sub + ".h5"),
                                   os.path.join(j_out, sub + ".h5")), sub
    assert not h5_parity_diffs(os.path.join(t_out, "molecule_info.h5"),
                               os.path.join(j_out, "molecule_info.h5"),
                               molecule_info=True)
    if extra:
        bam = "possorted_genome_bam.bam"
        with open(os.path.join(t_out, bam), "rb") as a, \
                open(os.path.join(j_out, bam), "rb") as b:
            assert a.read() == b.read()
        with open(os.path.join(t_out, bam + ".bai"), "rb") as a, \
                open(os.path.join(j_out, bam + ".bai"), "rb") as b:
            assert a.read() == b.read()


def test_build_pe_run_counts_hold(tmp_path):
    fx = build_pe_run(str(tmp_path / "fx"), n_pairs=1500, genome_len=200_000,
                      n_genes=20, n_cells=30, n_wl=500)
    exp = fx["expected"]
    assert exp["total_reads"] == 1500 and exp["improper_pair_reads"] > 0
    assert exp["conf_mapped_reads"] + exp["improper_pair_reads"] == 1500
    assert exp["total_molecules"] * 2 == exp["conf_mapped_reads"]
    s = tcount.run_count(tcount.CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], chemistry="SC5P-PE", read_len=L,
        batch_size=512, secondary_analysis=False, checkpoint=False),
        str(tmp_path / "out"), device="cpu")
    assert {k: s[k] for k in exp} == exp
    assert s["corrected_barcode_reads"] > 0      # the planted barcode errors
    # a second fixture over the first one's reference reuses its files
    again = build_pe_run(str(tmp_path / "fx2"), n_pairs=400, ref=fx,
                         genome_len=200_000, n_genes=20, n_cells=30,
                         n_wl=500)
    assert again["ref"] == fx["ref"] and again["wl"] == fx["wl"]
    assert not os.path.exists(tmp_path / "fx2" / "ref")
