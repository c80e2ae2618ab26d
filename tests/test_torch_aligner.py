"""Port parity: cellranger_tpu_torch's aligner against the JAX package's
`make_aligner`, on both index layouts (every/strand31, minimizer/parity)
and on a genome with planted unannotated junctions.

Reads carry substitutions, indels (SW rescue), N bases, polyA tails,
splices over annotated and novel junctions, repeats (multimappers and
saturated candidate tables) and junk.  Every output key must be equal
(tolerance 0).  The port's DeviceIndex built by its own from_host must
hold exactly the tables of the JAX DeviceIndex, and the two packages must
read each other's index.npz.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.align.aligner import make_aligner as jax_make_aligner
from cellranger_tpu.align.index import GenomeIndex as JaxGenomeIndex
from cellranger_tpu.io.gtf import Transcriptome as JaxTranscriptome
from cellranger_tpu_torch.align.aligner import DeviceIndex, make_aligner
from cellranger_tpu_torch.align.index import GenomeIndex
from cellranger_tpu_torch.io.gtf import Transcriptome

from util import random_genome, mutate, revcomp, make_two_gene_gtf
from test_aligner import codes_batch

READ_LEN = 91
B = 256


def _genome_with_repeats(rng, n):
    """Random genome with a 600 bp segment at 4 loci and a 300 bp segment
    at 6 loci (MAPQ 1 and saturated-candidate multimappers)."""
    g = bytearray(random_genome(rng, n))
    seg4 = bytes(g[8000:8600])
    for p in (n // 4, n // 2, 3 * n // 4):
        g[p:p + 600] = seg4
    seg6 = bytes(g[12000:12300])
    for i in range(1, 6):
        p = 12000 + i * (n // 7)
        g[p:p + 300] = seg6
    return bytes(g)


def _planted_junction_genome(rng, n):
    g = bytearray(_genome_with_repeats(rng, n))
    junctions = []
    for d in range(20_000, n - 20_000, 10_000):
        a = d + int(rng.integers(200, 5_000))
        g[d:d + 2] = b"GT"
        g[a - 2:a] = b"AG"
        junctions.append((d, a))
    return bytes(g), junctions


def _reads(rng, genome, junctions, n=B):
    """A mixed batch of reads of every class the aligner handles."""
    L = READ_LEN
    reads = []

    def pos():
        return int(rng.integers(0, len(genome) - L - 10))

    def strand(r):
        return revcomp(r) if rng.integers(2) else r

    while len(reads) < n:
        k = len(reads) % 9
        if k in (0, 1):                                   # substitutions
            p = pos()
            reads.append(strand(mutate(rng, genome[p:p + L],
                                       int(rng.integers(0, 4)))))
        elif k == 2:                                      # deletion
            p, cut, d = pos(), int(rng.integers(20, 70)), int(rng.integers(1, 5))
            r = genome[p:p + cut] + genome[p + cut + d:p + L + d]
            reads.append(strand(r))
        elif k == 3:                                      # insertion
            p, cut, d = pos(), int(rng.integers(20, 70)), int(rng.integers(1, 4))
            r = (genome[p:p + cut] + random_genome(rng, d)
                 + genome[p + cut:p + L - d])
            reads.append(strand(r))
        elif k == 4 and junctions:                        # spliced
            d, a = junctions[int(rng.integers(len(junctions)))]
            left = int(rng.integers(25, 66))
            reads.append(strand(genome[d - left:d] + genome[a:a + L - left]))
        elif k == 5:                                      # polyA tail
            p = pos()
            reads.append(genome[p:p + 60] + b"A" * (L - 60))
        elif k == 6:                                      # N bases
            p = pos()
            r = bytearray(genome[p:p + L])
            for i in rng.integers(0, L, 4):
                r[i] = ord("N")
            reads.append(bytes(r))
        elif k == 7:                                      # repeat copies
            base = 8000 if rng.integers(2) else 12000
            reads.append(strand(genome[base + 50:base + 50 + L]))
        else:                                             # junk
            reads.append(random_genome(rng, L))
    return reads


def _setup(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "every_strand31_gtf":
        genome = _genome_with_repeats(rng, 60_000)
        import tempfile, os
        with tempfile.TemporaryDirectory() as d:
            gtf = os.path.join(d, "genes.gtf")
            make_two_gene_gtf(gtf)
            txome = Transcriptome.from_gtf(gtf)
            jtxome = JaxTranscriptome.from_gtf(gtf)
        kw = dict(sampling="every", pos_mode="strand31")
        junctions = [(1400, 2200)]
    elif name == "minimizer_parity":
        genome = _genome_with_repeats(rng, 120_000)
        txome = jtxome = None
        kw = dict(sampling="minimizer", pos_mode="parity")
        junctions = []
    else:                                   # novel junctions, every layout
        genome, junctions = _planted_junction_genome(rng, 150_000)
        txome = jtxome = None
        kw = dict(sampling="every", pos_mode="strand31")
    seqs = {"chr1": genome}
    gi = GenomeIndex.build(seqs, txome, **kw)
    jgi = JaxGenomeIndex.build(seqs, jtxome, **kw)
    return genome, junctions, gi, jgi, rng


SETUPS = ["every_strand31_gtf", "minimizer_parity", "novel_sj"]


@pytest.fixture(scope="module", params=SETUPS)
def setup(request):
    return _setup(request.param)


def test_device_index_tables_match(setup):
    _genome, _j, gi, jgi, _rng = setup
    jidx = JaxDeviceIndex.from_host(jgi)
    own = DeviceIndex.from_host(gi, "cpu")
    via = DeviceIndex.from_jax(jidx, "cpu")
    for f in ("text_rows", "chrom_starts", "sj_rows", "text_rows_ov"):
        a, b = getattr(own, f), getattr(via, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    assert torch.equal(own.kmer_table.rows, via.kmer_table.rows)
    assert own.kmer_table.bits == via.kmer_table.bits
    for f in ("genome_len", "text_len", "sj_overhang", "k", "pos_mode",
              "sampling", "minimizer_w"):
        assert getattr(own, f) == getattr(via, f), f


def test_index_npz_interchange(setup, tmp_path):
    _genome, _j, gi, jgi, _rng = setup
    gi.save(str(tmp_path / "port.npz"))
    jgi.save(str(tmp_path / "jax.npz"))
    from_port = JaxGenomeIndex.load(str(tmp_path / "port.npz"))
    from_jax = GenomeIndex.load(str(tmp_path / "jax.npz"))
    for f in ("text", "text_valid", "chrom_starts", "sj_contig_start",
              "sj_chrom", "sj_donor_end", "sj_acceptor_start", "kmer_keys",
              "kmer_pos"):
        np.testing.assert_array_equal(getattr(from_port, f), getattr(jgi, f))
        np.testing.assert_array_equal(getattr(from_jax, f), getattr(gi, f))
    for f in ("chrom_names", "genome_len", "sj_overhang", "k", "stride",
              "sampling", "minimizer_w", "pos_mode"):
        assert getattr(from_port, f) == getattr(jgi, f) \
            == getattr(from_jax, f), f


def test_aligner_matches_jax(setup):
    genome, junctions, gi, jgi, rng = setup
    codes, mask = codes_batch(_reads(rng, genome, junctions), READ_LEN)
    want = jax_make_aligner(JaxDeviceIndex.from_host(jgi), READ_LEN)(
        codes, mask)
    got = make_aligner(DeviceIndex.from_host(gi, "cpu"), READ_LEN)(
        torch.from_numpy(np.asarray(codes)), torch.from_numpy(np.asarray(mask)))
    assert set(got) == set(want)
    for k in sorted(want):
        w = np.asarray(want[k])
        g = got[k].numpy()
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=k)
    # the batch reaches every stage
    mapped = np.asarray(want["mapped"])
    assert 0.5 < mapped.mean() < 1.0
    assert (np.asarray(want["sw_score"]) > np.asarray(want["score"])).any()
    assert (np.asarray(want["n_best"])[mapped] >= 2).any()
    if junctions and gi.n_junctions == 0:
        assert np.asarray(want["novel_sj"]).any()
