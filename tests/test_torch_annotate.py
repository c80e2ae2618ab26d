"""Port parity: cellranger_tpu_torch's annotator against the JAX
package's `make_annotator`, on a transcriptome with overlapping genes on
both strands, multi-exon transcripts and annotated junction contigs.
Alignments are random over genes, introns, intergenic space and junction
contigs; both chemistry strandednesses.  Tolerance 0 (the one float
compare, the 50% exonic overlap, is the same f32 compare on both sides).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnotationIndex
from cellranger_tpu.align.annotate import make_annotator as jax_make_annotator
from cellranger_tpu.align.index import GenomeIndex as JaxGenomeIndex
from cellranger_tpu.io.gtf import Transcriptome as JaxTranscriptome
from cellranger_tpu_torch.align.annotate import (AnnotationIndex,
                                                 make_annotator)
from cellranger_tpu_torch.align.index import GenomeIndex
from cellranger_tpu_torch.io.gtf import Transcriptome

from util import random_genome

GTF = [
    # gene, strand, transcripts: list of exon lists (0-based half-open)
    ("GA", "+", [[(1000, 1400), (2200, 2600)], [(1000, 1500), (2200, 2400)]]),
    ("GB", "-", [[(5000, 5800)]]),
    ("GC", "-", [[(5500, 6200), (7000, 7300)]]),       # overlaps GB
    ("GD", "-", [[(9000, 9100), (9500, 9600), (9900, 10400)]]),
    ("GE", "+", [[(12000, 12900)]]),
    ("GF", "-", [[(12100, 12500), (13000, 13200)]]),   # antisense to GE
]


def _write_gtf(path):
    with open(path, "w") as f:
        for gname, strand, txs in GTF:
            for ti, exons in enumerate(txs):
                attr = (f'gene_id "{gname}"; gene_name "{gname}"; '
                        f'transcript_id "{gname}.{ti}";')
                for a, b in exons:
                    f.write(f"chr1\tt\texon\t{a + 1}\t{b}\t.\t{strand}\t.\t"
                            f"{attr}\n")


@pytest.fixture(scope="module")
def indices(tmp_path_factory):
    d = tmp_path_factory.mktemp("ann")
    _write_gtf(str(d / "g.gtf"))
    txome = Transcriptome.from_gtf(str(d / "g.gtf"))
    jtxome = JaxTranscriptome.from_gtf(str(d / "g.gtf"))
    rng = np.random.default_rng(5)
    seqs = {"chr1": random_genome(rng, 16_000)}
    gi = GenomeIndex.build(seqs, txome)
    jgi = JaxGenomeIndex.build(seqs, jtxome)
    assert gi.n_junctions >= 4
    jann = JaxAnnotationIndex.build(jtxome, jgi)
    return txome, gi, jgi, jann


def _alignments(rng, gi, n=512):
    glen = gi.genome_len
    text_len = len(gi.text)
    pos = np.where(rng.random(n) < 0.8,
                   rng.integers(0, glen - 120, n),
                   rng.integers(glen, max(text_len - 120, glen + 1), n))
    pos[:32] = rng.integers(5500, 5720, 32)     # inside both GB and GC
    aln_len = rng.integers(20, 92, n).astype(np.int32)
    strand = rng.integers(0, 2, n).astype(np.int32)
    mapq = rng.choice(np.array([255, 3, 1, 0], np.int32), n)
    mapped = rng.random(n) < 0.9
    return pos.astype(np.uint32), aln_len, strand, mapq, mapped


def test_annotation_tables_match(indices):
    txome, gi, _jgi, jann = indices
    own = AnnotationIndex.build(txome, gi, "cpu")
    via = AnnotationIndex.from_jax(jann, "cpu")
    for f in ("iv_rows", "iv_grid", "sj_rows"):
        assert torch.equal(getattr(own, f), getattr(via, f)), f
    assert own.n_genes == via.n_genes == len(txome.genes)


@pytest.mark.parametrize("strandedness", ["+", "-"])
def test_annotator_matches_jax(indices, strandedness):
    txome, gi, jgi, jann = indices
    rng = np.random.default_rng(len(strandedness) + ord(strandedness))
    pos, aln_len, strand, mapq, mapped = _alignments(rng, gi)
    want = jax_make_annotator(jann, jgi.genome_len, jgi.sj_overhang,
                              strandedness)(
        jnp.asarray(pos), jnp.asarray(aln_len), jnp.asarray(strand),
        jnp.asarray(mapq), jnp.asarray(mapped))
    got = make_annotator(AnnotationIndex.build(txome, gi, "cpu"),
                         gi.genome_len, gi.sj_overhang, strandedness)(
        torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(aln_len),
        torch.from_numpy(strand), torch.from_numpy(mapq),
        torch.from_numpy(mapped))
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_array_equal(
            got[k].numpy().astype(np.int64),
            np.asarray(want[k]).astype(np.int64), err_msg=k)
    gene = np.asarray(want["gene"])
    region = np.asarray(want["region"])
    # every annotation outcome appears in the batch
    assert (gene >= 0).any() and (gene == -1).any() and (gene == -2).any()
    assert set(np.unique(region)) == {0, 1, 2}
    assert np.asarray(want["antisense"]).any()
    assert (pos >= gi.genome_len)[np.asarray(want["conf_mapped"])].any()
