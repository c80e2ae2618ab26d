"""GTF parsing -> transcriptome model (genes, transcripts, exons, junctions).

Counterpart of the reference's transcriptome crate
(lib/rust/transcriptome/src/transcriptome.rs Transcriptome::from_reference_path,
parse_gtf.rs): we parse `exon` records, group them by transcript_id, and
derive per-transcript sorted exon lists plus the set of annotated splice
junctions (intron donor/acceptor pairs) that seeds the aligner's junction
contigs (STAR sjdb equivalent).

Coordinates: GTF is 1-based inclusive; we store 0-based half-open [start, end).

Verbatim copy of cellranger_tpu/io/gtf.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Gene:
    id: str
    name: str
    chrom: str
    strand: str
    index: int


@dataclass
class Transcript:
    id: str
    gene_index: int
    chrom: str
    strand: str
    exons: list[tuple[int, int]] = field(default_factory=list)  # sorted [start, end)

    @property
    def start(self) -> int:
        return self.exons[0][0]

    @property
    def end(self) -> int:
        return self.exons[-1][1]

    def splice_junctions(self) -> list[tuple[int, int]]:
        """(donor_end, acceptor_start) 0-based: intron = [donor_end, acceptor_start)."""
        return [(self.exons[i][1], self.exons[i + 1][0])
                for i in range(len(self.exons) - 1)]


def _parse_attrs(s: str) -> dict[str, str]:
    out = {}
    for part in s.rstrip(";").split(";"):
        part = part.strip()
        if not part:
            continue
        if " " in part:
            k, v = part.split(" ", 1)
            out[k] = v.strip().strip('"')
    return out


@dataclass
class Transcriptome:
    genes: list[Gene]
    transcripts: list[Transcript]

    @property
    def gene_ids(self) -> list[str]:
        return [g.id for g in self.genes]

    @property
    def gene_names(self) -> list[str]:
        return [g.name for g in self.genes]

    def junctions(self) -> dict[tuple[str, int, int], list[int]]:
        """{(chrom, donor_end, acceptor_start): [transcript indices]}"""
        out: dict[tuple[str, int, int], list[int]] = {}
        for ti, t in enumerate(self.transcripts):
            for dj in t.splice_junctions():
                out.setdefault((t.chrom, dj[0], dj[1]), []).append(ti)
        return out

    @staticmethod
    def from_gtf(path: str) -> "Transcriptome":
        opener = gzip.open if path.endswith(".gz") else open
        genes: list[Gene] = []
        gene_idx: dict[str, int] = {}
        txs: dict[str, Transcript] = {}
        tx_order: list[str] = []
        with opener(path, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 9 or fields[2] != "exon":
                    continue
                chrom, _src, _kind, start, end, _score, strand, _frame, attrs = fields[:9]
                a = _parse_attrs(attrs)
                gid = a.get("gene_id")
                tid = a.get("transcript_id")
                if gid is None or tid is None:
                    continue
                if gid not in gene_idx:
                    gene_idx[gid] = len(genes)
                    genes.append(Gene(gid, a.get("gene_name", gid), chrom, strand,
                                      len(genes)))
                if tid not in txs:
                    txs[tid] = Transcript(tid, gene_idx[gid], chrom, strand)
                    tx_order.append(tid)
                txs[tid].exons.append((int(start) - 1, int(end)))
        transcripts = []
        for tid in tx_order:
            t = txs[tid]
            t.exons.sort()
            # merge book-ended/overlapping exon records
            merged: list[tuple[int, int]] = []
            for s, e in t.exons:
                if merged and s <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e))
                else:
                    merged.append((s, e))
            t.exons = merged
            transcripts.append(t)
        return Transcriptome(genes, transcripts)


def read_fasta(path: str) -> dict[str, bytes]:
    """FASTA -> {name: uppercase sequence bytes}."""
    opener = gzip.open if path.endswith(".gz") else open
    seqs: dict[str, bytes] = {}
    name = None
    chunks: list[bytes] = []
    with opener(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(chunks).upper()
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        seqs[name] = b"".join(chunks).upper()
    return seqs


def write_fasta(path: str, seqs: dict[str, bytes], width: int = 60):
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            s = seq.decode() if isinstance(seq, bytes) else seq
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + "\n")


def filter_gtf(in_path: str, out_path: str,
               attributes: dict[str, set] | None = None) -> int:
    """mkgtf: copy a GTF keeping rows whose attributes pass the filter
    (bin/rna/mkgtf_lib.py + reference.py GtfBuilder:441-467 semantics):
    a row is removed iff it HAS a filtered key with a value outside the
    allowed set; rows lacking the key, and comment lines, are kept.
    Returns the number of feature rows written."""
    attributes = attributes or {}
    n = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("#"):
                fout.write(line)
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                fout.write(line)
                continue
            props = _parse_attrs(parts[8])
            remove = any(k in attributes and v not in attributes[k]
                         for k, v in props.items())
            if not remove:
                fout.write(line)
                n += 1
    return n
