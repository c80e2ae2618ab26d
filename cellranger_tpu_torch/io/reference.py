"""Reference package builder/loader — the mkref analog.

The reference's mkref (lib/python/cellranger/reference_builder.py:40,370)
produces fasta/ + genes/ + STAR index; ours produces fasta/ + genes/ +
a kmer index (.npz) + reference.json metadata. The aligner needs only the
sorted kmer table, so the build is minutes of host numpy for a mammalian
genome (vs STAR's ~8 core-hours, reference_builder.py:404), or under a
minute with the kmer table built on a device.

Copied from cellranger_tpu/io/reference.py over the port's GenomeIndex;
`build` and `build_multi` take `device` as a required keyword, as the
port's other computing entry points do: the torch device the kmer table is
built on (`GenomeIndex.build(device=)`), or None for the host numpy build,
the same index.npz either way.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass

from ..align.index import GenomeIndex
from ..io.gtf import Transcriptome, read_fasta

REFERENCE_JSON = "reference.json"


@dataclass
class ReferencePackage:
    path: str
    genome_index: GenomeIndex
    transcriptome: Transcriptome
    metadata: dict

    @property
    def genome_name(self) -> str:
        genomes = self.metadata.get("genomes", ["genome"])
        return genomes[0]

    @property
    def genomes(self) -> list[str]:
        return self.metadata.get("genomes", ["genome"])

    def genome_of_gene(self) -> list[str]:
        """Per-gene genome name from the chromosome prefix (multi-genome
        references prefix chroms with '<genome>_')."""
        out = []
        for g in self.transcriptome.genes:
            hit = self.genomes[0]
            for name in self.genomes:
                if g.chrom.startswith(name + "_"):
                    hit = name
                    break
            out.append(hit)
        return out

    @staticmethod
    def build_multi(inputs: list[tuple[str, str, str]], out_dir: str,
                    k: int = 16, stride: int = 1,
                    sj_overhang: int = 120, *,
                    device) -> "ReferencePackage":
        """Multi-genome (barnyard) reference: inputs = [(genome_name,
        fasta, gtf)]; chromosomes and GTF seqnames get '<genome>_' prefixes
        (the reference's mkref multi-genome convention,
        reference_builder.py)."""
        os.makedirs(os.path.join(out_dir, "fasta"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "genes"), exist_ok=True)
        fa_dst = os.path.join(out_dir, "fasta", "genome.fa")
        gtf_dst = os.path.join(out_dir, "genes", "genes.gtf")
        from ..io.gtf import write_fasta

        merged = {}
        with open(gtf_dst, "w") as g_out:
            for name, fasta, gtf in inputs:
                for chrom, seq in read_fasta(fasta).items():
                    merged[f"{name}_{chrom}"] = seq
                with open(gtf) as g_in:
                    for line in g_in:
                        if line.startswith("#") or not line.strip():
                            continue
                        parts = line.split("\t", 1)
                        g_out.write(f"{name}_{parts[0]}\t{parts[1]}")
        write_fasta(fa_dst, merged)
        pkg = ReferencePackage._build_from(fa_dst, gtf_dst, out_dir,
                                           [n for n, _, _ in inputs],
                                           k, stride, sj_overhang, device)
        return pkg

    @staticmethod
    def build(fasta_path: str, gtf_path: str, out_dir: str,
              genome_name: str = "genome", k: int = 16, stride: int = 1,
              sj_overhang: int = 120, *, device) -> "ReferencePackage":
        os.makedirs(os.path.join(out_dir, "fasta"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "genes"), exist_ok=True)
        fa_dst = os.path.join(out_dir, "fasta", "genome.fa")
        gtf_dst = os.path.join(out_dir, "genes", "genes.gtf")
        if os.path.abspath(fasta_path) != os.path.abspath(fa_dst):
            shutil.copyfile(fasta_path, fa_dst)
        if os.path.abspath(gtf_path) != os.path.abspath(gtf_dst):
            shutil.copyfile(gtf_path, gtf_dst)
        return ReferencePackage._build_from(fa_dst, gtf_dst, out_dir,
                                            [genome_name], k, stride,
                                            sj_overhang, device)

    @staticmethod
    def _build_from(fa_dst: str, gtf_dst: str, out_dir: str,
                    genome_names: list[str], k: int, stride: int,
                    sj_overhang: int, device) -> "ReferencePackage":
        seqs = read_fasta(fa_dst)
        txome = Transcriptome.from_gtf(gtf_dst)
        gi = GenomeIndex.build(seqs, txome, k=k, stride=stride,
                               sj_overhang=sj_overhang, device=device)
        gi.save(os.path.join(out_dir, "index.npz"))
        meta = {
            "genomes": genome_names,
            "version": "cellranger-tpu-0.1.0",
            "input_fasta": os.path.basename(fa_dst),
            "input_gtf": os.path.basename(gtf_dst),
            "n_genes": len(txome.genes),
            "n_transcripts": len(txome.transcripts),
            "n_junctions": gi.n_junctions,
            "index_k": k,
            "index_stride": stride,
        }
        with open(os.path.join(out_dir, REFERENCE_JSON), "w") as f:
            json.dump(meta, f, indent=2)
        return ReferencePackage(out_dir, gi, txome, meta)

    @staticmethod
    def load(path: str) -> "ReferencePackage":
        with open(os.path.join(path, REFERENCE_JSON)) as f:
            meta = json.load(f)
        gi = GenomeIndex.load(os.path.join(path, "index.npz"))
        txome = Transcriptome.from_gtf(os.path.join(path, "genes", "genes.gtf"))
        return ReferencePackage(path, gi, txome, meta)
