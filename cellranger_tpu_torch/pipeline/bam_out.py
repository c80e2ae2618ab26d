"""Position-sorted BAM assembly for the count pipeline — the WRITE_POS_BAM
analog (lib/rust/cr_lib/src/stages/write_pos_bam.rs), without the
samtools-cat subprocess: per-batch alignment arrays are spooled to disk
(pipeline/bam_spool.py) as they stream off the device, into bands of
equal genomic span sized from pass 1's read count; the final write loads
one band at a time (a band past BAND_RECORDS is spooled again into parts
cut at its own sort keys, equal keys together), sorts it, encodes its
records in bulk (native/bam_host.py) and streams them through a BGZF
writer that compresses on threads and builds the .bai from arrays
(io/bam_fast.py).  Peak RAM is O(BAND_RECORDS), not O(run) nor O(one
chromosome), beside the index's 40 bytes a record — the per-chunk-BAM +
samtools-cat structure re-expressed.

Tag semantics (cr_bam/src/bam_tags.rs): CR/CY always; CB only when the
barcode is on the whitelist (possibly corrected); UR/UY always; UB for valid
UMIs (corrected per the dedup raw-triple views of EVERY partition — the r1
last-partition-only fallback is gone); GX/GN + RE on mapped reads; xf flags
mark conf-mapped / UMI-count / dup reads.

Copied from cellranger_tpu/pipeline/bam_out.py, which reaches jax through
its encode and GenomeIndex imports; this copy imports the port's.  That
package's write, one record at a time through `_write_rows` and the
verbatim copy of its pure-python BGZF writer, stays here as `write_plain`,
the plain version `write` is held to byte for byte.
"""

from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io.bam import (
    BAM_CMATCH, BAM_CREF_SKIP, BAM_CSOFT_CLIP, FLAG_FIRST_MATE,
    FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_PROPER_PAIR,
    FLAG_REVERSE, FLAG_SECOND_MATE, FLAG_SECONDARY, FLAG_UNMAPPED,
    XF_CONF_FEATURE, XF_CONF_MAPPED, XF_GENE_DISCORDANT, XF_LOW_SUPPORT_UMI,
    XF_UMI_COUNT)
from ..io.bam_fast import BgzfBamWriter
from ..io.bam_index import IndexingBamWriter as BamWriter
from ..io.gtf import Transcriptome
from .bam_spool import RecordSpool, concat_chunks, group_rows, take_rows
from .spill import lex3_join_np
from ..align.index import GenomeIndex
from ..native import bam_host
from ..native.strings import Strings
from ..ops import encode
from ..ops.encode import sorted_search

REGION_CHARS = {0: "E", 1: "I", 2: "N"}

# the last `write`'s split: seconds of spool load (load, join, sort;
# respool_s of it, the oversized bands spooled again in parts),
# representatives (each molecule partition's selection and the winners'
# flags), encode (waiting for the native encoder's threads), write
# (handing buffers to the BGZF writer and closing it; of it
# compress_wait, waiting for its threads, and index); compress_cpu (the
# compression threads' own seconds); the threads of each pool, records,
# stream bytes, blocks, the spool's bytes on disk; bands, the parts
# loaded, the rows of the largest (band_rows_max), the rows spooled again
LAST_SPLIT: dict = {}

# the records `write` holds at once: a band, or a part of one, is
# loaded, sorted and encoded whole.  Bands are cut at half of it from
# pass 1's read count (`BamCollector.plan`); a band that outgrows it
# (reads crowd a locus: chrM, a hot gene) is spooled again in parts cut
# at its own sort keys.  Read at run time.
BAND_RECORDS = 1 << 22
MAX_BANDS = 1024
REP_THREADS = 4             # molecule partitions flagged at once
_SRC_SHIFT = 40             # a record's id: source spool << 40 | row

_CHUNK_KEYS = ("rna", "rna_qual", "rna_len", "nmask", "bc_packed", "bc_qual",
               "umi_packed", "umi_valid", "umi_qual", "pos", "mapq", "strand",
               "aln_len", "aln_start", "mapped", "region", "gene", "conf_ok",
               "bc_ok", "corrected_bc", "bc_idx", "novel_sj", "sj_donor",
               "sj_acceptor", "sj_right_len", "mm", "gene_discordant",
               "gene_unpaired")
_CHUNK_KEYS_2D = ("gene_list", "anti_list")


class BamCollector:
    """Streams per-batch host arrays into a banded disk spool."""

    def __init__(self, gi: GenomeIndex, txome: Transcriptome,
                 spool_dir: str, read_group: str = "sample",
                 fresh: bool = True):
        self.gi = gi
        self.txome = txome
        self.read_group = read_group
        self.spool = RecordSpool(spool_dir, fresh=fresh)
        # multihost: other hosts' spool directories, merged at write time
        # (the per-chunk-BAM + samtools-cat structure of write_pos_bam.rs
        # :65-101, with bands instead of chunk files); every host cuts
        # the same bands (`plan` takes the run's total read count)
        self.sibling_dirs: list[str] = []
        # sort key = chrom << 33 | genomic pos (33 bits cover any chrom)
        self._chrom_starts = np.asarray(gi.chrom_starts, np.int64)
        meta = self.spool.meta
        # bands of equal span of the concatenated chromosomes, then the
        # unmapped band; the UMI_COUNT candidates spool to as many
        # partitions of (barcode, gene) so a molecule's reads share one;
        # one band until `plan` cuts them, a sealed spool's own on resume
        self.n_bands = int(meta.get("n_bands", 1))
        self.n_records = int(meta.get("n_records", 0))
        self.n_reads = int(meta.get("n_reads", 0))

    def plan(self, expected_records: int) -> None:
        """Cut the bands for a run of about expected_records records (from
        pass 1), each about half of BAND_RECORDS; before any row."""
        if self.n_records:
            raise RuntimeError("the bands are cut before the first record")
        self.n_bands = int(min(MAX_BANDS, max(
            1, -(-2 * int(expected_records) // BAND_RECORDS))))

    def seal(self) -> None:
        """Close the spool with its bands and counts (spool.json): a
        resumed run or host 0 reopens it with fresh=False."""
        self.spool.seal(dict(n_bands=self.n_bands, n_records=self.n_records,
                             n_reads=self.n_reads))

    def _band_of(self, key, mapped) -> np.ndarray:
        """Each record's band: its position along the concatenated
        chromosomes in n_bands equal spans (monotone in the sort key);
        unmapped records in band n_bands."""
        key = np.asarray(key, np.int64)
        mapped = np.asarray(mapped).astype(bool)
        starts = self._chrom_starts
        chrom = np.minimum(key >> 33, len(starts) - 2)
        lin = starts[np.maximum(chrom, 0)] + (key & ((1 << 33) - 1))
        span = max(int(starts[-1]), 1)
        band = np.clip(lin * self.n_bands // span, 0, self.n_bands - 1)
        return np.where(mapped, band, self.n_bands)

    @staticmethod
    def _rep_part(bc, gl, parts: int) -> np.ndarray:
        """A molecule's partition: a hash of (barcode, library gene)."""
        h = (np.asarray(bc).astype(np.uint64) * np.uint64(2654435761)
             + np.asarray(gl).astype(np.uint64))
        return (h % np.uint64(parts)).astype(np.int64)

    def _route(self, chunk: dict, n: int) -> None:
        """Spool a chunk whose sort keys are set: row ids, bands, the
        UMI_COUNT-candidate sidecar."""
        for k in ("names", "fr", "fq", "fb", "fx"):
            chunk[k] = Strings.of(chunk[k])
        chunk["rid"] = np.arange(self.n_records, self.n_records + n,
                                 dtype=np.int64)
        band = self._band_of(chunk["sort_key"], chunk["mapped"])
        self.spool.add("band", band, chunk)
        self._spool_rep_sidecar(band, chunk, n)
        self.n_records += n

    def _sort_keys(self, pos, aln_len, mapped):
        g = self.gi.pos_to_genomic(pos.astype(np.int64),
                                   aln_len.astype(np.int64))
        # unmapped sentinel chrom = chrom_count (fits the 33-bit-shift
        # layout; 2**31 would overflow int64 under the shift)
        key = np.where(mapped, g["chrom"].astype(np.int64),
                       len(self.gi.chrom_names)) * (1 << 33) \
            + np.where(mapped, g["gpos"], 0)
        return key, g

    def _spool_chunk(self, chunk, n):
        """Attach genomic sort keys + coordinates and band-spool a chunk."""
        # mate fields: neutral defaults so single-end / feature chunks can
        # share a band (and its concatenation) with paired-end chunks
        chunk.setdefault("pair_flag", np.zeros(n, np.int64))
        chunk.setdefault("mate_chrom", np.full(n, -1, np.int32))
        chunk.setdefault("mate_gpos", np.full(n, -1, np.int64))
        chunk.setdefault("tlen", np.zeros(n, np.int64))
        chunk.setdefault("umi_rep", np.ones(n, bool))
        chunk.setdefault("secondary", np.zeros(n, bool))
        key, g = self._sort_keys(chunk["pos"], chunk["aln_len"],
                                 chunk["mapped"])
        chunk["sort_key"] = key
        chunk["g_chrom"] = g["chrom"][:n].astype(np.int32)
        chunk["g_gpos"] = g["gpos"][:n].astype(np.int64)
        chunk["g_spliced"] = g["spliced"][:n].astype(bool)
        chunk["g_intron_len"] = g["intron_len"][:n].astype(np.int64)
        chunk["g_donor_off"] = g["donor_off"][:n].astype(np.int64)
        self._route(chunk, n)
        self.n_reads += n
        return chunk

    def _spool_secondary(self, prim_chunk, ho: dict, n: int):
        """Secondary alignment records for multimapped reads: one flagged
        (0x100) record per OTHER distinct best-score locus
        (tx_annotation/src/read.rs:155,224-226).  Secondary records carry
        CR/CY/UR/UY but no CB/UB/GX and no annotation tags (conf_ok and
        bc_ok are cleared); a rescued/promoted read's secondaries are
        demoted to MAPQ 0 (read.rs:152-156)."""
        sp = ho.get("sec_pos")
        if sp is None:
            return
        sok = np.asarray(ho["sec_ok"])[:n]
        for j in range(sp.shape[1]):
            idx = np.flatnonzero(sok[:, j])
            if not len(idx):
                continue
            sub = take_rows(prim_chunk, idx)
            ns = len(idx)
            sub.update(
                pos=np.asarray(ho["sec_pos"])[:n, j][idx],
                aln_len=np.asarray(ho["sec_len"])[:n, j][idx],
                aln_start=np.asarray(ho["sec_start"])[:n, j][idx],
                strand=np.asarray(ho["sec_strand"])[:n, j][idx],
                mapq=np.where(sub["mm"].astype(bool), 0, sub["mapq"]),
                mapped=np.ones(ns, bool),
                conf_ok=np.zeros(ns, bool), bc_ok=np.zeros(ns, bool),
                novel_sj=np.zeros(ns, np.int64),
                sj_donor=np.zeros(ns, np.int64),
                sj_acceptor=np.zeros(ns, np.int64),
                sj_right_len=np.zeros(ns, np.int64),
                mm=np.zeros(ns, np.int64),
                gene_discordant=np.zeros(ns, np.int64),
                gene_list=np.full((ns, 4), -1, np.int32),
                anti_list=np.full((ns, 4), -1, np.int32),
                umi_rep=np.zeros(ns, bool),
                secondary=np.ones(ns, bool))
            # drop keys _spool_chunk recomputes from pos/aln_len
            for k in ("sort_key", "g_chrom", "g_gpos", "g_spliced",
                      "g_intron_len", "g_donor_off", "rid"):
                sub.pop(k, None)
            self._spool_chunk(sub, ns)
            self.n_reads -= ns  # _spool_chunk counted them; keep read count
            self.n_secondary = getattr(self, "n_secondary", 0) + ns

    @staticmethod
    def _txomic(chunk):
        """Txomic rank for UmiSelectKey (mark_dups.rs:137-146
        is_conf_mapped_unique_txomic): conf-mapped + exonic.  Feature
        chunks carry region==0, so conf-counted feature reads rank equal
        (qname decides), as before."""
        return (chunk["conf_ok"].astype(bool)
                & (np.asarray(chunk["region"]) == 0))

    def _spool_rep_sidecar(self, band, chunk, n):
        """Sidecar of the UMI_COUNT candidates (conf-mapped, mate-1; the
        valid-UMI ones compete) in partitions of (barcode, gene), so the
        representative pass reads ~50B/read instead of re-deserializing
        the full record bands, and a molecule's reads in one partition;
        each row carries its record's id and band."""
        el = (np.asarray(chunk["conf_ok"]).astype(bool)
              & np.asarray(chunk["umi_rep"]).astype(bool))
        if not el.any():
            return
        idx = np.flatnonzero(el)
        sub = dict(
            bc=chunk["bc_idx"][idx].astype(np.uint32),
            gl=chunk["gene_lib"][idx].astype(np.uint32),
            umi=chunk["umi_packed"][idx].astype(np.uint32),
            txo=self._txomic(chunk)[idx],
            valid=np.asarray(chunk["umi_valid"])[idx].astype(bool),
            names=Strings.of(chunk["names"]).take(idx),
            rid=chunk["rid"][idx], band=np.asarray(band)[idx].astype(np.int32))
        self.spool.add("rep", self._rep_part(sub["bc"], sub["gl"],
                                             self.n_bands), sub)

    def add_batch(self, batch, ho: dict):
        """ho: host-side (numpy) step output dict for this batch.

        Paired-end chemistries (batch.rna2 + ho['pos2'] present) emit TWO
        records per read — both mates with 0x1/0x40/0x80 paired FLAG bits,
        mate RNEXT/PNEXT, and reference-span TLEN (write_pos_bam.rs emits
        every mate).  An improper pair is unmapped as a whole upstream, so
        both its records land in the unmapped band with 0x4|0x8 set."""
        n = batch.n_reads
        take = lambda a: np.asarray(a)[:n]
        chunk = dict(
            names=batch.names[:n] if batch.names else
                  [b"read%d" % i for i in batch.read_id[:n]],
            rna=take(batch.rna), rna_qual=take(batch.rna_qual),
            rna_len=take(batch.rna_len), nmask=take(batch.rna_nmask),
            bc_packed=take(batch.bc_packed), bc_qual=take(batch.bc_qual),
            umi_packed=take(batch.umi_packed), umi_valid=take(batch.umi_valid),
            umi_qual=take(batch.umi_qual))
        for k in _CHUNK_KEYS:
            if k not in chunk:
                src = ho.get(k)
                chunk[k] = (take(src) if src is not None
                            else np.zeros(n, np.int64))
        for k in _CHUNK_KEYS_2D:
            src = ho.get(k)
            chunk[k] = (take(src) if src is not None
                        else np.full((n, 4), -1, np.int32))
        chunk["is_feature"] = np.zeros(n, bool)
        # library-tagged gene: join key against the dedup raw-triple views
        chunk["gene_lib"] = take(ho.get("gene_lib", ho.get("gene"))) \
            .astype(np.uint32)
        for k in ("fr", "fq", "fb", "fx"):
            chunk[k] = Strings.empty(n)
        paired = "pos2" in ho and getattr(batch, "rna2", None) is not None
        if not paired:
            self._spool_chunk(chunk, n)
            self._spool_secondary(chunk, ho, n)
            return
        # ---- paired-end: build the mate-2 chunk and cross-link mates ----
        mapped = chunk["mapped"].astype(bool)
        chunk2 = dict(chunk)
        chunk2.update(
            rna=take(batch.rna2), rna_qual=take(batch.rna2_qual),
            rna_len=take(batch.rna2_len), nmask=take(batch.rna2_nmask),
            pos=take(ho["pos2"]).astype(np.int64),
            mapq=take(ho["mapq2"]), strand=take(ho["strand2"]),
            aln_len=take(ho["aln_len2"]), aln_start=take(ho["aln_start2"]),
            # mate-2 shares the pair-level gene/region annotation; SJ
            # discovery runs on mate 1 only
            novel_sj=np.zeros(n, np.int64))
        g1 = self.gi.pos_to_genomic(chunk["pos"].astype(np.int64),
                                    chunk["aln_len"].astype(np.int64))
        g2 = self.gi.pos_to_genomic(chunk2["pos"].astype(np.int64),
                                    chunk2["aln_len"].astype(np.int64))
        c1, p1 = g1["chrom"][:n].astype(np.int64), g1["gpos"][:n]
        c2, p2 = g2["chrom"][:n].astype(np.int64), g2["gpos"][:n]
        # reference span must match the written CIGAR: annotated-splice
        # reads span aln_len + intron; novel-SJ reads (mate 1 only) span
        # aln_len + discovered intron + right segment (see _write_rows)
        ann_spliced1 = g1["spliced"][:n] & (g1["intron_len"][:n] > 0)
        nsj1 = np.where(
            chunk["novel_sj"].astype(bool) & ~ann_spliced1,
            (chunk["sj_acceptor"] - chunk["sj_donor"])
            + chunk["sj_right_len"], 0)
        e1 = p1 + chunk["aln_len"] + np.where(
            g1["spliced"][:n], g1["intron_len"][:n], 0) + nsj1
        e2 = p2 + chunk2["aln_len"] + np.where(
            g2["spliced"][:n], g2["intron_len"][:n], 0)
        span = np.maximum(e1, e2) - np.minimum(p1, p2)
        same = mapped & (c1 == c2)
        tlen1 = np.where(same, np.where(p1 <= p2, span, -span), 0)
        base = FLAG_PAIRED | np.where(mapped, FLAG_PROPER_PAIR,
                                      FLAG_MATE_UNMAPPED)
        rev1 = (chunk["strand"] == 1)
        rev2 = (chunk2["strand"] == 1)
        chunk["pair_flag"] = (base | FLAG_FIRST_MATE
                              | np.where(mapped & rev2, FLAG_MATE_REVERSE, 0))
        chunk2["pair_flag"] = (base | FLAG_SECOND_MATE
                               | np.where(mapped & rev1, FLAG_MATE_REVERSE, 0))
        chunk["mate_chrom"] = np.where(mapped, c2, -1).astype(np.int32)
        chunk["mate_gpos"] = np.where(mapped, p2, -1)
        chunk["tlen"] = tlen1
        chunk2["mate_chrom"] = np.where(mapped, c1, -1).astype(np.int32)
        chunk2["mate_gpos"] = np.where(mapped, p1, -1)
        chunk2["tlen"] = -tlen1
        # only mate 1 is the molecule representative (UMI_COUNT eligible)
        chunk["umi_rep"] = np.ones(n, bool)
        chunk2["umi_rep"] = np.zeros(n, bool)
        self._spool_chunk(chunk, n)
        self._spool_chunk(chunk2, n)

    def add_feature_batch(self, batch, conf_ok, bc_ok, bc_idx, corrected_bc,
                          gene, fr, fq, fb_seq, fx,
                          seq_codes=None, seq_qual=None, seq_len=None,
                          seq_nmask=None, gene_lib=None):
        """Feature-barcode library reads: unmapped records carrying the
        fr/fq/fb/fx tags (read.rs:1335-1360 FeatureExtracted) and xf
        CONF_FEATURE when counted.  fr/fq/fb/fx: per-read bytes (b'' =
        omit the tag).  seq_*: the read content to emit (defaults to the
        batch's rna planes)."""
        n = batch.n_reads
        take = lambda a: np.asarray(a)[:n]
        z = lambda: np.zeros(n, np.int64)
        chunk = {k: z() for k in _CHUNK_KEYS}
        chunk.update(dict(
            names=batch.names[:n] if batch.names else
                  [b"read%d" % i for i in batch.read_id[:n]],
            rna=take(seq_codes if seq_codes is not None else batch.rna),
            rna_qual=take(seq_qual if seq_qual is not None
                          else batch.rna_qual),
            rna_len=take(seq_len if seq_len is not None else batch.rna_len),
            nmask=take(seq_nmask if seq_nmask is not None
                       else batch.rna_nmask),
            bc_packed=take(batch.bc_packed), bc_qual=take(batch.bc_qual),
            umi_packed=take(batch.umi_packed),
            umi_valid=take(batch.umi_valid), umi_qual=take(batch.umi_qual),
            mapped=np.zeros(n, bool), conf_ok=take(conf_ok),
            bc_ok=take(bc_ok), bc_idx=take(bc_idx),
            corrected_bc=take(corrected_bc), gene=take(gene),
            fr=list(fr[:n]), fq=list(fq[:n]), fb=list(fb_seq[:n]),
            fx=list(fx[:n]),
            sort_key=np.zeros(n, np.int64),
            g_chrom=np.zeros(n, np.int32), g_gpos=np.zeros(n, np.int64),
            g_spliced=np.zeros(n, bool), g_intron_len=np.zeros(n, np.int64),
            g_donor_off=np.zeros(n, np.int64),
        ))
        for k in _CHUNK_KEYS_2D:
            chunk[k] = np.full((n, 4), -1, np.int32)
        chunk["is_feature"] = np.ones(n, bool)
        chunk["gene_lib"] = take(gene_lib if gene_lib is not None
                                 else gene).astype(np.uint32)
        chunk["pair_flag"] = np.zeros(n, np.int64)
        chunk["mate_chrom"] = np.full(n, -1, np.int32)
        chunk["mate_gpos"] = np.full(n, -1, np.int64)
        chunk["tlen"] = np.zeros(n, np.int64)
        chunk["umi_rep"] = np.ones(n, bool)
        chunk["secondary"] = np.zeros(n, bool)
        self._route(chunk, n)
        self.n_reads += n

    def _header(self) -> tuple:
        """(reference names, lengths, @RG line) of the BAM's header."""
        gi = self.gi
        rg_header = f"@RG\tID:{self.read_group}\tSM:{self.read_group}\n"
        return (gi.chrom_names, list(np.diff(gi.chrom_starts).astype(int)),
                rg_header)

    def _sources(self) -> list:
        """This spool, then each sibling host's sealed spool; all cut the
        same bands."""
        sources = [self.spool] + [RecordSpool(d, fresh=False)
                                  for d in self.sibling_dirs]
        cuts = {int(s_.meta.get("n_bands", self.n_bands)) for s_ in sources}
        if cuts != {self.n_bands}:
            raise ValueError(f"the hosts' spools cut {sorted(cuts)} bands, "
                             f"this one {self.n_bands}")
        return sources

    def _band_chunks(self, name: str, sources=None):
        """The chunks of spool file `name` of every source, this spool's
        first; each record id (`rid`) tagged with its source's index."""
        for k, src in enumerate(sources or self._sources()):
            for c in src.iter(name):
                if "rid" in c:
                    c["rid"] = c["rid"] | (k << _SRC_SHIFT)
                yield c

    def _load_band(self, band: int, views: tuple):
        """One band's columns (this spool's chunks, then each sibling
        directory's) with each record's corrected UMI and low-support
        flag from the raw-triple views; None for an empty band."""
        rb, rg, ru, rc, rl = views
        chunks = list(self._band_chunks(f"band{band}"))
        if not chunks:
            return None
        cat = concat_chunks(chunks)
        # corrected-UMI / low-support join against the raw-triple views
        gl = cat.get("gene_lib", cat["gene"]).astype(np.uint32)
        if len(rb):
            jidx, jfound = lex3_join_np(
                rb, rg, ru, cat["bc_idx"].astype(np.uint32),
                gl, cat["umi_packed"])
            corr_umi = np.where(jfound, rc[jidx],
                                cat["umi_packed"].astype(np.uint32))
            low_sup = jfound & rl[jidx]
        else:
            corr_umi = cat["umi_packed"].astype(np.uint32)
            low_sup = np.zeros(len(corr_umi), bool)
        return cat, corr_umi, low_sup

    def write(self, path: str, raw_views: dict, bc_len: int, umi_len: int,
              gem_group: int = 1):
        """The position-sorted BAM and its .bai.  raw_views: concatenated
        dedup raw-triple views across ALL dedup partitions
        (raw_bc/raw_gene/raw_umi/raw_corr_umi/raw_low arrays of distinct
        conf-mapped triples).

        The UMI_COUNT winners are chosen a molecule partition at a time
        and their records' ids filed by band.  Then each band (or each
        part of one past BAND_RECORDS) is loaded, joined to the views'
        index, sorted, encoded in bulk by the native encoder
        (native/bam_host.py) and written by io/bam_fast.py's writer, whose
        threads compress one buffer's blocks while the next is encoded;
        the next part loads on a thread meanwhile, so two parts are held
        at most.  The bytes are those of `write_plain`.  LAST_SPLIT holds
        the seconds of the parts (the loading thread's among them) and
        the sizes."""
        LAST_SPLIT.clear()
        budget = max(1, int(BAND_RECORDS))
        sources = self._sources()
        split = dict(spool_load_s=0.0, respool_s=0.0, representatives_s=0.0,
                     encode_s=0.0, write_s=0.0,
                     spool_bytes=sum(s_.bytes_on_disk() for s_ in sources),
                     bands=self.n_bands + 1, parts=0, band_rows_max=0,
                     respooled_rows=0, band_records=budget)
        w = BgzfBamWriter(path, *self._header())
        # half the cores encode, while all of them compress
        encode_threads = max(1, w.threads // 2)
        records = 0
        work = os.path.join(self.spool.dir, "_write")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        if self.n_reads or self.sibling_dirs:
            t = time.perf_counter()
            vindex = _ViewIndex(_raw_views(raw_views))
            self._file_winners(vindex, work, sources)
            split["representatives_s"] += time.perf_counter() - t
            self._build_tx_tables()
            tables = bam_host.run_tables(
                self.read_group, gem_group, bc_len, umi_len,
                [g_.id for g_ in self.txome.genes],
                [g_.name for g_ in self.txome.genes], self._gene_txs)
            for cat, corr_umi, low_sup, win_idx, winners, order in _ahead(
                    self._prepared_parts(vindex, work, sources, budget,
                                         split)):
                recs_of = bam_host.encode_band(
                    tables, cat, corr_umi, low_sup, win_idx, order,
                    encode_threads, winners)
                while True:
                    t = time.perf_counter()
                    recs = next(recs_of, None)
                    t1 = time.perf_counter()
                    split["encode_s"] += t1 - t
                    if recs is None:
                        break
                    w.write_records(*recs)
                    split["write_s"] += time.perf_counter() - t1
                records += len(order)
                split["parts"] += 1
                split["band_rows_max"] = max(split["band_rows_max"],
                                             len(order))
        t = time.perf_counter()
        w.close()
        split["write_s"] += time.perf_counter() - t
        self.spool.close()
        LAST_SPLIT.update(
            split, compress_wait_s=w.wait_s, compress_cpu_s=w.compress_cpu_s,
            index_s=w.index_s, threads=w.threads,
            encode_threads=encode_threads, records=records,
            stream_bytes=w._stream, blocks=len(w._block_at) - 1)

    def _prepared_parts(self, vindex, work: str, sources, budget: int,
                        split: dict):
        """Each part of each band, in order, ready for the encoder: its
        columns, corrected UMIs and low-support flags, UMI_COUNT winners
        and sort order."""
        for band in range(self.n_bands + 1):
            rows = sum(s_.rows.get(f"band{band}", 0) for s_ in sources)
            if not rows:
                continue
            won = os.path.join(work, f"win{band}")
            wins = np.sort(np.fromfile(won, np.int64) if os.path.exists(won)
                           else np.zeros(0, np.int64))
            parts = self._band_parts(band, rows, budget, work, sources, split)
            while True:
                t = time.perf_counter()
                chunks = next(parts, None)
                if chunks is None:
                    break
                cat = concat_chunks(chunks)
                corr_umi, low_sup = vindex.join(cat)
                # a spool without the column holds no secondary record, as
                # `_write_rows` reads it
                cat.setdefault("secondary", np.zeros(len(corr_umi), bool))
                order = np.argsort(cat["sort_key"], kind="stable")
                t1 = time.perf_counter()
                split["spool_load_s"] += t1 - t
                win_idx, winners = _band_winners(cat, wins)
                split["representatives_s"] += time.perf_counter() - t1
                yield cat, corr_umi, low_sup, win_idx, winners, order

    def _band_parts(self, band: int, rows: int, budget: int, work: str,
                    sources, split: dict):
        """The chunks of one band, in parts of at most `budget` records:
        the band whole when it fits; else spooled again into parts cut at
        its own sort keys (equal keys in one part, each part's records in
        spool order), a part of one key past the budget given in pieces
        of spool order, which its sort leaves as they are."""
        name = f"band{band}"
        if rows <= budget:
            yield list(self._band_chunks(name, sources))
            return
        t = time.perf_counter()
        keys, cnt = np.unique(np.concatenate(
            [c["sort_key"] for c in self._band_chunks(name, sources)]),
            return_counts=True)
        part_of = _cut_parts(cnt, budget)
        parts = RecordSpool(os.path.join(work, name))
        for c in self._band_chunks(name, sources):
            parts.add("part", part_of[np.searchsorted(keys, c["sort_key"])],
                      c)
        parts.flush()
        split["respool_s"] += time.perf_counter() - t
        split["respooled_rows"] += rows
        single = np.bincount(part_of) == 1     # parts of one sort key
        try:
            for p in range(int(part_of[-1]) + 1):
                n = parts.rows.get(f"part{p}", 0)
                if n and (n <= budget or not single[p]):
                    yield list(parts.iter(f"part{p}"))
                elif n:
                    yield from _pieces(parts.iter(f"part{p}"), budget)
        finally:
            parts.close()

    def _file_winners(self, vindex, work: str, sources) -> None:
        """The UMI_COUNT flags, a molecule partition of the sidecar at a
        time on a few threads: the ids of the records whose (raw UMI,
        not_txomic, qname) equal their molecule's winner's
        (`_winner_flags`), appended to work/win<band>."""
        def flagged(p):
            chunks = list(self._band_chunks(f"rep{p}", sources))
            if not chunks:
                return None
            cat = concat_chunks(chunks)
            won = np.flatnonzero(_winner_flags(cat, vindex))
            return cat["band"][won], cat["rid"][won]

        files: dict = {}
        try:
            with ThreadPoolExecutor(REP_THREADS) as pool:
                for res in pool.map(flagged, range(self.n_bands)):
                    if res is None:
                        continue
                    for b, idx in group_rows(res[0]):
                        f = files.get(b)
                        if f is None:
                            f = files[b] = open(
                                os.path.join(work, f"win{b}"), "ab")
                        f.write(res[1][idx].tobytes())
        finally:
            for f in files.values():
                f.close()

    def write_plain(self, path: str, raw_views: dict, bc_len: int,
                    umi_len: int, gem_group: int = 1):
        """The plain version of `write`: every record through `_write_rows`
        and io/bam_index.py's IndexingBamWriter, one at a time, each band
        loaded whole.  Tests and chip_smoke.py hold `write` to it; the run
        does not call it.  The spool stays open (a test writes it again
        with `write`)."""
        w = BamWriter(path, *self._header())
        if self.n_reads == 0 and not self.sibling_dirs:
            w.close()
            return
        gene_ids = [g_.id for g_ in self.txome.genes]
        gene_names = [g_.name for g_ in self.txome.genes]
        self._gene_ids = gene_ids
        self._build_tx_tables()
        views = _raw_views(raw_views)
        # ---- pass A: the UMI_COUNT representative of each molecule is the
        # read with min (raw UMI, utype, qname) among its conf-mapped reads
        # (mark_dups.rs:110-114 UmiSelectKey orders Txomic < NonTxomic
        # before the qname tie-break; :252-265 rekeyed to the min raw UMI
        # correcting into the molecule; mate-1 records only).
        rep = self._rep_dict(self._select_representatives(*views))
        for band in range(self.n_bands + 1):
            r = self._load_band(band, views)
            if r is None:
                continue
            cat, corr_umi, low_sup = r
            order = np.argsort(cat["sort_key"], kind="stable")
            self._write_rows(w, cat, order, corr_umi, low_sup, rep,
                             gene_ids, gene_names, bc_len, umi_len, gem_group)
        w.close()

    @staticmethod
    def _rep_key(bc: int, gl: int, cu: int) -> int:
        return (bc << 64) | (gl << 32) | cu

    @classmethod
    def _rep_dict(cls, winners) -> dict:
        """The plain version's winners: packed (bc, gene_lib, corr_umi)
        key -> hash of the winning (raw_umi, not_txomic, qname)."""
        bc, gl, cu, um, ntxo, nm = winners
        return {cls._rep_key(int(bc[i]), int(gl[i]), int(cu[i])):
                hash((int(um[i]), int(ntxo[i]), bytes(nm[i])))
                for i in range(len(bc))}

    def _select_representatives(self, rb, rg, ru, rc, rl) -> tuple:
        """The plain version's per-molecule UMI_COUNT winner, from the
        sidecar spool (not the full bands): per partition one lexsort +
        group-first, merged across partitions by a second lexsort.
        Returns the winners as arrays (bc, gene_lib, corr_umi, raw_umi,
        not_txomic, qname), sorted by (bc, gene_lib, corr_umi), one row
        a molecule."""
        winners: list[tuple] = []
        for part in range(self.n_bands):
            chunks = list(self._band_chunks(f"rep{part}"))
            if not chunks:
                continue
            valid = np.concatenate([c["valid"] for c in chunks])
            bc = np.concatenate([c["bc"] for c in chunks])[valid]
            gl = np.concatenate([c["gl"] for c in chunks])[valid]
            um = np.concatenate([c["umi"] for c in chunks])[valid]
            txo = np.concatenate([c["txo"] for c in chunks])[valid]
            names = [n_ for c in chunks for n_ in c["names"].tolist()]
            names = [n_ for n_, v in zip(names, valid) if v]
            if len(rb):
                jidx, jfound = lex3_join_np(rb, rg, ru, bc, gl, um)
                cu = np.where(jfound, rc[jidx], um)
                keep = ~(jfound & rl[jidx])
            else:
                cu = um
                keep = np.ones(len(um), bool)
            if not keep.any():
                continue
            nm = np.asarray(names, dtype=bytes)[keep]
            bc, gl, cu, um = bc[keep], gl[keep], cu[keep], um[keep]
            ntxo = (~txo[keep].astype(bool)).astype(np.uint8)
            order = np.lexsort((nm, ntxo, um, cu, gl, bc))
            bc, gl, cu, um, ntxo, nm = (x[order]
                                        for x in (bc, gl, cu, um, ntxo, nm))
            first = np.ones(len(bc), bool)
            first[1:] = ((bc[1:] != bc[:-1]) | (gl[1:] != gl[:-1])
                         | (cu[1:] != cu[:-1]))
            winners.append(tuple(x[first]
                                 for x in (bc, gl, cu, um, ntxo, nm)))
        if not winners:
            return (np.zeros(0, np.uint32),) * 4 + (np.zeros(0, np.uint8),
                                                    np.zeros(0, "S1"))
        width = max(w[5].dtype.itemsize for w in winners)
        bc, gl, cu, um, ntxo = (np.concatenate([w[j] for w in winners])
                                for j in range(5))
        nm = np.concatenate([w[5].astype(f"S{width}") for w in winners])
        order = np.lexsort((nm, ntxo, um, cu, gl, bc))
        bc, gl, cu, um, ntxo, nm = (x[order]
                                    for x in (bc, gl, cu, um, ntxo, nm))
        first = np.ones(len(bc), bool)
        first[1:] = ((bc[1:] != bc[:-1]) | (gl[1:] != gl[:-1])
                     | (cu[1:] != cu[:-1]))
        return tuple(x[first] for x in (bc, gl, cu, um, ntxo, nm))

    def _build_tx_tables(self):
        """Per-gene transcript projection tables: gene index -> list of
        (tx_id, chrom_idx, tx_reverse, exon_starts, exon_ends, cum_len,
        tx_len), chrom-relative genomic coordinates."""
        chrom_idx = {c if isinstance(c, str) else c.decode(): i
                     for i, c in enumerate(self.gi.chrom_names)}
        self._gene_txs: dict = {}
        for t in self.txome.transcripts:
            starts = np.asarray([s for s, _ in t.exons], np.int64)
            ends = np.asarray([e for _, e in t.exons], np.int64)
            lens = ends - starts
            cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
            rec = (t.id, chrom_idx.get(t.chrom, -1), t.strand == "-",
                   starts, ends, cum, int(lens.sum()))
            self._gene_txs.setdefault(t.gene_index, []).append(rec)

    @staticmethod
    def _project_tx(rec, chrom: int, segs, lclip: int, rclip: int):
        """Project a read's genomic aligned segments onto one transcript
        (transcript.rs:436 align_to_transcript): every segment must sit
        inside an exon and consecutive segments must split exactly at the
        transcript's exon junctions.  Returns 'pos,cigar' in transcript
        coordinates or None if incompatible."""
        tx_id, tx_chrom, tx_rev, starts, ends, cum, tx_len = rec
        if chrom != tx_chrom:
            return None
        idxs = []
        for s, e in segs:
            i = int(np.searchsorted(starts, s, side="right")) - 1
            if i < 0 or e > ends[i] or s < starts[i]:
                return None
            idxs.append(i)
        for k in range(len(segs) - 1):
            # junction between segment k and k+1 must be this exon junction
            if (segs[k][1] != ends[idxs[k]] or idxs[k + 1] != idxs[k] + 1
                    or segs[k + 1][0] != starts[idxs[k + 1]]):
                return None
        tx_pos = int(cum[idxs[0]] + (segs[0][0] - starts[idxs[0]]))
        aligned = int(sum(e - s for s, e in segs))
        if tx_rev:
            tx_pos = tx_len - (tx_pos + aligned)
            lclip, rclip = rclip, lclip
        cig = (f"{lclip}S" if lclip else "") + f"{aligned}M" \
            + (f"{rclip}S" if rclip else "")
        return f"{tx_pos},{cig}"

    def _gene_set_tag(self, genes_row, chrom: int, segs, lclip: int,
                      rclip: int, antisense: bool) -> bytes:
        """TX/AN tag payload (transcript.rs:163-174): ';'-joined entries —
        'tx_id,{strand}{pos},{cigar}' per splice-compatible transcript,
        falling back to the 'gene_id,{strand}' gene form when no transcript
        of the gene projects (intronic reads).  strand is the alignment
        orientation relative to the transcript: '+' for sense (TX), '-'
        for antisense (AN)."""
        strand_c = "-" if antisense else "+"
        parts = []
        for g in sorted(int(x) for x in genes_row if x >= 0):
            hit = False
            if segs is not None:
                for rec in self._gene_txs.get(g, ()):
                    p = self._project_tx(rec, chrom, segs, lclip, rclip)
                    if p is not None:
                        parts.append(f"{rec[0]},{strand_c}{p}")
                        hit = True
            if not hit:
                gid = self._gene_ids[g]
                gid = gid if isinstance(gid, str) else gid.decode()
                parts.append(f"{gid},{strand_c}")
        return ";".join(sorted(parts)).encode()

    def _write_rows(self, w, cat, order, corr_umi_arr, low_arr, rep,
                    gene_ids, gene_names, bc_len, umi_len, gem_group):
        """The plain version of the native encoder: each record's fields,
        tags and write_record call in Python, one record at a time."""
        mapped = cat["mapped"].astype(bool)
        sec_col = cat.get("secondary")
        secondary = (np.asarray(sec_col).astype(bool) if sec_col is not None
                     else np.zeros(len(mapped), bool))
        for i in order:
            L = int(cat["rna_len"][i])
            st = int(cat["strand"][i])
            codes = cat["rna"][i][:L]
            nm = cat["nmask"][i][:L]
            seq = encode.decode_codes(codes, nm)
            qual = bytes(cat["rna_qual"][i][:L])
            if st == 1:
                seq = seq.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]
                qual = qual[::-1]

            raw_bc_s = encode.decode_codes(
                encode.unpack_np(cat["bc_packed"][i], bc_len))
            bq = bytes(cat["bc_qual"][i])
            umi_s = encode.decode_codes(
                encode.unpack_np(cat["umi_packed"][i], umi_len))
            uq = bytes(cat["umi_qual"][i][:umi_len])
            tags = [("RG", "Z", self.read_group.encode()),
                    ("CR", "Z", raw_bc_s), ("CY", "Z", bq),
                    ("UR", "Z", umi_s), ("UY", "Z", uq)]
            if cat["bc_ok"][i]:
                cb = encode.decode_codes(
                    encode.unpack_np(cat["corrected_bc"][i], bc_len))
                tags.append(("CB", "Z", cb + b"-%d" % gem_group))

            xf = 0
            flag = int(cat["pair_flag"][i])
            mate_ref = int(cat["mate_chrom"][i])
            mate_pos = int(cat["mate_gpos"][i])
            tlen = int(cat["tlen"][i])
            if not mapped[i]:
                if cat["is_feature"][i]:
                    # feature-barcode library read (FeatureExtracted tags)
                    for tg, val in (("fr", cat["fr"][i]), ("fq", cat["fq"][i]),
                                    ("fb", cat["fb"][i]), ("fx", cat["fx"][i])):
                        if val:
                            tags.append((tg, "Z", val))
                    if cat["conf_ok"][i]:
                        xf |= XF_CONF_FEATURE
                        cu = int(corr_umi_arr[i])
                        if cat["umi_valid"][i]:
                            tags.append(("UB", "Z", encode.decode_codes(
                                encode.unpack_np(np.uint32(cu), umi_len))))
                        if low_arr[i]:
                            xf |= XF_LOW_SUPPORT_UMI
                        else:
                            mol_key = self._rep_key(
                                int(cat["bc_idx"][i]),
                                int(cat["gene_lib"][i]), cu)
                            ntxo = 0 if int(cat["region"][i]) == 0 else 1
                            if rep.get(mol_key) == hash(
                                    (int(cat["umi_packed"][i]), ntxo,
                                     cat["names"][i])):
                                xf |= XF_UMI_COUNT
                # every record carries xf (unmapped non-feature: 0)
                tags.append(("xf", "i", xf))
                w.write_record(cat["names"][i], flag | FLAG_UNMAPPED,
                               -1, -1, 0, [], seq, qual, tags,
                               next_ref=mate_ref, next_pos=mate_pos)
                continue
            if st == 1:
                flag |= FLAG_REVERSE
            chrom = int(cat["g_chrom"][i])
            gpos = int(cat["g_gpos"][i])
            alen = int(cat["aln_len"][i])
            astart = int(cat["aln_start"][i])
            if secondary[i]:
                # flagged secondary locus of a multimapped read: CIGAR +
                # position only, no annotation/molecule tags, xf 0
                # (read.rs:155,224-226)
                cig = []
                if astart:
                    cig.append((astart, BAM_CSOFT_CLIP))
                cig.append((alen, BAM_CMATCH))
                rclip = L - astart - alen
                if rclip > 0:
                    cig.append((rclip, BAM_CSOFT_CLIP))
                w.write_record(cat["names"][i], flag | FLAG_SECONDARY,
                               chrom, gpos, int(cat["mapq"][i]), cig, seq,
                               qual, tags + [("xf", "i", 0)],
                               next_ref=mate_ref, next_pos=mate_pos,
                               tlen=tlen)
                continue
            cig = []
            if astart:
                cig.append((astart, BAM_CSOFT_CLIP))
            if cat["g_spliced"][i] and cat["g_intron_len"][i] > 0:
                d = int(cat["g_donor_off"][i])
                cig += [(d, BAM_CMATCH),
                        (int(cat["g_intron_len"][i]), BAM_CREF_SKIP),
                        (alen - d, BAM_CMATCH)]
                rclip = L - astart - alen
            elif cat["novel_sj"][i]:
                # discovered junction: left M, intron N, right M
                intron = int(cat["sj_acceptor"][i]) - int(cat["sj_donor"][i])
                rlen = int(cat["sj_right_len"][i])
                cig += [(alen, BAM_CMATCH), (intron, BAM_CREF_SKIP),
                        (rlen, BAM_CMATCH)]
                rclip = L - astart - alen - rlen
            else:
                cig.append((alen, BAM_CMATCH))
                rclip = L - astart - alen
            if rclip > 0:
                cig.append((rclip, BAM_CSOFT_CLIP))

            gene = int(cat["gene"][i])
            region = REGION_CHARS[int(cat["region"][i])]
            tags.append(("RE", "A", region))
            # TX / AN transcript-projected tags (transcript.rs:436).  The
            # read's genomic aligned segments; novel-SJ reads fall back to
            # the gene form (their junction lives in packed coordinates)
            gp = int(cat["g_gpos"][i])
            al = int(cat["aln_len"][i])
            if cat["novel_sj"][i]:
                segs = None
            elif cat["g_spliced"][i] and cat["g_intron_len"][i] > 0:
                d = int(cat["g_donor_off"][i])
                il = int(cat["g_intron_len"][i])
                segs = [(gp, gp + d), (gp + d + il, gp + al + il)]
            else:
                segs = [(gp, gp + al)]
            lclip = astart
            rcl = max(L - astart - al, 0)
            tx = self._gene_set_tag(cat["gene_list"][i], chrom, segs,
                                    lclip, rcl, antisense=False)
            if tx:
                tags.append(("TX", "Z", tx))
            an = self._gene_set_tag(cat["anti_list"][i], chrom, segs,
                                    lclip, rcl, antisense=True)
            if an:
                tags.append(("AN", "Z", an))
            if cat["mm"][i]:
                # rescued/promoted multimapper (read.rs:1247-1249)
                tags.append(("mm", "i", 1))
            if cat["gene_discordant"][i]:
                xf |= XF_GENE_DISCORDANT
                gu = int(cat["gene_unpaired"][i])
                if gu >= 0:
                    tags.append(("gX", "Z", gene_ids[gu]))
                    tags.append(("gN", "Z", gene_names[gu]))
            if cat["conf_ok"][i]:
                tags.append(("GX", "Z", gene_ids[gene]))
                tags.append(("GN", "Z", gene_names[gene]))
                xf |= XF_CONF_MAPPED
                cu = int(corr_umi_arr[i])
                if cat["umi_valid"][i]:
                    ub = encode.decode_codes(encode.unpack_np(
                        np.uint32(cu), umi_len))
                    tags.append(("UB", "Z", ub))
                if low_arr[i]:
                    xf |= XF_LOW_SUPPORT_UMI
                elif cat["umi_rep"][i]:
                    mol_key = self._rep_key(int(cat["bc_idx"][i]),
                                            int(cat["gene_lib"][i]), cu)
                    ntxo = 0 if int(cat["region"][i]) == 0 else 1
                    if rep.get(mol_key) == hash(
                            (int(cat["umi_packed"][i]), ntxo,
                             cat["names"][i])):
                        xf |= XF_UMI_COUNT
                    # a duplicate is CONF_MAPPED without UMI_COUNT (no
                    # separate flag in the reference's ExtraFlags)
            w.write_record(cat["names"][i], flag, chrom, gpos,
                           int(cat["mapq"][i]), cig, seq, qual,
                           tags + [("xf", "i", xf)],
                           next_ref=mate_ref, next_pos=mate_pos, tlen=tlen)


def _raw_views(raw_views: dict) -> tuple:
    """(raw_bc, raw_gene, raw_umi, raw_corr_umi, raw_low) arrays."""
    return tuple(np.asarray(raw_views.get(k, np.zeros(0, dt))) for k, dt in (
        ("raw_bc", np.uint32), ("raw_gene", np.uint32), ("raw_umi", np.uint32),
        ("raw_corr_umi", np.uint32), ("raw_low", bool)))


def _ahead(items):
    """The items of an iterator, each made on a thread while the one
    before it is used (the next part of the BAM loads while this one is
    encoded and compressed)."""
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(next, items, None)
        while True:
            item = fut.result()
            if item is None:
                return
            fut = pool.submit(next, items, None)
            yield item


def _cut_parts(cnt: np.ndarray, budget: int) -> np.ndarray:
    """The part of each distinct sort key (cnt: records a key, in key
    order): runs of keys of at most `budget` records, a part starting
    where the running count crosses a multiple of budget // 2; a key of
    more than budget // 2 records is a part alone."""
    half = max(1, budget // 2)
    run = (np.cumsum(cnt) - cnt) // half
    big = cnt > half
    new = np.ones(len(cnt), bool)
    new[1:] = (run[1:] != run[:-1]) | big[1:] | big[:-1]
    return np.cumsum(new) - 1


def _pieces(chunks, budget: int):
    """Lists of chunks of at most `budget` records, in order, a chunk cut
    where a piece fills."""
    held, n = [], 0
    for c in chunks:
        m, at = len(c["rid"]), 0
        while at < m:
            k = min(m - at, budget - n)
            held.append(c if k == m else take_rows(c, np.arange(at, at + k)))
            n += k
            at += k
            if n == budget:
                yield held
                held, n = [], 0
    if held:
        yield held


class _ViewIndex:
    """`lex3_join_np` against the whole raw-triple views as one sort of
    the views and a binary search a query, the same (idx, found) for the
    views in any order: the join takes, for a query, the view row of
    largest index among those at or below its triple in (barcode, gene,
    UMI) order (its running maximum), found when that row is the
    query's triple.  The views come in dedup-partition order, not
    sorted, so a part of a band joined to a subset of them would not
    find what the whole join finds."""

    def __init__(self, views: tuple):
        self.views = views
        rb, rg, ru = views[:3]
        k1 = (rb.astype(np.uint64) << np.uint64(32)) | rg.astype(np.uint64)
        order = np.lexsort((ru, k1))
        k1 = k1[order]
        self.pairs = np.unique(k1)
        rank = np.searchsorted(self.pairs, k1).astype(np.int64)
        del k1
        self.keys = (rank << 32) | ru[order].astype(np.int64)
        self.last = np.maximum.accumulate(order)

    def lookup(self, qb, qg, qu) -> tuple:
        """(idx into the views, found) of each query triple (uint32)."""
        n = len(qb)
        if not len(self.keys) or not n:
            return np.zeros(n, np.int64), np.zeros(n, bool)
        qb, qg, qu = (np.asarray(x).astype(np.uint32) for x in (qb, qg, qu))
        k1 = (qb.astype(np.uint64) << np.uint64(32)) | qg.astype(np.uint64)
        r = sorted_search(self.pairs, k1)
        hit = self.pairs[np.minimum(r, len(self.pairs) - 1)] == k1
        r = r << 32
        j = sorted_search(self.keys, np.where(hit, r | qu, r - 1),
                          "right") - 1
        cand = np.where(j >= 0, self.last[np.maximum(j, 0)], -1)
        cc = np.maximum(cand, 0)
        rb, rg, ru = self.views[:3]
        found = ((cand >= 0) & (rb[cc] == qb) & (rg[cc] == qg)
                 & (ru[cc] == qu))
        return cc, found

    def join(self, cat: dict) -> tuple:
        """Each record's corrected UMI and low-support flag as
        `_load_band` gives them, where the record is conf-mapped (the
        encoder reads them nowhere else); its own UMI and False
        elsewhere."""
        umi = np.asarray(cat["umi_packed"]).astype(np.uint32)
        corr = umi.copy()
        low = np.zeros(len(umi), bool)
        conf = np.flatnonzero(np.asarray(cat["conf_ok"]).astype(bool))
        jidx, jfound = self.lookup(np.asarray(cat["bc_idx"])[conf],
                                   np.asarray(cat["gene_lib"])[conf],
                                   umi[conf])
        corr[conf] = np.where(jfound, self.views[3][jidx], umi[conf])
        low[conf] = jfound & self.views[4][jidx]
        return corr, low


def _winner_flags(cat: dict, vindex: _ViewIndex) -> np.ndarray:
    """The sidecar rows (one molecule partition, `cat`) whose record gets
    UMI_COUNT: not low-support, and (raw UMI, not_txomic, qname) equal to
    its molecule's winner's, the min of that key among the molecule's
    valid-UMI rows (the plain version's rep[key] == hash(...), exactly).
    One lexsort by (molecule, invalid, raw UMI, not_txomic, qname) puts
    each molecule's winner first, where it has a valid row."""
    jidx, jfound = vindex.lookup(cat["bc"], cat["gl"], cat["umi"])
    keep = np.flatnonzero(~(jfound & vindex.views[4][jidx]))
    out = np.zeros(len(jidx), bool)
    if not len(keep):
        return out
    u64 = lambda a: np.asarray(a)[keep].astype(np.uint64)  # noqa: E731
    um = u64(cat["umi"])
    cu = np.where(jfound[keep], vindex.views[3][jidx[keep]].astype(np.uint64),
                  um)
    ntxo = u64(~np.asarray(cat["txo"]).astype(bool))
    mol = (u64(cat["bc"]) << np.uint64(32)) | u64(cat["gl"])
    sub = (cu << np.uint64(1)) | u64(~np.asarray(cat["valid"]).astype(bool))
    tie = (um << np.uint64(1)) | ntxo
    words = cat["names"].take(keep).words()
    order = np.lexsort([words[:, j] for j in reversed(range(words.shape[1]))]
                       + [tie, sub, mol])
    m, c_ = mol[order], cu[order]
    start = np.ones(len(order), bool)
    start[1:] = (m[1:] != m[:-1]) | (c_[1:] != c_[:-1])
    first = order[np.maximum.accumulate(
        np.where(start, np.arange(len(order)), 0))]
    won = (((sub[first] & np.uint64(1)) == 0) & (tie[order] == tie[first])
           & (words[order] == words[first]).all(1))
    out[keep[order[won]]] = True
    return out


def _band_winners(cat: dict, wins: np.ndarray) -> tuple:
    """The encoder's UMI_COUNT inputs for a part of a band: each record's
    row (-1: none) among the part's winners, and those winners' (raw UMI,
    not_txomic, qname) — the flagged records' own (`wins`: the band's
    flagged ids, sorted)."""
    rid = cat["rid"]
    at = np.minimum(np.searchsorted(wins, rid), max(len(wins) - 1, 0))
    hit = np.flatnonzero(wins[at] == rid) if len(wins) else \
        np.zeros(0, np.int64)
    win_idx = np.full(len(rid), -1, np.int64)
    win_idx[hit] = np.arange(len(hit))
    return win_idx, (np.asarray(cat["umi_packed"])[hit].astype(np.int64),
                     (np.asarray(cat["region"])[hit] != 0).astype(np.int64),
                     Strings.of(cat["names"]).take(hit))
