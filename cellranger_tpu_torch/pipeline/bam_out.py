"""Position-sorted BAM assembly for the count pipeline — the WRITE_POS_BAM
analog (lib/rust/cr_lib/src/stages/write_pos_bam.rs), without the
samtools-cat subprocess: per-batch alignment arrays are bucketed into
genome-position bands on disk (pipeline/spill.BamSpool) as they stream off
the device, and the final write loads one band at a time, sorts it,
encodes its records in bulk (native/bam_host.py) and streams them through
a BGZF writer that compresses on threads and builds the .bai from arrays
(io/bam_fast.py).  Peak RAM is O(one band), not O(run), beside the
index's 40 bytes a record — the per-chunk-BAM + samtools-cat structure
re-expressed.

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

import itertools
import os
import time

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
from .spill import BamSpool, lex3_join_np
from ..align.index import GenomeIndex
from ..native import bam_host
from ..ops import encode

REGION_CHARS = {0: "E", 1: "I", 2: "N"}

# the last `write`'s split: seconds of spool load (load, join, sort),
# representatives (selection and each band's join), encode (waiting for
# the native encoder's threads), write (handing buffers to the BGZF writer
# and closing it; of it compress_wait, waiting for its threads, and index);
# compress_cpu (the compression threads' own seconds); and the threads of
# each pool, records, stream bytes, blocks, the spool's bytes on disk
LAST_SPLIT: dict = {}

_CHUNK_KEYS = ("rna", "rna_qual", "rna_len", "nmask", "bc_packed", "bc_qual",
               "umi_packed", "umi_valid", "umi_qual", "pos", "mapq", "strand",
               "aln_len", "aln_start", "mapped", "region", "gene", "conf_ok",
               "bc_ok", "corrected_bc", "bc_idx", "novel_sj", "sj_donor",
               "sj_acceptor", "sj_right_len", "mm", "gene_discordant",
               "gene_unpaired")
_CHUNK_KEYS_2D = ("gene_list", "anti_list")


class BamCollector:
    """Streams per-batch host arrays into a position-banded disk spool."""

    def __init__(self, gi: GenomeIndex, txome: Transcriptome,
                 spool_dir: str, n_bands: int = 64,
                 read_group: str = "sample", fresh: bool = True):
        self.gi = gi
        self.txome = txome
        self.n_bands = n_bands
        self.read_group = read_group
        self.spool = BamSpool(spool_dir, n_bands, fresh=fresh)
        # multihost: other hosts' spool directories, merged at write time
        # (the per-chunk-BAM + samtools-cat structure of write_pos_bam.rs
        # :65-101, with position bands instead of chunk files)
        self.sibling_dirs: list[str] = []
        # sort key = chrom << 33 | genomic pos (33 bits cover any chrom)
        self._max_key = (len(gi.chrom_names) + 1) << 33
        self.n_reads = 0

    def _sort_keys(self, pos, aln_len, mapped):
        g = self.gi.pos_to_genomic(pos.astype(np.int64),
                                   aln_len.astype(np.int64))
        # unmapped sentinel chrom = chrom_count (fits the 33-bit-shift
        # layout; _max_key reserves chrom_count+1, and 2**31 would overflow
        # int64 under the shift)
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
        band = np.minimum((key * self.n_bands) // self._max_key,
                          self.n_bands - 1)
        band = np.where(chunk["mapped"].astype(bool), band, self.n_bands)
        self.spool.add(band.astype(np.int64), chunk)
        self._spool_rep_sidecar(band, chunk, n)
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
            sub = {}
            for k, v in prim_chunk.items():
                if isinstance(v, np.ndarray):
                    sub[k] = v[idx].copy()
                elif isinstance(v, list):
                    sub[k] = [v[i] for i in idx]
                else:
                    sub[k] = v
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
                      "g_intron_len", "g_donor_off"):
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
        """Sidecar of UMI_COUNT-candidate rows (conf-mapped, valid-UMI,
        mate-1) so the representative pass reads ~30B/read instead of
        re-deserializing the full record bands."""
        el = (chunk["conf_ok"].astype(bool) & chunk["umi_valid"].astype(bool)
              & chunk["umi_rep"].astype(bool))
        if not el.any():
            return
        sub = dict(
            bc=chunk["bc_idx"][el].astype(np.uint32),
            gl=chunk["gene_lib"][el].astype(np.uint32),
            umi=chunk["umi_packed"][el].astype(np.uint32),
            txo=self._txomic(chunk)[el],
            names=[chunk["names"][i] for i in np.flatnonzero(el)])
        self.spool.add_rep(np.asarray(band)[el].astype(np.int64), sub)

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
            chunk[k] = [b""] * n
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
        band = np.full(n, self.n_bands, np.int64)
        self.spool.add(band, chunk)
        self._spool_rep_sidecar(band, chunk, n)
        self.n_reads += n

    def _header(self) -> tuple:
        """(reference names, lengths, @RG line) of the BAM's header."""
        gi = self.gi
        rg_header = f"@RG\tID:{self.read_group}\tSM:{self.read_group}\n"
        return (gi.chrom_names, list(np.diff(gi.chrom_starts).astype(int)),
                rg_header)

    def _load_band(self, band: int, views: tuple):
        """One band's columns (this spool's chunks, then each sibling
        directory's) with each record's corrected UMI and low-support
        flag from the raw-triple views; None for an empty band."""
        rb, rg, ru, rc, rl = views
        chunks = list(self.spool.iter_band(band))
        for d in self.sibling_dirs:
            chunks.extend(BamSpool.iter_dir_band(d, band))
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

        Each band's records are encoded in bulk by the native encoder
        (native/bam_host.py) and written by io/bam_fast.py's writer, whose
        threads compress one buffer's blocks while the next is encoded;
        the bytes are those of `write_plain`.  LAST_SPLIT holds the
        seconds of the parts and the sizes."""
        LAST_SPLIT.clear()
        split = dict(spool_load_s=0.0, representatives_s=0.0, encode_s=0.0,
                     write_s=0.0, spool_bytes=sum(
                         e.stat().st_size
                         for d in [self.spool.dir, *self.sibling_dirs]
                         for e in os.scandir(d) if e.is_file()))
        w = BgzfBamWriter(path, *self._header())
        # half the cores encode, while all of them compress
        encode_threads = max(1, w.threads // 2)
        records = 0
        if self.n_reads or self.sibling_dirs:
            views = _raw_views(raw_views)
            t = time.perf_counter()
            winners = self._select_representatives(*views)
            split["representatives_s"] += time.perf_counter() - t
            self._build_tx_tables()
            tables = bam_host.run_tables(
                self.read_group, gem_group, bc_len, umi_len,
                [g_.id for g_ in self.txome.genes],
                [g_.name for g_ in self.txome.genes], self._gene_txs,
                winners)
            for band in range(self.n_bands + 1):
                t = time.perf_counter()
                r = self._load_band(band, views)
                if r is None:
                    continue
                cat, corr_umi, low_sup = r
                # a spool without the column holds no secondary record, as
                # `_write_rows` reads it
                cat.setdefault("secondary", np.zeros(len(corr_umi), bool))
                order = np.argsort(cat["sort_key"], kind="stable")
                t1 = time.perf_counter()
                split["spool_load_s"] += t1 - t
                win_idx = _winner_rows(winners, cat, corr_umi, low_sup)
                t2 = time.perf_counter()
                split["representatives_s"] += t2 - t1
                parts = bam_host.encode_band(tables, cat, corr_umi, low_sup,
                                             win_idx, order, encode_threads)
                while True:
                    t = time.perf_counter()
                    recs = next(parts, None)
                    t1 = time.perf_counter()
                    split["encode_s"] += t1 - t
                    if recs is None:
                        break
                    w.write_records(*recs)
                    split["write_s"] += time.perf_counter() - t1
                records += len(order)
        t = time.perf_counter()
        w.close()
        split["write_s"] += time.perf_counter() - t
        self.spool.close()
        LAST_SPLIT.update(
            split, compress_wait_s=w.wait_s, compress_cpu_s=w.compress_cpu_s,
            index_s=w.index_s, threads=w.threads,
            encode_threads=encode_threads, records=records,
            stream_bytes=w._stream, blocks=len(w._block_at) - 1)

    def write_plain(self, path: str, raw_views: dict, bc_len: int,
                    umi_len: int, gem_group: int = 1):
        """The plain version of `write`: every record through `_write_rows`
        and io/bam_index.py's IndexingBamWriter, one at a time.  Tests and
        chip_smoke.py hold `write` to it; the run does not call it.  The
        spool stays open (a test writes it again with `write`)."""
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
        """Per-molecule UMI_COUNT winner, from the sidecar spool (not the
        full bands): per band one lexsort + group-first, merged across
        bands by a second lexsort.  Returns the winners as arrays (bc,
        gene_lib, corr_umi, raw_umi, not_txomic, qname), sorted by
        (bc, gene_lib, corr_umi), one row a molecule."""
        winners: list[tuple] = []
        for band in range(self.n_bands + 1):
            chunks = list(self.spool.iter_rep(band))
            for d in self.sibling_dirs:
                chunks.extend(BamSpool.iter_dir_rep(d, band))
            if not chunks:
                continue
            bc = np.concatenate([c["bc"] for c in chunks])
            gl = np.concatenate([c["gl"] for c in chunks])
            um = np.concatenate([c["umi"] for c in chunks])
            txo = np.concatenate([c["txo"] for c in chunks])
            names = [n_ for c in chunks for n_ in c["names"]]
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


def concat_chunks(chunks: list[dict]) -> dict:
    """One dict of the chunks' columns, in chunk order: arrays
    concatenated, lists joined in linear time.  Each chunk gives up its
    columns as they are joined, so a band is held about once."""
    cat = {}
    for k in list(chunks[0]):
        parts = [c.pop(k) for c in chunks]
        cat[k] = (np.concatenate(parts) if isinstance(parts[0], np.ndarray)
                  else list(itertools.chain.from_iterable(parts)))
    return cat


def _winner_rows(winners: tuple, cat: dict, corr_umi, low_sup) -> np.ndarray:
    """Each record's molecule among the winners of
    `_select_representatives` (-1: none), for the records the UMI_COUNT
    test reaches (conf_ok, not low-support): an exact join on (bc_idx,
    gene_lib, corr_umi).  The encoder then compares (raw UMI, not_txomic,
    qname) exactly; the plain version compares Python hash() values of
    those tuples, so the two differ only on a 64-bit hash collision."""
    rows = np.full(len(corr_umi), -1, np.int64)
    need = np.flatnonzero(np.asarray(cat["conf_ok"]).astype(bool) & ~low_sup)
    if len(winners[0]) and len(need):
        idx, found = lex3_join_np(
            winners[0], winners[1], winners[2],
            np.asarray(cat["bc_idx"])[need],
            np.asarray(cat["gene_lib"])[need], corr_umi[need])
        rows[need[found]] = idx[found]
    return rows
