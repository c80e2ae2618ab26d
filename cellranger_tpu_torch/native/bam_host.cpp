// The BAM writer's record encoder (native/bam_host.py binds it with
// ctypes): one band's records, in the band's sorted order, laid out as
// io/bam.py BamWriter.write_record lays them out (each record's int32
// block size, then the record), with the tags pipeline/bam_out.py
// _write_rows gives each kind of record.  Host code: the inputs are the
// spooled host arrays of the band, the output one contiguous buffer.
//
// Columns come typed (Col.code: 0 uint8/bool, 1 int8, 2 int16, 3 uint16,
// 4 int32, 5 uint32, 6 int64, 7 uint64), so the band's arrays are read
// in place; strings come as one buffer plus n + 1 offsets.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// scalar columns, in the order of bam_host.py SCALAR_COLUMNS
enum {
  RNA_LEN, STRAND, BC_PACKED, UMI_PACKED, CORRECTED_BC, BC_OK, IS_FEATURE,
  CONF_OK, UMI_VALID, PAIR_FLAG, MATE_CHROM, MATE_GPOS, TLEN, MAPPED,
  SECONDARY, G_CHROM, G_GPOS, ALN_LEN, ALN_START, MAPQ, G_SPLICED,
  G_INTRON_LEN, G_DONOR_OFF, NOVEL_SJ, SJ_DONOR, SJ_ACCEPTOR, SJ_RIGHT_LEN,
  GENE, REGION, MM, GENE_DISCORDANT, GENE_UNPAIRED, UMI_REP, CORR_UMI,
  LOW_SUP, WIN_IDX, N_COLS
};

struct Col { const void* p; int64_t code; };
struct Mat { const void* p; int64_t code; int64_t width; };
struct Str { const uint8_t* buf; const int64_t* off; };

struct Band {
  Col col[N_COLS];
  Mat rna, nmask, rna_qual, bc_qual, umi_qual, gene_list, anti_list;
  Str names, fr, fq, fb, fx;
  Str read_group, gem_suffix;       // one string each
  int64_t bc_len, umi_len;
  int64_t n_genes;
  Str gene_ids, gene_names;
  // transcripts grouped by gene: gene g's are [gene_tx[g], gene_tx[g + 1])
  const int64_t* gene_tx;
  Str tx_ids;
  const int64_t* tx_chrom;
  const int64_t* tx_rev;
  const int64_t* tx_len;
  const int64_t* tx_exon;           // transcript t's exons [tx_exon[t], +1)
  const int64_t* ex_start;
  const int64_t* ex_end;
  const int64_t* ex_cum;
  // UMI_COUNT winners, indexed by the WIN_IDX column (-1: none)
  const int64_t* win_umi;
  const int64_t* win_ntxo;
  Str win_name;
};

int64_t crt_bam_n_cols() { return N_COLS; }

}  // extern "C"

namespace {

enum Err {
  ERR_BASE = -1,      // a base code above 4 where the mask says real base
  ERR_LEN = -2,       // a read length outside its planes
  ERR_FIELD = -3,     // a value that does not fit its BAM field
  ERR_GENE = -4,      // a gene index outside the gene table
  ERR_REGION = -5,    // a region code other than 0, 1, 2
  ERR_DTYPE = -6,     // a column code the encoder does not read
};

struct Fail { int code; };

inline int64_t at(const void* p, int64_t code, int64_t i) {
  switch (code) {
    case 0: return static_cast<const uint8_t*>(p)[i];
    case 1: return static_cast<const int8_t*>(p)[i];
    case 2: return static_cast<const int16_t*>(p)[i];
    case 3: return static_cast<const uint16_t*>(p)[i];
    case 4: return static_cast<const int32_t*>(p)[i];
    case 5: return static_cast<const uint32_t*>(p)[i];
    case 6:
    case 7: return static_cast<const int64_t*>(p)[i];   // uint64: its bits
    default: throw Fail{ERR_DTYPE};
  }
}

struct Rec {
  const Band* b;
  int64_t i;
  int64_t v(int c) const { return at(b->col[c].p, b->col[c].code, i); }
  int64_t m(const Mat& x, int64_t j) const {
    return at(x.p, x.code, i * x.width + j);
  }
  // the row of a one-byte plane (bam_host.py passes them as uint8)
  const uint8_t* row8(const Mat& x) const {
    if (x.code != 0) throw Fail{ERR_DTYPE};
    return static_cast<const uint8_t*>(x.p) + i * x.width;
  }
};

inline int64_t str_len(const Str& s, int64_t i) {
  return s.off[i + 1] - s.off[i];
}

struct Out {
  std::vector<uint8_t> r;
  void u8(uint32_t x) { r.push_back(static_cast<uint8_t>(x)); }
  void u16(uint32_t x) { u8(x & 0xFF); u8(x >> 8); }
  void u32(uint32_t x) { u16(x & 0xFFFF); u16(x >> 16); }
  void i32(int64_t x) {
    if (x < INT32_MIN || x > INT32_MAX) throw Fail{ERR_FIELD};
    u32(static_cast<uint32_t>(static_cast<int32_t>(x)));
  }
  void bytes(const void* p, int64_t n) {
    const uint8_t* q = static_cast<const uint8_t*>(p);
    r.insert(r.end(), q, q + n);
  }
  void str(const Str& s, int64_t i) { bytes(s.buf + s.off[i], str_len(s, i)); }
  void tag(const char* t, char type) { u8(t[0]); u8(t[1]); u8(type); }
  void tag_str(const char* t, const Str& s, int64_t i) {
    tag(t, 'Z'); str(s, i); u8(0);
  }
  void tag_int(const char* t, int64_t x) { tag(t, 'i'); i32(x); }
  // 2-bit codes MSB-first (ops/encode.py unpack_np, decode_codes)
  void tag_packed(const char* t, uint64_t packed, int64_t len) {
    tag(t, 'Z');
    for (int64_t j = 0; j < len; ++j) {
      int64_t sh = 2 * (len - 1 - j);
      u8("ACGT"[sh < 64 ? (packed >> sh) & 3 : 0]);
    }
  }
};

inline int64_t reg2bin(int64_t beg, int64_t end) {
  --end;   // arithmetic shifts, as Python's on negative values
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
  return 0;
}

struct Seg { int64_t s, e; };

// bam_out.py _project_tx: "pos,cigar" of the read's segments on transcript
// t, or false where a segment leaves an exon or a junction is not the
// transcript's
bool project_tx(const Band* b, int64_t t, int64_t chrom, const Seg* segs,
                int nseg, int64_t lclip, int64_t rclip, std::string& out) {
  if (chrom != b->tx_chrom[t]) return false;
  const int64_t e0 = b->tx_exon[t], ne = b->tx_exon[t + 1] - e0;
  const int64_t* st = b->ex_start + e0;
  const int64_t* en = b->ex_end + e0;
  int64_t idx[2] = {0, 0};
  for (int k = 0; k < nseg; ++k) {
    // numpy searchsorted(starts, s, side="right") - 1, its bisection
    int64_t lo = 0, hi = ne;
    while (lo < hi) {
      int64_t mid = lo + ((hi - lo) >> 1);
      if (segs[k].s < st[mid]) hi = mid; else lo = mid + 1;
    }
    int64_t i = lo - 1;
    if (i < 0 || segs[k].e > en[i] || segs[k].s < st[i]) return false;
    idx[k] = i;
  }
  for (int k = 0; k + 1 < nseg; ++k)
    if (segs[k].e != en[idx[k]] || idx[k + 1] != idx[k] + 1
        || segs[k + 1].s != st[idx[k + 1]])
      return false;
  int64_t tx_pos = b->ex_cum[e0 + idx[0]] + (segs[0].s - st[idx[0]]);
  int64_t aligned = 0;
  for (int k = 0; k < nseg; ++k) aligned += segs[k].e - segs[k].s;
  if (b->tx_rev[t]) {
    tx_pos = b->tx_len[t] - (tx_pos + aligned);
    std::swap(lclip, rclip);
  }
  out = std::to_string(tx_pos) + ",";
  if (lclip) out += std::to_string(lclip) + "S";
  out += std::to_string(aligned) + "M";
  if (rclip) out += std::to_string(rclip) + "S";
  return true;
}

// the entry "<id>,<strand>" (+ p) appended to parts
void add_entry(std::vector<std::string>& parts, const Str& ids, int64_t k,
               char strand, const std::string* p) {
  std::string e(reinterpret_cast<const char*>(ids.buf + ids.off[k]),
                str_len(ids, k));
  e += ',';
  e += strand;
  if (p) e += *p;
  parts.push_back(std::move(e));
}

// bam_out.py _gene_set_tag: the TX (or AN) payload of a gene-list row,
// appended to o as a Z tag unless it is empty
void gene_set_tag(const Band* b, const Rec& r, const Mat& list,
                  int64_t chrom, const Seg* segs, int nseg, int64_t lclip,
                  int64_t rclip, char strand, const char* tag, Out& o) {
  int64_t genes[16];
  int ng = 0;
  for (int64_t j = 0; j < list.width && j < 16; ++j) {
    int64_t g = r.m(list, j);
    if (g >= 0) genes[ng++] = g;
  }
  if (list.width > 16) throw Fail{ERR_FIELD};
  if (!ng) return;
  std::sort(genes, genes + ng);
  std::vector<std::string> parts;
  std::string p;
  for (int k = 0; k < ng; ++k) {
    const int64_t g = genes[k];
    if (g >= b->n_genes) throw Fail{ERR_GENE};
    bool hit = false;
    if (nseg) {
      for (int64_t t = b->gene_tx[g]; t < b->gene_tx[g + 1]; ++t) {
        if (!project_tx(b, t, chrom, segs, nseg, lclip, rclip, p)) continue;
        add_entry(parts, b->tx_ids, t, strand, &p);
        hit = true;
      }
    }
    if (!hit) add_entry(parts, b->gene_ids, g, strand, nullptr);
  }
  std::sort(parts.begin(), parts.end());   // bytes: UTF-8 in code point order
  o.tag(tag, 'Z');
  for (size_t k = 0; k < parts.size(); ++k) {
    if (k) o.u8(';');
    o.bytes(parts[k].data(), parts[k].size());
  }
  o.u8(0);
}

int64_t gene_index(const Band* b, int64_t g) {   // Python's list indexing
  int64_t k = g < 0 ? g + b->n_genes : g;
  if (k < 0 || k >= b->n_genes) throw Fail{ERR_GENE};
  return k;
}

bool same_name(const Band* b, int64_t i, int64_t w) {
  int64_t n = str_len(b->names, i);
  return n == str_len(b->win_name, w)
      && !std::memcmp(b->names.buf + b->names.off[i],
                      b->win_name.buf + b->win_name.off[w], n);
}

// the molecule's UMI_COUNT winner is this record: the plain version's
// rep[key] == hash((umi, ntxo, name)), exactly
bool umi_count(const Band* b, const Rec& r) {
  int64_t w = r.v(WIN_IDX);
  return w >= 0 && b->win_umi[w] == r.v(UMI_PACKED)
      && b->win_ntxo[w] == (r.v(REGION) != 0 ? 1 : 0)
      && same_name(b, r.i, w);
}

struct Cigar {
  uint32_t ops[8];
  int n = 0;
  int64_t ref_len = 0;    // M, D, N lengths
  void add(int64_t len, int op) {
    if (len < 0 || len >= (int64_t(1) << 28)) throw Fail{ERR_FIELD};
    ops[n++] = static_cast<uint32_t>(len << 4) | op;
    if (op == 0 || op == 2 || op == 3) ref_len += len;
  }
};

enum { OP_M = 0, OP_N = 3, OP_S = 4 };
enum {
  F_UNMAPPED = 4, F_REVERSE = 16, F_SECONDARY = 256,
  XF_CONF_MAPPED = 1, XF_LOW_SUPPORT_UMI = 2, XF_GENE_DISCORDANT = 4,
  XF_UMI_COUNT = 8, XF_CONF_FEATURE = 16,
};

// one record (block size first) appended to o; ref, pos and the index's
// end (pos + reference length, or pos + 1) returned
void encode_record(const Band* b, int64_t i, Out& o, Out& tags,
                   int64_t* ref_out, int64_t* pos_out, int64_t* end_out) {
  Rec r{b, i};
  const int64_t L = r.v(RNA_LEN);
  if (L < 0 || L > b->rna.width || L > b->nmask.width
      || L > b->rna_qual.width)
    throw Fail{ERR_LEN};
  const bool rev = r.v(STRAND) == 1;
  const bool mapped = r.v(MAPPED) != 0;

  int64_t flag = r.v(PAIR_FLAG);
  int64_t ref = -1, pos = -1, mapq = 0, tlen = 0;
  Cigar cig;
  tags.r.clear();
  // common tags: RG, CR, CY, UR, UY, then CB on a whitelisted barcode
  tags.tag("RG", 'Z');
  tags.str(b->read_group, 0);
  tags.u8(0);
  tags.tag_packed("CR", static_cast<uint64_t>(r.v(BC_PACKED)), b->bc_len);
  tags.u8(0);
  tags.tag("CY", 'Z');
  tags.bytes(r.row8(b->bc_qual), b->bc_qual.width);
  tags.u8(0);
  tags.tag_packed("UR", static_cast<uint64_t>(r.v(UMI_PACKED)), b->umi_len);
  tags.u8(0);
  tags.tag("UY", 'Z');
  tags.bytes(r.row8(b->umi_qual),
             std::max<int64_t>(0, std::min(b->umi_len, b->umi_qual.width)));
  tags.u8(0);
  if (r.v(BC_OK)) {
    tags.tag_packed("CB", static_cast<uint64_t>(r.v(CORRECTED_BC)),
                    b->bc_len);
    tags.str(b->gem_suffix, 0);
    tags.u8(0);
  }
  const uint64_t cu = static_cast<uint32_t>(r.v(CORR_UMI));
  int64_t xf = 0;
  if (!mapped) {
    flag |= F_UNMAPPED;
    if (r.v(IS_FEATURE)) {
      // feature-barcode read: its FeatureExtracted tags
      const Str* fs[4] = {&b->fr, &b->fq, &b->fb, &b->fx};
      const char* names[4] = {"fr", "fq", "fb", "fx"};
      for (int k = 0; k < 4; ++k)
        if (str_len(*fs[k], i)) tags.tag_str(names[k], *fs[k], i);
      if (r.v(CONF_OK)) {
        xf |= XF_CONF_FEATURE;
        if (r.v(UMI_VALID)) {
          tags.tag_packed("UB", cu, b->umi_len);
          tags.u8(0);
        }
        if (r.v(LOW_SUP)) xf |= XF_LOW_SUPPORT_UMI;
        else if (umi_count(b, r)) xf |= XF_UMI_COUNT;
      }
    }
    tags.tag_int("xf", xf);
  } else {
    if (rev) flag |= F_REVERSE;
    ref = r.v(G_CHROM);
    pos = r.v(G_GPOS);
    mapq = r.v(MAPQ);
    tlen = r.v(TLEN);
    const int64_t alen = r.v(ALN_LEN), astart = r.v(ALN_START);
    if (astart) cig.add(astart, OP_S);
    if (r.v(SECONDARY)) {
      // a multimapped read's other locus: CIGAR and position, xf 0
      flag |= F_SECONDARY;
      cig.add(alen, OP_M);
      int64_t rclip = L - astart - alen;
      if (rclip > 0) cig.add(rclip, OP_S);
      tags.tag_int("xf", 0);
    } else {
      const bool ann_spliced = r.v(G_SPLICED) && r.v(G_INTRON_LEN) > 0;
      const bool novel = r.v(NOVEL_SJ) != 0;
      int64_t rclip;
      if (ann_spliced) {
        int64_t d = r.v(G_DONOR_OFF);
        cig.add(d, OP_M);
        cig.add(r.v(G_INTRON_LEN), OP_N);
        cig.add(alen - d, OP_M);
        rclip = L - astart - alen;
      } else if (novel) {
        int64_t rlen = r.v(SJ_RIGHT_LEN);
        cig.add(alen, OP_M);
        cig.add(r.v(SJ_ACCEPTOR) - r.v(SJ_DONOR), OP_N);
        cig.add(rlen, OP_M);
        rclip = L - astart - alen - rlen;
      } else {
        cig.add(alen, OP_M);
        rclip = L - astart - alen;
      }
      if (rclip > 0) cig.add(rclip, OP_S);

      int64_t region = r.v(REGION);
      if (region < 0 || region > 2) throw Fail{ERR_REGION};
      tags.tag("RE", 'A');
      tags.u8("EIN"[region]);
      // TX / AN: the read's genomic segments (none on a novel junction)
      Seg segs[2];
      int nseg = 0;
      if (!novel) {
        if (ann_spliced) {
          int64_t d = r.v(G_DONOR_OFF), il = r.v(G_INTRON_LEN);
          segs[0] = {pos, pos + d};
          segs[1] = {pos + d + il, pos + alen + il};
          nseg = 2;
        } else {
          segs[0] = {pos, pos + alen};
          nseg = 1;
        }
      }
      const int64_t rcl = std::max<int64_t>(L - astart - alen, 0);
      gene_set_tag(b, r, b->gene_list, ref, segs, nseg, astart, rcl, '+',
                   "TX", tags);
      gene_set_tag(b, r, b->anti_list, ref, segs, nseg, astart, rcl, '-',
                   "AN", tags);
      if (r.v(MM)) tags.tag_int("mm", 1);
      if (r.v(GENE_DISCORDANT)) {
        xf |= XF_GENE_DISCORDANT;
        int64_t gu = r.v(GENE_UNPAIRED);
        if (gu >= 0) {
          gu = gene_index(b, gu);
          tags.tag_str("gX", b->gene_ids, gu);
          tags.tag_str("gN", b->gene_names, gu);
        }
      }
      if (r.v(CONF_OK)) {
        int64_t g = gene_index(b, r.v(GENE));
        tags.tag_str("GX", b->gene_ids, g);
        tags.tag_str("GN", b->gene_names, g);
        xf |= XF_CONF_MAPPED;
        if (r.v(UMI_VALID)) {
          tags.tag_packed("UB", cu, b->umi_len);
          tags.u8(0);
        }
        if (r.v(LOW_SUP)) xf |= XF_LOW_SUPPORT_UMI;
        else if (r.v(UMI_REP) && umi_count(b, r)) xf |= XF_UMI_COUNT;
      }
      tags.tag_int("xf", xf);
    }
  }
  const int64_t next_ref = r.v(MATE_CHROM), next_pos = r.v(MATE_GPOS);
  const int64_t name_len = str_len(b->names, i) + 1;
  if (name_len > 255 || mapq < 0 || mapq > 255 || flag < 0 || flag > 0xFFFF)
    throw Fail{ERR_FIELD};
  const int64_t end_b = cig.n ? pos + cig.ref_len : pos + 1;
  const int64_t bin = reg2bin(pos, std::max(end_b, pos + 1));
  const int64_t rec_len = 32 + name_len + 4 * cig.n + (L + 1) / 2 + L
      + static_cast<int64_t>(tags.r.size());

  o.i32(rec_len);
  o.i32(ref);
  o.i32(pos);
  o.u8(name_len);
  o.u8(mapq);
  o.u16(bin);
  o.u16(cig.n);
  o.u16(flag);
  o.i32(L);
  o.i32(next_ref);
  o.i32(next_pos);
  o.i32(tlen);
  o.str(b->names, i);
  o.u8(0);
  for (int k = 0; k < cig.n; ++k) o.u32(cig.ops[k]);
  // SEQ: ACGTN (N where the mask is off), reverse-complemented on strand
  // 1, as =ACMGRSVTWYHKDBN nibbles, high first; QUAL reversed with it
  static const uint8_t nib[5] = {1, 2, 4, 8, 15};
  const uint8_t* codes = r.row8(b->rna);
  const uint8_t* mask = r.row8(b->nmask);
  const uint8_t* qual = r.row8(b->rna_qual);
  const size_t at_seq = o.r.size();
  o.r.resize(at_seq + (L + 1) / 2 + L);
  uint8_t* seq = o.r.data() + at_seq;
  uint8_t* q = seq + (L + 1) / 2;
  for (int64_t j = 0; j < L; ++j) {
    const int64_t src = rev ? L - 1 - j : j;
    int c = mask[src] ? codes[src] : 4;
    if (c > 4) throw Fail{ERR_BASE};
    if (rev && c < 4) c = 3 - c;
    if (j & 1) seq[j >> 1] |= nib[c]; else seq[j >> 1] = nib[c] << 4;
    const int x = qual[src];
    q[j] = x >= 33 ? std::min(x - 33, 93) : 0xFF;
  }
  o.bytes(tags.r.data(), tags.r.size());
  *ref_out = ref;
  *pos_out = pos;
  *end_out = pos + (cig.ref_len ? cig.ref_len : 1);
}

}  // namespace

extern "C" {

// Encodes the records order[0..n) of the band into out (capacity cap) until
// the next one would not fit.  Returns the number encoded; rec_end[k] is the
// end of record k in out, ref/pos/end its reference, position and index
// end.  On a record the BAM format cannot hold returns a negative Err and
// sets *err_row to the row.
int64_t crt_bam_encode(const Band* b, const int64_t* order, int64_t n,
                       uint8_t* out, int64_t cap, int64_t* rec_end,
                       int64_t* ref, int64_t* pos, int64_t* end,
                       int64_t* err_row) {
  Out o, tags;
  int64_t used = 0;
  for (int64_t k = 0; k < n; ++k) {
    o.r.clear();
    try {
      encode_record(b, order[k], o, tags, ref + k, pos + k, end + k);
    } catch (const Fail& f) {
      *err_row = order[k];
      return f.code;
    }
    if (used + static_cast<int64_t>(o.r.size()) > cap) return k;
    std::memcpy(out + used, o.r.data(), o.r.size());
    used += o.r.size();
    rec_end[k] = used;
  }
  return n;
}

}  // extern "C"
