// A BAM stream's records walked in one pass (testing/bam_walk.py binds
// it with ctypes): the checks of a BAM too large for a record a Python
// loop (chip_smoke.py's depth runs) read each record's place, reference,
// span, flag and read number here, from the decompressed stream a buffer
// at a time.

#include <cstdint>
#include <cstring>

extern "C" {

static int32_t rd32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Walks the records starting at d[off] that lie whole in d[0, n), at
// most cap of them; for each: its start and end in d, reference id,
// position, end (position plus the reference bases its CIGAR spans, or
// plus 1 where it spans none), flag, and read number (the digits after
// the name's first character; -1 for a name of another form).  *stop is
// where the walk ended (the first record not whole in d).  Returns the
// records walked, or -1 for a record shorter than its fixed fields.
int64_t crt_bam_walk(const uint8_t* d, int64_t n, int64_t off, int64_t cap,
                     int64_t* rec_off, int64_t* rec_end, int32_t* ref,
                     int32_t* pos, int32_t* end, uint16_t* flag,
                     int64_t* readno, int64_t* stop) {
  int64_t k = 0;
  while (k < cap && off + 4 <= n) {
    const int64_t size = rd32(d + off);
    if (off + 4 + size > n) break;
    if (size < 32) return -1;
    const uint8_t* r = d + off + 4;
    const int32_t p = rd32(r + 4);
    const int64_t l_rn = r[8];
    const int64_t n_cig = rd16(r + 12);
    if (32 + l_rn + 4 * n_cig > size) return -1;
    int64_t span = 0;
    const uint8_t* cig = r + 32 + l_rn;
    for (int64_t c = 0; c < n_cig; ++c) {
      const uint32_t v = static_cast<uint32_t>(rd32(cig + 4 * c));
      const uint32_t op = v & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += v >> 4;
    }
    int64_t num = l_rn > 2 ? 0 : -1;
    for (int64_t c = 1; c + 1 < l_rn && num >= 0; ++c) {
      const uint8_t ch = r[32 + c];
      num = (ch >= '0' && ch <= '9') ? num * 10 + (ch - '0') : -1;
    }
    rec_off[k] = off;
    rec_end[k] = off + 4 + size;
    ref[k] = rd32(r);
    pos[k] = p;
    end[k] = static_cast<int32_t>(p + (span ? span : 1));
    flag[k] = rd16(r + 14);
    readno[k] = num;
    ++k;
    off += 4 + size;
  }
  *stop = off;
  return k;
}

}  // extern "C"
