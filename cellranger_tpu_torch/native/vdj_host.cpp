// The V(D)J pipeline's per-barcode host routines (vdj/support.py).
//
// Smith-Waterman local alignment of two byte strings, as vdj/annotate.py
// `local_align` computes it: linear gap, int32 scores, the best cell the
// first strictly greatest of H in row-major order, and the start found by
// the same greedy re-scan (diagonal, then up, then left, while H > 0).
//
//   crt_local_align(a, n, b, m, match, mismatch, gap, out)
//     out[0..4] = score, a_start, a_end, b_start, b_end
//     returns 0, or -1 when the score matrix cannot be allocated
//
// The base-quality pileup's sums, as vdj/assembly.py
// `contig_base_quals` adds them: per (position, UMI) group g and base b,
// the terms of the group's observations, one double add each in
// observation order onto 0.0.
//
//   crt_pileup_sums(obs, group, n, terms, n_terms, out)
//     obs[i]: the term column of observation i (quality byte * 4 + base),
//     group[i] its group; terms [4][n_terms]; out [groups][4], zeroed

#include <cstdint>
#include <new>
#include <vector>

extern "C" int crt_local_align(const char* a, int n, const char* b, int m,
                               int match, int mismatch, int gap,
                               int32_t* out) {
  const int64_t w = static_cast<int64_t>(m) + 1;
  std::vector<int32_t> H;
  try {
    H.assign((static_cast<int64_t>(n) + 1) * w, 0);
  } catch (const std::bad_alloc&) {
    return -1;
  }
  int32_t best = 0;
  int bi = 0, bj = 0;
  for (int i = 1; i <= n; ++i) {
    const char ai = a[i - 1];
    int32_t* row = &H[i * w];
    const int32_t* prev = &H[(i - 1) * w];
    for (int j = 1; j <= m; ++j) {
      const int32_t s = ai == b[j - 1] ? match : mismatch;
      int32_t v = prev[j - 1] + s;
      if (prev[j] + gap > v) v = prev[j] + gap;
      if (row[j - 1] + gap > v) v = row[j - 1] + gap;
      if (v < 0) v = 0;
      row[j] = v;
      if (v > best) {
        best = v;
        bi = i;
        bj = j;
      }
    }
  }
  int i = bi, j = bj;
  while (i > 0 && j > 0 && H[i * w + j] > 0) {
    const int32_t diag = H[(i - 1) * w + j - 1];
    const int32_t up = H[(i - 1) * w + j];
    const int32_t left = H[i * w + j - 1];
    if (diag >= up && diag >= left) {
      --i;
      --j;
    } else if (up >= left) {
      --i;
    } else {
      --j;
    }
  }
  out[0] = best;
  out[1] = i;
  out[2] = bi;
  out[3] = j;
  out[4] = bj;
  return 0;
}

extern "C" void crt_pileup_sums(const int16_t* obs, const int64_t* group,
                                int64_t n, const double* terms,
                                int64_t n_terms, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = obs[i];
    double* o = out + group[i] * 4;
    o[0] += terms[k];
    o[1] += terms[n_terms + k];
    o[2] += terms[2 * n_terms + k];
    o[3] += terms[3 * n_terms + k];
  }
}
