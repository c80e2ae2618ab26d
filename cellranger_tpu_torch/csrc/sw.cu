// Banded Smith-Waterman for Hopper (sm_90a): one thread per read.
//
// Replaces the Pallas kernel cellranger_tpu/align/sw.py `_sw_kernel`
// (launched by `banded_sw`).  Same recurrence, same masking order, same
// tie rules, so the outputs are bit-equal to the TPU kernel's:
//
//   band cell d of row i scores read base i against window base i + d;
//   s[d]    = active ? (w[i+d] == r[i] ? +1 : -1) : NEG
//   pre[d]  = max(h[d] + s[d], (d < 15 ? h[d+1] : NEG) - GAP, 0)
//   t[d]    = max(pre[d], t[d-1] - GAP)         (horizontal gap scan)
//   h[d]    = active ? t[d] : 0
//
// `pre` is scanned BEFORE the activity mask is applied, so an inactive
// cell's `pre` can feed active cells to its right.  That is what the TPU
// kernel computes (it differs from the host DP on masked inputs); keep it.
// The row best takes the smallest d on ties, and a row replaces the
// running best only when it is strictly greater, so the earliest row wins.
//
// What bounds it: each read is a dependency chain of L rows x 16 cells of
// integer max/add, held in registers; at the main path's sizes (B = 2048
// to 8192 reads, L = 91, about 3 MB of input) the kernel is latency-bound
// on that chain, not on memory.  Loads are one byte per thread per cell
// and uncoalesced; staging rows through shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BAND = 16;
constexpr int GAP = 2;           // linear gap penalty (-SW_GAP_EXTEND)
constexpr int NEG = -(1 << 20);  // score of a masked cell
constexpr int THREADS = 128;

__global__ void banded_sw_kernel(const uint8_t* __restrict__ read,
                                 const uint8_t* __restrict__ rmask,
                                 const uint8_t* __restrict__ win,
                                 const uint8_t* __restrict__ wmask,
                                 int B, int L,
                                 int32_t* __restrict__ score,
                                 int32_t* __restrict__ end_i,
                                 int32_t* __restrict__ end_d) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = L + BAND;
  const uint8_t* r = read + (size_t)b * L;
  const uint8_t* rm = rmask + (size_t)b * L;
  const uint8_t* w = win + (size_t)b * W;
  const uint8_t* wm = wmask + (size_t)b * W;

  int h[BAND];
#pragma unroll
  for (int d = 0; d < BAND; ++d) h[d] = 0;
  int best = 0, bi = 0, bd = 0;

  for (int i = 0; i < L; ++i) {
    const int rc = r[i];
    const bool ra = rm[i] != 0;
    int pre[BAND];
    bool act[BAND];
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      const bool a = ra && (wm[i + d] != 0);
      act[d] = a;
      const int s = a ? (w[i + d] == rc ? 1 : -1) : NEG;
      const int diag = h[d] + s;
      const int vert = (d < BAND - 1 ? h[d + 1] : NEG) - GAP;
      pre[d] = max(max(diag, vert), 0);
    }
    int t = pre[0];
    int row_best = -1, row_d = 0;
#pragma unroll
    for (int d = 0; d < BAND; ++d) {
      if (d > 0) t = max(pre[d], t - GAP);
      const int hv = act[d] ? t : 0;
      h[d] = hv;
      if (hv > row_best) {
        row_best = hv;
        row_d = d;
      }
    }
    if (row_best > best) {
      best = row_best;
      bi = i;
      bd = row_d;
    }
  }
  score[b] = best;
  end_i[b] = bi;
  end_d[b] = bd;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers: read/rmask [B, L] and win/wmask [B, L+16]
// bytes (masks are 0/1), outputs int32 [B].
extern "C" int crt_banded_sw(const void* read, const void* rmask,
                             const void* win, const void* wmask, int B,
                             int L, void* score, void* end_i, void* end_d,
                             void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  banded_sw_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)read, (const uint8_t*)rmask, (const uint8_t*)win,
      (const uint8_t*)wmask, B, L, (int32_t*)score, (int32_t*)end_i,
      (int32_t*)end_d);
  return (int)cudaGetLastError();
}
