// Banded Smith-Waterman for Hopper (sm_90a): a group of lanes per read.
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
// The best cell is the highest score; on ties the earliest row, then the
// smallest d.
//
// What bounds it: integer operations, not bytes.  A read is a chain of L
// rows x 16 cells of about a dozen integer operations each (B = 8192,
// L = 91: 143 M operations against 3.3 MB of traffic), and the rows of one
// read depend on each other, so the card is filled only by running many
// reads at once and keeping each row's chain short.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py): 0.014 ms for B = 8192, L = 91,
// 0.61 of the bound of 0.0085 ms, and 0.010 ms for B = 2048: the latency
// of one read's chain of rows, not instruction throughput, is what is
// left.  The design:
//
//   * Lanes.  A read is spread over G = 4 neighbouring lanes of a warp,
//     CPL = 4 band cells per lane in registers, in blocks of 64 threads
//     (16 reads); of the splits timed on the card (1, 2, 4, 8 and 16 cells
//     per lane, 64 to 256 threads) this one was the fastest or within
//     noise of it at B = 2048 and 8192.  The horizontal max-plus scan is
//     serial inside a lane (CPL - 1 add-max steps); across lanes an
//     exclusive prefix maximum of `last cell + GAP * first index` hands
//     each lane the value entering its first cell, by fetching every left
//     neighbour at once (three independent shuffles, no chain).  `vert` of
//     a lane's last cell is the right neighbour's h[0], one more shuffle.
//   * No per-row reduction.  Each lane keeps one packed key
//     (score << 20 | (0xFFFF - row) << 4 | (15 - d)) and takes the maximum
//     over its cells; the key orders by score, then earliest row, then
//     smallest d, so one butterfly over the G lanes after the last row
//     yields the reference's best cell.  The key with score 0, row 0, d 0
//     is the start value and is what a read with no positive cell returns.
//   * Loads.  A block's reads (and windows) are one contiguous byte range
//     of each input.  The block copies the ranges with 16-byte loads into
//     shared memory, laid out at the source's offset within its 16-byte
//     line so that whole lines move, and folds mask and code into one byte
//     on the way (code | 0x80 where masked: a cell is active when
//     (read | window) < 0x80).  Lines cut by the range's ends, and inputs
//     whose code and mask are aligned differently, take a per-byte path.
//     Per row a lane then reads one read byte (a broadcast) and one new
//     window byte; its other window bytes shift down in registers.
//   * Arithmetic.  32-bit scores with Hopper's DPX instructions:
//     pre = __viaddmax_s32_relu(h, s, vert), the scan steps
//     __viaddmax_s32(t, -GAP, pre).
//
// L is a run-time argument (1 <= L <= 2047, the key's score field); B is
// any number of reads; the last block's idle groups replay its last read
// and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BAND = 16;
constexpr int CPL = 4;            // band cells per lane
constexpr int G = BAND / CPL;     // lanes per read
constexpr int THREADS = 64;
constexpr int RPB = THREADS / G;  // reads per block
constexpr int GAP = 2;           // linear gap penalty (-SW_GAP_EXTEND)
constexpr int NEG = -(1 << 20);  // score of a masked cell
constexpr int MAX_L = 2047;      // the packed key holds scores below 2^11
constexpr unsigned FULL = 0xffffffffu;

// code | 0x80 where the mask byte is 0, for four bytes at once
__device__ __forceinline__ uint32_t fold4(uint32_t code, uint32_t mask) {
  return code | (__vcmpeq4(mask, 0u) & 0x80808080u);
}

__device__ __forceinline__ uint8_t fold1(uint8_t code, uint8_t mask) {
  return mask ? code : (uint8_t)(code | 0x80);
}

// Copy code[0, len) folded with mask[0, len) to dst + (code & 15) ...;
// dst is 16-byte aligned.  Returns the offset of byte 0 in dst.
__device__ __forceinline__ int stage_folded(uint8_t* dst,
                                            const uint8_t* __restrict__ code,
                                            const uint8_t* __restrict__ mask,
                                            int len) {
  const int a = (int)((uintptr_t)code & 15);
  const bool same = (int)((uintptr_t)mask & 15) == a;
  const int lines = (a + len + 15) >> 4;
  for (int k = threadIdx.x; k < lines; k += blockDim.x) {
    const int lo = k * 16 - a;
    if (same && lo >= 0 && lo + 16 <= len) {
      const uint4 c = *reinterpret_cast<const uint4*>(code + lo);
      const uint4 m = *reinterpret_cast<const uint4*>(mask + lo);
      uint4 f;
      f.x = fold4(c.x, m.x);
      f.y = fold4(c.y, m.y);
      f.z = fold4(c.z, m.z);
      f.w = fold4(c.w, m.w);
      *reinterpret_cast<uint4*>(dst + k * 16) = f;
    } else {
      const int j0 = lo < 0 ? 0 : lo;
      const int j1 = lo + 16 < len ? lo + 16 : len;
      for (int j = j0; j < j1; ++j) dst[a + j] = fold1(code[j], mask[j]);
    }
  }
  return a;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__global__ void __launch_bounds__(THREADS)
banded_sw_kernel(const uint8_t* __restrict__ read,
                 const uint8_t* __restrict__ rmask,
                 const uint8_t* __restrict__ win,
                 const uint8_t* __restrict__ wmask, int B, int L,
                 int32_t* __restrict__ score, int32_t* __restrict__ end_i,
                 int32_t* __restrict__ end_d) {
  extern __shared__ uint4 smem4[];
  uint8_t* const s_read = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* const s_win = s_read + round16(RPB * L + 15);

  const int W = L + BAND;
  const int b0 = blockIdx.x * RPB;
  const int n = min(RPB, B - b0);  // reads of this block, >= 1
  const int a_read = stage_folded(s_read, read + (size_t)b0 * L,
                                  rmask + (size_t)b0 * L, n * L);
  const int a_win = stage_folded(s_win, win + (size_t)b0 * W,
                                 wmask + (size_t)b0 * W, n * W);
  __syncthreads();

  const int r = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int rr = min(r, n - 1);  // idle groups replay the last read
  const uint8_t* pr = s_read + a_read + rr * L;
  const uint8_t* pw = s_win + a_win + rr * W + g * CPL;

  int h[CPL], wv[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    h[c] = 0;
    wv[c] = pw[c];
  }
  // key of (score 0, row 0, d): the lane's cell c of row i has
  // rowkey - 16 * i - c in its low 20 bits
  int rowkey = (0xFFFF << 4) | (BAND - 1 - g * CPL);
  int bestkey = (0xFFFF << 4) | (BAND - 1);

  int rf_next = pr[0];
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    // this row's read byte was loaded a row ahead, like the window byte
    // that enters the lane's band after this row: no row waits for a load
    const int rf = rf_next;
    rf_next = pr[min(i + 1, L - 1)];
    const int nxt = pw[i + CPL];
    int up = __shfl_down_sync(FULL, h[0], 1, G);  // the right lane's h[0]
    if (g == G - 1) up = NEG;

    bool act[CPL];
    int t[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      act[c] = (rf | wv[c]) < 0x80;
      const int s = act[c] ? (rf == wv[c] ? 1 : -1) : NEG;
      const int vert = (c < CPL - 1 ? h[c + 1] : up) - GAP;
      t[c] = __viaddmax_s32_relu(h[c], s, vert);  // pre
    }
    // horizontal scan: t[d] = max(pre[d], t[d-1] - GAP)
#pragma unroll
    for (int c = 1; c < CPL; ++c) t[c] = __viaddmax_s32(t[c - 1], -GAP, t[c]);
    // x: the exclusive prefix maximum over the lanes to the left of
    // u = last cell + GAP * CPL * lane, every left neighbour fetched at
    // once.  A shuffle from below the group's first lane returns the
    // caller's own value, which the NEG term takes out.
    const int u = t[CPL - 1] + GAP * CPL * g;
    int x = __shfl_up_sync(FULL, u, 1, G);
    if (g == 0) x = NEG;
#pragma unroll
    for (int k = 2; k < G; ++k)
      x = __viaddmax_s32(__shfl_up_sync(FULL, u, k, G), g >= k ? 0 : NEG, x);
    // value entering cell 0: the left neighbour's last cell - GAP
    const int cin = x - GAP * CPL * (g - 1) - GAP;
#pragma unroll
    for (int c = 0; c < CPL; ++c) t[c] = __viaddmax_s32(cin, -GAP * c, t[c]);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      h[c] = act[c] ? t[c] : 0;
      bestkey = max(bestkey, (h[c] << 20) + (rowkey - c));
    }
    rowkey -= BAND;
#pragma unroll
    for (int c = 0; c < CPL - 1; ++c) wv[c] = wv[c + 1];
    wv[CPL - 1] = nxt;
  }

#pragma unroll
  for (int sh = G / 2; sh > 0; sh /= 2)
    bestkey = max(bestkey, __shfl_xor_sync(FULL, bestkey, sh, G));
  if (g == 0 && r < n) {
    score[b0 + r] = bestkey >> 20;
    end_i[b0 + r] = 0xFFFF - ((bestkey >> 4) & 0xFFFF);
    end_d[b0 + r] = BAND - 1 - (bestkey & 15);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for L outside [1, 2047].  All pointers are device
// pointers: read/rmask [B, L] and win/wmask [B, L+16] bytes, contiguous
// (masks are 0 or non-zero), outputs int32 [B].
extern "C" int crt_banded_sw(const void* read, const void* rmask,
                             const void* win, const void* wmask, int B,
                             int L, void* score, void* end_i, void* end_d,
                             void* stream) {
  if (L < 1 || L > MAX_L) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int smem = round16(RPB * L + 15) + round16(RPB * (L + BAND) + 15);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + RPB - 1) / RPB;
  banded_sw_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)read, (const uint8_t*)rmask, (const uint8_t*)win,
      (const uint8_t*)wmask, B, L, (int32_t*)score, (int32_t*)end_i,
      (int32_t*)end_d);
  return (int)cudaGetLastError();
}
