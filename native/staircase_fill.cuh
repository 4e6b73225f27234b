// Staircase-band realignment fill for one row per thread block.
//
// Same recurrence, the same integer arithmetic and the same packed
// output as the XLA fill (repeatresolver_tpu/ops/staircase_realign.py,
// staircase_fill); the two must agree bit for bit.
//
// The XLA fill runs one scan step per sequence position, each a few
// fused kernels over a W2-lane band, so it pays loop and launch
// overhead ~33k times per paper block. Here one block owns one row and
// runs the whole chunk loop inside the kernel: the band lives in
// registers (K contiguous lanes per thread), the per-chunk cost window
// is loaded into registers once per chunk, and the per-step left
// relaxation (a prefix-min over the band) is a register scan, a warp
// shuffle scan and one shared-memory exchange of warp totals, with one
// barrier per step.
#pragma once

#include <cstdint>

namespace rr {

constexpr int kBig = 1 << 30;        // banded_realign.BIG
constexpr int kThreads = 256;        // threads per block (8 warps)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Shared memory: band exchange [w2], warp totals [2][kWarps], the
// chunk's per-step symbols and band starts [2][chunk].
inline int smem_ints(int w2, int chunk) {
  return w2 + 2 * kWarps + 2 * chunk;
}

// gap/ins/ns: [B, C] per-row costs with the row's own symbol removed;
// own: [B, C] the rows; gp: [B, C+1] gap-cost prefix sums; c4: [C, 4]
// base counts; seqs: [B, Lpad]; lob: [B, Lpad] reference band start of
// each position; a_chunks: [B, NC] window start of each chunk.
// codes: [Lpad/16, B, W2]; final_band: [B, W2]; final_a: [B].
template <int K>
__global__ void __launch_bounds__(kThreads, 1) staircase_fill_kernel(
    const int32_t* __restrict__ gap, const int32_t* __restrict__ ins,
    const int32_t* __restrict__ ns, const int8_t* __restrict__ own,
    const int32_t* __restrict__ gp, const int32_t* __restrict__ c4,
    const int8_t* __restrict__ seqs, const int32_t* __restrict__ lob,
    const int32_t* __restrict__ a_chunks,
    const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ ncols_p, int n_rows, int n_cols,
    int lpad, int n_chunks, int w, int chunk, int w2,
    int32_t* __restrict__ codes, int32_t* __restrict__ final_band,
    int32_t* __restrict__ final_a) {
  extern __shared__ int rr_smem[];
  int* band_s = rr_smem;                       // [w2]
  int* warp_s = rr_smem + w2;                  // [2][kWarps]
  int* seq_s = warp_s + 2 * kWarps;            // [chunk]
  int* lob_s = seq_s + chunk;                  // [chunk]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * K;
  const int ncols = *ncols_p;
  const int len = lengths[b];
  const int32_t* gap_r = gap + (int64_t)b * n_cols;
  const int32_t* ins_r = ins + (int64_t)b * n_cols;
  const int32_t* ns_r = ns + (int64_t)b * n_cols;
  const int8_t* own_r = own + (int64_t)b * n_cols;
  const int32_t* gp_r = gp + (int64_t)b * (n_cols + 1);

  int band[K], gapw[K], insw[K], gy1[K];
  int sc0[K], sc1[K], sc2[K], sc3[K];
  unsigned word[K];
  unsigned valid = 0, okins = 0;   // bit k: lane j0+k
#pragma unroll
  for (int k = 0; k < K; ++k) band[k] = 0;
  int prev_a = 0, a = 0;
  int bdiag = kBig;    // lane 0's diag predecessor at a chunk's start
  int bleft = kBig;    // band value of lane j0-1 (the left neighbour)
  int par = 0;

  for (int ci = 0; ci < n_chunks; ++ci) {
    a = a_chunks[b * n_chunks + ci];
    for (int i = tid; i < chunk; i += kThreads) {
      seq_s[i] = seqs[(int64_t)b * lpad + ci * chunk + i];
      lob_s[i] = lob[(int64_t)b * lpad + ci * chunk + i];
    }
    // the chunk's cost window [a, a + w2), padded as the XLA fill pads
    valid = okins = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int y = a + j0 + k;
      const bool in_c = y < n_cols;
      const int nsv = in_c ? ns_r[y] : 0;
      const int ow = in_c ? own_r[y] : 5;
      gapw[k] = in_c ? gap_r[y] : 0;
      insw[k] = in_c ? ins_r[y] : 0;
      gy1[k] = gp_r[y + 1 < n_cols ? y + 1 : n_cols];
      sc0[k] = nsv - ((in_c ? c4[y * 4 + 0] : 0) - (ow == 0));
      sc1[k] = nsv - ((in_c ? c4[y * 4 + 1] : 0) - (ow == 1));
      sc2[k] = nsv - ((in_c ? c4[y * 4 + 2] : 0) - (ow == 2));
      sc3[k] = nsv - ((in_c ? c4[y * 4 + 3] : 0) - (ow == 3));
      if (y < ncols && j0 + k < w2) valid |= 1u << k;
      if (y > 0 && y < ncols - 1) okins |= 1u << k;
    }
    // gy1 of lane j0-1: the left neighbour's m from this thread's
    // exclusive prefix
    const int ym1 = a + j0;      // gp index (j0 - 1) + 1
    const int gy1m1 = gp_r[ym1 < n_cols ? ym1 : n_cols];

    // chunk-boundary band shift (d >= 0) with the jump rule above the
    // old top, and the band-bottom diagonal carry (see staircase_fill)
    if (ci > 0) {
      const int d = imin(a - prev_a < 0 ? 0 : a - prev_a, w2 + 1);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j0 + k < w2) band_s[j0 + k] = band[k];
      __syncthreads();
      const int lastcol = band_s[w2 - 1];
      const int gt = prev_a + w2;
      const int gtop = gp_r[gt < n_cols ? gt : n_cols];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int jj = j0 + k + d;
        band[k] = jj < w2 ? band_s[jj] : lastcol + (gy1[k] - gtop);
      }
      if (tid == 0) {
        const int g0 = gy1[0] - gapw[0];
        bdiag = d == 0 ? kBig
                       : (d - 1 >= w2 ? lastcol + (g0 - gtop)
                                      : band_s[d - 1]);
      }
      __syncthreads();
    } else {
      bdiag = kBig;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (j0 + k < w2) band_s[j0 + k] = band[k];
    __syncthreads();
    bleft = (tid > 0 && j0 - 1 < w2) ? band_s[j0 - 1] : kBig;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < K; ++k) word[k] = 0u;
    for (int tt = 0; tt < chunk; ++tt) {
      const int x = ci * chunk + tt;
      const int s = seq_s[tt];
      const int lo = lob_s[tt];
      const bool first = x == 0;
      const bool active = x < len;
      const bool is_last = x == len - 1;
      const int prevb = tid == 0 ? (tt == 0 ? bdiag : kBig) : bleft;
      int diag[K], v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int y = a + j0 + k;
        const int dp = first ? 0 : (k == 0 ? prevb : band[k - 1]);
        const int up = first ? 0 : band[k];
        const int sc = s == 0 ? sc0[k]
                     : s == 1 ? sc1[k]
                     : s == 2 ? sc2[k] : sc3[k];
        const int dg = dp + sc;
        int av = imin(dg, ((okins >> k) & 1u) ? up + insw[k] : kBig);
        const bool inband = y >= lo && y < lo + w;
        av = (((valid >> k) & 1u) && inband) ? av : kBig;
        diag[k] = dg;
        v[k] = av - gy1[k];
      }
#pragma unroll
      for (int k = 1; k < K; ++k) v[k] = imin(v[k], v[k - 1]);
      int inc = v[K - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc = imin(inc, n);
      }
      int ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 0x7fffffff;
      if (lane == 31) warp_s[par * kWarps + warp] = inc;
      __syncthreads();
      for (int q = 0; q < warp; ++q) ex = imin(ex, warp_s[par * kWarps + q]);
      par ^= 1;

      const int left0 = tid == 0 ? kBig : ex + gy1m1;
      const int sh = 2 * (tt & 15);
      int prev_m = left0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int m = imin(ex, v[k]) + gy1[k];
        const bool gap_hit =
            m == prev_m + gapw[k] || (is_last && m == prev_m);
        const unsigned code = gap_hit ? 0u : (m == diag[k] ? 1u : 2u);
        word[k] |= code << sh;
        if (active) band[k] = m;
        prev_m = m;
      }
      if (active) bleft = left0;
      if ((tt & 15) == 15) {
        int32_t* out = codes + ((int64_t)(x >> 4) * n_rows + b) * w2;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (j0 + k < w2) out[j0 + k] = (int32_t)word[k];
          word[k] = 0u;
        }
      }
    }
    prev_a = a;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < w2) final_band[(int64_t)b * w2 + j0 + k] = band[k];
  if (tid == 0) final_a[b] = a;
}

}  // namespace rr
