// Device helpers shared by the port's kernels (asw_kernel.cu,
// asw_sep_kernel.cu, asw_dlanes_kernel.cu, asw_sym_dlanes_kernel.cu): the
// multiply-high division and the cp.async stage copy, the raw matching cost
// of one tap, the bilateral weight, the online left-view WTA state, the
// right-view fold, the symmetric register tiles' right-weight loads and
// window-row accumulation, and the WTA of an aggregated tile held in shared
// memory.
//
// Numerics: float32, IEEE division; no fast math.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kThird = 1.f / 3.f;  // (float)(1 / 3), as the TPU kernels round it

// i / d by a multiply-high, exact for i * d < 2^32 (the indices here are
// below 2^20 and d below 2^12); a runtime integer division costs ~20
// instructions per element of the build loops.
struct FastDiv {
  unsigned d, m;
};

__host__ __device__ inline FastDiv fast_div(unsigned d) {
  return {d, d == 1 ? 0u : (unsigned)(0xFFFFFFFFu / d + 1)};
}

__device__ __forceinline__ unsigned operator/(unsigned i, FastDiv f) {
  return f.d == 1 ? i : __umulhi(i, f.m);
}

// 4-byte asynchronous copy from global to shared memory (sm_80 and
// later), and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// TAD + gradient (or AD) cost of one tap from the left sample (l0, l1, l2,
// lg) and the right sample (r0, r1, r2, rg).  P carries cost_ad, alpha,
// one_minus_alpha, tau_color and tau_grad.  With kUnfused the two products
// and their sum are rounded one by one, as the plain version's separate
// tensor ops round them, instead of contracting into an FMA: the raw cost
// is then the plain version's bit for bit, which a kernel that rounds it
// to bfloat16 needs (a last-bit difference can move the bf16 rounding by a
// whole bf16 step).
template <bool kUnfused = false, class P>
__device__ __forceinline__ float tap_cost(const P& p, float l0, float l1,
                                          float l2, float lg, float r0,
                                          float r1, float r2, float rg) {
  float ad = (fabsf(l0 - r0) + fabsf(l1 - r1) + fabsf(l2 - r2)) * kThird;
  if (p.cost_ad) return ad;
  const float tc = fminf(ad, p.tau_color);
  const float tg = fminf(fabsf(lg - rg), p.tau_grad);
  if (kUnfused)
    return __fadd_rn(__fmul_rn(p.alpha, tc), __fmul_rn(p.one_minus_alpha, tg));
  return p.alpha * tc + p.one_minus_alpha * tg;
}

// Bilateral weight of a tap: the color factor exp(-|Lab(tap) - Lab(centre)|
// / gamma_c), with 1 / gamma_c rounded to float32 (p.inv_gamma_color), times
// the spatial factor.  The tap (a0, a1, a2) and centre (c0, c1, c2) are Lab.
template <class P>
__device__ __forceinline__ float bilateral(const P& p, float a0, float a1,
                                           float a2, float c0, float c1,
                                           float c2, float spatial) {
  float e0 = a0 - c0, e1 = a1 - c1, e2 = a2 - c2;
  float d2 = e0 * e0 + e1 * e1 + e2 * e2;
  return expf(-sqrtf(d2) * p.inv_gamma_color) * spatial;
}

// Online WTA over d in ascending order (asw_kernel.py:275-323): the
// first-occurrence argmin, the parabola triple (C at bestd - 1 and
// bestd + 1) and the three next-best (cost, d) pairs for ubest.
struct Wta {
  float bestc, cm, cp, prev;
  int bestd;
  float c1, c2, c3;
  int d1, d2, d3;

  __device__ Wta()
      : bestc(INFINITY), cm(0.f), cp(0.f), prev(0.f), bestd(0),
        c1(INFINITY), c2(INFINITY), c3(INFINITY),
        d1(-9), d2(-9), d3(-9) {}

  __device__ __forceinline__ void update(float agg, int d) {
    // Pending C(d*+1) capture, then strict-< update.
    if (bestd == d - 1) cp = agg;
    const bool better = agg < bestc;
    if (better) cm = prev;
    // Sorted insert into ranks 1..3 below the best (ubest tracking).
    const bool lt1 = agg < c1, lt2 = agg < c2, lt3 = agg < c3;
    const float n3c = lt2 ? c2 : (lt3 ? agg : c3);
    const int n3d = lt2 ? d2 : (lt3 ? d : d3);
    const float n2c = lt1 ? c1 : (lt2 ? agg : c2);
    const int n2d = lt1 ? d1 : (lt2 ? d : d2);
    const float n1c = better ? bestc : (lt1 ? agg : c1);
    const int n1d = better ? bestd : (lt1 ? d : d1);
    c3 = n3c; d3 = n3d; c2 = n2c; d2 = n2d; c1 = n1c; d1 = n1d;
    if (better) {
      bestc = agg;
      bestd = d;
    }
    prev = agg;
  }

  // Second-best cost excluding d within +-1 of the final winner.
  __device__ __forceinline__ float ubest() const {
    float u = INFINITY;
    if (abs(d1 - bestd) > 1) u = fminf(u, c1);
    if (abs(d2 - bestd) > 1) u = fminf(u, c2);
    if (abs(d3 - bestd) > 1) u = fminf(u, c3);
    return u;
  }
};

// Right view: fold the candidate C_R(x - d, d) = agg into its pixel's slot
// with an atomicMin on (float bits << 32 | d).  Costs are >= 0, so the
// unsigned order of the packed word is (cost, then lower d): the
// first-occurrence argmin over d, whatever the order blocks run in.
__device__ __forceinline__ void fold_right(unsigned long long* slot, float agg,
                                           int d) {
  const unsigned long long packed =
      ((unsigned long long)__float_as_uint(agg) << 32) | (unsigned)d;
  // Values only decrease, so a stale read can only cause a needless
  // atomic, never a skipped one.
  if (packed < *slot) atomicMin(slot, packed);
}

// The two edge-extended channel stacks every kernel takes: ls (7, H, WL),
// WL = W + 2r, and rs (7, H, WR), WR = WL + D - 1; PL and PR are their
// plane strides.
struct Stacks {
  const float* ls;
  const float* rs;
  int WL, WR;
  size_t PL, PR;
};

// Raw cost at row yy, ls column col (image column col - r), disparity d:
// the right sample is rs column col + D - 1 - d.  Unfused (tap_cost<true>),
// so it equals the plain version's raw cost bit for bit.
template <class P>
__device__ __forceinline__ float stack_cost(const P& p, const Stacks& s, int yy,
                                            int col, int d, int D) {
  const float* lt = s.ls + (size_t)yy * s.WL + col;
  const float* rt = s.rs + (size_t)yy * s.WR + col + D - 1 - d;
  return tap_cost<true>(p, lt[0], lt[s.PL], lt[2 * s.PL], lt[3 * s.PL], rt[0],
                        rt[s.PR], rt[2 * s.PR], rt[3 * s.PR]);
}

// The register tile of the symmetric kernels (asw_kernel.cu, and
// asw_sym_dlanes_kernel.cu): each thread owns kTileCols columns xb + i and
// kTileDisps disparities in two runs of 4, d_j = db + j (j < 4) and
// db + DC/2 + j - 4 (j >= 4) of a d-chunk of DC, so that a quarter-warp's
// 16-byte loads of a cost row or a right-weight window are one contiguous
// 128-byte line.
constexpr int kTileCols = 4;
constexpr int kTileDisps = 8;

__device__ __forceinline__ void load8(float (&v)[kTileDisps], const float* row,
                                      int db, int dh) {
  const float4 a = *reinterpret_cast<const float4*>(row + db);
  const float4 b = *reinterpret_cast<const float4*>(row + db + dh);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The right weights of a register tile (kTileCols x kTileDisps, the
// disparities in two runs of 4, db and db + dh): rv[0] holds row entries
// c .. c + 7, rv[1] entries c - dh .. c - dh + 7, with c the tile's base
// right index (16-byte aligned); (column xb + i, d_j) takes
// rv[j / 4][4 + i - j % 4].
__device__ __forceinline__ void load_right(float (&rv)[2][8], const float* wrow,
                                           int dh) {
  const float4 a0 = *reinterpret_cast<const float4*>(wrow);
  const float4 a1 = *reinterpret_cast<const float4*>(wrow + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(wrow - dh);
  const float4 b1 = *reinterpret_cast<const float4*>(wrow - dh + 4);
  rv[0][0] = a0.x; rv[0][1] = a0.y; rv[0][2] = a0.z; rv[0][3] = a0.w;
  rv[0][4] = a1.x; rv[0][5] = a1.y; rv[0][6] = a1.z; rv[0][7] = a1.w;
  rv[1][0] = b0.x; rv[1][1] = b0.y; rv[1][2] = b0.z; rv[1][3] = b0.w;
  rv[1][4] = b1.x; rv[1][5] = b1.y; rv[1][6] = b1.z; rv[1][7] = b1.w;
}

// One window row (or a run of K of its taps) of symmetric ASW:
// num / den[i][j] += t * C, t = wl * wr, for dx ascending, for the thread's
// columns xb + i and disparities d_j.  cost[u * DC + dl] is the raw cost
// of tile column u (the tap of column x at dx is u = x + dx) and d-chunk
// offset dl; wl[dx * TX + x] the left weights; wr[dx * NC + c] the right
// weights of right centre c = x - dl + DC.
__device__ __forceinline__ void accumulate_sym(
    float (&num)[kTileCols][kTileDisps], float (&den)[kTileCols][kTileDisps],
    const float* cost, const float* wl, const float* wr, int xb, int db, int K,
    int DC, int NC, int TX) {
  constexpr int XT = kTileCols, DT = kTileDisps;
  const int dh = DC / 2;
  // win[(dx + i) % 4] holds cost row xb + dx + i.
  float win[XT][DT];
#pragma unroll
  for (int i = 0; i < XT - 1; ++i) load8(win[i], cost + (xb + i) * DC, db, dh);
  // Right centres of (xb + i, d_j) are cb + 4 + i - j (first run) and
  // cb - dh + 4 + i - (j - 4) (second run).
  const int cb = xb - db - 4 + DC;
  for (int dx0 = 0; dx0 < K; dx0 += XT) {
#pragma unroll
    for (int u = 0; u < XT; ++u) {
      const int dx = dx0 + u;
      if (dx < K) {
        load8(win[(u + XT - 1) % XT], cost + (xb + dx + XT - 1) * DC, db, dh);
        const float4 l = *reinterpret_cast<const float4*>(wl + dx * TX + xb);
        const float lv[XT] = {l.x, l.y, l.z, l.w};
        float rv[2][8];
        load_right(rv, wr + dx * NC + cb, dh);
#pragma unroll
        for (int i = 0; i < XT; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            const float t = lv[i] * rv[j / 4][4 + i - j % 4];
            den[i][j] += t;
            num[i][j] = fmaf(t, win[(u + i) % XT][j], num[i][j]);
          }
      }
    }
  }
}

// The wide register tile of asw_sym_dlanes_kernel.cu: each thread owns
// kWideCols columns xb + i and kWideDisps consecutive disparities db + j of
// a d-chunk.  A warp's threads take consecutive disparity groups of one
// column group, so that its loads of the left weights are broadcasts and
// its loads of a cost row and of the right weights are contiguous: per
// window column, one 16-byte load of a new cost row, two of left weights
// and three of right weights feed 32 taps, against seven for
// accumulate_sym's 4 x 8 tile.  The taps and their order per output are
// accumulate_sym's.
constexpr int kWideCols = 8;
constexpr int kWideDisps = 4;

// num / den[i][j] += t * C, t = wl * wr, for dx ascending, for columns
// xb + i and disparities db + j: cost[u * DC + dl] is the raw cost of tile
// column u (the tap of column x at dx is u = x + dx) and d-chunk offset
// dl; wl[dx * TX + x] the left weights; wr[dx * NC + c] the right weights
// of right centre c = x - dl + DC.
__device__ __forceinline__ void accumulate_sym_wide(
    float (&num)[kWideCols][kWideDisps], float (&den)[kWideCols][kWideDisps],
    const float* cost, const float* wl, const float* wr, int xb, int db, int K, int DC,
    int NC, int TX) {
  constexpr int XW = kWideCols, DW = kWideDisps;
  // win[(dx + i) % 8] holds cost row xb + dx + i.
  float win[XW][DW];
#pragma unroll
  for (int i = 0; i < XW - 1; ++i) {
    const float4 c = *reinterpret_cast<const float4*>(cost + (xb + i) * DC + db);
    win[i][0] = c.x; win[i][1] = c.y; win[i][2] = c.z; win[i][3] = c.w;
  }
  // The right centre of (xb + i, db + j) is cb + 4 + i - j.
  const int cb = xb - db - 4 + DC;
  for (int dx0 = 0; dx0 < K; dx0 += XW) {
#pragma unroll
    for (int u = 0; u < XW; ++u) {
      const int dx = dx0 + u;
      if (dx < K) {
        const float4 c = *reinterpret_cast<const float4*>(cost + (xb + dx + XW - 1) * DC + db);
        float* nw = win[(u + XW - 1) % XW];
        nw[0] = c.x; nw[1] = c.y; nw[2] = c.z; nw[3] = c.w;
        const float4 l0 = *reinterpret_cast<const float4*>(wl + dx * TX + xb);
        const float4 l1 = *reinterpret_cast<const float4*>(wl + dx * TX + xb + 4);
        const float lv[XW] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const float* wrow = wr + dx * NC + cb;
        const float4 r0 = *reinterpret_cast<const float4*>(wrow);
        const float4 r1 = *reinterpret_cast<const float4*>(wrow + 4);
        const float4 r2 = *reinterpret_cast<const float4*>(wrow + 8);
        const float rv[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                              r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
        for (int i = 0; i < XW; ++i)
#pragma unroll
          for (int j = 0; j < DW; ++j) {
            const float t = lv[i] * rv[4 + i - j];
            den[i][j] += t;
            num[i][j] = fmaf(t, win[(u + i) % XW][j], num[i][j]);
          }
      }
    }
  }
}

// Left-view WTA and right-view fold of one block's aggregated tile:
// agg[s * stride + d] (s < ncols, d < D) is the aggregated cost of output
// pixel (y, x0 + s) at disparity d; columns x0 + s >= W are never read.
// Every thread of the block calls it, after the barrier that follows the
// tile's last write.  One thread per column runs the online WTA over d
// ascending; one thread per right column x' in [x0 - D + 1, x0 + ncols)
// takes the first-occurrence minimum of its candidates C_L(x' + d, d) that
// lie in this tile and folds it in with one atomicMin, so the tiles of a
// row combine into the right view's first-occurrence argmin.  wta_tile_lanes
// is the same with the work spread over lanes lane, lane + nlanes, ... of
// the block (a block that holds several rows gives each row its threads).
__device__ __forceinline__ void wta_tile_lanes(const float* agg, int stride,
                                               int ncols, int x0, int y, int W,
                                               int D, int* bestd, float* bestc,
                                               float* cm, float* cp, float* ubest,
                                               unsigned long long* rpack,
                                               int lane, int nlanes) {
  for (int s = lane; s < ncols && x0 + s < W; s += nlanes) {
    Wta wta;
    for (int d = 0; d < D; ++d) wta.update(agg[s * stride + d], d);
    const size_t o = (size_t)y * W + x0 + s;
    bestd[o] = wta.bestd;
    bestc[o] = wta.bestc;
    cm[o] = wta.cm;
    cp[o] = wta.cp;
    ubest[o] = wta.ubest();
  }
  const int xend = min(x0 + ncols, W);  // past the tile's last real column
  for (int k = lane; k < ncols + D - 1; k += nlanes) {
    const int xr = x0 - (D - 1) + k;
    if (xr < 0) continue;
    const int hi = min(D - 1, xend - 1 - xr);
    float bc = INFINITY;
    int bd = -1;
    for (int d = max(0, x0 - xr); d <= hi; ++d) {
      const float a = agg[(xr + d - x0) * stride + d];
      if (a < bc) {
        bc = a;
        bd = d;
      }
    }
    if (bd >= 0) fold_right(rpack + (size_t)y * W + xr, bc, bd);
  }
}

// The end of one d-chunk of a block of rows (asw_sym_dlanes_kernel.cu):
// agg[(t * TX + x) * AS + d - d0] is the aggregated cost of output pixel
// (y0 + t, x0 + x) at d in [d0, dend), for rows t < nrows.  Left view: the
// online WTA of each column over this chunk's d, its state read from
// state[t * TX + x] unless the chunk is the first and written back unless
// it is the last; right view: per right column x' and output row, the
// first-occurrence minimum of the candidates C_L(x' + d, d) with d in this
// chunk and x' + d in this tile, folded in with one atomicMin.  Lanes
// lane, lane + nlanes, ... of the block share the work.
__device__ __forceinline__ void wta_chunk_rows(
    const float* agg, int AS, Wta* state, bool first, bool last, int TX, FastDiv byTX,
    int nrows, int x0, int y0, int W, int d0, int dend, int* bestd, float* bestc, float* cm,
    float* cp, float* ubest, unsigned long long* rpack, int lane, int nlanes) {
  for (int c = lane; c < nrows * TX; c += nlanes) {
    const int t = (unsigned)c / byTX, x = x0 + c - t * TX;
    if (x >= W) continue;
    Wta w = first ? Wta() : state[c];
    for (int d = d0; d < dend; ++d) w.update(agg[c * AS + d - d0], d);
    if (!last) {
      state[c] = w;
      continue;
    }
    const size_t o = (size_t)(y0 + t) * W + x;
    bestd[o] = w.bestd;
    bestc[o] = w.bestc;
    cm[o] = w.cm;
    cp[o] = w.cp;
    ubest[o] = w.ubest();
  }
  const int xend = min(x0 + TX, W);
  const int NR = TX + dend - d0 - 1;
  const FastDiv byNR = fast_div(NR);
  for (int k = lane; k < nrows * NR; k += nlanes) {
    const int t = (unsigned)k / byNR, xr = x0 - (dend - 1) + k - t * NR;
    if (xr < 0) continue;
    const int hi = min(dend - 1, xend - 1 - xr);
    float bc = INFINITY;
    int bd = -1;
    for (int d = max(d0, x0 - xr); d <= hi; ++d) {
      const float a = agg[(t * TX + xr + d - x0) * AS + d - d0];
      if (a < bc) {
        bc = a;
        bd = d;
      }
    }
    if (bd >= 0) fold_right(rpack + (size_t)(y0 + t) * W + xr, bc, bd);
  }
}

__device__ __forceinline__ void wta_tile(const float* agg, int stride, int ncols,
                                         int x0, int y, int W, int D,
                                         int* bestd, float* bestc, float* cm,
                                         float* cp, float* ubest,
                                         unsigned long long* rpack) {
  wta_tile_lanes(agg, stride, ncols, x0, y, W, D, bestd, bestc, cm, cp, ubest,
                 rpack, threadIdx.x, blockDim.x);
}

__global__ void unpack_right_kernel(const unsigned long long* __restrict__ rpack,
                                    int* __restrict__ rbestd, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // Every right pixel x' has at least the candidate d = 0 from left x = x'.
  if (i < n) rbestd[i] = (int)(rpack[i] & 0xffffffffull);
}

}  // namespace
