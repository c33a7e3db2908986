// Fused cost + exact ASW (or box) aggregation + online dual-view WTA.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_kernel.py
// (body _kernel and _accumulate, launched by wta_outputs_from_stacks).  It
// computes what that kernel computes, for every mode and geometry it takes
// (symmetric ASW, left-only ASW, box; TAD + gradient or AD; any D >= 1,
// r >= 0), and keeps the idea that kernel had, not its Mosaic layout: the
// raw costs of a tile are built once and reused by every window that covers
// them, and a window row's weights once and reused for every d.  The
// H x W x D volume never exists.
//
//   num[y,x,d] = sum_(dy,dx) wL(y,x; dy,dx) wR(y,x-d; dy,dx) C[clamp(y+dy-r), x+dx-r, d]
//   den[y,x,d] = sum_(dy,dx) wL(y,x; dy,dx) wR(y,x-d; dy,dx)
//
// (left-only: wR = 1, so den depends on (y, x) only; box: both weights 1
// and the sum times (float)(1 / K^2)).
//
// Inputs (all float32, contiguous, one card):
//   ls  (7, H, W + 2r)          left stack: R, G, B, x-gradient, L, a, b
//   rs  (7, H, W + 2r + D - 1)  right stack, r + D - 1 extra columns left
//   sw  (K, K)                  spatial factor exp(-|o| / gamma_p)
// Column j of ls is image column j - r; column j of rs is j - r - D + 1;
// the pad columns are edge replicas (the virtual padded planes of
// config.py).  A y-tap reads the clamped row min(max(y + dy - r, 0), H - 1).
//
// Outputs, (H, W) each: bestd, bestc, cm (C at bestd-1), cp (C at bestd+1),
// ubest (second-best cost excluding bestd +- 1); and rpack, (H, W + D - 1),
// the right view over x' in [-(D-1), W): candidate C_R(x', d) = C_L(x' + d,
// d) folded in with an atomicMin on (float bits << 32 | d), the
// first-occurrence argmin over d, unpacked into rbestd and, for the
// sharded layouts, rbestc and the strip of x' < 0.
//
// The shard inputs (asw_kernel.py:466-473 of the TPU kernel, :270-298):
// left columns at or past n_valid feed no right-view candidate; only d in
// the window [d_lo, d_hi) may win either view (bestd starts at d_lo), while
// every d's plane is still computed and still feeds the pending cp and the
// cm of the next plane, so a d-slab's overlap planes give the triple.  The
// unsharded call (n_valid = W, the window [0, D)) computes what it computed
// without them, bit for bit.
//
// Design.  The tile plan (TY, TX, DC, KX) comes from the wrapper
// (asw_kernel.py::tile_plan), which sizes it to the geometry and the
// 232,448 bytes of shared memory a block may have; this entry checks it and
// refuses a plan that cannot run.  One block covers TY output rows x TX
// columns and walks d in chunks of DC <= 128, with TY * (TX / 4) * (DC / 8)
// <= 512 threads, each owning a 4-column x 8-disparity register tile of
// one output row (num and den; the disparities in two runs of 4, so that
// a quarter-warp's 16-byte loads are one 128-byte line; asw_common.cuh).
// For each d-chunk the block walks the TY + 2r stack rows its windows
// touch, in runs of KX window columns (KX = K unless K is too large for
// shared memory).  Per stage (stack row, run):
//   1. build, from the stage's stack rows already in shared memory:
//      - the raw-cost row, TX + KX - 1 columns x DC disparities, once for
//        all TY output rows that read it (K times per row in a one-row
//        design), unfused (tap_cost<true>, stack_cost's arithmetic), so
//        each raw cost is the plain version's bit for bit;
//      - for each output row t whose window covers the stack row, its left
//        weights, KX x TX, and its right weights for the TX + DC right
//        centres x0 - d0 - DC + c, KX x (TX + DC) (symmetric only);
//   2. barrier; start the cp.async copies of the next stage's stack rows
//      (the seven planes over the tile's columns) into the second of two
//      small buffers;
//   3. every thread of the output rows the stage covers runs its register
//      tile over the run: t = wl * wr, den += t, num = fma(t, C, num) for
//      dx ascending (left-only: num = fma(wl, C, num) and den += wl once
//      per (pixel, tap); box: num += C);
//   4. wait for the copies; barrier.
// So the global-memory latency of the build's inputs hides behind the
// FMAs, and the build itself reads shared memory only.  The stage arrays
// are not double-buffered: two copies of them (117 KB each at KITTI, two
// rows) would not fit, and at one row they halve the warps per SM, which
// measured 1.2-1.7x slower.  At the end of a chunk the aggregated
// TY x TX x DC tile goes to shared memory.  The thread that owns column c
// (c = tid; a separate instantiation, MULTI, for D > DC) carries that
// column's online Wta state (best, parabola triple, prev, the pending cp,
// the three next-best) across chunks in registers, and the right view is
// folded once per (tile, chunk) with the first-occurrence atomicMin.
//
// Tensor cores: none.  The tile is FP32 SIMT.  In symmetric mode the tap
// sum is no product of two matrices (the weight depends on x - d); TF32
// would break the f32 contract; 3xTF32 for the left-only and box modes'
// banded product is a question for a later change.
//
// What bounds it on an H100: issue slots and shared-memory wavefronts, not
// bytes (the two stacks of a KITTI pair are about 28 MB and stay in L2).
// At KITTI (1242x375, D=128, r=16) in symmetric mode the function's least
// work is 4.046 ms at the FP32 peak (k1_bound in chip_smoke.py).  This
// design's instruction count there, at the plan TY=2, TX=64, DC=128:
//   - taps: 3 FP32 instructions per (pixel, d, tap) plus 7 16-byte
//     shared-memory loads per 96 of them, ~6.1 G + ~0.5 G warp
//     instructions, a ~6 ms floor for any FP32-SIMT design (the loads
//     take 28 shared-memory wavefronts per 24 cycles of FP32 work);
//   - weights: (TX + TX + DC) / TX = 4 per (pixel, tap), ~40 instructions
//     each (IEEE sqrtf and expf, 6 shared-memory reads, indices): ~2.5 G;
//   - raw costs: (TY + 2r) / TY x (TX + 2r) / TX = 25.5 per (pixel, d),
//     ~26 instructions each: ~1.2 G.
// Widening TX to cut the right-weight redundancy (TX + DC) / TX needs more
// registers per block than the card has at TY=2, and a cluster sharing
// the right-weight window through distributed shared memory would save
// ~0.6 G of ~10 G; neither was taken.  ptxas (sm_90a, the 128-register cap
// of __launch_bounds__(512, 1)), with the windowed WTA: symmetric 128
// registers, left-only 116, box 104, no spills; the MULTI instantiations
// (D > 128): symmetric 128 registers with 464 / 1112 bytes of spill stores
// / loads, left-only 128 with 28 / 92, box 126 and none.  The plans' times
// are in PERF.md (section 6).
//
// Determinism: each output sums its taps in one fixed (dy, then dx) order
// whatever the tile plan; every column WTA runs d ascending across chunks;
// the right view's atomicMin picks (cost, then lower d) whatever the
// block order.  A batch equals single calls, and two plans give the same
// bits; in symmetric mode the arithmetic is K4's, term for term.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division (this file
// must not be built with --use_fast_math).  The weight product is
// (colorL * sw) * (colorR * sw), then num / den, as the plain version.

#include "asw_common.cuh"

namespace {

constexpr int XT = kTileCols;
constexpr int DT = kTileDisps;
constexpr int MAX_THREADS = 512;
constexpr int MAX_DC = 128;
constexpr int NPLANES = 7;  // R, G, B, x-gradient, L, a, b

enum Mode { kSymmetric = 0, kLeftOnly = 1, kBox = 2 };

struct Params {
  int H, W, r, D, K;
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
  float inv_n;            // (float)(1 / K^2), box mode
  int n_valid;            // left columns that feed the right view
  int d_lo, d_hi;         // the window of d's that may win
};

// The tile plan: TY output rows x TX columns per block, d-chunks of DC,
// runs of KX window columns.
struct Plan {
  int TY, TX, DC, KX;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Float offsets of the block's shared-memory arrays:
//   [0, stage)    raw-cost rows (TX + KX - 1) x DC, left weights
//                 TY x KX x TX (ASW), right weights TY x KX x NC
//                 (symmetric); after the last stage of a chunk, the
//                 aggregated tile TY x TX x (DC + 1) over them;
//   in[2]         the stack rows of a stage, two buffers: the left planes
//                 over LW = TX + KX - 1 columns, the right ones over
//                 RW = TX + DC + KX - 1 columns;
//   lctr, rctr    the window centres' Lab, 3 x TY x TX and 3 x TY x NC.
struct Layout {
  int wl, wr, in0, in1, lctr, rctr, total;
  int LW, RW;
};

Layout layout(const Plan& q, int mode) {
  Layout L;
  const int NC = q.TX + q.DC;
  L.LW = q.TX + q.KX - 1;
  L.RW = NC + q.KX - 1;
  L.wl = L.LW * q.DC;
  L.wr = L.wl + (mode != kBox ? q.TY * q.KX * q.TX : 0);
  const int stage = L.wr + (mode == kSymmetric ? q.TY * q.KX * NC : 0);
  const int agg = q.TY * q.TX * (q.DC + 1);
  L.in0 = round4(stage > agg ? stage : agg);
  const int in = round4(NPLANES * (L.LW + L.RW));
  L.in1 = L.in0 + in;
  L.lctr = L.in1 + in;
  L.rctr = L.lctr + (mode != kBox ? round4(3 * q.TY * q.TX) : 0);
  L.total = L.rctr + (mode == kSymmetric ? round4(3 * q.TY * NC) : 0);
  return L;
}

// The online WTA with only d in [lo, hi) allowed to win (the TPU kernel's
// in_win, asw_kernel.py:275-298): an out-of-window plane still completes
// a pending cp and becomes the prev a later winner's cm reads, but never
// wins and never enters the next-best ranks.  Over the window [0, D) it is
// Wta::update.  K1's own, so that the kernels sharing Wta compile as they
// did.
__device__ __forceinline__ Wta window_wta(int lo) {
  Wta w;
  w.bestd = lo;
  return w;
}

__device__ __forceinline__ void window_update(Wta& w, float agg, int d, int lo,
                                              int hi) {
  if (d >= lo && d < hi) {
    w.update(agg, d);
    return;
  }
  if (w.bestd == d - 1) w.cp = agg;
  w.prev = agg;
}

// Left-only: num[i][j] = fma(wl, C, num), den[i] += wl, dx ascending.
__device__ __forceinline__ void accumulate_left(float (&num)[XT][DT],
                                                float (&den)[XT],
                                                const float* cost,
                                                const float* wl, int xb, int db,
                                                int K, int DC, int TX) {
  const int dh = DC / 2;
  float win[XT][DT];
#pragma unroll
  for (int i = 0; i < XT - 1; ++i) load8(win[i], cost + (xb + i) * DC, db, dh);
  for (int dx0 = 0; dx0 < K; dx0 += XT) {
#pragma unroll
    for (int u = 0; u < XT; ++u) {
      const int dx = dx0 + u;
      if (dx < K) {
        load8(win[(u + XT - 1) % XT], cost + (xb + dx + XT - 1) * DC, db, dh);
        const float4 l = *reinterpret_cast<const float4*>(wl + dx * TX + xb);
        const float lv[XT] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int i = 0; i < XT; ++i) {
          den[i] += lv[i];
#pragma unroll
          for (int j = 0; j < DT; ++j)
            num[i][j] = fmaf(lv[i], win[(u + i) % XT][j], num[i][j]);
        }
      }
    }
  }
}

// Box: num[i][j] += C, dx ascending.
__device__ __forceinline__ void accumulate_box(float (&num)[XT][DT],
                                               const float* cost, int xb,
                                               int db, int K, int DC) {
  const int dh = DC / 2;
  float win[XT][DT];
#pragma unroll
  for (int i = 0; i < XT - 1; ++i) load8(win[i], cost + (xb + i) * DC, db, dh);
  for (int dx0 = 0; dx0 < K; dx0 += XT) {
#pragma unroll
    for (int u = 0; u < XT; ++u) {
      const int dx = dx0 + u;
      if (dx < K) {
        load8(win[(u + XT - 1) % XT], cost + (xb + dx + XT - 1) * DC, db, dh);
#pragma unroll
        for (int i = 0; i < XT; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j) num[i][j] += win[(u + i) % XT][j];
      }
    }
  }
}

// MULTI: D > DC, so the WTA state of a column is carried across d-chunks
// (a separate instantiation, so that D <= 128 does not hold it in
// registers through the stage loop).
template <int MODE, bool MULTI>
__global__ void __launch_bounds__(MAX_THREADS, 1)
asw_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
               const float* __restrict__ sw, Params p, Plan q, Layout L,
               int* __restrict__ bestd_out, float* __restrict__ bestc_out,
               float* __restrict__ cm_out, float* __restrict__ cp_out,
               float* __restrict__ ubest_out,
               unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.H, W = p.W, r = p.r, D = p.D, K = p.K;
  const int TY = q.TY, TX = q.TX, DC = q.DC, KX = q.KX;
  const int NC = TX + DC;          // right centres per output row
  const int AS = DC + 1;           // row stride of the aggregated tile (odd)
  const int DG = DC / 8;           // disparity groups of a row
  const int NTR = (TX / XT) * DG;  // threads per output row
  const int nthreads = TY * NTR;
  const FastDiv byDC = fast_div(DC), byTX = fast_div(TX), byNC = fast_div(NC);
  const int tid = threadIdx.x;
  const int ty = tid / NTR;                // the thread's output row y0 + ty
  const int xb = (tid % NTR) / DG * XT;    // its first tile column
  const int db = (tid % NTR) % DG * 4;     // and its first disparity offset
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int nrows = min(TY, H - y0);       // output rows inside the image
  const int WL = W + 2 * r, WR = WL + D - 1;
  const size_t PL = (size_t)H * WL, PR = (size_t)H * WR;  // plane strides
  const int nkx = (K + KX - 1) / KX;   // runs of window columns
  const int s_lo = y0 - r;             // stack rows s (unclamped) walked
  const int nst = (nrows + 2 * r) * nkx;  // stages: (stack row, run)
  const int nchunks = MULTI ? (D + DC - 1) / DC : 1;
  const int xend = min(x0 + TX, p.n_valid);  // past the last feeding column
  const int WP = W + D - 1;                  // rpack's row: x' in [-(D-1), W)
  const int nlp = MODE == kBox ? 4 : NPLANES;        // left planes read
  const int nrp = MODE == kSymmetric ? NPLANES : 4;  // right planes read
  float* lctr = smem + L.lctr;
  float* rctr = smem + L.rctr;

  Wta carry = window_wta(p.d_lo);  // column tid's WTA state across d-chunks (MULTI)

  for (int ch = 0; ch < nchunks; ++ch) {
    const int d0 = ch * DC;
    const int dend = min(d0 + DC, D);
    // Right columns of stage inputs start at rs column rb0 + dx0.
    const int rb0 = x0 - d0 - DC + D - 1;

    // The stack rows of stage k into in: the left planes over ls columns
    // x0 + dx0 + u (u < TX + kx - 1), the right ones over rs columns
    // rb0 + dx0 + v (v < TX + DC + kx - 1), clamped into the stacks (the
    // clamped entries feed only costs at d >= D, columns >= W + 2r or
    // zero weights).  Asynchronous: the copies land while the FMAs run.
    auto stage_in = [&](int k, float* in) {
      const int s = s_lo + k / nkx;
      const int dx0 = (k % nkx) * KX, kx = min(KX, K - dx0);
      const int yy = min(max(s, 0), H - 1);
      const float* lrow = ls + (size_t)yy * WL;
      const float* rrow = rs + (size_t)yy * WR;
      const int lw = TX + kx - 1, rw = NC + kx - 1;
      for (int c = 0; c < nlp; ++c)
        for (int u = tid; u < lw; u += nthreads)
          cp_async4(in + c * L.LW + u, lrow + c * PL + min(x0 + dx0 + u, WL - 1));
      float* rin = in + NPLANES * L.LW;
      for (int c = 0; c < nrp; ++c)
        for (int v = tid; v < rw; v += nthreads)
          cp_async4(rin + c * L.RW + v,
                    rrow + c * PR + min(max(rb0 + dx0 + v, 0), WR - 1));
    };

    // Build stage k from its stack rows: the raw-cost rows, and the
    // weights of each output row t whose window row dy = s - (y0 + t) + r
    // is in [0, K).
    auto build = [&](int k, const float* in) {
      const int s = s_lo + k / nkx;
      const int dx0 = (k % nkx) * KX, kx = min(KX, K - dx0);
      const float* rin = in + NPLANES * L.LW;
      // Raw cost of tile column u (ls column x0 + dx0 + u) at d = d0 + dl:
      // the right sample is rs column x0 + dx0 + u + D - 1 - d, right
      // input column u + DC - dl.
      const int ncost = (TX + kx - 1) * DC;
#pragma unroll 4
      for (int i = tid; i < ncost; i += nthreads) {
        const int u = (unsigned)i / byDC, dl = i - u * DC;
        const int v = u + DC - dl;
        smem[i] = d0 + dl < D && x0 + dx0 + u < WL
                      ? tap_cost<true>(p, in[u], in[L.LW + u], in[2 * L.LW + u],
                                       in[3 * L.LW + u], rin[v], rin[L.RW + v],
                                       rin[2 * L.RW + v], rin[3 * L.RW + v])
                      : 0.f;
      }
      if (MODE == kBox) return;
      const int t_lo = max(0, s - r - y0), nt = min(nrows - 1, s + r - y0) - t_lo + 1;
      const FastDiv bykx = fast_div(kx);
      // Left weight of column x0 + x and tap dx: the tap is ls column
      // x0 + x + dx, left input column x + dxl.
      const float* lab = in + 4 * L.LW;
#pragma unroll 4
      for (int i = tid; i < nt * kx * TX; i += nthreads) {
        const int row = (unsigned)i / byTX, x = i - row * TX;
        const int t_ = (unsigned)row / bykx, dxl = row - t_ * kx, t = t_lo + t_;
        const int dx = dx0 + dxl, c = t * TX + x;
        smem[L.wl + (t * KX + dxl) * TX + x] =
            x0 + x < W ? bilateral(p, lab[x + dxl], lab[L.LW + x + dxl],
                                   lab[2 * L.LW + x + dxl], lctr[c],
                                   lctr[TY * TX + c], lctr[2 * TY * TX + c],
                                   sw[(s - y0 - t + r) * K + dx])
                       : 0.f;
      }
      if (MODE != kSymmetric) return;
      // Right weight of centre xr = x0 - d0 - DC + c and tap dx: the tap is
      // rs column xr + dx + D - 1, right input column c + dxl; 0 for the
      // centres no (x, d) of the tile has.
      const float* rlab = rin + 4 * L.RW;
#pragma unroll 4
      for (int i = tid; i < nt * kx * NC; i += nthreads) {
        const int row = (unsigned)i / byNC, c = i - row * NC;
        const int t_ = (unsigned)row / bykx, dxl = row - t_ * kx, t = t_lo + t_;
        const int dx = dx0 + dxl, xr = x0 - d0 - DC + c, e = t * NC + c;
        smem[L.wr + (t * KX + dxl) * NC + c] =
            xr > -D && xr < W
                ? bilateral(p, rlab[c + dxl], rlab[L.RW + c + dxl],
                            rlab[2 * L.RW + c + dxl], rctr[e], rctr[TY * NC + e],
                            rctr[2 * TY * NC + e], sw[(s - y0 - t + r) * K + dx])
                : 0.f;
      }
    };

    // The window centres' Lab: left, row y0 + t, ls column x0 + x + r;
    // right, rs column xr + r + D - 1 of centre xr = x0 - d0 - DC + c.
    if (MODE != kBox) {
      for (int i = tid; i < TY * TX; i += nthreads) {
        const int t = (unsigned)i / byTX, x = i - t * TX;
        const float* a = ls + 4 * PL + (size_t)min(y0 + t, H - 1) * WL +
                         min(x0 + x + r, WL - 1);
        for (int c = 0; c < 3; ++c) lctr[c * TY * TX + i] = a[c * PL];
      }
    }
    if (MODE == kSymmetric) {
      for (int i = tid; i < TY * NC; i += nthreads) {
        const int t = (unsigned)i / byNC, c = i - t * NC;
        const float* a = rs + 4 * PR + (size_t)min(y0 + t, H - 1) * WR +
                         min(max(x0 - d0 - DC + c + r + D - 1, 0), WR - 1);
        for (int e = 0; e < 3; ++e) rctr[e * TY * NC + i] = a[e * PR];
      }
    }

    float num[XT][DT], den[XT][DT], denl[XT];
#pragma unroll
    for (int i = 0; i < XT; ++i) {
      denl[i] = 0.f;
#pragma unroll
      for (int j = 0; j < DT; ++j) num[i][j] = den[i][j] = 0.f;
    }

    // Per stage: build from stage k's rows; barrier; start the copies of
    // stage k + 1's rows into the other buffer; FMAs; wait; barrier.
    stage_in(0, smem + L.in0);
    cp_async_wait_all();
    __syncthreads();
    for (int k = 0; k < nst; ++k) {
      build(k, smem + ((k & 1) ? L.in1 : L.in0));
      __syncthreads();
      if (k + 1 < nst) stage_in(k + 1, smem + ((k & 1) ? L.in0 : L.in1));
      const int s = s_lo + k / nkx;
      const int dx0 = (k % nkx) * KX, kx = min(KX, K - dx0);
      const int dy = s - (y0 + ty) + r;
      if (ty < nrows && dy >= 0 && dy < K) {
        if (MODE == kSymmetric)
          accumulate_sym(num, den, smem, smem + L.wl + ty * KX * TX,
                         smem + L.wr + ty * KX * NC, xb, db, kx, DC, NC, TX);
        else if (MODE == kLeftOnly)
          accumulate_left(num, denl, smem, smem + L.wl + ty * KX * TX, xb, db,
                          kx, DC, TX);
        else
          accumulate_box(num, smem, xb, db, kx, DC);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // The aggregated tile over the stage arrays (all reads of them are
    // done): agg[(t * TX + x) * AS + dl] for d = d0 + dl.
    float* agg = smem;
    if (ty < nrows) {
#pragma unroll
      for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int dl = db + (j < 4 ? j : DC / 2 + j - 4);
          if (d0 + dl < D) {
            const float a = MODE == kBox        ? num[i][j] * p.inv_n
                            : MODE == kLeftOnly ? num[i][j] / denl[i]
                                                : num[i][j] / den[i][j];
            agg[(ty * TX + xb + i) * AS + dl] = a;
          }
        }
    }
    __syncthreads();

    // Left view: the online WTA of each column over this chunk's d.
    for (int c = tid; c < TY * TX; c += nthreads) {
      const int t = (unsigned)c / byTX, x = x0 + c - t * TX;
      if (t >= nrows || x >= W) continue;
      Wta w = MULTI ? carry : window_wta(p.d_lo);  // c == tid when MULTI
      for (int d = d0; d < dend; ++d)
        window_update(w, agg[c * AS + d - d0], d, p.d_lo, p.d_hi);
      if (MULTI) carry = w;
      if (ch == nchunks - 1) {
        const size_t o = (size_t)(y0 + t) * W + x;
        bestd_out[o] = w.bestd;
        bestc_out[o] = w.bestc;
        cm_out[o] = w.cm;
        cp_out[o] = w.cp;
        ubest_out[o] = w.ubest();
      }
    }
    // Right view: per right column x' >= -(D-1) and output row, the
    // first-occurrence minimum of the candidates C_L(x' + d, d) with d in
    // this chunk and the window and x' + d in this tile and below n_valid,
    // folded in with one atomicMin.
    const int NR = TX + DC - 1;
    const FastDiv byNR = fast_div(NR);
    const int dlo = max(d0, p.d_lo), dhi = min(dend, p.d_hi) - 1;
    for (int k = tid; k < nrows * NR; k += nthreads) {
      const int t = (unsigned)k / byNR, xr = x0 - (dend - 1) + k - t * NR;
      const int hi = min(dhi, xend - 1 - xr);
      float bc = INFINITY;
      int bd = -1;
      for (int d = max(dlo, x0 - xr); d <= hi; ++d) {
        const float a = agg[(t * TX + xr + d - x0) * AS + d - d0];
        if (a < bc) {
          bc = a;
          bd = d;
        }
      }
      if (bd >= 0) fold_right(rpack + (size_t)(y0 + t) * WP + xr + D - 1, bc, bd);
    }
    __syncthreads();  // the next chunk's build overwrites agg
  }
}

// The right view from rpack (H, W + D - 1; column x' + D - 1 holds x'):
// rbestd (H, W) for x' >= 0 and, where rbestc is not null, rbestc (H, W)
// and the strip (H, D - 1) of x' < 0.  A slot no candidate reached (still
// all-ones: out of the window, past n_valid, or left of every left column)
// reads (inf, 0), the TPU kernel's initial partial.
__global__ void unpack_right_wide_kernel(const unsigned long long* __restrict__ rpack,
                                         int H, int W, int D, int* __restrict__ rbestd,
                                         float* __restrict__ rbestc,
                                         float* __restrict__ strip_c,
                                         int* __restrict__ strip_d) {
  const int WP = W + D - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * WP) return;
  const int y = i / WP, j = i - y * WP;
  const unsigned long long word = rpack[i];
  const bool none = word == ~0ull;
  const float c = none ? INFINITY : __uint_as_float((unsigned)(word >> 32));
  const int d = none ? 0 : (int)(word & 0xffffffffull);
  if (j >= D - 1) {
    const int o = y * W + j - (D - 1);
    rbestd[o] = d;
    if (rbestc) rbestc[o] = c;
  } else if (strip_c) {
    const int o = y * (D - 1) + j;
    strip_c[o] = c;
    strip_d[o] = d;
  }
}

template <int MODE, bool MULTI>
cudaError_t launch_one(const float* ls, const float* rs, const float* sw,
                   const Params& p, const Plan& q, const Layout& L, int threads,
                   cudaStream_t s, int* bestd, float* bestc, float* cm,
                   float* cp, float* ubest, unsigned long long* rpack) {
  const size_t smem = sizeof(float) * (size_t)L.total;
  cudaError_t err = cudaFuncSetAttribute(
      asw_wta_kernel<MODE, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + q.TX - 1) / q.TX, (p.H + q.TY - 1) / q.TY);
  asw_wta_kernel<MODE, MULTI><<<grid, threads, smem, s>>>(
      ls, rs, sw, p, q, L, bestd, bestc, cm, cp, ubest, rpack);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const float* ls, const float* rs, const float* sw,
                   const Params& p, const Plan& q, const Layout& L, int threads,
                   cudaStream_t s, int* bestd, float* bestc, float* cm,
                   float* cp, float* ubest, unsigned long long* rpack) {
  if (p.D > q.DC)
    return launch_one<MODE, true>(ls, rs, sw, p, q, L, threads, s, bestd, bestc,
                                  cm, cp, ubest, rpack);
  return launch_one<MODE, false>(ls, rs, sw, p, q, L, threads, s, bestd, bestc,
                                 cm, cp, ubest, rpack);
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` (H, W + D - 1) must
// hold all-ones words on entry.  The plan (ty, tx, dc, kx) and its
// shared-memory bytes come from asw_kernel.py::tile_plan; a plan this
// kernel cannot run, n_valid outside [0, W] or a window outside [0, D)
// returns cudaErrorInvalidValue without launching.  rbestc, strip_c and
// strip_d are null unless the caller wants the strip.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int asw_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int mode, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int n_valid, int d_lo, int d_hi, int ty, int tx, int dc, int kx, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, float* rbestc, float* strip_c,
    int* strip_d, void* stream) {
  const int K = 2 * r + 1;
  const Plan q{ty, tx, dc, kx};
  if (mode < 0 || mode > 2 || ty < 1 || tx < XT || tx % XT || dc < 8 || dc % 8 ||
      dc > MAX_DC || kx < 1 || kx > K || n_valid < 0 || n_valid > W || d_lo < 0 ||
      d_lo >= d_hi || d_hi > D)
    return (int)cudaErrorInvalidValue;
  const long threads = (long)ty * (tx / XT) * (dc / 8);
  // More than one d-chunk: one thread per column carries its WTA state.
  if (threads > MAX_THREADS || (D > dc && threads < (long)ty * tx))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(q, mode);
  const size_t smem = sizeof(float) * (size_t)L.total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != (size_t)smem_bytes || smem > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const Params p{H, W, r, D, K, cost_ad, alpha, one_minus_alpha,
                 tau_color, tau_grad, inv_gamma_color, inv_n, n_valid, d_lo, d_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kSymmetric)
    err = launch<kSymmetric>(ls, rs, sw, p, q, L, (int)threads, s, bestd, bestc,
                             cm, cp, ubest, rpack);
  else if (mode == kLeftOnly)
    err = launch<kLeftOnly>(ls, rs, sw, p, q, L, (int)threads, s, bestd, bestc,
                            cm, cp, ubest, rpack);
  else
    err = launch<kBox>(ls, rs, sw, p, q, L, (int)threads, s, bestd, bestc, cm,
                       cp, ubest, rpack);
  if (err != cudaSuccess) return (int)err;
  const int n = H * (W + D - 1);
  unpack_right_wide_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, H, W, D, rbestd,
                                                          rbestc, strip_c, strip_d);
  return (int)cudaGetLastError();
}

extern "C" const char* asw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
