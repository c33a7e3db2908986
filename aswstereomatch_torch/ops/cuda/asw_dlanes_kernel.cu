// Exact left-only ASW (or box) aggregation + dual-view WTA, with the weights
// computed once per (pixel, tap) and reused for every disparity.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_dlanes.py
// (_compute and _wta_writeback, launched by wta_outputs).  It computes what
// that kernel computes, not its Mosaic layout (no 128-lane padded cost
// volume, no K*XW band matrix, no log-shear right view):
//
//   num[y,x,d] = sum_(dy,dx) w(y,x; dy,dx) C[clamp(y+dy-r), x+dx-r, d]
//   den[y,x]   = sum_(dy,dx) w(y,x; dy,dx)
//
// Left-only weights w = exp(-|Lab(tap) - Lab(centre)| / gamma_c) * sw(dy,dx)
// do not depend on d; box weights are 1 and den = K^2.  The H x (W + 2r) x D
// raw cost volume is never materialized: each block computes the rows it
// needs from the channel stacks K1 takes.
//
// Inputs (float32, contiguous, one card): ls (7, H, W + 2r), rs (7, H,
// W + 2r + D - 1) and sw (K, K), as asw_kernel.cu takes them.
//
// Design.  The tile plan (TY, TX, DP) comes from the wrapper
// (asw_dlanes_kernel.py::tile_plan), which sizes it to the geometry, the
// 232,448 bytes of shared memory and the 512 threads a block may have; the
// C entry recomputes the layout and refuses a plan that does not match or
// fit.  One block covers TY output rows x TX columns and every d (D <= 128,
// DP = D rounded up to 8), with TY * (TX / 8) * (DP / 8) threads, each
// owning an 8-column x 8-disparity register tile of one output row (the
// disparities in two runs of 4, d and d + DP/2, so that a quarter-warp's
// 16-byte loads of a cost row are one 128-byte line).
//   - Left-only ASW: the block walks the TY + 2r stack rows its windows
//     touch.  Per stage (stack row):
//       1. build, from the stage's stack rows already in shared memory: the
//          raw-cost row, TX + K - 1 columns x DP, once for all TY output
//          rows (a one-row block rebuilt it K times), unfused
//          (tap_cost<true>, stack_cost's arithmetic), so each raw cost is
//          the plain version's bit for bit; and for each output row t whose
//          window covers the stack row, its left weights as a banded matrix
//          band_t[q][x] = w(x; dy, q - x), zero off the band;
//       2. barrier; start the cp.async copies of the next stage's stack
//          rows (seven left planes over TX + K - 1 columns, four right ones
//          over TX + K + DP - 2) into the second of two small buffers;
//       3. each covered row's threads run their register tile, num[x][d] +=
//          band_t[q][x] * C[q][d] for q ascending (dx ascending for every
//          x; the zero band entries add +0, C is finite): 4 float4 loads
//          per 64 FMAs; the row's den adds its K weights, dx ascending;
//       4. wait for the copies; barrier.
//     The FMAs take one barrier interval per stage.  Double-buffered stage
//     arrays (build stage k + 1 while stage k's FMAs run, one barrier per
//     stage) measured no faster at KITTI, and were dropped.
//   - Box: the plain version sums each window column over dy first, then K
//     columns over dx, then times (float)(1 / K^2); the block keeps that
//     order and does the least work within it.  A thread owning (tile
//     column u, d) walks the block's TY + 2r stack rows ascending, builds
//     each raw cost once (stack_cost, from global memory, the loop unrolled
//     so that several rows' reads are in flight) and adds it into the
//     running column sums of the <= TY output rows whose windows cover that
//     row (TY is a template parameter, so the sums stay in registers), then
//     stores them; a banded dx pass over shared memory sums K columns in dx
//     order.  Bit for bit with the plain version.
//   - The aggregated TY x TX x DP tile goes back to shared memory and each
//     output row's threads run wta_tile_lanes (asw_common.cuh) over it: the
//     online WTA, d ascending, and the right-view fold, once per (row, tile).
//
// What bounds it on an H100: issue slots.  At KITTI (1242x375, D=128,
// r=16) the left-only function's least work is ~2 ms at the FP32 peak
// (k1_bound in chip_smoke.py), the box function's ~0.015 ms (box_bound).
// Left-only at its plan TY=8, TX=32, DP=128 (39 x 47 blocks of 16 warps,
// 40 stages each), per thread: the band product, K + 7 = 40 rows of 64
// FMAs and 4 16-byte loads per stage its row is covered (33 of 40; 7 of
// the 40 band rows are zeros), ~2.9 K instructions; the raw-cost row,
// 64 x 128 / 512 = 16 raw costs of ~30 instructions per stage (10 builds
// per (pixel, d); a one-row block of 64 columns needs 49.5); the weights,
// <= 16.5 of
// ~45 instructions per stage.  That is ~4.3 G warp instructions, ~4.1 ms at
// four per clock per SM; the kernel takes about twice that, build and
// FMAs each at about half that rate and never overlapped (PERF.md section
// 6).  Box at TY=4, TX=64: 9 x 1.5 = 13.5 raw costs per (pixel, d).
// Tensor cores: the left-only band product is a real matrix product
// (the weight does not depend on d), but 3xTF32 on mma.sync m16n8k8 ran
// slower than these FP32 FMAs (the operand splits and fragment loads cost
// more issue slots than the FMAs), so the tile stays FP32 SIMT.
// ptxas (sm_90a, the 128-register cap of __launch_bounds__(512, 1)):
// left-only 124 registers, box 90-94 over its five row counts, no spills.
//
// Determinism: each output sums its taps in one fixed (dy, then dx) order
// whatever the tile plan; every column WTA runs d ascending; the right
// view's atomicMin picks (cost, then lower d) whatever the block order.  A
// batch equals single calls, and any two plans give the same bits.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division, no fast math.
// Left-only divides num / den, as the plain version and K1 do (the Pallas
// kernel multiplies by a reciprocal); box multiplies by (float)(1 / K^2),
// as K1 does and as PyTorch divides a CUDA tensor by a Python scalar.

#include "asw_common.cuh"

namespace {

constexpr int XT = 8;  // columns per thread
constexpr int DT = 8;  // disparities per thread (2 runs of 4)
constexpr int MAX_THREADS = 512;
constexpr int MAX_BOX_TY = 16;  // box: the running column sums in registers
constexpr int NPLANES = 7;      // R, G, B, x-gradient, L, a, b

struct Params {
  int H, W, r, D, K;
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
  float inv_n;            // (float)(1 / K^2), box mode
};

// The tile plan: TY output rows x TX columns per block, DP disparities.
struct Plan {
  int TY, TX, DP;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Float offsets of the block's shared-memory arrays:
//   [0, in0)   left-only: the raw-cost row LW x DP, then the TY bands
//              LW x TX from `band` on; box: the column sums TY x LW x DP;
//              after the stage loop, the aggregated tile TY x TX x (DP + 1)
//              over them;
//   in0, in1   left-only: the stack rows of a stage, two buffers: the seven
//              left planes over LW = TX + K - 1 columns, the four right ones
//              over RW = LW + DP - 1;
//   lctr       left-only: the window centres' Lab, 3 x TY x TX;
//   dens       left-only: den of each output, TY x TX.
struct Layout {
  int band, in0, in1, lctr, dens, total;
  int LW, RW;
};

Layout layout(const Plan& q, int K, bool box) {
  Layout L;
  L.LW = q.TX + K - 1;
  L.RW = L.LW + q.DP - 1;
  L.band = L.LW * q.DP;
  const int stage = box ? q.TY * L.LW * q.DP : L.band + q.TY * L.LW * q.TX;
  const int agg = q.TY * q.TX * (q.DP + 1);
  L.in0 = round4(stage > agg ? stage : agg);
  const int in = box ? 0 : round4(NPLANES * L.LW + 4 * L.RW);
  L.in1 = L.in0 + in;
  L.lctr = L.in1 + in;
  L.dens = L.lctr + (box ? 0 : round4(3 * q.TY * q.TX));
  L.total = L.dens + (box ? 0 : round4(q.TY * q.TX));
  return L;
}

// num[i][j] += band[q][xb + i] * cost[q][d_j] over the rows q that the
// thread's columns xb .. xb + 7 tap, q ascending.  d_j is db + j for j < 4
// and db + DP/2 + j - 4 for j >= 4.
__device__ __forceinline__ void accumulate(float (&num)[XT][DT], const float* band,
                                           const float* cost, int xb, int db,
                                           int K, int DP, int TX) {
  const int dh = DP / 2;
  for (int q = xb; q < xb + XT - 1 + K; ++q) {
    const float4 s0 = *reinterpret_cast<const float4*>(band + q * TX + xb);
    const float4 s1 = *reinterpret_cast<const float4*>(band + q * TX + xb + 4);
    float c[DT];
    load8(c, cost + q * DP, db, dh);
    const float s[XT] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
      for (int j = 0; j < DT; ++j) num[i][j] = fmaf(s[i], c[j], num[i][j]);
  }
}

// The aggregated tile and the WTA of the block's rows: num (already
// normalised by `scale`) goes to agg[(t * TX + x) * (DP + 1) + d] over the
// stage arrays, then each output row's NTR threads run its WTA.
template <class Scale>
__device__ __forceinline__ void finish(float (&num)[XT][DT], float* agg,
                                      Scale scale, const Params& p, const Plan& q,
                                      int ty, int tq, int xb, int db, int nrows,
                                      int x0, int y0, int NTR, int* bestd,
                                      float* bestc, float* cm, float* cp,
                                      float* ubest, unsigned long long* rpack) {
  const int AS = q.DP + 1;  // row stride of the aggregated tile (odd)
  if (ty < nrows) {
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int d = db + (j < 4 ? j : q.DP / 2 + j - 4);
        if (d < p.D) agg[(ty * q.TX + xb + i) * AS + d] = scale(num[i][j], xb + i);
      }
  }
  __syncthreads();
  if (ty < nrows)
    wta_tile_lanes(agg + ty * q.TX * AS, AS, q.TX, x0, y0 + ty, p.W, p.D, bestd,
                   bestc, cm, cp, ubest, rpack, tq, NTR);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
dlanes_left_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                   const float* __restrict__ sw, Params p, Plan q, Layout L,
                   int* __restrict__ bestd_out, float* __restrict__ bestc_out,
                   float* __restrict__ cm_out, float* __restrict__ cp_out,
                   float* __restrict__ ubest_out,
                   unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.H, W = p.W, r = p.r, D = p.D, K = p.K;
  const int TY = q.TY, TX = q.TX, DP = q.DP, LW = L.LW, RW = L.RW;
  const int DG = DP / 8;            // disparity groups of a row
  const int NTR = (TX / XT) * DG;   // threads per output row
  const int nthreads = TY * NTR;
  const FastDiv byDP = fast_div(DP), byTX = fast_div(TX), byK = fast_div(K),
                byLW = fast_div(LW), byRW = fast_div(RW);
  const int tid = threadIdx.x;
  const int ty = tid / NTR;             // the thread's output row y0 + ty
  const int tq = tid - ty * NTR;        // its lane in that row
  const int xb = tq / DG * XT;          // its first tile column
  const int db = tq % DG * 4;           // and its first disparity
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int nrows = min(TY, H - y0);    // output rows inside the image
  const int WL = W + 2 * r, WR = WL + D - 1;
  const size_t PL = (size_t)H * WL, PR = (size_t)H * WR;  // plane strides
  const int s_lo = y0 - r;              // stack rows s (unclamped) walked
  const int nst = nrows + 2 * r;        // stages: one per stack row
  const int rb0 = x0 + D - DP;          // rs column of right input column 0
  float* cost = smem;                   // [LW][DP]
  float* band = smem + L.band;          // [TY][LW][TX]
  float* lctr = smem + L.lctr;
  float* dens = smem + L.dens;

  // The bands start at zero (only the in-band entries q - x in [0, K) are
  // ever written); den at zero; the window centres' Lab, ls column x + r.
  for (int i = tid; i < TY * LW * TX; i += nthreads) band[i] = 0.f;
  for (int i = tid; i < TY * TX; i += nthreads) {
    const int t = (unsigned)i / byTX, x = i - t * TX;
    const float* a = ls + 4 * PL + (size_t)min(y0 + t, H - 1) * WL +
                     min(x0 + x + r, WL - 1);
    for (int c = 0; c < 3; ++c) lctr[c * TY * TX + i] = a[c * PL];
    dens[i] = 0.f;
  }

  // The stack rows of stage k into `in`: left planes over ls columns
  // x0 + u (u < LW), right planes over rs columns rb0 + v (v < RW), clamped
  // into the stacks (the clamped entries feed only costs at d >= D,
  // columns >= W + 2r or zero weights).  Asynchronous.
  auto stage_in = [&](int k, float* in) {
    const int yy = min(max(s_lo + k, 0), H - 1);
    const float* lrow = ls + (size_t)yy * WL;
    const float* rrow = rs + (size_t)yy * WR;
    for (int i = tid; i < NPLANES * LW; i += nthreads) {
      const int c = (unsigned)i / byLW, u = i - c * LW;
      cp_async4(in + i, lrow + c * PL + min(x0 + u, WL - 1));
    }
    float* rin = in + NPLANES * LW;
    for (int i = tid; i < 4 * RW; i += nthreads) {
      const int c = (unsigned)i / byRW, v = i - c * RW;
      cp_async4(rin + i, rrow + c * PR + min(max(rb0 + v, 0), WR - 1));
    }
  };

  // Build stage k: the raw-cost row, and the band of each output row t
  // whose window row dy = s - (y0 + t) + r is in [0, K).
  auto build = [&](int k, const float* in) {
    const int s = s_lo + k;
    const float* rin = in + NPLANES * LW;
    // Raw cost of tile column u (ls column x0 + u) at d: the right sample
    // is rs column x0 + u + D - 1 - d, right input column u + DP - 1 - d.
#pragma unroll 4
    for (int i = tid; i < LW * DP; i += nthreads) {
      const int u = (unsigned)i / byDP, d = i - u * DP;
      const int v = u + DP - 1 - d;
      cost[i] = d < D && x0 + u < WL
                    ? tap_cost<true>(p, in[u], in[LW + u], in[2 * LW + u],
                                     in[3 * LW + u], rin[v], rin[RW + v],
                                     rin[2 * RW + v], rin[3 * RW + v])
                    : 0.f;
    }
    const int t_lo = max(0, s - r - y0), nt = min(nrows - 1, s + r - y0) - t_lo + 1;
    // Left weight of column x0 + x and tap dx: the tap is ls column
    // x0 + x + dx, left input column x + dx.
    const float* lab = in + 4 * LW;
#pragma unroll 4
    for (int i = tid; i < nt * K * TX; i += nthreads) {
      const int row = (unsigned)i / byTX, x = i - row * TX;
      const int t_ = (unsigned)row / byK, dx = row - t_ * K, t = t_lo + t_;
      const int c = t * TX + x;
      band[(t * LW + x + dx) * TX + x] =
          x0 + x < W ? bilateral(p, lab[x + dx], lab[LW + x + dx],
                                 lab[2 * LW + x + dx], lctr[c], lctr[TY * TX + c],
                                 lctr[2 * TY * TX + c], sw[(s - y0 - t + r) * K + dx])
                     : 0.f;
    }
  };

  float num[XT][DT];
#pragma unroll
  for (int i = 0; i < XT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) num[i][j] = 0.f;

  // Per stage: build from stage k's rows; barrier; start the copies of
  // stage k + 1's rows into the other buffer; FMAs and den; wait; barrier.
  stage_in(0, smem + L.in0);
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nst; ++k) {
    build(k, smem + ((k & 1) ? L.in1 : L.in0));
    __syncthreads();
    if (k + 1 < nst) stage_in(k + 1, smem + ((k & 1) ? L.in0 : L.in1));
    const int dy = k - ty;  // = s - (y0 + ty) + r
    if (ty < nrows && dy >= 0 && dy < K) {
      const float* bt = band + ty * LW * TX;
      accumulate(num, bt, cost, xb, db, K, DP, TX);
      for (int x = tq; x < TX; x += NTR) {  // den, dx ascending
        float dn = dens[ty * TX + x];
        for (int dx = 0; dx < K; ++dx) dn += bt[(x + dx) * TX + x];
        dens[ty * TX + x] = dn;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const float* dn = dens + ty * TX;
  finish(num, smem, [dn](float v, int x) { return v / dn[x]; }, p, q, ty, tq, xb,
         db, nrows, x0, y0, NTR, bestd_out, bestc_out, cm_out, cp_out, ubest_out,
         rpack);
}

template <int TY>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dlanes_box_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                  Params p, Plan q, Layout L, int* __restrict__ bestd_out,
                  float* __restrict__ bestc_out, float* __restrict__ cm_out,
                  float* __restrict__ cp_out, float* __restrict__ ubest_out,
                  unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  float* colsum = reinterpret_cast<float*>(smem4);  // [TY][LW][DP]
  const int H = p.H, W = p.W, r = p.r, D = p.D, K = p.K;
  const int TX = q.TX, DP = q.DP, LW = L.LW;
  const int DG = DP / 8;
  const int NTR = (TX / XT) * DG;
  const int nthreads = TY * NTR;
  const FastDiv byDP = fast_div(DP);
  const int tid = threadIdx.x;
  const int ty = tid / NTR;
  const int tq = tid - ty * NTR;
  const int xb = tq / DG * XT;
  const int db = tq % DG * 4;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int nrows = min(TY, H - y0);
  const int WL = W + 2 * r;
  const Stacks st{ls, rs, WL, WL + D - 1, (size_t)H * WL, (size_t)H * (WL + D - 1)};

  // Column sums: stack row y0 - r + k feeds output row t at dy = k - t.
  for (int i = tid; i < LW * DP; i += nthreads) {
    const int u = (unsigned)i / byDP, d = i - u * DP;
    float sum[TY];
#pragma unroll
    for (int t = 0; t < TY; ++t) sum[t] = 0.f;
    if (d < D && x0 + u < WL) {
      // Unrolled so that several rows' stack reads are in flight (the
      // adds still run k ascending); rolled, the loop waited on each.
#pragma unroll 4
      for (int k = 0; k < nrows + 2 * r; ++k) {
        const float c = stack_cost(p, st, min(max(y0 - r + k, 0), H - 1), x0 + u, d, D);
#pragma unroll
        for (int t = 0; t < TY; ++t)
          if (k - t >= 0 && k - t < K) sum[t] += c;
      }
    }
#pragma unroll
    for (int t = 0; t < TY; ++t) colsum[(t * LW + u) * DP + d] = sum[t];
  }
  __syncthreads();

  // K column sums per output, dx ascending: column xb + i takes tile
  // column u at dx = u - xb - i.
  float num[XT][DT];
#pragma unroll
  for (int i = 0; i < XT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) num[i][j] = 0.f;
  if (ty < nrows) {
    const float* cs = colsum + ty * LW * DP;
    for (int u = xb; u < xb + XT - 1 + K; ++u) {
      float c[DT];
      load8(c, cs + u * DP, db, DP / 2);
#pragma unroll
      for (int i = 0; i < XT; ++i)
        if (u - xb - i >= 0 && u - xb - i < K)
#pragma unroll
          for (int j = 0; j < DT; ++j) num[i][j] += c[j];
    }
  }
  __syncthreads();  // the aggregated tile overwrites the column sums

  const float inv_n = p.inv_n;
  finish(num, colsum, [inv_n](float v, int) { return v * inv_n; }, p, q, ty, tq,
         xb, db, nrows, x0, y0, NTR, bestd_out, bestc_out, cm_out, cp_out,
         ubest_out, rpack);
}

template <int TY>
cudaError_t launch_box(const float* ls, const float* rs, const Params& p,
                       const Plan& q, const Layout& L, dim3 grid, int threads,
                       size_t smem, cudaStream_t s, int* bestd, float* bestc,
                       float* cm, float* cp, float* ubest,
                       unsigned long long* rpack) {
  cudaError_t err = cudaFuncSetAttribute(
      dlanes_box_kernel<TY>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dlanes_box_kernel<TY><<<grid, threads, smem, s>>>(ls, rs, p, q, L, bestd, bestc,
                                                     cm, cp, ubest, rpack);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  Requires 2 <= D <= 128 and K <= 65.  The plan (ty, tx,
// dp) and its shared-memory bytes come from asw_dlanes_kernel.py::tile_plan;
// a plan this kernel cannot run returns cudaErrorInvalidValue without
// launching.  Returns the cudaError_t of the launches (0 on success).
extern "C" int asw_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int box, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int ty, int tx, int dp, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream) {
  const int K = 2 * r + 1;
  if (D < 2 || D > 128 || K > 65) return (int)cudaErrorInvalidValue;
  const Plan q{ty, tx, dp};
  if (ty < 1 || tx < XT || tx % XT || dp != (D + 7) / 8 * 8)
    return (int)cudaErrorInvalidValue;
  if (box && (ty > MAX_BOX_TY || (ty & (ty - 1)))) return (int)cudaErrorInvalidValue;
  const long threads = (long)ty * (tx / XT) * (dp / 8);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const Layout L = layout(q, K, box != 0);
  const size_t smem = sizeof(float) * (size_t)L.total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != (size_t)smem_bytes || smem > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  const Params p{H, W, r, D, K, cost_ad, alpha, one_minus_alpha,
                 tau_color, tau_grad, inv_gamma_color, inv_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + tx - 1) / tx, (H + ty - 1) / ty);
  const int nt = (int)threads;
  if (!box) {
    err = cudaFuncSetAttribute(dlanes_left_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dlanes_left_kernel<<<grid, nt, smem, s>>>(ls, rs, sw, p, q, L, bestd, bestc, cm,
                                              cp, ubest, rpack);
    err = cudaGetLastError();
  } else if (ty == 1) {
    err = launch_box<1>(ls, rs, p, q, L, grid, nt, smem, s, bestd, bestc, cm, cp, ubest, rpack);
  } else if (ty == 2) {
    err = launch_box<2>(ls, rs, p, q, L, grid, nt, smem, s, bestd, bestc, cm, cp, ubest, rpack);
  } else if (ty == 4) {
    err = launch_box<4>(ls, rs, p, q, L, grid, nt, smem, s, bestd, bestc, cm, cp, ubest, rpack);
  } else if (ty == 8) {
    err = launch_box<8>(ls, rs, p, q, L, grid, nt, smem, s, bestd, bestc, cm, cp, ubest, rpack);
  } else {
    err = launch_box<16>(ls, rs, p, q, L, grid, nt, smem, s, bestd, bestc, cm, cp, ubest, rpack);
  }
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
