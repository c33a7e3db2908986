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
// do not depend on d; box weights are 1 and den = K^2.  What the TPU kernel
// keeps, and this one too: each weight is computed once per (pixel, tap) and
// multiplies a whole row of D raw costs, and each raw cost of a row is
// computed once per block and reused by the K windows of the block that
// cover it.  The H x (W + 2r) x D raw cost volume is never materialized
// (the TPU wrapper built it for its DMA): each block computes the rows it
// needs from the channel stacks K1 takes.
//
// Inputs (float32, contiguous, one card): ls (7, H, W + 2r), rs (7, H,
// W + 2r + D - 1) and sw (K, K), as asw_kernel.cu takes them.
//
// Design: one block of 128 threads per (output row y, tile of 64 columns).
//   - ASW: for each window row dy the block writes the raw costs of row
//     clamp(y + dy - r) for the tile's 64 + 2r stack columns and every d
//     into shared memory, and the 64 x K weights of that dy into a banded
//     matrix band[q][x] = w(x; dy, q - x) (zero off the band), then each
//     thread accumulates an 8-column x 8-disparity register tile:
//     num[x][d] += band[q][x] * C[q][d] for q ascending, which is dx
//     ascending for every x.  The zero band entries add +0 (C is finite).
//   - Box: the plain version sums the window column by column (the y taps
//     first, then the x taps), so the block does the same: each column sum
//     over dy goes to shared memory in dy order, then the same banded loop
//     with a band of ones sums K columns in dx order.  The box result is
//     then the plain version's bit for bit on the card.
//   - The aggregated 64 x D tile goes back to shared memory and wta_tile
//     (asw_common.cuh) runs the online WTA and folds the right view.
//
// What bounds it on an H100: at KITTI (1242x375, D=128, r=16) the left-only
// function's least work is ~130 GFLOP of FMAs, ~2 ms at the card's FP32
// peak (k1_bound in chip_smoke.py); the box function's a few flops per
// (pixel, d), ~0.015 ms (box_bound).  This kernel does more: it recomputes
// a raw cost row once per output row that reads it (K times in all), and
// the band multiplies 7 zero entries per 33 useful ones at K=33.  The
// thread tile keeps the shared-memory traffic at 4 16-byte loads per 64
// FMAs: each thread's 8 disparities are two runs of 4 (d and d + DP/2), so
// a quarter-warp's loads of a cost row are one contiguous 128-byte line.
//
// Determinism: each output sums its taps in one fixed (dy, then dx) order
// whatever its tile; every column WTA runs d ascending; the right view's
// atomicMin picks (cost, then lower d) whatever the block order.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division, no fast math.
// Left-only divides num / den, as the plain version and K1 do (the Pallas
// kernel multiplies by a reciprocal); box multiplies by (float)(1 / K^2),
// as K1 does and as PyTorch divides a CUDA tensor by a Python scalar.

#include "asw_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TX = 64;                 // output columns per block
constexpr int XT = 8;                  // columns per thread
constexpr int DT = 8;                  // disparities per thread (2 runs of 4)
constexpr int DG = THREADS / (TX / XT);  // 16 disparity groups
static_assert(DG * 4 == 64, "DG runs of 4 cover half of D <= 128");

struct Params {
  int H, W, r, D, K;
  int DP;         // D rounded up to a multiple of 8 (shared-memory row)
  int box;        // 1: box aggregation, 0: left-only ASW
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
  float inv_n;            // (float)(1 / K^2), box mode
};

// num[i][j] += band[q][xb + i] * cost[q][d_j] over the rows q that the
// thread's columns xb .. xb + 7 tap, q ascending.  d_j is db + j for j < 4
// and db + DP/2 + j - 4 for j >= 4.
__device__ __forceinline__ void accumulate(float (&num)[XT][DT],
                                           const float* band, const float* cost,
                                           int xb, int db, int K, int DP) {
  const int dh = DP / 2;
  for (int q = xb; q < xb + XT - 1 + K; ++q) {
    const float4 s0 = *reinterpret_cast<const float4*>(band + q * TX + xb);
    const float4 s1 = *reinterpret_cast<const float4*>(band + q * TX + xb + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(cost + q * DP + db);
    const float4 c1 = *reinterpret_cast<const float4*>(cost + q * DP + db + dh);
    const float s[XT] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float c[DT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
      for (int j = 0; j < DT; ++j) num[i][j] = fmaf(s[i], c[j], num[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS)
asw_dlanes_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                      const float* __restrict__ sw, Params p,
                      int* __restrict__ bestd_out, float* __restrict__ bestc_out,
                      float* __restrict__ cm_out, float* __restrict__ cp_out,
                      float* __restrict__ ubest_out,
                      unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  const int r = p.r, K = p.K, D = p.D, DP = p.DP, W = p.W;
  const int NU = TX + 2 * r;   // tile columns u: ls column x0 + u
  const int AS = DP + 1;       // row stride of the aggregated tile (odd)
  float* cost = reinterpret_cast<float*>(smem4);  // [NU][DP]; then agg [TX][AS]
  float* band = cost + max(NU * DP, TX * AS);      // [TX + K - 1][TX]
  float* dens = band + (TX + K - 1) * TX;          // [TX]

  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int tid = threadIdx.x;
  const int xb = (tid / DG) * XT;  // the thread's first tile column
  const int db = (tid % DG) * 4;   // and its first disparity
  const bool active = db < DP / 2;
  const Stacks st{ls, rs, W + 2 * r, W + 2 * r + D - 1,
                  (size_t)p.H * (W + 2 * r), (size_t)p.H * (W + 2 * r + D - 1)};
  const bool box = p.box != 0;

  float num[XT][DT];
#pragma unroll
  for (int i = 0; i < XT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) num[i][j] = 0.f;

  // The band: ones (box) or zeros (ASW: the in-band entries are written
  // for each dy) off the band q - x in [0, K).
  for (int i = tid; i < (TX + K - 1) * TX; i += THREADS) {
    const int o = i / TX - i % TX;
    band[i] = box && o >= 0 && o < K ? 1.f : 0.f;
  }

  if (box) {
    // Column sums over the window rows, dy ascending (the plain version's
    // order), then one banded pass sums K columns.
    for (int i = tid; i < NU * DP; i += THREADS) {
      const int col = x0 + i / DP, d = i % DP;
      float s = 0.f;
      if (d < D && col < st.WL)
        for (int dy = 0; dy < K; ++dy)
          s += stack_cost(p, st, min(max(y + dy - r, 0), p.H - 1), col, d, D);
      cost[i] = s;
    }
    __syncthreads();
    if (active) accumulate(num, band, cost, xb, db, K, DP);
  } else {
    float den = 0.f;  // threads tid < TX: den of column x0 + tid
    const size_t ctr = (size_t)y * st.WL + x0 + r;  // left centres, ls column x + r
    for (int dy = 0; dy < K; ++dy) {
      const int yy = min(max(y + dy - r, 0), p.H - 1);
      for (int i = tid; i < NU * DP; i += THREADS) {
        const int col = x0 + i / DP, d = i % DP;
        cost[i] = d < D && col < st.WL ? stack_cost(p, st, yy, col, d, D) : 0.f;
      }
      for (int i = tid; i < TX * K; i += THREADS) {
        const int x = i % TX, dx = i / TX;
        float w = 0.f;
        if (x0 + x < W) {
          // Tap at image column x0 + x + dx - r: ls column x0 + x + dx.
          const float* t = ls + 4 * st.PL + (size_t)yy * st.WL + x0 + x + dx;
          const float* c = ls + 4 * st.PL + ctr + x;
          w = bilateral(p, t[0], t[st.PL], t[2 * st.PL], c[0], c[st.PL],
                        c[2 * st.PL], sw[dy * K + dx]);
        }
        band[(x + dx) * TX + x] = w;
      }
      __syncthreads();
      if (active) accumulate(num, band, cost, xb, db, K, DP);
      if (tid < TX)
        for (int dx = 0; dx < K; ++dx) den += band[(tid + dx) * TX + tid];
      __syncthreads();
    }
    if (tid < TX) dens[tid] = den;
  }
  __syncthreads();

  // The aggregated tile over the raw costs (all reads of them are done).
  float* agg = cost;
  if (active) {
#pragma unroll
    for (int i = 0; i < XT; ++i) {
      const float dn = box ? 0.f : dens[xb + i];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int d = db + (j < 4 ? j : DP / 2 + j - 4);
        if (d < D)
          agg[(xb + i) * AS + d] = box ? num[i][j] * p.inv_n : num[i][j] / dn;
      }
    }
  }
  __syncthreads();
  wta_tile(agg, AS, TX, x0, y, W, D, bestd_out, bestc_out, cm_out, cp_out,
           ubest_out, rpack);
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  Requires 2 <= D <= 128 and K <= 65.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int asw_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int box, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream) {
  const int K = 2 * r + 1;
  if (D < 2 || D > 128 || K > 65) return (int)cudaErrorInvalidValue;
  const int DP = (D + 7) / 8 * 8;
  Params p{H, W, r, D, K, DP, box, cost_ad, alpha, one_minus_alpha,
           tau_color, tau_grad, inv_gamma_color, inv_n};
  const int NU = TX + 2 * r;
  const size_t smem =
      sizeof(float) * ((size_t)max(NU * DP, TX * (DP + 1)) + (TX + K - 1) * TX + TX);
  cudaError_t err = cudaFuncSetAttribute(
      asw_dlanes_wta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((W + TX - 1) / TX, H);
  asw_dlanes_wta_kernel<<<grid, THREADS, smem, s>>>(ls, rs, sw, p, bestd, bestc,
                                                    cm, cp, ubest, rpack);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
