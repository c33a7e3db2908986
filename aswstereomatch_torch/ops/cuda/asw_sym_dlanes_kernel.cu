// Exact symmetric (two-view) ASW aggregation + dual-view WTA, with every
// bilateral weight computed once per block and window row and reused for
// all disparities.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_sym_dlanes.py
// (_compute, launched by wta_outputs).  It computes K1's function in
// symmetric mode,
//
//   num[y,x,d] = sum_(dy,dx) wL(y,x; dy,dx) wR(y,x-d; dy,dx) C[clamp(y+dy-r), x+dx-r, d]
//   den[y,x,d] = sum_(dy,dx) wL(y,x; dy,dx) wR(y,x-d; dy,dx)
//
// and keeps the TPU kernel's idea, not its layout (no lane-reversed Lab
// rows, no strided Hankel rolls): the right weight depends on the right
// centre x - d and the tap only, so it is computed once per (row, right
// column, tap) and read for every d whose centre it is; K1 recomputes it at
// every (pixel, d, tap).
//
// Inputs (float32, contiguous, one card): ls (7, H, W + 2r), rs (7, H,
// W + 2r + D - 1) and sw (K, K), as asw_kernel.cu takes them.
//
// Design: one block of 256 threads per (output row y, tile of 64 columns
// x0 .. x0 + 63).  For each window row dy the block writes to shared memory
//   - the raw costs of row clamp(y + dy - r) for the 64 + 2r stack columns
//     and every d (computed once per block and row, reused by K windows);
//   - the left weights wl[dx][x], 64 x K;
//   - the right weights wr[dx][c] for the right centres x0 - DP + c,
//     c < 64 + DP (those below -(D - 1) or at W and past are 0): ~25 KB at
//     K = 33, D = 128;
// then each thread accumulates a 4-column x 8-disparity register tile:
// for dx ascending, t = wl * wr, den += t, num += t * C.  The four cost rows
// a thread's columns read at one dx slide by one row per dx, so they stay
// in registers and each dx loads one new row.  The aggregated 64 x D tile
// goes back to shared memory and wta_tile (asw_common.cuh) runs the online
// WTA and folds the right view.
//
// What bounds it on an H100: the function's least work at KITTI (1242x375,
// D=128, r=16) is a weight product, an FMA and an add per (pixel, d, tap),
// ~4 ms at the card's FP32 peak (k1_bound in chip_smoke.py).  This kernel
// issues those three and ~7 16-byte shared-memory loads per 96 of them per
// thread, and recomputes each raw cost row K times (once per output row
// that reads it).  Each thread's 8 disparities are two runs of 4 (d and
// d + DP/2), so a quarter-warp's loads of a cost row or of a right-weight
// window are one contiguous 128-byte line.
//
// Determinism: each output sums its taps in one fixed (dy, then dx) order
// whatever its tile; every column WTA runs d ascending; the right view's
// atomicMin picks (cost, then lower d) whatever the block order.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division, no fast math.
// The weight product is (colorL * sw) * (colorR * sw), the plain version's
// order (the Pallas kernel folds sw^2 into the left factor), and the
// output divides num / den, as the plain version and K1 do.

#include "asw_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 64;                   // output columns per block
constexpr int XT = kTileCols;            // columns per thread
constexpr int DT = kTileDisps;           // disparities per thread (2 runs of 4)
constexpr int DG = THREADS / (TX / XT);  // 16 disparity groups
static_assert(DG * 4 == 64, "DG runs of 4 cover half of D <= 128");

struct Params {
  int H, W, r, D, K;
  int DP;         // D rounded up to a multiple of 8 (shared-memory row)
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
};

__global__ void __launch_bounds__(THREADS, 2)
asw_sym_dlanes_wta_kernel(const float* __restrict__ ls,
                          const float* __restrict__ rs,
                          const float* __restrict__ sw, Params p,
                          int* __restrict__ bestd_out,
                          float* __restrict__ bestc_out,
                          float* __restrict__ cm_out, float* __restrict__ cp_out,
                          float* __restrict__ ubest_out,
                          unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  const int r = p.r, K = p.K, D = p.D, DP = p.DP, W = p.W;
  const int NU = TX + 2 * r;  // tile columns u: ls column x0 + u
  const int NC = TX + DP;     // right centres x0 - DP + c
  const int AS = DP + 1;      // row stride of the aggregated tile (odd)
  float* cost = reinterpret_cast<float*>(smem4);  // [NU][DP]; then agg [TX][AS]
  float* wl = cost + max(NU * DP, TX * AS);        // [K][TX]
  float* wr = wl + K * TX;                         // [K][NC]

  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int tid = threadIdx.x;
  const int xb = (tid / DG) * XT;  // the thread's first tile column
  const int db = (tid % DG) * 4;   // and its first disparity
  const bool active = db < DP / 2;
  const Stacks st{ls, rs, W + 2 * r, W + 2 * r + D - 1,
                  (size_t)p.H * (W + 2 * r), (size_t)p.H * (W + 2 * r + D - 1)};
  const float* llab = ls + 4 * st.PL;  // Lab planes of the two stacks
  const float* rlab = rs + 4 * st.PR;

  float num[XT][DT], den[XT][DT];
#pragma unroll
  for (int i = 0; i < XT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) num[i][j] = den[i][j] = 0.f;

  for (int dy = 0; dy < K; ++dy) {
    const int yy = min(max(y + dy - r, 0), p.H - 1);
    const float* spatial = sw + dy * K;
    for (int i = tid; i < NU * DP; i += THREADS) {
      const int col = x0 + i / DP, d = i % DP;
      cost[i] = d < D && col < st.WL ? stack_cost(p, st, yy, col, d, D) : 0.f;
    }
    // Left weight of column x0 + x (ls centre column x0 + x + r) and tap dx
    // (ls column x0 + x + dx).
    for (int i = tid; i < TX * K; i += THREADS) {
      const int x = i % TX, dx = i / TX;
      float w = 0.f;
      if (x0 + x < W) {
        const float* t = llab + (size_t)yy * st.WL + x0 + x + dx;
        const float* c = llab + (size_t)y * st.WL + x0 + x + r;
        w = bilateral(p, t[0], t[st.PL], t[2 * st.PL], c[0], c[st.PL],
                      c[2 * st.PL], spatial[dx]);
      }
      wl[dx * TX + x] = w;
    }
    // Right weight of centre xr = x0 - DP + c (rs centre column
    // xr + r + D - 1) and tap dx (rs column xr + dx + D - 1).
    for (int i = tid; i < K * NC; i += THREADS) {
      const int c = i % NC, dx = i / NC;
      const int xr = x0 - DP + c;
      float w = 0.f;
      if (xr > -D && xr < W) {
        const float* t = rlab + (size_t)yy * st.WR + xr + dx + D - 1;
        const float* e = rlab + (size_t)y * st.WR + xr + r + D - 1;
        w = bilateral(p, t[0], t[st.PR], t[2 * st.PR], e[0], e[st.PR],
                      e[2 * st.PR], spatial[dx]);
      }
      wr[dx * NC + c] = w;
    }
    __syncthreads();
    if (active) accumulate_sym(num, den, cost, wl, wr, xb, db, K, DP, NC, TX);
    __syncthreads();
  }

  // The aggregated tile over the raw costs (all reads of them are done).
  float* agg = cost;
  if (active) {
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int d = db + (j < 4 ? j : DP / 2 + j - 4);
        if (d < D) agg[(xb + i) * AS + d] = num[i][j] / den[i][j];
      }
  }
  __syncthreads();
  wta_tile(agg, AS, TX, x0, y, W, D, bestd_out, bestc_out, cm_out, cp_out,
           ubest_out, rpack);
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  Requires 2 <= D <= 128 and K <= 63.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int asw_sym_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int cost_ad, float alpha, float one_minus_alpha, float tau_color,
    float tau_grad, float inv_gamma_color, int* bestd, float* bestc, float* cm,
    float* cp, float* ubest, unsigned long long* rpack, int* rbestd,
    void* stream) {
  const int K = 2 * r + 1;
  if (D < 2 || D > 128 || K > 63) return (int)cudaErrorInvalidValue;
  const int DP = (D + 7) / 8 * 8;
  Params p{H, W, r, D, K, DP, cost_ad, alpha, one_minus_alpha, tau_color,
           tau_grad, inv_gamma_color};
  const int NU = TX + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)max(NU * DP, TX * (DP + 1)) +
                                       (size_t)K * TX + (size_t)K * (TX + DP));
  cudaError_t err = cudaFuncSetAttribute(asw_sym_dlanes_wta_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((W + TX - 1) / TX, H);
  asw_sym_dlanes_wta_kernel<<<grid, THREADS, smem, s>>>(
      ls, rs, sw, p, bestd, bestc, cm, cp, ubest, rpack);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
