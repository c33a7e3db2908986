// Separable two-pass ASW aggregation + online dual-view WTA.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_sep_dlanes.py
// (_compute, launched by wta_outputs).  It computes what that kernel
// computes, not its Mosaic layout (no padded cost volume, no lane rolls):
//
//   numv[y,u,d] = sum_dy wvL(y,u;dy) wvR(y,u-d;dy) C[clamp(y+dy-r), u, d]
//   denv[y,u,d] = sum_dy wvL(y,u;dy) wvR(y,u-d;dy)
//   num [y,x,d] = sum_dx whL(y,x;dx) whR(y,x-d;dx) numv[y, x+dx-r, d]
//   den [y,x,d] = sum_dx whL(y,x;dx) whR(y,x-d;dx) denv[y, x+dx-r, d]
//
// and the output is num / den, reduced by online WTA over d.  The right
// factors are dropped in left-only mode (sym == 0).
//
// Inputs (float32, contiguous, one card):
//   ls  (7, H, W + 2r)          left stack: R, G, B, x-gradient, L, a, b
//   rs  (7, H, W + 2r + D - 1)  right stack, r + D - 1 extra columns left
//   aw  (K,)                    axial spatial factor exp(-|o| / gamma_p)
// Column j of ls is image column j - r; column j of rs is j - r - D + 1.
//
// Two steps:
//   1. weights_1d_kernel builds the 1-D weight planes once per pair, each
//      (H, K, columns): wvL and whL from ls, and in symmetric mode wvR and
//      whR from rs.  A weight depends on a column and a tap, never on d (the
//      right factor depends on x - d only), so the exps are K per column
//      instead of K per (column, d).  Each factor is the color factor times
//      the axial factor, and symmetric mode multiplies left by right:
//      (colorL * aw) * (colorR * aw), the jnp path's product order (the
//      Pallas kernel multiplies colorL * aw^2 by colorR instead).
//   2. asw_sep_wta_kernel: one block per (row y, tile of TXS = TXU - 2r
//      output columns).  It walks d in chunks of DC.  For each chunk the
//      vertical pass writes numv / denv for the tile's TXU extended columns
//      into shared memory, computing each tap's raw cost on the fly from the
//      stacks (K1's tap_cost, unfused: the plain version's raw cost bit for
//      bit, so the bf16 mode rounds the same value); the horizontal pass
//      reads them back for the TXS output columns; one thread per output
//      column then folds the chunk's d into its WTA state (ascending d) and
//      the right view.
//
// What bounds it on an H100: the function's least work at KITTI (1242x375,
// D=128, r=16, symmetric) is ~19 GFLOP of FP32 (per vertical tap a weight
// product, an FMA and an add; per horizontal tap a product and two FMAs;
// each raw cost and each 1-D weight once), ~0.29 ms at the card's FP32
// peak, against ~40 MB of stacks in and planes out (k2_bound in
// chip_smoke.py).  This kernel does more: it computes the raw cost on
// every vertical tap (K per cost), writes and reads ~262 MB of weight
// planes, and the loads of the taps from L1 limit it: a vertical tap reads
// the right sample (4 floats) and the right weight.  The design keeps the
// left sample and left weight in registers across DJ disparities, and the
// numv / denv exchange between the passes in shared memory, so the only
// traffic to device memory is the stacks and the weight planes, mostly L2
// hits.
//
// Determinism: every output sums its taps in one fixed order, dy ascending
// then dx ascending, and every numv is computed the same way whichever
// tile computes it, so the result does not depend on the tile geometry.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division (no fast
// math).  volume_dtype="bfloat16" (bf16 != 0) rounds each raw cost to
// bfloat16 (round to nearest even) and back before it is weighted;
// accumulation stays float32.

#include <cuda_bf16.h>

#include "asw_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TXU = 128;  // extended columns of the vertical pass per block
constexpr int DC = 16;    // disparities per chunk
constexpr int DJ = 8;     // disparities per thread in each pass
static_assert(DC % DJ == 0, "a chunk holds whole thread groups");

struct SepParams {
  int H, W, r, D, K;
  int sym;      // 1: symmetric two-view weights, 0: left-only
  int cost_ad;  // 1: AD cost, 0: TAD + gradient
  int bf16;     // 1: round each raw cost to bfloat16
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
};

// out[(y * K + k) * ncols + c] for one Lab image (three planes of
// (H, width), plane stride `plane`):
//   axis 0 (vertical):   centre (y, c),     tap (clamp(y + k - r), c), ncols = width
//   axis 1 (horizontal): centre (y, c + r), tap (y, c + k),          ncols = width - 2r
__global__ void weights_1d_kernel(const float* __restrict__ lab, size_t plane,
                                  int width, int ncols, int axis,
                                  const float* __restrict__ aw, SepParams p,
                                  float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (c >= ncols) return;
  const size_t ctr = (size_t)y * width + c + (axis ? p.r : 0);
  const float c0 = lab[ctr], c1 = lab[plane + ctr], c2 = lab[2 * plane + ctr];
  for (int k = 0; k < p.K; ++k) {
    const size_t tap =
        axis ? (size_t)y * width + c + k
             : (size_t)min(max(y + k - p.r, 0), p.H - 1) * width + c;
    out[((size_t)y * p.K + k) * ncols + c] =
        bilateral(p, lab[tap], lab[plane + tap], lab[2 * plane + tap], c0, c1,
                  c2, aw[k]);
  }
}

__global__ void __launch_bounds__(THREADS)
asw_sep_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                   const float* __restrict__ wvl, const float* __restrict__ whl,
                   const float* __restrict__ wvr, const float* __restrict__ whr,
                   SepParams p, int* __restrict__ bestd_out,
                   float* __restrict__ bestc_out, float* __restrict__ cm_out,
                   float* __restrict__ cp_out, float* __restrict__ ubest_out,
                   unsigned long long* __restrict__ rpack) {
  __shared__ float numv[DC][TXU];
  __shared__ float denv[DC][TXU];
  __shared__ float agg[DC][TXU];

  const int r = p.r, K = p.K, D = p.D, W = p.W;
  const int TXS = TXU - 2 * r;    // output columns of this block
  const int x0 = blockIdx.x * TXS;  // first output column = ls column of u = 0
  const int y = blockIdx.y;
  const int WL = W + 2 * r;       // ls columns; wvL columns
  const int WR = WL + D - 1;      // rs columns; wvR columns
  const int WHR = W + D - 1;      // whR columns
  const size_t PL = (size_t)p.H * WL;
  const size_t PR = (size_t)p.H * WR;
  const int tid = threadIdx.x;
  const bool sym = p.sym != 0;

  Wta wta;  // threads tid < TXS: output column x0 + tid

  for (int d0 = 0; d0 < D; d0 += DC) {
    // ---- vertical pass: numv / denv[j][u], u in [0, TXU), d = d0 + j ----
    for (int item = tid; item < TXU * (DC / DJ); item += THREADS) {
      const int u = item % TXU;
      const int g = item / TXU;
      const int col = x0 + u;  // ls column (image column col - r)
      const int db = d0 + g * DJ;
      float nv[DJ], dv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        nv[j] = 0.f;
        dv[j] = 0.f;
      }
      if (col < WL) {
        for (int dy = 0; dy < K; ++dy) {
          const int yy = min(max(y + dy - r, 0), p.H - 1);
          const float* lt = ls + (size_t)yy * WL + col;
          const float l0 = lt[0], l1 = lt[PL], l2 = lt[2 * PL], lg = lt[3 * PL];
          const float wl = wvl[((size_t)y * K + dy) * WL + col];
          // For disparity d the right sample is rs column col + D - 1 - d
          // (image column col - r - d), and so is the right weight's centre.
          const float* rrow = rs + (size_t)yy * WR + col + D - 1;
          const float* wrow = sym ? wvr + ((size_t)y * K + dy) * WR + col + D - 1
                                  : nullptr;
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const int d = db + j;
            if (d < D) {
              const float* rt = rrow - d;
              float c = tap_cost<true>(p, l0, l1, l2, lg, rt[0], rt[PR],
                                       rt[2 * PR], rt[3 * PR]);
              if (p.bf16) c = __bfloat162float(__float2bfloat16_rn(c));
              const float w = sym ? wl * wrow[-d] : wl;
              nv[j] += w * c;
              dv[j] += w;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        numv[g * DJ + j][u] = nv[j];
        // Past the last extended column only outputs x >= W read these.
        denv[g * DJ + j][u] = col < WL ? dv[j] : 1.f;
      }
    }
    __syncthreads();

    // ---- horizontal pass: agg[j][s], s in [0, TXS), d = d0 + j ----------
    for (int item = tid; item < TXS * (DC / DJ); item += THREADS) {
      const int s = item % TXS;
      const int g = item / TXS;
      const int x = x0 + s;
      if (x >= W) continue;
      const int db = d0 + g * DJ;
      float n[DJ], dn[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        n[j] = 0.f;
        dn[j] = 0.f;
      }
      for (int dx = 0; dx < K; ++dx) {
        const float wl = whl[((size_t)y * K + dx) * W + x];
        // whR column x + D - 1 - d is centred on image column x - d.
        const float* wrow = sym ? whr + ((size_t)y * K + dx) * WHR + x + D - 1
                                : nullptr;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = db + j;
          if (d < D) {
            const float w = sym ? wl * wrow[-d] : wl;
            n[j] += w * numv[g * DJ + j][s + dx];
            dn[j] += w * denv[g * DJ + j][s + dx];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) agg[g * DJ + j][s] = n[j] / dn[j];
    }
    __syncthreads();

    // ---- online WTA over the chunk, ascending d ---------------------------
    if (tid < TXS && x0 + tid < W) {
      const int x = x0 + tid;
      for (int j = 0; j < DC && d0 + j < D; ++j) {
        const int d = d0 + j;
        const float a = agg[j][tid];
        wta.update(a, d);
        // Right view: C_R(x - d, d) = a.
        if (x - d >= 0) fold_right(rpack + (size_t)y * W + x - d, a, d);
      }
    }
    __syncthreads();
  }

  if (tid < TXS && x0 + tid < W) {
    const size_t o = (size_t)y * W + x0 + tid;
    bestd_out[o] = wta.bestd;
    bestc_out[o] = wta.bestc;
    cm_out[o] = wta.cm;
    cp_out[o] = wta.cp;
    ubest_out[o] = wta.ubest();
  }
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  wvl (H, K, W + 2r) and whl
// (H, K, W) are scratch; in symmetric mode so are wvr (H, K, W + 2r + D - 1)
// and whr (H, K, W + D - 1), which left-only mode does not touch (null).
// `rpack` must hold all-ones words on entry.  Requires 2r < TXU.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int asw_sep_wta_launch(
    const float* ls, const float* rs, const float* aw, int H, int W, int r,
    int D, int sym, int cost_ad, int bf16, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float* wvl,
    float* whl, float* wvr, float* whr, int* bestd, float* bestc, float* cm,
    float* cp, float* ubest, unsigned long long* rpack, int* rbestd,
    void* stream) {
  if (2 * r >= TXU) return (int)cudaErrorInvalidValue;
  const int K = 2 * r + 1;
  SepParams p{H, W, r, D, K, sym, cost_ad, bf16, alpha, one_minus_alpha,
              tau_color, tau_grad, inv_gamma_color};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int WL = W + 2 * r, WR = WL + D - 1;
  const size_t PL = (size_t)H * WL, PR = (size_t)H * WR;

  // Weight planes from the Lab channels (4..6) of each stack.
  struct Plane { const float* lab; size_t plane; int width, ncols, axis; float* out; };
  const Plane planes[4] = {
      {ls + 4 * PL, PL, WL, WL, 0, wvl},
      {ls + 4 * PL, PL, WL, W, 1, whl},
      {rs + 4 * PR, PR, WR, WR, 0, wvr},
      {rs + 4 * PR, PR, WR, WR - 2 * r, 1, whr},
  };
  for (int i = 0; i < (sym ? 4 : 2); ++i) {
    const Plane& q = planes[i];
    dim3 grid((q.ncols + 127) / 128, H);
    weights_1d_kernel<<<grid, 128, 0, s>>>(q.lab, q.plane, q.width, q.ncols,
                                           q.axis, aw, p, q.out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const int txs = TXU - 2 * r;
  dim3 grid((W + txs - 1) / txs, H);
  asw_sep_wta_kernel<<<grid, THREADS, 0, s>>>(ls, rs, wvl, whl, wvr, whr, p,
                                              bestd, bestc, cm, cp, ubest,
                                              rpack);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
