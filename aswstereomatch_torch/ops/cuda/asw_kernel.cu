// Fused cost + exact ASW (or box) aggregation + online dual-view WTA.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_kernel.py
// (_kernel + _accumulate, launched by wta_outputs_from_stacks).  It computes
// what that kernel computes, not its Mosaic layout: one thread per output
// pixel (y, x) walks every disparity d and every window tap (dy, dx), builds
// the raw TAD+gradient (or AD) cost and the bilateral weights on the fly from
// the edge-padded channel stacks, and keeps the left-view winner-take-all
// state in registers.  The H x W x D aggregated volume never exists.
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
// ubest (second-best cost excluding bestd +- 1) and rpack, the right view:
// candidate C_R(x', d) = C_L(x' + d, d) is folded in with an atomicMin on
// (float bits << 32 | d).  Costs are >= 0, so the unsigned order of the
// packed word is (cost, then lower d): first-occurrence argmin over d.
//
// What bounds it on an H100: arithmetic, not bytes.  Per (pixel, d, tap)
// the symmetric mode does one expf + sqrtf for the right weight and roughly
// 25 other float operations, over inputs that stay in L1/L2 (the two stacks
// of a KITTI pair are about 28 MB).  The design walks d in chunks of DCHUNK
// so that a tap's left samples and left weight (one expf + sqrtf) are loaded
// and computed once per chunk instead of once per d.  The function needs
// less than the kernel does: a right weight depends on x - d only and a raw
// cost is shared by K^2 windows, so its least work is a weight product, an
// FMA and an add per tap, ~4 ms at KITTI on the card's FP32 peak (k1_bound
// in chip_smoke.py).  Every pixel sums its taps in one fixed (dy, dx)
// order, whatever block it lands in.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division (this file
// must not be built with --use_fast_math).

#include "asw_common.cuh"

namespace {

constexpr int DCHUNK = 8;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 4;

enum Mode { kSymmetric = 0, kLeftOnly = 1, kBox = 2 };

struct Params {
  int H, W, r, D;
  int mode;       // Mode
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
  float inv_n;            // (float)(1 / K^2), box mode
};

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
asw_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
               const float* __restrict__ sw, Params p,
               int* __restrict__ bestd_out, float* __restrict__ bestc_out,
               float* __restrict__ cm_out, float* __restrict__ cp_out,
               float* __restrict__ ubest_out,
               unsigned long long* __restrict__ rpack) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= p.W || y >= p.H) return;

  const int r = p.r, D = p.D, K = 2 * r + 1;
  const int WL = p.W + 2 * r;
  const int WR = WL + D - 1;
  const size_t PL = (size_t)p.H * WL;  // plane stride of ls
  const size_t PR = (size_t)p.H * WR;  // plane stride of rs
  const bool box = p.mode == kBox;
  const bool sym = p.mode == kSymmetric;

  // Left window centre (image column x is ls column x + r).
  const size_t cl = (size_t)y * WL + x + r;
  const float cl0 = ls[4 * PL + cl], cl1 = ls[5 * PL + cl], cl2 = ls[6 * PL + cl];

  Wta wta;

  for (int d0 = 0; d0 < D; d0 += DCHUNK) {
    float num[DCHUNK], den[DCHUNK];
    float cr0[DCHUNK], cr1[DCHUNK], cr2[DCHUNK];
#pragma unroll
    for (int j = 0; j < DCHUNK; ++j) {
      num[j] = 0.f;
      den[j] = 0.f;
      // Right window centre x - d is rs column x + r + D - 1 - d.
      const int dd = min(d0 + j, D - 1);
      const size_t cr = (size_t)y * WR + x + r + D - 1 - dd;
      cr0[j] = sym ? rs[4 * PR + cr] : 0.f;
      cr1[j] = sym ? rs[5 * PR + cr] : 0.f;
      cr2[j] = sym ? rs[6 * PR + cr] : 0.f;
    }
    float den_left = 0.f;

    for (int dy = 0; dy < K; ++dy) {
      const int yy = min(max(y + dy - r, 0), p.H - 1);
      const float* lrow = ls + (size_t)yy * WL + x;
      const float* rrow = rs + (size_t)yy * WR + x + D - 1;
      for (int dx = 0; dx < K; ++dx) {
        // Tap at image column x + dx - r: ls column x + dx, and for
        // disparity d the right sample at rs column x + dx + D - 1 - d.
        const float l0 = lrow[dx], l1 = lrow[PL + dx], l2 = lrow[2 * PL + dx];
        const float lg = lrow[3 * PL + dx];
        const float spatial = sw[dy * K + dx];
        float wl = 1.f;
        if (!box) {
          wl = bilateral(p, lrow[4 * PL + dx], lrow[5 * PL + dx],
                         lrow[6 * PL + dx], cl0, cl1, cl2, spatial);
          den_left += wl;
        }
#pragma unroll
        for (int j = 0; j < DCHUNK; ++j) {
          const int d = d0 + j;
          if (d < D) {
            const float* rt = rrow + dx - d;
            const float c = tap_cost(p, l0, l1, l2, lg, rt[0], rt[PR],
                                     rt[2 * PR], rt[3 * PR]);
            if (box) {
              num[j] += c;
            } else if (sym) {
              const float wr = bilateral(p, rt[4 * PR], rt[5 * PR],
                                         rt[6 * PR], cr0[j], cr1[j], cr2[j],
                                         spatial);
              const float t = wl * wr;
              num[j] += t * c;
              den[j] += t;
            } else {
              num[j] += wl * c;
            }
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < DCHUNK; ++j) {
      const int d = d0 + j;
      if (d >= D) break;
      const float agg = box ? num[j] * p.inv_n
                            : num[j] / (sym ? den[j] : den_left);
      wta.update(agg, d);
      // Right view: C_R(x - d, d) = agg.
      if (x - d >= 0) fold_right(rpack + (size_t)y * p.W + x - d, agg, d);
    }
  }

  const size_t o = (size_t)y * p.W + x;
  bestd_out[o] = wta.bestd;
  bestc_out[o] = wta.bestc;
  cm_out[o] = wta.cm;
  cp_out[o] = wta.cp;
  ubest_out[o] = wta.ubest();
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  Returns the cudaError_t of the launches (0 on success).
extern "C" int asw_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int mode, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream) {
  Params p{H, W, r, D, mode, cost_ad, alpha, one_minus_alpha,
           tau_color, tau_grad, inv_gamma_color, inv_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y);
  asw_wta_kernel<<<grid, block, 0, s>>>(ls, rs, sw, p, bestd, bestc, cm, cp,
                                        ubest, rpack);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}

extern "C" const char* asw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
