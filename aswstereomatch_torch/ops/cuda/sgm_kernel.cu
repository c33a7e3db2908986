// Semi-global aggregation (aggregation="sgm", 4 or 8 paths) of a raw
// (H, W, D) float32 cost volume.
//
// Replaces the reference's XLA scans, aswstereomatch_tpu/ops/aggregate.py
// (_sgm_scan, aggregate_sgm, _sgm_scan_diag: lax.scan over a carried
// (lines, D) plane, not a Pallas kernel).  Per path direction r, with
// predecessor q = p - r:
//
//   L(p, d) = (C(p, d) + min(L(q, d), min(L(q, d-1), L(q, d+1)) + P1,
//                            pmin + P2)) - pmin,   pmin = min_d' L(q, d')
//
// with L = C where p has no in-image predecessor, and +inf for the
// out-of-range d-1 / d+1 terms.  S sums the paths in the pinned order:
// l2r, r2l, t2b, b2t, then (1,1), (1,-1), (-1,1), (-1,-1) as (dy, dx)
// steps.  Every operation is an add, a subtract or a min, so the kernel
// takes the reference's operations in the reference's order and is equal
// to it (and to the plain version, sgm_kernel.py) bit for bit.
//
// Design.  Each direction is one launch; the first writes S = L, each
// later one S = S + L, which reproduces ((l2r + r2l) + t2b) + b2t and then
// the four diagonals in order.  One warp runs one scanline: a row (l2r,
// r2l), a column (t2b, b2t), or a diagonal starting at its first in-image
// pixel (row 0 or H - 1, then column 0 or W - 1), H + W - 1 of them.
// Disparities lie across the lanes in chunks of 32 (d = 32k + lane).  The
// previous step's L row lives in a per-warp buffer with a +inf guard at
// d = -1 and d = D, double-buffered (read one, write the other,
// __syncwarp), so the d +- 1 neighbours across chunk edges are plain loads
// and every D runs: in shared memory while one warp's two rows fit the
// 48 KB a block takes without opting in (D <= 6142), else in a global
// scratch buffer the binding allocates (the generic pointer is the same).
// pmin is a warp min-reduction of each lane's running min (min is exact in
// any order).  Each step loads the pixel's D costs (and S): d is the
// contiguous axis, so a chunk is one 128-byte line.  Those loads do not
// depend on the recurrence, so they are issued PD steps ahead into a
// register ring (the first PF chunks, D <= 128 as in every preset; chunks
// past them load at use).
//
// What bounds it on an H100: bytes.  The function's least traffic is one
// read of C and one write of S, 2 x 4 H W D bytes (477 MB at 1242 x 375,
// D = 128: 0.142 ms at 3.35 TB/s; ~8 flops per (pixel, d, path) are far
// below the FP32 peak).  One pass per direction moves C once and S once or
// twice: 3 P - 1 volumes for P paths, 11 for 4, 23 for 8.  A row pass has
// only H warps (375 at KITTI), so the loads' latency rather than the rate
// bounds each step; the prefetch ring hides part of it.
//
// Numerics: float32 adds and mins only; no fast math, no FMA contraction
// (there is no multiply).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;                 // scanlines per block
constexpr int PD = 4;                    // prefetch depth, steps
constexpr int PF = 4;                    // chunks of 32 disparities prefetched
constexpr int SMEM_BUDGET = 48 * 1024;   // bytes a block takes without opt-in

struct Pass {
  const float* C;
  float* S;
  float* scratch;  // null, or n_lines x 2 (D + 2) floats for the L rows
  int H, W, D, dy, dx, n_lines;
  int accumulate;  // 0: S = L (first direction), 1: S = S + L
  float p1, p2;
};

// First pixel and length of scanline i of the pass's direction.
__device__ inline void line_start(const Pass& q, int i, int& y, int& x, int& n) {
  if (q.dy == 0) {
    y = i;
    x = q.dx > 0 ? 0 : q.W - 1;
  } else if (q.dx == 0) {
    x = i;
    y = q.dy > 0 ? 0 : q.H - 1;
  } else if (i < q.W) {  // from the first row it enters
    y = q.dy > 0 ? 0 : q.H - 1;
    x = i;
  } else {  // from the first column it enters, the row's pixel excluded
    const int j = i - q.W + 1;
    y = q.dy > 0 ? j : q.H - 1 - j;
    x = q.dx > 0 ? 0 : q.W - 1;
  }
  const int ny = q.dy > 0 ? q.H - y : (q.dy < 0 ? y + 1 : q.H);
  const int nx = q.dx > 0 ? q.W - x : (q.dx < 0 ? x + 1 : q.W);
  n = q.dy == 0 ? nx : (q.dx == 0 ? ny : min(ny, nx));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// L(p, d) from the cost c and the previous step's row (prev[1 + d] holds
// L(q, d); prev[0] and prev[D + 1] are +inf), as the reference computes it.
__device__ __forceinline__ float recur(float c, const float* prev, int d, float pmin,
                                       float p1, float p2) {
  const float best = fminf(fminf(prev[1 + d], pmin + p2), fminf(prev[d], prev[2 + d]) + p1);
  return (c + best) - pmin;
}

__global__ void __launch_bounds__(32 * WARPS) sgm_pass_kernel(Pass q) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int line = blockIdx.x * (blockDim.x >> 5) + warp;
  if (line >= q.n_lines) return;  // a whole warp: no block-wide barrier follows
  const int D = q.D;
  const int stride = 2 * (D + 2);
  float* prev = q.scratch ? q.scratch + (size_t)line * stride : smem + warp * stride;
  float* cur = prev + D + 2;
  if (lane == 0) prev[0] = prev[D + 1] = cur[0] = cur[D + 1] = INFINITY;

  int y, x, n;
  line_start(q, line, y, x, n);
  const long long step = ((long long)q.dy * q.W + q.dx) * D;
  const long long off0 = ((long long)y * q.W + x) * D;
  const int nc = (D + 31) / 32;

  // Ring of the next PD steps' costs (and S) for the first PF chunks.
  float cr[PD][PF], sr[PD][PF];
#pragma unroll
  for (int u = 0; u < PD; ++u) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int d = 32 * k + lane;
      cr[u][k] = sr[u][k] = 0.f;
      if (u < n && d < D) {
        cr[u][k] = q.C[off0 + u * step + d];
        if (q.accumulate) sr[u][k] = q.S[off0 + u * step + d];
      }
    }
  }
  __syncwarp();  // the guards

  float pmin = 0.f;
  for (int t0 = 0; t0 < n; t0 += PD) {
#pragma unroll
    for (int u = 0; u < PD; ++u) {
      const int t = t0 + u;
      if (t >= n) break;  // uniform across the warp
      const long long off = off0 + t * step;
      float lmin = INFINITY;
#pragma unroll
      for (int k = 0; k < PF; ++k) {
        const int d = 32 * k + lane;
        if (d < D) {
          const float v = t == 0 ? cr[u][k] : recur(cr[u][k], prev, d, pmin, q.p1, q.p2);
          cur[1 + d] = v;
          q.S[off + d] = q.accumulate ? sr[u][k] + v : v;
          lmin = fminf(lmin, v);
        }
      }
      for (int k = PF; k < nc; ++k) {  // D > 128 only
        const int d = 32 * k + lane;
        if (d < D) {
          const float c = q.C[off + d];
          const float v = t == 0 ? c : recur(c, prev, d, pmin, q.p1, q.p2);
          cur[1 + d] = v;
          q.S[off + d] = q.accumulate ? q.S[off + d] + v : v;
          lmin = fminf(lmin, v);
        }
      }
      // Refill this ring slot with step t + PD.
      if (t + PD < n) {
        const long long offn = off + PD * step;
#pragma unroll
        for (int k = 0; k < PF; ++k) {
          const int d = 32 * k + lane;
          if (d < D) {
            cr[u][k] = q.C[offn + d];
            if (q.accumulate) sr[u][k] = q.S[offn + d];
          }
        }
      }
      __syncwarp();  // this step's row is written before any lane reads it
      pmin = warp_min(lmin);
      float* tmp = prev;
      prev = cur;
      cur = tmp;
    }
  }
}

// Scanlines of direction (dy, dx).
int lines_of(int H, int W, int dy, int dx) {
  return dy == 0 ? H : (dx == 0 ? W : H + W - 1);
}

}  // namespace

// Floats of global scratch the launch needs for the per-warp L rows: 0
// while one warp's two rows fit in the shared-memory budget.
extern "C" long long sgm_scratch_floats(int H, int W, int D, int paths) {
  const long long row2 = 2LL * (D + 2);
  if (row2 * (long long)sizeof(float) <= SMEM_BUDGET) return 0;
  long long lines = H > W ? H : W;
  if (paths == 8) lines = H + W - 1;
  return lines * row2;
}

// Plain C entry, called by asw_binding.cpp: S (H, W, D) from C (H, W, D),
// both float32 and contiguous on one card; `scratch` holds
// sgm_scratch_floats(...) floats (null when that is 0).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int sgm_aggregate_launch(const float* C, float* S, float* scratch, int H,
                                    int W, int D, int paths, float p1, float p2,
                                    void* stream) {
  static const int dirs[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0},
                                 {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
  if (H < 1 || W < 1 || D < 1 || (paths != 4 && paths != 8))
    return (int)cudaErrorInvalidValue;
  if ((sgm_scratch_floats(H, W, D, paths) > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t row2 = sizeof(float) * 2 * ((size_t)D + 2);
  const int warps = scratch ? WARPS : (int)(SMEM_BUDGET / row2 < WARPS ? SMEM_BUDGET / row2 : WARPS);
  const size_t smem = scratch ? 0 : warps * row2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j = 0; j < paths; ++j) {
    const Pass q{C, S, scratch, H, W, D, dirs[j][0], dirs[j][1],
                 lines_of(H, W, dirs[j][0], dirs[j][1]), j > 0, p1, p2};
    sgm_pass_kernel<<<(q.n_lines + warps - 1) / warps, 32 * warps, smem, s>>>(q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
