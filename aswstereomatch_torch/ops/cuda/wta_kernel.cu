// The WTA planes of an aggregated (H, W, D) cost volume in one launch.
//
// Replaces no Pallas kernel: the reference leaves the volume's WTA to XLA
// as jnp ops (aswstereomatch_tpu/ops/wta.py and postprocess.right_volume).
// The port's plain version (ops/wta.py::planes) dispatches ~20 ops a
// volume: an argmin, casts and three gathers for the triple; an inf pad, a
// cat, an int64 index, a gather and a second argmin for the right view; an
// int64 |d - bestd| volume, a compare, a where and an amin for ubest, with
// a scalar copied from the host.  This kernel computes the same planes bit
// for bit in one launch.
//
// Input: S (H, W, D) float32, contiguous, on one card.  Outputs (H, W):
//   bestd  int32    argmin_d S[y, x, d]
//   bestc  float32  S[y, x, bestd]
//   cm, cp float32  S[y, x, clamp(bestd -+ 1, 0, D - 1)]
//   rbestd int32    argmin_d S[y, x' + d, d] over x' + d <= W - 1 (the right
//                   view by volume reuse; the rest are +inf in the plain
//                   version and never win), when asked for
//   ubest  float32  min of S[y, x, d] over |d - bestd| > 1, +inf where no d
//                   is left (D <= 3), when asked for
//
// Bits.  Minima are exact, so only the tie and NaN rules are at stake; both
// are torch's.  An argmin takes the first NaN if there is one, else the
// first minimum (torch.argmin's order); ubest is NaN where a candidate is,
// as torch.amin propagates it (the NaN's own bits where there is one).
// One case has no defined answer on either side: where ubest's minimum is a
// zero held as both +0.0 and -0.0, the sign depends on the reduction's
// order; S never holds -0.0 on the port's paths (sums of costs >= +0).
//
// Bound.  By bytes: one read of S and one write of the planes, 4 H W D +
// 4 H W (4 to 6) bytes: 238 MB, ~0.074 ms, at KITTI (1242x375, D = 128);
// 1.47 GB, ~0.45 ms, at 1440x994, D = 256 (3.35 TB/s).  At that rate an SM
// takes in ~3.5 floats a clock and issues at most 128 thread-instructions
// a clock, so the design spends few instructions on an element.
//
// Design.  One block takes one row, so each right column's candidates
// arrive in one block in ascending d and no atomics are needed.  It walks
// the row in tiles of TX columns (TX x D contiguous floats of S), staged
// into shared memory NSTAGE - 1 tiles ahead by 16-byte cp.async (4-byte
// where D is not a multiple of 4, the column then padded with +inf to a
// multiple of 4), so the row streams from device memory once while the
// block works on the tile before.  On each tile:
//   - the left view: K threads a column (K from D, so that a thread holds
//     at most NQ groups of 4 disparities).  Each takes its groups' minima
//     (float4 reads, min.NaN) into registers; a K-lane shuffle gives the
//     column's minimum, NaN where the column holds one.  Without a NaN the
//     argmin is the first d whose value equals the minimum: each lane's
//     first group whose minimum does, then that group's first element, the
//     lowest over the lanes.  ubest is the minimum of the group minima
//     clear of bestd +-1 and of the far elements of the (at most two)
//     groups that meet it.  A column with a NaN takes an exact scan of every
//     element under torch's rules.
//   - the right view: one thread owns the right columns x' of one residue
//     x' mod D.  Column x holds one candidate of each, d = (x - x') mod D,
//     so walking the tile's columns in ascending x the thread meets its
//     candidates in ascending d, each column's last (d = D - 1) just before
//     the next one's first; it writes a column out at its last candidate,
//     or at the row's end.  Every element is one step of one thread, and at
//     a step a warp's lanes read consecutive words of one staged column.
//     The running (min, argmin) carries from tile to tile in shared memory,
//     one slot a residue, which only its owner touches.
// The columns of a tile lie `stride` floats apart in shared memory, stride
// >= D rounded up to 4 and stride = 4 K (mod 32), so that the K lanes of
// the columns one float4 read serves hit distinct banks.  Kernel-route
// shapes: D = 128 gives K = 4, TX = 64, stride 144 (37 KB a stage); D = 256
// K = 8, TX = 32, stride 256 (32 KB); two blocks fit an SM.  The kernel
// allocates nothing and does not synchronise with the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSTAGE = 3;             // staged tiles: NSTAGE - 1 in flight
constexpr int STAGE_FLOATS = 9216;    // a stage's largest size, 36 KB
constexpr int GROUPS_PER_THREAD = 8;  // the left view's groups a thread holds, where K allows
constexpr int MAX_D = 2048;           // keeps a thread's groups within 16

struct Args {
  const float* S;
  int* bestd;
  float* bestc;
  float* cm;
  float* cp;
  int* rbestd;   // null: not asked for
  float* ubest;  // null: not asked for
  int H, W, D;
  int k, stride, tx, tiles, groups;  // groups: ceil(D / 4)
  int vec4;                          // D % 4 == 0: 16-byte copies
};

__device__ __forceinline__ unsigned full_mask() { return 0xffffffffu; }

// The minimum that is NaN where either is (any NaN comes out canonical).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.argmin's order on (value, index): a NaN first, the lower index
// among NaNs and among equal values.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  if (isnan(va)) return !isnan(vb) || ia < ib;
  return va < vb || (va == vb && ia < ib);
}

// One step of an ascending-d scan under torch's rules: v at d replaces the
// running best if it comes first (d is above every index seen): v < best,
// or v a NaN and best not.  !(v >= best) is v < best or either a NaN.
__device__ __forceinline__ void step(float& best, int& bi, float v, int d) {
  const bool take = !(v >= best) & (best == best);
  best = take ? v : best;
  bi = take ? d : bi;
}

// The NaN-propagating minimum torch.amin takes, keeping the NaN's bits.
__device__ __forceinline__ float nan_min(float m, float v) {
  return (isnan(v) || v < m) ? v : m;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage tile t of the row (its nx x D floats, contiguous in S) into stage
// t % NSTAGE, column c at c * stride; commits a group either way, so that
// every thread counts one group a tile.
__device__ __forceinline__ void stage_tile(const Args& a, const float* row, float* stages,
                                           int t) {
  if (t < a.tiles) {
    const int x0 = t * a.tx, nx = min(a.tx, a.W - x0);
    float* dst = stages + (t % NSTAGE) * a.tx * a.stride;
    const float* src = row + (size_t)x0 * a.D;
    const int vec = a.vec4 ? 4 : 1, G = a.D / vec, n = nx * G;
    const int step_x = THREADS / G, step_g = THREADS - step_x * G;
    int x = threadIdx.x / G, g = threadIdx.x - x * G;
    for (int i = threadIdx.x; i < n; i += THREADS) {  // i = x G + g
      if (a.vec4)
        cp_async16(dst + x * a.stride + 4 * g, src + (size_t)i * 4);
      else
        cp_async4(dst + x * a.stride + g, src + i);
      x += step_x;
      g += step_g;
      if (g >= G) {
        g -= G;
        ++x;
      }
    }
  }
  cp_commit();
}

// The exact left view of one column under torch's rules, for a column that
// holds a NaN: each of the column's K lanes scans its groups, then a merge
// (the pad past D is +inf and changes neither result).
__device__ __noinline__ void left_exact(const float* col, int kk, int K, int groups, bool want_u,
                                        unsigned gmask, int& b, float& u) {
  float best = INFINITY;
  b = 4 * kk;  // this lane's first d: a tie of +inf keeps the lowest
  for (int g = kk; g < groups; g += K) {
    const float4 q = *reinterpret_cast<const float4*>(col + 4 * g);
    step(best, b, q.x, 4 * g);
    step(best, b, q.y, 4 * g + 1);
    step(best, b, q.z, 4 * g + 2);
    step(best, b, q.w, 4 * g + 3);
  }
  for (int o = K >> 1; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(gmask, best, o);
    const int oi = __shfl_xor_sync(gmask, b, o);
    if (before(ov, oi, best, b)) {
      best = ov;
      b = oi;
    }
  }
  u = INFINITY;
  if (want_u) {
    for (int g = kk; g < groups; g += K)
      for (int j = 0; j < 4; ++j)
        if (abs(4 * g + j - b) > 1) u = nan_min(u, col[4 * g + j]);
    for (int o = K >> 1; o > 0; o >>= 1) u = nan_min(u, __shfl_xor_sync(gmask, u, o));
  }
}

// The left view of a staged tile: bestd, the triple and ubest of its nx
// columns, K threads a column, each holding at most NQ group minima.
template <int NQ>
__device__ __forceinline__ void left_view(const Args& a, const float* tile, int nx,
                                          size_t out0) {
  const int K = a.k, D = a.D, groups = a.groups;
  const int lane = threadIdx.x & 31, kk = threadIdx.x & (K - 1);
  const unsigned gmask = K == 32 ? full_mask() : ((1u << K) - 1) << (lane & ~(K - 1));
  for (int c0 = 0; c0 < nx; c0 += THREADS / K) {  // the same count in every thread
    const int c = c0 + threadIdx.x / K;
    const bool on = c < nx;
    const float* col = tile + (on ? c : 0) * a.stride;
    float gm[NQ];
    float m = INFINITY;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = kk + q * K;
      gm[q] = INFINITY;
      if (on && g < groups) {
        const float4 v = *reinterpret_cast<const float4*>(col + 4 * g);
        gm[q] = min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w));
        m = min_nan(m, gm[q]);
      }
    }
    for (int o = K >> 1; o > 0; o >>= 1) m = min_nan(m, __shfl_xor_sync(gmask, m, o));
    int b;
    float u = INFINITY;
    if (isnan(m)) {  // the column's K lanes agree
      left_exact(col, kk, K, groups, a.ubest != nullptr, gmask, b, u);
    } else {
      // the first d whose value is m: this lane's first group whose minimum
      // is m, then that group's first element; the lowest over the lanes
      int qf = -1;
#pragma unroll
      for (int q = NQ - 1; q >= 0; --q) qf = gm[q] == m && kk + q * K < groups ? q : qf;
      b = INT_MAX;
      if (qf >= 0) {
        const int g = kk + qf * K;
        const float4 v = *reinterpret_cast<const float4*>(col + 4 * g);
        b = 4 * g + (v.x == m ? 0 : v.y == m ? 1 : v.z == m ? 2 : 3);
      }
      for (int o = K >> 1; o > 0; o >>= 1) b = min(b, __shfl_xor_sync(gmask, b, o));
      if (a.ubest) {
        // the groups clear of [b - 1, b + 1] by their minima, the ones that
        // meet it element by element
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int g = kk + q * K;
          const bool meets = (unsigned)(b + 1 - 4 * g) <= 5u;  // 4 g in [b - 4, b + 1]
          if (meets && g < groups) {
            const float4 v = *reinterpret_cast<const float4*>(col + 4 * g);
            const int e = 4 * g - b + 1;  // d - b + 1 at the group's first element
            if ((unsigned)e > 2u) u = fminf(u, v.x);
            if ((unsigned)(e + 1) > 2u) u = fminf(u, v.y);
            if ((unsigned)(e + 2) > 2u) u = fminf(u, v.z);
            if ((unsigned)(e + 3) > 2u) u = fminf(u, v.w);
          } else {
            u = fminf(u, gm[q]);
          }
        }
        for (int o = K >> 1; o > 0; o >>= 1) u = fminf(u, __shfl_xor_sync(gmask, u, o));
      }
    }
    if (on && kk == 0) {
      a.bestd[out0 + c] = b;
      a.bestc[out0 + c] = col[b];
      a.cm[out0 + c] = col[max(b - 1, 0)];
      a.cp[out0 + c] = col[min(b + 1, D - 1)];
      if (a.ubest) a.ubest[out0 + c] = u;
    }
  }
}

// The right view's share of a staged tile (columns [x0, x0 + nx)): each
// thread walks the columns for its residues rho, candidate d = (x - rho)
// mod D at column x; a right column is complete at its candidate D - 1,
// and the next of the residue starts at the following column.  The open
// column's (min, argmin) carries to the next tile in (sv, si)[rho].  A
// column's end is a select and a predicated store, so that no branch
// divides a warp whose lanes end their columns at different steps.
__device__ __forceinline__ void right_view(const Args& a, const float* tile, int x0, int nx,
                                           bool last, float* sv, int* si, int* rrow) {
  const int D = a.D, step_o = a.stride + 1;
  // rrow[first + i] is the right column that ends at column x0 + i
  int* const first = rrow + (x0 - (D - 1));
  const int i_store = D - 1 - x0;  // the columns before it end before the row starts
  for (int rho = threadIdx.x; rho < D; rho += THREADS) {
    float best = sv[rho];
    int bi = si[rho];
    int d = (x0 - rho) % D;  // the candidate at column x0
    if (d < 0) d += D;
    int o = d;           // (column x - x0, d) in the staged tile
    bool fresh = false;  // the previous step ended a right column
    for (int i = 0; i < nx; ++i) {
      const float v = tile[o];
      const bool take = fresh | (!(v >= best) & (best == best));  // step()'s rule
      best = take ? v : best;
      bi = take ? d : bi;
      fresh = d == D - 1;
      if (fresh & (i >= i_store)) first[i] = bi;
      o += fresh ? step_o - D : step_o;
      d = fresh ? 0 : d + 1;
    }
    if (fresh) {  // the tile ended a right column: the next starts afresh
      best = INFINITY;
      bi = 0;
    }
    if (!last) {
      sv[rho] = best;
      si[rho] = bi;
    } else if (d > 0 && x0 + nx - d >= 0) {  // the row ends: its open column is complete
      rrow[x0 + nx - d] = bi;
    }
  }
}

template <int NQ>
__global__ void __launch_bounds__(THREADS) wta_planes_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* sv = stages + NSTAGE * a.tx * a.stride;
  int* si = reinterpret_cast<int*>(sv + a.D);
  const int y = blockIdx.x;
  const size_t out_row = (size_t)y * a.W;
  const float* row = a.S + out_row * a.D;
  for (int rho = threadIdx.x; rho < a.D; rho += THREADS) {  // each thread's own residues
    sv[rho] = INFINITY;
    si[rho] = 0;
  }
  // the pad of each staged column past D, which no copy writes: +inf
  const int pad = 4 * a.groups - a.D;
  for (int i = threadIdx.x; i < NSTAGE * a.tx * pad; i += THREADS)
    stages[(i / pad) * a.stride + a.D + i % pad] = INFINITY;

#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) stage_tile(a, row, stages, t);
  for (int t = 0; t < a.tiles; ++t) {
    cp_wait<NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();        // everyone's have, and tile t - 1's stage is free
    stage_tile(a, row, stages, t + NSTAGE - 1);
    const float* tile = stages + (t % NSTAGE) * a.tx * a.stride;
    const int x0 = t * a.tx, nx = min(a.tx, a.W - x0);
    left_view<NQ>(a, tile, nx, out_row + x0);
    if (a.rbestd) right_view(a, tile, x0, nx, t == a.tiles - 1, sv, si, a.rbestd + out_row);
  }
  cp_wait<0>();
}

// The tile plan from (W, D): the threads a column K (the fewest, up to 32,
// that leave a thread at most GROUPS_PER_THREAD groups), its groups NQ at
// most, the column stride and the tile width TX.
struct Plan {
  int groups, k, nq, stride, tx;
};

Plan plan_for(int W, int D) {
  Plan p;
  p.groups = (D + 3) / 4;
  p.k = 1;
  while (p.k < 32 && p.k * GROUPS_PER_THREAD < p.groups) p.k *= 2;
  p.nq = (p.groups + p.k - 1) / p.k;
  const int r = (4 * p.k) % 32;
  p.stride = 4 * p.groups + ((r - 4 * p.groups) % 32 + 32) % 32;
  p.tx = THREADS / p.k;
  if (p.tx * p.stride > STAGE_FLOATS) p.tx = STAGE_FLOATS / p.stride;
  if (p.tx < 1) p.tx = 1;
  if (p.tx > W) p.tx = W;
  return p;
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  Returns the cudaError_t (0 on
// success); inputs this kernel cannot take return cudaErrorInvalidValue
// without launching.  S (H, W, D) -> bestd, bestc, cm, cp, and rbestd and
// ubest where not null, each (H, W).  One launch on `stream`.
extern "C" int wta_planes_launch(const float* S, int H, int W, int D, int* bestd, float* bestc,
                                 float* cm, float* cp, int* rbestd, float* ubest, void* stream) {
  if (H < 1 || W < 1 || D < 1 || D > MAX_D || (long long)W + D >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(W, D);
  const bool vec4 = D % 4 == 0;
  if (vec4 && reinterpret_cast<uintptr_t>(S) % 16 != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.S = S;
  a.bestd = bestd;
  a.bestc = bestc;
  a.cm = cm;
  a.cp = cp;
  a.rbestd = rbestd;
  a.ubest = ubest;
  a.H = H;
  a.W = W;
  a.D = D;
  a.k = p.k;
  a.stride = p.stride;
  a.tx = p.tx;
  a.tiles = (W + p.tx - 1) / p.tx;
  a.groups = p.groups;
  a.vec4 = vec4;
  const size_t smem = sizeof(float) * ((size_t)NSTAGE * p.tx * p.stride + 2 * (size_t)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = p.nq > 8;
  const void* kernel =
      wide ? (const void*)wta_planes_kernel<16> : (const void*)wta_planes_kernel<8>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)  // the most shared memory, so that two blocks fit an SM
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  if (wide)
    wta_planes_kernel<16><<<H, THREADS, smem, st>>>(a);
  else
    wta_planes_kernel<8><<<H, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
