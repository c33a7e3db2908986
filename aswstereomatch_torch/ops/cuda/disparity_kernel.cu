// The float32 disparity map from one pair's WTA planes in one launch.
//
// Replaces no Pallas kernel: the reference leaves this work to XLA as jnp
// ops.  The port's plain version (disparity_kernel.py::reference: parabola
// subpixel, LR check, uniqueness gate, hole filling, then the 3x3 median)
// dispatches ~40 ops a map, among them a cummax and a cummin scan, the
// median's nine-tap stack and its sort, and a scalar copied from the host
// that makes the host wait for the card; the card idles while the host
// enqueues them.  This kernel computes the same map bit for bit in one
// launch, and nothing in it waits for the card.
//
// Inputs (contiguous, one card, (H, W) each): bestd int32, the argmin;
// bestc, cm, cp float32, its (C[d], C[d-1], C[d+1]) triple; rbestd int32,
// the right view's argmin, where lr_check is on; ubest float32, the second
// best outside the winner's +-1, where the uniqueness gate is on.  Output:
// out float32 (H, W).  Each stage follows its flag, one code path for every
// combination:
//   subpixel    d* = d - clamp((cp - cm) / (2 denom), -0.5, 0.5) with
//               denom = (cp - 2 c0) + cm, where 0 < d < D - 1 and
//               |denom| > 1e-6; else d;
//   lr_check    valid iff d in [0, D), x - d in [0, W) and
//               |d - rbestd[x - d]| <= lr_tol;
//   uniqueness  valid iff ubest * 100 >= bestc * uscale, uscale being
//               100 + ratio rounded to float32 on the host;
//   fill        an invalid pixel takes min(nearest valid on its left,
//               nearest valid on its right) of its row, 0 where the row has
//               none; without fill it reads -1;
//   median      the 3x3 median, replicate border.
//
// Bits.  Every float operation is the one the plain op performs on the
// card, in the same order, each rounded on its own (__fsub_rn, __fadd_rn,
// __fmul_rn, __fdiv_rn, which nvcc never contracts): torch.clamp and
// torch.minimum keep a NaN, torch.round is rintf, and Python's scalars
// meet float32 tensors as float32.  The median is the fifth of the nine
// taps in torch.sort's ascending order, NaN above everything, from a fixed
// selection network of 19 compare-exchanges.
//
// Design.  The map reads ~20 bytes a pixel and writes 4: ~11 MB at KITTI
// (1242x375), ~3.3 us at the H100's 3.35 TB/s.  Hole filling is row-local
// over the whole width and the median needs one row above and one below,
// so one block takes a band of TY output rows across the full width.  It
// computes disp_pre for its TY rows and, where the median is on, one halo
// row on each side (clamped at the image's top and bottom, which is the
// median's replicate border) into shared memory, with each pixel's valid
// flag.  One warp per row then fills the holes: each lane owns a run of
// ceil(W / 32) columns, a warp-wide prefix max of the runs' last valid
// columns and a suffix min of their first valid ones give the nearest
// valid column before and after each run, and the lane walks its run
// forward (writing each hole's left neighbour into the hole's slot) and
// back (reading it, with the right neighbour, into the fill value).  Valid
// pixels are never written, so the lanes read one another's runs freely.
// Last, each output pixel's median comes from the nine taps in shared
// memory.  In the first step each thread loads ILP pixels side by side.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int TY = 2;        // output rows per block
constexpr int ILP = 4;       // pixels a thread loads side by side
constexpr int MAX_W = 8192;  // TY + 2 rows of W floats and W flags: 160 KB of shared memory
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* bestd;
  const float* bestc;
  const float* cm;
  const float* cp;
  const int* rbestd;   // null unless lr_check
  const float* ubest;  // null unless uniqueness
  float* out;
  int H, W, D;
  int subpixel, lr_check, uniqueness, fill, median;
  float lr_tol, uscale;
};

// torch.clamp(v, lo, hi) on the card: a NaN v stays NaN.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum on the card: a NaN operand is the result.
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.sort's ascending order: NaN above every number.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (b != b && a == a);
}

__device__ __forceinline__ void sort2(float& a, float& b) {
  if (before(b, a)) {
    const float t = a;
    a = b;
    b = t;
  }
}

// The fifth smallest of nine (Paeth's median-of-9 network).
__device__ __forceinline__ float median9(float (&p)[9]) {
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[1]); sort2(p[3], p[4]); sort2(p[6], p[7]);
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[3]); sort2(p[5], p[8]); sort2(p[4], p[7]);
  sort2(p[3], p[6]); sort2(p[1], p[4]); sort2(p[2], p[5]);
  sort2(p[4], p[7]); sort2(p[4], p[2]); sort2(p[6], p[4]);
  sort2(p[4], p[2]);
  return p[4];
}

// disp_pre's value and valid flag of pixel (g, x), before hole filling.
// Every load is made whatever the winner, as the plain ops compute every
// term and then select, so that a thread's pixels load side by side.
__device__ __forceinline__ float pixel(const Args& a, int g, int x, bool& valid) {
  const size_t p = (size_t)g * a.W + x;
  const int d = __ldg(a.bestd + p);
  const float df = (float)d;
  float v = df;
  if (a.subpixel) {
    const float c0 = __ldg(a.bestc + p), cm = __ldg(a.cm + p), cp = __ldg(a.cp + p);
    const float denom = __fadd_rn(__fsub_rn(cp, __fmul_rn(2.0f, c0)), cm);
    const float off = __fdiv_rn(__fsub_rn(cp, cm), __fmul_rn(2.0f, denom));
    if (d > 0 && d < a.D - 1 && fabsf(denom) > 1e-6f)
      v = __fsub_rn(df, clamp_keep_nan(off, -0.5f, 0.5f));
  }
  valid = true;
  if (a.lr_check) {
    const long long dli = (long long)rintf(df);
    const long long xr = x - dli;
    const int xc = (int)min(max(xr, 0LL), (long long)a.W - 1);
    const float dr = (float)__ldg(a.rbestd + (size_t)g * a.W + xc);
    valid = dli >= 0 && dli < a.D && xr >= 0 && xr < a.W && fabsf(__fsub_rn(df, dr)) <= a.lr_tol;
  }
  if (a.uniqueness)
    valid = valid &&
            __fmul_rn(__ldg(a.ubest + p), 100.0f) >= __fmul_rn(__ldg(a.bestc + p), a.uscale);
  return v;
}

// Fills the holes of one row of W disparities (ok: the valid flags), one
// warp: min(nearest valid left, nearest valid right), 0 where neither.
__device__ void fill_row(float* d, const unsigned char* ok, int W) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x % WARP;
  const int run = (W + WARP - 1) / WARP;
  const int lo = min(lane * run, W), hi = min(lo + run, W);
  int last = -1, first = W;
  for (int x = lo; x < hi; ++x) {
    if (ok[x]) {
      first = min(first, x);
      last = x;
    }
  }
  for (int o = 1; o < WARP; o <<= 1) {  // inclusive scans across the lanes' runs
    const int l = __shfl_up_sync(FULL, last, o), f = __shfl_down_sync(FULL, first, o);
    if (lane >= o) last = max(last, l);
    if (lane + o < WARP) first = min(first, f);
  }
  int left = __shfl_up_sync(FULL, last, 1), right = __shfl_down_sync(FULL, first, 1);
  if (lane == 0) left = -1;
  if (lane == WARP - 1) right = W;
  for (int x = lo; x < hi; ++x) {  // a hole's slot holds its left neighbour's column
    if (ok[x]) left = x;
    else d[x] = __int_as_float(left);
  }
  for (int x = hi - 1; x >= lo; --x) {
    if (ok[x]) {
      right = x;
    } else {
      const int l = __float_as_int(d[x]);
      const float f = minimum(l >= 0 ? d[l] : inf, right < W ? d[right] : inf);
      d[x] = isinf(f) ? 0.0f : f;
    }
  }
}

__global__ void __launch_bounds__(THREADS) disparity_map_kernel(const Args a) {
  extern __shared__ float sd[];  // rows x W disparities, then rows x W valid flags
  const int W = a.W;
  const int halo = a.median ? 1 : 0;
  const int rows = TY + 2 * halo;
  unsigned char* sv = reinterpret_cast<unsigned char*>(sd + rows * W);
  const int y0 = blockIdx.x * TY;
  const bool gated = a.lr_check || a.uniqueness;

  const int n = rows * W;
  for (int i0 = threadIdx.x; i0 < n; i0 += ILP * THREADS) {
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const int i = i0 + k * THREADS;
      if (i < n) {
        const int r = i / W, x = i - r * W;
        const int g = min(max(y0 - halo + r, 0), a.H - 1);
        bool valid;
        const float v = pixel(a, g, x, valid);
        sd[i] = gated && !a.fill && !valid ? -1.0f : v;
        sv[i] = valid;
      }
    }
  }
  __syncthreads();
  if (gated && a.fill) {
    for (int r = threadIdx.x / WARP; r < rows; r += THREADS / WARP)
      fill_row(sd + r * W, sv + r * W, W);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TY * W; i += THREADS) {
    const int r = i / W, x = i - r * W;
    if (y0 + r >= a.H) break;
    float v;
    if (a.median) {
      const int xs[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
      float p[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) p[3 * dy + dx] = sd[(r + dy) * W + xs[dx]];
      v = median9(p);
    } else {
      v = sd[i];
    }
    a.out[(size_t)(y0 + r) * W + x] = v;
  }
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  Returns the cudaError_t (0 on
// success); a shape outside the launch's geometry (W > MAX_W, an empty
// plane) returns cudaErrorInvalidValue without launching; the planes
// themselves are checked by the wrapper.  (H, W) planes -> out (H, W).
// One launch on `stream`.
extern "C" int disparity_map_launch(const int* bestd, const float* bestc, const float* cm,
                                    const float* cp, const int* rbestd, const float* ubest,
                                    int H, int W, int D, int subpixel, int lr_check,
                                    float lr_tol, int uniqueness, float uscale, int fill,
                                    int median, float* out, void* stream) {
  if (H < 1 || W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  Args a;
  a.bestd = bestd;
  a.bestc = bestc;
  a.cm = cm;
  a.cp = cp;
  a.rbestd = rbestd;
  a.ubest = ubest;
  a.out = out;
  a.H = H;
  a.W = W;
  a.D = D;
  a.subpixel = subpixel != 0;
  a.lr_check = lr_check != 0;
  a.uniqueness = uniqueness != 0;
  a.fill = fill != 0;
  a.median = median != 0;
  a.lr_tol = lr_tol;
  a.uscale = uscale;
  const int rows = TY + (a.median ? 2 : 0);
  const size_t smem = (size_t)rows * W * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        disparity_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (H + TY - 1) / TY;
  disparity_map_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
