// Both views' edge-extended channel stacks in one launch.
//
// Replaces no Pallas kernel: the reference builds the stacks with jnp ops
// (aswstereomatch_tpu/ops/pallas/asw_kernel.py::wta_outputs: channel_stack
// of aswstereomatch_tpu/ops/preprocess.py, then jnp.pad in edge mode) and
// leaves their fusion to XLA.  The port's plain version of the same
// function (ops/preprocess.py::channel_stack + pad_edge, over
// utils/colorspace.py) dispatches ~330 small ops a pair, each a launch of
// a few microseconds, two of them pageable host-to-device copies that wait
// for the stream; the card stays idle while the host enqueues them.  This
// kernel computes the same function in one launch a pair.
//
// Inputs (float32, contiguous, one card): left and right (H, W, 3) RGB or
// (H, W) gray, on the 8-bit grid in [0, 255].  Outputs:
//   ls  (7, H, W + 2r)          column j is image column clamp(j - r)
//   rs  (7, H, W + 2r + D - 1)  column j is image column clamp(j - r - D + 1)
// with channels R, G, B, x-gradient, L, a, b (gray input: R = G = B = the
// gray value, and the gradient taken on it as it is).
//
// Bits.  Every value is the plain version's bit for bit on the card: the
// same IEEE float32 operations in the same order, each rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never
// contracts into an FMA):
//   gray   = (0.299 r + 0.587 g) + 0.114 b
//   grad   = gray[min(x + 1, W - 1)] - gray[max(x - 1, 0)]
//   linear = LUT[clamp(rint(v), 0, 255)]   (ties to even; the 256-entry
//            sRGB decode table, float64-computed)
//   X = ((r m00 + g m01) + b m02) * (1 / Xn),  Y = (r m10 + g m11) + b m12,
//   Z = ((r m20 + g m21) + b m22) * (1 / Zn)   (r, g, b linear; the white
//            point's reciprocals rounded to float32)
//   f(t)   = t > (6/29)^3 ? cbrt(t) : t / (3 (6/29)^2) + 4/29, the cube
//            root an exponent-bit seed (bits / 3 + 0x2A514067) and four
//            steps y = (2 y + t / (y y)) / 3 (times the float32 third)
//   L = 116 fy - 16,  a = 500 (fx - fy),  b = 200 (fy - fz).
// The table (the LUT, then the float32 constants in the order of the
// T_* indices below) comes from the wrapper, stacks_kernel.py::table(),
// which takes it from utils/colorspace.py; it is written into constant
// memory once per process and device, never per call.
//
// Design.  The work is ~11 MB read and ~28 MB written a pair at KITTI
// (1242x375, D = 128, r = 16): memory-bound, ~12 us at the H100's
// 3.35 TB/s.  One thread computes the seven channels of one output column
// of one row of one view, at its clamped image column: the pad columns
// recompute their edge pixel (the right view's 143 left pad columns at
// KITTI read one address per warp, a broadcast), so every store of a warp
// is 32 consecutive floats of one channel row.  A work item is one chunk of
// THREADS columns of one row of one view, both views in one range of
// items; blocks walk the items grid-stride, two views' rows filling the
// SMs, and each block stages the LUT into shared memory once (its lookups
// diverge across a warp, which constant memory would serialize).  The
// kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int LUT_N = 256;

// The constant table: LUT_N LUT entries, then these float32 constants.
enum : int {
  T_GRAY_R = LUT_N, T_GRAY_G, T_GRAY_B,
  T_M00, T_M01, T_M02, T_M10, T_M11, T_M12, T_M20, T_M21, T_M22,
  T_INV_WHITE_X, T_INV_WHITE_Z, T_THIRD, T_CUBE, T_LIN_DIV, T_LIN_ADD,
  TABLE_N
};

constexpr int CBRT_MAGIC = 0x2A514067;

__constant__ float c_table[TABLE_N];

struct Args {
  const float* img[2];  // left, right: (H, W, C)
  float* out[2];        // ls, rs: (7, H, wo)
  int wo[2];            // padded widths
  int pad[2];           // left pad columns
  int chunks[2];        // ceil(wo / THREADS)
  int H, W, C;
  long long items0;     // the left view's items: H * chunks[0]
  long long items;      // both views'
};

__device__ __forceinline__ float gray_at(const float* row, int x, int C) {
  if (C == 1) return __ldg(row + x);
  const float* p = row + 3 * x;
  return __fadd_rn(__fadd_rn(__fmul_rn(c_table[T_GRAY_R], __ldg(p)),
                             __fmul_rn(c_table[T_GRAY_G], __ldg(p + 1))),
                   __fmul_rn(c_table[T_GRAY_B], __ldg(p + 2)));
}

__device__ __forceinline__ float decode(const float* lut, float v) {
  const float q = fminf(fmaxf(rintf(v), 0.f), 255.f);
  return lut[(int)q];
}

__device__ __forceinline__ float cbrt_newton(float t) {
  const float third = c_table[T_THIRD];
  float y = __int_as_float(__float_as_int(t) / 3 + CBRT_MAGIC);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y = __fmul_rn(__fadd_rn(__fmul_rn(2.f, y), __fdiv_rn(t, __fmul_rn(y, y))), third);
  return t > 0.f ? y : 0.f;
}

__device__ __forceinline__ float lab_f(float t) {
  const float lin = __fadd_rn(__fdiv_rn(t, c_table[T_LIN_DIV]), c_table[T_LIN_ADD]);
  return t > c_table[T_CUBE] ? cbrt_newton(t) : lin;
}

__device__ __forceinline__ float xyz_row(float r, float g, float b, int m) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, c_table[m]), __fmul_rn(g, c_table[m + 1])),
                   __fmul_rn(b, c_table[m + 2]));
}

__global__ void __launch_bounds__(THREADS) channel_stacks_kernel(const Args a) {
  __shared__ float lut[LUT_N];
  for (int i = threadIdx.x; i < LUT_N; i += THREADS) lut[i] = c_table[i];
  __syncthreads();
  const int W = a.W, C = a.C;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int v = item >= a.items0;
    const long long local = v ? item - a.items0 : item;
    const int chunks = v ? a.chunks[1] : a.chunks[0];
    const int y = (int)(local / chunks);
    const int xo = (int)(local - (long long)y * chunks) * THREADS + threadIdx.x;
    const int wo = v ? a.wo[1] : a.wo[0];
    if (xo >= wo) continue;
    const int x = min(max(xo - (v ? a.pad[1] : a.pad[0]), 0), W - 1);
    const float* row = (v ? a.img[1] : a.img[0]) + (size_t)y * W * C;
    float r, g, b;
    if (C == 1) {
      r = g = b = __ldg(row + x);
    } else {
      r = __ldg(row + 3 * x);
      g = __ldg(row + 3 * x + 1);
      b = __ldg(row + 3 * x + 2);
    }
    const float grad = __fsub_rn(gray_at(row, min(x + 1, W - 1), C),
                                 gray_at(row, max(x - 1, 0), C));
    const float rl = decode(lut, r), gl = decode(lut, g), bl = decode(lut, b);
    const float X = __fmul_rn(xyz_row(rl, gl, bl, T_M00), c_table[T_INV_WHITE_X]);
    const float Y = xyz_row(rl, gl, bl, T_M10);
    const float Z = __fmul_rn(xyz_row(rl, gl, bl, T_M20), c_table[T_INV_WHITE_Z]);
    const float fx = lab_f(X), fy = lab_f(Y), fz = lab_f(Z);
    const size_t plane = (size_t)a.H * wo;
    float* o = (v ? a.out[1] : a.out[0]) + (size_t)y * wo + xo;
    o[0] = r;
    o[plane] = g;
    o[2 * plane] = b;
    o[3 * plane] = grad;
    o[4 * plane] = __fsub_rn(__fmul_rn(116.f, fy), 16.f);
    o[5 * plane] = __fmul_rn(500.f, __fsub_rn(fx, fy));
    o[6 * plane] = __fmul_rn(200.f, __fsub_rn(fy, fz));
  }
}

}  // namespace

// Plain C entries, called by asw_binding.cpp.  Return the cudaError_t (0 on
// success); inputs this kernel cannot take return cudaErrorInvalidValue
// without launching.

// Writes the constant table (TABLE_N floats from host memory) on the
// current device.
extern "C" int channel_stacks_set_table(const float* table, int n) {
  if (table == nullptr || n != TABLE_N) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_table, table, sizeof(float) * TABLE_N);
}

// left / right (H, W, C), C 1 or 3; ls (7, H, W + 2r), rs (7, H, W + 2r +
// D - 1).  One launch on `stream`.
extern "C" int channel_stacks_launch(const float* left, const float* right, int H, int W,
                                     int C, int r, int D, float* ls, float* rs,
                                     void* stream) {
  if (H < 1 || W < 1 || (C != 1 && C != 3) || r < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.img[0] = left;
  a.img[1] = right;
  a.out[0] = ls;
  a.out[1] = rs;
  a.pad[0] = r;
  a.pad[1] = r + D - 1;
  const long long wo0 = (long long)W + 2LL * r, wo1 = wo0 + D - 1;
  if (wo1 >= (1LL << 30) || H >= (1 << 30)) return (int)cudaErrorInvalidValue;
  a.wo[0] = (int)wo0;
  a.wo[1] = (int)wo1;
  a.chunks[0] = (int)((wo0 + THREADS - 1) / THREADS);
  a.chunks[1] = (int)((wo1 + THREADS - 1) / THREADS);
  a.H = H;
  a.W = W;
  a.C = C;
  a.items0 = (long long)H * a.chunks[0];
  a.items = a.items0 + (long long)H * a.chunks[1];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long grid = a.items < (long long)sms * BLOCKS_PER_SM ? a.items
                                                                  : (long long)sms * BLOCKS_PER_SM;
  channel_stacks_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
