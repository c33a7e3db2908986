// The raw (H, W', D) matching-cost volume in one launch.
//
// Replaces no Pallas kernel: the reference builds the volume with jnp ops
// (aswstereomatch_tpu/ops/cost.py::cost_volume, one plane per disparity)
// and leaves their fusion to XLA.  The port's plain version of the same
// function (ops/cost.py::cost_plane, once per disparity, then a
// torch.stack along the last axis) dispatches ~10 ops per disparity, ~1,300
// a pair at D = 128, and writes the volume twice, once as planes and once
// through the stack's strided copy; the card idles while the host enqueues
// them.  This kernel writes the same volume once, in one launch.
//
// Inputs (float32, contiguous, one card), the edge-padded planes of
// ops/cost.py::precompute over W' = W + 2 x_extend output columns:
//   lc (H, W', C)          left colour, C = 3 (RGB) or 1 (gray)
//   rc (H, W' + D - 1, C)  right colour, D - 1 more columns on the left
//   gl (H, W')             left x-gradient
//   gr (H, W' + D - 1)     right x-gradient
// Output: out (H, W', D), contiguous, the layout torch.stack(..., dim=-1)
// gives, with out[y, x, d] the cost of lc[y, x] against rc[y, x + D-1-d].
//
// Bits.  Every value is the plain version's on the card: the same IEEE
// float32 operations in the same order, each rounded on its own
// (__fsub_rn / __fadd_rn / __fmul_rn, which nvcc never contracts):
//   a_c = |l_c - r_c|
//   AD  = ((a_0 + a_2) + a_1) * inv_c  (C = 3; AD = a_0 for C = 1)
// which is torch.mean(dim=-1) on the card: its reduction splits the three
// values over two lanes (lane 0 sums a_0 and a_2, lane 1 holds a_1, a
// shuffle adds them) and multiplies by the float32 factor num_outputs /
// num_inputs, which the wrapper computes as PyTorch does;
//   cost_ad: AD;  otherwise
//   alpha min(AD, tau_color) + (1 - alpha) min(|gl - gr|, tau_grad)
// with alpha, 1 - alpha and the two taus rounded to float32 once
// (Python's scalars on a float32 tensor), and a NaN kept by each min as
// torch.clamp keeps it.
//
// Design.  The function reads ~30 MB and writes the volume, 238,464,000
// bytes at KITTI (1242x375, D = 128): bound by the write, ~0.071 ms at the
// H100's 3.35 TB/s.  One block takes one row and a tile of TX output
// columns, whose TX * D outputs are one contiguous run of the volume.  It
// stages the tile's left samples and the TX + D - 1 right samples they
// meet, four channels each (R, G, B, gradient), in shared memory once.
// Its threads then walk the run in groups of VEC consecutive disparities
// of one column (VEC = 4 where D is a multiple of 4, else 1), so a warp
// stores 32 VEC contiguous floats at once: at D = 128 one pixel's 512
// bytes, 16 bytes a thread.  The group's VEC right samples are
// consecutive columns, and the right tile lies in VEC sub-planes by column
// mod VEC, so for each of the group's k the warp's 32 reads of a channel
// are 32 consecutive words of one sub-plane, free of bank conflicts; the
// left sample of a column is one word the lanes share.  The ragged last
// column tile and the ragged end of a row's run are masked.  The kernel
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 64;        // output columns per block
constexpr int MAX_D = 2048;   // keeps a block's shared memory under 48 KB
constexpr int CH = 4;         // staged channels: R, G, B, gradient

struct Args {
  const float* lc;  // (H, Wo, C)
  const float* rc;  // (H, Wr, C)
  const float* gl;  // (H, Wo)
  const float* gr;  // (H, Wr)
  float* out;       // (H, Wo, D)
  int H, Wo, Wr, C, D, tiles, rpitch;
  int cost_ad;
  float inv_c, alpha, one_minus_alpha, tau_color, tau_grad;
};

// min(v, t) as torch.clamp(v, max=t) computes it: a NaN v stays NaN.
__device__ __forceinline__ float clamp_max(float v, float t) { return v > t ? t : v; }

__device__ __forceinline__ float cost_of(const Args& a, float l0, float l1, float l2,
                                         float lg, float r0, float r1, float r2, float rg) {
  float ad = fabsf(__fsub_rn(l0, r0));
  if (a.C == 3)
    ad = __fmul_rn(__fadd_rn(__fadd_rn(ad, fabsf(__fsub_rn(l2, r2))), fabsf(__fsub_rn(l1, r1))),
                   a.inv_c);
  if (a.cost_ad) return ad;
  const float tc = clamp_max(ad, a.tau_color);
  const float tg = clamp_max(fabsf(__fsub_rn(lg, rg)), a.tau_grad);
  return __fadd_rn(__fmul_rn(a.alpha, tc), __fmul_rn(a.one_minus_alpha, tg));
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// Shared memory: the left tile, channel-major (CH x TX), then the right
// tile, CH channels of VEC sub-planes of rpitch words; right column j of
// the tile lies in sub-plane j % VEC at j / VEC.
template <int VEC>
__global__ void __launch_bounds__(THREADS) cost_volume_kernel(const Args a) {
  extern __shared__ float sm[];
  float* sl = sm;
  float* sr = sm + CH * TX;
  const int C = a.C, D = a.D;
  const int y = blockIdx.x / a.tiles;
  const int x0 = (blockIdx.x - y * a.tiles) * TX;
  const int nx = min(TX, a.Wo - x0);  // output columns of this tile
  const int nr = nx + D - 1;          // right columns they meet
  const int cplane = VEC * a.rpitch;  // one channel of the right tile

  const float* lrow = a.lc + ((size_t)y * a.Wo + x0) * C;
  const float* rrow = a.rc + ((size_t)y * a.Wr + x0) * C;
  for (int i = threadIdx.x; i < nx * C; i += THREADS) {
    const int j = C == 3 ? i / 3 : i;
    sl[(i - C * j) * TX + j] = __ldg(lrow + i);
  }
  for (int i = threadIdx.x; i < nr * C; i += THREADS) {
    const int j = C == 3 ? i / 3 : i;
    sr[(i - C * j) * cplane + (j % VEC) * a.rpitch + j / VEC] = __ldg(rrow + i);
  }
  const float* glrow = a.gl + (size_t)y * a.Wo + x0;
  const float* grrow = a.gr + (size_t)y * a.Wr + x0;
  for (int j = threadIdx.x; j < nx; j += THREADS) sl[3 * TX + j] = __ldg(glrow + j);
  for (int j = threadIdx.x; j < nr; j += THREADS)
    sr[3 * cplane + (j % VEC) * a.rpitch + j / VEC] = __ldg(grrow + j);
  __syncthreads();

  // Group q of the run is column q / G, disparities VEC (q % G) + k.
  const int G = D / VEC;
  const int step_x = THREADS / G, step_g = THREADS - step_x * G;
  int x = threadIdx.x / G, g = threadIdx.x - x * G;
  float* orow = a.out + ((size_t)y * a.Wo + x0) * D;
  while (x < nx) {
    const float l0 = sl[x], l1 = sl[TX + x], l2 = sl[2 * TX + x], lg = sl[3 * TX + x];
    float v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int j = x + D - 1 - (VEC * g + k);  // the right tile's column
      const float* r = sr + (j % VEC) * a.rpitch + j / VEC;
      v[k] = cost_of(a, l0, l1, l2, lg, r[0], r[cplane], r[2 * cplane], r[3 * cplane]);
    }
    store<VEC>(orow + (size_t)x * D + VEC * g, v);
    x += step_x;
    g += step_g;
    if (g >= G) {
      g -= G;
      ++x;
    }
  }
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  Returns the cudaError_t (0 on
// success); inputs this kernel cannot take return cudaErrorInvalidValue
// without launching.  lc (H, Wo, C), rc (H, Wo + D - 1, C), gl (H, Wo),
// gr (H, Wo + D - 1) -> out (H, Wo, D).  One launch on `stream`.
extern "C" int cost_volume_launch(const float* lc, const float* rc, const float* gl,
                                  const float* gr, int H, int Wo, int C, int D, int cost_ad,
                                  float inv_c, float alpha, float one_minus_alpha,
                                  float tau_color, float tau_grad, float* out, void* stream) {
  if (H < 1 || Wo < 1 || (C != 1 && C != 3) || D < 1 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 ? 4 : 1;
  if (vec == 4 && reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.lc = lc;
  a.rc = rc;
  a.gl = gl;
  a.gr = gr;
  a.out = out;
  a.H = H;
  a.Wo = Wo;
  a.Wr = Wo + D - 1;
  a.C = C;
  a.D = D;
  a.tiles = (Wo + TX - 1) / TX;
  a.rpitch = (TX + D - 1 + vec - 1) / vec;
  a.cost_ad = cost_ad;
  a.inv_c = inv_c;
  a.alpha = alpha;
  a.one_minus_alpha = one_minus_alpha;
  a.tau_color = tau_color;
  a.tau_grad = tau_grad;
  const long long blocks = (long long)H * a.tiles;
  if (blocks >= (1LL << 31) || (long long)Wo + D >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)CH * (TX + (size_t)vec * a.rpitch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    cost_volume_kernel<4><<<(unsigned)blocks, THREADS, smem, st>>>(a);
  else
    cost_volume_kernel<1><<<(unsigned)blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
