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
// Design.  The directions run in phases, one launch each, from the plan
// that sgm_kernel.py::plan computes.  In each group of four directions of
// the pinned order, the first three run side by side and the fourth
// completes S:
//   phase A: l2r writes S = L, r2l and t2b write their L into the scratch
//            volumes X1 and X2;
//   phase B: b2t writes S = ((S + X1) + X2) + L;
//   8 paths, phase C: (1,1) writes S = S + L, (1,-1) and (-1,1) write X1
//            and X2;  phase D: (-1,-1) writes S = ((S + X1) + X2) + L.
// That is the plain version's ((l2r + r2l) + t2b) + b2t, and then
// (((S4 + L(1,1)) + L(1,-1)) + L(-1,1)) + L(-1,-1).  One warp runs one
// scanline: a row, a column, or a diagonal starting at its first in-image
// pixel (row 0 or H - 1, then column 0 or W - 1), H + W - 1 of them.  A
// phase's work table lists its directions longest scanlines first, each
// with its number of lines; warp g of the launch takes line g - first[j] of
// slot j, so one block may mix directions.  The wrapper allocates the two
// scratch volumes; the kernel allocates nothing.
//
// The register path (D <= 128, the largest D of any preset, and a
// multiple of 4).  Lane l holds L(q, d) for its four consecutive
// disparities d = 4 l + k (+inf past D), so d - 1 and d + 1 across lanes
// come by one __shfl_up_sync and one __shfl_down_sync, +inf at d = -1 and
// d = D, and pmin by __reduce_min_sync (redux.sync) over an
// order-preserving integer image of the float bits (the sign bit of a
// non-negative float flipped, every bit of a negative one), exact for
// every non-NaN float; on an H100 80GB HBM3 (700 W) it is 4% / 2% faster
// over 4 / 8 paths than a fminf shuffle tree.  No row goes through shared
// memory.  A step's inputs do not depend on the recurrence: C, and S, X1,
// X2 in a completing phase.  Each lane stages its own 16 bytes of them
// DEPTH = 8 steps ahead with cp.async into a per-warp ring in shared
// memory, one commit group per step, and waits for a step's group just
// before it uses it; no lane reads another's ring entries, so no barrier
// is needed (16 steps were 7% / 3% slower).  A slot is refilled after the
// step that read it has stored its outputs.  Stores of S and of the
// scratch L are whole 16-byte vectors: a warp writes one pixel's 512 bytes
// at D = 128, four full 128-byte lines.  A row has 1242 steps at KITTI and
// only 750 of them run in phase A, so a step's latency bounds that phase:
// the line's end and the lane's share of D are zero-byte copies, selects
// and predicated stores, and the role's volumes a template argument, not
// branches inside the step.
//
// The long-D path (D > 128, D not a multiple of 4, or a plan with VPL 0).
// Disparities lie across
// the lanes in chunks of 32 (d = 32k + lane); the previous step's L row
// lives in a per-warp buffer with a +inf guard at d = -1 and d = D,
// double-buffered (read one, write the other, __syncwarp): in shared memory
// while one warp's two rows fit in 48 KB (D <= 6142), else in a global
// buffer after the scratch volumes (the generic pointer is the same).  Its
// loads are plain and its pmin a fminf shuffle tree; it runs in the same
// phases with the same sums.
//
// What bounds it on an H100: bytes.  The function's least traffic is one
// read of C and one write of S, 2 x 4 H W D bytes (477 MB at 1242 x 375,
// D = 128: 0.142 ms at 3.35 TB/s; ~8 flops per (pixel, d, path) are far
// below the FP32 peak).  A schedule that writes each direction's L to
// device memory once and sums in the pinned order moves 3 P - 1 volumes
// (11 for 4 paths, 23 for 8: 0.78 and 1.64 ms at KITTI), and so does
// this one; the 50 MB L2 cannot hold a volume.  What the phases buy is
// parallelism: 1992 scanlines in phase A at KITTI instead of 375 per row
// pass, 4848 in phase C, and the ring keeps DEPTH steps of loads in flight
// per warp.  Each step's serial chain is two shuffles, four dependent float
// ops and the warp minimum.  On an H100 80GB HBM3 (700 W) every phase then
// streams its volumes at about the rate of a plain torch copy of them
// (utils/plan_sweep.py --kernel sgm prints both), so what is left is the
// 3 P - 1 volumes themselves.
//
// Numerics: float32 adds and mins only; no fast math, no FMA contraction
// (there is no multiply).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_SLOTS = 3;           // directions of one phase
constexpr int MAX_PHASES = 4;
constexpr int WARPS = 4;               // warps (scanlines) per block
constexpr int VPL = 4;                 // disparities a lane holds on the register path
constexpr int REG_MAX_D = 32 * VPL;    // the register path's largest D
constexpr int DEPTH = 8;               // ring depth, steps
constexpr int ROW_SMEM_BUDGET = 48 * 1024;  // long path: a warp's rows in shared memory
constexpr int SMEM_OPTIN = 232448;     // an H100 block's opt-in shared memory
constexpr int PLAN_HEAD = 4;           // sgm_kernel.py::Plan.ints
constexpr int PLAN_PHASE = 3 + 4 * MAX_SLOTS;

// What a direction writes in its phase (sgm_kernel.py's ROLE_*).
enum Role : int { WRITE_S = 0, WRITE_X1 = 1, WRITE_X2 = 2, ADD_S = 3, COMPLETE_S = 4 };

// Volumes one step of a role reads: C, then S, X1, X2.
__host__ __device__ inline int role_volumes(int role) {
  return role == ADD_S ? 2 : (role == COMPLETE_S ? 4 : 1);
}

struct Slot {
  int dy, dx, role, n_lines;
};

struct Phase {
  const float* C;
  float* S;
  float* X1;        // scratch volume 1 (null when the plan has none)
  float* X2;        // scratch volume 2
  float* rows;      // long path: null, or (lines, 2 (D + 2)) floats of L rows
  int H, W, D;
  int n_slots;
  Slot slot[MAX_SLOTS];
  int first[MAX_SLOTS + 1];  // warp index of each slot's first line; the last is the total
  int nvol;         // volumes of a ring slot (register path)
  float p1, p2;
};

// First pixel and length of scanline i of direction (dy, dx).
__device__ inline void line_start(int H, int W, int dy, int dx, int i, int& y, int& x,
                                  int& n) {
  if (dy == 0) {
    y = i;
    x = dx > 0 ? 0 : W - 1;
  } else if (dx == 0) {
    x = i;
    y = dy > 0 ? 0 : H - 1;
  } else if (i < W) {  // from the first row it enters
    y = dy > 0 ? 0 : H - 1;
    x = i;
  } else {  // from the first column it enters, the row's pixel excluded
    const int j = i - W + 1;
    y = dy > 0 ? j : H - 1 - j;
    x = dx > 0 ? 0 : W - 1;
  }
  const int ny = dy > 0 ? H - y : (dy < 0 ? y + 1 : H);
  const int nx = dx > 0 ? W - x : (dx < 0 ? x + 1 : W);
  n = dy == 0 ? nx : (dx == 0 ? ny : min(ny, nx));
}

// Warp g's slot and scanline; false past the phase's last line.
__device__ inline bool take_line(const Phase& q, int g, Slot& s, int& y, int& x, int& n) {
  if (g >= q.first[q.n_slots]) return false;
  int j = 0;
  while (j + 1 < q.n_slots && g >= q.first[j + 1]) ++j;
  s = q.slot[j];
  line_start(q.H, q.W, s.dy, s.dx, g - q.first[j], y, x, n);
  return true;
}

__device__ inline float* output_of(const Phase& q, int role) {
  return role == WRITE_X1 ? q.X1 : (role == WRITE_X2 ? q.X2 : q.S);
}

__device__ __forceinline__ unsigned full_mask() { return 0xffffffffu; }

// The warp's minimum by redux.sync over the order-preserving image.
__device__ __forceinline__ float warp_min_redux(float v) {
  unsigned u = __float_as_uint(v);
  u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
  u = __reduce_min_sync(full_mask(), u);
  u ^= (u >> 31) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(u);
}

// The warp's minimum by a fminf shuffle tree.
__device__ __forceinline__ float warp_min_tree(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(full_mask(), v, o));
  return v;
}

// Copy `bytes` (0 or 16) of 16 from global src to shared dst; 0 reads
// nothing and zero-fills dst.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This lane's VPL floats of one volume of a ring slot.
__device__ __forceinline__ void load_lane(float (&v)[VPL], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// One scanline on the register path.  C, S, X1, X2 and out point at the
// line's first pixel and this lane's first disparity (any valid address
// for a lane past D, `on` false, which copies and stores nothing); `ring`
// at this lane's entry of the warp's first ring slot.  NV volumes a step
// (C, then S, X1, X2).  The line's end and the lane's share of D are data
// (zero-byte copies, selects, predicated stores), the role a template
// argument, so a step is one run of code the compiler can schedule around
// the recurrence.
template <int NV>
__device__ __forceinline__ void run_line(const float* C, const float* S, const float* X1,
                                         const float* X2, float* out, long long step, int n,
                                         bool on, float p1, float p2, float* ring,
                                         int slot_stride, int lane) {
  constexpr int VOL = 32 * VPL;  // floats of one volume in a ring slot
  const float* src[4] = {C, S, X1, X2};
  // Stage step t into slot t % DEPTH and close its commit group (steps past
  // the line's end copy nothing, so that every step has a group).
  auto stage = [&](int t) {
    const long long o = (long long)min(t, n - 1) * step;
    float* dst = ring + (t & (DEPTH - 1)) * slot_stride;
    const bool live = t < n;
#pragma unroll
    for (int v = 0; v < NV; ++v) cp_async16(dst + v * VOL, src[v] + o, live && on ? 16 : 0);
    cp_commit();
  };
  // Step t's outputs from its L and its ring slot: S = L, S + L or
  // ((S + X1) + X2) + L by the role's volumes.
  auto emit = [&](int t, const float (&L)[VPL], const float* in) {
    float o[VPL];
    if constexpr (NV == 1) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) o[k] = L[k];
    } else if constexpr (NV == 2) {
      float sv[VPL];
      load_lane(sv, in + VOL);
#pragma unroll
      for (int k = 0; k < VPL; ++k) o[k] = sv[k] + L[k];
    } else {
      float sv[VPL], x1[VPL], x2[VPL];
      load_lane(sv, in + VOL);
      load_lane(x1, in + 2 * VOL);
      load_lane(x2, in + 3 * VOL);
#pragma unroll
      for (int k = 0; k < VPL; ++k) o[k] = ((sv[k] + x1[k]) + x2[k]) + L[k];
    }
    if (on) *reinterpret_cast<float4*>(out + t * step) = make_float4(o[0], o[1], o[2], o[3]);
  };
  auto lane_min = [&](const float (&L)[VPL]) {
    return warp_min_redux(fminf(fminf(L[0], L[1]), fminf(L[2], L[3])));
  };

  const float inf = INFINITY;
  for (int t = 0; t < DEPTH; ++t) stage(t);
  float L[VPL];
  cp_wait<DEPTH - 1>();  // step 0's group has landed
  {
    float c[VPL];
    load_lane(c, ring);
#pragma unroll
    for (int k = 0; k < VPL; ++k) L[k] = on ? c[k] : inf;
    emit(0, L, ring);
  }
  float pmin = lane_min(L);
  stage(DEPTH);  // the slot step 0 read
#pragma unroll 2
  for (int t = 1; t < n; ++t) {
    cp_wait<DEPTH - 1>();  // step t's group has landed
    const float* in = ring + (t & (DEPTH - 1)) * slot_stride;
    float c[VPL];
    load_lane(c, in);
    float up = __shfl_up_sync(full_mask(), L[VPL - 1], 1);  // L(q, d0 - 1)
    float dn = __shfl_down_sync(full_mask(), L[0], 1);      // L(q, d0 + VPL)
    if (lane == 0) up = inf;
    if (lane == 31) dn = inf;
    const float pen2 = pmin + p2;
    float nl[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const float lo = k == 0 ? up : L[k - 1];
      const float hi = k == VPL - 1 ? dn : L[k + 1];
      const float best = fminf(fminf(L[k], pen2), fminf(lo, hi) + p1);
      nl[k] = on ? (c[k] + best) - pmin : inf;
    }
#pragma unroll
    for (int k = 0; k < VPL; ++k) L[k] = nl[k];
    emit(t, L, in);
    pmin = lane_min(L);
    stage(t + DEPTH);  // the slot this step read, after its outputs are stored
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(32 * WARPS) sgm_reg_kernel(const Phase q) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Slot s;
  int y, x, n;
  // a whole warp returns: no block-wide barrier follows
  if (!take_line(q, blockIdx.x * WARPS + warp, s, y, x, n)) return;
  const int d0 = lane * VPL;
  const bool on = d0 < q.D;  // D is a multiple of VPL: a lane has all VPL or none
  const long long step = ((long long)s.dy * q.W + s.dx) * q.D;
  const long long base = ((long long)y * q.W + x) * q.D + (on ? d0 : 0);
  const int nv = role_volumes(s.role);
  const int slot_stride = q.nvol * 32 * VPL;
  float* ring = smem + (size_t)warp * DEPTH * slot_stride + d0;
  float* out = output_of(q, s.role) + base;
  const float* X1 = q.X1 ? q.X1 + base : nullptr;
  const float* X2 = q.X2 ? q.X2 + base : nullptr;
  if (nv == 1)
    run_line<1>(q.C + base, nullptr, nullptr, nullptr, out, step, n, on, q.p1, q.p2, ring,
                slot_stride, lane);
  else if (nv == 2)
    run_line<2>(q.C + base, q.S + base, nullptr, nullptr, out, step, n, on, q.p1, q.p2, ring,
                slot_stride, lane);
  else
    run_line<4>(q.C + base, q.S + base, X1, X2, out, step, n, on, q.p1, q.p2, ring,
                slot_stride, lane);
}

// L(p, d) from the cost c and the previous step's row (prev[1 + d] holds
// L(q, d); prev[0] and prev[D + 1] are +inf), as the reference computes it.
__device__ __forceinline__ float recur(float c, const float* prev, int d, float pmin,
                                       float p1, float p2) {
  const float best = fminf(fminf(prev[1 + d], pmin + p2), fminf(prev[d], prev[2 + d]) + p1);
  return (c + best) - pmin;
}

__global__ void __launch_bounds__(32 * WARPS) sgm_long_kernel(const Phase q) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  Slot s;
  int y, x, n;
  if (!take_line(q, g, s, y, x, n)) return;  // a whole warp
  const int D = q.D;
  const int stride = 2 * (D + 2);
  float* prev = q.rows ? q.rows + (size_t)g * stride : smem + warp * stride;
  float* cur = prev + D + 2;
  if (lane == 0) prev[0] = prev[D + 1] = cur[0] = cur[D + 1] = INFINITY;
  __syncwarp();  // the guards

  const long long step = ((long long)s.dy * q.W + s.dx) * D;
  const long long off0 = ((long long)y * q.W + x) * D;
  float* out = output_of(q, s.role);
  float pmin = 0.f;
  for (int t = 0; t < n; ++t) {
    const long long off = off0 + t * step;
    float lmin = INFINITY;
    for (int d = lane; d < D; d += 32) {
      const float c = q.C[off + d];
      const float v = t == 0 ? c : recur(c, prev, d, pmin, q.p1, q.p2);
      cur[1 + d] = v;
      const long long i = off + d;
      out[i] = s.role == ADD_S        ? q.S[i] + v
               : s.role == COMPLETE_S ? ((q.S[i] + q.X1[i]) + q.X2[i]) + v
                                      : v;
      lmin = fminf(lmin, v);
    }
    __syncwarp();  // this step's row is written before any lane reads it
    pmin = warp_min_tree(lmin);
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// Scanlines of direction (dy, dx).
int lines_of(int H, int W, int dy, int dx) {
  return dy == 0 ? H : (dx == 0 ? W : H + W - 1);
}

using KernelFn = void (*)(Phase);

}  // namespace

// Plain C entry, called by asw_binding.cpp: S (H, W, D) from C (H, W, D),
// both float32 and contiguous on one card, through the phases of `plan`
// (sgm_kernel.py::Plan.ints: VPL, scratch volumes, L-row floats, phases;
// then per phase its slots, ring volumes and shared memory, and each
// slot's dy, dx, role, lines).  `scratch` holds `scratch_floats` floats:
// the scratch volumes, then the L rows.  The register path needs C, S and
// the scratch 16-byte aligned.  Returns the cudaError_t of the launches (0
// on success); an inconsistent plan is cudaErrorInvalidValue and launches
// nothing.
extern "C" int sgm_aggregate_launch(const float* C, float* S, float* scratch,
                                    long long scratch_floats, int H, int W, int D, float p1,
                                    float p2, const long long* plan, int plan_len,
                                    void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (H < 1 || W < 1 || D < 1 || plan_len < PLAN_HEAD) return bad;
  const int vpl = (int)plan[0];
  const long long n_scratch = plan[1], row_floats = plan[2];
  const int n_phases = (int)plan[3];
  if (n_phases < 1 || n_phases > MAX_PHASES || plan_len != PLAN_HEAD + PLAN_PHASE * n_phases)
    return bad;
  if ((vpl != 0 && vpl != VPL) || (vpl == VPL && (D > REG_MAX_D || D % VPL != 0))) return bad;
  if (vpl && (reinterpret_cast<unsigned long long>(C) | reinterpret_cast<unsigned long long>(S) |
              reinterpret_cast<unsigned long long>(scratch)) % 16 != 0)
    return bad;
  const long long hwd = (long long)H * W * D;
  if (n_scratch < 0 || n_scratch > 2 || row_floats < 0 ||
      scratch_floats < n_scratch * hwd + row_floats || (scratch == nullptr && scratch_floats > 0))
    return bad;
  const long long row2 = 2LL * (D + 2);
  const bool long_rows_global = vpl == 0 && row2 * (long long)sizeof(float) > ROW_SMEM_BUDGET;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  Phase ph[MAX_PHASES];
  int smem[MAX_PHASES];
  KernelFn fn[MAX_PHASES];
  for (int i = 0; i < n_phases; ++i) {  // check every phase before launching any
    const long long* e = plan + PLAN_HEAD + PLAN_PHASE * i;
    Phase& q = ph[i];
    q.C = C;
    q.S = S;
    q.X1 = n_scratch >= 1 ? scratch : nullptr;
    q.X2 = n_scratch >= 2 ? scratch + hwd : nullptr;
    q.rows = long_rows_global ? scratch + n_scratch * hwd : nullptr;
    q.H = H;
    q.W = W;
    q.D = D;
    q.n_slots = (int)e[0];
    q.nvol = (int)e[1];
    smem[i] = (int)e[2];
    q.p1 = p1;
    q.p2 = p2;
    if (q.n_slots < 1 || q.n_slots > MAX_SLOTS || q.nvol < 1 || q.nvol > 4) return bad;
    if (smem[i] < 0 || smem[i] > SMEM_OPTIN) return bad;
    long long lines = 0;
    for (int j = 0; j < q.n_slots; ++j) {
      const long long* f = e + 3 + 4 * j;
      Slot& sl = q.slot[j];
      sl = Slot{(int)f[0], (int)f[1], (int)f[2], (int)f[3]};
      if (sl.dy < -1 || sl.dy > 1 || sl.dx < -1 || sl.dx > 1 || (sl.dy == 0 && sl.dx == 0))
        return bad;
      if (sl.role < WRITE_S || sl.role > COMPLETE_S || sl.n_lines != lines_of(H, W, sl.dy, sl.dx))
        return bad;
      if (role_volumes(sl.role) > q.nvol) return bad;
      if (sl.role != WRITE_S && sl.role != ADD_S && n_scratch < 2) return bad;  // X1, X2
      q.first[j] = (int)lines;
      lines += sl.n_lines;
    }
    if (lines >= (1LL << 30)) return bad;
    q.first[q.n_slots] = (int)lines;
    fn[i] = vpl ? sgm_reg_kernel : sgm_long_kernel;
    if (vpl) {
      if ((long long)smem[i] < (long long)WARPS * DEPTH * q.nvol * 32 * VPL * 4) return bad;
    } else if (long_rows_global) {
      if (row_floats < lines * row2) return bad;
    } else if ((long long)smem[i] < WARPS * row2 * (long long)sizeof(float)) {
      return bad;
    }
  }
  for (int i = 0; i < n_phases; ++i) {
    if (smem[i] > ROW_SMEM_BUDGET) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
      if (err != cudaSuccess) return (int)err;
    }
    const int lines = ph[i].first[ph[i].n_slots];
    fn[i]<<<(lines + WARPS - 1) / WARPS, 32 * WARPS, smem[i], st>>>(ph[i]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
