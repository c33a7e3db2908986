// Exact symmetric (two-view) ASW aggregation + dual-view WTA, with build
// warps that fill the next stage while FMA warps run the current one.
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
// centre, tap) and read for every d whose centre it is.
//
// Inputs (float32, contiguous, one card): ls (7, H, W + 2r), rs (7, H,
// W + 2r + D - 1) and sw (K, K), as asw_kernel.cu takes them.
//
// Design.  The tile plan (TY, TX, DC, KX) comes from the wrapper
// (asw_sym_dlanes_kernel.py::tile_plan); this entry checks it and refuses a
// plan it cannot run.  One block covers TY output rows x TX columns, walks
// d in chunks of DC (one chunk wherever D <= DC) and, per chunk, the
// TY + 2r stack rows its windows touch in runs of KX window columns: one
// stage per (stack row, run).  Each stage has
//   - its stack rows (the seven planes over the stage's columns), copied by
//     cp.async into one of three input buffers a stage ahead;
//   - its raw-cost row, TX + KX - 1 columns x DC disparities, built once
//     for all TY output rows that read it, unfused (tap_cost<true>), so
//     each raw cost is the plain version's bit for bit;
//   - for each output row t whose window covers the stack row, its left
//     weights, KX x TX, and its right weights for the TX + DC right centres
//     x0 - d0 - DC + c, KX x (TX + DC), computed once and read for every d;
// the raw-cost row and the weights in one of two stage buffers.  The
// block's warps have two roles:
//   - two producer warpgroups (128 threads each; setmaxnreg lowers their
//     register budget) issue the copies and build each stage's weights,
//     TAPS window columns of one centre per thread and pass, so that
//     their sqrtf / expf chains overlap;
//   - the consumer warpgroups (setmaxnreg raises their budget) build each
//     stage's raw-cost row when its weights are in, then each runs an
//     8-column x 4-disparity register tile of one output row over it
//     (accumulate_sym_wide, asw_common.cuh): for dx ascending, t = wl * wr,
//     den += t, num = fma(t, C, num).
// Producers build stage k + 1's weights into the second stage buffer while
// consumers run stage k from the first.  The hand-off is named barriers:
// full and empty for each stage buffer (producers bar.arrive on full[b]
// when stage k's weights are written and its rows have landed, and
// bar.sync on empty[b] before they overwrite it with stage k + 2;
// consumers the other way round), one for the producers alone (their
// copies) and one for the consumers alone (the raw-cost row complete).  No block-wide
// barrier runs inside the stage loop.  At the end of a chunk both roles
// meet at a block barrier, the consumers write the aggregated TY x TX x DC
// tile over the stage buffers, and every thread runs the online WTA of
// the columns (carried across chunks in shared memory where D > DC) and
// folds the right view with one first-occurrence atomicMin per (row, right
// column, chunk).
//
// What bounds it on an H100: issue slots and latency, not bytes (the stacks
// of a KITTI pair, ~28 MB, stay in L2).  At KITTI (1242x375, D=128, r=16)
// the function's least work is 4.046 ms at the FP32 peak (k1_bound in
// chip_smoke.py).  At the plan (2, 48, 128, 33) this design issues
// ~6.5 G warp instructions of taps (3 FP32 instructions per (pixel, d, tap)
// and six 16-byte shared-memory loads per 96), ~1.9 G of weights
// ((TX + TX + DC) / TX = 4.67 per (pixel, tap), ~25 instructions each: IEEE
// sqrtf and expf) and ~1.4 G of raw costs ((TY + 2r) / TY x (TX + KX - 1)
// / TX = 28.3 per (pixel, d), ~26 each): about K1's ~10.3 G.  Registers
// bound the split: a consumer tile needs ~120 registers, so 16 consumer
// warps would leave none to the producers.  Two producer warpgroups at 48
// registers beside up to three consumer warpgroups at 128 (640 threads)
// fill what the launch bound gives the block.  Two stage buffers of K1's KITTI
// plan (TX = 64, 116,736 B each) do not fit beside each other; at TX = 48
// two take 200,192 B.  The phases do not overlap as the split intends:
// beside the consumers the producers' latency-bound sqrtf / expf chains
// slow down, and the whole stays near the sum of the phases (PERF.md
// section 6 has the measured phases and every variant tried): 23.645 ms
// over stacks at KITTI against K1's 23.142 in the same call on an H100
// 80GB HBM3 at 700 W.  ptxas (sm_90a): 96 registers at launch with 264 /
// 400 bytes of spill stores / loads (the producers at 48; none in the FMA
// loop).
//
// Determinism: each output sums its taps in one fixed (dy, then dx) order
// whatever the plan; every column WTA runs d ascending across chunks; the
// right view's atomicMin picks (cost, then lower d) whatever the block
// order.  Any two plans give the same bits, and the arithmetic is K1's
// symmetric mode, term for term.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division, no fast math.
// The weight product is (colorL * sw) * (colorR * sw), then num / den, as
// the plain version.

#include "asw_common.cuh"

namespace {

constexpr int XT = kWideCols;
constexpr int DT = kWideDisps;
constexpr int WG = 128;             // threads of a warpgroup
constexpr int MAX_CONSUMERS = 384;  // consumer threads of a block
constexpr int MAX_DC = 128;
constexpr int NPLANES = 7;  // R, G, B, x-gradient, L, a, b
constexpr int TAPS = 2;     // weights (window columns) of one centre per element

// Named barriers (0 is __syncthreads'): full and empty for stage buffer b,
// the whole block, the producers alone, the consumers alone.
constexpr int BAR_FULL = 1;
constexpr int BAR_EMPTY = 3;
constexpr int BAR_ALL = 5;
constexpr int BAR_PROD = 6;
constexpr int BAR_CONS = 7;

// The roles of a block: PG producer warpgroups beside at most three
// consumer warpgroups, and their register budgets per thread after
// setmaxnreg.  The launch bound gives every thread 65,536 / 640 registers
// rounded down to 8, 96, and 256 x 48 + 384 x 128 = 61,440 fit in what the
// block holds at launch; a plan of fewer consumer warpgroups launches fewer
// threads with the same budgets.  One producer warpgroup beside three
// consumer ones (96 / 136 registers) and three beside two (72 / 128)
// measured slower (PERF.md section 6).
constexpr int PG = 2;
constexpr int MAX_THREADS = PG * WG + MAX_CONSUMERS;
constexpr int PRODUCER_REGS = 48, CONSUMER_REGS = 128;

struct Params {
  int H, W, r, D, K;
  int cost_ad;    // 1: AD cost, 0: TAD + gradient
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
};

// The tile plan: TY output rows x TX columns per block, d-chunks of DC,
// runs of KX window columns.
struct Plan {
  int TY, TX, DC, KX;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Float offsets of the block's shared-memory arrays:
//   stage[2]    at 0 and S: the raw-cost row (TX + KX - 1) x DC, then the
//               left weights TY x KX x TX at wl, then the right weights
//               TY x KX x NC at wr; after the last stage of a chunk, the
//               aggregated tile TY x TX x (DC + 1) over both;
//   in[3]       the stack rows of a stage: the left planes over
//               LW = TX + KX - 1 columns, the right ones over
//               RW = TX + DC + KX - 1 columns;
//   lctr, rctr  the window centres' Lab, 3 x TY x TX and 3 x TY x NC;
//   carry       the columns' WTA state across d-chunks (D > DC only).
struct Layout {
  int S, wl, wr, in0, in, lctr, rctr, carry, total;
  int LW, RW;
};

Layout layout(const Plan& q, bool multi) {
  Layout L;
  const int NC = q.TX + q.DC;
  L.LW = q.TX + q.KX - 1;
  L.RW = NC + q.KX - 1;
  L.wl = L.LW * q.DC;
  L.wr = L.wl + q.TY * q.KX * q.TX;
  L.S = round4(L.wr + q.TY * q.KX * NC);
  const int agg = q.TY * q.TX * (q.DC + 1);
  L.in0 = round4(2 * L.S > agg ? 2 * L.S : agg);
  L.in = round4(NPLANES * (L.LW + L.RW));
  L.lctr = L.in0 + 3 * L.in;
  L.rctr = L.lctr + round4(3 * q.TY * q.TX);
  L.carry = L.rctr + round4(3 * q.TY * NC);
  L.total = L.carry + (multi ? (int)(sizeof(Wta) / 4) * q.TY * q.TX : 0);
  return L;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

template <int N>
__device__ __forceinline__ void regs_inc() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// What both roles share: the geometry of the block and its stages.
struct Block {
  const float* ls;
  const float* rs;
  const float* sw;
  Params p;
  Plan q;
  Layout L;
  float* smem;
  int x0, y0, nrows, NC, nkx, nst, nchunks, nthreads, WL, WR;
  size_t PL, PR;

  __device__ Block(const float* ls_, const float* rs_, const float* sw_, const Params& p_,
                   const Plan& q_, const Layout& L_, float* smem_)
      : ls(ls_), rs(rs_), sw(sw_), p(p_), q(q_), L(L_), smem(smem_) {
    x0 = blockIdx.x * q.TX;
    y0 = blockIdx.y * q.TY;
    nrows = min(q.TY, p.H - y0);
    NC = q.TX + q.DC;
    nkx = (p.K + q.KX - 1) / q.KX;
    nst = (nrows + 2 * p.r) * nkx;
    nchunks = (p.D + q.DC - 1) / q.DC;
    nthreads = blockDim.x;
    WL = p.W + 2 * p.r;
    WR = WL + p.D - 1;
    PL = (size_t)p.H * WL;
    PR = (size_t)p.H * WR;
  }

  __device__ float* stage(int k) const { return smem + (k & 1) * L.S; }
  __device__ float* input(int k) const { return smem + L.in0 + (k % 3) * L.in; }
};

// ---- building a stage -------------------------------------------------

// The stack rows of stage k into its input buffer: the left planes over ls
// columns x0 + dx0 + u (u < TX + kx - 1), the right ones over rs columns
// rb0 + dx0 + v (v < TX + DC + kx - 1), clamped into the stacks (the
// clamped entries feed only costs at d >= D, columns >= W + 2r or zero
// weights).  Asynchronous.
__device__ __forceinline__ void stage_in(const Block& b, int k, int d0, int ptid, int np) {
  const int s = b.y0 - b.p.r + k / b.nkx;
  const int dx0 = (k % b.nkx) * b.q.KX, kx = min(b.q.KX, b.p.K - dx0);
  const int yy = min(max(s, 0), b.p.H - 1);
  const float* lrow = b.ls + (size_t)yy * b.WL;
  const float* rrow = b.rs + (size_t)yy * b.WR;
  const int rb0 = b.x0 - d0 - b.q.DC + b.p.D - 1;
  const int lw = b.q.TX + kx - 1, rw = b.NC + kx - 1;
  float* in = b.input(k);
  for (int c = 0; c < NPLANES; ++c)
    for (int u = ptid; u < lw; u += np)
      cp_async4(in + c * b.L.LW + u, lrow + c * b.PL + min(b.x0 + dx0 + u, b.WL - 1));
  float* rin = in + NPLANES * b.L.LW;
  for (int c = 0; c < NPLANES; ++c)
    for (int v = ptid; v < rw; v += np)
      cp_async4(rin + c * b.L.RW + v,
                rrow + c * b.PR + min(max(rb0 + dx0 + v, 0), b.WR - 1));
}

// The raw-cost row of stage k of the chunk at d0, from its input rows,
// built by the consumers (lane of nlanes): tile column u (ls column
// x0 + dx0 + u) at d = d0 + dl, whose right sample is rs column
// x0 + dx0 + u + D - 1 - d, right input column u + DC - dl.  Unfused
// (tap_cost<true>), the arithmetic of asw_kernel.cu's build.  The loads
// are unconditional (every index is inside the stage's columns), and an
// entry past D or the stacks is then replaced by 0, so that no load waits
// behind a branch.
__device__ __forceinline__ void build_costs(const Block& b, int k, int d0, int lane, int nlanes,
                                            FastDiv byDC) {
  const Params& p = b.p;
  const int DC = b.q.DC;
  const int dx0 = (k % b.nkx) * b.q.KX, kx = min(b.q.KX, p.K - dx0);
  const float* in = b.input(k);
  const float* rin = in + NPLANES * b.L.LW;
  float* st = b.stage(k);
  const int LW = b.L.LW, RW = b.L.RW;
  const int ncost = (b.q.TX + kx - 1) * DC;
  for (int i = lane; i < ncost; i += nlanes) {
    const int u = (unsigned)i / byDC, dl = i - u * DC;
    const int v = u + DC - dl;
    const float c = tap_cost<true>(p, in[u], in[LW + u], in[2 * LW + u], in[3 * LW + u],
                                   rin[v], rin[RW + v], rin[2 * RW + v], rin[3 * RW + v]);
    st[i] = d0 + dl < p.D && b.x0 + dx0 + u < b.WL ? c : 0.f;
  }
}

// The weights of stage k of the chunk at d0, from its input rows, built by
// the producers: those of each output row t whose window row
// dy = s - (y0 + t) + r is in [0, K).  Arithmetic of asw_kernel.cu's build.
__device__ __forceinline__ void build_weights(const Block& b, int k, int d0, int ptid, int np,
                                              FastDiv byTX, FastDiv byNC) {
  const Params& p = b.p;
  const int TX = b.q.TX, DC = b.q.DC, KX = b.q.KX, TY = b.q.TY, NC = b.NC;
  const int D = p.D, K = p.K, r = p.r, W = p.W;
  const int s = b.y0 - r + k / b.nkx;
  const int dx0 = (k % b.nkx) * KX, kx = min(KX, K - dx0);
  const float* in = b.input(k);
  const float* rin = in + NPLANES * b.L.LW;
  float* st = b.stage(k);
  const int LW = b.L.LW, RW = b.L.RW;
  const int t_lo = max(0, s - r - b.y0);
  const int nt = min(b.nrows - 1, s + r - b.y0) - t_lo + 1;
  const float* lctr = b.smem + b.L.lctr;
  const float* rctr = b.smem + b.L.rctr;
  // The weights, TAPS window columns dxl = TAPS * dq + j per element: one
  // centre, its Lab loaded once, and TAPS independent chains of loads,
  // sqrtf and expf.  Taps past the run are computed from the run's last
  // column and not stored.
  const int nq = (kx + TAPS - 1) / TAPS;
  const FastDiv bynq = fast_div(nq);
  // Left weight of column x0 + x and tap dx: the tap is ls column
  // x0 + x + dx, left input column x + dxl.
  const float* lab = in + 4 * LW;
  const int nl = nt * nq * TX;
  for (int i = ptid; i < nl; i += np) {
    const int row = (unsigned)i / byTX, x = i - row * TX;
    const int t_ = (unsigned)row / bynq, dq = row - t_ * nq, t = t_lo + t_;
    const int c = t * TX + x;
    const float c0 = lctr[c], c1 = lctr[TY * TX + c], c2 = lctr[2 * TY * TX + c];
    const float* spatial = b.sw + (s - b.y0 - t + r) * K + dx0;
    float w[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int dxl = min(TAPS * dq + j, kx - 1);
      w[j] = bilateral(p, lab[x + dxl], lab[LW + x + dxl], lab[2 * LW + x + dxl], c0, c1, c2,
                       spatial[dxl]);
    }
    const bool ok = b.x0 + x < W;
    float* out = st + b.L.wl + (t * KX + TAPS * dq) * TX + x;
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
      if (TAPS * dq + j < kx) out[j * TX] = ok ? w[j] : 0.f;
  }
  // Right weight of centre xr = x0 - d0 - DC + c and tap dx: the tap is rs
  // column xr + dx + D - 1, right input column c + dxl; 0 for the centres
  // no (x, d) of the tile has.
  const float* rlab = rin + 4 * RW;
  const int nr = nt * nq * NC;
  for (int i = ptid; i < nr; i += np) {
    const int row = (unsigned)i / byNC, c = i - row * NC;
    const int t_ = (unsigned)row / bynq, dq = row - t_ * nq, t = t_lo + t_;
    const int e = t * NC + c;
    const float c0 = rctr[e], c1 = rctr[TY * NC + e], c2 = rctr[2 * TY * NC + e];
    const float* spatial = b.sw + (s - b.y0 - t + r) * K + dx0;
    float w[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int dxl = min(TAPS * dq + j, kx - 1);
      w[j] = bilateral(p, rlab[c + dxl], rlab[RW + c + dxl], rlab[2 * RW + c + dxl], c0, c1,
                       c2, spatial[dxl]);
    }
    const int xr = b.x0 - d0 - DC + c;
    const bool ok = xr > -D && xr < W;
    float* out = st + b.L.wr + (t * KX + TAPS * dq) * NC + c;
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
      if (TAPS * dq + j < kx) out[j * NC] = ok ? w[j] : 0.f;
  }
}

// The window centres' Lab for the chunk at d0: left, row y0 + t, ls column
// x0 + x + r; right, rs column xr + r + D - 1 of centre
// xr = x0 - d0 - DC + c.
__device__ __forceinline__ void load_centres(const Block& b, int d0, int ptid, int np,
                                             FastDiv byTX, FastDiv byNC) {
  const int TY = b.q.TY, TX = b.q.TX, NC = b.NC, H = b.p.H, r = b.p.r;
  float* lctr = b.smem + b.L.lctr;
  float* rctr = b.smem + b.L.rctr;
  for (int i = ptid; i < TY * TX; i += np) {
    const int t = (unsigned)i / byTX, x = i - t * TX;
    const float* a = b.ls + 4 * b.PL + (size_t)min(b.y0 + t, H - 1) * b.WL +
                     min(b.x0 + x + r, b.WL - 1);
    for (int c = 0; c < 3; ++c) lctr[c * TY * TX + i] = a[c * b.PL];
  }
  for (int i = ptid; i < TY * NC; i += np) {
    const int t = (unsigned)i / byNC, c = i - t * NC;
    const float* a = b.rs + 4 * b.PR + (size_t)min(b.y0 + t, H - 1) * b.WR +
                     min(max(b.x0 - d0 - b.q.DC + c + r + b.p.D - 1, 0), b.WR - 1);
    for (int e = 0; e < 3; ++e) rctr[e * TY * NC + i] = a[e * b.PR];
  }
}

// The end of chunk ch, every thread: the columns' WTA and the right view's
// fold over the aggregated tile, which lies at the start of shared memory
// (wta_chunk_rows, asw_common.cuh).
__device__ __forceinline__ void end_chunk(const Block& b, int ch, int* bestd, float* bestc,
                                          float* cm, float* cp, float* ubest,
                                          unsigned long long* rpack, FastDiv byTX) {
  const int d0 = ch * b.q.DC;
  wta_chunk_rows(b.smem, b.q.DC + 1, reinterpret_cast<Wta*>(b.smem + b.L.carry), ch == 0,
                 ch == b.nchunks - 1, b.q.TX, byTX, b.nrows, b.x0, b.y0, b.p.W, d0,
                 min(d0 + b.q.DC, b.p.D), bestd, bestc, cm, cp, ubest, rpack, threadIdx.x,
                 b.nthreads);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
asw_sym_dlanes_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                          const float* __restrict__ sw, Params p, Plan q, Layout L,
                          int* __restrict__ bestd_out, float* __restrict__ bestc_out,
                          float* __restrict__ cm_out, float* __restrict__ cp_out,
                          float* __restrict__ ubest_out,
                          unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  const Block b(ls, rs, sw, p, q, L, reinterpret_cast<float*>(smem4));
  const int NP = PG * WG;          // producer threads: warpgroups 0 .. PG - 1
  const int NT = b.nthreads;       // all threads
  const int DC = q.DC, TX = q.TX;
  const FastDiv byTX = fast_div(TX);
  const int tid = threadIdx.x;

  if (tid < NP) {
    // ==== producers: stage inputs, build stages ====
    regs_dec<PRODUCER_REGS>();
    const FastDiv byNC = fast_div(b.NC);
    for (int ch = 0; ch < b.nchunks; ++ch) {
      const int d0 = ch * DC;
      load_centres(b, d0, tid, NP, byTX, byNC);
      stage_in(b, 0, d0, tid, NP);
      for (int k = 0; k < b.nst; ++k) {
        // The consumers have left stage k - 2: its stage buffer and its
        // input rows are free.
        if (k >= 2) bar_sync(BAR_EMPTY + (k & 1), NT);
        // Stage k's rows have landed: start stage k + 1's copies (into
        // stage k - 2's input buffer), build stage k's weights.
        cp_async_wait_all();
        bar_sync(BAR_PROD, NP);
        if (k + 1 < b.nst) stage_in(b, k + 1, d0, tid, NP);
        build_weights(b, k, d0, tid, NP, byTX, byNC);
        bar_arrive(BAR_FULL + (k & 1), NT);
      }
      bar_sync(BAR_ALL, NT);  // every stage consumed
      bar_sync(BAR_ALL, NT);  // the aggregated tile written
      end_chunk(b, ch, bestd_out, bestc_out, cm_out, cp_out, ubest_out, rpack, byTX);
      if (ch + 1 < b.nchunks) bar_sync(BAR_ALL, NT);  // the next build overwrites agg
    }
  } else {
    // ==== consumers: register tiles over the stages ====
    regs_inc<CONSUMER_REGS>();
    const int ctid = tid - NP;
    const int NCT = NT - NP;          // consumer threads
    const FastDiv byDC = fast_div(DC);
    const int DG = DC / DT;           // disparity groups of a row
    const int NTR = (TX / XT) * DG;   // consumer threads per output row
    const int ty = ctid / NTR;        // the thread's output row y0 + ty (>= TY: idle)
    const int xb = (ctid % NTR) / DG * XT;
    const int db = (ctid % NTR) % DG * DT;
    const bool active = ty < b.nrows;
    const int AS = DC + 1;
    for (int ch = 0; ch < b.nchunks; ++ch) {
      const int d0 = ch * DC;
      float num[XT][DT], den[XT][DT];
#pragma unroll
      for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) num[i][j] = den[i][j] = 0.f;
      for (int k = 0; k < b.nst; ++k) {
        // Stage k's weights and input rows are in: build its raw-cost row.
        bar_sync(BAR_FULL + (k & 1), NT);
        build_costs(b, k, d0, ctid, NCT, byDC);
        bar_sync(BAR_CONS, NCT);
        const int s = b.y0 - p.r + k / b.nkx;
        const int dx0 = (k % b.nkx) * q.KX, kx = min(q.KX, p.K - dx0);
        const int dy = s - (b.y0 + ty) + p.r;
        if (active && dy >= 0 && dy < p.K) {
          const float* st = b.stage(k);
          accumulate_sym_wide(num, den, st, st + L.wl + ty * q.KX * TX,
                              st + L.wr + ty * q.KX * b.NC, xb, db, kx, DC, b.NC, TX);
        }
        if (k + 2 < b.nst) bar_arrive(BAR_EMPTY + (k & 1), NT);
      }
      bar_sync(BAR_ALL, NT);  // producers done: the stage buffers are free
      if (active) {
        float* agg = b.smem;
#pragma unroll
        for (int i = 0; i < XT; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            const int dl = db + j;
            if (d0 + dl < p.D) agg[(ty * TX + xb + i) * AS + dl] = num[i][j] / den[i][j];
          }
      }
      bar_sync(BAR_ALL, NT);
      end_chunk(b, ch, bestd_out, bestc_out, cm_out, cp_out, ubest_out, rpack, byTX);
      if (ch + 1 < b.nchunks) bar_sync(BAR_ALL, NT);
    }
  }
}

cudaError_t launch(const float* ls, const float* rs, const float* sw, const Params& p,
                   const Plan& q, const Layout& L, int consumers, cudaStream_t s,
                   int* bestd, float* bestc, float* cm, float* cp, float* ubest,
                   unsigned long long* rpack) {
  const auto kernel = asw_sym_dlanes_wta_kernel;
  // setmaxnreg waits for the registers the producers give up: refuse a
  // build whose registers at launch could not cover both budgets, rather
  // than launch a block that would never get them.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int threads = PG * WG + consumers;
  if ((long)attr.numRegs * threads <
      (long)consumers * CONSUMER_REGS + (long)PG * WG * PRODUCER_REGS)
    return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (size_t)L.total;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + q.TX - 1) / q.TX, (p.H + q.TY - 1) / q.TY);
  kernel<<<grid, threads, smem, s>>>(ls, rs, sw, p, q, L, bestd, bestc, cm, cp, ubest, rpack);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  The plan (ty, tx, dc, kx) and its shared-memory bytes
// come from asw_sym_dlanes_kernel.py::tile_plan; a plan this kernel
// cannot run returns cudaErrorInvalidValue without launching.  Requires
// 2 <= D <= 128 and K <= 63.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int asw_sym_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r, int D,
    int cost_ad, float alpha, float one_minus_alpha, float tau_color, float tau_grad,
    float inv_gamma_color, int ty, int tx, int dc, int kx, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream) {
  const int K = 2 * r + 1;
  if (D < 2 || D > 128 || K > 63) return (int)cudaErrorInvalidValue;
  const Plan q{ty, tx, dc, kx};
  if (ty < 1 || tx < XT || tx % XT || dc < 8 || dc % 8 || dc > MAX_DC || kx < 1 ||
      kx > K)
    return (int)cudaErrorInvalidValue;
  // Consumer threads: one per register tile, in whole warpgroups.
  const long tiles = (long)ty * (tx / XT) * (dc / DT);
  if (tiles > MAX_CONSUMERS) return (int)cudaErrorInvalidValue;
  const int consumers = (int)((tiles + WG - 1) / WG * WG);
  const Layout L = layout(q, D > dc);
  const size_t smem = sizeof(float) * (size_t)L.total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != (size_t)smem_bytes || smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const Params p{H, W, r, D, K, cost_ad, alpha, one_minus_alpha, tau_color, tau_grad,
                 inv_gamma_color};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch(ls, rs, sw, p, q, L, consumers, s, bestd, bestc, cm, cp, ubest, rpack);
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
