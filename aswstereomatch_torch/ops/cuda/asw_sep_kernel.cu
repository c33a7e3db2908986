// Separable two-pass ASW aggregation + online dual-view WTA.
//
// Replaces the TPU kernel aswstereomatch_tpu/ops/pallas/asw_sep_dlanes.py
// (_compute, launched by wta_outputs).  It computes what that kernel
// computes, not its Mosaic layout (no padded cost volume, no lane rolls,
// no banded-MXU left-only pass):
//
//   numv[y,u,d] = sum_dy wvL(y,u;dy) wvR(y,u-d;dy) C[clamp(y+dy-r), u, d]
//   denv[y,u,d] = sum_dy wvL(y,u;dy) wvR(y,u-d;dy)
//   num [y,x,d] = sum_dx whL(y,x;dx) whR(y,x-d;dx) numv[y, x+dx-r, d]
//   den [y,x,d] = sum_dx whL(y,x;dx) whR(y,x-d;dx) denv[y, x+dx-r, d]
//
// and the output is num / den, reduced by online WTA over d.  The right
// factors are dropped in left-only mode (sym == 0), where denv and den do
// not depend on d.  Each 1-D weight is the color factor times the axial
// factor, and symmetric mode multiplies left by right: (colorL * aw) *
// (colorR * aw), the plain version's product order (the Pallas kernel
// multiplies colorL * aw^2 by colorR instead).
//
// Inputs (float32, contiguous, one card):
//   ls  (7, H, W + 2r)          left stack: R, G, B, x-gradient, L, a, b
//   rs  (7, H, W + 2r + D - 1)  right stack, r + D - 1 extra columns left
//   aw  (K,)                    axial spatial factor exp(-|o| / gamma_p)
// Column j of ls is image column j - r; column j of rs is j - r - D + 1.
//
// Design.  The tile plan (TY, TX, DC, KX) comes from the wrapper
// (asw_sep_kernel.py::tile_plan), which sizes it to the geometry, the
// 232,448 bytes of shared memory and the 512 threads a block may have; the
// C entry recomputes the layout and refuses a plan that does not match or
// fit.  One block covers TY output rows x TX columns and walks d in chunks
// of DC.  In the vertical pass each thread owns a 4-column x 8-disparity
// register tile of one output row over the LW = TX + 2r extended columns
// (the disparities in two runs of 4, d and d + DC/2); in the horizontal
// pass two 4-column x 4-disparity tiles over the TX output columns.  Per
// chunk:
//   1. Vertical pass: the block walks the virtual stack rows y0 - r ...
//      y0 + nrows - 1 + r that its windows touch, each clamped for reading,
//      so every output row sums dy = 0 ... K - 1 in order.  Per stage:
//        - start the cp.async copies of the next stage's stack rows into
//          the second of two small buffers (read by the previous stage's
//          build, which a barrier closed);
//        - build, from the stage's stack rows already in shared memory, the
//          raw-cost row, LW columns x DC, once for all TY rows (a one-row
//          block rebuilt it K times), unfused (tap_cost<true>) and, in the
//          bf16 mode, rounded to bfloat16 right after, 8 disparities of a
//          column per thread; and for each output row t whose window covers
//          the stack row its vertical weights: left over LW columns, right
//          over the LW + DC - 1 right columns u - d of the chunk (bilateral,
//          from the stage's Lab and the centres' Lab, which the block loads
//          once); barrier;
//        - each covered row's threads run their register tile: w = wl * wr,
//          numv = fma(w, C, numv), denv += w (left-only: numv = fma(wl, C,
//          numv), and denv += wl once per column);
//        - wait for the copies; barrier.
//   2. The register tiles' numv / denv go to shared memory (TY x LW x DC).
//   3. Horizontal pass, in runs of KX taps: build the run's horizontal
//      weights of every row (left over TX columns, right over the TX + DC - 1
//      right columns x - d) from the centres' Lab (left-only: the left
//      ones of all K taps, once per block); barrier; each tile runs num =
//      fma(w, numv, num), den = fma(w, denv, den), dx ascending, holding
//      four columns of sums in registers so that each tap loads one new
//      column (accumulate_h); barrier.
//   4. num / den of the chunk into an aggregated tile over the vertical
//      sums; the thread that owns an output column carries its online WTA
//      state (in shared memory) across chunks, d ascending; the right view
//      is folded once per (row, right column, chunk) with the
//      first-occurrence atomicMin.
// No weight plane exists in device memory: every weight is computed in the
// block that uses it.  The full-D aggregated tile of K1 and K3 (TY x TX x
// D) does not fit beside the vertical sums, which are as large as the
// block's register tiles, so the WTA runs per chunk with its state carried,
// as K1's multi-chunk instantiation does.
//
// What bounds it on an H100: issue slots and shared-memory wavefronts, in
// phases that barriers keep apart.  The function's least work at KITTI
// (1242x375, D=128, r=16, symmetric) is ~0.29 ms at the FP32 peak
// (k2_bound in chip_smoke.py): each raw cost and 1-D weight once, 3-5 flops
// per tap.  This design, at the plan (4, 96, 32, 11): 9 x 1.33 = 12
// raw-cost builds per (pixel, d) (one row per block: 44); per (pixel, tap) and
// chunk, (LW + LW + DC - 1) / TX = 3 vertical and (2 TX + DC - 1) / TX =
// 2.3 horizontal weights; 3 FP32 operations per tap with, in the vertical
// pass, 13 16-byte shared-memory loads per 96 of them.  About 1.5 G warp
// instructions, ~1.7 ms at four per clock per SM; the kernel takes ~5.9
// ms.  Removing one phase at a time (PERF.md section 6): the build (raw
// costs and vertical weights) ~2.2 ms, the vertical FMAs ~1.1 ms, the
// horizontal FMAs ~1.2 ms, the horizontal weights ~0.6 ms, and the stage
// loop's copies and barriers alone take ~1.5 ms.
//
// Determinism: every numv sums dy ascending and every num dx ascending,
// in the same arithmetic whatever the plan (the vertical sums of a column
// are computed the same way in every block that covers it), every column
// WTA runs d ascending, and the right view's atomicMin picks (cost, then
// lower d) whatever the block order: any two plans give the same bits.
//
// Numerics: float32 throughout, IEEE expf / sqrtf / division (no fast
// math).  volume_dtype="bfloat16" (bf16 != 0) rounds each raw cost to
// bfloat16 (round to nearest even) and back before it is weighted;
// accumulation stays float32.

#include <cuda_bf16.h>

#include "asw_common.cuh"

namespace {

constexpr int XT = kTileCols;   // 4 columns per thread
constexpr int DT = kTileDisps;  // 8 disparities per thread
constexpr int MAX_THREADS = 512;
constexpr int NPLANES = 7;      // R, G, B, x-gradient, L, a, b
constexpr int WTA_WORDS = sizeof(Wta) / sizeof(float);
// Horizontal tiles (4 columns x 4 disparities) per thread: a block has
// TY * (LW / 4) * (DC / 8) threads and TY * (TX / 4) * (DC / 4) tiles, and
// LW = TX + 2r >= TX.
constexpr int HT = 2;

struct SepParams {
  int H, W, r, D, K;
  int sym;      // 1: symmetric two-view weights, 0: left-only
  int cost_ad;  // 1: AD cost, 0: TAD + gradient
  int bf16;     // 1: round each raw cost to bfloat16
  float alpha, one_minus_alpha, tau_color, tau_grad;
  float inv_gamma_color;  // (float)(1 / gamma_color)
};

// The tile plan: TY output rows x TX columns per block, d-chunks of DC,
// horizontal weights in runs of KX taps.
struct Plan {
  int TY, TX, DC, KX;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Float offsets of the block's shared-memory arrays:
//   [0, vsum)  the vertical pass's stage arrays (raw-cost row LWP x DCS,
//              left weights TY x LWP, right weights TY x NCV, two buffers
//              of stack rows: seven left planes over LWP columns, the right
//              ones over NCV); symmetric: then, per chunk, over them, a
//              run's horizontal weights (left TY x KX x TX, right
//              TY x KX x NCH); left-only: after them, the left horizontal
//              weights of all K = KX taps, TY x K x TX, built once;
//   vsum       numv (TY x LWP x DCS) and denv (symmetric: TY x LWP x DCS;
//              left-only: TY x LWP); then, over numv, the chunk's
//              aggregated tile TY x TX x (DC + 1);
//   lctr       the Lab of the block's rows over its LWP columns, 3 x TY x LWP;
//   rctr       symmetric: the right Lab of its rows over the chunk's NCV
//              right columns, 3 x TY x NCV;
//   wta        the WTA state of each output column, TY x TX Wta.
// LWP is LW rounded up to 4 (whole register tiles), NCV = LWP + DC and
// NCH = TX + DC: index c of a right-weight row is right column u - d + DC
// relative to the tile, as accumulate_sym (asw_common.cuh) indexes it.
// The [column][d] arrays (raw-cost row, vertical sums) have a row stride of
// DCS = DC + 4 floats: a quarter-warp's 16-byte loads cover two columns 4
// apart, which an unpadded stride of 32 floats puts on the same banks.
struct Layout {
  int LWP, NCV, NCH, DCS;
  int wl, wr, in0, in1, hwl, hwr, vsum, vden, lctr, rctr, wta, total;
};

Layout layout(const Plan& q, int r, bool sym) {
  Layout L;
  L.LWP = round4(q.TX + 2 * r);
  L.NCV = L.LWP + q.DC;
  L.NCH = q.TX + q.DC;
  L.DCS = q.DC + 4;
  L.wl = L.LWP * L.DCS;
  L.wr = L.wl + q.TY * L.LWP;
  L.in0 = L.wr + (sym ? q.TY * L.NCV : 0);
  const int in = round4(NPLANES * L.LWP + (sym ? NPLANES : 4) * L.NCV);
  L.in1 = L.in0 + in;
  const int stage = L.in1 + in;
  // Symmetric: a run's horizontal weights over the stage arrays; left-only:
  // the left ones of all K taps, built once per block, after them.
  L.hwl = sym ? 0 : round4(stage);
  L.hwr = sym ? q.TY * q.KX * q.TX : 0;
  const int a = sym ? L.hwr + q.TY * q.KX * L.NCH : L.hwl + q.TY * q.KX * q.TX;
  L.vsum = round4(stage > a ? stage : a);
  L.vden = L.vsum + q.TY * L.LWP * L.DCS;
  L.lctr = L.vden + (sym ? q.TY * L.LWP * L.DCS : q.TY * L.LWP);
  L.rctr = L.lctr + round4(3 * q.TY * L.LWP);
  L.wta = L.rctr + (sym ? 3 * q.TY * L.NCV : 0);
  L.total = L.wta + round4(WTA_WORDS * q.TY * q.TX);
  return L;
}

// One run of horizontal taps dx0 .. dx0 + kx - 1 for a 4-column x
// 4-disparity tile of one row: num[i][j] = fma(w, numv, num) and (symmetric)
// den[i][j] = fma(w, denv, den), w = wl * wr, for dx ascending, for columns
// xb + i and chunk offsets db + j.  vnum / vden hold the row's vertical sums
// at [column * DCS + d] (left-only: vden[column], den in den[i][0]); wl the
// run's left weights [dxl * TX + x], wr its right ones [dxl * NCH + c] at
// c = x - d + DC.  win[(dx + i) % 4] holds sum column xb + dx + i, so each
// tap loads one new column.
template <bool SYM>
__device__ __forceinline__ void accumulate_h(float (&num)[XT][4], float (&den)[XT][4],
                                             const float* vnum, const float* vden,
                                             const float* wl, const float* wr, int xb,
                                             int db, int dx0, int kx, int DCS, int DC,
                                             int TX, int NCH) {
  const float* nb = vnum + (xb + dx0) * DCS + db;
  const float* dbase = SYM ? vden + (xb + dx0) * DCS + db : vden + xb + dx0;
  float nw[XT][4], dw[XT][4];
#pragma unroll
  for (int i = 0; i < XT - 1; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(nb + i * DCS);
    nw[i][0] = a.x; nw[i][1] = a.y; nw[i][2] = a.z; nw[i][3] = a.w;
    if (SYM) {
      const float4 b = *reinterpret_cast<const float4*>(dbase + i * DCS);
      dw[i][0] = b.x; dw[i][1] = b.y; dw[i][2] = b.z; dw[i][3] = b.w;
    } else {
      dw[i][0] = dbase[i];
    }
  }
  const int cb = xb - db - 4 + DC;  // (x, d) takes wr[cb + 4 + i - j]
  for (int d0 = 0; d0 < kx; d0 += XT) {
#pragma unroll
    for (int u = 0; u < XT; ++u) {
      const int dxl = d0 + u;
      if (dxl < kx) {
        const int nu = (u + XT - 1) % XT;
        const float4 a = *reinterpret_cast<const float4*>(nb + (dxl + XT - 1) * DCS);
        nw[nu][0] = a.x; nw[nu][1] = a.y; nw[nu][2] = a.z; nw[nu][3] = a.w;
        if (SYM) {
          const float4 b = *reinterpret_cast<const float4*>(dbase + (dxl + XT - 1) * DCS);
          dw[nu][0] = b.x; dw[nu][1] = b.y; dw[nu][2] = b.z; dw[nu][3] = b.w;
        } else {
          dw[nu][0] = dbase[dxl + XT - 1];
        }
        const float4 l4 = *reinterpret_cast<const float4*>(wl + dxl * TX + xb);
        const float lv[XT] = {l4.x, l4.y, l4.z, l4.w};
        float rv[8];
        if (SYM) {
          const float4 r0 = *reinterpret_cast<const float4*>(wr + dxl * NCH + cb);
          const float4 r1 = *reinterpret_cast<const float4*>(wr + dxl * NCH + cb + 4);
          rv[0] = r0.x; rv[1] = r0.y; rv[2] = r0.z; rv[3] = r0.w;
          rv[4] = r1.x; rv[5] = r1.y; rv[6] = r1.z; rv[7] = r1.w;
        }
#pragma unroll
        for (int i = 0; i < XT; ++i) {
          const int s = (u + i) % XT;
          if (SYM) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float w = lv[i] * rv[4 + i - j];
              num[i][j] = fmaf(w, nw[s][j], num[i][j]);
              den[i][j] = fmaf(w, dw[s][j], den[i][j]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) num[i][j] = fmaf(lv[i], nw[s][j], num[i][j]);
            den[i][0] = fmaf(lv[i], dw[s][0], den[i][0]);
          }
        }
      }
    }
  }
}

template <bool SYM>
__global__ void __launch_bounds__(MAX_THREADS, 1)
asw_sep_wta_kernel(const float* __restrict__ ls, const float* __restrict__ rs,
                   const float* __restrict__ aw, SepParams p, Plan q, Layout L,
                   int* __restrict__ bestd_out, float* __restrict__ bestc_out,
                   float* __restrict__ cm_out, float* __restrict__ cp_out,
                   float* __restrict__ ubest_out,
                   unsigned long long* __restrict__ rpack) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.H, W = p.W, r = p.r, D = p.D, K = p.K;
  const int TY = q.TY, TX = q.TX, DC = q.DC, KX = q.KX;
  const int LWP = L.LWP, NCV = L.NCV, NCH = L.NCH, DCS = L.DCS;
  const int dh = DC / 2;
  const int DG = DC / 8;                 // disparity groups of a row
  const int NTV = (LWP / XT) * DG;       // threads per row, vertical pass
  const int DG4 = DC / 4;               // disparity groups, horizontal pass
  const int NTH = (TX / XT) * DG4;       // tiles per row, horizontal pass
  const int nthreads = TY * NTV;
  const int AS = DC + 1;                 // row stride of the aggregated tile
  const FastDiv byDG = fast_div(DG), byTX = fast_div(TX), byLWP = fast_div(LWP),
                byNCV = fast_div(NCV), byNCH = fast_div(NCH);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int nrows = min(TY, H - y0);     // output rows inside the image
  const int WL = W + 2 * r, WR = WL + D - 1;
  const size_t PL = (size_t)H * WL, PR = (size_t)H * WR;  // plane strides
  const int s_lo = y0 - r;               // first virtual stack row
  const int nst = nrows + 2 * r;         // stages: one per virtual stack row
  const int nchunks = (D + DC - 1) / DC;
  const int xend = min(x0 + TX, W);

  // The thread's vertical tile: row tv, extended columns ub + i, chunk
  // offsets db + j (j < 4) and dh + db + j - 4.
  const int tv = tid / NTV;
  const int ub = (tid - tv * NTV) / DG * XT;
  const int dbv = (tid - tv * NTV) % DG * 4;
  // Its HT horizontal tiles tid + h * nthreads (those < TY * NTH): row
  // t = tile / NTH, columns xb + i, disparities db + j (j < 4).
  int htile[HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) htile[h] = tid + h * nthreads;

  float* cost = smem;              // [LWP][DCS]
  float* wl = smem + L.wl;         // [TY][LWP]
  float* wr = smem + L.wr;         // [TY][NCV]
  float* hwl = smem + L.hwl;       // [TY][KX][TX]
  float* hwr = smem + L.hwr;       // [TY][KX][NCH]
  float* vnum = smem + L.vsum;     // [TY][LWP][DCS]
  float* vden = smem + L.vden;     // [TY][LWP][DCS], left-only [TY][LWP]
  float* lctr = smem + L.lctr;     // [3][TY][LWP]
  float* rctr = smem + L.rctr;     // [3][TY][NCV]
  Wta* state = reinterpret_cast<Wta*>(smem + L.wta);  // [TY * TX]

  // The Lab of row y0 + t at ls column x0 + u (clamped into the stacks):
  // the vertical weights' centres and both horizontal factors' taps.
  for (int i = tid; i < TY * LWP; i += nthreads) {
    const int t = (unsigned)i / byLWP, u = i - t * LWP;
    const float* a = ls + 4 * PL + (size_t)min(y0 + t, H - 1) * WL + min(x0 + u, WL - 1);
    for (int c = 0; c < 3; ++c) lctr[c * TY * LWP + i] = a[c * PL];
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    const int d0 = ch * DC;
    const int dend = min(d0 + DC, D);
    // rs column of right index c = 0: right index c is the right column of
    // (tile column u, d = d0 + dl) with c = u - dl + DC.
    const int rb = x0 + D - 1 - d0 - DC;

    if (SYM) {
      for (int i = tid; i < TY * NCV; i += nthreads) {
        const int t = (unsigned)i / byNCV, c = i - t * NCV;
        const float* a = rs + 4 * PR + (size_t)min(y0 + t, H - 1) * WR +
                         min(max(rb + c, 0), WR - 1);
        for (int e = 0; e < 3; ++e) rctr[e * TY * NCV + i] = a[e * PR];
      }
    }

    // The stack rows of stage k into `in`: the left planes over ls columns
    // x0 + u, the right ones over rs columns rb + v, clamped into the stacks
    // (the clamped entries feed only costs at d >= D, columns past the
    // image or weights no output reads).  Asynchronous.
    auto stage_in = [&](int k, float* in) {
      const int yy = min(max(s_lo + k, 0), H - 1);
      const float* lrow = ls + (size_t)yy * WL;
      const float* rrow = rs + (size_t)yy * WR;
      for (int i = tid; i < NPLANES * LWP; i += nthreads) {
        const int c = (unsigned)i / byLWP, u = i - c * LWP;
        cp_async4(in + i, lrow + c * PL + min(x0 + u, WL - 1));
      }
      float* rin = in + NPLANES * LWP;
      for (int i = tid; i < (SYM ? NPLANES : 4) * NCV; i += nthreads) {
        const int c = (unsigned)i / byNCV, v = i - c * NCV;
        cp_async4(rin + i, rrow + c * PR + min(max(rb + v, 0), WR - 1));
      }
    };

    // Build stage k: the raw-cost row, and the vertical weights of each
    // output row t whose window row dy = k - t is in [0, K).
    auto build = [&](int k, const float* in) {
      const float* rin = in + NPLANES * LWP;
      // Eight consecutive d of one column per item: the left sample is read
      // once, the right ones at v = u - dl + DC descending.
      for (int i = tid; i < LWP * DG; i += nthreads) {
        const int u = (unsigned)i / byDG, dl0 = (i - u * DG) * 8;
        const float l0 = in[u], l1 = in[LWP + u], l2 = in[2 * LWP + u], lg = in[3 * LWP + u];
        float c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int v = u - dl0 - j + DC;
          c[j] = 0.f;
          if (d0 + dl0 + j < D) {
            c[j] = tap_cost<true>(p, l0, l1, l2, lg, rin[v], rin[NCV + v],
                                  rin[2 * NCV + v], rin[3 * NCV + v]);
            if (p.bf16) c[j] = __bfloat162float(__float2bfloat16_rn(c[j]));
          }
        }
        float4* dst = reinterpret_cast<float4*>(cost + u * DCS + dl0);
        dst[0] = make_float4(c[0], c[1], c[2], c[3]);
        dst[1] = make_float4(c[4], c[5], c[6], c[7]);
      }
      const int t_lo = max(0, k - K + 1), nt = min(nrows - 1, k) - t_lo + 1;
      const float* lab = in + 4 * LWP;
#pragma unroll 4
      for (int i = tid; i < nt * LWP; i += nthreads) {
        const int t_ = (unsigned)i / byLWP, u = i - t_ * LWP, t = t_lo + t_;
        const int e = t * LWP + u;
        wl[e] = bilateral(p, lab[u], lab[LWP + u], lab[2 * LWP + u], lctr[e],
                          lctr[TY * LWP + e], lctr[2 * TY * LWP + e], aw[k - t]);
      }
      if (SYM) {
        const float* rlab = rin + 4 * NCV;
#pragma unroll 4
        for (int i = tid; i < nt * NCV; i += nthreads) {
          const int t_ = (unsigned)i / byNCV, c = i - t_ * NCV, t = t_lo + t_;
          const int e = t * NCV + c;
          wr[e] = bilateral(p, rlab[c], rlab[NCV + c], rlab[2 * NCV + c], rctr[e],
                            rctr[TY * NCV + e], rctr[2 * TY * NCV + e], aw[k - t]);
        }
      }
    };

    // ---- 1. vertical pass ------------------------------------------------
    float num[XT][DT], den[XT][DT];
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
      for (int j = 0; j < DT; ++j) num[i][j] = den[i][j] = 0.f;

    stage_in(0, smem + L.in0);
    cp_async_wait_all();
    __syncthreads();
    for (int k = 0; k < nst; ++k) {
      // The other buffer was last read by stage k - 1's build, which the
      // barrier after it closed: its copies for stage k + 1 land while this
      // stage builds and runs its FMAs.
      if (k + 1 < nst) stage_in(k + 1, smem + ((k & 1) ? L.in0 : L.in1));
      build(k, smem + ((k & 1) ? L.in1 : L.in0));
      __syncthreads();
      const int dy = k - tv;
      if (tv < nrows && dy >= 0 && dy < K) {
        const float4 l4 = *reinterpret_cast<const float4*>(wl + tv * LWP + ub);
        const float lv[XT] = {l4.x, l4.y, l4.z, l4.w};
        float rv[2][8];
        if (SYM) load_right(rv, wr + tv * NCV + ub - dbv - 4 + DC, dh);
#pragma unroll
        for (int i = 0; i < XT; ++i) {
          float cv[DT];
          load8(cv, cost + (ub + i) * DCS, dbv, dh);
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            if (SYM) {
              const float w = lv[i] * rv[j / 4][4 + i - j % 4];
              num[i][j] = fmaf(w, cv[j], num[i][j]);
              den[i][j] += w;
            } else {
              num[i][j] = fmaf(lv[i], cv[j], num[i][j]);
            }
          }
          if (!SYM) den[i][0] += lv[i];
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // ---- 2. the vertical sums to shared memory ---------------------------
    if (tv < nrows) {
#pragma unroll
      for (int i = 0; i < XT; ++i) {
        const int e = (tv * LWP + ub + i) * DCS;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int dl = dbv + (j < 4 ? j : dh + j - 4);
          vnum[e + dl] = num[i][j];
          if (SYM) vden[e + dl] = den[i][j];
        }
        if (!SYM && dbv == 0) vden[tv * LWP + ub + i] = den[i][0];
      }
    }

    // ---- 3. horizontal pass, in runs of KX taps --------------------------
    float hn[HT][XT][4], hd[HT][XT][4];
#pragma unroll
    for (int h = 0; h < HT; ++h)
#pragma unroll
      for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hn[h][i][j] = hd[h][i][j] = 0.f;
    for (int dx0 = 0; dx0 < K; dx0 += KX) {
      const int kx = min(KX, K - dx0);
      // Left-only: the left weights do not change with the chunk.
      if (SYM || ch == 0) {
      // Left factor of column x and tap dx: tap lctr column x + dx, centre
      // x + r.  Right factor of right index c (column x - d at c = x - dl +
      // DC): tap rctr index c + dx, centre c + r.
#pragma unroll 4
      for (int i = tid; i < nrows * kx * TX; i += nthreads) {
        const int row = (unsigned)i / byTX, x = i - row * TX;
        const int t = row / kx, dxl = row - t * kx, dx = dx0 + dxl;
        const float* a = lctr + t * LWP;
        hwl[(t * KX + dxl) * TX + x] =
            bilateral(p, a[x + dx], a[TY * LWP + x + dx], a[2 * TY * LWP + x + dx],
                      a[x + r], a[TY * LWP + x + r], a[2 * TY * LWP + x + r], aw[dx]);
      }
      if (SYM) {
#pragma unroll 4
        for (int i = tid; i < nrows * kx * NCH; i += nthreads) {
          const int row = (unsigned)i / byNCH, c = i - row * NCH;
          const int t = row / kx, dxl = row - t * kx, dx = dx0 + dxl;
          const float* a = rctr + t * NCV;
          hwr[(t * KX + dxl) * NCH + c] =
              bilateral(p, a[c + dx], a[TY * NCV + c + dx], a[2 * TY * NCV + c + dx],
                        a[c + r], a[TY * NCV + c + r], a[2 * TY * NCV + c + r], aw[dx]);
        }
      }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const int th = htile[h] / NTH, q = htile[h] - th * NTH;
        if (htile[h] < TY * NTH && th < nrows)
          accumulate_h<SYM>(hn[h], hd[h], vnum + th * LWP * DCS,
                            SYM ? vden + th * LWP * DCS : vden + th * LWP,
                            hwl + th * KX * TX, hwr + th * KX * NCH, q / DG4 * XT,
                            q % DG4 * 4, dx0, kx, DCS, DC, TX, NCH);
      }
      __syncthreads();
    }

    // ---- 4. the chunk's aggregated tile and WTA --------------------------
    float* agg = vnum;  // [TY * TX][AS], over the vertical sums
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      const int th = htile[h] / NTH, q = htile[h] - th * NTH;
      const int xb = q / DG4 * XT, db = q % DG4 * 4;
      if (htile[h] < TY * NTH && th < nrows) {
#pragma unroll
        for (int i = 0; i < XT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d0 + db + j < D)
              agg[(th * TX + xb + i) * AS + db + j] =
                  hn[h][i][j] / (SYM ? hd[h][i][j] : hd[h][i][0]);
      }
    }
    __syncthreads();

    // Left view: the online WTA of each column over this chunk's d.
    for (int c = tid; c < TY * TX; c += nthreads) {
      const int t = (unsigned)c / byTX, x = x0 + c - t * TX;
      if (t >= nrows || x >= W) continue;
      Wta w = ch == 0 ? Wta() : state[c];
      for (int d = d0; d < dend; ++d) w.update(agg[c * AS + d - d0], d);
      if (ch == nchunks - 1) {
        const size_t o = (size_t)(y0 + t) * W + x;
        bestd_out[o] = w.bestd;
        bestc_out[o] = w.bestc;
        cm_out[o] = w.cm;
        cp_out[o] = w.cp;
        ubest_out[o] = w.ubest();
      } else {
        state[c] = w;
      }
    }
    // Right view: per right column x' and output row, the first-occurrence
    // minimum of the candidates C_L(x' + d, d) with d in this chunk and
    // x' + d in this tile, folded in with one atomicMin.
    const int NR = TX + DC - 1;
    const FastDiv byNR = fast_div(NR);
    for (int k = tid; k < nrows * NR; k += nthreads) {
      const int t = (unsigned)k / byNR, xr = x0 - (dend - 1) + k - t * NR;
      if (xr < 0) continue;
      const int hi = min(dend - 1, xend - 1 - xr);
      float bc = INFINITY;
      int bd = -1;
      for (int d = max(d0, x0 - xr); d <= hi; ++d) {
        const float a = agg[(t * TX + xr + d - x0) * AS + d - d0];
        if (a < bc) {
          bc = a;
          bd = d;
        }
      }
      if (bd >= 0) fold_right(rpack + (size_t)(y0 + t) * W + xr, bc, bd);
    }
    __syncthreads();  // the next chunk's vertical sums overwrite agg
  }
}

template <bool SYM>
cudaError_t launch(const float* ls, const float* rs, const float* aw,
                   const SepParams& p, const Plan& q, const Layout& L, int threads,
                   cudaStream_t s, int* bestd, float* bestc, float* cm, float* cp,
                   float* ubest, unsigned long long* rpack) {
  const size_t smem = sizeof(float) * (size_t)L.total;
  cudaError_t err = cudaFuncSetAttribute(
      asw_sep_wta_kernel<SYM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + q.TX - 1) / q.TX, (p.H + q.TY - 1) / q.TY);
  asw_sep_wta_kernel<SYM><<<grid, threads, smem, s>>>(ls, rs, aw, p, q, L, bestd, bestc,
                                                      cm, cp, ubest, rpack);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, called by asw_binding.cpp.  `rpack` must hold all-ones
// words on entry.  Requires 2 <= D <= 128 and r <= 32.  The plan (ty, tx,
// dc, kx) and its shared-memory bytes come from
// asw_sep_kernel.py::tile_plan; a plan this kernel cannot run returns
// cudaErrorInvalidValue without launching.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int asw_sep_wta_launch(
    const float* ls, const float* rs, const float* aw, int H, int W, int r,
    int D, int sym, int cost_ad, int bf16, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, int ty, int tx,
    int dc, int kx, int smem_bytes, int* bestd, float* bestc, float* cm,
    float* cp, float* ubest, unsigned long long* rpack, int* rbestd,
    void* stream) {
  const int K = 2 * r + 1;
  if (D < 2 || D > 128 || r < 0 || r > 32) return (int)cudaErrorInvalidValue;
  const Plan q{ty, tx, dc, kx};
  if (ty < 1 || tx < 8 || tx % 8 || dc < 8 || dc % 8 || kx < 1 || kx > K ||
      (!sym && kx != K))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(q, r, sym != 0);
  const long threads = (long)ty * (L.LWP / XT) * (dc / 8);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)L.total;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem != (size_t)smem_bytes || smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const SepParams p{H, W, r, D, K, sym != 0, cost_ad, bf16, alpha, one_minus_alpha,
                    tau_color, tau_grad, inv_gamma_color};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = sym ? launch<true>(ls, rs, aw, p, q, L, (int)threads, s, bestd, bestc, cm, cp,
                           ubest, rpack)
            : launch<false>(ls, rs, aw, p, q, L, (int)threads, s, bestd, bestc, cm, cp,
                            ubest, rpack);
  if (err != cudaSuccess) return (int)err;
  const int n = H * W;
  unpack_right_kernel<<<(n + 255) / 256, 256, 0, s>>>(rpack, rbestd, n);
  return (int)cudaGetLastError();
}
