// PyTorch binding of the port's CUDA kernels as the operators
// torch.ops.asw_torch.asw_wta (fused exact ASW, asw_kernel.cu),
// asw_sep_wta (separable ASW, asw_sep_kernel.cu), asw_dlanes_wta (left-only
// ASW or box, asw_dlanes_kernel.cu), asw_sym_dlanes_wta (symmetric ASW,
// asw_sym_dlanes_kernel.cu), sgm_aggregate (semi-global aggregation,
// sgm_kernel.cu), channel_stacks (both views' channel stacks,
// stacks_kernel.cu), cost_volume (the raw cost volume, cost_kernel.cu),
// disparity_map (the map from the WTA planes, disparity_kernel.cu) and
// wta_planes (the WTA planes of an aggregated volume, wta_kernel.cu).
// Each checks its inputs (disparity_map leaves that to its wrapper),
// allocates the outputs and launches on the current CUDA stream (sgm_aggregate writes into the scratch its wrapper
// allocated); a launch error raises.  They have only a CUDA implementation:
// CPU tensors take the plain PyTorch versions in the ops/cuda/*.py wrappers
// before they get here.
// channel_stacks_table writes stacks_kernel.cu's constant table (a CPU
// tensor) on one device, once per process: its wrapper calls it.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/full.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <optional>
#include <tuple>
#include <utility>
#include <vector>

extern "C" int asw_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int mode, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int n_valid, int d_lo, int d_hi, int ty, int tx, int dc, int kx, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, float* rbestc, float* strip_c,
    int* strip_d, void* stream);
extern "C" int asw_sep_wta_launch(
    const float* ls, const float* rs, const float* aw, int H, int W, int r,
    int D, int sym, int cost_ad, int bf16, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, int ty, int tx,
    int dc, int kx, int smem_bytes, int* bestd, float* bestc, float* cm,
    float* cp, float* ubest, unsigned long long* rpack, int* rbestd,
    void* stream);
extern "C" int asw_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int box, int cost_ad, float alpha, float one_minus_alpha,
    float tau_color, float tau_grad, float inv_gamma_color, float inv_n,
    int ty, int tx, int dp, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream);
extern "C" int asw_sym_dlanes_wta_launch(
    const float* ls, const float* rs, const float* sw, int H, int W, int r,
    int D, int cost_ad, float alpha, float one_minus_alpha, float tau_color,
    float tau_grad, float inv_gamma_color, int ty, int tx, int dc, int kx, int smem_bytes,
    int* bestd, float* bestc, float* cm, float* cp, float* ubest,
    unsigned long long* rpack, int* rbestd, void* stream);
extern "C" int sgm_aggregate_launch(const float* C, float* S, float* scratch,
                                    long long scratch_floats, int H, int W, int D, float p1,
                                    float p2, const long long* plan, int plan_len,
                                    void* stream);
extern "C" int channel_stacks_set_table(const float* table, int n);
extern "C" int channel_stacks_launch(const float* left, const float* right, int H, int W,
                                     int C, int r, int D, float* ls, float* rs,
                                     void* stream);
extern "C" int cost_volume_launch(const float* lc, const float* rc, const float* gl,
                                  const float* gr, int H, int Wo, int C, int D, int cost_ad,
                                  float inv_c, float alpha, float one_minus_alpha,
                                  float tau_color, float tau_grad, float* out, void* stream);
extern "C" int disparity_map_launch(const int* bestd, const float* bestc, const float* cm,
                                    const float* cp, const int* rbestd, const float* ubest,
                                    int H, int W, int D, int subpixel, int lr_check,
                                    float lr_tol, int uniqueness, float uscale, int fill,
                                    int median, float* out, void* stream);
extern "C" int wta_planes_launch(const float* S, int H, int W, int D, int* bestd, float* bestc,
                                 float* cm, float* cp, int* rbestd, float* ubest, void* stream);
extern "C" const char* asw_error_string(int err);

namespace {

using Planes =
    std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor>;

void check_input(const at::Tensor& t, const char* name, int64_t dims) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.dim() == dims, name, " must have ", dims, " dimensions");
}

// Checks the stacks ls (7, H, W + 2r) and rs (7, H, W + 2r + D - 1) and the
// constant table (table_dims dimensions of K each); returns (H, W).
std::pair<int64_t, int64_t> check_stacks(const at::Tensor& ls, const at::Tensor& rs,
                                         const at::Tensor& table,
                                         int64_t table_dims, int64_t r, int64_t D) {
  check_input(ls, "ls", 3);
  check_input(rs, "rs", 3);
  check_input(table, "the constant table", table_dims);
  TORCH_CHECK(r >= 0 && D >= 1, "need r >= 0 and D >= 1");
  const int64_t H = ls.size(1);
  const int64_t W = ls.size(2) - 2 * r;
  const int64_t K = 2 * r + 1;
  TORCH_CHECK(ls.size(0) == 7 && rs.size(0) == 7, "stacks need 7 channels");
  TORCH_CHECK(H >= 1 && W >= 1, "empty image");
  TORCH_CHECK(rs.size(1) == H && rs.size(2) == W + 2 * r + D - 1,
              "rs must be (7, H, W + 2r + D - 1)");
  for (int64_t i = 0; i < table_dims; ++i)
    TORCH_CHECK(table.size(i) == K, "the constant table must be K along each axis");
  TORCH_CHECK(rs.device() == ls.device() && table.device() == ls.device(),
              "inputs must share one device");
  return {H, W};
}

// The six (H, W) output planes, and the right view's packed words (H,
// rpack_cols; W unless given), filled with all-ones: larger than every
// packed (cost, d) candidate.
struct Outputs {
  at::Tensor bestd, bestc, cm, cp, ubest, rbestd, rpack;

  Outputs(const at::Tensor& like, int64_t H, int64_t W, int64_t rpack_cols = -1) {
    const auto f32 = like.options();
    const auto i32 = like.options().dtype(at::kInt);
    bestd = at::empty({H, W}, i32);
    bestc = at::empty({H, W}, f32);
    cm = at::empty({H, W}, f32);
    cp = at::empty({H, W}, f32);
    ubest = at::empty({H, W}, f32);
    rbestd = at::empty({H, W}, i32);
    rpack = at::full({H, rpack_cols < 0 ? W : rpack_cols}, -1,
                     like.options().dtype(at::kLong));
  }

  unsigned long long* rpack_ptr() {
    return reinterpret_cast<unsigned long long*>(rpack.data_ptr<int64_t>());
  }

  Planes planes() const { return {bestd, bestc, cm, cp, ubest, rbestd}; }
};

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.get_device()).stream();
}

// K1 also takes the shard inputs n_valid and the window [d_lo, d_hi), and
// returns three more tensors: with want_strip, rbestc (H, W) and the strip
// r_strip_c / r_strip_d (H, D - 1) of the right columns x' in [-(D-1), -1];
// without it, three empty tensors.
std::vector<at::Tensor> asw_wta(const at::Tensor& ls, const at::Tensor& rs,
                                const at::Tensor& sw, int64_t r, int64_t D, int64_t mode,
                                int64_t cost_ad, double alpha, double one_minus_alpha,
                                double tau_color, double tau_grad, double inv_gamma_color,
                                int64_t n_valid, int64_t d_lo, int64_t d_hi,
                                bool want_strip, at::IntArrayRef plan) {
  const auto [H, W] = check_stacks(ls, rs, sw, 2, r, D);
  TORCH_CHECK(mode >= 0 && mode <= 2, "mode must be 0, 1 or 2");
  TORCH_CHECK(plan.size() == 5, "plan must be (ty, tx, dc, kx, smem_bytes)");
  TORCH_CHECK(H * (W + D - 1) < (int64_t)1 << 31, "image too large");
  TORCH_CHECK(n_valid >= 0 && n_valid <= W, "need 0 <= n_valid_cols <= W");
  TORCH_CHECK(d_lo >= 0 && d_lo < d_hi && d_hi <= D, "need 0 <= lo < hi <= D");
  const int64_t K = 2 * r + 1;
  c10::cuda::CUDAGuard guard(ls.device());
  Outputs o(ls, H, W, W + D - 1);
  const auto f32 = ls.options();
  at::Tensor rbestc = at::empty({want_strip ? H : 0, want_strip ? W : 0}, f32);
  at::Tensor strip_c = at::empty({want_strip ? H : 0, want_strip ? D - 1 : 0}, f32);
  at::Tensor strip_d = at::empty({want_strip ? H : 0, want_strip ? D - 1 : 0},
                                 f32.dtype(at::kInt));
  const int err = asw_wta_launch(
      ls.data_ptr<float>(), rs.data_ptr<float>(), sw.data_ptr<float>(),
      (int)H, (int)W, (int)r, (int)D, (int)mode, (int)cost_ad, (float)alpha,
      (float)one_minus_alpha, (float)tau_color, (float)tau_grad,
      (float)inv_gamma_color, (float)(1.0 / (double)(K * K)), (int)n_valid, (int)d_lo,
      (int)d_hi, (int)plan[0], (int)plan[1], (int)plan[2], (int)plan[3], (int)plan[4],
      o.bestd.data_ptr<int>(), o.bestc.data_ptr<float>(), o.cm.data_ptr<float>(),
      o.cp.data_ptr<float>(), o.ubest.data_ptr<float>(), o.rpack_ptr(),
      o.rbestd.data_ptr<int>(), want_strip ? rbestc.data_ptr<float>() : nullptr,
      want_strip ? strip_c.data_ptr<float>() : nullptr,
      want_strip ? strip_d.data_ptr<int>() : nullptr, stream_of(ls));
  TORCH_CHECK(err == 0, "asw_wta launch failed (tile plan ", plan, "): ",
              asw_error_string(err));
  return {o.bestd, o.bestc, o.cm, o.cp, o.ubest, o.rbestd, rbestc, strip_c, strip_d};
}

Planes asw_sep_wta(const at::Tensor& ls, const at::Tensor& rs, const at::Tensor& aw,
                   int64_t r, int64_t D, int64_t sym, int64_t cost_ad, int64_t bf16,
                   double alpha, double one_minus_alpha, double tau_color,
                   double tau_grad, double inv_gamma_color, at::IntArrayRef plan) {
  const auto [H, W] = check_stacks(ls, rs, aw, 1, r, D);
  TORCH_CHECK(D >= 2 && D <= 128 && r <= 32, "need 2 <= D <= 128 and r <= 32");
  TORCH_CHECK(plan.size() == 5, "plan must be (ty, tx, dc, kx, smem_bytes)");
  TORCH_CHECK(H * (W + 2 * r + D - 1) < (int64_t)1 << 31, "image too large");
  c10::cuda::CUDAGuard guard(ls.device());
  Outputs o(ls, H, W);
  const int err = asw_sep_wta_launch(
      ls.data_ptr<float>(), rs.data_ptr<float>(), aw.data_ptr<float>(),
      (int)H, (int)W, (int)r, (int)D, (int)(sym != 0), (int)cost_ad,
      (int)(bf16 != 0), (float)alpha, (float)one_minus_alpha,
      (float)tau_color, (float)tau_grad, (float)inv_gamma_color, (int)plan[0],
      (int)plan[1], (int)plan[2], (int)plan[3], (int)plan[4],
      o.bestd.data_ptr<int>(), o.bestc.data_ptr<float>(), o.cm.data_ptr<float>(),
      o.cp.data_ptr<float>(), o.ubest.data_ptr<float>(), o.rpack_ptr(),
      o.rbestd.data_ptr<int>(), stream_of(ls));
  TORCH_CHECK(err == 0, "asw_sep_wta launch failed (tile plan ", plan, "): ",
              asw_error_string(err));
  return o.planes();
}

Planes asw_dlanes_wta(const at::Tensor& ls, const at::Tensor& rs, const at::Tensor& sw,
                      int64_t r, int64_t D, int64_t box, int64_t cost_ad,
                      double alpha, double one_minus_alpha, double tau_color,
                      double tau_grad, double inv_gamma_color, at::IntArrayRef plan) {
  const auto [H, W] = check_stacks(ls, rs, sw, 2, r, D);
  const int64_t K = 2 * r + 1;
  TORCH_CHECK(D >= 2 && D <= 128 && K <= 65, "need 2 <= D <= 128 and K <= 65");
  TORCH_CHECK(plan.size() == 4, "plan must be (ty, tx, dp, smem_bytes)");
  TORCH_CHECK(H * (W + 2 * r + D - 1) < (int64_t)1 << 31, "image too large");
  c10::cuda::CUDAGuard guard(ls.device());
  Outputs o(ls, H, W);
  const int err = asw_dlanes_wta_launch(
      ls.data_ptr<float>(), rs.data_ptr<float>(), sw.data_ptr<float>(),
      (int)H, (int)W, (int)r, (int)D, (int)(box != 0), (int)cost_ad,
      (float)alpha, (float)one_minus_alpha, (float)tau_color, (float)tau_grad,
      (float)inv_gamma_color, (float)(1.0 / (double)(K * K)), (int)plan[0],
      (int)plan[1], (int)plan[2], (int)plan[3],
      o.bestd.data_ptr<int>(), o.bestc.data_ptr<float>(), o.cm.data_ptr<float>(),
      o.cp.data_ptr<float>(), o.ubest.data_ptr<float>(), o.rpack_ptr(),
      o.rbestd.data_ptr<int>(), stream_of(ls));
  TORCH_CHECK(err == 0, "asw_dlanes_wta launch failed (tile plan ", plan, "): ",
              asw_error_string(err));
  return o.planes();
}

Planes asw_sym_dlanes_wta(const at::Tensor& ls, const at::Tensor& rs,
                          const at::Tensor& sw, int64_t r, int64_t D,
                          int64_t cost_ad, double alpha, double one_minus_alpha,
                          double tau_color, double tau_grad,
                          double inv_gamma_color, at::IntArrayRef plan) {
  const auto [H, W] = check_stacks(ls, rs, sw, 2, r, D);
  const int64_t K = 2 * r + 1;
  TORCH_CHECK(D >= 2 && D <= 128 && K <= 63, "need 2 <= D <= 128 and K <= 63");
  TORCH_CHECK(plan.size() == 5, "plan must be (ty, tx, dc, kx, smem_bytes)");
  TORCH_CHECK(H * (W + 2 * r + D - 1) < (int64_t)1 << 31, "image too large");
  c10::cuda::CUDAGuard guard(ls.device());
  Outputs o(ls, H, W);
  const int err = asw_sym_dlanes_wta_launch(
      ls.data_ptr<float>(), rs.data_ptr<float>(), sw.data_ptr<float>(),
      (int)H, (int)W, (int)r, (int)D, (int)cost_ad, (float)alpha,
      (float)one_minus_alpha, (float)tau_color, (float)tau_grad,
      (float)inv_gamma_color, (int)plan[0], (int)plan[1], (int)plan[2], (int)plan[3],
      (int)plan[4], o.bestd.data_ptr<int>(), o.bestc.data_ptr<float>(),
      o.cm.data_ptr<float>(), o.cp.data_ptr<float>(), o.ubest.data_ptr<float>(),
      o.rpack_ptr(), o.rbestd.data_ptr<int>(), stream_of(ls));
  TORCH_CHECK(err == 0, "asw_sym_dlanes_wta launch failed (tile plan ", plan, "): ",
              asw_error_string(err));
  return o.planes();
}

at::Tensor sgm_aggregate(const at::Tensor& vol, const at::Tensor& scratch, double p1,
                         double p2, at::IntArrayRef plan) {
  check_input(vol, "vol", 3);
  check_input(scratch, "scratch", 1);
  TORCH_CHECK(scratch.device() == vol.device(), "scratch must be on the volume's device");
  const int64_t H = vol.size(0), W = vol.size(1), D = vol.size(2);
  TORCH_CHECK(H >= 1 && W >= 1 && D >= 1, "empty cost volume");
  TORCH_CHECK(H + W < (int64_t)1 << 29 && D < (int64_t)1 << 30, "cost volume too large");
  c10::cuda::CUDAGuard guard(vol.device());
  at::Tensor out = at::empty_like(vol);
  const std::vector<long long> p(plan.begin(), plan.end());
  const int err = sgm_aggregate_launch(
      vol.data_ptr<float>(), out.data_ptr<float>(),
      scratch.numel() > 0 ? scratch.data_ptr<float>() : nullptr, (long long)scratch.numel(),
      (int)H, (int)W, (int)D, (float)p1, (float)p2, p.data(), (int)p.size(), stream_of(vol));
  TORCH_CHECK(err == 0, "sgm_aggregate launch failed (plan ", plan, "): ",
              asw_error_string(err));
  return out;
}

void channel_stacks_table(const at::Tensor& table, int64_t device) {
  TORCH_CHECK(table.device().is_cpu() && table.scalar_type() == at::kFloat &&
                  table.is_contiguous() && table.dim() == 1,
              "the stack table must be a contiguous 1-D float32 CPU tensor");
  c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  const int err = channel_stacks_set_table(table.data_ptr<float>(), (int)table.numel());
  TORCH_CHECK(err == 0, "channel_stacks_table failed (", table.numel(), " floats): ",
              asw_error_string(err));
}

// left / right (H, W, 3) or (H, W) -> ls (7, H, W + 2r), rs (7, H, W + 2r + D - 1).
std::tuple<at::Tensor, at::Tensor> channel_stacks(const at::Tensor& left,
                                                  const at::Tensor& right, int64_t r,
                                                  int64_t D) {
  check_input(left, "left", left.dim());
  check_input(right, "right", left.dim());
  TORCH_CHECK(left.dim() == 2 || (left.dim() == 3 && left.size(2) == 3),
              "images must be (H, W, 3) or (H, W)");
  TORCH_CHECK(right.sizes() == left.sizes(), "left and right must have one shape");
  TORCH_CHECK(right.device() == left.device(), "left and right must share one device");
  TORCH_CHECK(r >= 0 && D >= 1, "need r >= 0 and D >= 1");
  const int64_t H = left.size(0), W = left.size(1);
  const int64_t C = left.dim() == 3 ? 3 : 1;
  TORCH_CHECK(H >= 1 && W >= 1, "empty image");
  TORCH_CHECK(H < (int64_t)1 << 30 && W + 2 * r + D - 1 < (int64_t)1 << 30, "image too large");
  c10::cuda::CUDAGuard guard(left.device());
  at::Tensor ls = at::empty({7, H, W + 2 * r}, left.options());
  at::Tensor rs = at::empty({7, H, W + 2 * r + D - 1}, left.options());
  const int err = channel_stacks_launch(left.data_ptr<float>(), right.data_ptr<float>(),
                                        (int)H, (int)W, (int)C, (int)r, (int)D,
                                        ls.data_ptr<float>(), rs.data_ptr<float>(),
                                        stream_of(left));
  TORCH_CHECK(err == 0, "channel_stacks launch failed: ", asw_error_string(err));
  return {ls, rs};
}

// lc (H, W', C), rc (H, W' + D - 1, C), gl (H, W'), gr (H, W' + D - 1) ->
// the raw cost volume (H, W', D).
at::Tensor cost_volume(const at::Tensor& lc, const at::Tensor& rc, const at::Tensor& gl,
                       const at::Tensor& gr, int64_t D, int64_t cost_ad, double inv_c,
                       double alpha, double one_minus_alpha, double tau_color,
                       double tau_grad) {
  check_input(lc, "lc", 3);
  check_input(rc, "rc", 3);
  check_input(gl, "gl", 2);
  check_input(gr, "gr", 2);
  const int64_t H = lc.size(0), Wo = lc.size(1), C = lc.size(2);
  TORCH_CHECK(C == 1 || C == 3, "lc must have 1 or 3 channels");
  TORCH_CHECK(H >= 1 && Wo >= 1 && D >= 1, "empty planes or D < 1");
  TORCH_CHECK(rc.size(0) == H && rc.size(1) == Wo + D - 1 && rc.size(2) == C,
              "rc must be (H, W' + D - 1, C)");
  TORCH_CHECK(gl.size(0) == H && gl.size(1) == Wo, "gl must be (H, W')");
  TORCH_CHECK(gr.size(0) == H && gr.size(1) == Wo + D - 1, "gr must be (H, W' + D - 1)");
  TORCH_CHECK(rc.device() == lc.device() && gl.device() == lc.device() &&
                  gr.device() == lc.device(),
              "the planes must share one device");
  TORCH_CHECK(H < (int64_t)1 << 30 && Wo + D < (int64_t)1 << 30, "planes too large");
  c10::cuda::CUDAGuard guard(lc.device());
  at::Tensor out = at::empty({H, Wo, D}, lc.options());
  const int err = cost_volume_launch(
      lc.data_ptr<float>(), rc.data_ptr<float>(), gl.data_ptr<float>(), gr.data_ptr<float>(),
      (int)H, (int)Wo, (int)C, (int)D, (int)cost_ad, (float)inv_c, (float)alpha,
      (float)one_minus_alpha, (float)tau_color, (float)tau_grad, out.data_ptr<float>(),
      stream_of(lc));
  TORCH_CHECK(err == 0, "cost_volume launch failed: ", asw_error_string(err));
  return out;
}

// The WTA planes (H, W): bestd and rbestd int32, the rest float32; rbestd
// where lr_check is on, ubest where uniqueness is on -> the map (H, W).
// Its wrapper (disparity_kernel.py::check) checks the planes: dtypes, one
// shape, contiguity, one CUDA device, the planes the flags read.
at::Tensor disparity_map(const at::Tensor& bestd, const at::Tensor& bestc, const at::Tensor& cm,
                         const at::Tensor& cp, const std::optional<at::Tensor>& rbestd,
                         const std::optional<at::Tensor>& ubest, int64_t D, int64_t subpixel,
                         int64_t lr_check, double lr_tol, int64_t uniqueness, double uscale,
                         int64_t fill, int64_t median) {
  const int64_t H = bestd.size(0), W = bestd.size(1);
  c10::cuda::CUDAGuard guard(bestd.device());
  at::Tensor out = at::empty({H, W}, bestc.options());
  const int err = disparity_map_launch(
      bestd.data_ptr<int>(), bestc.data_ptr<float>(), cm.data_ptr<float>(), cp.data_ptr<float>(),
      lr_check ? rbestd->data_ptr<int>() : nullptr,
      uniqueness ? ubest->data_ptr<float>() : nullptr, (int)H, (int)W, (int)D, (int)subpixel,
      (int)lr_check, (float)lr_tol, (int)uniqueness, (float)uscale, (int)fill, (int)median,
      out.data_ptr<float>(), stream_of(bestd));
  TORCH_CHECK(err == 0, "disparity_map launch failed: ", asw_error_string(err));
  return out;
}

// vol (H, W, D) -> [bestd, bestc, cm, cp] (H, W), then rbestd where asked
// for and ubest where asked for; bestd and rbestd int32, the rest float32.
std::vector<at::Tensor> wta_planes(const at::Tensor& vol, bool rbestd, bool ubest) {
  check_input(vol, "vol", 3);
  const int64_t H = vol.size(0), W = vol.size(1), D = vol.size(2);
  TORCH_CHECK(H >= 1 && W >= 1 && D >= 1, "empty volume");
  TORCH_CHECK(H < (int64_t)1 << 31 && W + D < (int64_t)1 << 30, "volume too large");
  c10::cuda::CUDAGuard guard(vol.device());
  const auto f32 = vol.options();
  const auto i32 = vol.options().dtype(at::kInt);
  std::vector<at::Tensor> out = {at::empty({H, W}, i32), at::empty({H, W}, f32),
                                 at::empty({H, W}, f32), at::empty({H, W}, f32)};
  if (rbestd) out.push_back(at::empty({H, W}, i32));
  if (ubest) out.push_back(at::empty({H, W}, f32));
  const int err = wta_planes_launch(
      vol.data_ptr<float>(), (int)H, (int)W, (int)D, out[0].data_ptr<int>(),
      out[1].data_ptr<float>(), out[2].data_ptr<float>(), out[3].data_ptr<float>(),
      rbestd ? out[4].data_ptr<int>() : nullptr, ubest ? out.back().data_ptr<float>() : nullptr,
      stream_of(vol));
  TORCH_CHECK(err == 0, "wta_planes launch failed: ", asw_error_string(err));
  return out;
}

}  // namespace

TORCH_LIBRARY(asw_torch, m) {
  m.def(
      "asw_wta(Tensor ls, Tensor rs, Tensor sw, int r, int D, int mode, "
      "int cost_ad, float alpha, float one_minus_alpha, float tau_color, "
      "float tau_grad, float inv_gamma_color, int n_valid, int d_lo, int d_hi, "
      "bool want_strip, int[] plan) -> Tensor[]");
  m.def(
      "asw_sep_wta(Tensor ls, Tensor rs, Tensor aw, int r, int D, int sym, "
      "int cost_ad, int bf16, float alpha, float one_minus_alpha, "
      "float tau_color, float tau_grad, float inv_gamma_color, int[] plan) "
      "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def(
      "asw_dlanes_wta(Tensor ls, Tensor rs, Tensor sw, int r, int D, int box, "
      "int cost_ad, float alpha, float one_minus_alpha, float tau_color, "
      "float tau_grad, float inv_gamma_color, int[] plan) "
      "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def(
      "asw_sym_dlanes_wta(Tensor ls, Tensor rs, Tensor sw, int r, int D, "
      "int cost_ad, float alpha, float one_minus_alpha, float tau_color, "
      "float tau_grad, float inv_gamma_color, int[] plan) "
      "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def(
      "sgm_aggregate(Tensor vol, Tensor(a!) scratch, float p1, float p2, int[] plan) "
      "-> Tensor");
  m.def("channel_stacks(Tensor left, Tensor right, int r, int D) -> (Tensor, Tensor)");
  m.def("channel_stacks_table(Tensor table, int device) -> ()");
  m.def(
      "cost_volume(Tensor lc, Tensor rc, Tensor gl, Tensor gr, int D, int cost_ad, "
      "float inv_c, float alpha, float one_minus_alpha, float tau_color, float tau_grad) "
      "-> Tensor");
  m.def(
      "disparity_map(Tensor bestd, Tensor bestc, Tensor cm, Tensor cp, Tensor? rbestd, "
      "Tensor? ubest, int D, int subpixel, int lr_check, float lr_tol, int uniqueness, "
      "float uscale, int fill, int median) -> Tensor");
  m.def("wta_planes(Tensor vol, bool rbestd, bool ubest) -> Tensor[]");
}

TORCH_LIBRARY_IMPL(asw_torch, CUDA, m) {
  m.impl("asw_wta", &asw_wta);
  m.impl("asw_sep_wta", &asw_sep_wta);
  m.impl("asw_dlanes_wta", &asw_dlanes_wta);
  m.impl("asw_sym_dlanes_wta", &asw_sym_dlanes_wta);
  m.impl("sgm_aggregate", &sgm_aggregate);
  m.impl("channel_stacks", &channel_stacks);
  m.impl("cost_volume", &cost_volume);
  m.impl("disparity_map", &disparity_map);
  m.impl("wta_planes", &wta_planes);
}

TORCH_LIBRARY_IMPL(asw_torch, CPU, m) {
  m.impl("channel_stacks_table", &channel_stacks_table);
}
