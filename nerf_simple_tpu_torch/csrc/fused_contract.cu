// The kernels of a contracted model (mip-NeRF 360's scene contraction)
// for Hopper (sm_90a): the forward tile kernels, point and mip, f32 and
// bf16, with or without BARF's anneal windows and an appearance model's
// code rows, which the forward, B2's recompute, B1 and the eval render
// (csrc/fused_mlp_fwd.cu, fused_mlp_bwd.cu, fused_train_step.cu,
// fused_render.cu) launch through set_contract_forward; and the
// input-gradient kernel's contract instantiations, point and mip, which B2
// launches through set_contract_input_grad.
//
// Replaces: the `if model.contract:` branch of nerf_simple_tpu/kernels/
// mlp.py::_encode (:437-456), reached by every _forward_tile: the
// forward (:669), B1 (:1623), B2's recompute (:1147) and B3 (:1734),
// composed there with the windows (:491-493) and the code rows (:541-545);
// and the contract branch of _input_grad_tile (:898-906, :933-938),
// reached from _bwd_kernel's want_dx (:733-746), and of
// _input_grad_tile_mip (:972-983, :1034-1064), reached under mip
// (:738-742).
//
// Contract: x as the forward takes it (csrc/fused_mlp_fwd.cu): rows 0..2
// the sample positions (under `mip` the frustum Gaussians' means, their
// variances in rows 11..13), 3..5 the unit view directions, and for an
// appearance model (`app`) the codes in rows 8..15; out and the residuals
// `res` (null for none) as forward() gives them. Before the encoding each
// row's n = |x| (x0^2 + x1^2 + x2^2 summed without FMAs, floored at
// 1e-20, then sqrt) gives g = 1 for n <= 1, else (2 - 1/n) / n, and rows
// 0..2 become g x: the angles of posx's sin and cos rows and its raw rows
// alike, so the residual plane of posx holds the contracted rows that B1's
// and B2's weight gradients read. Under mip the three variances first go
// through the contraction's Jacobian at the uncontracted mean: v = g^2 v +
// 2 g c m v + c^2 m (m . v), m = x^2, c = (-2/n^2 + 2/n^3) / n (0 inside
// the ball). The windows multiply the encoded rows after that; posd and
// the code rows are not contracted. Inside the ball nothing changes, so
// there the launch equals the one without contract to the bit.
//
// The input gradient (fused_contract_input_grad): dx of a contracted
// model, as csrc/input_grad.cuh computes it for one without contract, but
// with the encoder's transpose taken at the contracted rows g x
// (contract_point, so its angles are the forward's to the bit) and then
// the contraction's transpose, dxyz = g dy + c (x . dy) x, onto rows 0..2
// (contract_transpose); rows 3..5 and the code rows 8..15 are not touched
// by it. Under mip (dx of 16 rows) the angles and the damps are those of
// the contracted mean and variances, and the warp's coupled transpose
// (input_grad.cuh's contract_transpose_mip, at the raw mean and
// variances) takes the cotangents of both onto rows 0..2 and 11..13.
//
// What bounds them: the forward's arithmetic (csrc/fused_mlp_fwd.cu) and
// the input gradient's (csrc/input_grad.cuh). The contraction adds per row
// one sqrt, three divisions and ~10 FMAs (~20 more under mip, ~15 in the
// input gradient's transpose), against ~0.54 M multiply-adds of the
// forward's products and ~42 k of the input gradient's.
//
// Design: the CONTRACT instantiations of the forward tile kernels
// (fwd_f32.cuh, fwd_bf16.cuh: the encoders call contract_point of
// mlp_tile.cuh; in the f32 encoder each of a row's four threads contracts
// the row for itself, in the bf16 one each of its two) and of the
// input-gradient kernels (input_grad.cuh: their transpose warps contract
// a row a thread), built here once: kept out of the libraries that launch them, whose kernels without
// contract keep their SASS (mlp_tile.cuh's forward_contract).

#define CONTRACT_LIBRARY
#include "mlp_tile.cuh"
#include "input_grad.cuh"  // ig: its contract instantiation

extern "C" {

// The contracted forward on `stream`, as forward() runs it (`res`: the
// residual planes, or null; `image`: the forward's weight image scratch;
// `wx`, `wd`: the anneal windows, or null; `app`: an appearance model's,
// x of 16 rows); returns cudaGetLastError() (0 on success).
int fused_contract_fwd(const float *x, float *out, long long rows, int Lp, int Ld, int H, int is_bf16, Weights w,
                       void *res, void *image, int mip, const float *wx, const float *wd, int app, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0 || (wx == nullptr) != (wd == nullptr) || (mip && app))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return app ? forward<true, true>(x, out, rows, Lp, Ld, H, is_bf16 != 0, w, res, image, false, wx, wd, s)
             : forward<false, true>(x, out, rows, Lp, Ld, H, is_bf16 != 0, w, res, image, mip != 0, wx, wd, s);
}

// Launches of the contracted forward tile kernels so far.
long long fwd_contract_launch_count(int reset) {
  const long long n = fwd_contract_launches;
  if (reset) fwd_contract_launches = 0;
  return n;
}

// The input-gradient kernel of a contracted model on `stream`, as
// csrc/fused_mlp_bwd.cu's input_grad takes its arguments.
int fused_contract_input_grad(const void *gws, const float *x, long long rows, int Lp, int Ld, int H, int is_bf16,
                              Weights w, const float *wx, const float *wd, float *dx, int app, int mip,
                              void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0) return (int)cudaErrorInvalidValue;
  return ig::launch_contract(gws, x, rows, Lp, Ld, H, is_bf16 != 0, w, wx, wd, dx, static_cast<cudaStream_t>(stream),
                             app != 0, mip != 0);
}

// Launches of the input-gradient kernel's contract instantiations so far.
long long input_grad_contract_launch_count(int reset) {
  const long long n = ig::launches;
  if (reset) ig::launches = 0;
  return n;
}

// Of them, the launches of the mip one (MIP && CONTRACT).
long long input_grad_mip_contract_launch_count(int reset) {
  const long long n = ig::mip_launches;
  if (reset) ig::mip_launches = 0;
  return n;
}

// Of them, the launches in f32 (input_grad_fma).
long long input_grad_contract_f32_launch_count(int reset) {
  const long long n = ig::f32_launches;
  if (reset) ig::f32_launches = 0;
  return n;
}

}  // extern "C"
