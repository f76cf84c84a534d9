// The contracted forward tile kernels for Hopper (sm_90a): the forward of
// a contracted model (mip-NeRF 360's scene contraction), point and mip,
// f32 and bf16, which the forward, B2's recompute, B1 and the eval render
// (csrc/fused_mlp_fwd.cu, fused_mlp_bwd.cu, fused_train_step.cu,
// fused_render.cu) launch through set_contract_forward.
//
// Replaces: the `if model.contract:` branch of nerf_simple_tpu/kernels/
// mlp.py::_encode (:437-456), reached by every _forward_tile: the
// forward (:669), B1 (:1623), B2's recompute (:1147) and B3 (:1734).
//
// Contract: x as the forward takes it (csrc/fused_mlp_fwd.cu): rows 0..2
// the sample positions (under `mip` the frustum Gaussians' means, their
// variances in rows 11..13), 3..5 the unit view directions; out and the
// residuals `res` (null for none) as forward() gives them. Before the
// encoding each row's n = |x| (x0^2 + x1^2 + x2^2 summed without FMAs,
// floored at 1e-20, then sqrt) gives g = 1 for n <= 1, else (2 - 1/n) / n,
// and rows 0..2 become g x: the angles of posx's sin and cos rows and its
// raw rows alike, so the residual plane of posx holds the contracted rows
// that B1's and B2's weight gradients read (the TPU kernel's reason why the
// backward needs no gradient through x). Under mip the three variances
// first go through the contraction's Jacobian at the uncontracted mean:
// v = g^2 v + 2 g c m v + c^2 m (m . v), m = x^2, c = (-2/n^2 + 2/n^3) / n
// (0 inside the ball). Inside the ball nothing changes, so there the
// launch equals the one without contract to the bit. posd, the anneal
// windows and appearance codes are not contracted (a contracted model has
// neither windows nor codes here).
//
// What bounds it: the forward's arithmetic (csrc/fused_mlp_fwd.cu). The
// contraction adds per row one sqrt, three divisions and ~10 FMAs, ~20
// more under mip, against ~0.54 M multiply-adds of the products.
//
// Design: the CONTRACT instantiations of the forward tile kernels
// (fwd_f32.cuh, fwd_bf16.cuh: the encoders call contract_point of
// mlp_tile.cuh; in the f32 encoder each of a row's four threads contracts
// the row for itself, in the bf16 one each of its two), built here once:
// kept out of the libraries that launch them, whose kernels without
// contract keep their SASS (mlp_tile.cuh's forward_point).

#define CONTRACT_LIBRARY
#include "mlp_tile.cuh"

extern "C" {

// The contracted forward on `stream`, as forward() runs it (`res`: the
// residual planes, or null; `image`: the forward's weight image scratch);
// returns cudaGetLastError() (0 on success).
int fused_contract_fwd(const float *x, float *out, long long rows, int Lp, int Ld, int H, int is_bf16, Weights w,
                       void *res, void *image, int mip, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0) return (int)cudaErrorInvalidValue;
  return forward<false, true>(x, out, rows, Lp, Ld, H, is_bf16 != 0, w, res, image, mip != 0, nullptr, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// Launches of the contracted forward tile kernels so far.
long long fwd_contract_launch_count(int reset) {
  const long long n = fwd_contract_launches;
  if (reset) fwd_contract_launches = 0;
  return n;
}

}  // extern "C"
