// Fused NeRF MLP forward for Hopper (sm_90a): positional encoding, the
// nine matmuls of the packed layout and the rgb/sigma heads for a tile of
// sample rows, with every intermediate activation kept in shared memory.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::fused_mlp_forward (the
// pallas_call of _fwd_kernel -> _forward_tile -> _encode), point and mip
// variants, with or without BARF's anneal windows (enc_w, :613, :648-650;
// applied in _encode, :491-493), and the point variant with the appearance
// rail (app8, :541-545, :589-594, :624-641); with `contract` the point
// and mip variants of a contracted model (_encode's contraction,
// :437-456), with the windows and the code rows as above, through
// csrc/fused_contract.cu's kernels.
//
// Contract (same as the TPU kernel): x is (8, rows) f32 feature-major --
// rows 0..2 sample xyz, rows 3..5 unit view direction; with `mip`, x is
// (16, rows): rows 0..2 the frustum Gaussians' means, 3..5 the unit view
// direction, 11..13 their diagonal variances, and the encoder is the
// integrated one (mip-NeRF's IPE: each sin and cos of coordinate c at
// frequency 2^i times exp(-0.5 * 4^i * var_c)). With `app` (an appearance
// model; not with `mip`), x is (16, rows): rows 8..15 the image's code
// (app_dim rows, zeros after), broadcast over its samples; the encoder
// copies them into posd after its encoded rows, and Wcd (H/2, FD + 8)
// holds Wca as its last eight columns (pack_weights), so hc_pre = Wcs h7
// + [Wcd | Wca] [posd ; app8]: the TPU kernel's sum in one product. `wx`
// (FX floats) and `wd` (enc_rows(Ld) floats), on the card, are null or
// the anneal windows: each encoded row of posx and posd times its window
// (mlp.py::anneal_row_weights; the code rows have none). With `contract`,
// rows 0..2 are contracted, and under mip the variances warped, before the
// encoder; the windows and the code rows as without it
// (csrc/fused_contract.cu, which set_contract_forward hands in). out is (8, rows)
// f32: raw rgb in rows 0..2, raw sigma in row 3, zeros in rows 4..7. The
// weights are pack_weights' FusedWeights, (out, in) row-major; matrices
// in the compute type (f32 or bf16), biases f32.
//
// What bounds it on this card: arithmetic. A sample row costs ~0.54 M
// multiply-adds in the packed layout, while it reads 32 B and writes
// 32 B of device memory, so the layer-by-layer plain version's traffic
// (each 256-wide activation written and read back) is what the fusion
// removes. The weights (1.2 MB bf16, 2.4 MB f32) stay in L2; every
// 128-row tile streams each layer through shared memory once. In f32 the
// bound is the FMA pipes (67 TFLOP/s), in bf16 the tensor cores.
//
// Design (the tile kernels live in headers of mlp_tile.cuh, shared with
// the eval render and the training entries). Both compute types run a
// persistent grid of 128-row tiles, keep one activation tile in shared
// memory that each layer's epilogue overwrites in place, and stream the
// weights through an mbarrier ring that a producer warp fills with
// cp.async.bulk from a weight image a small launch builds first (`image`,
// fused_mlp_fwd_image_bytes).
//
// - f32 (SIMT, csrc/fwd_f32.cuh): 16 consumer warps, each thread an 8
//   (features) x 8 (rows) register tile of scalar FMAs over fragments
//   loaded one k ahead; full f32 products, no TF32. The weight image holds
//   slices of 16 columns [k][o]. Sigma and the rgb head are summed in the
//   epilogues of the layers that produce their inputs.
// - bf16 (tensor cores, csrc/fwd_bf16.cuh): wgmma with the sample rows as
//   M, two consumer warpgroups of 64 rows; the weight image is swizzled
//   for wgmma.

#include "mlp_tile.cuh"

extern "C" {

// Dynamic shared memory one block needs, in bytes (`app`: an appearance
// model's, as every entry below takes it).
long long fused_mlp_fwd_smem_bytes(int Lp, int Ld, int H, int is_bf16, int app) {
  return fwd_smem(Lp, Ld, H, is_bf16, app != 0);
}

// Bytes of the scratch `image` fused_mlp_fwd needs.
long long fused_mlp_fwd_image_bytes(int Lp, int Ld, int H, int is_bf16, int app) {
  return fwd_image_bytes(Lp, Ld, H, is_bf16, app != 0);
}

// The forward's weight image of the compute type alone, into `image`
// (fused_mlp_fwd_image_bytes), on `stream`: for tests.
int fwd_weight_image(Weights w, int Lp, int Ld, int H, int is_bf16, void *image, int app, void *stream) {
  if (!arch_ok(Lp, Ld, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return fb::build_image(w, fb::plan_of(Lp, Ld, H, app != 0), image, s);
  return ff::build_image(w, ff::plan_of(Lp, Ld, H, app != 0), image, s);
}

// The forward as B1 and B2 run it: out, and every residual plane into
// `res` ((FA, Rp) of mlp_tile.cuh's Layout in the compute type, Rp = rows
// rounded up to 64, 16-byte aligned): for tests.
int fused_mlp_fwd_residuals(const float *x, float *out, long long rows, int Lp, int Ld, int H, int is_bf16,
                            Weights w, void *res, void *image, int mip, const float *wx, const float *wd,
                            int app, int contract, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0 || (mip && app)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return contract ? forward_contract(x, out, rows, Lp, Ld, H, is_bf16, w, res, image, mip != 0, wx, wd, app != 0, s)
         : app    ? forward<true>(x, out, rows, Lp, Ld, H, is_bf16, w, res, image, false, wx, wd, s)
                  : forward(x, out, rows, Lp, Ld, H, is_bf16, w, res, image, mip != 0, wx, wd, s);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (8, rows) f32 and the scratch `image`, and checks
// shapes and types.
int fused_mlp_fwd(const float *x, float *out, long long rows, int Lp, int Ld,
                  int H, int is_bf16, Weights w, void *image, int mip, const float *wx, const float *wd,
                  int app, int contract, void *stream) {
  if (!arch_ok(Lp, Ld, H) || (wx == nullptr) != (wd == nullptr) || (mip && app)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return contract ? forward_contract(x, out, rows, Lp, Ld, H, is_bf16, w, nullptr, image, mip != 0, wx, wd, app != 0, s)
         : app    ? forward<true>(x, out, rows, Lp, Ld, H, is_bf16, w, nullptr, image, false, wx, wd, s)
                  : forward(x, out, rows, Lp, Ld, H, is_bf16, w, nullptr, image, mip != 0, wx, wd, s);
}

}  // extern "C"
