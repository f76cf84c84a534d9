// Fused NeRF MLP backward for Hopper (sm_90a): the weight and bias
// gradients of the packed MLP for per-sample output cotangents, summed
// over all rows.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_fused_mlp_bwd (the
// pallas_call of _bwd_kernel -> _forward_tile -> _backprop_tile ->
// _accumulate_grads), with want_dx=False, point variant, no anneal.
//
// Contract: x (8, rows) f32 as for the forward; g (8, rows) f32 with
// d_rgb in rows 0..2 and d_sigma in row 3 (rows 4..7 are not read).
// Gradients are f32 in the packed shapes. Biases come out as row sums of
// the cotangents (the TPU kernel carried three of them on a constant
// "rail" column of the encoded input; the port keeps biases apart).
//
// What bounds it on this card: arithmetic again (three products of the
// forward's size: recompute, cotangents, weight gradients), plus the
// residual and cotangent traffic of the design below.
//
// Design. The TPU kernel keeps a tile's 2,288 residual feature rows on
// chip; a block here has 227 KB of shared memory, so the residuals go to
// a device-memory workspace instead (2.4 GB in bf16 at 524,288 rows,
// written once and read twice, ~2-3 ms at the card's bandwidth), which
// also lets the weight-gradient sums run as separate, well-shaped
// reductions:
//  1. the forward tile kernel recomputes out and writes the residuals;
//  2. the backward tile kernel takes each layer's cotangent back through
//     W^T and the relu mask and writes it to the workspace (bf16:
//     csrc/bwd_bf16.cuh; f32: mlp_tile.cuh's f32::bwd_kernel);
//  3. per layer, dW = G A^T over all rows (csrc/wgrad.cuh): output tiles
//     split over row chunks, partial sums reduced in a fixed order, so
//     the result is bitwise deterministic. Bias sums ride the same pass.
// wgrad_sums runs one of those sums alone, and backward_tile the tile
// kernel alone, for tests and timing.
// bf16 rounds where _backprop_tile does: both operands of every product,
// f32 sums; cotangents are stored rounded, as each use rounds them.

#include "mlp_tile.cuh"

extern "C" {

// Bytes of the workspace fused_mlp_bwd needs.
long long fused_mlp_bwd_workspace_bytes(long long rows, int Lp, int Ld, int H, int is_bf16) {
  const Layout L = make_layout(rows, Lp, Ld, H);
  return carve(nullptr, rows, Lp, Ld, H, is_bf16).bytes + align256(4LL * 8 * L.Rp);
}

// Dynamic shared memory of the largest tile kernel, in bytes.
long long fused_mlp_bwd_smem_bytes(int Lp, int Ld, int H, int is_bf16) {
  const long long f = fwd_smem(Lp, Ld, H, is_bf16), b = bwd_smem(H, is_bf16);
  return f > b ? f : b;
}

// Launches on `stream`; returns the first CUDA error (0 on success).
int fused_mlp_bwd(const float *x, const float *g, long long rows, int Lp, int Ld,
                  int H, int is_bf16, Weights w, WeightsT wt, void *workspace,
                  Grads out, void *stream) {
  if (!arch_ok(Lp, Ld, H)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(workspace, rows, Lp, Ld, H, is_bf16);
  float *out8 = reinterpret_cast<float *>(static_cast<char *>(workspace) + ws.bytes);
  if (int e = forward(x, out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, s)) return e;
  return backward(g, rows, Lp, Ld, H, is_bf16, w, wt, ws.res, ws.gws, ws.image, ws.part, out, s);
}

// Bytes of the scratch `image` backward_tile needs (0 for f32).
long long bwd_tile_image_bytes(int H, int is_bf16) { return bwd_image_bytes(H, is_bf16); }

// The backward tile kernel alone, on `stream`: from the output cotangents
// g (rows 0..2 d_rgb, row 3 d_sigma; row stride `rows`) and the residual
// planes `res` (FA, Rp) to the cotangent planes `gws` (FG, Rp) of the
// workspace (mlp_tile.cuh's Layout, Rp = rows rounded up to 64), in the
// compute type, both 16-byte aligned. bf16 builds its weight image from
// `w` in `image` (bwd_tile_image_bytes); f32 multiplies by `wt`.
int backward_tile(const float *g, long long rows, int Lp, int Ld, int H, int is_bf16, Weights w,
                  WeightsT wt, const void *res, void *gws, void *image, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0) return (int)cudaErrorInvalidValue;
  return bwd_tile(g, rows, Lp, Ld, H, is_bf16, w, wt, res, gws, image, static_cast<cudaStream_t>(stream));
}

// The bf16 backward's weight image alone, into `image`
// (bwd_tile_image_bytes), on `stream`: for tests.
int bwd_weight_image(Weights w, int H, void *image, void *stream) {
  if (!arch_ok(1, 1, H)) return (int)cudaErrorInvalidValue;
  return bb::build_image(w, bb::Plan{H}, image, static_cast<cudaStream_t>(stream));
}

// Bytes of the partial-sum scratch wgrad_sums needs.
long long wgrad_part_bytes(int O, int K, long long Rp, int is_bf16) {
  const WTask t{nullptr, nullptr, O, K, nullptr, nullptr};
  return 4LL * wgrad_part_floats(&t, 1, Rp, is_bf16);
}

// Bytes of the partial-sum scratch wgrad_group needs.
long long wgrad_group_part_bytes(const WTask *tasks, int n, long long Rp, int is_bf16) {
  return 4LL * wgrad_part_floats(tasks, n, Rp, is_bf16);
}

// n <= 12 weight-gradient sums (as wgrad_sums below) in one launch and
// one reduce, as the backward runs its twelve.
int wgrad_group(const WTask *tasks, int n, long long Rp, int is_bf16, void *part, void *stream) {
  for (int i = 0; i < n; ++i) {
    const WTask &t = tasks[i];
    if (t.O < 1 || t.K < 1 || t.O > MAX_H || t.K > MAX_H ||
        (reinterpret_cast<uintptr_t>(t.G) | reinterpret_cast<uintptr_t>(t.A)) % 16)
      return (int)cudaErrorInvalidValue;
  }
  return wgrad_launch(tasks, n, Rp, is_bf16, static_cast<float *>(part),
                      static_cast<cudaStream_t>(stream));
}

// One weight-gradient sum alone: dW (O, K) = G A^T and db (O) the row sums of G
// (db may be null), for planes G (O, Rp) and A (K, Rp) in the compute
// type, 1 <= O, K <= 256, Rp a multiple of 64, both 16-byte aligned.
// Launches on `stream`; returns the first CUDA error (0 on success).
int wgrad_sums(const void *G, int O, const void *A, int K, long long Rp, int is_bf16,
               float *dW, float *db, void *part, void *stream) {
  const WTask t{G, A, O, K, dW, db};
  return wgrad_group(&t, 1, Rp, is_bf16, part, stream);
}

}  // extern "C"
