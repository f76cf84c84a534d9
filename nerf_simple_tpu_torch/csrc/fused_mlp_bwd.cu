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
//  2. the backward tile kernel (the forward's layout and matmul loop,
//     with transposed weights) takes each layer's cotangent back through
//     W^T and the relu mask and writes it to the workspace;
//  3. per layer, dW = G A^T over all rows: 64 x 64 output tiles split
//     over <= 64 row chunks, partial sums reduced in a fixed order, so
//     the result is bitwise deterministic. Bias sums ride the same pass.
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
  if (int e = forward(x, out8, rows, Lp, Ld, H, is_bf16, w, ws.res, s)) return e;
  return backward(g, rows, Lp, Ld, H, is_bf16, wt, ws.res, ws.gws, ws.part, out, s);
}

}  // extern "C"
