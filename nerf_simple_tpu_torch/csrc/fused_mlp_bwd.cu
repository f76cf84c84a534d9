// Fused NeRF MLP backward for Hopper (sm_90a): the weight and bias
// gradients of the packed MLP for per-sample output cotangents, summed
// over all rows.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_fused_mlp_bwd (the
// pallas_call of _bwd_kernel -> _forward_tile -> _backprop_tile ->
// _accumulate_grads), point and mip variants (the mip one recomputes the
// forward with the integrated encoder, :702, :717), with or without BARF's
// anneal windows in the recompute (:707, :1107, :1118-1120); with dx (the
// point variant's want_dx, :733-746) also the input gradient of
// _input_grad_tile (:871-938) by the kernel of csrc/input_grad.cuh, with
// `mip` and dx its mip instantiation, _input_grad_tile_mip (:941-1078,
// :738-742), and with `contract` and dx its contract instantiations, built
// in csrc/fused_contract.cu (:898-906, :933-938; under mip :972-983,
// :1034-1064); for an appearance model (`app`)
// the recompute with the codes (:716-724), dWca (:854-857) and the codes'
// rows of dx (:867, :747-748, :1140-1145).
//
// Contract: x (8, rows) f32 as for the forward, or (16, rows) with `mip`
// or `app` (csrc/fused_mlp_fwd.cu); g (8, rows) f32 with
// d_rgb in rows 0..2 and d_sigma in row 3 (rows 4..7 are not read).
// Gradients are f32 in the packed shapes: with `app`, Wcd's last eight
// columns are dWca = g_hc app8^T, from the same sum over posd's plane,
// which holds the codes' rows. Biases come out as row sums of
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
//     csrc/bwd_bf16.cuh; f32: csrc/bwd_f32.cuh);
//  3. per layer, dW = G A^T over all rows (csrc/wgrad.cuh): output tiles
//     split over row chunks, partial sums reduced in a fixed order, so
//     the result is bitwise deterministic. Bias sums ride the same pass.
// wgrad_sums runs one of those sums alone, and backward_tile the tile
// kernel alone, for tests and timing.
//  4. with dx: the input-gradient kernel (csrc/input_grad.cuh) from the
//     cotangent planes of step 2, which stay in the workspace; input_grad
//     runs it alone.
// bf16 rounds where _backprop_tile does: both operands of every product,
// f32 sums; cotangents are stored rounded, as each use rounds them.

#include "mlp_tile.cuh"
#include "input_grad.cuh"  // ig: the input-gradient kernel

extern "C" {

// Bytes of the workspace fused_mlp_bwd needs (`app`: an appearance
// model's, as every entry below takes it).
long long fused_mlp_bwd_workspace_bytes(long long rows, int Lp, int Ld, int H, int is_bf16, int app) {
  const Layout L = make_layout(rows, Lp, Ld, H, app != 0);
  return carve(nullptr, rows, Lp, Ld, H, is_bf16, app != 0).bytes + align256(4LL * 8 * L.Rp);
}

// Dynamic shared memory of the largest kernel, in bytes.
long long fused_mlp_bwd_smem_bytes(int Lp, int Ld, int H, int is_bf16, int app) {
  const long long f = fwd_smem(Lp, Ld, H, is_bf16, app != 0), b = bwd_smem(H, is_bf16),
                  i = ig::smem_bytes(H, app != 0, is_bf16 != 0);
  return std::max(std::max(f, b), i);
}

// Launches on `stream`; returns the first CUDA error (0 on success).
// `wt` is not read (mlp_tile.cuh's WeightsT). `wx`, `wd`: null, or the
// anneal windows of the forward it recomputes (FX and enc_rows(Ld) floats
// on the card). `contract`: a contracted model's recompute and input
// gradient. `dx`: null, or (8, rows) f32 for the input
// gradient, (16, rows) with `app` or `mip` (under mip rows 0..2
// d/d(mean), 3..5 d/d(dir), 11..13 d/d(variance); not with the windows or
// codes, as in JAX).
int fused_mlp_bwd(const float *x, const float *g, long long rows, int Lp, int Ld,
                  int H, int is_bf16, Weights w, WeightsT wt, void *workspace,
                  Grads out, int mip, const float *wx, const float *wd, float *dx, int app, int contract,
                  void *stream) {
  if (!arch_ok(Lp, Ld, H) || (wx == nullptr) != (wd == nullptr)) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || (mip && (wx || app))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace ws = carve(workspace, rows, Lp, Ld, H, is_bf16, app != 0);
  float *out8 = reinterpret_cast<float *>(static_cast<char *>(workspace) + ws.bytes);
  if (int e = contract ? forward_contract(x, out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, mip != 0, wx, wd,
                                          app != 0, s)
              : app    ? forward<true>(x, out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, false, wx, wd, s)
                       : forward(x, out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, mip != 0, wx, wd, s))
    return e;
  if (int e = backward(g, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.gws, ws.image, ws.part, out, s, app != 0))
    return e;
  return dx ? ig::launch(ws.gws, x, rows, Lp, Ld, H, is_bf16, w, wx, wd, dx, s, app != 0, mip != 0, contract != 0)
            : 0;
}

// The input-gradient kernel alone, on `stream`: from the cotangent planes
// `gws` ((FG, Rp) of mlp_tile.cuh's Layout in the compute type, Rp = rows
// rounded up to 64) and x (8, rows) f32 to dx (8, rows) f32 (both 16 rows
// with `app` or `mip`), with the anneal windows wx, wd (or null); a
// contracted model's with `contract` (through set_contract_input_grad):
// for tests and timing.
int input_grad(const void *gws, const float *x, long long rows, int Lp, int Ld, int H, int is_bf16, Weights w,
               const float *wx, const float *wd, float *dx, int app, int mip, int contract, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0) return (int)cudaErrorInvalidValue;
  return ig::launch(gws, x, rows, Lp, Ld, H, is_bf16, w, wx, wd, dx, static_cast<cudaStream_t>(stream), app != 0,
                    mip != 0, contract != 0);
}

// Launches of the input-gradient kernel by this library so far, as
// bwd_tile_launch_count counts the tile kernels (a contracted model's are
// counted in csrc/fused_contract.cu's library, which launches them).
long long input_grad_launch_count(int reset) {
  const long long n = ig::launches;
  if (reset) ig::launches = 0;
  return n;
}

// Of them, the launches of its mip instantiation.
long long input_grad_mip_launch_count(int reset) {
  const long long n = ig::mip_launches;
  if (reset) ig::mip_launches = 0;
  return n;
}

// Of them, the launches in f32 (input_grad_fma).
long long input_grad_f32_launch_count(int reset) {
  const long long n = ig::f32_launches;
  if (reset) ig::f32_launches = 0;
  return n;
}

// Where ig::launch finds the contract instantiation (csrc/fused_contract.cu's
// fused_contract_input_grad).
void set_contract_input_grad(void *f) { ig::contract_input_grad = reinterpret_cast<ig::ContractInputGrad>(f); }

// Bytes of the scratch `image` backward_tile needs (its weight image).
long long bwd_tile_image_bytes(int H, int is_bf16) { return bwd_image_bytes(H, is_bf16); }

// The backward tile kernel alone, on `stream`: from the output cotangents
// g (rows 0..2 d_rgb, row 3 d_sigma; row stride `rows`) and the residual
// planes `res` (FA, Rp) to the cotangent planes `gws` (FG, Rp) of the
// workspace (mlp_tile.cuh's Layout, Rp = rows rounded up to 64; `app`:
// an appearance model's), in the compute type, both 16-byte aligned. The
// kernel builds its weight image from `w` in `image`
// (bwd_tile_image_bytes); `wt` is not read.
int backward_tile(const float *g, long long rows, int Lp, int Ld, int H, int is_bf16, Weights w,
                  WeightsT wt, const void *res, void *gws, void *image, int app, void *stream) {
  if (!arch_ok(Lp, Ld, H) || rows <= 0) return (int)cudaErrorInvalidValue;
  return bwd_tile(g, rows, Lp, Ld, H, is_bf16, w, res, gws, image, static_cast<cudaStream_t>(stream), app != 0);
}

// The backward's weight image of the compute type alone, into `image`
// (bwd_tile_image_bytes), on `stream`: for tests.
int bwd_weight_image(Weights w, int H, int is_bf16, void *image, void *stream) {
  if (!arch_ok(1, 1, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bb::build_image(w, bb::Plan{H}, image, s) : fw::build_image(w, fw::Plan{H}, image, s);
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
