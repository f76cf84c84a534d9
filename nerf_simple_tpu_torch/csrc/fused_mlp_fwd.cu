// Fused NeRF MLP forward for Hopper (sm_90a): positional encoding, the
// nine matmuls of the packed layout and the rgb/sigma heads for a tile of
// sample rows, with every intermediate activation kept in shared memory.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::fused_mlp_forward (the
// pallas_call of _fwd_kernel -> _forward_tile -> _encode), point variant
// only (no mip, BARF anneal, appearance rail or contraction).
//
// Contract (same as the TPU kernel): x is (8, rows) f32 feature-major --
// rows 0..2 sample xyz, rows 3..5 unit view direction. out is (8, rows)
// f32: raw rgb in rows 0..2, raw sigma in row 3, zeros in rows 4..7. The
// weights are pack_weights' FusedWeights, (out, in) row-major; matrices
// in the compute type (f32 or bf16), biases f32.
//
// What bounds it on this card: arithmetic. A sample row costs ~0.54 M
// multiply-adds in the packed layout, while it reads 32 B and writes
// 32 B of device memory, so the layer-by-layer plain version's traffic
// (each 256-wide activation written and read back) is what the fusion
// removes. The weights (1.2 MB bf16, 2.4 MB f32) stay in L2 and every
// block streams each layer through shared memory once per 64 rows.
//
// Design (the tile kernels live in mlp_tile.cuh, shared with the training
// entries). One block of 256 threads per tile of 64 sample rows. The
// encoded inputs (posx, posd) and two ping-pong activation buffers live
// in shared memory; each layer streams its weight matrix through shared
// memory in K-slices.
//
// - f32 (SIMT): activations as [feature][row]; each thread accumulates an
//   8 (features) x 8 (rows) register tile with scalar FMAs. Full f32
//   products, no TF32. Weight slices of 16 columns are double-buffered
//   with cp.async, so the next slice's copy overlaps this one's FMAs
//   (one block an SM: nothing else hides the copy). ~196 KB of shared
//   memory.
// - bf16 (tensor cores): activations as [row][feature] (the mma B operand
//   wants consecutive k per row), each warp owns 32 output features x 64
//   rows and runs mma.sync m16n8k16 with f32 accumulators. Numerics
//   follow the TPU kernel's _mm: operands rounded to bf16, products summed
//   in f32, the f32 bias added after, relu outputs rounded before the next
//   product; the encoding is computed in f32 and rounded. Row strides are
//   padded so that the eight rows a fragment load touches fall in
//   distinct banks. ~104 KB of shared memory: two blocks an SM.

#include "mlp_tile.cuh"

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long fused_mlp_fwd_smem_bytes(int Lp, int Ld, int H, int is_bf16) {
  return fwd_smem(Lp, Ld, H, is_bf16);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (8, rows) f32 and checks shapes and types.
int fused_mlp_fwd(const float *x, float *out, long long rows, int Lp, int Ld,
                  int H, int is_bf16, Weights w, void *stream) {
  if (!arch_ok(Lp, Ld, H)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  return forward(x, out, rows, Lp, Ld, H, is_bf16, w, nullptr,
                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
