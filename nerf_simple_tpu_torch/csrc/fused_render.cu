// Fused NeRF eval render for Hopper (sm_90a): the MLP forward and point
// compositing of whole rays, giving each ray's rgb, depth and acc.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::fused_render (the pallas_call
// of _render_kernel -> _forward_tile, then segmented compositing); with
// `contract`, a contracted model's forward (csrc/fused_contract.cu).
//
// Contract (the TPU kernel's): x16 (16, B*N) f32 -- rows 0..2 sample xyz,
// 3..5 unit view dir, 6 ts (ray b's samples are columns b*N .. b*N+N-1),
// rows 7..15 not read (no appearance model: it has no slot for codes and
// the Layout without them; such a model renders through the forward
// kernel, as in JAX, mlp.py:1714). out (8, B*N) f32: at each ray's head column b*N,
// rows 0..2 the raw rgb sum_k w_k c_k, row 3 the depth sum_k w_k t_k, row
// 4 the acc sum_k w_k; every other entry 0. Compositing is f32 at both
// compute types (csrc/composite.cuh: softplus sigma, a 1e10 last delta,
// w = alpha * exp(exclusive cumsum of log max(1 - alpha, 1e-10))).
//
// What bounds it on this card: the forward's arithmetic, as in csrc/
// fused_mlp_fwd.cu (~0.54 M multiply-adds a sample row). Compositing adds
// ~52 B of device-memory traffic a row (reading raw rgb, sigma and ts
// back, writing the output over them): ~110 MB at a 2,097,152-row chunk,
// some 35 us at 3.35 TB/s against the forward's ~18 ms in bf16.
//
// Design: two passes on one stream. The forward tile kernel of
// mlp_tile.cuh writes raw rgb and sigma into `out` itself (128-row tiles:
// a ray at N = 128 may span two, so the tile kernel cannot composite). Then one
// warp a ray composites in place: every lane reads its run of samples,
// the warp sums, and only after __syncwarp do the lanes overwrite the
// ray's columns with the head values and zeros. No workspace.

#include "composite.cuh"
#include "mlp_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
    composite_render(float *__restrict__ out, const float *__restrict__ x16, int B, int N) {
  const int b = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: b is the same on every lane
  const int lane = threadIdx.x & 31;
  const long long R = (long long)B * N, base = (long long)b * N;
  const int per = (N + 31) / 32, k0 = min(N, lane * per), k1 = min(N, k0 + per);

  float local = 0.f, tot;
  for (int k = k0; k < k1; ++k) local += logf(sample_at(out, x16, R, base + k, k, N).m);
  float run = warp_exclusive(local, &tot);
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // rgb, depth, acc
  for (int k = k0; k < k1; ++k) {
    const long long col = base + k;
    const Sample s = sample_at(out, x16, R, col, k, N);
    const float w = s.alpha * expf(run);
    run += logf(s.m);
#pragma unroll
    for (int c = 0; c < 3; ++c) sums[c] += w * out[c * R + col];
    sums[3] += w * x16[6 * R + col];
    sums[4] += w;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) sums[j] = warp_sum(sums[j]);
  __syncwarp();  // every lane has read the ray before any lane overwrites it
  for (int k = lane; k < N; k += 32) {
#pragma unroll
    for (int r = 0; r < 8; ++r) out[r * R + base + k] = (k == 0 && r < 5) ? sums[r < 5 ? r : 0] : 0.f;
  }
}

}  // namespace

extern "C" {

long long fused_render_smem_bytes(int Lp, int Ld, int H, int is_bf16) {
  return fwd_smem(Lp, Ld, H, is_bf16);
}

// Bytes of the scratch `image` fused_render needs (the forward's weight image).
long long fused_render_image_bytes(int Lp, int Ld, int H, int is_bf16) {
  return fwd_image_bytes(Lp, Ld, H, is_bf16);
}

// Launches on `stream` and returns the first CUDA error (0 on success).
// The caller allocates `out` (8, rows) f32 and the scratch `image`, and
// checks shapes and types.
int fused_render(const float *x16, float *out, long long rows, int N, int Lp, int Ld, int H,
                 int is_bf16, Weights w, void *image, int contract, void *stream) {
  if (!arch_ok(Lp, Ld, H) || N <= 0 || rows <= 0 || rows % N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int e = forward_point(contract != 0, x16, out, rows, Lp, Ld, H, is_bf16, w, nullptr, image, false, nullptr,
                            nullptr, s))
    return e;
  const long long B = rows / N;
  const int rays_per_block = THREADS / 32;
  composite_render<<<(unsigned)((B + rays_per_block - 1) / rays_per_block), THREADS, 0, s>>>(
      out, x16, (int)B, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
