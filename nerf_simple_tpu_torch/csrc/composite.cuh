// Device helpers of compositing, shared by the train step
// (csrc/fused_train_step.cu) and the eval render (csrc/fused_render.cu).
//
// One warp composites one ray: each lane takes a run of consecutive
// samples, and the ray's exclusive prefix sums come from a warp shuffle
// scan over the lanes' partial sums. Per sample, as in the TPU kernels:
// softplus density; point form: delta = t[k+1] - t[k] with 1e10 for the
// last sample; interval form (the mip path): delta = the interval's width
// as given, 1e10 for the last interval only with an opaque tail;
// alpha = 1 - exp(-softplus(sigma) * delta), m = max(1 - alpha, 1e-10),
// weight = alpha * exp(exclusive prefix sum of log m).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// Exclusive prefix over the warp's lanes of v, and the warp total.
__device__ __forceinline__ float warp_exclusive(float v, float *total) {
  const int lane = threadIdx.x & 31;
  float s = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float n = __shfl_up_sync(0xffffffffu, s, d);
    if (lane >= d) s += n;
  }
  *total = __shfl_sync(0xffffffffu, s, 31);
  return s - v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

struct Sample {
  float delta, alpha, m, e;  // e = exp(-softplus(sigma) * delta)
};

// Sample k of a ray at column `col` of out8 (raw sigma in row 3) and x16
// (row 6: the ts, or with `mip` the interval widths), both with row
// stride R. `opaque` (with `mip`): the last interval's delta is 1e10.
__device__ __forceinline__ Sample sample_at(const float *out8, const float *x16, long long R,
                                            long long col, int k, int N, bool mip = false,
                                            bool opaque = false) {
  Sample s;
  if (mip)
    s.delta = opaque && k == N - 1 ? 1e10f : x16[6 * R + col];
  else
    s.delta = k == N - 1 ? 1e10f : x16[6 * R + col + 1] - x16[6 * R + col];
  s.e = expf(-softplus(out8[3 * R + col]) * s.delta);
  s.alpha = 1.f - s.e;
  s.m = fmaxf(1.f - s.alpha, 1e-10f);
  return s;
}

}  // namespace
