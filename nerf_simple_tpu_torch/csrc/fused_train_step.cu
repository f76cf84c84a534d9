// Fused NeRF train step for Hopper (sm_90a): forward, point compositing,
// the MSE loss and its gradient, and the full backward to the packed
// weight gradients, for one batch of whole rays.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::fused_train_step (the
// pallas_call of _train_kernel -> _forward_tile -> _composite_grad_block
// -> _backprop_tile), point branch without distortion, mip, opaque tail
// or the weights output.
//
// Contract: x16 (16, B*N) f32 -- rows 0..2 sample xyz, 3..5 unit view
// dir, 6 ts, 8..10 the ray's gt colour on every sample; ray b's samples
// are columns b*N .. b*N + N - 1. Returns loss = sum over rays and
// channels of (rgb_ray - gt)^2 / (3B) and its gradients, f32, packed.
//
// Design: the forward tile kernel and the backward of csrc/
// fused_mlp_bwd.cu (mlp_tile.cuh: residuals in a device-memory workspace,
// deterministic weight-gradient sums), with the compositing between them.
// A tile of 128 rows of the forward (64 in the f32 backward) holds one ray
// or half of one at N = 128, and rays need not line up with tiles, so compositing cannot
// run inside the tile kernels as it did in the TPU kernel's 1,024-lane tiles;
// it is its own pass, one warp a ray (csrc/composite.cuh, shared with the
// eval render): each lane takes a run of consecutive samples, and the
// ray's exclusive prefix sums (of log(1 - alpha) for transmittance, of
// d_w * w for the suffix sums of the alpha gradient) come from a warp
// shuffle scan over the lanes' partial sums.
// The TPU kernel's segment matrix and lane rolls have no counterpart
// here. The loss sums per-ray terms in a fixed order, so the whole step
// is bitwise deterministic.

#include "composite.cuh"
#include "mlp_tile.cuh"

namespace {

// One warp a ray: g (4, R) gets w * d_rgb in rows 0..2 and d_sigma in row
// 3; loss_ray[b] the ray's share of the loss.
__global__ void __launch_bounds__(THREADS)
    composite_grad(const float *__restrict__ out8, const float *__restrict__ x16,
                   int B, int N, float scale, float *__restrict__ g,
                   float *__restrict__ loss_ray) {
  const int b = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const long long R = (long long)B * N, base = (long long)b * N;
  const int per = (N + 31) / 32, k0 = min(N, lane * per), k1 = min(N, k0 + per);

  // transmittance: exclusive prefix of log m over the ray
  float local = 0.f, tot;
  for (int k = k0; k < k1; ++k) local += logf(sample_at(out8, x16, R, base + k, k, N).m);
  const float pre = warp_exclusive(local, &tot);
  float rgb[3] = {0.f, 0.f, 0.f};
  float run = pre;
  for (int k = k0; k < k1; ++k) {
    const Sample s = sample_at(out8, x16, R, base + k, k, N);
    const float w = s.alpha * expf(run);
    run += logf(s.m);
    for (int c = 0; c < 3; ++c) rgb[c] += w * out8[c * R + base + k];
  }
  float d_rgb[3], loss = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float err = warp_sum(rgb[c]) - x16[(8 + c) * R + base];
    loss += err * err;
    d_rgb[c] = 2.f * scale * err;
  }
  if (lane == 0) loss_ray[b] = loss * scale;

  // suffix sums of y = d_w * w: sum_{i > k} y_i = total - inclusive prefix
  local = 0.f;
  run = pre;
  for (int k = k0; k < k1; ++k) {
    const Sample s = sample_at(out8, x16, R, base + k, k, N);
    const float w = s.alpha * expf(run);
    run += logf(s.m);
    float d_w = 0.f;
    for (int c = 0; c < 3; ++c) d_w += out8[c * R + base + k] * d_rgb[c];
    local += d_w * w;
  }
  float ytot;
  float ypre = warp_exclusive(local, &ytot);
  run = pre;
  for (int k = k0; k < k1; ++k) {
    const long long col = base + k;
    const Sample s = sample_at(out8, x16, R, col, k, N);
    const float T = expf(run), w = s.alpha * T;
    run += logf(s.m);
    float d_w = 0.f;
    for (int c = 0; c < 3; ++c) {
      d_w += out8[c * R + col] * d_rgb[c];
      g[c * R + col] = w * d_rgb[c];
    }
    ypre += d_w * w;
    const float suffix = ytot - ypre;
    const float d_alpha = d_w * T - (1.f - s.alpha > 1e-10f ? suffix / s.m : 0.f);
    const float sig = out8[3 * R + col];
    g[3 * R + col] = d_alpha * s.e * s.delta / (1.f + expf(-sig));
  }
}

// loss = sum of loss_ray, one block, fixed order.
__global__ void sum_kernel(const float *__restrict__ v, int n, float *out) {
  __shared__ float part[1024];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += v[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int d = blockDim.x / 2; d > 0; d /= 2) {
    if (threadIdx.x < d) part[threadIdx.x] += part[threadIdx.x + d];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = part[0];
}

struct StepScratch {
  float *out8, *g, *loss_ray;
};

StepScratch step_scratch(void *workspace, const Workspace &ws, long long rows) {
  char *p = static_cast<char *>(workspace) + ws.bytes;
  const long long a = align256(4LL * 8 * rows), b = align256(4LL * 4 * rows);
  return StepScratch{reinterpret_cast<float *>(p), reinterpret_cast<float *>(p + a),
                     reinterpret_cast<float *>(p + a + b)};
}

}  // namespace

extern "C" {

// Bytes of the workspace fused_train_step needs.
long long fused_train_step_workspace_bytes(long long rows, int N, int Lp, int Ld, int H,
                                           int is_bf16) {
  return carve(nullptr, rows, Lp, Ld, H, is_bf16).bytes + align256(4LL * 8 * rows) +
         align256(4LL * 4 * rows) + align256(4LL * (rows / N));
}

long long fused_train_step_smem_bytes(int Lp, int Ld, int H, int is_bf16) {
  const long long f = fwd_smem(Lp, Ld, H, is_bf16), b = bwd_smem(H, is_bf16);
  return f > b ? f : b;
}

// Launches on `stream`; returns the first CUDA error (0 on success).
// `loss` is one f32 on the device.
int fused_train_step(const float *x16, long long rows, int N, int Lp, int Ld, int H,
                     int is_bf16, Weights w, WeightsT wt, void *workspace, float *loss,
                     Grads out, void *stream) {
  if (!arch_ok(Lp, Ld, H) || N <= 0 || rows <= 0 || rows % N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)(rows / N);
  const Workspace ws = carve(workspace, rows, Lp, Ld, H, is_bf16);
  const StepScratch sc = step_scratch(workspace, ws, rows);
  if (int e = forward(x16, sc.out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, s)) return e;
  const int rays_per_block = THREADS / 32;
  composite_grad<<<(B + rays_per_block - 1) / rays_per_block, THREADS, 0, s>>>(
      sc.out8, x16, B, N, 1.f / (3.f * B), sc.g, sc.loss_ray);
  sum_kernel<<<1, 1024, 0, s>>>(sc.loss_ray, B, loss);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return backward(sc.g, rows, Lp, Ld, H, is_bf16, w, wt, ws.res, ws.gws, ws.image, ws.part, out, s);
}

}  // extern "C"
