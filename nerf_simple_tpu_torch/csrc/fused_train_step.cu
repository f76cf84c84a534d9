// Fused NeRF train step for Hopper (sm_90a): forward, compositing, the
// MSE loss and its gradient, and the full backward to the packed weight
// gradients, for one batch of whole rays.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::fused_train_step (the
// pallas_call of _train_kernel -> _forward_tile -> _composite_grad_block
// -> _backprop_tile), point and mip branches, with the optional weights
// output (`out_weights`, which the hierarchical scheme's importance
// sampler and mip's fine level read), the optional distortion rail
// (`dist`, point form and interval form) and, under mip, the optional
// opaque tail (`opaque_tail`, mip-NeRF 360's opaque background).
//
// Contract: x16 (16, B*N) f32 -- rows 0..2 sample xyz, 3..5 unit view
// dir, 6 ts, 8..10 the ray's gt colour on every sample; ray b's samples
// are columns b*N .. b*N + N - 1. Returns loss = sum over rays and
// channels of (rgb_ray - gt)^2 / (3B) and its gradients, f32, packed;
// with a non-null w_out, also each sample's compositing weight, f32, at
// w_out[b*N + k] (a (B, N) row-major array). With dist_on, the loss
// gains dist_scale * sum over rays of the ray's distortion in s-space
// (s = (t - tn) / (tf - tn), or (1/tn - 1/t) / (1/tn - 1/tf) with
// `disparity`): 2 sum_k wm_k (s_k A_k - Bm_k) + sum_k wm_k^2 d_k / 3, with
// wm the weights with the tail sample's set to 0, A and Bm the exclusive
// prefix sums of wm and wm * s, d_k = s_{k+1} - s_k and 0 at the tail;
// dist_scale is the loss weight over B. With dist_on == 0 the kernels do
// exactly what they do without the rail.
//
// Mip (cone casting; train/step.py::build_x16_mip): rows 0..2 hold the
// frustum Gaussians' means and 11..13 their diagonal variances, which the
// forward's integrated encoder reads; row 6 holds each interval's width,
// composited as the delta itself (no 1e10 tail, so acc < 1 where light
// passes), row 7 its near edge t0, row 14 the ray's loss weight on its
// samples: the ray's squared error and d_rgb are scaled by it. The rail
// takes its interval form: s_k the midpoint of s(t0) and s(t0 + width),
// d_k = s(t0 + width) - s(t0), and no tail is dropped. With opaque_tail
// the last interval's delta is 1e10 and the rail drops it (wm and d_k 0
// there, its d_w term 0), though compositing keeps it.
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
// d_w * w for the suffix sums of the alpha gradient, and, with the rail,
// of wm and wm * s) come from a warp shuffle scan over the lanes' partial
// sums; the ray's totals give the rail's suffix sums.
// The TPU kernel's segment matrix and lane rolls have no counterpart
// here. The loss sums per-ray terms in a fixed order, so the whole step
// is bitwise deterministic.

#include "composite.cuh"
#include "mlp_tile.cuh"

namespace {

// The distortion rail's parameters: s = (t - a) / den, or with
// `disparity` (a - 1 / max(t, 1e-10)) / den; and the compositing's form
// (`mip`: intervals; `opaque`: the last interval's delta is 1e10).
struct DistRail {
  int on, disparity;
  float scale, a, den;
  bool mip, opaque;
  // the rail drops the tail sample in point form, and the last interval
  // under an opaque tail
  __device__ bool drops(int k, int N) const { return k == N - 1 && (!mip || opaque); }
};

__device__ __forceinline__ float s_of(const DistRail &d, float t) {
  return d.disparity ? (d.a - 1.f / fmaxf(t, 1e-10f)) / d.den : (t - d.a) / d.den;
}

// The rail's position of sample k at column `col` in s-space, and with
// `ds` its width: point form, s(t_k) and s(t_{k+1}) - s(t_k) (not read at
// the tail, which the rail drops); interval form, the midpoint of s(t0)
// and s(t0 + width) and their difference.
__device__ __forceinline__ float rail_pos(const DistRail &d, const float *x16, long long R, long long col,
                                          int k, int N, float *ds) {
  if (d.mip) {
    const float t0 = x16[7 * R + col], s0 = s_of(d, t0), s1 = s_of(d, t0 + x16[6 * R + col]);
    if (ds) *ds = s1 - s0;
    return 0.5f * (s0 + s1);
  }
  const float s = s_of(d, x16[6 * R + col]);
  if (ds && k < N - 1) *ds = s_of(d, x16[6 * R + col + 1]) - s;
  return s;
}

// The rail at sample k of a ray at column `col` with weight w: advances
// the inclusive prefixes *A, *Bm (of wm and wm * s) and returns the
// rail's d_w term (0 where the rail drops the sample), its loss term in
// *dl. atot, btot: the ray's totals of wm and wm * s.
__device__ __forceinline__ float dist_grad(const DistRail &d, const float *x16, long long R,
                                           long long col, int k, int N, float w, float atot,
                                           float btot, float *A, float *Bm, float *dl) {
  if (d.drops(k, N)) {  // wm = 0 and d_s = 0, so it adds nothing
    *dl = 0.f;
    return 0.f;
  }
  float ds;
  const float s = rail_pos(d, x16, R, col, k, N, &ds);
  const float cross = s * *A - *Bm;  // exclusive prefixes
  *A += w;
  *Bm += w * s;
  *dl = w * (2.f * cross) + w * w * ds / 3.f;
  return 2.f * (cross + (btot - *Bm) - s * (atot - *A)) + (2.f / 3.f) * w * ds;
}

// One warp a ray: g (4, R) gets w * d_rgb in rows 0..2 and d_sigma in row
// 3; loss_ray[b] the ray's share of the loss; w_out, where not null, the
// weights w; with dist.on, the distortion rail in the loss and in d_w;
// dist.mip and dist.opaque choose the compositing's form.
__global__ void __launch_bounds__(THREADS)
    composite_grad(const float *__restrict__ out8, const float *__restrict__ x16,
                   int B, int N, float scale, float *__restrict__ g,
                   float *__restrict__ loss_ray, float *__restrict__ w_out, const DistRail dist) {
  const int b = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const long long R = (long long)B * N, base = (long long)b * N;
  const int per = (N + 31) / 32, k0 = min(N, lane * per), k1 = min(N, k0 + per);
  const bool mip = dist.mip, opq = dist.opaque;

  // transmittance: exclusive prefix of log m over the ray
  float local = 0.f, tot;
  for (int k = k0; k < k1; ++k) local += logf(sample_at(out8, x16, R, base + k, k, N, mip, opq).m);
  const float pre = warp_exclusive(local, &tot);
  float rgb[3] = {0.f, 0.f, 0.f};
  float run = pre, la = 0.f, lb = 0.f;  // the rail's partial sums of wm and wm * s
  for (int k = k0; k < k1; ++k) {
    const Sample s = sample_at(out8, x16, R, base + k, k, N, mip, opq);
    const float w = s.alpha * expf(run);
    run += logf(s.m);
    for (int c = 0; c < 3; ++c) rgb[c] += w * out8[c * R + base + k];
    if (w_out) w_out[base + k] = w;
    if (dist.on && !dist.drops(k, N)) {
      la += w;
      lb += w * rail_pos(dist, x16, R, base + k, k, N, nullptr);
    }
  }
  const float lw = mip ? x16[14 * R + base] : 1.f;  // the ray's loss weight under mip
  float d_rgb[3], loss = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float err = warp_sum(rgb[c]) - x16[(8 + c) * R + base];
    if (mip) {
      loss += lw * err * err;
      d_rgb[c] = 2.f * scale * lw * err;
    } else {
      loss += err * err;
      d_rgb[c] = 2.f * scale * err;
    }
  }
  if (lane == 0) loss_ray[b] = loss * scale;
  float a_pre = 0.f, b_pre = 0.f, atot = 0.f, btot = 0.f;
  if (dist.on) {  // uniform over the warp
    a_pre = warp_exclusive(la, &atot);
    b_pre = warp_exclusive(lb, &btot);
  }

  // suffix sums of y = d_w * w: sum_{i > k} y_i = total - inclusive prefix
  local = 0.f;
  run = pre;
  float A = a_pre, Bm = b_pre, dl, dist_loss = 0.f;
  for (int k = k0; k < k1; ++k) {
    const Sample s = sample_at(out8, x16, R, base + k, k, N, mip, opq);
    const float w = s.alpha * expf(run);
    run += logf(s.m);
    float d_w = 0.f;
    for (int c = 0; c < 3; ++c) d_w += out8[c * R + base + k] * d_rgb[c];
    if (dist.on) {
      d_w += dist.scale * dist_grad(dist, x16, R, base + k, k, N, w, atot, btot, &A, &Bm, &dl);
      dist_loss += dl;
    }
    local += d_w * w;
  }
  if (dist.on) {
    dist_loss = warp_sum(dist_loss);
    if (lane == 0) loss_ray[b] = loss * scale + dist.scale * dist_loss;
  }
  float ytot;
  float ypre = warp_exclusive(local, &ytot);
  run = pre;
  A = a_pre;
  Bm = b_pre;
  for (int k = k0; k < k1; ++k) {
    const long long col = base + k;
    const Sample s = sample_at(out8, x16, R, col, k, N, mip, opq);
    const float T = expf(run), w = s.alpha * T;
    run += logf(s.m);
    float d_w = 0.f;
    for (int c = 0; c < 3; ++c) {
      d_w += out8[c * R + col] * d_rgb[c];
      g[c * R + col] = w * d_rgb[c];
    }
    if (dist.on) d_w += dist.scale * dist_grad(dist, x16, R, col, k, N, w, atot, btot, &A, &Bm, &dl);
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
// `loss` is one f32 on the device. `wt` is not read (mlp_tile.cuh's
// WeightsT). `w_out` (rows f32) may be null: then no weight is stored.
// With dist_on, the distortion rail (see the contract above) with
// dist_scale = its loss weight / B, the near and far distances tn < tf,
// and `disparity` for s in 1/t (then tn > 0). `mip` and `opaque_tail`
// (which needs `mip`): the cone-cast path of the contract above.
int fused_train_step(const float *x16, long long rows, int N, int Lp, int Ld, int H,
                     int is_bf16, Weights w, WeightsT wt, void *workspace, float *loss,
                     Grads out, float *w_out, int dist_on, float dist_scale, float tn, float tf,
                     int disparity, int mip, int opaque_tail, void *stream) {
  if (!arch_ok(Lp, Ld, H) || N <= 0 || rows <= 0 || rows % N) return (int)cudaErrorInvalidValue;
  if (dist_on && !(tf > tn && (!disparity || tn > 0.f))) return (int)cudaErrorInvalidValue;
  if (opaque_tail && !mip) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = (int)(rows / N);
  DistRail dist{dist_on != 0, disparity != 0, dist_scale, 0.f, 1.f, mip != 0, opaque_tail != 0};
  if (dist.on) {  // the constants in double, rounded once, as the plain version's
    dist.a = disparity ? (float)(1.0 / tn) : tn;
    dist.den = disparity ? (float)(1.0 / tn - 1.0 / tf) : (float)((double)tf - tn);
  }
  const Workspace ws = carve(workspace, rows, Lp, Ld, H, is_bf16);
  const StepScratch sc = step_scratch(workspace, ws, rows);
  if (int e = forward(x16, sc.out8, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.image, mip != 0, nullptr, nullptr, s))
    return e;
  const int rays_per_block = THREADS / 32;
  composite_grad<<<(B + rays_per_block - 1) / rays_per_block, THREADS, 0, s>>>(
      sc.out8, x16, B, N, 1.f / (3.f * B), sc.g, sc.loss_ray, w_out, dist);
  sum_kernel<<<1, 1024, 0, s>>>(sc.loss_ray, B, loss);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  return backward(sc.g, rows, Lp, Ld, H, is_bf16, w, ws.res, ws.gws, ws.image, ws.part, out, s);
}

}  // extern "C"
