// Device code shared by the fused NeRF MLP kernels for Hopper (sm_90a):
// the forward tile kernels (csrc/fused_mlp_fwd.cu, the eval render and
// the first pass of the two training entries; f32 in csrc/fwd_f32.cuh,
// bf16 in csrc/fwd_bf16.cuh) and the backward tile kernels (f32 below,
// bf16 in csrc/bwd_bf16.cuh), with the backward's task table for the
// weight-gradient sums (csrc/wgrad.cuh).
//
// Layout (the TPU kernels' packed layout, kernels/mlp.py::pack_weights):
// activations feature-major (features, rows); weights (out, in)
// row-major, matrices in the compute type (f32 or bf16), biases f32.
//
// sin/cos: the encoder evaluates sin(2^(L-1) x) at thousands of radians,
// so this code uses the accurate sincosf (never __sinf/__cosf) and must
// not be built with --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad.cuh"

// Field order of pack_weights' FusedWeights. Outside the anonymous
// namespace: the extern "C" entries take it, and a parameter type with
// internal linkage would give an entry internal linkage (no symbol).
struct Weights {
  const void *W1, *b1, *Wt1, *bt1, *Wt2, *bt2, *Wt3, *bt3, *Wt4, *bt4;
  const void *Wsh, *Wsx, *bs, *Wp0, *bp0, *Wp1, *bp1;
  const void *Wcs, *bcs, *Wcd, *Wc1, *bc1;
};

// Transposes (in, out) of the matrices the f32 backward multiplies a
// cotangent by (kernels/mlp.py::_transposed); the bf16 backward reads
// Weights and transposes into its weight image instead.
struct WeightsT {
  const void *Wc1T, *WcsT, *Wp1T, *Wp0T, *WshT, *Wt4T, *Wt3T, *Wt2T, *Wt1T;
};

// Weight and bias gradients, f32, in the shapes of Weights.
struct Grads {
  float *W1, *b1, *Wt1, *bt1, *Wt2, *bt2, *Wt3, *bt3, *Wt4, *bt4;
  float *Wsh, *Wsx, *bs, *Wp0, *bp0, *Wp1, *bp1;
  float *Wcs, *bcs, *Wcd, *Wc1, *bc1;
};

namespace {

constexpr int TR = 64;        // sample rows per block of the tile kernels
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_H = 256;    // widest layer the shared-memory plan holds

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int ceil8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int enc_rows(int L) { return 8 + 2 * ceil8(3 * L); }
__host__ __device__ inline long long align256(long long b) { return (b + 255) / 256 * 256; }

__device__ __forceinline__ float bias(const void *b, int o) {
  return static_cast<const float *>(b)[o];
}

// ----------------------------------------------------------------------
// Workspace of the backward: the forward's residuals and the backward's
// cotangents, each a (features, Rp) plane in the compute type, Rp = rows
// rounded up to a whole tile. Pad rows hold finite residuals and zero
// cotangents, so they add nothing to a weight gradient.
struct Layout {
  int FX, FD, H, H2;
  long long Rp;
  // residual planes (feature offsets): posx, posd, h0..h7, hc
  __host__ __device__ int posx() const { return 0; }
  __host__ __device__ int posd() const { return FX; }
  __host__ __device__ int h(int l) const { return FX + FD + l * H; }
  __host__ __device__ int hc() const { return FX + FD + 8 * H; }
  __host__ __device__ int FA() const { return FX + FD + 8 * H + H2; }
  // cotangent planes: g_rgb8 (8), g_cs = [g_hc ; g_sigma ; 0 x 7], g_h7..g_h0
  __host__ __device__ int gr8() const { return 0; }
  __host__ __device__ int gcs() const { return 8; }
  __host__ __device__ int gh(int l) const { return 16 + H2 + (7 - l) * H; }
  __host__ __device__ int FG() const { return 16 + H2 + 8 * H; }
};

__host__ __device__ inline Layout make_layout(long long rows, int Lp, int Ld, int H) {
  return Layout{enc_rows(Lp), enc_rows(Ld), H, H / 2, (rows + TR - 1) / TR * TR};
}

// ----------------------------------------------------------------------
// The f32 backward tile kernel: SIMT FMA. Activations [feature][row].
// Thread (to, tr) owns features to + 32i (i = 0..7) and rows tr*4 +
// {0..3}, 32 + tr*4 + {0..3}.
namespace f32 {

// Weights stream through two shared buffers [o][k] of KS_F32 columns,
// filled with cp.async: the next slice's copy is in flight while the
// current one is multiplied. Rows of 20 words: 16-byte aligned for the
// copies and for float4 reads along k, and the four features a warp reads
// at once (to..to+3) land on distinct banks.
constexpr int KS_F32 = 16;
constexpr int WS_LD = KS_F32 + 4;

__device__ __forceinline__ int row_of(int tr, int j) {
  return (j < 4 ? 0 : 32 - 4) + tr * 4 + j;
}

// Start copying W[:O, k0:k0+KS_F32] into buf (columns past K are skipped:
// the multiply stops at K).
__device__ void stage(const float *__restrict__ W, int O, int K, int k0, float *buf) {
  for (int idx = threadIdx.x; idx < O * (KS_F32 / 4); idx += THREADS) {
    const int o = idx / (KS_F32 / 4), c = (idx % (KS_F32 / 4)) * 4;
    if (k0 + c < K) cp_async16(buf + o * WS_LD + c, W + (long long)o * K + k0 + c);
  }
  cp_async_commit();
}

// acc[i][j] += sum_k W[to + 32i][k] * in[k][row_of(j)] over the first O
// rows of W (O, K), K a multiple of 8. Features past O read row O - 1
// (their sums are never stored). Ws holds two buffers of wsz floats.
// Starts with a barrier, so the caller's stores to `in` are visible and
// nobody still reads Ws; ends with one, so `in` may be overwritten.
__device__ void mm_acc(const float *__restrict__ W, int O, int K,
                       const float *in, float *Ws, int wsz, float acc[8][8],
                       int to, int tr) {
  int wrow[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) wrow[i] = min(to + 32 * i, O - 1) * WS_LD;
  const int ns = (K + KS_F32 - 1) / KS_F32;
  __syncthreads();
  stage(W, O, K, 0, Ws);
  for (int s = 0; s < ns; ++s) {
    const float *cur = Ws + (s & 1) * wsz;
    if (s + 1 < ns) {
      stage(W, O, K, (s + 1) * KS_F32, Ws + ((s + 1) & 1) * wsz);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = s * KS_F32, kn = min(KS_F32, K - k0);  // kn: 8 or 16
    if (to < O) {
      for (int kk = 0; kk < kn; kk += 4) {
        float4 w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = *reinterpret_cast<const float4 *>(cur + wrow[i] + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float *row = in + (k0 + kk + q) * TR + tr * 4;
          const float4 a0 = *reinterpret_cast<const float4 *>(row);
          const float4 a1 = *reinterpret_cast<const float4 *>(row + 32);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float wi = q == 0 ? w[i].x : q == 1 ? w[i].y : q == 2 ? w[i].z : w[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wi, a[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // everyone is done with cur before it is refilled
  }
}

// Backward epilogue: g[o][r] = acc * (h[o][row0 + r] > 0) for o < O, into
// shared `out` and the cotangent plane gout[o][row0 + r]. Resets acc.
__device__ void mask_store(float acc[8][8], int O, const float *h, float *out,
                           float *gout, long long Rp, long long row0, int to, int tr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = to + 32 * i;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (o < O) {
        const long long at = o * Rp + row0 + row_of(tr, half * 4);
        const float4 m = *reinterpret_cast<const float4 *>(h + at);
        const float mk[4] = {m.x, m.y, m.z, m.w};
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = mk[j] > 0.f ? acc[i][half * 4 + j] : 0.f;
          out[o * TR + row_of(tr, half * 4 + j)] = v[j];
        }
        *reinterpret_cast<float4 *>(gout + at) = make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][half * 4 + j] = 0.f;
    }
  }
}

// Backward of one 64-row tile: from the output cotangents g (rows 0..2
// d_rgb, row 3 d_sigma; stride `rows`) back to every layer's
// pre-activation cotangent, each written to its plane of `gws`. Masks
// come from the residual planes of `res`.
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const float *__restrict__ g, long long rows, int Lp, int Ld,
               int H, WeightsT wt, const float *res, float *gws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(rows, Lp, Ld, H);
  const int H2 = L.H2;
  const long long Rp = L.Rp;
  float *P = reinterpret_cast<float *>(smem);
  float *Q = P + H * TR;
  float *Ws = Q + H * TR;
  const int wsz = H * WS_LD;
  const long long row0 = (long long)blockIdx.x * TR;
  const int to = threadIdx.x >> 3, tr = threadIdx.x & 7;
  auto Wm = [](const void *p) { return static_cast<const float *>(p); };

  // g_rgb8 -> P; then [g_sigma ; 0 x 7] -> Q rows H2..H2+7 (the sigma
  // rows of g_cs). Both also to their planes.
  for (int idx = threadIdx.x; idx < 8 * TR; idx += THREADS) {
    const int k = idx / TR, r = idx % TR;
    const bool in = row0 + r < rows;
    const float vr = k < 3 && in ? g[k * rows + row0 + r] : 0.f;
    const float vs = k == 0 && in ? g[3 * rows + row0 + r] : 0.f;
    P[idx] = vr;
    gws[(L.gr8() + k) * Rp + row0 + r] = vr;
    Q[(H2 + k) * TR + r] = vs;
    gws[(L.gcs() + H2 + k) * Rp + row0 + r] = vs;
  }
  float acc[8][8] = {};
  mm_acc(Wm(wt.Wc1T), H2, 8, P, Ws, wsz, acc, to, tr);
  mask_store(acc, H2, res + L.hc() * Rp, Q, gws + L.gcs() * Rp, Rp, row0, to, tr);
  mm_acc(Wm(wt.WcsT), H, H2 + 8, Q, Ws, wsz, acc, to, tr);
  mask_store(acc, H, res + L.h(7) * Rp, P, gws + L.gh(7) * Rp, Rp, row0, to, tr);
  const void *chain[7] = {wt.Wp1T, wt.Wp0T, wt.WshT, wt.Wt4T, wt.Wt3T, wt.Wt2T, wt.Wt1T};
  for (int l = 6; l >= 0; --l) {  // g_h(l) = mask(h_l) * W^T g_h(l+1); g_h7 is in P
    const float *src = l % 2 == 0 ? P : Q;
    float *dst = l % 2 == 0 ? Q : P;
    mm_acc(Wm(chain[6 - l]), H, H, src, Ws, wsz, acc, to, tr);
    mask_store(acc, H, res + L.h(l) * Rp, dst, gws + L.gh(l) * Rp, Rp, row0, to, tr);
  }
}

long long bwd_smem_bytes(int H) { return 4LL * (2 * H * TR + 2 * H * WS_LD); }

}  // namespace f32

#include "fwd_bf16.cuh"  // fb: the bf16 forward tile kernel
#include "fwd_f32.cuh"   // ff: the f32 forward tile kernel (uses fb's ring helpers)
#include "bwd_bf16.cuh"  // bb: the bf16 backward tile kernel

// ----------------------------------------------------------------------
// The twelve weight-gradient sums of the backward, as csrc/wgrad.cuh
// takes them: cotangent plane gf (O features) of gws against residual
// plane af (K features) of res (element size es; null for sizing), into
// dW and db.
void wgrad_tasks(const Layout &L, const Grads &out, const void *res, const void *gws,
                 long long es, WTask w[12]) {
  struct Task { int gf, O, af, K; float *dW, *db; };
  const int H = L.H, H2 = L.H2;
  const Task t[12] = {
      {L.gr8(), 8, L.hc(), H2, out.Wc1, out.bc1},
      {L.gcs(), H2, L.posd(), L.FD, out.Wcd, nullptr},
      {L.gcs(), H2 + 8, L.h(7), H, out.Wcs, out.bcs},
      {L.gh(7), H, L.h(6), H, out.Wp1, out.bp1},
      {L.gh(6), H, L.h(5), H, out.Wp0, out.bp0},
      {L.gh(5), H, L.h(4), H, out.Wsh, out.bs},
      {L.gh(5), H, L.posx(), L.FX, out.Wsx, nullptr},
      {L.gh(4), H, L.h(3), H, out.Wt4, out.bt4},
      {L.gh(3), H, L.h(2), H, out.Wt3, out.bt3},
      {L.gh(2), H, L.h(1), H, out.Wt2, out.bt2},
      {L.gh(1), H, L.h(0), H, out.Wt1, out.bt1},
      {L.gh(0), H, L.posx(), L.FX, out.W1, out.b1},
  };
  for (int i = 0; i < 12; ++i) {
    const char *g = gws ? static_cast<const char *>(gws) + es * t[i].gf * L.Rp : nullptr;
    const char *a = res ? static_cast<const char *>(res) + es * t[i].af * L.Rp : nullptr;
    w[i] = WTask{g, a, t[i].O, t[i].K, t[i].dW, t[i].db};
  }
}

// Launches of the backward tile kernels by this library (each source that
// includes this header is its own library), counted where they launch.
long long bwd_tile_launches = 0;

// Bytes of the scratch `image` that bwd_tile() needs (bf16: the backward
// weight image; f32 reads none).
long long bwd_image_bytes(int H, int is_bf16) { return is_bf16 ? bb::Plan{H}.image_bytes() : 0; }

// The backward tile kernel of the compute type: from the output
// cotangents g (rows 0..2 d_rgb, row 3 d_sigma; stride `rows`) and the
// residual planes `res` to every cotangent plane of `gws` (Layout). bf16
// builds its weight image from `w` in `image` (bwd_image_bytes); f32
// multiplies by the transposes `wt`.
int bwd_tile(const float *g, long long rows, int Lp, int Ld, int H, bool is_bf16, const Weights &w,
             const WeightsT &wt, const void *res, void *gws, void *image, cudaStream_t stream) {
  int e;
  if (is_bf16) {
    e = bb::launch(g, rows, Lp, Ld, H, w, static_cast<const bf16 *>(res), static_cast<bf16 *>(gws), image,
                   stream);
  } else {
    const Layout L = make_layout(rows, Lp, Ld, H);
    const long long smem = f32::bwd_smem_bytes(H);
    e = (int)cudaFuncSetAttribute(f32::bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
    f32::bwd_kernel<<<(unsigned)(L.Rp / TR), THREADS, smem, stream>>>(
        g, rows, Lp, Ld, H, wt, static_cast<const float *>(res), static_cast<float *>(gws));
    e = (int)cudaGetLastError();
  }
  if (e == 0) ++bwd_tile_launches;
  return e;
}

// Backward from output cotangents: the tile kernel, then the twelve
// weight-gradient sums. `res` holds the forward's residuals; gws, image
// and part are scratch.
int backward(const float *g, long long rows, int Lp, int Ld, int H, bool is_bf16, const Weights &w,
             const WeightsT &wt, void *res, void *gws, void *image, float *part, const Grads &out,
             cudaStream_t stream) {
  if (int e = bwd_tile(g, rows, Lp, Ld, H, is_bf16, w, wt, res, gws, image, stream)) return e;
  const Layout L = make_layout(rows, Lp, Ld, H);
  WTask tasks[12];
  wgrad_tasks(L, out, res, gws, is_bf16 ? 2 : 4, tasks);
  return wgrad_launch(tasks, 12, L.Rp, is_bf16, part, stream);
}

// Forward of all rows through the tile kernel of the compute type; with
// `res`, the residuals are kept. Each builds its weight image in `image`
// (fwd_image_bytes) first.
int forward(const float *x, float *out, long long rows, int Lp, int Ld, int H,
            bool is_bf16, const Weights &w, void *res, void *image, cudaStream_t stream) {
  if (is_bf16) return fb::launch(x, out, rows, Lp, Ld, H, w, static_cast<bf16 *>(res), image, stream);
  return ff::launch(x, out, rows, Lp, Ld, H, w, static_cast<float *>(res), image, stream);
}

long long fwd_smem(int Lp, int Ld, int H, int is_bf16) {
  return is_bf16 ? fb::plan_of(Lp, Ld, H).smem_bytes() : ff::plan_of(Lp, Ld, H).smem_bytes();
}

// Bytes of the scratch `image` that forward() needs.
long long fwd_image_bytes(int Lp, int Ld, int H, int is_bf16) {
  return is_bf16 ? fb::plan_of(Lp, Ld, H).image_bytes() : ff::plan_of(Lp, Ld, H).image_bytes();
}

long long bwd_smem(int H, int is_bf16) {
  return is_bf16 ? bb::Plan{H}.smem_bytes() : f32::bwd_smem_bytes(H);
}

bool arch_ok(int Lp, int Ld, int H) {
  return H % 16 == 0 && H >= 16 && H <= MAX_H && Lp >= 1 && Ld >= 1;
}

// Workspace of the backward, carved from one buffer: residuals, cotangents,
// the weight-gradient partials and the weight image (the forward's, then
// the backward's where bf16 has one: one after the other on the stream),
// each 256-byte aligned.
struct Workspace {
  void *res, *gws;
  float *part;
  void *image;
  long long bytes;
};

Workspace carve(void *base, long long rows, int Lp, int Ld, int H, int is_bf16) {
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long es = is_bf16 ? 2 : 4;
  const long long a = align256(es * L.FA() * L.Rp), b = align256(es * L.FG() * L.Rp);
  WTask tasks[12];
  wgrad_tasks(L, Grads{}, nullptr, nullptr, es, tasks);
  const long long c = align256(4LL * wgrad_part_floats(tasks, 12, L.Rp, is_bf16));
  const long long d = align256(std::max(fwd_image_bytes(Lp, Ld, H, is_bf16), bwd_image_bytes(H, is_bf16)));
  char *p = static_cast<char *>(base);
  return Workspace{p, p + a, reinterpret_cast<float *>(p + a + b), p + a + b + c, a + b + c + d};
}

}  // namespace

extern "C" {

// Launches of the backward tile kernels by this library so far, as
// wgrad_launch_count counts the sums.
long long bwd_tile_launch_count(int reset) {
  const long long n = bwd_tile_launches;
  if (reset) bwd_tile_launches = 0;
  return n;
}

}  // extern "C"
