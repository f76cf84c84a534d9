// Device code shared by the fused NeRF MLP kernels for Hopper (sm_90a):
// the forward tile kernels (csrc/fused_mlp_fwd.cu, and the first pass of
// the two training entries), the backward tile kernels, the weight-
// gradient reduction and the compositing pass of the train step.
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

#include <algorithm>

// Field order of pack_weights' FusedWeights. Outside the anonymous
// namespace: the extern "C" entries take it, and a parameter type with
// internal linkage would give an entry internal linkage (no symbol).
struct Weights {
  const void *W1, *b1, *Wt1, *bt1, *Wt2, *bt2, *Wt3, *bt3, *Wt4, *bt4;
  const void *Wsh, *Wsx, *bs, *Wp0, *bp0, *Wp1, *bp1;
  const void *Wcs, *bcs, *Wcd, *Wc1, *bc1;
};

// Transposes (in, out) of the matrices the backward multiplies a
// cotangent by, in the compute type (kernels/mlp.py::_transposed).
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
__host__ __device__ inline int ceil32(int n) { return (n + 31) / 32 * 32; }
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

// Encoded feature k (< F) of one branch for one sample, in the TPU
// kernel's row order: 0..2 raw, 3..7 zero, then the sin block (8 + L*c + i
// = sin(2^i x_c)) and the cos block, each padded to a multiple of 8.
__device__ float encoded(const float *__restrict__ x, long long rows,
                         long long row, int L, int col0, int k) {
  const int sb = ceil8(3 * L);
  if (k < 3) return x[(long long)(col0 + k) * rows + row];
  if (k < 8) return 0.f;
  int j = k - 8;
  const bool is_cos = j >= sb;
  if (is_cos) j -= sb;
  if (j >= 3 * L) return 0.f;
  const int c = j / L, i = j % L;
  float s, co;
  sincosf(ldexpf(x[(long long)(col0 + c) * rows + row], i), &s, &co);
  return is_cos ? co : s;
}

// The heads, one output per thread: j = 0..2 rgb from hc (Wc1 rows 0..2),
// j = 3 sigma from h7 (Wcs row H/2); bias added after the sum. hc[r] and
// h7[r] address sample r's features with a stride of `ks` elements.
template <typename T>
__device__ void heads(const Weights &w, const T *hc, const T *h7, int rs,
                      int ks, int H, float *__restrict__ out, long long rows,
                      long long row0) {
  const int H2 = H / 2;
  const int j = threadIdx.x / TR, r = threadIdx.x % TR;
  const T *h = (j < 3 ? hc : h7) + r * rs;
  const T *wr = j < 3 ? static_cast<const T *>(w.Wc1) + j * H2
                      : static_cast<const T *>(w.Wcs) + (long long)H2 * H;
  const int K = j < 3 ? H2 : H;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(float(wr[k]), float(h[k * ks]), s);
  s += j < 3 ? bias(w.bc1, j) : bias(w.bcs, H2);
  const long long row = row0 + r;
  if (row < rows) {
    out[(long long)j * rows + row] = s;
    out[(long long)(4 + j) * rows + row] = 0.f;
  }
}

// ----------------------------------------------------------------------
// f32: SIMT FMA. Activations [feature][row]. Thread (to, tr) owns
// features to + 32i (i = 0..7) and rows tr*4 + {0..3}, 32 + tr*4 + {0..3}.
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

// pos[k][r] for k < F; with `res`, also the residual plane res[k][row0 + r].
__device__ void encode(const float *__restrict__ x, long long rows,
                       long long row0, int L, int col0, float *pos,
                       float *res, long long Rp) {
  const int F = enc_rows(L);
  for (int idx = threadIdx.x; idx < F * TR; idx += THREADS) {
    const int k = idx / TR, r = idx % TR;
    pos[idx] = row0 + r < rows ? encoded(x, rows, row0 + r, L, col0, k) : 0.f;
    if (res) res[k * Rp + row0 + r] = pos[idx];
  }
}

__device__ __forceinline__ void cp_async16(float *dst, const float *src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Start copying W[:O, k0:k0+KS_F32] into buf (columns past K are skipped:
// the multiply stops at K).
__device__ void stage(const float *__restrict__ W, int O, int K, int k0, float *buf) {
  for (int idx = threadIdx.x; idx < O * (KS_F32 / 4); idx += THREADS) {
    const int o = idx / (KS_F32 / 4), c = (idx % (KS_F32 / 4)) * 4;
    if (k0 + c < K) cp_async16(buf + o * WS_LD + c, W + (long long)o * K + k0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
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
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
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

// out[o][r] = relu(acc + b[o]) for the thread's features o < O; with
// `res`, also the residual plane res[o][row0 + r]. Resets acc.
__device__ void relu_store(float acc[8][8], const void *b, int O, float *out,
                           float *res, long long Rp, long long row0, int to, int tr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = to + 32 * i;
    const float bi = o < O ? bias(b, o) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(acc[i][half * 4 + j] + bi, 0.f);
        if (o < O) out[o * TR + row_of(tr, half * 4 + j)] = v[j];
        acc[i][half * 4 + j] = 0.f;
      }
      if (res && o < O)
        *reinterpret_cast<float4 *>(res + o * Rp + row0 + row_of(tr, half * 4)) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
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

// Forward of one 64-row tile. With `res`, every residual the backward
// needs (posx, posd, h0..h7, hc) is also written to its plane.
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const float *__restrict__ x, float *__restrict__ out,
               long long rows, int Lp, int Ld, int H, Weights w, float *res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(rows, Lp, Ld, H);
  const int FX = L.FX, FD = L.FD, H2 = L.H2;
  const long long Rp = L.Rp;
  float *A = reinterpret_cast<float *>(smem);
  float *B = A + H * TR;
  float *posx = B + H * TR;
  float *posd = posx + FX * TR;
  float *Ws = posd + FD * TR;  // two buffers of H x WS_LD
  const int wsz = H * WS_LD;
  const long long row0 = (long long)blockIdx.x * TR;
  const int to = threadIdx.x >> 3, tr = threadIdx.x & 7;
  auto Wm = [](const void *p) { return static_cast<const float *>(p); };
  auto plane = [&](int f) { return res ? res + f * Rp : nullptr; };

  encode(x, rows, row0, Lp, 0, posx, plane(L.posx()), Rp);
  encode(x, rows, row0, Ld, 3, posd, plane(L.posd()), Rp);
  float acc[8][8] = {};
  mm_acc(Wm(w.W1), H, FX, posx, Ws, wsz, acc, to, tr);
  relu_store(acc, w.b1, H, A, plane(L.h(0)), Rp, row0, to, tr);   // h0 -> A
  mm_acc(Wm(w.Wt1), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt1, H, B, plane(L.h(1)), Rp, row0, to, tr);  // h1 -> B
  mm_acc(Wm(w.Wt2), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt2, H, A, plane(L.h(2)), Rp, row0, to, tr);  // h2 -> A
  mm_acc(Wm(w.Wt3), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt3, H, B, plane(L.h(3)), Rp, row0, to, tr);  // h3 -> B
  mm_acc(Wm(w.Wt4), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt4, H, A, plane(L.h(4)), Rp, row0, to, tr);  // h4 -> A
  mm_acc(Wm(w.Wsh), H, H, A, Ws, wsz, acc, to, tr);               // skip: [h4 | posx]
  mm_acc(Wm(w.Wsx), H, FX, posx, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bs, H, B, plane(L.h(5)), Rp, row0, to, tr);   // h5 -> B
  mm_acc(Wm(w.Wp0), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bp0, H, A, plane(L.h(6)), Rp, row0, to, tr);  // h6 -> A
  mm_acc(Wm(w.Wp1), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bp1, H, B, plane(L.h(7)), Rp, row0, to, tr);  // h7 -> B
  mm_acc(Wm(w.Wcs), H2, H, B, Ws, wsz, acc, to, tr);              // folded colour rows
  mm_acc(Wm(w.Wcd), H2, FD, posd, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bcs, H2, A, plane(L.hc()), Rp, row0, to, tr); // hc -> A
  __syncthreads();
  heads<float>(w, A, B, 1, TR, H, out, rows, row0);
}

long long fwd_smem_bytes(int Lp, int Ld, int H) {
  return 4LL * (TR * (2 * H + enc_rows(Lp) + enc_rows(Ld)) + 2 * H * WS_LD);
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

// ----------------------------------------------------------------------
// bf16: tensor cores. Activations [row][feature] with padded strides;
// warp w owns output features 32w..32w+31 (two m16 tiles) x all 64 rows
// (eight n8 tiles): acc[mt][nt] is an m16n8 f32 fragment.
namespace tc {

constexpr int KS = 32;       // K-slice of a weight matrix staged per step
constexpr int LDW = KS + 8;  // staged weights [o][k]: 20-word rows, conflict-free

// Row stride (elements) of an activation buffer with F features: F
// padded so that the stride in 32-bit words is 4 mod 8, which puts the
// eight rows of a fragment load in distinct banks.
__host__ __device__ inline int ld(int F) { return F + ((F / 2) % 8 == 4 ? 16 : 8); }

__device__ __forceinline__ uint32_t ld32(const bf16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pos[r][k], k < ld(F); features past F (the stride's pad) are zero, as
// K-steps of 16 read up to 8 of them against zero weights. With `res`,
// also the residual plane res[k][row0 + r], k < F.
__device__ void encode(const float *__restrict__ x, long long rows,
                       long long row0, int L, int col0, bf16 *pos,
                       bf16 *res, long long Rp) {
  const int F = enc_rows(L), lp = ld(F);
  for (int idx = threadIdx.x; idx < TR * lp; idx += THREADS) {
    const int r = idx / lp, k = idx % lp;
    const float v = (row0 + r < rows && k < F) ? encoded(x, rows, row0 + r, L, col0, k) : 0.f;
    pos[idx] = __float2bfloat16_rn(v);
  }
  if (!res) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < F * TR; idx += THREADS) {  // row-fastest: coalesced
    const int k = idx / TR, r = idx % TR;
    res[k * Rp + row0 + r] = pos[r * lp + k];
  }
}

// acc += W[:, :K] @ act^T for this warp's features, over the first O rows
// of W (O, K) row-major. act is [TR][lda]. Weight rows past O (up to the
// warp tile) and columns past K stage as zeros; act must be finite up to
// K rounded to 16. Every K-slice starts with a barrier.
__device__ void mm_acc(const bf16 *__restrict__ W, int O, int K,
                       const bf16 *act, int lda, bf16 *Ws, float acc[2][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ow = warp * 32;
  const int O32 = ceil32(O);
  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < O32 * (KS / 8); idx += THREADS) {
      const int o = idx / (KS / 8), c = (idx % (KS / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (o < O && k0 + c < K)
        v = *reinterpret_cast<const uint4 *>(W + (long long)o * K + k0 + c);
      *reinterpret_cast<uint4 *>(Ws + o * LDW + c) = v;
    }
    __syncthreads();
    if (ow >= O) continue;
    for (int ks = 0; ks < KS && k0 + ks < K; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16 *w0 = Ws + (ow + mt * 16 + g) * LDW + ks + 2 * t;
        a[mt][0] = ld32(w0);
        a[mt][1] = ld32(w0 + 8 * LDW);
        a[mt][2] = ld32(w0 + 8);
        a[mt][3] = ld32(w0 + 8 * LDW + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16 *x0 = act + (nt * 8 + g) * lda + k0 + ks + 2 * t;
        const uint32_t b0 = ld32(x0), b1 = ld32(x0 + 8);
        mma(acc[0][nt], a[0], b0, b1);
        mma(acc[1][nt], a[1], b0, b1);
      }
    }
  }
}

// Calls f(o, r, c) for each of the thread's fragment elements: feature
// o, rows r and r + 1 in c[0] and c[1]; then resets them.
template <typename F>
__device__ __forceinline__ void for_fragments(float acc[2][8][4], F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = warp * 32 + mt * 16 + half * 8 + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float *c = acc[mt][nt] + 2 * half;
        f(o, nt * 8 + 2 * t, c);
        c[0] = c[1] = 0.f;
      }
    }
}

// out[r][o] = bf16(relu(acc + b[o])) for o < O; with `res`, also the
// residual plane res[o][row0 + r]. Resets acc.
__device__ void relu_store(float acc[2][8][4], const void *b, int O, bf16 *out,
                           int ldo, bf16 *res, long long Rp, long long row0) {
  for_fragments(acc, [&](int o, int r, const float *c) {
    if (o >= O) return;
    const float bo = bias(b, o);
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(fmaxf(c[0] + bo, 0.f));
    v.y = __float2bfloat16_rn(fmaxf(c[1] + bo, 0.f));
    out[r * ldo + o] = v.x;
    out[(r + 1) * ldo + o] = v.y;
    if (res) *reinterpret_cast<__nv_bfloat162 *>(res + o * Rp + row0 + r) = v;
  });
}

// Backward epilogue: g[r][o] = bf16(acc * (h[o][row0 + r] > 0)) for o < O,
// into shared `out` and the cotangent plane gout[o][row0 + r]. Resets acc.
__device__ void mask_store(float acc[2][8][4], int O, const bf16 *h, bf16 *out,
                           int ldo, bf16 *gout, long long Rp, long long row0) {
  for_fragments(acc, [&](int o, int r, const float *c) {
    if (o >= O) return;
    const long long at = o * Rp + row0 + r;
    const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162 *>(h + at);
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(__bfloat162float(m.x) > 0.f ? c[0] : 0.f);
    v.y = __float2bfloat16_rn(__bfloat162float(m.y) > 0.f ? c[1] : 0.f);
    out[r * ldo + o] = v.x;
    out[(r + 1) * ldo + o] = v.y;
    *reinterpret_cast<__nv_bfloat162 *>(gout + at) = v;
  });
}

__global__ void __launch_bounds__(THREADS, 2)
    fwd_kernel(const float *__restrict__ x, float *__restrict__ out,
               long long rows, int Lp, int Ld, int H, Weights w, bf16 *res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(rows, Lp, Ld, H);
  const int FX = L.FX, FD = L.FD, H2 = L.H2;
  const long long Rp = L.Rp;
  const int lh = ld(H), lx = ld(FX), lD = ld(FD);
  bf16 *A = reinterpret_cast<bf16 *>(smem);
  bf16 *B = A + TR * lh;
  bf16 *posx = B + TR * lh;
  bf16 *posd = posx + TR * lx;
  bf16 *Ws = posd + TR * lD;  // ceil32(H) x LDW
  const long long row0 = (long long)blockIdx.x * TR;
  auto Wm = [](const void *p) { return static_cast<const bf16 *>(p); };
  auto plane = [&](int f) { return res ? res + f * Rp : nullptr; };

  encode(x, rows, row0, Lp, 0, posx, plane(L.posx()), Rp);
  encode(x, rows, row0, Ld, 3, posd, plane(L.posd()), Rp);
  float acc[2][8][4] = {};
  mm_acc(Wm(w.W1), H, FX, posx, lx, Ws, acc);
  relu_store(acc, w.b1, H, A, lh, plane(L.h(0)), Rp, row0);    // h0 -> A
  mm_acc(Wm(w.Wt1), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bt1, H, B, lh, plane(L.h(1)), Rp, row0);   // h1 -> B
  mm_acc(Wm(w.Wt2), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bt2, H, A, lh, plane(L.h(2)), Rp, row0);   // h2 -> A
  mm_acc(Wm(w.Wt3), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bt3, H, B, lh, plane(L.h(3)), Rp, row0);   // h3 -> B
  mm_acc(Wm(w.Wt4), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bt4, H, A, lh, plane(L.h(4)), Rp, row0);   // h4 -> A
  mm_acc(Wm(w.Wsh), H, H, A, lh, Ws, acc);                     // skip: [h4 | posx]
  mm_acc(Wm(w.Wsx), H, FX, posx, lx, Ws, acc);
  relu_store(acc, w.bs, H, B, lh, plane(L.h(5)), Rp, row0);    // h5 -> B
  mm_acc(Wm(w.Wp0), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bp0, H, A, lh, plane(L.h(6)), Rp, row0);   // h6 -> A
  mm_acc(Wm(w.Wp1), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bp1, H, B, lh, plane(L.h(7)), Rp, row0);   // h7 -> B
  mm_acc(Wm(w.Wcs), H2, H, B, lh, Ws, acc);                    // folded colour rows
  mm_acc(Wm(w.Wcd), H2, FD, posd, lD, Ws, acc);
  relu_store(acc, w.bcs, H2, A, lh, plane(L.hc()), Rp, row0);  // hc -> A
  __syncthreads();
  heads<bf16>(w, A, B, lh, 1, H, out, rows, row0);
}

long long fwd_smem_bytes(int Lp, int Ld, int H) {
  return 2LL * (TR * (2 * ld(H) + ld(enc_rows(Lp)) + ld(enc_rows(Ld))) +
                ceil32(H) * LDW);
}

// The tensor-core twin of f32::bwd_kernel. Both ping-pong buffers start
// zeroed: K = 8 and K = H/2 + 8 steps of 16 read up to 8 features past K.
__global__ void __launch_bounds__(THREADS, 2)
    bwd_kernel(const float *__restrict__ g, long long rows, int Lp, int Ld,
               int H, WeightsT wt, const bf16 *res, bf16 *gws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(rows, Lp, Ld, H);
  const int H2 = L.H2, lh = ld(H);
  const long long Rp = L.Rp;
  bf16 *P = reinterpret_cast<bf16 *>(smem);
  bf16 *Q = P + TR * lh;
  bf16 *Ws = Q + TR * lh;
  const long long row0 = (long long)blockIdx.x * TR;
  auto Wm = [](const void *p) { return static_cast<const bf16 *>(p); };

  for (int idx = threadIdx.x; idx < 2 * TR * lh; idx += THREADS) P[idx] = __float2bfloat16_rn(0.f);
  __syncthreads();
  for (int idx = threadIdx.x; idx < 8 * TR; idx += THREADS) {
    const int k = idx / TR, r = idx % TR;
    const bool in = row0 + r < rows;
    const bf16 vr = __float2bfloat16_rn(k < 3 && in ? g[k * rows + row0 + r] : 0.f);
    const bf16 vs = __float2bfloat16_rn(k == 0 && in ? g[3 * rows + row0 + r] : 0.f);
    P[r * lh + k] = vr;
    gws[(L.gr8() + k) * Rp + row0 + r] = vr;
    Q[r * lh + H2 + k] = vs;
    gws[(L.gcs() + H2 + k) * Rp + row0 + r] = vs;
  }
  float acc[2][8][4] = {};
  mm_acc(Wm(wt.Wc1T), H2, 8, P, lh, Ws, acc);
  mask_store(acc, H2, res + L.hc() * Rp, Q, lh, gws + L.gcs() * Rp, Rp, row0);
  mm_acc(Wm(wt.WcsT), H, H2 + 8, Q, lh, Ws, acc);
  mask_store(acc, H, res + L.h(7) * Rp, P, lh, gws + L.gh(7) * Rp, Rp, row0);
  const void *chain[7] = {wt.Wp1T, wt.Wp0T, wt.WshT, wt.Wt4T, wt.Wt3T, wt.Wt2T, wt.Wt1T};
  for (int l = 6; l >= 0; --l) {  // as in f32::bwd_kernel; g_h7 is in P
    const bf16 *src = l % 2 == 0 ? P : Q;
    bf16 *dst = l % 2 == 0 ? Q : P;
    mm_acc(Wm(chain[6 - l]), H, H, src, lh, Ws, acc);
    mask_store(acc, H, res + L.h(l) * Rp, dst, lh, gws + L.gh(l) * Rp, Rp, row0);
  }
}

long long bwd_smem_bytes(int H) { return 2LL * (2 * TR * ld(H) + ceil32(H) * LDW); }

}  // namespace tc

// ----------------------------------------------------------------------
// Weight gradients: dW[o][k] = sum over rows of G[o][r] * A[k][r] for one
// (cotangent plane, residual plane) pair, split over S row chunks. Block
// (bo, bk, s) sums its chunk for a 64 x 64 output tile into part[s][o][k]
// (and, for bk = 0 with a bias, sum_r G[o][r] into part[s][O*K + o]);
// reduce_kernel then adds the S partials in order. Deterministic: every
// sum runs in a fixed order.
constexpr int WG = 64;   // output tile
constexpr int WR = 32;   // rows staged per step

// f32: SIMT, thread (ty, tx) owns o = ty*4 + i, k = tx*4 + j.
__global__ void __launch_bounds__(THREADS)
    wgrad_f32(const float *__restrict__ G, int O, const float *__restrict__ A, int K,
              long long Rp, long long chunk, int with_bias, float *part) {
  __shared__ __align__(16) float Gs[WR][WG + 4];
  __shared__ __align__(16) float As[WR][WG + 4];
  const int o0 = blockIdx.x * WG, k0 = blockIdx.y * WG;
  const long long r_begin = blockIdx.z * chunk, r_end = min(Rp, r_begin + chunk);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool do_bias = with_bias && blockIdx.y == 0;
  float acc[4][4] = {}, bsum = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += WR) {
    for (int idx = threadIdx.x; idx < 2 * WG * (WR / 4); idx += THREADS) {
      const bool isA = idx >= WG * (WR / 4);
      const int id = isA ? idx - WG * (WR / 4) : idx;
      const int f = id / (WR / 4), c = (id % (WR / 4)) * 4;
      const int feat = (isA ? k0 : o0) + f;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (feat < (isA ? K : O))
        v = *reinterpret_cast<const float4 *>((isA ? A : G) + feat * Rp + r0 + c);
      float(*S)[WG + 4] = isA ? As : Gs;
      S[c][f] = v.x; S[c + 1][f] = v.y; S[c + 2][f] = v.z; S[c + 3][f] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WR; ++r) {
      const float4 gv = *reinterpret_cast<const float4 *>(&Gs[r][ty * 4]);
      const float4 av = *reinterpret_cast<const float4 *>(&As[r][tx * 4]);
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w}, aa[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gg[i], aa[j], acc[i][j]);
    }
    if (do_bias && threadIdx.x < WG)
      for (int r = 0; r < WR; ++r) bsum += Gs[r][threadIdx.x];
    __syncthreads();
  }
  float *out = part + blockIdx.z * ((long long)O * K + O);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty * 4 + i, k = k0 + tx * 4 + j;
      if (o < O && k < K) out[(long long)o * K + k] = acc[i][j];
    }
  if (do_bias && threadIdx.x < WG && o0 + threadIdx.x < O)
    out[(long long)O * K + o0 + threadIdx.x] = bsum;
}

// bf16: mma.sync. Warp w owns o rows 16*(w%4).. and k columns 32*(w/4)..
// (four n8 tiles). Both planes stage [feature][row]: the contraction runs
// along rows, contiguous in both.
constexpr int WLD = WR + 8;  // 20-word rows: conflict-free fragment loads

__global__ void __launch_bounds__(THREADS)
    wgrad_bf16(const bf16 *__restrict__ G, int O, const bf16 *__restrict__ A, int K,
               long long Rp, long long chunk, int with_bias, float *part) {
  __shared__ __align__(16) bf16 Gs[WG * WLD];
  __shared__ __align__(16) bf16 As[WG * WLD];
  const int o0 = blockIdx.x * WG, k0 = blockIdx.y * WG;
  const long long r_begin = blockIdx.z * chunk, r_end = min(Rp, r_begin + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mo = (warp & 3) * 16, nk = (warp >> 2) * 32;
  const bool do_bias = with_bias && blockIdx.y == 0;
  float acc[4][4] = {}, bsum = 0.f;
  for (long long r0 = r_begin; r0 < r_end; r0 += WR) {
    for (int idx = threadIdx.x; idx < 2 * WG * (WR / 8); idx += THREADS) {
      const bool isA = idx >= WG * (WR / 8);
      const int id = isA ? idx - WG * (WR / 8) : idx;
      const int f = id / (WR / 8), c = (id % (WR / 8)) * 8;
      const int feat = (isA ? k0 : o0) + f;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (feat < (isA ? K : O))
        v = *reinterpret_cast<const uint4 *>((isA ? A : G) + feat * Rp + r0 + c);
      *reinterpret_cast<uint4 *>((isA ? As : Gs) + f * WLD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WR; ks += 16) {
      uint32_t a[4];
      const bf16 *w0 = Gs + (mo + g) * WLD + ks + 2 * t;
      a[0] = tc::ld32(w0);
      a[1] = tc::ld32(w0 + 8 * WLD);
      a[2] = tc::ld32(w0 + 8);
      a[3] = tc::ld32(w0 + 8 * WLD + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16 *x0 = As + (nk + nt * 8 + g) * WLD + ks + 2 * t;
        tc::mma(acc[nt], a, tc::ld32(x0), tc::ld32(x0 + 8));
      }
    }
    if (do_bias && threadIdx.x < WG)
      for (int r = 0; r < WR; ++r) bsum += __bfloat162float(Gs[threadIdx.x * WLD + r]);
    __syncthreads();
  }
  float *out = part + blockIdx.z * ((long long)O * K + O);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + mo + g + (q >= 2 ? 8 : 0), k = k0 + nk + nt * 8 + 2 * t + (q & 1);
      if (o < O && k < K) out[(long long)o * K + k] = acc[nt][q];
    }
  if (do_bias && threadIdx.x < WG && o0 + threadIdx.x < O)
    out[(long long)O * K + o0 + threadIdx.x] = bsum;
}

// dW[i] = sum_s part[s][i] (i < O*K); db[o] = sum_s part[s][O*K + o].
__global__ void reduce_kernel(const float *__restrict__ part, int S, int O, int K,
                              float *dW, float *db) {
  const long long n = (long long)O * K + O;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || (i >= (long long)O * K && !db)) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[z * n + i];
  if (i < (long long)O * K) dW[i] = s;
  else db[i - (long long)O * K] = s;
}

// Row splits of the weight-gradient sums: enough blocks to fill the card
// at the training batch, few enough partials to stay small.
inline int wgrad_splits(long long Rp) { return (int)std::min(64LL, Rp / TR); }

long long max_part_floats(const Layout &L) {
  const int H = L.H, H2 = L.H2;
  const int OK[5][2] = {{8, H2}, {H2, L.FD}, {H2 + 8, H}, {H, H}, {H, L.FX}};
  long long m = 0;
  for (auto &p : OK) m = std::max(m, (long long)p[0] * p[1] + p[0]);
  return m;
}

// ----------------------------------------------------------------------
// Backward from output cotangents: the tile kernel, then the twelve
// weight-gradient sums. `res` holds the forward's residuals; gws and part
// are scratch.
int backward(const float *g, long long rows, int Lp, int Ld, int H, bool is_bf16,
             const WeightsT &wt, void *res, void *gws, float *part, const Grads &out,
             cudaStream_t stream) {
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long smem = is_bf16 ? tc::bwd_smem_bytes(H) : f32::bwd_smem_bytes(H);
  const dim3 grid((unsigned)(L.Rp / TR));
  if (is_bf16) {
    cudaError_t e = cudaFuncSetAttribute(tc::bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tc::bwd_kernel<<<grid, THREADS, smem, stream>>>(g, rows, Lp, Ld, H, wt,
        static_cast<const bf16 *>(res), static_cast<bf16 *>(gws));
  } else {
    cudaError_t e = cudaFuncSetAttribute(f32::bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    f32::bwd_kernel<<<grid, THREADS, smem, stream>>>(g, rows, Lp, Ld, H, wt,
        static_cast<const float *>(res), static_cast<float *>(gws));
  }
  if (cudaError_t e = cudaGetLastError()) return (int)e;

  struct Task { int gf, O, af, K; float *dW, *db; };
  const int H2 = L.H2;
  const Task tasks[12] = {
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
  const int S = wgrad_splits(L.Rp);
  const long long chunk = ((L.Rp + S - 1) / S + WR - 1) / WR * WR;
  for (const Task &tk : tasks) {
    const dim3 wg((tk.O + WG - 1) / WG, (tk.K + WG - 1) / WG, S);
    if (is_bf16)
      wgrad_bf16<<<wg, THREADS, 0, stream>>>(
          static_cast<const bf16 *>(gws) + tk.gf * L.Rp, tk.O,
          static_cast<const bf16 *>(res) + tk.af * L.Rp, tk.K, L.Rp, chunk,
          tk.db != nullptr, part);
    else
      wgrad_f32<<<wg, THREADS, 0, stream>>>(
          static_cast<const float *>(gws) + tk.gf * L.Rp, tk.O,
          static_cast<const float *>(res) + tk.af * L.Rp, tk.K, L.Rp, chunk,
          tk.db != nullptr, part);
    const long long n = (long long)tk.O * tk.K + tk.O;
    reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, S, tk.O, tk.K, tk.dW, tk.db);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  return 0;
}

// Forward of all rows through the tile kernel of the compute type; with
// `res`, the residuals are kept.
int forward(const float *x, float *out, long long rows, int Lp, int Ld, int H,
            bool is_bf16, const Weights &w, void *res, cudaStream_t stream) {
  const long long smem = is_bf16 ? tc::fwd_smem_bytes(Lp, Ld, H) : f32::fwd_smem_bytes(Lp, Ld, H);
  const dim3 grid((unsigned)((rows + TR - 1) / TR));
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(tc::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    tc::fwd_kernel<<<grid, THREADS, smem, stream>>>(x, out, rows, Lp, Ld, H, w, static_cast<bf16 *>(res));
  } else {
    e = cudaFuncSetAttribute(f32::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    f32::fwd_kernel<<<grid, THREADS, smem, stream>>>(x, out, rows, Lp, Ld, H, w, static_cast<float *>(res));
  }
  return (int)cudaGetLastError();
}

long long fwd_smem(int Lp, int Ld, int H, int is_bf16) {
  return is_bf16 ? tc::fwd_smem_bytes(Lp, Ld, H) : f32::fwd_smem_bytes(Lp, Ld, H);
}

long long bwd_smem(int H, int is_bf16) {
  return is_bf16 ? tc::bwd_smem_bytes(H) : f32::bwd_smem_bytes(H);
}

bool arch_ok(int Lp, int Ld, int H) {
  return H % 16 == 0 && H >= 16 && H <= MAX_H && Lp >= 1 && Ld >= 1;
}

// Workspace of the backward, carved from one buffer: residuals, cotangents
// and the weight-gradient partials, each 256-byte aligned.
struct Workspace {
  void *res, *gws;
  float *part;
  long long bytes;
};

Workspace carve(void *base, long long rows, int Lp, int Ld, int H, int is_bf16) {
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long es = is_bf16 ? 2 : 4;
  const long long a = align256(es * L.FA() * L.Rp), b = align256(es * L.FG() * L.Rp);
  const long long c = align256(4LL * wgrad_splits(L.Rp) * max_part_floats(L));
  char *p = static_cast<char *>(base);
  return Workspace{p, p + a, reinterpret_cast<float *>(p + a + b), a + b + c};
}

}  // namespace
