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
// Design. One block of 256 threads per tile of 64 sample rows. The
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
//
// sin/cos: the encoder evaluates sin(2^(L-1) x) at thousands of radians,
// so this file uses the accurate sincosf (never __sinf/__cosf) and must
// not be built with --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Field order of pack_weights' FusedWeights. Matrices are in the compute
// type, biases f32. Outside the anonymous namespace: the extern "C" entry
// takes it, and a parameter type with internal linkage would give the
// entry internal linkage too (no exported symbol).
struct Weights {
  const void *W1, *b1, *Wt1, *bt1, *Wt2, *bt2, *Wt3, *bt3, *Wt4, *bt4;
  const void *Wsh, *Wsx, *bs, *Wp0, *bp0, *Wp1, *bp1;
  const void *Wcs, *bcs, *Wcd, *Wc1, *bc1;
};

namespace {

constexpr int TR = 64;        // sample rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_H = 256;    // widest layer the shared-memory plan holds

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int ceil8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int ceil32(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ inline int enc_rows(int L) { return 8 + 2 * ceil8(3 * L); }

__device__ __forceinline__ float bias(const void *b, int o) {
  return static_cast<const float *>(b)[o];
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

__device__ void encode(const float *__restrict__ x, long long rows,
                       long long row0, int L, int col0, float *pos) {
  const int F = enc_rows(L);
  for (int idx = threadIdx.x; idx < F * TR; idx += THREADS) {
    const int k = idx / TR, r = idx % TR;
    pos[idx] = row0 + r < rows ? encoded(x, rows, row0 + r, L, col0, k) : 0.f;
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
// rows of W (O, K). Features past O read row O - 1 (their sums are never
// stored). Ws holds two buffers of wsz floats. Starts with a barrier, so
// the caller's stores to `in` are visible and nobody still reads Ws.
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

// out[o][r] = relu(acc + b[o]) for the thread's features o < O; resets acc.
__device__ void relu_store(float acc[8][8], const void *b, int O, float *out,
                           int to, int tr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = to + 32 * i;
    const float bi = o < O ? bias(b, o) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (o < O) out[o * TR + row_of(tr, j)] = fmaxf(acc[i][j] + bi, 0.f);
      acc[i][j] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    kernel(const float *__restrict__ x, float *__restrict__ out,
           long long rows, int Lp, int Ld, int H, Weights w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int FX = enc_rows(Lp), FD = enc_rows(Ld), H2 = H / 2;
  float *A = reinterpret_cast<float *>(smem);
  float *B = A + H * TR;
  float *posx = B + H * TR;
  float *posd = posx + FX * TR;
  float *Ws = posd + FD * TR;  // two buffers of H x WS_LD
  const int wsz = H * WS_LD;
  const long long row0 = (long long)blockIdx.x * TR;
  const int to = threadIdx.x >> 3, tr = threadIdx.x & 7;
  auto Wm = [](const void *p) { return static_cast<const float *>(p); };

  encode(x, rows, row0, Lp, 0, posx);
  encode(x, rows, row0, Ld, 3, posd);
  float acc[8][8] = {};
  mm_acc(Wm(w.W1), H, FX, posx, Ws, wsz, acc, to, tr);
  relu_store(acc, w.b1, H, A, to, tr);                      // h0 -> A
  mm_acc(Wm(w.Wt1), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt1, H, B, to, tr);                     // h1 -> B
  mm_acc(Wm(w.Wt2), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt2, H, A, to, tr);                     // h2 -> A
  mm_acc(Wm(w.Wt3), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt3, H, B, to, tr);                     // h3 -> B
  mm_acc(Wm(w.Wt4), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bt4, H, A, to, tr);                     // h4 -> A
  mm_acc(Wm(w.Wsh), H, H, A, Ws, wsz, acc, to, tr);              // skip: [h4 | posx]
  mm_acc(Wm(w.Wsx), H, FX, posx, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bs, H, B, to, tr);                      // h5 -> B
  mm_acc(Wm(w.Wp0), H, H, B, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bp0, H, A, to, tr);                     // h6 -> A
  mm_acc(Wm(w.Wp1), H, H, A, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bp1, H, B, to, tr);                     // h7 -> B
  mm_acc(Wm(w.Wcs), H2, H, B, Ws, wsz, acc, to, tr);             // folded colour rows
  mm_acc(Wm(w.Wcd), H2, FD, posd, Ws, wsz, acc, to, tr);
  relu_store(acc, w.bcs, H2, A, to, tr);                    // hc -> A
  __syncthreads();
  heads<float>(w, A, B, 1, TR, H, out, rows, row0);
}

long long smem_bytes(int Lp, int Ld, int H) {
  return 4LL * (TR * (2 * H + enc_rows(Lp) + enc_rows(Ld)) + 2 * H * WS_LD);
}

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
// K-steps of 16 read up to 8 of them against zero weights.
__device__ void encode(const float *__restrict__ x, long long rows,
                       long long row0, int L, int col0, bf16 *pos) {
  const int F = enc_rows(L), lp = ld(F);
  for (int idx = threadIdx.x; idx < TR * lp; idx += THREADS) {
    const int r = idx / lp, k = idx % lp;
    const float v = (row0 + r < rows && k < F) ? encoded(x, rows, row0 + r, L, col0, k) : 0.f;
    pos[idx] = __float2bfloat16_rn(v);
  }
}

// acc += W[:, :K] @ act^T for this warp's features, over the first O rows
// of W (O, K) row-major. act is [TR][lda]. Weight rows past O (up to the
// warp tile) and columns past K stage as zeros.
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

// out[r][o] = bf16(relu(acc + b[o])) for o < O; resets acc.
__device__ void relu_store(float acc[2][8][4], const void *b, int O, bf16 *out,
                           int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ow = warp * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = ow + mt * 16 + half * 8 + g;
      const float bo = o < O ? bias(b, o) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int r = nt * 8 + 2 * t;
        float *c = acc[mt][nt] + 2 * half;
        if (o < O) {
          out[r * ldo + o] = __float2bfloat16_rn(fmaxf(c[0] + bo, 0.f));
          out[(r + 1) * ldo + o] = __float2bfloat16_rn(fmaxf(c[1] + bo, 0.f));
        }
        c[0] = c[1] = 0.f;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 2)
    kernel(const float *__restrict__ x, float *__restrict__ out,
           long long rows, int Lp, int Ld, int H, Weights w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int FX = enc_rows(Lp), FD = enc_rows(Ld), H2 = H / 2;
  const int lh = ld(H), lx = ld(FX), lD = ld(FD);
  bf16 *A = reinterpret_cast<bf16 *>(smem);
  bf16 *B = A + TR * lh;
  bf16 *posx = B + TR * lh;
  bf16 *posd = posx + TR * lx;
  bf16 *Ws = posd + TR * lD;  // ceil32(H) x LDW
  const long long row0 = (long long)blockIdx.x * TR;
  auto Wm = [](const void *p) { return static_cast<const bf16 *>(p); };

  encode(x, rows, row0, Lp, 0, posx);
  encode(x, rows, row0, Ld, 3, posd);
  float acc[2][8][4] = {};
  mm_acc(Wm(w.W1), H, FX, posx, lx, Ws, acc);
  relu_store(acc, w.b1, H, A, lh);                          // h0 -> A
  mm_acc(Wm(w.Wt1), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bt1, H, B, lh);                         // h1 -> B
  mm_acc(Wm(w.Wt2), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bt2, H, A, lh);                         // h2 -> A
  mm_acc(Wm(w.Wt3), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bt3, H, B, lh);                         // h3 -> B
  mm_acc(Wm(w.Wt4), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bt4, H, A, lh);                         // h4 -> A
  mm_acc(Wm(w.Wsh), H, H, A, lh, Ws, acc);                  // skip: [h4 | posx]
  mm_acc(Wm(w.Wsx), H, FX, posx, lx, Ws, acc);
  relu_store(acc, w.bs, H, B, lh);                          // h5 -> B
  mm_acc(Wm(w.Wp0), H, H, B, lh, Ws, acc);
  relu_store(acc, w.bp0, H, A, lh);                         // h6 -> A
  mm_acc(Wm(w.Wp1), H, H, A, lh, Ws, acc);
  relu_store(acc, w.bp1, H, B, lh);                         // h7 -> B
  mm_acc(Wm(w.Wcs), H2, H, B, lh, Ws, acc);                 // folded colour rows
  mm_acc(Wm(w.Wcd), H2, FD, posd, lD, Ws, acc);
  relu_store(acc, w.bcs, H2, A, lh);                        // hc -> A
  __syncthreads();
  heads<bf16>(w, A, B, lh, 1, H, out, rows, row0);
}

long long smem_bytes(int Lp, int Ld, int H) {
  return 2LL * (TR * (2 * ld(H) + ld(enc_rows(Lp)) + ld(enc_rows(Ld))) +
                ceil32(H) * LDW);
}

}  // namespace tc

int launch(void (*kernel)(const float *, float *, long long, int, int, int, Weights),
           const float *x, float *out, long long rows, int Lp, int Ld, int H,
           const Weights &w, long long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rows + TR - 1) / TR));
  kernel<<<grid, THREADS, (size_t)smem, stream>>>(x, out, rows, Lp, Ld, H, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long fused_mlp_fwd_smem_bytes(int Lp, int Ld, int H, int is_bf16) {
  return is_bf16 ? tc::smem_bytes(Lp, Ld, H) : f32::smem_bytes(Lp, Ld, H);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller allocates `out` (8, rows) f32 and checks shapes and types.
int fused_mlp_fwd(const float *x, float *out, long long rows, int Lp, int Ld,
                  int H, int is_bf16, Weights w, void *stream) {
  if (H % 16 != 0 || H < 16 || H > MAX_H || Lp < 1 || Ld < 1)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(is_bf16 ? tc::kernel : f32::kernel, x, out, rows, Lp, Ld, H, w,
                fused_mlp_fwd_smem_bytes(Lp, Ld, H, is_bf16), s);
}

}  // extern "C"
