// The input-gradient kernel of the fused NeRF MLP backward for Hopper
// (sm_90a): dL/dx of the MLP's input rows, from the cotangent planes the
// backward tile kernel leaves in the workspace. Included by
// fused_mlp_bwd.cu after mlp_tile.cuh (whose Layout, Weights and helpers
// it uses); fused_mlp_bwd launches it after the weight-gradient sums when
// it is asked for dx (pose refinement trains through ray generation).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_bwd_kernel's want_dx branch
// (:733-746): the encoded inputs' cotangents of _backprop_tile (:865-868,
// g_posx = W1^T g_h0 + Wsx^T g_h5 and g_posd = Wcd^T g_hc, its mTg
// products, :784-790), times BARF's anneal windows, through the
// encoder's transpose _input_grad_tile (:871-938, without contraction).
//
// Contract: the workspace's cotangent planes (mlp_tile.cuh's Layout) g_h0,
// g_h5 and g_hc (the first H/2 rows of g_cs), each (features, Rp) in the
// compute type; W1, Wsx and Wcd of the packed weights in the compute type;
// x (8, rows) f32 (rows 0..2 xyz, 3..5 the unit direction); wx (FX floats)
// and wd (FD floats) on the card, or both null. dx (8, rows) f32: rows
// 0..2 from posx, 3..5 from posd, 6..7 zero; rows past `rows` are not
// written. Numerics of mTg: both operands in the compute type, f32 sums
// (a bf16 product is exact in f32, so an f32 FMA of bf16 values is the
// bf16 product with f32 accumulation); the angles in f32 with the
// accurate sincosf (bf16 angles would corrupt the high octaves'
// derivatives, mlp.py:888-889). A raw row passes its cotangent through; a
// sin row of coordinate c at frequency 2^i adds 2^i cos(2^i x_c) times its
// cotangent to x_c, a cos row -2^i sin(2^i x_c) times it. Pad rows carry
// zero weight columns, so they are not read (the port's row 3 is a pad
// row: no bias rail). Lp <= 10 and Ld <= 4 (LXM, LDM).
//
// What bounds it (flagship, 524,288 rows): in bf16 the bytes, 640 plane
// rows x 2 B, x and dx, ~1,344 B a row: 0.21 ms at 3.35 TB/s (its 83,968
// flop a row take 0.045 ms on the tensor cores); in f32 the operations,
// 0.66 ms at 67 TFLOP/s (its bytes 0.41 ms).
//
// Design: simple SIMT, one thread a sample row, chosen over mma.sync for
// a first kernel that is right: the products are skinny (K = H rows of
// cotangents to 63 + 27 outputs), and the transpose's sincosf runs per
// row anyway. A block (512 threads, one an SM: a persistent grid) copies
// the three weight slices it needs into shared memory once, as f32 and
// transposed to [o][slot]: only the columns a row of x reads (3 raw, 3 Lp
// sin, 3 Lp cos of posx in KX = 64 slots; 27 of posd in KD = 32), 147 KB
// at H = 256. Each thread then walks the H cotangent rows of its sample
// row (coalesced loads along the rows, the next one fetched ahead),
// multiplying each into 64 f32 accumulators with weights read as float4
// broadcasts; posx first (W1 on g_h0 and Wsx on g_h5 into one set of
// accumulators), then posd (Wcd on g_hc). So f32 and bf16 both run on the
// FMA pipes: a bf16 launch does not reach its byte bound.

#pragma once

namespace {
namespace ig {

constexpr int THREADS = 512;
constexpr int LXM = 10, KX = 64;  // octaves of posx held; slots: 3 raw + 3 LXM sin + 3 LXM cos, padded
constexpr int LDM = 4, KD = 32;   // the same for posd

long long launches = 0;  // of this library, counted where they launch

__host__ __device__ inline long long smem_bytes(int H) { return 4LL * (2LL * H * KX + (long long)(H / 2) * KD); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// The encoded-row column (kernel layout, L octaves) of slot s of a branch
// holding LM octaves: raw 0..2; then the sin rows, then the cos rows, each
// coordinate c's octave i at slot 3 + LM c + i (+ 3 LM for cos); -1 for a
// slot past L or past the rows.
template <int LM>
__device__ __forceinline__ int column(int s, int L) {
  if (s < 3) return s;
  const int t = s - 3, cos_row = t >= 3 * LM, u = cos_row ? t - 3 * LM : t, c = u / LM, i = u % LM;
  if (c >= 3 || i >= L) return -1;
  return 8 + cos_row * ceil8(3 * L) + L * c + i;
}

// One branch of the encoder's transpose for the calling thread's row: the
// f32 products of its O cotangent rows ga (and gb, TWO) with the slot
// weights sa (and sb) [o][K], times the windows ew (or none), then the
// transpose at the row's three coordinates xc (stride `rows`) into d.
template <class T, int K, int LM, bool TWO>
__device__ __forceinline__ void branch(const T *__restrict__ ga, const T *__restrict__ gb, long long Rp,
                                       const float *sa, const float *sb, int O, const float *__restrict__ xc,
                                       long long rows, int L, const float *__restrict__ ew, float d[3]) {
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  float a = to_f(ga[0]), b = TWO ? to_f(gb[0]) : 0.f;
  for (int o = 0; o < O; ++o) {
    float an = 0.f, bn = 0.f;  // the next cotangent row, fetched ahead
    if (o + 1 < O) {
      ga += Rp;
      an = to_f(*ga);
      if (TWO) {
        gb += Rp;
        bn = to_f(*gb);
      }
    }
    const float4 *wa = reinterpret_cast<const float4 *>(sa + o * K);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 u = wa[q];
      acc[4 * q] = fmaf(u.x, a, acc[4 * q]);
      acc[4 * q + 1] = fmaf(u.y, a, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(u.z, a, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(u.w, a, acc[4 * q + 3]);
    }
    if (TWO) {
      const float4 *wb = reinterpret_cast<const float4 *>(sb + o * K);
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 u = wb[q];
        acc[4 * q] = fmaf(u.x, b, acc[4 * q]);
        acc[4 * q + 1] = fmaf(u.y, b, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(u.z, b, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(u.w, b, acc[4 * q + 3]);
      }
    }
    a = an;
    b = bn;
  }
  const int sbk = ceil8(3 * L);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float dc = acc[c];
    if (ew) dc *= __ldg(ew + c);
    const float xv = xc[(long long)c * rows];
#pragma unroll
    for (int i = 0; i < LM; ++i) {
      if (i < L) {
        float gs = acc[3 + LM * c + i], gc = acc[3 + 3 * LM + LM * c + i];
        if (ew) {
          gs *= __ldg(ew + 8 + L * c + i);
          gc *= __ldg(ew + 8 + sbk + L * c + i);
        }
        float s, co;
        sincosf(ldexpf(xv, i), &s, &co);
        dc += ldexpf(gs * co - gc * s, i);
      }
    }
    d[c] = dc;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    input_grad_kernel(const T *__restrict__ g0, const T *__restrict__ g5, const T *__restrict__ gc, long long Rp,
                      const float *__restrict__ x, long long rows, int Lp, int Ld, int H, int FX, int FD,
                      const T *__restrict__ W1, const T *__restrict__ Wsx, const T *__restrict__ Wcd,
                      const float *__restrict__ wx, const float *__restrict__ wd, float *__restrict__ dx) {
  extern __shared__ __align__(16) float sm[];
  const int H2 = H / 2;
  float *sA = sm, *sB = sA + H * KX, *sC = sB + H * KX;
  for (int u = threadIdx.x; u < H * KX; u += THREADS) {  // W1^T, Wsx^T in their slots
    const int o = u / KX, k = column<LXM>(u % KX, Lp);
    sA[u] = k < 0 ? 0.f : to_f(W1[o * FX + k]);
    sB[u] = k < 0 ? 0.f : to_f(Wsx[o * FX + k]);
  }
  for (int u = threadIdx.x; u < H2 * KD; u += THREADS) {  // Wcd^T
    const int o = u / KD, k = column<LDM>(u % KD, Ld);
    sC[u] = k < 0 ? 0.f : to_f(Wcd[o * FD + k]);
  }
  __syncthreads();
  for (long long row = (long long)blockIdx.x * THREADS + threadIdx.x; row < rows;
       row += (long long)gridDim.x * THREADS) {
    float d[3], e[3];
    branch<T, KX, LXM, true>(g0 + row, g5 + row, Rp, sA, sB, H, x + row, rows, Lp, wx, d);
    branch<T, KD, LDM, false>(gc + row, nullptr, Rp, sC, nullptr, H2, x + 3 * rows + row, rows, Ld, wd, e);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dx[c * rows + row] = d[c];
      dx[(3 + c) * rows + row] = e[c];
    }
    dx[6 * rows + row] = 0.f;
    dx[7 * rows + row] = 0.f;
  }
}

template <class T>
int launch_t(const char *gws, const float *x, long long rows, int Lp, int Ld, int H, const Weights &w,
             const float *wx, const float *wd, float *dx, cudaStream_t stream) {
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long es = sizeof(T), smem = smem_bytes(H);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(input_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);
  auto plane = [&](int f) { return reinterpret_cast<const T *>(gws + es * f * L.Rp); };
  input_grad_kernel<T><<<grid, THREADS, smem, stream>>>(
      plane(L.gh(0)), plane(L.gh(5)), plane(L.gcs()), L.Rp, x, rows, Lp, Ld, H, L.FX, L.FD,
      static_cast<const T *>(w.W1), static_cast<const T *>(w.Wsx), static_cast<const T *>(w.Wcd), wx, wd, dx);
  return (int)cudaGetLastError();
}

// dx (8, rows) from the cotangent planes `gws` of the workspace, on
// `stream`; counts the launch.
int launch(const void *gws, const float *x, long long rows, int Lp, int Ld, int H, bool is_bf16,
           const Weights &w, const float *wx, const float *wd, float *dx, cudaStream_t stream) {
  if (Lp > LXM || Ld > LDM || rows <= 0 || (wx == nullptr) != (wd == nullptr)) return (int)cudaErrorInvalidValue;
  const char *g = static_cast<const char *>(gws);
  const int e = is_bf16 ? launch_t<bf16>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream)
                        : launch_t<float>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream);
  if (e == 0) ++launches;
  return e;
}

}  // namespace ig
}  // namespace
