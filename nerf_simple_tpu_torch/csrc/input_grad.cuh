// The input-gradient kernel of the fused NeRF MLP backward for Hopper
// (sm_90a): dL/dx of the MLP's input rows, from the cotangent planes the
// backward tile kernel leaves in the workspace. Included by
// fused_mlp_bwd.cu and (its CONTRACT instantiations) fused_contract.cu,
// after mlp_tile.cuh (whose Layout, Weights and helpers it uses);
// fused_mlp_bwd launches it after the weight-gradient sums when it is
// asked for dx (pose refinement trains through ray generation).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_bwd_kernel's want_dx branch
// (:733-746): the encoded inputs' cotangents of _backprop_tile (:865-868,
// g_posx = W1^T g_h0 + Wsx^T g_h5 and g_posd = Wcd^T g_hc, its mTg
// products, :784-790), times BARF's anneal windows, through the
// encoder's transpose _input_grad_tile (:871-938, without contraction);
// for an appearance model also the code gradients g_app = Wca^T g_hc
// (:867), appended as rows 8..15 of dx (:747-748, :1140-1145); under mip
// (cone casting) the integrated encoder's transpose instead,
// _input_grad_tile_mip (:941-1078, without contraction; :738-742); for
// a contracted model without mip the contract branch of _input_grad_tile
// (:898-906, :933-938), in the CONTRACT instantiation, and under mip that
// of _input_grad_tile_mip (:972-983, :1034-1064), in the MIP && CONTRACT
// one.
//
// Contract: the workspace's cotangent planes (mlp_tile.cuh's Layout) g_h0,
// g_h5 and g_hc (the first H/2 rows of g_cs), each (features, Rp) in the
// compute type; W1, Wsx and Wcd of the packed weights in the compute type;
// x (8, rows) f32 (rows 0..2 xyz, 3..5 the unit direction; 16 rows for an
// appearance model, of which rows 0..5 are read); wx (FX floats) and wd
// (enc_rows(Ld) floats) on the card, or both null. dx (8, rows) f32: rows
// 0..2 from posx, 3..5 from posd, 6..7 zero; for an appearance model
// (`app`: Wcd holds Wca as its last eight columns, posd_rows) dx is (16,
// rows) and rows 8..15 are Wca^T g_hc, the codes' cotangents, which pass
// through no encoder and no window. Rows past `rows` are not written. Numerics of mTg: both operands in the compute type, f32 sums
// (a bf16 product is exact in f32, so an f32 FMA of bf16 values is the
// bf16 product with f32 accumulation); the angles in f32 with the
// accurate sincosf (bf16 angles would corrupt the high octaves'
// derivatives, mlp.py:888-889). A raw row passes its cotangent through; a
// sin row of coordinate c at frequency 2^i adds 2^i cos(2^i x_c) times its
// cotangent to x_c, a cos row -2^i sin(2^i x_c) times it. Pad rows carry
// zero weight columns, so they are not read (the port's row 3 is a pad
// row: no bias rail). Lp <= 10 and Ld <= 4 (LXM, LDM).
//
// Mip (`MIP`, a compile-time switch like the code slots, so the launches
// without it keep their code): x is (16, rows) with the frustum
// Gaussians' means in rows 0..2, unit dirs 3..5 and diagonal variances
// 11..13; posx's sin and cos rows of coordinate c at 2^i were damped in
// the forward by damp = exp(-0.5 4^i v_c) (the raw rows and posd are
// not). So a damped row's cotangent g feeds two chains: the angle chain,
// g f'(ang) damp into the mean as above, and the damp chain, -0.5 g
// f(ang) damp, which adds 4^i times it to d/d(v_c). dx is (16, rows):
// rows 0..2 d/d(mean), 3..5 d/d(unit dir), 11..13 d/d(variance), the
// rest zero. One expf a (coordinate, octave) pair, shared by its sin and
// cos rows, in f32 as the forward computes it; no windows and no codes
// under mip (the JAX config's rules).
//
// Contract (`CONTRACT`, a compile-time switch whose instantiations are
// built into csrc/fused_contract.cu's library alone; B2 reaches them
// through set_contract_input_grad, so the kernels without it keep their
// code): each row contracts x's rows 0..2 with mlp_tile.cuh's
// contract_point, the forward's own arithmetic, so the angles of sincosf
// are the forward's contracted coordinates to the bit; posx's transpose is
// taken there, and the contraction's transpose (contract_transpose: g dy
// + c (x . dy) x at the uncontracted x) then goes onto d[0..2]. posd and
// the code rows are not contracted. Windows and codes compose with it.
// Under mip (MIP && CONTRACT, no windows, no codes) contract_point also
// warps the row's variances (the forward's linearised Gaussian), so the
// angles and the damps are the forward's; the two chains' cotangents of
// the contracted mean and variance then go through the warp's coupled
// transpose at the raw mean and variance (contract_transpose_mip: the
// variance transform depends on the mean through n and m = x^2), onto dx
// rows 0..2 and 11..13. Inside the unit ball the row is the MIP kernel's,
// bit for bit.
//
// What bounds it (flagship, 524,288 rows): in bf16 the bytes, 640 plane
// rows x 2 B, x and dx, ~1,344 B a row: 0.21 ms at 3.35 TB/s (its 83,968
// flop a row take 0.045 ms on the tensor cores); in f32 the operations,
// 0.66 ms at 67 TFLOP/s (its bytes 0.41 ms). Under mip it reads 9 rows of
// x and writes 16 of dx, ~1,380 B a row in bf16 (0.22 ms); the products
// are the same. The coupled transpose of MIP && CONTRACT adds ~60 flops a
// row, after the products.
//
// Design: simple SIMT, one thread a sample row, chosen over mma.sync for
// a first kernel that is right: the products are skinny (K = H rows of
// cotangents to 63 + 27 outputs), and the transpose's sincosf runs per
// row anyway. A block (512 threads, one an SM: a persistent grid) copies
// the three weight slices it needs into shared memory once, as f32 and
// transposed to [o][slot]: only the columns a row of x reads (3 raw, 3 Lp
// sin, 3 Lp cos of posx in KX = 64 slots; 27 of posd in KD = 32, and
// with appearance codes their eight in eight more slots, KDA = 40), 147
// KB at H = 256 (151 KB with codes). Each thread then walks the H cotangent rows of its sample
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
constexpr int KDA = KD + 8;       // posd's slots with the eight appearance-code columns after them

long long launches = 0;      // of this library, counted where they launch
long long mip_launches = 0;  // of them, the integrated encoder's transpose (MIP)

__host__ __device__ inline long long smem_bytes(int H, bool app = false) {
  return 4LL * (2LL * H * KX + (long long)(H / 2) * (app ? KDA : KD));
}

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
// transpose at the row's three coordinates xc (stride `rows`) into d; the
// products of the slots past KD (the appearance codes', K = KDA) go to
// `code` as they are. MIP: the sin and cos rows were damped by the
// variances vc (stride `rows`); d gets the angle chain, dv the damp chain.
// CX: the transpose is taken at the contracted coordinates (contract_point
// of the row xc, after the products, so that they hold no register
// through them); with MIP also at the contracted variances.
template <class T, int K, int LM, bool TWO, bool MIP = false, bool CX = false>
__device__ __forceinline__ void branch(const T *__restrict__ ga, const T *__restrict__ gb, long long Rp,
                                       const float *sa, const float *sb, int O, const float *__restrict__ xc,
                                       long long rows, int L, const float *__restrict__ ew, float d[3],
                                       float *code = nullptr, const float *__restrict__ vc = nullptr,
                                       float *dv = nullptr) {
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
  float cx[3], cv[3];
  if constexpr (CX) {
    float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) cx[c] = xc[(long long)c * rows];
    if constexpr (MIP) {
#pragma unroll
      for (int c = 0; c < 3; ++c) cv[c] = vc[(long long)c * rows];
      contract_point(cx, cv, true);
    } else {
      contract_point(cx, v, false);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float dc = acc[c];
    if (ew) dc *= __ldg(ew + c);
    float xv;
    if constexpr (CX)
      xv = cx[c];
    else
      xv = xc[(long long)c * rows];
    float vv = 0.f, dvc = 0.f;
    if constexpr (MIP && CX)
      vv = cv[c];
    else if constexpr (MIP)
      vv = vc[(long long)c * rows];
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
        if constexpr (MIP) {  // the row's cotangents through the damp: both chains carry it
          const float damp = expf(-0.5f * ldexpf(vv, 2 * i));
          gs *= damp;
          gc *= damp;
          dvc += ldexpf(gs * s + gc * co, 2 * i);
        }
        dc += ldexpf(gs * co - gc * s, i);
      }
    }
    d[c] = dc;
    if constexpr (MIP) dv[c] = -0.5f * dvc;
  }
  if constexpr (K == KDA)
#pragma unroll
    for (int j = 0; j < 8; ++j) code[j] = acc[KD + j];
}

// The transpose of contract_point with mip at the raw mean x[0..2] and
// variances v[0..2] (JAX _input_grad_tile_mip :1034-1064): the cotangents
// d of the contracted mean and dv of the contracted variances become, in
// place, those of x and v. With n = |x| (contract_norm), g, c as there, g'
// = c n, c' = 6/n^4 - 8/n^5, m = x^2, S = m . v, C = m . dv, A = dv . v, B =
// dv . (m v): dv_k <- (g^2 + 2 g c m_k) dv_k + c^2 m_k C, and d_k <- g d_k +
// x_k (c (x . d) + 2 (g g' A + (g' c + g c') B + c c' S C) / n + (4 g c v_k
// + 2 c^2 S) dv_k + 2 c^2 v_k C). Inside the ball both are left as they are.
__device__ __forceinline__ void contract_transpose_mip(const float *x, const float *v, float *d, float *dv) {
  const float n = contract_norm(x);
  if (n <= 1.f) return;
  const float n2 = n * n, g = (2.f - 1.f / n) / n, c = (-2.f / n2 + 2.f / (n2 * n)) / n;
  const float gp = c * n, cp = 6.f / (n2 * n2) - 8.f / (n2 * n2 * n), c2 = c * c;
  float m[3], S = 0.f, C = 0.f, A = 0.f, B = 0.f, dot = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m[k] = x[k] * x[k];
    S += m[k] * v[k];
    C += m[k] * dv[k];
    A += dv[k] * v[k];
    B += dv[k] * m[k] * v[k];
    dot += x[k] * d[k];
  }
  const float tn = 2.f * (g * gp * A + (gp * c + g * cp) * B + c * cp * S * C) / n;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dvo = dv[k];
    d[k] = g * d[k] + (c * dot + tn + (4.f * g * c * v[k] + 2.f * c2 * S) * dvo + 2.f * c2 * v[k] * C) * x[k];
    dv[k] = (g * g + 2.f * g * c * m[k]) * dvo + c2 * m[k] * C;
  }
}

// KP: posd's slots, KD, or KDA with the appearance codes (dx then has 16
// rows); MIP: the integrated encoder's transpose (x and dx of 16 rows);
// CONTRACT: a contracted model's (with MIP: KD only).
template <class T, int KP, bool MIP = false, bool CONTRACT = false>
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
  for (int u = threadIdx.x; u < H2 * KP; u += THREADS) {  // Wcd^T (its Wca columns in the slots past KD)
    const int o = u / KP, s = u % KP, k = s < KD ? column<LDM>(s, Ld) : enc_rows(Ld) + s - KD;
    sC[u] = k < 0 ? 0.f : to_f(Wcd[o * FD + k]);
  }
  __syncthreads();
  for (long long row = (long long)blockIdx.x * THREADS + threadIdx.x; row < rows;
       row += (long long)gridDim.x * THREADS) {
    float d[3], e[3], code[8];
    if constexpr (MIP) {
      float dv[3];
      branch<T, KX, LXM, true, true, CONTRACT>(g0 + row, g5 + row, Rp, sA, sB, H, x + row, rows, Lp, nullptr, d,
                                               nullptr, x + 11 * rows + row, dv);
      if constexpr (CONTRACT) {  // the warp's coupled transpose at the raw mean and variances
        float xo[3], vo[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          xo[c] = x[c * rows + row];
          vo[c] = x[(11 + c) * rows + row];
        }
        contract_transpose_mip(xo, vo, d, dv);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) dx[(11 + c) * rows + row] = dv[c];
#pragma unroll
      for (int j = 8; j < 11; ++j) dx[j * rows + row] = 0.f;
      dx[14 * rows + row] = 0.f;
      dx[15 * rows + row] = 0.f;
    } else if constexpr (CONTRACT) {  // posx's transpose at the contracted row, then the contraction's
      branch<T, KX, LXM, true, false, true>(g0 + row, g5 + row, Rp, sA, sB, H, x + row, rows, Lp, wx, d);
      float xo[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) xo[c] = x[c * rows + row];
      contract_transpose(xo, d);
    } else {
      branch<T, KX, LXM, true>(g0 + row, g5 + row, Rp, sA, sB, H, x + row, rows, Lp, wx, d);
    }
    branch<T, KP, LDM, false>(gc + row, nullptr, Rp, sC, nullptr, H2, x + 3 * rows + row, rows, Ld, wd, e, code);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dx[c * rows + row] = d[c];
      dx[(3 + c) * rows + row] = e[c];
    }
    dx[6 * rows + row] = 0.f;
    dx[7 * rows + row] = 0.f;
    if constexpr (KP == KDA)
#pragma unroll
      for (int j = 0; j < 8; ++j) dx[(8 + j) * rows + row] = code[j];
  }
}

// CONTRACT: a contracted model's instantiations (and no other is built).
template <class T, bool CONTRACT = false>
int launch_t(const char *gws, const float *x, long long rows, int Lp, int Ld, int H, const Weights &w,
             const float *wx, const float *wd, float *dx, cudaStream_t stream, bool app, bool mip) {
  const Layout L = make_layout(rows, Lp, Ld, H, app);
  const long long es = sizeof(T), smem = smem_bytes(H, app);
  decltype(&input_grad_kernel<T, KD>) kernel;
  if constexpr (CONTRACT)
    kernel = mip   ? input_grad_kernel<T, KD, true, true>
             : app ? input_grad_kernel<T, KDA, false, true>
                   : input_grad_kernel<T, KD, false, true>;
  else
    kernel = mip ? input_grad_kernel<T, KD, true> : app ? input_grad_kernel<T, KDA> : input_grad_kernel<T, KD>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);
  auto plane = [&](int f) { return reinterpret_cast<const T *>(gws + es * f * L.Rp); };
  kernel<<<grid, THREADS, smem, stream>>>(
      plane(L.gh(0)), plane(L.gh(5)), plane(L.gcs()), L.Rp, x, rows, Lp, Ld, H, L.FX, L.FD,
      static_cast<const T *>(w.W1), static_cast<const T *>(w.Wsx), static_cast<const T *>(w.Wcd), wx, wd, dx);
  return (int)cudaGetLastError();
}

#ifdef CONTRACT_LIBRARY
// dx (8, rows), or (16, rows) with `app` or `mip`, of a contracted model
// from the cotangent planes `gws` of the workspace, on `stream`; counts the
// launch (and the mip ones apart).
int launch_contract(const void *gws, const float *x, long long rows, int Lp, int Ld, int H, bool is_bf16,
                    const Weights &w, const float *wx, const float *wd, float *dx, cudaStream_t stream, bool app,
                    bool mip) {
  if (Lp > LXM || Ld > LDM || rows <= 0 || (wx == nullptr) != (wd == nullptr) || (mip && (wx || app)))
    return (int)cudaErrorInvalidValue;
  const char *g = static_cast<const char *>(gws);
  const int e = is_bf16 ? launch_t<bf16, true>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream, app, mip)
                        : launch_t<float, true>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream, app, mip);
  if (e == 0) {
    ++launches;
    mip_launches += mip;
  }
  return e;
}
#else
// The contract instantiation: csrc/fused_contract.cu's
// fused_contract_input_grad, which set_contract_input_grad hands to this
// library (as mlp_tile.cuh's contract_forward, and for the same reason).
typedef int (*ContractInputGrad)(const void *, const float *, long long, int, int, int, int, Weights, const float *,
                                 const float *, float *, int, int, void *);
ContractInputGrad contract_input_grad = nullptr;

// dx (8, rows), or (16, rows) with `app` or `mip`, from the cotangent
// planes `gws` of the workspace, on `stream`; counts the launch (and the
// mip ones apart). A contracted model's (`contract`, with or without mip)
// goes to contract_input_grad, whose library counts it.
int launch(const void *gws, const float *x, long long rows, int Lp, int Ld, int H, bool is_bf16,
           const Weights &w, const float *wx, const float *wd, float *dx, cudaStream_t stream, bool app = false,
           bool mip = false, bool contract = false) {
  if (contract) {
    if (!contract_input_grad) return (int)cudaErrorInvalidValue;
    return contract_input_grad(gws, x, rows, Lp, Ld, H, is_bf16, w, wx, wd, dx, app, mip, stream);
  }
  if (Lp > LXM || Ld > LDM || rows <= 0 || (wx == nullptr) != (wd == nullptr) || (mip && (wx || app)))
    return (int)cudaErrorInvalidValue;
  const char *g = static_cast<const char *>(gws);
  const int e = is_bf16 ? launch_t<bf16>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream, app, mip)
                        : launch_t<float>(g, x, rows, Lp, Ld, H, w, wx, wd, dx, stream, app, mip);
  if (e == 0) {
    ++launches;
    mip_launches += mip;
  }
  return e;
}
#endif

}  // namespace ig
}  // namespace
