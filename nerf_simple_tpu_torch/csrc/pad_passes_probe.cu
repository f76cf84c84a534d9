// Padding probe for Hopper (sm_90a): does a bf16 matmul of contraction
// depth K = 72 cost what K = 80 costs, or what K = 128 costs? The packed
// layout pads posx to K = 72 and posd to K = 40, and mma.sync takes K in
// steps of 16.
//
// Replaces: scripts/pad_passes_probe.py::build (the pallas_call of
// _kernel), the TPU probe of the same question for the MXU's 128-deep
// passes.
//
// Contract (the TPU kernel's): x (K, TR), W (256, K) f32; out (256, TR)
// f32 = acc after `reps` steps of acc += W . bf16(x + acc[:K] * 1e-20),
// both operands rounded to bf16, products summed in f32, acc starting at
// 0. The recurrence runs through the matmul, so no step can be hoisted
// or merged; the 1e-20 keeps the values where they are.
//
// What bounds it on this card: the tensor cores. A block holds its W
// rows as mma A fragments in registers for all `reps` steps and its
// acc tile in registers; device memory is touched once before and once
// after the loop. Per step the warps that own rows < K write xi to
// shared memory (an elementwise stage of K x 64 values, as the TPU
// probe's VPU add), then every warp runs ceil(K/16) x 16 mma.sync
// m16n8k16. So the measured cost of K is ceil(K/16) k-steps of mma plus
// that stage.
//
// Design: columns are independent, so each block owns a slice of TC = 64
// columns and all 256 rows; warp w owns rows 32w..32w+31 (two m16 tiles)
// x the 64 columns (eight n8 tiles). K is a template parameter in k-steps
// (KS = ceil(K/16) <= 8), so the fragment arrays stay in registers. One
// block an SM (~200 registers a thread); the caller picks TR to fill the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 256;        // output rows
constexpr int TC = 64;        // columns a block owns
constexpr int THREADS = 256;  // 8 warps

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16 *p) {
  return *reinterpret_cast<const uint32_t *>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
    probe_kernel(const float *__restrict__ x, const float *__restrict__ W, int K,
                 long long TR, int reps, float *__restrict__ out) {
  constexpr int LDX = 16 * KS + 8;  // 4 mod 8 words a row: conflict-free fragment loads
  __shared__ __align__(16) bf16 xs[TC * LDX];  // xi as [column][k]; k >= K stays 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long c0 = (long long)blockIdx.x * TC;

  for (int i = threadIdx.x; i < TC * LDX; i += THREADS) xs[i] = __float2bfloat16_rn(0.f);
  __syncthreads();  // the zeros land before the first step's xi

  // This warp's rows of W as A fragments, columns past K zero.
  auto wv = [&](int o, int k) { return k < K ? W[o * K + k] : 0.f; };
  uint32_t a[2][KS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int o = warp * 32 + mt * 16 + g, k = ks * 16 + 2 * t;
      a[mt][ks][0] = pack2(wv(o, k), wv(o, k + 1));
      a[mt][ks][1] = pack2(wv(o + 8, k), wv(o + 8, k + 1));
      a[mt][ks][2] = pack2(wv(o, k + 8), wv(o, k + 9));
      a[mt][ks][3] = pack2(wv(o + 8, k + 8), wv(o + 8, k + 9));
    }

  // Fragment element q of (mt, nt): row o = warp*32 + mt*16 + g (+8 for
  // q >= 2), column r = nt*8 + 2t (+1 for odd q).
  float xr[2][8][4], acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = warp * 32 + mt * 16 + g + (q >= 2 ? 8 : 0);
        const long long c = c0 + nt * 8 + 2 * t + (q & 1);
        xr[mt][nt][q] = (o < K && c < TR) ? x[o * TR + c] : 0.f;
        acc[mt][nt][q] = 0.f;
      }

  for (int it = 0; it < reps; ++it) {
    if (warp * 32 < K) {  // xi = bf16(x + acc[:K] * 1e-20), not contracted to an fma
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int o = warp * 32 + mt * 16 + g + (q >= 2 ? 8 : 0);
            const int r = nt * 8 + 2 * t + (q & 1);
            if (o < K)
              xs[r * LDX + o] = __float2bfloat16_rn(
                  __fadd_rn(xr[mt][nt][q], __fmul_rn(acc[mt][nt][q], 1e-20f)));
          }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16 *x0 = xs + (nt * 8 + g) * LDX + ks * 16 + 2 * t;
        const uint32_t b0 = ld32(x0), b1 = ld32(x0 + 8);
        mma(acc[0][nt], a[0][ks], b0, b1);
        mma(acc[1][nt], a[1][ks], b0, b1);
      }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = warp * 32 + mt * 16 + g + (q >= 2 ? 8 : 0);
        const long long c = c0 + nt * 8 + 2 * t + (q & 1);
        if (c < TR) out[o * TR + c] = acc[mt][nt][q];
      }
}

template <int KS>
void launch(const float *x, const float *W, float *out, int K, long long TR, int reps,
            cudaStream_t s) {
  probe_kernel<KS><<<(unsigned)((TR + TC - 1) / TC), THREADS, 0, s>>>(x, W, K, TR, reps, out);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller allocates `out` (256, TR) f32 and checks shapes and types.
int pad_passes_probe(const float *x, const float *W, float *out, int K, long long TR, int reps,
                     void *stream) {
  if (K < 1 || K > 128 || TR <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((K + 15) / 16) {
    case 1: launch<1>(x, W, out, K, TR, reps, s); break;
    case 2: launch<2>(x, W, out, K, TR, reps, s); break;
    case 3: launch<3>(x, W, out, K, TR, reps, s); break;
    case 4: launch<4>(x, W, out, K, TR, reps, s); break;
    case 5: launch<5>(x, W, out, K, TR, reps, s); break;
    case 6: launch<6>(x, W, out, K, TR, reps, s); break;
    case 7: launch<7>(x, W, out, K, TR, reps, s); break;
    default: launch<8>(x, W, out, K, TR, reps, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
