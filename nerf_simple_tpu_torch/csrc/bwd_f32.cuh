// The f32 backward tile kernel of the fused NeRF MLP for Hopper (sm_90a).
// Included by mlp_tile.cuh inside its anonymous namespace, after
// fwd_f32.cuh, whose weight ring and register-tile products it uses (and
// through them fb's mbarrier and bulk-copy helpers): bwd_tile() launches
// it for every f32 path (B1 and B2, and the standalone backward_tile).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_backprop_tile's chain of
// mTg products (:808-841), in f32: from the output cotangents of a tile of
// sample rows back through W^T and each relu mask to the cotangent of
// every layer, each written to its plane of the workspace (the weight-
// gradient sums, csrc/wgrad.cuh, read them afterwards). Numerics: full f32
// FMA products (no TF32), masks h > 0, each output's terms summed in
// order of k with one fmaf a term from zero, as the earlier kernel did,
// so the planes are the same bit for bit.
//
// What bounds it: the FMA pipes. A sample row costs 494,592 multiply-adds
// at the flagship (524,288 rows: 7.74 ms at 67 TFLOP/s); it also reads
// 2,176 residual features and writes 2,192 cotangent features, 17.5 KB a
// row (2.74 ms at 3.35 TB/s), which has to run under the products.
//
// Design (fwd_f32.cuh's recipe, run in reverse):
//  - One block an SM (persistent grid) walks 128-row tiles with 16 warps,
//    every one of them multiplying. A thread owns features 128 i + 4 fo +
//    {0..3} (i < NP: NP = 2 for the H-wide outputs when H > 128, else 1)
//    and rows 64 h + 4 ro + {0..3} (h < 2): ff's 8 x 8 register tile,
//    fragments loaded one k ahead.
//  - One cotangent tile [feature][row] (128 KB at H = 256): when a
//    layer's product is done its whole output is in the accumulators, so
//    after one barrier the epilogue writes the masked result over the
//    input, and one more barrier makes it the next product's input. No
//    barrier inside a product. W_c1^T (O = H/2) runs with NP = 1 over the
//    same thread grid, so no thread idles at the flagship. g_cs's sigma
//    row and its seven zero rows go into the tile with g_rgb8, before any
//    product.
//  - The transposed weights stream through ff's ring (up to MAX_STAGES
//    stages of 16 weight rows; 6 at the flagship, where the backward's
//    tile leaves ~99 KB; 3 to 6 ran alike), refilled by the last warp to
//    read a stage. The copies come from a backward weight image that one
//    small launch builds at every call (bwd_image_kernel: 1.9 MB at the
//    flagship): slice c of W^T [k][o] is rows 16c .. 16c + 15 of the
//    packed (out, in) matrix, each row zero-padded to 128 NP features and
//    W_c1's 8 rows to 16. So one bulk copy fills a stage at every width
//    (H <= 128 and 144..240 need the padding the packed rows do not
//    have), and the f32 paths make no transposed copies of the weights.
//  - Masks off the device-memory path: as each layer's product starts,
//    every thread prefetches two 128-byte lines of the tile's residual
//    plane into L2 (the block's lines of the plane, 128 KB at the
//    flagship), so the epilogue's float4 mask loads (8 NP a thread) wait
//    on L2, not on device memory. hc's lines, for the short W_c1^T
//    product, are prefetched with the tile's inputs. Keeping the masks in
//    registers instead (a float4 a slice packed into a 64-bit mask) or in
//    shared memory (a cp.async a slice) ran no faster and spilled: the
//    products leave no registers.
//  - Registers: the 8 x 8 tile, its fragments and the ring's cursor take
//    ~all 128 that 16 warps leave a thread; the row stride is made opaque
//    to the compiler once a tile, so that the planes' addresses are
//    computed in the tile and not hoisted before it (and spilled).
//  - Cotangent planes: each epilogue stores its float4s along the rows,
//    eight lanes a feature: one 128-byte line a feature a store.
//  - Ragged rows: rows past `rows` read zero output cotangents, so every
//    cotangent there is zero (the sums rely on it); a 64-row half past Rp
//    reads and writes no plane but still walks the ring.
//  - Each row's chain is its own: no atomics, bitwise reproducible.

#pragma once

namespace fw {

using ff::KS;
using ff::ROWS;
using ff::THREADS;
using fb::SMEM_LIMIT;

constexpr int MAX_STAGES = 6;

// The transposed matrices in the order the kernel multiplies by them
// (weight image order): Wc1^T, Wcs^T, Wp1^T, Wp0^T, Wsh^T, Wt4^T .. Wt1^T.
// Matrix m is W^T (O(m), K(m)): the packed (out, in) = (K(m), O(m)) matrix
// read as (in, out).
struct Plan {
  static constexpr int NMAT = 9;
  int H;
  __host__ __device__ int NI() const { return H > 128 ? 2 : 1; }
  __host__ __device__ int O(int m) const { return m == 0 ? H / 2 : H; }
  __host__ __device__ int K(int m) const { return m == 0 ? 8 : m == 1 ? H / 2 + 8 : H; }
  // output features of a slice, zero-padded: 128 a feature group
  __host__ __device__ int OP(int m) const { return m == 0 ? 128 : 128 * NI(); }
  __host__ __device__ int slices(int m) const { return (K(m) + KS - 1) / KS; }
  __host__ __device__ long long slice_bytes(int m) const { return 4LL * KS * OP(m); }
  __host__ __device__ long long image_bytes() const {
    long long b = 0;
    for (int m = 0; m < NMAT; ++m) b += slices(m) * slice_bytes(m);
    return b;
  }
  __host__ __device__ long long stage_bytes() const { return 4LL * KS * 128 * NI(); }
  // the cotangent tile, the full barriers and the release counts
  __host__ __device__ long long fixed_bytes() const { return 4LL * ROWS * H + 2 * MAX_STAGES * 8; }
  __host__ __device__ int stages() const {
    const long long s = (SMEM_LIMIT - fixed_bytes()) / stage_bytes();
    return s < 2 ? 2 : s > MAX_STAGES ? MAX_STAGES : (int)s;
  }
  __host__ __device__ long long smem_bytes() const { return stages() * stage_bytes() + fixed_bytes(); }
  // element (o, k) of W^T of matrix m: element (k, o) of the packed matrix
  __device__ float weight(const Weights &w, int m, int k, int o) const {
    const void *const mats[NMAT] = {w.Wc1, w.Wcs, w.Wp1, w.Wp0, w.Wsh, w.Wt4, w.Wt3, w.Wt2, w.Wt1};
    return static_cast<const float *>(mats[m])[(long long)k * O(m) + o];
  }
};

using Ring = ff::Ring<Plan>;

// Where a thread stands in the tile; every field is live anyway.
struct At {
  long long Rp, row0;
  int fo4, ro4;
  __device__ __forceinline__ bool live1() const { return row0 + 64 < Rp; }  // the second 64-row half
};

// The thread's masks of one residual plane: load n (< 8 NP) reads the
// float4 of feature fo4 + df(n) at rows 64 (n % 2) + ro4 + {0..3}, the
// residuals of accumulators acc[4 i + j][4 hh + e] for n = 8 i + 2 j + hh.
// A load past the plane's O features, or in a half past Rp, reads nothing
// and gives zeros.
__device__ __forceinline__ int df(int n) { return 128 * (n >> 3) + ((n >> 1) & 3); }
__device__ __forceinline__ bool mask_ok(int n, int O, const At &a) {
  return a.fo4 + df(n) < O && (!(n & 1) || a.live1());
}
// h: the plane at the thread's feature fo4 and row row0 + ro4
__device__ __forceinline__ const float *mask_at(const float *h, int n, const At &a) {
  return h + df(n) * a.Rp + 64 * (n & 1);
}
__device__ __forceinline__ float4 mask_load(const float *h, int n, int O, const At &a) {
  if (!mask_ok(n, O, a)) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldcs(reinterpret_cast<const float4 *>(mask_at(h, n, a)));
}
// The lines of the thread's masks into L2, as the layer's product starts
// (h: the plane at the thread's feature fo4 and row row0 + ro4): the eight
// lanes of equal fo4 read one 128-byte line a load, so each of them
// prefetches two of their 8 NP lines (NP = 1: each line twice).
template <int NP>
__device__ __forceinline__ void prefetch_masks(const float *h, int O, const At &a) {
  const int n0 = 2 * ((threadIdx.x & 7) % (4 * NP));
#pragma unroll
  for (int n = n0; n < n0 + 2; ++n)
    if (mask_ok(n, O, a)) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(mask_at(h, n, a)));
}

// One layer's epilogue, between two barriers: out[o][r] = acc * (h > 0)
// for the thread's features o < O (i < NP), over the input tile and to
// the cotangent plane; resets acc. h: the residual plane at the thread's
// feature fo4 and row row0 + ro4, its lines prefetched into L2.
template <int NI, int NP>
__device__ __forceinline__ void epilogue(float (&acc)[4 * NI][8], const float *h, int O, float *out, float *plane,
                                         const At &a) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 128 * i + a.fo4 + j;
      if (o < O) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float4 m = mask_load(h, 8 * i + 2 * j + hh, O, a);
          const float mk[4] = {m.x, m.y, m.z, m.w};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = mk[e] > 0.f ? acc[4 * i + j][4 * hh + e] : 0.f;
          const float4 q = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4 *>(out + o * ROWS + 64 * hh + a.ro4) = q;
          if (a.row0 + 64 * hh < a.Rp)
            *reinterpret_cast<float4 *>(plane + o * a.Rp + a.row0 + 64 * hh + a.ro4) = q;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[4 * i + j][e] = 0.f;
    }
}

// NI: the feature groups of a thread in the H-wide outputs (2 for H > 128).
template <int NI>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const float *__restrict__ g, long long rows, int Lp, int Ld, int H, const char *__restrict__ image,
               const float *__restrict__ res, float *__restrict__ gws) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan P{H};
  const int stages = P.stages(), H2 = H / 2;
  const long long ntiles = (rows + ROWS - 1) / ROWS;
  char *buf = reinterpret_cast<char *>(smem);
  float *act = reinterpret_cast<float *>(buf + stages * P.stage_bytes());
  uint64_t *full = reinterpret_cast<uint64_t *>(act + H * ROWS);
  int *count = reinterpret_cast<int *>(full + MAX_STAGES);
  Ring rg{buf, full, count, image, P, ntiles, (int)P.stage_bytes(), stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      fb::mbar_init(full + s, 1);
      count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  rg.start();
  __syncthreads();

  const int t = threadIdx.x, lane = t & 31, wq = t >> 5;
  const int fo4 = 4 * (4 * (wq & 7) + (lane >> 3)), ro4 = 4 * (8 * (wq >> 3) + (lane & 7));
  const Layout L = make_layout(rows, Lp, Ld, H);
  float acc[4 * NI][8] = {};
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // Rp, opaque to the compiler once a tile: the planes' addresses are then
    // computed in the tile rather than all before the loop, where they do
    // not fit in the registers the products leave
    long long Rp = L.Rp;
    asm volatile("" : "+l"(Rp));
    const At a{Rp, tile * ROWS, fo4, ro4};
    // the residual plane at feature f, at the thread's feature fo4 and row row0 + ro4
    auto plane = [&](int f) { return res + (f + fo4) * a.Rp + a.row0 + ro4; };
    // a layer's product (np: its output feature groups, a std::integral_constant)
    // and its epilogue over `act` into the cotangent plane at feature gf, with
    // masks from the residual plane at feature hf: O = H, or H/2 for W_c1^T,
    // whose masks are prefetched with the tile's inputs (pre false)
    auto layer = [&](auto np, int K, int O, int hf, int gf, bool pre) {
      constexpr int NP = decltype(np)::value;
      if (pre) prefetch_masks<NP>(plane(hf), O, a);
      ff::product<NI, NP>(acc, rg, act, K, a.fo4, a.ro4, lane);
      __syncthreads();  // every product has read `act`
      epilogue<NI, NP>(acc, plane(hf), O, act, gws + gf * a.Rp, a);
      __syncthreads();
    };
    prefetch_masks<1>(plane(L.hc()), H2, a);
    __syncthreads();  // the last tile's epilogue has written `act`
    // g_rgb8 = [d_rgb ; 0 x 5] into rows 0..7 and [g_sigma ; 0 x 7] into
    // rows H2..H2+7 (the sigma rows of g_cs), both also to their planes
    for (int idx = t; idx < 8 * ROWS; idx += THREADS) {
      const int k = idx / ROWS, r = idx % ROWS;
      const long long row = a.row0 + r;
      const bool in = row < rows;
      const float vr = k < 3 && in ? g[k * rows + row] : 0.f;
      const float vs = k == 0 && in ? g[3 * rows + row] : 0.f;
      act[k * ROWS + r] = vr;
      act[(H2 + k) * ROWS + r] = vs;
      if (row < a.Rp) {
        gws[(L.gr8() + k) * a.Rp + row] = vr;
        gws[(L.gcs() + H2 + k) * a.Rp + row] = vs;
      }
    }
    __syncthreads();
    const auto one = std::integral_constant<int, 1>();
    const auto all = std::integral_constant<int, NI>();
    layer(one, 8, H2, L.hc(), L.gcs(), false);     // g_hc = mask(hc) Wc1^T g_rgb8
    layer(all, H2 + 8, H, L.h(7), L.gh(7), true);  // g_h7 = mask(h7) Wcs^T g_cs
    // g_h(l) = mask(h_l) W^T g_h(l+1): Wp1 .. Wt1
    for (int l = 6; l >= 0; --l) layer(all, H, H, L.h(l), L.gh(l), true);
  }
}

// The backward weight image (ff::image_at): slice c of matrix m is rows
// KS c .. KS c + KS - 1 of the packed matrix. One thread a float.
__global__ void bwd_image_kernel(Weights w, Plan P, long long n, float *image) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u < n) image[u] = ff::image_at(w, P, u);
}

int build_image(const Weights &w, const Plan &P, void *image, cudaStream_t stream) {
  const long long n = P.image_bytes() / 4;
  bwd_image_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(w, P, n, static_cast<float *>(image));
  return (int)cudaGetLastError();
}

// The weight image, then the persistent grid: one block an SM, at most one
// a tile. `image` holds P.image_bytes(), 16-byte aligned; `res` and `gws`
// are the workspace's planes (Layout), 16-byte aligned.
int launch(const float *g, long long rows, int Lp, int Ld, int H, const Weights &w, const float *res, float *gws,
           void *image, cudaStream_t stream) {
  const Plan P{H};
  if (int e = build_image(w, P, image, stream)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = P.NI() == 2 ? bwd_kernel<2> : bwd_kernel<1>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem_bytes());
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (rows + ROWS - 1) / ROWS;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, THREADS, P.smem_bytes(), stream>>>(g, rows, Lp, Ld, H, static_cast<const char *>(image), res,
                                                    gws);
  return (int)cudaGetLastError();
}

}  // namespace fw
