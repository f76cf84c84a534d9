// The bf16 backward tile kernel of the fused NeRF MLP for Hopper (sm_90a).
// Included by mlp_tile.cuh inside its anonymous namespace, after
// fwd_bf16.cuh, whose ring, products, stores and swizzle it uses:
// bwd_tile() launches it for every bf16 path (B1 and B2, and the
// standalone backward_tile).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_backprop_tile's chain of
// mTg products (:805-841), in bf16: from the output cotangents of a tile
// of sample rows back through W^T and each relu mask to the cotangent of
// every layer, each written to its plane of the workspace (the weight-
// gradient sums, csrc/wgrad.cuh, read them afterwards).
//
// What bounds it: memory. It reads the residual planes of h0..h7 and hc
// (8 H + H/2 bf16 planes) and writes the cotangent planes (16 + H/2 +
// 8 H): 4.58 GB at 524,288 rows at the flagship, 1.37 ms at 3.35 TB/s,
// against ~0.49 M multiply-adds a row (0.52 ms at 989 TFLOP/s).
// Numerics are the TPU kernel's: bf16 operands, f32 sums, each cotangent
// g_l = bf16(mask(h_l > 0) * W^T g_(l+1)) rounded once, and that value
// feeds both the next product and its plane.
//
// Design (the recipe of fwd_bf16.cuh, run in reverse):
//  - A persistent grid, one block an SM, walks 128-row tiles. Two
//    consumer warpgroups hold 64 rows each; a producer warpgroup gives its
//    registers away (setmaxnreg 40 against 232) and one of its threads
//    streams the transposed weights through the ring.
//  - A consumer keeps its rows' cotangent tile [row][feature] in shared
//    memory in the 128-byte swizzle and runs wgmma m64nNk16 on it against
//    the ring's slices: N = H for W_cs^T and the seven-matrix chain, H/2
//    for W_c1^T; K = 8 (W_c1^T) and H/2 + 8 (W_cs^T) are padded to 16 with
//    zeros. Each epilogue masks and rounds in place with stmatrix stores.
//  - The ring is filled from a backward weight image that one small launch
//    builds at every call straight from the packed (out, in) matrices:
//    W^T in K-slices of 64 columns, already swizzled, so a slice is one
//    cp.async.bulk. No transposed copies are made on the host side.
//  - Masks, line-wise: before each layer's products the consumers start
//    16-byte cp.async copies of the layer's residual plane (eight lanes a
//    feature, whole 128-byte lines) into a stage of their own, feature-
//    major and swizzled; the copies land while the products run, and the
//    epilogue reads each mask fragment with ldmatrix.trans, in exactly the
//    accumulators' layout, free of bank conflicts.
//  - Cotangent planes, line-wise: the epilogue also writes each result,
//    transposed (stmatrix.trans), over the mask it was read from, so the
//    stage then holds the cotangents feature-major; each plane leaves as
//    16-byte copies, four whole lines a warp store, and a thread refills
//    with the next layer's residuals the chunks it has just copied out.
//  - Shared memory at H = 256: two cotangent tiles (2 x 32 KB), two
//    residual stages (2 x 32 KB) and a 3-stage ring (3 x 32 KB): 225 KB.
//  - Ragged rows: rows past `rows` read zero output cotangents, so every
//    cotangent there is zero (the sums rely on it); a 64-row unit past Rp
//    reads and writes nothing but still walks the ring. Each row's chain
//    is its own: no atomics, bitwise reproducible.

#pragma once

namespace bb {

using fb::CHUNK;
using fb::CONSUMERS;
using fb::MAX_STAGES;
using fb::ROWS;
using fb::SMEM_LIMIT;
using fb::THREADS;
using fb::TILE;
using fb::ceil64;
using fb::chunks;
using fb::saddr;
using fb::sw;

constexpr int NMAT = 9;

// The transposed matrices in the order the kernel multiplies by them
// (weight image order): Wc1^T, Wcs^T, Wp1^T, Wp0^T, Wsh^T, Wt4^T .. Wt1^T.
// Matrix m is (N(m), K(m)): the forward's (out, in) read as (in, out).
struct Plan {
  int H;
  __host__ __device__ int N(int m) const { return m == 0 ? H / 2 : H; }
  __host__ __device__ int K(int m) const { return m == 0 ? 8 : m == 1 ? H / 2 + 8 : H; }
  __host__ __device__ int npad(int m) const { return ceil64(N(m)); }  // rows of a slice: the product's N
  __host__ __device__ long long slice_bytes(int m) const { return 128LL * npad(m); }
  __host__ __device__ long long image_bytes() const {
    long long b = 0;
    for (int m = 0; m < NMAT; ++m) b += chunks(K(m)) * slice_bytes(m);
    return b;
  }
  __host__ __device__ long long stage_bytes() const { return 128LL * ceil64(H); }
  __host__ __device__ long long tile_bytes() const { return chunks(H) * (long long)CHUNK; }
  // a warpgroup's residual stage: up to H feature lines of its 64 rows
  __host__ __device__ long long res_bytes() const { return 128LL * H; }
  // align slack, both warpgroups' tiles and residual stages, the barriers
  __host__ __device__ long long fixed_bytes() const {
    return 1024 + CONSUMERS * (tile_bytes() + res_bytes()) + 2 * MAX_STAGES * 8;
  }
  __host__ __device__ int stages() const {
    const long long s = (SMEM_LIMIT - fixed_bytes()) / stage_bytes();
    return s < 2 ? 2 : s > MAX_STAGES ? MAX_STAGES : (int)s;
  }
  __host__ __device__ long long smem_bytes() const { return fixed_bytes() + stages() * stage_bytes(); }
};

// Byte offset of the 16-byte chunk c (rows 8c .. 8c + 7) of feature line f
// in a residual stage: chunk c of line f sits at c ^ (f % 8), so the eight
// lines an ldmatrix reads at one chunk fall in distinct banks.
__device__ __forceinline__ int rsw(int f, int c) { return f * 128 + ((c ^ (f & 7)) << 4); }

// Start copying features 0..F-1 (F a multiple of 16) of the residual planes
// at `src` (row stride Rp, the warpgroup's 64 rows) into the stage: eight
// lanes a feature, 16 bytes (8 rows) each.
__device__ __forceinline__ void load_res(const bf16 *src, int F, long long Rp, char *rs, int tid) {
  for (int i = tid; i < 8 * F; i += 128) {
    const int f = i >> 3, c = i & 7;
    cp_async16(rs + rsw(f, c), src + f * Rp + 8 * c);
  }
}

// Four (two) 8x8 bf16 blocks, transposed: lane l gives the address of line
// l % 8 of block l / 8.
__device__ __forceinline__ void ldsm4t(const char *p, uint32_t &a, uint32_t &b, uint32_t &c, uint32_t &d) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm2t(const char *p, uint32_t &a, uint32_t &b) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a), "=r"(b) : "r"(saddr(p)) : "memory");
}
// Their inverse: the stores of fragments back to those blocks, transposed.
__device__ __forceinline__ void stsm4t(char *p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(saddr(p)),
               "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}
__device__ __forceinline__ void stsm2t(char *p, uint32_t a, uint32_t b) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(saddr(p)), "r"(a),
               "r"(b) : "memory");
}

// bf16 pair of (a where the low residual of m > 0, b where the high one
// is), zero elsewhere.
__device__ __forceinline__ uint32_t mask2(float a, float b, uint32_t m) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__uint_as_float(m << 16) > 0.f ? a : 0.f,
                                                 __uint_as_float(m & 0xFFFF0000u) > 0.f ? b : 0.f);
  return *reinterpret_cast<const uint32_t *>(&v);
}

// tile[r][n] = bf16(d * (residual[n][r] > 0)) for the output features n <
// O (a multiple of 8), 16 features at a time: one ldmatrix.trans of the
// masks from the stage (the accumulators' fragment layout: the residual
// of row 8h + g, features 2q, 2q + 1 of each block), one stmatrix into
// the tile, and one stmatrix.trans of the same values back over the masks
// they replace: the stage then holds the cotangents feature-major, as
// their planes lay them out.
__device__ __forceinline__ void epilogue(const float (&d)[128], char *rs, int O, char *tile, int tid) {
  const int wr = tid >> 5, lane = tid & 31;
  const int srow = 16 * wr + 8 * ((lane >> 3) & 1) + (lane & 7), scol = 8 * (lane >> 4);
  const int mf = (lane & 7) + scol, mc = 2 * wr + ((lane >> 3) & 1);  // line and chunk this lane addresses
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    if (8 * j >= O) break;
    char *m = rs + rsw(8 * j + mf, mc);
    if (8 * j + 8 < O) {
      uint32_t m0, m1, m2, m3;
      ldsm4t(m, m0, m1, m2, m3);
      const uint32_t v0 = mask2(d[4 * j], d[4 * j + 1], m0), v1 = mask2(d[4 * j + 2], d[4 * j + 3], m1);
      const uint32_t v2 = mask2(d[4 * j + 4], d[4 * j + 5], m2), v3 = mask2(d[4 * j + 6], d[4 * j + 7], m3);
      fb::stsm4(tile + sw(srow, 8 * j + scol), v0, v1, v2, v3);
      stsm4t(m, v0, v1, v2, v3);
    } else {
      uint32_t m0, m1;
      ldsm2t(m, m0, m1);
      const uint32_t v0 = mask2(d[4 * j], d[4 * j + 1], m0), v1 = mask2(d[4 * j + 2], d[4 * j + 3], m1);
      fb::stsm2(tile + sw(srow, 8 * j), v0, v1);
      stsm2t(m, v0, v1);
    }
  }
}

// Features 0..F-1 of the stage to their planes plane[f][row0 + r], row
// stride Rp: a 16-byte copy each, eight lanes a feature, four whole lines
// a warp store. A thread copies out the chunks that load_res has it fill
// (the same (f, c) for each i), so it may start refilling the stage
// without a barrier.
__device__ __forceinline__ void drain(const char *rs, int F, bf16 *plane, long long Rp, int tid) {
  for (int i = tid; i < 8 * F; i += 128) {
    const int f = i >> 3, c = i & 7;
    *reinterpret_cast<uint4 *>(plane + f * Rp + 8 * c) = *reinterpret_cast<const uint4 *>(rs + rsw(f, c));
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t *>(&v);
}

// HF: the width H where it is fixed at build time (the flagship's 256);
// 0 where H is taken at run time.
template <int HF>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const float *__restrict__ g, long long rows, int Lp, int Ld, int H_,
               const char *__restrict__ image, const bf16 *__restrict__ res, bf16 *__restrict__ gws) {
  constexpr int NH = HF ? ceil64(HF) : 0, NH2 = HF ? ceil64(HF / 2) : 0;
  const int H = HF ? HF : H_;
  extern __shared__ unsigned char smem_raw[];
  char *smem = reinterpret_cast<char *>(smem_raw) +
               ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);  // swizzle atoms
  const Plan P{H};
  const int stages = P.stages();
  char *stage_res = smem + CONSUMERS * P.tile_bytes();
  fb::Ring rg{stage_res + CONSUMERS * P.res_bytes(), nullptr, nullptr, (int)P.stage_bytes(), stages};
  rg.full = reinterpret_cast<uint64_t *>(rg.buf + stages * rg.stage_bytes);
  rg.empty = rg.full + MAX_STAGES;
  const long long ntiles = (rows + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      fb::mbar_init(rg.full + s, 1);
      fb::mbar_init(rg.empty + s, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wq = threadIdx.x >> 7;

  if (wq == CONSUMERS) {  // the producer: one thread walks the slices of every tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128) return;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const char *src = image;
      for (int m = 0; m < NMAT; ++m) {
        const uint32_t bytes = (uint32_t)P.slice_bytes(m);
        for (int c = 0; c < chunks(P.K(m)); ++c, src += bytes, rg.advance()) {
          fb::mbar_wait(rg.empty + rg.stage, rg.phase ^ 1);
          fb::bulk_load(rg.buf + rg.stage * rg.stage_bytes, src, bytes, rg.full + rg.stage);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127, H2 = H / 2;
  char *tile = smem + wq * P.tile_bytes();
  char *rs = stage_res + wq * P.res_bytes();
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long Rp = L.Rp;
  const int nh = P.npad(2), nh2 = P.npad(0);
  const int r = tid & (ROWS - 1), half = tid >> 6;  // the row this thread loads g for
  float d[128] = {};
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * TILE + wq * ROWS;
    const bool live = row0 < Rp;
    auto fetch = [&](int f0, int F) {  // start the copies of the next mask's residual planes
      if (live) load_res(res + f0 * Rp + row0, F, Rp, rs, tid);
      cp_async_commit();
    };
    auto masked = [&](int O) {  // the products are issued: mask and round in place
      cp_async_wait<0>();
      fb::bar_wg(wq);  // every product has read `tile`; every copy into `rs` has landed
      epilogue(d, rs, O, tile, tid);
    };
    auto visible = [&] {  // the new values of `tile` and `rs`, to the warpgroup and its products
      fb::to_async();
      fb::bar_wg(wq);
    };
    auto planes = [&](int F, int f) {  // the stage's features 0..F-1 to the cotangent planes at f
      if (live) drain(rs, F, gws + f * Rp + row0, Rp, tid);
    };
    fb::bar_wg(wq);  // the last tile's plane stores have read `rs`
    fetch(L.hc(), H2);
    // g_rgb8 = bf16([d_rgb ; 0 x 5]) into features 0..7, zeros in 8..15
    // (the product's K of 8, padded to 16); d_sigma waits in a register
    const long long row = row0 + r;
    const bool in = row < rows;
    float sig = 0.f;
    if (half == 0) {
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = in ? g[c * rows + row] : 0.f;
      *reinterpret_cast<uint4 *>(tile + sw(r, 0)) = make_uint4(pack2(v[0], v[1]), pack2(v[2], 0.f), 0u, 0u);
    } else {
      *reinterpret_cast<uint4 *>(tile + sw(r, 8)) = make_uint4(0u, 0u, 0u, 0u);
      sig = in ? g[3 * rows + row] : 0.f;
    }
    visible();
    if (live) fb::store_planes(tile, 8, gws + L.gr8() * Rp, Rp, row0, tid);
    fb::product<NH2>(d, rg, tile, 8, nh2, false);  // g_hc = mask(hc) Wc1^T g_rgb8
    masked(H2);
    // g_cs = [g_hc ; g_sigma ; 0 x 7]: in the tile, then zeros up to the K
    // step of 16; in the stage, lines H2 .. H2 + 7
    if (half) {
      *reinterpret_cast<uint4 *>(tile + sw(r, H2)) = make_uint4(pack2(sig, 0.f), 0u, 0u, 0u);
      *reinterpret_cast<uint4 *>(tile + sw(r, H2 + 8)) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<bf16 *>(rs + rsw(H2, r >> 3) + 2 * (r & 7)) = __float2bfloat16_rn(sig);
    } else if (tid < 56) {
      *reinterpret_cast<uint4 *>(rs + rsw(H2 + 1 + (tid >> 3), tid & 7)) = make_uint4(0u, 0u, 0u, 0u);
    }
    visible();
    planes(H2 + 8, L.gcs());
    fetch(L.h(7), H);
    fb::product<NH>(d, rg, tile, H2 + 8, nh, false);  // g_h7 = mask(h7) Wcs^T g_cs
    masked(H);
    visible();
    for (int l = 6; l >= 0; --l) {  // g_h(l) = mask(h_l) W^T g_h(l+1): Wp1, Wp0, Wsh, Wt4 .. Wt1
      planes(H, L.gh(l + 1));
      fetch(L.h(l), H);
      fb::product<NH>(d, rg, tile, H, nh, false);
      masked(H);
      visible();
    }
    planes(H, L.gh(0));
  }
}

// The backward weight image: matrix m of the Plan's order, W^T in K-slices
// of 64 columns, each slice (npad(m), 64) bf16 in the 128-byte swizzle,
// rows past N and columns past K zero. Read straight from the packed (K,
// N) matrices: element (n, k) of W^T is W[k][n]. One thread a 16-byte unit.
__global__ void bwd_image_kernel(Weights w, Plan P, long long units, char *image) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  long long off = 16 * u;
  int m = 0;
  for (; m < NMAT - 1; ++m) {
    const long long b = chunks(P.K(m)) * P.slice_bytes(m);
    if (off < b) break;
    off -= b;
  }
  const void *const mats[NMAT] = {w.Wc1, w.Wcs, w.Wp1, w.Wp0, w.Wsh, w.Wt4, w.Wt3, w.Wt2, w.Wt1};
  const uint16_t *W = static_cast<const uint16_t *>(mats[m]);
  const int N = P.N(m), K = P.K(m);
  const long long sb = P.slice_bytes(m);
  const int c = (int)(off / sb), n = (int)(off % sb) / 128, pos = (int)(off % 128) / 16;
  const int k0 = 64 * c + 8 * (pos ^ (n & 7));  // the logical chunk stored at `pos`
  uint16_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = n < N && k0 + e < K ? W[(long long)(k0 + e) * N + n] : 0;
  uint4 o;
  o.x = v[0] | (uint32_t)v[1] << 16;
  o.y = v[2] | (uint32_t)v[3] << 16;
  o.z = v[4] | (uint32_t)v[5] << 16;
  o.w = v[6] | (uint32_t)v[7] << 16;
  reinterpret_cast<uint4 *>(image)[u] = o;
}

int build_image(const Weights &w, const Plan &P, void *image, cudaStream_t stream) {
  const long long units = P.image_bytes() / 16;
  bwd_image_kernel<<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(w, P, units, static_cast<char *>(image));
  return (int)cudaGetLastError();
}

// The weight image, then the persistent grid: one block an SM, at most one
// a tile. `image` holds P.image_bytes(), 16-byte aligned; `res` and `gws`
// are the workspace's planes (Layout), 16-byte aligned.
int launch(const float *g, long long rows, int Lp, int Ld, int H, const Weights &w, const bf16 *res,
           bf16 *gws, void *image, cudaStream_t stream) {
  const Plan P{H};
  if (int e = build_image(w, P, image, stream)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = H == 256 ? bwd_kernel<256> : bwd_kernel<0>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem_bytes());
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (rows + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, THREADS, P.smem_bytes(), stream>>>(g, rows, Lp, Ld, H, static_cast<const char *>(image), res, gws);
  return (int)cudaGetLastError();
}

}  // namespace bb
