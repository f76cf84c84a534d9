// The bf16 forward tile kernel of the fused NeRF MLP for Hopper (sm_90a).
// Included by mlp_tile.cuh inside its anonymous namespace: forward()
// launches it for every bf16 path (serving, the eval render B3, and the
// first pass of B1 and B2, which also keep the residuals).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_forward_tile (:497) with
// _encode (:410), in bf16: the encoding (the point one, or with `var` the
// integrated one of the mip path, :473-477; with `wx`/`wd` BARF's anneal
// windows, :491-494, in f32 before the rounding), the nine chained products
// and the rgb/sigma heads of a tile of sample rows.
//
// What bounds it: the tensor cores (~0.54 M multiply-adds a sample row:
// 2.28 ms at 2,097,152 rows at 989 TFLOP/s); with residuals, the
// 2,288 bf16 feature planes it writes (4.6 KB a row). Numerics are the
// TPU kernel's _mm: bf16 operands, f32 sums, the f32 bias added after the
// sum, relu outputs rounded to bf16 before the next product, the encoding
// in f32 with the accurate sincosf, then rounded.
//
// Design:
//  - wgmma with the sample rows as M. A block holds two consumer
//    warpgroups of 64 rows each (a 128-row tile) and one producer
//    warpgroup, which gives its registers to the consumers (setmaxnreg:
//    40 a thread against 232).
//    A warpgroup keeps its rows' activations [row][feature] in shared
//    memory in the 128-byte swizzle, in chunks of 64 features (8 KB), and
//    runs wgmma m64nNk16 against the weight slice (N = all output
//    features, padded to a multiple of 64; 128 f32 accumulators a thread
//    at N = 256). A warpgroup reads only its own rows, so each epilogue
//    (bias, relu, bf16; stmatrix stores of 16 features an instruction)
//    overwrites its input tile in place once its products are done: no
//    ping-pong buffer, no block-wide barrier between layers, only
//    barriers of the warpgroup's 128 threads. The epilogues, the encoding
//    and the ring bookkeeping run between a warpgroup's products, so
//    they are kept short: the kernel is also built for H = 256, where
//    the product widths and the epilogues' bounds are constants.
//  - The skip layer sums Wsh h4 and Wsx posx into one accumulator; Wcs
//    (H/2 + 8 rows) takes the sigma row into the same product as the
//    colour rows, and Wcd adds into it; the rgb head Wc1 (8 x H/2) is a
//    wgmma m64n8k16 on hc. No SIMT dot remains.
//  - The weights stream through a ring of 2-4 stages (3 at the flagship:
//    32 KB a stage, 64 weight columns of every output row). One producer
//    thread copies each slice with one cp.async.bulk that completes on
//    the stage's "full" mbarrier; the 256 consumer threads arrive on its
//    "empty" mbarrier once their products have read it. The copies come
//    from a weight image that one small launch builds at every call
//    (image_kernel: 1.17 MB at the flagship, each slice padded with zeros
//    and already in the swizzle), so a slice is one contiguous copy.
//  - A persistent grid: one block an SM walks over the 128-row tiles, so
//    the ring runs on across tile boundaries, and each tile reads the
//    weights once for 128 rows (half the L2 traffic of 64-row tiles).
//  - Residuals (with `res`): after each epilogue the warpgroup reads its
//    tile back transposed, 8 rows of one feature a lane, and writes each
//    feature plane along the rows in 16-byte stores, eight lanes a
//    feature: four whole 128-byte lines a warp store, instead of 4-byte
//    pairs over 8 planes.
//  - Ragged rows: rows past `rows` encode to zero and are not stored; a
//    64-row unit past Rp writes no residuals but still walks the ring.

#pragma once

namespace fb {

constexpr int ROWS = 64;                     // sample rows of a consumer warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups: 128-row tiles
constexpr int TILE = ROWS * CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int CHUNK = ROWS * 128;            // 64 rows x 64 features, bf16, swizzled
constexpr int MAX_STAGES = 4;
constexpr int NMAT = 12;
constexpr long long SMEM_LIMIT = 232448;     // the H100's shared memory a block

__host__ __device__ constexpr int ceil64(int n) { return (n + 63) / 64 * 64; }
__host__ __device__ inline int chunks(int K) { return (K + 63) / 64; }

// The matrices in the order the kernel multiplies by them (weight image
// order): W1, Wt1..Wt4, Wsh, Wsx, Wp0, Wp1, Wcs, Wcd, Wc1.
struct Plan {
  int H, FX, FD;
  __host__ __device__ int O(int m) const {
    return m < 9 ? H : m == 9 ? H / 2 + 8 : m == 10 ? H / 2 : 8;
  }
  __host__ __device__ int K(int m) const {
    return m == 0 || m == 6 ? FX : m == 10 ? FD : m == 11 ? H / 2 : H;
  }
  // rows of a slice: the product's N (Wcd adds into the Wcs accumulator)
  __host__ __device__ int npad(int m) const {
    return m < 9 ? ceil64(H) : m < 11 ? ceil64(H / 2 + 8) : 8;
  }
  __host__ __device__ long long slice_bytes(int m) const { return 128LL * npad(m); }
  __host__ __device__ long long image_bytes() const {
    long long b = 0;
    for (int m = 0; m < NMAT; ++m) b += chunks(K(m)) * slice_bytes(m);
    return b;
  }
  __host__ __device__ int tile_chunks() const { return chunks(H) + chunks(FX) + chunks(FD); }
  __host__ __device__ long long stage_bytes() const { return 128LL * ceil64(H); }
  // every bias, f32: b1, bt1..bt4, bs, bp0, bp1 (H each), bcs, bc1
  __host__ __device__ int bias_floats() const { return 8 * H + H / 2 + 16; }
  // align slack, both warpgroups' tiles, the head staging, the biases, the barriers
  __host__ __device__ long long fixed_bytes() const {
    return 1024 + CONSUMERS * (tile_chunks() * (long long)CHUNK + 4 * ROWS * 4) +
           4LL * bias_floats() + 2 * MAX_STAGES * 8;
  }
  __host__ __device__ int stages() const {
    const long long s = (SMEM_LIMIT - fixed_bytes()) / stage_bytes();
    return s < 2 ? 2 : s > MAX_STAGES ? MAX_STAGES : (int)s;
  }
  __host__ __device__ long long smem_bytes() const { return fixed_bytes() + stages() * stage_bytes(); }
};

__host__ __device__ inline Plan plan_of(int Lp, int Ld, int H) { return Plan{H, enc_rows(Lp), enc_rows(Ld)}; }

// Byte offset of (row, feature n) in a tile of 64-feature chunks: 16-byte
// chunk c of a 128-byte row r sits at c ^ (r % 8), as wgmma reads it.
__device__ __forceinline__ int sw(int r, int n) {
  return (n >> 6) * CHUNK + r * 128 + ((((n >> 3) & 7) ^ (r & 7)) << 4) + (n & 7) * 2;
}

__device__ __forceinline__ uint32_t saddr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t *b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(saddr(b)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}

// The producer's copy of one slice: `bytes` from global `src` to shared
// `dst`, completing on the stage's full barrier.
__device__ __forceinline__ void bulk_load(void *dst, const void *src, uint32_t bytes, uint64_t *full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(full)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(full)) : "memory");
}

// Barrier of one consumer warpgroup's 128 threads (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void bar_wg(int wq) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wq + 1) : "memory");
}

// Shared-memory stores of this thread, visible to the warpgroup's wgmma
// after the next bar_wg.
__device__ __forceinline__ void to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d (64 x N of the warpgroup) = A B^T (+ d when acc), A and B K-major in
// the 128-byte swizzle; thread t holds d[4j + 2h + e] = (row 16 (t / 32) +
// 8h + (t % 32) / 4, column 8j + 2 (t % 4) + e).

__device__ __forceinline__ void mma_n64(float *d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n128(float *d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n192(float *d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n256(float *d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n8(float *d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

// N = NFIX where the kernel is built for it, else npad chosen at run time.
template <int NFIX, int NACC>
__device__ __forceinline__ void mma(float (&d)[NACC], int npad, uint64_t da, uint64_t db, int acc) {
  if constexpr (NACC == 4) {
    mma_n8(d, da, db, acc);
  } else if constexpr (NFIX == 256) {
    mma_n256(d, da, db, acc);
  } else if constexpr (NFIX == 192) {
    mma_n192(d, da, db, acc);
  } else if constexpr (NFIX == 128) {
    mma_n128(d, da, db, acc);
  } else {
    switch (npad) {
      case 64: mma_n64(d, da, db, acc); break;
      case 128: mma_n128(d, da, db, acc); break;
      case 192: mma_n192(d, da, db, acc); break;
      default: mma_n256(d, da, db, acc); break;
    }
  }
}

// The weight ring as a consumer or the producer walks it: the next slice
// sits in stage `stage`, filled in a round of parity `phase`.
struct Ring {
  char *buf;
  uint64_t *full, *empty;
  int stage_bytes, stages;
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// d (+)= in[:, :K] W^T for the next chunks(K) slices of the ring; in is a
// tile of the warpgroup. Each slice's stage is released as soon as the
// products that read it are done; returns with all of them done.
template <int NFIX, int NACC>
__device__ __forceinline__ void product(float (&d)[NACC], Ring &rg, const char *in, int K,
                                        int npad, bool accumulate) {
  const int nc = chunks(K), ks = (K + 15) / 16;
  int prev = 0;
  for (int c = 0; c < nc; ++c) {
    const int s = rg.stage;
    mbar_wait(rg.full + s, rg.phase);
    const uint64_t da = wg::sw128_desc(in + c * CHUNK);
    const uint64_t db = wg::sw128_desc(rg.buf + s * rg.stage_bytes);
    wg::wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * c + k < ks) mma<NFIX>(d, npad, da + 2 * k, db + 2 * k, accumulate || c > 0 || k > 0);
    wg::wg_commit();
    if (c > 0) {
      wg_wait1();
      mbar_arrive(rg.empty + prev);
    }
    prev = s;
    rg.advance();
  }
  wg::wg_wait0();
#pragma unroll
  for (int i = 0; i < NACC; ++i) wg::keep(d[i]);
  mbar_arrive(rg.empty + prev);
}

// bf16 pair of relu(a), relu(b): rounding keeps the sign, so relu after
// the rounding is relu before it.
__device__ __forceinline__ uint32_t relu2(float a, float b) {
  const __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(a, b), __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t *>(&v);
}

// Stores of four (two) 8x8 bf16 blocks of accumulator fragments; lane l
// gives the 16-byte row address of row l % 8 of block l / 8.
__device__ __forceinline__ void stsm4(char *p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(saddr(p)),
               "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}
__device__ __forceinline__ void stsm2(char *p, uint32_t a, uint32_t b) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(saddr(p)), "r"(a),
               "r"(b) : "memory");
}

// tile[r][n] = bf16(relu(d + b[n])) for the output features n < O (a
// multiple of 8), 16 features at a time with one stmatrix; with sig >= 0,
// the pre-activation of feature `sig` goes to sigma[r] in f32.
__device__ __forceinline__ void epilogue(const float (&d)[128], const float *b, int O, int sig,
                                         char *tile, float *sigma, int tid) {
  const int wr = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int srow = 16 * wr + 8 * ((lane >> 3) & 1) + (lane & 7), scol = 8 * (lane >> 4);
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    if (8 * j >= O) break;
    const float2 b0 = *reinterpret_cast<const float2 *>(b + 8 * j + 2 * q);
    const uint32_t r0 = relu2(d[4 * j] + b0.x, d[4 * j + 1] + b0.y);
    const uint32_t r1 = relu2(d[4 * j + 2] + b0.x, d[4 * j + 3] + b0.y);
    if (8 * j + 8 < O) {
      const float2 b1 = *reinterpret_cast<const float2 *>(b + 8 * j + 8 + 2 * q);
      stsm4(tile + sw(srow, 8 * j + scol), r0, r1, relu2(d[4 * j + 4] + b1.x, d[4 * j + 5] + b1.y),
            relu2(d[4 * j + 6] + b1.x, d[4 * j + 7] + b1.y));
    } else {
      stsm2(tile + sw(srow, 8 * j), r0, r1);
    }
  }
  if (sig < 0 || q) return;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (8 * j == sig)
#pragma unroll
      for (int h = 0; h < 2; ++h) sigma[16 * wr + 8 * h + g] = d[4 * j + 2 * h] + b[sig];
}

__device__ __forceinline__ void put(char *tile, int r, int k, float v) {
  *reinterpret_cast<bf16 *>(tile + sw(r, k)) = __float2bfloat16_rn(v);
}

// The encoded inputs of the warpgroup's rows into its posx and posd tiles
// (features past 3 + 2 * 3L in each 8-aligned block stay zero from the
// start). Two threads a row: the first writes posx's raw coordinates, the
// second posd's, and they split the frequencies of both branches (Lp of
// posx, then Ld of posd), each frequency the sin and cos of three
// channels from three independent sincosf. With `var` (the mip path's
// three variance rows, stride `rows`), posx's sin and cos of coordinate c
// at frequency 2^i are damped by exp(-0.5 * 4^i * var_c) before they are
// rounded to bf16. With `wx`, `wd` (the anneal windows of posx and posd,
// one float an encoded row), each row is multiplied by its window in f32,
// before the rounding; with null windows nothing is multiplied. Rows past
// `rows` encode to zero.
__device__ void encode(const float *__restrict__ x, long long rows, long long row0, int Lp,
                       int Ld, char *posx, char *posd, int tid, const float *__restrict__ var,
                       const float *__restrict__ wx, const float *__restrict__ wd) {
  const int r = tid & (ROWS - 1), half = tid >> 6;
  const long long row = row0 + r;
  const bool in = row < rows;
  float v[6], va[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 6; ++c) v[c] = in ? x[(long long)c * rows + row] : 0.f;
  if (var && in)
#pragma unroll
    for (int c = 0; c < 3; ++c) va[c] = var[(long long)c * rows + row];
  const float *rw = half ? wd : wx;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float u = half ? v[3 + c] : v[c];
    if (rw) u *= __ldg(rw + c);
    put(half ? posd : posx, r, c, u);
  }
  const int n = Lp + Ld, f0 = half ? (n + 1) / 2 : 0, f1 = half ? n : (n + 1) / 2;
#pragma unroll 2
  for (int f = f0; f < f1; ++f) {
    const bool bx = f < Lp;
    const int L = bx ? Lp : Ld, i = bx ? f : f - Lp, sb = ceil8(3 * L);
    char *t = bx ? posx : posd;
    float s[3] = {0.f, 0.f, 0.f}, co[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (in) sincosf(ldexpf(bx ? v[c] : v[3 + c], i), &s[c], &co[c]);
    if (bx && var)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float d = expf(-0.5f * ldexpf(va[c], 2 * i));
        s[c] *= d;
        co[c] *= d;
      }
    const float *ew = bx ? wx : wd;
    if (ew)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c] *= __ldg(ew + 8 + L * c + i);
        co[c] *= __ldg(ew + 8 + sb + L * c + i);
      }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      put(t, r, 8 + L * c + i, s[c]);
      put(t, r, 8 + sb + L * c + i, co[c]);
    }
  }
}

// Features 0..F-1 (F a multiple of 8) of the tile to their residual
// planes plane[f][row0 + r], row stride Rp. Eight lanes take one feature,
// 8 rows each, so a warp writes four whole 128-byte lines a store. Lane
// l8 reads its rows in the order 8 l8 + (e + l8) % 8: the eight lanes of a
// feature then read eight rows of different swizzle, in distinct banks;
// a rotation by l8 puts the values back in row order.
__device__ void store_planes(const char *tile, int F, bf16 *plane, long long Rp, long long row0,
                             int tid) {
  const int l8 = tid & 7, r0 = 8 * l8;
  for (int f = tid >> 3; f < F; f += 16) {
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = *reinterpret_cast<const uint16_t *>(tile + sw(r0 + ((e + l8) & 7), f));
    // v[e] holds row r0 + (e + l8) % 8: rotate the eight halves right by
    // l8 (words by l8 / 2 in two steps, then one half if l8 is odd)
    uint32_t w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = v[2 * m] | (v[2 * m + 1] << 16);
    if (l8 & 2) {
      const uint32_t t3 = w[3];
      w[3] = w[2], w[2] = w[1], w[1] = w[0], w[0] = t3;
    }
    if (l8 & 4) {
      uint32_t t = w[0];
      w[0] = w[2], w[2] = t;
      t = w[1], w[1] = w[3], w[3] = t;
    }
    if (l8 & 1) {
      const uint32_t t3 = w[3];
      w[3] = __byte_perm(w[2], w[3], 0x5432);
      w[2] = __byte_perm(w[1], w[2], 0x5432);
      w[1] = __byte_perm(w[0], w[1], 0x5432);
      w[0] = __byte_perm(t3, w[0], 0x5432);
    }
    *reinterpret_cast<uint4 *>(plane + f * Rp + row0 + r0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// HF: the width H where it is fixed at build time (the flagship's 256), so
// that the product widths and the epilogues' bounds are constants; 0
// where H is taken at run time.
template <int HF>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const float *__restrict__ x, float *__restrict__ out, long long rows, int Lp, int Ld,
               int H_, Weights w, const char *__restrict__ image, bf16 *res, const float *__restrict__ var,
               const float *__restrict__ wx, const float *__restrict__ wd) {
  constexpr int NH = HF ? ceil64(HF) : 0, NC = HF ? ceil64(HF / 2 + 8) : 0;
  const int H = HF ? HF : H_;
  extern __shared__ unsigned char smem_raw[];
  char *smem = reinterpret_cast<char *>(smem_raw) +
               ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);  // swizzle atoms
  const Plan P{H, enc_rows(Lp), enc_rows(Ld)};
  const int ntc = P.tile_chunks(), stages = P.stages();
  Ring rg{smem + CONSUMERS * ntc * CHUNK, nullptr, nullptr, (int)P.stage_bytes(), stages};
  float *heads = reinterpret_cast<float *>(rg.buf + stages * rg.stage_bytes);  // [CONSUMERS][4][ROWS]
  float *bias_s = heads + CONSUMERS * 4 * ROWS;
  rg.full = reinterpret_cast<uint64_t *>(bias_s + P.bias_floats());
  rg.empty = rg.full + MAX_STAGES;
  const long long ntiles = (rows + TILE - 1) / TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(rg.full + s, 1);
      mbar_init(rg.empty + s, 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < CONSUMERS * ntc * CHUNK / 16; i += THREADS)
    reinterpret_cast<uint4 *>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  {
    const void *const bsrc[10] = {w.b1, w.bt1, w.bt2, w.bt3, w.bt4, w.bs, w.bp0, w.bp1, w.bcs, w.bc1};
    for (int i = threadIdx.x; i < P.bias_floats(); i += THREADS) {
      const int v = i < 8 * H ? i / H : i < 8 * H + H / 2 + 8 ? 8 : 9;
      const int o = v < 8 ? i - v * H : v == 8 ? i - 8 * H : i - 8 * H - H / 2 - 8;
      bias_s[i] = static_cast<const float *>(bsrc[v])[o];
    }
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
          mbar_wait(rg.empty + rg.stage, rg.phase ^ 1);
          bulk_load(rg.buf + rg.stage * rg.stage_bytes, src, bytes, rg.full + rg.stage);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127, H2 = H / 2, FX = P.FX, FD = P.FD;
  char *act = smem + wq * ntc * CHUNK;
  char *posx = act + chunks(H) * CHUNK, *posd = posx + chunks(FX) * CHUNK;
  float *hd = heads + wq * 4 * ROWS;  // rgb in rows 0..2, sigma in row 3
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long Rp = L.Rp;
  const int nh = P.npad(0), nc = P.npad(9);
  const float *bc1 = bias_s + 8 * H + H2 + 8;
  float d[128] = {}, d8[4] = {};
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * TILE + wq * ROWS;
    const bool keep = res != nullptr && row0 < Rp;
    auto plane = [&](int f) { return res + f * Rp; };
    // one layer: products, then the epilogue in place and the residual plane
    auto dense = [&](int layer, int O, int sig, int f) {
      bar_wg(wq);  // every product of the warpgroup has read `act`
      epilogue(d, bias_s + layer * H, O, sig, act, hd + 3 * ROWS, tid);
      to_async();
      bar_wg(wq);
      if (keep) store_planes(act, O, plane(f), Rp, row0, tid);
    };
    bar_wg(wq);  // the last tile's reads of posx, posd and the heads are done
    encode(x, rows, row0, Lp, Ld, posx, posd, tid, var, wx, wd);
    to_async();
    bar_wg(wq);
    if (keep) {
      store_planes(posx, FX, plane(L.posx()), Rp, row0, tid);
      store_planes(posd, FD, plane(L.posd()), Rp, row0, tid);
    }
    product<NH>(d, rg, posx, FX, nh, false);  // W1
    dense(0, H, -1, L.h(0));
    product<NH>(d, rg, act, H, nh, false);  // Wt1
    dense(1, H, -1, L.h(1));
    product<NH>(d, rg, act, H, nh, false);  // Wt2
    dense(2, H, -1, L.h(2));
    product<NH>(d, rg, act, H, nh, false);  // Wt3
    dense(3, H, -1, L.h(3));
    product<NH>(d, rg, act, H, nh, false);  // Wt4
    dense(4, H, -1, L.h(4));
    product<NH>(d, rg, act, H, nh, false);  // skip: Wsh h4 + Wsx posx
    product<NH>(d, rg, posx, FX, nh, true);
    dense(5, H, -1, L.h(5));
    product<NH>(d, rg, act, H, nh, false);  // Wp0
    dense(6, H, -1, L.h(6));
    product<NH>(d, rg, act, H, nh, false);  // Wp1
    dense(7, H, -1, L.h(7));
    product<NC>(d, rg, act, H, nc, false);  // Wcs h7 (colour rows and sigma) + Wcd posd
    product<NC>(d, rg, posd, FD, nc, true);
    dense(8, H2, H2, L.hc());
    product<8>(d8, rg, act, H2, 8, false);  // Wc1 hc: rgb
    {
      const int wr = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wr + 8 * h + g;
        if (q == 0) {
          hd[r] = d8[2 * h] + bc1[0];
          hd[ROWS + r] = d8[2 * h + 1] + bc1[1];
        } else if (q == 1) {
          hd[2 * ROWS + r] = d8[2 * h] + bc1[2];
        }
      }
    }
    bar_wg(wq);
    for (int i = tid; i < 8 * ROWS; i += 128) {
      const int k = i / ROWS, r = i % ROWS;
      if (row0 + r < rows) out[k * rows + row0 + r] = k < 4 ? hd[k * ROWS + r] : 0.f;
    }
  }
}

// The weight image: matrix m of the Plan's order in K-slices of 64
// columns, each slice (npad(m), 64) bf16 in the 128-byte swizzle, rows
// past O and columns past K zero. One thread a 16-byte unit.
__global__ void image_kernel(Weights w, Plan P, long long units, char *image) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  long long off = 16 * u;
  int m = 0;
  for (; m < NMAT - 1; ++m) {
    const long long b = chunks(P.K(m)) * P.slice_bytes(m);
    if (off < b) break;
    off -= b;
  }
  const void *const mats[NMAT] = {w.W1, w.Wt1, w.Wt2, w.Wt3, w.Wt4, w.Wsh,
                                  w.Wsx, w.Wp0, w.Wp1, w.Wcs, w.Wcd, w.Wc1};
  const bf16 *W = static_cast<const bf16 *>(mats[m]);
  const int O = P.O(m), K = P.K(m);
  const long long sb = P.slice_bytes(m);
  const int c = (int)(off / sb), n = (int)(off % sb) / 128, pos = (int)(off % 128) / 16;
  const int k0 = 64 * c + 8 * (pos ^ (n & 7));  // the logical chunk stored at `pos`
  uint16_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = n < O && k0 + e < K ? reinterpret_cast<const uint16_t *>(W)[(long long)n * K + k0 + e] : 0;
  uint4 o;
  o.x = v[0] | (uint32_t)v[1] << 16;
  o.y = v[2] | (uint32_t)v[3] << 16;
  o.z = v[4] | (uint32_t)v[5] << 16;
  o.w = v[6] | (uint32_t)v[7] << 16;
  reinterpret_cast<uint4 *>(image)[u] = o;
}

int build_image(const Weights &w, const Plan &P, void *image, cudaStream_t stream) {
  const long long units = P.image_bytes() / 16;
  image_kernel<<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(w, P, units, static_cast<char *>(image));
  return (int)cudaGetLastError();
}

// The weight image, then the persistent grid: one block an SM, at most one
// a tile. `image` holds P.image_bytes(), 16-byte aligned. `var`: null, or
// the mip path's variance rows; `wx`, `wd`: null, or the anneal windows.
int launch(const float *x, float *out, long long rows, int Lp, int Ld, int H, const Weights &w,
           bf16 *res, void *image, const float *var, const float *wx, const float *wd, cudaStream_t stream) {
  const Plan P = plan_of(Lp, Ld, H);
  if (int e = build_image(w, P, image, stream)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = H == 256 ? fwd_kernel<256> : fwd_kernel<0>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem_bytes());
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (rows + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, THREADS, P.smem_bytes(), stream>>>(x, out, rows, Lp, Ld, H, w,
                                                    static_cast<const char *>(image), res, var, wx, wd);
  return (int)cudaGetLastError();
}

}  // namespace fb
