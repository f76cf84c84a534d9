// Weight-gradient sums of the fused MLP backward for Hopper (sm_90a):
// for each (cotangent plane G (O, Rp), residual plane A (K, Rp)) pair,
//   dW[o][k] = sum_r G[o][r] * A[k][r]   and   db[o] = sum_r G[o][r],
// operands as stored (f32 or bf16), sums in f32, deterministic.
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_backprop_tile's mmT_acc and
// dbias (:774-791) and the revisited-block accumulation _accumulate_grads
// (:1081).
//
// What bounds it: a tall-K "TN" product (O, K <= 256; Rp = 524,288 rows
// at the training batch), both operands contiguous along the contraction.
// The flagship's twelve sums read 4.70 GB of bf16 planes for 0.563 TFLOP:
// bf16 is bound by memory (1.40 ms at 3.35 TB/s), f32 by the SIMT FMA
// rate (8.40 ms at 67 TFLOP/s).
//
// Design:
//  - All sums of a call run in ONE launch: block b takes output tile t =
//    b % T of the T tiles of all sums and row split s = b / T; one reduce
//    launch adds the partials. Two launches a backward (the old sums took
//    24).
//  - 128 x 128 output tiles: a 256-wide plane is read by two tiles, not
//    four (the second read mostly from L2); features past O or K are not
//    loaded.
//  - A ring of row slices in shared memory, filled with 16-byte cp.async
//    copies, stays ahead of the math. bf16: six stages of 64 rows, each
//    feature row 128 B in the 128-byte swizzle; two warpgroups each run
//    wgmma m64n128k16 on 64 o rows, both operands read from shared
//    memory. f32: five stages of 32 rows, an 8 x 8 block of sums a
//    thread, float4 reads along the rows.
//  - The bias row sum rides the same pass: bf16 as a wgmma m64n8k16 of
//    the G rows against a tile of ones, f32 as one vector read a step by
//    half the threads. No warp waits on it at a barrier.
//  - bf16: the tensor cores do not round their adds to nearest, so each
//    stage's 64 rows go to a fresh accumulator that is then added to the
//    running f32 sum, rounding to nearest: the error stays that of f32
//    sums (at 524,288 rows, 4e-7 of the largest entry from float64; 1e-5
//    with one accumulator).
//  - Row splits sized to the card: about 4,096 blocks over all sums, at
//    most 256 splits. Each block writes its partial tile, and the reduce
//    adds the S partials in a fixed order: no atomics, bitwise
//    reproducible.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// One sum: planes G (O, Rp) and A (K, Rp), row stride Rp; db may be null.
struct WTask {
  const void *G, *A;
  int O, K;
  float *dW, *db;
};

namespace {

// 16-byte cp.async copies into shared memory, their commit and wait: the
// one set of these helpers, for the sums below and for every tile kernel
// of mlp_tile.cuh (which includes this header first).
__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;   // 8 warps
constexpr int TO = 128;        // output tile: o rows ...
constexpr int TK = 128;        // ... x k columns
constexpr int MAX_TASKS = 12;
constexpr int ROW_ALIGN = 64;  // splits hold whole stages of both kernels
constexpr long long TARGET_BLOCKS = 4096;  // blocks a launch, over all sums
constexpr int MAX_SPLITS = 256;

constexpr int BR16 = 64;  // bf16 rows a stage: one 128-byte swizzle row a feature
// f32: 5 stages of 32 rows; rows of 36 floats (144 B).
constexpr int BR32 = 32, NS32 = 5, LD32 = BR32 + 4;
constexpr int STAGE32 = (TO + TK) * LD32;
constexpr int SMEM32 = NS32 * STAGE32 * 4;  // 184,320 B: one block an SM

// The sums of one launch: tiles, partial offsets and the row split.
struct Group {
  WTask t[MAX_TASKS];
  long long off[MAX_TASKS];  // floats before each sum's partial in a split
  int tile0[MAX_TASKS];      // first output tile of each sum
  int n, T, S;               // sums, tiles in all, row splits
  long long total;           // floats of one split's partials
  long long Rp, chunk;       // rows; rows a split (a multiple of ROW_ALIGN)
};

// What one block works on.
struct Work {
  const char *G, *A;  // the tile's first feature row, at row 0
  int O, K, Fo, Fk;   // the sum's widths; valid features of this tile
  int o0, k0;
  long long r0, r1;
  float *out;         // this split's partial of the sum: (O, K), then (O,)
  bool bias;          // this tile writes the bias partial
};

__device__ __forceinline__ Work work_of(const Group &g, float *part, int esize) {
  const int s = blockIdx.x / g.T, t = blockIdx.x % g.T;
  // the sum of tile t, read with constant indices only (no local copy)
  WTask tk = g.t[0];
  int first = 0;
  long long off = 0;
#pragma unroll
  for (int j = 1; j < MAX_TASKS; ++j)
    if (j < g.n && t >= g.tile0[j]) {
      tk = g.t[j];
      first = g.tile0[j];
      off = g.off[j];
    }
  const int nk = (tk.K + TK - 1) / TK, lt = t - first;
  Work w;
  w.O = tk.O;
  w.K = tk.K;
  w.o0 = lt / nk * TO;
  w.k0 = lt % nk * TK;
  w.Fo = min(TO, tk.O - w.o0);
  w.Fk = min(TK, tk.K - w.k0);
  w.G = static_cast<const char *>(tk.G) + (long long)w.o0 * g.Rp * esize;
  w.A = static_cast<const char *>(tk.A) + (long long)w.k0 * g.Rp * esize;
  w.r0 = (long long)s * g.chunk;
  w.r1 = min(g.Rp, w.r0 + g.chunk);
  w.out = part + (long long)s * g.total + off;
  w.bias = tk.db != nullptr && w.k0 == 0;
  return w;
}

// Start copying BYTES of each of the first F feature rows of P (row
// stride Rpb bytes), from byte rb of the row, into S (row stride LDB
// bytes). With SW (128-byte rows), 16-byte chunk c of row f goes to chunk
// c ^ (f % 8): the 128-byte swizzle that wgmma reads.
template <int BYTES, int LDB, bool SW>
__device__ __forceinline__ void copy_rows(const char *P, int F, long long Rpb, long long rb,
                                          char *S) {
  constexpr int CPR = BYTES / 16;  // 16-byte copies a feature row
  static_assert(TO * CPR % THREADS == 0 && (!SW || CPR == 8), "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < TO * CPR / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS, f = idx / CPR, c = idx % CPR;
    if (f < F) cp_async16(S + f * LDB + (SW ? c ^ (f & 7) : c) * 16, P + f * Rpb + rb + c * 16);
  }
}

// ----------------------------------------------------------------------
// bf16 on wgmma: warpgroup wq (threads 128 wq ..) owns o rows 64 wq .. +63
// of the tile and all 128 k columns: m64n128k16 with both operands read
// from shared memory. A stage holds 64 rows of R, 128 B a feature row, in
// the 128-byte swizzle wgmma reads: 16-byte chunk c of feature row f sits
// at chunk c ^ (f % 8) of its row.
constexpr uint32_t ONES = 0x3F803F80u;           // two bf16 1.0
constexpr int SWB = 128;                         // bytes of a feature row in a stage
constexpr int WSTAGE = (TO + TK) * SWB;          // 32 KB a stage
constexpr int NSW = 6;
constexpr int SMEMW = 1024 + NSW * WSTAGE + 1024;  // align slack, stages, ones tile

__device__ __forceinline__ uint64_t sw128_desc(const void *p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void keep(float &r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 128 of the warpgroup) = A B^T (+ d when acc), A and B K-major.
__device__ __forceinline__ void wgmma128(float d[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 8) = A B^T (+ d when acc): the bias rows against a ones tile.
__device__ __forceinline__ void wgmma8(float d[4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

__global__ void __launch_bounds__(THREADS, 1) sums_bf16(const Group g, float *part) {
  extern __shared__ unsigned char smem_raw[];
  char *smem = reinterpret_cast<char *>(smem_raw) +
               ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);  // swizzle atoms
  char *ones = smem + NSW * WSTAGE;
  const Work w = work_of(g, part, 2);
  const int nst = w.r1 > w.r0 ? (int)((w.r1 - w.r0) / BR16) : 0;
  const long long Rpb = g.Rp * 2;
  auto load = [&](int st) {
    char *S = smem + (st % NSW) * WSTAGE;
    const long long rb = (w.r0 + (long long)st * BR16) * 2;
    copy_rows<SWB, SWB, true>(w.G, w.Fo, Rpb, rb, S);
    copy_rows<SWB, SWB, true>(w.A, w.Fk, Rpb, rb, S + TO * SWB);
  };
#pragma unroll
  for (int st = 0; st < NSW - 1; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  reinterpret_cast<uint32_t *>(ones)[threadIdx.x] = ONES;  // 8 rows x 128 B of 1.0
  const int wq = threadIdx.x >> 7;
  const bool active = w.Fo > 64 * wq, bias_on = active && w.bias;
  const uint64_t dn = sw128_desc(ones);
  float acc[64] = {}, s[64] = {}, bacc[4] = {}, sb[4] = {};
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NSW - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // copies visible to wgmma
    __syncthreads();
    if (st + NSW - 1 < nst) load(st + NSW - 1);
    cp_async_commit();
    if (!active) continue;
    const char *S = smem + (st % NSW) * WSTAGE;
    const uint64_t da = sw128_desc(S + wq * 64 * SWB), db = sw128_desc(S + TO * SWB);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BR16 / 16; ++k) wgmma128(s, da + 2 * k, db + 2 * k, k > 0);
    if (bias_on)
#pragma unroll
      for (int k = 0; k < BR16 / 16; ++k) wgmma8(sb, da + 2 * k, dn + 2 * k, k > 0);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(s[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(sb[i]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += s[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) bacc[i] += sb[i];
  }
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) & 3, gq = lane >> 2, q = lane & 3;
  const bool even = (w.K & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = wq * 64 + wr * 16 + h * 8 + gq;  // within the tile
    if (o >= w.Fo) continue;
    float *row = w.out + (long long)(w.o0 + o) * w.K + w.k0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = 8 * j + 2 * q;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (even && k + 1 < w.Fk) {
        *reinterpret_cast<float2 *>(row + k) = make_float2(v0, v1);
      } else {
        if (k < w.Fk) row[k] = v0;
        if (k + 1 < w.Fk) row[k + 1] = v1;
      }
    }
    if (bias_on && q == 0) w.out[(long long)w.O * w.K + w.o0 + o] = bacc[2 * h];
  }
}

// ----------------------------------------------------------------------
// f32: SIMT FMA. Thread (ty, tx) = (tid / 16, tid % 16) owns o rows ty +
// 16 i and k columns tx + 16 j (i, j < 8); rows are added in order, four
// at a time from one float4 read of each operand. Thread (ty, tx < 8)
// also sums the bias of o row 8 ty + tx.
constexpr int IB = 4;  // o rows of the block held in registers at a time: no spills

__device__ __forceinline__ float4 ld4(const float *p) { return *reinterpret_cast<const float4 *>(p); }

__device__ __forceinline__ void fma4(float &c, const float4 &g, const float4 &a) {
  c = fmaf(g.x, a.x, c);
  c = fmaf(g.y, a.y, c);
  c = fmaf(g.z, a.z, c);
  c = fmaf(g.w, a.w, c);
}

template <bool FULL>
__device__ __forceinline__ void stage_f32(const float *Gs, const float *As, int ty, int tx,
                                          int mn, int nn, bool bias_thread, float acc[8][8],
                                          float &bsum) {
#pragma unroll
  for (int rr = 0; rr < BR32; rr += 4) {
#pragma unroll
    for (int i0 = 0; i0 < 8; i0 += IB) {
      if (!FULL && i0 >= mn) continue;
      float4 gv[IB];
#pragma unroll
      for (int i = 0; i < IB; ++i) gv[i] = ld4(Gs + (ty + 16 * (i0 + i)) * LD32 + rr);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!FULL && j >= nn) continue;
        const float4 a = ld4(As + (tx + 16 * j) * LD32 + rr);
#pragma unroll
        for (int i = 0; i < IB; ++i)
          if (FULL || i0 + i < mn) fma4(acc[i0 + i][j], gv[i], a);
      }
    }
    if (bias_thread) {
      const float4 v = ld4(Gs + (8 * ty + tx) * LD32 + rr);
      bsum += v.x;
      bsum += v.y;
      bsum += v.z;
      bsum += v.w;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) sums_f32(const Group g, float *part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Work w = work_of(g, part, 4);
  const int nst = w.r1 > w.r0 ? (int)((w.r1 - w.r0) / BR32) : 0;
  const long long Rpb = g.Rp * 4;
  auto buf = [&](int st) { return reinterpret_cast<float *>(smem) + (st % NS32) * STAGE32; };
  auto load = [&](int st) {
    char *S = reinterpret_cast<char *>(buf(st));
    const long long rb = (w.r0 + (long long)st * BR32) * 4;
    copy_rows<BR32 * 4, LD32 * 4, false>(w.G, w.Fo, Rpb, rb, S);
    copy_rows<BR32 * 4, LD32 * 4, false>(w.A, w.Fk, Rpb, rb, S + TO * LD32 * 4);
  };
#pragma unroll
  for (int st = 0; st < NS32 - 1; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int mn = (w.Fo + 15) / 16, nn = (w.Fk + 15) / 16;  // i, j blocks with a valid row
  const bool full = mn == 8 && nn == 8;
  const bool bias_thread = w.bias && tx < 8;
  float acc[8][8] = {}, bsum = 0.f;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS32 - 2>();
    __syncthreads();
    if (st + NS32 - 1 < nst) load(st + NS32 - 1);
    cp_async_commit();
    const float *Gs = buf(st), *As = Gs + TO * LD32;
    if (full) stage_f32<true>(Gs, As, ty, tx, mn, nn, bias_thread, acc, bsum);
    else stage_f32<false>(Gs, As, ty, tx, mn, nn, bias_thread, acc, bsum);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = ty + 16 * i;
    if (o >= w.Fo) continue;
    float *row = w.out + (long long)(w.o0 + o) * w.K + w.k0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tx + 16 * j < w.Fk) row[tx + 16 * j] = acc[i][j];
  }
  if (bias_thread && 8 * ty + tx < w.Fo) w.out[(long long)w.O * w.K + w.o0 + 8 * ty + tx] = bsum;
}

// ----------------------------------------------------------------------
// dW[i] = sum over splits s of part[s][i], in a fixed order (runs of 16
// splits, then the runs: the error grows with 16 + S / 16 adds, not S);
// likewise db. One thread an output, all sums of the group in one launch.
__global__ void reduce_kernel(const float *__restrict__ part, const Group g) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.total) return;
  WTask tk = g.t[0];
  long long off = 0;
#pragma unroll
  for (int j = 1; j < MAX_TASKS; ++j)
    if (j < g.n && i >= g.off[j]) {
      tk = g.t[j];
      off = g.off[j];
    }
  const long long l = i - off, OK = (long long)tk.O * tk.K;
  float *dst = l < OK ? tk.dW + l : (tk.db && l < OK + tk.O ? tk.db + (l - OK) : nullptr);
  if (!dst) return;  // no bias, or the pad that keeps partials 16-byte aligned
  float s = 0.f;
  for (int z0 = 0; z0 < g.S; z0 += 16) {
    float run = 0.f;
    for (int z = z0; z < min(g.S, z0 + 16); ++z) run += part[(long long)z * g.total + i];
    s += run;
  }
  *dst = s;
}

// Tiles, partial offsets and row splits for these sums: enough blocks to
// fill the card many times over (~4,096: 31 waves, one block an SM), whole
// stages in every split.
Group plan(const WTask *tasks, int n, long long Rp, bool is_bf16) {
  Group g{};
  g.n = n;
  g.Rp = Rp;
  for (int i = 0; i < n; ++i) {
    const WTask &tk = tasks[i];
    g.t[i] = tk;
    g.tile0[i] = g.T;
    g.off[i] = g.total;
    g.T += ((tk.O + TO - 1) / TO) * ((tk.K + TK - 1) / TK);
    g.total += ((long long)tk.O * tk.K + tk.O + 3) / 4 * 4;
  }
  const long long want = std::max(
      1LL, std::min({(TARGET_BLOCKS + g.T - 1) / g.T, Rp / ROW_ALIGN, (long long)MAX_SPLITS}));
  g.chunk = (Rp + want * ROW_ALIGN - 1) / (want * ROW_ALIGN) * ROW_ALIGN;
  g.S = (int)((Rp + g.chunk - 1) / g.chunk);
  return g;
}

}  // namespace wg

// Launches of the sums kernel by this library (each source that includes
// this header is its own library), counted where it is launched.
long long wgrad_launches = 0;

// Floats of the partial-sum scratch that wgrad_launch needs for these sums.
long long wgrad_part_floats(const WTask *tasks, int n, long long Rp, bool is_bf16) {
  const wg::Group g = wg::plan(tasks, n, Rp, is_bf16);
  return (long long)g.S * g.total;
}

// The n <= 12 sums, Rp a multiple of 64, every plane 16-byte aligned, in
// one launch and one reduce on `stream`; returns the first CUDA error (0
// on success).
int wgrad_launch(const WTask *tasks, int n, long long Rp, bool is_bf16, float *part,
                 cudaStream_t stream) {
  if (n < 1 || n > wg::MAX_TASKS || Rp <= 0 || Rp % wg::ROW_ALIGN)
    return (int)cudaErrorInvalidValue;
  const wg::Group g = wg::plan(tasks, n, Rp, is_bf16);
  const unsigned blocks = (unsigned)(g.S * g.T);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(wg::sums_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEMW);
    if (e != cudaSuccess) return (int)e;
    wg::sums_bf16<<<blocks, wg::THREADS, wg::SMEMW, stream>>>(g, part);
  } else {
    e = cudaFuncSetAttribute(wg::sums_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM32);
    if (e != cudaSuccess) return (int)e;
    wg::sums_f32<<<blocks, wg::THREADS, wg::SMEM32, stream>>>(g, part);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++wgrad_launches;
  wg::reduce_kernel<<<(unsigned)((g.total + 255) / 256), 256, 0, stream>>>(part, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches of the sums kernel by this library so far; with `reset`, the
// count restarts from 0 after it is read.
long long wgrad_launch_count(int reset) {
  const long long n = wgrad_launches;
  if (reset) wgrad_launches = 0;
  return n;
}

}  // extern "C"
