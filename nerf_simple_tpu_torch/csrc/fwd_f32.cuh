// The f32 forward tile kernel of the fused NeRF MLP for Hopper (sm_90a).
// Included by mlp_tile.cuh inside its anonymous namespace, after
// fwd_bf16.cuh, whose mbarrier and bulk-copy helpers it uses: forward()
// launches it for every f32 path (serving, the eval render B3, and the
// first pass of B1 and B2, which also keep the residuals).
//
// Replaces: nerf_simple_tpu/kernels/mlp.py::_forward_tile (:497) with
// _encode (:410), in f32: the encoding (the point one, or with `var` the
// integrated one of the mip path, :473-477; with `wx`/`wd` BARF's anneal
// windows, :491-493), the nine chained products
// and the rgb/sigma heads of a tile of sample rows. Numerics are the TPU kernel's
// at f32: full f32 FMA products (no TF32), the f32 bias added after the
// sum, relu, the encoding with the accurate sincosf. Only the order of
// the sums differs from the plain version.
//
// What bounds it: the FMA pipes. A sample row costs 536,576 multiply-adds
// at the flagship (2,097,152 rows: 33.6 ms at 67 TFLOP/s); with `res`, it
// also writes 2,288 f32 feature planes (9.2 KB a row). The inner loop is
// an outer product of register fragments from shared memory: a thread's
// 8 features x 8 rows take 64 FMAs for 16 floats loaded, so the shared
// memory pipe (128 B a clock an SM) runs at a quarter of the FMA rate at
// best, and latency must be hidden by warps in flight and by loading the
// next k's fragments while this k's FMAs run.
//
// Design:
//  - One block an SM (persistent grid) walks 128-row tiles with 16 warps
//    (512 threads, four warps a scheduler), every one of them multiplying.
//    A thread owns features 128 i + 4 fo + {0..3} (i < NI: NI = 2 for H >
//    128, else 1) and rows 64 h + 4 ro + {0..3} (h < 2), fo = 0..31, ro =
//    0..15: an 8 x 8 register tile at the flagship. In a warp eight lanes
//    share fo and read consecutive rows, so a float4 fragment load of
//    activations is 128 contiguous bytes and one of weights 64.
//  - One activation buffer [feature][row] (128 KB at H = 256): when a
//    layer's last product is done, its whole output is in the
//    accumulators, so after one barrier the epilogue writes it over the
//    input (float4 stores along rows: eight lanes of a feature fill 128
//    contiguous bytes, no bank twice), and one more barrier makes it the
//    next layer's input: two barriers a layer, ~21 a tile, none inside a
//    product.
//  - The weights stream through a ring of 2-4 stages (3 at the flagship:
//    16 KB a stage, 16 weight columns of every output feature, [k][o];
//    posd is encoded into the posx tile once the skip layer has read
//    posx, which leaves room for the third stage; three ran faster than
//    two in turns on one card).
//    Each slice is one cp.async.bulk that completes on the stage's "full"
//    mbarrier; warps wait on a stage, never on the whole block. Each warp
//    counts itself out of a stage when it has read it (a shared atomic),
//    and the last one starts the copy of the slice due there next; every
//    thread steps a cursor to that slice, so the refill is one copy. No
//    warp only copies: a 17th warp (one producer warp beside 16) puts five
//    warps on one of the SM's four register files and caps ptxas at 96
//    registers a thread, which spilled 772 bytes; 16 warps leave 128. The
//    copies come from an f32 weight image that one small launch builds at
//    every call (image_kernel: 2.1 MB at the flagship), each slice
//    contiguous and zero-padded to 128 NI output features.
//  - The heads. The colour product Wcs (rows 0..H/2-1) and Wcd run with
//    NI = 1 over the same thread grid: every thread holds 4 of the H/2 =
//    128 features, none idles and none computes a feature past H/2.
//    Sigma (Wcs row H/2, on h7) is summed in the Wp1 epilogue, and the rgb
//    head Wc1 (on hc) in the Wcs epilogue, each thread over the features
//    it holds in registers, then over the warp's lanes by shuffles and
//    over the eight feature warps in a fixed order through shared memory:
//    a small product spread over the block, deterministic, with no serial
//    dot.
//  - Encoding: four threads a row; each sincosf of a (coordinate,
//    frequency) pair writes both its sin row and its cos row. posx at the
//    start of a tile, posd in the skip layer's epilogue. Mip (`var`, the
//    variance rows of the input): each sin and cos of posx's coordinate c
//    at frequency 2^i is multiplied by exp(-0.5 * 4^i * var_c) before it
//    is stored, in the tile and in the residual planes alike, so B1's and
//    B2's weight gradients (read from the planes) need no change. The
//    anneal windows (`wx`, `wd`: FX and FD floats on the card, pose
//    refinement's coarse-to-fine encoder) multiply each encoded row of
//    posx and posd by its weight in the same place; with null windows
//    nothing is multiplied, so those launches are the same as without.
//  - Residuals (with `res`): each epilogue also stores its float4s to the
//    feature planes along the rows (eight lanes a feature: a 128-byte line).
//  - Ragged rows: rows past `rows` encode to zero and are not output; a
//    64-row half past Rp writes no residuals.
//  ptxas (sm_90a): 127 registers for the H > 128 build, 117 for H <= 128,
//  0 spill bytes.

#pragma once

namespace ff {

constexpr int ROWS = 128;                 // sample rows of a tile
constexpr int WARPS = 16;                 // every warp multiplies; none only copies
constexpr int THREADS = 32 * WARPS;
constexpr int KS = 16;                    // weight columns of a ring slice
constexpr int MAX_STAGES = 4;
using fb::SMEM_LIMIT;

// The matrices in the order the kernel multiplies by them (weight image
// order): W1, Wt1..Wt4, Wsh, Wsx, Wp0, Wp1, Wcs (its H/2 colour rows), Wcd.
// Matrix m is the packed (out, in) = (O(m), K(m)) matrix.
struct Plan {
  static constexpr int NMAT = 11;
  int H, FX, FD;
  __host__ __device__ int NI() const { return H > 128 ? 2 : 1; }
  __host__ __device__ int O(int m) const { return m < 9 ? H : H / 2; }
  __host__ __device__ int K(int m) const { return m == 0 || m == 6 ? FX : m == 10 ? FD : H; }
  // output features of a slice, zero-padded: 128 a feature group
  __host__ __device__ int OP(int m) const { return m < 9 ? 128 * NI() : 128; }
  __host__ __device__ int slices(int m) const { return (K(m) + KS - 1) / KS; }
  __host__ __device__ long long slice_bytes(int m) const { return 4LL * KS * OP(m); }
  __host__ __device__ long long image_bytes() const {
    long long b = 0;
    for (int m = 0; m < NMAT; ++m) b += slices(m) * slice_bytes(m);
    return b;
  }
  __host__ __device__ long long stage_bytes() const { return 4LL * KS * 128 * NI(); }
  // posd lives in the posx tile past the heads' sigma slots (ROWS floats
  // a slot, 8 slots) when it fits there: it is encoded once posx is read
  // for the last time (the skip layer), which frees a ring stage at the
  // flagship; else it has a tile of its own after posx.
  __host__ __device__ bool posd_in_posx() const { return FX >= FD + 8; }
  // the activation tile, posx (and posd), the full barriers and release counts
  __host__ __device__ long long fixed_bytes() const {
    return 4LL * ROWS * (H + FX + (posd_in_posx() ? 0 : FD)) + 2 * MAX_STAGES * 8;
  }
  __host__ __device__ int stages() const {
    const long long s = (SMEM_LIMIT - fixed_bytes()) / stage_bytes();
    return s < 2 ? 2 : s > MAX_STAGES ? MAX_STAGES : (int)s;
  }
  __host__ __device__ long long smem_bytes() const { return stages() * stage_bytes() + fixed_bytes(); }
  // element (o, k) of matrix m, o < O(m), k < K(m)
  __device__ float weight(const Weights &w, int m, int k, int o) const {
    const void *const mats[NMAT] = {w.W1, w.Wt1, w.Wt2, w.Wt3, w.Wt4, w.Wsh, w.Wsx, w.Wp0, w.Wp1, w.Wcs, w.Wcd};
    return static_cast<const float *>(mats[m])[(long long)o * K(m) + k];
  }
};

__host__ __device__ inline Plan plan_of(int Lp, int Ld, int H) { return Plan{H, enc_rows(Lp), enc_rows(Ld)}; }

// The weight ring as the block walks it: slice n of the block's sequence
// (every tile's slices in image order, tile after tile) sits in stage n %
// stages, filled in a round of parity (n / stages) % 2. A stage's count
// of the warps that have read it lets the last of them refill it with the
// slice due `stages` later, which every thread tracks (tile tn, matrix
// mn, its slice cn, at byte `off` of the image). PlanT gives the image's
// NMAT matrices, their slices() and slice_bytes(): ff's Plan, or the f32
// backward's (bwd_f32.cuh).
template <class PlanT>
struct Ring {
  char *buf;
  uint64_t *full;
  int *count;
  const char *image;
  PlanT P;
  long long ntiles;
  int stage_bytes, stages;
  int stage = 0;
  uint32_t phase = 0;
  long long tn = 0, off = 0;
  int mn = 0, cn = 0;

  // Start the copy of the tracked slice into stage s, if its tile is the block's.
  __device__ __forceinline__ void issue(int s) const {
    if (tn < ntiles) fb::bulk_load(buf + s * stage_bytes, image + off, (uint32_t)P.slice_bytes(mn), full + s);
  }
  __device__ __forceinline__ void step() {
    off += P.slice_bytes(mn);
    if (++cn == P.slices(mn)) {
      cn = 0;
      if (++mn == PlanT::NMAT) mn = 0, off = 0, tn += gridDim.x;
    }
  }
  // Thread 0 fills every stage; every thread's cursor moves past them.
  __device__ void start() {
    tn = blockIdx.x;
    for (int s = 0; s < stages; ++s) {
      if (threadIdx.x == 0) issue(s);
      step();
    }
  }
  // The warp has read the current stage: the last warp to do so refills it.
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(count + stage, 1) == WARPS - 1) {
        count[stage] = 0;
        __threadfence_block();
        issue(stage);
      }
    }
    step();
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

__device__ __forceinline__ float4 ld4(const float *p) { return *reinterpret_cast<const float4 *>(p); }

// Fragments of one k: the thread's NP x 4 weights (ws: [k][128 NP]) and
// its 2 x 4 rows of the input (in: [k][ROWS]).
template <int NP>
__device__ __forceinline__ void load_k(float4 (&wf)[NP], float4 (&af)[2], const float *ws,
                                       const float *in, int k, int fo4, int ro4) {
#pragma unroll
  for (int i = 0; i < NP; ++i) wf[i] = ld4(ws + k * 128 * NP + 128 * i + fo4);
#pragma unroll
  for (int h = 0; h < 2; ++h) af[h] = ld4(in + k * ROWS + 64 * h + ro4);
}

template <int NI, int NP>
__device__ __forceinline__ void fma_k(float (&acc)[4 * NI][8], const float4 (&wf)[NP], const float4 (&af)[2]) {
  const float a[8] = {af[0].x, af[0].y, af[0].z, af[0].w, af[1].x, af[1].y, af[1].z, af[1].w};
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float wv[4] = {wf[i].x, wf[i].y, wf[i].z, wf[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[4 * i + j][e] = fmaf(wv[j], a[e], acc[4 * i + j][e]);
  }
}

// acc[:4 NP] += the slice's KN columns: the next k's fragments load while
// this k's FMAs run.
template <int NI, int NP, int KN>
__device__ __forceinline__ void fma_slice(float (&acc)[4 * NI][8], const float *ws, const float *in, int fo4,
                                          int ro4) {
  float4 wf[2][NP], af[2][2];
  load_k<NP>(wf[0], af[0], ws, in, 0, fo4, ro4);
#pragma unroll
  for (int k = 0; k < KN; ++k) {
    if (k + 1 < KN) load_k<NP>(wf[(k + 1) & 1], af[(k + 1) & 1], ws, in, k + 1, fo4, ro4);
    fma_k<NI, NP>(acc, wf[k & 1], af[k & 1]);
  }
}

// acc[:4 NP] += W in[:K] for the next slices(K) slices of the ring (K a
// multiple of 8; W^T in the f32 backward's ring); each stage is released
// by the warp once it has read it.
template <int NI, int NP, class PlanT>
__device__ void product(float (&acc)[4 * NI][8], Ring<PlanT> &rg, const float *in, int K, int fo4, int ro4,
                        int lane) {
  for (int k0 = 0; k0 < K; k0 += KS) {
    fb::mbar_wait(rg.full + rg.stage, rg.phase);
    const float *ws = reinterpret_cast<const float *>(rg.buf + rg.stage * rg.stage_bytes);
    if (K - k0 >= KS)
      fma_slice<NI, NP, KS>(acc, ws, in + k0 * ROWS, fo4, ro4);
    else
      fma_slice<NI, NP, 8>(acc, ws, in + k0 * ROWS, fo4, ro4);
    rg.release(lane);
  }
}

// v[e] of the thread's 8 rows summed over the warp's four feature lanes
// (lanes 8 apart); lanes 0..7 write them to slot[row].
__device__ __forceinline__ void reduce_rows(float (&v)[8], float *slot, int lane, int ro4) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 8);
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 16);
  }
  if (lane < 8) {
    *reinterpret_cast<float4 *>(slot + ro4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4 *>(slot + 64 + ro4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// One layer's epilogue, between two barriers: out[o][r] =
// relu(acc + b[o]) for the thread's features o < O (i < NP) over the input
// tile, and to the residual plane (plane: null for none); resets acc.
// With hw (null for none), the head rows hw[c * hs + o] (c < nh) are summed
// over the relu outputs into slots[(c * 8 + fw) * ROWS + row].
template <int NI, int NP>
__device__ __forceinline__ void epilogue(float (&acc)[4 * NI][8], const float *b, int O, float *out, float *plane,
                                         long long Rp, long long row0, const float *hw, int hs, int nh,
                                         float *slots, int fo4, int ro4, int lane, int fw) {
  float hsum[3][8] = {};
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = 128 * i + fo4 + j;
      if (o < O) {
        const float bo = __ldg(b + o);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = fmaxf(acc[4 * i + j][e] + bo, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 q = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
          *reinterpret_cast<float4 *>(out + o * ROWS + 64 * h + ro4) = q;
          if (plane && row0 + 64 * h < Rp)
            *reinterpret_cast<float4 *>(plane + o * Rp + row0 + 64 * h + ro4) = q;
        }
        if (hw)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            if (c < nh) {
              const float wc = __ldg(hw + c * hs + o);
#pragma unroll
              for (int e = 0; e < 8; ++e) hsum[c][e] = fmaf(wc, v[e], hsum[c][e]);
            }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[4 * i + j][e] = 0.f;
    }
  if (hw)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < nh) reduce_rows(hsum[c], slots + (c * 8 + fw) * ROWS, lane, ro4);
}

// One branch of the encoding (coordinates col0..col0+2 of x, L
// frequencies) of the tile's rows into pos [feature][row]; with `plane`,
// also into its residual planes. Four threads a row: each (coordinate,
// frequency) pair takes one sincosf for its sin row and its cos row; the
// raw rows, the zero rows and the pad rows of the 8-aligned blocks are
// written too. With `var` (three rows of stride `rows`: the coordinates'
// variances), the sin and cos of coordinate c at frequency 2^i are damped
// by exp(-0.5 * 4^i * var_c). With `ew` (the branch's anneal windows, one
// float an encoded row), each row is multiplied by its window after that.
// Rows past `rows` encode to zero.
__device__ void encode(const float *__restrict__ x, long long rows, long long row0, int L, int col0, float *pos,
                       float *plane, long long Rp, int t, const float *__restrict__ var,
                       const float *__restrict__ ew) {
  const int r = t & (ROWS - 1), q = t >> 7, sb = ceil8(3 * L);
  const long long row = row0 + r;
  const bool in = row < rows, keep = plane != nullptr && row < Rp;
  for (int p = q; p < 3 * L; p += 4) {  // sin(2^i x_c) in row 8 + L c + i = 8 + p, its cos sb rows on
    float s = 0.f, co = 0.f;
    if (in) sincosf(ldexpf(x[(long long)(col0 + p / L) * rows + row], p % L), &s, &co);
    if (var && in) {
      const float d = expf(-0.5f * ldexpf(var[(long long)(p / L) * rows + row], 2 * (p % L)));
      s *= d;
      co *= d;
    }
    if (ew) {
      s *= __ldg(ew + 8 + p);
      co *= __ldg(ew + 8 + sb + p);
    }
    pos[(8 + p) * ROWS + r] = s;
    pos[(8 + sb + p) * ROWS + r] = co;
    if (keep) {
      plane[(8 + p) * Rp + row] = s;
      plane[(8 + sb + p) * Rp + row] = co;
    }
  }
  for (int k = q; k < 8 + 2 * sb; k += 4) {
    if (k >= 8 && (k - 8) % sb < 3 * L) continue;  // a sin or cos row
    float v = k < 3 && in ? x[(long long)(col0 + k) * rows + row] : 0.f;
    if (ew) v *= __ldg(ew + k);
    pos[k * ROWS + r] = v;
    if (keep) plane[k * Rp + row] = v;
  }
}

// NI: the feature groups of a thread in the H-wide layers (2 for H > 128).
// `var`: null, or the mip path's variance rows; `wx`, `wd`: null, or the
// anneal windows of posx and posd (encode).
template <int NI>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const float *__restrict__ x, float *__restrict__ out, long long rows, int Lp, int Ld, int H,
               Weights w, const char *__restrict__ image, float *res, const float *__restrict__ var,
               const float *__restrict__ wx, const float *__restrict__ wd) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan P = plan_of(Lp, Ld, H);
  const int stages = P.stages(), FX = P.FX, FD = P.FD, H2 = H / 2;
  const long long ntiles = (rows + ROWS - 1) / ROWS;
  char *buf = reinterpret_cast<char *>(smem);
  float *act = reinterpret_cast<float *>(buf + stages * P.stage_bytes());
  float *posx = act + H * ROWS, *posd = posx + (P.posd_in_posx() ? 8 * ROWS : FX * ROWS);
  uint64_t *full = reinterpret_cast<uint64_t *>(posx + FX * ROWS + (P.posd_in_posx() ? 0 : FD * ROWS));
  int *count = reinterpret_cast<int *>(full + MAX_STAGES);
  Ring<Plan> rg{buf, full, count, image, P, ntiles, (int)P.stage_bytes(), stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      fb::mbar_init(full + s, 1);
      count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  rg.start();
  __syncthreads();

  const int t = threadIdx.x, lane = t & 31, wq = t >> 5, fw = wq & 7;
  const int fo4 = 4 * (4 * fw + (lane >> 3)), ro4 = 4 * (8 * (wq >> 3) + (lane & 7));
  const Layout L = make_layout(rows, Lp, Ld, H);
  const long long Rp = L.Rp;
  auto Wm = [](const void *p) { return static_cast<const float *>(p); };
  float *slots = posx;  // the heads' partial sums, once posx is read
  float acc[4 * NI][8] = {};
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * ROWS;
    auto plane = [&](int f) { return res ? res + f * Rp : nullptr; };
    // a layer's epilogue over `act`, between two barriers
    auto dense = [&](const void *b, int f, const float *hw, int hs, int nh) {
      __syncthreads();  // every product has read `act` (and posx, for the slots)
      epilogue<NI, NI>(acc, Wm(b), H, act, plane(f), Rp, row0, hw, hs, nh, slots, fo4, ro4, lane, fw);
      __syncthreads();
    };
    __syncthreads();  // the last tile's reads of posx, posd and the slots are done
    encode(x, rows, row0, Lp, 0, posx, plane(L.posx()), Rp, t, var, wx);
    __syncthreads();
    product<NI, NI>(acc, rg, posx, FX, fo4, ro4, lane);  // W1
    dense(w.b1, L.h(0), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wt1
    dense(w.bt1, L.h(1), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wt2
    dense(w.bt2, L.h(2), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wt3
    dense(w.bt3, L.h(3), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wt4
    dense(w.bt4, L.h(4), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // skip: Wsh h4 + Wsx posx
    product<NI, NI>(acc, rg, posx, FX, fo4, ro4, lane);
    __syncthreads();  // every product has read `act` and posx
    epilogue<NI, NI>(acc, Wm(w.bs), H, act, plane(L.h(5)), Rp, row0, nullptr, 0, 0, slots, fo4, ro4, lane, fw);
    encode(x, rows, row0, Ld, 3, posd, plane(L.posd()), Rp, t, nullptr, wd);  // for Wcd, over posx
    __syncthreads();
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wp0
    dense(w.bp0, L.h(6), nullptr, 0, 0);
    product<NI, NI>(acc, rg, act, H, fo4, ro4, lane);  // Wp1; sigma's partial sums from h7
    dense(w.bp1, L.h(7), Wm(w.Wcs) + (long long)H2 * H, 0, 1);
    {  // sigma = its eight partial sums in order + bcs[H/2]
      const long long row = row0 + t;
      if (t < ROWS && row < rows) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s += slots[k * ROWS + t];
        out[3 * rows + row] = s + __ldg(Wm(w.bcs) + H2);
      }
    }
    product<NI, 1>(acc, rg, act, H, fo4, ro4, lane);  // Wcs h7 (colour rows) + Wcd posd
    product<NI, 1>(acc, rg, posd, FD, fo4, ro4, lane);
    __syncthreads();  // every product has read `act`; sigma has read its slots
    epilogue<NI, 1>(acc, Wm(w.bcs), H2, act, plane(L.hc()), Rp, row0, Wm(w.Wc1), H2, 3, slots, fo4, ro4, lane,
                    fw);
    __syncthreads();
    {  // rgb = the partial sums of Wc1 hc in order + bc1; rows 4..7 zero
      const int c = t >> 7, r = t & (ROWS - 1);
      const long long row = row0 + r;
      if (row < rows) {
        if (c < 3) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) s += slots[(c * 8 + k) * ROWS + r];
          out[c * rows + row] = s + __ldg(Wm(w.bc1) + c);
        }
        out[(4 + c) * rows + row] = 0.f;
      }
    }
  }
}

// Float u of a weight image: matrix m of PlanT's order in slices of KS
// columns, each slice [k][o] (KS, OP(m)) f32, zero past O and K; the
// weights from PlanT::weight. ff's Plan, or the f32 backward's.
template <class PlanT>
__device__ __forceinline__ float image_at(const Weights &w, const PlanT &P, long long u) {
  long long off = u;
  int m = 0;
  for (; m < PlanT::NMAT - 1; ++m) {
    const long long b = P.slices(m) * P.slice_bytes(m) / 4;
    if (off < b) break;
    off -= b;
  }
  const int OP = P.OP(m);
  const int c = (int)(off / (KS * OP)), k = c * KS + (int)(off % (KS * OP)) / OP, o = (int)(off % OP);
  return o < P.O(m) && k < P.K(m) ? P.weight(w, m, k, o) : 0.f;
}

// The weight image (image_at). One thread a float.
__global__ void image_kernel(Weights w, Plan P, long long n, float *image) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u < n) image[u] = image_at(w, P, u);
}

int build_image(const Weights &w, const Plan &P, void *image, cudaStream_t stream) {
  const long long n = P.image_bytes() / 4;
  image_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(w, P, n, static_cast<float *>(image));
  return (int)cudaGetLastError();
}

// The weight image, then the persistent grid: one block an SM, at most one
// a tile. `image` holds P.image_bytes(), 16-byte aligned. `var`: null, or
// the variance rows of the mip path's input; `wx`, `wd`: null, or the
// anneal windows (FX and FD floats on the card).
int launch(const float *x, float *out, long long rows, int Lp, int Ld, int H, const Weights &w, float *res,
           void *image, const float *var, const float *wx, const float *wd, cudaStream_t stream) {
  const Plan P = plan_of(Lp, Ld, H);
  if (int e = build_image(w, P, image, stream)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = P.NI() == 2 ? fwd_kernel<2> : fwd_kernel<1>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem_bytes());
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (rows + ROWS - 1) / ROWS;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, THREADS, P.smem_bytes(), stream>>>(x, out, rows, Lp, Ld, H, w, static_cast<const char *>(image),
                                                    res, var, wx, wd);
  return (int)cudaGetLastError();
}

}  // namespace ff
