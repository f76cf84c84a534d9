// Device code shared by the fused NeRF MLP kernels for Hopper (sm_90a):
// the forward tile kernels (csrc/fused_mlp_fwd.cu, the eval render and
// the first pass of the two training entries; f32 in csrc/fwd_f32.cuh,
// bf16 in csrc/fwd_bf16.cuh) and the backward tile kernels (f32 in
// csrc/bwd_f32.cuh, bf16 in csrc/bwd_bf16.cuh), with the backward's task
// table for the weight-gradient sums (csrc/wgrad.cuh).
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

#include <type_traits>

#include "wgrad.cuh"

// Field order of pack_weights' FusedWeights. Outside the anonymous
// namespace: the extern "C" entries take it, and a parameter type with
// internal linkage would give an entry internal linkage (no symbol).
struct Weights {
  const void *W1, *b1, *Wt1, *bt1, *Wt2, *bt2, *Wt3, *bt3, *Wt4, *bt4;
  const void *Wsh, *Wsx, *bs, *Wp0, *bp0, *Wp1, *bp1;
  const void *Wcs, *bcs, *Wcd, *Wc1, *bc1;
};

// Transposes (in, out) of the matrices the backward multiplies a
// cotangent by (kernels/mlp.py::_transposed). The C entries still take
// them so that their signatures match earlier libraries, whose f32
// backward read them; the backward tile kernels here read Weights and
// transpose into their weight images, so they get null pointers.
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

constexpr int TR = 64;        // the workspace's planes hold rows in whole multiples of TR
constexpr int THREADS = 256;  // 8 warps: a block of the compositing passes
constexpr int MAX_H = 256;    // widest layer the shared-memory plan holds

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int ceil8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int enc_rows(int L) { return 8 + 2 * ceil8(3 * L); }
// Rows of the posd tile and plane: the encoded direction, and with `app`
// the eight appearance-code rows after it (the input's rows 8..15, which
// Wca, packed into Wcd's last eight columns, multiplies).
__host__ __device__ inline int posd_rows(int Ld, bool app) { return enc_rows(Ld) + (app ? 8 : 0); }
__host__ __device__ inline long long align256(long long b) { return (b + 255) / 256 * 256; }

__device__ __forceinline__ float bias(const void *b, int o) {
  return static_cast<const float *>(b)[o];
}

// Scene contraction of one sample (mip-NeRF 360, eqn. 10), in place on
// its coordinates y[0..2]: n = |y| (its square summed without FMAs, as the
// plain version sums it, floored at 1e-20), y unchanged for n <= 1, else
// y * g with g = (2 - 1/n) / n, so that all of space lands in the radius-2
// ball. With `mip`, the three variances v[0..2] first go through the
// contraction's Jacobian at the uncontracted mean (the linearised Gaussian
// warp, eqn. 8-9): v_c = g^2 v_c + 2 g c m_c v_c + c^2 m_c sum_j m_j v_j,
// m = y^2, c = g'(n) / n = (-2/n^2 + 2/n^3) / n. Inside the ball nothing is
// touched (g = 1, c = 0): a contracted launch equals one without there, to
// the bit.
__device__ __forceinline__ void contract_point(float *y, float *v, bool mip) {
  const float n = sqrtf(fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(y[0], y[0]), __fmul_rn(y[1], y[1])),
                                        __fmul_rn(y[2], y[2])), 1e-20f));
  if (n <= 1.f) return;
  const float g = (2.f - 1.f / n) / n;
  if (mip) {
    const float c = (-2.f / (n * n) + 2.f / (n * n * n)) / n;
    float m2[3], m2v = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m2[k] = y[k] * y[k];
      m2v += m2[k] * v[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = g * g * v[k] + 2.f * g * c * m2[k] * v[k] + c * c * m2[k] * m2v;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) y[k] *= g;
}

// ----------------------------------------------------------------------
// Workspace of the backward: the forward's residuals and the backward's
// cotangents, each a (features, Rp) plane in the compute type, Rp = rows
// rounded up to a whole tile. Pad rows hold finite residuals and zero
// cotangents, so they add nothing to a weight gradient. With appearance
// codes the posd plane has eight more rows (posd_rows), and every plane
// after it moves down by eight.
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

__host__ __device__ inline Layout make_layout(long long rows, int Lp, int Ld, int H, bool app = false) {
  return Layout{enc_rows(Lp), posd_rows(Ld, app), H, H / 2, (rows + TR - 1) / TR * TR};
}

#include "fwd_bf16.cuh"  // fb: the bf16 forward tile kernel
#include "fwd_f32.cuh"   // ff: the f32 forward tile kernel (uses fb's ring helpers)
#include "bwd_bf16.cuh"  // bb: the bf16 backward tile kernel
#include "bwd_f32.cuh"   // fw: the f32 backward tile kernel (uses ff's ring and products)

// ----------------------------------------------------------------------
// The twelve weight-gradient sums of the backward, as csrc/wgrad.cuh
// takes them: cotangent plane gf (O features) of gws against residual
// plane af (K features) of res (element size es; null for sizing), into
// dW and db. With appearance codes Wcd's sum runs over posd's eight code
// rows too: its last eight columns are dWca.
void wgrad_tasks(const Layout &L, const Grads &out, const void *res, const void *gws,
                 long long es, WTask w[12]) {
  struct Task { int gf, O, af, K; float *dW, *db; };
  const int H = L.H, H2 = L.H2;
  const Task t[12] = {
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
  for (int i = 0; i < 12; ++i) {
    const char *g = gws ? static_cast<const char *>(gws) + es * t[i].gf * L.Rp : nullptr;
    const char *a = res ? static_cast<const char *>(res) + es * t[i].af * L.Rp : nullptr;
    w[i] = WTask{g, a, t[i].O, t[i].K, t[i].dW, t[i].db};
  }
}

// Launches of the backward tile kernels by this library (each source that
// includes this header is its own library), counted where they launch.
long long bwd_tile_launches = 0;
// Launches of the forward tile kernels' contracted instantiations
// (csrc/fused_contract.cu), counted where they launch.
long long fwd_contract_launches = 0;

// Bytes of the scratch `image` that bwd_tile() needs: the backward weight
// image of the compute type.
long long bwd_image_bytes(int H, int is_bf16) {
  return is_bf16 ? bb::Plan{H}.image_bytes() : fw::Plan{H}.image_bytes();
}

// The backward tile kernel of the compute type: from the output
// cotangents g (rows 0..2 d_rgb, row 3 d_sigma; stride `rows`) and the
// residual planes `res` to every cotangent plane of `gws` (Layout; `app`:
// the appearance model's). Each builds its weight image from `w` in
// `image` (bwd_image_bytes) first. The tile kernels read the relu outputs
// h0..h7 and hc, never posx or posd; an appearance model's posd has eight
// more rows, which moves each of those planes by eight, so they get the
// planes from eight rows on and walk them in the layout without codes.
int bwd_tile(const float *g, long long rows, int Lp, int Ld, int H, bool is_bf16, const Weights &w,
             const void *res, void *gws, void *image, cudaStream_t stream, bool app = false) {
  const long long shift = app ? 8 * make_layout(rows, Lp, Ld, H).Rp * (is_bf16 ? 2 : 4) : 0;
  const char *r = static_cast<const char *>(res) + shift;
  const int e = is_bf16 ? bb::launch(g, rows, Lp, Ld, H, w, reinterpret_cast<const bf16 *>(r),
                                     static_cast<bf16 *>(gws), image, stream)
                        : fw::launch(g, rows, Lp, Ld, H, w, reinterpret_cast<const float *>(r),
                                     static_cast<float *>(gws), image, stream);
  if (e == 0) ++bwd_tile_launches;
  return e;
}

// Backward from output cotangents: the tile kernel, then the twelve
// weight-gradient sums. `res` holds the forward's residuals; gws, image
// and part are scratch. `app`: the appearance model's Layout.
int backward(const float *g, long long rows, int Lp, int Ld, int H, bool is_bf16, const Weights &w,
             void *res, void *gws, void *image, float *part, const Grads &out, cudaStream_t stream,
             bool app = false) {
  if (int e = bwd_tile(g, rows, Lp, Ld, H, is_bf16, w, res, gws, image, stream, app)) return e;
  const Layout L = make_layout(rows, Lp, Ld, H, app);
  WTask tasks[12];
  wgrad_tasks(L, out, res, gws, is_bf16 ? 2 : 4, tasks);
  return wgrad_launch(tasks, 12, L.Rp, is_bf16, part, stream);
}

// Forward of all rows through the tile kernel of the compute type; with
// `res`, the residuals are kept. Each builds its weight image in `image`
// (fwd_image_bytes) first. With `mip`, x has 16 rows of stride `rows` and
// the encoder is the integrated one, on the variances of rows 11..13.
// `wx`, `wd`: null, or the anneal windows of posx and posd (FX and
// enc_rows(Ld) floats on the card), which multiply each encoded row. With
// APP (an appearance model; not with `mip`), x has 16 rows and rows 8..15
// are the appearance codes: the encoder copies them, unencoded and without
// a window, into posd's last eight rows, where Wcd's last eight columns
// (Wca) read them. APP is a compile-time switch: the train-step and render
// entries, which take no codes, build the forward kernels without it only.
// CONTRACT (a contracted model's; not with APP): the encoder contracts
// rows 0..2, and under mip warps the variances, before it encodes them
// (contract_point). Only csrc/fused_contract.cu instantiates it
// (forward_point), which counts its launches in fwd_contract_launches.
template <bool APP = false, bool CONTRACT = false>
int forward(const float *x, float *out, long long rows, int Lp, int Ld, int H, bool is_bf16,
            const Weights &w, void *res, void *image, bool mip, const float *wx, const float *wd,
            cudaStream_t stream) {
  static_assert(!(APP && CONTRACT), "no appearance model is contracted");
  const float *var = mip ? x + 11 * rows : nullptr;
  const int e =
      is_bf16
          ? fb::launch<APP, CONTRACT>(x, out, rows, Lp, Ld, H, w, static_cast<bf16 *>(res), image, var, wx, wd, stream)
          : ff::launch<APP, CONTRACT>(x, out, rows, Lp, Ld, H, w, static_cast<float *>(res), image, var, wx, wd,
                                      stream);
  if (CONTRACT && e == 0) ++fwd_contract_launches;
  return e;
}

// The contracted forward: fused_contract_fwd of csrc/fused_contract.cu, a
// library of its own, which set_contract_forward hands to this one. The
// contracted tile kernels are built there once, not into every library
// that runs a forward: nvcc's code for a kernel depends on the other
// kernels of its translation unit, and beside contracted instantiations
// the bf16 forward without contract built to other SASS (192 more
// instructions at H = 256 in the train-step and render libraries).
#ifndef CONTRACT_LIBRARY  // csrc/fused_contract.cu itself builds no forward without contract
typedef int (*ContractForward)(const float *, float *, long long, int, int, int, int, Weights, void *, void *,
                               int, void *);
ContractForward contract_forward = nullptr;

// forward() of a model without codes, contracted (through contract_forward;
// no windows) or not.
int forward_point(bool contract, const float *x, float *out, long long rows, int Lp, int Ld, int H, bool is_bf16,
                  const Weights &w, void *res, void *image, bool mip, const float *wx, const float *wd,
                  cudaStream_t stream) {
  if (!contract) return forward(x, out, rows, Lp, Ld, H, is_bf16, w, res, image, mip, wx, wd, stream);
  if (!contract_forward || wx) return (int)cudaErrorInvalidValue;
  return contract_forward(x, out, rows, Lp, Ld, H, is_bf16, w, res, image, mip, stream);
}
#endif

long long fwd_smem(int Lp, int Ld, int H, int is_bf16, bool app = false) {
  return is_bf16 ? fb::plan_of(Lp, Ld, H, app).smem_bytes() : ff::plan_of(Lp, Ld, H, app).smem_bytes();
}

// Bytes of the scratch `image` that forward() needs.
long long fwd_image_bytes(int Lp, int Ld, int H, int is_bf16, bool app = false) {
  return is_bf16 ? fb::plan_of(Lp, Ld, H, app).image_bytes() : ff::plan_of(Lp, Ld, H, app).image_bytes();
}

long long bwd_smem(int H, int is_bf16) { return is_bf16 ? bb::Plan{H}.smem_bytes() : fw::Plan{H}.smem_bytes(); }

bool arch_ok(int Lp, int Ld, int H) {
  return H % 16 == 0 && H >= 16 && H <= MAX_H && Lp >= 1 && Ld >= 1;
}

// Workspace of the backward, carved from one buffer: residuals, cotangents,
// the weight-gradient partials and the weight image (the forward's, then
// the backward's: one after the other on the stream), each 256-byte
// aligned.
struct Workspace {
  void *res, *gws;
  float *part;
  void *image;
  long long bytes;
};

Workspace carve(void *base, long long rows, int Lp, int Ld, int H, int is_bf16, bool app = false) {
  const Layout L = make_layout(rows, Lp, Ld, H, app);
  const long long es = is_bf16 ? 2 : 4;
  const long long a = align256(es * L.FA() * L.Rp), b = align256(es * L.FG() * L.Rp);
  WTask tasks[12];
  wgrad_tasks(L, Grads{}, nullptr, nullptr, es, tasks);
  const long long c = align256(4LL * wgrad_part_floats(tasks, 12, L.Rp, is_bf16));
  const long long d = align256(std::max(fwd_image_bytes(Lp, Ld, H, is_bf16, app), bwd_image_bytes(H, is_bf16)));
  char *p = static_cast<char *>(base);
  return Workspace{p, p + a, reinterpret_cast<float *>(p + a + b), p + a + b + c, a + b + c + d};
}

}  // namespace

extern "C" {

// Launches of the backward tile kernels by this library so far, as
// wgrad_launch_count counts the sums.
long long bwd_tile_launch_count(int reset) {
  const long long n = bwd_tile_launches;
  if (reset) bwd_tile_launches = 0;
  return n;
}

// Where forward_point finds the contracted forward (csrc/fused_contract.cu's
// fused_contract_fwd).
#ifndef CONTRACT_LIBRARY
void set_contract_forward(void *f) { contract_forward = reinterpret_cast<ContractForward>(f); }
#endif

}  // extern "C"
