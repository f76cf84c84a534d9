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
// rows x 2 B, x and dx, ~1,344 B a row: 0.21 ms at 3.35 TB/s (its ~72,000
// flop a row take ~0.04 ms on the tensor cores, 0.56 ms on the FMA pipes);
// in f32 the operations, 0.56 ms at 67 TFLOP/s (its bytes 0.41 ms). Under
// mip it reads 9 rows of x and writes 16 of dx, ~1,380 B a row in bf16
// (0.22 ms); the products are the same. The coupled transpose of MIP &&
// CONTRACT adds ~60 flops a row, after the products.
//
// Two kernels share the encoder's transpose (`transpose` and `posx_dx`
// below, with contract_transpose and contract_transpose_mip: the angles,
// damps, windows, codes and the contraction's transposes are one piece of
// code, run by transpose warps of their own, a thread a row), and differ
// in the products. Both take only the slot columns a row of x reads (3
// raw, 3 Lp sin, 3 Lp cos of posx in KX = 64 slots; 27 of posd in KD = 32,
// and with appearance codes their eight in eight more slots, KDA = 40).
//
// f32, input_grad_fma: a register-blocked product on the FMA pipes, in f32
// (no TF32, no split TF32: f32 is the port's parity mode), fed by bulk
// copies.
//  - A persistent grid, one block an SM, walks 256-row tiles as small
//    GEMMs: posx's slot sums (256 rows x 64 slots) = the tile's g_h0 and
//    g_h5 cotangents (2 H features) against W1^T and Wsx^T, posd's (256 x
//    32, or 40 with the code slots) = g_hc (H/2) against Wcd^T.
//  - Eight product warps: warp w sums posx's slots 8 w .. 8 w + 7 (posd's
//    KP/8 w .. KP/8 w + KP/8 - 1) of all 256 rows, a thread 8 rows (4 lane
//    + i and 128 + 4 lane + i, i < 4) x 8 slots. For each feature a thread
//    reads its rows' cotangents (two float4s: a warp's 32 lanes read 512
//    contiguous bytes, free of bank conflicts) and its warp's slot weights
//    (two float4s at one address for the whole warp), then does 64 FMAs.
//    The layout is the shared-memory pipe's: a 128-bit shared load takes a
//    cycle a quarter warp, so the SIMT kernel this replaced (a thread a
//    row, 36% of the bound, a float4 of weights a 4 FMAs) and a first
//    version with 4 x 8 blocks (three loads a 32 FMAs) were held by that
//    pipe; at 8 x 8 it carries as many cycles as the FMA pipes.
//  - Cotangents: a ring of 5 stages (4 with the code slots) of FKC = 8
//    features x 256 rows (8 KB, [feature][row]), a stage for each K-chunk
//    of a tile: first posx's, each 4 features o of g_h0 and of g_h5
//    interleaved (stage feature 2 i is g_h0's o0 + i, 2 i + 1 g_h5's), then
//    g_hc's. A copy warp of its own (RingF32, CopierF32) fills a stage once
//    the eight product warps have released it ("empty" mbarrier): a
//    feature's 256 rows are one cp.async.bulk of 1 KB, completing on the
//    stage's "full" mbarrier, which each product warp waits on for itself.
//    A bulk copy holds the warp that issues it for a while: when the last
//    product warp to release a stage refilled it (the f32 forward's
//    ring), that warp stood still for eight copies a stage, fell behind
//    and so stayed the last, and copies and products ran nearly one after
//    the other; hence a copy warp of its own. Bulk, not 16-byte cp.async:
//    the same copy warp with cp.async (16 copies a lane a stage, arriving
//    on "full" by cp.async.mbarrier.arrive.noinc) took 2.06-2.53 ms at
//    524,288 rows against this kernel's 1.15-1.27, in turns, dx to the
//    bit (probes/input_grad.py --before on that copy of csrc/, an H100 at
//    700 W): one warp cannot issue 512 copies a stage fast enough. The
//    tile is 256 rows for the copies' sake: in a streaming test of these
//    planes (development only, not kept), 512-byte bulk pieces (128-row
//    tiles) streamed far slower than 1 KB pieces, whatever the depth of
//    the ring. A 512-row tile would not fit.
//  - Weights: each block copies the slot columns once, as f32 [k][slot],
//    posx's in the stage's order (line 2 o W1's column o, 2 o + 1 Wsx's),
//    then posd's H/2 lines.
//  - Slot sums: one buffer [row][slot] of 256 rows, a row FSTR = 41 floats
//    (odd: a transpose thread's loads of its row meet 32 rows on 32 banks),
//    handed to the transpose threads and back by named barriers ("full",
//    "empty") three times a tile: posx's slots 0..31 (warps 0..3), 32..63
//    (warps 4..7), then posd's. A transpose thread copies them to registers
//    and frees the buffer before it transposes, long before the next
//    hand-over; the product warps wait on it only for the copy of posx's
//    first half. (Four transpose warps of two rows a thread would give the
//    block 13 warps and 128 registers a thread, but their second row's
//    copy waits on the first row's transpose, and the product warps on
//    that: slower, most under mip.)
//  - Shared memory at H = 256: the weights 2 H x 64 x 4 = 131,072 B and
//    128 x 32 x 4 = 16,384 B (20,480 with the code slots), the sums 256 x
//    41 x 4 = 41,984 B, the ring 5 x 8,192 = 40,960 B (4 stages, 32,768 B,
//    with codes), its barriers 80 B (64): 230,480 B (226,368 with codes) of
//    the 232,448 a block may use. A buffer of all 64 posx slots (68 KB)
//    would leave the ring no stage beside the resident weights.
//  - 544 threads (8 product warps, 8 transpose warps, the copy warp): 17
//    warps take 20 warps' registers, so 96 a thread; ptxas spills 12-16
//    bytes, 60-64 in the point and MIP && CONTRACT instantiations, the
//    slowest two.
//  - Numerics: each slot sums over k in the SIMT kernel's order (posx: for
//    each o, g_h0's product then g_h5's; posd: o upwards), with fmaf, so
//    dx is that kernel's to the bit.
//
// bf16, input_grad_mma: the products on the tensor cores, so that the
// launch is bound by its bytes, not by the FMA pipes (a bf16 SIMT launch
// ran at the f32 one's speed, 13% of its bound).
//  - mma.sync m16n8k16 (bf16 operands, f32 accumulators), the sample rows
//    as M. posx: N = the 64 slots, K = g_h0 against W1^T and then g_h5
//    against Wsx^T (2 H) into one accumulator set; posd: N = 32 (40 with
//    the code slots), K = H/2 (padded to a multiple of 16 with zero
//    weights, and zero cotangents in the stage). mma.sync, not wgmma: the
//    products need ~0.04 ms of the tensor cores against the bytes' 0.21.
//  - A persistent grid, one block an SM, walks 128-row tiles. Eight
//    product warps own 16 rows each (one m16 tile against every n8 tile);
//    four transpose warps run the encoder's transpose, a thread a row,
//    while the product warps go on to the next tile: with the transpose in
//    the product warps, the loads stood still while it ran. Two product
//    warps a scheduler (MM = 1) hide the products behind the loads better
//    than one (MM = 2, four warps of 32 rows; `python -m
//    nerf_simple_tpu_torch.probes.input_grad --before` times a copy of
//    csrc/ with MM = 2 beside this one).
//  - Weights: each block copies the slot columns once, in bf16, as the
//    B operand [o][slot] in 128-byte lines (80 KB at H = 256: posx 2 H
//    lines, posd H/2 padded to 16), the 16-byte chunks swizzled by the
//    line (chunk q at q ^ (o % 8)), and reads the fragments with
//    ldmatrix.trans, free of bank conflicts.
//  - Cotangents: the planes are feature-major, (features, Rp). They stream
//    through a ring of NSTAGE = 5 stages of KC = 64 features x 128 rows (16
//    KB: two whole 128-byte lines a feature) with 16-byte cp.async copies
//    by the product warps, a stage for each K-chunk of a tile: g_h0's
//    chunks, then g_h5's, then g_hc's; 64 KB in flight an SM. The A
//    fragments are read with ldmatrix.trans from the feature-major stage
//    (chunk c of feature line f at c ^ (f % 8): conflict-free). One barrier
//    of the product warps a stage publishes it and frees the one read
//    before.
//  - Slot sums: after a branch's products each product warp writes its
//    accumulators as f32 [slot][row] (a stride of 132 floats: the fragment
//    stores and the transpose's reads by row are both free of bank
//    conflicts) into a buffer of their own, posx's or posd's; named
//    barriers hand each buffer to the transpose warps ("full") and back
//    ("empty"). A transpose thread copies its row's sums to registers,
//    frees the buffer, and runs `posx_dx` (rows 0..2, and under mip 11..13)
//    or posd's `transpose` (rows 3..5, the code rows). No register is held
//    through the products.
//  - Shared memory at H = 256: the ring 80 KB, the weights 80 KB, the two
//    sum buffers 66 KB: 231,424 bytes, one block an SM.
//  - Ragged rows: a tile's rows past Rp are not read (their sums are never
//    used); rows past `rows` are not read from x nor written to dx.
//  - Numerics: bf16 operands, f32 sums, as the TPU kernel's mTg; only the
//    order of the sums differs from the f32 kernel's. Each output column
//    sums over the same K in the same order whatever the instantiation, so
//    the code slots leave rows 0..5 as they are without them, a contracted
//    row inside the ball is the point (or MIP) kernel's, and two launches
//    give the same bits (no atomics).

#pragma once

namespace {
namespace ig {

constexpr int LXM = 10, KX = 64;  // octaves of posx held; slots: 3 raw + 3 LXM sin + 3 LXM cos, padded
constexpr int LDM = 4, KD = 32;   // the same for posd
constexpr int KDA = KD + 8;       // posd's slots with the eight appearance-code columns after them

// The bf16 kernel (input_grad_mma): tiles of MT rows; CWARPS warps of MM
// m16 tiles each run the products, four warps (a thread a row) the
// transpose (MTHREADS in all); ring stages of KC features (STAGE bytes),
// NSTAGE of them; two buffers of slot sums [slot][row], KX slots of ESTR
// floats (a row stride).
constexpr int MT = 128, MM = 1, CWARPS = MT / (16 * MM), CTHREADS = 32 * CWARPS, MTHREADS = CTHREADS + MT;
constexpr int KC = 64, STAGE = KC * MT * 2, NSTAGE = 5;
constexpr int ESTR = MT + 4, SUMS = KX * ESTR;

// The f32 kernel (input_grad_fma): tiles of FT rows; FWARPS warps run the
// products, FT threads (a thread a row) the transpose (FHAND threads, which
// hand the slot sums over), one warp the copies (FTHREADS in all); ring
// stages of FKC features (FSTAGE floats),
// fstages(app) of them; one buffer of slot sums [row][slot], a row FSTR
// floats.
constexpr int FT = 256, FWARPS = 8, FCTHREADS = 32 * FWARPS, FHAND = FCTHREADS + FT, FTHREADS = FHAND + 32;
constexpr int FKC = 8, FSTAGE = FKC * FT, FSTR = 41;
__host__ __device__ constexpr int fstages(bool app) { return app ? 4 : 5; }

long long launches = 0;      // of this library, counted where they launch
long long mip_launches = 0;  // of them, the integrated encoder's transpose (MIP)
long long f32_launches = 0;  // of them, f32 (input_grad_fma)

__host__ __device__ inline int ceil16(int n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of a launch: the ring, the weight lines (posx 2 H,
// posd H/2 padded to 16) and the slot sums; f32 as input_grad_fma lays
// them out, bf16 as input_grad_mma.
__host__ __device__ inline long long smem_bytes(int H, bool app = false, bool is_bf16 = false) {
  if (is_bf16) return (long long)NSTAGE * STAGE + 128LL * (2 * H + ceil16(H / 2)) + 2 * 4LL * SUMS;
  return 4LL * (fstages(app) * FSTAGE + 2LL * H * KX + (long long)(H / 2) * (app ? KDA : KD) + FT * FSTR) +
         16LL * fstages(app);
}

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

// One branch of the encoder's transpose for one row, from its slot sums
// acc (K slots; either kernel's products): times the windows ew (or none),
// then the transpose at the row's three coordinates xc (stride `rows`)
// into d; the sums of the slots past KD (the appearance codes', K = KDA)
// go to `code` as they are. MIP: the sin and cos rows were damped by the
// variances vc (stride `rows`); d gets the angle chain, dv the damp chain.
// CX: the transpose is taken at the contracted coordinates (contract_point
// of the row xc, after the products, so that they hold no register
// through them); with MIP also at the contracted variances.
template <int K, int LM, bool MIP = false, bool CX = false>
__device__ __forceinline__ void transpose(const float (&acc)[K], const float *__restrict__ xc, long long rows, int L,
                                          const float *__restrict__ ew, float d[3], float *code = nullptr,
                                          const float *__restrict__ vc = nullptr, float *dv = nullptr) {
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

// Both kernels' posx transpose for row `row` from its slot sums acc, into
// d (the cotangent of x's rows 0..2, not stored here); under MIP it also
// stores dx rows 11..13 (the variances') and the rows it leaves zero, 8..10, 14, 15;
// CONTRACT: then the contraction's transpose at the raw row (under MIP the
// warp's coupled transpose at the raw mean and variances).
template <bool MIP, bool CONTRACT>
__device__ __forceinline__ void posx_dx(const float (&acc)[KX], const float *__restrict__ x, long long rows,
                                        long long row, int Lp, const float *__restrict__ wx, float d[3],
                                        float *__restrict__ dx) {
  if constexpr (MIP) {
    float dv[3];
    transpose<KX, LXM, true, CONTRACT>(acc, x + row, rows, Lp, nullptr, d, nullptr, x + 11 * rows + row, dv);
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
    transpose<KX, LXM, false, true>(acc, x + row, rows, Lp, wx, d);
    float xo[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) xo[c] = x[c * rows + row];
    contract_transpose(xo, d);
  } else {
    transpose<KX, LXM>(acc, x + row, rows, Lp, wx, d);
  }
}

// ----------------------------------------------------------------------
// The f32 kernel's pieces (input_grad_fma).

// Named barriers of both kernels (0 is __syncthreads'): the bf16 product
// warps' ring, and for each buffer of slot sums (the f32 kernel has one)
// "full" (the product warps arrive, the transpose warps wait) and "empty"
// (the other way round).
constexpr int BAR_RING = 1, BAR_FULL = 2, BAR_EMPTY = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The f32 kernel's ring as the block walks it: chunk n of the block's
// sequence (every tile's chunks in order, tile after tile) sits in stage n
// % stages, filled in a round of parity (n / stages) % 2. A tile's chunks:
// cx of posx, each FKC / 2 features o of g_h0 and of g_h5 interleaved
// (stage feature 2 i is g_h0's o0 + i, 2 i + 1 g_h5's), then g_hc's
// features, FKC a chunk (H/2 is a multiple of FKC). The copy warp fills a
// stage once every product warp has released it ("empty", FWARPS
// arrivals): each feature's rows of the tile are one cp.async.bulk (rows
// past Rp are not read) completing on the stage's "full" barrier, which
// each product warp waits on for itself.
struct RingF32 {
  float *buf;
  uint64_t *full, *empty;
  int stages;
  int stage = 0;
  uint32_t phase = 0;

  // The current stage, once its copies have landed.
  __device__ __forceinline__ const float *wait() const {
    fb::mbar_wait(full + stage, phase);
    return buf + stage * FSTAGE;
  }
  // The warp has read the current stage.
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) fb::mbar_arrive(empty + stage);
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// The copy warp's walk over the block's chunks (tile tn, chunk j, chunk
// n of the sequence): lane `lane` < FKC copies feature `lane`.
struct CopierF32 {
  const RingF32 &rg;
  const float *g0, *g5, *gc;
  long long Rp, ntiles;
  int cx, nch;
  long long tn = blockIdx.x, n = 0;
  int j = 0;

  // Fill the next stage (once it is empty, past the first round) with
  // the tracked chunk, if its tile is the block's; false past the last.
  __device__ __forceinline__ bool next(int lane) {
    if (tn >= ntiles) return false;
    const int s = (int)(n % rg.stages);
    const long long round = n / rg.stages;
    if (round > 0) fb::mbar_wait(rg.empty + s, (uint32_t)((round - 1) & 1));
    if (lane < FKC) {
      const float *src = j < cx ? (lane & 1 ? g5 : g0) + (long long)(FKC / 2 * j + (lane >> 1)) * Rp
                                : gc + (long long)(FKC * (j - cx) + lane) * Rp;
      const long long r0 = tn * FT;
      fb::bulk_load(rg.buf + s * FSTAGE + lane * FT, src + r0, (uint32_t)(4 * (Rp - r0 < FT ? Rp - r0 : FT)),
                    rg.full + s);
    }
    if (++j == nch) j = 0, tn += gridDim.x;
    ++n;
    return true;
  }
};

// acc[i][s] += a stage's FKC features of this thread's rows (g: the stage
// from its first row; rows 4 lane + i for i < 4, 128 + 4 lane + i - 4
// after) times weight lines w[0 .. FKC) of KP slots (w: this warp's first
// slot, KP / 8 slots a warp, the same for every lane). Each sum takes its
// features in the stage's order.
template <int KP>
__device__ __forceinline__ void fma_stage(float (&acc)[8][KP / 8], const float *g, const float *w) {
  constexpr int NS = KP / 8;
#pragma unroll
  for (int k = 0; k < FKC; ++k) {
    const float4 ra = *reinterpret_cast<const float4 *>(g + k * FT);
    const float4 rb = *reinterpret_cast<const float4 *>(g + k * FT + 128);
    const float *wk = w + k * KP;
    float v[NS];
    if constexpr (NS == 5) {
#pragma unroll
      for (int s = 0; s < NS; ++s) v[s] = wk[s];
    } else {
#pragma unroll
      for (int q = 0; q < NS; q += 4) {
        const float4 a = *reinterpret_cast<const float4 *>(wk + q);
        v[q] = a.x;
        v[q + 1] = a.y;
        v[q + 2] = a.z;
        v[q + 3] = a.w;
      }
    }
    const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[i][s] = fmaf(v[s], rv[i], acc[i][s]);
  }
}

// This thread's sums of NS slots to columns c0 .. c0 + NS - 1 of its eight
// rows of e[row][column] (a row FSTR floats).
template <int NS>
__device__ __forceinline__ void store_fsums(const float (&acc)[8][NS], float *e, int lane, int c0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float *p = e + (i < 4 ? 4 * lane + i : 124 + 4 * lane + i) * FSTR + c0;
#pragma unroll
    for (int s = 0; s < NS; ++s) p[s] = acc[i][s];
  }
}

// The f32 kernel. KP: posd's slots, KD, or KDA with the appearance codes
// (dx then has 16 rows); MIP: the integrated encoder's transpose (x and dx
// of 16 rows); CONTRACT: a contracted model's (with MIP: KD only). The last
// warp fills the ring; the FWARPS product warps run the products of each
// tile from it, warp w
// the posx slots 8 w .. 8 w + 7 and the posd slots KP / 8 w .. of all FT
// rows, a thread eight rows; they hand the sums to the transpose threads
// through the one buffer: posx's first 32 slots (warps 0..3), its last 32
// (warps 4..7), then posd's. The FT threads after them run the transpose, a
// thread a row, while the product warps go on.
template <int KP, bool MIP = false, bool CONTRACT = false>
__global__ void __launch_bounds__(FTHREADS, 1)
    input_grad_fma(const float *__restrict__ g0, const float *__restrict__ g5, const float *__restrict__ gc,
                   long long Rp, const float *__restrict__ x, long long rows, int Lp, int Ld, int H, int FX, int FD,
                   const float *__restrict__ W1, const float *__restrict__ Wsx, const float *__restrict__ Wcd,
                   const float *__restrict__ wx, const float *__restrict__ wd, float *__restrict__ dx) {
  constexpr int NS = KP / 8, STAGES = fstages(KP == KDA);  // posd's slots a warp
  extern __shared__ __align__(16) float fsm[];
  const int H2 = H / 2, cx = 2 * H / FKC;
  float *wpx = fsm + STAGES * FSTAGE, *wpd = wpx + 2 * H * KX, *e = wpd + H2 * KP;
  uint64_t *full = reinterpret_cast<uint64_t *>(e + FT * FSTR);
  const long long ntiles = (rows + FT - 1) / FT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RingF32 rg{fsm, full, full + STAGES, STAGES};
  const bool copier = warp == FTHREADS / 32 - 1;
  CopierF32 cp{rg, g0, g5, gc, Rp, ntiles, cx, cx + H2 / FKC};
  if (copier) {
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) {
        fb::mbar_init(full + s, FKC);
        fb::mbar_init(rg.empty + s, FWARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int s = 0; s < STAGES && cp.next(lane); ++s) {
    }
  }
  // the weight lines, while the first stages load: W1^T and Wsx^T
  // interleaved [2 o + (0, 1)][slot], then Wcd^T [o][slot]
#pragma unroll 4
  for (int u = threadIdx.x; u < 2 * H * KX; u += FTHREADS) {
    const int o = u / (2 * KX), k = column<LXM>(u % KX, Lp);
    wpx[u] = k < 0 ? 0.f : ((u / KX) & 1 ? Wsx : W1)[o * FX + k];
  }
#pragma unroll 4
  for (int u = threadIdx.x; u < H2 * KP; u += FTHREADS) {
    const int o = u / KP, s = u % KP, k = s < KD ? column<LDM>(s, Ld) : enc_rows(Ld) + s - KD;
    wpd[u] = k < 0 ? 0.f : Wcd[o * FD + k];
  }
  __syncthreads();
  if (copier) {
    while (cp.next(lane)) {
    }
    return;
  }
  if (warp < FWARPS) {
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      {  // posx: g_h0 against W1^T and g_h5 against Wsx^T, feature by feature
        float acc[8][8] = {};
        for (int j = 0; j < cx; ++j) {
          fma_stage<KX>(acc, rg.wait() + 4 * lane, wpx + FKC * KX * j + 8 * warp);
          rg.release(lane);
        }
        if (t != blockIdx.x) bar_sync(BAR_EMPTY, FHAND);
        if (warp < 4) store_fsums(acc, e, lane, 8 * warp);
        bar_arrive(BAR_FULL, FHAND);
        bar_sync(BAR_EMPTY, FHAND);
        if (warp >= 4) store_fsums(acc, e, lane, 8 * warp - 32);
        bar_arrive(BAR_FULL, FHAND);
      }
      {  // posd: g_hc against Wcd^T (and Wca^T in the code slots)
        float acc[8][NS] = {};
        for (int j = 0; j < H2 / FKC; ++j) {
          fma_stage<KP>(acc, rg.wait() + 4 * lane, wpd + FKC * KP * j + NS * warp);
          rg.release(lane);
        }
        bar_sync(BAR_EMPTY, FHAND);
        store_fsums(acc, e, lane, NS * warp);
        bar_arrive(BAR_FULL, FHAND);
      }
    }
    return;
  }
  const int r = threadIdx.x - FCTHREADS;  // this thread's row of a tile
  const float *er = e + r * FSTR;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row = t * FT + r;
    const bool live = row < rows, more = t + gridDim.x < ntiles;
    float d[3];
    {
      float sums[KX];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the first 32 slots, then the last
        bar_sync(BAR_FULL, FHAND);
#pragma unroll
        for (int k = 0; k < 32; ++k) sums[32 * h + k] = er[k];
        bar_arrive(BAR_EMPTY, FHAND);
      }
      if (live) {
        posx_dx<MIP, CONTRACT>(sums, x, rows, row, Lp, wx, d, dx);
#pragma unroll
        for (int c = 0; c < 3; ++c) dx[c * rows + row] = d[c];
      }
    }
    float sums[KP], code[8];
    bar_sync(BAR_FULL, FHAND);
#pragma unroll
    for (int k = 0; k < KP; ++k) sums[k] = er[k];
    if (more) bar_arrive(BAR_EMPTY, FHAND);
    if (live) {
      transpose<KP, LDM>(sums, x + 3 * rows + row, rows, Ld, wd, d, code);
#pragma unroll
      for (int c = 0; c < 3; ++c) dx[(3 + c) * rows + row] = d[c];
      dx[6 * rows + row] = 0.f;
      dx[7 * rows + row] = 0.f;
      if constexpr (KP == KDA)
#pragma unroll
        for (int j = 0; j < 8; ++j) dx[(8 + j) * rows + row] = code[j];
    }
  }
}

// ----------------------------------------------------------------------
// The bf16 kernel's pieces (input_grad_mma).

// d += a b: one mma.sync m16n8k16, bf16 operands, f32 accumulators (d0,
// d1 at row lane/4, columns 2 (lane%4) + 0, 1; d2, d3 eight rows on).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of rows 8c .. 8c + 7 of feature f in a ring stage: a
// feature's 128 rows are 256 bytes, chunk c sits at c ^ (f % 8).
__device__ __forceinline__ int stage_at(int f, int c) { return f * 256 + ((c ^ (f & 7)) << 4); }
// Byte offset of slots 8q .. 8q + 7 of weight line o: chunk q at q ^ (o % 8).
__device__ __forceinline__ int wline_at(int o, int q) { return o * 128 + ((q ^ (o & 7)) << 4); }

// Start the copies of ring chunk q of this block's walk into `stage` (by
// the product warps), and commit them as one group (an empty one past the
// last tile). A tile's chunks: g_h0's features in KC-feature chunks (cx
// of them), g_h5's, g_hc's. Features past the plane's are zeroed (their
// weights are zero too, but the products must not meet a stale NaN); rows
// past Rp are not read.
__device__ __forceinline__ void load_chunk(char *stage, long long q, int nch, int cx, long long ntiles,
                                           const bf16 *g0, const bf16 *g5, const bf16 *gc, long long Rp, int H) {
  const long long t = blockIdx.x + q / nch * gridDim.x;
  if (t < ntiles) {
    const int j = (int)(q % nch);
    const bf16 *p = j < cx ? g0 : j < 2 * cx ? g5 : gc;
    const int f0 = KC * (j < cx ? j : j < 2 * cx ? j - cx : j - 2 * cx), F = j < 2 * cx ? H : H / 2;
    const int valid = F - f0 < KC ? F - f0 : KC;
    const long long r0 = t * MT;
    for (int u = threadIdx.x; u < KC * MT / 8; u += CTHREADS) {
      const int f = u >> 4, c = u & 15;
      char *dst = stage + stage_at(f, c);
      if (f >= valid)
        *reinterpret_cast<uint4 *>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else if (r0 + 8 * c < Rp)
        cp_async16(dst, p + (long long)(f0 + f) * Rp + r0 + 8 * c);
    }
  }
  cp_async_commit();
}

// acc[m][n] += this warp's 16 MM rows (MM m16 tiles) of a stage's first
// `valid` features (A, feature-major: ldmatrix.trans) times weight lines
// wl[0 .. valid) (B [o][slot], ldmatrix.trans), NT n8 tiles of slots.
// FULL: all KC features, without a branch between the k16 steps.
template <int NT, bool FULL>
__device__ __forceinline__ void mma_steps(float (&acc)[MM][NT][4], const char *stage, const char *wl, int valid,
                                          int warp, int lane) {
  const int j = lane >> 3, i = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    if (!FULL && 16 * ks >= valid) break;
    uint32_t a[MM][4], b[NT][2];
#pragma unroll
    for (int m = 0; m < MM; ++m)  // matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (0-7, 8-15), (8-15, 8-15)
      bb::ldsm4t(stage + stage_at(16 * ks + 8 * (j >> 1) + i, 2 * (MM * warp + m) + (j & 1)), a[m][0], a[m][1],
                 a[m][2], a[m][3]);
    const char *w = wl + (16 * ks + 8 * (j & 1)) * 128;  // matrices (k 0-7, n), (k 8-15, n), then n + 8
#pragma unroll
    for (int n = 0; n < NT / 2; ++n)
      bb::ldsm4t(w + wline_at(i, 2 * n + (j >> 1)), b[2 * n][0], b[2 * n][1], b[2 * n + 1][0], b[2 * n + 1][1]);
    if constexpr (NT % 2) bb::ldsm2t(w + wline_at(i, NT - 1), b[NT - 1][0], b[NT - 1][1]);
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma16816(acc[m][n], a[m], b[n][0], b[n][1]);
  }
}

template <int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[MM][NT][4], const char *stage, const char *wl, int valid,
                                          int warp, int lane) {
  if (valid >= KC)
    mma_steps<NT, true>(acc, stage, wl, valid, warp, lane);
  else
    mma_steps<NT, false>(acc, stage, wl, valid, warp, lane);
}

// The warp's accumulators to the slot sums e[slot][row] (rows of the tile).
template <int NT>
__device__ __forceinline__ void store_sums(const float (&acc)[MM][NT][4], float *e, int warp, int lane) {
  const int r = 16 * MM * warp + (lane >> 2), s = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float *p = e + (8 * n + s) * ESTR + r + 16 * m;
      p[0] = acc[m][n][0];
      p[ESTR] = acc[m][n][1];
      p[8] = acc[m][n][2];
      p[ESTR + 8] = acc[m][n][3];
    }
}

// The bf16 kernel, as input_grad_kernel takes its arguments (KP, MIP,
// CONTRACT as there). The CWARPS product warps stream the cotangents
// through the ring and run the products of each tile: posx's sums to
// buffer 0, posd's to buffer 1. The four warps after them run the
// transpose from those sums, a thread a row, while the product warps go on
// to the next tile's stages.
template <int KP, bool MIP = false, bool CONTRACT = false>
__global__ void __launch_bounds__(MTHREADS, 1)
    input_grad_mma(const bf16 *__restrict__ g0, const bf16 *__restrict__ g5, const bf16 *__restrict__ gc,
                   long long Rp, const float *__restrict__ x, long long rows, int Lp, int Ld, int H, int FX, int FD,
                   const bf16 *__restrict__ W1, const bf16 *__restrict__ Wsx, const bf16 *__restrict__ Wcd,
                   const float *__restrict__ wx, const float *__restrict__ wd, float *__restrict__ dx) {
  constexpr int ND = KP / 8;  // posd's n8 tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int H2 = H / 2, cx = (H + KC - 1) / KC, cd = (H2 + KC - 1) / KC, nch = 2 * cx + cd, kd = ceil16(H2);
  char *ring = reinterpret_cast<char *>(smem), *wpx = ring + NSTAGE * STAGE, *wpd = wpx + 2 * H * 128;
  float *e = reinterpret_cast<float *>(wpd + kd * 128);  // the two buffers of slot sums
  const long long ntiles = (rows + MT - 1) / MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < CWARPS)
    for (int s = 0; s < NSTAGE - 1; ++s) load_chunk(ring + s * STAGE, s, nch, cx, ntiles, g0, g5, gc, Rp, H);
  {  // the weight lines, while the first stages load: W1^T then Wsx^T [o][slot], then Wcd^T
    const int n = threadIdx.x & 63, k = column<LXM>(n, Lp);
    const int kp = n < KD ? column<LDM>(n, Ld) : n < KP ? enc_rows(Ld) + n - KD : -1;
    const bf16 zero = __float2bfloat16(0.f);
    for (int o = threadIdx.x >> 6; o < 2 * H; o += MTHREADS / 64)
      *reinterpret_cast<bf16 *>(wpx + wline_at(o, n >> 3) + 2 * (n & 7)) =
          k < 0 ? zero : o < H ? W1[o * FX + k] : Wsx[(o - H) * FX + k];
    for (int o = threadIdx.x >> 6; o < kd; o += MTHREADS / 64)
      *reinterpret_cast<bf16 *>(wpd + wline_at(o, n >> 3) + 2 * (n & 7)) =
          kp < 0 || o >= H2 ? zero : Wcd[o * FD + kp];
  }
  __syncthreads();
  if (warp < CWARPS) {
    long long q = 0;  // the ring chunk this block reads next
    auto stage = [&]() {  // wait for chunk q, refill the stage read before, return chunk q's stage
      cp_async_wait<NSTAGE - 2>();
      bar_sync(BAR_RING, CTHREADS);
      load_chunk(ring + (q + NSTAGE - 1) % NSTAGE * STAGE, q + NSTAGE - 1, nch, cx, ntiles, g0, g5, gc, Rp, H);
      return ring + q++ % NSTAGE * STAGE;
    };
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const bool first = t == blockIdx.x;
      {  // posx: g_h0 against W1^T, then g_h5 against Wsx^T, into one accumulator set
        float acc[MM][8][4] = {};
        for (int j = 0; j < 2 * cx; ++j) {
          const int f0 = KC * (j < cx ? j : j - cx);
          const char *s = stage();
          mma_stage<8>(acc, s, wpx + (j < cx ? f0 : H + f0) * 128, H - f0, warp, lane);
        }
        if (!first) bar_sync(BAR_EMPTY, MTHREADS);
        store_sums<8>(acc, e, warp, lane);
        bar_arrive(BAR_FULL, MTHREADS);
      }
      {  // posd: g_hc against Wcd^T (and Wca^T in the code slots)
        float acc[MM][ND][4] = {};
        for (int j = 0; j < cd; ++j) {
          const char *s = stage();
          mma_stage<ND>(acc, s, wpd + KC * j * 128, H2 - KC * j, warp, lane);
        }
        if (!first) bar_sync(BAR_EMPTY + 1, MTHREADS);
        store_sums<ND>(acc, e + SUMS, warp, lane);
        bar_arrive(BAR_FULL + 1, MTHREADS);
      }
    }
    cp_async_wait<0>();
    return;
  }
  const int r = 32 * (warp - CWARPS) + lane;  // this thread's row of a tile
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row = t * MT + r;
    const bool live = row < rows, more = t + gridDim.x < ntiles;
    float d[3];
    {
      float sums[KX];
      bar_sync(BAR_FULL, MTHREADS);
#pragma unroll
      for (int k = 0; k < KX; ++k) sums[k] = e[k * ESTR + r];
      if (more) bar_arrive(BAR_EMPTY, MTHREADS);
      if (live) {
        posx_dx<MIP, CONTRACT>(sums, x, rows, row, Lp, wx, d, dx);
#pragma unroll
        for (int c = 0; c < 3; ++c) dx[c * rows + row] = d[c];
      }
    }
    float sums[KP], code[8];
    bar_sync(BAR_FULL + 1, MTHREADS);
#pragma unroll
    for (int k = 0; k < KP; ++k) sums[k] = e[SUMS + k * ESTR + r];
    if (more) bar_arrive(BAR_EMPTY + 1, MTHREADS);
    if (live) {
      transpose<KP, LDM>(sums, x + 3 * rows + row, rows, Ld, wd, d, code);
#pragma unroll
      for (int c = 0; c < 3; ++c) dx[(3 + c) * rows + row] = d[c];
      dx[6 * rows + row] = 0.f;
      dx[7 * rows + row] = 0.f;
      if constexpr (KP == KDA)
#pragma unroll
        for (int j = 0; j < 8; ++j) dx[(8 + j) * rows + row] = code[j];
    }
  }
}

// Start kernel `k` on `threads`-thread blocks with `smem` bytes, a block
// an SM at most, one for every `per_block` rows.
template <class K, class T>
int start(K k, int threads, long long per_block, long long smem, cudaStream_t stream, const T *g0, const T *g5,
          const T *gc, long long Rp, const float *x, long long rows, int Lp, int Ld, int H, int FX, int FD,
          const Weights &w, const float *wx, const float *wd, float *dx) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + per_block - 1) / per_block;
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);
  k<<<grid, threads, smem, stream>>>(g0, g5, gc, Rp, x, rows, Lp, Ld, H, FX, FD, static_cast<const T *>(w.W1),
                                     static_cast<const T *>(w.Wsx), static_cast<const T *>(w.Wcd), wx, wd, dx);
  return (int)cudaGetLastError();
}

// CONTRACT: a contracted model's instantiations (and no other is built).
// bf16 launches the mma kernel, f32 the FMA one.
template <class T, bool CONTRACT = false>
int launch_t(const char *gws, const float *x, long long rows, int Lp, int Ld, int H, const Weights &w,
             const float *wx, const float *wd, float *dx, cudaStream_t stream, bool app, bool mip) {
  const Layout L = make_layout(rows, Lp, Ld, H, app);
  const long long es = sizeof(T);
  auto plane = [&](int f) { return reinterpret_cast<const T *>(gws + es * f * L.Rp); };
  if (reinterpret_cast<uintptr_t>(gws) % 16) return (int)cudaErrorInvalidValue;  // the 16-byte copies
  if constexpr (std::is_same<T, bf16>::value) {
    decltype(&input_grad_mma<KD>) kernel;
    if constexpr (CONTRACT)
      kernel = mip ? input_grad_mma<KD, true, true> : app ? input_grad_mma<KDA, false, true>
                                                          : input_grad_mma<KD, false, true>;
    else
      kernel = mip ? input_grad_mma<KD, true> : app ? input_grad_mma<KDA> : input_grad_mma<KD>;
    return start(kernel, MTHREADS, MT, smem_bytes(H, app, true), stream, plane(L.gh(0)), plane(L.gh(5)),
                 plane(L.gcs()), L.Rp, x, rows, Lp, Ld, H, L.FX, L.FD, w, wx, wd, dx);
  } else {
    decltype(&input_grad_fma<KD>) kernel;
    if constexpr (CONTRACT)
      kernel = mip ? input_grad_fma<KD, true, true> : app ? input_grad_fma<KDA, false, true>
                                                          : input_grad_fma<KD, false, true>;
    else
      kernel = mip ? input_grad_fma<KD, true> : app ? input_grad_fma<KDA> : input_grad_fma<KD>;
    return start(kernel, FTHREADS, FT, smem_bytes(H, app), stream, plane(L.gh(0)), plane(L.gh(5)), plane(L.gcs()),
                 L.Rp, x, rows, Lp, Ld, H, L.FX, L.FD, w, wx, wd, dx);
  }
}

#ifdef CONTRACT_LIBRARY
// dx (8, rows), or (16, rows) with `app` or `mip`, of a contracted model
// from the cotangent planes `gws` of the workspace, on `stream`; counts the
// launch (and the mip and f32 ones apart).
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
    f32_launches += !is_bf16;
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
// mip and f32 ones apart). A contracted model's (`contract`, with or without mip)
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
    f32_launches += !is_bf16;
  }
  return e;
}
#endif

}  // namespace ig
}  // namespace
