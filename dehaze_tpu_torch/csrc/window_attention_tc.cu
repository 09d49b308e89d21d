// K1 and K3-v3 on Hopper's tensor cores (sm_90a), forward and backward:
// ProbSparse window attention for bf16 activations, N <= 64 tokens per
// window, head dim D in {16, 32, 48, 64}.
//
// Forward: replaces the TPU kernel `_kernel_v4` / `_fused_attn_v4_fwd` of
// dehaze_tpu/ops/pallas/window_attention.py (`fused_window_attention`,
// version 4) for those shapes; `window_attention_fwd_kernel<bf16, kV4>` of
// csrc/window_attention.cu computes the same function on the CUDA cores and
// takes everything else (float32, N > 64, other head dims).
// Same function as the plain twin
// `dehaze_tpu_torch.ops.probsparse.probsparse_attention_bnc`, per window and
// head:
//   S = Q K^T, rounded to bf16 -> M = max over the sampled columns -
//   sum(cnt * S) / N -> the top u rows by rank (M descending, index
//   ascending) -> a1 = softmax(S * scale), rounded -> z = (a1 + bias[h]) +
//   mask (one add of the summed -100 / -200) -> a2 = softmax(z), rounded ->
//   kept rows a2 @ V, the others mean(V).
// Backward: replaces `_kernel_v4_bwd` / `_fused_attn_v4_bwd` (same file,
// :822 and :938) for the same shapes with u <= 32 kept rows;
// `window_attention_bwd_kernel` of csrc/window_attention.cu takes the rest.
// Same function as `probsparse_attention_bnc_bwd`: the chain recomputed
// (the roundings of a1 and a2 pass the gradient straight through; a2 is
// used unrounded), then, with g_sel the output gradient on the kept rows,
//   dv = a2^T g_sel + sum_i g_unsel / N,  da2 = g_sel V^T,
//   dz = a2 * (da2 - rowsum(da2 * a2)),    ds = a1 * (dz - rowsum(dz * a1)),
//   dq = scale * ds K,  dk = scale * ds^T Q,  dbias[h] = sum over windows dz.
// q/k/v/g/out/dq/dk/dv are token-major [B_ * N, C] with heads as channel
// slices; region ids and pad flags are [nW, N], indexed by window % nW.
// The forward also takes head-major q/k/v/out [B, H, N, D] (the HM
// template argument; K3's v1 and v2): a window-head is then one contiguous
// N x D block, at (w * H + h) * N * D with rows D apart, so its loads are
// unstrided runs of 16-byte copies.
//
// K3 on the same kernels (the `Numerics` argument, as in
// csrc/window_attention.cu): K3-v3, `_kernel_v3` / `_fused_attn_v3_fwd` and
// `_kernel_v3_bwd` / `_fused_attn_v3_bwd` (window_attention.py:618, :639),
// token-major, and K3-v2, `_kernel_v2` of
// `probsparse_window_attention_pallas_v2` (:220), head-major, forward only,
// both "v23" (twins `probsparse_attention_bnc(numerics="v23")` and
// `probsparse_attention_v2`); K3-v1, `_kernel` of
// `probsparse_window_attention_pallas` (:317), head-major, forward only,
// "v1" (twin `probsparse_attention_v1`):
//   kV4   as above.
//   kV23  q * scale rounded to bf16 (the scale rounded to bf16 first) as q
//         is widened for QK^T, and in the backward's q tile, which dk then
//         uses with no further scale; S rounded once, to float, not to bf16,
//         and M taken on it (sum(cnt * S) in float64, each product exact
//         there); the first softmax without a further scale; a1 not rounded.
//   kV1   nothing rounded in the chain: S rounded once, to float, from the
//         unscaled q, M on it (as kV23); a1 = softmax(S * scale) and a2
//         not rounded; PV in float32: a2 split into bf16 hi + lo (about 16
//         significand bits), each half times the bf16 V on the tensor
//         cores into one float32 sum, twice kV23's PV products. a2's hi
//         and lo rows are packed 2 * kLS bf16 apart, so the r-th kept row
//         lies on float S row r, which no later pass of the chain reads.
//         Its tiles and occupancy are kV23's (the same float S plan).
// kV23's float S tile is twice kV4's bf16 one. The forward then holds fewer
// window-heads per SM: one CTA of as many warps as fit (7 at D = 32) for
// kV4's two CTAs of four. The backward keeps its pairs and loses one (3 at
// D = 32 for kV4's 4); its a1, a float that the ds step needs, is written
// over the kept row's S in the tile (no registers for it), and dq rows are
// staged in the same float rows. S in registers instead would need the
// whole 64 x 64 tile per warp (128 registers a lane) before the rank says
// which rows are kept, and staging only some rows is not possible before
// the rank either; so the tile is what shrinks occupancy. float32 stays on
// the CUDA-core kernels.
//
// What bounds it. Per window-head the forward moves 4 * N * D bf16 (q, k,
// v in, out out: 16 KB at N = 64, D = 32) and the backward 7 * N * D (q,
// k, v, g in, dq, dk, dv out); both do N * N * D multiply-adds for QK^T in
// float64, and the kept rows' products in bf16 (u * N * D for PV; about
// 10 * u * N * D for da2, dq, dk and dv, the f32 operands in two terms).
// HBM is the bound of the work (0.165 ms for the 33,280 window-heads of the
// serving frame's first stage, 0.07 ms for the 8,192 of a train step's);
// QK^T on the FP64 tensor cores (67 TFLOP/s) is of the same order, and the
// row statistics, 2 * u * N accurate expf per window-head, come next.
//
// Design, shared by both kernels. A CTA holds warps of one head h, so the
// count matrix and bias[h] are staged in shared memory once per CTA; there
// is one wave of CTAs. In the forward each warp walks its window-heads one
// after another, on its own; in the backward a pair of warps shares each
// window-head's tiles and splits its work (m16 blocks of S, tiles of kept
// slots, tiles of dv/dk rows, the loads and stores), meeting at a named
// barrier between phases: the backward's tiles leave room for one CTA of
// 3-5 pairs per SM, and a pair halves each warp's serial chain while two
// warps per scheduler hide each other's latency.
//   load   k and v (and, in the backward, q and g) of the window-head by
//          16-byte cp.async into bf16 shared tiles (rows past N
//          zero-filled); q also goes straight from global memory into
//          registers, one m16 block ahead of its use;
//   QK^T   mma.sync m16n8k16 in float64 (Hopper's shape, one
//          instruction for eight of m8n8k4), the bf16 operands widened on
//          the way in, 16 rows x N columns at a time (32 double
//          accumulators per lane); the head dim is walked in a permuted
//          order (lane quad t takes the contiguous columns t*D/4 ...
//          t*D/4 + D/4 - 1), so every fragment is one contiguous load.
//          S is rounded to float and then to bf16 into shared memory
//          right after each block, and the measure (max and float64
//          sum(cnt * S) over a row) is taken from the rounded values in
//          registers, reduced over the lane quad that holds the row;
//   rank   a lane per row compares its M with all N; the kept rows are
//          compacted into a list by ballot (exactly u of them).
// Forward, past the selection:
//   chain  only the u kept rows, two lanes per row (32 columns each, in
//          registers), sixteen rows at a time: both softmaxes with accurate
//          expf, bias and mask from shared memory; a2, rounded to bf16, is
//          written packed into row r of the S tile for the r-th kept row;
//   PV     mma.sync m16n8k16 (bf16 in, float32 sum) on the packed rows
//          (ceil(u / 16) m16 tiles), operands by ldmatrix; rows staged in
//          the k tile, which QK^T no longer needs;
//   mean   one column sum of V per window-head;
//   store  16-byte stores of each row: the staged row if kept, else mean.
// Backward, past the selection, on the kept rows only (u = 25 of 64: two
// m16 tiles of kept slots, one per warp of the pair; slots past u read a
// zero row):
//   chain  per m16 tile, in the mma accumulator layout (a lane holds rows
//          g and g + 8 of the tile, sixteen columns each; row sums over
//          the lane quad): a1 (rounded to bf16, as kV4 does) and a2 (f32);
//   da2    g_sel V^T as bf16 mma.sync (both operands exact bf16 inputs,
//          f32 sums), g_sel rows gathered by ldmatrix row addresses;
//   dz, ds in registers; dz is added into the pair's own float32 [N, N]
//          dbias partial (global memory; each element by one thread in a
//          window, windows ordered by the pair's barriers; the tile's
//          partial rows are loaded before its chain, so the L2 round trip
//          is hidden);
//   dq     ds K on the tensor cores, ds split into bf16 hi + lo (two mmas;
//          about 16 significand bits kept), staged in the S tile's row;
//   dv, dk after both tiles, from a2 and ds staged as hi + lo bf16 tiles:
//          a2^T g_sel + sum(g_unsel) / N and scale * ds^T q_sel, the
//          transposes by ldmatrix.trans, staged in the v and k tiles;
//   store  16-byte stores of dq (zero rows for unselected tokens), dk, dv.
// A second kernel sums the pairs' dbias partials in slot order. Every sum
// has a fixed order, so dbias is the same from run to run (no float
// atomics). Unselected rows (39 of 64 at N = 64) never run a softmax. N =
// 64 is compiled as a constant (FULL); other N run the same code with a
// runtime N and branch-free masks past it.
//
// Exactness of the selection. The rows kept depend discontinuously on S,
// so S and M must come out bit-identical to the twin's in both passes. A
// product of two bf16 values has a 16-bit significand and is exact in
// float64; the sum of D such products is exact in float64 whenever their
// exponents span fewer than about 32 binades, and an exact sum is the same
// double in any order: the FP64 tensor cores here, the scalar fma chain of
// the CUDA-core kernels and the twin's float64 matmul all give it, and all
// round it once to float and once to bf16. sum(cnt * S) over bf16 values
// and small integer counts is exact in float64 as well, so the lane-split
// sum is order-free; the max is. The rank is a pure comparison. Both
// kernels run the same device functions for all of it. The softmax sums
// are float32 and run in another order than the twin's; that moves a1 and
// a2 by about an ulp and never the selection. In kV23, q * scale is bf16,
// so S is exact in float64 as before and is rounded once, to float; each
// float S times a count is exact in float64 (32 significand bits), and
// their float64 sum over a row, rounded to float, is the twin's unless the
// row's values span more than about 20 binades, where the sum itself
// rounds; the twin sums in float64 too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxN = 64;
constexpr int kLS = kMaxN + 8;          // row stride of the S / a2 tile
// Row strides of the staged bias (floats) and counts (bytes), padded so
// that rows read side by side fall in different banks.
constexpr int kBS = kMaxN + 1;
constexpr int kCS = kMaxN + 8;
constexpr int kShared = kMaxN * kBS * 4 + kMaxN * kCS;  // bias + counts
static_assert(kShared % 16 == 0, "16-byte aligned warp slices");
constexpr int kSmemMax = 232448;        // shared memory a CTA may use
constexpr int kMaxKept = 32;            // kept rows the backward takes

// Where the chain rounds (values as csrc/window_attention.cu's Numerics).
enum Numerics : int { kV4 = 0, kV1 = 1, kV23 = 2 };

// The S tile's element: bf16 where S is rounded to bf16 (kV4), float where
// it is not (kV1, kV23). Rows are kLS elements apart in either.
template <int NUM>
using STile = std::conditional_t<NUM == kV4, bf16, float>;

// Forward: kV4 four warps per CTA, two CTAs per SM; kV1 and kV23 one CTA
// per SM of as many warps as their tiles allow (8, 7, 6, 5 at D = 16, 32,
// 48, 64).
template <int D, int NUM>
struct Cfg {
  using ST = STile<NUM>;
  static constexpr int LD = D + 8;      // row stride of the k, v, out tiles
  static constexpr int DQ = D / 4;      // k-steps of the float64 MMA
  static constexpr int kWarpBytes =
      2 * kMaxN * LD * 2 +              // k (then out), v
      kMaxN * kLS * static_cast<int>(sizeof(ST)) +  // S, then packed a2
      3 * kMaxN * 4 +                   // M, region ids, pad flags
      kMaxN * 2 + kMaxN;                // mean(V), kept-row list
  static constexpr int kFit = (kSmemMax - kShared) / kWarpBytes;
  static constexpr int kWarps = NUM == kV4 ? 4 : (kFit < 8 ? kFit : 8);
  static constexpr int kMinCtas = NUM == kV4 ? 2 : 1;  // per SM
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSmem = kShared + kWarps * kWarpBytes;
  static_assert(D % 16 == 0 && D <= 64, "head dim 16, 32, 48 or 64");
  static_assert(kWarpBytes % 16 == 0, "16-byte aligned warp slices");
  static_assert(kWarps >= 1 && kSmem <= kSmemMax, "a warp's tiles fit");
};

// Backward: one CTA per SM, as many pairs of warps as their tiles allow
// (kV4: 5, 4, 3, 3 at D = 16, 32, 48, 64; kV23: 4, 3, 3, 2); a pair shares
// one set of tiles.
template <int D, int NUM>
struct BwdCfg {
  using ST = STile<NUM>;
  static constexpr int LD = D + 8;
  static constexpr int kPairBytes =
      4 * kMaxN * LD * 2 +              // k (then dk), v (then dv), q, g
      kMaxN * kLS * static_cast<int>(sizeof(ST)) +  // S (a1), then dq rows
      4 * kMaxKept * kLS * 2 +          // a2 hi, a2 lo, ds hi, ds lo
      3 * kMaxN * 4 +                   // M, region ids, pad flags
      kMaxN * 4 +                       // sum(g_unsel) / N
      kLS * 2 + kMaxN +                 // a zero row, kept-row list
      16;                               // the pair's keep bits
  static constexpr int kPairsRaw = (kSmemMax - kShared) / kPairBytes;
  static constexpr int kPairs = kPairsRaw < 8 ? kPairsRaw : 8;
  static constexpr int kThreads = 64 * kPairs;
  static constexpr int kSmem = kShared + kPairs * kPairBytes;
  static_assert(kPairBytes % 16 == 0, "16-byte aligned pair slices");
  static_assert(kPairs >= 1, "a pair's tiles fit in shared memory");
};

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// d += a (16x16, row) * b (16x8, col) in float64 (sm_90). With g = l / 4
// and t = l % 4 for lane l: a0[j] = a[g][t + 4j], a1[j] = a[g + 8][t + 4j],
// b[j] = b[t + 4j][g], d = {d[g][2t], d[g][2t + 1], d[g + 8][2t],
// d[g + 8][2t + 1]}. Not volatile: independent products may interleave.
__device__ __forceinline__ void dmma16(double (&d)[4], const double* a0,
                                       const double* a1, const double* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0[0]), "d"(a1[0]), "d"(a0[1]), "d"(a1[1]), "d"(a0[2]),
        "d"(a1[2]), "d"(a0[3]), "d"(a1[3]), "d"(b[0]), "d"(b[1]), "d"(b[2]),
        "d"(b[3]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, float32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x / y rounded to nearest, as the IEEE division, given ry = RN(1 / y):
// q = RN(x * ry) is within an ulp of x / y, and one correction by the exact
// residual (fma) rounds it correctly (Markstein), without the division's
// branch to its slow path. For x >= 0 and y >= 1 (softmax numerators over
// their sum) only quotients below float's normal range could differ, and
// those vanish in the bf16 rounding that follows.
__device__ __forceinline__ float div_rn(float x, float y, float ry) {
  const float q = x * ry;
  return fmaf(fmaf(-q, y, x), ry, q);
}

// n bf16 (n a multiple of 4) from p (8-byte aligned), widened to double.
template <int n>
__device__ __forceinline__ void load_wide(const bf16* p, double* dst) {
#pragma unroll
  for (int c = 0; c < n / 4; ++c) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + 4 * c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[4 * c + i] = bf2f(e[i]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as bf16 pairs hi = RN(x) and lo = RN(x - hi): hi + lo keeps about
// 16 significand bits of x.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// ---- shared by the forward and the backward ----------------------------

// The count matrix and bias[h], once per CTA (zero past N), by the CTA's
// THREADS threads (a compile-time stride, so the loads are unrolled and in
// flight together).
template <int THREADS>
__device__ __forceinline__ void stage_bias_counts(
    float* sBias, unsigned char* sCnt, const int32_t* __restrict__ cnt,
    const float* __restrict__ bias, int h, int N) {
  for (int e = threadIdx.x; e < kMaxN * kMaxN; e += THREADS) {
    const int i = e >> 6, j = e & 63;
    const bool in = i < N && j < N;
    sCnt[i * kCS + j] = in ? static_cast<unsigned char>(cnt[i * N + j]) : 0;
    if (bias != nullptr) {
      sBias[i * kBS + j] =
          in ? bias[(static_cast<size_t>(h) * N + i) * N + j] : 0.f;
    }
  }
}

// One [N, D] slice (rows C elements apart: the channel count when
// token-major, D when head-major) into a [N16][LD] shared tile by 16-byte
// cp.async, rows N ... N16 zero, by threads i of n. Not committed here.
template <int D, int LD>
__device__ __forceinline__ void cp_tile(bf16* dst,
                                        const bf16* __restrict__ src,
                                        int N, int N16, int C, int i, int n) {
  for (int e = i; e < N16 * (D / 8); e += n) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool ok = r < N;
    cp_async16(smem_addr(dst + r * LD + c),
               src + static_cast<size_t>(ok ? r : 0) * C + c, ok);
  }
}

// This window's region ids and pad flags (zero past N or without them),
// by threads i of n.
__device__ __forceinline__ void load_masks(int* sReg, int* sPad,
                                           const int32_t* __restrict__ region,
                                           const int32_t* __restrict__ pad,
                                           size_t wn, int N, int i, int n) {
  for (int j = i; j < kMaxN; j += n) {
    sReg[j] = region != nullptr && j < N ? region[wn + j] : 0;
    sPad[j] = pad != nullptr && j < N ? pad[wn + j] : 0;
  }
}

// q rows m0 + g and m0 + 8 + g, columns t*DQ ... t*DQ + DQ - 1, in
// registers (zero past N), loaded one m16 block ahead of their use.
template <int D>
struct QRows {
  static constexpr int DQ = D / 4;
  uint2 raw[2][DQ / 4];
  __device__ __forceinline__ void load(const bf16* __restrict__ qw, int C,
                                       int N, int m0, int g, int t) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = m0 + 8 * b + g;
      const uint2* p = reinterpret_cast<const uint2*>(
          qw + static_cast<size_t>(r < N ? r : 0) * C + t * DQ);
#pragma unroll
      for (int c = 0; c < DQ / 4; ++c) {
        raw[b][c] = r < N ? __ldg(p + c) : make_uint2(0u, 0u);
      }
    }
  }
};

// q * qsc rounded to bf16 (kV23's scaled q; qsc is the scale rounded to
// bf16, so the float product is exact before its one rounding).
__device__ __forceinline__ float q_scaled(bf16 q, float qsc) {
  return bf2f(__float2bfloat16_rn(bf2f(q) * qsc));
}

// kV23: the first n_rows rows of a [.][LD] q tile times qsc, rounded, in
// place, by threads i of n: the same 16-byte pieces cp_tile gave each of
// them, so each thread's own completed copies are all it touches.
template <int D, int LD>
__device__ __forceinline__ void scale_tile(bf16* tile, int n_rows, float qsc,
                                           int i, int n) {
  for (int e = i; e < n_rows * (D / 8); e += n) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4* p = reinterpret_cast<uint4*>(tile + r * LD + c);
    uint4 raw = *p;
    bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __float2bfloat16_rn(q_scaled(x[j], qsc));
    *p = raw;
  }
}

// QK^T in float64 on the tensor cores, 16 rows at a time (rows m_first,
// m_first + STEP, ...), from q rows in registers (`qr` holds rows m_first
// ... m_first + 15 on entry; kV23 scales them by qsc as they are widened)
// and the k tile. S, rounded to float (and then, in kV4, to bf16), goes to
// sS; the measure of each row is taken from the rounded values in registers
// (the lane quad t = 0..3 holds a row's columns; counts past N are zero).
template <int D, bool FULL, int STEP, int NUM>
__device__ __forceinline__ void qk_measure(
    QRows<D>& qr, const bf16* __restrict__ qw, int C, const bf16* sK,
    STile<NUM>* sS, float* sM, const unsigned char* sCnt,
    int n_tokens, int m_first, int lane, float qsc) {
  constexpr int LD = D + 8, DQ = D / 4;
  const int N = FULL ? kMaxN : n_tokens;
  const int g = lane >> 2, t = lane & 3;
  const int NT = (N + 7) >> 3;
  for (int m0 = m_first; m0 < N; m0 += STEP) {
    double qa[2][DQ];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int c = 0; c < DQ / 4; ++c) {
        const bf16* e = reinterpret_cast<const bf16*>(&qr.raw[b][c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[b][4 * c + i] = NUM == kV23 ? q_scaled(e[i], qsc) : bf2f(e[i]);
        }
      }
    }
    if (m0 + STEP < N) qr.load(qw, C, N, m0 + STEP, g, t);
    // k-slot t + 4j of k-block kk is column t*DQ + 4kk + j, in A and B
    double acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0;
      if (nt < NT) {
        double kb[DQ];
        load_wide<DQ>(sK + (nt * 8 + g) * LD + t * DQ, kb);
#pragma unroll
        for (int kk = 0; kk < DQ / 4; ++kk) {
          dmma16(acc[nt], qa[0] + 4 * kk, qa[1] + 4 * kk, kb + 4 * kk);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = m0 + 8 * b + g;
      float m_max = -1e30f;
      double m_sum = 0.0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < NT) {
          const int c = nt * 8 + 2 * t;
          float2 s = make_float2(__double2float_rn(acc[nt][2 * b]),
                                 __double2float_rn(acc[nt][2 * b + 1]));
          if constexpr (NUM != kV4) {
            *reinterpret_cast<float2*>(sS + r * kLS + c) = s;
          } else {
            const __nv_bfloat162 s2 = __floats2bfloat162_rn(s.x, s.y);
            *reinterpret_cast<__nv_bfloat162*>(sS + r * kLS + c) = s2;
            s = __bfloat1622float2(s2);
          }
          const unsigned cc = *reinterpret_cast<const unsigned short*>(
              sCnt + r * kCS + c);
          // count c < 256 as float (exact, without a conversion unit)
          const float c0 = __int_as_float(0x4b000000 | (cc & 0xffu)) -
                           8388608.f;
          const float c1 = __int_as_float(0x4b000000 | (cc >> 8)) -
                           8388608.f;
          // branch-free: unsampled columns add 0 and leave the max
          m_max = fmaxf(m_max, fmaxf(c0 > 0.f ? s.x : -1e30f,
                                     c1 > 0.f ? s.y : -1e30f));
          if constexpr (NUM != kV4) {
            // a float S times 8 bits is exact in float64, not in float
            m_sum += static_cast<double>(s.x) * static_cast<double>(c0);
            m_sum += static_cast<double>(s.y) * static_cast<double>(c1);
          } else {
            // exact in float: an 8-bit significand times 8 bits
            m_sum += static_cast<double>(s.x * c0);
            m_sum += static_cast<double>(s.y * c1);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m_max = fmaxf(m_max, __shfl_xor_sync(~0u, m_max, o));
        m_sum += __shfl_xor_sync(~0u, m_sum, o);
      }
      if (t == 0 && r < N) {
        sM[r] = m_max - __double2float_rn(m_sum) / static_cast<float>(N);
      }
    }
  }
}

// rank: (M descending, index ascending) < u; the kept rows listed in index
// order in sIdx, the keep bits of rows 0..31 and 32..63 in keep_lo /
// keep_hi. Returns the number kept.
__device__ __forceinline__ int rank_rows(const float* sM, unsigned char* sIdx,
                                         int N, int u, int lane,
                                         unsigned& keep_lo,
                                         unsigned& keep_hi) {
  bool keep[2];
  const int i0 = lane, i1 = lane + 32;
  const float m0 = i0 < N ? sM[i0] : 0.f, m1 = i1 < N ? sM[i1] : 0.f;
  int rank0 = 0, rank1 = 0;
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const float mj = sM[j];
    rank0 += (mj > m0) || (mj == m0 && j < i0);
    rank1 += (mj > m1) || (mj == m1 && j < i1);
  }
  keep[0] = i0 < N && rank0 < u;
  keep[1] = i1 < N && rank1 < u;
  keep_lo = __ballot_sync(~0u, keep[0]);
  keep_hi = __ballot_sync(~0u, keep[1]);
  const unsigned below = (1u << lane) - 1u;
  const int n_lo = __popc(keep_lo);
  if (keep[0]) sIdx[__popc(keep_lo & below)] = lane;
  if (keep[1]) sIdx[n_lo + __popc(keep_hi & below)] = lane + 32;
  return n_lo + __popc(keep_hi);
}

// The backward's rank, split over a pair: the keep bits of rows
// 32*half ... 32*half + 31, by the same comparison as rank_rows (a lane per
// row, the measures read 16 bytes at a time).
template <bool FULL>
__device__ __forceinline__ unsigned rank_half(const float* sM, int N, int u,
                                              int half, int lane) {
  const int i = 32 * half + lane;
  const float mi = i < N ? sM[i] : 0.f;
  int rank = 0;
  const float4* m4 = reinterpret_cast<const float4*>(sM);
#pragma unroll 4
  for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
    const float4 m = m4[j4];
    const float mj[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * j4 + c;
      if (FULL || j < N) rank += (mj[c] > mi) || (mj[c] == mi && j < i);
    }
  }
  return __ballot_sync(~0u, i < N && rank < u);
}

__device__ __forceinline__ bool kept_row(unsigned keep_lo, unsigned keep_hi,
                                         int i) {
  return ((i < 32 ? keep_lo >> i : keep_hi >> (i - 32)) & 1u) != 0;
}

// ---- forward ------------------------------------------------------------

// FULL: N = 64 (8x8 windows, every stage of the default model), a
// compile-time constant, so no loop or select depends on a runtime N.
// HM: head-major q/k/v/out [B, H, N, D] (K3's v1 and v2), where a
// window-head is one contiguous N x D block; else token-major [B * N, C].
template <int D, bool FULL, int NUM, bool HM>
__global__ void __launch_bounds__(Cfg<D, NUM>::kThreads,
                                  Cfg<D, NUM>::kMinCtas)
    window_attention_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const int32_t* __restrict__ cnt,
        const float* __restrict__ bias, const int32_t* __restrict__ region,
        const int32_t* __restrict__ pad, bf16* __restrict__ out, int B,
        int n_tokens, int C, int nW, int u, float scale) {
  using L = Cfg<D, NUM>;
  using ST = typename L::ST;
  constexpr int kWarps = L::kWarps;
  const int N = FULL ? kMaxN : n_tokens;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sBias = reinterpret_cast<float*>(smem);        // [64][kBS] bias[h]
  unsigned char* sCnt = smem + kMaxN * kBS * 4;          // [64][kCS] counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ws = smem + kShared + warp * L::kWarpBytes;
  bf16* sK = reinterpret_cast<bf16*>(ws);                // [64][LD]: k, out
  bf16* sV = sK + kMaxN * LD;                            // [64][LD]
  ST* sS = reinterpret_cast<ST*>(sV + kMaxN * LD);       // [64][kLS]
  // packed a2, bf16 rows kA2 apart over the S tile (row r of a2 never
  // reaches a float S row that a later pass of the chain reads: r <= i);
  // kV1's rows hold a2 as bf16 hi + lo, the lo half kLS after the hi one,
  // so row r lies on float S row r
  constexpr int kA2 = NUM == kV1 ? 2 * kLS : kLS;
  bf16* sA2 = reinterpret_cast<bf16*>(sS);
  float* sM = reinterpret_cast<float*>(sS + kMaxN * kLS);  // [64]
  int* sReg = reinterpret_cast<int*>(sM + kMaxN);          // [64]
  int* sPad = sReg + kMaxN;                                // [64]
  bf16* sMean = reinterpret_cast<bf16*>(sPad + kMaxN);     // [64]
  unsigned char* sIdx = reinterpret_cast<unsigned char*>(sMean + kMaxN);
  const int h = blockIdx.y;
  const bool has_bias = bias != nullptr, has_reg = region != nullptr,
             has_pad = pad != nullptr;
  const float qsc = bf2f(__float2bfloat16_rn(scale));  // kV23's q scale

  stage_bias_counts<L::kThreads>(sBias, sCnt, cnt, bias, h, N);
  __syncthreads();
  // phase: stage

  const int g = lane >> 2, t = lane & 3;
  const int N16 = (N + 15) & ~15;
  // Each warp walks window-heads w, w + kWarps * gridDim.x, ... of head h
  // on its own; no CTA-wide barrier follows.
  // a token's row: C elements on from the last (token-major), or D
  const int rs = HM ? D : C;
  for (int w = blockIdx.x * kWarps + warp; w < B;
       w += gridDim.x * kWarps) {
    const size_t base =
        HM ? (static_cast<size_t>(w) * gridDim.y + h) * N * D
           : static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;

    // load: k and v by cp.async (rows N ... N16 zero), this window's masks,
    // q rows 0..15 into registers.
    cp_tile<D, LD>(sK, k + base, N, N16, rs, lane, 32);
    cp_tile<D, LD>(sV, v + base, N, N16, rs, lane, 32);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    load_masks(sReg, sPad, region, pad, static_cast<size_t>(w % nW) * N, N,
               lane, 32);
    QRows<D> qr;
    qr.load(q + base, rs, N, 0, g, t);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    // phase: load

    qk_measure<D, FULL, 16, NUM>(qr, q + base, rs, sK, sS, sM, sCnt, N, 0,
                                 lane, qsc);
    __syncwarp();
    // phase: QK^T+measure

    unsigned keep_lo, keep_hi;
    const int nk = rank_rows(sM, sIdx, N, u, lane, keep_lo, keep_hi);
    __syncwarp();
    // phase: rank

    // chain, kept rows only, two lanes per row (sixteen rows at a time):
    // lane sub = lane & 1 holds columns 16m + 8sub ... 16m + 8sub + 7, m =
    // 0..3, in registers. a2 of the r-th kept row, rounded (kV1: split
    // into bf16 hi + lo), goes to row r of sA2 (zero past N); rows are
    // listed in index order, so row r is never a later pass's input.
    const int slot = lane >> 1, sub = lane & 1;
    for (int r0 = 0; r0 < nk; r0 += 16) {
      const int r = r0 + slot;
      const int i = r < nk ? sIdx[r] : 0;
      float x[32];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if constexpr (NUM != kV4) {
          const float4* sv = reinterpret_cast<const float4*>(
              sS + i * kLS + 16 * m + 8 * sub);
          const float4 a = sv[0], b = sv[1];
          x[8 * m + 0] = a.x, x[8 * m + 1] = a.y, x[8 * m + 2] = a.z;
          x[8 * m + 3] = a.w, x[8 * m + 4] = b.x, x[8 * m + 5] = b.y;
          x[8 * m + 6] = b.z, x[8 * m + 7] = b.w;
        } else {
          const uint4 sv = *reinterpret_cast<const uint4*>(
              sS + i * kLS + 16 * m + 8 * sub);
          const bf16* se = reinterpret_cast<const bf16*>(&sv);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[8 * m + e] = bf2f(se[e]);
        }
      }
      __syncwarp();  // this pass's rows are read before any is overwritten
      // branch-free: columns past N enter as -inf, so exp gives them 0;
      // kV23's S carries the scale already
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = 16 * (e >> 3) + 8 * sub + (e & 7) < N
                   ? (NUM == kV23 ? x[e] : x[e] * scale)
                   : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = expf(x[e] - mx);
        sum += x[e];
      }
      sum += __shfl_xor_sync(~0u, sum, 1);
      float rsum = __frcp_rn(sum);
      const bool pad_i = has_pad && sPad[i];
      const int reg_i = sReg[i];
      mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = 16 * (e >> 3) + 8 * sub + (e & 7);
        float z = div_rn(x[e], sum, rsum);  // a1, rounded in kV4
        if (NUM == kV4) z = bf2f(__float2bfloat16_rn(z));
        if (has_bias) z = z + sBias[i * kBS + j];
        if (has_reg || has_pad) {  // one add of the summed mask
          float m = 0.f;
          if (has_reg && reg_i != sReg[j]) m += -100.f;
          if (pad_i && sPad[j]) m += -100.f;
          z = z + m;
        }
        x[e] = j < N ? z : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      sum = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = expf(x[e] - mx);
        sum += x[e];
      }
      sum += __shfl_xor_sync(~0u, sum, 1);
      rsum = __frcp_rn(sum);
      if (r < nk) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          bf16* row = sA2 + r * kA2 + 16 * m + 8 * sub;
          if constexpr (NUM == kV1) {  // a2 unrounded: hi + lo
            uint4 hi, lo;
            uint32_t* he = reinterpret_cast<uint32_t*>(&hi);
            uint32_t* le = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              split_bf16(div_rn(x[8 * m + 2 * e], sum, rsum),
                         div_rn(x[8 * m + 2 * e + 1], sum, rsum), he[e],
                         le[e]);
            }
            *reinterpret_cast<uint4*>(row) = hi;
            *reinterpret_cast<uint4*>(row + kLS) = lo;
          } else {
            uint4 o;
            bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              oe[e] = __float2bfloat16_rn(div_rn(x[8 * m + e], sum, rsum));
            }
            *reinterpret_cast<uint4*>(row) = o;
          }
        }
      }
    }
    __syncwarp();
    // phase: chain

    // PV on the tensor cores for the packed kept rows (kV1: hi and lo
    // halves into one float32 sum); each row r < nk goes to row sIdx[r] of
    // the staging tile (the k tile). Rows nk ... of the last m16 tile
    // compute garbage that is never stored.
    bf16* sO = sK;
    const int KS = N16 >> 4;
    for (int mt = 0; mt * 16 < nk; ++mt) {
      float acc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      }
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* arow =
            sA2 + (mt * 16 + (lane & 15)) * kA2 + kk * 16 + (lane >> 4) * 8;
        uint32_t a[4], alo[4];
        ldsm_x4(smem_addr(arow), a);
        if constexpr (NUM == kV1) ldsm_x4(smem_addr(arow + kLS), alo);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t b[4];
          ldsm_x4_t(smem_addr(sV + (kk * 16 + (lane & 15)) * LD + n * 16 +
                              (lane >> 4) * 8),
                    b);
          mma_bf16(acc[2 * n], a, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
          if constexpr (NUM == kV1) {
            mma_bf16(acc[2 * n], alo, b[0], b[1]);
            mma_bf16(acc[2 * n + 1], alo, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = mt * 16 + g + 8 * hh;
        if (r < nk) {
          const int i = sIdx[r];
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(sO + i * LD + n * 8 + 2 * t) =
                __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
          }
        }
      }
    }
    // mean(V), summed in token order as the CUDA-core kernel does
    for (int d = lane; d < D; d += 32) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s += bf2f(sV[j * LD + d]);
      sMean[d] = __float2bfloat16_rn(s / static_cast<float>(N));
    }
    __syncwarp();
    // phase: PV+mean

    // store: 16 bytes at a time, the staged row if kept, else mean(V).
    for (int e = lane; e < N * (D / 8); e += 32) {
      const int i = e / (D / 8), c = (e % (D / 8)) * 8;
      const uint4 val =
          kept_row(keep_lo, keep_hi, i)
              ? *reinterpret_cast<const uint4*>(sO + i * LD + c)
              : *reinterpret_cast<const uint4*>(sMean + c);
      *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(i) * rs +
                                c) = val;
    }
    __syncwarp();  // the tiles are free for the next window-head
    // phase: store
  }
}

// ---- backward -----------------------------------------------------------

template <int D, bool FULL, int NUM>
__global__ void __launch_bounds__(BwdCfg<D, NUM>::kThreads, 1)
    window_attention_tc_bwd_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ go,
        const int32_t* __restrict__ cnt, const float* __restrict__ bias,
        const int32_t* __restrict__ region, const int32_t* __restrict__ pad,
        bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
        float* __restrict__ db_part, int B, int n_tokens, int C, int nW,
        int u, float scale) {
  using L = BwdCfg<D, NUM>;
  using ST = typename L::ST;
  constexpr int LD = L::LD, kP = L::kPairs;
  // dq rows are staged as bf16 in the S tile's rows: kDqS bf16 apart
  constexpr int kDqS = kLS * static_cast<int>(sizeof(ST)) / 2;
  const int N = FULL ? kMaxN : n_tokens;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sBias = reinterpret_cast<float*>(smem);        // [64][kBS] bias[h]
  unsigned char* sCnt = smem + kMaxN * kBS * 4;          // [64][kCS] counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warps 2p and 2p + 1 share window-head tiles: half (= 0 or 1) is this
  // warp's side of the pair, pl its thread index in the pair
  const int pair = warp >> 1, half = warp & 1, pl = threadIdx.x & 63;
  auto pair_sync = [&]() {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
  };
  unsigned char* ws = smem + kShared + pair * L::kPairBytes;
  bf16* sK = reinterpret_cast<bf16*>(ws);    // [64][LD]: k, then dk
  bf16* sV = sK + kMaxN * LD;                // [64][LD]: v, then dv
  bf16* sQ = sV + kMaxN * LD;                // [64][LD]
  bf16* sG = sQ + kMaxN * LD;                // [64][LD]: the output grad
  ST* sS = reinterpret_cast<ST*>(sG + kMaxN * LD);  // [64][kLS]: S (kV23:
                                                    // then a1 of kept rows)
  bf16* sDq = reinterpret_cast<bf16*>(sS);   // then dq rows, kDqS apart
  bf16* sA2h = reinterpret_cast<bf16*>(sS + kMaxN * kLS);  // [32][kLS] by
                                                           // kept slot
  bf16* sA2l = sA2h + kMaxKept * kLS;
  bf16* sDsh = sA2l + kMaxKept * kLS;
  bf16* sDsl = sDsh + kMaxKept * kLS;
  float* sM = reinterpret_cast<float*>(sDsl + kMaxKept * kLS);  // [64]
  int* sReg = reinterpret_cast<int*>(sM + kMaxN);               // [64]
  int* sPad = sReg + kMaxN;                                     // [64]
  float* sGu = reinterpret_cast<float*>(sPad + kMaxN);  // [64] g_unsel / N
  bf16* sZero = reinterpret_cast<bf16*>(sGu + kMaxN);   // [kLS] zeros
  unsigned char* sIdx = reinterpret_cast<unsigned char*>(sZero + kLS);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sIdx + kMaxN);  // [2]
  const int h = blockIdx.y;
  const bool has_bias = bias != nullptr, has_reg = region != nullptr,
             has_pad = pad != nullptr;
  const float qsc = bf2f(__float2bfloat16_rn(scale));  // kV23's q scale

  stage_bias_counts<L::kThreads>(sBias, sCnt, cnt, bias, h, N);
  for (int e = pl; e < kLS; e += 64) sZero[e] = __float2bfloat16_rn(0.f);
  // This pair's dbias partial [N, N]: slot blockIdx.x * kP + pair of head
  // h, zeroed here, then summed into window after window; within a window
  // the two warps add disjoint rows, and the pair's barriers order the
  // windows.
  const int slot = blockIdx.x * kP + pair;
  float* part = db_part == nullptr
                    ? nullptr
                    : db_part + (static_cast<size_t>(slot) * gridDim.y + h) *
                                    N * N;
  if (part != nullptr) {
    for (int e = pl; e < N * N; e += 64) __stcg(part + e, 0.f);
  }
  __syncthreads();
  // phase: stage

  const int g = lane >> 2, t = lane & 3;
  const int N16 = (N + 15) & ~15;
  for (int w = slot; w < B; w += gridDim.x * kP) {
    const size_t base =
        static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;

    // load: k, v, q and g by cp.async (rows N ... N16 zero), this window's
    // masks, this warp's first q block into registers for QK^T.
    cp_tile<D, LD>(sK, k + base, N, N16, C, pl, 64);
    cp_tile<D, LD>(sV, v + base, N, N16, C, pl, 64);
    cp_tile<D, LD>(sQ, q + base, N, N16, C, pl, 64);
    cp_tile<D, LD>(sG, go + base, N, N16, C, pl, 64);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    load_masks(sReg, sPad, region, pad, static_cast<size_t>(w % nW) * N, N,
               pl, 64);
    QRows<D> qr;
    qr.load(q + base, C, N, 16 * half, g, t);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // kV23: dk takes q * scale, rounded, as QK^T does
    if constexpr (NUM == kV23) scale_tile<D, LD>(sQ, N, qsc, pl, 64);
    pair_sync();
    // phase: load

    // the pair's warps take the m16 blocks of S in turn
    qk_measure<D, FULL, 32, NUM>(qr, q + base, C, sK, sS, sM, sCnt, N,
                                 16 * half, lane, qsc);
    pair_sync();
    // phase: QK^T+measure

    // each warp ranks its 32 rows; the first lists the kept rows
    const unsigned mine = rank_half<FULL>(sM, N, u, half, lane);
    if (lane == 0) sKeep[half] = mine;
    pair_sync();
    const unsigned keep_lo = sKeep[0], keep_hi = sKeep[1];
    const int n_lo = __popc(keep_lo), nk = n_lo + __popc(keep_hi);
    if (half == 0) {
      const unsigned below = (1u << lane) - 1u;
      if ((keep_lo >> lane) & 1u) sIdx[__popc(keep_lo & below)] = lane;
      if ((keep_hi >> lane) & 1u) {
        sIdx[n_lo + __popc(keep_hi & below)] = lane + 32;
      }
    }
    // sum of g over the unselected rows, in token order, / N
    for (int d = pl; d < D; d += 64) {
      float s = 0.f;
      for (int i = 0; i < N; ++i) {
        if (!kept_row(keep_lo, keep_hi, i)) s += bf2f(sG[i * LD + d]);
      }
      sGu[d] = s / static_cast<float>(N);
    }
    // a kept slot's g row (the zero row past nk), as ldmatrix reads it
    auto sel_row = [&](const bf16* tile, int r) -> const bf16* {
      return r < nk ? tile + sIdx[r] * LD : sZero;
    };
    pair_sync();
    // phase: rank

    // the pair's warps take the m16 tiles of kept slots in turn
    const int KT = (nk + 15) >> 4;
    for (int mt = half; mt < KT; mt += 2) {
      // chain on kept slots mt*16 + g and mt*16 + g + 8 (token rows ri[b];
      // row 0 stands in past nk: finite values, never stored), columns
      // nt*8 + 2t, nt*8 + 2t + 1 in x[nt][2b], x[nt][2b + 1]: the mma
      // accumulator layout.
      int ri[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = mt * 16 + g + 8 * b;
        ri[b] = r < nk ? sIdx[r] : 0;
      }
      // this tile's dbias partial rows, loaded now: the L2 round trip
      // hides behind the chain and da2 (zero for slots past nk)
      float pold[2][8][2];
      if (part != nullptr) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const bool ok = mt * 16 + g + 8 * b < nk;
          const float* prow = part + ri[b] * N;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c = nt * 8 + 2 * t;
            if (FULL) {
              const float2 o =
                  ok ? __ldcg(reinterpret_cast<const float2*>(prow + c))
                     : make_float2(0.f, 0.f);
              pold[b][nt][0] = o.x;
              pold[b][nt][1] = o.y;
            } else {
              pold[b][nt][0] = ok && c < N ? __ldcg(prow + c) : 0.f;
              pold[b][nt][1] = ok && c + 1 < N ? __ldcg(prow + c + 1) : 0.f;
            }
          }
        }
      }
      float x[8][4];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * t;
          float2 s;
          if constexpr (NUM == kV23) {
            s = *reinterpret_cast<const float2*>(sS + ri[b] * kLS + c);
          } else {
            s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                sS + ri[b] * kLS + c));
          }
          // branch-free: columns past N enter as -inf, so exp gives 0;
          // kV23's S carries the scale already
          const float sc = NUM == kV23 ? 1.f : scale;
          x[nt][2 * b] = FULL || c < N ? s.x * sc : -INFINITY;
          x[nt][2 * b + 1] = FULL || c + 1 < N ? s.y * sc : -INFINITY;
        }
      }
      // a1: kV4 rounded to bf16 (exact), packed in registers; kV23 a float,
      // written over the kept row's S (slots past nk write nothing)
      uint32_t a1p[8][2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mx = fmaxf(mx, fmaxf(x[nt][2 * b], x[nt][2 * b + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[nt][2 * b + e] = expf(x[nt][2 * b + e] - mx);
            sum += x[nt][2 * b + e];
          }
        }
        sum += __shfl_xor_sync(~0u, sum, 1);
        sum += __shfl_xor_sync(~0u, sum, 2);
        float rsum = __frcp_rn(sum);
        const int i = ri[b];
        const bool pad_i = has_pad && sPad[i];
        const int reg_i = sReg[i];
        mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float a1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = nt * 8 + 2 * t + e;
            a1[e] = div_rn(x[nt][2 * b + e], sum, rsum);
            if (NUM == kV4) a1[e] = bf2f(__float2bfloat16_rn(a1[e]));
            float z = a1[e];
            if (has_bias) z = z + sBias[i * kBS + j];
            if (has_reg || has_pad) {  // one add of the summed mask
              float m = 0.f;
              if (has_reg && reg_i != sReg[j]) m += -100.f;
              if (pad_i && sPad[j]) m += -100.f;
              z = z + m;
            }
            x[nt][2 * b + e] = FULL || j < N ? z : -INFINITY;
            mx = fmaxf(mx, x[nt][2 * b + e]);
          }
          if constexpr (NUM == kV23) {
            if (mt * 16 + g + 8 * b < nk) {
              *reinterpret_cast<float2*>(sS + i * kLS + nt * 8 + 2 * t) =
                  make_float2(a1[0], a1[1]);
            }
          } else {
            a1p[nt][b] = pack_bf16(a1[0], a1[1]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
        sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[nt][2 * b + e] = expf(x[nt][2 * b + e] - mx);
            sum += x[nt][2 * b + e];
          }
        }
        sum += __shfl_xor_sync(~0u, sum, 1);
        sum += __shfl_xor_sync(~0u, sum, 2);
        // a2, unrounded: the backward needs it to about float's precision,
        // not correctly rounded (a1's rounding above must match the twin's)
        rsum = __frcp_rn(sum);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          x[nt][2 * b] *= rsum;
          x[nt][2 * b + 1] *= rsum;
        }
      }
      // phase: chain

      // da2 = g_sel V^T: A rows are kept slots (g rows by ldmatrix row
      // address), B = V as [n = token][k = d] rows.
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(smem_addr(sel_row(sG, mt * 16 + (lane & 15)) + kk * 16 +
                          (lane >> 4) * 8),
                a);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (FULL || np * 16 < N) {
            uint32_t bv[4];
            ldsm_x4(smem_addr(sV + (np * 16 + (lane & 7) +
                                    ((lane >> 4) << 3)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8),
                    bv);
            mma_bf16(acc[2 * np], a, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], a, bv[2], bv[3]);
          }
        }
      }
      // phase: da2

      // dz = a2 (da2 - rowsum(da2 a2)), into the dbias partial; then
      // ds = a1 (dz - rowsum(dz a1)). Slots past nk have da2 = 0 (zero g
      // rows), so dz = ds = 0 there.
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float dot = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          dot = fmaf(acc[nt][2 * b], x[nt][2 * b], dot);
          dot = fmaf(acc[nt][2 * b + 1], x[nt][2 * b + 1], dot);
        }
        dot += __shfl_xor_sync(~0u, dot, 1);
        dot += __shfl_xor_sync(~0u, dot, 2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][2 * b] = x[nt][2 * b] * (acc[nt][2 * b] - dot);
          acc[nt][2 * b + 1] = x[nt][2 * b + 1] * (acc[nt][2 * b + 1] - dot);
        }
        if (part != nullptr && mt * 16 + g + 8 * b < nk) {
          float* prow = part + ri[b] * N;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c = nt * 8 + 2 * t;
            const float p0 = pold[b][nt][0] + acc[nt][2 * b];
            const float p1 = pold[b][nt][1] + acc[nt][2 * b + 1];
            if (FULL) {
              __stcg(reinterpret_cast<float2*>(prow + c), make_float2(p0, p1));
            } else {
              if (c < N) __stcg(prow + c, p0);
              if (c + 1 < N) __stcg(prow + c + 1, p1);
            }
          }
        }
        // a1 of column pair nt. kV23 reads it from the kept row's S row;
        // a slot past nk takes 0 (its stand-in row 0 may not be kept, and
        // at N < 64 its columns past the last 8-column tile of S were never
        // written: 0 * NaN in the row dot would reach every column of ds)
        const bool real = mt * 16 + g + 8 * b < nk;
        auto a1_of = [&](int nt) -> float2 {
          if constexpr (NUM == kV23) {
            return real ? *reinterpret_cast<const float2*>(
                              sS + ri[b] * kLS + nt * 8 + 2 * t)
                        : make_float2(0.f, 0.f);
          } else {
            return __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&a1p[nt][b]));
          }
        };
        dot = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 a1 = a1_of(nt);
          dot = fmaf(acc[nt][2 * b], a1.x, dot);
          dot = fmaf(acc[nt][2 * b + 1], a1.y, dot);
        }
        dot += __shfl_xor_sync(~0u, dot, 1);
        dot += __shfl_xor_sync(~0u, dot, 2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 a1 = a1_of(nt);
          acc[nt][2 * b] = a1.x * (acc[nt][2 * b] - dot);
          acc[nt][2 * b + 1] = a1.y * (acc[nt][2 * b + 1] - dot);
        }
      }
      // phase: dz+dbias+ds

      // stage a2 and ds of these slots as bf16 hi + lo, by slot row
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = mt * 16 + g + 8 * b;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int o = r * kLS + nt * 8 + 2 * t;
          uint32_t hi, lo;
          split_bf16(x[nt][2 * b], x[nt][2 * b + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sA2h + o) = hi;
          *reinterpret_cast<uint32_t*>(sA2l + o) = lo;
          split_bf16(acc[nt][2 * b], acc[nt][2 * b + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sDsh + o) = hi;
          *reinterpret_cast<uint32_t*>(sDsl + o) = lo;
        }
      }
      // dq = scale * ds K: the ds accumulators are the A fragments (tiles
      // 2kk and 2kk + 1 form k-block kk), split hi + lo; B = K by
      // ldmatrix.trans.
      float dacc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        dacc[n][0] = dacc[n][1] = dacc[n][2] = dacc[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (FULL || kk * 16 < N) {
          uint32_t ah[4], al[4];
          split_bf16(acc[2 * kk][0], acc[2 * kk][1], ah[0], al[0]);
          split_bf16(acc[2 * kk][2], acc[2 * kk][3], ah[1], al[1]);
          split_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1], ah[2], al[2]);
          split_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            uint32_t bk[4];
            ldsm_x4_t(smem_addr(sK + (kk * 16 + (lane & 15)) * LD + n * 16 +
                                (lane >> 4) * 8),
                      bk);
            mma_bf16(dacc[2 * n], ah, bk[0], bk[1]);
            mma_bf16(dacc[2 * n], al, bk[0], bk[1]);
            mma_bf16(dacc[2 * n + 1], ah, bk[2], bk[3]);
            mma_bf16(dacc[2 * n + 1], al, bk[2], bk[3]);
          }
        }
      }
      __syncwarp();  // every lane has read its S rows
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (mt * 16 + g + 8 * b < nk) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(sDq + ri[b] * kDqS + n * 8 +
                                               2 * t) =
                __floats2bfloat162_rn(dacc[n][2 * b] * scale,
                                      dacc[n][2 * b + 1] * scale);
          }
        }
      }
      // phase: dq
    }
    pair_sync();

    // dv = a2^T g_sel + sum(g_unsel) / N and dk = scale * ds^T q_sel, 16
    // token rows j at a time, side by side (two independent sums): A = the
    // staged [slot][j] tiles by ldmatrix.trans, B = the kept slots' g / q
    // rows by ldmatrix.trans. Written into the v and k tiles, which no
    // product needs any more.
    const int JT = N16 >> 4;
    // kV23's q tile holds q * scale (rounded) already
    const float dk_scale = NUM == kV23 ? 1.f : scale;
    for (int J = half; J < JT; J += 2) {
      float vacc[D / 8][4], kacc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) vacc[n][e] = kacc[n][e] = 0.f;
      }
      for (int kk = 0; kk < KT; ++kk) {
        const int o = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLS +
                      J * 16 + ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4], dh[4], dl[4];
        ldsm_x4_t(smem_addr(sA2h + o), ah);
        ldsm_x4_t(smem_addr(sA2l + o), al);
        ldsm_x4_t(smem_addr(sDsh + o), dh);
        ldsm_x4_t(smem_addr(sDsl + o), dl);
        const bf16* grow = sel_row(sG, kk * 16 + (lane & 15));
        const bf16* qrow = sel_row(sQ, kk * 16 + (lane & 15));
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t bg[4], bq[4];
          ldsm_x4_t(smem_addr(grow + n * 16 + (lane >> 4) * 8), bg);
          ldsm_x4_t(smem_addr(qrow + n * 16 + (lane >> 4) * 8), bq);
          mma_bf16(vacc[2 * n], ah, bg[0], bg[1]);
          mma_bf16(kacc[2 * n], dh, bq[0], bq[1]);
          mma_bf16(vacc[2 * n + 1], ah, bg[2], bg[3]);
          mma_bf16(kacc[2 * n + 1], dh, bq[2], bq[3]);
          mma_bf16(vacc[2 * n], al, bg[0], bg[1]);
          mma_bf16(kacc[2 * n], dl, bq[0], bq[1]);
          mma_bf16(vacc[2 * n + 1], al, bg[2], bg[3]);
          mma_bf16(kacc[2 * n + 1], dl, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = J * 16 + g + 8 * hh;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int c = n * 8 + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(sV + j * LD + c) =
              __floats2bfloat162_rn(vacc[n][2 * hh] + sGu[c],
                                    vacc[n][2 * hh + 1] + sGu[c + 1]);
          *reinterpret_cast<__nv_bfloat162*>(sK + j * LD + c) =
              __floats2bfloat162_rn(kacc[n][2 * hh] * dk_scale,
                                    kacc[n][2 * hh + 1] * dk_scale);
        }
      }
    }
    pair_sync();
    // phase: dv+dk

    // store: 16 bytes at a time; dq is zero on the unselected rows.
    for (int e = pl; e < N * (D / 8); e += 64) {
      const int i = e / (D / 8), c = (e % (D / 8)) * 8;
      const size_t o = base + static_cast<size_t>(i) * C + c;
      *reinterpret_cast<uint4*>(dq + o) =
          kept_row(keep_lo, keep_hi, i)
              ? *reinterpret_cast<const uint4*>(sDq + i * kDqS + c)
              : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dk + o) =
          *reinterpret_cast<const uint4*>(sK + i * LD + c);
      *reinterpret_cast<uint4*>(dv + o) =
          *reinterpret_cast<const uint4*>(sV + i * LD + c);
    }
    pair_sync();  // the tiles are free for the next window-head
    // phase: store
  }
}

// dbias[e] = sum over slots s (in order) of part[s][e], e over H * N * N.
__global__ void __launch_bounds__(256) dbias_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dbias, int n_slots,
    int n) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_slots; ++b) s += part[static_cast<size_t>(b) * n + e];
  dbias[e] = s;
}

// ---- launches -----------------------------------------------------------

// One wave of CTAs at most: min(groups of window-heads, CTAs the card holds
// at once / H) along x, H along y.
int wave_ctas(const void* kernel, int threads, int smem, int B, int per_cta,
              int H, int* grid_x) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (B + per_cta - 1) / per_cta;
  const int wave = (max(per_sm, 1) * sms + H - 1) / H;
  *grid_x = max(1, min(groups, wave));
  return 0;
}

template <int D, bool FULL, int NUM, bool HM>
int launch_n(const void* q, const void* k, const void* v, const int32_t* cnt,
             const float* bias, const int32_t* region, const int32_t* pad,
             void* out, int B, int N, int C, int H, int nW, int u,
             float scale, cudaStream_t stream) {
  using L = Cfg<D, NUM>;
  auto kernel = window_attention_tc_kernel<D, FULL, NUM, HM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int gx = 0;
  const int err = wave_ctas(reinterpret_cast<const void*>(kernel),
                            L::kThreads, L::kSmem, B, L::kWarps, H, &gx);
  if (err != 0) return err;
  kernel<<<dim3(gx, H), L::kThreads, L::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), cnt, bias, region, pad,
      static_cast<bf16*>(out), B, N, C, nW, u, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NUM, bool HM>
int launch(const void* q, const void* k, const void* v, const int32_t* cnt,
           const float* bias, const int32_t* region, const int32_t* pad,
           void* out, int B, int N, int C, int H, int nW, int u, float scale,
           cudaStream_t stream) {
  return N == kMaxN
             ? launch_n<D, true, NUM, HM>(q, k, v, cnt, bias, region, pad,
                                          out, B, N, C, H, nW, u, scale,
                                          stream)
             : launch_n<D, false, NUM, HM>(q, k, v, cnt, bias, region, pad,
                                           out, B, N, C, H, nW, u, scale,
                                           stream);
}

struct BwdArgs {
  const void *q, *k, *v, *g;
  const int32_t* cnt;
  const float* bias;
  const int32_t *region, *pad;
  void *dq, *dk, *dv;
  float *db_part, *dbias;
  int B, N, C, H, nW, u;
  float scale;
  int n_slots;
};

template <int D, bool FULL, int NUM>
int bwd_grid(int B, int H, int* grid_x) {
  using L = BwdCfg<D, NUM>;
  auto kernel = window_attention_tc_bwd_kernel<D, FULL, NUM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return wave_ctas(reinterpret_cast<const void*>(kernel), L::kThreads,
                   L::kSmem, B, L::kPairs, H, grid_x);
}

template <int D, bool FULL, int NUM>
int launch_bwd_n(const BwdArgs& a, cudaStream_t stream) {
  using L = BwdCfg<D, NUM>;
  int gx = 0;
  int err = bwd_grid<D, FULL, NUM>(a.B, a.H, &gx);
  if (err != 0) return err;
  if (a.bias != nullptr && gx * L::kPairs > a.n_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_attention_tc_bwd_kernel<D, FULL, NUM>
      <<<dim3(gx, a.H), L::kThreads, L::kSmem, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
          a.cnt, a.bias, a.region, a.pad, static_cast<bf16*>(a.dq),
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
          a.bias != nullptr ? a.db_part : nullptr, a.B, a.N, a.C, a.nW, a.u,
          a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.bias == nullptr) return err;
  const int n = a.H * a.N * a.N;
  dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      a.db_part, a.dbias, gx * L::kPairs, n);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NUM>
int launch_bwd(const BwdArgs& a, cudaStream_t s) {
  return a.N == kMaxN ? launch_bwd_n<D, true, NUM>(a, s)
                      : launch_bwd_n<D, false, NUM>(a, s);
}

template <int D, int NUM>
int slots_of(int B, int N, int H) {
  int gx = 0;
  const int err = N == kMaxN ? bwd_grid<D, true, NUM>(B, H, &gx)
                             : bwd_grid<D, false, NUM>(B, H, &gx);
  return err != 0 ? -err : gx * BwdCfg<D, NUM>::kPairs;
}

// The numerics and layouts the kernels take: K1 (kV4) token-major, K3-v3
// (kV23) token-major and K3-v2 (kV23) head-major, K3-v1 (kV1) head-major;
// the backward token-major kV4 and kV23 only.
bool takes(int N, int C, int H, int B, int nW, int numerics, int head_major) {
  const bool layout = head_major ? (numerics == kV1 || numerics == kV23)
                                 : (numerics == kV4 || numerics == kV23);
  return H >= 1 && C % H == 0 && N >= 1 && N <= kMaxN && B >= 1 &&
         nW >= 1 && layout;
}

// f(integral_constant<D>, integral_constant<NUM>) for the head dim C / H
// and the numerics (kV1 only where V1, the forward), or an invalid-value
// error for any other.
template <bool V1, typename F>
int by_shape(int C, int H, int numerics, F f) {
  auto d = [&](auto num) {
    switch (C / H) {
      case 16: return f(std::integral_constant<int, 16>{}, num);
      case 32: return f(std::integral_constant<int, 32>{}, num);
      case 48: return f(std::integral_constant<int, 48>{}, num);
      case 64: return f(std::integral_constant<int, 64>{}, num);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if constexpr (V1) {
    if (numerics == kV1) return d(std::integral_constant<int, kV1>{});
  }
  return numerics == kV23 ? d(std::integral_constant<int, kV23>{})
                          : d(std::integral_constant<int, kV4>{});
}

}  // namespace

extern "C" {

// bf16 q/k/v/out contiguous and 16-byte aligned: token-major [B * N, C],
// heads as channel slices of D = C / H, or (head_major) [B, H, N, D]; D in
// {16, 32, 48, 64}; 1 <= N <= 64. cnt: [N, N] int32; bias: [H, N, N]
// float32 or null; region and pad: [nW, N] int32 or null; numerics: 0 (kV4,
// K1, token-major), 1 (kV1, K3-v1, head-major) or 2 (kV23: K3-v3
// token-major, K3-v2 head-major). Returns cudaGetLastError() after the
// launch, or an error code for a shape the kernel does not take.
int window_attention_tc_fwd(const void* q, const void* k, const void* v,
                            const int32_t* cnt, const float* bias,
                            const int32_t* region, const int32_t* pad,
                            void* out, int B, int N, int C, int H, int nW,
                            int u, float scale, int numerics, int head_major,
                            void* stream) {
  if (!takes(N, C, H, B, nW, numerics, head_major)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape<true>(C, H, numerics, [&](auto d, auto num) {
    constexpr int kD = decltype(d)::value, kNum = decltype(num)::value;
    // only the layouts `takes` lets through are compiled
    if constexpr (kNum == kV4) {
      return launch<kD, kNum, false>(q, k, v, cnt, bias, region, pad, out, B,
                                     N, C, H, nW, u, scale, s);
    } else if constexpr (kNum == kV1) {
      return launch<kD, kNum, true>(q, k, v, cnt, bias, region, pad, out, B,
                                    N, C, H, nW, u, scale, s);
    } else {
      return head_major
                 ? launch<kD, kNum, true>(q, k, v, cnt, bias, region, pad,
                                          out, B, N, C, H, nW, u, scale, s)
                 : launch<kD, kNum, false>(q, k, v, cnt, bias, region, pad,
                                           out, B, N, C, H, nW, u, scale, s);
    }
  });
}

// The dbias partial slots of one head that window_attention_tc_bwd fills
// for these shapes and numerics (> 0), or minus a CUDA error code.
int window_attention_tc_bwd_slots(int B, int N, int C, int H, int numerics) {
  if (!takes(N, C, H, B, 1, numerics, 0)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return by_shape<false>(C, H, numerics, [&](auto d, auto num) {
    return slots_of<decltype(d)::value, decltype(num)::value>(B, N, H);
  });
}

// Backward of window_attention_tc_fwd for the output gradient g: q/k/v/g
// and dq/dk/dv bf16 [B * N, C] as there; u <= 32 kept rows. With a bias,
// db_part is float32 scratch [n_slots, H, N, N] (n_slots from
// window_attention_tc_bwd_slots) and dbias the float32 output [H, N, N];
// both are ignored without one. Returns cudaGetLastError() after the last
// launch, or an error code for a shape the kernel does not take.
int window_attention_tc_bwd(const void* q, const void* k, const void* v,
                            const void* g, const int32_t* cnt,
                            const float* bias, const int32_t* region,
                            const int32_t* pad, void* dq, void* dk, void* dv,
                            float* db_part, float* dbias, int B, int N, int C,
                            int H, int nW, int u, float scale, int n_slots,
                            int numerics, void* stream) {
  if (!takes(N, C, H, B, nW, numerics, 0) || u < 1 || u > kMaxKept) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const BwdArgs a{q, k, v, g, cnt, bias, region, pad, dq, dk, dv, db_part,
                  dbias, B, N, C, H, nW, u, scale, n_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape<false>(C, H, numerics, [&](auto d, auto num) {
    return launch_bwd<decltype(d)::value, decltype(num)::value>(a, s);
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
