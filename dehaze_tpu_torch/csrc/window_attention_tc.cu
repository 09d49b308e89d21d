// K1 forward on Hopper's tensor cores (sm_90a): ProbSparse window
// attention for bf16 activations, N <= 64 tokens per window, head dim D in
// {16, 32, 48, 64}.
//
// Replaces the TPU kernel `_kernel_v4` / `_fused_attn_v4_fwd` of
// dehaze_tpu/ops/pallas/window_attention.py (`fused_window_attention`,
// version 4) for those shapes; `window_attention_fwd_kernel<bf16, kV4>` of
// csrc/window_attention.cu computes the same function on the CUDA cores and
// takes everything else (float32, K3's numerics, N > 64, other head dims).
// Same function as the plain twin
// `dehaze_tpu_torch.ops.probsparse.probsparse_attention_bnc`, per window and
// head:
//   S = Q K^T, rounded to bf16 -> M = max over the sampled columns -
//   sum(cnt * S) / N -> the top u rows by rank (M descending, index
//   ascending) -> a1 = softmax(S * scale), rounded -> z = (a1 + bias[h]) +
//   mask (one add of the summed -100 / -200) -> a2 = softmax(z), rounded ->
//   kept rows a2 @ V, the others mean(V).
// q/k/v/out are token-major [B_ * N, C] with heads as channel slices; region
// ids and pad flags are [nW, N], indexed by window % nW.
//
// What bounds it. Per window-head it moves 4 * N * D bf16 (q, k, v in, out
// out: 16 KB at N = 64, D = 32) and does N * N * D multiply-adds for QK^T
// in float64 plus u * N * D for PV in bf16. HBM is the bound of the work
// (0.165 ms for the 33,280 window-heads of the serving frame's first
// stage); QK^T on the FP64 tensor cores (67 TFLOP/s) is of the same order
// (0.14 ms there), and the row statistics, 2 * u * N accurate expf per
// window-head, come next.
//
// Design. A CTA holds kWarps warps of one head h, so the count matrix and
// bias[h] are staged in shared memory once per CTA; there is one wave of
// CTAs, and each warp walks its window-heads one after another, on its own:
//   load   k and v of the window-head by 16-byte cp.async into bf16 shared
//          tiles (rows past N zero-filled); q goes straight from global
//          memory into registers, one m16 block ahead of its use;
//   QK^T   mma.sync m16n8k16 in float64 (Hopper's shape, one
//          instruction for eight of m8n8k4), the bf16 operands widened on
//          the way in, 16 rows x N columns at a time (32 double accumulators per
//          lane); the head dim is walked in a permuted order (lane quad t
//          takes the contiguous columns t*D/4 ... t*D/4 + D/4 - 1), so
//          every fragment is one contiguous load. S is rounded to float
//          and then to bf16 into shared memory right after each block, and
//          the measure (max and float64 sum(cnt * S) over a row) is taken
//          from the rounded values in registers, reduced over the lane quad
//          that holds the row;
//   rank   a lane per row compares its M with all N; the kept rows are
//          compacted into a list by ballot (exactly u of them);
//   chain  only the u kept rows, two lanes per row (32 columns each, in
//          registers), sixteen rows at a time: both softmaxes with accurate
//          expf, bias and mask from shared memory; a2, rounded to bf16, is
//          written packed into row r of the S tile for the r-th kept row;
//   PV     mma.sync m16n8k16 (bf16 in, float32 sum) on the packed rows
//          (ceil(u / 16) m16 tiles), operands by ldmatrix; rows staged in
//          the k tile, which QK^T no longer needs;
//   mean   one column sum of V per window-head;
//   store  16-byte stores of each row: the staged row if kept, else mean.
// Unselected rows (39 of 64 at N = 64) never run a softmax. N = 64 is
// compiled as a constant (FULL); other N run the same code with a runtime
// N and branch-free masks past it.
//
// Exactness of the selection. The rows kept depend discontinuously on S,
// so S and M must come out bit-identical to the twin's (and to the
// backward's, which recomputes them with the scalar `scores` / `row_chain`
// of csrc/window_attention.cu). A product of two bf16 values has a 16-bit
// significand and is exact in float64; the sum of D such products is exact
// in float64 whenever their exponents span fewer than about 32 binades, and
// an exact sum is the same double in any order: the FP64 tensor cores here,
// the scalar fma chain of the CUDA-core kernels and the twin's float64
// matmul all give it, and all round it once to float and once to bf16.
// sum(cnt * S) over bf16 values and small integer counts is exact in
// float64 as well, so the lane-split sum is order-free; the max is. The
// rank is a pure comparison. The softmax sums are float32 and run in
// another order than the twin's; that moves a1 and a2 by about an ulp and
// never the selection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;               // window-heads per CTA, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 64;
constexpr int kLS = kMaxN + 8;          // row stride of the S / a2 tile
// Row strides of the staged bias (floats) and counts (bytes), padded so
// that rows read side by side fall in different banks.
constexpr int kBS = kMaxN + 1;
constexpr int kCS = kMaxN + 8;
constexpr int kShared = kMaxN * kBS * 4 + kMaxN * kCS;  // bias + counts
static_assert(kShared % 16 == 0, "16-byte aligned warp slices");

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;      // row stride of the k, v, out tiles
  static constexpr int DQ = D / 4;      // k-steps of the float64 MMA
  static constexpr int kWarpBytes =
      2 * kMaxN * LD * 2 +              // k (then out), v
      kMaxN * kLS * 2 +                 // S, then packed a2
      3 * kMaxN * 4 +                   // M, region ids, pad flags
      kMaxN * 2 + kMaxN;                // mean(V), kept-row list
  static constexpr int kSmem = kShared + kWarps * kWarpBytes;
  static_assert(D % 16 == 0 && D <= 64, "head dim 16, 32, 48 or 64");
  static_assert(kWarpBytes % 16 == 0, "16-byte aligned warp slices");
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

// FULL: N = 64 (8x8 windows, every stage of the default model), a
// compile-time constant, so no loop or select depends on a runtime N.
template <int D, bool FULL>
__global__ void __launch_bounds__(kThreads, 2) window_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int32_t* __restrict__ cnt,
    const float* __restrict__ bias, const int32_t* __restrict__ region,
    const int32_t* __restrict__ pad, bf16* __restrict__ out, int B,
    int n_tokens, int C, int nW, int u, float scale) {
  using L = Cfg<D>;
  const int N = FULL ? kMaxN : n_tokens;
  constexpr int LD = L::LD, DQ = L::DQ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sBias = reinterpret_cast<float*>(smem);        // [64][kBS] bias[h]
  unsigned char* sCnt = smem + kMaxN * kBS * 4;          // [64][kCS] counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ws = smem + kShared + warp * L::kWarpBytes;
  bf16* sK = reinterpret_cast<bf16*>(ws);                // [64][LD]: k, out
  bf16* sV = sK + kMaxN * LD;                            // [64][LD]
  bf16* sS = sV + kMaxN * LD;                            // [64][kLS]
  float* sM = reinterpret_cast<float*>(sS + kMaxN * kLS);  // [64]
  int* sReg = reinterpret_cast<int*>(sM + kMaxN);          // [64]
  int* sPad = sReg + kMaxN;                                // [64]
  bf16* sMean = reinterpret_cast<bf16*>(sPad + kMaxN);     // [64]
  unsigned char* sIdx = reinterpret_cast<unsigned char*>(sMean + kMaxN);
  const int h = blockIdx.y;
  const bool has_bias = bias != nullptr, has_reg = region != nullptr,
             has_pad = pad != nullptr;

  // The count matrix and bias[h], once per CTA (zero past N).
  for (int e = threadIdx.x; e < kMaxN * kMaxN; e += kThreads) {
    const int i = e >> 6, j = e & 63;
    const bool in = i < N && j < N;
    sCnt[i * kCS + j] = in ? static_cast<unsigned char>(cnt[i * N + j]) : 0;
    if (has_bias) {
      sBias[i * kBS + j] =
          in ? bias[(static_cast<size_t>(h) * N + i) * N + j] : 0.f;
    }
  }
  __syncthreads();
  // phase: stage

  const int g = lane >> 2, t = lane & 3;
  const int N16 = (N + 15) & ~15;
  const int NT = (N + 7) >> 3;
  // Each warp walks window-heads w, w + kWarps * gridDim.x, ... of head h
  // on its own; no CTA-wide barrier follows.
  for (int w = blockIdx.x * kWarps + warp; w < B;
       w += gridDim.x * kWarps) {
    const size_t base =
        static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;

    // load: k and v by cp.async (rows N ... N16 zero), this window's masks.
    for (int e = lane; e < N16 * (D / 8); e += 32) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool ok = r < N;
      const size_t o = base + static_cast<size_t>(ok ? r : 0) * C + c;
      cp_async16(smem_addr(sK + r * LD + c), k + o, ok);
      cp_async16(smem_addr(sV + r * LD + c), v + o, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const size_t wn = static_cast<size_t>(w % nW) * N;
    for (int j = lane; j < kMaxN; j += 32) {
      sReg[j] = has_reg && j < N ? region[wn + j] : 0;
      sPad[j] = has_pad && j < N ? pad[wn + j] : 0;
    }
    // q rows m0 + g and m0 + 8 + g, columns t*DQ ... t*DQ + DQ - 1,
    // straight into registers (zero past N)
    uint2 qraw[2][DQ / 4];
    auto load_q = [&](int m0) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = m0 + 8 * b + g;
        const uint2* p = reinterpret_cast<const uint2*>(
            q + base + static_cast<size_t>(r < N ? r : 0) * C + t * DQ);
#pragma unroll
        for (int c = 0; c < DQ / 4; ++c) {
          qraw[b][c] = r < N ? __ldg(p + c) : make_uint2(0u, 0u);
        }
      }
    };
    load_q(0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    // phase: load

    // QK^T in float64 on the tensor cores, 16 rows at a time. S, rounded
    // to float and then bf16, goes to sS; the measure of each row is taken
    // from the rounded values in registers (the lane quad t = 0..3 holds a
    // row's columns; counts past N are zero).
    for (int m0 = 0; m0 < N; m0 += 16) {
      double qa[2][DQ];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int c = 0; c < DQ / 4; ++c) {
          const bf16* e = reinterpret_cast<const bf16*>(&qraw[b][c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[b][4 * c + i] = bf2f(e[i]);
        }
      }
      if (m0 + 16 < N) load_q(m0 + 16);
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
            const __nv_bfloat162 s2 =
                __floats2bfloat162_rn(__double2float_rn(acc[nt][2 * b]),
                                      __double2float_rn(acc[nt][2 * b + 1]));
            *reinterpret_cast<__nv_bfloat162*>(sS + r * kLS + c) = s2;
            const float2 s = __bfloat1622float2(s2);
            const unsigned cc = *reinterpret_cast<const unsigned short*>(
                sCnt + r * kCS + c);
            // count c < 256 as float (exact, without a conversion unit);
            // S * c is exact in float: an 8-bit significand times 8 bits
            const float c0 = __int_as_float(0x4b000000 | (cc & 0xffu)) -
                             8388608.f;
            const float c1 = __int_as_float(0x4b000000 | (cc >> 8)) -
                             8388608.f;
            // branch-free: unsampled columns add 0 and leave the max
            m_max = fmaxf(m_max, fmaxf(c0 > 0.f ? s.x : -1e30f,
                                       c1 > 0.f ? s.y : -1e30f));
            m_sum += static_cast<double>(s.x * c0);
            m_sum += static_cast<double>(s.y * c1);
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
    __syncwarp();
    // phase: QK^T+measure

    // rank: (M descending, index ascending) < u; the kept rows listed in
    // index order.
    bool keep[2];
    {
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
    }
    const unsigned keep_lo = __ballot_sync(~0u, keep[0]);
    const unsigned keep_hi = __ballot_sync(~0u, keep[1]);
    const unsigned below = (1u << lane) - 1u;
    const int n_lo = __popc(keep_lo);
    if (keep[0]) sIdx[__popc(keep_lo & below)] = lane;
    if (keep[1]) sIdx[n_lo + __popc(keep_hi & below)] = lane + 32;
    const int nk = n_lo + __popc(keep_hi);
    __syncwarp();
    // phase: rank

    // chain, kept rows only, two lanes per row (sixteen rows at a time):
    // lane sub = lane & 1 holds columns 16m + 8sub ... 16m + 8sub + 7, m =
    // 0..3, in registers. a2 of the r-th kept row, rounded, goes to row r
    // of sS (zero past N); rows are listed in index order, so row r is
    // never a later pass's input.
    const int slot = lane >> 1, sub = lane & 1;
    for (int r0 = 0; r0 < nk; r0 += 16) {
      const int r = r0 + slot;
      const int i = r < nk ? sIdx[r] : 0;
      float x[32];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 sv = *reinterpret_cast<const uint4*>(
            sS + i * kLS + 16 * m + 8 * sub);
        const bf16* se = reinterpret_cast<const bf16*>(&sv);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[8 * m + e] = bf2f(se[e]);
      }
      __syncwarp();  // this pass's rows are read before any is overwritten
      // branch-free: columns past N enter as -inf, so exp gives them 0
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = 16 * (e >> 3) + 8 * sub + (e & 7) < N ? x[e] * scale
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
        float z = bf2f(__float2bfloat16_rn(div_rn(x[e], sum, rsum)));  // a1
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
          uint4 o;
          bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            oe[e] = __float2bfloat16_rn(div_rn(x[8 * m + e], sum, rsum));
          }
          *reinterpret_cast<uint4*>(sS + r * kLS + 16 * m + 8 * sub) = o;
        }
      }
    }
    __syncwarp();
    // phase: chain

    // PV on the tensor cores for the packed kept rows; each row r < nk
    // goes to row sIdx[r] of the staging tile (the k tile). Rows nk ... of
    // the last m16 tile compute garbage that is never stored.
    bf16* sO = sK;
    const int KS = N16 >> 4;
    for (int mt = 0; mt * 16 < nk; ++mt) {
      float acc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      }
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldsm_x4(smem_addr(sS + (mt * 16 + (lane & 15)) * kLS + kk * 16 +
                          (lane >> 4) * 8),
                a);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          uint32_t b[4];
          ldsm_x4_t(smem_addr(sV + (kk * 16 + (lane & 15)) * LD + n * 16 +
                              (lane >> 4) * 8),
                    b);
          mma_bf16(acc[2 * n], a, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
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
      const bool kept = (i < 32 ? keep_lo >> i : keep_hi >> (i - 32)) & 1u;
      const uint4 val =
          kept ? *reinterpret_cast<const uint4*>(sO + i * LD + c)
               : *reinterpret_cast<const uint4*>(sMean + c);
      *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(i) * C +
                                c) = val;
    }
    __syncwarp();  // the tiles are free for the next window-head
    // phase: store
  }
}

template <int D, bool FULL>
int launch_n(const void* q, const void* k, const void* v, const int32_t* cnt,
             const float* bias, const int32_t* region, const int32_t* pad,
             void* out, int B, int N, int C, int H, int nW, int u,
             float scale, cudaStream_t stream) {
  auto kernel = window_attention_tc_kernel<D, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // One wave of CTAs at most; each warp then walks its window-heads.
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads,
                                                      Cfg<D>::kSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (B + kWarps - 1) / kWarps;
  const int wave = (max(per_sm, 1) * sms + H - 1) / H;
  dim3 grid(max(1, min(groups, wave)), H);
  kernel<<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), cnt, bias, region, pad,
      static_cast<bf16*>(out), B, N, C, nW, u, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int32_t* cnt,
           const float* bias, const int32_t* region, const int32_t* pad,
           void* out, int B, int N, int C, int H, int nW, int u, float scale,
           cudaStream_t stream) {
  return N == kMaxN
             ? launch_n<D, true>(q, k, v, cnt, bias, region, pad, out, B, N,
                                 C, H, nW, u, scale, stream)
             : launch_n<D, false>(q, k, v, cnt, bias, region, pad, out, B, N,
                                  C, H, nW, u, scale, stream);
}

}  // namespace

extern "C" {

// bf16 q/k/v/out [B * N, C] contiguous and 16-byte aligned, heads as channel
// slices of D = C / H in {16, 32, 48, 64}; 1 <= N <= 64. cnt: [N, N] int32;
// bias: [H, N, N] float32 or null; region and pad: [nW, N] int32 or null.
// Returns cudaGetLastError() after the launch, or an error code for a shape
// the kernel does not take.
int window_attention_tc_fwd(const void* q, const void* k, const void* v,
                            const int32_t* cnt, const float* bias,
                            const int32_t* region, const int32_t* pad,
                            void* out, int B, int N, int C, int H, int nW,
                            int u, float scale, void* stream) {
  if (H < 1 || C % H != 0 || N < 1 || N > kMaxN || B < 1 || nW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(q, k, v, cnt, bias, region, pad, out, B, N, C,
                               H, nW, u, scale, s);
    case 32: return launch<32>(q, k, v, cnt, bias, region, pad, out, B, N, C,
                               H, nW, u, scale, s);
    case 48: return launch<48>(q, k, v, cnt, bias, region, pad, out, B, N, C,
                               H, nW, u, scale, s);
    case 64: return launch<64>(q, k, v, cnt, bias, region, pad, out, B, N, C,
                               H, nW, u, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
