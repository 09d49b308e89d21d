// K1 and K3: ProbSparse window attention, forward and backward, for Hopper
// (sm_90a).
//
// Forward: replaces the TPU kernel `_kernel_v4` / `_fused_attn_v4_fwd` of
// dehaze_tpu/ops/pallas/window_attention.py (reached through
// `fused_window_attention`, version 4). Same function as the plain twin
// `dehaze_tpu_torch.ops.probsparse.probsparse_attention_bnc`:
//   S = Q K^T (rounded to the activation type) -> sparsity measure
//   M = max over sampled columns - sum(cnt * S) / N -> top-u rows by rank
//   (value descending, index ascending) -> a1 = softmax(S * scale), rounded
//   -> z = a1 + bias[h] + mask -> a2 = softmax(z)
//   -> kept rows a2 @ V, the others mean(V).
// The mask adds -100 where the SW region ids differ and -100 where both
// tokens are padding (pad flags of any-resolution inputs, the reference's
// m (x) m product mask), so a padded pair across regions gets -200. Region
// ids and pad flags are [nW, N], indexed by window % nW.
//
// Backward: replaces `_kernel_v4_bwd` / `_fused_attn_v4_bwd` (same file).
// Same function as `probsparse_attention_bnc_bwd`: it recomputes the chain
// (the roundings of a1 and a2 pass the gradient straight through), then
//   dv = a2^T g_sel + sum_i g_unsel / N,  da2 = g_sel V^T,
//   dz = a2 * (da2 - rowsum(da2 * a2)),    ds = a1 * (dz - rowsum(dz * a1)),
//   dq = scale * ds K,  dk = scale * ds^T Q,  dbias[h] = sum over windows dz.
// The selection is recomputed with the scalar device functions `scores`,
// `row_chain` and `select_rows` on the same inputs; no row mask is saved
// between the two passes. In bf16 the forward runs on the tensor cores
// (csrc/window_attention_tc.cu: QK^T as mma.sync in float64, sum(cnt * S)
// split over lanes), not through these functions, so the two passes select
// the same rows only because both compute S and M exactly: a sum of bf16
// products, and of bf16 values times small counts, is exact in float64 and
// so the same in any order, and both round it once to float and once to
// bf16 (see that file's note). The float32 forward at the model's shapes
// (N <= 64, head dim 16-64) runs window_attention_f32_fwd_kernel below,
// which takes each S element as the same float64 fma chain over d
// ascending as `scores` and each M by `row_measure`, the function
// `row_chain` runs: its selection is the backward's recomputation bit for
// bit. Other float32 shapes run window_attention_fwd_kernel.
//
// K3, the older TPU kernels of the same chain, are instantiations of the
// same kernels with another `Numerics` (where the chain rounds):
//   kV4  K1 (`_kernel_v4`): S, a1 rounded to T; a2 rounded before PV.
//   kV1  `_kernel` of `probsparse_window_attention_pallas` (:317): nothing
//        rounded, PV in float32. Forward only.
//   kV23 `_kernel_v2` (:220) and `_kernel_v3` / `_kernel_v3_bwd` (:618,
//        :639): q * scale rounded to T at load (the scale rounded to T
//        first); S and a1 not rounded, M on the scaled S, the first softmax
//        without a further scale; a2 rounded before PV. Backward:
//        dq = (ds K) * scale, dk = ds^T (q * scale, rounded).
// v1 and v2 take q/k/v/out head-major, [B, H, N, D] (`head_major`); the
// others token-major. In bf16 at N <= 64 and head dims 16-64 all of them
// run on csrc/window_attention_tc.cu's tensor-core kernels instead (kV1
// there too); these kernels take float32 and the other shapes.
//
// Layout: token-major q/k/v/g/out/dq/dk/dv are [B_ * N, C], heads are
// channel slices of width D = C / H; head-major ones are [B_, H, N, D].
// One CTA per (window, head) in the forward; in the backward one CTA per
// (window group, head) walks its windows one after another. The N x N
// score tiles, the count matrix, both softmaxes, the rank and all products
// stay in shared memory, so HBM traffic is q/k/v (and g) in and the
// outputs out. Where they do not fit in shared memory (N = 256 for 16 x 16
// windows, or a wide head), the same tiles live in a global-memory
// workspace, one slice per CTA, that the wrapper allocates; the forward's
// CTAs then walk their windows as the backward's do, so the workspace is
// sized by the CTAs, not the windows, and the backward keeps its dbias
// partial there too instead of in registers. Rows are strided over the
// threads when N exceeds them.
//
// dbias is a sum over all windows. CTAs run in no order, so each backward
// CTA sums dz over its own windows in registers, in window order, and
// writes one partial [H, N, N] slice; a second kernel sums the partials in
// block order. Both sums have a fixed order, so dbias is the same from run
// to run (no float atomics).
//
// What bounds it: per window-head the forward moves 4*N*D elements and
// does 2*N*N*D multiply-adds twice; the backward moves 7*N*D elements and
// does about 7*N*N*D. Both are bound by instruction throughput on the CUDA
// cores, not by HBM: the products run as scalar FMAs (QK^T in float64),
// and the row statistics run one thread per row. The model's shapes have
// kernels of their own: bf16 forward and backward on the tensor cores
// (csrc/window_attention_tc.cu), the float32 forward register-blocked
// (window_attention_f32_fwd_kernel, below); the float32 backward is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kAcc = kMaxN * kMaxN / kThreads;  // dbias elements per thread
// Shared memory one CTA may use on Hopper; larger tiles go to a workspace.
constexpr size_t kSmemMax = 232448;

// Where the chain rounds to the activation type (see the header).
enum Numerics : int { kV4 = 0, kV1 = 1, kV23 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round x to T's precision and return it as float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Load one (window, head) slice [N, D] of each tensor (rows `rs` elements
// apart) into padded smem rows. With q_scale != 0 the first tensor (q) is
// multiplied by it and rounded to T, as `q * scale` in T does.
template <typename T>
__device__ __forceinline__ void load_tiles(const T* const* src,
                                           float* const* dst, int n_src,
                                           size_t base, int N, int rs, int D,
                                           int ld, float q_scale) {
  for (int e = threadIdx.x; e < N * D; e += kThreads) {
    const int i = e / D, d = e - i * D;
    const size_t g = base + static_cast<size_t>(i) * rs + d;
    for (int t = 0; t < n_src; ++t) {
      float x = to_f(src[t][g]);
      if (t == 0 && q_scale != 0.f) x = round_to<T>(x * q_scale);
      dst[t][i * ld + d] = x;
    }
  }
}

// S = Q K^T: float64 accumulation, one rounding to float (then, in kV4,
// to T).
template <typename T, int NUM>
__device__ __forceinline__ void scores(const float* sQ, const float* sK,
                                       float* sS, int N, int D, int ld,
                                       int ls) {
  for (int e = threadIdx.x; e < N * N; e += kThreads) {
    const int i = e / N, j = e - i * N;
    double acc = 0.0;
    for (int d = 0; d < D; ++d) {
      acc = fma(static_cast<double>(sQ[i * ld + d]),
                static_cast<double>(sK[j * ld + d]), acc);
    }
    const float s = __double2float_rn(acc);
    sS[i * ls + j] = NUM == kV4 ? round_to<T>(s) : s;
  }
}

// Row i: sparsity measure into sM[i]; S row -> a1 (rounded in kV4) into
// a1row and a2 into a2row (a2row may alias the S row). a2 is left
// unrounded; the forward rounds it before PV, the backward uses it as is.
// reg and pad are this window's [N] region ids and pad flags, or null.
// Row i's sparsity measure M from its S row (float, srow[0..N)) and its
// sample counts: max over the sampled columns - sum(cnt * S) / N, the sum
// in float64 over j ascending. The float32 forward's kernel below runs this
// function too, so both passes select the same rows bit for bit.
__device__ __forceinline__ float row_measure(const float* srow,
                                             const unsigned char* cntrow,
                                             int N) {
  float m_max = -1e30f;
  double m_sum = 0.0;
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const int c = cntrow[j];
    if (c > 0) {
      m_max = fmaxf(m_max, srow[j]);
      m_sum += static_cast<double>(srow[j]) * c;
    }
  }
  return m_max - __double2float_rn(m_sum) / static_cast<float>(N);
}

template <typename T, int NUM>
__device__ __forceinline__ void row_chain(const float* srow, float* a1row,
                                          float* a2row, float* sM,
                                          const unsigned char* cntrow,
                                          const float* brow,
                                          const int32_t* reg,
                                          const int32_t* pad, int i, int N,
                                          float scale) {
  sM[i] = row_measure(srow, cntrow, N);

  // kV23's S carries the scale already (q was scaled at load)
  const float sc = NUM == kV23 ? 1.f : scale;
  float mx = -INFINITY;
  for (int j = 0; j < N; ++j) mx = fmaxf(mx, srow[j] * sc);
  float sum = 0.f;
  for (int j = 0; j < N; ++j) {
    const float e = expf(srow[j] * sc - mx);
    a2row[j] = e;
    sum += e;
  }
  const bool pad_i = pad && pad[i];
  mx = -INFINITY;
  for (int j = 0; j < N; ++j) {
    float a1 = a2row[j] / sum;
    if (NUM == kV4) a1 = round_to<T>(a1);
    if (a1row != a2row) a1row[j] = a1;
    float z = a1;
    if (brow) z = z + brow[j];
    if (reg || pad) {  // one add of the summed mask, as the twin does
      float m = 0.f;
      if (reg && reg[i] != reg[j]) m += -100.f;
      if (pad_i && pad[j]) m += -100.f;
      z = z + m;
    }
    a2row[j] = z;
    mx = fmaxf(mx, z);
  }
  sum = 0.f;
  for (int j = 0; j < N; ++j) {
    const float e = expf(a2row[j] - mx);
    a2row[j] = e;
    sum += e;
  }
  for (int j = 0; j < N; ++j) a2row[j] = a2row[j] / sum;
}

// Top-u rows by lexicographic rank: (M descending, index ascending).
__device__ __forceinline__ void select_rows(const float* sM, int* sSel, int N,
                                            int u) {
  for (int t = threadIdx.x; t < N; t += kThreads) {
    const float mi = sM[t];
    int rank = 0;
    for (int j = 0; j < N; ++j) {
      const float mj = sM[j];
      rank += (mj > mi) || (mj == mi && j < t);
    }
    sSel[t] = rank < u;
  }
}

template <typename T>
__device__ __forceinline__ float q_scale_of(int num, float scale) {
  return num == kV23 ? round_to<T>(scale) : 0.f;
}

template <typename T, int NUM, bool WS>
__global__ void __launch_bounds__(kThreads) window_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ cnt,
    const float* __restrict__ bias, const int32_t* __restrict__ region,
    const int32_t* __restrict__ pad, T* __restrict__ out, int B, int N,
    int C, int D, int nW, int u, float scale, int head_major,
    float* __restrict__ ws, size_t ws_floats) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded rows: conflict-free column walks
  const int ls = N + 1;
  // the tiles: shared memory, or (WS) this CTA's slice of the workspace; a
  // compile-time choice, so that shared-memory tiles keep shared loads
  float* tiles =
      WS ? ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                    ws_floats
         : smem;
  float* sQ = tiles;           // [N][ld]
  float* sK = sQ + N * ld;     // [N][ld]
  float* sV = sK + N * ld;     // [N][ld]
  float* sS = sV + N * ld;     // [N][ls]: S, then a2
  float* sM = sS + N * ls;     // [N] sparsity measure
  int* sSel = reinterpret_cast<int*>(sM + N);                 // [N]
  unsigned char* sCnt = reinterpret_cast<unsigned char*>(sSel + N);  // [N*N]

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int rs = head_major ? D : C;  // elements from one token to the next
  for (int e = tid; e < N * N; e += kThreads) {
    sCnt[e] = static_cast<unsigned char>(cnt[e]);
  }

  // One window when the tiles are in shared memory (gridDim.x == B); the
  // workspace's CTAs walk theirs.
  for (int w = blockIdx.x; w < B; w += gridDim.x) {
    const size_t base =
        head_major
            ? (static_cast<size_t>(w) * gridDim.y + h) * N * D
            : static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;
    __syncthreads();  // previous window's tile reads are done
    const T* src[3] = {q, k, v};
    float* dst[3] = {sQ, sK, sV};
    load_tiles<T>(src, dst, 3, base, N, rs, D, ld, q_scale_of<T>(NUM, scale));
    __syncthreads();
    scores<T, NUM>(sQ, sK, sS, N, D, ld, ls);
    __syncthreads();
    for (int i = tid; i < N; i += kThreads) {
      float* row = sS + i * ls;
      const size_t wn = static_cast<size_t>(w % nW) * N;
      row_chain<T, NUM>(
          row, row, row, sM, sCnt + i * N,
          bias ? bias + (static_cast<size_t>(h) * N + i) * N : nullptr,
          region ? region + wn : nullptr, pad ? pad + wn : nullptr, i, N,
          scale);
      if (NUM != kV1) {
        for (int j = 0; j < N; ++j) row[j] = round_to<T>(row[j]);
      }
    }
    __syncthreads();
    select_rows(sM, sSel, N, u);
    __syncthreads();

    // Kept rows: a2 @ V; the others: mean(V).
    for (int e = tid; e < N * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      float acc = 0.f;
      if (sSel[i]) {
        for (int j = 0; j < N; ++j) {
          acc = fmaf(sS[i * ls + j], sV[j * ld + d], acc);
        }
      } else {
        for (int j = 0; j < N; ++j) acc += sV[j * ld + d];
        acc = acc / static_cast<float>(N);
      }
      out[base + static_cast<size_t>(i) * rs + d] = from_f<T>(acc);
    }
  }
}

// ---- K1's float32 forward at the model's shapes ---------------------------
//
// window_attention_f32_fwd_kernel: K1 (kV4), float32, token-major, N <= 64,
// head dim D in {16, 32, 48, 64}. The same function as
// window_attention_fwd_kernel<float, kV4> and the same selection as the
// backward's recomputation, bit for bit: each S element is one float64 fma
// chain over d ascending (as `scores`), rounded once to float, and each M
// is `row_measure` of its row (float64 sum over j ascending). Only the
// speed differs:
//   - persistent CTAs of 128 threads, each walking window-heads of one
//     head h; the count matrix is staged once per CTA as bytes (bias[h],
//     read by the kept rows' chain only, comes through the L1 cache, so
//     that three CTAs fit an SM at D = 32);
//   - q, k and v arrive by 16-byte cp.async one window-head ahead: the
//     next one's copies are issued as soon as this one's q and k are
//     widened, and land while it computes (v double-buffered, as PV reads
//     it to the end);
//   - q and k are widened to float64 once per window-head, into transposed
//     tiles, and S is register-blocked: a thread holds a 4 x 8 block of
//     float64 sums (32 independent chains), reading 4 q and 8 k values per
//     d step (six 16-byte loads for 32 fmas);
//   - S (float) then overwrites the float64 tiles; a thread per row takes
//     M, a warp ranks the rows and lists the kept ones by ballot;
//   - the softmax chain runs on the u kept rows only, four lanes per row
//     (16 columns each in registers), and writes a2 packed (the r-th kept
//     row into S row r <= its own index, after a barrier);
//   - PV on the kept rows only, register-blocked float FMAs (a float4 of
//     output columns and up to eight rows per thread), stored as 16-byte
//     rows; mean(V) is one column sum per window-head (token order, as the
//     other kernels and the flipped-row check take it) and is stored for
//     the other rows.
// What bounds it: per window-head 4 * N * D floats move (32 KB at N = 64,
// D = 32) and S takes N * N * D float64 fmas on the CUDA cores (34 TFLOP/s
// on the H100: about 0.26 ms for the 33,280 window-heads of the serving
// frame's first stage, against 0.33 ms for its bytes).
constexpr int kF32Threads = 128;
constexpr int kCS = kMaxN + 8;  // row stride of the staged counts (bytes)
constexpr int kSS = kMaxN + 1;  // ... of the S / a2 tile (floats)

// x / y rounded to nearest, as the IEEE division, given ry = RN(1 / y): one
// correction of q = RN(x * ry) by the exact residual (Markstein). For the
// softmaxes' x in [0, 1] and y >= 1 only quotients below float's normal
// range could differ.
__device__ __forceinline__ float div_rn(float x, float y, float ry) {
  const float q = x * ry;
  return fmaf(fmaf(-q, y, x), ry, q);
}

template <int D>
struct F32Fwd {
  static constexpr int kQK = 2 * D * kMaxN * 8;  // float64 q^T, k^T
  static constexpr int kS = kMaxN * kSS * 4;     // float S, then a2
  static constexpr int kTile = kQK > kS ? kQK : kS;
  static constexpr int LV = D + 4;               // row stride of the v tile
  static constexpr int kShared = kMaxN * kCS;   // the counts
  static constexpr int kSmem =
      kShared + kTile + 4 * kMaxN * LV * 4 +       // tiles; q, k, 2 x v
      3 * kMaxN * 4 + kMaxN * 4 +                  // M, region, pad; mean(V)
      kMaxN + 16;                                  // kept-row list, keep bits
  // PV: a float4 of columns (D / 4 groups) and every RG-th kept row
  static constexpr int kGroups = D / 4;
  static constexpr int RG = kF32Threads / kGroups;
  static constexpr int MR = (kMaxN + RG - 1) / RG;
  static_assert(D % 16 == 0 && D <= 64, "head dim 16, 32, 48 or 64");
  static_assert(kShared % 16 == 0 && kTile % 16 == 0 && LV % 4 == 0,
                "16-byte aligned tiles");
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    window_attention_f32_fwd_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int32_t* __restrict__ cnt,
        const float* __restrict__ bias, const int32_t* __restrict__ region,
        const int32_t* __restrict__ pad, float* __restrict__ out, int B,
        int N, int C, int nW, int u, float scale) {
  using L = F32Fwd<D>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  unsigned char* sCnt = smem_f32;                        // [64][kCS] counts
  unsigned char* tile = smem_f32 + L::kShared;
  double* sQT = reinterpret_cast<double*>(tile);         // [D][64] q^T
  double* sKT = sQT + D * kMaxN;                         // [D][64] k^T
  float* sS = reinterpret_cast<float*>(tile);            // [64][kSS]: S, a2
  float* sQf = reinterpret_cast<float*>(tile + L::kTile);  // [64][LV] q, as
  float* sKf = sQf + kMaxN * L::LV;                        // ... k, copied
  float* sVb = sKf + kMaxN * L::LV;                      // 2 x [64][LV] v
  float* sM = sVb + 2 * kMaxN * L::LV;                   // [64]
  int* sReg = reinterpret_cast<int*>(sM + kMaxN);        // [64]
  int* sPad = sReg + kMaxN;                              // [64]
  float* sMean = reinterpret_cast<float*>(sPad + kMaxN);  // [D]
  unsigned char* sIdx =
      reinterpret_cast<unsigned char*>(sMean + kMaxN);   // [64] kept rows
  unsigned* sKeep = reinterpret_cast<unsigned*>(sIdx + kMaxN);  // keep bits
  const int tid = threadIdx.x, h = blockIdx.y;
  const bool has_bias = bias != nullptr, has_reg = region != nullptr,
             has_pad = pad != nullptr;

  for (int e = tid; e < kMaxN * kMaxN; e += kF32Threads) {
    const int i = e >> 6, j = e & 63;
    const bool in = i < N && j < N;
    sCnt[i * kCS + j] = in ? static_cast<unsigned char>(cnt[i * N + j]) : 0;
  }
  const float* bias_h =
      has_bias ? bias + static_cast<size_t>(h) * N * N : nullptr;

  // window-head w's q, k and v (into v buffer vb) by 16-byte cp.async,
  // rows past N zero-filled; one commit group
  auto issue = [&](int w, float* vb) {
    const size_t base =
        static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;
    const float* src[3] = {q, k, v};
    float* dst[3] = {sQf, sKf, vb};
    for (int e = tid; e < 3 * kMaxN * L::kGroups; e += kF32Threads) {
      const int t = e / (kMaxN * L::kGroups), f = e % (kMaxN * L::kGroups);
      const int r = f / L::kGroups, c = (f % L::kGroups) * 4;
      const bool ok = r < N;
      const uint32_t to = static_cast<uint32_t>(
          __cvta_generic_to_shared(dst[t] + r * L::LV + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       to),
                   "l"(src[t] + base + static_cast<size_t>(ok ? r : 0) * C +
                       c),
                   "r"(ok ? 16 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (blockIdx.x < B) issue(blockIdx.x, sVb);

  for (int w = blockIdx.x, it = 0; w < B; w += gridDim.x, ++it) {
    const size_t base =
        static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;
    float* sV = sVb + (it & 1) * kMaxN * L::LV;
    // this window-head's copies have landed, and the previous one is done
    // with the tiles
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // q and k widened into the transposed float64 tiles (a thread per row
    // and float4); this window's masks
    for (int e = tid; e < kMaxN * L::kGroups; e += kF32Threads) {
      const int i = e & 63, c = (e >> 6) * 4;
      const float4 a = *reinterpret_cast<const float4*>(sQf + i * L::LV + c);
      const float4 b = *reinterpret_cast<const float4*>(sKf + i * L::LV + c);
      sQT[(c + 0) * kMaxN + i] = a.x, sQT[(c + 1) * kMaxN + i] = a.y;
      sQT[(c + 2) * kMaxN + i] = a.z, sQT[(c + 3) * kMaxN + i] = a.w;
      sKT[(c + 0) * kMaxN + i] = b.x, sKT[(c + 1) * kMaxN + i] = b.y;
      sKT[(c + 2) * kMaxN + i] = b.z, sKT[(c + 3) * kMaxN + i] = b.w;
    }
    for (int j = tid; j < kMaxN; j += kF32Threads) {
      const size_t wn = static_cast<size_t>(w % nW) * N;
      sReg[j] = has_reg && j < N ? region[wn + j] : 0;
      sPad[j] = has_pad && j < N ? pad[wn + j] : 0;
    }
    __syncthreads();
    // the next window-head's copies land during this one (its v into the
    // other buffer, which the previous window-head's PV is done with)
    if (w + gridDim.x < B) {
      issue(w + gridDim.x, sVb + ((it + 1) & 1) * kMaxN * L::LV);
    }

    // S: rows 4 * rg ... + 3, columns 8 * cg ... + 7 of this thread, each
    // one float64 fma chain over d ascending
    const int rg = tid >> 3, cg = tid & 7;
    double acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const double2* qr =
          reinterpret_cast<const double2*>(sQT + d * kMaxN + 4 * rg);
      const double2* kr =
          reinterpret_cast<const double2*>(sKT + d * kMaxN + 8 * cg);
      const double2 q01 = qr[0], q23 = qr[1];
      const double qv[4] = {q01.x, q01.y, q23.x, q23.y};
      double kv[8];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const double2 t = kr[b];
        kv[2 * b] = t.x, kv[2 * b + 1] = t.y;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fma(qv[a], kv[b], acc[a][b]);
    }
    __syncthreads();  // every read of the float64 tiles is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        sS[(4 * rg + a) * kSS + 8 * cg + b] = __double2float_rn(acc[a][b]);
      }
    __syncthreads();

    // M, a thread per row; mean(V), a thread per column, beside it
    if (tid < N) sM[tid] = row_measure(sS + tid * kSS, sCnt + tid * kCS, N);
    for (int d = tid - kMaxN; d >= 0 && d < D; d += kF32Threads - kMaxN) {
      float sum = 0.f;
      for (int j = 0; j < N; ++j) sum += sV[j * L::LV + d];
      sMean[d] = sum / static_cast<float>(N);
    }
    __syncthreads();

    // rank (M descending, index ascending) < u, by warp 0: the kept rows
    // listed in index order, their count and bits
    if (tid < 32) {
      const int lane = tid;
      const float m0 = lane < N ? sM[lane] : 0.f;
      const float m1 = lane + 32 < N ? sM[lane + 32] : 0.f;
      int rank0 = 0, rank1 = 0;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const float mj = sM[j];
        rank0 += (mj > m0) || (mj == m0 && j < lane);
        rank1 += (mj > m1) || (mj == m1 && j < lane + 32);
      }
      const unsigned lo = __ballot_sync(~0u, lane < N && rank0 < u);
      const unsigned hi = __ballot_sync(~0u, lane + 32 < N && rank1 < u);
      const unsigned below = (1u << lane) - 1u;
      if ((lo >> lane) & 1u) sIdx[__popc(lo & below)] = lane;
      if ((hi >> lane) & 1u) sIdx[__popc(lo) + __popc(hi & below)] = lane + 32;
      if (lane == 0) sKeep[0] = lo, sKeep[1] = hi;
    }
    __syncthreads();
    const unsigned keep_lo = sKeep[0], keep_hi = sKeep[1];
    const int nk = __popc(keep_lo) + __popc(keep_hi);

    // chain on the kept rows, four lanes per row (columns sub + 4e), 32
    // rows a pass: a1 = softmax(S * scale), z = a1 + bias + mask, a2 =
    // softmax(z), written into row r of the tile for the r-th kept row
    const int slot = tid >> 2, sub = tid & 3;
    for (int r0 = 0; r0 < nk; r0 += 32) {
      const int r = r0 + slot;
      const int i = r < nk ? sIdx[r] : 0;
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int j = sub + 4 * e;
        x[e] = j < N ? sS[i * kSS + j] * scale : -INFINITY;
      }
      __syncthreads();  // this pass's rows are read before any is written
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, x[e]);
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        x[e] = expf(x[e] - mx);
        sum += x[e];
      }
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      float rsum = __frcp_rn(sum);
      const bool pad_i = has_pad && sPad[i];
      const int reg_i = sReg[i];
      mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int j = sub + 4 * e;
        float z = div_rn(x[e], sum, rsum);  // a1
        if (has_bias && j < N) z = z + __ldg(bias_h + i * N + j);
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
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        x[e] = expf(x[e] - mx);
        sum += x[e];
      }
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      rsum = __frcp_rn(sum);
      if (r < nk) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sS[r * kSS + sub + 4 * e] = div_rn(x[e], sum, rsum);
        }
      }
    }
    __syncthreads();

    // PV for the kept rows: a float4 of columns and every RG-th row, into
    // out row sIdx[r]; the other rows get mean(V)
    if (tid < L::RG * L::kGroups) {
      const int c = (tid % L::kGroups) * 4, r1 = tid / L::kGroups;
      float4 o[L::MR];
#pragma unroll
      for (int m = 0; m < L::MR; ++m) o[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < N; ++j) {
        const float4 vj = *reinterpret_cast<const float4*>(sV + j * L::LV + c);
#pragma unroll
        for (int m = 0; m < L::MR; ++m) {
          const int r = r1 + m * L::RG;
          if (r < nk) {
            const float a = sS[r * kSS + j];
            o[m].x = fmaf(a, vj.x, o[m].x);
            o[m].y = fmaf(a, vj.y, o[m].y);
            o[m].z = fmaf(a, vj.z, o[m].z);
            o[m].w = fmaf(a, vj.w, o[m].w);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < L::MR; ++m) {
        const int r = r1 + m * L::RG;
        if (r < nk) {
          *reinterpret_cast<float4*>(
              out + base + static_cast<size_t>(sIdx[r]) * C + c) = o[m];
        }
      }
    }
    for (int e = tid; e < N * L::kGroups; e += kF32Threads) {
      const int i = e / L::kGroups, c = (e % L::kGroups) * 4;
      const bool kept = ((i < 32 ? keep_lo >> i : keep_hi >> (i - 32)) & 1u);
      if (!kept) {
        *reinterpret_cast<float4*>(out + base + static_cast<size_t>(i) * C +
                                   c) =
            *reinterpret_cast<const float4*>(sMean + c);
      }
    }
  }
}

template <typename T, int NUM, bool WS>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const int32_t* __restrict__ cnt, const float* __restrict__ bias,
    const int32_t* __restrict__ region, const int32_t* __restrict__ pad,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ db_part, int B, int N, int C, int D, int H, int nW,
    int u, float scale, float* __restrict__ ws, size_t ws_floats) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ls = N + 1;
  // the tiles: shared memory, or (WS) this CTA's slice of the workspace; a
  // compile-time choice, so that shared-memory tiles keep shared loads
  float* tiles =
      WS ? ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                    ws_floats
         : smem;
  float* sQ = tiles;           // [N][ld]
  float* sK = sQ + N * ld;     // [N][ld]
  float* sV = sK + N * ld;     // [N][ld]
  float* sG = sV + N * ld;     // [N][ld]: g, then g_sel
  float* sA1 = sG + N * ld;    // [N][ls]: S, then a1
  float* sA2 = sA1 + N * ls;   // [N][ls]: a2
  float* sD = sA2 + N * ls;    // [N][ls]: da2, then dz, then ds
  float* sM = sD + N * ls;     // [N]
  float* sGu = sM + N;         // [D]: sum over unselected rows of g
  int* sSel = reinterpret_cast<int*>(sGu + D);                       // [N]
  unsigned char* sCnt = reinterpret_cast<unsigned char*>(sSel + N);  // [N*N]

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  for (int e = tid; e < N * N; e += kThreads) {
    sCnt[e] = static_cast<unsigned char>(cnt[e]);
  }
  // This CTA's dbias partial: in registers up to kMaxN; beyond, summed in
  // place in its db_part slice, each element by one thread in window order.
  const bool db_regs = N <= kMaxN;
  float* part =
      db_part ? db_part + (static_cast<size_t>(blockIdx.x) * H + h) * N * N
              : nullptr;
  float acc_db[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc_db[r] = 0.f;
  if (part && !db_regs) {
    for (int e = tid; e < N * N; e += kThreads) part[e] = 0.f;
  }

  for (int w = blockIdx.x; w < B; w += gridDim.x) {
    const size_t base =
        static_cast<size_t>(w) * N * C + static_cast<size_t>(h) * D;
    __syncthreads();  // previous window's smem reads are done
    const T* src[4] = {q, k, v, g};
    float* dst[4] = {sQ, sK, sV, sG};
    load_tiles<T>(src, dst, 4, base, N, C, D, ld, q_scale_of<T>(NUM, scale));
    __syncthreads();
    scores<T, NUM>(sQ, sK, sA1, N, D, ld, ls);
    __syncthreads();
    for (int i = tid; i < N; i += kThreads) {
      const size_t wn = static_cast<size_t>(w % nW) * N;
      row_chain<T, NUM>(
          sA1 + i * ls, sA1 + i * ls, sA2 + i * ls, sM, sCnt + i * N,
          bias ? bias + (static_cast<size_t>(h) * N + i) * N : nullptr,
          region ? region + wn : nullptr, pad ? pad + wn : nullptr, i, N,
          scale);
    }
    __syncthreads();
    select_rows(sM, sSel, N, u);
    __syncthreads();

    // sum over unselected rows of g (the mean(V) term of dv), then zero
    // those rows of g so that sG holds g_sel.
    for (int d = tid; d < D; d += kThreads) {
      float s = 0.f;
      for (int i = 0; i < N; ++i) {
        if (!sSel[i]) s += sG[i * ld + d];
      }
      sGu[d] = s;
    }
    __syncthreads();
    for (int e = tid; e < N * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      if (!sSel[i]) sG[i * ld + d] = 0.f;
    }
    __syncthreads();

    // dv[j, d] = sum_i a2[i, j] g_sel[i, d] + sum_i g_unsel[i, d] / N
    for (int e = tid; e < N * D; e += kThreads) {
      const int j = e / D, d = e - j * D;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) {
        acc = fmaf(sA2[i * ls + j], sG[i * ld + d], acc);
      }
      acc = acc + sGu[d] / static_cast<float>(N);
      dv[base + static_cast<size_t>(j) * C + d] = from_f<T>(acc);
    }
    // da2[i, j] = sum_d g_sel[i, d] v[j, d]
    for (int e = tid; e < N * N; e += kThreads) {
      const int i = e / N, j = e - i * N;
      float acc = 0.f;
      if (sSel[i]) {
        for (int d = 0; d < D; ++d) {
          acc = fmaf(sG[i * ld + d], sV[j * ld + d], acc);
        }
      }
      sD[i * ls + j] = acc;
    }
    __syncthreads();
    // dz = a2 * (da2 - rowsum(da2 * a2))
    for (int i = tid; i < N; i += kThreads) {
      const float* a2 = sA2 + i * ls;
      float* dr = sD + i * ls;
      float s = 0.f;
      for (int j = 0; j < N; ++j) s = fmaf(dr[j], a2[j], s);
      for (int j = 0; j < N; ++j) dr[j] = a2[j] * (dr[j] - s);
    }
    __syncthreads();
    if (part) {
      if (db_regs) {
#pragma unroll
        for (int r = 0; r < kAcc; ++r) {
          const int e = tid + r * kThreads;
          if (e < N * N) acc_db[r] += sD[(e / N) * ls + e % N];
        }
      } else {
        for (int e = tid; e < N * N; e += kThreads) {
          part[e] += sD[(e / N) * ls + e % N];
        }
      }
      __syncthreads();
    }
    // ds = a1 * (dz - rowsum(dz * a1))
    for (int i = tid; i < N; i += kThreads) {
      const float* a1 = sA1 + i * ls;
      float* dr = sD + i * ls;
      float s = 0.f;
      for (int j = 0; j < N; ++j) s = fmaf(dr[j], a1[j], s);
      for (int j = 0; j < N; ++j) dr[j] = a1[j] * (dr[j] - s);
    }
    __syncthreads();
    // dq[i, d] = scale sum_j ds[i, j] k[j, d]
    // dk[j, d] = scale sum_i ds[i, j] q[i, d]; in kV23 sQ holds q * scale
    // (rounded) already
    for (int e = tid; e < N * D; e += kThreads) {
      const int i = e / D, d = e - i * D;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < N; ++j) {
        aq = fmaf(sD[i * ls + j], sK[j * ld + d], aq);
        ak = fmaf(sD[j * ls + i], sQ[j * ld + d], ak);
      }
      const size_t o = base + static_cast<size_t>(i) * C + d;
      dq[o] = from_f<T>(aq * scale);
      dk[o] = from_f<T>(NUM == kV23 ? ak : ak * scale);
    }
  }
  if (part && db_regs) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < N * N) part[e] = acc_db[r];
    }
  }
}

// dbias[e] = sum over blocks b (in order) of part[b][e], e over H * N * N.
__global__ void __launch_bounds__(kThreads) dbias_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dbias, int n_blocks,
    int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[static_cast<size_t>(b) * n + e];
  dbias[e] = s;
}

// Bytes of one CTA's tiles (see the kernels' carve-outs).
size_t fwd_tile_bytes(int N, int D) {
  return (3 * static_cast<size_t>(N) * (D + 1) + N * (N + 1) + N) *
             sizeof(float) +
         N * sizeof(int) + static_cast<size_t>(N) * N;
}

size_t bwd_tile_bytes(int N, int D) {
  return (4 * static_cast<size_t>(N) * (D + 1) + 3 * N * (N + 1) + N + D) *
             sizeof(float) +
         N * sizeof(int) + static_cast<size_t>(N) * N;
}

// Floats of workspace per CTA: 0 when the tiles fit in shared memory.
size_t ws_floats_of(size_t bytes) {
  return bytes <= kSmemMax ? 0 : (bytes + sizeof(float) - 1) / sizeof(float);
}

struct FwdArgs {
  const void *q, *k, *v;
  const int32_t* cnt;
  const float* bias;
  const int32_t *region, *pad;
  void* out;
  int B, N, C, H, nW, u;
  float scale;
  int head_major;
  float* ws;
  int ws_blocks;
};

template <typename T, int NUM>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const int D = a.C / a.H;
  const int N = a.N;
  const size_t bytes = fwd_tile_bytes(N, D);
  const size_t ws_floats = ws_floats_of(bytes);
  if (ws_floats && (a.ws == nullptr || a.ws_blocks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = ws_floats ? 0 : bytes;
  auto kernel = ws_floats ? window_attention_fwd_kernel<T, NUM, true>
                          : window_attention_fwd_kernel<T, NUM, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ws_floats ? a.ws_blocks : a.B, a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.cnt, a.bias, a.region, a.pad,
      static_cast<T*>(a.out), a.B, N, a.C, D, a.nW, a.u, a.scale,
      a.head_major, ws_floats ? a.ws : nullptr, ws_floats);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_numerics(int numerics, const FwdArgs& a, cudaStream_t s) {
  switch (numerics) {
    case kV4: return launch_fwd<T, kV4>(a, s);
    case kV1: return launch_fwd<T, kV1>(a, s);
    case kV23: return launch_fwd<T, kV23>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  int n_blocks;
  float* ws;
};

template <typename T, int NUM>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int D = a.C / a.H;
  const int N = a.N;
  const size_t bytes = bwd_tile_bytes(N, D);
  const size_t ws_floats = ws_floats_of(bytes);
  if (ws_floats && a.ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = ws_floats ? 0 : bytes;
  auto kernel = ws_floats ? window_attention_bwd_kernel<T, NUM, true>
                          : window_attention_bwd_kernel<T, NUM, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.n_blocks, a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.cnt, a.bias,
      a.region, a.pad, static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.bias ? a.db_part : nullptr, a.B, N, a.C, D,
      a.H, a.nW, a.u, a.scale, ws_floats ? a.ws : nullptr, ws_floats);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.bias == nullptr) return err;
  const int n = a.H * N * N;
  dbias_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.db_part, a.dbias, a.n_blocks, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_numerics(int numerics, const BwdArgs& a, cudaStream_t s) {
  switch (numerics) {
    case kV4: return launch_bwd<T, kV4>(a, s);
    case kV23: return launch_bwd<T, kV23>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);  // kV1 has no backward
}

template <int D>
int launch_f32_fwd(const FwdArgs& a, cudaStream_t stream) {
  using L = F32Fwd<D>;
  auto kernel = window_attention_f32_fwd_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kF32Threads, L::kSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave of persistent CTAs: what the card holds at once, over H heads
  const int wave = (max(per_sm, 1) * sms + a.H - 1) / a.H;
  const int gx = max(1, min(a.B, wave));
  kernel<<<dim3(gx, a.H), kF32Threads, L::kSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.cnt, a.bias, a.region, a.pad,
      static_cast<float*>(a.out), a.B, a.N, a.C, a.nW, a.u, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1's float32 forward at the model's shapes (window_attention_f32_fwd_
// kernel): q/k/v/out float32 [B * N, C] token-major, contiguous and 16-byte
// aligned, head dim D = C / H in {16, 32, 48, 64}, 1 <= N <= 64; cnt,
// bias, region and pad as for window_attention_fwd. Returns
// cudaGetLastError() after the launch, or an error code for a shape it
// does not take.
int window_attention_f32_fwd(const void* q, const void* k, const void* v,
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
  const FwdArgs a{q, k, v, cnt, bias, region, pad, out, B, N, C, H, nW, u,
                  scale, 0, nullptr, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch_f32_fwd<16>(a, s);
    case 32: return launch_f32_fwd<32>(a, s);
    case 48: return launch_f32_fwd<48>(a, s);
    case 64: return launch_f32_fwd<64>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// Bytes of global-memory workspace one CTA needs for these tiles (bwd = 0:
// the forward, 1: the backward); 0 when they fit in shared memory.
int window_attention_ws_bytes(int bwd, int N, int D) {
  const size_t bytes = bwd ? bwd_tile_bytes(N, D) : fwd_tile_bytes(N, D);
  return static_cast<int>(ws_floats_of(bytes) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. numerics: 0 = K1 (v4), 1 = v1,
// 2 = v2/v3. q/k/v/out contiguous: [B * N, C] token-major, or [B, H, N, D]
// with head_major != 0. cnt: [N, N] int32; bias: [H, N, N] float32 or
// null; region and pad: [nW, N] int32 or null. Where
// window_attention_ws_bytes(0, N, D) > 0, ws is float32 scratch of that
// many bytes for each of ws_blocks * H CTAs, which then walk the B
// windows (1 <= ws_blocks <= B); otherwise ws is ignored. Returns
// cudaGetLastError() after the launch.
int window_attention_fwd(int dtype, int numerics, int head_major,
                         const void* q, const void* k, const void* v,
                         const int32_t* cnt, const float* bias,
                         const int32_t* region, const int32_t* pad, void* out,
                         int B, int N, int C, int H, int nW, int u,
                         float scale, float* ws, int ws_blocks,
                         void* stream) {
  const FwdArgs a{q, k, v, cnt, bias, region, pad, out, B, N, C, H, nW, u,
                  scale, head_major, ws, ws_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd_numerics<float>(numerics, a, s);
  return launch_fwd_numerics<__nv_bfloat16>(numerics, a, s);
}

// Backward, token-major. numerics: 0 = K1 (v4), 2 = v3. q/k/v/g and
// dq/dk/dv: [B * N, C] contiguous, in the activation type. With a bias,
// db_part is float32 scratch [n_blocks, H, N, N] and dbias the float32
// output [H, N, N]; both are ignored without one. n_blocks (1..B) CTAs per
// head share the windows. Where window_attention_ws_bytes(1, N, D) > 0, ws
// is float32 scratch of that many bytes for each of n_blocks * H CTAs.
// Returns cudaGetLastError() after the last launch.
int window_attention_bwd(int dtype, int numerics, const void* q,
                         const void* k, const void* v, const void* g,
                         const int32_t* cnt, const float* bias,
                         const int32_t* region, const int32_t* pad, void* dq,
                         void* dk, void* dv, float* db_part, float* dbias,
                         int B, int N, int C, int H, int nW, int u,
                         float scale, int n_blocks, float* ws, void* stream) {
  const BwdArgs a{q, k, v, g, cnt, bias, region, pad, dq, dk, dv, db_part,
                  dbias, B, N, C, H, nW, u, scale, n_blocks, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_numerics<float>(numerics, a, s);
  return launch_bwd_numerics<__nv_bfloat16>(numerics, a, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
