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
// bf16 (see that file's note). The float32 forward runs the functions here
// and is bit-identical to the backward's recomputation.
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
// and the row statistics run one thread per row. The bf16 forward of the
// model's shapes has its own kernel on the tensor cores
// (csrc/window_attention_tc.cu); the backward's is later work.

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
template <typename T, int NUM>
__device__ __forceinline__ void row_chain(const float* srow, float* a1row,
                                          float* a2row, float* sM,
                                          const unsigned char* cntrow,
                                          const float* brow,
                                          const int32_t* reg,
                                          const int32_t* pad, int i, int N,
                                          float scale) {
  float m_max = -1e30f;
  double m_sum = 0.0;
  for (int j = 0; j < N; ++j) {
    const int c = cntrow[j];
    if (c > 0) {
      m_max = fmaxf(m_max, srow[j]);
      m_sum += static_cast<double>(srow[j]) * c;
    }
  }
  sM[i] = m_max - __double2float_rn(m_sum) / static_cast<float>(N);

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

}  // namespace

extern "C" {

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
