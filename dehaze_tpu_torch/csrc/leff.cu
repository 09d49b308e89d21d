// K2: fused LayerNorm + LeFF, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `leff_fused` -> `_kernel` of
// dehaze_tpu/ops/pallas/leff.py. Same function as the plain twin
// `dehaze_tpu_torch.ops.kernels.leff.leff_reference`:
//   LayerNorm (eps, f32 statistics) -> x @ W1 + b1 (C -> Ch) -> GELU ->
//   zero the halo pixels outside the image -> depthwise 3x3 + bias -> GELU
//   -> @ W2 + b2 (Ch -> C). The residual add stays outside.
// The activation type T (float or bf16) is rounded to at the same points as
// the twin: LN output, dense1 + bias, each GELU, dwconv + bias, the output.
// GELU is exact (erff, or tanhf for the tanh form) in f32 from the rounded
// value, as in the twin.
//
// bf16 (the serving type): one CTA per output tile of 8 x TW pixels of one
// image; the last tile row and column may be ragged (any H and W). The haloed (8+2) x (TW+2) input tile is layer-normed once into
// shared memory (bf16; rows padded to 16 for the MMA, K padded to 16 with
// zeros; one to sixteen lanes per pixel, so small C needs no shuffles). The
// CTA then walks the hidden width in chunks of KC channels:
//   - W1[:, chunk] with the chunk's b1, dw taps and bias (P1), and
//     W2[chunk, :] (P2), are staged in shared memory by cp.async, zero-filled
//     outside [C, Ch] (C and Ch need not be multiples of the MMA tile). One
//     buffer each for W1 and W2, their copies staggered: P1(k+1) is issued
//     once dense1(k) is done with W1, P2(k) once dense2(k-1) is done with
//     W2, so each lands during a phase of compute;
//   - dense1 on the tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32,
//     operands by ldmatrix from the padded rows), a warp per 16 pixels x 32
//     channels; + b1, rounded to bf16 into the hidden tile;
//   - GELU over the haloed hidden tile by all threads, zero outside the
//     image (the conv's SAME padding);
//   - depthwise 3x3 + bias + GELU on CUDA cores into dense2's bf16 A tile;
//   - dense2 on the tensor cores; its f32 accumulator stays in registers
//     across all chunks, the output channels split over the warps (at
//     C = 512: 16 warps x 32 channels x 64 pixels, 64 registers each; no
//     cluster or second CTA is needed).
// The hidden tensor never reaches HBM. The tile class (TW, warps, KC) is
// picked per C by the wrapper's planner (`ops/kernels/leff.py`, plan_tile):
// 8x32 up to C = 128 (dense1 on 1.33 haloed pixels per output pixel), 8x16
// at C = 256 (1.41), 8x8 at C = 512 (1.56), each within 227 KB.
//
// What bounds it. Small C (32, 64): the exact GELU on the CUDA cores,
// twice per hidden element plus the halo's third, tens of instructions
// each; the tensor cores are idle most of the time. Large C (256, 512): one
// CTA fills an SM (the LN tile alone is 116 KB at C = 512), and its four
// phases per chunk (dense1, GELU, dwconv, dense2) run one after the other
// between barriers, so the tensor cores idle while the CUDA cores work and
// the reverse. scripts/k2_phases.py measures the phases. Overlapping them
// (warp specialisation, wgmma) is the next step; neither bound is HBM.
//
// float32 (the card's test path, not the serving one) stays on CUDA cores:
// TF32 would move the result past the tolerance against the twin. It walks
// the hidden width in chunks of 32 (one lane per channel) and accumulates
// dense2 in a float tile in shared memory, 8 columns by the rows the
// wrapper plans.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float gelu(float x, int fast) {
  if (fast) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// LayerNorm of pixel row xp (C values) by one warp; writes C normalized
// values of type T to dst[0..C) and zeros to dst[C..Kp).
template <typename T>
__device__ __forceinline__ void layer_norm_row(const T* xp, const T* gamma,
                                               const T* beta, T* dst, int C,
                                               int Kp, float eps, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xp[c]);
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xp[c]) - mu;
    s2 += d * d;
  }
  const float rs = rsqrtf(warp_sum(s2) / C + eps);
  for (int c = lane; c < Kp; c += 32) {
    dst[c] = c < C ? from_f<T>((to_f(xp[c]) - mu) * rs * to_f(gamma[c]) +
                               to_f(beta[c]))
                   : from_f<T>(0.f);
  }
}

// ----------------------------------------------------------------- float32

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Chunk = 32;  // hidden channels per chunk: one per lane

__global__ void __launch_bounds__(kF32Threads) leff_fwd_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ dw,
    const float* __restrict__ dwb, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int H, int W,
    int C, int Ch, int TH, int TW, float eps, int fast_gelu) {
  extern __shared__ float smem[];
  const int PW = TW + 2;               // haloed tile width
  const int HP = (TH + 2) * PW;        // haloed pixels
  const int TP = TH * TW;              // output pixels
  float* sOut = smem;                  // [TP][C] dense2 accumulator
  float* sHid = sOut + TP * C;         // [HP][kF32Chunk] GELU(dense1) chunk
  float* sG = sHid + HP * kF32Chunk;   // [TP][kF32Chunk] GELU(dwconv) chunk
  float* sXn = sG + TP * kF32Chunk;    // [HP][C]
  unsigned char* sIn = reinterpret_cast<unsigned char*>(sXn + HP * C);  // [HP]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. LayerNorm of the haloed input tile, one warp per pixel.
  for (int p = warp; p < HP; p += kF32Warps) {
    const int gy = y0 - 1 + p / PW;
    const int gx = x0 - 1 + p % PW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    if (lane == 0) sIn[p] = inside;
    if (!inside) continue;  // its hidden values are masked to zero below
    layer_norm_row(x + ((static_cast<size_t>(b) * H + gy) * W + gx) * C,
                   gamma, beta, sXn + p * C, C, C, eps, lane);
  }
  for (int e = tid; e < TP * C; e += kF32Threads) sOut[e] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < Ch; c0 += kF32Chunk) {
    const int ch = c0 + lane;
    const bool live = ch < Ch;

    // 2a. dense1 + GELU on the haloed tile; zero outside the image.
    for (int p = warp; p < HP; p += kF32Warps) {
      float g = 0.f;
      if (live && sIn[p]) {
        const float* xr = sXn + p * C;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) {
          acc = fmaf(xr[c], w1[static_cast<size_t>(c) * Ch + ch], acc);
        }
        g = gelu(acc + b1[ch], fast_gelu);
      }
      sHid[p * kF32Chunk + lane] = g;
    }
    __syncthreads();

    // 2b. depthwise 3x3 (VALID over the halo) + bias + GELU.
    for (int t = warp; t < TP; t += kF32Warps) {
      const int r = t / TW, c = t % TW;
      float g = 0.f;
      if (live) {
        float acc = 0.f;
        for (int di = 0; di < 3; ++di) {
          for (int dj = 0; dj < 3; ++dj) {
            acc = fmaf(sHid[((r + di) * PW + c + dj) * kF32Chunk + lane],
                       dw[(di * 3 + dj) * Ch + ch], acc);
          }
        }
        g = gelu(acc + dwb[ch], fast_gelu);
      }
      sG[t * kF32Chunk + lane] = g;
    }
    __syncthreads();

    // 2c. this chunk's share of dense2.
    const int n_live = min(kF32Chunk, Ch - c0);
    for (int e = tid; e < TP * C; e += kF32Threads) {
      const int t = e / C, n = e - t * C;
      float acc = sOut[e];
      for (int j = 0; j < n_live; ++j) {
        acc = fmaf(sG[t * kF32Chunk + j],
                   w2[static_cast<size_t>(c0 + j) * C + n], acc);
      }
      sOut[e] = acc;
    }
    __syncthreads();
  }

  // 3. + b2, store the tile.
  for (int e = tid; e < TP * C; e += kF32Threads) {
    const int t = e / C, n = e - t * C;
    const int gy = y0 + t / TW, gx = x0 + t % TW;
    if (gy < H && gx < W) {
      out[((static_cast<size_t>(b) * H + gy) * W + gx) * C + n] =
          sOut[e] + b2[n];
    }
  }
}

size_t f32_smem_bytes(int C, int TH, int TW) {
  const size_t HP = (TH + 2) * (TW + 2), TP = TH * TW;
  return (TP * C + HP * kF32Chunk + TP * kF32Chunk + HP * C) * sizeof(float) +
         HP;
}

// ---------------------------------------------------- bf16, tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows x COLS bf16 of src (row stride src_stride) to dst (row stride
// dst_stride) by all NT threads, zero where row >= row_end or col >= col_end:
// by 16-byte cp.async (zero-filled; the caller commits) when vec, else by
// plain loads and stores. With vec, COLS and col_end are multiples of 8.
template <int COLS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, int dst_stride,
                                          const bf16* src, size_t src_stride,
                                          int rows, int row_end, int col_end,
                                          int vec, int tid) {
  if (vec) {
    constexpr int kSegs = COLS / 8;
    for (int i = tid; i < rows * kSegs; i += NT) {
      const int r = i / kSegs, c = (i % kSegs) * 8;
      const bool ok = r < row_end && c < col_end;
      cp_async16(smem_addr(dst + r * dst_stride + c),
                 ok ? src + r * src_stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * dst_stride + c] = r < row_end && c < col_end
                                    ? src[r * src_stride + c]
                                    : __float2bfloat16_rn(0.f);
    }
  }
}

// A tile class: output tile 8 x TW; warps WM x WN, each holding MW x NW
// dense2 fragments (16 pixels x 8 channels each); hidden chunk KC; MINB
// CTAs per SM.
template <int TW_, int WM_, int WN_, int MW_, int NW_, int KC_, int MINB_>
struct Tile {
  static constexpr int TH = 8, TW = TW_, WM = WM_, WN = WN_, MW = MW_,
                       NW = NW_, KC = KC_, MINB = MINB_;
  static constexpr int kWarps = WM * WN, kThreads = 32 * kWarps;
  static constexpr int PW = TW + 2;                  // haloed tile width
  static constexpr int HP = (TH + 2) * PW;           // haloed pixels
  static constexpr int HMT = (HP + 15) / 16;         // ... in m-tiles
  static constexpr int HPP = HMT * 16;               // ... padded to 16
  static constexpr int TP = TH * TW;                 // output pixels
  static constexpr int NC = WN * NW * 8;             // output channels held
  static constexpr int HS = KC + 8;  // row stride of the W1 chunk, sHid, sG
  static constexpr int NS = NC + 8;  // row stride of the W2 chunk
  static constexpr int kPar = 11;    // parameter rows: b1, dw bias, 9 taps
  static constexpr int LG = NC / 32;  // LN: lanes per pixel, 32 values each
  static_assert(TP == WM * MW * 16, "the warps cover the output pixels");
  static_assert(NW % 2 == 0 && KC % 32 == 0 && NC % 32 == 0,
                "MMA tile multiples");
  static_assert(kThreads % (KC / 2) == 0, "dwconv: fixed channel pair");

  // Shared memory in bytes for K = C padded to 16: bf16 tiles whose rows
  // are padded by 8 elements (16 bytes, which keeps ldmatrix free of bank
  // conflicts): LN tile, W1 chunk, W2 chunk (one buffer each: their copies
  // are staggered, see the kernel), two buffers of the chunk's parameters,
  // the hidden tile and dense2's A; a byte per haloed pixel (in the image
  // or not).
  static size_t smem_bytes(int C) {
    const size_t Kp = (C + 15) / 16 * 16;
    return 2 * (HPP * (Kp + 8) + Kp * HS + KC * NS + 2 * kPar * KC +
                HPP * HS + TP * HS) +
           HPP;
  }
};

// The classes, by the largest C each takes (must match plan_tile).
using Tile32 = Tile<32, 8, 1, 2, 4, 32, 2>;    // C <= 32: 8x32, 8 warps
using Tile64 = Tile<32, 8, 2, 2, 4, 64, 1>;    // C <= 64: 8x32, 16 warps
using Tile128 = Tile<32, 4, 4, 4, 4, 64, 1>;   // C <= 128: 8x32, 16 warps
using Tile256 = Tile<16, 2, 8, 4, 4, 64, 1>;   // C <= 256: 8x16, 16 warps
using Tile512 = Tile<8, 1, 16, 4, 4, 32, 1>;   // C <= 512: 8x8, 16 warps

template <class L>
__global__ void __launch_bounds__(L::kThreads, L::MINB)
    leff_fwd_mma_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta,
                        const bf16* __restrict__ w1,
                        const bf16* __restrict__ b1,
                        const bf16* __restrict__ dw,
                        const bf16* __restrict__ dwb,
                        const bf16* __restrict__ w2,
                        const bf16* __restrict__ b2, bf16* __restrict__ out,
                        int H, int W, int C, int Ch, float eps, int fast_gelu,
                        int vec) {
  constexpr int KC = L::KC, HS = L::HS, NS = L::NS, NC = L::NC,
                NT = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Kp = (C + 15) / 16 * 16, XS = Kp + 8;
  bf16* sXn = reinterpret_cast<bf16*>(smem_raw);  // [HPP][XS] LN(x)
  bf16* sW1 = sXn + L::HPP * XS;                  // [Kp][HS] W1[:, chunk]
  bf16* sW2 = sW1 + Kp * HS;                      // [KC][NS] W2[chunk, :]
  bf16* sPar = sW2 + KC * NS;        // 2 x [kPar][KC]: b1, dw bias, taps
  bf16* sHid = sPar + 2 * L::kPar * KC;           // [HPP][HS] hidden chunk
  bf16* sG = sHid + L::HPP * HS;                  // [TP][HS] GELU(dwconv)
  unsigned char* sIn =
      reinterpret_cast<unsigned char*>(sG + L::TP * HS);  // [HPP] in image

  const int b = blockIdx.z, y0 = blockIdx.y * L::TH, x0 = blockIdx.x * L::TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (Ch + KC - 1) / KC;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // The chunk's copies (one cp.async group each), zero outside [C, Ch]:
  // P1(k): W1[:, chunk] and the chunk's b1, dw bias and taps (buffer k&1);
  // P2(k): W2[chunk, :].
  auto issue_p1 = [&](int k) {
    const int c0 = k * KC;
    bf16* par = sPar + (k & 1) * L::kPar * KC;
    copy_rows<KC, NT>(sW1, HS, w1 + c0, Ch, Kp, C, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par, KC, b1 + c0, 0, 1, 1, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par + KC, KC, dwb + c0, 0, 1, 1, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par + 2 * KC, KC, dw + c0, Ch, 9, 9, Ch - c0, vec,
                      tid);
    if (vec) cp_async_commit();
  };
  auto issue_p2 = [&](int k) {
    const int c0 = k * KC;
    copy_rows<NC, NT>(sW2, NS, w2 + static_cast<size_t>(c0) * C, C, KC,
                      Ch - c0, C, vec, tid);
    if (vec) cp_async_commit();
  };

  issue_p1(0);

  // 1. LayerNorm of the haloed tile into sXn, LG lanes per pixel (one at
  //    C <= 32: no shuffles), each lane holding 32 channels in four runs of
  //    8 (one 16-byte load each when vec); rows outside the image and
  //    padding rows are zero.
  {
    constexpr int G = L::LG, PPW = 32 / G;  // pixels per warp and pass
    const int sub = lane % G;
    for (int p0 = warp * PPW; p0 < L::HPP; p0 += L::kWarps * PPW) {
      const int p = p0 + lane / G;
      const int gy = y0 - 1 + p / L::PW, gx = x0 - 1 + p % L::PW;
      const bool in = p < L::HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      if (sub == 0 && p < L::HPP) sIn[p] = in;
      const bf16* xp =
          x + ((static_cast<size_t>(b) * H + (in ? gy : 0)) * W +
               (in ? gx : 0)) * C;
      float v[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = (j * G + sub) * 8;
        if (vec && in && c0 < C) {
          const uint4 q = *reinterpret_cast<const uint4*>(xp + c0);
          const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[j][i] = to_f(e[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[j][i] = in && c0 + i < C ? to_f(xp[c0 + i]) : 0.f;
          }
        }
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) s += v[j][i];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
      const float mu = s / C;
      float s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = (j * G + sub) * 8 + i < C ? v[j][i] - mu : 0.f;
          s2 += d * d;
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) s2 += __shfl_xor_sync(~0u, s2, o);
      const float rs = rsqrtf(s2 / C + eps);
      if (p < L::HPP) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c0 = (j * G + sub) * 8;
          if (c0 >= Kp) continue;
          uint4 q;
          bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = c0 + i;
            e[i] = in && c < C
                       ? from_f<bf16>((v[j][i] - mu) * rs * to_f(gamma[c]) +
                                      to_f(beta[c]))
                       : zero;
          }
          *reinterpret_cast<uint4*>(sXn + p * XS + c0) = q;
        }
      }
    }
  }

  // dense2's accumulator: warp (wm, wn) holds pixels of m-tiles wm*MW + i
  // and channels of n-tiles wn*NW + j, across all chunks.
  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[L::MW][L::NW][4];
#pragma unroll
  for (int i = 0; i < L::MW; ++i)
#pragma unroll
    for (int j = 0; j < L::NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Per chunk k, four barriers: A (P1(k) landed;
  // dense2(k-1) done, so the W2 buffer is free for P2(k)), B (dense1(k)
  // done, so the W1 buffer is free for P1(k+1)), G (GELU over the hidden
  // tile done), C (P2(k) landed, sG written). Each copy has at least a
  // phase of compute to land in.
  for (int k = 0; k < n_chunks; ++k) {
    const bf16* par = sPar + (k & 1) * L::kPar * KC;
    cp_async_wait_all();  // P1(k), this thread's copies
    __syncthreads();      // A
    issue_p2(k);

    // 2a. dense1 on the tensor cores: a warp per 16 pixels x 32 channels,
    //     one A fragment feeding four MMAs; + b1, rounded to bf16: the
    //     twin's first rounding point.
    for (int u = warp; u < L::HMT * (KC / 32); u += L::kWarps) {
      const int mt = u / (KC / 32), n0 = (u % (KC / 32)) * 32;
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
      const uint32_t a_addr =
          smem_addr(sXn + (mt * 16 + (lane & 15)) * XS + (lane >> 4) * 8);
      const uint32_t b_addr =
          smem_addr(sW1 + (lane & 15) * HS + n0 + (lane >> 4) * 8);
#pragma unroll 2
      for (int kk = 0; kk < Kp / 16; ++kk) {
        uint32_t a[4], b01[4], b23[4];
        ldsm_x4(a_addr + kk * 32, a);
        ldsm_x4_t(b_addr + kk * 16 * HS * 2, b01);
        ldsm_x4_t(b_addr + kk * 16 * HS * 2 + 32, b23);
        mma_bf16(d[0], a, b01[0], b01[1]);
        mma_bf16(d[1], a, b01[2], b01[3]);
        mma_bf16(d[2], a, b23[0], b23[1]);
        mma_bf16(d[3], a, b23[2], b23[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + (lane >> 2) + h * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = n0 + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(sHid + p * HS + cl) =
              __floats2bfloat162_rn(d[j][2 * h] + to_f(par[cl]),
                                    d[j][2 * h + 1] + to_f(par[cl + 1]));
        }
      }
    }
    __syncthreads();  // B
    if (k + 1 < n_chunks) issue_p1(k + 1);

    // 2b. GELU over the haloed hidden tile by all threads, zero outside the
    //     image (the conv's SAME padding sees zeros).
    for (int e = tid; e < L::HP * (KC / 2); e += NT) {
      const int p = e / (KC / 2), cl = 2 * (e % (KC / 2));
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(sHid + p * HS +
                                                             cl);
      const float2 hv = __bfloat1622float2(*hp);
      *hp = sIn[p] ? __floats2bfloat162_rn(gelu(hv.x, fast_gelu),
                                           gelu(hv.y, fast_gelu))
                   : __floats2bfloat162_rn(0.f, 0.f);
    }
    __syncthreads();  // G

    // 2c. depthwise 3x3 (VALID over the halo) + bias + GELU, two channels
    //     per thread (a fixed pair, so its taps stay in registers).
    {
      constexpr int kPairs = KC / 2;
      const int cl = 2 * (tid % kPairs);
      float k0[9], k1[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        k0[t] = to_f(par[(2 + t) * KC + cl]);
        k1[t] = to_f(par[(2 + t) * KC + cl + 1]);
      }
      const float db0 = to_f(par[KC + cl]), db1 = to_f(par[KC + cl + 1]);
      for (int t = tid / kPairs; t < L::TP; t += NT / kPairs) {
        const int r = t / L::TW, c = t % L::TW;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    sHid + ((r + di) * L::PW + c + dj) * HS + cl));
            a0 = fmaf(hv.x, k0[di * 3 + dj], a0);
            a1 = fmaf(hv.y, k1[di * 3 + dj], a1);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(sG + t * HS + cl) =
            __floats2bfloat162_rn(
                gelu(round_to<bf16>(a0 + db0), fast_gelu),
                gelu(round_to<bf16>(a1 + db1), fast_gelu));
      }
    }
    // P2(k) landed: the newest group, P1(k+1), may still be in flight.
    if (k + 1 < n_chunks) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // C

    // 2d. this chunk's share of dense2 into the register accumulator.
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[L::MW][4];
#pragma unroll
      for (int i = 0; i < L::MW; ++i) {
        ldsm_x4(smem_addr(sG + ((wm * L::MW + i) * 16 + (lane & 15)) * HS +
                          kk * 16 + (lane >> 4) * 8),
                a[i]);
      }
#pragma unroll
      for (int j = 0; j < L::NW; j += 2) {
        uint32_t bq[4];
        ldsm_x4_t(smem_addr(sW2 + (kk * 16 + (lane & 15)) * NS +
                            (wn * L::NW + j) * 8 + (lane >> 4) * 8),
                  bq);
#pragma unroll
        for (int i = 0; i < L::MW; ++i) {
          mma_bf16(acc[i][j], a[i], bq[0], bq[1]);
          mma_bf16(acc[i][j + 1], a[i], bq[2], bq[3]);
        }
      }
    }
  }

  // 3. + b2, round, store the tile.
#pragma unroll
  for (int i = 0; i < L::MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = (wm * L::MW + i) * 16 + (lane >> 2) + h * 8;
      const int gy = y0 + t / L::TW, gx = x0 + t % L::TW;
      if (gy >= H || gx >= W) continue;
      bf16* o = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < L::NW; ++j) {
        const int n = (wn * L::NW + j) * 8 + (lane & 3) * 2;
        if (n < C) o[n] = from_f<bf16>(acc[i][j][2 * h] + to_f(b2[n]));
        if (n + 1 < C) {
          o[n + 1] = from_f<bf16>(acc[i][j][2 * h + 1] + to_f(b2[n + 1]));
        }
      }
    }
  }
}

template <class L>
int launch_mma(const void* x, const void* gamma, const void* beta,
               const void* w1, const void* b1, const void* dw,
               const void* dwb, const void* w2, const void* b2, void* out,
               int B, int H, int W, int C, int Ch, float eps, int fast_gelu,
               cudaStream_t stream) {
  const size_t smem = L::smem_bytes(C);
  auto kernel = leff_fwd_mma_kernel<L>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w2) |
                        reinterpret_cast<uintptr_t>(b1) |
                        reinterpret_cast<uintptr_t>(dw) |
                        reinterpret_cast<uintptr_t>(dwb);
  const int vec = C % 8 == 0 && Ch % 8 == 0 && any % 16 == 0;
  dim3 grid((W + L::TW - 1) / L::TW, (H + L::TH - 1) / L::TH, B);
  kernel<<<grid, L::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(dw),
      static_cast<const bf16*>(dwb), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), H, W, C, Ch,
      eps, fast_gelu, vec);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 class of C, and its smem for C, if (TH, TW) is that class's
// tile; -1 otherwise.
long mma_smem_bytes(int C, int TH, int TW) {
  if (TH != 8 || C < 1) return -1;
  if (C <= 32) return TW == Tile32::TW ? Tile32::smem_bytes(C) : -1;
  if (C <= 64) return TW == Tile64::TW ? Tile64::smem_bytes(C) : -1;
  if (C <= 128) return TW == Tile128::TW ? Tile128::smem_bytes(C) : -1;
  if (C <= 256) return TW == Tile256::TW ? Tile256::smem_bytes(C) : -1;
  if (C <= 512) return TW == Tile512::TW ? Tile512::smem_bytes(C) : -1;
  return -1;
}

}  // namespace

extern "C" {

// Shared memory the kernel allocates for this plan, in bytes; -1 if the
// plan is not one the kernel takes. dtype: 0 = float32, 1 = bfloat16.
long leff_smem_bytes(int dtype, int C, int TH, int TW) {
  if (dtype == 0) return static_cast<long>(f32_smem_bytes(C, TH, TW));
  return mma_smem_bytes(C, TH, TW);
}

// dtype: 0 = float32, 1 = bfloat16. x/out: [B, H, W, C] contiguous;
// gamma/beta/b2: [C]; w1: [C, Ch]; b1/dwb: [Ch]; dw: [9, Ch]; w2: [Ch, C];
// all of the activation type. Any H and W: the last row and column tiles
// are ragged (pixels past the image load as zero, the conv's halo, and are
// never stored). The tile (TH, TW) is the wrapper's plan (for bf16, the
// class of C). Returns cudaGetLastError().
int leff_fwd(int dtype, const void* x, const void* gamma, const void* beta,
             const void* w1, const void* b1, const void* dw, const void* dwb,
             const void* w2, const void* b2, void* out, int B, int H, int W,
             int C, int Ch, int TH, int TW, float eps, int fast_gelu,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = f32_smem_bytes(C, TH, TW);
    cudaError_t e = cudaFuncSetAttribute(
        leff_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    leff_fwd_f32_kernel<<<grid, kF32Threads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(dw),
        static_cast<const float*>(dwb), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, Ch,
        TH, TW, eps, fast_gelu);
    return static_cast<int>(cudaGetLastError());
  }
  if (mma_smem_bytes(C, TH, TW) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define LEFF_LAUNCH(L)                                                      \
  return launch_mma<L>(x, gamma, beta, w1, b1, dw, dwb, w2, b2, out, B, H, \
                       W, C, Ch, eps, fast_gelu, s)
  if (C <= 32) LEFF_LAUNCH(Tile32);
  if (C <= 64) LEFF_LAUNCH(Tile64);
  if (C <= 128) LEFF_LAUNCH(Tile128);
  if (C <= 256) LEFF_LAUNCH(Tile256);
  LEFF_LAUNCH(Tile512);
#undef LEFF_LAUNCH
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
