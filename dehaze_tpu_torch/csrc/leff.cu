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
//
// act_store (mode 1 fp8, 2 int8; 0 none): the LeWin block's --act_store
// round trips that fall inside LeFF (dehaze_tpu/models/uformer.py:383,393,
// dehaze_tpu/models/layers.py:154,158): the LN output, the hidden after
// each GELU and the output, each right after its rounding to T, as the twin
// applies ops/actstore.compress. Both kernels do them (the bf16 one is
// compiled once per mode, so the plain kernel keeps its registers); nothing
// of the hidden reaches HBM.
//   - fp8 is elementwise (fp8_trip): e4m3 without saturation, so |v| > 464,
//     inf and NaN read back as NaN, as JAX's cast does.
//   - int8 scales each pixel by the amax of its values over the channel
//     axis (i8_scale, i8_trip). The LN output's amax is a reduction over
//     the lanes of its pixel; the output's over the quad and the warps that
//     hold the pixel's channels (an atomicMax in shared memory, after the
//     chunk loop). The two hidden tensors span every chunk of the hidden
//     width, so their amax is known only after the last chunk. The design
//     is the simple one that is right: the chunk loop runs three sweeps.
//     Sweep 0 computes dense1 + GELU and takes each haloed pixel's amax;
//     sweep 1 recomputes them, quantizes with it, runs the dwconv + GELU
//     and takes each output pixel's amax; sweep 2 recomputes both,
//     quantizes both and runs dense2. dense1 runs three times and the
//     dwconv twice. A halo pixel gets its own amax over its whole hidden
//     width, as in the tile that owns it. Keeping a whole hidden tile in
//     shared memory instead would fit only at C <= 64. The amaxes are kept
//     as the bits of |v| (ints order them as floats, and NaN's bits exceed
//     inf's, so a NaN propagates as torch's amax propagates it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

constexpr int kFp8 = 1, kInt8 = 2;  // act_store modes

// v read back from its e4m3 storage: nearest, ties to even; no saturation,
// so |v| > 464 (448 plus half a step), inf and NaN give NaN.
__device__ __forceinline__ float fp8_trip(float v) {
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
}

// The bits of |v|: as ints they order as the floats, NaN above inf.
__device__ __forceinline__ int abs_bits(float v) {
  return __float_as_int(fabsf(v));
}

// Max of m over aligned groups of `width` lanes (a power of two <= 32).
__device__ __forceinline__ int group_max(int m, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// The int8 scale of a pixel whose amax bits are `bits`: max(amax, 1e-8) /
// 127 rounded to T (a NaN amax stays NaN, as in torch's clamp_min).
template <typename T>
__device__ __forceinline__ float i8_scale(int bits) {
  const float amax = __int_as_float(bits), tiny = round_to<T>(1e-8f);
  return round_to<T>(__fdiv_rn(amax < tiny ? tiny : amax, 127.f));
}

// v read back from its int8 storage at `scale`: round(v / scale) with
// v / scale rounded to T first, ties to even, clipped to +-127 (NaN to 0,
// as JAX casts it), times scale rounded to T.
template <typename T>
__device__ __forceinline__ float i8_trip(float v, float scale) {
  float q = rintf(round_to<T>(__fdiv_rn(v, scale)));
  q = q != q ? 0.f : fminf(fmaxf(q, -127.f), 127.f);
  return round_to<T>(q * scale);
}

// LayerNorm of pixel row xp (C values) by one warp, each value rounded to T
// and round-tripped by `mode`; writes them to dst[0..C), zeros to
// dst[C..Kp).
template <typename T>
__device__ __forceinline__ void layer_norm_row(const T* xp, const T* gamma,
                                               const T* beta, T* dst, int C,
                                               int Kp, float eps, int lane,
                                               int mode) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xp[c]);
  const float mu = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xp[c]) - mu;
    s2 += d * d;
  }
  const float rs = rsqrtf(warp_sum(s2) / C + eps);
  int m = 0;
  for (int c = lane; c < Kp; c += 32) {
    float y = c < C ? round_to<T>((to_f(xp[c]) - mu) * rs * to_f(gamma[c]) +
                                  to_f(beta[c]))
                    : 0.f;
    if (mode == kFp8) y = fp8_trip(y);
    m = max(m, abs_bits(y));
    dst[c] = from_f<T>(y);
  }
  if (mode != kInt8) return;
  const float scale = i8_scale<T>(group_max(m, 32));
  for (int c = lane; c < C; c += 32) {
    dst[c] = from_f<T>(i8_trip<T>(to_f(dst[c]), scale));
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
    int C, int Ch, int TH, int TW, float eps, int fast_gelu, int mode) {
  extern __shared__ float smem[];
  const int PW = TW + 2;               // haloed tile width
  const int HP = (TH + 2) * PW;        // haloed pixels
  const int TP = TH * TW;              // output pixels
  float* sOut = smem;                  // [TP][C] dense2 accumulator
  float* sHid = sOut + TP * C;         // [HP][kF32Chunk] GELU(dense1) chunk
  float* sG = sHid + HP * kF32Chunk;   // [TP][kF32Chunk] GELU(dwconv) chunk
  float* sXn = sG + TP * kF32Chunk;    // [HP][C]
  int* sMax1 = reinterpret_cast<int*>(sXn + HP * C);  // [HP] int8: GELU1's
  int* sMax2 = sMax1 + HP;             // [TP] int8: GELU2's, then the output's
  unsigned char* sIn = reinterpret_cast<unsigned char*>(sMax2 + TP);  // [HP]

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
                   gamma, beta, sXn + p * C, C, C, eps, lane, mode);
  }
  for (int e = tid; e < TP * C; e += kF32Threads) sOut[e] = 0.f;
  for (int e = tid; e < HP + TP; e += kF32Threads) sMax1[e] = 0;
  __syncthreads();

  // The chunks of the hidden width, once, or in three sweeps for int8 (see
  // the header): a warp keeps its pixels in every step, so the amaxes are
  // its own to update.
  const int n_chunks = (Ch + kF32Chunk - 1) / kF32Chunk;
  const int n_sweeps = mode == kInt8 ? 3 : 1;
  for (int v = 0; v < n_sweeps * n_chunks; ++v) {
    const int c0 = (v % n_chunks) * kF32Chunk, sweep = v / n_chunks;
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
      if (mode == kFp8) {
        g = fp8_trip(g);
      } else if (mode == kInt8 && sweep == 0) {
        const int m = group_max(abs_bits(g), 32);
        if (lane == 0) sMax1[p] = max(sMax1[p], m);
      } else if (mode == kInt8) {
        g = i8_trip<float>(g, i8_scale<float>(sMax1[p]));
      }
      sHid[p * kF32Chunk + lane] = g;
    }
    __syncthreads();
    if (mode == kInt8 && sweep == 0) continue;

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
      if (mode == kFp8) {
        g = fp8_trip(g);
      } else if (mode == kInt8 && sweep == 1) {
        const int m = group_max(abs_bits(g), 32);
        if (lane == 0) sMax2[t] = max(sMax2[t], m);
      } else if (mode == kInt8) {
        g = i8_trip<float>(g, i8_scale<float>(sMax2[t]));
      }
      sG[t * kF32Chunk + lane] = g;
    }
    __syncthreads();
    if (sweep + 1 < n_sweeps) continue;

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

  // 3. + b2, the output's round trip, store the tile. int8: a warp per
  //    pixel takes its amax over C (into sMax2, free once the last 2b is
  //    done).
  for (int e = tid; e < TP * C; e += kF32Threads) {
    const float y = sOut[e] + b2[e % C];
    sOut[e] = mode == kFp8 ? fp8_trip(y) : y;
  }
  if (mode == kInt8) {
    __syncthreads();
    for (int t = warp; t < TP; t += kF32Warps) {
      int m = 0;
      for (int n = lane; n < C; n += 32) m = max(m, abs_bits(sOut[t * C + n]));
      m = group_max(m, 32);
      if (lane == 0) sMax2[t] = m;
    }
    __syncthreads();
  }
  for (int e = tid; e < TP * C; e += kF32Threads) {
    const int t = e / C, n = e - t * C;
    const int gy = y0 + t / TW, gx = x0 + t % TW;
    if (gy < H && gx < W) {
      out[((static_cast<size_t>(b) * H + gy) * W + gx) * C + n] =
          mode == kInt8 ? i8_trip<float>(sOut[e], i8_scale<float>(sMax2[t]))
                        : sOut[e];
    }
  }
}

size_t f32_smem_bytes(int C, int TH, int TW) {
  const size_t HP = (TH + 2) * (TW + 2), TP = TH * TW;
  return (TP * C + HP * kF32Chunk + TP * kF32Chunk + HP * C) * sizeof(float) +
         (HP + TP) * sizeof(int) + HP;
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
  static_assert(HP * (KC / 2) % 32 == 0, "GELU pass: whole warps");

  // Shared memory in bytes for K = C padded to 16: bf16 tiles whose rows
  // are padded by 8 elements (16 bytes, which keeps ldmatrix free of bank
  // conflicts): LN tile, W1 chunk, W2 chunk (one buffer each: their copies
  // are staggered, see the kernel), two buffers of the chunk's parameters,
  // the hidden tile and dense2's A; the int8 amaxes of the haloed and the
  // output pixels (an int each); a byte per haloed pixel (in the image or
  // not).
  static size_t smem_bytes(int C) {
    const size_t Kp = (C + 15) / 16 * 16;
    return 2 * (HPP * (Kp + 8) + Kp * HS + KC * NS + 2 * kPar * KC +
                HPP * HS + TP * HS) +
           4 * (HPP + TP) + HPP;
  }
};

// The classes, by the largest C each takes (must match plan_tile).
using Tile32 = Tile<32, 8, 1, 2, 4, 32, 2>;    // C <= 32: 8x32, 8 warps
using Tile64 = Tile<32, 8, 2, 2, 4, 64, 1>;    // C <= 64: 8x32, 16 warps
using Tile128 = Tile<32, 4, 4, 4, 4, 64, 1>;   // C <= 128: 8x32, 16 warps
using Tile256 = Tile<16, 2, 8, 4, 4, 64, 1>;   // C <= 256: 8x16, 16 warps
using Tile512 = Tile<8, 1, 16, 4, 4, 32, 1>;   // C <= 512: 8x8, 16 warps

// MODE is the act_store mode (a template argument, so that the plain
// kernel carries none of the round trips' registers).
template <class L, int MODE>
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
                NT = L::kThreads, mode = MODE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Kp = (C + 15) / 16 * 16, XS = Kp + 8;
  bf16* sXn = reinterpret_cast<bf16*>(smem_raw);  // [HPP][XS] LN(x)
  bf16* sW1 = sXn + L::HPP * XS;                  // [Kp][HS] W1[:, chunk]
  bf16* sW2 = sW1 + Kp * HS;                      // [KC][NS] W2[chunk, :]
  bf16* sPar = sW2 + KC * NS;        // 2 x [kPar][KC]: b1, dw bias, taps
  bf16* sHid = sPar + 2 * L::kPar * KC;           // [HPP][HS] hidden chunk
  bf16* sG = sHid + L::HPP * HS;                  // [TP][HS] GELU(dwconv)
  int* sMax1 = reinterpret_cast<int*>(sG + L::TP * HS);  // [HPP] int8 amaxes
  int* sMax2 = sMax1 + L::HPP;                            // [TP]
  unsigned char* sIn =
      reinterpret_cast<unsigned char*>(sMax2 + L::TP);  // [HPP] in image

  const int b = blockIdx.z, y0 = blockIdx.y * L::TH, x0 = blockIdx.x * L::TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (Ch + KC - 1) / KC;
  // the chunk loop's steps: the chunks once, or three sweeps over them for
  // int8 (see the header)
  constexpr int n_sweeps = mode == kInt8 ? 3 : 1;
  const int n_steps = n_sweeps * n_chunks;

  // Step v's copies (one cp.async group each), zero outside [C, Ch], for
  // its chunk k = v % n_chunks: P1(v): W1[:, chunk] and the chunk's b1, dw
  // bias and taps (buffer v&1); P2(v): W2[chunk, :].
  auto issue_p1 = [&](int v) {
    const int c0 = (v % n_chunks) * KC;
    bf16* par = sPar + (v & 1) * L::kPar * KC;
    copy_rows<KC, NT>(sW1, HS, w1 + c0, Ch, Kp, C, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par, KC, b1 + c0, 0, 1, 1, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par + KC, KC, dwb + c0, 0, 1, 1, Ch - c0, vec, tid);
    copy_rows<KC, NT>(par + 2 * KC, KC, dw + c0, Ch, 9, 9, Ch - c0, vec,
                      tid);
    if (vec) cp_async_commit();
  };
  auto issue_p2 = [&](int v) {
    const int c0 = (v % n_chunks) * KC;
    copy_rows<NC, NT>(sW2, NS, w2 + static_cast<size_t>(c0) * C, C, KC,
                      Ch - c0, C, vec, tid);
    if (vec) cp_async_commit();
  };

  issue_p1(0);
  for (int e = tid; e < L::HPP + L::TP; e += NT) sMax1[e] = 0;

  // 1. LayerNorm of the haloed tile into sXn, LG lanes per pixel (one at
  //    C <= 32: no shuffles), each lane holding 32 channels in four runs of
  //    8 (one 16-byte load each when vec); rows outside the image and
  //    padding rows are zero. Then its round trip (int8: the pixel's amax
  //    over its LG lanes).
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
      int m = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = (j * G + sub) * 8 + i;
          float y = in && c < C
                        ? round_to<bf16>((v[j][i] - mu) * rs * to_f(gamma[c]) +
                                         to_f(beta[c]))
                        : 0.f;
          if (mode == kFp8) y = fp8_trip(y);
          m = max(m, abs_bits(y));
          v[j][i] = y;
        }
      }
      if (mode == kInt8) {
        const float scale = i8_scale<bf16>(group_max(m, G));
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i) v[j][i] = i8_trip<bf16>(v[j][i], scale);
      }
      if (p < L::HPP) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c0 = (j * G + sub) * 8;
          if (c0 >= Kp) continue;
          uint4 q;
          bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = from_f<bf16>(v[j][i]);
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

  // Per step v, four barriers: A (P1(v) landed;
  // dense2(v-1) done, so the W2 buffer is free for P2(v)), B (dense1(v)
  // done, so the W1 buffer is free for P1(v+1)), G (GELU over the hidden
  // tile done), C (P2(v) landed, sG written). Each copy has at least a
  // phase of compute to land in. The int8 sweeps 0 and 1 stop after G and
  // after the dwconv, and issue no P2.
  for (int v = 0; v < n_steps; ++v) {
    const int sweep = v / n_chunks;
    const bool last = sweep + 1 == n_sweeps;  // the sweep that runs dense2
    const bf16* par = sPar + (v & 1) * L::kPar * KC;
    cp_async_wait_all();  // P1(v), this thread's copies
    __syncthreads();      // A
    if (last) issue_p2(v);

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
    if (v + 1 < n_steps) issue_p1(v + 1);

    // 2b. GELU over the haloed hidden tile by all threads, zero outside the
    //     image (the conv's SAME padding sees zeros), rounded, then its
    //     round trip. The KC/2 threads of a pixel are an aligned group of
    //     lanes (HP * KC/2 is a multiple of 32: every lane runs every pass).
    for (int e = tid; e < L::HP * (KC / 2); e += NT) {
      const int p = e / (KC / 2), cl = 2 * (e % (KC / 2));
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(sHid + p * HS +
                                                             cl);
      const float2 hv = __bfloat1622float2(*hp);
      float g0 = 0.f, g1 = 0.f;
      if (sIn[p]) {
        g0 = round_to<bf16>(gelu(hv.x, fast_gelu));
        g1 = round_to<bf16>(gelu(hv.y, fast_gelu));
      }
      if (mode == kFp8) {
        g0 = fp8_trip(g0);
        g1 = fp8_trip(g1);
      } else if (mode == kInt8 && sweep == 0) {
        const int m = group_max(max(abs_bits(g0), abs_bits(g1)), KC / 2);
        if (cl == 0) atomicMax(sMax1 + p, m);
      } else if (mode == kInt8) {
        const float scale = i8_scale<bf16>(sMax1[p]);
        g0 = i8_trip<bf16>(g0, scale);
        g1 = i8_trip<bf16>(g1, scale);
      }
      *hp = __floats2bfloat162_rn(g0, g1);
    }
    __syncthreads();  // G
    if (mode == kInt8 && sweep == 0) continue;

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
      // the kPairs threads of an output pixel are an aligned group of lanes,
      // and every lane runs every pass (TP is a multiple of NT / kPairs)
      static_assert(L::TP % (NT / kPairs) == 0, "dwconv: whole passes");
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
        float g0 = round_to<bf16>(gelu(round_to<bf16>(a0 + db0), fast_gelu));
        float g1 = round_to<bf16>(gelu(round_to<bf16>(a1 + db1), fast_gelu));
        if (mode == kFp8) {
          g0 = fp8_trip(g0);
          g1 = fp8_trip(g1);
        } else if (mode == kInt8 && sweep == 1) {
          const int m = group_max(max(abs_bits(g0), abs_bits(g1)), kPairs);
          if (cl == 0) atomicMax(sMax2 + t, m);
        } else if (mode == kInt8) {
          const float scale = i8_scale<bf16>(sMax2[t]);
          g0 = i8_trip<bf16>(g0, scale);
          g1 = i8_trip<bf16>(g1, scale);
        }
        *reinterpret_cast<__nv_bfloat162*>(sG + t * HS + cl) =
            __floats2bfloat162_rn(g0, g1);
      }
    }
    if (!last) continue;  // int8 sweep 1: its amaxes are in for sweep 2
    // P2(v) landed: the newest group, P1(v+1), may still be in flight.
    if (v + 1 < n_steps) {
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

  // 3. + b2, rounded, the output's round trip, store the tile. int8: a
  //    pixel's channels lie in a quad of lanes of each of the WN warps of
  //    its row, so its amax is a quad reduction, then an atomicMax into
  //    sMax2 (free: every thread is past the last dwconv's reads of it).
  auto out_val = [&](int i, int j, int e, int n) {
    const float y = n < C ? round_to<bf16>(acc[i][j][e] + to_f(b2[n])) : 0.f;
    return mode == kFp8 ? fp8_trip(y) : y;
  };
  if (mode == kInt8) {
    for (int e = tid; e < L::TP; e += NT) sMax2[e] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < L::MW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = (wm * L::MW + i) * 16 + (lane >> 2) + h * 8;
        int m = 0;
#pragma unroll
        for (int j = 0; j < L::NW; ++j) {
          const int n = (wn * L::NW + j) * 8 + (lane & 3) * 2;
          m = max(m, max(abs_bits(out_val(i, j, 2 * h, n)),
                         abs_bits(out_val(i, j, 2 * h + 1, n + 1))));
        }
        m = group_max(m, 4);
        if ((lane & 3) == 0) atomicMax(sMax2 + t, m);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < L::MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = (wm * L::MW + i) * 16 + (lane >> 2) + h * 8;
      const int gy = y0 + t / L::TW, gx = x0 + t % L::TW;
      if (gy >= H || gx >= W) continue;
      const float scale = mode == kInt8 ? i8_scale<bf16>(sMax2[t]) : 0.f;
      bf16* o = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < L::NW; ++j) {
        const int n = (wn * L::NW + j) * 8 + (lane & 3) * 2;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (n + u >= C) continue;
          const float y = out_val(i, j, 2 * h + u, n + u);
          o[n + u] = from_f<bf16>(mode == kInt8 ? i8_trip<bf16>(y, scale) : y);
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
               int mode, cudaStream_t stream) {
  const size_t smem = L::smem_bytes(C);
  auto kernel = mode == kInt8  ? leff_fwd_mma_kernel<L, kInt8>
                : mode == kFp8 ? leff_fwd_mma_kernel<L, kFp8>
                               : leff_fwd_mma_kernel<L, 0>;
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
// class of C). act_store: 0 none, 1 fp8, 2 int8 (the header); another
// value is refused. Returns cudaGetLastError().
int leff_fwd(int dtype, const void* x, const void* gamma, const void* beta,
             const void* w1, const void* b1, const void* dw, const void* dwb,
             const void* w2, const void* b2, void* out, int B, int H, int W,
             int C, int Ch, int TH, int TW, float eps, int fast_gelu,
             int act_store, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_store < 0 || act_store > kInt8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
        TH, TW, eps, fast_gelu, act_store);
    return static_cast<int>(cudaGetLastError());
  }
  if (mma_smem_bytes(C, TH, TW) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define LEFF_LAUNCH(L)                                                      \
  return launch_mma<L>(x, gamma, beta, w1, b1, dw, dwb, w2, b2, out, B, H, \
                       W, C, Ch, eps, fast_gelu, act_store, s)
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
