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
// at C = 256 (1.41), 8x8 at C = 512 (1.56), each within 227 KB. int8 has
// classes of its own, picked per C and Ch (below).
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
//   - fp8 is elementwise (fp8_trip2, on pairs): the e4m3 converts of
//     sm_89+ there and back, which saturate at +-448, then a select that
//     gives NaN where |v| > 464, inf or NaN, as JAX's cast does (464 itself
//     ties to 448). A few instructions a value, against the erf GELU's
//     tens. `leff_fp8_trip` applies it to a buffer, so that the card can
//     hold it to ops/actstore.compress on every bit pattern.
//   - int8 scales each pixel by the amax of its values over the channel
//     axis (i8_scale, i8_trip). The LN output's amax is a reduction over
//     the lanes of its pixel; the output's over the quad and the warps that
//     hold the pixel's channels (an atomicMax in shared memory, after
//     dense2). Each hidden tensor spans the whole hidden width, so its
//     amaxes are known only after the last chunk. int8's own classes
//     (I8Tile*) keep what fits of the hidden in shared memory, in bf16
//     (its values are rounded to bf16 before their round trip, so that is
//     exact), and compute each quantity as few times as that room allows:
//       one pass (R = 1; C <= 64 at Ch = 4C; 8x32 tiles up to C = 32,
//         8x16 to 64): hidden1 (the haloed tile after GELU1) and hidden2
//         (the output pixels after GELU2) both whole: dense1 + GELU1 over
//         every chunk with each haloed pixel's amax; hidden1 quantized in
//         place; dwconv + GELU2 over every chunk with each output pixel's
//         amax; hidden2 quantized in place; dense2 over every chunk. Each
//         runs once, as in the plain kernel.
//       two sweeps (R = 2; C = 128 at 8x16, C = 256 at 8x8): hidden2 whole,
//         hidden1 a chunk: sweep 0 runs dense1 + GELU1 for the amaxes
//         alone, sweep 1 runs them again, quantizes the chunk and runs its
//         dwconv + GELU2 into hidden2; then as above. dense1 twice, the
//         dwconv once.
//       three sweeps (where neither fits: C = 512, or a wide Ch), in the
//         class of every mode: sweep 0 runs dense1 + GELU1 for hidden1's
//         amaxes, sweep 1 again with the dwconv + GELU2 for hidden2's,
//         sweep 2 all of it again, quantized, and dense2. dense1 three
//         times, the dwconv twice.
//     In its own classes, the LN tile's room takes two W2 chunk buffers
//     once dense1 is done, so dense2's copies land during the previous
//     chunk's MMAs; a thread keeps the same pixels in every chunk, so it
//     takes their amaxes as running maxima in registers, reduced over the
//     pixel's lanes once after the last chunk (no atomics). Every bf16
//     round trip divides as a product with the scale's reciprocal and a
//     remainder step (i8_trip_rcp, exact). Every design computes each
//     value from the same inputs
//     in the same order (dense1's and dense2's k-order does not depend on
//     the chunk width or the tile), so the three give the same bits. A
//     halo pixel gets its own amax over its whole hidden width, as in the
//     tile that owns it. The amaxes are kept as the bits of |v| (ints order
//     them as floats, and NaN's bits exceed inf's, so a NaN propagates as
//     torch's amax propagates it); once complete, each is replaced in place
//     by its pixel's scale.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
constexpr float kFp8NanAbove = 464.f;  // = actstore.FP8_NAN_ABOVE

// a and b read back from their e4m3 storage: nearest, ties to even,
// subnormals included; |v| > 464 (448 plus half a step), inf and NaN give
// NaN, as JAX's cast does. On the hardware converts of sm_89+, a pair at a
// time: cvt.rn.satfinite.e4m3x2.f32 there (b into the high byte, a into
// the low), cvt.rn.f16x2.e4m3x2 back (exact: every e4m3 value is an f16
// value). satfinite clamps whatever lies beyond 448, inf included, to
// +-448, so the select puts the NaNs back.
__device__ __forceinline__ void fp8_trip2(float& a, float& b) {
  unsigned short q;
  unsigned int h;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(q) : "f"(b), "f"(a));
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(q));
  __half2_raw raw;
  raw.x = static_cast<unsigned short>(h & 0xffffu);
  raw.y = static_cast<unsigned short>(h >> 16);
  const float2 r = __half22float2(__half2(raw));
  const float nan = __int_as_float(0x7fc00000);
  a = fabsf(a) <= kFp8NanAbove ? r.x : nan;
  b = fabsf(b) <= kFp8NanAbove ? r.y : nan;
}

// fp8_trip2 of one value.
__device__ __forceinline__ float fp8_trip(float v) {
  float unused = 0.f;
  fp8_trip2(v, unused);
  return v;
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

// i8_trip bit for bit (the bf16 kernels' int8 round trips; the float32
// kernel keeps i8_trip), with the division as a product: inv is the correctly
// rounded 1 / scale (__frcp_rn), q0 = v * inv, and one remainder step
// q1 = q0 + (v - q0 * scale) * inv in two fmas gives v / scale correctly
// rounded (Markstein's theorem; a scale of inf or NaN gives NaN in both).
// A zero quotient takes v's sign, as the division gives it (the fmas give
// -0 + 0 = +0). A few instructions against __fdiv_rn's tens;
// chip_smoke.py's phase_k2_trips holds it to the division on every bf16
// value and scale.
template <typename T>
__device__ __forceinline__ float i8_trip_rcp(float v, float scale,
                                             float inv) {
  const float q0 = __fmul_rn(v, inv);
  const float q1 = copysignf(fmaf(fmaf(-q0, scale, v), inv, q0), v);
  float q = rintf(round_to<T>(q1));
  q = q != q ? 0.f : fminf(fmaxf(q, -127.f), 127.f);
  return round_to<T>(q * scale);
}

// Each of n amaxes (the bits of |v|) replaced in place by its pixel's int8
// scale, and that scale's reciprocal into inv if given, by threads tid,
// tid + nt, ...
__device__ __forceinline__ void amax_to_scale(int* m, int n, int tid, int nt,
                                              float* inv = nullptr) {
  for (int p = tid; p < n; p += nt) {
    const float scale = i8_scale<bf16>(m[p]);
    reinterpret_cast<float*>(m)[p] = scale;
    if (inv) inv[p] = __frcp_rn(scale);
  }
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

// cp.async: this thread's copies but its newest group have landed.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy a chunk's parameters (KC hidden channels from c0): b1, the dw bias
// and the 9 taps, as rows 0, 1 and 2-10 of par (row stride ps), zero past
// Ch; by cp.async when vec (the caller commits).
template <int KC, int NT>
__device__ __forceinline__ void copy_par(bf16* par, int ps, const bf16* b1,
                                         const bf16* dwb, const bf16* dw,
                                         int c0, int Ch, int vec, int tid) {
  copy_rows<KC, NT>(par, ps, b1 + c0, 0, 1, 1, Ch - c0, vec, tid);
  copy_rows<KC, NT>(par + ps, ps, dwb + c0, 0, 1, 1, Ch - c0, vec, tid);
  copy_rows<KC, NT>(par + 2 * ps, ps, dw + c0, Ch, 9, 9, Ch - c0, vec, tid);
}

// A tile class: output tile 8 x TW; warps WM x WN, each holding MW x NW
// dense2 fragments (16 pixels x 8 channels each); hidden chunk KC; MINB
// CTAs per SM. R is the int8 design of the classes only int8 runs (the
// header): 0 for the classes of every mode (int8 in three sweeps), 1 one
// pass, 2 two sweeps.
template <int TW_, int WM_, int WN_, int MW_, int NW_, int KC_, int MINB_,
          int R_ = 0>
struct Tile {
  static constexpr int TH = 8, TW = TW_, WM = WM_, WN = WN_, MW = MW_,
                       NW = NW_, KC = KC_, MINB = MINB_, R = R_;
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

  // Shared memory in bytes for K = C padded to 16 and hidden width Ch:
  // bf16 tiles whose rows are padded by 8 elements (16 bytes, which keeps
  // ldmatrix free of bank conflicts), then the int8 amaxes of the haloed
  // and the output pixels (an int each; R > 0: and the reciprocals of
  // their scales) and a byte per haloed pixel (in the image or not).
  // R = 0: the LN tile, W1 chunk, W2 chunk (one buffer each: their copies
  // are staggered, see the kernel), two buffers of the chunk's parameters,
  // the hidden tile and dense2's A. R > 0 (Ch padded to KC): the LN tile
  // (later two W2 chunk buffers), the W1 chunk, the parameters (all of
  // them for one pass, two chunks' for two sweeps), hidden1 (whole or a
  // chunk) and hidden2 (whole).
  static size_t smem_bytes(int C, int Ch) {
    const size_t Kp = (C + 15) / 16 * 16;
    if (R == 0) {
      return 2 * (HPP * (Kp + 8) + Kp * HS + KC * NS + 2 * kPar * KC +
                  HPP * HS + TP * HS) +
             4 * (HPP + TP) + HPP;
    }
    const size_t ChP = (Ch + KC - 1) / KC * KC, HSW = ChP + 8;
    const size_t xn = HPP * (Kp + 8) > 2 * KC * NS ? HPP * (Kp + 8)
                                                    : 2 * KC * NS;
    return 2 * (xn + Kp * HS + (R == 1 ? kPar * ChP : 2 * kPar * KC) +
                HPP * (R == 1 ? HSW : HS) + TP * HSW) +
           8 * (HPP + TP) + HPP;
  }
};

// The classes of every mode, by the largest C each takes (must match
// plan_tile's _MMA_CLASSES).
using Tile32 = Tile<32, 8, 1, 2, 4, 32, 2>;    // C <= 32: 8x32, 8 warps
using Tile64 = Tile<32, 8, 2, 2, 4, 64, 1>;    // C <= 64: 8x32, 16 warps
using Tile128 = Tile<32, 4, 4, 4, 4, 64, 1>;   // C <= 128: 8x32, 16 warps
using Tile256 = Tile<16, 2, 8, 4, 4, 64, 1>;   // C <= 256: 8x16, 16 warps
using Tile512 = Tile<8, 1, 16, 4, 4, 32, 1>;   // C <= 512: 8x8, 16 warps
// int8's classes with the hidden resident, tried in this order (must match
// plan_tile's _I8_CLASSES); where none fits, the class above runs three
// sweeps.
using I8Tile32 = Tile<32, 16, 1, 1, 4, 32, 1, 1>;  // C <= 32: 8x32, one pass
using I8Tile64 = Tile<16, 8, 2, 1, 4, 64, 1, 1>;   // C <= 64: 8x16, one pass
using I8Tile128 = Tile<16, 4, 4, 2, 4, 32, 1, 2>;  // C <= 128: 8x16, 2 sweeps
using I8Tile256 = Tile<8, 2, 8, 2, 4, 32, 1, 2>;   // C <= 256: 8x8, 2 sweeps
constexpr size_t kSmemLimit = 232448;  // = SMEM_LIMIT of ops/kernels/leff.py

// 1. LayerNorm of the haloed tile into sXn (row stride XS), LG lanes per
//    pixel (one at C <= 32: no shuffles), each lane holding 32 channels in
//    four runs of 8 (one 16-byte load each when vec); rows outside the
//    image and padding rows are zero, sIn[p] says whether pixel p lies in
//    the image. Then its round trip (int8: the pixel's amax over its LG
//    lanes).
template <class L, int MODE>
__device__ __forceinline__ void layer_norm_tile(
    const bf16* __restrict__ x, const bf16* __restrict__ gamma,
    const bf16* __restrict__ beta, bf16* sXn, unsigned char* sIn, int XS,
    int Kp, int b, int y0, int x0, int H, int W, int C, float eps, int vec,
    int warp, int lane) {
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
        if (MODE == kFp8) y = fp8_trip(y);
        m = max(m, abs_bits(y));
        v[j][i] = y;
      }
    }
    if (MODE == kInt8) {
      const float scale = i8_scale<bf16>(group_max(m, G));
      const float inv = __frcp_rn(scale);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[j][i] = i8_trip_rcp<bf16>(v[j][i], scale, inv);
        }
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

// 2a. dense1 of a chunk on the tensor cores: a warp per 16 pixels x 32
//     channels, one A fragment feeding four MMAs; + b1 (par's first row),
//     rounded to bf16 (the twin's first rounding point) into hid (row
//     stride hs).
template <class L>
__device__ __forceinline__ void dense1_chunk(const bf16* sXn, int XS, int Kp,
                                             const bf16* sW1, const bf16* par,
                                             bf16* hid, int hs, int warp,
                                             int lane) {
  constexpr int KC = L::KC, HS = L::HS;
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
        *reinterpret_cast<__nv_bfloat162*>(hid + p * hs + cl) =
            __floats2bfloat162_rn(d[j][2 * h] + to_f(par[cl]),
                                  d[j][2 * h + 1] + to_f(par[cl + 1]));
      }
    }
  }
}

// GELU of the hidden pair at hid (a haloed pixel's, row stride hs),
// rounded; zero outside the image (the conv's SAME padding sees zeros).
__device__ __forceinline__ float2 gelu_pair(const bf16* hp, bool in,
                                            int fast_gelu) {
  const float2 hv =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp));
  if (!in) return make_float2(0.f, 0.f);
  return make_float2(round_to<bf16>(gelu(hv.x, fast_gelu)),
                     round_to<bf16>(gelu(hv.y, fast_gelu)));
}

// 2b. GELU over a chunk of the haloed hidden tile (row stride hs) by all
//     threads (gelu_pair); fn(p, cl, g0, g1) takes each pair (and may
//     change it) before it is stored back. The KC/2 threads of a pixel are
//     an aligned group of lanes (HP * KC/2 is a multiple of 32: every lane
//     runs every pass).
template <class L, class Fn>
__device__ __forceinline__ void gelu_chunk(bf16* hid, int hs,
                                           const unsigned char* sIn,
                                           int fast_gelu, int tid, Fn fn) {
  constexpr int KC = L::KC;
  for (int e = tid; e < L::HP * (KC / 2); e += L::kThreads) {
    const int p = e / (KC / 2), cl = 2 * (e % (KC / 2));
    bf16* hp = hid + p * hs + cl;
    float2 g = gelu_pair(hp, sIn[p], fast_gelu);
    fn(p, cl, g.x, g.y);
    *reinterpret_cast<__nv_bfloat162*>(hp) = __floats2bfloat162_rn(g.x, g.y);
  }
}

// The taps (par's rows 2-10, row stride ps) and bias (row 1) of the
// channel pair cl.
struct PairTaps {
  float k0[9], k1[9], db0, db1;
  __device__ __forceinline__ PairTaps(const bf16* par, int ps, int cl) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      k0[t] = to_f(par[(2 + t) * ps + cl]);
      k1[t] = to_f(par[(2 + t) * ps + cl + 1]);
    }
    db0 = to_f(par[ps + cl]);
    db1 = to_f(par[ps + cl + 1]);
  }
};

// depthwise 3x3 (VALID over the halo of hid, row stride hs) + bias + GELU
// of output pixel t's channel pair cl, rounded.
template <class L>
__device__ __forceinline__ float2 dwconv_pair(const bf16* hid, int hs, int t,
                                              int cl, const PairTaps& k,
                                              int fast_gelu) {
  const int r = t / L::TW, c = t % L::TW;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int di = 0; di < 3; ++di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              hid + ((r + di) * L::PW + c + dj) * hs + cl));
      a0 = fmaf(hv.x, k.k0[di * 3 + dj], a0);
      a1 = fmaf(hv.y, k.k1[di * 3 + dj], a1);
    }
  }
  return make_float2(
      round_to<bf16>(gelu(round_to<bf16>(a0 + k.db0), fast_gelu)),
      round_to<bf16>(gelu(round_to<bf16>(a1 + k.db1), fast_gelu)));
}

// 2c. depthwise 3x3 + bias + GELU of a chunk (dwconv_pair), two channels
//     per thread (a fixed pair, so its taps stay in registers); fn(t, cl,
//     g0, g1) takes each output pixel's pair.
template <class L, class Fn>
__device__ __forceinline__ void dwconv_chunk(const bf16* hid, int hs,
                                             const bf16* par, int ps,
                                             int fast_gelu, int tid, Fn fn) {
  constexpr int kPairs = L::KC / 2, NT = L::kThreads;
  const int cl = 2 * (tid % kPairs);
  const PairTaps k(par, ps, cl);
  // the kPairs threads of an output pixel are an aligned group of lanes,
  // and every lane runs every pass (TP is a multiple of NT / kPairs)
  static_assert(L::TP % (NT / kPairs) == 0, "dwconv: whole passes");
  for (int t = tid / kPairs; t < L::TP; t += NT / kPairs) {
    const float2 g = dwconv_pair<L>(hid, hs, t, cl, k, fast_gelu);
    fn(t, cl, g.x, g.y);
  }
}

// 2d. a chunk's share of dense2 into the register accumulator: A from the
//     chunk's KC columns of a (row stride as), B from the W2 chunk w.
template <class L>
__device__ __forceinline__ void dense2_chunk(float (&acc)[L::MW][L::NW][4],
                                             const bf16* a_src, int as,
                                             const bf16* w, int wm, int wn,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < L::KC / 16; ++kk) {
    uint32_t a[L::MW][4];
#pragma unroll
    for (int i = 0; i < L::MW; ++i) {
      ldsm_x4(smem_addr(a_src + ((wm * L::MW + i) * 16 + (lane & 15)) * as +
                        kk * 16 + (lane >> 4) * 8),
              a[i]);
    }
#pragma unroll
    for (int j = 0; j < L::NW; j += 2) {
      uint32_t bq[4];
      ldsm_x4_t(smem_addr(w + (kk * 16 + (lane & 15)) * L::NS +
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
//    pixel's channels lie in a quad of lanes of each of the WN warps of its
//    row, so its amax is a quad reduction, then an atomicMax into sMax2
//    (free: every thread is past its last read of it).
template <class L, int MODE>
__device__ __forceinline__ void store_tile(
    const float (&acc)[L::MW][L::NW][4], const bf16* __restrict__ b2,
    bf16* __restrict__ out, int* sMax2, int b, int y0, int x0, int H, int W,
    int C, int wm, int wn, int tid, int lane) {
  auto out_val = [&](int i, int j, int e, int n) {
    const float y = n < C ? round_to<bf16>(acc[i][j][e] + to_f(b2[n])) : 0.f;
    return MODE == kFp8 ? fp8_trip(y) : y;
  };
  if (MODE == kInt8) {
    for (int e = tid; e < L::TP; e += L::kThreads) sMax2[e] = 0;
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
      const float scale = MODE == kInt8 ? i8_scale<bf16>(sMax2[t]) : 0.f;
      const float inv = MODE == kInt8 ? __frcp_rn(scale) : 0.f;
      bf16* o = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < L::NW; ++j) {
        const int n = (wn * L::NW + j) * 8 + (lane & 3) * 2;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (n + u >= C) continue;
          const float y = out_val(i, j, 2 * h + u, n + u);
          o[n + u] = from_f<bf16>(
              MODE == kInt8 ? i8_trip_rcp<bf16>(y, scale, inv) : y);
        }
      }
    }
  }
}

// The classes of every mode. MODE is the act_store mode (a template
// argument, so that the plain kernel carries none of the round trips'
// registers); int8 runs here only where no class of its own fits.
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
    copy_rows<KC, NT>(sW1, HS, w1 + c0, Ch, Kp, C, Ch - c0, vec, tid);
    copy_par<KC, NT>(sPar + (v & 1) * L::kPar * KC, KC, b1, dwb, dw, c0, Ch,
                     vec, tid);
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
  layer_norm_tile<L, MODE>(x, gamma, beta, sXn, sIn, XS, Kp, b, y0, x0, H, W,
                           C, eps, vec, warp, lane);

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
    // int8: an amax is complete once its sweep is done; its scale replaces
    // it before B, for the GELU (sweeps 1, 2) and the dwconv (sweep 2)
    if (mode == kInt8 && v == n_chunks) amax_to_scale(sMax1, L::HPP, tid, NT);
    if (mode == kInt8 && v == 2 * n_chunks) {
      amax_to_scale(sMax2, L::TP, tid, NT);
    }

    dense1_chunk<L>(sXn, XS, Kp, sW1, par, sHid, HS, warp, lane);
    __syncthreads();  // B
    if (v + 1 < n_steps) issue_p1(v + 1);

    // GELU, then its round trip
    gelu_chunk<L>(sHid, HS, sIn, fast_gelu, tid,
                  [&](int p, int cl, float& g0, float& g1) {
      if (mode == kFp8) {
        fp8_trip2(g0, g1);
      } else if (mode == kInt8 && sweep == 0) {
        const int m = group_max(max(abs_bits(g0), abs_bits(g1)), KC / 2);
        if (cl == 0) atomicMax(sMax1 + p, m);
      } else if (mode == kInt8) {
        const float scale = reinterpret_cast<const float*>(sMax1)[p];
        const float inv = __frcp_rn(scale);
        g0 = i8_trip_rcp<bf16>(g0, scale, inv);
        g1 = i8_trip_rcp<bf16>(g1, scale, inv);
      }
    });
    __syncthreads();  // G
    if (mode == kInt8 && sweep == 0) continue;

    dwconv_chunk<L>(sHid, HS, par, KC, fast_gelu, tid,
                    [&](int t, int cl, float g0, float g1) {
      if (mode == kFp8) {
        fp8_trip2(g0, g1);
      } else if (mode == kInt8 && sweep == 1) {
        const int m = group_max(max(abs_bits(g0), abs_bits(g1)), KC / 2);
        if (cl == 0) atomicMax(sMax2 + t, m);
      } else if (mode == kInt8) {
        const float scale = reinterpret_cast<const float*>(sMax2)[t];
        const float inv = __frcp_rn(scale);
        g0 = i8_trip_rcp<bf16>(g0, scale, inv);
        g1 = i8_trip_rcp<bf16>(g1, scale, inv);
      }
      *reinterpret_cast<__nv_bfloat162*>(sG + t * HS + cl) =
          __floats2bfloat162_rn(g0, g1);
    });
    if (!last) continue;  // int8 sweep 1: its amaxes are in for sweep 2
    // P2(v) landed: the newest group, P1(v+1), may still be in flight.
    if (v + 1 < n_steps) {
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // C

    dense2_chunk<L>(acc, sG, HS, sW2, wm, wn, lane);
  }

  store_tile<L, MODE>(acc, b2, out, sMax2, b, y0, x0, H, W, C, wm, wn, tid,
                      lane);
}

// int8 with the hidden resident in shared memory (the classes with R > 0;
// the header). R = 1: dense1 + GELU1 over every chunk into hidden1 with
// its amaxes, hidden1 quantized in place, dwconv + GELU2 over every chunk
// into hidden2 with its amaxes. R = 2: sweep 0 runs dense1 + GELU1 for the
// amaxes alone, sweep 1 runs them again, quantizes each chunk and runs its
// dwconv + GELU2 into hidden2. Then hidden2 is quantized in place and
// dense2 walks it chunk by chunk, its W2 chunks double-buffered where the
// LN tile was.
template <class L>
__global__ void __launch_bounds__(L::kThreads, L::MINB)
    leff_fwd_i8_kernel(const bf16* __restrict__ x,
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
                NT = L::kThreads, R = L::R;
  static_assert(R == 1 || R == 2, "int8's resident designs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Kp = (C + 15) / 16 * 16, XS = Kp + 8;
  const int n_chunks = (Ch + KC - 1) / KC, ChP = n_chunks * KC;
  const int HSW = ChP + 8;              // row stride of a whole hidden tile
  const int HS1 = R == 1 ? HSW : HS;    // ... of hidden1
  const int PS = R == 1 ? ChP : KC;     // ... of the parameters
  const int xn_len = L::HPP * XS > 2 * KC * NS ? L::HPP * XS : 2 * KC * NS;
  bf16* sXn = reinterpret_cast<bf16*>(smem_raw);  // [HPP][XS] LN(x), then
                                                  // 2 x [KC][NS] W2 chunks
  bf16* sW1 = sXn + xn_len;                       // [Kp][HS] W1[:, chunk]
  bf16* sPar = sW1 + Kp * HS;  // [kPar][ChP] or 2 x [kPar][KC]: b1, dw
                               // bias, taps
  bf16* sHid = sPar + (R == 1 ? L::kPar * ChP : 2 * L::kPar * KC);
                                                  // [HPP][HS1] hidden1
  bf16* sG = sHid + L::HPP * HS1;                 // [TP][HSW] hidden2
  int* sMax1 = reinterpret_cast<int*>(sG + L::TP * HSW);  // [HPP] amaxes
  int* sMax2 = sMax1 + L::HPP;                            // [TP]
  float* sInv1 = reinterpret_cast<float*>(sMax2 + L::TP);  // [HPP] 1/scale
  float* sInv2 = sInv1 + L::HPP;                             // [TP]
  unsigned char* sIn =
      reinterpret_cast<unsigned char*>(sInv2 + L::TP);  // [HPP] in image
  // each pixel's scale, in place of its amax once that is complete
  float* sScale1 = reinterpret_cast<float*>(sMax1);
  float* sScale2 = reinterpret_cast<float*>(sMax2);

  const int b = blockIdx.z, y0 = blockIdx.y * L::TH, x0 = blockIdx.x * L::TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_steps = R * n_chunks;  // dense1's steps

  // P1(v) (one cp.async group): W1[:, chunk] of step v, and for R = 2 the
  // chunk's parameters (buffer v&1); for R = 1 every parameter comes with
  // P1(0).
  auto issue_p1 = [&](int v) {
    const int c0 = (v % n_chunks) * KC;
    copy_rows<KC, NT>(sW1, HS, w1 + c0, Ch, Kp, C, Ch - c0, vec, tid);
    if (R == 2) {
      copy_par<KC, NT>(sPar + (v & 1) * L::kPar * KC, KC, b1, dwb, dw, c0,
                       Ch, vec, tid);
    } else if (v == 0) {
      for (int k = 0; k < n_chunks; ++k) {
        copy_par<KC, NT>(sPar + k * KC, ChP, b1, dwb, dw, k * KC, Ch, vec,
                         tid);
      }
    }
    if (vec) cp_async_commit();
  };
  auto par_of = [&](int v) -> const bf16* {  // row stride PS
    return R == 1 ? sPar + (v % n_chunks) * KC : sPar + (v & 1) * L::kPar * KC;
  };
  // rows x ChP values of buf (row stride HSW) quantized in place, row p by
  // scale[p] (reciprocal inv[p]): a thread per row and channel pair of a
  // chunk, for every chunk
  auto quantize = [&](bf16* buf, int rows, const float* scale,
                      const float* inv) {
    for (int e = tid; e < rows * (KC / 2); e += NT) {
      const int p = e / (KC / 2), cl = 2 * (e % (KC / 2));
      const float sp = scale[p], ip = inv[p];
      for (int c = cl; c < ChP; c += KC) {
        __nv_bfloat162* hp =
            reinterpret_cast<__nv_bfloat162*>(buf + p * HSW + c);
        const float2 hv = __bfloat1622float2(*hp);
        *hp = __floats2bfloat162_rn(i8_trip_rcp<bf16>(hv.x, sp, ip),
                                    i8_trip_rcp<bf16>(hv.y, sp, ip));
      }
    }
  };
  // The amaxes without atomics: a thread takes the same pixels and channel
  // pair in every chunk (NT is a multiple of KC/2), so it keeps a running
  // max of each of its pixels over the chunks in registers (m1: haloed
  // pixels, kG1 of them; m2: output pixels, kD), and the KC/2 lanes that
  // share a pixel reduce them once, after the last chunk.
  constexpr int kPairs = KC / 2;
  constexpr int kG1 = (L::HP * kPairs + NT - 1) / NT;
  constexpr int kD = L::TP / (NT / kPairs);
  int m1[kG1], m2[kD];
#pragma unroll
  for (int i = 0; i < kG1; ++i) m1[i] = 0;
#pragma unroll
  for (int j = 0; j < kD; ++j) m2[j] = 0;
  // GELU1 over a chunk of hidden1 (hid, row stride HS1): its amaxes into
  // m1 (kept in hid for one pass), or for R = 2's sweep 1 quantized with
  // hidden1's scales and kept
  auto gelu1 = [&](bf16* hid, bool quant) {
#pragma unroll
    for (int i = 0; i < kG1; ++i) {
      const int e = tid + i * NT;
      if (e >= L::HP * kPairs) break;  // whole warps (Tile's assert)
      const int p = e / kPairs, cl = 2 * (e % kPairs);
      bf16* hp = hid + p * HS1 + cl;
      float2 g = gelu_pair(hp, sIn[p], fast_gelu);
      if (quant) {
        g.x = i8_trip_rcp<bf16>(g.x, sScale1[p], sInv1[p]);
        g.y = i8_trip_rcp<bf16>(g.y, sScale1[p], sInv1[p]);
      } else {
        m1[i] = max(m1[i], max(abs_bits(g.x), abs_bits(g.y)));
        if (R == 2) continue;  // sweep 0: the amax alone
      }
      *reinterpret_cast<__nv_bfloat162*>(hp) = __floats2bfloat162_rn(g.x, g.y);
    }
  };
  // the dwconv + GELU2 of chunk k from src (row stride ss; its columns)
  // into hidden2, its amaxes into m2
  auto dwconv2 = [&](int k, const bf16* src, int ss, const bf16* par) {
    const int cl = 2 * (tid % kPairs);
    const PairTaps taps(par, PS, cl);
    bf16* g = sG + k * KC;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const int t = tid / kPairs + j * (NT / kPairs);
      const float2 v = dwconv_pair<L>(src, ss, t, cl, taps, fast_gelu);
      m2[j] = max(m2[j], max(abs_bits(v.x), abs_bits(v.y)));
      *reinterpret_cast<__nv_bfloat162*>(g + t * HSW + cl) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  };
  // each pixel's amax over its whole hidden width into sMax1 / sMax2
  auto put_max1 = [&]() {
#pragma unroll
    for (int i = 0; i < kG1; ++i) {
      const int e = tid + i * NT;
      if (e >= L::HP * kPairs) break;
      const int m = group_max(m1[i], kPairs);
      if (e % kPairs == 0) sMax1[e / kPairs] = m;
    }
  };
  auto put_max2 = [&]() {
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const int m = group_max(m2[j], kPairs);
      if (tid % kPairs == 0) sMax2[tid / kPairs + j * (NT / kPairs)] = m;
    }
  };

  issue_p1(0);
  for (int e = tid; e < L::HPP + L::TP; e += NT) sMax1[e] = 0;
  layer_norm_tile<L, kInt8>(x, gamma, beta, sXn, sIn, XS, Kp, b, y0, x0, H,
                            W, C, eps, vec, warp, lane);

  // dense1's steps, three barriers each: A (P1(v) landed; the step
  // before is done with sHid), B (dense1(v) done, so the W1 buffer is free
  // for P1(v+1), which lands during the GELU), and for R = 2's sweep 1, G
  // (GELU done) before the dwconv.
  for (int v = 0; v < n_steps; ++v) {
    const int k = v % n_chunks;
    const bool quant = R == 2 && v >= n_chunks;  // sweep 1: amaxes are in
    cp_async_wait_all();
    __syncthreads();  // A
    if (R == 2 && v == n_chunks) {
      amax_to_scale(sMax1, L::HPP, tid, NT, sInv1);
    }
    bf16* hid = sHid + (R == 1 ? k * KC : 0);
    dense1_chunk<L>(sXn, XS, Kp, sW1, par_of(v), hid, HS1, warp, lane);
    __syncthreads();  // B
    if (v + 1 < n_steps) issue_p1(v + 1);
    gelu1(hid, quant);
    if (quant) {
      __syncthreads();  // G
      dwconv2(k, hid, HS1, par_of(v));
    }
    if (v + 1 == n_chunks) put_max1();  // before A (R = 2) or the barrier
  }
  if (R == 2) put_max2();
  __syncthreads();
  if (R == 1) {
    amax_to_scale(sMax1, L::HPP, tid, NT, sInv1);
    __syncthreads();
    quantize(sHid, L::HP, sScale1, sInv1);
    __syncthreads();
    for (int k = 0; k < n_chunks; ++k) {
      dwconv2(k, sHid + k * KC, HSW, sPar + k * KC);
    }
    put_max2();
    __syncthreads();
  }

  // dense2 over hidden2, quantized in place; W(k): W2[chunk k, :] into
  // buffer k&1 where the LN tile was (every dense1 is done).
  auto issue_w2 = [&](int k) {
    const int c0 = k * KC;
    copy_rows<NC, NT>(sXn + (k & 1) * KC * NS, NS,
                      w2 + static_cast<size_t>(c0) * C, C, KC, Ch - c0, C,
                      vec, tid);
    if (vec) cp_async_commit();
  };
  issue_w2(0);
  if (n_chunks > 1) issue_w2(1);
  amax_to_scale(sMax2, L::TP, tid, NT, sInv2);
  __syncthreads();
  quantize(sG, L::TP, sScale2, sInv2);

  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[L::MW][L::NW][4];
#pragma unroll
  for (int i = 0; i < L::MW; ++i)
#pragma unroll
    for (int j = 0; j < L::NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      cp_async_wait_one();  // W(k); W(k+1) may be in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // W(k) landed; (k = 0) hidden2 quantized
    dense2_chunk<L>(acc, sG + k * KC, HSW, sXn + (k & 1) * KC * NS, wm, wn,
                    lane);
    if (k + 2 < n_chunks) {
      __syncthreads();  // buffer k&1 read by every warp
      issue_w2(k + 2);
    }
  }
  store_tile<L, kInt8>(acc, b2, out, sMax2, b, y0, x0, H, W, C, wm, wn, tid,
                       lane);
}

// Launch `kernel` (a kernel of class L) on L's grid of output tiles with
// L's shared memory for (C, Ch); returns cudaGetLastError().
template <class L, class K>
int launch(K kernel, const void* x, const void* gamma, const void* beta,
           const void* w1, const void* b1, const void* dw, const void* dwb,
           const void* w2, const void* b2, void* out, int B, int H, int W,
           int C, int Ch, float eps, int fast_gelu, cudaStream_t stream) {
  const size_t smem = L::smem_bytes(C, Ch);
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

template <class L>
int launch_mma(const void* x, const void* gamma, const void* beta,
               const void* w1, const void* b1, const void* dw,
               const void* dwb, const void* w2, const void* b2, void* out,
               int B, int H, int W, int C, int Ch, float eps, int fast_gelu,
               int mode, cudaStream_t stream) {
  auto kernel = mode == kInt8  ? leff_fwd_mma_kernel<L, kInt8>
                : mode == kFp8 ? leff_fwd_mma_kernel<L, kFp8>
                               : leff_fwd_mma_kernel<L, 0>;
  return launch<L>(kernel, x, gamma, beta, w1, b1, dw, dwb, w2, b2, out, B,
                   H, W, C, Ch, eps, fast_gelu, stream);
}

// Class L takes C, and its tile fits the hidden width Ch.
template <class L>
bool fits(int C, int Ch) {
  return C <= L::NC && L::smem_bytes(C, Ch) <= kSmemLimit;
}

// int8's design for (C, Ch): the first of its own classes that fits (1-4:
// I8Tile32 ... I8Tile256); 0 if none does (the class of C, three sweeps).
int i8_class(int C, int Ch) {
  if (fits<I8Tile32>(C, Ch)) return 1;
  if (fits<I8Tile64>(C, Ch)) return 2;
  if (fits<I8Tile128>(C, Ch)) return 3;
  if (fits<I8Tile256>(C, Ch)) return 4;
  return 0;
}

// The shared memory of the bf16 class that runs (C, Ch, mode), if (TH, TW)
// is that class's tile; -1 otherwise.
long mma_smem_bytes(int C, int Ch, int TH, int TW, int mode) {
  if (TH != 8 || C < 1 || Ch < 1) return -1;
#define LEFF_BYTES(L) \
  return TW == L::TW ? static_cast<long>(L::smem_bytes(C, Ch)) : -1
  if (mode == kInt8) {
    switch (i8_class(C, Ch)) {
      case 1: LEFF_BYTES(I8Tile32);
      case 2: LEFF_BYTES(I8Tile64);
      case 3: LEFF_BYTES(I8Tile128);
      case 4: LEFF_BYTES(I8Tile256);
      default: break;
    }
  }
  if (C <= 32) LEFF_BYTES(Tile32);
  if (C <= 64) LEFF_BYTES(Tile64);
  if (C <= 128) LEFF_BYTES(Tile128);
  if (C <= 256) LEFF_BYTES(Tile256);
  if (C <= 512) LEFF_BYTES(Tile512);
#undef LEFF_BYTES
  return -1;
}

// K2's fp8 round trip (fp8_trip2, the device function of its four sites)
// over n values of type T, from in to out.
template <typename T>
__global__ void fp8_trip_kernel(const T* __restrict__ in, T* __restrict__ out,
                                long long n) {
  const long long step = 2LL * gridDim.x * blockDim.x;
  for (long long i = 2LL * (static_cast<long long>(blockIdx.x) * blockDim.x +
                            threadIdx.x);
       i < n; i += step) {
    float a = to_f(in[i]), c = i + 1 < n ? to_f(in[i + 1]) : 0.f;
    fp8_trip2(a, c);
    out[i] = from_f<T>(a);
    if (i + 1 < n) out[i + 1] = from_f<T>(c);
  }
}

// i8_trip_rcp (with its reciprocal as the kernel takes it) over n bf16
// values v[i] at scale[i], from v to out.
__global__ void i8_trip_kernel(const bf16* __restrict__ v,
                               const bf16* __restrict__ scale,
                               bf16* __restrict__ out, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const float s = to_f(scale[i]);
    out[i] = from_f<bf16>(i8_trip_rcp<bf16>(to_f(v[i]), s, __frcp_rn(s)));
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel allocates for this plan, in bytes; -1 if the
// plan is not one the kernel takes. dtype: 0 = float32, 1 = bfloat16; Ch
// the hidden width; act_store the mode (int8 has classes of its own).
long leff_smem_bytes(int dtype, int C, int Ch, int TH, int TW,
                     int act_store) {
  if (dtype == 0) return static_cast<long>(f32_smem_bytes(C, TH, TW));
  return mma_smem_bytes(C, Ch, TH, TW, act_store);
}

// dtype: 0 = float32, 1 = bfloat16. x/out: [B, H, W, C] contiguous;
// gamma/beta/b2: [C]; w1: [C, Ch]; b1/dwb: [Ch]; dw: [9, Ch]; w2: [Ch, C];
// all of the activation type. Any H and W: the last row and column tiles
// are ragged (pixels past the image load as zero, the conv's halo, and are
// never stored). The tile (TH, TW) is the wrapper's plan (for bf16, the
// class of C, Ch and the mode). act_store: 0 none, 1 fp8, 2 int8 (the
// header); another value is refused. Returns cudaGetLastError().
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
  if (mma_smem_bytes(C, Ch, TH, TW, act_store) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define LEFF_I8(L)                                                          \
  return launch<L>(leff_fwd_i8_kernel<L>, x, gamma, beta, w1, b1, dw, dwb, \
                   w2, b2, out, B, H, W, C, Ch, eps, fast_gelu, s)
  if (act_store == kInt8) {
    switch (i8_class(C, Ch)) {
      case 1: LEFF_I8(I8Tile32);
      case 2: LEFF_I8(I8Tile64);
      case 3: LEFF_I8(I8Tile128);
      case 4: LEFF_I8(I8Tile256);
      default: break;
    }
  }
#undef LEFF_I8
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

// K2's fp8 round trip applied to n values: out[i] = in[i] as it reads back
// from its e4m3 storage in the kernel (NaN beyond +-464). dtype: 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError().
int leff_fp8_trip(int dtype, const void* in, void* out, long long n,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const long long blocks = (n + 511) / 512;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  if (dtype == 0) {
    fp8_trip_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), n);
  } else {
    fp8_trip_kernel<bf16><<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(in), static_cast<bf16*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int8 round trip of K2's resident-hidden kernels applied to n bf16
// values: out[i] = v[i] read back from int8 at scale[i] (i8_trip_rcp).
// Returns cudaGetLastError().
int leff_i8_trip(const void* v, const void* scale, void* out, long long n,
                 void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  i8_trip_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(scale),
      static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
