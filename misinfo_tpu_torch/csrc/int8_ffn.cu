// int8 FFN for Hopper (sm_90a): quantize rows -> s8 product -> dequant +
// bias -> activation -> requantize per (row, chunk) -> s8 product -> f32
// sums in chunk order -> scale + bias.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_int8.py::_ffn_kernel
// (reached through int8_ffn_pallas). Same math, same quantization
// granularity: the intermediate is processed in chunks of `jc` columns
// and its activations are quantized per (row, chunk). The numerics are
// those of the JAX kernel as XLA compiles it (held bit for bit on the CPU
// by tests/test_torch_int8_ffn.py against its interpret mode), repeated
// operation for operation by int8_ffn_plain in ops/int8_ffn.py:
//   * row scales max(amax · f32(1/127), 1e-8) (XLA folds `/ 127.0`), for
//     x and for each (row, chunk) of the intermediate; IEEE division and
//     round-half-even in the quantize;
//   * h = (hi·sx)·s1 + b1, the multiply-add rounded once (an FMA); the
//     activation with the bf16 roundings of _act_f32, except that quick
//     GELU's product h·sigmoid is not rounded to bf16 before it is
//     quantized (XLA keeps it in f32: excess precision);
//   * acc = y_j·sg_j + acc per chunk in chunk order, and out = acc·s2 +
//     b2, each multiply-add rounded once (FMAs, as XLA fuses them; the
//     plain version rounds to odd in float64 first, which makes its one
//     rounding to f32 that of the FMA).
// Never build with --use_fast_math.
//
// What bounds it on this card: 2·M·N·(K + K2) int8 ops. At RoBERTa b32
// (M = 16,384, 768 → 3,072 → 768) that is 155 G ops, 78 µs at the int8
// tensor-core rate, against ~26 MB of x and out (8 µs): compute-bound.
// Its elementwise work (a tanh/erf/exp, a quantize and three roundings
// per intermediate element, 50 M of them) adds tens of µs of CUDA-core
// time: the quantize divides only near a half-integer and rounds by an
// addition (int8_gemm.cuh), the bf16 roundings go two at a time through
// one packed conversion (conversions issue at 1/8 of the FP32 rate).
// The design, three launches on the mainloop of int8_gemm.cuh (K-major
// weights, wgmma s8 with sums in registers, a producer thread keeping a
// TMA ring full):
//   1. quantize x once per row (xq [M, K], sx [M]);
//   2. up: 64-row × jc-column tiles, one chunk per block, four consumer
//      warpgroups of 64 × jc/4 on wgmma.m64n(jc/4)k32 (two at jc = 128,
//      each needing 64 columns), sixteen warps sharing the epilogue; the
//      (row, chunk) abs-max is a reduction inside the block. The
//      epilogue dequantizes, adds the bias, applies the activation and
//      requantizes in registers, then writes gq [M, N] s8 (16 bytes per
//      lane) and sg [M, N/jc] f32. The intermediate makes a round trip
//      to memory of 2·M·N bytes (100 MB at RoBERTa b32, ~30 µs at 3.35
//      TB/s) where a fused kernel would have to keep [BM, K2] f32 sums
//      across every chunk in registers (64 × 768 f32 is 49,152 of them
//      before any first-product sums) and reread the weights for each
//      small row tile;
//   3. down: 128 × 128 output tiles over K = N, two consumer warpgroups of
//      64 rows on wgmma.m64n128k32; at the end of each chunk the s32 sums
//      are folded into f32 registers with that chunk's sg, in chunk order,
//      then ·s2 + b2 → bf16, 16 bytes per lane. A row tile's column tiles
//      run side by side, so that its gq rows (50 MB in all at b32, as
//      large as L2) come from memory once.
// Few output tiles (fewer than SMs: one request, M = 512, 77, 50) leave the
// card idle in step 3, so there each block takes one (tile, chunk) and
// writes its s32 sums to a workspace; a fourth launch folds them in chunk
// order exactly as step 3 does. Both forms give bit-identical results.

#include "int8_gemm.cuh"

namespace {

using int8k::MODE_ERF;
using int8k::MODE_QUICK;
using int8k::MODE_TANH;

constexpr int UP_BM = 64, UP_STAGES = 3;
constexpr int DN_BM = 128, DN_BN = 128, DN_STAGES = 6;
constexpr int DN_THREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer

// Consumer warpgroups of the up kernel at chunk width JC, each 64 × JC/WG
// (at least 64 columns): four at jc >= 256, so that sixteen warps share
// the epilogue's arithmetic (two take 1.7× as long at b32).
__host__ __device__ constexpr int up_wg(int jc) { return jc >= 256 ? 4 : 2; }
__host__ __device__ constexpr int up_threads(int jc) {
  return up_wg(jc) * 128 + 32;
}

// a and b rounded to bf16 and back, by one packed conversion
__device__ __forceinline__ float2 bf16_pair(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The activation of two f32 pre-activations as the values that are
// quantized: int8k::act<true>'s arithmetic (_act_f32's casts), but for the
// unrounded quick-GELU product.
template <int MODE>
__device__ __forceinline__ float2 act(float a, float b) {
  const float2 h = bf16_pair(a, b);
  if (MODE == MODE_QUICK) {
    const float2 s = bf16_pair(1.0f / (1.0f + expf(-1.702f * h.x)),
                               1.0f / (1.0f + expf(-1.702f * h.y)));
    return make_float2(__fmul_rn(h.x, s.x), __fmul_rn(h.y, s.y));
  }
  float g[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float v = e ? h.y : h.x;
    if (MODE == MODE_TANH) {
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      g[e] = v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    } else {
      g[e] = 0.5f * v * erfcf(-v * 0.7071067811865476f);
    }
  }
  return bf16_pair(g[0], g[1]);
}

// Step 2: one 64-row tile × chunk blockIdx.y of the intermediate.
template <int JC, int MODE>
__global__ void __launch_bounds__(up_threads(JC), 1)
ffn_up_kernel(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mw,
              const float* __restrict__ sx, const float* __restrict__ s1,
              const float* __restrict__ b1, int8_t* __restrict__ gq,
              float* __restrict__ sg, int M, int K, int N) {
  constexpr int WG = up_wg(JC), WN = JC / WG;
  extern __shared__ unsigned char smem[];
  const auto ring = i8g::make_ring<UP_BM, JC, UP_STAGES>(smem);
  i8g::ring_init(ring, 4 * WG);
  const int m0 = blockIdx.x * UP_BM, n0 = blockIdx.y * JC;
  const int nkb = (K + i8g::BK - 1) / i8g::BK;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  uint32_t it = 0;
  if (wg == WG) {
    if (lane == 0) i8g::produce(ring, &mx, m0, &mw, n0, 0, nkb, it);
    return;
  }
  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  i8g::consume<WN>(ring, 0, wg * WN * i8g::BK, 0, nkb, nkb, acc,
                   [](int) {}, it);

  const int q = lane & 3;
  const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = n0 + wg * WN + 2 * q;
  float sxv[2], amax[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sxv[h] = m0 + rl + 8 * h < M ? sx[m0 + rl + 8 * h] : 0.f;
  // dequantize, bias, activation; the activations replace the sums
#pragma unroll
  for (int i = 0; i < WN / 8; ++i) {
    const float2 sv = *reinterpret_cast<const float2*>(s1 + c0 + 8 * i);
    const float2 bv = *reinterpret_cast<const float2*>(b1 + c0 + 8 * i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 4 * i + 2 * h;
      const float2 g = act<MODE>(
          __fmaf_rn(__fmul_rn(__int2float_rn(acc[k]), sxv[h]), sv.x, bv.x),
          __fmaf_rn(__fmul_rn(__int2float_rn(acc[k + 1]), sxv[h]), sv.y,
                    bv.y));
      acc[k] = __float_as_int(g.x);
      acc[k + 1] = __float_as_int(g.y);
      amax[h] = fmaxf(amax[h], fmaxf(fabsf(g.x), fabsf(g.y)));
    }
  }
  // the (row, chunk) abs-max: the quad, then the warpgroups
  float* red = reinterpret_cast<float*>(ring.extra(smem));   // [WG][64]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
    amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
    if (q == 0) red[wg * 64 + rl + 8 * h] = amax[h];
  }
  i8g::named_sync(1, WG * 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rl + 8 * h;
    float m = red[rl + 8 * h];
#pragma unroll
    for (int w = 1; w < WG; ++w) m = fmaxf(m, red[w * 64 + rl + 8 * h]);
    const float s = i8g::row_scale(m), r = __frcp_rn(s);
    if (wg == 0 && q == 0 && row < M)
      sg[(size_t)row * gridDim.y + blockIdx.y] = s;
    // requantize; lane q stores columns 16q .. 16q + 15 of each 64
#pragma unroll
    for (int blk = 0; blk < WN / 64; ++blk) {
      uint32_t b[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int k = 4 * (blk * 8 + g) + 2 * h;
        b[g] =
            (uint32_t)(uint8_t)i8g::quant(__int_as_float(acc[k]), s, r) |
            (uint32_t)(uint8_t)i8g::quant(__int_as_float(acc[k + 1]), s, r)
                << 8;
      }
      const uint4 v = i8g::gather_bytes(b);
      if (row < M)
        *reinterpret_cast<uint4*>(gq + (size_t)row * N + n0 + wg * WN +
                                  blk * 64 + 16 * q) = v;
    }
  }
}

// Step 3: one 128 × 128 output tile (columns blockIdx.x, rows blockIdx.y)
// over every chunk (SPLIT false: fold the chunks' sums in order, write
// out) or over chunk blockIdx.z alone (SPLIT true: write its s32 sums to
// part [N/jc, M, K2]).
template <bool SPLIT>
__global__ void __launch_bounds__(DN_THREADS, 1)
ffn_down_kernel(const __grid_constant__ CUtensorMap mg,
                const __grid_constant__ CUtensorMap mw,
                const float* __restrict__ sg, const float* __restrict__ s2,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                int* __restrict__ part, int M, int N, int K2, int jc) {
  constexpr int WN = DN_BN;
  extern __shared__ unsigned char smem[];
  const auto ring = i8g::make_ring<DN_BM, DN_BN, DN_STAGES>(smem);
  i8g::ring_init(ring, 8);
  const int m0 = blockIdx.y * DN_BM, n0 = blockIdx.x * DN_BN;
  const int chunks = N / jc, ck = jc / i8g::BK;
  const int kb0 = SPLIT ? blockIdx.z * ck : 0;
  const int kb1 = SPLIT ? kb0 + ck : N / i8g::BK;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  uint32_t it = 0;
  if (wg == 2) {
    if (lane == 0) i8g::produce(ring, &mg, m0, &mw, n0, kb0, kb1, it);
    return;
  }
  const int r_lo = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  int acc[WN / 2];
  float accf[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) {
    acc[i] = 0;
    accf[i] = 0.f;
  }
  // this chunk's sg of the thread's two rows, the next chunk's loading
  float s_now[2], s_next[2] = {0.f, 0.f};
  const auto sg_of = [&](int c, float* s) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      s[h] = r_lo + 8 * h < M && c < chunks
                 ? sg[(size_t)(r_lo + 8 * h) * chunks + c]
                 : 0.f;
  };
  if constexpr (!SPLIT) sg_of(0, s_next);
  i8g::consume<WN>(ring, wg * 64 * i8g::BK, 0, kb0, kb1, ck, acc,
                   [&](int c) {
                     if constexpr (!SPLIT) {
#pragma unroll
                       for (int h = 0; h < 2; ++h) s_now[h] = s_next[h];
                       sg_of(c + 1, s_next);
#pragma unroll
                       for (int k = 0; k < WN / 2; ++k)
                         accf[k] = __fmaf_rn(__int2float_rn(acc[k]),
                                             s_now[(k >> 1) & 1], accf[k]);
                     }
                   },
                   it);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < WN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * q;
        if (row < M && col < K2)
          *reinterpret_cast<int2*>(
              part + ((size_t)blockIdx.z * M + row) * K2 + col) =
              make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int blk = 0; blk < WN / 32; ++blk) {
        uint32_t w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int i = blk * 4 + g, col = n0 + 8 * i + 2 * q;
          const bool ok = col < K2;
          const int k = 4 * i + 2 * h;
          w[g] = i8g::pack_bf16(
              __fmaf_rn(accf[k], ok ? s2[col] : 0.f, ok ? b2[col] : 0.f),
              __fmaf_rn(accf[k + 1], ok ? s2[col + 1] : 0.f,
                        ok ? b2[col + 1] : 0.f));
        }
        const uint4 v = i8g::gather_groups(w);
        const int col = n0 + 8 * (blk * 4 + q);
        if (row < M && col < K2)
          *reinterpret_cast<uint4*>(out + (size_t)row * K2 + col) = v;
      }
    }
  }
}

// Split form, last launch: out = (Σ_j y_j·sg_j + acc, in chunk order)
// · s2 + b2, the same roundings as ffn_down_kernel<false>.
__global__ void ffn_reduce_kernel(const int* __restrict__ part,
                                  const float* __restrict__ sg,
                                  const float* __restrict__ s2,
                                  const float* __restrict__ b2,
                                  __nv_bfloat16* __restrict__ out, int M,
                                  int K2, int chunks) {
  const size_t n = (size_t)M * K2;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = (int)(i / K2), col = (int)(i % K2);
  float acc = 0.f;
  for (int j = 0; j < chunks; ++j)
    acc = __fmaf_rn(__int2float_rn(part[j * n + i]),
                    sg[(size_t)row * chunks + j], acc);
  out[i] = __float2bfloat16_rn(__fmaf_rn(acc, s2[col], b2[col]));
}

template <int JC, int MODE>
cudaError_t launch_up(const int8_t* xq, const float* sx, const void* w1t,
                      const void* s1, const void* b1, int8_t* gq, float* sg,
                      int M, int K, int N, cudaStream_t stream) {
  CUtensorMap mx, mw;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mx, xq, M, K, UP_BM)) != cudaSuccess ||
      (e = i8g::tensor_map(&mw, w1t, N, K, JC < 256 ? JC : 256)) !=
          cudaSuccess)
    return e;
  const size_t smem =
      i8g::Ring<UP_BM, JC, UP_STAGES>::bytes(up_wg(JC) * 64 * 4);
  if ((e = i8g::allow_smem<ffn_up_kernel<JC, MODE>>(smem)) != cudaSuccess)
    return e;
  const dim3 grid((M + UP_BM - 1) / UP_BM, N / JC);
  ffn_up_kernel<JC, MODE><<<grid, up_threads(JC), smem, stream>>>(
      mx, mw, sx, static_cast<const float*>(s1),
      static_cast<const float*>(b1), gq, sg, M, K, N);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch_down(const int8_t* gq, const float* sg, const void* w2t,
                        const void* s2, const void* b2, void* out, int* part,
                        int M, int N, int K2, int jc, cudaStream_t stream) {
  CUtensorMap mg, mw;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mg, gq, M, N, DN_BM)) != cudaSuccess ||
      (e = i8g::tensor_map(&mw, w2t, K2, N, DN_BN)) != cudaSuccess)
    return e;
  const size_t smem = i8g::Ring<DN_BM, DN_BN, DN_STAGES>::bytes(0);
  if ((e = i8g::allow_smem<ffn_down_kernel<SPLIT>>(smem)) != cudaSuccess)
    return e;
  // the column tiles of a row tile run side by side, so that its gq rows
  // come from memory once and from L2 for the others (gq is 50 MB at
  // RoBERTa b32, as large as L2)
  const dim3 grid((K2 + DN_BN - 1) / DN_BN, (M + DN_BM - 1) / DN_BM,
                  SPLIT ? N / jc : 1);
  ffn_down_kernel<SPLIT><<<grid, DN_THREADS, smem, stream>>>(
      mg, mw, sg, static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), part,
      M, N, K2, jc);
  return cudaGetLastError();
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

}  // namespace

// Bytes of the workspace int8_ffn_launch needs: xq [M, K] s8, sx [M] f32,
// gq [M, N] s8, sg [M, N/jc] f32 and, for the split form, the chunks' s32
// sums [N/jc, M, K2].
extern "C" size_t int8_ffn_workspace(int M, int K, int N, int K2, int jc,
                                     int split) {
  return align256((size_t)M * K) + align256((size_t)M * 4) +
         align256((size_t)M * N) + align256((size_t)M * (N / jc) * 4) +
         (split ? (size_t)(N / jc) * M * K2 * 4 : 0);
}

// C entry: x bf16 [M, K], w1t s8 [N, K] and w2t s8 [K2, N] (the K-major
// weights), s1/b1 f32 [N], s2/b2 f32 [K2], out bf16 [M, K2], work
// (int8_ffn_workspace bytes), all contiguous and 16-byte aligned; split 1
// takes the split form. Launches: quantize, up, down (+ reduce when
// split). Returns a cudaError_t (0 = launched). Supported: jc ∈ {128,
// 256, 512} dividing N, K % 16 == 0, K2 % 8 == 0, mode 0 tanh / 1 erf /
// 2 quick.
extern "C" int int8_ffn_launch(const void* x, const void* w1t, const void* s1,
                               const void* b1, const void* w2t,
                               const void* s2, const void* b2, void* out,
                               void* work, int M, int K, int N, int K2, int jc,
                               int mode, int split, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 || K2 <= 0 || K2 % 8 || mode < 0 ||
      mode > 2 || (jc != 128 && jc != 256 && jc != 512) || N % jc)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  int8_t* xq = reinterpret_cast<int8_t*>(w);
  w += align256((size_t)M * K);
  float* sx = reinterpret_cast<float*>(w);
  w += align256((size_t)M * 4);
  int8_t* gq = reinterpret_cast<int8_t*>(w);
  w += align256((size_t)M * N);
  float* sg = reinterpret_cast<float*>(w);
  w += align256((size_t)M * (N / jc) * 4);
  int* part = split ? reinterpret_cast<int*>(w) : nullptr;

  cudaError_t e = i8g::quantize_rows(static_cast<const __nv_bfloat16*>(x), xq,
                                     sx, M, K, st);
  if (e != cudaSuccess) return e;
#define INT8_FFN_UP(J, MD)                                                   \
  if (jc == (J) && mode == (MD))                                             \
    e = launch_up<J, MD>(xq, sx, w1t, s1, b1, gq, sg, M, K, N, st);
  INT8_FFN_UP(128, MODE_TANH) INT8_FFN_UP(128, MODE_ERF)
  INT8_FFN_UP(128, MODE_QUICK) INT8_FFN_UP(256, MODE_TANH)
  INT8_FFN_UP(256, MODE_ERF) INT8_FFN_UP(256, MODE_QUICK)
  INT8_FFN_UP(512, MODE_TANH) INT8_FFN_UP(512, MODE_ERF)
  INT8_FFN_UP(512, MODE_QUICK)
#undef INT8_FFN_UP
  if (e != cudaSuccess) return e;
  if (!split)
    return launch_down<false>(gq, sg, w2t, s2, b2, out, nullptr, M, N, K2, jc,
                              st);
  e = launch_down<true>(gq, sg, w2t, s2, b2, out, part, M, N, K2, jc, st);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)M * K2;
  ffn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, sg, static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), M, K2, N / jc);
  return cudaGetLastError();
}

extern "C" const char* int8_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
