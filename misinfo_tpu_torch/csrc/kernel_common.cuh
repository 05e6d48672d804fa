// Pieces shared by the tensor-core kernels (int8_ffn.cu, K1; int8_dense.cu,
// K2; fused_ffn.cu, K5): warp reductions, bf16 rounding, IEEE per-row int8
// quantization, the 16x16-tile layout that WMMA s8 fragments load, and the
// FFN activations with the casts of the JAX package's _act.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// round(v / s) half-to-even with an IEEE division, clipped to ±127
__device__ __forceinline__ int8_t quant(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return (int8_t)max(-127, min(127, q));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Offset of element (r, c) in a matrix stored as 16x16 tiles, tile (r/16,
// c/16) at ((r/16)·ct + c/16)·256 with rows of 16 bytes. Every tile starts
// 256-byte aligned, as WMMA loads require.
__device__ __forceinline__ int tile_off(int r, int c, int ct) {
  return (((r >> 4) * ct + (c >> 4)) << 8) + ((r & 15) << 4) + (c & 15);
}

enum { MODE_TANH = 0, MODE_ERF = 1, MODE_QUICK = 2 };

// Activation of the f32 pre-activation h32 with the casts of the JAX
// package's _act / _act_f32: with ROUND (a bf16 compute dtype) h is rounded
// to bf16 first, computed in f32, and each product rounded to bf16 again.
template <bool ROUND>
__device__ __forceinline__ float act(float h32, int mode) {
  const float h = ROUND ? bf16_round(h32) : h32;
  if (mode == MODE_QUICK) {
    float s = 1.0f / (1.0f + expf(-1.702f * h));
    if (ROUND) s = bf16_round(s);
    return ROUND ? bf16_round(h * s) : h * s;
  }
  float g;
  if (mode == MODE_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    g = h * (0.5f * (1.0f + tanhf(c * (h + 0.044715f * (h * h * h)))));
  } else {
    g = 0.5f * h * erfcf(-h * 0.7071067811865476f);
  }
  return ROUND ? bf16_round(g) : g;
}

}  // namespace int8k
