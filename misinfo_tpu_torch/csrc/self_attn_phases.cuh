// Device bodies and host helpers of the self-attention decode step
// (self_attn_step.cu), shared with the whole-layer kernel (layer_step.cu).

#pragma once

#include "decode_common.cuh"

namespace dec {

constexpr int SELF_ATT = 256;   // threads of the self-attention body

inline size_t self_attention_smem(int pos) {
  return (size_t)(HD + SELF_ATT + pos + 1) * 4;
}

// Head h of batch row b: one thread per cache row for the scores, over
// rows 0..pos; `sm` holds self_attention_smem(pos) bytes. For a whole
// block of SELF_ATT threads.
__device__ __forceinline__ void self_attention_body(
    float* sm, int h, int b, const __nv_bfloat16* q,
    const __nv_bfloat16* ck,
    const __nv_bfloat16* cv, __nv_bfloat16* ctx,
    int D, int S, int pos) {
  const Team tm = whole_block();
  float* qs = sm;                 // [HD]
  float* scr = qs + HD;           // [SELF_ATT]: warp scratch, then partials
  float* sc = scr + SELF_ATT;     // [pos + 1]
  wait_prior_grid();              // q and row `pos` of the caches
  if (threadIdx.x < HD) qs[threadIdx.x] = ld(q + (size_t)b * D + h * HD +
                                             threadIdx.x);
  __syncthreads();
  const float root = sqrtf((float)HD);
  float m = NEG;
  for (int s = threadIdx.x; s <= pos; s += SELF_ATT) {
    sc[s] = __fdiv_rn(row_dot(ck + ((size_t)b * S + s) * D + h * HD, qs),
                      root);
    m = fmaxf(m, sc[s]);
  }
  m = block_max(m, scr, tm);
  float l = 0.f;
  for (int s = threadIdx.x; s <= pos; s += SELF_ATT) {
    const float e = expf(__fsub_rn(sc[s], m));
    sc[s] = e;
    l = __fadd_rn(l, e);
  }
  l = block_sum(l, scr, tm);
  for (int s = threadIdx.x; s <= pos; s += SELF_ATT)
    sc[s] = bf(__fdiv_rn(sc[s], l));
  __syncthreads();
  constexpr int G = SELF_ATT / HD;            // row groups of the PV sum
  const int d = threadIdx.x & (HD - 1), grp = threadIdx.x / HD;
  float acc = 0.f;
  for (int s = grp; s <= pos; s += G)
    acc = __fmaf_rn(sc[s], ld(cv + ((size_t)b * S + s) * D + h * HD + d),
                    acc);
  scr[threadIdx.x] = acc;   // the warp scratch is no longer needed
  __syncthreads();
  if (threadIdx.x < HD) {
    float c = scr[d];
    for (int g = 1; g < G; ++g) c = __fadd_rn(c, scr[g * HD + d]);
    ctx[(size_t)b * D + h * HD + d] = __float2bfloat16_rn(c);
  }
}

inline size_t self_part_bytes(int B, int D, int sms) {
  const size_t p1 = gemm_part_bytes(B, D, 3 * D, sms);
  const size_t p2 = gemm_part_bytes(B, D, D, sms);
  return p1 > p2 ? p1 : p2;
}

}  // namespace dec
