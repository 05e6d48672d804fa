// Device bodies and host helpers of the cross-attention + FFN decode step
// (cross_ffn_step.cu), shared with its int8-plane form
// (cross_ffn_step_i8cc.cu) and the whole-layer kernel (layer_step.cu).

#pragma once

#include "decode_common.cuh"

namespace dec {

constexpr int CROSS_ATT = 128;   // threads of one cross-attention body

// Scores of head h, batch row b over T chunk z, [B, H, T] f32; `qs` holds
// HD floats. For a team of whole warps.
__device__ __forceinline__ void cross_scores_body(
    float* qs, int h, int b, int z, int H, const __nv_bfloat16* q,
    const __nv_bfloat16* __restrict__ ck, float* sc, int D,
    int T, int t_actual, int tc, const Team& tm) {
  const int warp = tm.tid >> 5, lane = tm.tid & 31, nw = tm.n >> 5;
  if (tm.tid < HD) qs[tm.tid] = ld(q + (size_t)b * D + h * HD + tm.tid);
  team_sync(tm);
  const float root = sqrtf((float)HD);
  const int t0 = z * tc, t1 = min(T, t0 + tc);
  float* row = sc + ((size_t)b * H + h) * T;
  for (int t = t0 + warp; t < t1; t += nw) {
    const __nv_bfloat16* kr = ck + ((size_t)b * T + t) * D + h * HD;
    float p = __fmul_rn(qs[2 * lane], ld(kr + 2 * lane));
    p = __fadd_rn(p, __fmul_rn(qs[2 * lane + 1], ld(kr + 2 * lane + 1)));
    p = warp_sum(p);
    if (lane == 0) row[t] = t < t_actual ? __fdiv_rn(p, root) : NEG;
  }
}

__host__ __device__ inline int cross_pv_smem_floats(int tc) {
  return CROSS_ATT + tc;
}
inline size_t cross_pv_smem(int tc) {
  return (size_t)cross_pv_smem_floats(tc) * 4;
}

// Probabilities and the partial context of head h, batch row b over T
// chunk z: pctx [chunks, B, D] f32. `sm` holds cross_pv_smem(tc) bytes.
// For a team of CROSS_ATT threads: the reductions' order is theirs.
__device__ __forceinline__ void cross_pv_body(
    float* sm, int h, int b, int z, int H, int B,
    const float* sc, const __nv_bfloat16* __restrict__ cv,
    float* pctx, int D, int T, int tc, const Team& tm) {
  float* scr = sm;                // [CROSS_ATT] warp scratch, then halves
  float* p = sm + CROSS_ATT;      // [tc]
  const float* row = sc + ((size_t)b * H + h) * T;
  float m = NEG;
  for (int t = tm.tid; t < T; t += CROSS_ATT) m = fmaxf(m, row[t]);
  m = block_max(m, scr, tm);
  float l = 0.f;
  for (int t = tm.tid; t < T; t += CROSS_ATT)
    l = __fadd_rn(l, expf(__fsub_rn(row[t], m)));
  l = block_sum(l, scr, tm);
  const int t0 = z * tc, t1 = min(T, t0 + tc);
  for (int t = t0 + tm.tid; t < t1; t += CROSS_ATT)
    p[t - t0] = bf(__fdiv_rn(expf(__fsub_rn(row[t], m)), l));
  team_sync(tm);
  const int d = tm.tid & (HD - 1), half = tm.tid >> 6;
  float acc = 0.f;
  for (int t = t0 + half; t < t1; t += 2)
    acc = __fmaf_rn(p[t - t0], ld(cv + ((size_t)b * T + t) * D + h * HD + d),
                    acc);
  scr[tm.tid] = acc;
  team_sync(tm);
  if (tm.tid < HD)
    pctx[((size_t)z * B + b) * D + h * HD + d] =
        __fadd_rn(scr[d], scr[d + HD]);
}

// Element i of ctx [B, D] = bf16(Σ_j pctx[j], in chunk order)
__device__ __forceinline__ void combine_elem(int i,
                                             const float* pctx,
                                             __nv_bfloat16* ctx,
                                             int n, int chunks) {
  float s = 0.f;
  for (int j = 0; j < chunks; ++j) s = __fadd_rn(s, pctx[(size_t)j * n + i]);
  ctx[i] = __float2bfloat16_rn(s);
}

// T chunks: about two attention blocks per SM, at least 32 rows a chunk.
inline int t_chunks(int B, int H, int T, int sms, int* tc_out) {
  int ch = (2 * sms + B * H - 1) / (B * H);
  const int hi = (T + 31) / 32;
  ch = ch < 1 ? 1 : (ch > hi ? hi : ch);
  const int tc = (T + ch - 1) / ch;
  *tc_out = tc;
  return (T + tc - 1) / tc;
}

inline size_t cross_part_bytes(int B, int D, int F, int sms) {
  size_t m = gemm_part_bytes(B, D, D, sms);
  const size_t a = gemm_part_bytes(B, D, F, sms);
  const size_t c = gemm_part_bytes(B, F, D, sms);
  m = a > m ? a : m;
  return c > m ? c : m;
}

// What follows the context in both forms of the step, six launches:
// x2 = x + o(ctx); out = x2 + W2·gelu(W1·LN(x2)).
template <typename WT>
cudaError_t after_attention(const __nv_bfloat16* x, const __nv_bfloat16* ctx,
                            const WT* wo, const float* so, const float* bo,
                            const float* ln2_g, const float* ln2_b,
                            const WT* w1, const float* s1, const float* b1,
                            const WT* w2, const float* s2, const float* b2,
                            void* part, float* rs, __nv_bfloat16* x2,
                            __nv_bfloat16* g, __nv_bfloat16* out, int B,
                            int D, int F, int sms, cudaStream_t st) {
  int ks;
  cudaError_t e = gemm<WT, IN_ROW>(ctx, nullptr, nullptr, wo, part, rs, B, D,
                                   D, sms, st, &ks);
  if (e != cudaSuccess) return e;
  e = run_epilogue<WT, EP_RESID>(part, ks, so, bo, rs, x, x2, B, D, st);
  if (e != cudaSuccess) return e;
  e = gemm<WT, IN_LN>(x2, ln2_g, ln2_b, w1, part, rs, B, D, F, sms, st, &ks);
  if (e != cudaSuccess) return e;
  e = run_epilogue<WT, EP_GELU>(part, ks, s1, b1, rs, nullptr, g, B, F, st);
  if (e != cudaSuccess) return e;
  e = gemm<WT, IN_ROW>(g, nullptr, nullptr, w2, part, rs, B, F, D, sms, st,
                       &ks);
  if (e != cudaSuccess) return e;
  return run_epilogue<WT, EP_RESID>(part, ks, s2, b2, rs, x2, out, B, D, st);
}

}  // namespace dec
