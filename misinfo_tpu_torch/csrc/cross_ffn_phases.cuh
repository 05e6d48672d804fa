// Device bodies and host helpers of the cross-attention + FFN decode step
// (cross_ffn_step.cu), shared with its int8-plane form
// (cross_ffn_step_i8cc.cu) and the whole-layer kernel (layer_step.cu).

#pragma once

#include "decode_common.cuh"

namespace dec {

constexpr int CROSS_ATT = 128;   // threads of one cross-attention body
constexpr int PV_GROUPS = CROSS_ATT / 8;   // rows in flight in the PV sum

// Floats of one body's shared memory: q, the chunk's scores, the PV
// partials (reused by the chunk combine), the warps' scratch and the
// last-body flag.
__host__ __device__ inline int cross_att_smem_floats(int tc) {
  return HD + tc + PV_GROUPS * HD + CROSS_ATT / 32 + 1;
}
inline size_t cross_att_smem(int tc) {
  return (size_t)cross_att_smem_floats(tc) * 4;
}

// Head h of batch row b over T chunk z (flash-decoding): the scores
// q·K_t / √64 of the chunk's positions (−1e9 from t_actual on), their max
// m_z, the exp-sum l_z of exp(s − m_z), and o_z = Σ_t exp(s_t − m_z)·V_t in
// f32, to po [chunks, B, D], pm and pl [chunks, B, H]. The last of the
// head's `ch` chunk bodies to finish (ticket tickets[b·H + h], zero on
// entry and left zero) combines them into the head's 64 lanes of the
// context row, ctx = bf16(Σ_z exp(m_z − m)·o_z / Σ_z exp(m_z − m)·l_z), m
// the max over the chunks: the probabilities are never rounded, where the
// plain version rounds them to bf16. The combine's sums run in a fixed
// order (each half of the chunks in chunk order, then the halves added),
// so every route through this body gets the same bits. `sm` holds
// cross_att_smem(tc) bytes. For a team of CROSS_ATT threads: the
// reductions' order is theirs.
__device__ __forceinline__ void cross_attn_body(
    float* sm, int h, int b, int z, int H, int B, int ch,
    const __nv_bfloat16* q, const __nv_bfloat16* __restrict__ ck,
    const __nv_bfloat16* __restrict__ cv, float* po, float* pm, float* pl,
    int* tickets, __nv_bfloat16* ctx, int D, int T, int t_actual, int tc,
    const Team& tm) {
  float* qs = sm;                 // [HD]
  float* e = qs + HD;             // [tc] scores, then their exponentials
  float* red = e + tc;            // [PV_GROUPS, HD]
  float* scr = red + PV_GROUPS * HD;
  int* last = reinterpret_cast<int*>(scr + CROSS_ATT / 32);
  wait_prior_grid();
  if (tm.tid < HD) qs[tm.tid] = ld(q + (size_t)b * D + h * HD + tm.tid);
  team_sync(tm);
  const float root = sqrtf((float)HD);
  const int t0 = z * tc, t1 = min(T, t0 + tc);
  float m = NEG;
  for (int t = t0 + tm.tid; t < t1; t += CROSS_ATT) {
    const float s =
        t < t_actual
            ? __fdiv_rn(row_dot(ck + ((size_t)b * T + t) * D + h * HD, qs),
                        root)
            : NEG;
    e[t - t0] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, scr, tm);
  float l = 0.f;
  for (int t = t0 + tm.tid; t < t1; t += CROSS_ATT) {
    const float x = expf(__fsub_rn(e[t - t0], m));
    e[t - t0] = x;
    l = __fadd_rn(l, x);
  }
  l = block_sum(l, scr, tm);      // its barriers publish e
  // eight threads per V row, 16 bytes (eight lanes of the head) each
  const int grp = tm.tid >> 3, c8 = (tm.tid & 7) * 8;
  float acc[8] = {};
#pragma unroll 4
  for (int t = t0 + grp; t < t1; t += PV_GROUPS) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        cv + ((size_t)b * T + t) * D + h * HD + c8);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float p = e[t - t0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(v2[i]);
      acc[2 * i] = __fmaf_rn(p, f.x, acc[2 * i]);
      acc[2 * i + 1] = __fmaf_rn(p, f.y, acc[2 * i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[grp * HD + c8 + i] = acc[i];
  team_sync(tm);
  const size_t zbh = ((size_t)z * B + b) * H + h;
  if (tm.tid < HD) {
    float s = red[tm.tid];
    for (int g = 1; g < PV_GROUPS; ++g) s = __fadd_rn(s, red[g * HD + tm.tid]);
    po[zbh * HD + tm.tid] = s;
  }
  if (tm.tid == 0) {
    pm[zbh] = m;
    pl[zbh] = l;
  }

  // the head's last chunk body combines the head's chunks
  __threadfence();
  team_sync(tm);
  int* ticket = tickets + b * H + h;
  if (tm.tid == 0) *last = atomicAdd(ticket, 1) == ch - 1;
  team_sync(tm);
  if (!*last) return;
  __threadfence();
  float* fac = red;               // [ch] the chunks' maxima, then factors
  float* lz = red + ch;           // [ch] their exp-sums
  float* half = red + 2 * ch;     // [2·HD]
  for (int zz = tm.tid; zz < ch; zz += CROSS_ATT) {
    const size_t i = ((size_t)zz * B + b) * H + h;
    fac[zz] = __ldcg(pm + i);
    lz[zz] = __ldcg(pl + i);
  }
  team_sync(tm);
  if (tm.tid == 0) {
    float mx = fac[0], lt = 0.f;
    for (int zz = 1; zz < ch; ++zz) mx = fmaxf(mx, fac[zz]);
    for (int zz = 0; zz < ch; ++zz) {
      fac[zz] = expf(__fsub_rn(fac[zz], mx));
      lt = __fadd_rn(lt, __fmul_rn(fac[zz], lz[zz]));
    }
    scr[0] = lt;
  }
  team_sync(tm);
  // lane d of the head over one half of the chunks, in chunk order
  const int d = tm.tid & (HD - 1), hf = tm.tid >> 6, mid = (ch + 1) >> 1;
  float s = 0.f;
#pragma unroll 4
  for (int zz = hf ? mid : 0; zz < (hf ? ch : mid); ++zz)
    s = __fadd_rn(s, __fmul_rn(fac[zz],
                               __ldcg(po + (((size_t)zz * B + b) * H + h) *
                                               HD + d)));
  half[tm.tid] = s;
  team_sync(tm);
  if (tm.tid < HD)
    ctx[(size_t)b * D + h * HD + d] = __float2bfloat16_rn(
        __fdiv_rn(__fadd_rn(half[d], half[HD + d]), scr[0]));
  if (tm.tid == 0) *ticket = 0;
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

// Tickets a call needs: one per column tile of its widest product, one
// per (batch row, head) of the attention.
inline int cross_tickets(int D, int F) {
  const int g = gemm_tickets(D > F ? D : F), a = MAXB * (D / HD);
  return g > a ? g : a;
}

inline size_t cross_part_bytes(int B, int D, int F, int sms) {
  size_t m = gemm_part_bytes(B, D, D, sms);
  const size_t a = gemm_part_bytes(B, D, F, sms);
  const size_t c = gemm_part_bytes(B, F, D, sms);
  m = a > m ? a : m;
  return c > m ? c : m;
}

// What follows the attention in both forms of the step, three launches:
// x2 = x + o(ctx); out = x2 + W2·gelu(W1·LN(x2)).
template <typename WT>
cudaError_t after_attention(const __nv_bfloat16* x, const __nv_bfloat16* ctx,
                            const WT* wo, const float* so, const float* bo,
                            const float* ln2_g, const float* ln2_b,
                            const WT* w1, const float* s1, const float* b1,
                            const WT* w2, const float* s2, const float* b2,
                            void* part, int* tickets, __nv_bfloat16* x2,
                            __nv_bfloat16* g, __nv_bfloat16* out, int B,
                            int D, int F, int sms, cudaStream_t st) {
  cudaError_t e = gemm<WT, IN_ROW, EP_RESID>(
      In{ctx}, wo, part, nullptr, tickets, Ep{so, bo, x, x2}, B, D, D, sms,
      st);
  if (e != cudaSuccess) return e;
  e = gemm<WT, IN_LN, EP_GELU>(In{x2, ln2_g, ln2_b}, w1, part, nullptr,
                               tickets, Ep{s1, b1, nullptr, g}, B, D, F, sms,
                               st);
  if (e != cudaSuccess) return e;
  return gemm<WT, IN_ROW, EP_RESID>(In{g}, w2, part, nullptr, tickets,
                                    Ep{s2, b2, x2, out}, B, F, D, sms, st);
}

}  // namespace dec
