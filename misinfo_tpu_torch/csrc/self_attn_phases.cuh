// Device bodies and host helpers of the self-attention decode step
// (self_attn_step.cu), shared with the whole-layer kernel (layer_step.cu).
//
// The attention of one (batch row, head) over cache rows 0..pos is split
// into C chunks of consecutive rows (self_split: C from pos + 1 and the SM
// count, so that B·H·C blocks fill the card). Each chunk is walked by one
// block of SELF_ATT threads with the chunk functions below, straight from
// the caches (a copy through shared memory first measured slower):
//  - chunk_scores: s = q·K_r / √64 in f32, eight lanes per cache row (the
//    row's 128 bytes in 16-byte loads, 32 rows per block and pass, the
//    loads of up to BATCH passes issued before their arithmetic), the
//    eight partial dots added by a butterfly; the chunk's max m_z;
//  - chunk_sum: the chunk's l_z = Σ exp(s − m_z);
//  - merge_chunks: the global max m = max_z m_z and the exp-sum
//    l = Σ_z exp(m_z − m)·l_z, in chunk order;
//  - chunk_pv: p = bf16(exp(s − m) / l), rounded after the global max
//    and sum as the TPU kernel and the plain version round each
//    probability before the PV product; then o_z = Σ_r p_r·V_r over the
//    chunk, eight lanes per V row (eight dims a lane from one 16-byte
//    load), the 32 row groups' sums added in a fixed order.
// ctx = bf16(Σ_z o_z) in chunk order. The chunks exchange (m_z, l_z) and
// o_z between them: in self_attn_step.cu the chunks of one (row, head)
// belong to one thread-block cluster and the exchange goes through
// distributed shared memory; in layer_step.cu (a cooperative launch, which
// takes no cluster) each chunk is a virtual block of the grid and the
// exchange goes through global memory. The same functions over the same
// rows in the same order: the same bits on both routes.
//
// Rows past pos are never read: the TPU kernel masks them to −1e9 before
// an f32 softmax, and exp(−1e9 − max) is exactly 0 in f32. A one-row query
// (M = 1) gives the tensor cores nothing to do; the work is the cache's
// bytes, and at decode sizes the latency of the chain of dependent steps.

#pragma once

#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace dec {

constexpr int SELF_ATT = 256;                 // threads of a chunk's block
constexpr int ROW_LANES = 8;                  // lanes per cache row
constexpr int ROW_GROUPS = SELF_ATT / ROW_LANES;   // rows in flight
constexpr int MAX_CHUNKS = 8;                 // the portable cluster size
constexpr int MIN_CHUNK_ROWS = 64;

constexpr int MAX_CLUSTER = 16;   // with the non-portable cluster size
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory of a block

// Chunks of rows 0..pos: about one block per SM over B·H (batch row, head)
// pairs, at most `most` chunks, at least MIN_CHUNK_ROWS rows a chunk (but
// one chunk at least). Returns C; *rc_out gets the rows per chunk (the
// last chunk may have fewer).
inline int self_chunks(int B, int H, int pos, int sms, int most,
                       int* rc_out) {
  const int n = pos + 1;
  int c = (sms + B * H - 1) / (B * H);
  int hi = (n + MIN_CHUNK_ROWS - 1) / MIN_CHUNK_ROWS;
  hi = hi < most ? hi : most;
  c = c < 1 ? 1 : (c > hi ? hi : c);
  const int rc = (n + c - 1) / c;
  *rc_out = rc;
  return (n + rc - 1) / rc;
}

// Shared memory of self_attn_step.cu's attention block for chunks of rc
// rows: the scores, q, the row groups' PV partials, the warps' scratch,
// what the cluster reads (m_z, l_z, o_z); with the o product folded in
// (fold_w columns of W_o per block, w_bytes a weight), the context row and
// the W_o tile.
inline size_t self_cluster_smem(int rc, int D, int fold_w, int w_bytes) {
  size_t f = (size_t)rc + HD + ROW_GROUPS * HD + SELF_ATT / 32 + 2 + HD;
  if (fold_w) f += D;
  return (f * 4 + 15) / 16 * 16 + (size_t)D * fold_w * w_bytes;
}

// The attention's split for one call: chunks C of rc rows, and whether the
// o product is folded into the attention launch (fold_w > 0: that many
// output columns per block). The fold makes each batch row's H·C blocks
// one cluster, so it needs H ≤ 16 (C ≤ 16 / H). Measured on the H100, it
// pays only for int8 W_o (whose separate product quantizes the context
// in every block), with a head split into C ≥ 2 chunks (with one chunk
// the row's H blocks each carry 64 columns of W_o) and the B·H·C blocks
// in one wave (past it every batch row's blocks stage all of W_o).
// Otherwise C ≤ 8 and the o product is a launch of its own. One function
// for self_attn_step.cu and layer_step.cu, so that both split the rows
// alike.
struct SelfSplit {
  int C, rc, fold_w;
};
inline SelfSplit self_split(int B, int H, int pos, int sms, int w_bytes) {
  SelfSplit sp;
  const int D = H * HD;
  if (H <= MAX_CLUSTER && w_bytes == 1) {
    sp.C = self_chunks(B, H, pos, sms, MAX_CLUSTER / H, &sp.rc);
    sp.fold_w = D / (H * sp.C);
    if (sp.C > 1 && B * H * sp.C <= sms &&
        self_cluster_smem(sp.rc, D, sp.fold_w, w_bytes) <= MAX_SMEM)
      return sp;
  }
  sp.C = self_chunks(B, H, pos, sms, MAX_CHUNKS, &sp.rc);
  sp.fold_w = 0;
  return sp;
}

constexpr int BATCH = 8;   // cache rows in flight per row group

// Scores of a chunk's n rows, k[r·ks .. r·ks + 64) (16-byte aligned rows),
// against qs [HD] f32: sc[r] = (q·k_r)/√64. Returns the chunk's max to
// every thread. `scr` holds a float per warp. The loads of BATCH rows per
// row group are issued before their arithmetic.
__device__ __forceinline__ float chunk_scores(float* sc, const float* qs,
                                              const __nv_bfloat16* k, int ks,
                                              int n, float* scr) {
  const int grp = threadIdx.x / ROW_LANES;
  const int c8 = (threadIdx.x % ROW_LANES) * 8;
  const float root = sqrtf((float)HD);
  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = qs[c8 + e];
  float m = NEG;
  for (int r0 = 0; r0 < n; r0 += ROW_GROUPS * BATCH) {
    uint4 u[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + j * ROW_GROUPS + grp;
      u[j] = r < n ? *reinterpret_cast<const uint4*>(k + (size_t)r * ks + c8)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (r0 + j * ROW_GROUPS >= n) break;        // uniform: the shuffles
      const int r = r0 + j * ROW_GROUPS + grp;
      const __nv_bfloat162* h2 =
          reinterpret_cast<const __nv_bfloat162*>(&u[j]);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        acc = __fadd_rn(acc, __fmul_rn(qv[2 * e], f.x));
        acc = __fadd_rn(acc, __fmul_rn(qv[2 * e + 1], f.y));
      }
      // the eight lanes of a row: every lane gets the same bits
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 4));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      if (r < n) {
        const float s = __fdiv_rn(acc, root);
        if (threadIdx.x % ROW_LANES == 0) sc[r] = s;
        m = fmaxf(m, s);
      }
    }
  }
  return block_max(m, scr, whole_block());   // its barriers publish sc
}

// l_z = Σ exp(s − m_z) over the chunk's n scores (to every thread).
__device__ __forceinline__ float chunk_sum(const float* sc, int n, float mz,
                                           float* scr) {
  float l = 0.f;
  for (int r = threadIdx.x; r < n; r += SELF_ATT)
    l = __fadd_rn(l, expf(__fsub_rn(sc[r], mz)));
  return block_sum(l, scr, whole_block());
}

// The global max m and exp-sum l of C chunks, get(z) giving (m_z, l_z),
// in chunk order.
template <typename Get>
__device__ __forceinline__ void merge_chunks(int C, Get get, float& m,
                                             float& l) {
  m = NEG;
  for (int z = 0; z < C; ++z) m = fmaxf(m, get(z).x);
  l = 0.f;
  for (int z = 0; z < C; ++z) {
    const float2 c = get(z);
    l = __fadd_rn(l, __fmul_rn(expf(__fsub_rn(c.x, m)), c.y));
  }
}

// p = bf16(exp(s − m) / l) in place, then o[d] = Σ_r p_r·v_r[d] over the
// chunk's n rows v[r·vs .. r·vs + 64) into o [HD] (by threads 0..63; the
// caller synchronizes before reading it): each row group's rows in order
// (the loads of BATCH rows issued first), a warp's four groups by a
// butterfly, then the eight warps in order. `red` holds ROW_GROUPS·HD
// floats.
__device__ __forceinline__ void chunk_pv(float* sc, const __nv_bfloat16* v,
                                         int vs, int n, float m, float l,
                                         float* red, float* o) {
  for (int r = threadIdx.x; r < n; r += SELF_ATT)
    sc[r] = bf(__fdiv_rn(expf(__fsub_rn(sc[r], m)), l));
  __syncthreads();
  const int grp = threadIdx.x / ROW_LANES;
  const int c8 = (threadIdx.x % ROW_LANES) * 8;
  float acc[8] = {};
  for (int r0 = grp; r0 < n; r0 += ROW_GROUPS * BATCH) {
    uint4 u[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + j * ROW_GROUPS;
      u[j] = r < n ? *reinterpret_cast<const uint4*>(v + (size_t)r * vs + c8)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + j * ROW_GROUPS;
      if (r >= n) break;
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(&u[j]);
      const float p = sc[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(v2[i]);
        acc[2 * i] = __fmaf_rn(p, f.x, acc[2 * i]);
        acc[2 * i + 1] = __fmaf_rn(p, f.y, acc[2 * i + 1]);
      }
    }
  }
  // a warp's four row groups by a butterfly (the same bits on each lane),
  // then the warps in order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], 8));
    acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], 16));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < ROW_LANES) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[warp * HD + c8 + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < HD) {
    float t = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < SELF_ATT / 32; ++w)
      t = __fadd_rn(t, red[w * HD + threadIdx.x]);
    o[threadIdx.x] = t;
  }
}

// The int8 o product folded into the attention: W output columns of
// x + o(ctx) for one batch row, out pointing at the first. Lane d of the
// context row is bf16(Σ_z o_z[d]) over its head's C chunks in chunk order,
// oload(d, z) giving chunk z's lane d % HD of head d / HD; the row is
// quantized by its abs-max as quantize_rows, then multiplied by the W_o
// slab wt [D, W] (its cp.async copies waited for here) in int32 sums,
// exact in any order: the bits of the separate o product. x_n, s_n, b_n:
// the residual, scale and bias of this thread's column, loaded before the
// caller's wait. Shared memory: row [D], part [SELF_ATT], scr the warps'
// scratch. For SELF_ATT threads.
template <typename OLoad>
__device__ __forceinline__ void fold_o(OLoad oload, int C, int D, int W,
                                       const int8_t* wt, float* row,
                                       int* part, float* scr, float x_n,
                                       float s_n, float b_n,
                                       __nv_bfloat16* out) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int d = tid; d < D; d += SELF_ATT) {
    float s = 0.f;
    for (int z = 0; z < C; ++z) s = __fadd_rn(s, oload(d, z));
    row[d] = bf(s);
  }
  cp_async_wait_all();        // the slab
  __syncthreads();
  // max(amax / 127, 1e-8) and the levels, as quantize_rows
  float amax = 0.f;
  for (int d = tid; d < D; d += SELF_ATT) amax = fmaxf(amax, fabsf(row[d]));
  const float s_row = row_scale(block_max(amax, scr, whole_block()));
  for (int d = tid; d < D; d += SELF_ATT) row[d] = (float)quant(row[d], s_row);
  __syncthreads();
  // W columns; SELF_ATT / W slices of the rows, each over four interleaved
  // sums, slices and sums added in a fixed order
  const int col = tid % W, slice = tid / W, slices = SELF_ATT / W;
  int acc[4] = {};
  for (int k = slice; k < D; k += 4 * slices) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kk = k + a * slices;
      if (kk < D) acc[a] += (int)row[kk] * wval(wt[kk * W + col]);
    }
  }
  part[slice * W + col] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (tid < W) {
    int s = part[tid];
    for (int i = 1; i < slices; ++i) s += part[i * W + tid];
    // finish<int8_t, EP_RESID> with the values loaded before the wait
    const float y = bf(__fadd_rn(
        __fmul_rn(__fmul_rn((float)s, s_row), s_n), b_n));
    out[tid] = __float2bfloat16_rn(__fadd_rn(x_n, y));
  }
}

inline size_t self_part_bytes(int B, int D, int sms) {
  const size_t p1 = gemm_part_bytes(B, D, 3 * D, sms);
  const size_t p2 = gemm_part_bytes(B, D, D, sms);
  return p1 > p2 ? p1 : p2;
}

}  // namespace dec
