// Whole-layer Whisper decode step for Hopper (sm_90a), int8 weights:
//   x1  = x + o1(selfattn(LN(x)))      new K/V row written into the caches
//   x2  = x1 + o2(crossattn(LN(x1)))   over the bf16 encoder K/V planes
//   out = x2 + W2·gelu(W1·LN(x2))
// in ONE kernel launch.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_layer.py
// ::_layer_step_kernel_i8 (K9), reached through fused_layer_step. That
// kernel is the int8 self-attention body followed by the int8
// cross-attention + FFN body, composed so that one launch per layer takes
// the place of two; its numerics are theirs by construction. The same here:
// the phases are the device bodies of self_attn_step.cu and
// cross_ffn_step.cu (self_attn_phases.cuh, cross_ffn_phases.cuh,
// decode_common.cuh), which those files launch as two or three and five
// kernels, walked by one persistent grid launched with
// cudaLaunchCooperativeKernel. Each phase loops over the block indices of
// the corresponding launch ("virtual blocks"). Where a sum is in floating
// point its partition is the two-call route's (the self-attention's chunks
// from self_split, the cross-attention's T chunks from t_chunks) and so is
// its order; the products' sums are int32, exact in any grouping, so their
// K split is this kernel's own. The output and the written cache rows are
// bit for bit those of self_attn_step_launch followed by
// cross_ffn_step_launch.
//
// What bounds it on this card: the two steps' bytes (the int8 weights
// 4·D² + 2·D·F, cache rows 0..pos, the bf16 cross planes 2·B·T·D·2), a few
// MB that the card streams in microseconds: the chain of dependent memory
// round trips in each phase decides the time, and a grid barrier ends a
// phase with nothing in flight across it. The design:
//  - Each product's K split keeps its virtual blocks within one round of
//    the grid (one_round_k); each block stages its weight tile with
//    cp.async as it starts the product (skinny_gemm_body). A tile staged
//    before the barrier that precedes its product, as the two-call route's
//    early launches stage theirs, measured no faster here.
//  - The self-attention runs one virtual block per (batch row, head,
//    chunk) of self_split, K6b's chunks, each on a block of its own
//    (B·H·C ≤ the grid; checked at launch, so that no block waits on a
//    virtual block it has still to run). The chunks exchange (m_z, l_z)
//    and o_z through global memory where K6 uses a cluster's distributed
//    shared memory (a cooperative launch takes no cluster), with the same
//    chunk functions and orders. With the o1 product folded in (as K6b
//    folds it: a chunk's share of W_o is 16 bytes or more a row, and every
//    chunk of the grid has its block), each chunk stages its slab of W_o
//    as it starts, waits for its batch row's chunks and computes its
//    columns of x1 = x + o1(ctx) with K6b's fold_o; otherwise the head's
//    last chunk (a ticket) forms ctx = bf16(Σ_z o_z) and the o1 product is
//    a phase of its own.
//  - The cross-attention bodies take team 0 of every block first, so that
//    they spread over the SMs.
//  - The counts that a batch row's chunks poll sit on L2 lines of their
//    own.
// Barriers: QKV | self-attention (+ o1) | [o1 |] q | cross-attention | o2
// | W1 | W2.
//
// The grid is sized from the occupancy of this kernel (at most two blocks
// per SM by its launch bounds, as the partitions aim at two blocks per SM),
// never from the problem; the whole grid must be resident for the
// barriers. Blocks have 256 threads, the width of skinny_gemm and of the
// self-attention body; the cross-attention body is written for 128 threads
// (its reduction order), so each block runs two of them side by side as
// teams that meet at named barriers (each team takes its own ticket for
// the chunk combine). A refused cooperative launch is returned as its
// error; nothing falls back to the two-call route.

#include <cooperative_groups.h>

#include <mutex>

#include "cross_ffn_phases.cuh"
#include "self_attn_phases.cuh"

namespace cg = cooperative_groups;
using namespace dec;

namespace {

constexpr int NPROD = 6;     // the products, in the order the phases run
enum { P_QKV, P_O1, P_Q, P_O2, P_W1, P_W2 };
constexpr int LINE = 32;     // ints per polled counter: an L2 line each

struct Params {
  const __nv_bfloat16* x;
  const float *ln1_g, *ln1_b;
  const int8_t* w[NPROD];           // wqkv, wo1, wq, wo2, w1, w2
  const float *sqkv, *bqkv;
  const float *so1, *bo1;
  const float *lnc_g, *lnc_b;
  const float *sq, *bq;
  const float *so2, *bo2;
  const float *ln2_g, *ln2_b;
  const float *s1, *b1;
  const float *s2, *b2;
  __nv_bfloat16 *ck, *cv;
  const __nv_bfloat16 *xk, *xv;
  __nv_bfloat16* out;
  int* tickets;
  int* sctr;     // the self-attention's counters (self_counters ints)
  // workspace
  int* part;
  __nv_bfloat16 *q, *ctx, *x1, *x2, *g;
  float *po, *pm, *pl;              // the cross-attention's chunks
  float2* sml;                      // the self-attention's (m_z, l_z)
  float* so;                        // its o_z
  int B, D, F, S, pos, T, t_actual;
  // partitions, from the SM count
  int ks[NPROD], kc[NPROD], ch, tc;
  int sc, src;              // the self-attention's chunks, rows per chunk
  int fw;                   // > 0: the o1 product folded in, fw columns a chunk
  // shared memory of a self-attention chunk: the folded o1 product's W_o
  // slab at 0, then the work area (a product and the cross-attention
  // bodies start at 0)
  int work, scf;
};

// The self-attention's counters, after the phases' tickets: per (batch
// row, head) its chunks' stats published and its chunks finished, and per
// batch row (a line each) its chunks finished.
__host__ __device__ inline int self_counters(int H) {
  return 2 * MAXB * H + MAXB * LINE;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Product i with its epilogue as a phase: virtual blocks (N / 32, ks).
template <int IN, int EP>
__device__ __forceinline__ void gemm_phase(unsigned char* smem, int i,
                                           const In& in, const Ep& ep,
                                           const Params& p) {
  const int K = i == P_W2 ? p.F : p.D;
  const int N = i == P_QKV ? 3 * p.D : (i == P_W1 ? p.F : p.D);
  const int tiles = N / TILE_N, ks = p.ks[i];
  for (int vb = blockIdx.x; vb < tiles * ks; vb += gridDim.x) {
    __syncthreads();            // the shared memory of the last round
    skinny_gemm_body<int8_t, IN, EP>(smem, vb % tiles, vb / tiles, in,
                                     p.w[i], p.part, nullptr, p.tickets, ep,
                                     p.B, K, N, p.kc[i], ks);
  }
}

// Self-attention chunk z of head h of batch row b (self_split's rows): the
// chunk's scores, m_z and l_z; with C > 1 chunks a head, (m_z, l_z)
// published to the siblings and theirs waited for (each has a block of its
// own: see layer_step_launch); the merge and the PV sum. Then either, with
// the o1 product folded in (fw > 0), every chunk of the batch row waits for
// the row's o_z and computes fw columns of x1 = x + o1(ctx) (fold_o, as
// K6b's folded launch does: its slab of W_o, columns [(h·C + z)·fw, +fw)
// over all D rows, in flight since the chunk began); or the head's last
// chunk (a ticket) forms the head's context lanes.
__device__ __forceinline__ void self_chunk(unsigned char* smem,
                                           const Params& p, int vb) {
  const int D = p.D, S = p.S, H = D / HD, C = p.sc, rc = p.src;
  const int z = vb % C, h = (vb / C) % H, b = vb / (C * H), bh = b * H + h;
  const int tid = threadIdx.x;
  int8_t* wt = reinterpret_cast<int8_t*>(smem);          // [D, fw]
  float* sc = reinterpret_cast<float*>(smem + p.work);   // [scf]
  float* qs = sc + p.scf;                                // [HD]
  float* red = qs + HD;                                  // [ROW_GROUPS, HD]
  float* scr = red + ROW_GROUPS * HD;                    // [SELF_ATT / 32]
  float* oz = scr + SELF_ATT / 32;                       // [HD]
  __shared__ int last;
  int* cnt = p.sctr + bh;                  // stats published
  int* tk = p.sctr + MAXB * H + bh;        // chunks finished
  int* rowc = p.sctr + 2 * MAXB * H + b * LINE;
  const int r0 = z * rc, n = min(rc, p.pos + 1 - r0);
  const size_t base = (size_t)b * S * D + h * HD + (size_t)r0 * D;
  const int W = p.fw, n0 = (h * C + z) * W;
  for (int i = tid; i < D * W / 16; i += THREADS) {       // the slab
    const int r = i / (W / 16), c = (i % (W / 16)) * 16;
    cp_async16(wt + r * W + c, p.w[P_O1] + (size_t)r * D + n0 + c);
  }
  if (tid < HD) qs[tid] = ld(p.q + (size_t)b * D + h * HD + tid);
  __syncthreads();
  const float mz = chunk_scores(sc, qs, p.ck + base, D, n, scr);
  const float lz = chunk_sum(sc, n, mz, scr);
  float m, l;
  if (C > 1) {
    float2* ml = p.sml + (size_t)bh * C;
    if (tid == 0) ml[z] = make_float2(mz, lz);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(cnt, 1);
      while (ld_acquire(cnt) < C) __nanosleep(32);
    }
    __syncthreads();
    merge_chunks(C, [&](int zz) { return __ldcg(ml + zz); }, m, l);
  } else {                      // every thread has its block's own
    merge_chunks(1, [&](int) { return make_float2(mz, lz); }, m, l);
  }
  chunk_pv(sc, p.cv + base, D, n, m, l, red, oz);
  __syncthreads();
  if (C > 1 || W)
    if (tid < HD) p.so[((size_t)bh * C + z) * HD + tid] = oz[tid];

  if (W) {
    // the epilogue's residual, scale and bias of this thread's column
    float x_n = 0.f, s_n = 1.f, b_n = 0.f;
    if (tid < W) {
      x_n = ld(p.x + (size_t)b * D + n0 + tid);
      s_n = p.so1[n0 + tid];
      b_n = p.bo1[n0 + tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(rowc, 1);
      while (ld_acquire(rowc) < H * C) __nanosleep(32);
    }
    __syncthreads();
    const float* so = p.so + (size_t)b * H * C * HD;
    fold_o([&](int d, int zz) {
             return __ldcg(so + ((size_t)(d / HD) * C + zz) * HD + d % HD);
           },
           C, D, W, wt, red, reinterpret_cast<int*>(sc), scr, x_n, s_n, b_n,
           p.x1 + (size_t)b * D + n0);
    return;
  }
  if (C > 1) {                  // the head's last chunk forms its context
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tk, 1) == C - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  if (tid < HD) {               // ctx = bf16(Σ_z o_z) in chunk order
    float s = 0.f;
    for (int zz = 0; zz < C; ++zz)
      s = __fadd_rn(s, C > 1 ? __ldcg(p.so + ((size_t)bh * C + zz) * HD + tid)
                             : oz[tid]);
    p.ctx[(size_t)b * D + h * HD + tid] = __float2bfloat16_rn(s);
  }
}

__global__ void __launch_bounds__(THREADS, 2) layer_step(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, H = p.D / HD;

  // ---- the self-attention step (self_attn_step.cu's launches)
  gemm_phase<IN_LN, EP_QKV>(smem, P_QKV, In{p.x, p.ln1_g, p.ln1_b},
                            Ep{p.sqkv, p.bqkv, nullptr, p.q, p.ck, p.cv, p.S,
                               p.pos},
                            p);
  grid.sync();                  // row `pos` is visible to every block
  for (int vb = blockIdx.x; vb < B * H * p.sc; vb += gridDim.x) {
    __syncthreads();
    self_chunk(smem, p, vb);
  }
  grid.sync();
  if (blockIdx.x == 0)          // the self-attention's counters back to zero
    for (int i = threadIdx.x; i < self_counters(H); i += THREADS)
      p.sctr[i] = 0;
  if (!p.fw) {
    gemm_phase<IN_ROW, EP_RESID>(smem, P_O1, In{p.ctx},
                                 Ep{p.so1, p.bo1, p.x, p.x1}, p);
    grid.sync();
  }

  // ---- the cross-attention + FFN step (cross_ffn_step.cu's five)
  gemm_phase<IN_LN, EP_Q>(smem, P_Q, In{p.x1, p.lnc_g, p.lnc_b},
                          Ep{p.sq, p.bq, nullptr, p.q}, p);
  grid.sync();
  {
    // two teams of CROSS_ATT threads, each on its own virtual block; team
    // 0 of every block first, so that the bodies spread over the SMs
    const int team = threadIdx.x / CROSS_ATT;
    const Team tm{(int)threadIdx.x % CROSS_ATT, CROSS_ATT, 1 + team};
    float* sm = reinterpret_cast<float*>(smem) +
                team * cross_att_smem_floats(p.tc);
    const int nvb = H * B * p.ch;
    for (int vb = blockIdx.x + team * gridDim.x; vb < nvb;
         vb += 2 * gridDim.x) {
      team_sync(tm);
      cross_attn_body(sm, vb % H, (vb / H) % B, vb / (H * B), H, B, p.ch,
                      p.q, p.xk, p.xv, p.po, p.pm, p.pl, p.tickets, p.ctx,
                      p.D, p.T, p.t_actual, p.tc, tm);
    }
  }
  grid.sync();
  gemm_phase<IN_ROW, EP_RESID>(smem, P_O2, In{p.ctx},
                               Ep{p.so2, p.bo2, p.x1, p.x2}, p);
  grid.sync();
  gemm_phase<IN_LN, EP_GELU>(smem, P_W1, In{p.x2, p.ln2_g, p.ln2_b},
                             Ep{p.s1, p.b1, nullptr, p.g}, p);
  grid.sync();
  gemm_phase<IN_ROW, EP_RESID>(smem, P_W2, In{p.g},
                               Ep{p.s2, p.b2, p.x2, p.out}, p);
}

// The products' K split: int8 partial sums are exact in any grouping, so
// this kernel need not split K as the two-call route does (its bits are the
// same whatever the split); it takes as many weight-row chunks as keep the
// product's virtual blocks within one round of the grid (about two blocks
// per SM), at most MAX_KC and at least 32 rows a chunk. Returns ks;
// *kc_out gets the rows per chunk.
int one_round_k(int K, int N, int sms, int* kc_out) {
  const int tiles = N / TILE_N;
  int ks = 2 * sms / tiles;
  const int lo = (K + MAX_KC - 1) / MAX_KC, hi = (K + 31) / 32;
  ks = ks < lo ? lo : (ks > hi ? hi : ks);
  const int kc = (K + ks - 1) / ks;
  *kc_out = kc;
  return (K + kc - 1) / kc;
}

// The six products' (K, N), in phase order.
void shapes(int D, int F, int out[NPROD][2]) {
  const int s[NPROD][2] = {{D, 3 * D}, {D, D}, {D, D}, {D, D}, {D, F},
                           {F, D}};
  for (int i = 0; i < NPROD; ++i) out[i][0] = s[i][0], out[i][1] = s[i][1];
}

size_t part_bytes(int B, int D, int F, int sms) {
  int sh[NPROD][2];
  shapes(D, F, sh);
  size_t m = 0;
  for (int i = 0; i < NPROD; ++i) {
    int kc;
    const size_t b = (size_t)one_round_k(sh[i][0], sh[i][1], sms, &kc) * B *
                     sh[i][1] * 4;
    m = b > m ? b : m;
  }
  return m;
}

// Tickets that the phases take turns with.
int phase_tickets(int D, int F) {
  const int a = gemm_tickets(3 * D), c = cross_tickets(D, F);
  return a > c ? a : c;
}

// Carves the workspace into p; returns the bytes used.
size_t carve(void* ws, Params& p, int B, int D, int F, int T, int sms) {
  Carve c(ws);
  int tc;
  const int H = D / HD, ch = t_chunks(B, H, T, sms, &tc);
  p.part = static_cast<int*>(c.take(part_bytes(B, D, F, sms)));
  p.q = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  p.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  p.x1 = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  p.x2 = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  p.g = static_cast<__nv_bfloat16*>(c.take((size_t)B * F * 2));
  p.po = static_cast<float*>(c.take((size_t)ch * B * D * 4));
  p.pm = static_cast<float*>(c.take((size_t)ch * B * H * 4));
  p.pl = static_cast<float*>(c.take((size_t)ch * B * H * 4));
  p.sml = static_cast<float2*>(c.take((size_t)B * H * MAX_CLUSTER * 8));
  p.so = static_cast<float*>(c.take((size_t)B * H * MAX_CLUSTER * HD * 4));
  return c.used;
}

// Blocks of layer_step that one SM holds with `smem` bytes of dynamic shared
// memory, after raising the kernel's limit to it. Both answers depend only
// on the device and on smem, so the last one is kept: a decode asks six
// times a step with the same size.
cudaError_t resident_blocks(size_t smem, int* per_sm) {
  static std::mutex mu;
  static int last_device = -1, last_per_sm = 0;
  static size_t last_smem = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (device != last_device || smem != last_smem) {
    e = cudaFuncSetAttribute(
        layer_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_per_sm, layer_step,
                                                      THREADS, smem);
    if (e != cudaSuccess) return e;
    last_device = device, last_smem = smem;
  }
  *per_sm = last_per_sm;
  return cudaSuccess;
}

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t layer_step_workspace(int B, int D, int F, int T, int sms) {
  Params p;
  return carve(nullptr, p, B, D, F, T, sms);
}

// Tickets (ints) for one call: a zeroed buffer that each call leaves
// zeroed, so calls in one stream's order share it. The phases take turns
// with its first phase_tickets (the products' tiles, the cross-attention's
// (batch row, head) pairs); the self-attention's counters follow.
extern "C" int layer_step_tickets(int D, int F) {
  return phase_tickets(D, F) + self_counters(D / HD);
}

// __global__ launches made by layer_step_launch since the library was
// loaded (one per call that reached its launch).
extern "C" long long layer_step_kernel_launches() { return g_launches; }

// C entry. x bf16 [B, D]; LayerNorm parameters f32 [D]; the int8 weights
// wqkv [D, 3D], wo1, wq, wo2 [D, D], w1 [D, F], w2 [F, D], each followed by
// its f32 per-channel scales and its f32 bias; self caches bf16 [B, S, D],
// row `pos` written in place; cross planes bf16 [B, T, D] whose positions
// ≥ t_actual are masked; out bf16 [B, D]; ws from layer_step_workspace;
// tickets layer_step_tickets ints, zero (and left zero). All contiguous.
// Returns a cudaError_t (0 = launched). Needs 1 ≤ B ≤ 32, D % 64 == 0,
// F % 32 == 0, 0 ≤ pos < S, 1 ≤ t_actual ≤ T.
extern "C" int layer_step_launch(
    const void* x, const void* ln1_g, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wo1, const void* so1,
    const void* bo1, const void* lnc_g, const void* lnc_b, const void* wq,
    const void* sq, const void* bq, const void* wo2, const void* so2,
    const void* bo2, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, void* cache_k, void* cache_v, const void* cross_k,
    const void* cross_v, void* out, void* ws, void* tickets, int B, int D,
    int F, int S, int pos, int T, int t_actual, int sms, void* stream) {
  if (B < 1 || B > MAXB || D <= 0 || D % HD || F <= 0 || F % TILE_N ||
      pos < 0 || pos >= S || t_actual < 1 || t_actual > T || sms < 1)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto h = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  Params p;
  p.x = h(x);
  p.ln1_g = f(ln1_g), p.ln1_b = f(ln1_b);
  p.w[P_QKV] = i8(wqkv), p.sqkv = f(sqkv), p.bqkv = f(bqkv);
  p.w[P_O1] = i8(wo1), p.so1 = f(so1), p.bo1 = f(bo1);
  p.lnc_g = f(lnc_g), p.lnc_b = f(lnc_b);
  p.w[P_Q] = i8(wq), p.sq = f(sq), p.bq = f(bq);
  p.w[P_O2] = i8(wo2), p.so2 = f(so2), p.bo2 = f(bo2);
  p.ln2_g = f(ln2_g), p.ln2_b = f(ln2_b);
  p.w[P_W1] = i8(w1), p.s1 = f(s1), p.b1 = f(b1);
  p.w[P_W2] = i8(w2), p.s2 = f(s2), p.b2 = f(b2);
  p.ck = static_cast<__nv_bfloat16*>(cache_k);
  p.cv = static_cast<__nv_bfloat16*>(cache_v);
  p.xk = h(cross_k), p.xv = h(cross_v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.tickets = static_cast<int*>(tickets);
  p.sctr = p.tickets + phase_tickets(D, F);
  carve(ws, p, B, D, F, T, sms);
  p.B = B, p.D = D, p.F = F, p.S = S, p.pos = pos, p.T = T;
  p.t_actual = t_actual;
  const int H = D / HD;
  int shape[NPROD][2];
  shapes(D, F, shape);
  size_t smem = 0;                // a product's weight tile and input rows
  for (int i = 0; i < NPROD; ++i) {
    p.ks[i] = one_round_k(shape[i][0], shape[i][1], sms, &p.kc[i]);
    const size_t a = gemm_smem<int8_t>(B, p.kc[i]);
    smem = a > smem ? a : smem;
  }
  p.ch = t_chunks(B, H, T, sms, &p.tc);
  const SelfSplit sp = self_split(B, H, pos, sms, 1);   // int8 W_o
  p.sc = sp.C, p.src = sp.rc;
  const int nvb = B * H * sp.C;
  // the o1 product folded into the self-attention where every chunk of
  // every batch row can have a block of its own and a chunk's share of W_o
  // is 16 bytes or more a row
  p.fw = HD % sp.C == 0 && sp.C <= 4 && nvb <= 2 * sms ? D / (H * sp.C) : 0;
  // a self-attention chunk: the W_o slab, then its work area (the scores
  // sized for the last position, so that a decode's steps share one
  // shared-memory size and with it the grid); two cross-attention bodies
  p.scf = ((S > SELF_ATT ? S : SELF_ATT) + 3) / 4 * 4;
  p.work = (D * p.fw + 15) / 16 * 16;
  const size_t att = p.work + (size_t)(p.scf + HD + ROW_GROUPS * HD +
                                       SELF_ATT / 32 + HD) * 4;
  const size_t cross = 2 * cross_att_smem(p.tc);
  smem = att > smem ? att : smem;
  smem = cross > smem ? cross : smem;
  int per_sm = 0;
  cudaError_t e = resident_blocks(smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = (per_sm > 2 ? 2 : per_sm) * sms;
  // A chunk that waits for its siblings or its batch row needs every chunk
  // on a block of its own. With C > 1, B·H·C < sms + B·H ≤ 2·sms
  // (self_chunks aims at one block per SM over B·H ≤ sms pairs): two
  // blocks per SM always hold them; a grid that could not is refused.
  if ((sp.C > 1 || p.fw) && nvb > blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer_step),
                                  dim3(blocks), dim3(THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return launched();
}

extern "C" const char* layer_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
