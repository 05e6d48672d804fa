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
// decode_common.cuh), which those files launch as three and five kernels,
// walked by one persistent grid launched with cudaLaunchCooperativeKernel,
// with a grid-wide barrier between phases. Each phase loops over the block
// indices of the corresponding launch ("virtual blocks"), with the
// partitions (K split, T chunks) derived from the SM count exactly as
// there, so every partial sum is formed over the same elements in the same
// order (the self-attention's chunks, which self_attn_step.cu spreads over
// a thread-block cluster, are walked by one virtual block per (batch row,
// head) one after another: a cooperative launch takes no cluster, and the
// chunk functions are the same), each product's last virtual block of a
// column tile applies the
// same epilogue (its atomic ticket works across virtual blocks as across
// blocks), and the output and the written cache rows are bit for bit those
// of self_attn_step_launch followed by cross_ffn_step_launch.
//
// What bounds it on this card: the two steps' bytes (the int8 weights
// 4·D² + 2·D·F, cache rows 0..pos, the bf16 cross planes 2·B·T·D·2), a few
// MB that the card streams in microseconds; what this kernel removes is
// seven of eight launches and the host work between the two calls. What
// it pays is seven grid barriers.
//
// The grid is sized from the occupancy of this kernel (at most two blocks
// per SM, as the partitions aim at two blocks per SM), never from the
// problem; the whole grid must be resident for the barriers. Blocks have
// 256 threads, the width of skinny_gemm and of the self-attention body; the
// cross-attention body is written for 128 threads (its reduction order),
// so each block runs two of them side by side as teams that meet at named
// barriers (each team takes its own ticket for the chunk combine). The row `pos` of the self caches is written by the QKV
// product's epilogue and read by the attention phase after a grid barrier.
// A refused cooperative launch is returned as its error; nothing falls
// back to the two-call route.

#include <cooperative_groups.h>

#include <initializer_list>
#include <mutex>

#include "cross_ffn_phases.cuh"
#include "self_attn_phases.cuh"

namespace cg = cooperative_groups;
using namespace dec;

namespace {

struct Params {
  const __nv_bfloat16* x;
  const float *ln1_g, *ln1_b;
  const int8_t* wqkv;
  const float *sqkv, *bqkv;
  const int8_t* wo1;
  const float *so1, *bo1;
  const float *lnc_g, *lnc_b;
  const int8_t* wq;
  const float *sq, *bq;
  const int8_t* wo2;
  const float *so2, *bo2;
  const float *ln2_g, *ln2_b;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  __nv_bfloat16 *ck, *cv;
  const __nv_bfloat16 *xk, *xv;
  __nv_bfloat16* out;
  int* tickets;
  // workspace
  int* part;
  __nv_bfloat16 *q, *ctx, *x1, *x2, *g;
  float *po, *pm, *pl;
  int B, D, F, S, pos, T, t_actual;
  // partitions, from the SM count
  int ks_qkv, kc_qkv, ks_dd, kc_dd, ks_df, kc_df, ks_fd, kc_fd, ch, tc;
  int sc, src;      // the self-attention's chunks and rows per chunk
};

// One skinny product with its epilogue as a phase: virtual blocks
// (N / 32, ks).
template <int IN, int EP>
__device__ __forceinline__ void gemm_phase(unsigned char* smem, const In& in,
                                           const int8_t* w, const Ep& ep,
                                           const Params& p, int K, int N,
                                           int ks, int kc) {
  const int tiles = N / TILE_N;
  for (int vb = blockIdx.x; vb < tiles * ks; vb += gridDim.x) {
    __syncthreads();            // the shared memory of the last round
    skinny_gemm_body<int8_t, IN, EP>(smem, vb % tiles, vb / tiles, in, w,
                                     p.part, nullptr, p.tickets, ep, p.B, K,
                                     N, kc, ks);
  }
}

__global__ void __launch_bounds__(THREADS) layer_step(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, D = p.D, F = p.F, H = p.D / HD;

  // ---- the self-attention step (self_attn_step.cu's three launches)
  gemm_phase<IN_LN, EP_QKV>(smem, In{p.x, p.ln1_g, p.ln1_b}, p.wqkv,
                            Ep{p.sqkv, p.bqkv, nullptr, p.q, p.ck, p.cv, p.S,
                               p.pos},
                            p, D, 3 * D, p.ks_qkv, p.kc_qkv);
  grid.sync();                  // row `pos` is visible to every block
  for (int vb = blockIdx.x; vb < H * B; vb += gridDim.x) {
    __syncthreads();
    self_attention_serial(reinterpret_cast<float*>(smem), vb % H, vb / H,
                          p.q, p.ck, p.cv, p.ctx, D, p.S, p.pos, p.sc,
                          p.src);
  }
  grid.sync();
  gemm_phase<IN_ROW, EP_RESID>(smem, In{p.ctx}, p.wo1,
                               Ep{p.so1, p.bo1, p.x, p.x1}, p, D, D, p.ks_dd,
                               p.kc_dd);
  grid.sync();

  // ---- the cross-attention + FFN step (cross_ffn_step.cu's five)
  gemm_phase<IN_LN, EP_Q>(smem, In{p.x1, p.lnc_g, p.lnc_b}, p.wq,
                          Ep{p.sq, p.bq, nullptr, p.q}, p, D, D, p.ks_dd,
                          p.kc_dd);
  grid.sync();
  {
    // two teams of CROSS_ATT threads, each on its own virtual block
    const int team = threadIdx.x / CROSS_ATT;
    const Team tm{(int)threadIdx.x % CROSS_ATT, CROSS_ATT, 1 + team};
    float* sm = reinterpret_cast<float*>(smem) +
                team * cross_att_smem_floats(p.tc);
    const int nvb = H * B * p.ch;
    for (int vb = 2 * blockIdx.x + team; vb < nvb; vb += 2 * gridDim.x) {
      team_sync(tm);
      cross_attn_body(sm, vb % H, (vb / H) % B, vb / (H * B), H, B, p.ch, p.q,
                      p.xk, p.xv, p.po, p.pm, p.pl, p.tickets, p.ctx, D, p.T,
                      p.t_actual, p.tc, tm);
    }
  }
  grid.sync();
  gemm_phase<IN_ROW, EP_RESID>(smem, In{p.ctx}, p.wo2,
                               Ep{p.so2, p.bo2, p.x1, p.x2}, p, D, D, p.ks_dd,
                               p.kc_dd);
  grid.sync();
  gemm_phase<IN_LN, EP_GELU>(smem, In{p.x2, p.ln2_g, p.ln2_b}, p.w1,
                             Ep{p.s1, p.b1, nullptr, p.g}, p, D, F, p.ks_df,
                             p.kc_df);
  grid.sync();
  gemm_phase<IN_ROW, EP_RESID>(smem, In{p.g}, p.w2,
                               Ep{p.s2, p.b2, p.x2, p.out}, p, F, D, p.ks_fd,
                               p.kc_fd);
}

size_t part_bytes(int B, int D, int F, int sms) {
  const size_t a = self_part_bytes(B, D, sms);
  const size_t b = cross_part_bytes(B, D, F, sms);
  return a > b ? a : b;
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
// zeroed, so calls in one stream's order share it.
extern "C" int layer_step_tickets(int D, int F) {
  const int a = gemm_tickets(3 * D), c = cross_tickets(D, F);
  return a > c ? a : c;
}

// __global__ launches made by layer_step_launch since the library was
// loaded (one per call that reached its launch).
extern "C" long long layer_step_kernel_launches() { return g_launches; }

// C entry. x bf16 [B, D]; LayerNorm parameters f32 [D]; the int8 weights
// wqkv [D, 3D], wo1, wq, wo2 [D, D], w1 [D, F], w2 [F, D], each followed by
// its f32 per-channel scales and its f32 bias; self caches bf16 [B, S, D],
// row `pos` written in place; cross planes bf16 [B, T, D] whose positions
// ≥ t_actual are masked; out bf16 [B, D]; ws from layer_step_workspace;
// tickets layer_step_tickets ints, zero (and left zero). All contiguous. Returns a cudaError_t (0 = launched). Needs 1 ≤ B ≤ 32,
// D % 64 == 0, F % 32 == 0, 0 ≤ pos < S, 1 ≤ t_actual ≤ T.
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
  p.wqkv = i8(wqkv), p.sqkv = f(sqkv), p.bqkv = f(bqkv);
  p.wo1 = i8(wo1), p.so1 = f(so1), p.bo1 = f(bo1);
  p.lnc_g = f(lnc_g), p.lnc_b = f(lnc_b);
  p.wq = i8(wq), p.sq = f(sq), p.bq = f(bq);
  p.wo2 = i8(wo2), p.so2 = f(so2), p.bo2 = f(bo2);
  p.ln2_g = f(ln2_g), p.ln2_b = f(ln2_b);
  p.w1 = i8(w1), p.s1 = f(s1), p.b1 = f(b1);
  p.w2 = i8(w2), p.s2 = f(s2), p.b2 = f(b2);
  p.ck = static_cast<__nv_bfloat16*>(cache_k);
  p.cv = static_cast<__nv_bfloat16*>(cache_v);
  p.xk = h(cross_k), p.xv = h(cross_v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.tickets = static_cast<int*>(tickets);
  carve(ws, p, B, D, F, T, sms);
  p.B = B, p.D = D, p.F = F, p.S = S, p.pos = pos, p.T = T;
  p.t_actual = t_actual;
  p.ks_qkv = split_k(D, 3 * D, sms, &p.kc_qkv);
  p.ks_dd = split_k(D, D, sms, &p.kc_dd);
  p.ks_df = split_k(D, F, sms, &p.kc_df);
  p.ks_fd = split_k(F, D, sms, &p.kc_fd);
  p.ch = t_chunks(B, D / HD, T, sms, &p.tc);
  const SelfSplit sp = self_split(B, D / HD, pos, sms, 1);   // int8 W_o
  p.sc = sp.C, p.src = sp.rc;

  size_t smem = 0;
  for (const int kc : {p.kc_qkv, p.kc_dd, p.kc_df, p.kc_fd})
    smem = gemm_smem<int8_t>(B, kc) > smem ? gemm_smem<int8_t>(B, kc) : smem;
  // sized for the last position, so that a decode's steps share one
  // shared-memory size (and with it the grid)
  const size_t att = self_serial_smem(S);
  const size_t cross = 2 * cross_att_smem(p.tc);
  smem = att > smem ? att : smem;
  smem = cross > smem ? cross : smem;
  int per_sm = 0;
  cudaError_t e = resident_blocks(smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = (per_sm > 2 ? 2 : per_sm) * sms;
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
