// Fused Whisper decoder self-attention step for Hopper (sm_90a):
//   out = x + o(attn(LN(x))), with the new K/V row written into the caches.
//
// Replaces the TPU kernels misinfo_tpu/ops/pallas_decode.py
// ::_self_attn_step_kernel (bf16 weights, K6a) and
// ::_self_attn_step_kernel_i8 (int8 weights with f32 per-channel scales,
// K6b), reached through fused_self_attn_step. The weight type is a template
// parameter; the arithmetic follows the plain version in
// misinfo_tpu_torch/ops/self_attn_step.py.
//
// What bounds it on this card: at decode shapes (B ≤ 32 rows, D = 512,
// S = 448) the step reads the fused QKV and output weights (4·D² bytes in
// int8, twice that in bf16) and the cache rows 0..pos of one layer
// (2·B·(pos+1)·D·2 bytes) for a few FLOPs per byte; all of it is a few MB,
// which the card streams in microseconds, so launch count and how many SMs
// share the streams decide the time. The design, two launches from one
// C call where the o product is folded into the attention launch, three
// where it is not, each launched early (Hopper's programmatic dependent
// launch: a kernel's blocks stage what does not depend on the kernel
// before it while that one finishes, decode_common.cuh):
//  1. skinny_gemm (decode_common.cuh): LN (and int8 row quantization) in
//     every block's prologue, the [D, 3D] product split over ~2 blocks per
//     SM by output columns and weight rows, each block's weight tile
//     staged with 16-byte cp.async; the last block of each column tile
//     adds the K-split partials in chunk order and dequantizes — q as
//     (acc·s_chan)·s_row + b, k and v as (acc·s_row)·s_chan + b, the two
//     orders of the TPU kernel — rounds to bf16 and writes q to a workspace
//     and k, v into row `pos` of the caches, in place (the TPU kernel's
//     masked full-plane select was a Mosaic workaround; JAX aliased the
//     buffers);
//  2. attention (self_attn_phases.cuh): the rows 0..pos of each (batch
//     row, head) split into C chunks, one block each, where one block per
//     (row, head) left most SMs idle; the chunks of a (row, head) are one
//     thread-block cluster that exchanges their maxima and exp-sums, then
//     their PV partials, through distributed shared memory. Every block
//     has the global max and exp-sum before it rounds a probability to
//     bf16, as the TPU kernel and the plain version do; rows > pos are
//     never read (masked to −1e9 there, and exp(−1e9 − max) is exactly 0
//     in f32). Eight lanes per cache row for the scores and for the PV
//     sum, 8 rows per row group in flight. The context is rounded to bf16
//     before the output projection. With int8 W_o, C ≥ 2 chunks and the
//     B·H·C blocks in one wave (self_split), all H·C ≤ 16 blocks of a
//     batch row are one cluster and the o product is folded in: each
//     block computes D / (H·C) output columns over all D rows of W_o, its
//     W_o tile staged with cp.async before the wait, the context
//     quantized by its whole-row abs-max as the o product's prologue does
//     (the int32 sums are exact: the bits of the separate product).
//     Otherwise the context goes to a workspace and
//  3. skinny_gemm over the context (quantized per row for int8 W) adds
//     bias and residual in its last blocks.
// A one-row query (M = 1) gives the tensor cores nothing to do: the work
// is bytes. The wrapper counts one launch per call; the library counts its
// __global__ launches (self_attn_step_kernel_launches).

#include <mutex>

#include "self_attn_phases.cuh"

using namespace dec;

namespace {

// Chunk z of head h of batch row b over rows [z·rc, min((z + 1)·rc,
// pos + 1)), one block of a cluster: (C, 1, 1), the chunks of one (row,
// head); with FOLD (C, H, 1), every chunk of every head of batch row b.
// Grid (C, H, B), SELF_ATT threads, dynamic shared memory
// self_cluster_smem. Before the wait for the QKV product, with FOLD, the
// block stages its W_o tile (columns [j·W, (j + 1)·W), j its rank in the
// cluster, W = D / (H·C)) with cp.async. Without FOLD the head's context
// lanes go to ctx; with FOLD every block sums the batch row's whole
// context from the cluster's partials, quantizes it by its abs-max (as
// the int8 o product's prologue does), and writes its W output columns of
// x + o(ctx): int8 sums are exact, so these are the bits of the separate
// o product. FOLD is for int8 W_o only (self_split).
// Launched early.
template <typename WT, bool FOLD>
__global__ void __launch_bounds__(SELF_ATT)
self_attention(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ ck,
               const __nv_bfloat16* __restrict__ cv,
               __nv_bfloat16* __restrict__ ctx,
               const __nv_bfloat16* __restrict__ x, const WT* __restrict__ wo,
               const float* __restrict__ so, const float* __restrict__ bo,
               __nv_bfloat16* __restrict__ out, int D, int S, int pos,
               int rc) {
  namespace cg = cooperative_groups;
  static_assert(!FOLD || std::is_same<WT, int8_t>::value,
                "the o product is folded for int8 W_o only");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int z = blockIdx.x, C = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int H = D / HD, W = FOLD ? D / (H * C) : 0;
  // the cluster rank of chunk zz of head hh
  auto rank = [&](int hh, int zz) { return FOLD ? hh * C + zz : zz; };
  float* sc = reinterpret_cast<float*>(smem);   // [rc]
  float* qs = sc + rc;                          // [HD]
  float* red = qs + HD;                         // [ROW_GROUPS, HD]
  float* scr = red + ROW_GROUPS * HD;           // [SELF_ATT / 32]
  float* xch = scr + SELF_ATT / 32;             // m_z, l_z, o_z [HD]
  float* row = xch + 2 + HD;                    // FOLD: the context [D]
  const size_t f = (size_t)rc + HD + ROW_GROUPS * HD + SELF_ATT / 32 + 2 +
                   HD + (FOLD ? D : 0);
  WT* wt = reinterpret_cast<WT*>(smem + (f * 4 + 15) / 16 * 16);  // [D, W]
  const int r0 = z * rc;
  const int n = min(rc, pos + 1 - r0);
  const size_t base = ((size_t)b * S + r0) * D + h * HD;
  const int n0 = FOLD ? rank(h, z) * W : 0;
  // FOLD: the epilogue's residual, scale and bias of this thread's column
  float x_n = 0.f, s_n = 1.f, b_n = 0.f;
  if constexpr (FOLD) {
    constexpr int CH = 16 / (int)sizeof(WT);  // weights per 16 bytes
    const int rcs = W / CH;                   // 16-byte pieces per row
    for (int i = threadIdx.x; i < D * rcs; i += SELF_ATT) {
      const int r = i / rcs, c = (i % rcs) * CH;
      cp_async16(wt + r * W + c, wo + (size_t)r * D + n0 + c);
    }
    if (threadIdx.x < W) {    // x is the QKV product's input: final
      x_n = __bfloat162float(__ldcg(x + (size_t)b * D + n0 + threadIdx.x));
      b_n = bo[n0 + threadIdx.x];
      s_n = so[n0 + threadIdx.x];
    }
  }
  wait_prior_grid();                          // q and row `pos`
  if (threadIdx.x < HD) qs[threadIdx.x] = ld(q + (size_t)b * D + h * HD +
                                             threadIdx.x);
  __syncthreads();

  const float mz = chunk_scores(sc, qs, ck + base, D, n, scr);
  const float lz = chunk_sum(sc, n, mz, scr);
  float m, l;
  if (C > 1) {                // a head's chunks meet in the cluster
    if (threadIdx.x == 0) xch[0] = mz, xch[1] = lz;
    cl.sync();
    merge_chunks(C, [&](int zz) {
      const float* o = cl.map_shared_rank(xch, rank(h, zz));
      return make_float2(o[0], o[1]);
    }, m, l);
  } else {                    // every thread has its block's own
    merge_chunks(1, [&](int) { return make_float2(mz, lz); }, m, l);
  }
  chunk_pv(sc, cv + base, D, n, m, l, red, xch + 2);
  if (FOLD || C > 1) cl.sync();   // (one chunk: a thread reads its own)
  if constexpr (!FOLD) {
    // the head's 64 lanes, dim d by its chunk d % C, in chunk order
    if (threadIdx.x < HD && threadIdx.x % C == z) {
      float s = 0.f;
      for (int zz = 0; zz < C; ++zz)
        s = __fadd_rn(s, C > 1 ? *cl.map_shared_rank(xch + 2 + threadIdx.x,
                                                     zz)
                               : xch[2 + threadIdx.x]);
      ctx[(size_t)b * D + h * HD + threadIdx.x] = __float2bfloat16_rn(s);
    }
  } else {
    // the whole context row of batch row b from the cluster's o_z
    fold_o([&](int d, int zz) {
             return *cl.map_shared_rank(xch + 2 + d % HD, rank(d / HD, zz));
           },
           C, D, W, reinterpret_cast<const int8_t*>(wt), row,
           reinterpret_cast<int*>(red), scr, x_n, s_n, b_n,
           out + (size_t)b * D + n0);
  }
  if (FOLD || C > 1) cl.sync();   // no block leaves while another reads it
}

// launch_early with the blocks in clusters of (cx, cy, 1), or alone
template <typename... KArgs, typename... Args>
cudaError_t launch_early_clusters(void (*kernel)(KArgs...), dim3 grid,
                                  dim3 block, size_t smem, int cx, int cy,
                                  cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cx;
  attr[1].val.clusterDim.y = cy;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cx * cy > 1 ? 2 : 1;   // a lone block needs no cluster
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return e != cudaSuccess ? e : launched();
}

// Raises self_attention<WT, FOLD>'s dynamic shared memory limit to `smem`
// (and lets it take clusters of more than 8 blocks), once per size.
template <typename WT, bool FOLD>
cudaError_t prepare(size_t smem) {
  static std::mutex mu;
  static size_t done = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (smem <= done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      self_attention<WT, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(self_attention<WT, FOLD>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done = smem;
  return e;
}

struct Work {
  void* part;
  __nv_bfloat16* q;
  __nv_bfloat16* ctx;
};

// Carves the workspace; *used gets the bytes taken.
Work carve(void* ws, int B, int D, int sms, size_t* used = nullptr) {
  Carve c(ws);
  Work w;
  w.part = c.take(self_part_bytes(B, D, sms));
  w.q = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  if (used) *used = c.used;
  return w;
}

template <typename WT>
cudaError_t run(const __nv_bfloat16* x, const float* ln_g, const float* ln_b,
                const WT* wqkv, const float* sqkv, const float* bqkv,
                const WT* wo, const float* so, const float* bo,
                __nv_bfloat16* ck, __nv_bfloat16* cv, __nv_bfloat16* out,
                void* ws, int* tickets, int B, int D, int S, int pos, int sms,
                cudaStream_t st) {
  const Work w = carve(ws, B, D, sms);
  cudaError_t e = gemm<WT, IN_LN, EP_QKV>(
      In{x, ln_g, ln_b}, wqkv, w.part, nullptr, tickets,
      Ep{sqkv, bqkv, nullptr, w.q, ck, cv, S, pos}, B, D, 3 * D, sms, st);
  if (e != cudaSuccess) return e;
  const int H = D / HD;
  const SelfSplit sp = self_split(B, H, pos, sms, (int)sizeof(WT));
  const size_t smem = self_cluster_smem(sp.rc, D, sp.fold_w,
                                        (int)sizeof(WT));
  if constexpr (std::is_same<WT, int8_t>::value) {
    if (sp.fold_w) {
      e = prepare<WT, true>(smem);
      if (e != cudaSuccess) return e;
      return launch_early_clusters(
          self_attention<WT, true>, dim3(sp.C, H, B), dim3(SELF_ATT), smem,
          sp.C, H, st, w.q, ck, cv, w.ctx, x, wo, so, bo, out, D, S, pos,
          sp.rc);
    }
  }
  e = prepare<WT, false>(smem);
  if (e != cudaSuccess) return e;
  e = launch_early_clusters(self_attention<WT, false>, dim3(sp.C, H, B),
                            dim3(SELF_ATT), smem, sp.C, 1, st, w.q, ck, cv,
                            w.ctx, x, wo, so, bo, out, D, S, pos, sp.rc);
  if (e != cudaSuccess) return e;
  return gemm<WT, IN_ROW, EP_RESID>(In{w.ctx}, wo, w.part, nullptr, tickets,
                                    Ep{so, bo, x, out}, B, D, D, sms, st);
}

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t self_attn_step_workspace(int B, int D, int sms) {
  size_t used = 0;
  carve(nullptr, B, D, sms, &used);
  return used;
}

// Tickets (ints) for one call: a zeroed buffer that each call leaves
// zeroed, so calls in one stream's order share it.
extern "C" int self_attn_step_tickets(int D) { return gemm_tickets(3 * D); }

// __global__ launches made by self_attn_step_launch since the library was
// loaded (two per call with the o product folded, three without).
extern "C" long long self_attn_step_kernel_launches() { return g_launches; }

// C entry: x bf16 [B, D]; ln_g/ln_b f32 [D]; wqkv [D, 3D] and wo [D, D],
// bf16 (int8_weights 0) or int8 with f32 per-channel scales sqkv [3D] / so
// [D] (int8_weights 1; the scale pointers are ignored otherwise); biases
// f32; caches bf16 [B, S, D], row `pos` written in place; out bf16 [B, D];
// ws from self_attn_step_workspace; tickets self_attn_step_tickets ints,
// zero (and left zero). All contiguous. Returns a cudaError_t
// (0 = launched). Needs 1 ≤ B ≤ 32, D % 64 == 0, 0 ≤ pos < S.
extern "C" int self_attn_step_launch(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wo, const void* so,
    const void* bo, void* cache_k, void* cache_v, void* out, void* ws,
    void* tickets, int B, int D, int S, int pos, int int8_weights, int sms,
    void* stream) {
  if (B < 1 || B > MAXB || D % HD || D <= 0 || pos < 0 || pos >= S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(ln_g);
  const auto* bb = static_cast<const float*>(ln_b);
  auto* ck = static_cast<__nv_bfloat16*>(cache_k);
  auto* cv = static_cast<__nv_bfloat16*>(cache_v);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* tk = static_cast<int*>(tickets);
  if (int8_weights)
    return run<int8_t>(xb, g, bb, static_cast<const int8_t*>(wqkv),
                       static_cast<const float*>(sqkv),
                       static_cast<const float*>(bqkv),
                       static_cast<const int8_t*>(wo),
                       static_cast<const float*>(so),
                       static_cast<const float*>(bo), ck, cv, o, ws, tk, B, D,
                       S, pos, sms, st);
  return run<__nv_bfloat16>(xb, g, bb, static_cast<const __nv_bfloat16*>(wqkv),
                            nullptr, static_cast<const float*>(bqkv),
                            static_cast<const __nv_bfloat16*>(wo), nullptr,
                            static_cast<const float*>(bo), ck, cv, o, ws, tk,
                            B, D, S, pos, sms, st);
}

extern "C" const char* self_attn_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
