// Fused Whisper decoder cross-attention + FFN step for Hopper (sm_90a):
//   x2  = x + o(crossattn(LN(x)))    over the encoder K/V planes
//   out = x2 + W2·gelu(W1·LN(x2))
//
// Replaces the TPU kernels misinfo_tpu/ops/pallas_cross_ffn.py
// ::_cross_ffn_kernel (bf16 weights, K7a) and ::_cross_ffn_kernel_i8
// (int8 weights with f32 per-channel scales, K7b), reached through
// fused_cross_ffn_step. The weight type is a template parameter; the
// arithmetic follows the plain version in
// misinfo_tpu_torch/ops/cross_ffn_step.py.
//
// What bounds it on this card: the merged cross K/V planes, 2·B·T·D·2
// bytes per layer (3 MB per batch row at T = 1,500, D = 512), then the
// four weights (2·D² + 2·D·F bytes in int8, 2.6 MB for whisper-base, twice
// that in bf16); a few FLOPs per byte, so it is a streaming problem, and at
// these sizes the card streams each in microseconds: launches and the
// number of SMs sharing each stream decide the time. The design:
//  1. q = W_q·LN(x) with skinny_gemm (decode_common.cuh) and an epilogue
//     in the TPU kernel's q order (acc·s_chan)·s_row + b;
//  2. scores: grid (head, batch row, T chunk), so the K plane is split
//     over ~2 blocks per SM; positions ≥ t_actual get −1e9;
//  3. probabilities and partial contexts, same grid: every block computes
//     the row's max and exp-sum over all T itself (the same reduction in
//     the same order in every block, so the same bits), rounds its chunk's
//     probabilities to bf16 and writes Σ_t p_t·v_t for its chunk;
//  4. the chunk partials are added in chunk order and rounded to bf16.
//     Against the plain version's one-pass softmax and PV product only the
//     order of the f32 sums differs;
//  5. x2 = x + o(ctx), then h2 = LN(x2) in the next product's prologue,
//     mid = W1·h2 rounded to bf16, g = gelu_tanh(mid) rounded to bf16 (the
//     TPU kernel's bf16 serving form; the plain version uses erf in f32
//     mode only), out = x2 + W2·g. With int8 weights each product's input
//     is quantized per row over its full width (F = 2,048 for W2), as the
//     TPU kernel's dense_q does.
// Eleven launches from one C call; the wrapper counts one launch per call.

#include "cross_ffn_phases.cuh"

using namespace dec;

namespace {

// Grid (H, B, chunks), CROSS_ATT threads; scores [B, H, T] f32.
__global__ void __launch_bounds__(CROSS_ATT)
cross_scores(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ ck, float* __restrict__ sc,
             int D, int T, int t_actual, int tc) {
  __shared__ float qs[HD];
  cross_scores_body(qs, blockIdx.x, blockIdx.y, blockIdx.z, gridDim.x, q, ck,
                    sc, D, T, t_actual, tc, whole_block());
}

// Grid (H, B, chunks), CROSS_ATT threads; partial contexts pctx
// [chunks, B, D] f32. Dynamic shared memory cross_pv_smem(tc).
__global__ void __launch_bounds__(CROSS_ATT)
cross_pv(const float* __restrict__ sc, const __nv_bfloat16* __restrict__ cv,
         float* __restrict__ pctx, int D, int T, int tc) {
  extern __shared__ float sm[];
  cross_pv_body(sm, blockIdx.x, blockIdx.y, blockIdx.z, gridDim.x, gridDim.y,
                sc, cv, pctx, D, T, tc, whole_block());
}

__global__ void combine(const float* __restrict__ pctx,
                        __nv_bfloat16* __restrict__ ctx, int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) combine_elem(i, pctx, ctx, n, chunks);
}

struct Work {
  void* part;
  float* rs;
  __nv_bfloat16 *q, *ctx, *x2, *g;
  float *sc, *pctx;
};

Work carve(void* ws, int B, int D, int F, int T, int sms) {
  Carve c(ws);
  int tc;
  const int ch = t_chunks(B, D / HD, T, sms, &tc);
  Work w;
  w.part = c.take(cross_part_bytes(B, D, F, sms));
  w.rs = static_cast<float*>(c.take((size_t)B * 4));
  w.q = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.x2 = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.g = static_cast<__nv_bfloat16*>(c.take((size_t)B * F * 2));
  w.sc = static_cast<float*>(c.take((size_t)B * (D / HD) * T * 4));
  w.pctx = static_cast<float*>(c.take((size_t)ch * B * D * 4));
  return w;
}

template <typename WT>
cudaError_t run(const __nv_bfloat16* x, const float* lnc_g,
                const float* lnc_b, const WT* wq, const float* sq,
                const float* bq, const WT* wo, const float* so,
                const float* bo, const float* ln2_g, const float* ln2_b,
                const WT* w1, const float* s1, const float* b1, const WT* w2,
                const float* s2, const float* b2, const __nv_bfloat16* ck,
                const __nv_bfloat16* cv, __nv_bfloat16* out, void* ws, int B,
                int D, int F, int T, int t_actual, int sms, cudaStream_t st) {
  const Work w = carve(ws, B, D, F, T, sms);
  const int H = D / HD;
  int ks, tc;
  const int ch = t_chunks(B, H, T, sms, &tc);
  cudaError_t e = gemm<WT, IN_LN>(x, lnc_g, lnc_b, wq, w.part, w.rs, B, D, D,
                                  sms, st, &ks);
  if (e != cudaSuccess) return e;
  e = run_epilogue<WT, EP_Q>(w.part, ks, sq, bq, w.rs, nullptr, w.q, B, D,
                             st);
  if (e != cudaSuccess) return e;
  cross_scores<<<dim3(H, B, ch), CROSS_ATT, 0, st>>>(w.q, ck, w.sc, D, T,
                                                     t_actual, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem = cross_pv_smem(tc);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(cross_pv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  cross_pv<<<dim3(H, B, ch), CROSS_ATT, smem, st>>>(w.sc, cv, w.pctx, D, T,
                                                    tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  combine<<<(B * D + 255) / 256, 256, 0, st>>>(w.pctx, w.ctx, B * D, ch);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return after_attention<WT>(x, w.ctx, wo, so, bo, ln2_g, ln2_b, w1, s1, b1,
                             w2, s2, b2, w.part, w.rs, w.x2, w.g, out, B, D,
                             F, sms, st);
}

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t cross_ffn_step_workspace(int B, int D, int F, int T,
                                           int sms) {
  Carve c(nullptr);
  int tc;
  const int ch = t_chunks(B, D / HD, T, sms, &tc);
  c.take(cross_part_bytes(B, D, F, sms));
  c.take((size_t)B * 4);
  for (int i = 0; i < 3; ++i) c.take((size_t)B * D * 2);
  c.take((size_t)B * F * 2);
  c.take((size_t)B * (D / HD) * T * 4);
  c.take((size_t)ch * B * D * 4);
  return c.used;
}

// C entry: x bf16 [B, D]; LayerNorm parameters f32 [D]; wq, wo [D, D],
// w1 [D, F], w2 [F, D] bf16 (int8_weights 0) or int8 with f32 per-channel
// scales (int8_weights 1; the scale pointers are ignored otherwise);
// biases f32; merged cross K/V bf16 [B, T, D] whose positions ≥ t_actual
// are masked; out bf16 [B, D]; ws from cross_ffn_step_workspace. All
// contiguous. Returns a cudaError_t (0 = launched). Needs 1 ≤ B ≤ 32,
// D % 64 == 0, F % 32 == 0, 1 ≤ t_actual ≤ T.
extern "C" int cross_ffn_step_launch(
    const void* x, const void* lnc_g, const void* lnc_b, const void* wq,
    const void* sq, const void* bq, const void* wo, const void* so,
    const void* bo, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, const void* cache_k, const void* cache_v, void* out,
    void* ws, int B, int D, int F, int T, int t_actual, int int8_weights,
    int sms, void* stream) {
  if (B < 1 || B > MAXB || D <= 0 || D % HD || F <= 0 || F % TILE_N ||
      t_actual < 1 || t_actual > T)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* kb = static_cast<const __nv_bfloat16*>(cache_k);
  const auto* vb = static_cast<const __nv_bfloat16*>(cache_v);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (int8_weights) {
    auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
    return run<int8_t>(xb, f(lnc_g), f(lnc_b), i8(wq), f(sq), f(bq), i8(wo),
                       f(so), f(bo), f(ln2_g), f(ln2_b), i8(w1), f(s1), f(b1),
                       i8(w2), f(s2), f(b2), kb, vb, o, ws, B, D, F, T,
                       t_actual, sms, st);
  }
  auto h = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  return run<__nv_bfloat16>(xb, f(lnc_g), f(lnc_b), h(wq), nullptr, f(bq),
                            h(wo), nullptr, f(bo), f(ln2_g), f(ln2_b), h(w1),
                            nullptr, f(b1), h(w2), nullptr, f(b2), kb, vb, o,
                            ws, B, D, F, T, t_actual, sms, st);
}

extern "C" const char* cross_ffn_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
