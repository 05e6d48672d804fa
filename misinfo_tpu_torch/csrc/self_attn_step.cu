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
// share the streams decide the time. The design, three launches from one
// C call, each launched early (Hopper's programmatic dependent launch: a
// kernel's blocks stage their weight tiles while the kernel before it
// finishes, decode_common.cuh):
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
//  2. attention, one block per (head, batch row), one thread per cache
//     row for the scores (16-byte loads), over cache rows 0..pos only:
//     the TPU kernel masks rows > pos to −1e9 before an f32 softmax, and
//     exp(−1e9 − max) is exactly 0 in f32, so skipping them changes no
//     bit. Probabilities are rounded to bf16 before the PV product, the
//     context to bf16 before the output projection;
//  3. skinny_gemm over the context (quantized per row for int8 W), its
//     last blocks adding bias and residual.
// The wrapper counts one launch per call; the library counts its
// __global__ launches (self_attn_step_kernel_launches).

#include "self_attn_phases.cuh"

using namespace dec;

namespace {

// Grid (H, B), SELF_ATT threads; dynamic shared memory
// self_attention_smem(pos). Launched early.
__global__ void __launch_bounds__(SELF_ATT)
self_attention(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ ck,
               const __nv_bfloat16* __restrict__ cv,
               __nv_bfloat16* __restrict__ ctx, int D, int S, int pos) {
  extern __shared__ float sm[];
  self_attention_body(sm, blockIdx.x, blockIdx.y, q, ck, cv, ctx, D, S, pos);
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
  const size_t smem = self_attention_smem(pos);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(self_attention,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  e = launch_early(self_attention, dim3(D / HD, B), dim3(SELF_ATT), smem, st,
                   w.q, ck, cv, w.ctx, D, S, pos);
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
// loaded (three per call that reached its last launch).
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
