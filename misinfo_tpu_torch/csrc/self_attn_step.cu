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
// share the streams decide the time. The design:
//  1. skinny_gemm (decode_common.cuh): LN (and int8 row quantization) in
//     every block's prologue, the [D, 3D] product split over ~2 blocks per
//     SM by output columns and weight rows;
//  2. an epilogue adds the K-split partials, dequantizes — q as
//     (acc·s_chan)·s_row + b, k and v as (acc·s_row)·s_chan + b, the two
//     orders of the TPU kernel — rounds to bf16 and writes q to a workspace
//     and k, v into row `pos` of the caches, in place (the TPU kernel's
//     masked full-plane select was a Mosaic workaround; JAX aliased the
//     buffers);
//  3. attention, one block per (head, batch row), one thread per cache
//     row for the scores (16-byte loads), over cache rows 0..pos only:
//     the TPU kernel masks rows > pos to −1e9 before an f32 softmax, and
//     exp(−1e9 − max) is exactly 0 in f32, so skipping them changes no
//     bit. Probabilities are rounded to bf16 before the PV product, the
//     context to bf16 before the output projection;
//  4. skinny_gemm over the context (quantized per row for int8 W), and
//  5. an epilogue adding bias and residual.
// Five launches from one C call; the wrapper counts one launch per call.

#include "decode_common.cuh"

using namespace dec;

namespace {

constexpr int ATT = 256;   // threads of the attention kernel

// 64 bf16 of one cache row (128 bytes, 16-byte aligned) dotted with q in
// f32, in dimension order.
__device__ __forceinline__ float row_dot(const __nv_bfloat16* row,
                                         const float* q) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 u = r[c];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      acc = __fadd_rn(acc, q[8 * c + 2 * e] * f.x);
      acc = __fadd_rn(acc, q[8 * c + 2 * e + 1] * f.y);
    }
  }
  return acc;
}

// Grid (H, B), ATT threads, one thread per cache row for the scores;
// dynamic shared memory (HD + ATT + pos + 1) floats.
__global__ void __launch_bounds__(ATT)
self_attention(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ ck,
               const __nv_bfloat16* __restrict__ cv,
               __nv_bfloat16* __restrict__ ctx, int D, int S, int pos) {
  extern __shared__ float sm[];
  float* qs = sm;            // [HD]
  float* scr = qs + HD;      // [ATT]: warp scratch, then context partials
  float* sc = scr + ATT;     // [pos + 1]
  const int h = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x < HD) qs[threadIdx.x] = ld(q + (size_t)b * D + h * HD +
                                             threadIdx.x);
  __syncthreads();
  const float root = sqrtf((float)HD);
  float m = NEG;
  for (int s = threadIdx.x; s <= pos; s += ATT) {
    sc[s] = __fdiv_rn(row_dot(ck + ((size_t)b * S + s) * D + h * HD, qs),
                      root);
    m = fmaxf(m, sc[s]);
  }
  m = block_max(m, scr);
  float l = 0.f;
  for (int s = threadIdx.x; s <= pos; s += ATT) {
    const float e = expf(__fsub_rn(sc[s], m));
    sc[s] = e;
    l = __fadd_rn(l, e);
  }
  l = block_sum(l, scr);
  for (int s = threadIdx.x; s <= pos; s += ATT)
    sc[s] = bf(__fdiv_rn(sc[s], l));
  __syncthreads();
  constexpr int G = ATT / HD;                 // row groups of the PV sum
  const int d = threadIdx.x & (HD - 1), grp = threadIdx.x / HD;
  float acc = 0.f;
  for (int s = grp; s <= pos; s += G)
    acc += sc[s] * ld(cv + ((size_t)b * S + s) * D + h * HD + d);
  scr[threadIdx.x] = acc;   // the warp scratch is no longer needed
  __syncthreads();
  if (threadIdx.x < HD) {
    float c = scr[d];
    for (int g = 1; g < G; ++g) c = __fadd_rn(c, scr[g * HD + d]);
    ctx[(size_t)b * D + h * HD + d] = __float2bfloat16_rn(c);
  }
}

// q → q_out [B, D]; k, v → row `pos` of the caches [B, S, D].
template <typename WT>
__global__ void qkv_epilogue(const typename Acc<WT>::T* __restrict__ part,
                             int ks, const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const float* __restrict__ rs,
                             __nv_bfloat16* __restrict__ q_out,
                             __nv_bfloat16* __restrict__ ck,
                             __nv_bfloat16* __restrict__ cv, int B, int D,
                             int S, int pos) {
  const int N = 3 * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i - b * N;
  const __nv_bfloat16 y = __float2bfloat16_rn(
      dequant<WT>(part, ks, B, N, b, n, scale, bias, rs, n < D));
  if (n < D)
    q_out[(size_t)b * D + n] = y;
  else if (n < 2 * D)
    ck[((size_t)b * S + pos) * D + n - D] = y;
  else
    cv[((size_t)b * S + pos) * D + n - 2 * D] = y;
}

struct Work {
  void* part;
  float* rs;
  __nv_bfloat16* q;
  __nv_bfloat16* ctx;
};

Work carve(void* ws, int B, int D, int sms) {
  Carve c(ws);
  const size_t p1 = gemm_part_bytes(B, D, 3 * D, sms);
  const size_t p2 = gemm_part_bytes(B, D, D, sms);
  Work w;
  w.part = c.take(p1 > p2 ? p1 : p2);
  w.rs = static_cast<float*>(c.take((size_t)B * 4));
  w.q = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  return w;
}

template <typename WT>
cudaError_t run(const __nv_bfloat16* x, const float* ln_g, const float* ln_b,
                const WT* wqkv, const float* sqkv, const float* bqkv,
                const WT* wo, const float* so, const float* bo,
                __nv_bfloat16* ck, __nv_bfloat16* cv, __nv_bfloat16* out,
                void* ws, int B, int D, int S, int pos, int sms,
                cudaStream_t st) {
  const Work w = carve(ws, B, D, sms);
  int ks;
  cudaError_t e = gemm<WT, IN_LN>(x, ln_g, ln_b, wqkv, w.part, w.rs, B, D,
                                  3 * D, sms, st, &ks);
  if (e != cudaSuccess) return e;
  const int n = B * 3 * D;
  qkv_epilogue<WT><<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const typename Acc<WT>::T*>(w.part), ks, sqkv, bqkv, w.rs,
      w.q, ck, cv, B, D, S, pos);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem = (size_t)(HD + ATT + pos + 1) * 4;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(self_attention,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  self_attention<<<dim3(D / HD, B), ATT, smem, st>>>(w.q, ck, cv, w.ctx, D,
                                                     S, pos);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = gemm<WT, IN_ROW>(w.ctx, nullptr, nullptr, wo, w.part, w.rs, B, D, D,
                       sms, st, &ks);
  if (e != cudaSuccess) return e;
  return run_epilogue<WT, EP_RESID>(w.part, ks, so, bo, w.rs, x, out, B, D,
                                    st);
}

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t self_attn_step_workspace(int B, int D, int sms) {
  Carve c(nullptr);
  const size_t p1 = gemm_part_bytes(B, D, 3 * D, sms);
  const size_t p2 = gemm_part_bytes(B, D, D, sms);
  c.take(p1 > p2 ? p1 : p2);
  c.take((size_t)B * 4);
  c.take((size_t)B * D * 2);
  c.take((size_t)B * D * 2);
  return c.used;
}

// C entry: x bf16 [B, D]; ln_g/ln_b f32 [D]; wqkv [D, 3D] and wo [D, D],
// bf16 (int8_weights 0) or int8 with f32 per-channel scales sqkv [3D] / so
// [D] (int8_weights 1; the scale pointers are ignored otherwise); biases
// f32; caches bf16 [B, S, D], row `pos` written in place; out bf16 [B, D];
// ws from self_attn_step_workspace. All contiguous. Returns a cudaError_t
// (0 = launched). Needs 1 ≤ B ≤ 32, D % 64 == 0, 0 ≤ pos < S.
extern "C" int self_attn_step_launch(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wo, const void* so,
    const void* bo, void* cache_k, void* cache_v, void* out, void* ws, int B,
    int D, int S, int pos, int int8_weights, int sms, void* stream) {
  if (B < 1 || B > MAXB || D % HD || D <= 0 || pos < 0 || pos >= S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(ln_g);
  const auto* bb = static_cast<const float*>(ln_b);
  auto* ck = static_cast<__nv_bfloat16*>(cache_k);
  auto* cv = static_cast<__nv_bfloat16*>(cache_v);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (int8_weights)
    return run<int8_t>(xb, g, bb, static_cast<const int8_t*>(wqkv),
                       static_cast<const float*>(sqkv),
                       static_cast<const float*>(bqkv),
                       static_cast<const int8_t*>(wo),
                       static_cast<const float*>(so),
                       static_cast<const float*>(bo), ck, cv, o, ws, B, D, S,
                       pos, sms, st);
  return run<__nv_bfloat16>(xb, g, bb, static_cast<const __nv_bfloat16*>(wqkv),
                            nullptr, static_cast<const float*>(bqkv),
                            static_cast<const __nv_bfloat16*>(wo), nullptr,
                            static_cast<const float*>(bo), ck, cv, o, ws, B,
                            D, S, pos, sms, st);
}

extern "C" const char* self_attn_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
