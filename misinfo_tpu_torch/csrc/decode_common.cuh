// Shared device code of the fused Whisper decode-step kernels
// (self_attn_step.cu, cross_ffn_step.cu, cross_ffn_step_i8cc.cu,
// layer_step.cu), Hopper sm_90a.
//
// Every kernel's work is a __device__ body over the block's indices, which
// its __global__ kernel calls with blockIdx and the whole-layer kernel
// (layer_step.cu) calls in a loop over the same indices: one source for
// the arithmetic, so the same partial sums in the same order on both
// routes.
//
// At decode shapes (B = 1..32 rows, D = 512, F = 2048) every matrix product
// is skinny: a handful of FLOPs per weight byte, so the products are bound
// by the weight stream, not by the tensor cores. `skinny_gemm` spreads one
// weight matrix over many blocks: block (i, j) owns 32 output columns and
// rows [j·kc, (j+1)·kc) of W. It first stages its [kc, 32] weight tile in
// shared memory with cp.async, 16 bytes a lane (16 int8 or 8 bf16
// columns), then walks it with each warp on every 8th row and its 32 lanes
// on the 32 columns, every thread keeping one accumulator per batch row.
// The block's partial sums go to a workspace [ks, B, N]. The last of the
// ks blocks of a column tile to finish (an atomic ticket per tile, taken
// after a __threadfence, reset by that block) adds the ks partials in
// chunk order and applies the epilogue: scales, bias, activation,
// residual. With int8 weights the partials are int32 and the sum is exact,
// as on the TPU's int8 MXU.
//
// The input rows are prepared by every block in its prologue: LayerNorm
// (single-pass variance, the bf16 serving formula of ops/common.layer_norm)
// and, for int8 weights, the per-row abs-max quantization of
// ops/quant.quantize_rows (IEEE division, round half to even). Redundant
// across blocks, but it is B·K values read from L2 against a launch.
// (Staging the rows in shared memory first, one more round trip after the
// wait, measured slower on the H100.)
//
// Launches: every kernel of a step is launched with Hopper's programmatic
// dependent launch (launch_early). Its blocks may start as the kernel
// before it finishes (as that kernel's blocks exit); each stages what does
// not depend on the kernel before (the weight tile) and waits for that
// kernel's completion (wait_prior_grid) before it reads an activation,
// takes a ticket or writes anything. In a kernel launched without the
// attribute (layer_step.cu's cooperative launch) the wait is a no-op.
// (Letting dependents start at a block's start, griddepcontrol.
// launch_dependents, measured slower on the H100: their waiting blocks
// then share the SMs with the kernel they wait for.)
//
// Numerics: __fdiv_rn/__fmul_rn/__fadd_rn wherever a contracted FMA or an
// approximate division would move a rounding. Never build with
// --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dec {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXB = 32;       // batch rows a call may carry
constexpr int TILE_N = 32;     // output columns per block
constexpr int MAX_KC = 256;    // weight rows per block (bounds shared memory)
constexpr int HD = 64;         // head width of every Whisper size
constexpr float LN_EPS = 1e-5f;
constexpr float NEG = -1e9f;   // masked score, as the JAX package

// skinny_gemm inputs: a LayerNormed bf16 row, a bf16 row as it is
enum { IN_LN = 0, IN_ROW = 1 };
// epilogues: none (the partials stay for the caller), q (the TPU kernel's
// q order), GELU, residual, and the fused QKV projection of the
// self-attention step (q out, k and v into cache row `pos`)
enum { EP_NONE = 0, EP_Q = 1, EP_GELU = 2, EP_RESID = 3, EP_QKV = 4 };

template <typename WT> struct Acc;
template <> struct Acc<int8_t> { using T = int; };
template <> struct Acc<__nv_bfloat16> { using T = float; };

// __global__ launches made by this library since it was loaded: internal
// linkage, so that each library (one translation unit each) counts its own
// (an inline variable would be one symbol shared by every loaded library)
static long long g_launches = 0;
static inline cudaError_t launched() {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches;
  return e;
}

// Programmatic dependent launch, device side: wait until the kernel before
// this one has finished and its writes are visible.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches `kernel` on `st` with programmatic stream serialization: it may
// start before the kernel ahead of it ends, and must wait_prior_grid()
// before it touches that kernel's results. Counted as one launch.
template <typename... KArgs, typename... Args>
cudaError_t launch_early(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                         size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return e != cudaSuccess ? e : launched();
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float wval(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int wval(int8_t v) { return (int)v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// max(amax / 127, 1e-8) and clip(round(v / s)), as ops/quant.quantize_rows
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}
__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return max(-127, min(127, q));
}

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
      acc = __fadd_rn(acc, __fmul_rn(q[8 * c + 2 * e], f.x));
      acc = __fadd_rn(acc, __fmul_rn(q[8 * c + 2 * e + 1], f.y));
    }
  }
  return acc;
}

// The threads that work on one body together: a whole block (bar < 0,
// __syncthreads), or `n` threads of it (whole warps) that meet at the named
// barrier `bar` (1..15), so that a 256-thread block can run two 128-thread
// bodies side by side.
struct Team {
  int tid, n, bar;
};
__device__ __forceinline__ Team whole_block() {
  return Team{(int)threadIdx.x, (int)blockDim.x, -1};
}
__device__ __forceinline__ void team_sync(const Team& t) {
  if (t.bar < 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(t.n) : "memory");
}

// Team-wide reductions; `scr` holds one float per warp. Every team that
// reduces the same values in the same layout gets the same bits.
__device__ __forceinline__ float block_max(float v, float* scr,
                                           const Team& t) {
  const int warp = t.tid >> 5, lane = t.tid & 31, nw = t.n >> 5;
  v = warp_max(v);
  team_sync(t);
  if (lane == 0) scr[warp] = v;
  team_sync(t);
  float r = scr[0];
  for (int w = 1; w < nw; ++w) r = fmaxf(r, scr[w]);
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* scr,
                                           const Team& t) {
  const int warp = t.tid >> 5, lane = t.tid & 31, nw = t.n >> 5;
  v = warp_sum(v);
  team_sync(t);
  if (lane == 0) scr[warp] = v;
  team_sync(t);
  float r = scr[0];
  for (int w = 1; w < nw; ++w) r = __fadd_rn(r, scr[w]);
  return r;
}

// Mean and 1/sqrt(var + eps) of one bf16 row, single-pass variance
// E[x²] − E[x]² floored at 0; called by a whole warp. Each lane sums
// elements lane, lane + 32, ... in that order; their loads go out eight at
// a time.
__device__ __forceinline__ void ln_stats(const __nv_bfloat16* x, int K,
                                         int lane, float& mean, float& rstd) {
  float s = 0.f, ss = 0.f;
  constexpr int U = 8;
  for (int k0 = lane; k0 < K; k0 += 32 * U) {
    float v[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      v[i] = k0 + 32 * i < K ? ld(x + k0 + 32 * i) : 0.f;
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (k0 + 32 * i < K) {
        s = __fadd_rn(s, v[i]);
        ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
      }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = __fdiv_rn(s, (float)K);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mean, mean)), 0.f);
  rstd = rsqrtf(__fadd_rn(var, LN_EPS));
}

// A product's input rows [B, K] bf16, LayerNormed with ln_g/ln_b for
// IN_LN.
struct In {
  const __nv_bfloat16* a;
  const float *ln_g, *ln_b;
};

// What the last block of a column tile writes (see finish).
struct Ep {
  const float *scale, *bias;    // int8 per-channel scales (else unused), bias
  const __nv_bfloat16* x;       // EP_RESID: the residual [B, N]
  __nv_bfloat16* out;           // [B, N]; EP_QKV: q [B, N / 3]
  __nv_bfloat16 *ck, *cv;       // EP_QKV: self caches [B, S, N / 3]
  int S, pos;                   // EP_QKV: their length, the row written
};

// Shared memory of skinny_gemm_body: the weight tile, then the input rows
// (later the warps' partials). 16-byte aligned pieces.
template <typename WT>
__host__ __device__ inline int gemm_w_bytes(int kc) {
  return (kc * TILE_N * (int)sizeof(WT) + 15) / 16 * 16;
}
template <typename WT>
__host__ __device__ inline size_t gemm_smem(int B, int kc) {
  const int n = B * kc > WARPS * B * 32 ? B * kc : WARPS * B * 32;
  return gemm_w_bytes<WT>(kc) + (size_t)n * 4;
}

template <int IN>
__device__ __forceinline__ float in_val(const In& in, int b, int k, int K,
                                        float mean, float rstd) {
  const __nv_bfloat16* xr = in.a + (size_t)b * K;
  if constexpr (IN == IN_LN)
    return bf(__fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(ld(xr + k), mean), rstd), in.ln_g[k]),
        in.ln_b[k]));
  else
    return ld(xr + k);
}

// max |input value| of row b (a whole warp; K % 8 == 0): 16 bytes of the
// row per lane and step, the values as in_val computes them. The max does
// not depend on the order.
template <int IN>
__device__ __forceinline__ float row_amax(const In& in, int b, int K,
                                          float mean, float rstd, int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(in.a + (size_t)b * K);
  float amax = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    const uint4 u = xr[c];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
    if constexpr (IN == IN_LN) {
      const float4* g4 = reinterpret_cast<const float4*>(in.ln_g) + 2 * c;
      const float4* b4 = reinterpret_cast<const float4*>(in.ln_b) + 2 * c;
      const float4 ga = g4[0], gb = g4[1], ba = b4[0], bb = b4[1];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float o[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = bf(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), g[i]), o[i]));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  return warp_max(amax);
}

// y = dequantized sum + bias, before the rounding to bf16. int8:
// (acc·s_row)·s_chan + b as ops/quant.dense_int8, or with q_order
// (acc·s_chan)·s_row + b as the TPU kernels derive q.
template <typename WT>
__device__ __forceinline__ float dequant(typename Acc<WT>::T s, int n,
                                         float s_row, const float* scale,
                                         const float* bias, bool q_order) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    const float v = (float)s;
    const float t = q_order ? __fmul_rn(__fmul_rn(v, scale[n]), s_row)
                            : __fmul_rn(__fmul_rn(v, s_row), scale[n]);
    return __fadd_rn(t, bias[n]);
  } else {
    return __fadd_rn(s, bias[n]);
  }
}

// Σ_j part[j, b, n] in chunk order
template <typename WT>
__device__ __forceinline__ typename Acc<WT>::T sum_parts(
    const typename Acc<WT>::T* part, int ks, int B, int N, int b, int n) {
  typename Acc<WT>::T s = 0;
  for (int j = 0; j < ks; ++j) s += __ldcg(part + ((size_t)j * B + b) * N + n);
  return s;
}

// GELU, tanh form, in f32 (PyTorch's formula; the one multiply-add that
// the compiler would contract is written out)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2/pi)
  const float kKappa = 0.044715f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fmaf_rn(kKappa, x3, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// Element (b, n) of [B, N] from its summed partials s: EP_Q out = bf16(y)
// in the q order; EP_GELU out = bf16(gelu_tanh(bf16(y))); EP_RESID
// out = bf16(x + bf16(y)); EP_QKV bf16(y), q in the q order, to q, or to
// row `pos` of the caches (k, v in place).
template <typename WT, int EP>
__device__ __forceinline__ void finish(typename Acc<WT>::T s, int b, int n,
                                       int N, float s_row, const Ep& ep) {
  if constexpr (EP == EP_QKV) {
    const int D = N / 3;
    const __nv_bfloat16 y = __float2bfloat16_rn(
        dequant<WT>(s, n, s_row, ep.scale, ep.bias, n < D));
    if (n < D)
      ep.out[(size_t)b * D + n] = y;
    else if (n < 2 * D)
      ep.ck[((size_t)b * ep.S + ep.pos) * D + n - D] = y;
    else
      ep.cv[((size_t)b * ep.S + ep.pos) * D + n - 2 * D] = y;
  } else {
    const size_t i = (size_t)b * N + n;
    const float y = bf(dequant<WT>(s, n, s_row, ep.scale, ep.bias,
                                   EP == EP_Q));
    float r = y;
    if constexpr (EP == EP_GELU) r = gelu_tanh(y);
    if constexpr (EP == EP_RESID) r = __fadd_rn(ld(ep.x + i), y);
    ep.out[i] = __float2bfloat16_rn(r);
  }
}

// The block's products over its weight tile ws [kc, TILE_N] into the
// warps' partials as [WARPS, B, 32] (overwriting the input rows as [B,
// kc]): each warp over rows k0 + warp, k0 + warp + WARPS, ... in that
// order, one accumulator per batch row (bf16·bf16 is exact in f32). NB ≥ B
// bounds the unrolled loop over the batch rows: unrolled over all MAXB
// rows it issued 32 predicated steps per weight row whatever B was, which
// set a product's time at decode sizes (device timestamps, H100).
template <int NB, typename WT>
__device__ __forceinline__ void tile_product(const WT* ws,
                                             typename Acc<WT>::T* as, int k0,
                                             int k1, int kc, int B, int warp,
                                             int lane) {
  using AT = typename Acc<WT>::T;
  AT acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0;
  for (int k = k0 + warp; k < k1; k += WARPS) {
    const AT wa = wval(ws[(k - k0) * TILE_N + lane]);
    const AT* ar = as + (k - k0);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B) acc[b] += ar[b * kc] * wa;
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B) as[(warp * B + b) * 32 + lane] = acc[b];
}

// Partial products Y[B, N] over rows [k0, k0 + kc) of W [K, N] (row-major,
// the JAX [in, out] layout) of the input `in` (see In). int8 W: the input
// rows are quantized per row, and block (0, 0) writes their scales to
// rs_out [B] where given. Writes part[by, b, n] (int32 for int8 W, f32 for
// bf16 W); then, unless EP == EP_NONE, the last of the ks blocks of column
// tile bx (ticket tickets[bx], zero on entry and left zero) applies the
// epilogue to the tile. The body of block (bx, by) of a grid (N / 32, ks),
// for THREADS threads with gemm_smem bytes of shared memory at `smem`; a
// caller that runs it again on the same shared memory synchronizes the
// block in between.
template <typename WT, int IN, int EP>
__device__ __forceinline__ void skinny_gemm_body(
    unsigned char* smem, int bx, int by, const In& in,
    const WT* __restrict__ w, typename Acc<WT>::T* part, float* rs_out,
    int* tickets, const Ep& ep, int B, int K, int N, int kc, int ks) {
  using AT = typename Acc<WT>::T;
  constexpr bool Q = std::is_same<WT, int8_t>::value;
  constexpr int CH = 16 / (int)sizeof(WT);   // columns per 16-byte chunk
  constexpr int RC = TILE_N / CH;            // chunks per tile row
  __shared__ float rs_s[MAXB];
  __shared__ int last;
  WT* ws = reinterpret_cast<WT*>(smem);                    // [kc, TILE_N]
  AT* as = reinterpret_cast<AT*>(smem + gemm_w_bytes<WT>(kc));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = by * kc, k1 = min(K, k0 + kc), n0 = bx * TILE_N;

  // the weight tile in flight while the kernel before finishes and the
  // input rows are prepared
  for (int i = threadIdx.x; i < (k1 - k0) * RC; i += THREADS) {
    const int r = i / RC, c = i - r * RC;
    cp_async16(ws + r * TILE_N + c * CH, w + (size_t)(k0 + r) * N + n0 + c * CH);
  }
  wait_prior_grid();
  for (int b = warp; b < B; b += WARPS) {
    float mean = 0.f, rstd = 1.f;
    if constexpr (IN == IN_LN) ln_stats(in.a + (size_t)b * K, K, lane, mean,
                                        rstd);
    if constexpr (Q) {
      const float s = row_scale(row_amax<IN>(in, b, K, mean, rstd, lane));
      if (lane == 0) {
        rs_s[b] = s;
        if (rs_out && bx == 0 && by == 0) rs_out[b] = s;
      }
      for (int k = k0 + lane; k < k1; k += 32 * 4) {   // loads 4 at a time
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = k + 32 * i < k1 ? in_val<IN>(in, b, k + 32 * i, K, mean,
                                              rstd) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + 32 * i < k1) as[b * kc + k + 32 * i - k0] = quant(v[i], s);
      }
    } else {
      for (int k = k0 + lane; k < k1; k += 32 * 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = k + 32 * i < k1 ? in_val<IN>(in, b, k + 32 * i, K, mean,
                                              rstd) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + 32 * i < k1) as[b * kc + k + 32 * i - k0] = v[i];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (B <= 1)
    tile_product<1>(ws, as, k0, k1, kc, B, warp, lane);
  else if (B <= 2)
    tile_product<2>(ws, as, k0, k1, kc, B, warp, lane);
  else if (B <= 4)
    tile_product<4>(ws, as, k0, k1, kc, B, warp, lane);
  else if (B <= 8)
    tile_product<8>(ws, as, k0, k1, kc, B, warp, lane);
  else if (B <= 16)
    tile_product<16>(ws, as, k0, k1, kc, B, warp, lane);
  else
    tile_product<MAXB>(ws, as, k0, k1, kc, B, warp, lane);
  AT* red = as;
  __syncthreads();
  for (int i = threadIdx.x; i < B * 32; i += THREADS) {
    const int b = i >> 5, l = i & 31;
    AT s = 0;
    for (int v = 0; v < WARPS; ++v) s += red[(v * B + b) * 32 + l];
    part[((size_t)by * B + b) * N + n0 + l] = s;
  }
  if constexpr (EP != EP_NONE) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets + bx, 1) == ks - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int i = threadIdx.x; i < B * 32; i += THREADS) {
        const int b = i >> 5, n = n0 + (i & 31);
        finish<WT, EP>(sum_parts<WT>(part, ks, B, N, b, n), b, n, N,
                       Q ? rs_s[b] : 1.f, ep);
      }
      if (threadIdx.x == 0) tickets[bx] = 0;
    }
  }
}

// Grid (N / 32, ks), THREADS threads, dynamic shared memory gemm_smem.
// Launched early (launch_early).
template <typename WT, int IN, int EP>
__global__ void __launch_bounds__(THREADS)
skinny_gemm(const In in, const WT* __restrict__ w,
            typename Acc<WT>::T* __restrict__ part, float* __restrict__ rs_out,
            int* __restrict__ tickets, const Ep ep, int B, int K, int N,
            int kc, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  skinny_gemm_body<WT, IN, EP>(smem, blockIdx.x, blockIdx.y, in, w, part,
                               rs_out, tickets, ep, B, K, N, kc, ks);
}

// K split of a skinny product: about two blocks per SM, at most MAX_KC and
// at least 32 weight rows per block. Returns ks; kc = ceil(K / ks).
inline int split_k(int K, int N, int sms, int* kc_out) {
  const int tiles = N / TILE_N;
  int ks = (2 * sms + tiles - 1) / tiles;
  const int lo = (K + MAX_KC - 1) / MAX_KC, hi = (K + 31) / 32;
  ks = ks < lo ? lo : (ks > hi ? hi : ks);
  const int kc = (K + ks - 1) / ks;
  *kc_out = kc;
  return (K + kc - 1) / kc;
}

// One product in one launch; *ks_out gets the K split (for EP_NONE, whose
// caller reads the partials).
template <typename WT, int IN, int EP>
cudaError_t gemm(const In& in, const WT* w, void* part, float* rs,
                 int* tickets, const Ep& ep, int B, int K, int N, int sms,
                 cudaStream_t st, int* ks_out = nullptr) {
  int kc;
  const int ks = split_k(K, N, sms, &kc);
  if (ks_out) *ks_out = ks;
  const size_t smem = gemm_smem<WT>(B, kc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        skinny_gemm<WT, IN, EP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  return launch_early(skinny_gemm<WT, IN, EP>, dim3(N / TILE_N, ks),
                      dim3(THREADS), smem, st, in, w,
                      static_cast<typename Acc<WT>::T*>(part), rs, tickets,
                      ep, B, K, N, kc, ks);
}

inline size_t gemm_part_bytes(int B, int K, int N, int sms) {
  int kc;
  return (size_t)split_k(K, N, sms, &kc) * B * N * 4;
}

// Tickets a product needs: one per column tile.
inline int gemm_tickets(int N) { return N / TILE_N; }

// Carves 256-byte aligned pieces off a workspace.
struct Carve {
  char* p;
  size_t used = 0;
  explicit Carve(void* base) : p(static_cast<char*>(base)) {}
  void* take(size_t bytes) {
    void* r = p + used;
    used += (bytes + 255) / 256 * 256;
    return r;
  }
};

}  // namespace dec
