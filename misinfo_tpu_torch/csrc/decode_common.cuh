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
// rows [j·kc, (j+1)·kc) of W, each warp walks every 8th of those rows with
// its 32 lanes on 32 neighbouring columns (coalesced), and every thread keeps
// one accumulator per batch row. The block's partial sums go to a workspace
// [ks, B, N]; an epilogue kernel adds the ks partials in chunk order and
// applies scales, bias, activation or residual. With int8 weights the
// partials are int32 and the sum is exact, as on the TPU's int8 MXU.
//
// The input rows are prepared by every block in its prologue: LayerNorm
// (single-pass variance, the bf16 serving formula of ops/common.layer_norm)
// and, for int8 weights, the per-row abs-max quantization of
// ops/quant.quantize_rows (IEEE division, round half to even). Redundant
// across blocks, but it is B·K values read from L2 against a launch.
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

enum { IN_LN = 0, IN_ROW = 1 };              // skinny_gemm input
enum { EP_Q = 0, EP_GELU = 1, EP_RESID = 2 };  // epilogue kinds

template <typename WT> struct Acc;
template <> struct Acc<int8_t> { using T = int; };
template <> struct Acc<__nv_bfloat16> { using T = float; };

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float wval(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ int wval(const int8_t* p) { return (int)*p; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max(amax / 127, 1e-8) and clip(round(v / s)), as ops/quant.quantize_rows
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}
__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return max(-127, min(127, q));
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
// E[x²] − E[x]² floored at 0; called by a whole warp.
__device__ __forceinline__ void ln_stats(const __nv_bfloat16* x, int K,
                                         int lane, float& mean, float& rstd) {
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float v = ld(x + k);
    s = __fadd_rn(s, v);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mean = __fdiv_rn(s, (float)K);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, (float)K), __fmul_rn(mean, mean)), 0.f);
  rstd = rsqrtf(__fadd_rn(var, LN_EPS));
}

template <int IN>
__device__ __forceinline__ float in_val(const __nv_bfloat16* xr, int k,
                                        float mean, float rstd,
                                        const float* g, const float* bb) {
  if constexpr (IN == IN_LN)
    return bf(__fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(ld(xr + k), mean), rstd), g[k]), bb[k]));
  else
    return ld(xr + k);
}

// Partial products Y[B, N] over rows [k0, k0 + kc) of W [K, N] (row-major,
// the JAX [in, out] layout). Input: a [B, K] bf16, LayerNormed with
// (ln_g, ln_b) when IN == IN_LN. int8 W: the input rows are quantized per
// row and block (0, 0) writes their scales to rs_out [B]. Writes
// part[by, b, n] (int32 for int8 W, f32 for bf16 W). The body of block
// (bx, by) of a grid (N / 32, ks), for THREADS threads with gemm_smem(B, kc)
// bytes of shared memory at `smem`; a caller that runs it again on the same
// shared memory synchronizes the block in between.
template <typename WT, int IN>
__device__ __forceinline__ void skinny_gemm_body(
    unsigned char* smem, int bx, int by, const __nv_bfloat16* a,
    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
    const WT* __restrict__ w, typename Acc<WT>::T* part,
    float* rs_out, int B, int K, int N, int kc) {
  using AT = typename Acc<WT>::T;
  constexpr bool Q = std::is_same<WT, int8_t>::value;
  AT* as = reinterpret_cast<AT*>(smem);  // [B, kc]; later [WARPS, B, 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = by * kc, k1 = min(K, k0 + kc);
  const int n = bx * TILE_N + lane;

  for (int b = warp; b < B; b += WARPS) {
    const __nv_bfloat16* xr = a + (size_t)b * K;
    float mean = 0.f, rstd = 1.f;
    if constexpr (IN == IN_LN) ln_stats(xr, K, lane, mean, rstd);
    if constexpr (Q) {
      float amax = 0.f;
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(in_val<IN>(xr, k, mean, rstd, ln_g, ln_b)));
      const float s = row_scale(warp_max(amax));
      if (lane == 0 && bx == 0 && by == 0) rs_out[b] = s;
      for (int k = k0 + lane; k < k1; k += 32)
        as[b * kc + k - k0] =
            quant(in_val<IN>(xr, k, mean, rstd, ln_g, ln_b), s);
    } else {
      for (int k = k0 + lane; k < k1; k += 32)
        as[b * kc + k - k0] = in_val<IN>(xr, k, mean, rstd, ln_g, ln_b);
    }
  }
  __syncthreads();

  AT acc[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0;
  for (int k = k0 + warp; k < k1; k += WARPS) {
    const AT wv = wval(w + (size_t)k * N + n);
    const AT* ar = as + (k - k0);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B) acc[b] += ar[b * kc] * wv;   // bf16·bf16 is exact in f32
  }
  __syncthreads();
  AT* red = as;
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
    if (b < B) red[(warp * B + b) * 32 + lane] = acc[b];
  __syncthreads();
  for (int i = threadIdx.x; i < B * 32; i += THREADS) {
    const int b = i >> 5, l = i & 31;
    AT s = 0;
    for (int v = 0; v < WARPS; ++v) s += red[(v * B + b) * 32 + l];
    part[((size_t)by * B + b) * N + bx * TILE_N + l] = s;
  }
}

// Grid (N / 32, ks), THREADS threads, dynamic shared memory
// gemm_smem(B, kc).
template <typename WT, int IN>
__global__ void __launch_bounds__(THREADS)
skinny_gemm(const __nv_bfloat16* __restrict__ a,
            const float* __restrict__ ln_g, const float* __restrict__ ln_b,
            const WT* __restrict__ w,
            typename Acc<WT>::T* __restrict__ part,
            float* __restrict__ rs_out, int B, int K, int N, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  skinny_gemm_body<WT, IN>(smem, blockIdx.x, blockIdx.y, a, ln_g, ln_b, w,
                           part, rs_out, B, K, N, kc);
}

inline size_t gemm_smem(int B, int kc) {
  const int n = B * kc > WARPS * B * 32 ? B * kc : WARPS * B * 32;
  return (size_t)n * 4;
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

template <typename WT, int IN>
cudaError_t gemm(const __nv_bfloat16* a, const float* ln_g, const float* ln_b,
                 const WT* w, void* part, float* rs, int B, int K, int N,
                 int sms, cudaStream_t st, int* ks_out) {
  int kc;
  const int ks = split_k(K, N, sms, &kc);
  *ks_out = ks;
  skinny_gemm<WT, IN><<<dim3(N / TILE_N, ks), THREADS, gemm_smem(B, kc), st>>>(
      a, ln_g, ln_b, w, static_cast<typename Acc<WT>::T*>(part), rs, B, K, N,
      kc);
  return cudaGetLastError();
}

inline size_t gemm_part_bytes(int B, int K, int N, int sms) {
  int kc;
  return (size_t)split_k(K, N, sms, &kc) * B * N * 4;
}

// y = dequantized partial sum + bias, before the rounding to bf16.
// int8: (acc·s_row)·s_chan + b as ops/quant.dense_int8, or with q_order
// (acc·s_chan)·s_row + b as the TPU kernels derive q.
template <typename WT>
__device__ __forceinline__ float dequant(const typename Acc<WT>::T* part,
                                         int ks, int B, int N, int b, int n,
                                         const float* scale, const float* bias,
                                         const float* rs, bool q_order) {
  typename Acc<WT>::T s = 0;
  for (int j = 0; j < ks; ++j) s += part[((size_t)j * B + b) * N + n];
  if constexpr (std::is_same<WT, int8_t>::value) {
    const float v = (float)s;
    const float t = q_order ? __fmul_rn(__fmul_rn(v, scale[n]), rs[b])
                            : __fmul_rn(__fmul_rn(v, rs[b]), scale[n]);
    return __fadd_rn(t, bias[n]);
  } else {
    return __fadd_rn(s, bias[n]);
  }
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

// Element i of [B, N]: EP_Q  out = bf16(y) with the q order;
// EP_GELU out = bf16(gelu_tanh(bf16(y))); EP_RESID out = bf16(x + bf16(y)).
template <typename WT, int EP>
__device__ __forceinline__ void epilogue_elem(
    int i, const typename Acc<WT>::T* part, int ks,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* rs, const __nv_bfloat16* x,
    __nv_bfloat16* out, int B, int N) {
  const int b = i / N, n = i - b * N;
  const float y = bf(dequant<WT>(part, ks, B, N, b, n, scale, bias, rs,
                                 EP == EP_Q));
  float r = y;
  if constexpr (EP == EP_GELU) r = gelu_tanh(y);
  if constexpr (EP == EP_RESID) r = __fadd_rn(ld(x + i), y);
  out[i] = __float2bfloat16_rn(r);
}

template <typename WT, int EP>
__global__ void epilogue(const typename Acc<WT>::T* __restrict__ part, int ks,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ rs,
                         const __nv_bfloat16* __restrict__ x,
                         __nv_bfloat16* __restrict__ out, int B, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * N)
    epilogue_elem<WT, EP>(i, part, ks, scale, bias, rs, x, out, B, N);
}

template <typename WT, int EP>
cudaError_t run_epilogue(const void* part, int ks, const float* scale,
                         const float* bias, const float* rs,
                         const __nv_bfloat16* x, __nv_bfloat16* out, int B,
                         int N, cudaStream_t st) {
  const int n = B * N;
  epilogue<WT, EP><<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const typename Acc<WT>::T*>(part), ks, scale, bias, rs, x,
      out, B, N);
  return cudaGetLastError();
}

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
