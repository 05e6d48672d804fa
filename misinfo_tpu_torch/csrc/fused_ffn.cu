// Fused transformer FFN for Hopper (sm_90a): dense -> activation -> dense,
// with the [M, N] intermediate kept on chip.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_ffn.py::_ffn_kernel
// (reached through fused_ffn / ffn_apply, selected by use_pallas="ffn" in
// the RoBERTa and CLIP towers and by pallas_ffn=True in the Whisper
// decode step). Per row tile and per chunk of JC intermediate columns:
// h = x·W1[:, chunk] + b1 in f32, rounded to the compute dtype, the
// activation with the casts of the JAX package's _act (tanh or erf GELU,
// or CLIP's quick_gelu), rounded again, then acc += g·W2[chunk, :] in f32;
// finally out = (acc + b2) in the compute dtype. The plain PyTorch version
// is fused_ffn_plain in misinfo_tpu_torch/ops/fused_ffn.py; the two sum in
// other orders, which misinfo_tpu_torch/ops/kernel_checks.py bounds.
//
// bf16: WMMA 16x16x16 bf16 tiles with f32 accumulators. A block of 8
// warps takes 32 rows (16 when K2 > 768, so that the accumulator
// fragments stay in registers): x's row tile sits in shared memory, each
// chunk's weight slabs (32 rows at a time) are staged through shared
// memory, the chunk's h goes to a shared f32 buffer, its activation to a
// shared bf16 buffer that feeds the second product, and the [rows, K2]
// accumulator stays in fragments across all chunks (~197 KB of shared
// memory at K = K2 = 768, JC = 512: one block per SM). f32 (the parity
// mode): plain FMAs, 16 rows per block, JC = 128, one row and 16-strided
// columns per thread. K2 is a template parameter, instantiated for the
// widths of every tower and Whisper size (384, 512, 768, 1024, 1280).
//
// What bounds it on this card: 2·M·N·(K + K2) flops (RoBERTa b32/S512:
// 154.6 GFLOP) on a few tens of MB, so it is compute-bound (~156 µs at
// 989 TFLOP/s bf16). This version reaches a fraction of that: WMMA (not
// wgmma), no asynchronous staging, and W1/W2 streamed again for each
// 32-row tile (from L2). Those are later work.

#include <mma.h>

#include "kernel_common.cuh"

using namespace nvcuda;
using int8k::act;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KS = 32;                    // weight rows staged per step

// ---------------------------------------------------------------- bf16

constexpr int JC = 512;                   // intermediate columns per chunk
constexpr int NT1 = JC / 16 / WARPS;      // first product: tiles per warp
constexpr size_t SMEM_MAX = 227 * 1024;   // shared memory per block

// 16-row tiles per block: 2 (32 rows) up to K2 = 768, else 1
template <int K2>
__host__ __device__ constexpr int row_tiles() { return K2 <= 768 ? 2 : 1; }

template <int K2>
size_t smem_bf16(int K) {
  constexpr int BM = 16 * row_tiles<K2>();
  const int sw = JC > K2 ? JC : K2;
  return (size_t)BM * JC * 4 + (size_t)BM * (K + 8) * 2 +
         (size_t)KS * (sw + 8) * 2 + (size_t)BM * (JC + 8) * 2;
}

// Copy rows [r0, r0 + KS) x columns [c0, c0 + w) of a row-major bf16
// matrix (row length ld) into a shared [KS][w + 8] slab.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int ld, int r0, int c0, int w) {
  const int segs = w >> 3;                  // 16-byte vectors per row
  for (int i = threadIdx.x; i < KS * segs; i += THREADS) {
    const int r = i / segs, s = i - r * segs;
    *reinterpret_cast<int4*>(dst + r * (w + 8) + s * 8) =
        *reinterpret_cast<const int4*>(src + (size_t)(r0 + r) * ld + c0 + s * 8);
  }
}

template <int K2, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                int M, int K, int N) {
  constexpr int NT2 = K2 / 16 / WARPS;      // second product: tiles per warp
  constexpr int RT = row_tiles<K2>();
  constexpr int BM = 16 * RT;               // rows per block
  extern __shared__ __align__(256) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);                // [BM][JC]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(hbuf + BM * JC);
  __nv_bfloat16* stage = xs + BM * (K + 8);                    // [KS][sw+8]
  constexpr int SW = JC > K2 ? JC : K2;
  __nv_bfloat16* gbuf = stage + KS * (SW + 8);                 // [BM][JC+8]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;
  const int LX = K + 8;

  // x's row tile; rows past M are zeros
  for (int i = threadIdx.x; i < BM * (K >> 3); i += THREADS) {
    const int r = i / (K >> 3), s = i - r * (K >> 3);
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < M)
      val = *reinterpret_cast<const int4*>(x + (size_t)(row0 + r) * K + s * 8);
    *reinterpret_cast<int4*>(xs + r * LX + s * 8) = val;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][NT2];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int t = 0; t < NT2; ++t) wmma::fill_fragment(acc[rt][t], 0.f);

  for (int j0 = 0; j0 < N; j0 += JC) {
    // 1. h = x · W1[:, j0:j0+JC] (f32)
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RT][NT1];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int t = 0; t < NT1; ++t) wmma::fill_fragment(c[rt][t], 0.f);
      for (int k0 = 0; k0 < K; k0 += KS) {
        __syncthreads();
        stage_bf16(stage, w1, N, k0, j0, JC);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a[RT];
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
            wmma::load_matrix_sync(a[rt], xs + rt * 16 * LX + k0 + kk * 16, LX);
#pragma unroll
          for (int t = 0; t < NT1; ++t) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b;
            wmma::load_matrix_sync(
                b, stage + kk * 16 * (JC + 8) + (warp * NT1 + t) * 16, JC + 8);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
              wmma::mma_sync(c[rt][t], a[rt], b, c[rt][t]);
          }
        }
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int t = 0; t < NT1; ++t)
          wmma::store_matrix_sync(hbuf + rt * 16 * JC + (warp * NT1 + t) * 16,
                                  c[rt][t], JC, wmma::mem_row_major);
    }
    __syncthreads();

    // 2. g = act(h + b1), rounded to bf16
    for (int i = threadIdx.x; i < BM * JC; i += THREADS) {
      const int r = i / JC, n = i - r * JC;
      gbuf[r * (JC + 8) + n] = __float2bfloat16_rn(
          act<true>(__fadd_rn(hbuf[i], b1[j0 + n]), MODE));
    }

    // 3. acc += g · W2[j0:j0+JC, :]
    for (int k0 = 0; k0 < JC; k0 += KS) {
      __syncthreads();
      stage_bf16(stage, w2, K2, j0 + k0, 0, K2);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
          wmma::load_matrix_sync(a[rt], gbuf + rt * 16 * (JC + 8) + k0 + kk * 16,
                                 JC + 8);
#pragma unroll
        for (int t = 0; t < NT2; ++t) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(
              b, stage + kk * 16 * (K2 + 8) + (warp * NT2 + t) * 16, K2 + 8);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
            wmma::mma_sync(acc[rt][t], a[rt], b, acc[rt][t]);
        }
      }
    }
  }
  __syncthreads();

  // 4. out = acc + b2 through a per-warp 16x16 scratch (hbuf is free)
  float* scr = hbuf + warp * 256;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int t = 0; t < NT2; ++t) {
      wmma::store_matrix_sync(scr, acc[rt][t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + (e >> 4);
        const int col = (warp * NT2 + t) * 16 + (e & 15);
        if (row0 + r < M)
          out[(size_t)(row0 + r) * K2 + col] =
              __float2bfloat16_rn(__fadd_rn(scr[e], b2[col]));
      }
      __syncwarp();
    }
}

// ----------------------------------------------------------------- f32

constexpr int FBM = 16;                   // rows per block
constexpr int FJC = 128;                  // intermediate columns per chunk
constexpr int FKS2 = 8;                   // W2 rows staged per step

template <int K2>
size_t smem_f32(int K) {
  return ((size_t)FBM * (K + 1) + (size_t)KS * FJC + (size_t)FBM * (FJC + 1) +
          (size_t)FKS2 * K2) * 4;
}

template <int K2, int MODE>
__global__ void __launch_bounds__(THREADS)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M,
               int K, int N) {
  constexpr int J2 = K2 / 16;             // output columns per thread
  extern __shared__ float fsmem[];
  float* xs = fsmem;                      // [FBM][K+1]
  float* w1s = xs + FBM * (K + 1);        // [KS][FJC]
  float* gs = w1s + KS * FJC;             // [FBM][FJC+1]
  float* w2s = gs + FBM * (FJC + 1);      // [FKS2][K2]
  const int tid = threadIdx.x, tx = tid & 15, r = tid >> 4;
  const int row0 = blockIdx.x * FBM;

  for (int i = tid; i < FBM * K; i += THREADS) {
    const int rr = i / K, k = i - rr * K;
    xs[rr * (K + 1) + k] = row0 + rr < M ? x[(size_t)(row0 + rr) * K + k] : 0.f;
  }
  float acc[J2];
#pragma unroll
  for (int j = 0; j < J2; ++j) acc[j] = 0.f;

  for (int j0 = 0; j0 < N; j0 += FJC) {
    float h[FJC / 16];
#pragma unroll
    for (int j = 0; j < FJC / 16; ++j) h[j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();
      for (int i = tid; i < KS * FJC; i += THREADS) {
        const int kr = i / FJC, c = i - kr * FJC;
        w1s[i] = w1[(size_t)(k0 + kr) * N + j0 + c];
      }
      __syncthreads();
      for (int kk = 0; kk < KS; ++kk) {
        const float a = xs[r * (K + 1) + k0 + kk];
#pragma unroll
        for (int j = 0; j < FJC / 16; ++j)
          h[j] = fmaf(a, w1s[kk * FJC + tx + 16 * j], h[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FJC / 16; ++j) {
      const int n = tx + 16 * j;
      gs[r * (FJC + 1) + n] = act<false>(__fadd_rn(h[j], b1[j0 + n]), MODE);
    }
    for (int n0 = 0; n0 < FJC; n0 += FKS2) {
      __syncthreads();
      for (int i = tid; i < FKS2 * K2; i += THREADS)
        w2s[i] = w2[(size_t)(j0 + n0) * K2 + i];
      __syncthreads();
#pragma unroll
      for (int nn = 0; nn < FKS2; ++nn) {
        const float g = gs[r * (FJC + 1) + n0 + nn];
#pragma unroll
        for (int j = 0; j < J2; ++j)
          acc[j] = fmaf(g, w2s[nn * K2 + tx + 16 * j], acc[j]);
      }
    }
  }
  if (row0 + r < M)
#pragma unroll
    for (int j = 0; j < J2; ++j)
      out[(size_t)(row0 + r) * K2 + tx + 16 * j] =
          __fadd_rn(acc[j], b2[tx + 16 * j]);
}

template <int K2, int MODE>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int K,
                   int N, int is_f32, cudaStream_t stream) {
  if (is_f32) {
    auto kern = ffn_f32_kernel<K2, MODE>;
    const size_t smem = smem_f32<K2>(K);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<(M + FBM - 1) / FBM, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
  }
  constexpr int BM = 16 * row_tiles<K2>();
  auto kern = ffn_bf16_kernel<K2, MODE>;
  const size_t smem = smem_bf16<K2>(K);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
}

template <int K2>
cudaError_t launch_mode(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int M,
                        int K, int N, int mode, int is_f32,
                        cudaStream_t st) {
  switch (mode) {
    case int8k::MODE_TANH:
      return launch<K2, int8k::MODE_TANH>(x, w1, b1, w2, b2, out, M, K, N,
                                          is_f32, st);
    case int8k::MODE_ERF:
      return launch<K2, int8k::MODE_ERF>(x, w1, b1, w2, b2, out, M, K, N,
                                         is_f32, st);
    case int8k::MODE_QUICK:
      return launch<K2, int8k::MODE_QUICK>(x, w1, b1, w2, b2, out, M, K, N,
                                           is_f32, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry: x [M, K], w1 [K, N], w2 [N, K2], out [M, K2], all bf16 (is_f32
// 0) or all f32 (1); b1 f32 [N], b2 f32 [K2]; contiguous. mode 0 tanh /
// 1 erf / 2 quick. Returns a cudaError_t (0 = launched). Supported:
// K2 ∈ {384, 512, 768, 1024, 1280}; K % 32 == 0 with the buffers of
// smem_bf16 / smem_f32 within 227 KB (K ≤ 1304 in bf16 up to K2 = 768,
// so every K = K2 here); N % 512 == 0 (bf16) or N % 128 == 0 (f32).
extern "C" int fused_ffn_launch(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int M, int K, int N, int K2, int mode,
                                int is_f32, void* stream) {
  if (M <= 0 || K <= 0 || K % KS || N <= 0 || N % (is_f32 ? FJC : JC))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K2) {
#define K2_CASE(W) \
    case W:        \
      return launch_mode<W>(x, w1, b1, w2, b2, out, M, K, N, mode, is_f32, st);
    K2_CASE(384)
    K2_CASE(512)
    K2_CASE(768)
    K2_CASE(1024)
    K2_CASE(1280)
#undef K2_CASE
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* fused_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
