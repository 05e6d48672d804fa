// Fused int8 FFN for Hopper (sm_90a): quantize rows -> s8 GEMM -> dequant +
// bias -> activation -> requantize per (row, chunk) -> s8 GEMM -> f32
// accumulate -> scale + bias, with the [M, N] intermediate kept on chip.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_int8.py::_ffn_kernel
// (reached through int8_ffn_pallas). Same math, same quantization
// granularity: the intermediate is processed in chunks of `jc` columns and
// its activations are quantized per (row, chunk), so results match the
// plain PyTorch version in misinfo_tpu_torch/ops/int8_ffn.py up to the
// ulps of tanh/erf/exp.
//
// What bounds it on this card: at the main path's shapes (K = 512/768,
// N = 2048/3072) the work is 2·M·N·(K + K2) int8 ops against M·(K + K2)·2
// bytes of activations and N·(K + K2) bytes of weights per block row, so
// it is compute-bound at serving batch sizes. This first version uses the
// int8 tensor cores through WMMA (16x16x16 s8·s8 -> s32) with weight slabs
// staged through shared memory, one 32-row tile per block; the f32
// accumulator [32, K2] and the chunk's intermediate live in shared memory
// (about 225 KB at K = K2 = 768, jc = 512), which holds the kernel to one
// block of 8 warps per SM. wgmma, TMA and a register-resident accumulator
// are later work.
//
// Small M (fewer 32-row tiles than SMs, e.g. one request) would leave most
// of the card idle, so there each block takes one (row tile, chunk) pair
// and writes its f32 partial (gq·W2)·sg to a workspace; a second kernel
// adds the partials in chunk order and applies s2, b2. The additions run
// in the same order as the single-block accumulator, so both forms give
// bit-identical results.
//
// Numerics: division is IEEE (__fdiv_rn) and rounding half-to-even
// (__float2int_rn); dequantization uses __fmul_rn/__fadd_rn so that no FMA
// contraction changes a rounding. Never build this file with
// --use_fast_math: approximate scales flip quantization levels.

#include <mma.h>

#include "kernel_common.cuh"

using namespace nvcuda;
using int8k::quant;
using int8k::tile_off;
using int8k::warp_max;

namespace {

constexpr int BM = 32;        // rows per block
constexpr int KS = 32;        // weight rows staged per step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

using int8k::MODE_ERF;
using int8k::MODE_QUICK;
using int8k::MODE_TANH;

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}

// Activation of the dequantized f32 pre-activation, with the casts of
// _act_f32: round to bf16, compute in f32, round to bf16.
__device__ __forceinline__ float act(float h32, int mode) {
  return int8k::act<true>(h32, mode);
}

// Copy rows [r0, r0 + KS) x columns [c0, c0 + w) of a row-major int8
// matrix with row length ld into 16x16 tiles (w/16 tiles per tile row).
__device__ __forceinline__ void stage_slab(int8_t* dst,
                                           const int8_t* __restrict__ src,
                                           int ld, int r0, int c0, int w) {
  const int segs = w >> 4;
  for (int v = threadIdx.x; v < KS * segs; v += THREADS) {
    const int r = v / segs, nt = v - r * segs;
    const int4 val = *reinterpret_cast<const int4*>(
        src + (size_t)(r0 + r) * ld + c0 + nt * 16);
    *reinterpret_cast<int4*>(dst + (((r >> 4) * segs + nt) << 8) +
                             ((r & 15) << 4)) = val;
  }
}

// Shared memory of one block; the split form keeps no accumulator.
template <int NT1, int NT2, bool SPLIT>
constexpr size_t smem_bytes(int K) {
  constexpr int JC = NT1 * 16 * WARPS;
  constexpr int K2 = NT2 * 16 * WARPS;
  return (size_t)BM * K + (size_t)BM * JC * 4 + (size_t)BM * JC +
         (SPLIT ? 0 : (size_t)BM * K2 * 4) + (size_t)KS * (JC > K2 ? JC : K2) +
         2 * BM * 4;
}

// One block: BM rows of x and all K2 outputs, over every chunk of JC
// intermediate columns (SPLIT false: accumulate in shared memory, write
// `out`) or over chunk blockIdx.y alone (SPLIT true: write the chunk's
// partial to `part` [N/JC, M, K2]). NT1 = 16-column tiles per warp in the
// first GEMM (JC = NT1·128), NT2 the same for the second (K2 = NT2·128);
// MODE is the activation.
template <int NT1, int NT2, int MODE, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
int8_ffn_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w1, const float* __restrict__ s1,
                const float* __restrict__ b1, const int8_t* __restrict__ w2,
                const float* __restrict__ s2, const float* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                int M, int K, int N) {
  constexpr int JC = NT1 * 16 * WARPS;
  constexpr int K2 = NT2 * 16 * WARPS;
  constexpr int SW = JC > K2 ? JC : K2;
  extern __shared__ __align__(256) unsigned char smem[];
  const int KT = K >> 4;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);          // [BM, K] tiles
  int* hbuf = reinterpret_cast<int*>(smem + BM * K);     // [BM, JC] s32/f32
  int8_t* gq = reinterpret_cast<int8_t*>(hbuf + BM * JC);  // [BM, JC] tiles
  float* acc = reinterpret_cast<float*>(gq + BM * JC);   // [BM, K2] unless SPLIT
  int8_t* stage = reinterpret_cast<int8_t*>(acc + (SPLIT ? 0 : BM * K2));
  float* sx = reinterpret_cast<float*>(stage + KS * SW);
  float* sg = sx + BM;
  float* hf = reinterpret_cast<float*>(hbuf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

  // 1. quantize the row tile; rows past M (the ragged edge) are zeros
  for (int r = warp; r < BM; r += WARPS) {
    const int gr = row0 + r;
    const __nv_bfloat16* xr = x + (size_t)gr * K;
    float amax = 0.f;
    if (gr < M)
      for (int k = lane; k < K; k += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
    const float s = row_scale(warp_max(amax));
    for (int k = lane; k < K; k += 32)
      xq[tile_off(r, k, KT)] = quant(gr < M ? __bfloat162float(xr[k]) : 0.f, s);
    if (lane == 0) sx[r] = s;
  }
  if constexpr (!SPLIT)
    for (int i = threadIdx.x; i < BM * K2; i += THREADS) acc[i] = 0.f;

  const int j_begin = SPLIT ? blockIdx.y * JC : 0;
  const int j_end = SPLIT ? j_begin + JC : N;
  for (int j0 = j_begin; j0 < j_end; j0 += JC) {
    // 2. h = xq · W1[:, j0:j0+JC] in s32
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[2][NT1];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int t = 0; t < NT1; ++t) wmma::fill_fragment(c[rt][t], 0);
      for (int k0 = 0; k0 < K; k0 += KS) {
        __syncthreads();
        stage_slab(stage, w1, N, k0, j0, JC);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a[2];
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
            wmma::load_matrix_sync(
                a[rt], xq + ((rt * KT + (k0 >> 4) + kk) << 8), 16);
#pragma unroll
          for (int t = 0; t < NT1; ++t) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::row_major> b;
            wmma::load_matrix_sync(
                b, stage + ((kk * (JC >> 4) + warp * NT1 + t) << 8), 16);
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
              wmma::mma_sync(c[rt][t], a[rt], b, c[rt][t]);
          }
        }
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int t = 0; t < NT1; ++t)
          wmma::store_matrix_sync(hbuf + rt * 16 * JC + (warp * NT1 + t) * 16,
                                  c[rt][t], JC, wmma::mem_row_major);
    }
    __syncthreads();

    // 3. dequant + bias + activation, requantized per (row, chunk)
    for (int r = warp; r < BM; r += WARPS) {
      const float s = sx[r];
      float amax = 0.f;
      for (int n = lane; n < JC; n += 32) {
        const float h = __fadd_rn(
            __fmul_rn(__fmul_rn((float)hbuf[r * JC + n], s), s1[j0 + n]),
            b1[j0 + n]);
        const float g = act(h, MODE);
        hf[r * JC + n] = g;
        amax = fmaxf(amax, fabsf(g));
      }
      const float sgr = row_scale(warp_max(amax));
      for (int n = lane; n < JC; n += 32)
        gq[tile_off(r, n, JC >> 4)] = quant(hf[r * JC + n], sgr);
      if (lane == 0) sg[r] = sgr;
    }
    __syncthreads();

    // 4. acc += (gq · W2[j0:j0+JC, :]) · sg
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[2][NT2];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int t = 0; t < NT2; ++t) wmma::fill_fragment(c[rt][t], 0);
      for (int k0 = 0; k0 < JC; k0 += KS) {
        __syncthreads();
        stage_slab(stage, w2, K2, j0 + k0, 0, K2);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a[2];
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
            wmma::load_matrix_sync(
                a[rt], gq + ((rt * (JC >> 4) + (k0 >> 4) + kk) << 8), 16);
#pragma unroll
          for (int t = 0; t < NT2; ++t) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::row_major> b;
            wmma::load_matrix_sync(
                b, stage + ((kk * (K2 >> 4) + warp * NT2 + t) << 8), 16);
#pragma unroll
            for (int rt = 0; rt < 2; ++rt)
              wmma::mma_sync(c[rt][t], a[rt], b, c[rt][t]);
          }
        }
      }
      // fold into acc through a per-warp 16x16 scratch (hbuf is free now)
      int* scr = hbuf + warp * 256;
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int t = 0; t < NT2; ++t) {
          wmma::store_matrix_sync(scr, c[rt][t], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = rt * 16 + (e >> 4);
            const int col = (warp * NT2 + t) * 16 + (e & 15);
            const float p = __fmul_rn((float)scr[e], sg[r]);
            if constexpr (SPLIT) {
              if (row0 + r < M)
                part[((size_t)blockIdx.y * M + row0 + r) * K2 + col] = p;
            } else {
              acc[r * K2 + col] = __fadd_rn(acc[r * K2 + col], p);
            }
          }
          __syncwarp();
        }
    }
  }
  if constexpr (SPLIT) return;
  __syncthreads();

  // 5. out = acc · s2 + b2, rows below M only
  for (int i = threadIdx.x; i < BM * K2; i += THREADS) {
    const int r = i / K2, col = i - r * K2;
    if (row0 + r < M)
      out[(size_t)(row0 + r) * K2 + col] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(acc[i], s2[col]), b2[col]));
  }
}

// Split form, second pass: out = (Σ_j part[j], in chunk order) · s2 + b2.
__global__ void int8_ffn_reduce(const float* __restrict__ part,
                                const float* __restrict__ s2,
                                const float* __restrict__ b2,
                                __nv_bfloat16* __restrict__ out, int M,
                                int K2, int chunks) {
  const size_t n = (size_t)M * K2;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int j = 0; j < chunks; ++j) acc = __fadd_rn(acc, part[j * n + i]);
  const int col = (int)(i % K2);
  out[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(acc, s2[col]), b2[col]));
}

template <int NT1, int NT2, int MODE, bool SPLIT>
cudaError_t launch_one(const void* x, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2,
                       const void* b2, void* out, float* part, int M, int K,
                       int N, cudaStream_t stream) {
  constexpr int JC = NT1 * 16 * WARPS;
  const size_t smem = smem_bytes<NT1, NT2, SPLIT>(K);
  auto kern = int8_ffn_kernel<NT1, NT2, MODE, SPLIT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, SPLIT ? N / JC : 1);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), part,
      M, K, N);
  e = cudaGetLastError();
  if (e != cudaSuccess || !SPLIT) return e;
  constexpr int K2 = NT2 * 16 * WARPS;
  const size_t n = (size_t)M * K2;
  int8_ffn_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), M, K2, N / JC);
  return cudaGetLastError();
}

template <int NT1, int NT2>
cudaError_t launch(const void* x, const void* w1, const void* s1,
                   const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, float* part, int M, int K,
                   int N, int mode, cudaStream_t stream) {
#define INT8_FFN_MODE(MD)                                                   \
  if (mode == MD)                                                          \
    return part ? launch_one<NT1, NT2, MD, true>(x, w1, s1, b1, w2, s2, b2, \
                                                 out, part, M, K, N, stream) \
                : launch_one<NT1, NT2, MD, false>(x, w1, s1, b1, w2, s2, b2, \
                                                  out, part, M, K, N, stream);
  INT8_FFN_MODE(MODE_TANH) INT8_FFN_MODE(MODE_ERF) INT8_FFN_MODE(MODE_QUICK)
#undef INT8_FFN_MODE
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry: x bf16 [M, K], w1 s8 [K, N], s1/b1 f32 [N], w2 s8 [N, K2],
// s2/b2 f32 [K2], out bf16 [M, K2], all contiguous; `part` is null (one
// block per row tile) or an f32 workspace [N/jc, M, K2] (split form).
// Returns a cudaError_t (0 = launched). Supported: jc ∈ {128, 256, 512}
// dividing N, K2 ∈ {512, 768}, K % 32 == 0, mode 0 tanh / 1 erf / 2 quick.
extern "C" int int8_ffn_launch(const void* x, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2,
                               const void* b2, void* out, void* part, int M,
                               int K, int N, int K2, int jc, int mode,
                               void* stream) {
  if (M <= 0 || K % KS || jc <= 0 || N % jc) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_FFN_CASE(J, C2)                                              \
  if (jc == (J) * 128 && K2 == (C2) * 128)                                \
    return launch<J, C2>(x, w1, s1, b1, w2, s2, b2, out,                  \
                         static_cast<float*>(part), M, K, N, mode, st);
  INT8_FFN_CASE(1, 4) INT8_FFN_CASE(1, 6)
  INT8_FFN_CASE(2, 4) INT8_FFN_CASE(2, 6)
  INT8_FFN_CASE(4, 4) INT8_FFN_CASE(4, 6)
#undef INT8_FFN_CASE
  return cudaErrorInvalidValue;
}

extern "C" const char* int8_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
