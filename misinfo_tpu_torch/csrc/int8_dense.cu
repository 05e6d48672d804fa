// int8 dense layer for Hopper (sm_90a): per-row int8 quantization of x in
// each block's prologue -> s8·s8 -> s32 tensor-core product -> f32
// epilogue ((yi·sx)·w_scale + bias) -> output dtype.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_int8.py::_dense_kernel
// (reached through int8_dense_pallas, dispatched by dense_int8_dispatch
// from 256 rows under quant="int8"). Bit for bit the plain PyTorch version
// in misinfo_tpu_torch/ops/int8_dense.py, which is the JAX function as XLA
// compiles it:
//   * the row scale is max(amax · f32(1/127), 1e-8): XLA folds JAX's
//     `/ 127.0` into a multiply by the constant's f32 reciprocal;
//   * xq = round_half_even(x / sx) with an IEEE division, clipped to ±127;
//   * the product is exact in s32, widened to f32 with one rounding;
//   * with a bias, y = (yi·sx)·w_scale + b with ONE rounding of the
//     multiply-add, as XLA fuses it: computed in double (the product of
//     two floats is exact there) and rounded to f32 once. Without a bias,
//     two f32 multiplies.
// Every operation is an explicit intrinsic, so no FMA contraction by nvcc
// changes a rounding. Never build with --use_fast_math.
//
// What bounds it on this card: at the main path's shapes (RoBERTa
// M = 16,384, K = N = 768) it does 2·M·K·N = 19.3 G int8 ops on ~51 MB of
// operands, so an ideal kernel is memory-bound (~15 µs at 3.35 TB/s) and
// close to the int8 tensor-core floor (~10 µs). This first version uses
// WMMA 16x16x16 s8 tiles: a block takes 32 rows x 256 columns, quantizes
// its 32 rows of x into shared memory (each of the N/256 column blocks of
// a row tile quantizes it again: x is read N/256 times, from L2 after the
// first), stages 32-row weight slabs through shared memory and keeps the
// s32 sums in fragments; the epilogue goes through a per-warp 16x16
// scratch. wgmma, TMA and a pipelined weight stream are later work.

#include <mma.h>

#include "kernel_common.cuh"

using namespace nvcuda;
using int8k::quant;
using int8k::tile_off;
using int8k::warp_max;

namespace {

constexpr int BM = 32;                  // rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 2;                   // 16-column tiles per warp
constexpr int BN = NT * 16 * WARPS;     // columns per block
constexpr int KS = 32;                  // weight rows staged per step
constexpr float R127 = 0x1.020408p-7f;  // f32(1/127)

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

size_t smem_bytes(int K) {
  return (size_t)BM * K + (size_t)KS * BN + (size_t)WARPS * 256 * 4 +
         (size_t)BM * 4;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
int8_dense_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ ws, const float* __restrict__ b,
                  TOut* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(256) unsigned char smem[];
  const int KT = K >> 4;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);            // [BM, K] tiles
  int8_t* stage = xq + BM * K;                             // [KS, BN] tiles
  int* scr = reinterpret_cast<int*>(stage + KS * BN);      // [WARPS][256]
  float* sx = reinterpret_cast<float*>(scr + WARPS * 256); // [BM]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  // 1. quantize the row tile; rows past M (the ragged edge) are zeros
  for (int r = warp; r < BM; r += WARPS) {
    const int gr = row0 + r;
    const TIn* xr = x + (size_t)gr * K;
    float amax = 0.f;
    if (gr < M)
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
    const float s = fmaxf(__fmul_rn(warp_max(amax), R127), 1e-8f);
    for (int k = lane; k < K; k += 32)
      xq[tile_off(r, k, KT)] = quant(gr < M ? to_f32(xr[k]) : 0.f, s);
    if (lane == 0) sx[r] = s;
  }

  // 2. yi = xq · W[:, col0:col0+BN] in s32 (columns past N read as zeros)
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[2][NT];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(c[rt][t], 0);
  constexpr int SEGS = BN / 16;
  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();
    for (int v = threadIdx.x; v < KS * SEGS; v += THREADS) {
      const int r = v / SEGS, nt = v - r * SEGS, col = col0 + nt * 16;
      int4 val = make_int4(0, 0, 0, 0);
      if (col < N)
        val = *reinterpret_cast<const int4*>(w + (size_t)(k0 + r) * N + col);
      *reinterpret_cast<int4*>(stage + (((r >> 4) * SEGS + nt) << 8) +
                               ((r & 15) << 4)) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[2];
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
        wmma::load_matrix_sync(a[rt], xq + ((rt * KT + (k0 >> 4) + kk) << 8),
                               16);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, stage + ((kk * SEGS + warp * NT + t) << 8),
                               16);
#pragma unroll
        for (int rt = 0; rt < 2; ++rt) wmma::mma_sync(c[rt][t], a[rt], bf, c[rt][t]);
      }
    }
  }

  // 3. epilogue through a per-warp 16x16 scratch; rows < M, columns < N
  int* ws_scr = scr + warp * 256;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      wmma::store_matrix_sync(ws_scr, c[rt][t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + (e >> 4);
        const int col = col0 + (warp * NT + t) * 16 + (e & 15);
        if (row0 + r < M && col < N) {
          const float p = __fmul_rn(__int2float_rn(ws_scr[e]), sx[r]);
          const float y =
              b ? __double2float_rn(__dadd_rn(
                      __dmul_rn((double)p, (double)ws[col]), (double)b[col]))
                : __fmul_rn(p, ws[col]);
          store(out + (size_t)(row0 + r) * N + col, y);
        }
      }
      __syncwarp();
    }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, const void* ws,
                   const void* b, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  auto kern = int8_dense_kernel<TIn, TOut>;
  const size_t smem = smem_bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const float*>(b),
      static_cast<TOut*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// C entry: x [M, K] (x_f32: 0 bf16, 1 f32), w s8 [K, N], ws f32 [N], b f32
// [N] or null, out [M, N] (out_f32: 0 bf16, 1 f32), all contiguous.
// Returns a cudaError_t (0 = launched). Supported: K % 32 == 0 and
// K <= 4096 (the quantized row tile lives in shared memory), N % 16 == 0.
extern "C" int int8_dense_launch(const void* x, const void* w, const void* ws,
                                 const void* b, void* out, int M, int K,
                                 int N, int x_f32, int out_f32,
                                 void* stream) {
  if (M <= 0 || K <= 0 || K % KS || K > 4096 || N <= 0 || N % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return out_f32 ? launch<float, float>(x, w, ws, b, out, M, K, N, st)
                   : launch<float, __nv_bfloat16>(x, w, ws, b, out, M, K, N, st);
  return out_f32
             ? launch<__nv_bfloat16, float>(x, w, ws, b, out, M, K, N, st)
             : launch<__nv_bfloat16, __nv_bfloat16>(x, w, ws, b, out, M, K, N,
                                                     st);
}

extern "C" const char* int8_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
