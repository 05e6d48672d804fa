// int8 dense layer for Hopper (sm_90a): per-row int8 quantization of x ->
// s8·s8 -> s32 on the tensor cores (wgmma) -> f32 epilogue
// ((yi·sx)·w_scale + bias) -> output dtype.
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
// operands, so it is memory-bound: ~15 µs at 3.35 TB/s against ~10 µs at
// the int8 tensor-core rate. The design (int8_gemm.cuh):
//   * x is quantized once per row by a vectorized pass (one warp per row)
//     into xq [M, K] s8 and sx [M]: 25 MB read, 12.6 MB written at
//     RoBERTa b32, where the earlier design quantized each row tile again
//     for every 256-column block;
//   * the product reads xq and the K-major weight (`kernel_q.t()`, the
//     [N, K] buffer ops/serving.py keeps on the card) through the shared
//     mainloop: 128 × 128 output tiles, two consumer warpgroups of 64 rows
//     on wgmma.m64n128k32, a producer thread keeping a 3-stage TMA ring
//     full, two blocks per SM so that one block's epilogue overlaps the
//     other's products;
//   * the epilogue works on the registers and stores 16 bytes per lane
//     (bf16) or 8 (f32).

#include "int8_gemm.cuh"

namespace {

constexpr int BM = 128, BN = 128, STAGES = 3, WN = 128;
constexpr int THREADS = 2 * 128 + 32;   // two consumer warpgroups, a producer
using RingT = i8g::Ring<BM, BN, STAGES>;

template <typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
int8_dense_kernel(const __grid_constant__ CUtensorMap mx,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ sx, const float* __restrict__ ws,
                  const float* __restrict__ b, TOut* __restrict__ out, int M,
                  int K, int N) {
  extern __shared__ unsigned char smem[];
  const auto ring = i8g::make_ring<BM, BN, STAGES>(smem);
  i8g::ring_init(ring, 8);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nkb = (K + i8g::BK - 1) / i8g::BK;
  const int wg = threadIdx.x >> 7;
  uint32_t it = 0;
  if (wg == 2) {
    if ((threadIdx.x & 31) == 0)
      i8g::produce(ring, &mx, m0, &mw, n0, 0, nkb, it);
    return;
  }
  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  i8g::consume<WN>(ring, wg * 64 * i8g::BK, 0, 0, nkb, nkb, acc,
                   [](int) {}, it);

  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r_lo = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float sxv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sxv[h] = r_lo + 8 * h < M ? sx[r_lo + 8 * h] : 0.f;
  // y = (yi·sx)·ws + b with one rounding (double: the product is exact),
  // each column's scale and bias widened once for both rows; 32 columns
  // at a time, then stored (16 bytes per lane for bf16)
#pragma unroll
  for (int blk = 0; blk < WN / 32; ++blk) {
    uint32_t w[2][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int i = blk * 4 + g, col = n0 + 8 * i + 2 * q;
      const bool ok = col < N;
      const float2 wv = ok ? *reinterpret_cast<const float2*>(ws + col)
                           : make_float2(0.f, 0.f);
      const float2 bv = ok && b ? *reinterpret_cast<const float2*>(b + col)
                                : make_float2(0.f, 0.f);
      float y[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wf = e ? wv.y : wv.x;
        const double wd = wf, bd = e ? bv.y : bv.x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p =
              __fmul_rn(__int2float_rn(acc[4 * i + 2 * h + e]), sxv[h]);
          y[h][e] = b ? __double2float_rn(__fma_rn(p, wd, bd))
                      : __fmul_rn(p, wf);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (sizeof(TOut) == 4) {
          if (r_lo + 8 * h < M && ok)
            *reinterpret_cast<float2*>(out + (size_t)(r_lo + 8 * h) * N +
                                       col) = make_float2(y[h][0], y[h][1]);
        } else {
          w[h][g] = i8g::pack_bf16(y[h][0], y[h][1]);
        }
      }
    }
    if constexpr (sizeof(TOut) == 2) {
      const int col = n0 + 8 * (blk * 4 + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = i8g::gather_groups(w[h]);
        if (r_lo + 8 * h < M && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)(r_lo + 8 * h) * N + col) =
              v;
      }
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* wt, const void* ws,
                   const void* b, void* out, void* work, int M, int K, int N,
                   cudaStream_t stream) {
  int8_t* xq = static_cast<int8_t*>(work);
  float* sx = reinterpret_cast<float*>(xq + (((size_t)M * K + 255) & ~255));
  cudaError_t e =
      i8g::quantize_rows(static_cast<const TIn*>(x), xq, sx, M, K, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mw;
  if ((e = i8g::tensor_map(&mx, xq, M, K, BM)) != cudaSuccess ||
      (e = i8g::tensor_map(&mw, wt, N, K, BN)) != cudaSuccess)
    return e;
  const size_t smem = RingT::bytes(0);
  if ((e = i8g::allow_smem<int8_dense_kernel<TOut>>(smem)) != cudaSuccess)
    return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);  // row tiles last
  int8_dense_kernel<TOut><<<grid, THREADS, smem, stream>>>(mx, mw, sx,
                                        static_cast<const float*>(ws),
                                        static_cast<const float*>(b),
                                        static_cast<TOut*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace int8_dense_launch needs: xq [M, K] s8, sx [M].
extern "C" size_t int8_dense_workspace(int M, int K) {
  return (((size_t)M * K + 255) & ~(size_t)255) + (size_t)M * 4;
}

// C entry: x [M, K] (x_f32: 0 bf16, 1 f32), wt s8 [N, K] (the K-major
// weight), ws f32 [N], b f32 [N] or null, out [M, N] (out_f32: 0 bf16,
// 1 f32), work (int8_dense_workspace bytes), all contiguous and 16-byte
// aligned. Two launches: the quantize pass, the product. Returns a
// cudaError_t (0 = launched). Supported: K % 16 == 0, N % 16 == 0.
extern "C" int int8_dense_launch(const void* x, const void* wt,
                                 const void* ws, const void* b, void* out,
                                 void* work, int M, int K, int N, int x_f32,
                                 int out_f32, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 || N <= 0 || N % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return out_f32 ? launch<float, float>(x, wt, ws, b, out, work, M, K, N, st)
                   : launch<float, __nv_bfloat16>(x, wt, ws, b, out, work, M,
                                                  K, N, st);
  return out_f32 ? launch<__nv_bfloat16, float>(x, wt, ws, b, out, work, M, K,
                                                N, st)
                 : launch<__nv_bfloat16, __nv_bfloat16>(x, wt, ws, b, out,
                                                        work, M, K, N, st);
}

extern "C" const char* int8_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
