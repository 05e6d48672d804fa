// Row LayerNorm for Hopper (sm_90a): f32 two-pass mean and variance,
// rsqrt(var + eps), affine, output in the input's type.
//
// Replaces the TPU kernel inside misinfo_tpu/ops/pallas_attention.py::
// fused_layer_norm (its inner `kernel`). The plain PyTorch version is
// fused_layer_norm_plain in misinfo_tpu_torch/ops/fused_attention.py; the
// two differ in the order of the row sums and in rsqrtf's last bits, which
// misinfo_tpu_torch/ops/kernel_checks.py bounds.
//
// One warp per row, 8 rows per 256-thread block: the warp sums the row
// (lanes stride over it, then a butterfly), subtracts the mean and sums
// the squares in a second pass, and writes (x − mean)·rsqrt(var + eps)·
// scale + bias. What bounds it on this card: it reads each input once and
// writes each output once (16,384 × 768 bf16: 50.3 MB, ~15 µs at
// 3.35 TB/s) with a few flops per byte, so it is memory-bound; the second
// and third passes over a row read it from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out,
                  int rows, int D, float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += to_f32(xr[j]);
  const float mean = __fdiv_rn(warp_sum(s), (float)D);
  float ss = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = to_f32(xr[j]) - mean;
    ss = fmaf(d, d, ss);
  }
  const float r = rsqrtf(__fdiv_rn(warp_sum(ss), (float)D) + eps);
  T* orow = out + (size_t)row * D;
  for (int j = lane; j < D; j += 32)
    store(orow + j, fmaf((to_f32(xr[j]) - mean) * r, scale[j], bias[j]));
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* out, int rows, int D, float eps,
                   cudaStream_t stream) {
  layer_norm_kernel<T><<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

// C entry: x and out [rows, D] of one type (is_f32: 0 bf16, 1 f32), scale
// and bias f32 [D], contiguous. Returns a cudaError_t (0 = launched).
extern "C" int layer_norm_launch(const void* x, const void* scale,
                                 const void* bias, void* out, int rows, int D,
                                 float eps, int is_f32, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float>(x, scale, bias, out, rows, D, eps, st)
                : launch<__nv_bfloat16>(x, scale, bias, out, rows, D, eps, st);
}

extern "C" const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
