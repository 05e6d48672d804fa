// Row LayerNorm for Hopper (sm_90a): f32 two-pass mean and variance,
// rsqrt(var + eps), affine, output in the input's type.
//
// Replaces the TPU kernel inside misinfo_tpu/ops/pallas_attention.py::
// fused_layer_norm (its inner `kernel`). The plain PyTorch version is
// fused_layer_norm_plain in misinfo_tpu_torch/ops/fused_attention.py; the
// two differ in the order of the row sums and in rsqrtf's last bits, which
// misinfo_tpu_torch/ops/kernel_checks.py bounds.
//
// What bounds it on this card: it reads each input once and writes each
// output once (16,384 × 768 bf16: 50.3 MB, ~15 µs at 3.35 TB/s) with a few
// flops per byte, so it is memory-bound, and what decides the time is how
// many bytes are in flight and how wide each access is. The design:
//  - persistent warps: a grid of at most eight 128-thread blocks per SM
//    (as many as the registers allow), each warp walking rows warp, warp +
//    all warps, ...; each lane keeps its slice of scale and bias in
//    registers, loaded once per warp, not once per row;
//  - for the row widths the repo uses (512, 768, 1024, 1280; a template
//    parameter) the row is read once, in 16-byte pieces (8 bf16 or 4 f32
//    a lane; the warp moves 512 contiguous bytes per piece), and kept in
//    registers for both statistics passes and the output, which is written
//    with 16-byte streaming stores;
//  - the next rows are in flight while the current one reduces: each warp
//    streams its rows through a ring of 2-8 row buffers in shared memory
//    with cp.async, 1-7 rows ahead (7 for a 1.5 KB bf16 row of 768). A
//    first design that prefetched one row into registers read 0.054 ms
//    against the old warp-per-row kernel's 0.043 (H100, 16,384 × 768 bf16,
//    cold L2): one row ahead per warp keeps too few bytes in flight;
//  - any other width runs the same persistent warps over a general loop
//    (one element a lane per step, three passes over the row through
//    L1/L2, scale and bias from L1), which also serves rows that are not
//    16-byte aligned.
// One launch per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int WARPS = 4;            // warps per block
constexpr int MAX_BLOCKS_PER_SM = 8;

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

// 16 bytes of T as floats, and back (round to nearest even for bf16)
template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 put(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <> struct Pack<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 put(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages of a warp's ring for rows of `bytes`: rows in flight per warp,
// about 12 KB a warp.
__host__ __device__ constexpr int ring_stages(int bytes) {
  return bytes <= 1536 ? 8 : (bytes <= 2048 ? 6 : (bytes <= 4096 ? 3 : 2));
}

// Rows of compile-time width D. Lane l owns the 16-byte chunks
// c = i·32 + l (i < L) of every row: elements [c·V, c·V + V). Each warp
// streams its rows through a ring of NB row buffers in shared memory with
// cp.async, NB − 1 rows ahead of the one it reduces; a lane copies and
// reads only its own chunks, so no barrier is needed.
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out,
                int rows, float eps) {
  constexpr int V = Pack<T>::V;
  constexpr int L = D / (32 * V);
  constexpr int NB = ring_stages(D * (int)sizeof(T));
  static_assert(D % (32 * V) == 0, "row width must be whole warp loads");
  extern __shared__ __align__(16) uint4 ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* ring = ring_all + (size_t)warp * NB * L * 32;
  const int stride = gridDim.x * WARPS;
  const int first = blockIdx.x * WARPS + warp;
  if (first >= rows) return;

  float g[L * V], b[L * V];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = (i * 32 + lane) * V;
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 gs = *reinterpret_cast<const float4*>(scale + e + k);
      const float4 bs = *reinterpret_cast<const float4*>(bias + e + k);
      g[i * V + k] = gs.x, g[i * V + k + 1] = gs.y;
      g[i * V + k + 2] = gs.z, g[i * V + k + 3] = gs.w;
      b[i * V + k] = bs.x, b[i * V + k + 1] = bs.y;
      b[i * V + k + 2] = bs.z, b[i * V + k + 3] = bs.w;
    }
  }
  auto issue = [&](int row, int slot) {
    if (row < rows) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * D);
#pragma unroll
      for (int i = 0; i < L; ++i)
        cp_async16(ring + (slot * L + i) * 32 + lane, src + i * 32 + lane);
    }
    cp_async_commit();        // one group per row, empty past the end
  };
#pragma unroll
  for (int s = 0; s < NB - 1; ++s) issue(first + s * stride, s);
  int slot = 0;
  for (int row = first; row < rows; row += stride) {
    issue(row + (NB - 1) * stride, (slot + NB - 1) % NB);
    cp_async_wait<NB - 1>();  // this row's group has landed
    float v[L * V];
#pragma unroll
    for (int i = 0; i < L; ++i)
      Pack<T>::get(ring[(slot * L + i) * 32 + lane], v + i * V);
    slot = (slot + 1) % NB;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < L * V; ++j) s += v[j];
    const float mean = __fdiv_rn(warp_sum(s), (float)D);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < L * V; ++j) {
      const float d = v[j] - mean;
      ss = fmaf(d, d, ss);
    }
    const float r = rsqrtf(__fdiv_rn(warp_sum(ss), (float)D) + eps);
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float y[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = i * V + k;
        y[k] = fmaf((v[j] - mean) * r, g[j], b[j]);
      }
      __stcs(dst + i * 32 + lane, Pack<T>::put(y));
    }
  }
  cp_async_wait<0>();
}

// Any width (and rows that are not 16-byte aligned): the same persistent
// warps, one element a lane per step, three passes over the row.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_any(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int rows,
               int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += stride) {
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
}

// Blocks for `kernel`: at most MAX_BLOCKS_PER_SM per SM (fewer where the
// registers do not allow them), never more than the rows need. The
// occupancy and the SM count of the current device are kept per kernel.
template <typename K>
cudaError_t grid_for(K kernel, int rows, size_t smem, int* blocks) {
  struct Seen {
    const void* fn;
    int device, per_sm, sms;
  };
  static std::mutex mu;
  static Seen seen[32];
  static int n_seen = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int per_sm = 0, sms = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen; ++i)
      if (seen[i].fn == fn && seen[i].device == device)
        per_sm = seen[i].per_sm, sms = seen[i].sms;
    if (!sms) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
      if (e != cudaSuccess) return e;
      if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
      }
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        WARPS * 32, smem);
      if (e != cudaSuccess) return e;
      if (n_seen < 32) seen[n_seen++] = Seen{fn, device, per_sm, sms};
    }
  }
  per_sm = per_sm < 1 ? 1 : (per_sm > MAX_BLOCKS_PER_SM ? MAX_BLOCKS_PER_SM
                                                        : per_sm);
  const int need = (rows + WARPS - 1) / WARPS;
  *blocks = need < per_sm * sms ? need : per_sm * sms;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_rows(const void* x, const void* scale, const void* bias,
                        void* out, int rows, float eps, cudaStream_t st) {
  constexpr int bytes = D * (int)sizeof(T);
  constexpr size_t smem = (size_t)WARPS * ring_stages(bytes) * bytes;
  int blocks = 0;
  const cudaError_t e =
      grid_for(layer_norm_rows<T, D>, rows, smem, &blocks);
  if (e != cudaSuccess) return e;
  layer_norm_rows<T, D><<<blocks, WARPS * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* out, int rows, int D, float eps, cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(scale) |
        reinterpret_cast<uintptr_t>(bias)) & 15) == 0;
  if (aligned) switch (D) {
      case 512: return launch_rows<T, 512>(x, scale, bias, out, rows, eps, st);
      case 768: return launch_rows<T, 768>(x, scale, bias, out, rows, eps, st);
      case 1024:
        return launch_rows<T, 1024>(x, scale, bias, out, rows, eps, st);
      case 1280:
        return launch_rows<T, 1280>(x, scale, bias, out, rows, eps, st);
      default: break;
    }
  int blocks = 0;
  const cudaError_t e = grid_for(layer_norm_any<T>, rows, 0, &blocks);
  if (e != cudaSuccess) return e;
  layer_norm_any<T><<<blocks, WARPS * 32, 0, st>>>(
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
