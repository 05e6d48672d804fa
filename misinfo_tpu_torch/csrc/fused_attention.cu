// Fused multi-head attention for Hopper (sm_90a):
//   out = softmax(Q·Kᵀ·scale + (1 − mask)·(−1e9), causal by where) · V
// with f32 scores and softmax, probabilities rounded to V's type, f32 PV
// sums and the output in Q's type; the [S, S_kv] scores never touch
// device memory.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_attention.py::_attn_kernel
// (reached through fused_attention, selected by use_pallas=True in
// ops/attention.py). Numerics follow that kernel, not the einsum path: the
// scores stay f32 (the einsum path rounds them to policy.score), the
// padding mask is added as (1 − m)·(−1e9), and the causal mask replaces a
// score by −1e9 (`where`), it is not added. The plain PyTorch version is
// fused_attention_plain in misinfo_tpu_torch/ops/fused_attention.py.
//
// One block per (query tile of QT = 32 rows, head, batch row), 256
// threads. The key axis is tiled in KT = 64-row tiles, staged in shared
// memory as f32, in two passes: the first computes each tile's scores into
// whole f32 score rows held in shared memory (S_kv ≤ 512: 64 KB), then a
// warp per row takes the exact softmax of its row; the second streams V's
// tiles and accumulates P·V in registers. So neither K nor V has to fit
// in shared memory whole (f32 K and V at S_kv = 512 take 256 KB, more than
// a block's 227 KB), and the softmax is the plain one, not an online
// rescaling. Each thread owns a 2 × 4 register tile of the scores and of
// the output; products are f32 FMAs on the CUDA cores.
//
// What bounds it on this card: at RoBERTa b32/S512 the work is 4·B·H·S²·D
// = 25.8 GFLOP on 100.7 MB of q/k/v/out, so an ideal kernel on the bf16
// tensor cores is memory-bound (~30 µs). This first version runs on the
// CUDA cores (67 TFLOP/s f32): ≥ 0.39 ms. Tensor-core tiles (wgmma on bf16
// Q/K/P/V), skipping causally masked tiles and keeping Q in registers are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 32;          // query rows per block
constexpr int KT = 64;          // key rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SKV = 512;    // whole f32 score rows in shared memory

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// a probability rounded to V's type, kept as f32
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int D, int skv_pad) {
  return ((size_t)QT * (D + 1) + (size_t)KT * (D + 1) +
          (size_t)QT * (skv_pad + 1)) * 4;
}

// q [B, S, H, D], k/v [B, Skv, H, D], mask [B, Skv] f32 or null,
// out [B, S, H, D]; D a template parameter (64 here).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ mask,
            T* __restrict__ out, int S, int H, int Skv, int causal,
            float scale) {
  constexpr int LD = D + 1;                 // padded rows: no bank conflicts
  constexpr int DJ = D / 16;                // output dims per thread
  extern __shared__ float smem[];
  const int skv_pad = (Skv + KT - 1) / KT * KT;
  const int LS = skv_pad + 1;
  float* qs = smem;                         // [QT][LD]
  float* kv = qs + QT * LD;                 // [KT][LD]
  float* sc = kv + KT * LD;                 // [QT][LS]

  const int s0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t row_stride = (size_t)H * D;
  const T* qb = q + ((size_t)b * S * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * H + h) * D;
  const T* vb = v + ((size_t)b * Skv * H + h) * D;

  for (int i = tid; i < QT * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qs[r * LD + d] = s0 + r < S ? to_f32(qb[(size_t)(s0 + r) * row_stride + d])
                                : 0.f;
  }

  // pass 1: scores of each key tile into the f32 score rows
  const int r0 = ty * 2;
  for (int t0 = 0; t0 < Skv; t0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      kv[r * LD + d] = t0 + r < Skv
                           ? to_f32(kb[(size_t)(t0 + r) * row_stride + d])
                           : 0.f;
    }
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = qs[r0 * LD + d], a1 = qs[(r0 + 1) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kj = kv[(tx + 16 * j) * LD + d];
        acc[0][j] = fmaf(a0, kj, acc[0][j]);
        acc[1][j] = fmaf(a1, kj, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + tx + 16 * j;
        if (key >= Skv) continue;
        float s = __fmul_rn(acc[i][j], scale);
        if (mask)
          s = __fadd_rn(s, __fmul_rn(__fsub_rn(1.f, mask[(size_t)b * Skv + key]),
                                     -1e9f));
        if (causal && s0 + r0 + i < key) s = -1e9f;
        sc[(r0 + i) * LS + key] = s;
      }
  }
  __syncthreads();

  // softmax of each row (a warp per row), probabilities rounded to V's type
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * LS;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < Skv; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Skv; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Skv; j += 32)
      row[j] = round_to(__fdiv_rn(row[j], sum), v);
  }

  // pass 2: out = P · V over V's tiles
  float acc[2][DJ] = {};
  for (int t0 = 0; t0 < Skv; t0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      kv[r * LD + d] = t0 + r < Skv
                           ? to_f32(vb[(size_t)(t0 + r) * row_stride + d])
                           : 0.f;
    }
    __syncthreads();
    const int nk = min(KT, Skv - t0);
    for (int c = 0; c < nk; ++c) {
      const float p0 = sc[r0 * LS + t0 + c], p1 = sc[(r0 + 1) * LS + t0 + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vj = kv[c * LD + tx + 16 * j];
        acc[0][j] = fmaf(p0, vj, acc[0][j]);
        acc[1][j] = fmaf(p1, vj, acc[1][j]);
      }
    }
  }
  T* ob = out + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (s0 + r0 + i >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(ob + (size_t)(s0 + r0 + i) * row_stride + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int S, int H,
                   int Skv, int causal, float scale, cudaStream_t stream) {
  constexpr int D = 64;
  auto kern = attn_kernel<T, D>;
  const size_t smem = smem_bytes(D, (Skv + KT - 1) / KT * KT);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), S, H, Skv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry: q [B, S, H, D], k/v [B, Skv, H, D], out [B, S, H, D], all of one
// type (is_f32: 0 bf16, 1 f32), mask f32 [B, Skv] or null, contiguous.
// Returns a cudaError_t (0 = launched). Supported: D == 64,
// 1 <= Skv <= 512, grid limits on H and B (≤ 65,535).
extern "C" int fused_attention_launch(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int S, int H, int Skv,
                                      int D, int causal, int is_f32,
                                      float scale, void* stream) {
  if (D != 64 || B <= 0 || S <= 0 || H <= 0 || Skv <= 0 || Skv > MAX_SKV ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  return is_f32 ? launch<float>(q, k, v, m, out, B, S, H, Skv, causal, scale,
                                st)
                : launch<__nv_bfloat16>(q, k, v, m, out, B, S, H, Skv, causal,
                                        scale, st);
}

extern "C" const char* fused_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
