// Similarities of a query batch against a packed int4 Truth Vault for
// Hopper (sm_90a):
//   out[b, n] = (Σ_d q[b, d] · nib[n, d]) · scale[n]            (K10a)
//   out[b, n] = ((Σ_d qi8[b, d] · nib[n, d]) · scale[n]) · qs[b]  (K10b)
// where row n is stored packed, byte j holding dim j in its low nibble and
// dim j + D/2 in its high nibble (two's complement).
//
// Replaces the TPU kernels misinfo_tpu/vault/int4.py::_int4_sims_kernel
// (K10a: bf16 query, f32 sums) and ::_int4_sims_kernel_i8 (K10b: int8
// query, int32 sums), reached through int4_sims_pallas and
// int4_sims_pallas_i8. The query type is a template parameter; the
// arithmetic follows the plain versions in misinfo_tpu_torch/vault/int4.py.
//
// What bounds it on this card: at a 1,048,576-row, 512-d vault each call
// reads 256 MiB of packed rows and writes B·4 MiB of sims; at 3.35 TB/s
// that is ~81 µs at B = 1 and ~120 µs at B = 32. The products are B·N·D
// (K10b: dp4a, four per instruction; K10a: f32 FMA), so from a few query
// rows on the arithmetic, not the bytes, sets the time of this simple
// design. What the design does about the bytes, the TPU kernel's point
// (0.5 byte per vault element from device memory):
//  - every packed row is read from device memory once, for all B queries:
//    the query batch (B ≤ 64) sits in shared memory for the life of a
//    persistent block (int8 for K10b, widened to f32 for K10a);
//  - a block stages a tile of 128 packed rows into shared memory with
//    coalesced 16-byte loads (rows padded by 16 bytes, so the per-thread
//    row reads below are free of bank conflicts);
//  - one thread owns one row: it sign-extends the nibbles in registers
//    (K10b: four at a time into int8 lanes with __vsub4) and sums over all
//    D dims for up to 16 queries at once (K10b with __dp4a, exact in
//    int32; K10a with f32 FMAs, whose products are exact), so no
//    cross-lane reduction is needed, and writes out[b, row] for every b:
//    neighbouring threads store neighbouring floats, a coalesced store;
//  - the epilogue multiplies with __fmul_rn, so no FMA contraction moves a
//    rounding (K10b is bitwise equal to its plain version);
//  - rows past N in the last tile are neither loaded nor stored.
// Tensor-core int8 tiles (mma.sync / wgmma) and a top-k fused into the
// epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // one packed row per thread
constexpr int TILE = THREADS;       // rows staged per tile
constexpr int PAD = 16;             // bytes after each staged row
constexpr int MAXB = 64;            // query rows per launch
constexpr int MAXD = 1024;
constexpr int LOADS = 8;            // 16-byte loads in flight per thread

// The four low (shift 0) or high (shift 4) nibbles of the bytes of w,
// sign-extended into the four int8 lanes of the result.
__device__ __forceinline__ int nibbles_s8(uint32_t w, int shift) {
  const uint32_t n = (w >> shift) & 0x0F0F0F0Fu;
  return static_cast<int>(__vsub4(n ^ 0x08080808u, 0x08080808u));
}

// Nibble value of byte i (shift 0: low, 4: high) of w as a float.
__device__ __forceinline__ float nibble_f32(uint32_t w, int i, int shift) {
  const int n = static_cast<int>(((w >> (8 * i + shift)) & 0xFu) ^ 8u) - 8;
  return __int2float_rn(n);
}

// K10b, queries b0..b0+QB-1 against the thread's staged row.
template <int QB>
__device__ __forceinline__ void row_i8(const uint8_t* srow,
                                       const int8_t* q, int b0, int D,
                                       float s, const float* __restrict__ qs,
                                       float* __restrict__ col, int N) {
  const int D2 = D >> 1;
  int acc[QB];
#pragma unroll
  for (int k = 0; k < QB; ++k) acc[k] = 0;
  for (int c = 0; c < D2; c += 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(srow + c);
    const int lo0 = nibbles_s8(w.x, 0), lo1 = nibbles_s8(w.y, 0),
              lo2 = nibbles_s8(w.z, 0), lo3 = nibbles_s8(w.w, 0);
    const int hi0 = nibbles_s8(w.x, 4), hi1 = nibbles_s8(w.y, 4),
              hi2 = nibbles_s8(w.z, 4), hi3 = nibbles_s8(w.w, 4);
#pragma unroll
    for (int k = 0; k < QB; ++k) {
      const int8_t* qr = q + (size_t)(b0 + k) * D;
      const int4 ql = *reinterpret_cast<const int4*>(qr + c);
      const int4 qh = *reinterpret_cast<const int4*>(qr + D2 + c);
      int a = acc[k];
      a = __dp4a(lo0, ql.x, a);
      a = __dp4a(lo1, ql.y, a);
      a = __dp4a(lo2, ql.z, a);
      a = __dp4a(lo3, ql.w, a);
      a = __dp4a(hi0, qh.x, a);
      a = __dp4a(hi1, qh.y, a);
      a = __dp4a(hi2, qh.z, a);
      a = __dp4a(hi3, qh.w, a);
      acc[k] = a;
    }
  }
#pragma unroll
  for (int k = 0; k < QB; ++k)
    col[(size_t)(b0 + k) * N] =
        __fmul_rn(__fmul_rn(__int2float_rn(acc[k]), s), qs[b0 + k]);
}

// K10a, queries b0..b0+QB-1 (f32 in shared memory) against the row.
template <int QB>
__device__ __forceinline__ void row_f32(const uint8_t* srow, const float* q,
                                        int b0, int D, float s,
                                        float* __restrict__ col, int N) {
  const int D2 = D >> 1;
  float acc[QB];
#pragma unroll
  for (int k = 0; k < QB; ++k) acc[k] = 0.f;
  for (int c = 0; c < D2; c += 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(srow + c);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    float lo[16], hi[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      lo[i] = nibble_f32(ws[i >> 2], i & 3, 0);
      hi[i] = nibble_f32(ws[i >> 2], i & 3, 4);
    }
#pragma unroll
    for (int k = 0; k < QB; ++k) {
      const float* qr = q + (size_t)(b0 + k) * D;
      float a = acc[k];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 ql = *reinterpret_cast<const float4*>(qr + c + 4 * v);
        a = fmaf(ql.x, lo[4 * v], a);
        a = fmaf(ql.y, lo[4 * v + 1], a);
        a = fmaf(ql.z, lo[4 * v + 2], a);
        a = fmaf(ql.w, lo[4 * v + 3], a);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 qh =
            *reinterpret_cast<const float4*>(qr + D2 + c + 4 * v);
        a = fmaf(qh.x, hi[4 * v], a);
        a = fmaf(qh.y, hi[4 * v + 1], a);
        a = fmaf(qh.z, hi[4 * v + 2], a);
        a = fmaf(qh.w, hi[4 * v + 3], a);
      }
      acc[k] = a;
    }
  }
#pragma unroll
  for (int k = 0; k < QB; ++k)
    col[(size_t)(b0 + k) * N] = __fmul_rn(acc[k], s);
}

// Grid: persistent blocks striding over tiles of TILE rows. Dynamic shared
// memory: TILE·(D/2 + PAD) bytes of staged rows, then the query (K10b:
// int8 [B, D]; K10a: f32 [B, D]).
template <bool I8>
__global__ void __launch_bounds__(THREADS)
int4_sims_kernel(const void* __restrict__ query,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 const float* __restrict__ qscale, float* __restrict__ out,
                 int B, int N, int D) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int D2 = D >> 1;
  const int stride = D2 + PAD;
  uint8_t* tile = sm;
  uint8_t* qsm = sm + (size_t)TILE * stride;
  if constexpr (I8) {
    const int4* src = static_cast<const int4*>(query);
    int4* dst = reinterpret_cast<int4*>(qsm);
    for (int i = threadIdx.x; i < B * D / 16; i += THREADS) dst[i] = src[i];
  } else {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(query);
    float* dst = reinterpret_cast<float*>(qsm);
    for (int i = threadIdx.x; i < B * D; i += THREADS)
      dst[i] = __bfloat162float(src[i]);
  }
  const int per_row = D2 / 16;
  const int tiles = (N + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * TILE;
    const int rows = min(TILE, N - r0);
    const int total = rows * per_row;
    __syncthreads();    // the query is staged; the last tile is consumed
    const uint4* src = reinterpret_cast<const uint4*>(packed +
                                                      (size_t)r0 * D2);
    for (int base = threadIdx.x; base < total; base += LOADS * THREADS) {
      uint4 v[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS;
        if (i < total) v[k] = src[i];
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS;
        if (i < total) {
          const int r = i / per_row, c = i - r * per_row;
          *reinterpret_cast<uint4*>(tile + r * stride + c * 16) = v[k];
        }
      }
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < rows) {
      const uint8_t* srow = tile + r * stride;
      const float s = scale[r0 + r];
      float* col = out + r0 + r;
      int b = 0;
      if constexpr (I8) {
        const int8_t* q = reinterpret_cast<const int8_t*>(qsm);
        for (; b + 16 <= B; b += 16) row_i8<16>(srow, q, b, D, s, qscale, col, N);
        if (B - b >= 8) { row_i8<8>(srow, q, b, D, s, qscale, col, N); b += 8; }
        if (B - b >= 4) { row_i8<4>(srow, q, b, D, s, qscale, col, N); b += 4; }
        if (B - b >= 2) { row_i8<2>(srow, q, b, D, s, qscale, col, N); b += 2; }
        if (B - b >= 1) row_i8<1>(srow, q, b, D, s, qscale, col, N);
      } else {
        const float* q = reinterpret_cast<const float*>(qsm);
        for (; b + 16 <= B; b += 16) row_f32<16>(srow, q, b, D, s, col, N);
        if (B - b >= 8) { row_f32<8>(srow, q, b, D, s, col, N); b += 8; }
        if (B - b >= 4) { row_f32<4>(srow, q, b, D, s, col, N); b += 4; }
        if (B - b >= 2) { row_f32<2>(srow, q, b, D, s, col, N); b += 2; }
        if (B - b >= 1) row_f32<1>(srow, q, b, D, s, col, N);
      }
    }
  }
}

template <bool I8>
cudaError_t run(const void* query, const uint8_t* packed, const float* scale,
                const float* qscale, float* out, int B, int N, int D,
                cudaStream_t st) {
  const size_t smem = (size_t)TILE * (D / 2 + PAD) +
                      (size_t)B * D * (I8 ? 1 : 4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int4_sims_kernel<I8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, int4_sims_kernel<I8>, THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (N + TILE - 1) / TILE;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  int4_sims_kernel<I8><<<grid, THREADS, smem, st>>>(query, packed, scale,
                                                     qscale, out, B, N, D);
  return cudaGetLastError();
}

}  // namespace

// C entry: query [B, D] (int8_query 1: int8 with qscale f32 [B]; 0: bf16,
// qscale ignored); packed uint8 [N, D/2]; scale f32 [N]; out f32 [B, N].
// All contiguous and 16-byte aligned. Returns a cudaError_t (0 =
// launched). Needs 1 ≤ B ≤ 64, N ≥ 1, D % 32 == 0, 32 ≤ D ≤ 1024.
extern "C" int int4_sims_launch(const void* query, const void* packed,
                                const void* scale, const void* qscale,
                                void* out, int B, int N, int D,
                                int int8_query, void* stream) {
  if (B < 1 || B > MAXB || N < 1 || D % 32 || D < 32 || D > MAXD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  if (int8_query)
    return run<true>(query, p, s, static_cast<const float*>(qscale), o, B,
                     N, D, st);
  return run<false>(query, p, s, nullptr, o, B, N, D, st);
}

extern "C" const char* int4_sims_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
