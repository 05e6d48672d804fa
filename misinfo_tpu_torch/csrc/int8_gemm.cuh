// The int8 tensor-core mainloop that the int8 FFN (int8_ffn.cu, K1) and
// the int8 dense layer (int8_dense.cu, K2) share, for Hopper (sm_90a):
//
//   * quantize_rows_kernel: per-row int8 of x (bf16 or f32) with the scale
//     max(amax · f32(1/127), 1e-8) (jitted JAX's folded `/ 127.0`), one
//     warp per row, 16-byte loads, the row held in registers. Each row is
//     quantized once, whatever the number of column tiles after it.
//   * Mainloop: C = A · Bᵀ with A s8 [M, K] and B s8 [N, K], both K-major
//     (B is the weight's [out, in] buffer, which ops/serving.py keeps on
//     the card). A block owns a BM × BN output tile; one producer thread
//     streams 128-byte-deep K slices of the A and B tiles into a ring of
//     STAGES shared-memory stages by TMA (one tensor-map copy per tile,
//     zero-filled past the matrix edges), in the 128-byte swizzle that
//     wgmma's descriptors read, each stage's mbarrier counting its bytes
//     in; consumer warpgroups, each a 64 × WN slice of the tile, run
//     wgmma.m64nWNk32.s32.s8.s8 on a stage while the next ones load and
//     hand the stage back through a second mbarrier once their products
//     on it are done. Sums stay in registers (WN/2 s32 per thread).
//   * Epilogue helpers: the accumulator's fragment layout (thread t of a
//     warpgroup holds rows 16·(t/32) + (t%32)/4 and +8, columns
//     8i + 2·(t%4) and +1), and a 4 × 4 word transpose inside each quad
//     of lanes, after which every lane stores 16 contiguous bytes.
//   * The quantize without the conversion unit (which issues at 1/8 of
//     the rate of additions on this card) and with a division only near a
//     half-integer (quant).
//
// Every int8 product is exact in s32 whatever the order of summation, so
// the kernels on this mainloop are bit for bit their plain versions as
// long as their epilogues repeat the plain arithmetic: the IEEE quotient
// in the quantize, explicit intrinsics (no FMA contraction), never
// --use_fast_math. The ring is fed by TMA because 16-byte cp.async from
// one producer warp keeps too few bytes in flight to use L2's bandwidth.
#pragma once

#include <cuda.h>

#include <algorithm>

#include "kernel_common.cuh"

namespace i8g {

constexpr int BK = 128;                 // K bytes per stage (one swizzle row)
constexpr float R127 = 0x1.020408p-7f;  // f32(1/127)

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, R127), 1e-8f);
}

// int8k::quant(v, s) (the IEEE quotient v / s rounded half to even,
// clipped to ±127) for |v| <= amax, so that |v / s| <= 127.0000001, given
// r = __frcp_rn(s), without dividing: q = v·r is within 2^-22.9·|v / s| of
// v / s and the IEEE quotient within 2^-24·|v / s|, both below 2^-16.
// Unless q lies within 2^-14 of a half-integer, both therefore round to
// the integer nearest q; there (about one element in 8,000) the quotient
// is computed. Rounding adds 1.5·2^23, exact below 2^22, with no
// conversion instruction (those run at 1/8 of the rate of additions).
__device__ __forceinline__ int quant(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  float t = __fadd_rn(q, 12582912.0f);            // 1.5·2^23 + round(q)
  if (fabsf(__fsub_rn(q, __fsub_rn(t, 12582912.0f))) > 0.5f - 0x1p-14f)
    t = __fadd_rn(__fdiv_rn(v, s), 12582912.0f);
  return max(-127, min(127, __float_as_int(t) - 0x4b400000));
}

// ------------------------------------------------------------- quantize

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint2 quant8(const float* v, float s, float r) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    w[h] = (uint32_t)(uint8_t)quant(v[4 * h], s, r) |
           (uint32_t)(uint8_t)quant(v[4 * h + 1], s, r) << 8 |
           (uint32_t)(uint8_t)quant(v[4 * h + 2], s, r) << 16 |
           (uint32_t)(uint8_t)quant(v[4 * h + 3], s, r) << 24;
  return make_uint2(w[0], w[1]);
}

// xq [M, K] s8 and sx [M] f32 from x [M, K]; K % 8 == 0, rows 16-byte
// aligned. One warp per row, the warps of a grid sized to the card
// walking the rows in strides (no tail wave); each lane takes 8 elements
// in every 256. Rows of up to CACHE·256 elements stay in registers
// between the abs-max and the quantize, longer ones are read twice.
template <typename TIn, int CACHE>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const TIn* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * 8 + (threadIdx.x >> 5); row < M;
       row += gridDim.x * 8) {
    const TIn* xr = x + (size_t)row * K;
    int8_t* qr = xq + (size_t)row * K;
    float amax = 0.f, v[CACHE][8];
    if (K <= CACHE * 256) {
#pragma unroll
      for (int j = 0; j < CACHE; ++j)
        if (lane * 8 + j * 256 < K) load8(xr + lane * 8 + j * 256, v[j]);
#pragma unroll
      for (int j = 0; j < CACHE; ++j)
        if (lane * 8 + j * 256 < K)
#pragma unroll
          for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[j][i]));
      const float s = row_scale(int8k::warp_max(amax)), r = __frcp_rn(s);
#pragma unroll
      for (int j = 0; j < CACHE; ++j) {
        const int k = lane * 8 + j * 256;
        if (k < K) *reinterpret_cast<uint2*>(qr + k) = quant8(v[j], s, r);
      }
      if (lane == 0) sx[row] = s;
      continue;
    }
    for (int k = lane * 8; k < K; k += 256) {
      load8(xr + k, v[0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[0][i]));
    }
    const float s = row_scale(int8k::warp_max(amax)), r = __frcp_rn(s);
    for (int k = lane * 8; k < K; k += 256) {
      load8(xr + k, v[0]);
      *reinterpret_cast<uint2*>(qr + k) = quant8(v[0], s, r);
    }
    if (lane == 0) sx[row] = s;
  }
}

template <typename TIn>
cudaError_t quantize_rows(const TIn* x, int8_t* xq, float* sx, int M, int K,
                          cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int blocks = std::min((M + 7) / 8, 4 * sms);
  quantize_rows_kernel<TIn, 4><<<blocks, 256, 0, stream>>>(x, xq, sx, M, K);
  return cudaGetLastError();
}

// ------------------------------------------------------ PTX primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (k0, row0) of a 2-D tensor map into shared memory,
// counted in on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), tile 1024-byte aligned.
// Adding 2 to it steps 32 bytes (one k32 slice) along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across the async product
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 × N] (+)= A[64 × 32] · B[N × 32]ᵀ, s8 · s8 → s32, both operands
// in shared memory; `accumulate` 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ------------------------------------------------------------- mainloop

// Shared memory of a block: the ring (STAGES × (A tile + B tile), 1024-
// byte aligned), then the full and empty mbarriers, then `extra` bytes
// for the epilogue.
template <int BM, int BN, int STAGES>
struct Ring {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = (BM + BN) * BK;
  static constexpr size_t bytes(int extra) {
    return 1024 + (size_t)STAGES * STAGE + 16 * STAGES + extra;
  }
  uint32_t base;                        // stage 0, 1024-byte aligned
  __device__ uint32_t a(int s) const { return base + s * STAGE; }
  __device__ uint32_t b(int s) const { return base + s * STAGE + A_BYTES; }
  __device__ uint32_t full(int s) const {
    return base + STAGES * STAGE + 8 * s;
  }
  __device__ uint32_t empty(int s) const {
    return base + STAGES * STAGE + 8 * (STAGES + s);
  }
  __device__ unsigned char* extra(unsigned char* smem) const {
    return smem + (base - smem_u32(smem)) + STAGES * STAGE + 16 * STAGES;
  }
};

template <int BM, int BN, int STAGES>
__device__ __forceinline__ Ring<BM, BN, STAGES> make_ring(unsigned char* smem) {
  Ring<BM, BN, STAGES> r;
  r.base = (smem_u32(smem) + 1023) & ~1023u;
  return r;
}

// Barrier set-up, by every thread of the block before the roles split:
// full[s] waits for the producer's one arrival and the stage's bytes,
// empty[s] for the consumer warps.
template <int BM, int BN, int STAGES>
__device__ __forceinline__ void ring_init(const Ring<BM, BN, STAGES>& ring,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The producer (one thread): K slices [kb0, kb1) of A rows [m0, m0 + BM)
// and B rows [n0, n0 + BN) into the ring by TMA, each stage once the
// consumers have handed it back. `ma` / `mb` are the tensor maps of A and
// B (tensor_map: 128-byte boxes of BM and min(BN, 256) rows). `it` counts
// the slices loaded so far (it sets the stage and its phase).
template <int BM, int BN, int STAGES>
__device__ void produce(const Ring<BM, BN, STAGES>& ring,
                        const CUtensorMap* ma, int m0, const CUtensorMap* mb,
                        int n0, int kb0, int kb1, uint32_t& it) {
  constexpr int BOX = BN < 256 ? BN : 256;
  for (int kb = kb0; kb < kb1; ++kb, ++it) {
    const uint32_t s = it % STAGES;
    mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(ring.full(s), Ring<BM, BN, STAGES>::STAGE);
    tma_load(ring.a(s), ma, ring.full(s), kb * BK, m0);
#pragma unroll
    for (int r = 0; r < BN; r += BOX)
      tma_load(ring.b(s) + r * BK, mb, ring.full(s), kb * BK, n0 + r);
  }
}

// A consumer warpgroup's product over K slices [kb0, kb1): its 64 rows
// start at byte a_off of each A tile, its WN columns at b_off of each B
// tile. Every `chunk` slices the sums restart, after `fold(c)` has read
// the finished sums of chunk c (the s32 accumulator `acc`, WN/2 per
// thread). The product on a stage overlaps the copies into the others;
// each stage is handed back once its products are done, the tile's last
// before returning. `it` counts slices as the producer's does.
template <int WN, int BM, int BN, int STAGES, typename Fold>
__device__ __forceinline__ void consume(const Ring<BM, BN, STAGES>& ring,
                                        int a_off, int b_off, int kb0,
                                        int kb1, int chunk, int* acc,
                                        Fold&& fold, uint32_t& it) {
  const int lane = threadIdx.x & 31;
  for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i, ++it) {
    const uint32_t s = it % STAGES;
    mbar_wait(ring.full(s), (it / STAGES) & 1);
    const uint64_t da = sw128_desc(ring.a(s) + a_off);
    const uint64_t db = sw128_desc(ring.b(s) + b_off);
    const int first = i % chunk == 0;
    fence_regs<WN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 32; ++j)
      wgmma_s8<WN>(acc, da + 2 * j, db + 2 * j, !(first && j == 0));
    wgmma_commit();
    wgmma_wait<1>();                  // slice i - 1's products are done
    if (i > 0 && lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
    if ((i + 1) % chunk == 0) {
      wgmma_wait<0>();
      fence_regs<WN / 2>(acc);
      fold(i / chunk);
    }
  }
  wgmma_wait<0>();
  fence_regs<WN / 2>(acc);
  if (kb1 > kb0 && lane == 0) mbar_arrive(ring.empty((it - 1) % STAGES));
}

// ------------------------------------------------------------ epilogue

// Lane q of each quad holds w[p] destined for lane p; afterwards lane p
// holds in w[q] the word that lane q held for it.
__device__ __forceinline__ void quad_transpose(uint32_t* w) {
  const int p = threadIdx.x & 3;
  const bool hi = p & 2, odd = p & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
  if (hi) { w[0] = r0; w[1] = r1; } else { w[2] = r0; w[3] = r1; }
  r0 = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
  if (odd) { w[0] = r0; w[2] = r1; } else { w[1] = r0; w[3] = r1; }
}

// Four column pairs' words of one row (lane q's pair of 8-column group
// g in w[g]) → lane p's 16 bytes: group p of the four, in column order.
__device__ __forceinline__ uint4 gather_groups(uint32_t* w) {
  quad_transpose(w);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight groups' s8 pairs of one row (lane q's two bytes of group g in
// b[g]) → lane p's 16 bytes: columns 16p .. 16p + 15 of the 64.
__device__ __forceinline__ uint4 gather_bytes(const uint32_t* b) {
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) w[p] = b[2 * p] | b[2 * p + 1] << 16;
  quad_transpose(w);
  return make_uint4(__byte_perm(w[0], w[1], 0x5410),
                    __byte_perm(w[2], w[3], 0x5410),
                    __byte_perm(w[0], w[1], 0x7632),
                    __byte_perm(w[2], w[3], 0x7632));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

// ----------------------------------------------------------- host side

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per kernel
// and device
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// Tensor map of a K-major s8 matrix [rows, K] (row length K bytes, K %
// 16 == 0, 16-byte aligned): boxes of 128 bytes × box_rows rows in the
// 128-byte swizzle, zeros past the edges.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows,
                              int K, int box_rows) {
  const EncodeTiled f = encode_tiled();
  if (!f) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
           dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace i8g
