// The bf16 warpgroup products that the fused FFN (fused_ffn.cu, K5), flash
// attention (flash_attention.cu, K11) and its backward
// (flash_attention_bwd.cu, K11-bwd) share, for Hopper (sm_90a):
// wgmma.m64nNk16.f32.bf16.bf16 with B in shared memory, K-major or
// MN-major (the transpose bit), and A in shared memory (K-major, the
// 128-byte swizzle: i8g::sw128_desc) or in registers. The TMA ring, the
// mbarriers and the K-major descriptor are int8_gemm.cuh's.
//
// Register fragments (thread t of the warpgroup, w = t / 32, g = (t % 32)
// / 4, q = t % 4): the f32 accumulator d[4i + e] holds row 16w + g (e <
// 2) or 16w + g + 8 (e >= 2), column 8i + 2q + (e & 1); an A operand in
// registers holds, per k16 slice, four words of two bf16 each: (row g,
// columns 2q, 2q + 1), (row g + 8, the same), (row g, 2q + 8, 2q + 9),
// (row g + 8, the same) of the warp's 16 rows. So the accumulator of one
// product, packed to bf16 in place (words 4kk .. 4kk + 3 from d[8kk] ..
// d[8kk + 7]), is the A operand of the next over its columns.
#pragma once

#include "int8_gemm.cuh"

namespace bf16w {

// wgmma descriptor of an MN-major bf16 tile in the 128-byte swizzle, as
// TMA lays out boxes of 64 columns (128 bytes) × K rows: 8-row groups
// 1024 bytes apart (SBO) along K, 64-column boxes box_bytes apart (LBO)
// along M/N, tile 1024-byte aligned. Adding 128 to it steps 16 K rows.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr,
                                            uint32_t box_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(box_bytes >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// keep the compiler from moving accumulator reads across the async product
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for an A operand in registers: live, and unmoved, until the
// product that reads it has been waited for
template <int R>
__device__ __forceinline__ void fence_words(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D[64 × N] (+)= A[64 × 16] · B[16 × N], bf16 · bf16 → f32, A K-major in
// shared memory, B MN-major (B_MN 1: the transpose bit) or K-major (0) in
// shared memory; `accumulate` 0 overwrites D.
template <int N, int B_MN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<64, 1>(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64, 0>(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define BF16W_N128_OUT                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define BF16W_N128_REGS                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "             \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "             \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "             \
  "%60, %61, %62, %63"

template <>
__device__ __forceinline__ void wgmma_bf16<128, 1>(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" BF16W_N128_REGS
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : BF16W_N128_OUT
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128, 0>(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" BF16W_N128_REGS
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : BF16W_N128_OUT
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef BF16W_N128_OUT
#undef BF16W_N128_REGS

// D[64 × 64] (+)= A[64 × 16] · B[16 × 64], A in registers (the four words
// of its k16 slice, in the layout above), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_bf16_rs64(float* d, const uint32_t* a,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

}  // namespace bf16w
