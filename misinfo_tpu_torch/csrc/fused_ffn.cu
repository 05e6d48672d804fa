// Fused transformer FFN for Hopper (sm_90a): dense -> activation -> dense.
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_ffn.py::_ffn_kernel
// (reached through fused_ffn / ffn_apply, selected by use_pallas="ffn" in
// the RoBERTa and CLIP towers and by pallas_ffn=True in the Whisper
// decode step): h = x·W1 + b1 in f32, rounded to the compute dtype, the
// activation with the casts of the JAX package's _act (tanh or erf GELU,
// or CLIP's quick_gelu; int8k::act), rounded again (g), then out =
// (Σ g·W2 in f32 + b2) in the compute dtype. The plain PyTorch version is
// fused_ffn_plain in misinfo_tpu_torch/ops/fused_ffn.py; the two sum in
// other orders, which misinfo_tpu_torch/ops/kernel_checks.py bounds.
//
// What bounds it on this card: 2·M·N·(K + K2) bf16 flops (RoBERTa
// b32/S512: 154.6 GFLOP, ~156 µs at 989 TFLOP/s) on ~30 MB of operands:
// compute-bound, so the products belong on wgmma. bf16 design, two
// products on one tensor-core mainloop (the TMA ring, mbarriers and
// 128-byte swizzle of int8_gemm.cuh, the bf16 wgmma of wgmma_bf16.cuh):
//   1. up: g = act(bf16(x·W1 + b1)), written bf16 to an [M, N] scratch
//      buffer. A block owns a BM × BN tile of g; one producer thread
//      streams 64-element K slices of x (K-major, as stored) and of W1 by
//      TMA into a ring of STAGES stages, W1 as stored ([K, N], N
//      contiguous: boxes of 64 columns × 64 rows that wgmma reads
//      MN-major through its transpose bit, so no caller keeps a second
//      copy of the weights); consumer warpgroups of 64 × WN run
//      wgmma.m64nWNk16.f32.bf16.bf16 with the sums in registers. The
//      epilogue (bias, rounding, activation, rounding) runs in registers
//      and stores 16 bytes a lane after a quad transpose. At RoBERTa b32
//      the tile is 128 × 256 with four consumer warpgroups (sixteen warps
//      share the activation's instructions); fewer rows take 64 × 128 or
//      64 × 64 tiles with one warpgroup, two blocks to an SM.
//   2. down: out = bf16(g·W2 + b2), the same mainloop over K = N with one
//      f32 accumulator across all of N; a row tile's column tiles run
//      side by side, so its rows of g (100 MB at b32, above L2's 50 MB)
//      come from memory once. Where the output tiles do not fill the card
//      (one request, Whisper's decode rows), blocks also split N: each
//      writes its f32 partial sums and a third launch adds them in split
//      order, + b2, rounded.
// The intermediate makes a round trip through memory (2·2·M·N bytes, ~60
// µs of the card's 3.35 TB/s at b32): kept on chip, a 64-row block would
// hold a 64 × K2 f32 accumulator (384 registers a thread at K2 = 768) and
// stream all of W1 and W2 again per row tile, which the previous design
// did. The wrapper picks the tile configurations and the split
// (fused_ffn.plan) and passes them in.
//
// f32 (the parity mode): plain FMAs, 16 rows per block, JC = 128, one row
// and 16-strided columns per thread; K2 is a template parameter,
// instantiated for the widths of every tower and Whisper size (384, 512,
// 768, 1024, 1280).
//
// Numerics: __fadd_rn for + b1 and + b2, bf16 roundings of h and g as the
// plain version; never build with --use_fast_math.

#include "wgmma_bf16.cuh"

using int8k::act;

namespace {

constexpr size_t SMEM_MAX = 227 * 1024;   // shared memory per block

// ----------------------------------------------------------------- bf16

constexpr int KEL = i8g::BK / 2;          // bf16 elements per K slice (64)
constexpr int STAGES = 4;
constexpr int B_BOX = KEL * i8g::BK;      // bytes of a 64 × 64 W box (8 KB)

// The producer (one thread): K slices [kb0, kb1) of A rows [m0, m0 + BM)
// (K-major, boxes of 128 bytes × BM rows) and of B columns [n0, n0 + BN)
// (MN-major, boxes of 64 columns × 64 K rows) into the ring.
template <int BM, int BN>
__device__ void produce_bf16(const i8g::Ring<BM, BN, STAGES>& ring,
                             const CUtensorMap* ma, int m0,
                             const CUtensorMap* mb, int n0, int kb0, int kb1,
                             uint32_t& it) {
  for (int kb = kb0; kb < kb1; ++kb, ++it) {
    const uint32_t s = it % STAGES;
    i8g::mbar_wait(ring.empty(s), ((it / STAGES) & 1) ^ 1);
    i8g::mbar_expect_tx(ring.full(s), i8g::Ring<BM, BN, STAGES>::STAGE);
    i8g::tma_load(ring.a(s), ma, ring.full(s), kb * i8g::BK, m0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      i8g::tma_load(ring.b(s) + j * B_BOX, mb, ring.full(s),
                    (n0 + 64 * j) * 2, kb * KEL);
  }
}

// A consumer warpgroup's product over K slices [kb0, kb1): its 64 rows
// start at byte a_off of each A tile, its WN columns at b_off of each B
// tile; f32 sums in acc (WN/2 per thread, zero for an empty range). The
// product on a stage overlaps the copies into the others; each stage is
// handed back once its products are done.
template <int WN, int BM, int BN>
__device__ __forceinline__ void consume_bf16(
    const i8g::Ring<BM, BN, STAGES>& ring, int a_off, int b_off, int kb0,
    int kb1, float* acc, uint32_t& it) {
  const int lane = threadIdx.x & 31;
  for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i, ++it) {
    const uint32_t s = it % STAGES;
    i8g::mbar_wait(ring.full(s), (it / STAGES) & 1);
    const uint64_t da = i8g::sw128_desc(ring.a(s) + a_off);
    const uint64_t db = bf16w::mn_desc(ring.b(s) + b_off, B_BOX);
    bf16w::fence_acc<WN / 2>(acc);
    i8g::wgmma_fence();
#pragma unroll
    for (int j = 0; j < KEL / 16; ++j)
      bf16w::wgmma_bf16<WN, 1>(acc, da + 2 * j, db + 128 * j, i > 0 || j > 0);
    i8g::wgmma_commit();
    i8g::wgmma_wait<1>();             // slice i - 1's products are done
    if (i > 0 && lane == 0) i8g::mbar_arrive(ring.empty((it - 1) % STAGES));
  }
  i8g::wgmma_wait<0>();
  bf16w::fence_acc<WN / 2>(acc);
  if (kb1 > kb0 && lane == 0) i8g::mbar_arrive(ring.empty((it - 1) % STAGES));
}

// Tile configurations (the wrapper's plan): WGM × WGN consumer
// warpgroups of 64 × WN each, a tile of 64·WGM × WN·WGN, one producer
// warp. One warpgroup leaves room for two blocks on an SM.
__host__ __device__ constexpr int threads(int wgm, int wgn) {
  return wgm * wgn * 128 + 32;
}
__host__ __device__ constexpr int per_sm(int wgm, int wgn) {
  return wgm * wgn == 1 ? 2 : 1;
}

// The bf16 of an f32 that is one already: its high half.
__device__ __forceinline__ uint32_t bf16_bits(float lo, float hi) {
  return __float_as_uint(lo) >> 16 | (__float_as_uint(hi) & 0xffff0000u);
}

// Step 1: g tile (row tile blockIdx.y, column tile blockIdx.x).
template <int WGM, int WGN, int WN, int MODE>
__global__ void __launch_bounds__(threads(WGM, WGN), per_sm(WGM, WGN))
ffn_up_bf16(const __grid_constant__ CUtensorMap mx,
            const __grid_constant__ CUtensorMap mw,
            const float* __restrict__ b1, __nv_bfloat16* __restrict__ g,
            int M, int K, int N) {
  constexpr int WG = WGM * WGN, BM = 64 * WGM, BN = WN * WGN;
  extern __shared__ unsigned char smem[];
  const auto ring = i8g::make_ring<BM, BN, STAGES>(smem);
  i8g::ring_init(ring, 4 * WG);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nkb = (K + KEL - 1) / KEL;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  uint32_t it = 0;
  if (wg == WG) {
    if (lane == 0) produce_bf16(ring, &mx, m0, &mw, n0, 0, nkb, it);
    return;
  }
  const int wm = wg / WGN, wn = wg % WGN;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  consume_bf16<WN>(ring, wm * 64 * i8g::BK, wn * (WN / 64) * B_BOX, 0, nkb,
                   acc, it);

  const int q = lane & 3;
  const int r = m0 + wm * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int cb = n0 + wn * WN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
#pragma unroll
    for (int blk = 0; blk < WN / 32; ++blk) {
      uint32_t w[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const int i = blk * 4 + gg, c = cb + 8 * i + 2 * q;
        const float2 bv = c < N ? *reinterpret_cast<const float2*>(b1 + c)
                                : make_float2(0.f, 0.f);
        w[gg] = bf16_bits(act<true>(__fadd_rn(acc[4 * i + 2 * h], bv.x), MODE),
                          act<true>(__fadd_rn(acc[4 * i + 2 * h + 1], bv.y),
                                    MODE));
      }
      const uint4 v = i8g::gather_groups(w);
      const int col = cb + 8 * (blk * 4 + q);
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(g + (size_t)row * N + col) = v;
    }
  }
}

// Step 2: out tile (column tile blockIdx.x, row tile blockIdx.y) over K
// slices [z·per, min((z + 1)·per, N/64)) of split z = blockIdx.z: SPLIT
// false (one split) adds b2 and writes out, SPLIT true writes the f32
// sums to part [splits, M, K2].
template <int WGM, int WGN, int WN, bool SPLIT>
__global__ void __launch_bounds__(threads(WGM, WGN), per_sm(WGM, WGN))
ffn_down_bf16(const __grid_constant__ CUtensorMap mg,
              const __grid_constant__ CUtensorMap mw,
              const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
              float* __restrict__ part, int M, int N, int K2, int per) {
  constexpr int WG = WGM * WGN, BM = 64 * WGM, BN = WN * WGN;
  extern __shared__ unsigned char smem[];
  const auto ring = i8g::make_ring<BM, BN, STAGES>(smem);
  i8g::ring_init(ring, 4 * WG);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nkb = (N + KEL - 1) / KEL;
  const int kb0 = blockIdx.z * per, kb1 = min(nkb, kb0 + per);
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  uint32_t it = 0;
  if (wg == WG) {
    if (lane == 0) produce_bf16(ring, &mg, m0, &mw, n0, kb0, kb1, it);
    return;
  }
  const int wm = wg / WGN, wn = wg % WGN;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  consume_bf16<WN>(ring, wm * 64 * i8g::BK, wn * (WN / 64) * B_BOX, kb0, kb1,
                   acc, it);

  const int q = lane & 3;
  const int r = m0 + wm * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int cb = n0 + wn * WN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < WN / 8; ++i) {
        const int c = cb + 8 * i + 2 * q;
        if (row < M && c < K2)
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.z * M + row) * K2 + c) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int blk = 0; blk < WN / 32; ++blk) {
        uint32_t w[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          const int i = blk * 4 + gg, c = cb + 8 * i + 2 * q;
          const float2 bv = c < K2
                                ? *reinterpret_cast<const float2*>(b2 + c)
                                : make_float2(0.f, 0.f);
          w[gg] = i8g::pack_bf16(__fadd_rn(acc[4 * i + 2 * h], bv.x),
                                 __fadd_rn(acc[4 * i + 2 * h + 1], bv.y));
        }
        const uint4 v = i8g::gather_groups(w);
        const int col = cb + 8 * (blk * 4 + q);
        if (row < M && col < K2)
          *reinterpret_cast<uint4*>(out + (size_t)row * K2 + col) = v;
      }
    }
  }
}

// Split form, last launch: out = bf16(Σ_z part[z] in split order + b2),
// four elements a thread.
__global__ void ffn_reduce_bf16(const float* __restrict__ part,
                                const float* __restrict__ b2,
                                __nv_bfloat16* __restrict__ out, int M,
                                int K2, int splits) {
  const size_t n4 = (size_t)M * K2 / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* p = reinterpret_cast<const float4*>(part);
  float4 s = p[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = p[z * n4 + i];
    s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                    __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
  }
  const float4 b = *reinterpret_cast<const float4*>(b2 + (i * 4) % K2);
  *reinterpret_cast<uint2*>(out + i * 4) =
      make_uint2(i8g::pack_bf16(__fadd_rn(s.x, b.x), __fadd_rn(s.y, b.y)),
                 i8g::pack_bf16(__fadd_rn(s.z, b.z), __fadd_rn(s.w, b.w)));
}

template <int WGM, int WGN, int WN, int MODE>
cudaError_t launch_up(const void* x, const void* w1, const void* b1,
                      __nv_bfloat16* g, int M, int K, int N,
                      cudaStream_t stream) {
  constexpr int BM = 64 * WGM, BN = WN * WGN;
  CUtensorMap mx, mw;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mx, x, M, 2 * K, BM)) != cudaSuccess ||
      (e = i8g::tensor_map(&mw, w1, K, 2 * N, KEL)) != cudaSuccess)
    return e;
  const size_t smem = i8g::Ring<BM, BN, STAGES>::bytes(0);
  if ((e = i8g::allow_smem<ffn_up_bf16<WGM, WGN, WN, MODE>>(smem)) !=
      cudaSuccess)
    return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ffn_up_bf16<WGM, WGN, WN, MODE><<<grid, threads(WGM, WGN), smem, stream>>>(
      mx, mw, static_cast<const float*>(b1), g, M, K, N);
  return cudaGetLastError();
}

template <int WGM, int WGN, int WN>
cudaError_t launch_down(const __nv_bfloat16* g, const void* w2,
                        const void* b2, void* out, float* part, int M, int N,
                        int K2, int splits, int per, cudaStream_t stream) {
  constexpr int BM = 64 * WGM, BN = WN * WGN;
  CUtensorMap mg, mw;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mg, g, M, 2 * N, BM)) != cudaSuccess ||
      (e = i8g::tensor_map(&mw, w2, N, 2 * K2, KEL)) != cudaSuccess)
    return e;
  const size_t smem = i8g::Ring<BM, BN, STAGES>::bytes(0);
  // the column tiles of a row tile run side by side (its g rows then come
  // from memory once)
  const dim3 grid((K2 + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const auto* bias = static_cast<const float*>(b2);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (splits == 1) {
    if ((e = i8g::allow_smem<ffn_down_bf16<WGM, WGN, WN, false>>(smem)) !=
        cudaSuccess)
      return e;
    ffn_down_bf16<WGM, WGN, WN, false><<<grid, threads(WGM, WGN), smem,
                                         stream>>>(mg, mw, bias, o, nullptr,
                                                   M, N, K2, per);
    return cudaGetLastError();
  }
  if ((e = i8g::allow_smem<ffn_down_bf16<WGM, WGN, WN, true>>(smem)) !=
      cudaSuccess)
    return e;
  ffn_down_bf16<WGM, WGN, WN, true><<<grid, threads(WGM, WGN), smem,
                                      stream>>>(mg, mw, bias, o, part, M, N,
                                                K2, per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n4 = (size_t)M * K2 / 4;
  ffn_reduce_bf16<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      part, bias, o, M, K2, splits);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32

constexpr int THREADS = 256;
constexpr int KS = 32;                    // W1 rows staged per step
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
cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int M, int K,
                       int N, cudaStream_t stream) {
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

template <int K2>
cudaError_t launch_f32_mode(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int M,
                            int K, int N, int mode, cudaStream_t st) {
  switch (mode) {
    case int8k::MODE_TANH:
      return launch_f32<K2, int8k::MODE_TANH>(x, w1, b1, w2, b2, out, M, K, N,
                                              st);
    case int8k::MODE_ERF:
      return launch_f32<K2, int8k::MODE_ERF>(x, w1, b1, w2, b2, out, M, K, N,
                                             st);
    case int8k::MODE_QUICK:
      return launch_f32<K2, int8k::MODE_QUICK>(x, w1, b1, w2, b2, out, M, K,
                                               N, st);
  }
  return cudaErrorInvalidValue;
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

}  // namespace

// Bytes of the workspace the bf16 path needs: g [M, N] bf16 and, when N
// is split, the splits' f32 sums [splits, M, K2].
extern "C" size_t fused_ffn_workspace(int M, int N, int K2, int splits) {
  return align256((size_t)M * N * 2) +
         (splits > 1 ? (size_t)splits * M * K2 * 4 : 0);
}

// C entry: x [M, K], w1 [K, N], w2 [N, K2], out [M, K2], all bf16 (is_f32
// 0) or all f32 (1); b1 f32 [N], b2 f32 [K2]; contiguous, 16-byte
// aligned. mode 0 tanh / 1 erf / 2 quick. Returns a cudaError_t (0 =
// launched).
//   bf16: work (fused_ffn_workspace bytes); up ∈ {0: 128 × 256, 1: 64 ×
//   128, 2: 64 × 64} and down ∈ {0: 128 × 256, 1: 64 × 128, 2: 64 × 64}
//   the tiles of the two products; N split into `splits`
//   ranges of `per` 64-column slices (the last may be shorter, none
//   empty). Launches: up, down (+ reduce when split). Supported: K, N, K2
//   multiples of 8.
//   f32: one launch, work and the plan ignored. Supported: K2 ∈ {384,
//   512, 768, 1024, 1280}, K % 32 == 0 with smem_f32 within 227 KB, N %
//   128 == 0.
extern "C" int fused_ffn_launch(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                void* work, int M, int K, int N, int K2,
                                int mode, int is_f32, int up, int down,
                                int splits, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K2 <= 0 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  if (is_f32) {
    if (K % KS || N % FJC) return cudaErrorInvalidValue;
    switch (K2) {
#define K2_CASE(W) \
      case W:      \
        return launch_f32_mode<W>(x, w1, b1, w2, b2, out, M, K, N, mode, st);
      K2_CASE(384)
      K2_CASE(512)
      K2_CASE(768)
      K2_CASE(1024)
      K2_CASE(1280)
#undef K2_CASE
    }
    return cudaErrorInvalidValue;
  }
  const int nkb = (N + KEL - 1) / KEL;
  if (K % 8 || N % 8 || K2 % 8 || up < 0 || up > 2 || down < 0 ||
      down > 2 || splits < 1 || per < 1 || (splits - 1) * per >= nkb ||
      splits * per < nkb)
    return cudaErrorInvalidValue;
  auto* g = static_cast<__nv_bfloat16*>(work);
  float* part = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                         align256((size_t)M * N * 2));
  cudaError_t e = cudaErrorInvalidValue;
#define FFN_UP(U, WGM, WGN, WN, MD)                                          \
  if (up == (U) && mode == (MD))                                             \
    e = launch_up<WGM, WGN, WN, MD>(x, w1, b1, g, M, K, N, st);
  FFN_UP(0, 2, 2, 128, int8k::MODE_TANH) FFN_UP(0, 2, 2, 128, int8k::MODE_ERF)
  FFN_UP(0, 2, 2, 128, int8k::MODE_QUICK)
  FFN_UP(1, 1, 1, 128, int8k::MODE_TANH) FFN_UP(1, 1, 1, 128, int8k::MODE_ERF)
  FFN_UP(1, 1, 1, 128, int8k::MODE_QUICK)
  FFN_UP(2, 1, 1, 64, int8k::MODE_TANH) FFN_UP(2, 1, 1, 64, int8k::MODE_ERF)
  FFN_UP(2, 1, 1, 64, int8k::MODE_QUICK)
#undef FFN_UP
  if (e != cudaSuccess) return e;
  switch (down) {
    case 0:
      return launch_down<2, 2, 128>(g, w2, b2, out, part, M, N, K2, splits,
                                    per, st);
    case 1:
      return launch_down<1, 1, 128>(g, w2, b2, out, part, M, N, K2, splits,
                                    per, st);
    default:
      return launch_down<1, 1, 64>(g, w2, b2, out, part, M, N, K2, splits,
                                   per, st);
  }
}

extern "C" const char* fused_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
