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
// What bounds it on this card: at RoBERTa b32/S512 (H = 12, D = 64) the
// work is 4·B·H·S²·D = 25.8 GFLOP on 100.7 MB of q/k/v/out and the mask,
// so on the bf16 tensor cores (989 TFLOP/s) it is bound by the bytes:
// 0.0301 ms at 3.35 TB/s, against 0.026 ms of tensor-core time.
//
// bf16 (the serving type), on the tensor cores. One block per (query tile
// of 128 rows, head, batch row), eight warps of sixteen query rows. Q·Kᵀ
// and P·V are mma.sync.m16n8k16 bf16 products with f32 sums: the products
// of two bf16 values are exact in f32, only the order of the f32 sums
// differs from the plain version. Q stays in registers as A fragments; K
// and V stay bf16, staged with cp.async in 64-key tiles (rows of 128 B,
// 16-byte chunks swizzled by row so that ldmatrix reads no bank twice),
// double-buffered. JAX's softmax order is kept without holding score rows
// anywhere, in two walks over the key tiles: the first takes each row's
// max and the sum of exp(s − max) (per thread over its own columns with a
// running rescale, then merged over the four threads of a row); the
// second recomputes the scores (the tensor cores make that cheap), divides
// each exp by the sum (a multiply by the row's reciprocal), rounds the
// probability to bf16 and multiplies it into V (the score fragments are
// the P·V product's A fragments, so P never leaves registers). The
// padding term (1 − mask)·(−1e9) is formed once per key. Causal: a warp
// skips the key tiles that lie wholly above its rows' diagonal, whose
// scores are all exactly −1e9; the first walk adds their exp(−1e9 − max)
// by count, and the second walks them only where that is not 0 (a row
// whose visible keys are all padding, where every score sits near −1e9).
// Padded key tiles are never skipped. Beyond the f32 reordering, the
// probabilities differ from the plain version's by the reciprocal
// multiply (one rounding) and the rescaled sum; ops/kernel_checks.py's
// band covers both.
//
// f32 (parity mode only) stays on the CUDA cores, never in TF32: one block
// per (32 query rows, head, batch row), 256 threads, 64-key tiles staged in
// shared memory as f32, in two passes: the first computes whole f32 score
// rows into shared memory (S_kv ≤ 512: 64 KB) and a warp per row takes
// their exact softmax; the second streams V and accumulates P·V in
// registers, each thread owning a 2 × 4 register tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // the head width (every tower)
constexpr int KT = 64;          // keys per tile (ops/kernel_checks.py KEY_TILE)
constexpr int MAX_SKV = 512;
constexpr float NEG = -1e9f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TQ = 128;                 // query rows per block
constexpr int TC_THREADS = 256;         // eight warps of sixteen rows
constexpr int TILE_BYTES = KT * HD * 2; // one bf16 K or V tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a 16-byte copy, zero-filled where bytes == 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
// c += a·b, a 16×16 bf16 (row), b 16×8 bf16 (col), c 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// byte offset of 16-byte chunk c (of 8) in row r of a [KT][HD] bf16 tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (HD * 2) + ((c ^ (r & 7)) << 4);
}

// q [B, S, H, 64], k/v [B, Skv, H, 64] bf16, mask [B, Skv] f32 or null,
// out [B, S, H, 64] bf16. Grid (ceil(S / 128), H, B), TC_THREADS threads.
__global__ void __launch_bounds__(TC_THREADS, 2)
attn_bf16(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
          int S, int H, int Skv, int causal, float scale) {
  __shared__ __align__(128) unsigned char ks[2][TILE_BYTES];
  __shared__ __align__(128) unsigned char vs[2][TILE_BYTES];
  __shared__ float madd[MAX_SKV];   // (1 − mask)·(−1e9); −inf past Skv

  const int s0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD;             // row stride, elements
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * HD;
  const int nt = (Skv + KT - 1) / KT, steps = 2 * nt;
  for (int i = tid; i < nt * KT; i += TC_THREADS)   // published by the
    madd[i] = i >= Skv ? neg_inf()                  // loop's first barrier
              : mask ? __fmul_rn(__fsub_rn(1.f, mask[(size_t)b * Skv + i]),
                                 NEG)
                     : 0.f;

  // stage key tile t (and, in the second walk, value tile t) into buffer
  // st & 1: 512 chunks of 16 bytes each, two per thread and plane
  auto stage_tile = [&](int st) {
    const int t = st % nt, buf = st & 1;
    const bool with_v = st >= nt;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * TC_THREADS, r = i >> 3, c = i & 7;
      const int key = t * KT + r;
      const size_t off = (size_t)min(key, Skv - 1) * rs + c * 8;
      const int bytes = key < Skv ? 16 : 0;
      cp_async16(smem_addr(ks[buf]) + swz(r, c), kb + off, bytes);
      if (with_v) cp_async16(smem_addr(vs[buf]) + swz(r, c), vb + off, bytes);
    }
    cp_commit();
  };

  // this warp's sixteen rows: r0 = s0 + 16·warp + g and r1 = r0 + 8; Q as
  // the A fragments of four 16-wide k steps
  const int r0 = s0 + warp * 16 + g, r1 = r0 + 8;
  const int last_row = s0 + warp * 16 + 15;
  const bool active = s0 + warp * 16 < S;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD + 2 * tq;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t* a0 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * rs + 16 * kk);
    const uint32_t* a1 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * rs + 16 * kk);
    qf[kk][0] = r0 < S ? a0[0] : 0u;
    qf[kk][1] = r1 < S ? a1[0] : 0u;
    qf[kk][2] = r0 < S ? a0[4] : 0u;
    qf[kk][3] = r1 < S ? a1[4] : 0u;
  }
  // key tiles from `skip_from` on lie wholly above this warp's diagonal
  const int skip_from =
      causal ? min(nt, (last_row + KT) / KT) : nt;

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f}, inv[2];
  bool walk_skipped = false;
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  stage_tile(0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      stage_tile(st + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int second = st >= nt, t = st - second * nt, buf = st & 1;
    if (st == nt) {
      // merge the four threads of each row: max, then the rescaled sums
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float li = m[i] == neg_inf() ? 0.f
                                     : __fmul_rn(l[i], expf(__fsub_rn(m[i],
                                                                      mx)));
        li = __fadd_rn(li, __shfl_xor_sync(0xffffffffu, li, 1));
        li = __fadd_rn(li, __shfl_xor_sync(0xffffffffu, li, 2));
        // the skipped keys' scores, exactly −1e9 each
        const int nskip = Skv - skip_from * KT;
        if (nskip > 0) {
          const float m2 = fmaxf(mx, NEG);
          li = __fadd_rn(__fmul_rn(li, expf(__fsub_rn(mx, m2))),
                         __fmul_rn((float)nskip, expf(__fsub_rn(NEG, m2))));
          mx = m2;
        }
        m[i] = mx;
        inv[i] = __fdiv_rn(1.f, li);
      }
      walk_skipped = __any_sync(0xffffffffu,
                                expf(__fsub_rn(NEG, m[0])) != 0.f ||
                                    expf(__fsub_rn(NEG, m[1])) != 0.f);
    }
    if (active && (t < skip_from || (second && walk_skipped))) {
      // scores of the tile: s[j] holds keys key0 + 8j + 2tq (+1) of rows
      // r0 (elements 0, 1) and r1 (2, 3)
      const int key0 = t * KT;
      const uint32_t kbase = smem_addr(ks[buf]);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const int r = j * 8 + (lane & 7);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(kbase + swz(r, 4 * p + (lane >> 3)), b0, b1, b2, b3);
          mma_bf16(s[j], qf[2 * p], b0, b1);
          mma_bf16(s[j], qf[2 * p + 1], b2, b3);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          float x = __fadd_rn(__fmul_rn(s[j][e], scale), madd[key]);
          if (causal && (e < 2 ? r0 : r1) < key && key < Skv) x = NEG;
          s[j][e] = x;                 // keys past Skv stay −inf
        }
      if (!second) {
        // a running max and rescaled exp-sum over this thread's columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = m[i];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
          if (mx == neg_inf()) continue;     // only keys past Skv so far
          float sum = m[i] == neg_inf()
                          ? 0.f
                          : __fmul_rn(l[i], expf(__fsub_rn(m[i], mx)));
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum = __fadd_rn(sum, expf(__fsub_rn(s[j][2 * i], mx)));
            sum = __fadd_rn(sum, expf(__fsub_rn(s[j][2 * i + 1], mx)));
          }
          m[i] = mx;
          l[i] = sum;
        }
      } else {
        // probabilities rounded to bf16, as the A fragments of P·V
        const uint32_t vbase = smem_addr(vs[buf]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float p[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[u][e] = __fmul_rn(
                  expf(__fsub_rn(s[2 * kk + u][e], m[e >> 1])), inv[e >> 1]);
          const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                                 pack_bf16(p[0][2], p[0][3]),
                                 pack_bf16(p[1][0], p[1][1]),
                                 pack_bf16(p[1][2], p[1][3])};
          const int r = 16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vbase + swz(r, 2 * jj + (lane >> 4)), b0, b1, b2, b3);
            mma_bf16(o[2 * jj], a, b0, b1);
            mma_bf16(o[2 * jj + 1], a, b2, b3);
          }
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD + 2 * tq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * rs + 8 * j) =
          pack_bf16(o[j][0], o[j][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * rs + 8 * j) =
          pack_bf16(o[j][2], o[j][3]);
  }
}

// ------------------------------------------- f32: the CUDA cores (parity)

constexpr int QT = 32;          // query rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

size_t f32_smem_bytes(int skv_pad) {
  return ((size_t)QT * (HD + 1) + (size_t)KT * (HD + 1) +
          (size_t)QT * (skv_pad + 1)) * 4;
}

// The layouts of attn_bf16 in f32. Grid (ceil(S / 32), H, B), THREADS
// threads, f32_smem_bytes dynamic shared memory.
__global__ void __launch_bounds__(THREADS)
attn_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ mask,
         float* __restrict__ out, int S, int H, int Skv, int causal,
         float scale) {
  constexpr int D = HD;
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
  const float* qb = q + ((size_t)b * S * H + h) * D;
  const float* kb = k + ((size_t)b * Skv * H + h) * D;
  const float* vb = v + ((size_t)b * Skv * H + h) * D;

  for (int i = tid; i < QT * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qs[r * LD + d] = s0 + r < S ? qb[(size_t)(s0 + r) * row_stride + d] : 0.f;
  }

  // pass 1: scores of each key tile into the f32 score rows
  const int r0 = ty * 2;
  for (int t0 = 0; t0 < Skv; t0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      kv[r * LD + d] =
          t0 + r < Skv ? kb[(size_t)(t0 + r) * row_stride + d] : 0.f;
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
          s = __fadd_rn(
              s, __fmul_rn(__fsub_rn(1.f, mask[(size_t)b * Skv + key]), NEG));
        if (causal && s0 + r0 + i < key) s = NEG;
        sc[(r0 + i) * LS + key] = s;
      }
  }
  __syncthreads();

  // softmax of each row (a warp per row)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < QT; r += WARPS) {
    float* row = sc + r * LS;
    float m = neg_inf();
    for (int j = lane; j < Skv; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Skv; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Skv; j += 32) row[j] = __fdiv_rn(row[j], sum);
  }

  // pass 2: out = P · V over V's tiles
  float acc[2][DJ] = {};
  for (int t0 = 0; t0 < Skv; t0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      kv[r * LD + d] =
          t0 + r < Skv ? vb[(size_t)(t0 + r) * row_stride + d] : 0.f;
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
  float* ob = out + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (s0 + r0 + i >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)(s0 + r0 + i) * row_stride + tx + 16 * j] = acc[i][j];
  }
}

}  // namespace

// C entry: q [B, S, H, D], k/v [B, Skv, H, D], out [B, S, H, D], all of one
// type (is_f32: 0 bf16, 1 f32), mask f32 [B, Skv] or null, contiguous,
// 16-byte aligned. Returns a cudaError_t (0 = launched). Supported:
// D == 64, 1 <= Skv <= 512, grid limits on H and B (≤ 65,535).
extern "C" int fused_attention_launch(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int S, int H, int Skv,
                                      int D, int causal, int is_f32,
                                      float scale, void* stream) {
  if (D != HD || B <= 0 || S <= 0 || H <= 0 || Skv <= 0 || Skv > MAX_SKV ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (!is_f32) {
    attn_bf16<<<dim3((S + TQ - 1) / TQ, H, B), TC_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), m,
        static_cast<__nv_bfloat16*>(out), S, H, Skv, causal, scale);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes((Skv + KT - 1) / KT * KT);
  cudaError_t e = cudaFuncSetAttribute(
      attn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_f32<<<dim3((S + QT - 1) / QT, H, B), THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), m, static_cast<float*>(out), S, H, Skv,
      causal, scale);
  return cudaGetLastError();
}

extern "C" const char* fused_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
