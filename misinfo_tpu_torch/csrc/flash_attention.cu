// Flash attention over segment ids (K11) for Hopper (sm_90a):
//   out = softmax(Q·Kᵀ·scale, keys of the query's segment, causal) · V
// with JAX's library numerics: f32 scores, an invisible score taken to
// s + mask_value (−0.7·f32 max), an online softmax over key blocks of 128
// (p = exp(s − m_next) rounded to V's type before the 1/l multiply, the
// accumulator rescaled by (alpha·l_prev)·(1/l_next) at every block), the
// output in Q's type; one key block (S_kv = 128) is JAX's single-step form
// (p / l rounded after the divide). The [S, S_kv] scores never touch
// device memory.
//
// Replaces the TPU kernel jax/experimental/pallas/ops/tpu/flash_attention.py
// ::_flash_attention_kernel_single_batch (and
// _flash_attention_kernel_single_batch_single_step), reached through
// flash_attention's pallas_call in _flash_attention_impl, which
// misinfo_tpu/ops/attention.py calls under use_pallas="flash". The plain
// PyTorch version is flash_attention_plain in
// misinfo_tpu_torch/ops/flash_attention.py.
//
// What bounds it on this card: at RoBERTa b32/S512 (H = 12, D = 64) the
// work is 4·B·H·S²·D = 25.8 GFLOP on 100.7 MB of q/k/v/out (the segment
// ids add 0.13 MB), so on the bf16 tensor cores (989 TFLOP/s) it is bound
// by the bytes: 0.0301 ms at 3.35 TB/s, against 0.026 ms of tensor-core
// time. The design keeps every byte it reads once per query tile: K and V
// tiles are read by each of the S/128 query tiles of a (row, head), so the
// device reads K and V S/128 times from L2 (4 at S = 512); the scores and
// probabilities live in registers.
//
// bf16 (the serving type), on the tensor cores. One block per (query tile
// of 128 rows, head, batch row), eight warps of sixteen query rows. Q·Kᵀ
// and P·V are mma.sync.m16n8k16 bf16 products with f32 sums. Q stays in
// registers as A fragments; K and V tiles of 128 keys (JAX's block_k, so
// that the running max, and with it every rounding of p, is the library's)
// are staged with cp.async together with the tile's key segment ids
// (rows of 128 B, 16-byte chunks swizzled by row so that ldmatrix reads no
// bank twice), double-buffered. One walk over the key tiles: per tile a
// warp takes its rows' scores, the scale and the mask, the tile's row max
// and the new running max, p = exp(s − m_next) and its row sum, then packs
// p as bf16 A fragments of P·V (P never leaves registers), multiplies them
// into V and folds the tile into the accumulator as
// acc·((alpha·l_prev)·(1/l_next)) + (P·V)·(1/l_next), JAX's order.
//
// Tiles are chosen before the walk, per query tile, into a list in shared
// memory: causal, JAX's own block skip (key tiles past the query tile's
// 128-row block); with segment ids, a key tile whose segment range cannot
// meet the query tile's is left out too, where every row of the query tile
// sees its own position (q_seg[r] == kv_seg[r]). Such a row's scores in a
// left-out tile are all exactly mask_value, and its own position's tile is
// walked, so leaving the tile out changes the row by at most one f32
// rounding of the rescale (l·(1/l) may be 1 − 2^-24); a query tile with a
// row that does not see itself (the padded form's padding queries) walks
// every tile, as the library does.
//
// f32 (parity mode only) stays on the CUDA cores, never in TF32: one block
// per (32 query rows, head, batch row), 256 threads; per listed key tile
// the f32 scores go to shared memory, a warp per row takes the online
// softmax step, then V is staged and each thread accumulates a 2 × 4 tile
// of the output in sequential FMA chains.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // the head width (every tower)
constexpr int KT = 128;         // keys per tile = JAX's block_k = block_q
constexpr int MAX_SKV = 65536;  // the tile list's bound (flash_attention.py)

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Into `tiles` the key tiles that the block's rows [s0, s0 + rows) walk;
// returns their count. sh holds four ints of scratch. Every thread calls it.
__device__ int plan_tiles(const int* __restrict__ qseg,
                          const int* __restrict__ kvseg, int b, int S, int Skv,
                          int s0, int rows, int causal, int* tiles,
                          unsigned char* keep, int* sh) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int nt = Skv / KT;
  const int last = causal ? min(nt - 1, s0 / KT) : nt - 1;
  if (tid == 0) {
    sh[0] = 0x7fffffff;   // q segment min
    sh[1] = -0x7fffffff - 1;  // q segment max
    sh[2] = 1;            // every row sees its own position
  }
  __syncthreads();
  if (qseg) {
    for (int t = tid; t < rows; t += nthreads) {
      const int r = s0 + t;
      if (r >= S) continue;
      const int qv = qseg[(size_t)b * S + r];
      atomicMin(&sh[0], qv);
      atomicMax(&sh[1], qv);
      if (r >= Skv || kvseg[(size_t)b * Skv + r] != qv) sh[2] = 0;
    }
  }
  __syncthreads();
  const bool seg_skip = qseg && sh[2];
  const int qmin = sh[0], qmax = sh[1];
  for (int j = warp; j <= last; j += nwarps) {
    bool k = true;
    if (seg_skip) {
      const int* ks = kvseg + (size_t)b * Skv + j * KT + lane * 4;
      int kmin = ks[0], kmax = ks[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        kmin = min(kmin, ks[i]);
        kmax = max(kmax, ks[i]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      }
      k = !(kmax < qmin || kmin > qmax);
    }
    if (lane == 0) keep[j] = k;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = 0; j <= last; ++j)
      if (keep[j]) tiles[n++] = j;
    sh[3] = n;
  }
  __syncthreads();
  return sh[3];
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int TQ = 128;                 // query rows per block
constexpr int TC_THREADS = 256;         // eight warps of sixteen rows
constexpr int TILE_BYTES = KT * HD * 2; // one bf16 K or V tile (16 KB)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
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

size_t bf16_smem_bytes(int nt) {
  return 4 * (size_t)TILE_BYTES + 2 * KT * sizeof(int) + 4 * sizeof(int) +
         nt * (sizeof(int) + 1);
}

// q [B, S, H, 64], k/v [B, Skv, H, 64] bf16, qseg [B, S] / kvseg [B, Skv]
// int32 or null, out [B, S, H, 64] bf16. Grid (S / 128, H, B), TC_THREADS
// threads, bf16_smem_bytes(Skv / 128) dynamic shared memory.
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ qseg,
           const int* __restrict__ kvseg, __nv_bfloat16* __restrict__ out,
           int S, int H, int Skv, int causal, float scale, float mask_value) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                       // [2][TILE_BYTES]
  unsigned char* vs = ks + 2 * TILE_BYTES;        // [2][TILE_BYTES]
  int* segs = reinterpret_cast<int*>(vs + 2 * TILE_BYTES);  // [2][KT]
  int* sh = segs + 2 * KT;                        // [4]
  const int nt = Skv / KT;
  int* tiles = sh + 4;                            // [nt]
  unsigned char* keep = reinterpret_cast<unsigned char*>(tiles + nt);

  const int s0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t rs = (size_t)H * HD;             // row stride, elements
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * HD;
  const int n_run = plan_tiles(qseg, kvseg, b, S, Skv, s0, TQ, causal,
                               tiles, keep, sh);
  const bool single = nt == 1;                  // JAX's single-step form

  // stage the i-th listed tile's keys, values and key segment ids into
  // buffer i & 1: 2 × 1,024 chunks of 16 bytes, eight per thread
  auto stage = [&](int i) {
    const int t = tiles[i], buf = i & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c16 = tid + j * TC_THREADS, r = c16 >> 3, c = c16 & 7;
      const size_t off = (size_t)(t * KT + r) * rs + c * 8;
      cp_async16(smem_addr(ks + buf * TILE_BYTES) + swz(r, c), kb + off);
      cp_async16(smem_addr(vs + buf * TILE_BYTES) + swz(r, c), vb + off);
    }
    if (kvseg && tid < KT / 4)
      cp_async16(smem_addr(segs + buf * KT + tid * 4),
                 kvseg + (size_t)b * Skv + t * KT + tid * 4);
    cp_commit();
  };

  // this warp's sixteen rows: r0 = s0 + 16·warp + g and r1 = r0 + 8; Q as
  // the A fragments of four 16-wide k steps
  const int r0 = s0 + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD + 2 * tq;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t* a0 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * rs + 16 * kk);
    const uint32_t* a1 =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * rs + 16 * kk);
    qf[kk][0] = a0[0];
    qf[kk][1] = a1[0];
    qf[kk][2] = a0[4];
    qf[kk][3] = a1[4];
  }
  const int qs0 = qseg ? qseg[(size_t)b * S + r0] : 0;
  const int qs1 = qseg ? qseg[(size_t)b * S + r1] : 0;

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  stage(0);
  for (int i = 0; i < n_run; ++i) {
    if (i + 1 < n_run) {
      stage(i + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = i & 1, key0 = tiles[i] * KT;
    const uint32_t kbase = smem_addr(ks + buf * TILE_BYTES);
    const uint32_t vbase = smem_addr(vs + buf * TILE_BYTES);
    const int* ksg = segs + buf * KT;

    // scores: s[j] holds keys key0 + 8j + 2tq (+1) of rows r0 (elements
    // 0, 1) and r1 (2, 3)
    float s[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * tq + (e & 1), row = e < 2 ? r0 : r1;
        float x = s[j][e];
        if (scale != 1.f) x = __fmul_rn(x, scale);
        const bool seen = (!kvseg || ksg[kl] == (e < 2 ? qs0 : qs1)) &&
                          (!causal || key0 + kl <= row);
        if (!seen) x = __fadd_rn(x, mask_value);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mn[2], inv[2], c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
      mn[r] = fmaxf(m[r], t);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[j][e], mn[e >> 1]));
        s[j][e] = p;
        sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, 2));
      const float alpha = expf(__fsub_rn(m[r], mn[r]));
      const float l_corr = __fmul_rn(alpha, l[r]);
      const float l_next = __fadd_rn(t, l_corr);
      inv[r] = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
      c[r] = __fmul_rn(l_corr, inv[r]);
      m[r] = mn[r];
      l[r] = l_next;
    }
    if (single) {
      // the single-step form: p / l, rounded after the divide
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = __fdiv_rn(s[j][e], l[e >> 1]);
    }

    // P (bf16, as the A fragments) · V
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r = 16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(vbase + swz(r, 2 * jj + (lane >> 4)), b0, b1, b2, b3);
        mma_bf16(o[2 * jj], a, b0, b1);
        mma_bf16(o[2 * jj + 1], a, b2, b3);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = single ? o[j][e]
                           : __fadd_rn(__fmul_rn(acc[j][e], c[e >> 1]),
                                       __fmul_rn(o[j][e], inv[e >> 1]));
    __syncthreads();
  }

  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD + 2 * tq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * rs + 8 * j) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * rs + 8 * j) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------- f32: the CUDA cores (parity)

constexpr int QT = 32;          // query rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LD = HD + 1;      // padded rows: no bank conflicts
constexpr int LS = KT + 1;

size_t f32_smem_bytes(int nt) {
  return ((size_t)QT * LD + (size_t)KT * LD + (size_t)QT * LS + KT +
          4 * QT + 4) * 4 + nt * (sizeof(int) + 1);
}

// The layouts of flash_bf16 in f32. Grid (S / 32, H, B), THREADS threads,
// f32_smem_bytes(Skv / 128) dynamic shared memory.
__global__ void __launch_bounds__(THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ qseg,
          const int* __restrict__ kvseg, float* __restrict__ out, int S,
          int H, int Skv, int causal, float scale, float mask_value) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                          // [QT][LD]
  float* kv = qs + QT * LD;                 // [KT][LD], K then V
  float* sc = kv + KT * LD;                 // [QT][LS]
  int* segs = reinterpret_cast<int*>(sc + QT * LS);  // [KT]
  float* rm = reinterpret_cast<float*>(segs + KT);   // running max [QT]
  float* rl = rm + QT;                      // running sum [QT]
  float* rc = rl + QT;                      // this tile's rescale [QT]
  float* ri = rc + QT;                      // this tile's 1/l [QT]
  int* sh = reinterpret_cast<int*>(ri + QT);          // [4]
  const int nt = Skv / KT;
  int* tiles = sh + 4;
  unsigned char* keep = reinterpret_cast<unsigned char*>(tiles + nt);

  const int s0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)H * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * Skv * H + h) * HD;
  const float* vb = v + ((size_t)b * Skv * H + h) * HD;
  const int n_run = plan_tiles(qseg, kvseg, b, S, Skv, s0, QT, causal,
                               tiles, keep, sh);
  const bool single = nt == 1;

  for (int i = tid; i < QT * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    qs[r * LD + d] = qb[(size_t)(s0 + r) * rs + d];
  }
  if (tid < QT) {
    rm[tid] = neg_inf();
    rl[tid] = 0.f;
  }
  const int r0 = ty * 2;                    // this thread's two rows
  int qv[2] = {0, 0};
  if (qseg) {
    qv[0] = qseg[(size_t)b * S + s0 + r0];
    qv[1] = qseg[(size_t)b * S + s0 + r0 + 1];
  }
  float acc[2][4] = {};

  for (int i = 0; i < n_run; ++i) {
    const int key0 = tiles[i] * KT;
    __syncthreads();
    for (int e = tid; e < KT * HD; e += THREADS) {
      const int r = e / HD, d = e - r * HD;
      kv[r * LD + d] = kb[(size_t)(key0 + r) * rs + d];
    }
    if (kvseg && tid < KT) segs[tid] = kvseg[(size_t)b * Skv + key0 + tid];
    __syncthreads();
    // scores of rows r0, r0 + 1 at keys tx + 16j
    float sa[2][8] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float a0 = qs[r0 * LD + d], a1 = qs[(r0 + 1) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kj = kv[(tx + 16 * j) * LD + d];
        sa[0][j] = fmaf(a0, kj, sa[0][j]);
        sa[1][j] = fmaf(a1, kj, sa[1][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = tx + 16 * j, row = s0 + r0 + r;
        float x = sa[r][j];
        if (scale != 1.f) x = __fmul_rn(x, scale);
        const bool seen = (!kvseg || segs[kl] == qv[r]) &&
                          (!causal || key0 + kl <= row);
        if (!seen) x = __fadd_rn(x, mask_value);
        sc[(r0 + r) * LS + kl] = x;
      }
    __syncthreads();
    // the online softmax step of each row (a warp per row)
    for (int r = warp; r < QT; r += WARPS) {
      float* row = sc + r * LS;
      float mx = neg_inf();
      for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, row[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(rm[r], mx);
      float sum = 0.f;
      for (int j = lane; j < KT; j += 32) {
        const float p = expf(__fsub_rn(row[j], mn));
        row[j] = p;
        sum = __fadd_rn(sum, p);
      }
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (single) {
        for (int j = lane; j < KT; j += 32) row[j] = __fdiv_rn(row[j], sum);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(rm[r], mn));
        const float l_corr = __fmul_rn(alpha, rl[r]);
        const float l_next = __fadd_rn(sum, l_corr);
        const float inv = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        rc[r] = __fmul_rn(l_corr, inv);
        ri[r] = inv;
        rm[r] = mn;
        rl[r] = l_next;
      }
    }
    __syncthreads();
    for (int e = tid; e < KT * HD; e += THREADS) {
      const int r = e / HD, d = e - r * HD;
      kv[r * LD + d] = vb[(size_t)(key0 + r) * rs + d];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float o[4] = {};
      const float* prow = sc + (r0 + r) * LS;
      for (int c = 0; c < KT; ++c) {
        const float p = prow[c];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = fmaf(p, kv[c * LD + tx + 16 * j], o[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[r][j] = single ? o[j]
                           : __fadd_rn(__fmul_rn(acc[r][j], rc[r0 + r]),
                                       __fmul_rn(o[j], ri[r0 + r]));
    }
  }
  float* ob = out + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[(size_t)(s0 + r0 + r) * rs + tx + 16 * j] = acc[r][j];
}

}  // namespace

// C entry: q [B, S, H, D], k/v [B, Skv, H, D], out [B, S, H, D], all of one
// type (is_f32: 0 bf16, 1 f32), segment ids int32 [B, S] and [B, Skv] (both
// or neither null), contiguous, 16-byte aligned. Returns a cudaError_t
// (0 = launched). Supported: D == 64, S and Skv positive multiples of 128,
// Skv <= 65,536, grid limits on H and B (<= 65,535).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* qseg,
                                      const void* kvseg, void* out, int B,
                                      int S, int H, int Skv, int D,
                                      int causal, int is_f32, float scale,
                                      float mask_value, void* stream) {
  if (D != HD || B <= 0 || S <= 0 || H <= 0 || Skv <= 0 || S % KT ||
      Skv % KT || Skv > MAX_SKV || B > 65535 || H > 65535 ||
      (qseg == nullptr) != (kvseg == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
  const int nt = Skv / KT;
  if (!is_f32) {
    const size_t smem = bf16_smem_bytes(nt);
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    flash_bf16<<<dim3(S / TQ, H, B), TC_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qs, ks,
        static_cast<__nv_bfloat16*>(out), S, H, Skv, causal, scale,
        mask_value);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_bytes(nt);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_f32<<<dim3(S / QT, H, B), THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qs, ks, static_cast<float*>(out), S, H,
      Skv, causal, scale, mask_value);
  return cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
