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
// ids add 0.13 MB): 0.0301 ms of bytes at 3.35 TB/s, 0.026 ms on the bf16
// tensor cores (989 TFLOP/s), and one precise expf per (query, key) pair
// walked, up to 100.7 M, ~0.026 ms at 16 a clock an SM. The floors are
// close together, so the kernel is bound by whichever of the three units
// it leaves idle: a design that runs the products, the softmax's CUDA-
// core and special-function work and the copies at once sits near the
// largest floor, one that takes them in turn near their sum.
//
// bf16 (the serving type): a warp-specialised, persistent kernel, one
// block of 384 threads an SM, walking work units of one 128-row query
// tile of one (batch row, head), the query tiles of a (row, head) next to
// each other so that its K and V stay in L2.
//   * The producer warpgroup (40 registers) plans each unit's key tiles
//     (below) with ballots and prefix popcounts, then one thread copies
//     them by TMA: q, k and v are viewed as [rows, H·128 bytes] tensor
//     maps, a box of 128 rows × 128 bytes at column 128·h in the 128-byte
//     swizzle. Q (with its 128 segment ids, a bulk copy) goes into one of
//     two buffers once per unit, ahead of the unit; each key tile's K, V
//     and segment ids into a ring of STAGES stages, each with a full and
//     an empty mbarrier, the tile's index and "last" flag beside them.
//   * Two consumer warpgroups (232 registers) own 64 rows each.
//     S = Q·Kᵀ is four wgmma.m64n128k16 with both operands K-major in
//     shared memory; P·V eight wgmma.m64n64k16 with P in registers (the S
//     accumulator packed to bf16 in place is exactly the A fragment) and
//     V read MN-major through the transpose bit (wgmma_bf16.cuh).
//   * Overlap: a warpgroup issues tile i's Q·Kᵀ and tile i − 1's P·V
//     together, then takes tile i's softmax while P·V runs, and folds
//     P·V into the accumulator after; the two warpgroups take turns to
//     issue (named barriers), so one's softmax runs under the other's
//     products. The ring hands a stage back once both have done its P·V.
//   * The grid is min(units, SMs) with blocks striding over the units;
//     the producer loads the next unit's Q and first tiles while the
//     consumers finish the current one, and the output leaves registers
//     in 16-byte stores after a transpose inside each quad of lanes.
// Per tile a warpgroup takes its rows' scores (the wgmma fragment: row
// 16w + g and + 8, keys 8i + 2q and + 1), the scale and the mask, the
// tile's row max over the quad and the new running max, p = exp(s −
// m_next) and its row sum, and folds the tile into the accumulator as
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
//
// Given two more pointers (flash_attention_launch_res), both forms also
// write JAX's residuals for the backward (csrc/flash_attention_bwd.cu):
// each query row's final running sum l and max m, [B, H, S] f32. A left-
// out tile leaves both exactly as walking it would (its p are all 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int HD = 64;          // the head width (every tower)
constexpr int KT = 128;         // keys per tile = JAX's block_k = block_q
constexpr int MAX_SKV = 65536;  // the tile list's bound (flash_attention.py)

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Into `tiles` the key tiles that the block's rows [s0, s0 + rows) walk;
// returns their count. sh holds four ints of scratch. Every thread calls it
// (the f32 kernel; the bf16 producer builds the same list in parallel).
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

constexpr int TQ = 128;                   // query rows per work unit
constexpr int TC_THREADS = 384;           // producer + two consumer groups
constexpr int STAGES = 4;                 // key tiles in the ring
constexpr int TILE_BYTES = KT * HD * 2;   // a bf16 K or V tile, or Q: 16 KB
constexpr int SEG_BYTES = KT * 4;         // a tile's segment ids
constexpr int PLAN_BAR = 1;               // the producer's named barrier
constexpr int TURN_BAR = 2;               // + c: consumer c's turn to issue

// shared memory, from a 1024-byte aligned base
constexpr int OFF_Q = 0;                                 // [2][TILE_BYTES]
constexpr int OFF_K = OFF_Q + 2 * TILE_BYTES;            // [STAGES][TILE]
constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;       // [STAGES][TILE]
constexpr int OFF_KSEG = OFF_V + STAGES * TILE_BYTES;    // [STAGES][KT] int
constexpr int OFF_QSEG = OFF_KSEG + STAGES * SEG_BYTES;  // [2][KT] int
constexpr int OFF_HDR = OFF_QSEG + 2 * SEG_BYTES;        // [STAGES] int2
constexpr int OFF_BAR = OFF_HDR + STAGES * 8;  // full, empty [STAGES],
                                               // qfull, qempty [2]
constexpr int OFF_RED = OFF_BAR + (2 * STAGES + 4) * 8;  // [4] int4
constexpr int OFF_KEEP = OFF_RED + 4 * 16;               // [MAX_SKV/KT] u8
constexpr int OFF_LIST = OFF_KEEP + MAX_SKV / KT;        // [MAX_SKV/KT] int
constexpr int BF16_SMEM = 1024 + OFF_LIST + MAX_SKV / KT * 4;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// work unit u: a query tile of (batch row, head) bh = u / nq, the nq
// tiles of a bh next to each other, their order turned by bh. A block
// walks units G apart (G the grid); were the tile u % nq, G a multiple of
// nq (132 of 4 at S = 512) would hand a block the same query tile every
// time, and the tiles that walk every key tile (the padding tail's) to a
// fixed quarter of the SMs.
struct Unit {
  int b, h, s0;
};
__device__ __forceinline__ Unit unit_of(int u, int nq, int H) {
  const int bh = u / nq;
  return {bh / H, bh % H, (u - bh * nq + bh) % nq * TQ};
}

// One online-softmax step of a consumer thread's rows r0 (elements 4i,
// 4i + 1 of sc) and r0 + 8 (4i + 2, 4i + 3) over a key tile's scores sc
// (key 8i + 2q + (e & 1) of the tile in sc[4i + e]): sc becomes p (p / l
// in the single-step form); m, l move on; c = (alpha·l_prev)·(1/l_next)
// and inv = 1/l_next. ksg: the tile's key segment ids; lim: r0 − (the
// tile's first key + 2q), for the causal test.
template <bool SEG, bool CAUSAL>
__device__ __forceinline__ void softmax_step(float (&sc)[64], const int* ksg,
                                             int qs0, int qs1, int lim,
                                             float scale, float mask_value,
                                             bool single, float (&m)[2],
                                             float (&l)[2], float (&c)[2],
                                             float (&inv)[2]) {
  const int q4 = threadIdx.x & 3;
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int2 ks = make_int2(0, 0);
    if constexpr (SEG)
      ks = *reinterpret_cast<const int2*>(ksg + 8 * i + 2 * q4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * i + e];
      if (scale != 1.f) x = __fmul_rn(x, scale);
      bool seen = true;
      if constexpr (SEG) seen = ((e & 1) ? ks.y : ks.x) == (e < 2 ? qs0 : qs1);
      if constexpr (CAUSAL)
        seen = seen && 8 * i + (e & 1) - 8 * (e >> 1) <= lim;
      if (!seen) x = __fadd_rn(x, mask_value);
      sc[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
    mn[r] = fmaxf(m[r], t);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = expf(__fsub_rn(sc[i], mn[(i >> 1) & 1]));
    sc[i] = p;
    sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], p);
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
    for (int i = 0; i < 64; ++i) sc[i] = __fdiv_rn(sc[i], l[(i >> 1) & 1]);
  }
}

// acc = acc·c + o·inv (o alone in the single-step form), per row
__device__ __forceinline__ void fold(float (&acc)[32], const float (&o)[32],
                                     const float (&c)[2],
                                     const float (&inv)[2], bool single) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    acc[i] = single ? o[i]
                    : __fadd_rn(__fmul_rn(acc[i], c[r]),
                                __fmul_rn(o[i], inv[r]));
  }
}

// o = P (bf16, registers) · V (the tile at v_tile, MN-major)
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  const uint64_t dv = bf16w::mn_desc(v_tile, TILE_BYTES);
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    bf16w::wgmma_bf16_rs64(o, p + 4 * kk, dv + 128 * kk, kk > 0);
}

// q [B, S, H, 64] (mq), k/v [B, Skv, H, 64] (mk, mv) bf16 through their
// tensor maps, qseg [B, S] / kvseg [B, Skv] int32 (SEG), out [B, S, H,
// 64] bf16. Grid min(units, SMs), TC_THREADS threads, BF16_SMEM bytes of
// dynamic shared memory; units = B·H·S/128.
template <bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bf16(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const int* __restrict__ qseg, const int* __restrict__ kvseg,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lres,
           float* __restrict__ mres, int S, int H, int Skv, int units,
           float scale, float mask_value) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = i8g::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full0 = base + OFF_BAR, empty0 = full0 + 8 * STAGES;
  const uint32_t qfull0 = empty0 + 8 * STAGES, qempty0 = qfull0 + 16;
  int2* hdr = reinterpret_cast<int2*>(sm + OFF_HDR);
  const int nq = S / TQ, nt = Skv / KT;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      i8g::mbar_init(full0 + 8 * s, 1);
      i8g::mbar_init(empty0 + 8 * s, 8);      // the consumers' eight warps
    }
    for (int i = 0; i < 2; ++i) {
      i8g::mbar_init(qfull0 + 8 * i, 1);
      i8g::mbar_init(qempty0 + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer: plan each unit's key tiles, copy them in
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    int4* red = reinterpret_cast<int4*>(sm + OFF_RED);
    unsigned char* keep = sm + OFF_KEEP;
    int* list = reinterpret_cast<int*>(sm + OFF_LIST);
    uint32_t it = 0;                          // stages filled so far
    int k = 0;                                // units begun
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const Unit w = unit_of(u, nq, H);
      const int last = CAUSAL ? min(nt - 1, w.s0 / KT) : nt - 1;
      int n = last + 1;
      bool listed = false;
      if constexpr (SEG) {
        // the query tile's segment range, and whether every row sees its
        // own position (a thread a row)
        const int* qs = qseg + (size_t)w.b * S;
        const int* ks = kvseg + (size_t)w.b * Skv;
        const int r = w.s0 + t;
        const int qv = qs[r];
        const bool own = r < Skv && ks[r] == qv;
        int lo = qv, hi = qv;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        const int all = __all_sync(0xffffffffu, own);
        if (lane == 0) red[warp] = make_int4(lo, hi, all, 0);
        i8g::named_sync(PLAN_BAR, 128);
        int qmin = red[0].x, qmax = red[0].y, anchored = red[0].z;
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          qmin = min(qmin, red[i].x);
          qmax = max(qmax, red[i].y);
          anchored &= red[i].z;
        }
        if (anchored) {
          // keep[j]: tile j's segment range meets the query tile's (a
          // warp a tile, four ids a lane)
          for (int j = warp; j <= last; j += 4) {
            const int4 kv =
                *reinterpret_cast<const int4*>(ks + j * KT + lane * 4);
            int kmin = min(min(kv.x, kv.y), min(kv.z, kv.w));
            int kmax = max(max(kv.x, kv.y), max(kv.z, kv.w));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
              kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
            }
            if (lane == 0) keep[j] = !(kmax < qmin || kmin > qmax);
          }
          i8g::named_sync(PLAN_BAR, 128);
          if (warp == 0) {
            // the kept tiles in order: 32 at a time, each lane's place
            // the count of kept tiles below it
            int m = 0;
            for (int j0 = 0; j0 <= last; j0 += 32) {
              const int j = j0 + lane;
              const bool kj = j <= last && keep[j];
              const unsigned bal = __ballot_sync(0xffffffffu, kj);
              if (kj) list[m + __popc(bal & ((1u << lane) - 1))] = j;
              m += __popc(bal);
            }
            n = m;
            __syncwarp();
          }
          listed = true;
        }
      }
      if (t == 0) {
        const int qb = k & 1;
        i8g::mbar_wait(qempty0 + 8 * qb, ((k >> 1) & 1) ^ 1);
        i8g::mbar_expect_tx(qfull0 + 8 * qb,
                            TILE_BYTES + (SEG ? SEG_BYTES : 0));
        i8g::tma_load(base + OFF_Q + qb * TILE_BYTES, &mq, qfull0 + 8 * qb,
                      w.h * HD * 2, w.b * S + w.s0);
        if constexpr (SEG)
          bulk_load(base + OFF_QSEG + qb * SEG_BYTES,
                    qseg + (size_t)w.b * S + w.s0, SEG_BYTES,
                    qfull0 + 8 * qb);
        for (int i = 0; i < n; ++i, ++it) {
          const int j = listed ? list[i] : i;
          const int s = it % STAGES;
          i8g::mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          hdr[s] = make_int2(j, i == n - 1);
          i8g::mbar_expect_tx(full0 + 8 * s,
                              2 * TILE_BYTES + (SEG ? SEG_BYTES : 0));
          const int row = w.b * Skv + j * KT;
          i8g::tma_load(base + OFF_K + s * TILE_BYTES, &mk, full0 + 8 * s,
                        w.h * HD * 2, row);
          i8g::tma_load(base + OFF_V + s * TILE_BYTES, &mv, full0 + 8 * s,
                        w.h * HD * 2, row);
          if constexpr (SEG)
            bulk_load(base + OFF_KSEG + s * SEG_BYTES, kvseg + (size_t)row,
                      SEG_BYTES, full0 + 8 * s);
        }
      }
      // red, keep and list are the next unit's once thread 0 is done
      if constexpr (SEG) i8g::named_sync(PLAN_BAR, 128);
    }
  } else {
    // ---- the consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const int rl = 64 * c + 16 * warp + g;    // rows rl, rl + 8 of a unit
    const bool single = nt == 1;              // JAX's single-step form
    if (c == 1) named_arrive(TURN_BAR, 256);  // consumer 0 issues first
    uint32_t it = 0;                          // stages taken so far
    int k = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const Unit w = unit_of(u, nq, H);
      const int qb = k & 1;
      i8g::mbar_wait(qfull0 + 8 * qb, (k >> 1) & 1);
      int qs0 = 0, qs1 = 0;
      if constexpr (SEG) {
        const int* qsm =
            reinterpret_cast<const int*>(sm + OFF_QSEG + qb * SEG_BYTES);
        qs0 = qsm[rl];
        qs1 = qsm[rl + 8];
      }
      const int row0 = w.s0 + rl;
      const uint64_t dq = i8g::sw128_desc(base + OFF_Q + qb * TILE_BYTES +
                                          c * (TILE_BYTES / 2));
      float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
      float cc[2], ic[2], cp[2], ip[2];
      float acc[32], sc[64], o[32];
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;

      // S = Q·Kᵀ of the tile in stage s, issued in turn with the other
      // consumer; with pv, also P·V of the tile in stage sp. Returns
      // once S is done (P·V may still run).
      auto scores = [&](int s, bool pv, int sp) {
        bf16w::fence_acc<64>(sc);
        bf16w::fence_acc<32>(o);
        bf16w::fence_words<32>(p);
        i8g::named_sync(TURN_BAR + c, 256);
        i8g::wgmma_fence();
        const uint64_t dk = i8g::sw128_desc(base + OFF_K + s * TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<128, 0>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
        i8g::wgmma_commit();
        if (pv) issue_pv(o, p, base + OFF_V + sp * TILE_BYTES);
        i8g::wgmma_commit();
        named_arrive(TURN_BAR + 1 - c, 256);
        i8g::wgmma_wait<1>();
        bf16w::fence_acc<64>(sc);
      };
      auto step = [&](int s, bool last) {
        if (last && lane == 0) i8g::mbar_arrive(qempty0 + 8 * qb);
        const int2 hd = hdr[s];
        softmax_step<SEG, CAUSAL>(
            sc, reinterpret_cast<const int*>(sm + OFF_KSEG + s * SEG_BYTES),
            qs0, qs1, row0 - hd.x * KT - 2 * q4, scale, mask_value, single,
            m, l, cc, ic);
      };

      // the first tile
      int s = it % STAGES;
      i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      bool last = hdr[s].y;
      scores(s, false, 0);
      step(s, last);
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      int sp = s;
      cp[0] = cc[0], cp[1] = cc[1], ip[0] = ic[0], ip[1] = ic[1];
      ++it;
      // the others: this tile's scores beside the previous tile's P·V
      while (!last) {
        s = it % STAGES;
        i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        last = hdr[s].y;
        scores(s, true, sp);
        step(s, last);
        i8g::wgmma_wait<0>();
        bf16w::fence_acc<32>(o);
        bf16w::fence_words<32>(p);
        fold(acc, o, cp, ip, single);
        if (lane == 0) i8g::mbar_arrive(empty0 + 8 * sp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        sp = s;
        cp[0] = cc[0], cp[1] = cc[1], ip[0] = ic[0], ip[1] = ic[1];
        ++it;
      }
      // the last tile's P·V
      bf16w::fence_acc<32>(o);
      bf16w::fence_words<32>(p);
      i8g::wgmma_fence();
      issue_pv(o, p, base + OFF_V + sp * TILE_BYTES);
      i8g::wgmma_commit();
      i8g::wgmma_wait<0>();
      bf16w::fence_acc<32>(o);
      bf16w::fence_words<32>(p);
      fold(acc, o, cp, ip, single);
      if (lane == 0) i8g::mbar_arrive(empty0 + 8 * sp);

      // out: each row's 64 values in 16-byte stores after a quad transpose
      __nv_bfloat16* ob = out + (((size_t)w.b * S + row0) * H + w.h) * HD;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int blk = 0; blk < 2; ++blk) {
          uint32_t wd[4];
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) {
            const int i = 4 * blk + gg;
            wd[gg] = pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
          }
          const uint4 v = i8g::gather_groups(wd);
          *reinterpret_cast<uint4*>(ob + (size_t)hh * 8 * H * HD +
                                    8 * (4 * blk + q4)) = v;
        }
      // the residuals: rows row0 and row0 + 8, once a quad
      if (lres && q4 == 0) {
        const size_t ro = ((size_t)w.b * H + w.h) * S + row0;
        lres[ro] = l[0];
        lres[ro + 8] = l[1];
        mres[ro] = m[0];
        mres[ro + 8] = m[1];
      }
    }
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
          const int* __restrict__ kvseg, float* __restrict__ out,
          float* __restrict__ lres, float* __restrict__ mres, int S,
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
  if (lres && tid < QT) {
    const size_t o = ((size_t)b * H + h) * S + s0 + tid;
    lres[o] = rl[tid];
    mres[o] = rm[tid];
  }
}


// The card's SM count, read once per device (never on a capture path
// after the first call)
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

template <bool SEG, bool CAUSAL>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* qseg, const int* kvseg, void* out,
                        float* lres, float* mres, int B, int S, int H,
                        int Skv, float scale, float mask_value,
                        cudaStream_t st) {
  const long long units = (long long)B * H * (S / TQ);
  const int sms = sm_count();
  if (units > 0x7fffffff || (long long)B * S > 0x7fffffff ||
      (long long)B * Skv > 0x7fffffff || sms <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mq, q, B * S, H * HD * 2, TQ)) != cudaSuccess ||
      (e = i8g::tensor_map(&mk, k, B * Skv, H * HD * 2, KT)) != cudaSuccess ||
      (e = i8g::tensor_map(&mv, v, B * Skv, H * HD * 2, KT)) != cudaSuccess)
    return e;
  if ((e = i8g::allow_smem<flash_bf16<SEG, CAUSAL>>(BF16_SMEM)) !=
      cudaSuccess)
    return e;
  const int grid = (int)(units < sms ? units : sms);
  flash_bf16<SEG, CAUSAL><<<grid, TC_THREADS, BF16_SMEM, st>>>(
      mq, mk, mv, qseg, kvseg, static_cast<__nv_bfloat16*>(out), lres, mres,
      S, H, Skv, (int)units, scale, mask_value);
  return cudaGetLastError();
}

}  // namespace

// C entry: q [B, S, H, D], k/v [B, Skv, H, D], out [B, S, H, D], all of one
// type (is_f32: 0 bf16, 1 f32), segment ids int32 [B, S] and [B, Skv] (both
// or neither null), contiguous, 16-byte aligned; l and m (both or neither
// null) the residuals, f32 [B, H, S]. Returns a cudaError_t (0 =
// launched). Supported: D == 64, S and Skv positive multiples of 128,
// Skv <= 65,536, grid limits on H and B (<= 65,535).
extern "C" int flash_attention_launch_res(const void* q, const void* k,
                                          const void* v, const void* qseg,
                                          const void* kvseg, void* out,
                                          void* l, void* m, int B, int S,
                                          int H, int Skv, int D, int causal,
                                          int is_f32, float scale,
                                          float mask_value, void* stream) {
  if (D != HD || B <= 0 || S <= 0 || H <= 0 || Skv <= 0 || S % KT ||
      Skv % KT || Skv > MAX_SKV || B > 65535 || H > 65535 ||
      (qseg == nullptr) != (kvseg == nullptr) ||
      (l == nullptr) != (m == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
  float* lr = static_cast<float*>(l);
  float* mr = static_cast<float*>(m);
  const int nt = Skv / KT;
  if (!is_f32) {
    if (qs)
      return causal ? launch_bf16<true, true>(q, k, v, qs, ks, out, lr, mr,
                                              B, S, H, Skv, scale,
                                              mask_value, st)
                    : launch_bf16<true, false>(q, k, v, qs, ks, out, lr, mr,
                                               B, S, H, Skv, scale,
                                               mask_value, st);
    return causal ? launch_bf16<false, true>(q, k, v, qs, ks, out, lr, mr, B,
                                             S, H, Skv, scale, mask_value,
                                             st)
                  : launch_bf16<false, false>(q, k, v, qs, ks, out, lr, mr,
                                              B, S, H, Skv, scale,
                                              mask_value, st);
  }
  const size_t smem = f32_smem_bytes(nt);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_f32<<<dim3(S / QT, H, B), THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qs, ks, static_cast<float*>(out), lr, mr,
      S, H, Skv, causal, scale, mask_value);
  return cudaGetLastError();
}

// The same without residuals (the serving path's entry).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* qseg,
                                      const void* kvseg, void* out, int B,
                                      int S, int H, int Skv, int D,
                                      int causal, int is_f32, float scale,
                                      float mask_value, void* stream) {
  return flash_attention_launch_res(q, k, v, qseg, kvseg, out, nullptr,
                                    nullptr, B, S, H, Skv, D, causal, is_f32,
                                    scale, mask_value, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
