// Flash attention's backward over segment ids (K11-bwd) for Hopper
// (sm_90a): dK, dV and dQ of softmax(Q·Kᵀ·scale, keys of the query's
// segment, causal)·V from q, k, v, the forward's residuals l and m
// (csrc/flash_attention.cu, flash_attention_launch_res), dO and
// di = Σ_d o·dO, in JAX's numerics: per (query, key) pair the forward's
// f32 score s (s·scale, + mask_value where the key is invisible), p =
// exp(s − m)·(1/l), dp = dO·vᵀ in f32, ds = (dp − di)·p, then ds·scale;
// dV += p (in dO's type)ᵀ·dO, dK += ds (in dO's type)ᵀ·q, dQ += ds (in k's
// type)·k, each summed in f32 and written in the input's type.
//
// Replaces the TPU kernels jax/experimental/pallas/ops/tpu/
// flash_attention.py::_flash_attention_dkv_kernel (pallas_call in
// _flash_attention_bwd_dkv) and _flash_attention_dq_kernel (pallas_call in
// _flash_attention_bwd_dq), which the custom_vjp of flash_attention runs
// under jax.grad of misinfo_tpu/ops/attention.py's use_pallas="flash". The
// plain PyTorch versions are flash_dkv_plain and flash_dq_plain in
// misinfo_tpu_torch/ops/flash_attention.py.
//
// What bounds it on this card: at RoBERTa b32/S512 (H = 12, D = 64, bf16)
// the function is five products of 2·S²·D per (row, head), s, dp, dV, dK
// and dQ: 64.4 GFLOP, 0.065 ms on the bf16 tensor cores (989 TFLOP/s); it
// reads q, k, v, o and dO and writes dq, dk and dv, 203 MB with l and m,
// 0.061 ms at 3.35 TB/s. Split as JAX splits it, the two kernels recompute
// s and dp each (seven products, 0.091 ms), and each walks every (query,
// key) pair once more on the CUDA cores: the mask, an expf and five more
// operations a pair, two walks of 100.7 M pairs, ~0.1 ms at 16 expf a
// clock an SM. This first design is bound there and by mma.sync's share of
// the tensor-core rate; it takes the work in turn, not overlapped.
//
// Pairs: a block walks the (query tile, key tile) pairs of 128 that JAX
// walks, causal JAX's own skip (key tile ≤ query tile), and with segment
// ids leaves out a pair whose segment ranges cannot meet where every row
// of the query tile sees its own position (q_seg[r] == kv_seg[r]): then
// every p of the pair is exp(s + mask_value − m) = 0 exactly, so leaving
// it out changes nothing. A query tile with a row that sees no key (the
// padded form's all-padding rows, where p is uniform and nonzero over
// every key) walks every tile, as JAX does. ops/flash_attention.py::
// walked_pairs mirrors the rule.
//
// No atomics: one block owns each output tile and sums its terms in one
// fixed order, so a result repeats bit for bit from run to run.
//
// bf16: mma.sync.m16n8k16 bf16 products with f32 sums, eight warps a
// block; operands staged in shared memory with rows of 72 bf16 (144 B: the
// fragment loads read no bank twice), the products' f32 results turned
// into the next product's A fragments in registers (p and ds rounded to
// bf16 there).
//   * dK/dV: one block per (128-key tile, head, batch row), each warp 16
//     keys; K and V stay in registers as A fragments. Per walked query
//     tile, in halves of 64 queries: Q, dO, m, 1/l, di staged; sᵀ = K·Qᵀ
//     and dpᵀ = V·dOᵀ (32 products each a warp), pᵀ and dsᵀ elementwise,
//     then dV += pᵀ·dO and dK += dsᵀ·Q into register accumulators.
//   * dQ: one block per (128-query tile, head, batch row), each warp 16
//     queries; Q and dO stay in registers as A fragments. Per walked key
//     tile, in halves of 64 keys: K, V staged; s = Q·Kᵀ, dp = dO·Vᵀ, ds,
//     then dQ += ds·K.
// f32 (parity mode only) stays on the CUDA cores, never in TF32: blocks of
// 32 keys (dK/dV) or 32 queries (dQ), 256 threads, the other side in
// sub-tiles of 32 through shared memory; each thread takes four pairs'
// scores as sequential FMA chains, then eight output elements' sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // the head width (every tower)
constexpr int T = 128;          // JAX's blocks: the pairs' tiles
constexpr int MAX_T = 512;      // tiles a side: S, Skv <= 65,536
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// ------------------------------------------------------ the walked pairs

struct TileSeg {
  int lo, hi, anchored;
};

// Tile t's segment range (128 ids from ids, four a lane) and, where own is
// not null (a query tile: own = the key ids), whether every row r < Skv
// sees its own position. Called by a whole warp; every lane gets it.
__device__ TileSeg tile_seg(const int* ids, const int* own, int Skv, int t) {
  const int lane = threadIdx.x & 31;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1, all = 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t * T + lane * 4 + i;
    const int v = ids[r];
    lo = min(lo, v);
    hi = max(hi, v);
    if (own && !(r < Skv && own[r] == v)) all = 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return {lo, hi, __all_sync(0xffffffffu, all)};
}

// Into list the partner tiles walked with the block's own tile (a query
// tile if own_q, else a key tile), in order; returns their count. Every
// thread calls it. keep: MAX_T bytes, list: MAX_T ints, sh: 4 ints.
__device__ int plan_pairs(const int* qseg, const int* kvseg, int b, int S,
                          int Skv, int own, bool own_q, int causal,
                          unsigned char* keep, int* list, int* sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = S / T, nt = Skv / T;
  const int first = own_q || !causal ? 0 : own;
  const int last = own_q ? (causal ? min(nt - 1, own) : nt - 1) : nq - 1;
  if (!qseg) {
    for (int j = first + tid; j <= last; j += THREADS) list[j - first] = j;
    __syncthreads();
    return last - first + 1;
  }
  const int* qs = qseg + (size_t)b * S;
  const int* ks = kvseg + (size_t)b * Skv;
  if (warp == 0) {
    const TileSeg t =
        own_q ? tile_seg(qs, ks, Skv, own) : tile_seg(ks, nullptr, Skv, own);
    if (lane == 0) {
      sh[0] = t.lo;
      sh[1] = t.hi;
      sh[2] = t.anchored;
    }
  }
  __syncthreads();
  for (int j = first + warp; j <= last; j += WARPS) {
    bool k;
    if (own_q) {
      const TileSeg kt = tile_seg(ks, nullptr, Skv, j);
      k = !sh[2] || !(kt.hi < sh[0] || kt.lo > sh[1]);
    } else {
      const TileSeg qt = tile_seg(qs, ks, Skv, j);
      k = !qt.anchored || !(sh[1] < qt.lo || sh[0] > qt.hi);
    }
    if (lane == 0) keep[j] = k;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int j = first; j <= last; ++j)
      if (keep[j]) list[n++] = j;
    sh[3] = n;
  }
  __syncthreads();
  return sh[3];
}

// p and ds of one pair from its raw score x = q·k and dp = dO·v: JAX's
// order, each step one IEEE rounding
__device__ __forceinline__ void p_ds(float x, float dp, bool seen, float m,
                                     float inv_l, float di, float scale,
                                     float mask_value, float& p, float& ds) {
  if (scale != 1.f) x = __fmul_rn(x, scale);
  if (!seen) x = __fadd_rn(x, mask_value);
  p = __fmul_rn(expf(__fsub_rn(x, m)), inv_l);
  ds = __fmul_rn(__fsub_rn(dp, di), p);
  if (scale != 1.f) ds = __fmul_rn(ds, scale);
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int LDB = HD + 8;     // bf16 row stride in shared memory
constexpr int HALF = 64;        // the other side's rows per step

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
// two adjacent bf16 of a shared-memory row
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 of one column, rows r and r + 1
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + LDB);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// rows [r0, r0 + n) of one head of x [rows, H, 64] into s [n][LDB]
__device__ __forceinline__ void stage(__nv_bfloat16* s,
                                      const __nv_bfloat16* x, size_t r0,
                                      int n, int H, int h) {
  for (int i = threadIdx.x; i < n * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(s + r * LDB + c * 8) =
        *reinterpret_cast<const uint4*>(x + ((r0 + r) * H + h) * HD + c * 8);
  }
}

// A fragments (16 rows × 64 of a staged tile, rows r, r + 8 a lane)
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4],
                                        const __nv_bfloat16* s, int row) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* r0 = s + (row + g) * LDB + 16 * kk + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * LDB;
    a[kk][0] = ld2(r0);
    a[kk][1] = ld2(r1);
    a[kk][2] = ld2(r0 + 8);
    a[kk][3] = ld2(r1 + 8);
  }
}

// acc[n] (16 × 64 over n) += A (16 × 64, registers) · Xᵀ, X the staged
// [64][LDB] tile whose row 8n + g is output column 8n + g
__device__ __forceinline__ void mma_xt(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* x) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* xb = x + (8 * n + g) * LDB + 16 * kk + 2 * t4;
      mma_bf16(acc[n], a[kk], ld2(xb), ld2(xb + 8));
    }
}

// acc[n] (16 × 64 over n) += C (16 × 64 f32 fragments, rounded to bf16 as
// A fragments) · X, X the staged [64][LDB] tile (row = the summed index)
__device__ __forceinline__ void mma_cx(float (&acc)[8][4],
                                       const float (&c)[8][4],
                                       const __nv_bfloat16* x) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* xb = x + (16 * kk + 2 * t4) * LDB + 8 * n + g;
      mma_bf16(acc[n], a, ld_col2(xb), ld_col2(xb + 8 * LDB));
    }
  }
}

// out rows [r0 + 16w + g (+8)] of one head from 16 × 64 fragments
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[8][4],
                                           size_t row, int H, int h) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* o = out + ((row + g + 8 * r) * H + h) * HD + 8 * n +
                         2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
}

struct Smem {
  static constexpr int TILE = T * LDB;        // bf16 elements
  static constexpr int HALF_TILE = HALF * LDB;
  static constexpr size_t BF16_BYTES =
      (2 * TILE + 2 * HALF_TILE) * 2 + (4 * T + 4 * HALF + MAX_T + 4) * 4 +
      MAX_T;
};

// Grid (Skv / 128, H, B), THREADS threads, Smem::BF16_BYTES dynamic.
__global__ void __launch_bounds__(THREADS, 1)
dkv_bf16(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, const int* __restrict__ qseg,
         const int* __restrict__ kvseg, const float* __restrict__ l,
         const float* __restrict__ m, const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv, int S, int H, int Skv, int causal,
         float scale, float mask_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [T][LDB]
  __nv_bfloat16* vs = ks + Smem::TILE;                         // [T][LDB]
  __nv_bfloat16* qs = vs + Smem::TILE;                      // [HALF][LDB]
  __nv_bfloat16* dos = qs + Smem::HALF_TILE;                // [HALF][LDB]
  float* ms = reinterpret_cast<float*>(dos + Smem::HALF_TILE);  // [HALF]
  float* ils = ms + HALF;                                   // 1/l [HALF]
  float* dis = ils + HALF;                                  // [HALF]
  int* qsg = reinterpret_cast<int*>(dis + HALF);            // [HALF]
  int* ksg = qsg + HALF;                                    // [T]
  int* list = ksg + T;                                      // [MAX_T]
  int* sh = list + MAX_T;                                   // [4]
  unsigned char* keep = reinterpret_cast<unsigned char*>(sh + 4);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * T;
  stage(ks, k, (size_t)b * Skv + k0, T, H, h);
  stage(vs, v, (size_t)b * Skv + k0, T, H, h);
  if (qseg && tid < T) ksg[tid] = kvseg[(size_t)b * Skv + k0 + tid];
  const int n = plan_pairs(qseg, kvseg, b, S, Skv, kt, false, causal, keep,
                           list, sh);
  uint32_t ka[4][4], va[4][4];
  a_frags(ka, ks, 16 * warp);
  a_frags(va, vs, 16 * warp);
  const int kr = 16 * warp + g;             // this lane's keys kr, kr + 8
  const int kseg[2] = {qseg ? ksg[kr] : 0, qseg ? ksg[kr + 8] : 0};
  float dka[8][4] = {}, dva[8][4] = {};
  for (int i = 0; i < n; ++i) {
    for (int hf = 0; hf < T / HALF; ++hf) {
      const int q0 = list[i] * T + hf * HALF;
      __syncthreads();                      // the last step's reads done
      stage(qs, q, (size_t)b * S + q0, HALF, H, h);
      stage(dos, dout, (size_t)b * S + q0, HALF, H, h);
      if (tid < HALF) {
        const size_t r = ((size_t)b * H + h) * S + q0 + tid;
        ms[tid] = m[r];
        ils[tid] = __fdiv_rn(1.f, l[r]);
        dis[tid] = di[r];
        if (qseg) qsg[tid] = qseg[(size_t)b * S + q0 + tid];
      }
      __syncthreads();
      float st[8][4] = {}, dpt[8][4] = {};
      mma_xt(st, ka, qs);                   // sᵀ = K·Qᵀ
      mma_xt(dpt, va, dos);                 // dpᵀ = V·dOᵀ
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
          bool seen = true;
          if (qseg) seen = kseg[r] == qsg[c];
          if (causal) seen = seen && k0 + kr + 8 * r <= q0 + c;
          p_ds(st[j][e], dpt[j][e], seen, ms[c], ils[c], dis[c], scale,
               mask_value, st[j][e], dpt[j][e]);
        }
      mma_cx(dva, st, dos);                 // dV += pᵀ·dO
      mma_cx(dka, dpt, qs);                 // dK += dsᵀ·Q
    }
  }
  store_rows(dk, dka, (size_t)b * Skv + k0 + 16 * warp, H, h);
  store_rows(dv, dva, (size_t)b * Skv + k0 + 16 * warp, H, h);
}

// Grid (S / 128, H, B), THREADS threads, Smem::BF16_BYTES dynamic.
__global__ void __launch_bounds__(THREADS, 1)
dq_bf16(const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const int* __restrict__ qseg,
        const int* __restrict__ kvseg, const float* __restrict__ l,
        const float* __restrict__ m, const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int S,
        int H, int Skv, int causal, float scale, float mask_value) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [T][LDB]
  __nv_bfloat16* dos = qs + Smem::TILE;                        // [T][LDB]
  __nv_bfloat16* ks = dos + Smem::TILE;                     // [HALF][LDB]
  __nv_bfloat16* vs = ks + Smem::HALF_TILE;                 // [HALF][LDB]
  int* ksg = reinterpret_cast<int*>(vs + Smem::HALF_TILE);  // [HALF]
  int* list = ksg + HALF;                                   // [MAX_T]
  int* sh = list + MAX_T;                                   // [4]
  unsigned char* keep = reinterpret_cast<unsigned char*>(sh + 4);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * T;
  stage(qs, q, (size_t)b * S + q0, T, H, h);
  stage(dos, dout, (size_t)b * S + q0, T, H, h);
  const int n = plan_pairs(qseg, kvseg, b, S, Skv, qt, true, causal, keep,
                           list, sh);
  uint32_t qa[4][4], da[4][4];
  a_frags(qa, qs, 16 * warp);
  a_frags(da, dos, 16 * warp);
  const int qr = q0 + 16 * warp + g;        // this lane's rows qr, qr + 8
  float mr[2], ilr[2], dir[2];
  int qsr[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t o = ((size_t)b * H + h) * S + qr + 8 * r;
    mr[r] = m[o];
    ilr[r] = __fdiv_rn(1.f, l[o]);
    dir[r] = di[o];
    if (qseg) qsr[r] = qseg[(size_t)b * S + qr + 8 * r];
  }
  float dqa[8][4] = {};
  for (int i = 0; i < n; ++i) {
    for (int hf = 0; hf < T / HALF; ++hf) {
      const int c0 = list[i] * T + hf * HALF;
      __syncthreads();
      stage(ks, k, (size_t)b * Skv + c0, HALF, H, h);
      stage(vs, v, (size_t)b * Skv + c0, HALF, H, h);
      if (qseg && tid < HALF) ksg[tid] = kvseg[(size_t)b * Skv + c0 + tid];
      __syncthreads();
      float s[8][4] = {}, dp[8][4] = {};
      mma_xt(s, qa, ks);                    // s = Q·Kᵀ
      mma_xt(dp, da, vs);                   // dp = dO·Vᵀ
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
          bool seen = true;
          if (qseg) seen = qsr[r] == ksg[c];
          if (causal) seen = seen && c0 + c <= qr + 8 * r;
          p_ds(s[j][e], dp[j][e], seen, mr[r], ilr[r], dir[r], scale,
               mask_value, s[j][e], dp[j][e]);
        }
      mma_cx(dqa, dp, ks);                  // dQ += ds·K
    }
  }
  store_rows(dq, dqa, (size_t)b * S + q0 + 16 * warp, H, h);
}

// ------------------------------------------- f32: the CUDA cores (parity)

constexpr int FT = 32;          // rows of a block and of a sub-tile
constexpr int LF = HD + 1;      // padded rows: no bank conflicts
constexpr int LP = FT + 1;
constexpr size_t F32_BYTES =
    ((size_t)4 * FT * LF + 2 * FT * LP + 5 * FT + MAX_T + 4) * 4 + MAX_T;

// rows [r0, r0 + FT) of one head of x [rows, H, 64] into s [FT][LF]
__device__ __forceinline__ void stage_f32(float* s, const float* x,
                                          size_t r0, int H, int h) {
  for (int i = threadIdx.x; i < FT * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    s[r * LF + d] = x[((r0 + r) * H + h) * HD + d];
  }
}

// Σ_d a[d]·b[d] as one sequential FMA chain
__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Grid (Skv / 32, H, B), THREADS threads, F32_BYTES dynamic.
__global__ void __launch_bounds__(THREADS)
dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int* __restrict__ qseg,
        const int* __restrict__ kvseg, const float* __restrict__ l,
        const float* __restrict__ m, const float* __restrict__ dout,
        const float* __restrict__ di, float* __restrict__ dk,
        float* __restrict__ dv, int S, int H, int Skv, int causal,
        float scale, float mask_value) {
  extern __shared__ __align__(16) float fsm[];
  float* kf = fsm;                      // [FT][LF]
  float* vf = kf + FT * LF;
  float* qf = vf + FT * LF;
  float* df = qf + FT * LF;             // dO
  float* P = df + FT * LF;              // [key][query] [FT][LP]
  float* DS = P + FT * LP;
  float* ms = DS + FT * LP;             // [FT]
  float* ils = ms + FT;
  float* dis = ils + FT;
  int* qsg = reinterpret_cast<int*>(dis + FT);
  int* ksg = qsg + FT;
  int* list = ksg + FT;                 // [MAX_T]
  int* sh = list + MAX_T;
  unsigned char* keep = reinterpret_cast<unsigned char*>(sh + 4);

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * FT;
  const int tid = threadIdx.x, kr = tid >> 3, c = tid & 7;
  stage_f32(kf, k, (size_t)b * Skv + k0, H, h);
  stage_f32(vf, v, (size_t)b * Skv + k0, H, h);
  if (qseg && tid < FT) ksg[tid] = kvseg[(size_t)b * Skv + k0 + tid];
  const int n = plan_pairs(qseg, kvseg, b, S, Skv, k0 / T, false, causal,
                           keep, list, sh);
  float dka[8] = {}, dva[8] = {};
  for (int i = 0; i < n; ++i) {
    for (int sub = 0; sub < T / FT; ++sub) {
      const int q0 = list[i] * T + sub * FT;
      __syncthreads();
      stage_f32(qf, q, (size_t)b * S + q0, H, h);
      stage_f32(df, dout, (size_t)b * S + q0, H, h);
      if (tid < FT) {
        const size_t r = ((size_t)b * H + h) * S + q0 + tid;
        ms[tid] = m[r];
        ils[tid] = __fdiv_rn(1.f, l[r]);
        dis[tid] = di[r];
        if (qseg) qsg[tid] = qseg[(size_t)b * S + q0 + tid];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = c + 8 * j;
        bool seen = true;
        if (qseg) seen = ksg[kr] == qsg[qc];
        if (causal) seen = seen && k0 + kr <= q0 + qc;
        float p, ds;
        p_ds(dot64(qf + qc * LF, kf + kr * LF),
             dot64(df + qc * LF, vf + kr * LF), seen, ms[qc], ils[qc],
             dis[qc], scale, mask_value, p, ds);
        P[kr * LP + qc] = p;
        DS[kr * LP + qc] = ds;
      }
      __syncthreads();
      for (int qc = 0; qc < FT; ++qc) {
        const float p = P[kr * LP + qc], ds = DS[kr * LP + qc];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dva[j] = fmaf(p, df[qc * LF + c + 8 * j], dva[j]);
          dka[j] = fmaf(ds, qf[qc * LF + c + 8 * j], dka[j]);
        }
      }
    }
  }
  const size_t o = (((size_t)b * Skv + k0 + kr) * H + h) * HD + c;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk[o + 8 * j] = dka[j];
    dv[o + 8 * j] = dva[j];
  }
}

// Grid (S / 32, H, B), THREADS threads, F32_BYTES dynamic.
__global__ void __launch_bounds__(THREADS)
dq_f32(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const int* __restrict__ qseg,
       const int* __restrict__ kvseg, const float* __restrict__ l,
       const float* __restrict__ m, const float* __restrict__ dout,
       const float* __restrict__ di, float* __restrict__ dq, int S, int H,
       int Skv, int causal, float scale, float mask_value) {
  extern __shared__ __align__(16) float fsm[];
  float* qf = fsm;                      // [FT][LF]
  float* df = qf + FT * LF;             // dO
  float* kf = df + FT * LF;
  float* vf = kf + FT * LF;
  float* DS = vf + FT * LF;             // [query][key] [FT][LP]
  float* ms = DS + FT * LP;             // [FT]
  float* ils = ms + FT;
  float* dis = ils + FT;
  int* qsg = reinterpret_cast<int*>(dis + FT);
  int* ksg = qsg + FT;
  int* list = ksg + FT;                 // [MAX_T]
  int* sh = list + MAX_T;
  unsigned char* keep = reinterpret_cast<unsigned char*>(sh + 4);

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * FT;
  const int tid = threadIdx.x, qr = tid >> 3, c = tid & 7;
  stage_f32(qf, q, (size_t)b * S + q0, H, h);
  stage_f32(df, dout, (size_t)b * S + q0, H, h);
  if (tid < FT) {
    const size_t r = ((size_t)b * H + h) * S + q0 + tid;
    ms[tid] = m[r];
    ils[tid] = __fdiv_rn(1.f, l[r]);
    dis[tid] = di[r];
    if (qseg) qsg[tid] = qseg[(size_t)b * S + q0 + tid];
  }
  const int n = plan_pairs(qseg, kvseg, b, S, Skv, q0 / T, true, causal,
                           keep, list, sh);
  float dqa[8] = {};
  for (int i = 0; i < n; ++i) {
    for (int sub = 0; sub < T / FT; ++sub) {
      const int c0 = list[i] * T + sub * FT;
      __syncthreads();
      stage_f32(kf, k, (size_t)b * Skv + c0, H, h);
      stage_f32(vf, v, (size_t)b * Skv + c0, H, h);
      if (qseg && tid < FT) ksg[tid] = kvseg[(size_t)b * Skv + c0 + tid];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = c + 8 * j;
        bool seen = true;
        if (qseg) seen = qsg[qr] == ksg[kc];
        if (causal) seen = seen && c0 + kc <= q0 + qr;
        float p, ds;
        p_ds(dot64(qf + qr * LF, kf + kc * LF),
             dot64(df + qr * LF, vf + kc * LF), seen, ms[qr], ils[qr],
             dis[qr], scale, mask_value, p, ds);
        DS[qr * LP + kc] = ds;
      }
      __syncthreads();
      for (int kc = 0; kc < FT; ++kc) {
        const float ds = DS[qr * LP + kc];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dqa[j] = fmaf(ds, kf[kc * LF + c + 8 * j], dqa[j]);
      }
    }
  }
  const size_t o = (((size_t)b * S + q0 + qr) * H + h) * HD + c;
#pragma unroll
  for (int j = 0; j < 8; ++j) dq[o + 8 * j] = dqa[j];
}

template <typename K>
cudaError_t allow(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int B, int S, int H, int Skv, int D, const void* qseg,
               const void* kvseg) {
  return D != HD || B <= 0 || S <= 0 || H <= 0 || Skv <= 0 || S % T ||
         Skv % T || S > MAX_T * T || Skv > MAX_T * T || B > 65535 ||
         H > 65535 || (long long)B * S * H > 0x7fffffffLL ||
         (long long)B * Skv * H > 0x7fffffffLL ||
         (qseg == nullptr) != (kvseg == nullptr);
}

}  // namespace

// C entries: q, dO [B, S, H, D], k/v [B, Skv, H, D] of one type (is_f32: 0
// bf16, 1 f32), segment ids int32 [B, S] and [B, Skv] (both or neither
// null), l, m and di f32 [B, H, S]; the gradients in the inputs' type and
// shapes. Contiguous, 16-byte aligned. Returns a cudaError_t (0 =
// launched). Supported: D == 64, S and Skv positive multiples of 128 up to
// 65,536, grid limits on H and B (<= 65,535).
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* qseg, const void* kvseg,
                                const void* l, const void* m,
                                const void* dout, const void* di, void* dk,
                                void* dv, int B, int S, int H, int Skv, int D,
                                int causal, int is_f32, float scale,
                                float mask_value, void* stream) {
  if (bad_shape(B, S, H, Skv, D, qseg, kvseg)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* dif = static_cast<const float*>(di);
  cudaError_t e;
  if (!is_f32) {
    if ((e = allow(dkv_bf16, Smem::BF16_BYTES)) != cudaSuccess) return e;
    dkv_bf16<<<dim3(Skv / T, H, B), THREADS, Smem::BF16_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qs, ks, lf, mf,
        static_cast<const __nv_bfloat16*>(dout), dif,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
        H, Skv, causal, scale, mask_value);
    return cudaGetLastError();
  }
  if ((e = allow(dkv_f32, F32_BYTES)) != cudaSuccess) return e;
  dkv_f32<<<dim3(Skv / FT, H, B), THREADS, F32_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qs, ks, lf, mf,
      static_cast<const float*>(dout), dif, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, Skv, causal, scale, mask_value);
  return cudaGetLastError();
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* qseg, const void* kvseg,
                               const void* l, const void* m, const void* dout,
                               const void* di, void* dq, int B, int S, int H,
                               int Skv, int D, int causal, int is_f32,
                               float scale, float mask_value, void* stream) {
  if (bad_shape(B, S, H, Skv, D, qseg, kvseg)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  const float* dif = static_cast<const float*>(di);
  cudaError_t e;
  if (!is_f32) {
    if ((e = allow(dq_bf16, Smem::BF16_BYTES)) != cudaSuccess) return e;
    dq_bf16<<<dim3(S / T, H, B), THREADS, Smem::BF16_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qs, ks, lf, mf,
        static_cast<const __nv_bfloat16*>(dout), dif,
        static_cast<__nv_bfloat16*>(dq), S, H, Skv, causal, scale,
        mask_value);
    return cudaGetLastError();
  }
  if ((e = allow(dq_f32, F32_BYTES)) != cudaSuccess) return e;
  dq_f32<<<dim3(S / FT, H, B), THREADS, F32_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qs, ks, lf, mf,
      static_cast<const float*>(dout), dif, static_cast<float*>(dq), S, H,
      Skv, causal, scale, mask_value);
  return cudaGetLastError();
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
