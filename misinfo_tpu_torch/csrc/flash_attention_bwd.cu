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
// s and dp each (seven products), and each walks every walked (query, key)
// pair once more on the CUDA cores: the scale, the mask, an expf (eight
// instructions, one of them on the special-function unit), 1/l, di and
// the bf16 roundings, some 16-18 instructions a pair, ~0.05 ms a walk of
// the 87.7 M pairs of b32/S512's packed rows at one warp instruction a
// clock per scheduler. So each kernel has three floors of like size: the
// bytes' (0.038-0.046 ms), the tensor cores' (0.034-0.045 ms) and the CUDA
// cores' issue rate. A first design on mma.sync, taking the work in turn,
// ran at 10-12× the bytes bound. This one runs at ~3×: within a consumer
// warpgroup the elementwise pass waits on its half's first two products
// and the products of the next half wait on the pass, so a warpgroup
// spends about half its time in the pass and most of the rest waiting for
// the tensor cores to take its products; the two warpgroups' passes
// overlap each other more than the other's products. Timed by parts with
// k11_probe.py bwd_ablate and bwd_clocks (PERF.md). This design:
//
// bf16: one warp-specialised, persistent kernel a direction, one block of
// 384 threads an SM, walking work units of one 128-row own tile of one
// (batch row, head), the tiles of a (row, head) next to each other so that
// its partner tiles stay in L2 (K11's unit order).
//   * dK/dV: the unit is a 128-key tile, its own tiles K and V; its
//     partners are the query tiles walked with it, Q and dO with their
//     rows' m, 1/l, di and segment ids. dQ: the unit is a 128-query tile,
//     its own tiles Q and dO with its rows' side data; its partners are the
//     key tiles, K and V with their segment ids.
//   * The producer warpgroup (40 registers) plans each unit's partner
//     tiles with ballots and prefix popcounts (walked_pairs' rule, K11's
//     planner), then one thread copies the tiles by TMA: q, k, v and dO
//     are viewed as [rows, H·128 bytes] tensor maps, a box of 128 rows ×
//     128 bytes at column 128·h in the 128-byte swizzle. The own tiles go
//     into one of two buffers once per unit, ahead of the unit; each
//     partner tile pair into a ring of STAGES stages, each with a full and
//     an empty mbarrier. Every producer thread reads one row's side data
//     (m, l, di, the segment id) before it waits for the stage, writes it
//     there with 1/l taken once a row, and arrives on the stage's full
//     barrier. (Bulk copies of the side rows, with the planning moved to
//     three warps one unit ahead, timed 2-4% slower.)
//   * Two consumer warpgroups (232 registers) own 64 rows of the unit's
//     tile each, the own tiles resident A operands, and take each partner
//     tile in halves of 64 rows. Per half, dK/dV: sᵀ = K·Qᵀ and dpᵀ =
//     V·dOᵀ (wgmma.m64n64k16, both operands K-major in shared memory), pᵀ
//     and dsᵀ elementwise, then dV += pᵀ·dO and dK += dsᵀ·Q (pᵀ and dsᵀ
//     from registers: the first products' accumulators packed to bf16 in
//     place are the A operands; dO and Q read MN-major through the
//     transpose bit). dQ: s = Q·Kᵀ, dp = dO·Vᵀ, ds, then dQ += ds·K.
//     Sums stay in registers across the unit's partners.
//   * Overlap: a warpgroup issues a half's first two products together
//     with the last half's gradient products (two commit groups: the
//     unit's first half, which has no gradient products, is a separate
//     copy of the step, because ptxas serializes every wgmma of a step
//     whose commit groups depend on a branch), then takes the half's
//     elementwise pass while the gradient products run; the two
//     warpgroups take turns to issue (named barriers), and the ring keeps
//     the next tiles' copies in flight. A stage goes back to the producer
//     once both warpgroups' products on it are done.
//   * The grid is min(units, SMs), blocks striding over the units; the
//     gradients leave registers in 16-byte stores after a transpose inside
//     each quad of lanes.
//
// Pairs: a unit walks the (query tile, key tile) pairs of 128 that JAX
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
// f32 (parity mode only) stays on the CUDA cores, never in TF32: blocks of
// 32 keys (dK/dV) or 32 queries (dQ), 256 threads, the other side in
// sub-tiles of 32 through shared memory; each thread takes four pairs'
// scores as sequential FMA chains, then eight output elements' sums; the
// pairs planned by plan_pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_bf16.cuh"

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

constexpr int TC_THREADS = 384;           // producer + two consumer groups
constexpr int STAGES = 4;                 // partner tiles in the ring
constexpr int HALF = 64;                  // partner rows per product
constexpr int TILE_BYTES = T * HD * 2;    // a bf16 tile of 128 rows: 16 KB
constexpr int HALF_BYTES = HALF * HD * 2;
constexpr int SIDE_BYTES = 4 * T * 4;     // a tile's rows' m, 1/l, di, ids
constexpr int PLAN_BAR = 1;               // the producer's named barrier
constexpr int TURN_BAR = 2;               // + c: consumer c's turn to issue

// shared memory, from a 1024-byte aligned base
constexpr int OFF_OWN = 0;                          // [2][2 tiles]
constexpr int OFF_RING = OFF_OWN + 4 * TILE_BYTES;  // [STAGES][2 tiles]
constexpr int OFF_OWN_SIDE = OFF_RING + STAGES * 2 * TILE_BYTES;  // [2]
constexpr int OFF_SIDE = OFF_OWN_SIDE + 2 * SIDE_BYTES;     // [STAGES]
constexpr int OFF_HDR = OFF_SIDE + STAGES * SIDE_BYTES;     // [STAGES] int
constexpr int OFF_COUNT = OFF_HDR + STAGES * 4;             // [2] int
constexpr int OFF_BAR = OFF_COUNT + 16;  // full, empty [STAGES], ofull,
                                         // oempty [2]
constexpr int OFF_RED = OFF_BAR + (2 * STAGES + 4) * 8;     // [5] int4
constexpr int OFF_KEEP = OFF_RED + 5 * 16;                  // [MAX_T] u8
constexpr int OFF_LIST = OFF_KEEP + MAX_T;                  // [MAX_T] int
constexpr int BF16_SMEM = 1024 + OFF_LIST + MAX_T * 4;
static_assert(OFF_RED % 16 == 0 && OFF_BAR % 8 == 0, "aligned barriers");

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// work unit u: the own tile (a key tile for dK/dV, a query tile for dQ)
// of (batch row, head) bh = u / n, the n tiles of a bh next to each other,
// their order turned by bh (K11's unit_of: a block walks units G apart,
// and G a multiple of n would hand it the same tile every time)
struct Unit {
  int b, h, t;
};
__device__ __forceinline__ Unit unit_of(int u, int n, int H) {
  const int bh = u / n;
  return {bh / H, bh % H, (u - bh * n + bh) % n};
}

// a warp's min, max and all-of over its lanes
__device__ __forceinline__ void warp_range(int& lo, int& hi, bool& all) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  all = __all_sync(0xffffffffu, all);
}

// p and ds of a consumer thread's 64 pairs of one half: the products' f32
// accumulators s (the raw scores) and dp in the wgmma fragment (element
// 4i + e: own row rl + 8·(e >> 1), partner column 8i + 2q + (e & 1) of the
// half) become p (in s) and ds (in dp). The own rows' (or, for dK/dV, the
// partner columns') m, 1/l and di, the own rows' segment ids rseg and the
// columns' cseg; lim is the causal limit: a pair is seen where
// 8·(e >> 1) − 8i − (e & 1) <= lim (dK/dV: key ≤ query) or 8i + (e & 1) −
// 8·(e >> 1) <= lim (dQ).
template <bool DKV, bool SEG, bool CAUSAL>
__device__ __forceinline__ void half_p_ds(
    float (&s)[32], float (&dp)[32], const float* cm, const float* cil,
    const float* cdi, const int* cseg, const float (&rm)[2],
    const float (&ril)[2], const float (&rdi)[2], const int (&rseg)[2],
    int lim, float scale, float mask_value) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float2 m2 = make_float2(0.f, 0.f), il2 = m2, di2 = m2;
    int2 sg = make_int2(0, 0);
    if constexpr (DKV) {
      m2 = *reinterpret_cast<const float2*>(cm + 8 * i);
      il2 = *reinterpret_cast<const float2*>(cil + 8 * i);
      di2 = *reinterpret_cast<const float2*>(cdi + 8 * i);
    }
    if constexpr (SEG) sg = *reinterpret_cast<const int2*>(cseg + 8 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, cc = e & 1;
      bool seen = true;
      if constexpr (SEG) seen = rseg[r] == (cc ? sg.y : sg.x);
      if constexpr (CAUSAL)
        seen = seen && (DKV ? 8 * r - 8 * i - cc : 8 * i + cc - 8 * r) <= lim;
      const float m = DKV ? (cc ? m2.y : m2.x) : rm[r];
      const float il = DKV ? (cc ? il2.y : il2.x) : ril[r];
      const float di = DKV ? (cc ? di2.y : di2.x) : rdi[r];
      p_ds(s[4 * i + e], dp[4 * i + e], seen, m, il, di, scale, mask_value,
           s[4 * i + e], dp[4 * i + e]);
    }
  }
}

// the gradient products of one half from its p / ds in bf16 (registers, A
// operands) and the half's partner tiles read MN-major: dK/dV: dV += pᵀ·dO
// (acc1) and dK += dsᵀ·Q (acc0); dQ: dQ += ds·K (acc0)
template <bool DKV>
__device__ __forceinline__ void issue_grads(float (&acc0)[32],
                                            float (&acc1)[32],
                                            const uint32_t (&pw)[16],
                                            const uint32_t (&dw)[16],
                                            uint32_t p0, uint32_t p1) {
  if constexpr (DKV) {
    const uint64_t b1 = bf16w::mn_desc(p1, TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk)
      bf16w::wgmma_bf16_rs64(acc1, pw + 4 * kk, b1 + 128 * kk, 1);
  }
  const uint64_t b0 = bf16w::mn_desc(p0, TILE_BYTES);
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk)
    bf16w::wgmma_bf16_rs64(acc0, dw + 4 * kk, b0 + 128 * kk, 1);
}

// rows row0 + 16w + g (+ 8) of one head of out [rows, H, 64] from a
// consumer's 64 × 64 accumulator, 16 bytes a lane after a quad transpose
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          const float (&acc)[32], size_t row,
                                          int H, int h) {
  const int q4 = threadIdx.x & 3;
  __nv_bfloat16* ob = out + (row * H + h) * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      uint32_t wd[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const int i = 4 * blk + gg;
        wd[gg] = i8g::pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
      const uint4 v = i8g::gather_groups(wd);
      *reinterpret_cast<uint4*>(ob + (size_t)hh * 8 * H * HD +
                                8 * (4 * blk + q4)) = v;
    }
}

// One kernel for both directions. DKV: the unit is a 128-key tile, its own
// tiles K and V (mo0, mo1), its partners the query tiles walked with it,
// Q and dO (mp0, mp1) with their rows' m, 1/l, di and segment ids; out0 =
// dK, out1 = dV. !DKV: the unit is a 128-query tile, its own tiles Q and
// dO with its rows' side data, its partners the key tiles, K and V with
// their segment ids; out0 = dQ. Tensor maps over [rows, H·128 bytes] with
// boxes of 128 rows × 128 bytes in the 128-byte swizzle. Grid min(units,
// SMs), TC_THREADS threads, BF16_SMEM bytes of dynamic shared memory;
// units = B·H·(own rows)/128.
template <bool DKV, bool SEG, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_bf16(const __grid_constant__ CUtensorMap mo0,
         const __grid_constant__ CUtensorMap mo1,
         const __grid_constant__ CUtensorMap mp0,
         const __grid_constant__ CUtensorMap mp1,
         const int* __restrict__ qseg, const int* __restrict__ kvseg,
         const float* __restrict__ l, const float* __restrict__ m,
         const float* __restrict__ di, __nv_bfloat16* __restrict__ out0,
         __nv_bfloat16* __restrict__ out1, int S, int H, int Skv, int units,
         float scale, float mask_value) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = i8g::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full0 = base + OFF_BAR, empty0 = full0 + 8 * STAGES;
  const uint32_t ofull0 = empty0 + 8 * STAGES, oempty0 = ofull0 + 16;
  int* hdr = reinterpret_cast<int*>(sm + OFF_HDR);
  int* count = reinterpret_cast<int*>(sm + OFF_COUNT);
  const int own_rows = DKV ? Skv : S, partner_rows = DKV ? S : Skv;
  const int n_own = own_rows / T;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      i8g::mbar_init(full0 + 8 * s, 129);   // the copy's and the side rows'
      i8g::mbar_init(empty0 + 8 * s, 8);    // the consumers' eight warps
    }
    for (int i = 0; i < 2; ++i) {
      i8g::mbar_init(ofull0 + 8 * i, 129);
      i8g::mbar_init(oempty0 + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer: plan each unit's partner tiles, copy them in
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    int4* red = reinterpret_cast<int4*>(sm + OFF_RED);
    unsigned char* keep = sm + OFF_KEEP;
    int* list = reinterpret_cast<int*>(sm + OFF_LIST);
    uint32_t it = 0;                          // stages filled so far
    int k = 0;                                // units begun
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const Unit w = unit_of(u, n_own, H);
      // partner tiles [first, last]: JAX's causal skip (key tile <= query
      // tile), then, with segment ids, walked_pairs' range rule
      const int first = DKV && CAUSAL ? w.t : 0;
      const int last = DKV ? S / T - 1
                           : (CAUSAL ? min(Skv / T - 1, w.t) : Skv / T - 1);
      int n = max(0, last - first + 1);
      bool listed = false;
      if constexpr (SEG) {
        const int* qs = qseg + (size_t)w.b * S;
        const int* ks = kvseg + (size_t)w.b * Skv;
        // the own tile's segment range (a thread a row) and, for a query
        // tile, whether every row sees its own position
        const int r = w.t * T + t;
        int lo, hi;
        bool all = true;
        if (DKV) {
          lo = hi = ks[r];
        } else {
          lo = hi = qs[r];
          all = r < Skv && ks[r] == lo;
        }
        warp_range(lo, hi, all);
        if (lane == 0) red[warp] = make_int4(lo, hi, all, 0);
        i8g::named_sync(PLAN_BAR, 128);
        int omin = red[0].x, omax = red[0].y, anchored = red[0].z;
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          omin = min(omin, red[i].x);
          omax = max(omax, red[i].y);
          anchored &= red[i].z;
        }
        if (DKV || anchored) {
          // keep[j]: partner tile j is walked (a warp a tile, four rows a
          // lane): its range meets the own tile's, or (a query tile) one
          // of its rows does not see its own position
          for (int j = first + warp; j <= last; j += 4) {
            const int r0 = j * T + lane * 4;
            const int4 pv = *reinterpret_cast<const int4*>(
                (DKV ? qs : ks) + r0);
            int pmin = min(min(pv.x, pv.y), min(pv.z, pv.w));
            int pmax = max(max(pv.x, pv.y), max(pv.z, pv.w));
            bool pa = true;
            if (DKV) {
              pa = r0 < Skv;
              if (pa) {
                const int4 kv = *reinterpret_cast<const int4*>(ks + r0);
                pa = kv.x == pv.x && kv.y == pv.y && kv.z == pv.z &&
                     kv.w == pv.w;
              }
            }
            warp_range(pmin, pmax, pa);
            if (lane == 0)
              keep[j] = (DKV && !pa) || !(pmax < omin || pmin > omax);
          }
          i8g::named_sync(PLAN_BAR, 128);
          if (warp == 0) {
            // the kept tiles in order: 32 at a time, each lane's place the
            // count of kept tiles below it
            int c = 0;
            for (int j0 = first; j0 <= last; j0 += 32) {
              const int j = j0 + lane;
              const bool kj = j <= last && keep[j];
              const unsigned bal = __ballot_sync(0xffffffffu, kj);
              if (kj) list[c + __popc(bal & ((1u << lane) - 1))] = j;
              c += __popc(bal);
            }
            if (lane == 0) red[4].x = c;
          }
          i8g::named_sync(PLAN_BAR, 128);
          n = red[4].x;
          listed = true;
        }
      }
      // the unit's own tiles and its rows' side data (a thread a row,
      // read before the wait)
      const int kb = k & 1;
      const int orow = w.t * T + t;
      float om = 0.f, ol = 1.f, odi = 0.f;
      int oseg = 0;
      if constexpr (DKV) {
        if (SEG) oseg = kvseg[(size_t)w.b * Skv + orow];
      } else {
        const size_t o = ((size_t)w.b * H + w.h) * S + orow;
        om = m[o];
        ol = l[o];
        odi = di[o];
        if (SEG) oseg = qseg[(size_t)w.b * S + orow];
      }
      i8g::mbar_wait(oempty0 + 8 * kb, ((k >> 1) & 1) ^ 1);
      if (t == 0) {
        count[kb] = n;
        i8g::mbar_expect_tx(ofull0 + 8 * kb, 2 * TILE_BYTES);
        const int row = w.b * own_rows + w.t * T;
        i8g::tma_load(base + OFF_OWN + 2 * kb * TILE_BYTES, &mo0,
                      ofull0 + 8 * kb, w.h * HD * 2, row);
        i8g::tma_load(base + OFF_OWN + (2 * kb + 1) * TILE_BYTES, &mo1,
                      ofull0 + 8 * kb, w.h * HD * 2, row);
      }
      float* os = reinterpret_cast<float*>(sm + OFF_OWN_SIDE + kb * SIDE_BYTES);
      if constexpr (!DKV) {
        os[t] = om;
        os[T + t] = __fdiv_rn(1.f, ol);
        os[2 * T + t] = odi;
      }
      reinterpret_cast<int*>(os)[3 * T + t] = oseg;
      i8g::mbar_arrive(ofull0 + 8 * kb);
      // the partner tiles into the ring, each with its rows' side data
      for (int i = 0; i < n; ++i, ++it) {
        const int j = listed ? list[i] : first + i;
        const int prow = j * T + t;
        float pm = 0.f, pl = 1.f, pdi = 0.f;
        int pseg = 0;
        if constexpr (DKV) {
          const size_t o = ((size_t)w.b * H + w.h) * S + prow;
          pm = m[o];
          pl = l[o];
          pdi = di[o];
          if (SEG) pseg = qseg[(size_t)w.b * S + prow];
        } else {
          if (SEG) pseg = kvseg[(size_t)w.b * Skv + prow];
        }
        const int s = it % STAGES;
        i8g::mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        if (t == 0) {
          hdr[s] = j;
          i8g::mbar_expect_tx(full0 + 8 * s, 2 * TILE_BYTES);
          const int row = w.b * partner_rows + j * T;
          const uint32_t dst = base + OFF_RING + 2 * s * TILE_BYTES;
          i8g::tma_load(dst, &mp0, full0 + 8 * s, w.h * HD * 2, row);
          i8g::tma_load(dst + TILE_BYTES, &mp1, full0 + 8 * s, w.h * HD * 2,
                        row);
        }
        float* ps = reinterpret_cast<float*>(sm + OFF_SIDE + s * SIDE_BYTES);
        if constexpr (DKV) {
          ps[t] = pm;
          ps[T + t] = __fdiv_rn(1.f, pl);
          ps[2 * T + t] = pdi;
        }
        reinterpret_cast<int*>(ps)[3 * T + t] = pseg;
        i8g::mbar_arrive(full0 + 8 * s);
      }
      // red, keep and list are the next unit's once every thread is done
      if constexpr (SEG) i8g::named_sync(PLAN_BAR, 128);
    }
  } else {
    // ---- the consumers: 64 own rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, q4 = lane & 3;
    const int rl = 64 * c + 16 * warp + g;    // own rows rl, rl + 8 of a tile
    if (c == 1) named_arrive(TURN_BAR, 256);  // consumer 0 issues first
    uint32_t it = 0;                          // stages taken so far
    int k = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const Unit w = unit_of(u, n_own, H);
      const int kb = k & 1;
      i8g::mbar_wait(ofull0 + 8 * kb, (k >> 1) & 1);
      const int n = count[kb];
      const float* os =
          reinterpret_cast<const float*>(sm + OFF_OWN_SIDE + kb * SIDE_BYTES);
      float rm[2] = {0.f, 0.f}, ril[2] = {0.f, 0.f}, rdi[2] = {0.f, 0.f};
      int rseg[2] = {0, 0};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (!DKV) {
          rm[r] = os[rl + 8 * r];
          ril[r] = os[T + rl + 8 * r];
          rdi[r] = os[2 * T + rl + 8 * r];
        }
        if constexpr (SEG)
          rseg[r] = reinterpret_cast<const int*>(os)[3 * T + rl + 8 * r];
      }
      const uint32_t own = base + OFF_OWN + 2 * kb * TILE_BYTES + c * HALF_BYTES;
      const uint64_t da0 = i8g::sw128_desc(own);
      const uint64_t da1 = i8g::sw128_desc(own + TILE_BYTES);
      const int orow = w.t * T + rl;          // own index of row rl
      float acc0[32], acc1[32], sc[32], dp[32];
      uint32_t pw[16], dw[16];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
      uint32_t prev0 = 0, prev1 = 0;          // the last half's partners
      int prev_s = 0;

      // One half (64 partner rows) of the tile in stage s: this half's
      // sᵀ and dpᵀ (dK/dV) or s and dp (dQ), issued in turn with the other
      // consumer, with (GRADS) the last half's gradient products beside
      // them as a second commit group; then p and ds while the gradient
      // products run. The first half of a unit issues no gradient
      // products: the branch is taken outside, so that every path commits
      // exactly the groups that its wait counts.
      auto half = [&](auto grads, int s, int j, int hf, const float* ps) {
        constexpr bool GRADS = decltype(grads)::value;
        const uint32_t p0 =
            base + OFF_RING + 2 * s * TILE_BYTES + hf * HALF_BYTES;
        const uint32_t p1 = p0 + TILE_BYTES;
        bf16w::fence_acc<32>(sc);
        bf16w::fence_acc<32>(dp);
        bf16w::fence_acc<32>(acc0);
        if (DKV) bf16w::fence_acc<32>(acc1);
        bf16w::fence_words<16>(pw);
        bf16w::fence_words<16>(dw);
        i8g::named_sync(TURN_BAR + c, 256);
        i8g::wgmma_fence();
        const uint64_t db0 = i8g::sw128_desc(p0), db1 = i8g::sw128_desc(p1);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<64, 0>(sc, da0 + 2 * kk, db0 + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          bf16w::wgmma_bf16<64, 0>(dp, da1 + 2 * kk, db1 + 2 * kk, kk > 0);
        i8g::wgmma_commit();
        if constexpr (GRADS) {
          issue_grads<DKV>(acc0, acc1, pw, dw, prev0, prev1);
          i8g::wgmma_commit();
        }
        named_arrive(TURN_BAR + 1 - c, 256);
        if constexpr (GRADS)
          i8g::wgmma_wait<1>();
        else
          i8g::wgmma_wait<0>();
        bf16w::fence_acc<32>(sc);
        bf16w::fence_acc<32>(dp);
        const int col = hf * HALF + 2 * q4;   // this lane's first column
        const int lim = DKV ? j * T + col - orow : orow - j * T - col;
        half_p_ds<DKV, SEG, CAUSAL>(sc, dp, ps + col, ps + T + col,
                                    ps + 2 * T + col,
                                    reinterpret_cast<const int*>(ps) +
                                        3 * T + col,
                                    rm, ril, rdi, rseg, lim, scale,
                                    mask_value);
        if constexpr (GRADS) {
          i8g::wgmma_wait<0>();
          bf16w::fence_acc<32>(acc0);
          if (DKV) bf16w::fence_acc<32>(acc1);
          bf16w::fence_words<16>(pw);
          bf16w::fence_words<16>(dw);
          // the last tile's products are all done: hand its stage back
          if (hf == 0 && lane == 0) i8g::mbar_arrive(empty0 + 8 * prev_s);
        }
        // p (dK/dV) and ds rounded to bf16: the next products' A operands
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          if (DKV) pw[x] = i8g::pack_bf16(sc[2 * x], sc[2 * x + 1]);
          dw[x] = i8g::pack_bf16(dp[2 * x], dp[2 * x + 1]);
        }
        prev0 = p0;
        prev1 = p1;
        prev_s = s;
      };

      for (int i = 0; i < n; ++i, ++it) {
        const int s = it % STAGES;
        i8g::mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const int j = hdr[s];
        const float* ps =
            reinterpret_cast<const float*>(sm + OFF_SIDE + s * SIDE_BYTES);
        if (i == 0)
          half(std::false_type{}, s, j, 0, ps);
        else
          half(std::true_type{}, s, j, 0, ps);
        half(std::true_type{}, s, j, 1, ps);
      }
      if (n > 0) {
        // the last half's gradient products
        bf16w::fence_acc<32>(acc0);
        if (DKV) bf16w::fence_acc<32>(acc1);
        bf16w::fence_words<16>(pw);
        bf16w::fence_words<16>(dw);
        i8g::wgmma_fence();
        issue_grads<DKV>(acc0, acc1, pw, dw, prev0, prev1);
        i8g::wgmma_commit();
        i8g::wgmma_wait<0>();
        bf16w::fence_acc<32>(acc0);
        if (DKV) bf16w::fence_acc<32>(acc1);
        bf16w::fence_words<16>(pw);
        bf16w::fence_words<16>(dw);
        if (lane == 0) i8g::mbar_arrive(empty0 + 8 * prev_s);
      }
      if (lane == 0) i8g::mbar_arrive(oempty0 + 8 * kb);
      const size_t row = (size_t)w.b * own_rows + w.t * T + 64 * c + 16 * warp;
      store_acc(out0, acc0, row + g, H, w.h);
      if (DKV) store_acc(out1, acc1, row + g, H, w.h);
    }
  }
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

// The bf16 kernel of one direction (DKV: dK/dV, else dQ) on a persistent
// grid; out1 (dV) is null for dQ.
template <bool DKV, bool SEG, bool CAUSAL>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* qseg, const int* kvseg, const float* l,
                        const float* m, const void* dout, const float* di,
                        void* out0, void* out1, int B, int S, int H, int Skv,
                        float scale, float mask_value, cudaStream_t st) {
  const long long units = (long long)B * H * ((DKV ? Skv : S) / T);
  const int sms = sm_count();
  if (units > 0x7fffffff || sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t e;
  if ((e = i8g::tensor_map(&mq, q, B * S, H * HD * 2, T)) != cudaSuccess ||
      (e = i8g::tensor_map(&mo, dout, B * S, H * HD * 2, T)) != cudaSuccess ||
      (e = i8g::tensor_map(&mk, k, B * Skv, H * HD * 2, T)) != cudaSuccess ||
      (e = i8g::tensor_map(&mv, v, B * Skv, H * HD * 2, T)) != cudaSuccess)
    return e;
  if ((e = i8g::allow_smem<bwd_bf16<DKV, SEG, CAUSAL>>(BF16_SMEM)) !=
      cudaSuccess)
    return e;
  const int grid = (int)(units < sms ? units : sms);
  bwd_bf16<DKV, SEG, CAUSAL><<<grid, TC_THREADS, BF16_SMEM, st>>>(
      DKV ? mk : mq, DKV ? mv : mo, DKV ? mq : mk, DKV ? mo : mv, qseg, kvseg,
      l, m, di, static_cast<__nv_bfloat16*>(out0),
      static_cast<__nv_bfloat16*>(out1), S, H, Skv, (int)units, scale,
      mask_value);
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const int* qseg, const int* kvseg, const float* l,
                          const float* m, const void* dout, const float* di,
                          void* out0, void* out1, int B, int S, int H,
                          int Skv, int causal, float scale, float mask_value,
                          cudaStream_t st) {
  if (qseg)
    return causal ? launch_bf16<DKV, true, true>(
                        q, k, v, qseg, kvseg, l, m, dout, di, out0, out1, B,
                        S, H, Skv, scale, mask_value, st)
                  : launch_bf16<DKV, true, false>(
                        q, k, v, qseg, kvseg, l, m, dout, di, out0, out1, B,
                        S, H, Skv, scale, mask_value, st);
  return causal ? launch_bf16<DKV, false, true>(
                      q, k, v, qseg, kvseg, l, m, dout, di, out0, out1, B, S,
                      H, Skv, scale, mask_value, st)
                : launch_bf16<DKV, false, false>(
                      q, k, v, qseg, kvseg, l, m, dout, di, out0, out1, B, S,
                      H, Skv, scale, mask_value, st);
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
  if (!is_f32)
    return dispatch_bf16<true>(q, k, v, qs, ks, lf, mf, dout, dif, dk, dv, B,
                               S, H, Skv, causal, scale, mask_value, st);
  cudaError_t e;
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
  if (!is_f32)
    return dispatch_bf16<false>(q, k, v, qs, ks, lf, mf, dout, dif, dq,
                                nullptr, B, S, H, Skv, causal, scale,
                                mask_value, st);
  cudaError_t e;
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
