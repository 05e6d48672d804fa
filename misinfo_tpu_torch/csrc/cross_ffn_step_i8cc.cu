// Fused Whisper decoder cross-attention + FFN step over int8 cross planes,
// for Hopper (sm_90a):
//   x2  = x + o(crossattn_i8(LN(x)))   over int8 encoder K/V planes
//   out = x2 + W2·gelu(W1·LN(x2))
//
// Replaces the TPU kernel misinfo_tpu/ops/pallas_cross_ffn.py
// ::_cross_ffn_kernel_i8cc (K8: int8 weights and int8 cross planes with one
// f32 scale per (batch row, position)), reached through
// fused_cross_ffn_step(k_scale=, v_scale=). The arithmetic follows the plain
// version, misinfo_tpu_torch/ops/cross_ffn_step.py
// ::cross_ffn_step_i8cc_plain; everything but the attention is the device
// code of cross_ffn_step.cu (cross_ffn_phases.cuh, decode_common.cuh).
//
// What bounds it on this card: the int8 planes, 2·B·T·D bytes per layer
// (1.5 MB per batch row at T = 1,500, D = 512, half of the bf16 planes),
// then the int8 weights (2.6 MB for whisper-base) and 8·B·T bytes of
// scales: a streaming problem of a few MB, so launches, the chain of
// dependent memory round trips in each, and the number of SMs sharing each
// stream decide the time. The function fixes two passes over T: the V
// pass quantizes pv = softmax·s_v with one scale per (batch row, V tile)
// taken over all heads, so every head's global max and exp-sum must be
// known before a V row is quantized. The design, five launches from one C
// call, each launched early (programmatic dependent launch,
// decode_common.cuh):
//  1. q = W_q·LN(x) with skinny_gemm, its int32 partials and row scales
//     left for the next launch;
//  2. the attention in ONE launch: a persistent grid (at most the blocks
//     the card holds at once) whose blocks take roles from an atomic
//     counter until they run out, every scores role before any V role and
//     the V roles tile by tile. So every scores role is held by a running
//     block before a V role exists, and the pieces a V role waits for are
//     held by running blocks or go to the next block that frees up (blocks
//     holding earlier tiles need nothing untaken; the grid has more blocks
//     than a tile has pieces): no wait can hold up the work it waits for,
//     however many blocks the card runs and in whatever order.
//     - Scores roles (head, batch row, T chunk; t_chunks' split, about
//       two blocks per SM): the block rebuilds its batch row's q from the
//       product's partials (s32, exact in any order; two thread groups
//       share the partials' loads) in the q order (acc·s_chan)·s_row + b,
//       takes s_q = max(amax, 1e-30)·f32(1/127) over the whole row and
//       quantizes its head's 64 lanes (K10b's fold of the query quantize);
//       then the chunk's scores, four lanes of 16 bytes per int8 K row
//       (sixteen rows per warp in flight), dp4a, ((s32·s_q)·s_k[t]) / √64
//       in that order (positions ≥ t_actual get −1e9), to the workspace,
//       with the chunk's max m_z and exp-sum l_z; then a per-row count.
//     - V roles (batch row, piece of a V tile; about two V blocks per SM,
//       16-64 rows a piece): the block stages its piece's V rows in shared
//       memory with cp.async, waits for the row's count, loads every
//       head's chunk stats at once and merges them in chunk order
//       (merge_chunks: the same order in every block), computes
//       pv = (exp(s − m) / l)·s_v[t] over its rows and all heads, and
//       takes the tile's scale s_p = max(max pv, 1e-30)·f32(1/127) from
//       the max over the tile's pieces, which they exchange through an
//       integer atomic max on the tile's line (pv ≥ 0, so the bits order
//       as the values; a max is exact in any order) and a count; then it
//       quantizes its rows, pq = clip(round(pv / s_p), 0, 127), forms the s32
//       sums Σ pq·v of every head and adds them to the tile's s32 sum with
//       integer atomics (exact in any order). The last V block of the
//       batch row (a ticket) forms ctx = bf16(Σ_tiles float(Σ s32)·s_p) in
//       tile order and leaves every counter and sum at zero.
//     Counters polled across blocks sit on L2 lines of their own. The
//     tile is the TPU wrapper's (the wrapper passes
//     ops/cross_ffn_step.py::v_tile).
//  3-5. x2 = x + o(ctx) and the FFN as in cross_ffn_step.cu (three
//     launches, each product's epilogue in its last blocks).
// The f32(1/127) multiplies are how XLA evaluates the TPU kernel's
// `/ 127.0` under jit; the plain version does the same. Up to the scores
// the arithmetic is integer or a fixed sequence of single f32 roundings;
// against the plain version only LayerNorm's and the softmax's summation
// order (chunked here) and expf differ.
// Five launches from one C call; the wrapper counts one launch per call,
// the library its __global__ launches (cross_ffn_step_i8cc_kernel_launches).

#include <mutex>

#include "cross_ffn_phases.cuh"
#include "self_attn_phases.cuh"

using namespace dec;

namespace {

constexpr float R127 = 0x1.020408p-7f;   // f32(1/127)
constexpr int ATT = 256;                 // threads of the attention kernel
constexpr int KL = 4;                    // lanes per K row, 16 bytes each
constexpr int KROWS = ATT / KL;          // K rows per pass of the block
constexpr int KBATCH = 4;                // passes whose loads go out together
constexpr int MIN_PIECE = 16;            // V rows per piece, at least
constexpr int MAX_PIECE = 64;            // and at most
constexpr int LINE = 32;                 // ints per counter: one L2 line each
constexpr int PV_BATCH = 8;              // scores in flight per thread

// Pieces of a V tile: about two V blocks per SM over the B·nt tiles,
// MIN_PIECE..MAX_PIECE rows a piece.
// Returns the pieces per tile; rows per piece in *pc_out
// (ops/decode_checks.py::tile_pieces mirrors it).
int tile_pieces(int B, int tile, int nt, int sms, int* pc_out) {
  int pp = (2 * sms + B * nt - 1) / (B * nt);
  const int lo = (tile + MAX_PIECE - 1) / MAX_PIECE;
  const int hi = (tile + MIN_PIECE - 1) / MIN_PIECE;
  pp = pp < lo ? lo : (pp > hi ? hi : pp);
  const int pc = (tile + pp - 1) / pp;
  *pc_out = pc;
  return (tile + pc - 1) / pc;
}

// What the attention launch reads and writes. Counters, in the zeroed
// tickets buffer (left zero), each on a line of its own: role, the scores
// roles done per batch row, the V ticket per batch row, the pieces done and
// their largest pv per (batch row, tile); then the tiles' s32 sums acc
// [B, nt, D].
struct Att {
  const int* part;               // the q product's partials [ks, B, D]
  const float *wscale, *bias, *rs;
  const int8_t *ck, *cv;         // planes [B, T, D]
  const float *k_scale, *v_scale;   // [B, T]
  float* sc;                     // scores [B, H, T]
  float *pm, *pl;                // [B, H, ch]
  float* sp;                     // tile scales [B, nt]
  __nv_bfloat16* ctx;            // [B, D]
  int *role, *done, *vt, *tiles, *acc;
  int ks, B, D, T, t_actual, tile, nt, ch, tc, pc, pp;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int sext8(int w, int byte) {
  return (w << (24 - 8 * byte)) >> 24;
}

// The s32 sum over the q product's partials j = j0, j0 + step, ... < ks of
// four lanes (a 16-byte word of one row), the loads of eight partials at
// a time in flight.
__device__ __forceinline__ int4 sum_words(const int4* p, size_t stride,
                                          int j0, int step, int ks) {
  int4 s = make_int4(0, 0, 0, 0);
  for (int j = j0; j < ks; j += 8 * step) {
    int4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = j + i * step < ks ? __ldcg(p + (size_t)(j + i * step) * stride)
                               : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s.x += v[i].x, s.y += v[i].y, s.z += v[i].z, s.w += v[i].w;
  }
  return s;
}

// Scores role (head h, batch row b, chunk z). Shared memory: the head's q
// in f32 [HD], its int8 words [HD / 4], scratch [ATT / 32], the partial
// sums of the thread groups [ATT] int4, the chunk's scores [tc].
__device__ __forceinline__ void scores_role(float* sm, const Att& a, int h,
                                            int b, int z) {
  const int D = a.D, B = a.B, T = a.T, H = D / HD, tid = threadIdx.x;
  float* qf = sm;                                     // [HD]
  int* qw = reinterpret_cast<int*>(qf + HD);          // [HD / 4]
  float* scr = reinterpret_cast<float*>(qw + HD / 4); // [ATT / 32]
  int4* red4 = reinterpret_cast<int4*>(scr + ATT / 32);   // [ATT]
  float* scs = reinterpret_cast<float*>(red4 + ATT);  // [tc]
  const int words = D / 4;
  const int4* p4 = reinterpret_cast<const int4*>(a.part) + (size_t)b * words;
  const size_t stride = (size_t)B * words;            // one partial
  float4 wsc = make_float4(0.f, 0.f, 0.f, 0.f), bia = wsc;
  if (tid < words) {            // weights: loaded before the wait
    wsc = __ldg(reinterpret_cast<const float4*>(a.wscale) + tid);
    bia = __ldg(reinterpret_cast<const float4*>(a.bias) + tid);
  }
  wait_prior_grid();                                  // the q partials
  // q of batch row b, four lanes (one word) per thread, the partials summed
  // in s32 (exact in any order), dequantized in the q order
  const float s_row = __ldcg(a.rs + b);
  float amax = 0.f;
  auto lanes = [&](int4 s, int c, float4 w, float4 bb) {
    const int si[4] = {s.x, s.y, s.z, s.w};
    const float sw[4] = {w.x, w.y, w.z, w.w};
    const float bw[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * c + e;
      // dequant<int8_t>(.., q_order) with the scale and bias in registers
      const float q = __fadd_rn(
          __fmul_rn(__fmul_rn((float)si[e], sw[e]), s_row), bw[e]);
      amax = fmaxf(amax, fabsf(q));
      if (n / HD == h) qf[n - h * HD] = q;
    }
  };
  if (words < ATT) {            // G groups of threads share the partials
    const int G = ATT / words, grp = tid / words, c = tid - grp * words;
    int4 s = make_int4(0, 0, 0, 0);
    if (grp < G) s = sum_words(p4 + c, stride, grp, G, a.ks);
    if (grp > 0 && grp < G) red4[(grp - 1) * words + c] = s;
    __syncthreads();
    if (grp == 0) {
      for (int gg = 1; gg < G; ++gg) {
        const int4 t = red4[(gg - 1) * words + c];
        s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
      }
      lanes(s, c, wsc, bia);
    }
  } else {
    for (int c = tid; c < words; c += ATT) {
      if (c != tid) {           // past the first ATT words
        wsc = __ldg(reinterpret_cast<const float4*>(a.wscale) + c);
        bia = __ldg(reinterpret_cast<const float4*>(a.bias) + c);
      }
      lanes(sum_words(p4 + c, stride, 0, 1, a.ks), c, wsc, bia);
    }
  }
  amax = block_max(amax, scr, whole_block());   // its barriers publish qf
  const float s_q = __fmul_rn(fmaxf(amax, 1e-30f), R127);
  if (tid < HD / 4) {
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w |= (uint32_t)(quant(qf[4 * tid + e], s_q) & 0xff) << (8 * e);
    qw[tid] = (int)w;
  }
  __syncthreads();

  // the chunk's scores: four lanes of 16 bytes per K row
  const int g = tid / KL, l = tid % KL;
  int q4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) q4[e] = qw[4 * l + e];
  const float root = sqrtf((float)HD);
  const int t0 = z * a.tc, t1 = min(T, t0 + a.tc);
  const int ta = min(t1, a.t_actual);
  const int8_t* kb = a.ck + (size_t)b * T * D + h * HD + 16 * l;
  const float* ksb = a.k_scale + (size_t)b * T;
  float* row = a.sc + ((size_t)b * H + h) * T;
  float m = NEG;
  for (int r0 = t0; r0 < t1; r0 += KROWS * KBATCH) {
    int4 u[KBATCH];
    float kz[KBATCH];
#pragma unroll
    for (int i = 0; i < KBATCH; ++i) {
      const int t = r0 + i * KROWS + g;
      const bool in = t < ta;
      u[i] = in ? __ldcs(reinterpret_cast<const int4*>(kb + (size_t)t * D))
                : make_int4(0, 0, 0, 0);
      kz[i] = in ? __ldg(ksb + t) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < KBATCH; ++i) {
      if (r0 + i * KROWS >= t1) break;            // uniform: the shuffles
      const int t = r0 + i * KROWS + g;
      int acc = __dp4a(u[i].x, q4[0], 0);
      acc = __dp4a(u[i].y, q4[1], acc);
      acc = __dp4a(u[i].z, q4[2], acc);
      acc = __dp4a(u[i].w, q4[3], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (t < t1) {
        const float v =
            t < a.t_actual
                ? __fdiv_rn(__fmul_rn(__fmul_rn((float)acc, s_q), kz[i]),
                            root)
                : NEG;
        if (l == 0) {
          scs[t - t0] = v;
          row[t] = v;
        }
        m = fmaxf(m, v);
      }
    }
  }
  m = block_max(m, scr, whole_block());         // its barriers publish scs
  float lz = 0.f;
  for (int r = tid; r < t1 - t0; r += ATT)
    lz = __fadd_rn(lz, expf(__fsub_rn(scs[r], m)));
  lz = block_sum(lz, scr, whole_block());
  if (tid == 0) {
    const size_t i = ((size_t)b * H + h) * a.ch + z;
    a.pm[i] = m;
    a.pl[i] = lz;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicAdd(a.done + b * LINE, 1);
}

// V role (batch row b, piece k of tile j). Shared memory: the piece's V
// rows [pc, D] int8, pv then its levels [H, pc], the heads' m and l [H]
// each, scratch [ATT / 32], the row groups' sums [ATT·4] ints, the
// chunks' m_z and l_z [H, ch] each.
__device__ __forceinline__ void v_role(unsigned char* smem, const Att& a,
                                       int b, int j, int k) {
  const int D = a.D, T = a.T, H = D / HD, tid = threadIdx.x, pc = a.pc;
  int8_t* vs = reinterpret_cast<int8_t*>(smem);               // [pc, D]
  float* pvs = reinterpret_cast<float*>(smem + (size_t)pc * D);   // [H, pc]
  int* pq = reinterpret_cast<int*>(pvs);
  float* mh = pvs + H * pc;                                   // [H]
  float* lh = mh + H;                                         // [H]
  float* scr = lh + H;                                        // [ATT / 32]
  int* red = reinterpret_cast<int*>(scr + ATT / 32);          // [ATT, 4]
  float* zm = reinterpret_cast<float*>(red + 4 * ATT);        // [H, ch]
  float* zl = zm + H * a.ch;                                  // [H, ch]
  __shared__ int last;
  const int jt0 = j * a.tile, jt1 = min(T, jt0 + a.tile);
  const int p0 = jt0 + k * pc, p1 = min(p0 + pc, jt1);
  const int n = max(0, p1 - p0);
  // the piece's rows are one contiguous run of the plane: in flight while
  // the scores are taken
  const int8_t* vsrc = a.cv + ((size_t)b * T + p0) * D;
  for (int i = tid; i < n * D / 16; i += ATT)
    cp_async16(vs + 16 * i, vsrc + 16 * i);
  wait_prior_grid();
  if (tid == 0)
    while (ld_acquire(a.done + b * LINE) < H * a.ch) __nanosleep(128);
  __syncthreads();
  // every head's chunk stats in one round trip, then each head's merge
  for (int i = tid; i < H * a.ch; i += ATT) {
    zm[i] = __ldcg(a.pm + (size_t)b * H * a.ch + i);
    zl[i] = __ldcg(a.pl + (size_t)b * H * a.ch + i);
  }
  __syncthreads();
  if (tid < H) {
    float m, l;
    merge_chunks(a.ch, [&](int z) {
      return make_float2(zm[tid * a.ch + z], zl[tid * a.ch + z]);
    }, m, l);
    mh[tid] = m;
    lh[tid] = l;
  }
  __syncthreads();
  // pv of the piece's rows and every head, and their max; the tile's
  // scale from the max over its pieces (exact: a max in any order), which
  // the pieces exchange through the tile's line
  float mx = 0.f;
  const float* vsc = a.v_scale + (size_t)b * T;
  const float* scb = a.sc + (size_t)b * H * T;
  for (int i0 = tid; i0 < H * n; i0 += PV_BATCH * ATT) {
    float s[PV_BATCH], f[PV_BATCH];
#pragma unroll
    for (int u = 0; u < PV_BATCH; ++u) {
      const int i = i0 + u * ATT, h = i / n, t = p0 + i - h * n;
      const bool in = i < H * n;
      s[u] = in ? __ldcg(scb + (size_t)h * T + t) : 0.f;
      f[u] = in ? __ldg(vsc + t) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PV_BATCH; ++u) {
      const int i = i0 + u * ATT, h = i / n, r = i - h * n;
      if (i >= H * n) break;
      const float pv = __fmul_rn(
          __fdiv_rn(expf(__fsub_rn(s[u], mh[h])), lh[h]), f[u]);
      mx = fmaxf(mx, pv);
      pvs[h * pc + r] = pv;
    }
  }
  mx = block_max(mx, scr, whole_block());      // its barriers publish pvs
  int* tl_line = a.tiles + ((size_t)b * a.nt + j) * LINE;   // count, max
  if (tid == 0) {
    atomicMax(tl_line + 1, __float_as_int(mx));   // pv ≥ 0: ints order too
    __threadfence();
    atomicAdd(tl_line, 1);
    while (ld_acquire(tl_line) < a.pp) __nanosleep(64);
    scr[0] = __int_as_float(__ldcg(tl_line + 1));
  }
  __syncthreads();
  mx = scr[0];
  const float sp = __fmul_rn(fmaxf(mx, 1e-30f), R127);
  for (int i = tid; i < H * n; i += ATT) {
    const int h = i / n, r = i - h * n;
    pq[h * pc + r] =
        max(0, min(127, __float2int_rn(__fdiv_rn(pvs[h * pc + r], sp))));
  }
  cp_async_wait_all();
  __syncthreads();
  // Σ_t pq[h, t]·v[t, d]: a thread per 4 lanes (one word of a row), the
  // rows split over G groups
  const int words = D / 4;
  const int G = ATT / words > 1 ? ATT / words : 1;
  int* accb = a.acc + ((size_t)b * a.nt + j) * D;
  for (int w = tid; w < G * words; w += ATT) {
    const int g = w / words, c = w - g * words, h = 4 * c / HD;
    int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    const int* vw = reinterpret_cast<const int*>(vs) + c;
    for (int r = g; r < n; r += G) {
      const int v = vw[r * words], p = pq[h * pc + r];
      s0 += p * sext8(v, 0);
      s1 += p * sext8(v, 1);
      s2 += p * sext8(v, 2);
      s3 += p * sext8(v, 3);
    }
    if (G == 1) {
      atomicAdd(accb + 4 * c, s0);
      atomicAdd(accb + 4 * c + 1, s1);
      atomicAdd(accb + 4 * c + 2, s2);
      atomicAdd(accb + 4 * c + 3, s3);
    } else {
      int* r4 = red + 4 * w;
      r4[0] = s0, r4[1] = s1, r4[2] = s2, r4[3] = s3;
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int d = tid; d < D; d += ATT) {
      int s = 0;
      for (int g = 0; g < G; ++g) s += red[4 * g * words + d];
      atomicAdd(accb + d, s);
    }
  }
  if (k == 0 && tid == 0) a.sp[(size_t)b * a.nt + j] = sp;

  // the batch row's last V block forms its context
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.vt + b * LINE, 1) == a.nt * a.pp - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int* accr = a.acc + (size_t)b * a.nt * D;
  for (int d = tid; d < D; d += ATT) {
    float s = 0.f;
    for (int jj = 0; jj < a.nt; ++jj) {
      const int ci = __ldcg(accr + (size_t)jj * D + d);
      accr[(size_t)jj * D + d] = 0;
      s = __fadd_rn(s, __fmul_rn((float)ci,
                                 __ldcg(a.sp + (size_t)b * a.nt + jj)));
    }
    a.ctx[(size_t)b * D + d] = __float2bfloat16_rn(s);
  }
  if (tid == 0) {
    a.vt[b * LINE] = 0;
    a.done[b * LINE] = 0;
  }
  for (int jj = tid; jj < a.nt; jj += ATT) {   // the row's tiles' lines
    a.tiles[((size_t)b * a.nt + jj) * LINE] = 0;
    a.tiles[((size_t)b * a.nt + jj) * LINE + 1] = 0;
  }
}

// A persistent grid of at most the blocks the card holds at once, ATT
// threads, dynamic shared memory att_smem: each block takes roles from the
// role counter until they run out (B·H·ch scores roles, then B·nt·pp V
// roles), so every scores role is held by a running block before any V
// role is taken. Launched early.
__global__ void __launch_bounds__(ATT, 4) attend_i8(const Att a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int role_s;
  const int H = a.D / HD, ns = a.B * H * a.ch;
  const int total = ns + a.B * a.nt * a.pp;
  for (;;) {
    __syncthreads();            // role_s and the last role's shared memory
    if (threadIdx.x == 0) {
      const int r = atomicAdd(a.role, 1);
      if (r == total + (int)gridDim.x - 1) *a.role = 0;  // all ran dry
      role_s = r;
    }
    __syncthreads();
    const int r = role_s;
    if (r >= total) return;
    if (r < ns) {
      const int z = r % a.ch, bh = r / a.ch;
      scores_role(reinterpret_cast<float*>(smem), a, bh % H, bh / H, z);
    } else {
      const int v = r - ns, per = a.nt * a.pp;
      const int b = v / per, jk = v - b * per;
      v_role(smem, a, b, jk / a.pp, jk % a.pp);
    }
  }
}

// Blocks of attend_i8 that the card holds at once with `smem` bytes of
// dynamic shared memory, after raising the kernel's limit to it; the last
// answer is kept (a decode asks with the same size at every step).
cudaError_t att_capacity(size_t smem, int sms, int* blocks) {
  static std::mutex mu;
  static int last_device = -1, last_per_sm = 0;
  static size_t last_smem = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (device != last_device || smem != last_smem) {
    e = cudaFuncSetAttribute(attend_i8,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_per_sm, attend_i8,
                                                      ATT, smem);
    if (e != cudaSuccess) return e;
    last_device = device, last_smem = smem;
  }
  *blocks = last_per_sm * sms;
  return cudaSuccess;
}

size_t att_smem(int D, int tc, int pc, int ch) {
  const int H = D / HD;
  const size_t scores = (size_t)(HD + HD / 4 + ATT / 32 + 4 * ATT + tc) * 4;
  const size_t v = (size_t)pc * D + (size_t)(H * pc + 2 * H + ATT / 32 +
                                             4 * ATT + 2 * H * ch) * 4;
  return scores > v ? scores : v;
}

struct Work {
  void* part;
  float *rs, *sc, *pm, *pl, *sp;
  __nv_bfloat16 *ctx, *x2, *g;
};

// The call's partitions.
struct Split {
  int H, nt, ch, tc, pp, pc;
};
Split split(int B, int D, int T, int tile, int sms) {
  Split s;
  s.H = D / HD;
  s.nt = (T + tile - 1) / tile;
  s.ch = t_chunks(B, s.H, T, sms, &s.tc);
  s.pp = tile_pieces(B, tile, s.nt, sms, &s.pc);
  return s;
}

// Carves the workspace; *used gets the bytes taken.
Work carve(void* ws, int B, int D, int F, int T, int tile, int sms,
           size_t* used = nullptr) {
  Carve c(ws);
  const Split s = split(B, D, T, tile, sms);
  Work w;
  w.part = c.take(cross_part_bytes(B, D, F, sms));
  w.rs = static_cast<float*>(c.take((size_t)B * 4));
  w.sc = static_cast<float*>(c.take((size_t)B * s.H * T * 4));
  w.pm = static_cast<float*>(c.take((size_t)B * s.H * s.ch * 4));
  w.pl = static_cast<float*>(c.take((size_t)B * s.H * s.ch * 4));
  w.sp = static_cast<float*>(c.take((size_t)B * s.nt * 4));
  w.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.x2 = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.g = static_cast<__nv_bfloat16*>(c.take((size_t)B * F * 2));
  if (used) *used = c.used;
  return w;
}

// Tickets of the products; the attention's counters follow them.
int gemm_part(int D, int F) { return gemm_tickets(D > F ? D : F); }

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t cross_ffn_step_i8cc_workspace(int B, int D, int F, int T,
                                                int tile, int sms) {
  size_t used = 0;
  carve(nullptr, B, D, F, T, tile, sms, &used);
  return used;
}

// Tickets (ints) for one call: a zeroed buffer that each call leaves
// zeroed, so calls in one stream's order share it. The products' tickets,
// then the attention's counters and the tiles' s32 sums.
extern "C" int cross_ffn_step_i8cc_tickets(int B, int D, int F, int T,
                                           int tile) {
  const int nt = (T + tile - 1) / tile;
  return gemm_part(D, F) + LINE * (1 + 2 * MAXB + B * nt) + B * nt * D;
}

// __global__ launches made by cross_ffn_step_i8cc_launch since the library
// was loaded (five per call that reached its last launch).
extern "C" long long cross_ffn_step_i8cc_kernel_launches() {
  return g_launches;
}

// C entry: x bf16 [B, D]; LayerNorm parameters f32 [D]; wq, wo [D, D],
// w1 [D, F], w2 [F, D] int8 with f32 per-channel scales; biases f32; merged
// cross K/V int8 [B, T, D] with f32 row scales k_scale, v_scale [B, T];
// positions ≥ t_actual are masked; `tile` the V-pass tile in rows; out bf16
// [B, D]; ws from cross_ffn_step_i8cc_workspace; tickets
// cross_ffn_step_i8cc_tickets ints, zero (and left zero). All contiguous,
// 16-byte aligned. Returns a cudaError_t (0 = launched). Needs 1 ≤ B ≤ 32,
// D % 64 == 0, F % 32 == 0, 1 ≤ t_actual ≤ T, tile ≥ 1.
extern "C" int cross_ffn_step_i8cc_launch(
    const void* x_, const void* lnc_g_, const void* lnc_b_, const void* wq_,
    const void* sq_, const void* bq_, const void* wo_, const void* so_,
    const void* bo_, const void* ln2_g_, const void* ln2_b_, const void* w1_,
    const void* s1_, const void* b1_, const void* w2_, const void* s2_,
    const void* b2_, const void* cache_k, const void* cache_v,
    const void* k_scale_, const void* v_scale_, void* out_, void* ws,
    void* tickets_, int B, int D, int F, int T, int t_actual, int tile,
    int sms, void* stream) {
  if (B < 1 || B > MAXB || D <= 0 || D % HD || F <= 0 || F % TILE_N ||
      t_actual < 1 || t_actual > T || tile < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  auto* tickets = static_cast<int*>(tickets_);
  const Work w = carve(ws, B, D, F, T, tile, sms);
  const Split s = split(B, D, T, tile, sms);
  int ks;
  cudaError_t e = gemm<int8_t, IN_LN, EP_NONE>(
      In{x, f(lnc_g_), f(lnc_b_)}, i8(wq_), w.part, w.rs, nullptr, Ep{}, B, D,
      D, sms, st, &ks);
  if (e != cudaSuccess) return e;
  int* cnt = tickets + gemm_part(D, F);
  const Att a{static_cast<const int*>(w.part), f(sq_), f(bq_), w.rs,
              i8(cache_k), i8(cache_v), f(k_scale_), f(v_scale_), w.sc, w.pm,
              w.pl, w.sp, w.ctx, cnt, cnt + LINE, cnt + LINE * (1 + MAXB),
              cnt + LINE * (1 + 2 * MAXB),
              cnt + LINE * (1 + 2 * MAXB + B * s.nt), ks, B, D, T, t_actual,
              tile, s.nt, s.ch, s.tc, s.pc, s.pp};
  const size_t smem = att_smem(D, s.tc, s.pc, s.ch);
  int blocks = 0;
  e = att_capacity(smem, sms, &blocks);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const int roles = B * s.H * s.ch + B * s.nt * s.pp;
  e = launch_early(attend_i8, dim3(roles < blocks ? roles : blocks),
                   dim3(ATT), smem, st, a);
  if (e != cudaSuccess) return e;
  return after_attention<int8_t>(
      x, w.ctx, i8(wo_), f(so_), f(bo_), f(ln2_g_), f(ln2_b_), i8(w1_),
      f(s1_), f(b1_), i8(w2_), f(s2_), f(b2_), w.part, tickets, w.x2, w.g, out,
      B, D, F, sms, st);
}

extern "C" const char* cross_ffn_step_i8cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
