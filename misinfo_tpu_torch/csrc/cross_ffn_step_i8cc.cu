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
// scales: a streaming problem of a few MB, so launches and the number of
// SMs sharing each stream decide the time. The design:
//  1. q = W_q·LN(x) with skinny_gemm; one block per batch row dequantizes
//     the row in f32 in the q order (acc·s_chan)·s_row + b (it is not
//     rounded to bf16 here), takes s_q = max(amax, 1e-30)·f32(1/127) over
//     the whole row and quantizes it;
//  2. scores, grid (head, batch row, T chunk), one thread per position:
//     sixteen dp4a over the 64 int8 of the head, then
//     ((s32·s_q)·s_k[t]) / 8 in that order; positions ≥ t_actual get −1e9;
//  3. one block per (head, batch row): the f32 softmax over all T (not
//     rounded), the V row scales folded in, pv = p·s_v[t], written over the
//     scores, and the largest pv of each V tile;
//  4. the V pass, grid (head, batch row, tile piece): the tile's scale
//     s_p = max(max over heads and positions of pv, 1e-30)·f32(1/127) (a
//     max over the heads' maxima, so exact), pq = clip(round(pv / s_p), 0,
//     127), and the s32 sums Σ_t pq·v over the piece. The tile is the TPU
//     wrapper's (the wrapper passes ops/cross_ffn_step.py::v_tile); pieces
//     of a tile only split its integer sum, which is exact in any order;
//  5. ctx = bf16(Σ_tiles float(s32)·s_p), in tile order;
//  6. x2 = x + o(ctx) and the FFN as in cross_ffn_step.cu.
// The f32(1/127) multiplies are how XLA evaluates the TPU kernel's
// `/ 127.0` under jit; the plain version does the same. Up to the scores
// the arithmetic is integer or a fixed sequence of single f32 roundings;
// against the plain version only LayerNorm's and the softmax's summation
// order and expf differ.
// Twelve launches from one C call; the wrapper counts one launch per call.

#include "cross_ffn_phases.cuh"

using namespace dec;

namespace {

constexpr float R127 = 0x1.020408p-7f;   // f32(1/127)
constexpr int PROB = 256;                // threads of the softmax kernel

// Grid B, THREADS threads; dynamic shared memory (D + WARPS) floats.
__global__ void __launch_bounds__(THREADS)
quantize_q(const int* __restrict__ part, int ks,
           const float* __restrict__ scale, const float* __restrict__ bias,
           const float* __restrict__ rs, int8_t* __restrict__ qq,
           float* __restrict__ sq, int B, int D) {
  extern __shared__ float sm[];
  float* qf = sm;           // [D]
  float* scr = sm + D;      // [WARPS]
  const int b = blockIdx.x;
  float amax = 0.f;
  for (int n = threadIdx.x; n < D; n += THREADS) {
    const float v = dequant<int8_t>(part, ks, B, D, b, n, scale, bias, rs,
                                    true);
    qf[n] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, scr, whole_block());
  const float s = __fmul_rn(fmaxf(amax, 1e-30f), R127);
  for (int n = threadIdx.x; n < D; n += THREADS)
    qq[(size_t)b * D + n] = (int8_t)quant(qf[n], s);
  if (threadIdx.x == 0) sq[b] = s;
}

// Grid (H, B, chunks), CROSS_ATT threads, one thread per position; scores
// [B, H, T] f32.
__global__ void __launch_bounds__(CROSS_ATT)
scores_i8(const int8_t* __restrict__ qq, const float* __restrict__ sq,
          const int8_t* __restrict__ ck, const float* __restrict__ k_scale,
          float* __restrict__ sc, int D, int T, int t_actual, int tc) {
  __shared__ int qw[HD / 4];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  if (threadIdx.x < HD / 4)
    qw[threadIdx.x] = reinterpret_cast<const int*>(
        qq + (size_t)b * D + h * HD)[threadIdx.x];
  __syncthreads();
  const float s = sq[b], root = sqrtf((float)HD);
  const int t0 = blockIdx.z * tc, t1 = min(T, t0 + tc);
  float* row = sc + ((size_t)b * H + h) * T;
  for (int t = t0 + threadIdx.x; t < t1; t += CROSS_ATT) {
    const int4* kr = reinterpret_cast<const int4*>(
        ck + ((size_t)b * T + t) * D + h * HD);
    int acc = 0;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const int4 u = kr[c];
      acc = __dp4a(u.x, qw[4 * c], acc);
      acc = __dp4a(u.y, qw[4 * c + 1], acc);
      acc = __dp4a(u.z, qw[4 * c + 2], acc);
      acc = __dp4a(u.w, qw[4 * c + 3], acc);
    }
    const float v = __fdiv_rn(
        __fmul_rn(__fmul_rn((float)acc, s), k_scale[(size_t)b * T + t]),
        root);
    row[t] = t < t_actual ? v : NEG;
  }
}

// Grid (H, B), PROB threads: scores → pv = softmax·s_v in place, and
// tmax[b, h, j] = the largest pv of V tile j.
__global__ void __launch_bounds__(PROB)
fold_probs(float* __restrict__ sc, const float* __restrict__ v_scale,
           float* __restrict__ tmax, int T, int tile, int nt) {
  __shared__ float scr[PROB / 32];
  const Team tm = whole_block();
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  float* row = sc + ((size_t)b * H + h) * T;
  float m = NEG;
  for (int t = threadIdx.x; t < T; t += PROB) m = fmaxf(m, row[t]);
  m = block_max(m, scr, tm);
  float l = 0.f;
  for (int t = threadIdx.x; t < T; t += PROB)
    l = __fadd_rn(l, expf(__fsub_rn(row[t], m)));
  l = block_sum(l, scr, tm);
  for (int j = 0; j < nt; ++j) {
    const int t1 = min(T, (j + 1) * tile);
    float mx = 0.f;
    for (int t = j * tile + threadIdx.x; t < t1; t += PROB) {
      const float pv = __fmul_rn(__fdiv_rn(expf(__fsub_rn(row[t], m)), l),
                                 v_scale[(size_t)b * T + t]);
      row[t] = pv;
      mx = fmaxf(mx, pv);
    }
    mx = block_max(mx, scr, tm);
    if (threadIdx.x == 0) tmax[((size_t)b * H + h) * nt + j] = mx;
  }
}

// Pieces of a V tile: about two blocks per SM over all tiles, at least 32
// rows a piece. Returns the pieces per tile; rows per piece in *pc_out.
int tile_pieces(int B, int H, int tile, int nt, int sms, int* pc_out) {
  int pp = (2 * sms + B * H * nt - 1) / (B * H * nt);
  const int hi = (tile + 31) / 32;
  pp = pp < 1 ? 1 : (pp > hi ? hi : pp);
  const int pc = (tile + pp - 1) / pp;
  *pc_out = pc;
  return (tile + pc - 1) / pc;
}

// Grid (H, B, nt·pp), CROSS_ATT threads; pint [nt·pp, B, D] s32, sp [B, nt].
// Dynamic shared memory (pc + CROSS_ATT·4) ints.
__global__ void __launch_bounds__(CROSS_ATT)
pv_i8(const float* __restrict__ pv, const float* __restrict__ tmax,
      const int8_t* __restrict__ cv, int* __restrict__ pint,
      float* __restrict__ sp_out, int D, int T, int tile, int nt, int pc,
      int pp) {
  extern __shared__ int smi[];
  int* pq = smi;            // [pc]
  int* red = smi + pc;      // [CROSS_ATT / 16, HD]
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const int j = blockIdx.z / pp, piece = blockIdx.z - j * pp;
  const int t0 = j * tile + piece * pc;
  const int t1 = min(min(t0 + pc, (j + 1) * tile), T);
  float mx = 0.f;
  for (int hh = 0; hh < H; ++hh)
    mx = fmaxf(mx, tmax[((size_t)b * H + hh) * nt + j]);
  const float sp = __fmul_rn(fmaxf(mx, 1e-30f), R127);
  if (h == 0 && piece == 0 && threadIdx.x == 0) sp_out[b * nt + j] = sp;
  const float* row = pv + ((size_t)b * H + h) * T;
  for (int t = t0 + threadIdx.x; t < t1; t += CROSS_ATT)
    pq[t - t0] = max(0, min(127, __float2int_rn(__fdiv_rn(row[t], sp))));
  __syncthreads();
  // sixteen threads take the 64 lanes of a row four at a time; eight rows
  // in flight
  const int c = threadIdx.x & 15, g = threadIdx.x >> 4;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int t = t0 + g; t < t1; t += CROSS_ATT / 16) {
    const int w = *reinterpret_cast<const int*>(
        cv + ((size_t)b * T + t) * D + h * HD + 4 * c);
    const int p = pq[t - t0];
    a0 += p * (int)(int8_t)(w & 0xff);
    a1 += p * (int)(int8_t)((w >> 8) & 0xff);
    a2 += p * (int)(int8_t)((w >> 16) & 0xff);
    a3 += p * (w >> 24);
  }
  int* r = red + g * HD + 4 * c;
  r[0] = a0;
  r[1] = a1;
  r[2] = a2;
  r[3] = a3;
  __syncthreads();
  if (threadIdx.x < HD) {
    int s = 0;
    for (int v = 0; v < CROSS_ATT / 16; ++v) s += red[v * HD + threadIdx.x];
    pint[((size_t)blockIdx.z * B + b) * D + h * HD + threadIdx.x] = s;
  }
}

// ctx [B, D] = bf16(Σ_j float(Σ_pieces pint)·sp[b, j], in tile order)
__global__ void combine_i8(const int* __restrict__ pint,
                           const float* __restrict__ sp,
                           __nv_bfloat16* __restrict__ ctx, int B, int D,
                           int nt, int pp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * D) return;
  const int b = i / D;
  float s = 0.f;
  for (int j = 0; j < nt; ++j) {
    int ci = 0;
    for (int p = 0; p < pp; ++p) ci += pint[(size_t)(j * pp + p) * B * D + i];
    s = __fadd_rn(s, __fmul_rn((float)ci, sp[b * nt + j]));
  }
  ctx[i] = __float2bfloat16_rn(s);
}

struct Work {
  void* part;
  float *rs, *sq, *sc, *tmax, *sp;
  int8_t* qq;
  int* pint;
  __nv_bfloat16 *ctx, *x2, *g;
};

// Carves the workspace; *used gets the bytes taken.
Work carve(void* ws, int B, int D, int F, int T, int tile, int sms,
           size_t* used = nullptr) {
  Carve c(ws);
  const int H = D / HD, nt = (T + tile - 1) / tile;
  int pc;
  const int pp = tile_pieces(B, H, tile, nt, sms, &pc);
  Work w;
  w.part = c.take(cross_part_bytes(B, D, F, sms));
  w.rs = static_cast<float*>(c.take((size_t)B * 4));
  w.sq = static_cast<float*>(c.take((size_t)B * 4));
  w.qq = static_cast<int8_t*>(c.take((size_t)B * D));
  w.sc = static_cast<float*>(c.take((size_t)B * H * T * 4));
  w.tmax = static_cast<float*>(c.take((size_t)B * H * nt * 4));
  w.sp = static_cast<float*>(c.take((size_t)B * nt * 4));
  w.pint = static_cast<int*>(c.take((size_t)nt * pp * B * D * 4));
  w.ctx = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.x2 = static_cast<__nv_bfloat16*>(c.take((size_t)B * D * 2));
  w.g = static_cast<__nv_bfloat16*>(c.take((size_t)B * F * 2));
  if (used) *used = c.used;
  return w;
}

}  // namespace

// Workspace bytes for one call (the wrapper allocates them).
extern "C" size_t cross_ffn_step_i8cc_workspace(int B, int D, int F, int T,
                                                int tile, int sms) {
  size_t used = 0;
  carve(nullptr, B, D, F, T, tile, sms, &used);
  return used;
}

// C entry: x bf16 [B, D]; LayerNorm parameters f32 [D]; wq, wo [D, D],
// w1 [D, F], w2 [F, D] int8 with f32 per-channel scales; biases f32; merged
// cross K/V int8 [B, T, D] with f32 row scales k_scale, v_scale [B, T];
// positions ≥ t_actual are masked; `tile` the V-pass tile in rows; out bf16
// [B, D]; ws from cross_ffn_step_i8cc_workspace. All contiguous, 16-byte
// aligned. Returns a cudaError_t (0 = launched). Needs 1 ≤ B ≤ 32,
// D % 64 == 0, F % 32 == 0, 1 ≤ t_actual ≤ T, tile ≥ 1.
extern "C" int cross_ffn_step_i8cc_launch(
    const void* x_, const void* lnc_g_, const void* lnc_b_, const void* wq_,
    const void* sq_, const void* bq_, const void* wo_, const void* so_,
    const void* bo_, const void* ln2_g_, const void* ln2_b_, const void* w1_,
    const void* s1_, const void* b1_, const void* w2_, const void* s2_,
    const void* b2_, const void* cache_k, const void* cache_v,
    const void* k_scale_, const void* v_scale_, void* out_, void* ws, int B,
    int D, int F, int T, int t_actual, int tile, int sms, void* stream) {
  if (B < 1 || B > MAXB || D <= 0 || D % HD || F <= 0 || F % TILE_N ||
      t_actual < 1 || t_actual > T || tile < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto* x = static_cast<const __nv_bfloat16*>(x_);
  auto* out = static_cast<__nv_bfloat16*>(out_);
  const Work w = carve(ws, B, D, F, T, tile, sms);
  const int H = D / HD, nt = (T + tile - 1) / tile;
  int ks, tc, pc;
  const int ch = t_chunks(B, H, T, sms, &tc);
  const int pp = tile_pieces(B, H, tile, nt, sms, &pc);
  cudaError_t e = gemm<int8_t, IN_LN>(x, f(lnc_g_), f(lnc_b_), i8(wq_), w.part,
                                      w.rs, B, D, D, sms, st, &ks);
  if (e != cudaSuccess) return e;
  quantize_q<<<B, THREADS, (size_t)(D + WARPS) * 4, st>>>(
      static_cast<const int*>(w.part), ks, f(sq_), f(bq_), w.rs, w.qq, w.sq, B,
      D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scores_i8<<<dim3(H, B, ch), CROSS_ATT, 0, st>>>(
      w.qq, w.sq, i8(cache_k), f(k_scale_), w.sc, D, T, t_actual, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fold_probs<<<dim3(H, B), PROB, 0, st>>>(w.sc, f(v_scale_), w.tmax, T, tile,
                                          nt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  pv_i8<<<dim3(H, B, nt * pp), CROSS_ATT, (size_t)(pc + CROSS_ATT * 4) * 4,
          st>>>(w.sc, w.tmax, i8(cache_v), w.pint, w.sp, D, T, tile, nt, pc,
                pp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  combine_i8<<<(B * D + 255) / 256, 256, 0, st>>>(w.pint, w.sp, w.ctx, B, D,
                                                  nt, pp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return after_attention<int8_t>(x, w.ctx, i8(wo_), f(so_), f(bo_), f(ln2_g_),
                                 f(ln2_b_), i8(w1_), f(s1_), f(b1_), i8(w2_),
                                 f(s2_), f(b2_), w.part, w.rs, w.x2, w.g, out,
                                 B, D, F, sms, st);
}

extern "C" const char* cross_ffn_step_i8cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
