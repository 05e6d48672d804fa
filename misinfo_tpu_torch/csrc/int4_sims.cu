// Similarities of a query batch against a packed int4 Truth Vault for
// Hopper (sm_90a):
//   out[b, n] = (Σ_d q[b, d] · nib[n, d]) · scale[n]            (K10a)
//   out[b, n] = ((Σ_d qi8[b, d] · nib[n, d]) · scale[n]) · qs[b]  (K10b)
// where row n is stored packed, byte j holding dim j in its low nibble and
// dim j + D/2 in its high nibble (two's complement).
//
// Replaces the TPU kernels misinfo_tpu/vault/int4.py::_int4_sims_kernel
// (K10a: bf16 query, f32 sums) and ::_int4_sims_kernel_i8 (K10b: int8
// query, int32 sums), reached through int4_sims_pallas and
// int4_sims_pallas_i8. The query type is a template parameter; the
// arithmetic follows the plain versions in misinfo_tpu_torch/vault/int4.py.
//
// What bounds it on this card: at a 1,048,576-row, 512-d vault each call
// reads 256 MiB of packed rows and writes B·4 MiB of sims; at 3.35 TB/s
// that is ~83 µs at B = 1 and ~121 µs at B = 32. The products (B·N·D, 34
// G at B = 32) go to the tensor cores, where they take a fraction of that
// time, so the bytes set it:
//  - persistent blocks, one per SM, each with a producer thread that
//    streams tiles of TR consecutive packed rows (one contiguous block of
//    memory: a 1-D bulk copy, cp.async.bulk, counted in on an mbarrier)
//    into a ring of an even number, up to MAX_STAGES, of shared-memory
//    stages (each consumer group owns every other one); every packed
//    row is read from memory once for all B queries;
//  - the query sits in shared memory for the life of the block, laid out
//    in mma.sync B-fragment order (one lane-contiguous 16-byte load per
//    fragment): K10a's bf16 as given; K10b's quantized per row in the
//    block's prologue from the f32 query, with the IEEE arithmetic of
//    quantize_query_i8 (no separate launches for it);
//  - vault rows are the M side of mma.sync, query rows the N side (B ≤ 8
//    per n-tile). Eight consumer warps in two groups of four take the
//    tiles in turns (two tiles in work per SM, two warps per scheduler to
//    hide the steps' latency); a warp owns 16·MT rows of a tile (MT = 2
//    up to 512 dims, so that each query fragment loaded from shared
//    memory serves 32 rows; 1 for K10b's 64 query rows). A lane loads
//    16 packed bytes of a row (bytes s0 + 16t .. s0 + 16t + 15 of a
//    64-byte slice s0, t its quad index) and of the row 8 below, the next
//    slice's while it works on this one, and builds the A fragments from
//    them in registers: the low nibbles are dims s0 + 16t + j, the high
//    nibbles dims D/2 + s0 + 16t + j, and the query fragments hold the
//    same dims (the k order inside a fragment is any order both operands
//    share);
//  - K10b: mma.sync.m16n8k32.s32.s8.s8 on the nibbles placed in the high
//    half of each byte (16·v as s8, one AND or shift-and per word): the
//    int32 sums are 16 times the true ones, exact (|Σ| ≤ 16·D·127·8 <
//    2^31), and an arithmetic shift by 4 restores them, so K10b stays bit
//    for bit its plain version (the low and the high nibbles' steps sum
//    into two accumulators, two dependency chains, added exactly);
//  - K10a: mma.sync.m16n8k16.f32.bf16.bf16 on nibbles turned into bf16
//    pairs without the conversion unit: a byte permute builds the bf16
//    bits of 128 + u (u = nibble ^ 8, 0x4300 | u) two at a time, and a
//    packed bf16 subtraction of 136 leaves u − 8, the signed nibble,
//    exactly. From 256 dims the eight k16 steps of a slice (128 exact
//    products) chain in the tensor cores' f32 accumulator and each
//    slice's sums join the running sums by IEEE additions; below, every
//    step starts from a zero C and is added by an IEEE addition
//    (vault/int4_checks.py derives its band for both);
//  - each accumulator tile goes through shared memory so that every lane
//    stores 16 contiguous bytes of out[b, n0 ..] (streaming stores;
//    scalar ones where N is not a multiple of 4), after the multiplies by
//    scale (loaded at the tile's start) and qs with __fmul_rn in the plain
//    version's order (K10b's integer sums become floats by a magic-number
//    addition, exact below 2^22, not by the conversion unit); rows past N
//    are not stored.
// Never build with --use_fast_math.

#include "int8_gemm.cuh"

namespace {

constexpr int MAXB = 64;            // query rows per launch
constexpr int MAXD = 1024;
constexpr int MAX_STAGES = 6;
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr int GROUP = 4;            // consumer warps per group
constexpr int CONSUMERS = 2 * GROUP;
constexpr int THREADS = (CONSUMERS + 1) * 32;
constexpr float R127 = 0x1.020408p-7f;  // f32(1/127)

// floats per staged output row of a warp (16·MT rows + 4: conflict-free
// writes and reads, 16-byte rows)
__host__ __device__ constexpr int stage_stride(int mt) { return 16 * mt + 4; }
// bytes of a lane's query fragments per 64-byte slice and n-tile
__host__ __device__ constexpr int frag_bytes(bool i8) { return i8 ? 32 : 64; }

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += the tensor cores' sum of one k16 step's 16 products
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// K10b's A words: the low (HI false) or high nibbles of the four bytes of
// w in the high half of each s8 lane, 16·v
template <bool HI>
__device__ __forceinline__ uint32_t nibbles16(uint32_t w) {
  return (HI ? w : w << 4) & 0xF0F0F0F0u;
}

// K10a's A words: the signed nibbles (low: HI false) of bytes (lo, lo + 1)
// of w, u = w ^ 0x88888888 its nibbles + 8, as a bf16 pair
template <bool HI>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t u, int lo) {
  const uint32_t n = (HI ? u >> 4 : u) & 0x0F0F0F0Fu;
  // bytes (u_lo, 0x43, u_hi, 0x43): the bf16 pair (128 + u_lo, 128 + u_hi)
  const uint32_t p = __byte_perm(n, 0x43434343u, lo ? 0x5342 : 0x5140);
  const uint32_t c136 = 0x43084308u;          // the bf16 pair (136, 136)
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p),
              *reinterpret_cast<const __nv_bfloat162*>(&c136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an integer below 2^22 in magnitude as a float, exactly, by the
// addition of 1.5·2^23 (no conversion instruction)
__device__ __forceinline__ float small_int_float(int v) {
  return __fsub_rn(__int_as_float(v + 0x4b400000), 12582912.0f);
}

// K10b's prologue: qi8 = clip(round(q · (127 / qmax))) and qs = qmax ·
// f32(1/127) per query row, qmax = max(max|q|, 1e-12) (quantize_query_i8);
// one warp per row, qi8 [B, D] and qs [B] into shared memory.
__device__ void quantize_query(const float* __restrict__ q, int8_t* qi8,
                               float* qs, int B, int D, int warps) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < B; b += warps) {
    const float* row = q + (size_t)b * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(row[d]));
    const float qmax = fmaxf(int8k::warp_max(amax), 1e-12f);
    const float r = __fdiv_rn(127.f, qmax);
    for (int d = lane; d < D; d += 32)
      qi8[b * D + d] = (int8_t)fminf(fmaxf(rintf(__fmul_rn(row[d], r)),
                                           -127.f), 127.f);
    if (lane == 0) qs[b] = __fmul_rn(qmax, R127);
  }
}

// Grid: persistent blocks striding over tiles of TR = 64·MT rows; warp
// 8 produces, warps 0..7 consume in two groups of four that take the
// block's tiles in turns (group q: its tiles it = q, q + 2, ...; warp w
// of a group: rows 16·MT·w ..), so that two tiles are in work on each SM
// and every warp's query fragments serve 16·MT rows. Dynamic shared
// memory: the ring (stages × TR·D/2 bytes), the query fragments (slices ×
// NT × 32 lanes × frag_bytes), the output staging (8 warps × 8 × TS
// floats), K10b's qs [MAXB] and query rows (int8 [B, D]), the full and
// empty mbarriers. K10a with CHAIN chains the 8 k16 steps of a 64-byte
// slice in the tensor cores' accumulator and adds each slice's sums by
// IEEE additions; without, every step starts from a zero C.
template <bool I8, int NT, int MT, bool CHAIN>
__global__ void __launch_bounds__(THREADS, 1)
int4_sims_kernel(const void* __restrict__ query,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int B, int N, int D, int stages) {
  constexpr int TR = 64 * MT, WR = 16 * MT, TS = stage_stride(MT);
  constexpr int QB = frag_bytes(I8), CH = QB / 16;
  extern __shared__ __align__(128) uint8_t sm[];
  const int D2 = D >> 1, slices = (D2 + 63) / 64;
  const int tile_bytes = TR * D2;
  uint8_t* ring = sm;
  uint8_t* qf = ring + (size_t)stages * tile_bytes;
  float* stage_out = reinterpret_cast<float*>(qf + slices * NT * 32 * QB);
  float* qs = stage_out + CONSUMERS * 8 * TS;           // [MAXB]
  int8_t* qi8 = reinterpret_cast<int8_t*>(qs + MAXB);   // [B, D] (K10b)
  const uint32_t bars =
      i8g::smem_u32(qi8 + (I8 ? (B * D + 15) / 16 * 16 : 0));
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (stages + s); };

  if constexpr (I8) {
    quantize_query(static_cast<const float*>(query), qi8, qs, B, D,
                   THREADS / 32);
    __syncthreads();
  }
  // the query in fragment order: lane (g, t) of n-tile nt and slice sl
  // holds query row 8·nt + g at dims sl·64 + 16t .. + 15 and D/2 + those
  // (zeros past B and past D/2)
  for (int i = threadIdx.x; i < slices * NT * 32 * CH; i += THREADS) {
    const int c = i % CH, lane = (i / CH) % 32;
    const int nt = (i / (CH * 32)) % NT, sl = i / (CH * 32 * NT);
    const int b = nt * 8 + (lane >> 2), base = sl * 64 + 16 * (lane & 3);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (b < B && base < D2) {
      if constexpr (I8) {
        v = *reinterpret_cast<const uint4*>(qi8 + b * D + base + c * D2);
      } else {
        const int dim = base + (c & 1) * 8 + (c >> 1) * D2;
        v = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(query) + (size_t)b * D + dim);
      }
    }
    reinterpret_cast<uint4*>(qf)[i] = v;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      i8g::mbar_init(full(s), 1);
      i8g::mbar_init(empty(s), GROUP);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (N + TR - 1) / TR;
  if (warp == CONSUMERS) {
    if (lane == 0)
      for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
        const int s = it % stages;
        const uint32_t bytes = min(TR, N - t * TR) * D2;
        i8g::mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        i8g::mbar_expect_tx(full(s), bytes);
        bulk_load(i8g::smem_u32(ring + (size_t)s * tile_bytes),
                  packed + (size_t)t * TR * D2, bytes, full(s));
      }
    return;
  }

  const int group = warp / GROUP, wl = warp % GROUP;
  const int g = lane >> 2, t = lane & 3;
  float* so = stage_out + warp * 8 * TS;
  for (int it = group, tile = blockIdx.x + group * gridDim.x; tile < tiles;
       it += 2, tile += 2 * gridDim.x) {
    // the scales of the rows this lane stores, in flight meanwhile: rows
    // 4·(l / 8 + 4i) .. + 3 of the warp's for lane l, i < MT
    float4 sc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int n = tile * TR + wl * WR + 4 * ((lane >> 3) + 4 * i);
      sc[i] = (N & 3) == 0 && n + 3 < N
                  ? *reinterpret_cast<const float4*>(scale + n)
                  : make_float4(n < N ? scale[n] : 0.f,
                                n + 1 < N ? scale[n + 1] : 0.f,
                                n + 2 < N ? scale[n + 2] : 0.f,
                                n + 3 < N ? scale[n + 3] : 0.f);
    }
    const int s = it % stages;
    i8g::mbar_wait(full(s), (it / stages) & 1);
    // rows g and g + 8 of each of the warp's 16-row tiles: 16 bytes each
    // per slice (bytes past the row meet zero query fragments)
    const uint8_t* rows = ring + (size_t)s * tile_bytes +
                          (size_t)(wl * WR + g) * D2 + 16 * t;
    // I8: s32 sums ×16 of the low and the high nibbles' steps; else f32
    // running sums
    int iacc[I8 ? MT * NT * 8 : 1];
    float facc[I8 ? 1 : MT * NT * 4];
#pragma unroll
    for (int i = 0; i < MT * NT * 8; ++i) {
      if constexpr (I8) iacc[i] = 0; else if (i < MT * NT * 4) facc[i] = 0.f;
    }
    uint4 raw[MT][2], next[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        raw[mt][h] = *reinterpret_cast<const uint4*>(
            rows + (size_t)(mt * 16 + 8 * h) * D2);
    for (int sl = 0; sl < slices; ++sl) {
      if (sl + 1 < slices)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            next[mt][h] = *reinterpret_cast<const uint4*>(
                rows + (size_t)(mt * 16 + 8 * h) * D2 + (sl + 1) * 64);
      const uint4* frag = reinterpret_cast<const uint4*>(qf) +
                          ((size_t)sl * NT * 32 + lane) * CH;
      if constexpr (I8) {
        // step (hi, p): a0/a2 from words 2p/2p + 1 of row g, a1/a3 of row
        // g + 8; b0/b1 from the same words of the query chunk
        uint32_t a[MT][2][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t w[4] = {raw[mt][h].x, raw[mt][h].y, raw[mt][h].z,
                                   raw[mt][h].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[mt][0][j >> 1][(j & 1) * 2 + h] = nibbles16<false>(w[j]);
              a[mt][1][j >> 1][(j & 1) * 2 + h] = nibbles16<true>(w[j]);
            }
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 ql = frag[nt * 32 * CH], qh = frag[nt * 32 * CH + 1];
          const uint32_t qw[2][4] = {{ql.x, ql.y, ql.z, ql.w},
                                     {qh.x, qh.y, qh.z, qh.w}};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                const uint32_t* av = a[mt][hi][p];
                mma_s8(&iacc[((mt * NT + nt) * 2 + hi) * 4], av[0], av[1],
                       av[2], av[3], qw[hi][2 * p], qw[hi][2 * p + 1]);
              }
        }
      } else {
        // step (hi, j): word j of the lane's 16 bytes, dims 4j .. 4j + 3:
        // a0/a2 the pairs (4j, 4j + 1)/(4j + 2, 4j + 3) of row g, a1/a3
        // of row g + 8; b0/b1 the query's bf16 at the same dims
        uint32_t a[MT][2][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t w[4] = {raw[mt][h].x, raw[mt][h].y, raw[mt][h].z,
                                   raw[mt][h].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t u = w[j] ^ 0x88888888u;
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                a[mt][0][j][2 * p + h] = nibble_pair<false>(u, p);
                a[mt][1][j][2 * p + h] = nibble_pair<true>(u, p);
              }
            }
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t qw[2][8];
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const uint4 v = frag[nt * 32 * CH + 2 * hi + k];
              qw[hi][4 * k] = v.x;
              qw[hi][4 * k + 1] = v.y;
              qw[hi][4 * k + 2] = v.z;
              qw[hi][4 * k + 3] = v.w;
            }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float* acc = &facc[(mt * NT + nt) * 4];
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint32_t* av = a[mt][hi][j];
                if constexpr (!CHAIN) d[0] = d[1] = d[2] = d[3] = 0.f;
                mma_bf16(d, av[0], av[1], av[2], av[3], qw[hi][2 * j],
                         qw[hi][2 * j + 1]);
                if constexpr (!CHAIN)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    acc[e] = __fadd_rn(acc[e], d[e]);
              }
            if constexpr (CHAIN)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) raw[mt][h] = next[mt][h];
    }
    __syncwarp();                     // every lane's loads of the stage done
    if (lane == 0) i8g::mbar_arrive(empty(s));

    // out[b, n0 .. n0 + WR - 1], one n-tile at a time through so: lane l
    // stores rows 4·(l / 8 + 4i) .. + 3 of query row 8·nt + l % 8
    const int n0 = tile * TR + wl * WR;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v;
          if constexpr (I8)
            v = __int_as_float(iacc[((mt * NT + nt) * 2) * 4 + e] +
                               iacc[((mt * NT + nt) * 2 + 1) * 4 + e]);
          else
            v = facc[(mt * NT + nt) * 4 + e];
          so[(2 * t + (e & 1)) * TS + mt * 16 + g + 8 * (e >> 1)] = v;
        }
      __syncwarp();
      const int b = nt * 8 + (lane & 7);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = 4 * ((lane >> 3) + 4 * i), n = n0 + r;
        if (b < B && n < N) {
          const float4 v =
              *reinterpret_cast<const float4*>(so + (lane & 7) * TS + r);
          const float qv = I8 ? qs[b] : 1.f;
          const auto one = [&](float a, float sv) {
            return I8 ? __fmul_rn(__fmul_rn(small_int_float(
                                                __float_as_int(a) >> 4),
                                            sv),
                                  qv)
                      : __fmul_rn(a, sv);
          };
          const float4 o = make_float4(one(v.x, sc[i].x), one(v.y, sc[i].y),
                                       one(v.z, sc[i].z), one(v.w, sc[i].w));
          float* dst = out + (size_t)b * N + n;
          if ((N & 3) == 0 && n + 3 < N) {
            __stcs(reinterpret_cast<float4*>(dst), o);
          } else {
            const float os[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + e < N) dst[e] = os[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool I8, int NT, int MT, bool CHAIN>
cudaError_t run(const void* query, const uint8_t* packed, const float* scale,
                float* out, int B, int N, int D, cudaStream_t st) {
  const int D2 = D / 2, slices = (D2 + 63) / 64;
  const size_t tile_bytes = (size_t)64 * MT * D2;
  const size_t fixed = (size_t)slices * NT * 32 * frag_bytes(I8) +
                       (size_t)CONSUMERS * 8 * stage_stride(MT) * 4 +
                       MAXB * 4 +
                       (I8 ? ((size_t)B * D + 15) / 16 * 16 : 0) +
                       16 * MAX_STAGES;
  // An even depth: group q takes tiles it ≡ q (mod 2), so with an even
  // depth it uses only the stages s ≡ q (mod 2) and waits on every phase
  // of their full barriers. With an odd depth a stage would pass between
  // the groups, each group's parity wait would skip the other's phase and
  // could pass on a phase two back before the other group's copy landed
  // (bulk copies complete in no promised order).
  const int stages =
      (int)std::min<size_t>(MAX_STAGES, (SMEM_MAX - fixed) / tile_bytes) & ~1;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = stages * tile_bytes + fixed;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int4_sims_kernel<I8, NT, MT, CHAIN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (N + 64 * MT - 1) / (64 * MT);
  int4_sims_kernel<I8, NT, MT, CHAIN>
      <<<std::min(tiles, sms), THREADS, smem, st>>>(query, packed, scale, out,
                                                    B, N, D, stages);
  return cudaGetLastError();
}

// the smallest n-tile count holding B query rows; 32 rows a warp up to
// 512 dims (tiles of at most 32 KB), but 16 for K10b's 64 query rows
// (its split accumulators spill at 32 rows); K10a chains the tensor
// cores' sums within a slice from 256 dims (int4_checks.py)
template <bool I8, int MT, bool CHAIN>
cudaError_t by_batch(const void* query, const uint8_t* packed,
                     const float* scale, float* out, int B, int N, int D,
                     cudaStream_t st) {
#define INT4_RUN(NT, M) \
  return run<I8, NT, M, CHAIN>(query, packed, scale, out, B, N, D, st)
  if (B <= 8) INT4_RUN(1, MT);
  if (B <= 16) INT4_RUN(2, MT);
  if (B <= 32) INT4_RUN(4, MT);
  INT4_RUN(8, I8 ? 1 : MT);
#undef INT4_RUN
}

}  // namespace

// C entry: query [B, D] (int8_query 1: f32, quantized per row in the
// kernel, K10b; 0: bf16, K10a); packed uint8 [N, D/2]; scale f32 [N]; out
// f32 [B, N]. All contiguous and 16-byte aligned. Returns a cudaError_t
// (0 = launched). Needs 1 ≤ B ≤ 64, N ≥ 1, D % 32 == 0, 32 ≤ D ≤ 1024.
extern "C" int int4_sims_launch(const void* query, const void* packed,
                                const void* scale, void* out, int B, int N,
                                int D, int int8_query, void* stream) {
  if (B < 1 || B > MAXB || N < 1 || D % 32 || D < 32 || D > MAXD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  if (int8_query) {
    if (D <= 512) return by_batch<true, 2, false>(query, p, s, o, B, N, D, st);
    return by_batch<true, 1, false>(query, p, s, o, B, N, D, st);
  }
  if (D > 512) return by_batch<false, 1, true>(query, p, s, o, B, N, D, st);
  if (D >= 256) return by_batch<false, 2, true>(query, p, s, o, B, N, D, st);
  return by_batch<false, 2, false>(query, p, s, o, B, N, D, st);
}

extern "C" const char* int4_sims_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
