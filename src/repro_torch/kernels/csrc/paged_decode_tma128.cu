// Paged single-token decode attention for Hopper (sm_90a): bf16 q over
// bf16 or int8 pools at head_dim 128, blocks loaded by TMA, keys split over
// CTAs.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_decode_attention (body _paged_decode_kernel) at head_dim 128, the
// route the dense configs (qwen2.5-32b, qwen3-14b, qwen3-32b, yi-34b)
// serve on; paged_decode_tma.cu keeps head_dim 64 and paged_decode.cu
// float32 q and the shapes neither takes (kernels/ops.py :: paged_route).
//
// What bounds it on an H100: the bytes of K/V read (2 * ctx * 128
// elements per lane and KV head, 4 * g * 128 flops a key: far below the
// ridge). At serving sizes a call moves a few hundred KB and the launch
// and the chain of dependent loads bound it; at long contexts (8 lanes at
// 4096 keys, 8 KV heads: 134 MB of bf16 K/V) the memory rate does.
//
// What the design does about it (the ring and the splits are
// paged_tma.cuh's, at DD = 128):
//   * the grid is (KV head, lane, split) with the head_dim-64 kernel's
//     split plan: a long context fills the card, the serving shape
//     (tables of up to 384 keys) runs one split a (lane, KV head) and
//     writes its output with no merge;
//   * a producer warp reads the split's table slice once and keeps whole
//     K/V blocks (and int8 scales) in flight by TMA, NS stages of 64 keys.
//     A bf16 row is 256 bytes: each block is two 128-byte-swizzled boxes
//     (columns 0-63 and 64-127) into the two halves of the stage's tile;
//     an int8 row is 128 bytes, one box. A bf16 stage is 32 KB, so the
//     ring is three deep: two CTAs fit an SM (in shared memory; in
//     registers up to a group of 5, kMinBlocks), and qwen3-14b's
//     4096-key launch (256 CTAs) runs in one wave;
//   * eight consumer warps take 8 keys each of every tile, on the CUDA
//     cores (g <= 8 query rows give the tensor cores nothing to do): four
//     lanes a key dot its K row (32 dims each, 16-byte loads from the
//     swizzled tile: the eight keys of a quarter-warp lie on the eight
//     rows of a swizzle atom, so no bank conflict) with the g query rows
//     held in shared memory as float, pre-scaled by scale * log2(e); the
//     softmax statistics are float32 warp shuffles in the log2 domain; for
//     P V each lane owns four of the 128 output columns and reads one
//     8-byte (bf16) or 4-byte (int8) word of each staged V row, a
//     half-warp covering one 128-byte line, the probabilities broadcast by
//     shuffle. The kernel is instantiated for each group g from 1 to 8, so
//     no lane computes a row that does not exist (qwen3-14b's 5, yi-34b's
//     7, qwen3-32b's 8);
//   * int8 pools are dequantized in registers: K's scale multiplies the
//     score, V's is folded into the probability (the row sum l takes the
//     unscaled one);
//   * blocks past the context are never loaded and no key at or past ctx
//     is read, so the NaN-poisoned null block behind a dead table slot
//     never reaches a score; a lane at ctx 0 loads nothing and writes
//     exact zeros;
//   * the warps' (m, l, acc) merge through shared memory at the end; the
//     splits' through the workspace, in split order (bitwise repeatable);
//   * the fused entry point writes each lane's new K/V row first, as
//     paged_decode_tma.cu does: in the CTA of the last live split, the
//     producer warp writes the K and V rows (half a warp each, eight
//     elements a lane) once the ring is full, before it loads its last
//     tile, the one holding that slot.
#include "paged_tma.cuh"

namespace paged_tma128 {

using namespace paged_tma;

constexpr int D = 128;
constexpr int NS = 3;                     // ring stages
constexpr int kWarps = 8;                 // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr int KPW = KT / kWarps;          // keys a warp takes of a tile
constexpr int LPK = 32 / KPW;             // lanes a key
constexpr int DPL = D / LPK;              // dims a lane
constexpr int kQStride = D / 32 * 36;     // floats a query row (4 x 36)
static_assert(NS <= STAGES, "the ring's barriers and scale rows");

template <typename KVT, int G>
struct DecodeSmem {
  Stage<KVT, D> ring[NS];
  Scales scales;
  Ring r;
  alignas(16) float q[G * kQStride];   // row r, dim d: q_index(r, d)
  float wm[kWarps][G], wl[kWarps][G];
  int flag;
};
static_assert(sizeof(float) * kWarps * 8 * D <=
                  sizeof(Stage<int8_t, D>) * NS,
              "the ring holds the warps' partial sums");

// Where one query row's element d sits in the padded layout.
__device__ __forceinline__ int q_index(int r, int d) {
  return r * kQStride + (d >> 5) * 36 + (d & 31);
}

// Four bf16 or int8 values of one V word as floats.
__device__ __forceinline__ float4 word_floats(uint2 w, __nv_bfloat16) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 word_floats(uint2 w, int8_t) {
  const char4 c = *reinterpret_cast<const char4*>(&w.x);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

// Two CTAs an SM up to G = 5 (qwen3-14b's group; ptxas then holds a
// thread to 96 registers, spill-free); the larger groups' accumulators
// spill under that cap, so they take the registers they need.
template <int G>
constexpr int kMinBlocks = G <= 5 ? 2 : 1;

template <typename KVT, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
paged_decode_tma128_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tks,
                           const __grid_constant__ CUtensorMap tvs,
                           const __nv_bfloat16* __restrict__ q,
                           __nv_bfloat16* __restrict__ out,
                           const int* __restrict__ tables,
                           const int* __restrict__ ctx_lens,
                           float* __restrict__ ws, int* __restrict__ counters,
                           const __grid_constant__ Append ap, int Hq,
                           int Hkv, int NB, int bs, int T, int nsplit,
                           int split_keys, float scale_log2) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int ESZ = sizeof(KVT);
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DecodeSmem<KVT, G>*>(align1024(smem_raw));
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const bool append = ap.k != nullptr;     // key ctx_lens[b] is appended
  const int ctx = max(0, min(ctx_lens[b] + (append ? 1 : 0), T * bs));
  const int nlive = max(1, (ctx + split_keys - 1) / split_keys);
  if (sp >= nlive) return;                 // the whole CTA: nothing to see
  const bool writes = append && sp == nlive - 1;
  Walk w;
  w.table = tables + (size_t)b * T;
  w.lo = sp * split_keys;
  w.kend = min(ctx, w.lo + split_keys);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_ring(s.r, kWarps);
  const int ids = warp == kWarps ? first_ids(w, bs) : 0;
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = threadIdx.x; e < G * D; e += kConsumers) {
    if (warp == kWarps) break;
    s.q[q_index(e / D, e % D)] = __bfloat162float(qh[e]) * scale_log2;
  }
  __syncthreads();

  if (warp == kWarps) {                    // the producer warp
    produce<KVT, D, NS>(s.ring, &s.scales, s.r, tk, tv, tks, tvs, w, bs,
                        h * NB, ids, writes ? &ap : nullptr, h, b, NB);
    return;
  }

  // ---- consumers: warp w takes keys KPW w .. KPW w + KPW - 1 of every
  // tile, LPK lanes a key
  const int kk = KPW * warp + lane % KPW;  // this lane's key in the tile
  const int seg = lane / KPW;              // its dims: DPL seg + 0..DPL-1
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int t = 0; t < w.tiles(); ++t) {
    const int st = t % NS;
    mbar_wait(&s.r.full[st], (t / NS) & 1);
    const int nv = min(KT, w.kend - (w.lo + t * KT));   // live keys
    const unsigned char* kt = s.ring[st].k;
    const unsigned char* vt = s.ring[st].v;
    // s = q . k over this lane's DPL dims, summed over the key's lanes
    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) sc[r] = 0.f;
    if (kk < nv) {
      constexpr int kChunks = DPL * ESZ / 16;   // 16-byte chunks a lane
      constexpr int kPer = 16 / ESZ;            // values in a chunk
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kt + tile_off<KVT, D>(kk, seg * DPL * ESZ + 16 * c));
        float kf[kPer];
        chunk_floats(raw, kf, KVT{});
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float* qr = s.q + q_index(r, seg * DPL + c * kPer);
#pragma unroll
          for (int i = 0; i < kPer; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + i);
            sc[r] = fmaf(qv.x, kf[i], sc[r]);
            sc[r] = fmaf(qv.y, kf[i + 1], sc[r]);
            sc[r] = fmaf(qv.z, kf[i + 2], sc[r]);
            sc[r] = fmaf(qv.w, kf[i + 3], sc[r]);
          }
        }
      }
    }
    float ksc = 1.f, vsc = 1.f;
    if (kInt8 && kk < nv) {
      ksc = s.scales.k[st][scale_index(kk, bs)];
      vsc = s.scales.v[st][scale_index(kk, bs)];
    }
    // this lane's V words (columns 4 lane .. 4 lane + 3) of the warp's
    // live keys, loaded before the softmax so that the loads are
    // independent of it and of each other; zeros past the live keys,
    // whose p is 0
    const int nw = min(KPW, max(0, nv - KPW * warp));
    uint2 vw[KPW];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      vw[j] = make_uint2(0u, 0u);
      if (j < nw) {
        const unsigned char* at =
            vt + tile_off<KVT, D>(KPW * warp + j, 4 * ESZ * lane);
        if (kInt8)
          vw[j].x = *reinterpret_cast<const uint32_t*>(at);
        else
          vw[j] = *reinterpret_cast<const uint2*>(at);
      }
    }
    float p[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float x = sc[r];
#pragma unroll
      for (int o = KPW; o < 32; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      x = kk < nv ? x * ksc : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = KPW / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = ex2(m[r] - m_new);
      float pr = ex2(x - m_new);             // masked: 2^-inf = 0
      float sum = pr;
#pragma unroll
      for (int o = KPW / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= corr;
      p[r] = pr * vsc;
    }
    // acc += p v over the warp's keys, key by key
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const float4 vf = word_floats(vw[j], KVT{});
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
        acc[r][0] = fmaf(pj, vf.x, acc[r][0]);
        acc[r][1] = fmaf(pj, vf.y, acc[r][1]);
        acc[r][2] = fmaf(pj, vf.z, acc[r][2]);
        acc[r][3] = fmaf(pj, vf.w, acc[r][3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.r.empty[st]);
  }

  // ---- the warps' (m, l, acc) -> the CTA's, through shared memory (the
  // ring is free: every tile has been waited for and consumed)
  consumers_sync<kConsumers>();
  float* wacc = reinterpret_cast<float*>(s.ring[0].k);   // [warp][G][128]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      s.wm[warp][r] = m[r];
      s.wl[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < G; ++r)
    *reinterpret_cast<float4*>(wacc + (warp * G + r) * D + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  consumers_sync<kConsumers>();
  const size_t head = (size_t)b * Hkv + h;
  const int stride = partial_floats<D>(G);
  float* part = ws + (head * nsplit + sp) * (size_t)stride;
  for (int e = threadIdx.x; e < G * D; e += kConsumers) {
    const int r = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, s.wm[i][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float f = ex2(s.wm[i][r] - mx);
      lsum += s.wl[i][r] * f;
      a += wacc[(i * G + r) * D + d] * f;
    }
    if (nlive == 1) {          // ctx 0: l = acc = 0, and 0 / 1e-30 = 0
      out[((size_t)b * Hq + (size_t)h * G) * D + e] =
          __float2bfloat16_rn(a / fmaxf(lsum, 1e-30f));
    } else {
      part[e] = a;
      if (d == 0) {
        part[G * D + r] = mx;
        part[G * D + G + r] = lsum;
      }
    }
  }
  if (nlive == 1) return;
  if (!arrive_last<kConsumers>(counters + head, nlive, &s.flag)) return;
  // the ring again serves as scratch: wacc has been read
  merge_partials<kConsumers, D>(ws + head * nsplit * (size_t)stride, nlive,
                                stride, G, G,
                                reinterpret_cast<float*>(s.ring[0].k),
                                out + ((size_t)b * Hq + (size_t)h * G) * D);
  if (threadIdx.x == 0) counters[head] = 0;   // ready for the next launch
}

template <typename KVT, int G>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* tables,
                  const int* ctx, void* out, float* ws, int* counters,
                  const Append& ap, int B, int Hq, int Hkv, int NB, int bs,
                  int T, int nsplit, int split_keys, float scale,
                  cudaStream_t stream) {
  Maps m;
  cudaError_t err = pool_maps(&m, sizeof(KVT) == 1, k, v, ks, vs, Hkv * NB,
                              bs, D);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(DecodeSmem<KVT, G>) + 1024;   // + alignment
  auto kernel = paged_decode_tma128_kernel<KVT, G>;
  static bool opted_in = false;
  err = opt_in_smem(kernel, smem, &opted_in);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hkv, B, nsplit), kThreads, smem, stream>>>(
      m.k, m.v, m.ks, m.vs, (const __nv_bfloat16*)q, (__nv_bfloat16*)out,
      tables, ctx, ws, counters, ap, Hq, Hkv, NB, bs, T, nsplit, split_keys,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename KVT>
static int launch_g(int g, const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, const int* tables,
                    const int* ctx, void* out, float* ws, int* counters,
                    const Append& ap, int B, int Hq, int Hkv, int NB, int bs,
                    int T, int nsplit, int split_keys, float scale,
                    cudaStream_t st) {
#define PAGED_DECODE128_LAUNCH(GG)                                         \
  case GG:                                                                 \
    return launch<KVT, GG>(q, k, v, ks, vs, tables, ctx, out, ws,          \
                           counters, ap, B, Hq, Hkv, NB, bs, T, nsplit,    \
                           split_keys, scale, st)
  switch (g) {
    PAGED_DECODE128_LAUNCH(1);
    PAGED_DECODE128_LAUNCH(2);
    PAGED_DECODE128_LAUNCH(3);
    PAGED_DECODE128_LAUNCH(4);
    PAGED_DECODE128_LAUNCH(5);
    PAGED_DECODE128_LAUNCH(6);
    PAGED_DECODE128_LAUNCH(7);
    PAGED_DECODE128_LAUNCH(8);
  }
#undef PAGED_DECODE128_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged_tma128

// q: [B, Hq, 128] bf16; k/v: [Hkv, NB, bs, 128] bf16 (kv_dtype 1) or int8
// (kv_dtype 2) with ks/vs [Hkv, NB, bs, 1] float32; tables: [B, T] int32;
// ctx: [B] int32; out: [B, Hq, 128] bf16; all 16-byte aligned. Hq / Hkv
// <= 8; bs in {8, 16, 32, 64} (int8: 16, 32, 64). nsplit (<= 64) CTAs a
// (lane, KV head) over split_keys keys each (a multiple of 64); above one
// split, ws holds B * Hkv * nsplit * partial_floats<128>(g) floats and
// counters B * Hkv int32 zeros (left zero). krow .. vsn: the fused
// append, as paged_decode_attention_tma takes it (krow null: none; the
// strides multiples of 8, krow and vrow 16-byte aligned).
// Returns cudaGetLastError() of the launch.
extern "C" int paged_decode_attention_tma128(
    int kv_dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* tables, const int* ctx,
    void* out, float* ws, int* counters, const void* krow,
    const void* vrow, const void* phys, const void* off, int idx64,
    long long ksp, long long ksn, long long vsp, long long vsn,
    int B, int Hq, int Hkv, int NB, int bs, int T, int nsplit,
    int split_keys, float scale, void* stream) {
  using namespace paged_tma;
  cudaStream_t st = (cudaStream_t)stream;
  const int g = Hq / Hkv;
  const bool ok_split = split_keys % KT == 0 && nsplit <= MAX_SPLITS &&
                        (nsplit == 1 || (ws != nullptr && counters));
  const bool ok_rows = krow == nullptr ||
                       (vrow != nullptr && phys != nullptr && off != nullptr);
  if (g < 1 || g > 8 || Hq % Hkv != 0 || KT % bs != 0 || !ok_split ||
      !ok_rows)
    return (int)cudaErrorInvalidValue;
  const Append ap{krow, vrow, phys, off, const_cast<void*>(k),
                  const_cast<void*>(v), const_cast<float*>(ks),
                  const_cast<float*>(vs), ksp, ksn, vsp, vsn, idx64};
  if (kv_dtype == paged::kBF16 && bs % 8 == 0)
    return paged_tma128::launch_g<__nv_bfloat16>(
        g, q, k, v, ks, vs, tables, ctx, out, ws, counters, ap, B, Hq, Hkv,
        NB, bs, T, nsplit, split_keys, scale, st);
  if (kv_dtype == paged::kI8 && bs % 16 == 0)
    return paged_tma128::launch_g<int8_t>(
        g, q, k, v, ks, vs, tables, ctx, out, ws, counters, ap, B, Hq, Hkv,
        NB, bs, T, nsplit, split_keys, scale, st);
  return (int)cudaErrorInvalidValue;
}
