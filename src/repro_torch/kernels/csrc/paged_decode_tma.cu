// Paged single-token decode attention for Hopper (sm_90a): bf16 q over
// bf16 or int8 pools at head_dim 64, blocks loaded by TMA, keys split over
// CTAs.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_decode_attention (body _paged_decode_kernel) on the route the
// serving path runs; paged_decode.cu keeps float32 q and the shapes this
// kernel does not take (kernels/ops.py :: paged_route).
//
// What bounds it on an H100: the bytes of K/V read (2 * ctx * 64 elements
// per lane and KV head, 4 * g * 64 flops a key: far below the ridge). At
// serving sizes a call moves a few hundred KB and the launch and the
// chain of dependent loads bound it; at long contexts (8 lanes at 4096
// keys: 67 MB of bf16 K/V) the memory rate does.
//
// What the design does about it (the ring and the splits are in
// paged_tma.cuh):
//   * the grid is (KV head, lane, split): a lane's keys are split in runs
//     of split_keys over CTAs, so a long context fills the card; the split
//     count comes from the table width on the host (ctx_lens lives on the
//     device), and a CTA whose split lies past its lane's ctx exits at
//     once; the serving shape (128-key tables) has one split, so each CTA
//     writes its output with no merge;
//   * a producer warp reads the split's table slice once and keeps whole
//     K/V blocks (and int8 scales) in flight by TMA, STAGES tiles of 64
//     keys: no load waits on a table lookup, no thread spends registers
//     on a copy;
//   * four consumer warps take 16 keys each of every tile, on the CUDA
//     cores (g <= 8 query rows give the tensor cores nothing to do): two
//     lanes a key dot its K row (32 dims each, 16-byte loads from the
//     swizzled tile, conflict-free) with the g query rows held in shared
//     memory as float, pre-scaled by scale * log2(e); the softmax
//     statistics are float32 warp shuffles in the log2 domain; for P V
//     each lane owns two of the 64 output columns and reads one 4-byte
//     word of each staged V row, the probabilities broadcast by shuffle;
//   * int8 pools are dequantized in registers: K's scale multiplies the
//     score, V's is folded into the probability (the row sum l takes the
//     unscaled one);
//   * the warps' (m, l, acc) merge through shared memory at the end; the
//     splits' through the workspace, in split order (bitwise repeatable);
//   * a serving decode step appends each lane's new K/V row before it
//     attends over ctx + 1 keys, and the kernel does that write itself
//     (the fused entry point; it folds kv_append_int8.cu's launch, or a
//     bf16 cache's two scatters, into the decode's): the one CTA whose
//     split holds key ctx of its (lane, KV head), the last live split,
//     is that slot's only reader. Its producer warp writes the K and V
//     rows, half a warp each (paged_tma.cuh :: append_rows: int8 pools
//     quantized bitwise as kv_append_int8.cu does, bf16 pools copied), and
//     fences them for the async proxy once the ring is full, before it
//     loads the last tile, the one holding the slot: the tiles before it
//     are in flight meanwhile and no consumer warp waits on the write.
//     The other CTAs run as the plain decode does.
#include "paged_tma.cuh"

namespace paged_tma {

constexpr int kWarps = 4;                 // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr int KPW = KT / kWarps;          // keys a warp takes of a tile
constexpr int LPK = 32 / KPW;             // lanes a key
constexpr int DPL = D / LPK;              // dims a lane
constexpr int kQStride = 72;              // floats a query row (2 x 36)

template <typename KVT, int G>
struct DecodeSmem {
  Stage<KVT> ring[STAGES];
  Scales scales;
  Ring r;
  alignas(16) float q[G * kQStride];   // row r, dim d: q_index(r, d)
  float wm[kWarps][G], wl[kWarps][G];
  int flag;
};

// Read one query row's element d of the padded layout.
__device__ __forceinline__ int q_index(int r, int d) {
  return r * kQStride + (d >> 5) * 36 + (d & 31);
}

template <typename KVT, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_tma_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tks,
                        const __grid_constant__ CUtensorMap tvs,
                        const __nv_bfloat16* __restrict__ q,
                        __nv_bfloat16* __restrict__ out,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens,
                        float* __restrict__ ws, int* __restrict__ counters,
                        const __grid_constant__ Append ap, int Hq, int Hkv,
                        int NB, int bs, int T, int nsplit, int split_keys,
                        float scale_log2) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int ESZ = sizeof(KVT);
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DecodeSmem<KVT, G>*>(align1024(smem_raw));
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int g = Hq / Hkv;
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
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * g) * D;
  for (int e = threadIdx.x; e < G * D; e += kConsumers) {
    if (warp == kWarps) break;
    const int r = e / D, d = e % D;
    s.q[q_index(r, d)] =
        r < g ? __bfloat162float(qh[r * D + d]) * scale_log2 : 0.f;
  }
  __syncthreads();

  if (warp == kWarps) {                    // the producer warp
    produce<KVT>(s.ring, &s.scales, s.r, tk, tv, tks, tvs, w, bs, h * NB,
                 ids, writes ? &ap : nullptr, h, b, NB);
    return;
  }

  // ---- consumers: warp w takes keys KPW w .. KPW w + KPW - 1 of every
  // tile, LPK lanes a key
  const int kk = KPW * warp + lane % KPW;  // this lane's key in the tile
  const int seg = lane / KPW;              // its dims: DPL seg + 0..DPL-1
  float m[G], l[G], acc[G][2];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }
  for (int t = 0; t < w.tiles(); ++t) {
    const int st = t % STAGES;
    mbar_wait(&s.r.full[st], (t / STAGES) & 1);
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
        const uint32_t off = kk * D * ESZ + seg * DPL * ESZ + 16 * c;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kt + swizzle128(off));
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
      acc[r][0] *= corr;
      acc[r][1] *= corr;
      p[r] = pr * vsc;
    }
    // acc += p v over this warp's live keys; this lane's columns 2 lane +
    // 0..1. All KPW V words are loaded first (zeros past the live keys,
    // whose p is 0), so the loads are independent of each other and of
    // the FMAs.
    const int nw = min(KPW, max(0, nv - KPW * warp));
    float vv[KPW][2];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      vv[j][0] = vv[j][1] = 0.f;
      if (j < nw) {
        const int key = KPW * warp + j;
        if (kInt8) {
          const char2 raw = *reinterpret_cast<const char2*>(
              vt + swizzle128(key * D + 2 * lane));
          vv[j][0] = static_cast<float>(raw.x);
          vv[j][1] = static_cast<float>(raw.y);
        } else {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  vt + swizzle128(key * D * 2 + 4 * lane)));
          vv[j][0] = f.x;
          vv[j][1] = f.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
        acc[r][0] = fmaf(pj, vv[j][0], acc[r][0]);
        acc[r][1] = fmaf(pj, vv[j][1], acc[r][1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.r.empty[st]);
  }

  // ---- the warps' (m, l, acc) -> the CTA's, through shared memory (the
  // ring is free: every tile has been waited for and consumed)
  consumers_sync<kConsumers>();
  float* wacc = reinterpret_cast<float*>(s.ring[0].k);   // [warp][G][64]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      s.wm[warp][r] = m[r];
      s.wl[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < G; ++r) {
    wacc[(warp * G + r) * D + 2 * lane] = acc[r][0];
    wacc[(warp * G + r) * D + 2 * lane + 1] = acc[r][1];
  }
  consumers_sync<kConsumers>();
  const size_t head = (size_t)b * Hkv + h;
  const int stride = partial_floats(g);
  float* part = ws + (head * nsplit + sp) * (size_t)stride;
  for (int e = threadIdx.x; e < g * D; e += kConsumers) {
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
      out[((size_t)b * Hq + (size_t)h * g) * D + e] =
          __float2bfloat16_rn(a / fmaxf(lsum, 1e-30f));
    } else {
      part[e] = a;
      if (d == 0) {
        part[g * D + r] = mx;
        part[g * D + g + r] = lsum;
      }
    }
  }
  if (nlive == 1) return;
  if (!arrive_last<kConsumers>(counters + head, nlive, &s.flag)) return;
  // the ring again serves as scratch: wacc has been read
  merge_partials<kConsumers>(ws + head * nsplit * (size_t)stride, nlive,
                             stride, g, g,
                             reinterpret_cast<float*>(s.ring[0].k),
                             out + ((size_t)b * Hq + (size_t)h * g) * D);
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
                              bs);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(DecodeSmem<KVT, G>) + 1024;   // + alignment
  auto kernel = paged_decode_tma_kernel<KVT, G>;
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
#define PAGED_DECODE_LAUNCH(GG)                                            \
  return launch<KVT, GG>(q, k, v, ks, vs, tables, ctx, out, ws, counters, \
                         ap, B, Hq, Hkv, NB, bs, T, nsplit, split_keys,     \
                         scale, st)
  if (g <= 1) PAGED_DECODE_LAUNCH(1);
  if (g <= 2) PAGED_DECODE_LAUNCH(2);
  if (g <= 4) PAGED_DECODE_LAUNCH(4);
  PAGED_DECODE_LAUNCH(8);
#undef PAGED_DECODE_LAUNCH
}

}  // namespace paged_tma

// q: [B, Hq, 64] bf16; k/v: [Hkv, NB, bs, 64] bf16 (kv_dtype 1) or int8
// (kv_dtype 2) with ks/vs [Hkv, NB, bs, 1] float32; tables: [B, T] int32;
// ctx: [B] int32; out: [B, Hq, 64] bf16; all 16-byte aligned. Hq / Hkv
// <= 8; bs in {8, 16, 32, 64} (int8: 16, 32, 64). nsplit (<= 64) CTAs a
// (lane, KV head) over split_keys keys each (a multiple of 64); above one
// split, ws holds B * Hkv * nsplit * partial_floats(g) floats and counters
// B * Hkv int32 zeros (left zero). With krow non-null (the fused append),
// lane b first writes its bf16 rows krow/vrow (element (h, b, e) at h ksp
// + b ksn + e of K, V likewise; ksp, ksn, vsp, vsn multiples of 4 and
// krow, vrow 8-byte aligned)
// into slot (phys[b], off[b]) of each KV head's pools (and scales),
// phys/off [B] int64 when idx64, else int32, and then attends over
// ctx[b] + 1 keys.
// Returns cudaGetLastError() of the launch.
extern "C" int paged_decode_attention_tma(
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
  if (g < 1 || g > 8 || KT % bs != 0 || !ok_split || !ok_rows)
    return (int)cudaErrorInvalidValue;
  const Append ap{krow, vrow, phys, off, const_cast<void*>(k),
                  const_cast<void*>(v), const_cast<float*>(ks),
                  const_cast<float*>(vs), ksp, ksn, vsp, vsn, idx64};
  if (kv_dtype == paged::kBF16 && bs % 8 == 0)
    return launch_g<__nv_bfloat16>(g, q, k, v, ks, vs, tables, ctx, out, ws,
                                   counters, ap, B, Hq, Hkv, NB, bs, T,
                                   nsplit, split_keys, scale, st);
  if (kv_dtype == paged::kI8 && bs % 16 == 0)
    return launch_g<int8_t>(g, q, k, v, ks, vs, tables, ctx, out, ws,
                            counters, ap, B, Hq, Hkv, NB, bs, T, nsplit,
                            split_keys, scale, st);
  return (int)cudaErrorInvalidValue;
}
