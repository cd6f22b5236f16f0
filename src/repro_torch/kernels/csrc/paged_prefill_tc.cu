// Chunked paged prefill attention on Hopper's tensor cores (sm_90a): bf16
// q over bf16 or int8 pools at head_dim 64, blocks loaded by TMA, keys
// split over CTAs, S = Q K^T and O += P V on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_prefill_attention (body _paged_prefill_kernel) on the route the
// serving path runs; paged_prefill.cu keeps float32 q and the shapes this
// kernel does not take (kernels/ops.py :: paged_route). The query chunk
// [Hq, C, 64] is read as its group-major view [Hkv, G*C, 64] (query head
// h = kv_head * G + gi), so row r of KV head h sits at absolute position
// q_offset + r % C; the causal mask comes from those positions and ctx.
//
// Numerics: S takes bf16 operands with float32 accumulation; int8 blocks
// are converted to bf16 in shared memory (exact), K's row scale then
// multiplies S's columns; the online softmax is float32 in the log2
// domain; the row sum l is taken from the float32 P without V's scale.
// P (with V's row scale folded in for int8 pools) enters the P V product,
// which accumulates in float32, in one of two ways (template kSplitP):
//   * a prefill chunk rounds it once to bf16 (2^-9 of itself);
//   * the batched verify splits it into bf16 hi = bf16(p) and lo =
//     bf16(p - hi) and runs two products into the same accumulator, lo's
//     first, carrying p to about 2^-16 of itself: the paged decode kernel,
//     which computes the same rows one at a time, keeps P in float32 on
//     the CUDA cores, as both of the reference's Pallas kernels do
//     (dot(p, v.astype(float32))), so a verify row lands within a bf16
//     ulp of the decode step's instead of a bf16 rounding of P away,
//     but for elements that cancel toward 0, where the two kernels'
//     orders of summation part them by a few ulps (the card checks hold
//     them to ref.verify_decode_gap_bound). The second product doubles P V's tensor-core work, which the launch
//     latency of the verify shape hides.
//
// What bounds it on an H100: the bytes of K/V read. At the serving shape
// (a 16-row chunk of 16 query heads, up to 128 keys) the launch and the
// latency of the loads do; at 4096 keys the 8.4 MB of bf16 K/V.
//
// What the design does about it (the ring and the splits are in
// paged_tma.cuh):
//   * one CTA per (KV head, key split, 64-row tile of the group's G*C
//     rows) holds all of a GQA group's rows (32 at flad-adllm's G 2, C 16),
//     so each K/V block is read once per KV head and split, not once per
//     8-row tile; splits of split_keys keys fill the card at long
//     contexts, the serving shape runs one split and merges nothing;
//   * the queries are M, the keys N: S = Q K^T is a 64 x 64 x 64 wgmma
//     from shared memory (Q written there swizzled by the consumers, K as
//     TMA landed it), P stays in registers as the A operand of O += P V
//     with V read MN-major, as in flash_fwd_tc.cu. With 32 real rows half
//     of each product is padding: the tensor cores are idle either way,
//     and this keeps the proven fragment layout (mma.sync m16n8k16 with
//     32-row M would need no padding, but a second fragment scheme);
//   * a producer warp keeps whole blocks in flight by TMA through the
//     table slice; the four consumer warps form the warpgroup;
//   * rows of V at or past ctx (a block's tail) are zeroed in shared
//     memory before P V reads them, and blocks past ctx are never loaded.
//
// The speculative decoder's batched verify is this kernel with the lanes
// as a grid axis: blockIdx.z is lane b's row tile, and a CTA of lane b
// takes the lane's table row, its q_offset (lane_ctx[b], the context
// before its draft window) and ctx (q_offset + lane_len[b]) from device
// memory; everything else (the Walk of paged_tma.cuh, the split plan, the
// merge) is per (lane, KV head, row tile) as it is per (KV head, row tile)
// for one chunk, which is one lane with null lane arrays. A verify window
// is k + 1 rows, so a lane's G * (k + 1) rows fill a fraction of its
// 64-row tile: one launch for all lanes instead of one a lane.
#include "paged_tma.cuh"

namespace paged_tma {

constexpr int BQ = 64;                    // query rows of a CTA (wgmma M)
constexpr int kPrefillThreads = 128 + 32;

template <typename KVT>
struct PrefillSmem {
  alignas(1024) __nv_bfloat16 q[BQ * D];
  Stage<KVT> ring[STAGES];
  // int8 pools: the current tile's K and V as bf16 (swizzled like TMA's)
  alignas(1024) unsigned char conv[sizeof(KVT) == 1 ? 2 * KT * D * 2 : 16];
  Scales scales;
  float ksc[KT], vsc[KT];      // int8: the current tile's row scales
  Ring r;
  int flag;
};

// Convert one tile of int8 rows (64 bytes a key, swizzled as TMA wrote
// the [bs / 2, 128] boxes) into bf16 rows (128 bytes a key, swizzled);
// keys at or past nv become zeros.
__device__ __forceinline__ void int8_tile_to_bf16(const unsigned char* src,
                                                  unsigned char* dst,
                                                  int nv) {
  for (int i = threadIdx.x; i < KT * 4; i += 128) {
    const int k = i >> 2, c = i & 3;          // key, 16-byte int8 chunk
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (k < nv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + swizzle128(k * 64 + 16 * c));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[j] = pack_bf16((float)b[2 * j], (float)b[2 * j + 1]);
        h[j] = pack_bf16((float)b[8 + 2 * j], (float)b[9 + 2 * j]);
      }
    }
    *reinterpret_cast<uint4*>(dst + swizzle128(k * 128 + 32 * c)) = lo;
    *reinterpret_cast<uint4*>(dst + swizzle128(k * 128 + 32 * c + 16)) = hi;
  }
}

template <typename KVT, bool kSplitP>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tks,
                           const __grid_constant__ CUtensorMap tvs,
                           const __nv_bfloat16* __restrict__ q_all,
                           __nv_bfloat16* __restrict__ out_all,
                           const int* __restrict__ tables,
                           const int* __restrict__ lane_ctx,
                           const int* __restrict__ lane_len,
                           float* __restrict__ ws, int* __restrict__ counters,
                           int Hq, int Hkv, int NB, int bs, int T, int C,
                           int q_offset, int ctx, int nrt, int split_keys,
                           float scale_log2) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<PrefillSmem<KVT>*>(align1024(smem_raw));
  const int h = blockIdx.x, sp = blockIdx.y;
  const int b = blockIdx.z / nrt, rt = blockIdx.z % nrt;   // lane, tile
  const int nsplit = gridDim.y;
  const int R = (Hq / Hkv) * C;             // the group's query rows
  if (lane_ctx != nullptr) {                // the batched verify
    q_offset = lane_ctx[b];
    ctx = q_offset + lane_len[b];
  }
  const size_t lane_rows = (size_t)b * Hq * C;   // rows of earlier lanes
  const __nv_bfloat16* q = q_all + lane_rows * D;
  __nv_bfloat16* out = out_all + lane_rows * D;
  // the per-lane arguments, in one place: the table row, q_offset, ctx
  Walk w;
  w.table = tables + (size_t)b * T;
  w.lo = sp * split_keys;
  w.kend = min(min(ctx, T * bs), w.lo + split_keys);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) init_ring(s.r, 4);
  const int ids = warp == 4 ? first_ids(w, bs) : 0;
  __syncthreads();
  if (warp == 4) {                          // the producer warp
    produce<KVT>(s.ring, &s.scales, s.r, tk, tv, tks, tvs, w, bs, h * NB,
                 ids);
    return;
  }

  // ---- the Q tile, swizzled as TMA would write it; padding rows zero
  const __nv_bfloat16* qh = q + ((size_t)h * R + (size_t)rt * BQ) * D;
  for (int i = threadIdx.x; i < BQ * 8; i += 128) {
    const int row = i >> 3, c = i & 7;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (rt * BQ + row < R)
      val = *reinterpret_cast<const uint4*>(qh + row * D + 8 * c);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(s.q) +
                              swizzle128(row * 128 + 16 * c)) = val;
  }
  fence_proxy_async();
  consumers_sync();

  const int c_lo = 2 * (lane % 4);              // + 8j + {0, 1}
  const int row0 = 16 * warp + lane / 4;        // and row0 + 8
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    pos[hh] = q_offset + (rt * BQ + row0 + 8 * hh) % C;
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < w.tiles(); ++t) {
    const int st = t % STAGES;
    const int tile_lo = w.lo + t * KT;
    const int nv = min(KT, w.kend - tile_lo);
    mbar_wait(&s.r.full[st], (t / STAGES) & 1);
    const void* kt = s.ring[st].k;
    const __nv_bfloat16* vt =
        reinterpret_cast<const __nv_bfloat16*>(s.ring[st].v);
    if constexpr (kInt8) {
      consumers_sync();              // the last tile's P V read conv
      int8_tile_to_bf16(s.ring[st].k, s.conv, nv);
      int8_tile_to_bf16(s.ring[st].v, s.conv + KT * D * 2, nv);
      if (threadIdx.x < KT) {
        const int k = threadIdx.x;
        s.ksc[k] = k < nv ? s.scales.k[st][scale_index(k, bs)] : 0.f;
        s.vsc[k] = k < nv ? s.scales.v[st][scale_index(k, bs)] : 0.f;
      }
      fence_proxy_async();
      consumers_sync();
      if (lane == 0) mbar_arrive(&s.r.empty[st]);   // the raw stage is free
      kt = s.conv;
      vt = reinterpret_cast<const __nv_bfloat16*>(s.conv + KT * D * 2);
    } else {
      if (nv < KT) {                 // zero V's rows at or past ctx
        unsigned char* v = s.ring[st].v;
        for (int i = nv * 8 + threadIdx.x; i < KT * 8; i += 128)
          *reinterpret_cast<uint4*>(v + 16 * i) = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        consumers_sync();
      }
    }
    float sc[32];
    wgmma_fence();
    mma_ss_k64(sc, s.q, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // mask (keys past ctx or past the row's position), K's int8 scale
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 8 * (x >> 2) + c_lo + (x & 1);
      const bool ok = col < nv && tile_lo + col <= pos[(x >> 1) & 1];
      const float v = kInt8 ? sc[x] * s.ksc[col] : sc[x];
      sc[x] = ok ? v : -INFINITY;
    }
    float corr[2], part[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx * scale_log2);   // scale > 0
      corr[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1;
      const float p = ex2(fmaf(sc[x], scale_log2, -m[hh]));   // masked: 0
      part[hh] += p;
      sc[x] = kInt8 ? p * s.vsc[8 * (x >> 2) + c_lo + (x & 1)] : p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + part[hh];
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] *= corr[(x >> 1) & 1];
    if constexpr (kSplitP) {
      uint32_t ph[4][4], pl[4][4];
      pack_frag_split(ph, pl, sc);
      wgmma_fence();
      mma_rs_k64(acc, pl, vt);
      mma_rs_k64(acc, ph, vt);
    } else {
      uint32_t pa[4][4];
      pack_frag(pa, sc);
      wgmma_fence();
      mma_rs_k64(acc, pa, vt);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (!kInt8 && lane == 0) mbar_arrive(&s.r.empty[st]);
  }

  // ---- the CTA's rows: written, or (several splits) merged in order
  float lt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lt[hh] = l[hh];
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 1);
    lt[hh] += __shfl_xor_sync(0xffffffffu, lt[hh], 2);
  }
  const size_t tile = ((size_t)b * Hkv + h) * nrt + rt;
  constexpr int kPart = BQ * (D + 2);           // floats of a partial
  const int live_rows = min(BQ, R - rt * BQ);
  __nv_bfloat16* orows = out + ((size_t)h * R + (size_t)rt * BQ) * D;
  if (nsplit == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= live_rows) continue;
      const float lc = fmaxf(lt[hh], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orows + row * D + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / lc,
                                  acc[4 * j + 2 * hh + 1] / lc);
    }
    return;
  }
  float* part = ws + (tile * nsplit + sp) * kPart;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(part + row * D + 8 * j + c_lo) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    if (lane % 4 == 0) {
      part[BQ * D + row] = m[hh];
      part[BQ * D + BQ + row] = lt[hh];
    }
  }
  if (!arrive_last(counters + tile, nsplit, &s.flag)) return;
  // the ring serves as scratch: every tile has been consumed
  merge_partials(ws + tile * nsplit * kPart, nsplit, kPart, BQ, live_rows,
                 reinterpret_cast<float*>(s.ring[0].k), orows);
  if (threadIdx.x == 0) counters[tile] = 0;   // ready for the next launch
}

// B lanes (lane_ctx / lane_len null for one prefill chunk, B = 1).
template <typename KVT, bool kSplitP>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* lane_ctx, const int* lane_len, void* out,
                  float* ws, int* counters, int B, int Hq, int Hkv, int NB,
                  int bs, int T, int C, int q_offset, int ctx, int nsplit,
                  int split_keys, float scale, cudaStream_t stream) {
  Maps m;
  cudaError_t err = pool_maps(&m, sizeof(KVT) == 1, k, v, ks, vs, Hkv * NB,
                              bs);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(PrefillSmem<KVT>) + 1024;   // + alignment
  auto kernel = paged_prefill_wgmma_kernel<KVT, kSplitP>;
  static bool opted_in = false;
  err = opt_in_smem(kernel, smem, &opted_in);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hq / Hkv) * C + BQ - 1) / BQ;
  kernel<<<dim3(Hkv, nsplit, tiles * B), kPrefillThreads, smem, stream>>>(
      m.k, m.v, m.ks, m.vs, (const __nv_bfloat16*)q, (__nv_bfloat16*)out,
      table, lane_ctx, lane_len, ws, counters, Hq, Hkv, NB, bs, T, C,
      q_offset, ctx, tiles, split_keys, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace paged_tma

// B lanes of q: [B, Hq, C, 64] bf16; k/v: [Hkv, NB, bs, 64] bf16 (kv_dtype
// 1) or int8 (kv_dtype 2) with ks/vs [Hkv, NB, bs, 1] float32; tables: [B,
// T] int32; out: [B, Hq, C, 64] bf16; all 16-byte aligned. Lane b's chunk
// covers positions [q_offset, ctx): with lane_ctx / lane_len null (one
// prefill chunk, B = 1) the two scalars, else lane_ctx[b] and lane_ctx[b]
// + lane_len[b], [B] int32 on the device (the batched verify, each
// window's own K/V already in the pools). Rows at or past a lane's chunk
// length are finite garbage; a lane with ctx 0 gets zeros. bs in {8, 16,
// 32, 64} (int8: 16, 32, 64). nsplit (<= 64) CTAs a (lane, KV head, row
// tile) over split_keys keys each (a multiple of 64) must cover the keys:
// min(ctx, T * bs) for one chunk, T * bs for lanes (their windows live on
// the device); above one split, ws holds B * Hkv * tiles * nsplit * 64 *
// 66 floats and counters B * Hkv * tiles int32 zeros (left zero), tiles =
// ceil(Hq / Hkv * C / 64). split_p 1 carries P into P V as two bf16
// parts (the verify's route), 0 rounds it once (a prefill chunk's).
// Returns cudaGetLastError() of the launch.
extern "C" int paged_prefill_attention_tc(
    int kv_dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* tables, const int* lane_ctx,
    const int* lane_len, void* out, float* ws, int* counters, int B, int Hq,
    int Hkv, int NB, int bs, int T, int C, int q_offset, int ctx, int nsplit,
    int split_keys, int split_p, float scale, void* stream) {
  using namespace paged_tma;
  cudaStream_t st = (cudaStream_t)stream;
  const bool lanes = lane_ctx != nullptr;
  const int keys = lanes ? T * bs : min(ctx, T * bs);
  const bool ok = B >= 1 && lanes == (lane_len != nullptr) &&
                  (lanes || B == 1) && split_keys % KT == 0 &&
                  nsplit <= MAX_SPLITS && KT % bs == 0 && keys > 0 &&
                  (long long)nsplit * split_keys >= keys &&
                  (long long)(nsplit - 1) * split_keys < keys &&
                  (nsplit == 1 || (ws != nullptr && counters != nullptr)) &&
                  (split_p == 0 || split_p == 1);
  if (!ok) return (int)cudaErrorInvalidValue;
#define PAGED_PREFILL_TC(KVT, SPLIT)                                        \
  launch<KVT, SPLIT>(q, k, v, ks, vs, tables, lane_ctx, lane_len, out, ws, \
                     counters, B, Hq, Hkv, NB, bs, T, C, q_offset, ctx,    \
                     nsplit, split_keys, scale, st)
  if (kv_dtype == paged::kBF16 && bs % 8 == 0)
    return split_p ? PAGED_PREFILL_TC(__nv_bfloat16, true)
                   : PAGED_PREFILL_TC(__nv_bfloat16, false);
  if (kv_dtype == paged::kI8 && bs % 16 == 0)
    return split_p ? PAGED_PREFILL_TC(int8_t, true)
                   : PAGED_PREFILL_TC(int8_t, false);
#undef PAGED_PREFILL_TC
  return (int)cudaErrorInvalidValue;
}
