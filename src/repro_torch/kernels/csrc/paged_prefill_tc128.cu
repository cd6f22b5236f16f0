// Chunked paged prefill attention on Hopper's tensor cores (sm_90a): bf16
// q over bf16 or int8 pools at head_dim 128, blocks loaded by TMA, keys
// split over CTAs, S = Q K^T and O += P V on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_prefill_attention (body _paged_prefill_kernel) at head_dim 128, the
// route the dense configs (qwen2.5-32b, qwen3-14b, qwen3-32b, yi-34b)
// serve on; paged_prefill_tc.cu keeps head_dim 64 and paged_prefill.cu
// float32 q and the shapes neither takes (kernels/ops.py :: paged_route).
// The query chunk [Hq, C, 128] is read as its group-major view [Hkv, G*C,
// 128] (query head h = kv_head * G + gi), so row r of KV head h sits at
// absolute position q_offset + r % C; the causal mask comes from those
// positions and ctx.
//
// Numerics are paged_prefill_tc.cu's: S takes bf16 operands with float32
// accumulation; int8 blocks are converted to bf16 in shared memory
// (exact), K's row scale then multiplies S's columns; the online softmax
// is float32 in the log2 domain; the row sum l is taken from the float32
// P without V's scale; P (with V's row scale folded in for int8 pools)
// enters P V as two bf16 parts (lo's product first: about 2^-16 of
// itself), for a prefill chunk as for the batched verify, where
// paged_prefill_tc.cu rounds a chunk's P once: at head_dim 128 one
// rounding put a qwen3-14b int8-cache prefill row past the serving
// checks' bound (2^-7 of the row's largest |value|), since an output row
// that averages many values of both signs is small against the V rows
// whose rounding error it carries. The accumulator is float32, written as
// bf16; splits merge in split order.
//
// What bounds it on an H100: each SM's tensor cores and issue slots, not
// the bytes. A 64-key tile is a 128 x 64 x 128 S, a 128 x 128 x 64 P V
// twice (P's two parts) and 8192 exponentials, the two warpgroups'
// products and softmax interleaved; over int8 pools the conversion of a
// stage leads. The bytes (16.8 MB of bf16 K/V at 4096 keys over eight KV
// heads: 5.0 us at 3.35 TB/s) would bound it only with the keys spread
// over far more SMs than a split plan of 128 CTAs reaches.
//
// What the design does about it (the ring and the splits are
// paged_tma.cuh's, at DD = 128):
//   * one CTA per (KV head, key split, 128-row tile of the group's G*C
//     rows): the dense configs' groups of 5, 7 and 8 at the serving chunk
//     of 16 are 80, 112 and 128 rows, one tile, so each K/V block is read
//     once per KV head and split (a 64-row tile would read every block
//     twice for 80 rows, its second tile 16/64 live);
//   * a CTA's 128-row products keep its SM's tensor cores busy, and a CTA
//     takes a whole SM (164 KB of shared memory), so past four tiles
//     kernels/ops.py splits the keys down to one 64-key tile a CTA, up to
//     128 CTAs a call (prefill_splits; up to four tiles one CTA takes them:
//     a split and its merge cost about as much); the merge reads 16
//     splits' partials at a time;
//   * two consumer warpgroups of 64 rows each behind one producer warp;
//     each computes S = Q K^T for its rows as a 64 x 64 x 128 wgmma from
//     shared memory (Q written there swizzled by the consumers, as two
//     64-column halves; K as TMA landed it, two boxes a bf16 block) and
//     O += P V as two m64n128 wgmmas a 16-key step (P's lo part, then its
//     hi part), P in registers and V read MN-major, its two halves LBO
//     apart. A warpgroup whose rows are
//     all past the group's (a verify window of G * (k + 1) <= 64 rows)
//     skips the products and only keeps the barriers;
//   * the producer warp keeps NS = 4 stages of 64 keys in flight (a bf16
//     stage is 32 KB, int8 16 KB). Over int8 pools three converter warps
//     (the producer's warpgroup) turn each stage into one of two bf16
//     buffers, by integer and bf16x2 ops, up to two tiles ahead of the
//     consumers, behind full/empty mbarriers of their own: the two
//     consumer warpgroups never wait for each other, so one's softmax
//     runs under the other's products, as over bf16 pools;
//   * rows of V at or past ctx (a block's tail) are zeroed in shared
//     memory before P V reads them (int8: the conversion writes zeros),
//     and blocks past ctx are never loaded, so the NaN-poisoned null block
//     never reaches an accumulator; a lane at ctx 0 loads nothing and
//     writes exact zeros.
//
// The speculative decoder's batched verify is this kernel with the lanes
// as a grid axis, as in paged_tma.cuh's Walk: blockIdx.z is lane b's row
// tile, and a CTA of lane b takes its table row, q_offset (lane_ctx[b])
// and ctx (q_offset + lane_len[b]) from device memory.
#include "paged_tma.cuh"

namespace paged_tc128 {

using namespace paged_tma;

constexpr int D = 128;
constexpr int NS = 4;                         // ring stages
constexpr int kGroups = 2;                    // consumer warpgroups
constexpr int BQ = 64 * kGroups;              // query rows of a CTA
constexpr int kConsumers = 128 * kGroups;
constexpr int kWarps = kConsumers / 32;       // consumer warps
// and a warpgroup of one producer warp (TMA) and kConvWarps warps that
// convert int8 stages to bf16 (idle over bf16 pools)
constexpr int kConvWarps = 3;
constexpr int kConverters = 32 * kConvWarps;
constexpr int kThreads = kConsumers + 32 + kConverters;
constexpr int kBufs = 2;                      // int8: bf16 tile buffers
constexpr int kTileBytes = KT * D * 2;        // a bf16 [64, 128] tile
static_assert(NS <= STAGES, "the ring's barriers and scale rows");
static_assert(kTileBytes == 2 * HALF128_BYTES, "two 64-column halves");

template <typename KVT>
struct PrefillSmem {
  // warpgroup g's 64 rows at q + g * 64 * D: two 64-column halves
  alignas(1024) __nv_bfloat16 q[BQ * D];
  Stage<KVT, D> ring[NS];
  // int8 pools: kBufs buffers of a tile's K and V as bf16 (swizzled like
  // TMA's, two halves a tile), and their row scales
  alignas(1024) unsigned char conv[sizeof(KVT) == 1 ? kBufs * 2 * kTileBytes
                                                    : 16];
  Scales scales;
  float ksc[kBufs][KT], vsc[kBufs][KT];
  Ring r;
  // int8: buffer b holds a converted tile / is free for the next one
  uint64_t conv_full[kBufs], conv_empty[kBufs];
  int flag;
};
// the merge's scratch: n * BQ + BQ floats for up to MAX_SPLITS splits
static_assert(sizeof(float) * (MAX_SPLITS + 1) * BQ <=
                  sizeof(Stage<int8_t, D>) * NS,
              "the ring holds the merge's weights");

// Two int8 values (bytes `sel` of w, sel 0x4140: bytes 0 and 1, 0x4342:
// bytes 2 and 3) as a bf16 pair, exactly, by two byte permutes and one
// bf16x2 subtraction instead of the conversion unit: x = m - 128 s for
// its low 7 bits m and sign bit s; the bf16 bits 0x4300 | m are 128 + m
// and 0x4300 | s << 7 are 128 + 128 s, so their difference is x (every
// value an integer of at most 8 bits: exact).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w,
                                                     uint32_t sel) {
  const uint32_t a = __byte_perm(w & 0x7F7F7F7Fu, 0x43434343u, sel);
  const uint32_t b = __byte_perm(w & 0x80808080u, 0x43434343u, sel);
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Convert one tile of int8 rows (128 bytes a key, swizzled as TMA wrote
// them) into bf16 rows (256 bytes a key: two halves, tile_off<bf16, 128>);
// keys at or past nv become zeros. Called by the kConverters threads, ct
// the caller's index among them.
__device__ __forceinline__ void int8_tile_to_bf16(const unsigned char* src,
                                                  unsigned char* dst, int nv,
                                                  int ct) {
  for (int i = ct; i < KT * 8; i += kConverters) {
    const int k = i >> 3, c = i & 7;          // key, 16-byte int8 chunk
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (k < nv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + tile_off<int8_t, D>(k, 16 * c));
      lo = make_uint4(int8x2_to_bf16x2(raw.x, 0x4140),
                      int8x2_to_bf16x2(raw.x, 0x4342),
                      int8x2_to_bf16x2(raw.y, 0x4140),
                      int8x2_to_bf16x2(raw.y, 0x4342));
      hi = make_uint4(int8x2_to_bf16x2(raw.z, 0x4140),
                      int8x2_to_bf16x2(raw.z, 0x4342),
                      int8x2_to_bf16x2(raw.w, 0x4140),
                      int8x2_to_bf16x2(raw.w, 0x4342));
    }
    *reinterpret_cast<uint4*>(dst + tile_off<__nv_bfloat16, D>(k, 32 * c)) =
        lo;
    *reinterpret_cast<uint4*>(
        dst + tile_off<__nv_bfloat16, D>(k, 32 * c + 16)) = hi;
  }
}

template <typename KVT>
__global__ void __launch_bounds__(kThreads, 1)
paged_prefill_tc128_kernel(const __grid_constant__ CUtensorMap tk,
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
  Walk w;
  w.table = tables + (size_t)b * T;
  w.lo = sp * split_keys;
  w.kend = min(min(ctx, T * bs), w.lo + split_keys);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live_rows = min(BQ, R - rt * BQ);

  const int ntiles = w.tiles();
  if (threadIdx.x == 0) {
    // a raw stage is read by the consumers (bf16) or the converters (int8)
    init_ring(s.r, kInt8 ? kConvWarps : kWarps);
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&s.conv_full[i], kConvWarps);
      mbar_init(&s.conv_empty[i], kWarps);
    }
    fence_barrier_init();
  }
  const int ids = warp == kWarps ? first_ids(w, bs) : 0;
  __syncthreads();
  if (warp == kWarps) {                     // the producer warp
    produce<KVT, D, NS>(s.ring, &s.scales, s.r, tk, tv, tks, tvs, w, bs,
                        h * NB, ids);
    return;
  }
  if (warp > kWarps) {                      // the converter warps
    if constexpr (kInt8) {
      // tile t's raw stage into buffer t % kBufs (its scales into ksc /
      // vsc), kBufs tiles ahead of the consumers at most; each warp
      // releases the raw stage once its own reads are done
      const int ct = threadIdx.x - kConsumers - 32;
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % NS, bf = t % kBufs;
        const int nv = min(KT, w.kend - (w.lo + t * KT));
        mbar_wait(&s.r.full[st], (t / NS) & 1);
        mbar_wait(&s.conv_empty[bf], ((t / kBufs) & 1) ^ 1);
        unsigned char* cv = s.conv + bf * 2 * kTileBytes;
        int8_tile_to_bf16(s.ring[st].k, cv, nv, ct);
        int8_tile_to_bf16(s.ring[st].v, cv + kTileBytes, nv, ct);
        if (ct < KT) {
          const int at = scale_index(ct, bs);
          s.ksc[bf][ct] = ct < nv ? s.scales.k[st][at] : 0.f;
          s.vsc[bf][ct] = ct < nv ? s.scales.v[st][at] : 0.f;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&s.conv_full[bf]);
          mbar_arrive(&s.r.empty[st]);
        }
      }
    }
    return;
  }

  // ---- the Q tile, swizzled as TMA would write it; padding rows zero
  const __nv_bfloat16* qh = q + ((size_t)h * R + (size_t)rt * BQ) * D;
  unsigned char* qs = reinterpret_cast<unsigned char*>(s.q);
  for (int i = threadIdx.x; i < BQ * 16; i += kConsumers) {
    const int row = i >> 4, c = i & 15;         // row, 16-byte chunk
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < live_rows)
      val = *reinterpret_cast<const uint4*>(qh + row * D + 8 * c);
    *reinterpret_cast<uint4*>(
        qs + (row >> 6) * kTileBytes +
        tile_off<__nv_bfloat16, D>(row & 63, 16 * c)) = val;
  }
  fence_proxy_async();
  consumers_sync<kConsumers>();

  const int wg = warp >> 2;                     // this thread's warpgroup
  const bool idle = 64 * wg >= live_rows;       // its rows: all padding
  const void* qw = qs + wg * kTileBytes;
  const int c_lo = 2 * (lane % 4);              // + 8j + {0, 1}
  const int row0 = 64 * wg + 16 * (warp & 3) + lane / 4;   // and row0 + 8
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    pos[hh] = q_offset + (rt * BQ + row0 + 8 * hh) % C;
  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % NS, bf = t % kBufs;
    const int tile_lo = w.lo + t * KT;
    const int nv = min(KT, w.kend - tile_lo);
    const void* kt = s.ring[st].k;
    const __nv_bfloat16* vt =
        reinterpret_cast<const __nv_bfloat16*>(s.ring[st].v);
    const float* ksc = s.ksc[bf];
    const float* vsc = s.vsc[bf];
    if constexpr (kInt8) {           // the converters' bf16 tile
      mbar_wait(&s.conv_full[bf], (t / kBufs) & 1);
      kt = s.conv + bf * 2 * kTileBytes;
      vt = reinterpret_cast<const __nv_bfloat16*>(
          s.conv + bf * 2 * kTileBytes + kTileBytes);
    } else {
      mbar_wait(&s.r.full[st], (t / NS) & 1);
      if (nv < KT) {                 // zero V's rows at or past ctx
        unsigned char* v = s.ring[st].v;
        for (int i = nv * 8 + threadIdx.x; i < KT * 8; i += kConsumers) {
          *reinterpret_cast<uint4*>(v + 16 * i) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(v + HALF128_BYTES + 16 * i) =
              make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        consumers_sync<kConsumers>();
      }
    }
    if (!idle) {
      float sc[32];
      wgmma_fence();
      mma_ss_k128(sc, qw, kt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // mask (keys past ctx or past the row's position), K's int8 scale
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = 8 * (x >> 2) + c_lo + (x & 1);
        const bool ok = col < nv && tile_lo + col <= pos[(x >> 1) & 1];
        const float v = kInt8 ? sc[x] * ksc[col] : sc[x];
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
        const float p = ex2(fmaf(sc[x], scale_log2, -m[hh]));  // masked: 0
        part[hh] += p;
        sc[x] = kInt8 ? p * vsc[8 * (x >> 2) + c_lo + (x & 1)] : p;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + part[hh];
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] *= corr[(x >> 1) & 1];
      uint32_t ph[4][4], pl[4][4];
      pack_frag_split(ph, pl, sc);
      wgmma_fence();
      mma_rs_n128<64>(acc, pl, vt);
      mma_rs_n128<64>(acc, ph, vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // the tile's K and V have been read: its raw stage (bf16) or its bf16
    // buffer (int8) is free
    if (lane == 0)
      mbar_arrive(kInt8 ? &s.conv_empty[bf] : &s.r.empty[st]);
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
  const int kPart = partial_floats<D>(BQ);      // floats of a partial
  __nv_bfloat16* orows = out + ((size_t)h * R + (size_t)rt * BQ) * D;
  if (nsplit == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= live_rows) continue;
      const float lc = fmaxf(lt[hh], 1e-30f);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orows + row * D + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / lc,
                                  acc[4 * j + 2 * hh + 1] / lc);
    }
    return;
  }
  // a partial's acc rows past the group's are never read: not written
  float* part = ws + (tile * nsplit + sp) * kPart;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row < live_rows) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(part + row * D + 8 * j + c_lo) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    if (lane % 4 == 0) {
      part[BQ * D + row] = m[hh];
      part[BQ * D + BQ + row] = lt[hh];
    }
  }
  if (!arrive_last<kConsumers>(counters + tile, nsplit, &s.flag)) return;
  // the ring serves as scratch: every tile has been consumed
  merge_partials<kConsumers, D, 16>(ws + tile * nsplit * kPart, nsplit,
                                    kPart, BQ, live_rows,
                                    reinterpret_cast<float*>(s.ring[0].k),
                                    orows);
  if (threadIdx.x == 0) counters[tile] = 0;   // ready for the next launch
}

// B lanes (lane_ctx / lane_len null for one prefill chunk, B = 1).
template <typename KVT>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* lane_ctx, const int* lane_len, void* out,
                  float* ws, int* counters, int B, int Hq, int Hkv, int NB,
                  int bs, int T, int C, int q_offset, int ctx, int nsplit,
                  int split_keys, float scale, cudaStream_t stream) {
  Maps m;
  cudaError_t err = pool_maps(&m, sizeof(KVT) == 1, k, v, ks, vs, Hkv * NB,
                              bs, D);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(PrefillSmem<KVT>) + 1024;   // + alignment
  auto kernel = paged_prefill_tc128_kernel<KVT>;
  static bool opted_in = false;
  err = opt_in_smem(kernel, smem, &opted_in);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hq / Hkv) * C + BQ - 1) / BQ;
  kernel<<<dim3(Hkv, nsplit, tiles * B), kThreads, smem, stream>>>(
      m.k, m.v, m.ks, m.vs, (const __nv_bfloat16*)q, (__nv_bfloat16*)out,
      table, lane_ctx, lane_len, ws, counters, Hq, Hkv, NB, bs, T, C,
      q_offset, ctx, tiles, split_keys, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace paged_tc128

// B lanes of q: [B, Hq, C, 128] bf16; k/v: [Hkv, NB, bs, 128] bf16
// (kv_dtype 1) or int8 (kv_dtype 2) with ks/vs [Hkv, NB, bs, 1] float32;
// tables: [B, T] int32; out: [B, Hq, C, 128] bf16; all 16-byte aligned.
// Lane b's chunk covers positions [q_offset, ctx): with lane_ctx /
// lane_len null (one prefill chunk, B = 1) the two scalars, else
// lane_ctx[b] and lane_ctx[b] + lane_len[b], [B] int32 on the device (the
// batched verify, each window's own K/V already in the pools). Rows at or
// past a lane's chunk length are finite garbage; a lane with ctx 0 gets
// zeros. bs in {8, 16, 32, 64} (int8: 16, 32, 64). nsplit (<= 64) CTAs a
// (lane, KV head, row tile) over split_keys keys each (a multiple of 64)
// must cover the keys: min(ctx, T * bs) for one chunk, T * bs for lanes;
// above one split, ws holds B * Hkv * tiles * nsplit * 128 * 130 floats
// and counters B * Hkv * tiles int32 zeros (left zero), tiles = ceil(Hq /
// Hkv * C / 128). split_p must be 1: P enters P V as two bf16 parts (the
// argument list is paged_prefill_tc.cu's, where 0 rounds a chunk's P
// once). Returns cudaGetLastError() of the launch.
extern "C" int paged_prefill_attention_tc128(
    int kv_dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* tables, const int* lane_ctx,
    const int* lane_len, void* out, float* ws, int* counters, int B, int Hq,
    int Hkv, int NB, int bs, int T, int C, int q_offset, int ctx, int nsplit,
    int split_keys, int split_p, float scale, void* stream) {
  using namespace paged_tma;
  cudaStream_t st = (cudaStream_t)stream;
  const bool lanes = lane_ctx != nullptr;
  const int keys = lanes ? T * bs : min(ctx, T * bs);
  const bool ok = B >= 1 && Hkv >= 1 && Hq % Hkv == 0 &&
                  lanes == (lane_len != nullptr) && (lanes || B == 1) &&
                  split_keys % KT == 0 && nsplit <= MAX_SPLITS &&
                  KT % bs == 0 && keys > 0 &&
                  (long long)nsplit * split_keys >= keys &&
                  (long long)(nsplit - 1) * split_keys < keys &&
                  (nsplit == 1 || (ws != nullptr && counters != nullptr)) &&
                  split_p == 1;
  if (!ok) return (int)cudaErrorInvalidValue;
#define PAGED_PREFILL_TC128(KVT)                                             \
  paged_tc128::launch<KVT>(q, k, v, ks, vs, tables, lane_ctx, lane_len, out, \
                           ws, counters, B, Hq, Hkv, NB, bs, T, C, q_offset, \
                           ctx, nsplit, split_keys, scale, st)
  if (kv_dtype == paged::kBF16 && bs % 8 == 0)
    return PAGED_PREFILL_TC128(__nv_bfloat16);
  if (kv_dtype == paged::kI8 && bs % 16 == 0)
    return PAGED_PREFILL_TC128(int8_t);
#undef PAGED_PREFILL_TC128
  return (int)cudaErrorInvalidValue;
}
