// Shared device and host code of the TMA-fed paged-attention kernels
// (paged_decode_tma.cu on the CUDA cores, paged_prefill_tc.cu on wgmma, at
// head_dim 64; paged_decode_tma128.cu at head_dim 128): a table-driven
// ring of whole K/V blocks loaded by TMA, key splits over CTAs, and the
// merge of the splits' partial results. The head_dim is a template
// parameter (DD, D = 64 by default: the head_dim-64 kernels name none).
//
// Layout. A pool [Hkv, NB, bs, DD] holds each (KV head, physical block)
// as bs * DD contiguous elements, so it is viewed as [Hkv * NB, bs, DD]
// and the TMA boxes of a block land it at coordinate (c0, 0, h * NB +
// phys). TMA writes with the 128-byte swizzle, whose lines are 128 bytes:
//   * bf16 at 64 (128-byte rows): one box a block, bs lines;
//   * int8 at 64 (64-byte rows): one box, the block viewed as [bs / 2, 128]
//     bytes (two keys a line);
//   * int8 at 128 (128-byte rows): one box, bs lines;
//   * bf16 at 128 (256-byte rows): two boxes a block, columns 0-63 and
//     64-127 (c0 = 0, 64), into the two halves of the stage's tile, each
//     a run of KT 128-byte lines (KT * 128 bytes apart).
// A block starts on a 1024-byte boundary of its stage (one swizzle atom:
// bs * 128 bytes of a run for bs % 8 == 0, bs * 64 for int8 at 64 with
// bs % 16 == 0): byte b of key k's row sits at tile_off(k, b). The int8
// scales [Hkv * NB, bs] float32 come as one box of bs floats a block,
// into a slot of its stage's scale row: TMA writes shared memory from
// 128-byte boundaries, so block j of a stage starts at float j *
// scale_stride(bs), with scale_stride(bs) = max(bs, 32) (int8 takes bs 16
// and up at either head_dim, so a stage's scales fit SCALE_FLOATS).
//
// The ring. A stage holds KT = 64 keys: 64 / bs blocks of K and of V. A
// producer warp reads the CTA's slice of the block table, 32 entries at a
// time (the only table lookups), and one of its threads keeps up to NS
// (STAGES at head_dim 64) stages of block loads in flight behind
// full/empty mbarriers.
// Blocks past the context are never loaded: the consumers read no key at
// or past ctx, or zero such rows before a product reads them, so neither
// a poisoned null block nor stale shared memory reaches an accumulator.
//
// Splits. A (lane, KV head) walks keys [s * split_keys, (s + 1) *
// split_keys) in CTA s (split_keys a multiple of KT; at most MAX_SPLITS
// splits). A CTA that is the only live split of its (lane, head) writes
// the output; otherwise every live split writes its partial (m, l, acc)
// (m in the log2 domain) to a workspace, and the last to arrive (an
// atomic counter, __threadfence before and after) merges them in split
// order and resets the counter to zero for the next launch. The merge
// reads every partial back from the workspace, the merging CTA's own too,
// so the output is bitwise the same whichever CTA merges.
//
// The decode's append. A serving decode step first writes each lane's new
// K/V row at key ctx and then attends over ctx + 1 keys. The decode
// kernels' fused entry points do both: in the CTA of the last live split,
// the only one that reads slot ctx of its (lane, KV head), the producer
// warp writes the rows (append_rows) and fences them for the async proxy
// before it loads the last tile.
#pragma once

#include <mutex>
#include <type_traits>
#include <vector>

#include "hopper.cuh"
#include "paged_attention.cuh"

namespace paged_tma {

using namespace hopper;

constexpr int D = 64;          // head_dim of the head_dim-64 kernels (DD)
constexpr int KT = 64;         // keys of a ring stage
constexpr int STAGES = 4;      // ring stages at head_dim 64 (at most)
// floats of a stage's int8 scale row: KT / bs blocks of max(bs, 32)
// floats each (bs 16: 4 x 32; bs 32: 2 x 32; bs 64: 1 x 64)
constexpr int SCALE_FLOATS = 128;
constexpr int MAX_SPLITS = 64;       // splits a (lane, head) merges
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = paged::kNegInf;

// One ring stage: KT keys of K and of V, in the pool's element type
// (1024-byte aligned: each tile is whole swizzle atoms).
template <typename KVT, int DD = D>
struct alignas(1024) Stage {
  unsigned char k[KT * DD * sizeof(KVT)];
  unsigned char v[KT * DD * sizeof(KVT)];
};

// The byte of a stage tile that holds byte b of key `key`'s row (rows of
// DD elements of KVT): rows of up to 128 bytes run on in one swizzled run,
// 256-byte rows (bf16 at 128) are two halves of KT lines each.
template <typename KVT, int DD>
__device__ __forceinline__ uint32_t tile_off(int key, int b) {
  constexpr int kRow = DD * (int)sizeof(KVT);
  if constexpr (kRow <= 128)
    return swizzle128(key * kRow + b);
  else
    return (b >> 7) * (KT * 128) + swizzle128(key * 128 + (b & 127));
}

// The int8 scales of the ring: one row of SCALE_FLOATS a stage.
struct alignas(128) Scales {
  float k[STAGES][SCALE_FLOATS];
  float v[STAGES][SCALE_FLOATS];
};

// Floats between the starts of two blocks' scales in a stage's row (a
// whole number of 128 bytes), and where key k of the stage has its scale.
__host__ __device__ constexpr int scale_stride(int bs) {
  return bs < 32 ? 32 : bs;
}
__device__ __forceinline__ int scale_index(int k, int bs) {
  return k / bs * scale_stride(bs) + k % bs;
}
static_assert(KT / 16 * scale_stride(16) <= SCALE_FLOATS &&
                  KT / 32 * scale_stride(32) <= SCALE_FLOATS &&
                  KT / 64 * scale_stride(64) <= SCALE_FLOATS,
              "a stage's scales fit its row at every int8 block size");

// The barriers of the ring (a ring of NS < STAGES stages uses the first
// NS).
struct Ring {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// The per-lane arguments of a walk: the lane's table row and its visible
// keys [lo, kend) of this split.
struct Walk {
  const int* table;            // the lane's block table row
  int lo, kend;                // keys of this CTA's split
  __device__ __forceinline__ int tiles() const {
    return kend > lo ? (kend - lo + KT - 1) / KT : 0;
  }
};

__device__ __forceinline__ void init_ring(Ring& r, int consumer_warps) {
  for (int i = 0; i < STAGES; ++i) {
    mbar_init(&r.full[i], 1);
    mbar_init(&r.empty[i], consumer_warps);
  }
  fence_barrier_init();
}

// Barrier of the NT consumer threads (0 .. NT - 1) alone.
template <int NT = 128>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// The producer warp's first 32 table entries of the walk (lane i holds
// block i of the split), loaded before the CTA's first barrier so that
// the lookup overlaps the consumers' setup.
__device__ __forceinline__ int first_ids(const Walk& w, int bs) {
  const int lane = threadIdx.x & 31;
  const int nblk = w.kend > w.lo ? (w.kend - w.lo + bs - 1) / bs : 0;
  return lane < nblk ? w.table[w.lo / bs + lane] : 0;
}

// ------------------------------------------------- the decode's append
// A decode step's new K/V rows, which the decode kernels write into the
// pools themselves (the fused entry points): row (h, b) of K is at
// k + h * ksp + b * ksn bf16 elements, V's at v + h * vsp + b * vsn;
// both go to slot (phys[b], off[b]) of KV head h's
// plane (int64 indices when idx64, else int32), into the pools kp / vp
// [Hkv, NB, bs, DD] and, for int8 pools, the scales ks / vs [Hkv, NB, bs].
// k null: no append (the plain decode).
struct Append {
  const void* k;
  const void* v;
  const void* phys;
  const void* off;
  void* kp;
  void* vp;
  float* ks;
  float* vs;
  long long ksp, ksn, vsp, vsn;
  int idx64;
};

constexpr float kInvQmax = 0x1.020408p-7f;   // float32(1 / 127)

// Order this thread's generic-proxy global stores before later
// async-proxy (TMA) reads of the same bytes, once a barrier orders the
// thread that issues them after this one.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ long long append_index(const void* p, int is64,
                                                  int i) {
  return is64 ? reinterpret_cast<const long long*>(p)[i]
              : (long long)reinterpret_cast<const int*>(p)[i];
}

// One warp writes lane b's K and V rows of KV head h into their pool
// slots, K by the warp's lanes 0-15 and V by 16-31 at once, each thread DD
// / 16 adjacent elements by one vector load and store (the wrapper checks
// the rows' alignment), then orders its stores before the TMA loads that
// lane 0 issues after the warp's next __syncwarp. int8 pools take
// kv_append_int8.cu's arithmetic, bitwise: scale = absmax *
// float32(1/127) (__fmul_rn; the absmax a shuffle over the half-warp),
// code = clip(floor(x / scale + 0.5)) (__fdiv_rn, __fadd_rn), an all-zero
// row scale 0 and code 0. bf16 pools take the row's bits.
template <typename KVT, int DD>
__device__ __forceinline__ void append_rows(const Append& a, int h, int b,
                                            int NB, int bs) {
  constexpr int PER = DD / 16;               // 4 or 8 elements a lane
  using Bf16s = typename std::conditional<PER == 8, uint4, uint2>::type;
  using Codes = typename std::conditional<PER == 8, uint2, uint32_t>::type;
  const int lane = threadIdx.x & 15;         // within its half-warp
  const bool is_v = (threadIdx.x & 31) >= 16;
  const long long blk = append_index(a.phys, a.idx64, b);
  const long long o = append_index(a.off, a.idx64, b);
  const long long src = (is_v ? a.vsp : a.ksp) * h +
                        (is_v ? a.vsn : a.ksn) * b + lane * PER;
  const long long slot = ((long long)h * NB + blk) * bs + o;
  void* pool = is_v ? a.vp : a.kp;
  const Bf16s w = *reinterpret_cast<const Bf16s*>(
      static_cast<const __nv_bfloat16*>(is_v ? a.v : a.k) + src);
  if constexpr (sizeof(KVT) == 1) {
    float x[PER];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int u = 0; u < PER / 2; ++u) {
      const float2 f = __bfloat1622float2(p[u]);
      x[2 * u] = f.x;
      x[2 * u + 1] = f.y;
    }
    float amax = 0.0f;
#pragma unroll
    for (int u = 0; u < PER; ++u) amax = fmaxf(amax, fabsf(x[u]));
#pragma unroll
    for (int s = 8; s > 0; s >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    const float sc = __fmul_rn(amax, kInvQmax);
    const float safe = amax > 0.0f ? sc : 1.0f;
    uint32_t words[PER / 4] = {};            // the codes, 4 a word
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const float c = floorf(__fadd_rn(__fdiv_rn(x[u], safe), 0.5f));
      words[u / 4] |= (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(c, -127.0f),
                                                      127.0f)
                      << (8 * (u % 4));
    }
    Codes packed;
    if constexpr (PER == 8)
      packed = make_uint2(words[0], words[1]);
    else
      packed = words[0];
    reinterpret_cast<Codes*>(static_cast<int8_t*>(pool) + slot * DD)[lane] =
        packed;
    if (lane == 0) (is_v ? a.vs : a.ks)[slot] = amax > 0.0f ? sc : 0.0f;
  } else {
    reinterpret_cast<Bf16s*>(static_cast<__nv_bfloat16*>(pool) +
                             slot * DD)[lane] = w;
  }
  fence_proxy_async_global();
}

// append_rows as a call of its own. Each decode kernel takes the form
// with which ptxas spills nothing in any of its instantiations: int8
// pools inline the writer (called, the head_dim-64 G-1 kernel spills 8
// bytes), bf16 pools call it (inlined, their head_dim-64 G-1 kernel
// spills 4); at head_dim 128 both forms spill nothing.
template <typename KVT, int DD>
__device__ __noinline__ void append_rows_call(const Append& a, int h,
                                              int b, int NB, int bs) {
  append_rows<KVT, DD>(a, h, b, NB, bs);
}

// The producer warp: every live block of every tile of the walk, stage
// by stage (NS of them), lane 0 issuing. The table entries come 32 at a
// time, one a lane, and reach lane 0 by shuffle: no load waits on a lookup
// but the first of each 32 blocks. `plane0` is h * NB, the KV head's first
// plane; `ids` is first_ids(). With `ap` (the CTA of a decode that appends
// lane b's K/V rows of KV head h, append_rows), the warp writes the two
// rows once the ring is full, where it would first wait for a consumer
// (or before the last tile, the one holding the appended key, if that
// comes first): the tiles before are in flight meanwhile, and no
// consumer waits on the write.
template <typename KVT, int DD = D, int NS = STAGES>
__device__ __forceinline__ void produce(Stage<KVT, DD>* ring, Scales* sc,
                                        Ring& r, const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tks,
                                        const CUtensorMap& tvs,
                                        const Walk& w, int bs, int plane0,
                                        int ids,
                                        const Append* ap = nullptr,
                                        int h = 0, int b = 0, int NB = 0) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  // a block's boxes: a 256-byte row is two 128-byte halves
  constexpr int kBoxes = DD * sizeof(KVT) > 128 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int nblk = w.kend > w.lo ? (w.kend - w.lo + bs - 1) / bs : 0;
  const uint32_t blk_bytes = bs * DD * sizeof(KVT);
  const uint32_t box_bytes = blk_bytes / kBoxes;
  const int per = KT / bs;
  for (int t = 0; t < w.tiles(); ++t) {
    const int st = t % NS;
    const int first = t * per, n = min(per, nblk - first);
    if (ap != nullptr && t == min(NS, w.tiles() - 1)) {
      if constexpr (kInt8)
        append_rows<KVT, DD>(*ap, h, b, NB, bs);
      else
        append_rows_call<KVT, DD>(*ap, h, b, NB, bs);
      __syncwarp();           // every lane's stores and fence before lane 0
    }
    if (lane == 0) {
      mbar_wait(&r.empty[st], ((t / NS) & 1) ^ 1);
      mbar_expect_tx(&r.full[st],
                     n * (2 * blk_bytes + (kInt8 ? 2 * bs * 4 : 0)));
    }
    for (int j = 0; j < n; ++j) {
      const int i = first + j;               // block i of the split
      if (i > 0 && i % 32 == 0)
        ids = i + lane < nblk ? w.table[w.lo / bs + i + lane] : 0;
      const int plane = plane0 + __shfl_sync(0xffffffffu, ids, i % 32);
      if (lane != 0) continue;
#pragma unroll
      for (int h = 0; h < kBoxes; ++h) {
        tma_load_3d(ring[st].k + h * KT * 128 + j * box_bytes, &tk,
                    &r.full[st], 64 * h, 0, plane);
        tma_load_3d(ring[st].v + h * KT * 128 + j * box_bytes, &tv,
                    &r.full[st], 64 * h, 0, plane);
      }
      if constexpr (kInt8) {
        const int at = j * scale_stride(bs);
        tma_load_2d(sc->k[st] + at, &tks, &r.full[st], 0, plane);
        tma_load_2d(sc->v[st] + at, &tvs, &r.full[st], 0, plane);
      }
    }
  }
}

// 8 bf16 or 16 int8 values of one 16-byte chunk as floats.
__device__ __forceinline__ void chunk_floats(const uint4& c, float* f,
                                             __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void chunk_floats(const uint4& c, float* f,
                                             int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&c);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
}

// Merge the `n` splits' partial results of `rows` query rows, split s at
// base + s * stride floats: acc [rows][DD], then m [rows] (log2 domain),
// then l [rows]; write rows < live_rows of the output (bf16, DD a row
// from `out`). Each row's weights 2^(m_s - max m) go to `scratch` (n *
// rows + rows floats of shared memory) first, so every acc load is
// independent of the others. A split that saw no key has l = acc = 0; no
// key at all gives 0 * (1 / 1e-30) = 0. Called by the NT consumer
// threads of the CTA that arrived last. The splits are read UNROLL at a
// time, all of a group's loads issued before the first is used (a loop of
// n loads unrolled by UNROLL would run a remainder of up to UNROLL - 1 one
// load at a time); the sums run in split order either way.
template <int NT = 128, int DD = D, int UNROLL = 4>
__device__ __forceinline__ void merge_partials(const float* base, int n,
                                               int stride, int rows,
                                               int live_rows, float* scratch,
                                               __nv_bfloat16* out) {
  float* wt = scratch;                       // [n][rows]
  float* inv = scratch + n * rows;           // [rows]
  for (int r = threadIdx.x; r < rows; r += NT) {
    const float* m = base + rows * DD + r;
    const float* l = m + rows;
    float mx = kNegInf;
    for (int s0 = 0; s0 < n; s0 += UNROLL) {
      float ms[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        ms[j] = s0 + j < n ? __ldcg(m + (s0 + j) * stride) : kNegInf;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) mx = fmaxf(mx, ms[j]);
    }
    float lsum = 0.f;
    for (int s0 = 0; s0 < n; s0 += UNROLL) {
      float ms[UNROLL], ls[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        ms[j] = s0 + j < n ? __ldcg(m + (s0 + j) * stride) : 0.f;
        ls[j] = s0 + j < n ? __ldcg(l + (s0 + j) * stride) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (s0 + j >= n) break;
        const float f = ex2(ms[j] - mx);
        wt[(s0 + j) * rows + r] = f;
        lsum += ls[j] * f;
      }
    }
    inv[r] = 1.f / fmaxf(lsum, 1e-30f);
  }
  consumers_sync<NT>();
  for (int e = 4 * threadIdx.x; e < live_rows * DD; e += 4 * NT) {
    const int r = e / DD;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n; s0 += UNROLL) {
      float4 x[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        x[j] = s0 + j < n ? __ldcg(reinterpret_cast<const float4*>(
                                base + (size_t)(s0 + j) * stride + e))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (s0 + j >= n) break;
        const float f = wt[(s0 + j) * rows + r];
        a.x = fmaf(x[j].x, f, a.x);
        a.y = fmaf(x[j].y, f, a.y);
        a.z = fmaf(x[j].z, f, a.z);
        a.w = fmaf(x[j].w, f, a.w);
      }
    }
    const float c = inv[r];
    *reinterpret_cast<__nv_bfloat162*>(out + e) =
        __floats2bfloat162_rn(a.x * c, a.y * c);
    *reinterpret_cast<__nv_bfloat162*>(out + e + 2) =
        __floats2bfloat162_rn(a.z * c, a.w * c);
  }
}

// Floats of one split's partial of `rows` rows (acc, m, l), rounded up to
// whole float4s so that every partial starts 16-byte aligned.
template <int DD = D>
__host__ __device__ __forceinline__ int partial_floats(int rows) {
  return (rows * (DD + 2) + 3) / 4 * 4;
}

// Count this CTA's arrival at its (lane, head)'s counter once its partial
// is written; true in every consumer thread of the CTA that arrives last.
// `flag` is a shared int. Called by the NT consumer threads.
template <int NT = 128>
__device__ __forceinline__ bool arrive_last(int* counter, int n, int* flag) {
  __threadfence();
  consumers_sync<NT>();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == n - 1;
  consumers_sync<NT>();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// ------------------------------------------------------ host: tensor maps
// Kinds of map: a bf16 pool's blocks, an int8 pool's blocks, a scales
// tensor's block rows.
enum MapKind { kBF16Blocks = 0, kI8Blocks = 1, kScaleRows = 2 };

inline cudaError_t encode(CUtensorMap* map, MapKind kind, const void* base,
                          int planes, int bs, int d = D) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUresult res;
  const cuuint32_t unit[3] = {1, 1, 1};
  void* p = const_cast<void*>(base);
  if (kind == kScaleRows) {
    const cuuint64_t dims[2] = {(cuuint64_t)bs, (cuuint64_t)planes};
    const cuuint64_t strides[1] = {(cuuint64_t)bs * 4};
    const cuuint32_t box[2] = {(cuuint32_t)bs, 1};
    res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p, dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const bool i8 = kind == kI8Blocks;
    const int esz = i8 ? 1 : 2, row = d * esz;   // bytes of a key's row
    // a block's rows as the map sees them: 128-byte lines (two 64-byte
    // int8 rows a line at d 64), `pitch` bytes apart; a box is one line
    // wide (64 bf16 or 128 int8: a 256-byte row takes two boxes)
    const int rows = row < 128 ? bs * row / 128 : bs;
    const int pitch = row < 128 ? 128 : row;
    const cuuint64_t dims[3] = {(cuuint64_t)(pitch / esz), (cuuint64_t)rows,
                                (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)pitch,
                                   (cuuint64_t)rows * pitch};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / esz), (cuuint32_t)rows,
                               1};
    res = fn(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, p, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The four maps of a launch (the scales' only for int8 pools; a bf16
// launch passes the K map in their place, unread).
struct Maps {
  CUtensorMap k, v, ks, vs;
};

// The maps of a pool pair, encoded once and then taken from a cache keyed
// by (k, v, ks, vs, planes, bs, d): the pools live as long as their
// engine, so a decode step encodes nothing and takes one lock.
inline cudaError_t pool_maps(Maps* m, bool int8, const void* k,
                             const void* v, const float* ks, const float* vs,
                             int planes, int bs, int d = D) {
  struct Entry {
    const void *k, *v, *ks, *vs;
    int planes, bs, d;
    Maps maps;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.k == k && e.v == v && e.ks == ks && e.vs == vs &&
        e.planes == planes && e.bs == bs && e.d == d) {
      *m = e.maps;
      return cudaSuccess;
    }
  Entry e{k, v, ks, vs, planes, bs, d, {}};
  const MapKind kind = int8 ? kI8Blocks : kBF16Blocks;
  cudaError_t err = encode(&e.maps.k, kind, k, planes, bs, d);
  if (err == cudaSuccess) err = encode(&e.maps.v, kind, v, planes, bs, d);
  if (err == cudaSuccess && int8)
    err = encode(&e.maps.ks, kScaleRows, ks, planes, bs);
  if (err == cudaSuccess && int8)
    err = encode(&e.maps.vs, kScaleRows, vs, planes, bs);
  if (err != cudaSuccess) return err;
  if (!int8) e.maps.ks = e.maps.vs = e.maps.k;
  if (cache.size() >= 1024) cache.clear();
  cache.push_back(e);
  *m = e.maps;
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared-memory cap once per instantiation.
template <typename K>
inline cudaError_t opt_in_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace paged_tma
