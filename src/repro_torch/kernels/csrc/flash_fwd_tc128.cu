// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16, D 128.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (body _fwd_kernel) for bf16 inputs at head_dim 128, the
// route the dense configs (qwen2.5-32b, qwen3-14b, qwen3-32b, yi-34b)
// train on; flash_fwd_tc.cu keeps head_dim 64 and flash_fwd.cu float32
// and head_dim 32. q [B, Hq, Sq, 128], k/v [B, Hkv, Skv, 128] bf16 (query
// head h reads KV head h / (Hq/Hkv)) give o [B, Hq, Sq, 128] bf16 and,
// optionally, the float32 row logsumexp lse [B, Hq, Sq]. Query row r sits
// at absolute position q_offset + r; causal and window masks follow the
// reference's _mask_block, masked pairs get p = 0 exactly and a row that
// sees no key gets o = 0.
//
// Numerics, as flash_fwd_tc.cu: q.k takes bf16 operands with float32
// accumulation; the row max and sum and the rescaling are float32; p is
// rounded once to bf16 for the p.v product, which accumulates in float32;
// the row sum l is taken from the float32 p.
//
// What bounds it on an H100: operations. At qwen3-14b's training shape
// (B 2, Hq 40, Hkv 8, S 1024, causal) a call needs 21.5 GFLOP against
// 26 MB of q, k, v and o: above the bf16 ridge.
//
// What the design does about it:
//   * a CTA's two consumer warpgroups take two neighbouring 64-row query
//     tiles of one head (rows 128 p .. 128 p + 127), whatever the GQA
//     group, and share every K/V tile of the pair: each K/V tile is read
//     once for 128 query rows. The grid is persistent, one CTA an SM: the
//     pairs are dealt out heaviest first in a snake over the CTAs (Sched),
//     so under a causal mask every CTA has about the same work and no wave
//     of CTAs runs a third full; the next pair's query tiles load while
//     the current pair runs (two buffers);
//   * a producer warpgroup (one issuing thread) loads each query tile once
//     and keeps two rings of 128-key tiles in flight by TMA, K and V apart
//     (STAGES deep each): a K tile is released as soon as Q K^T has read
//     it, a V tile after P V, so the next K lands while P V runs. A
//     128-wide row is two 64-column boxes (the 128-byte swizzle takes 64
//     bf16 at most), so every tile is two halves; 3-D tensor maps, rows
//     past Skv read as zeros. A warpgroup passes over the tiles that its
//     own query rows cannot see (a pair's tiles are the union of both
//     warpgroups' live tiles; under a plain causal mask they are the
//     same);
//   * S = Q K^T is one 64 x 128 product over the two halves of D
//     (mma_ss_k128_n128: eight m64n128k16 wgmmas with both operands in
//     shared memory); the online softmax runs on S's accumulator
//     fragment; P, packed to bf16 in registers, is the A operand of
//     O += P V, one m64n128 wgmma a 16-key step whose B is the V tile read
//     MN-major, the descriptor's LBO stepping from the first column half
//     to the second (mma_rs_n128): neither S nor P touches shared memory.
//     O's 64 x 128 float32 accumulator is 64 registers a thread, S 64,
//     P 32: more than ptxas allots a thread of a CTA over 256 threads
//     (168), so the producer warpgroup keeps 24 registers and the
//     consumers take 240 (setmaxnreg; their waits cannot trap,
//     mbar_wait_bounded, or ptxas holds them to the 168);
//   * software pipelining inside a warpgroup: tile j + 1's Q K^T is issued
//     together with tile j's P V, and the softmax of tile j + 1 runs while
//     P V does;
//   * the element mask is applied only to tiles that cross the causal
//     diagonal, the window's edge or Skv.
#include "flash_attention.cuh"
#include "flash_tc128.cuh"
#include "hopper.cuh"

namespace flash_tc128 {

using namespace hopper;

constexpr int D = 128;
constexpr int BQ = 64;          // query rows of a warpgroup (wgmma M)
constexpr int BK = 128;         // keys of a K/V tile (wgmma N of Q K^T)
constexpr int NWG = 2;          // consumer warpgroups: a pair of query tiles
constexpr int STAGES = 2;       // of the K ring and of the V ring
constexpr int kThreads = (NWG + 1) * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;   // (NWG * 240 + 24) * 128 <= 64 K
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BK * D * 2;
constexpr int Q_HALF = BQ * 64;   // elements of a 64-column half tile
constexpr int KV_HALF = BK * 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  __nv_bfloat16 q[2][NWG][BQ * D];   // [item parity][warpgroup], 2 halves
  __nv_bfloat16 k[STAGES][BK * D];   // two [128, 64] halves each
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};

// The work (Sched, live_tiles, pair_tiles) is flash_tc128.cuh's.
static_assert(BQ == kPairRows, "flash_tc128.cuh's query tiles");

// The producer: one thread loads each item's query tiles once, into the
// item's parity's buffer when the consumers have released it, and keeps
// the K and V rings full across the items; a K tile is released as soon
// as Q K^T has read it, its V tile only after P V.
__device__ __forceinline__ void produce(Smem& s, const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const Sched& w, int Sq, int Skv,
                                        const flash::Mask& mask) {
  int it = 0;
  for (int t = 0; w.item(blockIdx.x, t) >= 0; ++t) {
    const int i = w.item(blockIdx.x, t), qb = t & 1;
    const int q_lo = 2 * w.pair(i) * BQ;          // < Sq
    const int nq = q_lo + BQ < Sq ? 2 : 1;
    if (t >= 2) mbar_wait(&s.q_empty[qb], ((t >> 1) - 1) & 1);
    mbar_expect_tx(&s.q_full[qb], nq * Q_BYTES);
    for (int g = 0; g < nq; ++g) {
      tma_load_3d(s.q[qb][g], &tq, &s.q_full[qb], 0, q_lo + g * BQ,
                  w.qplane(i));
      tma_load_3d(s.q[qb][g] + Q_HALF, &tq, &s.q_full[qb], 64,
                  q_lo + g * BQ, w.qplane(i));
    }
    int u0, u1;
    pair_tiles<BK>(mask, w.pair(i), Sq, Skv, &u0, &u1);
    for (int j = u0; j < u1; ++j, ++it) {
      const int st = it % STAGES;
      const uint32_t ph = ((it / STAGES) & 1) ^ 1;
      mbar_wait(&s.k_empty[st], ph);
      mbar_expect_tx(&s.k_full[st], KV_BYTES);
      tma_load_3d(s.k[st], &tk, &s.k_full[st], 0, j * BK, w.kvplane(i));
      tma_load_3d(s.k[st] + KV_HALF, &tk, &s.k_full[st], 64, j * BK,
                  w.kvplane(i));
      mbar_wait(&s.v_empty[st], ph);
      mbar_expect_tx(&s.v_full[st], KV_BYTES);
      tma_load_3d(s.v[st], &tv, &s.v_full[st], 0, j * BK, w.kvplane(i));
      tma_load_3d(s.v[st] + KV_HALF, &tv, &s.v_full[st], 64, j * BK,
                  w.kvplane(i));
    }
  }
}

// The online softmax step of one tile of raw scores sc (rows row0 and
// row0 + 8, keys key0 + 8j + {0, 1}, j < 16): unless the tile is whole,
// masked pairs become -inf; the running row max m (log2 domain) moves to
// the tile's, corr is 2^(old max - new max); sc becomes p = 2^(s
// scale_log2 - m) and part gains the rows' partial sums (this thread's
// columns).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&corr)[2],
                                             float (&part)[2], bool whole,
                                             int row0, int key0, int Skv,
                                             const flash::Mask& mask,
                                             float scale_log2) {
  if (!whole) {
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      const int qp = mask.q_offset + row0 + 8 * ((x >> 1) & 1);
      const int key = key0 + 8 * (x >> 2) + (x & 1);
      const bool ok = (key < Skv) & (!mask.causal | (key <= qp)) &
                      ((mask.window <= 0) | (key > qp - mask.window));
      sc[x] = ok ? sc[x] : -INFINITY;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale_log2);   // scale > 0
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int h = (x >> 1) & 1;
    sc[x] = ex2(fmaf(sc[x], scale_log2, -m[h]));   // -inf (masked) -> 0
    part[h] += sc[x];
  }
}

// Wait for and release `count` ring tiles that this warpgroup does not
// use (the other one does); `it` is the ring position.
__device__ __forceinline__ void pass_tiles(Smem& s, int& it, int count,
                                           int lane) {
  for (int c = 0; c < count; ++c, ++it) {
    const int st = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    mbar_wait_bounded(&s.k_full[st], ph);
    mbar_wait_bounded(&s.v_full[st], ph);
    if (lane == 0) {
      mbar_arrive(&s.k_empty[st]);
      mbar_arrive(&s.v_empty[st]);
    }
  }
}

// O += P V for one tile: P the bf16 fragments of 128 keys, V a [128, 128]
// tile as two [128, 64] halves, read MN-major.
__device__ __forceinline__ void mma_pv(float (&acc)[64],
                                       const uint32_t (&pa)[8][4],
                                       const __nv_bfloat16* v) {
  mma_rs_n128<128, KV_HALF * 2>(acc, pa, v);
}

// A consumer warpgroup g: query tile 2 pr + g of each of the CTA's items.
__device__ __forceinline__ void consume(Smem& s, __nv_bfloat16* o,
                                        float* lse, const Sched& w, int Sq,
                                        int Skv, float scale_log2,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  const int c_lo = 2 * (lane % 4);                      // + 8j + {0, 1}
  int it = 0;                                           // ring position
  for (int t = 0; w.item(blockIdx.x, t) >= 0; ++t) {
    const int i = w.item(blockIdx.x, t), qb = t & 1;
    const size_t plane = (size_t)w.qplane(i) * Sq;
    const int q_lo = (2 * w.pair(i) + g) * BQ;
    const int row0 = q_lo + 16 * (warp % 4) + lane / 4;   // and row0 + 8
    int u0, u1, kt0, n;
    pair_tiles<BK>(mask, w.pair(i), Sq, Skv, &u0, &u1);
    live_tiles<BK>(mask, q_lo, Sq, Skv, &kt0, &n);
    // a tile needs no element mask inside the diagonal, the window and Skv
    auto whole = [&](int j) {
      const int k0 = (kt0 + j) * BK;
      return k0 + BK <= Skv &&
             (!mask.causal || k0 + BK - 1 <= mask.q_offset + q_lo) &&
             (mask.window <= 0 ||
              k0 > mask.q_offset + q_lo + BQ - 1 - mask.window);
    };
    float acc[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.0f;
    float m[2] = {flash::kNegInf, flash::kNegInf};   // log2 domain, finite
    float l[2] = {0.0f, 0.0f};                       // this thread's part

    // the item's query tiles; waited for even by a warpgroup whose rows
    // see no key (or lie past Sq): no TMA copy may still be in flight when
    // the buffer is released or the CTA exits
    mbar_wait_bounded(&s.q_full[qb], (t >> 1) & 1);
    pass_tiles(s, it, n > 0 ? kt0 - u0 : u1 - u0, lane);
    if (n > 0) {
      // Software pipeline: while tile j's P V runs on the tensor cores,
      // the warpgroup takes the softmax of tile j + 1's scores, issued
      // just before it. P lives in registers as bf16 pairs (pa), S in sc.
      const __nv_bfloat16* qs = s.q[qb][g];
      float sc[64];
#pragma unroll
      for (int x = 0; x < 64; ++x) sc[x] = 0.0f;
      uint32_t pa[8][4];
      int st = it % STAGES;
      mbar_wait_bounded(&s.k_full[st], (it / STAGES) & 1);
      wgmma_fence();
      mma_ss_k128_n128(sc, qs, s.k[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&s.k_empty[st]);
      float corr[2];
      softmax_tile(sc, m, corr, l, whole(0), row0, kt0 * BK + c_lo, Skv,
                   mask, scale_log2);
      pack_frags(pa, sc);
      for (int j = 0; j + 1 < n; ++j, ++it) {
        st = it % STAGES;
        const int nx = (it + 1) % STAGES;
        mbar_wait_bounded(&s.k_full[nx], ((it + 1) / STAGES) & 1);
        mbar_wait_bounded(&s.v_full[st], (it / STAGES) & 1);
        wgmma_fence();
        mma_ss_k128_n128(sc, qs, s.k[nx]);
        wgmma_commit();
        mma_pv(acc, pa, s.v[st]);
        wgmma_commit();
        wgmma_wait<1>();             // S of tile j + 1; P V of tile j runs
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&s.k_empty[nx]);
        float part[2] = {0.0f, 0.0f};
        softmax_tile(sc, m, corr, part, whole(j + 1), row0,
                     (kt0 + j + 1) * BK + c_lo, Skv, mask, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&s.v_empty[st]);
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + part[h];
#pragma unroll
        for (int x = 0; x < 64; ++x) acc[x] *= corr[(x >> 1) & 1];
        pack_frags(pa, sc);
      }
      st = it % STAGES;
      mbar_wait_bounded(&s.v_full[st], (it / STAGES) & 1);
      wgmma_fence();
      mma_pv(acc, pa, s.v[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&s.v_empty[st]);
      ++it;
      pass_tiles(s, it, u1 - (kt0 + n), lane);
    }
    if (lane == 0) mbar_arrive(&s.q_empty[qb]);   // the item's Q is free
    if (q_lo >= Sq) continue;

    // ---- o = acc / l in bf16, lse = m ln2 + log l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
      const float lc = fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = o + (plane + row) * D;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / lc,
                                  acc[4 * j + 2 * hh + 1] / lc);
      if (lse != nullptr && lane % 4 == 0)
        lse[plane + row] =
            lt > 0.0f ? m[hh] * kLn2 + logf(lt) : flash::kNegInf;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d128_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, Sched w, int Sq, int Skv,
                      float scale_log2, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], NWG * 4);   // one arrival per consumer warp
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.k_empty[i], NWG * 4);
      mbar_init(&s.v_empty[i], NWG * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == NWG * 128) produce(s, tq, tk, tv, w, Sq, Skv, mask);
  } else {
    reg_alloc<kConsumerRegs>();
    consume(s, o, lse, w, Sq, Skv, scale_log2, mask);
  }
}

static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bf16_cols_map(&tq, q, B * Hq, Sq, D, BQ);
  if (err == cudaSuccess) err = bf16_cols_map(&tk, k, B * Hkv, Skv, D, BK);
  if (err == cudaSuccess) err = bf16_cols_map(&tv, v, B * Hkv, Skv, D, BK);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem) + 1024;   // + alignment slack
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_fwd_d128_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one CTA an SM (its shared memory)
  const Sched w = make_sched(B, Hq, Hkv, Sq, sms);
  flash_fwd_d128_kernel<<<w.G, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, w, Sq, Skv, scale * kLog2e, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc128

// q: [B, Hq, Sq, 128]; k, v: [B, Hkv, Skv, 128]; o: [B, Hq, Sq, 128], all
// bf16, contiguous and 16-byte aligned; lse: [B, Hq, Sq] float32 or null.
// Hq a multiple of Hkv; window <= 0 is no window. Rows that see no key get
// o = 0 and lse = -1e30. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd_tc128(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int B, int Hq, int Hkv, int Sq,
                                         int Skv, float scale, int causal,
                                         int window, int q_offset,
                                         void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tc128::launch(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale,
                             mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_fwd_tc128_smem() {
  return (int)sizeof(flash_tc128::Smem) + 1024;
}
