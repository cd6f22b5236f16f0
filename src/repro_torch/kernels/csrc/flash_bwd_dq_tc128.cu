// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a), bf16,
// D 128.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's third pallas_call (body _bwd_dq_kernel) for bf16
// inputs at head_dim 128, the route the dense configs (qwen2.5-32b,
// qwen3-14b, qwen3-32b, yi-34b) train on; flash_bwd_dq_tc.cu keeps head_dim
// 64 and flash_bwd_dq.cu float32 and head_dim 32. For each query row i of
// query head h it sums, over the keys j that i sees,
//   dQ_i += dS_ij k_j,   dS_ij = p_ij (dO_i.v_j - delta_i) scale,
// with p = exp(s - lse) recomputed from the forward's lse; a float32
// accumulator, written as bf16. Masks are flash_attention.cuh's (causal,
// window, q_offset); masked pairs get p = 0 exactly.
//
// Numerics, as flash_bwd_dq_tc.cu: s = q.k and dP = dO.v take bf16
// operands with float32 accumulation; p and dS are float32, then dS is
// rounded once to bf16 as the A operand of the dQ product, which
// accumulates in float32. No atomics: a warpgroup owns its 64 dQ rows and
// sums its key tiles in a fixed order, so the result is the same bit for
// bit on every run.
//
// What bounds it on an H100: operations, three 128-deep or 128-wide
// products per visible (query, key) pair: 32.2 GFLOP at qwen3-14b's
// training shape (B 2, Hq 40, Hkv 8, S 1024, causal) against 72 MB.
//
// What the design does about it: dQ walks K/V tiles for fixed query rows,
// as the forward does, and takes the forward's schedule
// (flash_fwd_tc128.cu):
//   * a CTA's two consumer warpgroups take two neighbouring 64-row query
//     tiles of one head (rows 128 p .. 128 p + 127), whatever the GQA
//     group, and share every 64-key K/V tile of the pair. The grid is
//     persistent, one CTA an SM: the pairs are dealt out heaviest first in
//     a snake over the CTAs (Sched), so under a causal mask every CTA has
//     about the same work; the next pair's Q and dO tiles load while the
//     current pair runs (two buffers);
//   * a producer warpgroup (one issuing thread) loads each pair's Q and dO
//     once and keeps a STAGES-deep ring of K and V tiles in flight by TMA.
//     A 128-wide row is two 64-column boxes (the 128-byte swizzle takes 64
//     bf16 at most), so every tile is two halves; 3-D tensor maps, rows
//     past Sq or Skv read as zeros. Each thread reads its two rows' lse and
//     delta before it waits for the pair's tiles (the loads overlap the
//     wait): two Q/dO buffers and three K/V stages fill the shared memory;
//   * per live key tile, S = Q K^T and dP = dO V^T are 64 x 64 products
//     over the two halves of D (mma_ss_k128, both operands K-major in
//     shared memory); P and dS are formed on their accumulator fragments,
//     dS is packed to bf16 in registers as the A operand of dQ += dS K, one
//     m64n128 wgmma a 16-key step whose B is the K tile read MN-major, the
//     descriptor's LBO stepping from the first column half to the second
//     (mma_rs_n128): nothing but the TMA tiles touches shared memory;
//   * tile j + 1's S and dP are issued right behind tile j's dQ product,
//     so the tensor cores see three products back to back; the other
//     warpgroup's products fill them while this one forms P and dS;
//   * dQ (64), S (32), dP (32) and the dS fragments (16) are more
//     registers a thread than ptxas allots a thread of a 384-thread CTA
//     (168), so the producer warpgroup keeps 24 and the consumers take 240
//     (setmaxnreg; their waits cannot trap, mbar_wait_bounded, or ptxas
//     holds them to the 168);
//   * the element mask is applied only to tiles that cross the causal
//     diagonal, the window's edge or Skv; a warpgroup passes over the
//     pair's tiles that its own rows cannot see.
#include "flash_attention.cuh"
#include "flash_tc128.cuh"
#include "hopper.cuh"

namespace flash_tc128_dq {

using namespace hopper;
using flash_tc128::Sched;
using flash_tc128::live_tiles;
using flash_tc128::pair_tiles;

constexpr int D = 128;
constexpr int BQ = 64;          // query rows of a warpgroup (wgmma M)
constexpr int BK = 64;          // keys of a K/V tile
constexpr int NWG = 2;          // consumer warpgroups: a pair of query tiles
constexpr int STAGES = 3;       // of the K/V ring
constexpr int kThreads = (NWG + 1) * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;   // (NWG * 240 + 24) * 128 <= 64 K
constexpr int TILE_BYTES = 64 * D * 2;   // a [64, 128] tile: two halves
constexpr int HALF = 64 * 64;            // elements of a half tile
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 q[2][NWG][BQ * D];      // [item parity][warpgroup]
  __nv_bfloat16 dout[2][NWG][BQ * D];
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full[2], q_empty[2];
  uint64_t full[STAGES], empty[STAGES];
};

// The work (Sched, live_tiles, pair_tiles) is the forward's,
// flash_tc128.cuh's, over 64-key tiles.
static_assert(BQ == flash_tc128::kPairRows, "flash_tc128.cuh's tiles");

// The producer: one thread loads each item's Q and dO tiles once, into the
// item's parity's buffers when the consumers have released them, and
// keeps the K/V ring full across the items.
__device__ __forceinline__ void produce(Smem& s, const CUtensorMap& tq,
                                        const CUtensorMap& tdo,
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
    mbar_expect_tx(&s.q_full[qb], 2 * nq * TILE_BYTES);
    for (int g = 0; g < nq; ++g)
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(s.q[qb][g] + h * HALF, &tq, &s.q_full[qb], 64 * h,
                    q_lo + g * BQ, w.qplane(i));
        tma_load_3d(s.dout[qb][g] + h * HALF, &tdo, &s.q_full[qb], 64 * h,
                    q_lo + g * BQ, w.qplane(i));
      }
    int u0, u1;
    pair_tiles<BK>(mask, w.pair(i), Sq, Skv, &u0, &u1);
    for (int j = u0; j < u1; ++j, ++it) {
      const int st = it % STAGES;
      mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
      for (int h = 0; h < 2; ++h) {
        tma_load_3d(s.k[st] + h * HALF, &tk, &s.full[st], 64 * h, j * BK,
                    w.kvplane(i));
        tma_load_3d(s.v[st] + h * HALF, &tv, &s.full[st], 64 * h, j * BK,
                    w.kvplane(i));
      }
    }
  }
}

// Wait for and release `count` ring tiles that this warpgroup does not
// use (the other one does); `it` is the ring position.
__device__ __forceinline__ void pass_tiles(Smem& s, int& it, int count,
                                           int lane) {
  for (int c = 0; c < count; ++c, ++it) {
    const int st = it % STAGES;
    mbar_wait_bounded(&s.full[st], (it / STAGES) & 1);
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }
}

// A consumer warpgroup g: query tile 2 pr + g of each of the CTA's items.
__device__ __forceinline__ void consume(Smem& s, __nv_bfloat16* dq,
                                        const float* lse, const float* delta,
                                        const Sched& w, int Sq, int Skv,
                                        float scale,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;
  const int c_lo = 2 * (lane % 4);                      // + 8j + {0, 1}
  const float scale_log2 = scale * kLog2e;
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
    // this thread's two rows' lse (log2 domain) and delta; rows past Sq
    // read zeros (their Q and dO rows are zeros, and they are not stored)
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      lse2[h] = row < Sq ? lse[plane + row] * kLog2e : 0.0f;
      dl[h] = row < Sq ? delta[plane + row] : 0.0f;
    }
    float acc[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.0f;

    // the item's Q and dO tiles; waited for even by a warpgroup whose rows
    // see no key (or lie past Sq): no TMA copy may still be in flight when
    // the buffer is released or the CTA exits
    mbar_wait_bounded(&s.q_full[qb], (t >> 1) & 1);
    pass_tiles(s, it, n > 0 ? kt0 - u0 : u1 - u0, lane);
    if (n > 0) {
      // Per tile j: P and dS from S and dP (issued with tile j - 1's dQ
      // product), dS packed to bf16; once tile j + 1's K/V has landed, its
      // S and dP are issued right behind tile j's dQ product, and all
      // three are waited for together. No wgmma is in flight while the
      // warpgroup spins on a barrier.
      const __nv_bfloat16* qs = s.q[qb][g];
      const __nv_bfloat16* dos = s.dout[qb][g];
      float sa[32], dpa[32];
      uint32_t da[4][4];
      // P and dS of the tile whose S and dP sit in sa and dpa, packed to
      // bf16 into da
      auto form_ds = [&](int j) {
        if (!whole(j)) {        // masked pairs: s = -inf, so p = 0
          const int key0 = (kt0 + j) * BK + c_lo;
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int qp = mask.q_offset + row0 + 8 * ((x >> 1) & 1);
            const int key = key0 + 8 * (x >> 2) + (x & 1);
            const bool ok = (key < Skv) & (!mask.causal | (key <= qp)) &
                            ((mask.window <= 0) | (key > qp - mask.window));
            sa[x] = ok ? sa[x] : -INFINITY;
          }
        }
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int h = (x >> 1) & 1;
          const float p = ex2(fmaf(sa[x], scale_log2, -lse2[h]));
          dpa[x] = p * (dpa[x] - dl[h]) * scale;
        }
        pack_frag(da, dpa);
      };
      int st = it % STAGES;
      mbar_wait_bounded(&s.full[st], (it / STAGES) & 1);
      wgmma_fence();
      mma_ss_k128(sa, qs, s.k[st]);
      mma_ss_k128(dpa, dos, s.v[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);
      for (int j = 0; j + 1 < n; ++j, ++it) {
        st = it % STAGES;
        const int nx = (it + 1) % STAGES;
        form_ds(j);
        mbar_wait_bounded(&s.full[nx], ((it + 1) / STAGES) & 1);
        fence_regs(acc);
        wgmma_fence();
        mma_rs_n128<64>(acc, da, s.k[st]);
        mma_ss_k128(sa, qs, s.k[nx]);
        mma_ss_k128(dpa, dos, s.v[nx]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(sa);
        fence_regs(dpa);
        if (lane == 0) mbar_arrive(&s.empty[st]);
      }
      st = it % STAGES;
      form_ds(n - 1);
      fence_regs(acc);
      wgmma_fence();
      mma_rs_n128<64>(acc, da, s.k[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&s.empty[st]);
      ++it;
      pass_tiles(s, it, u1 - (kt0 + n), lane);
    }
    if (lane == 0) mbar_arrive(&s.q_empty[qb]);   // the item's Q/dO free
    if (q_lo >= Sq) continue;

    // ---- dQ rows as bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
      __nv_bfloat16* drow = dq + (plane + row) * D;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                  acc[4 * j + 2 * hh + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_d128_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Sched w, int Sq,
                         int Skv, float scale, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], NWG * 4);   // one arrival per consumer warp
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], NWG * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == NWG * 128)
      produce(s, tq, tdo, tk, tv, w, Sq, Skv, mask);
  } else {
    reg_alloc<kConsumerRegs>();
    consume(s, dq, lse, delta, w, Sq, Skv, scale, mask);
  }
}

static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bf16_cols_map(&tq, q, B * Hq, Sq, D, BQ);
  if (err == cudaSuccess) err = bf16_cols_map(&tdo, dout, B * Hq, Sq, D, BQ);
  if (err == cudaSuccess) err = bf16_cols_map(&tk, k, B * Hkv, Skv, D, BK);
  if (err == cudaSuccess) err = bf16_cols_map(&tv, v, B * Hkv, Skv, D, BK);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem) + 1024;   // + alignment slack
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_dq_d128_kernel,
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
  const Sched w = flash_tc128::make_sched(B, Hq, Hkv, Sq, sms);
  flash_bwd_dq_d128_kernel<<<w.G, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, (__nv_bfloat16*)dq, w, Sq, Skv, scale,
      mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc128_dq

// q, dout, dq: [B, Hq, Sq, 128]; k, v: [B, Hkv, Skv, 128], all bf16,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Hq a
// multiple of Hkv; mask arguments as flash_attention_fwd_tc128. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_bwd_dq_tc128(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dq,
                                            int B, int Hq, int Hkv, int Sq,
                                            int Skv, float scale, int causal,
                                            int window, int q_offset,
                                            void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tc128_dq::launch(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                Sq, Skv, scale, mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_bwd_dq_tc128_smem() {
  return (int)sizeof(flash_tc128_dq::Smem) + 1024;
}
