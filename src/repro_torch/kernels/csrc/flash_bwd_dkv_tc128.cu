// Flash-attention backward, dK and dV, on Hopper's tensor cores (sm_90a),
// bf16, D 128.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's second pallas_call (body _bwd_dkv_kernel) for bf16
// inputs at head_dim 128, the route the dense configs train on;
// flash_bwd_dkv_tc.cu keeps head_dim 64 and flash_bwd_dkv.cu float32 and
// head_dim 32. For each key j of KV head hk it sums, over every query
// head of hk's GQA group and every query row i that sees j,
//   dV_j += p_ij dO_i   and   dK_j += dS_ij q_i,
// with p = exp(s - lse) recomputed and dS = p (dO_i.v_j - delta_i) scale;
// float32 accumulators, written as bf16.
//
// Numerics, as flash_bwd_dkv_tc.cu: s and dP = dO.v take bf16 operands
// with float32 accumulation; p and dS are float32, then rounded once to
// bf16 as the A operands of the dV and dK products, which accumulate in
// float32.
//
// What bounds it on an H100: operations, four 128-deep or 128-wide
// products per visible (query, key) pair: 43.0 GFLOP at qwen3-14b's
// training shape (B 2, Hq 40, Hkv 8, S 1024, causal) against 34 MB.
//
// What the design does about it: the kernel works in the transposed frame,
// keys as the MMA's rows, so that all four products are wgmmas and
// neither P nor dS goes through shared memory:
//   S^T  = K Q^T    A = the CTA's 64 K rows, B = the Q tile (mma_ss_k128:
//                   128 deep over two column halves)
//   dP^T = V dO^T   A = its 64 V rows,  B = the dO tile
//   dV  += P^T dO   A = P^T, bf16 in registers from S^T's accumulator;
//                   B = the dO tile read MN-major, one m64n128 wgmma a
//                   16-row step (mma_rs_n128)
//   dK  += dS^T Q   A = dS^T in registers; B = the Q tile, MN-major.
// A CTA owns 64 keys of one KV head, K and V loaded once by TMA (two
// 64-column boxes a 128-wide row) and kept in shared memory. Its walk
// visits, for every query head of the group, the 64-row query tiles that
// can see those keys (live_rows); two consumer warpgroups take the walk's
// tiles in turn (even, odd), each summing its own dK and dV over its
// tiles, and at the end each adds the other's half of the sums (dK meets
// in warpgroup 0, dV in warpgroup 1) through shared memory: two partial
// sums, always added in the same order, so the result is the same bit for
// bit on every run, with no atomics. Two warpgroups on the same 64 keys,
// rather than 64 keys each of a 128-key CTA, halve the longest CTA's time
// under a causal mask (the CTA of the first keys walks every query tile,
// that of the last keys one) and double the CTAs, 256 at the shape above.
// A producer warpgroup streams the walk through a STAGES-deep ring (one
// thread loads the Q and dO tiles by TMA, a second warp copies the rows'
// lse and delta beside them); it keeps 24 registers a thread and the
// consumers take 240 (setmaxnreg): the dK and dV accumulators of a 64-key
// warpgroup are 128 registers a thread before S^T and dP^T (32 each),
// more than the 168 that ptxas allots each thread of a 384-thread CTA.
// The consumers' waits cannot trap (mbar_wait_bounded): with a trap in
// their code ptxas keeps them within the 168 and spills. The element mask is applied only on tiles that cross the
// diagonal, the window's edge, Sq or Skv. The key tile is the grid's slow
// axis, first tile (heaviest under a causal mask) first.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tc128_bwd {

using namespace hopper;

constexpr int D = 128;
constexpr int BQ = 64;          // query rows of a tile (the MMAs' N)
constexpr int BKC = 64;         // keys of a CTA (wgmma M)
constexpr int NWG = 2;          // consumer warpgroups, taking tiles in turn
constexpr int STAGES = 4;       // even: each consumer has STAGES / 2 stages
constexpr int HALF = 64 * 64;   // elements of a 64-column half tile
constexpr int TILE_BYTES = 64 * D * 2;
constexpr int kThreads = (NWG + 1) * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;   // (NWG * 240 + 24) * 128 <= 64 K
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 k[BKC * D];
  __nv_bfloat16 v[BKC * D];
  // the ring; once both consumers are done with it, q holds the two
  // partial sums that change hands (64 floats a thread each)
  __nv_bfloat16 q[STAGES][BQ * D];
  __nv_bfloat16 dout[STAGES][BQ * D];
  float lse2[STAGES][BQ];    // lse * log2(e) of the tile's rows
  float delta[STAGES][BQ];
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
static_assert(STAGES * BQ * D * 2 >= 2 * 64 * 128 * 4,
              "the Q ring must hold the two exchanged partial sums");

// The CTA's walk: tile i is query head hk * G + i / n_rt, rows r0(i) ..
// r0(i) + 63, for the live query tiles rt0 .. rt0 + n_rt - 1 of each head.
struct Walk {
  int qplane0;   // b * Hq + hk * G: the plane of the group's first head
  int rt0, n_rt, n_tiles;
  __device__ __forceinline__ int plane(int i) const {
    return qplane0 + i / n_rt;
  }
  __device__ __forceinline__ int r0(int i) const {
    return (rt0 + i % n_rt) * BQ;
  }
};

// The TMA thread: the CTA's K and V once, then the Q / dO ring.
__device__ __forceinline__ void produce_tiles(Smem& s, const CUtensorMap& tq,
                                              const CUtensorMap& tk,
                                              const CUtensorMap& tv,
                                              const CUtensorMap& tdo,
                                              int k_lo, int kvplane,
                                              const Walk& w) {
  mbar_expect_tx(&s.kv_full, 2 * TILE_BYTES);
  tma_load_3d(s.k, &tk, &s.kv_full, 0, k_lo, kvplane);
  tma_load_3d(s.k + HALF, &tk, &s.kv_full, 64, k_lo, kvplane);
  tma_load_3d(s.v, &tv, &s.kv_full, 0, k_lo, kvplane);
  tma_load_3d(s.v + HALF, &tv, &s.kv_full, 64, k_lo, kvplane);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
    const int r0 = w.r0(i), p = w.plane(i);
    tma_load_3d(s.q[st], &tq, &s.full[st], 0, r0, p);
    tma_load_3d(s.q[st] + HALF, &tq, &s.full[st], 64, r0, p);
    tma_load_3d(s.dout[st], &tdo, &s.full[st], 0, r0, p);
    tma_load_3d(s.dout[st] + HALF, &tdo, &s.full[st], 64, r0, p);
  }
}

// The statistics warp: each tile's lse (times log2 e) and delta rows into
// the ring beside its Q and dO, zeros past Sq; each lane's arrival
// publishes its stores.
__device__ __forceinline__ void produce_stats(Smem& s, const float* lse,
                                              const float* delta, int Sq,
                                              const Walk& w) {
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % STAGES;
    const size_t plane = (size_t)w.plane(i) * Sq;
    const int r0 = w.r0(i);
    mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
#pragma unroll
    for (int e = lane; e < BQ; e += 32) {
      const int row = r0 + e;
      s.lse2[st][e] = row < Sq ? lse[plane + row] * kLog2e : 0.0f;
      s.delta[st][e] = row < Sq ? delta[plane + row] : 0.0f;
    }
    mbar_arrive(&s.full[st]);
  }
}

// One warpgroup's 64 rows of a dK or dV sum, as bf16: `acc` in the
// accumulator fragment's layout (keys key0 and key0 + 8).
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[64],
                                           size_t kplane, int key0, int Skv,
                                           int c_lo) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= Skv) continue;
    __nv_bfloat16* row = out + (kplane + key) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int x = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c_lo) =
          __floats2bfloat162_rn(acc[x], acc[x + 1]);
    }
  }
}

// A consumer warpgroup wg: the walk's tiles wg, wg + 2, ...; returns with
// its half of the output (dK for warpgroup 0, dV for 1) written.
__device__ __forceinline__ void consume(Smem& s, __nv_bfloat16* dk,
                                        __nv_bfloat16* dv, int kvplane,
                                        int Sq, int Skv, int k_lo,
                                        const Walk& w, float scale,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int key_lo = 16 * (warp % 4) + lane / 4;   // keys key_lo, key_lo + 8
  const int c_lo = 2 * (lane % 4);                 // rows + 8j + {0, 1}
  float dka[64], dva[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) dka[x] = dva[x] = 0.0f;
  const float scale_log2 = scale * kLog2e;

  // Per tile: S^T and dP^T are issued; when they are done P and dS are
  // formed and the tile's dV and dK products issued; when those are done
  // the stage is released. The other warpgroup's products fill the tensor
  // cores meanwhile.
  mbar_wait_bounded(&s.kv_full, 0);
  for (int i = wg; i < w.n_tiles; i += NWG) {
    const int st = i % STAGES;
    const int r0 = w.r0(i);
    mbar_wait_bounded(&s.full[st], (i / STAGES) & 1);
    const __nv_bfloat16* qs = s.q[st];
    const __nv_bfloat16* dos = s.dout[st];
    float sa[32], dpa[32];
    wgmma_fence();
    mma_ss_k128(sa, s.k, qs);
    mma_ss_k128(dpa, s.v, dos);
    wgmma_commit();
    const bool whole =
        r0 + BQ <= Sq && k_lo + BKC <= Skv &&
        (!mask.causal || k_lo + BKC - 1 <= mask.q_offset + r0) &&
        (mask.window <= 0 ||
         k_lo > mask.q_offset + r0 + BQ - 1 - mask.window);
    wgmma_wait<0>();       // S^T and dP^T
    fence_regs(sa);
    fence_regs(dpa);
    if (!whole) {          // masked pairs: s = -inf, so p = 0
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int key = k_lo + key_lo + 8 * ((x >> 1) & 1);
        const int row = r0 + 8 * (x >> 2) + c_lo + (x & 1);
        const int qp = mask.q_offset + row;
        const bool ok = (row < Sq) & (key < Skv) &
                        (!mask.causal | (key <= qp)) &
                        ((mask.window <= 0) | (key > qp - mask.window));
        sa[x] = ok ? sa[x] : -INFINITY;
      }
    }
    const float* lse2 = s.lse2[st];
    const float* dl = s.delta[st];
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 8 * (x >> 2) + c_lo + (x & 1);   // row - r0
      sa[x] = ex2(fmaf(sa[x], scale_log2, -lse2[col]));
      dpa[x] = sa[x] * (dpa[x] - dl[col]) * scale;
    }
    uint32_t pa[4][4], da[4][4];
    pack_frags(pa, sa);
    pack_frags(da, dpa);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    mma_rs_n128<64>(dva, pa, dos);
    mma_rs_n128<64>(dka, da, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }

  // ---- the two warpgroups' sums meet: warpgroup 1 hands over its dK,
  // warpgroup 0 its dV, through the Q ring (free once both have passed
  // the first barrier: every tile was consumed, so no copy is in flight);
  // thread t of one warpgroup holds the same fragment slots as thread t of
  // the other, stored value-major (no bank conflict)
  const int t = threadIdx.x % 128;
  float* xk = reinterpret_cast<float*>(s.q[0]);   // warpgroup 1's dK
  float* xv = xk + 64 * 128;                      // warpgroup 0's dV
  bar_sync(1, NWG * 128);
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < 64; ++x) xk[x * 128 + t] = dka[x];
  } else {
#pragma unroll
    for (int x = 0; x < 64; ++x) xv[x * 128 + t] = dva[x];
  }
  bar_sync(2, NWG * 128);
  const size_t kplane = (size_t)kvplane * Skv;
  if (wg == 0) {
#pragma unroll
    for (int x = 0; x < 64; ++x) dka[x] += xk[x * 128 + t];
    store_rows(dk, dka, kplane, k_lo + key_lo, Skv, c_lo);
  } else {
#pragma unroll
    for (int x = 0; x < 64; ++x) dva[x] += xv[x * 128 + t];
    store_rows(dv, dva, kplane, k_lo + key_lo, Skv, c_lo);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_d128_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                          int Sq, int Skv, float scale, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k_lo = blockIdx.y * BKC;
  int r_begin, r_end;
  flash::live_rows(mask, k_lo, min(Skv, k_lo + BKC) - 1, Sq, &r_begin,
                   &r_end);
  Walk w;
  w.qplane0 = b * Hq + hk * G;
  w.rt0 = r_begin / BQ;
  w.n_rt = r_end > r_begin ? (r_end + BQ - 1) / BQ - w.rt0 : 0;
  w.n_tiles = G * w.n_rt;

  if (threadIdx.x == 0) {
    mbar_init(&s.kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1 + 32);     // the TMA thread + the stats warp
      mbar_init(&s.empty[i], 4);         // the consuming warpgroup's warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= NWG * 4) {                          // the producer warpgroup
    reg_dealloc<kProducerRegs>();
    if (warp == NWG * 4) {                        // the TMA warp
      if (threadIdx.x % 32 == 0)
        produce_tiles(s, tq, tk, tv, tdo, k_lo, b * Hkv + hk, w);
    } else if (warp == NWG * 4 + 1) {             // the statistics warp
      produce_stats(s, lse, delta, Sq, w);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    consume(s, dk, dv, b * Hkv + hk, Sq, Skv, k_lo, w, scale, mask);
  }
}

static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                  int Skv, float scale, flash::Mask mask,
                  cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_cols_map(&tq, q, B * Hq, Sq, D, BQ);
  if (err == cudaSuccess) err = bf16_cols_map(&tdo, dout, B * Hq, Sq, D, BQ);
  if (err == cudaSuccess) err = bf16_cols_map(&tk, k, B * Hkv, Skv, D, BKC);
  if (err == cudaSuccess) err = bf16_cols_map(&tv, v, B * Hkv, Skv, D, BKC);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem) + 1024;   // + alignment slack
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_d128_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(B * Hkv, (Skv + BKC - 1) / BKC);
  flash_bwd_dkv_d128_kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      Hq, Hkv, Sq, Skv, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc128_bwd

// q, dout: [B, Hq, Sq, 128]; k, v, dk, dv: [B, Hkv, Skv, 128], all bf16,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Mask
// arguments as flash_attention_fwd_tc128. Returns cudaGetLastError() of
// the launch.
extern "C" int flash_attention_bwd_dkv_tc128(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const float* lse,
                                             const float* delta, void* dk,
                                             void* dv, int B, int Hq,
                                             int Hkv, int Sq, int Skv,
                                             float scale, int causal,
                                             int window, int q_offset,
                                             void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tc128_bwd::launch(q, k, v, dout, lse, delta, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, scale, mask,
                                 (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_bwd_dkv_tc128_smem() {
  return (int)sizeof(flash_tc128_bwd::Smem) + 1024;
}
