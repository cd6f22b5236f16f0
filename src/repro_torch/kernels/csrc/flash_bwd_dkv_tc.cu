// Flash-attention backward, dK and dV, on Hopper's tensor cores (sm_90a),
// bf16, D 64.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's second pallas_call (body _bwd_dkv_kernel) for bf16
// inputs at head_dim 64, the route the training and distillation paths
// run; flash_bwd_dkv.cu keeps float32 and the other head widths. For each
// key j of KV head hk it sums, over every query head of hk's GQA group and
// every query row i that sees j,
//   dV_j += p_ij dO_i   and   dK_j += dS_ij q_i,
// with p = exp(s - lse) recomputed and dS = p (dO_i.v_j - delta_i) scale;
// float32 accumulators, written as bf16.
//
// Numerics: s and dP = dO.v take bf16 operands with float32 accumulation
// (each product exact); p and dS are float32, then rounded once to bf16
// as the A operands of the dV and dK products, which accumulate in
// float32.
//
// What bounds it on an H100: operations, four 64-deep products per
// visible (query, key) pair: 17.2 GFLOP at the training shape against
// 34 MB.
//
// What the design does about it: the kernel works in the transposed frame,
// keys as the MMA's rows, so that all four products are wgmmas and
// neither P nor dS goes through shared memory:
//   S^T  = K Q^T    A = the warpgroup's 64 K rows, B = the Q tile
//   dP^T = V dO^T   A = its 64 V rows,  B = the dO tile
//   dV  += P^T dO   A = P^T, bf16 in registers from S^T's accumulator;
//                   B = the dO tile read MN-major (transpose bit)
//   dK  += dS^T Q   A = dS^T in registers; B = the Q tile, MN-major.
// One CTA owns 64 * NWG keys of one KV head (NWG = 2 consumer warpgroups
// of 64 keys), K and V loaded once by TMA and kept in shared memory, the
// dK and dV accumulators in registers for the whole walk. Two producer
// warps stream the walk's tiles through a STAGES-deep ring: one thread
// loads 64-row Q and dO tiles of every query head of the group by TMA,
// the second warp copies their rows' lse and delta beside them. Only the
// query tiles that can see the CTA's keys (live_rows) are visited, and a
// warpgroup skips the products of a tile none of whose rows sees its own
// keys. A warpgroup
// issues a tile's S^T and dP^T, forms P and dS from them, and issues the
// tile's dV and dK products; the other warpgroup's products fill the
// tensor cores while it forms P and dS. (Leaving dV and dK running into
// the next tile keeps 128 accumulator registers in flight, more than the
// 168 a thread ptxas allows here: it then serializes every wgmma.) The
// element mask is applied only on tiles that cross the diagonal, the
// window's edge, Sq or Skv. No atomics: a CTA owns its keys' rows and
// walks heads and tiles in a fixed order, so the result is the same bit
// for bit on every run. The key tile is the grid's slow axis,
// first tile (heaviest under a causal mask) first.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tc_bwd {

using namespace hopper;

constexpr int D = 64;
constexpr int BQ = 64;          // query rows of a tile (the MMAs' N)
constexpr int BKW = 64;         // keys of a consumer warpgroup (wgmma M)
constexpr int NWG = 2;          // consumer warpgroups
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BQ * D * 2;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 k[NWG * BKW * D];
  __nv_bfloat16 v[NWG * BKW * D];
  __nv_bfloat16 q[STAGES][BQ * D];
  __nv_bfloat16 dout[STAGES][BQ * D];
  float lse2[STAGES][BQ];    // lse * log2(e) of the tile's rows
  float delta[STAGES][BQ];
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

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
  mbar_expect_tx(&s.kv_full, 2 * NWG * BKW * D * 2);
  tma_load_3d(s.k, &tk, &s.kv_full, 0, k_lo, kvplane);
  tma_load_3d(s.v, &tv, &s.kv_full, 0, k_lo, kvplane);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
    tma_load_3d(s.q[st], &tq, &s.full[st], 0, w.r0(i), w.plane(i));
    tma_load_3d(s.dout[st], &tdo, &s.full[st], 0, w.r0(i), w.plane(i));
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
    mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
#pragma unroll
    for (int e = lane; e < BQ; e += 32) {
      const int row = w.r0(i) + e;
      s.lse2[st][e] = row < Sq ? lse[plane + row] * kLog2e : 0.0f;
      s.delta[st][e] = row < Sq ? delta[plane + row] : 0.0f;
    }
    mbar_arrive(&s.full[st]);
  }
}

// A consumer warpgroup wg: keys kw_lo .. kw_lo + 63 of the CTA's 64 * NWG;
// returns with its dK and dV rows written.
__device__ __forceinline__ void consume(Smem& s, __nv_bfloat16* dk,
                                        __nv_bfloat16* dv, int kvplane,
                                        int Sq, int Skv, int k_lo,
                                        const Walk& w, float scale,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int kw_lo = k_lo + wg * BKW;
  const int key_lo = 16 * (warp % 4) + lane / 4;   // keys key_lo, key_lo + 8
  const int c_lo = 2 * (lane % 4);                 // rows + 8j + {0, 1}
  int my_begin = 0, my_end = 0;                    // rows that see my keys
  if (kw_lo < Skv)
    flash::live_rows(mask, kw_lo, min(Skv, kw_lo + BKW) - 1, Sq, &my_begin,
                     &my_end);
  float dka[32], dva[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.0f;
  const float scale_log2 = scale * kLog2e;

  // Per tile: S^T and dP^T are issued; when they are done P and dS are
  // formed and the tile's dV and dK products issued; when those are done
  // the stage is released.
  mbar_wait(&s.kv_full, 0);
  const __nv_bfloat16* kw = s.k + wg * BKW * D;    // my K and V rows
  const __nv_bfloat16* vw = s.v + wg * BKW * D;
  for (int i = 0; i < w.n_tiles; ++i) {
    const int st = i % STAGES;
    const int r0 = w.r0(i);
    mbar_wait(&s.full[st], (i / STAGES) & 1);
    if (r0 >= my_end || r0 + BQ <= my_begin) {   // no row sees my keys
      if (lane == 0) mbar_arrive(&s.empty[st]);
      continue;
    }
    float sa[32], dpa[32];
    wgmma_fence();
    mma_ss_k64(sa, kw, s.q[st]);
    mma_ss_k64(dpa, vw, s.dout[st]);
    wgmma_commit();
    const bool whole =
        r0 + BQ <= Sq && kw_lo + BKW <= Skv &&
        (!mask.causal || kw_lo + BKW - 1 <= mask.q_offset + r0) &&
        (mask.window <= 0 ||
         kw_lo > mask.q_offset + r0 + BQ - 1 - mask.window);

    wgmma_wait<0>();       // S^T and dP^T
    fence_regs(sa);
    fence_regs(dpa);
    if (!whole) {          // masked pairs: s = -inf, so p = 0
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int key = kw_lo + key_lo + 8 * ((x >> 1) & 1);
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
      const int col = 8 * (x >> 2) + c_lo + (x & 1);   // query row - r0
      sa[x] = ex2(fmaf(sa[x], scale_log2, -lse2[col]));
      dpa[x] = sa[x] * (dpa[x] - dl[col]) * scale;
    }
    uint32_t pa[4][4], da[4][4];
    pack_frag(pa, sa);
    pack_frag(da, dpa);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    mma_rs_k64(dva, pa, s.dout[st]);
    mma_rs_k64(dka, da, s.q[st]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }

  // ---- epilogue: the warpgroup's 64 rows of dK and dV as bf16
  const size_t kplane = (size_t)kvplane * Skv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kw_lo + key_lo + 8 * hh;
    if (key >= Skv) continue;
    __nv_bfloat16* dkrow = dk + (kplane + key) * D;
    __nv_bfloat16* dvrow = dv + (kplane + key) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = 4 * j + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * j + c_lo) =
          __floats2bfloat162_rn(dka[x], dka[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * j + c_lo) =
          __floats2bfloat162_rn(dva[x], dva[x + 1]);
    }
  }
}

__global__ void __launch_bounds__(NWG * 128 + 64, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
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
  const int k_lo = blockIdx.y * NWG * BKW;
  int r_begin, r_end;
  flash::live_rows(mask, k_lo, min(Skv, k_lo + NWG * BKW) - 1, Sq, &r_begin,
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
      mbar_init(&s.empty[i], NWG * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == NWG * 4) {                          // the TMA warp
    if (threadIdx.x % 32 == 0)
      produce_tiles(s, tq, tk, tv, tdo, k_lo, b * Hkv + hk, w);
  } else if (warp == NWG * 4 + 1) {               // the statistics warp
    produce_stats(s, lse, delta, Sq, w);
  } else {
    consume(s, dk, dv, b * Hkv + hk, Sq, Skv, k_lo, w, scale, mask);
  }
}

static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                  int Skv, float scale, flash::Mask mask,
                  cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bf16_rows_map(&tq, q, B * Hq, Sq, BQ);
  if (err == cudaSuccess) err = bf16_rows_map(&tdo, dout, B * Hq, Sq, BQ);
  if (err == cudaSuccess)
    err = bf16_rows_map(&tk, k, B * Hkv, Skv, NWG * BKW);
  if (err == cudaSuccess)
    err = bf16_rows_map(&tv, v, B * Hkv, Skv, NWG * BKW);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem) + 1024;   // + alignment slack
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(B * Hkv, (Skv + NWG * BKW - 1) / (NWG * BKW));
  flash_bwd_dkv_wgmma_kernel<<<grid, NWG * 128 + 64, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      Hq, Hkv, Sq, Skv, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc_bwd

// q, dout: [B, Hq, Sq, 64]; k, v, dk, dv: [B, Hkv, Skv, 64], all bf16,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Mask
// arguments as flash_attention_fwd_tc. Returns cudaGetLastError() of the
// launch.
extern "C" int flash_attention_bwd_dkv_tc(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse,
                                          const float* delta, void* dk,
                                          void* dv, int B, int Hq, int Hkv,
                                          int Sq, int Skv, float scale,
                                          int causal, int window,
                                          int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tc_bwd::launch(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv,
                              Sq, Skv, scale, mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_bwd_dkv_tc_smem() {
  return (int)sizeof(flash_tc_bwd::Smem) + 1024;
}
