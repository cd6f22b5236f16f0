// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a), bf16,
// D 64.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's third pallas_call (body _bwd_dq_kernel) for bf16
// inputs at head_dim 64, the route the training and distillation paths
// run; flash_bwd_dq.cu keeps float32 and the other head widths. For each
// query row i of query head h it sums, over the keys j that i sees,
//   dQ_i += dS_ij k_j,   dS_ij = p_ij (dO_i.v_j - delta_i) scale,
// with p = exp(s - lse) recomputed from the forward's lse; a float32
// accumulator, written as bf16.
//
// Numerics: s = q.k and dP = dO.v take bf16 operands with float32
// accumulation (each product exact); p and dS are float32, then dS is
// rounded once to bf16 as the A operand of the dQ product, which
// accumulates in float32. Masked pairs get p = 0 exactly.
//
// What bounds it on an H100: operations, three 64-deep products per
// visible (query, key) pair: 12.9 GFLOP at the training shape (B 4, Hq 16,
// Hkv 8, S 1024, causal) against 34 MB.
//
// What the design does about it: dQ walks K/V tiles for fixed query rows,
// as the forward does, and borrows its layout (flash_fwd_tc.cu):
//   * a CTA serves the NWG query heads of one KV head's GQA group in
//     consumer warpgroups, one head each (NWG = 2 when the group is even,
//     else 1), so every K/V tile is read once for both heads, and walks
//     two 64-row query tiles, one from each end of the sequence, so every
//     CTA has about the same work under a causal mask;
//   * a producer warp (one issuing thread) loads each query tile's Q and
//     dO once and keeps a STAGES-deep ring of 64-key K and V tiles in
//     flight by TMA (3-D tensor maps, so rows past Skv read as zeros);
//   * per live key tile, S = Q K^T and dP = dO V^T are wgmmas with both
//     operands in shared memory (Q, dO, K and V all K-major as stored);
//     P and dS are formed on their accumulator fragments, dS is packed to
//     bf16 in registers as the A operand of dQ += dS K, whose B is the K
//     tile read MN-major (the transpose bit): nothing but the TMA tiles
//     touches shared memory;
//   * tile j + 1's S and dP are issued right behind tile j's dQ product,
//     so the tensor cores see three products back to back; the other
//     warpgroup's products fill them while this one forms P and dS;
//   * the element mask is applied only to tiles that cross the causal
//     diagonal, the window's edge or Skv; only the live KV tiles
//     (live_keys) are visited. No atomics: each CTA owns its dQ rows and
//     sums its key tiles in a fixed order, so the result is the same bit
//     for bit on every run.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tc_dq {

using namespace hopper;

constexpr int D = 64;
constexpr int BQ = 64;          // query rows of a warpgroup (wgmma M)
constexpr int BK = 64;          // keys of a K/V tile
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BQ * D * 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int NWG>
struct Smem {
  __nv_bfloat16 q[2][NWG][BQ * D];    // the CTA's (up to) two query tiles
  __nv_bfloat16 dout[2][NWG][BQ * D];
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full[2];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// The CTA's work, as the forward's: query tiles qt[0] and, when n_q == 2,
// qt[1] of the NWG heads qplane .. qplane + NWG - 1, which read KV plane
// kvplane.
struct Work {
  int qplane, kvplane, n_q;
  int qt[2];
};

// The live 64-key tiles [kt0, kt0 + n) of the query tile at q_lo.
__device__ __forceinline__ void live_tiles(const flash::Mask& mask, int q_lo,
                                           int Sq, int Skv, int* kt0,
                                           int* n) {
  int k_begin, k_end;
  flash::live_keys(mask, q_lo, min(Sq, q_lo + BQ) - 1, Skv, &k_begin,
                   &k_end);
  *kt0 = k_begin / BK;
  *n = k_end > k_begin ? (k_end + BK - 1) / BK - *kt0 : 0;
}

// The producer: one thread loads each query tile's Q and dO once and
// keeps the K/V ring full across both query tiles.
template <int NWG>
__device__ __forceinline__ void produce(Smem<NWG>& s, const CUtensorMap& tq,
                                        const CUtensorMap& tdo,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const Work& w, int Sq, int Skv,
                                        const flash::Mask& mask) {
  int it = 0;
  for (int t = 0; t < w.n_q; ++t) {
    const int q_lo = w.qt[t] * BQ;
    int kt0, n;
    live_tiles(mask, q_lo, Sq, Skv, &kt0, &n);
    mbar_expect_tx(&s.q_full[t], 2 * NWG * TILE_BYTES);
    for (int g = 0; g < NWG; ++g) {
      tma_load_3d(s.q[t][g], &tq, &s.q_full[t], 0, q_lo, w.qplane + g);
      tma_load_3d(s.dout[t][g], &tdo, &s.q_full[t], 0, q_lo, w.qplane + g);
    }
    for (int i = 0; i < n; ++i, ++it) {
      const int st = it % STAGES;
      mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], 2 * TILE_BYTES);
      tma_load_3d(s.k[st], &tk, &s.full[st], 0, (kt0 + i) * BK, w.kvplane);
      tma_load_3d(s.v[st], &tv, &s.full[st], 0, (kt0 + i) * BK, w.kvplane);
    }
  }
}

// A consumer warpgroup wg: query head qplane + wg, rows q_lo .. q_lo + 63
// of each of the CTA's query tiles.
template <int NWG>
__device__ __forceinline__ void consume(Smem<NWG>& s, __nv_bfloat16* dq,
                                        const float* lse, const float* delta,
                                        const Work& w, int Sq, int Skv,
                                        float scale,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int c_lo = 2 * (lane % 4);                      // + 8j + {0, 1}
  const size_t plane = (size_t)(w.qplane + wg) * Sq;
  const float scale_log2 = scale * kLog2e;
  int it = 0;                                           // ring position
  for (int t = 0; t < w.n_q; ++t) {
    const int q_lo = w.qt[t] * BQ;
    const int row0 = q_lo + 16 * (warp % 4) + lane / 4;   // and row0 + 8
    int kt0, n;
    live_tiles(mask, q_lo, Sq, Skv, &kt0, &n);
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
    float acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.0f;

    // Per tile j: P and dS from S and dP (issued with tile j - 1's dQ
    // product), dS packed to bf16; once tile j + 1's K/V has landed, its
    // S and dP are issued right behind tile j's dQ product, so the tensor
    // cores see three products back to back, and all three are waited
    // for together. No wgmma is in flight while the warpgroup spins on a
    // barrier.
    mbar_wait(&s.q_full[t], 0);
    const __nv_bfloat16* qs = s.q[t][wg];
    const __nv_bfloat16* dos = s.dout[t][wg];
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
    if (n > 0) {
      const int st = it % STAGES;
      mbar_wait(&s.full[st], (it / STAGES) & 1);
      wgmma_fence();
      mma_ss_k64(sa, qs, s.k[st]);
      mma_ss_k64(dpa, dos, s.v[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);
      for (int j = 0; j + 1 < n; ++j, ++it) {
        const int st = it % STAGES, nx = (it + 1) % STAGES;
        form_ds(j);
        mbar_wait(&s.full[nx], ((it + 1) / STAGES) & 1);
        wgmma_fence();
        mma_rs_k64(acc, da, s.k[st]);
        mma_ss_k64(sa, qs, s.k[nx]);
        mma_ss_k64(dpa, dos, s.v[nx]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(sa);
        fence_regs(dpa);
        if (lane == 0) mbar_arrive(&s.empty[st]);
      }
      form_ds(n - 1);
      wgmma_fence();
      mma_rs_k64(acc, da, s.k[it % STAGES]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&s.empty[it % STAGES]);
      ++it;
    }

    // ---- dQ rows as bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
      __nv_bfloat16* drow = dq + (plane + row) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                  acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Hq, int Hkv,
                          int Sq, int Skv, float scale, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NWG>& s = *reinterpret_cast<Smem<NWG>*>(align1024(smem_raw));
  const int groups = Hq / NWG;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * NWG;
  Work w;
  w.qplane = b * Hq + h0;
  w.kvplane = b * Hkv + h0 / (Hq / Hkv);
  const int nqt = (Sq + BQ - 1) / BQ;
  w.qt[0] = nqt - 1 - blockIdx.y;
  w.qt[1] = blockIdx.y;
  w.n_q = w.qt[1] < w.qt[0] ? 2 : 1;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full[0], 1);
    mbar_init(&s.q_full[1], 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], NWG * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {                 // the producer warp
    if (threadIdx.x == NWG * 128)
      produce(s, tq, tdo, tk, tv, w, Sq, Skv, mask);
  } else {
    consume(s, dq, lse, delta, w, Sq, Skv, scale, mask);
  }
}

template <int NWG>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = bf16_rows_map(&tq, q, B * Hq, Sq, BQ);
  if (err == cudaSuccess) err = bf16_rows_map(&tdo, dout, B * Hq, Sq, BQ);
  if (err == cudaSuccess) err = bf16_rows_map(&tk, k, B * Hkv, Skv, BK);
  if (err == cudaSuccess) err = bf16_rows_map(&tv, v, B * Hkv, Skv, BK);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem<NWG>) + 1024;   // + alignment slack
  auto kernel = flash_bwd_dq_wgmma_kernel<NWG>;
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int nqt = (Sq + BQ - 1) / BQ;
  const dim3 grid(B * Hq / NWG, (nqt + 1) / 2);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, (__nv_bfloat16*)dq, Hq, Hkv, Sq, Skv,
      scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc_dq

// q, dout, dq: [B, Hq, Sq, 64]; k, v: [B, Hkv, Skv, 64], all bf16,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Mask
// arguments as flash_attention_fwd_tc. Returns cudaGetLastError() of the
// launch.
extern "C" int flash_attention_bwd_dq_tc(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse,
                                         const float* delta, void* dq, int B,
                                         int Hq, int Hkv, int Sq, int Skv,
                                         float scale, int causal, int window,
                                         int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if ((Hq / Hkv) % 2 == 0)
    return flash_tc_dq::launch<2>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                  Sq, Skv, scale, mask, st);
  return flash_tc_dq::launch<1>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                Sq, Skv, scale, mask, st);
}

// Dynamic shared memory of a CTA with nwg consumer warpgroups, in bytes.
extern "C" int flash_attention_bwd_dq_tc_smem(int nwg) {
  return nwg == 1 ? (int)sizeof(flash_tc_dq::Smem<1>) + 1024
                  : (int)sizeof(flash_tc_dq::Smem<2>) + 1024;
}
