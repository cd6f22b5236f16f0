// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16, D 64.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (body _fwd_kernel) for bf16 inputs at head_dim 64, the
// route the training and distillation paths run; flash_fwd.cu keeps
// float32 and the other head widths. q [B, Hq, Sq, 64], k/v
// [B, Hkv, Skv, 64] bf16 (query head h reads KV head h / (Hq/Hkv)) give
// o [B, Hq, Sq, 64] bf16 and, optionally, the float32 row logsumexp
// lse [B, Hq, Sq]. Query row r sits at absolute position q_offset + r;
// causal and window masks follow the reference's _mask_block, masked
// pairs get p = 0 exactly and a row that sees no key gets o = 0.
//
// Numerics: q.k takes bf16 operands with float32 accumulation (each
// product exact, as the reference's float32 upcast); the row max and sum
// and the rescaling are float32; p is rounded once to bf16 for the p.v
// product, which accumulates in float32; the row sum l is taken from the
// float32 p.
//
// What bounds it on an H100: operations. At the training shape (B 4,
// Hq 16, Hkv 8, S 1024, D 64, causal) a call needs 8.6 GFLOP against 25 MB
// of q, k, v and o: about 340 flops per byte, above the bf16 ridge.
//
// What the design does about it:
//   * a CTA serves the NWG query heads of one KV head's GQA group that it
//     holds in consumer warpgroups, one head each (NWG = 2 when the group
//     is even, else 1), so every K/V tile is read once for both heads; it
//     walks two 64-row query tiles, one from each end of the sequence, so
//     under a causal mask every CTA has about the same work, the heavier
//     tile first;
//   * a producer warp (one issuing thread) loads each query tile once and
//     keeps a STAGES-deep ring of 64-key K and V tiles in flight by TMA
//     across both query tiles: 3-D tensor maps, so rows past Skv read as
//     zeros and never as the next head's; a full and an empty mbarrier a
//     stage;
//   * S = Q K^T is a wgmma with both operands in shared memory (K is
//     K-major as stored); the online softmax runs on S's accumulator
//     fragment; P, packed to bf16 in registers, is the A operand of
//     O += P V, whose B is the V tile read MN-major (the transpose bit):
//     neither S nor P touches shared memory;
//   * software pipelining inside a warpgroup: tile j + 1's Q K^T is issued
//     together with tile j's P V, and the softmax of tile j + 1 runs while
//     P V does;
//   * the element mask is applied only to tiles that cross the causal
//     diagonal, the window's edge or Skv; only the live KV tiles
//     (live_keys) are visited.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tc {

using namespace hopper;

constexpr int D = 64;
constexpr int BQ = 64;          // query rows of a warpgroup (wgmma M)
constexpr int BK = 64;          // keys of a K/V tile
constexpr int STAGES = 3;
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BK * D * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int NWG>
struct Smem {
  __nv_bfloat16 q[2][NWG][BQ * D];   // the CTA's (up to) two query tiles
  __nv_bfloat16 k[STAGES][BK * D];
  __nv_bfloat16 v[STAGES][BK * D];
  uint64_t q_full[2];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// The CTA's work: query tiles qt[0] and, when n_q == 2, qt[1] of the NWG
// heads qplane .. qplane + NWG - 1, which read KV plane kvplane. Under a
// causal mask a tile near the end of the sequence is paired with one near
// its start, so every CTA walks about the same number of KV tiles.
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

// The producer: one thread loads each query tile's Q once and keeps the
// K/V ring full across both query tiles.
template <int NWG>
__device__ __forceinline__ void produce(Smem<NWG>& s, const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const Work& w, int Sq, int Skv,
                                        const flash::Mask& mask) {
  int it = 0;
  for (int t = 0; t < w.n_q; ++t) {
    const int q_lo = w.qt[t] * BQ;
    int kt0, n;
    live_tiles(mask, q_lo, Sq, Skv, &kt0, &n);
    mbar_expect_tx(&s.q_full[t], NWG * Q_BYTES);
    for (int g = 0; g < NWG; ++g)
      tma_load_3d(s.q[t][g], &tq, &s.q_full[t], 0, q_lo, w.qplane + g);
    for (int i = 0; i < n; ++i, ++it) {
      const int st = it % STAGES;
      mbar_wait(&s.empty[st], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], 2 * KV_BYTES);
      tma_load_3d(s.k[st], &tk, &s.full[st], 0, (kt0 + i) * BK, w.kvplane);
      tma_load_3d(s.v[st], &tv, &s.full[st], 0, (kt0 + i) * BK, w.kvplane);
    }
  }
}

// The online softmax step of one tile of raw scores sc (rows row0 and
// row0 + 8, keys key0 + 8j + {0, 1}): unless the tile is whole, masked
// pairs become -inf; the running row max m (log2 domain) moves to the
// tile's, corr is 2^(old max - new max); sc becomes p = 2^(s scale_log2
// - m) and part gains the rows' partial sums (this thread's columns).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&corr)[2],
                                             float (&part)[2], bool whole,
                                             int row0, int key0, int Skv,
                                             const flash::Mask& mask,
                                             float scale_log2) {
  if (!whole) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
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
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale_log2);   // scale > 0
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1;
    sc[x] = ex2(fmaf(sc[x], scale_log2, -m[h]));   // -inf (masked) -> 0
    part[h] += sc[x];
  }
}

// A consumer warpgroup wg: query head qplane + wg, rows q_lo .. q_lo + 63
// of each of the CTA's query tiles.
template <int NWG>
__device__ __forceinline__ void consume(Smem<NWG>& s, __nv_bfloat16* o,
                                        float* lse, const Work& w, int Sq,
                                        int Skv, float scale_log2,
                                        const flash::Mask& mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int c_lo = 2 * (lane % 4);                      // + 8j + {0, 1}
  const size_t plane = (size_t)(w.qplane + wg) * Sq;
  int it = 0;                                           // ring position
  for (int t = 0; t < w.n_q; ++t) {
    const int q_lo = w.qt[t] * BQ;
    const int row0 = q_lo + 16 * (warp % 4) + lane / 4;   // and row0 + 8
    int kt0, n;
    live_tiles(mask, q_lo, Sq, Skv, &kt0, &n);
    // a tile needs no element mask inside the diagonal, the window and Skv
    auto whole = [&](int j) {
      const int k0 = (kt0 + j) * BK;
      return k0 + BK <= Skv &&
             (!mask.causal || k0 + BK - 1 <= mask.q_offset + q_lo) &&
             (mask.window <= 0 ||
              k0 > mask.q_offset + q_lo + BQ - 1 - mask.window);
    };
    float acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
    float m[2] = {flash::kNegInf, flash::kNegInf};   // log2 domain, finite
    float l[2] = {0.0f, 0.0f};                       // this thread's part

    // Software pipeline: while tile j's P V runs on the tensor cores, the
    // warpgroup takes the softmax of tile j + 1's scores, issued just
    // before it. P lives in registers as bf16 pairs (pa), S in sc.
    mbar_wait(&s.q_full[t], 0);
    const __nv_bfloat16* qs = s.q[t][wg];
    float sc[32];
    uint32_t pa[4][4];
    if (n > 0) {
      mbar_wait(&s.full[it % STAGES], (it / STAGES) & 1);
      wgmma_fence();
      mma_ss_k64(sc, qs, s.k[it % STAGES]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float corr[2];
      softmax_tile(sc, m, corr, l, whole(0), row0, kt0 * BK + c_lo, Skv,
                   mask, scale_log2);
      pack_frag(pa, sc);
      for (int j = 0; j + 1 < n; ++j, ++it) {
        const int st = it % STAGES, nx = (it + 1) % STAGES;
        mbar_wait(&s.full[nx], ((it + 1) / STAGES) & 1);
        wgmma_fence();
        mma_ss_k64(sc, qs, s.k[nx]);
        wgmma_commit();
        mma_rs_k64(acc, pa, s.v[st]);
        wgmma_commit();
        wgmma_wait<1>();             // S of tile j + 1; P V of tile j runs
        fence_regs(sc);
        float part[2] = {0.0f, 0.0f};
        softmax_tile(sc, m, corr, part, whole(j + 1), row0,
                     (kt0 + j + 1) * BK + c_lo, Skv, mask, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&s.empty[st]);
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + part[h];
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] *= corr[(x >> 1) & 1];
        pack_frag(pa, sc);
      }
      wgmma_fence();
      mma_rs_k64(acc, pa, s.v[it % STAGES]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&s.empty[it % STAGES]);
      ++it;
    }

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
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c_lo) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / lc,
                                  acc[4 * j + 2 * hh + 1] / lc);
      if (lse != nullptr && lane % 4 == 0)
        lse[plane + row] =
            lt > 0.0f ? m[hh] * kLn2 + logf(lt) : flash::kNegInf;
    }
  }
}

template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Hq, int Hkv, int Sq,
                       int Skv, float scale_log2, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NWG>& s = *reinterpret_cast<Smem<NWG>*>(align1024(smem_raw));
  const int groups = Hq / NWG;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * NWG;
  Work w;
  w.qplane = b * Hq + h0;
  w.kvplane = b * Hkv + h0 / (Hq / Hkv);
  // pair the query tile blockIdx.y with the one as far from the end: the
  // pairs' work is even under a causal mask, the heavier tile goes first
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
    if (threadIdx.x == NWG * 128) produce(s, tq, tk, tv, w, Sq, Skv, mask);
  } else {
    consume(s, o, lse, w, Sq, Skv, scale_log2, mask);
  }
}

template <int NWG>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = bf16_rows_map(&tq, q, B * Hq, Sq, BQ);
  if (err == cudaSuccess) err = bf16_rows_map(&tk, k, B * Hkv, Skv, BK);
  if (err == cudaSuccess) err = bf16_rows_map(&tv, v, B * Hkv, Skv, BK);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem<NWG>) + 1024;   // + alignment slack
  auto kernel = flash_fwd_wgmma_kernel<NWG>;
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
      tq, tk, tv, (__nv_bfloat16*)o, lse, Hq, Hkv, Sq, Skv, scale * kLog2e,
      mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tc

// q: [B, Hq, Sq, 64]; k, v: [B, Hkv, Skv, 64]; o: [B, Hq, Sq, 64], all
// bf16, contiguous and 16-byte aligned; lse: [B, Hq, Sq] float32 or null.
// Hq a multiple of Hkv; window <= 0 is no window. Rows that see no key get
// o = 0 and lse = -1e30. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      float scale, int causal, int window,
                                      int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if ((Hq / Hkv) % 2 == 0)
    return flash_tc::launch<2>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale,
                               mask, st);
  return flash_tc::launch<1>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale,
                             mask, st);
}

// Dynamic shared memory of a CTA with nwg consumer warpgroups, in bytes.
extern "C" int flash_attention_fwd_tc_smem(int nwg) {
  return nwg == 1 ? (int)sizeof(flash_tc::Smem<1>) + 1024
                  : (int)sizeof(flash_tc::Smem<2>) + 1024;
}
