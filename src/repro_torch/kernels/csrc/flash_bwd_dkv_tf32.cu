// Flash-attention backward, dK and dV, on Hopper's tensor cores (sm_90a),
// float32, D 64, every product 3xTF32 on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's second pallas_call (body _bwd_dkv_kernel) for
// float32 inputs at head_dim 64, the route the FHDP step (flad-vision)
// and every other float32 path runs; flash_bwd_dkv.cu keeps float32 at
// head_dims 32 and 128, and flash_bwd_dkv_tc.cu bf16 at 64. It computes
// what flash_bwd_dkv.cu computes: for each key j of KV head hk, over every
// query head of hk's GQA group and every query row i that sees j,
//   dV_j += p_ij dO_i   and   dK_j += dS_ij q_i,
// with p = exp(s - lse) recomputed (0 exactly where masked) and dS =
// p (dO_i.v_j - delta_i) scale; dK and dV [B, Hkv, Skv, 64] float32.
//
// Numerics: 3xTF32 (hopper.cuh): q, k, v and dO split into tf32 big and
// small parts as they are staged, every product small.big + big.small +
// big.big on wgmma, accumulated in float32; p, dS and the scaling float32
// on the CUDA cores; P^T and dS^T split on the fly as register A
// operands.
//
// What bounds it on an H100: operations. At the FHDP step's shape (B 2,
// Hq = Hkv 12, S 256, D 64, non-causal) a call needs 805.3 MFLOP against
// 9.5 MB: 0.01202 ms at float32's 67 TFLOP/s on the CUDA cores, 0.00488 ms
// at 3xTF32's 495 / 3 TFLOP/s, 0.00283 ms for the bytes.
//
// What the design does about it: the kernel works in the transposed
// frame, keys as the MMA's rows, so that all four products are wgmmas and
// neither P nor dS goes through shared memory:
//   S^T  = K Q^T    A = the CTA's 64 K rows, B = the Q tile (as stored)
//   dP^T = V dO^T   A = its 64 V rows,       B = the dO tile (as stored)
//   dV  += P^T dO   A = P^T in registers; B = dO^T, the tile transposed
//   dK  += dS^T Q   A = dS^T in registers; B = Q^T.
// tf32 wgmma has no transpose bit, so each query tile is staged in both
// layouts, the transposed ones with their rows permuted inside each
// 8-group to match the register fragments (hopper.cuh).
//   * One CTA owns 64 keys of one KV head: 96 CTAs at the FHDP shape,
//     where the SIMT kernel's 128-key CTAs gave 48. K and V are split into
//     shared memory once; the CTA walks the group's query heads and the
//     query tiles that can see its keys (live_rows). The first key tiles
//     (the most rows under a causal mask) launch first.
//   * Two consumer warpgroups share K and V and split the walk between
//     them (warpgroup w takes tiles w, w + 2, ...), each with its own
//     stage, raw tile and dK and dV sums, on its own named barriers; at
//     the end warpgroup 0 writes dK = its sum + warpgroup 1's, and
//     warpgroup 1 dV likewise, through shared memory. (With one warpgroup
//     a CTA, each SM scheduler had a single warp, and the split passes and
//     the elementwise steps stalled on every instruction's latency.)
//   * dK and dV are sums over every row of the walk: each tile's dV and dK
//     products start from zero and are added to the float32 sums in
//     registers on the CUDA cores (the tensor cores' accumulation
//     truncates: one long wgmma sum over a 1032-row causal walk drifted
//     past the 2e-5 limit, toward zero).
//   * Query tiles of 32 rows (N = 32 for S^T and dP^T): a tile's Q, dO,
//     Q^T and dO^T as big and small tf32 take 64 KB; 64-row tiles would
//     take 128 KB a warpgroup.
//   * A warpgroup's next tile (raw Q and dO rows, lse and delta) is copied
//     by cp.async as soon as this one is split, under this tile's
//     products; rows past Sq read as zeros.
//   * The element mask is applied only on tiles that cross the diagonal,
//     the window's edge, Sq or Skv.
//   * No atomics: a CTA owns its keys' rows, each warpgroup walks its
//     tiles in a fixed order and the two sums meet in a fixed order, so
//     the result is the same bit for bit on every run.
// Shared memory: K and V as big and small tf32 (64 KB), each warpgroup's
// stage (2 x 64 KB), raw tile (2 x 16.25 KB) and rows' statistics:
// 225 KB.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tf32_bwd {

using namespace hopper;

constexpr int D = 64;
constexpr int BK = 64;          // keys of a CTA (wgmma M)
constexpr int BQ = 32;          // query rows of a tile (S^T's N)
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kThreads = 2 * kWG;
constexpr float kLog2e = 1.4426950408889634f;

// Operand tiles with 128-byte (32-float) swizzled rows: [64][32] (8 KB)
// and [32][32] (4 KB).
struct alignas(1024) Tile { float x[64 * 32]; };
struct alignas(1024) Half { float x[32 * 32]; };

// One query tile's operands (64 KB); at the end, a warpgroup's dK or dV
// sum for the other to add.
union Stage {
  struct {
    Half q[4];    // Q [32 rows][64 d]: big d 0-31, 32-63; small 2-3
    Half dout[4]; // dO, the same
    Tile qt[2];   // Q^T [64 d][32 rows, permuted]: big, small
    Tile dot[2];  // dO^T, the same
  } t;
  float sum[32][kWG];
};

// A query tile as copied.
struct Raw {
  float q[BQ * D];
  float dout[BQ * D];
  float lse[BQ];
  float delta[BQ];
};

struct Smem {
  Tile k[4];          // K [64 keys][64 d]: big d 0-31, 32-63; small 2-3
  Tile v[4];          // V, the same
  Stage st[2];        // a warpgroup's
  Raw raw[2];         // a warpgroup's
  float lse2[2][BQ];  // a warpgroup's tile's rows: lse * log2 e
  float delta[2][BQ];
};

// The CTA's walk: tile i is query head plane0 + i / n_rt, rows r0(i) ..
// r0(i) + 31, for the live query tiles rt0 .. rt0 + n_rt - 1 of each head.
struct Walk {
  int plane0, rt0, n_rt, n_tiles;
  __device__ __forceinline__ int plane(int i) const {
    return plane0 + i / n_rt;
  }
  __device__ __forceinline__ int r0(int i) const {
    return (rt0 + i % n_rt) * BQ;
  }
};

// Tile i's Q and dO rows, lse and delta into a raw buffer by cp.async, by
// the warpgroup's thread l; rows past Sq read as zeros; chunk c of row r
// lands at chunk c ^ raw_chunk_swz(r).
__device__ __forceinline__ void load_tile(Raw& r, const float* q,
                                          const float* dout,
                                          const float* lse,
                                          const float* delta, const Walk& w,
                                          int i, int Sq, int l) {
  const size_t plane = (size_t)w.plane(i) * Sq;
  const int r0 = w.r0(i);
#pragma unroll
  for (int c = l; c < BQ * 16; c += kWG) {
    const int row = c >> 4, part = c & 15;
    const bool ok = r0 + row < Sq;
    const size_t off = (plane + (ok ? r0 + row : r0)) * D + 4 * part;
    const int at = row * D + 4 * (part ^ raw_chunk_swz(row));
    cp_async16(r.q + at, q + off, ok);
    cp_async16(r.dout + at, dout + off, ok);
  }
  const int e = l & (BQ - 1);
  const bool ok = r0 + e < Sq;
  const size_t off = plane + (ok ? r0 + e : r0);
  if (l < BQ)
    cp_async4(&r.lse[e], lse + off, ok);
  else if (l < 2 * BQ)
    cp_async4(&r.delta[e], delta + off, ok);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int kvplanes, int Hq, int Hkv, int Sq, int Skv,
                          float scale, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int kvplane = blockIdx.x % kvplanes;
  const int k_lo = (int)(blockIdx.x / kvplanes) * BK;
  const int G = Hq / Hkv;
  int r_begin, r_end;
  flash::live_rows(mask, k_lo, min(Skv, k_lo + BK) - 1, Sq, &r_begin,
                   &r_end);
  Walk w;
  w.plane0 = (kvplane / Hkv) * Hq + (kvplane % Hkv) * G;
  w.rt0 = r_begin / BQ;
  w.n_rt = r_end > r_begin ? (r_end + BQ - 1) / BQ - w.rt0 : 0;
  w.n_tiles = G * w.n_rt;

  const int wg = threadIdx.x >> 7, l = threadIdx.x & (kWG - 1);
  const int warp = l >> 5, lane = l & 31;
  const int key_lo = 16 * warp + (lane >> 2);   // keys key_lo, key_lo + 8
  const int c_lo = 2 * (lane & 3);              // rows + 8j + {0, 1}
  const float scale_log2 = scale * kLog2e;
  auto& st = s.st[wg].t;
  Raw& raw = s.raw[wg];
  float* lse2 = s.lse2[wg];
  float* dl = s.delta[wg];
  const int bar = 1 + wg;        // the warpgroup's named barrier

  // this warpgroup's first tile, then K and V by both
  if (wg < w.n_tiles) load_tile(raw, q, dout, lse, delta, w, wg, Sq, l);
  cp_commit();
  const size_t kplane = (size_t)kvplane * Skv * D;
  tf32_stage64<kThreads>(k + kplane, k_lo, Skv, s.k);
  tf32_stage64<kThreads>(v + kplane, k_lo, Skv, s.v);
  __syncthreads();

  float dka[32], dva[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.0f;

  for (int i = wg; i < w.n_tiles; i += 2) {
    cp_wait<0>();               // this thread's copies of tile i are in
    bar_sync(bar, kWG);         // everyone's; every warp is done with st
    tf32_split_rows32(raw.q, st.q, l);
    tf32_split_cols32(raw.q, st.qt, l);
    tf32_split_rows32(raw.dout, st.dout, l);
    tf32_split_cols32(raw.dout, st.dot, l);
    if (l < BQ) {
      lse2[l] = raw.lse[l] * kLog2e;
      dl[l] = raw.delta[l];
    }
    fence_proxy_async();
    bar_sync(bar, kWG);         // st is written, raw is read
    if (i + 2 < w.n_tiles)
      load_tile(raw, q, dout, lse, delta, w, i + 2, Sq, l);
    cp_commit();

    float sa[16], dpa[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) sa[x] = dpa[x] = 0.0f;
    wgmma_fence();
    tf32x3_k64_n32<false, false>(sa, &s.k[0], &s.k[1], &s.k[2], &s.k[3],
                                 &st.q[0], &st.q[1], &st.q[2], &st.q[3], 0);
    tf32x3_k64_n32<false, false>(dpa, &s.v[0], &s.v[1], &s.v[2], &s.v[3],
                                 &st.dout[0], &st.dout[1], &st.dout[2],
                                 &st.dout[3], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);

    // ---- P^T and dS^T on the fragments: keys (rows), query rows (cols)
    const int r0 = w.r0(i);
    const bool whole =
        r0 + BQ <= Sq && k_lo + BK <= Skv &&
        (!mask.causal || k_lo + BK - 1 <= mask.q_offset + r0) &&
        (mask.window <= 0 ||
         k_lo > mask.q_offset + r0 + BQ - 1 - mask.window);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int col = 8 * (x >> 2) + c_lo + (x & 1);   // query row - r0
      const int key = k_lo + key_lo + 8 * ((x >> 1) & 1);
      const int qp = mask.q_offset + r0 + col;
      const bool ok = whole || ((r0 + col < Sq) & (key < Skv) &
                                (!mask.causal | (key <= qp)) &
                                ((mask.window <= 0) |
                                 (key > qp - mask.window)));
      const float p = ok ? ex2(fmaf(sa[x], scale_log2, -lse2[col])) : 0.0f;
      dpa[x] = p * (dpa[x] - dl[col]) * scale;
      sa[x] = p;
    }
    uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tf32_frag(sa, kk, pb[kk], ps[kk]);
      tf32_frag(dpa, kk, db[kk], ds[kk]);
    }
    float dvp[32], dkp[32];     // this tile's dV and dK
#pragma unroll
    for (int x = 0; x < 32; ++x) dvp[x] = dkp[x] = 0.0f;
    wgmma_fence();
    tf32x3_rs_n64<4>(dvp, pb, ps, &st.dot[0], &st.dot[0], &st.dot[1],
                     &st.dot[1]);
    tf32x3_rs_n64<4>(dkp, db, ds, &st.qt[0], &st.qt[0], &st.qt[1],
                     &st.qt[1]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvp);
    fence_regs(dkp);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dva[x] += dvp[x];
      dka[x] += dkp[x];
    }
  }

  // ---- the two sums meet: warpgroup 0 writes dK, warpgroup 1 dV (a sum
  // of two terms is the same in either order)
  __syncthreads();              // both are done with their stages
  float* give = s.st[wg].sum[0];
#pragma unroll
  for (int x = 0; x < 32; ++x) give[x * kWG + l] = wg == 0 ? dva[x] : dka[x];
  __syncthreads();
  const float* take = s.st[1 - wg].sum[0];
  float* out = (wg == 0 ? dk : dv) + kplane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k_lo + key_lo + 8 * h;
    if (key >= Skv) continue;
    float* row = out + (size_t)key * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = 4 * j + 2 * h;
      const float y0 = wg == 0 ? dka[x] : dva[x];
      const float y1 = wg == 0 ? dka[x + 1] : dva[x + 1];
      *reinterpret_cast<float2*>(row + 8 * j + c_lo) =
          make_float2(y0 + take[x * kWG + l], y1 + take[(x + 1) * kWG + l]);
    }
  }
}

constexpr size_t kSmem = sizeof(Smem) + 1024;   // + alignment slack

static int launch(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dk, float* dv, int B, int Hq, int Hkv, int Sq,
                  int Skv, float scale, flash::Mask mask,
                  cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_tf32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int kvplanes = B * Hkv, nkt = (Skv + BK - 1) / BK;
  flash_bwd_dkv_tf32_kernel<<<kvplanes * nkt, kThreads, kSmem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, kvplanes, Hq, Hkv, Sq, Skv, scale,
      mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tf32_bwd

// q, dout: [B, Hq, Sq, 64]; k, v, dk, dv: [B, Hkv, Skv, 64], all float32,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Mask
// arguments as flash_attention_fwd_tf32. Returns cudaGetLastError() of
// the launch.
extern "C" int flash_attention_bwd_dkv_tf32(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, int B, int Hq, int Hkv,
                                            int Sq, int Skv, float scale,
                                            int causal, int window,
                                            int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tf32_bwd::launch(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, lse, delta, (float*)dk, (float*)dv, B, Hq, Hkv,
      Sq, Skv, scale, mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_bwd_dkv_tf32_smem() {
  return (int)flash_tf32_bwd::kSmem;
}
