// Flash-attention backward, dQ, on Hopper's tensor cores (sm_90a),
// float32, D 64, every product 3xTF32 on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's third pallas_call (body _bwd_dq_kernel) for
// float32 inputs at head_dim 64, the route the FHDP step (flad-vision)
// and every other float32 path runs; flash_bwd_dq.cu keeps float32 at
// head_dims 32 and 128, and flash_bwd_dq_tc.cu bf16 at 64. It computes
// what flash_bwd_dq.cu computes: for each query row i of query head h,
// over the keys j of KV head h / (Hq/Hkv) that i sees,
//   dQ_i = sum_j dS_ij k_j,
// with p = exp(s - lse) recomputed (0 exactly where masked) and dS =
// p (dO_i.v_j - delta_i) scale; dQ [B, Hq, Sq, 64] float32. A row that
// sees no key gets dQ = 0.
//
// Numerics: 3xTF32 (hopper.cuh): q, k, v and dO split into tf32 big and
// small parts as they are staged, every product small.big + big.small +
// big.big on wgmma, accumulated in float32; p, dS and the scaling float32
// on the CUDA cores; dS split on the fly as the register A operand.
//
// What bounds it on an H100: operations. At the FHDP step's shape (B 2,
// Hq = Hkv 12, S 256, D 64, non-causal) a call needs 604.0 MFLOP against
// 7.9 MB: 0.00901 ms at float32's 67 TFLOP/s on the CUDA cores, 0.00366 ms
// at 3xTF32's 495 / 3 TFLOP/s, 0.00236 ms for the bytes.
//
// What the design does about it: query rows are the MMA's rows, so all
// three products are wgmmas and dS never goes through shared memory:
//   S   = Q K^T    A = the CTA's 64 Q rows, B = the K tile (as stored)
//   dP  = dO V^T   A = its 64 dO rows,      B = the V tile (as stored)
//   dQ += dS K     A = dS in registers;     B = K^T, the tile transposed.
// tf32 wgmma has no transpose bit, so each key tile's K is staged in both
// layouts, K^T with its keys permuted inside each 8-group to match the
// register fragment (hopper.cuh).
//   * One CTA owns 64 query rows of one query head: 96 CTAs at the FHDP
//     shape, where the SIMT kernel's 128-row CTAs gave 48. Q and dO are
//     split into shared memory once, lse and delta of a thread's two rows
//     kept in registers; the CTA walks the live key tiles (live_keys) of
//     its KV head. The last query tiles (the most keys under a causal
//     mask) launch first.
//   * Two consumer warpgroups share Q and dO and split the walk between
//     them (warpgroup w takes tiles w, w + 2, ...), each with its own
//     stage, raw tile and dQ sum, on its own named barrier; at the end
//     each hands the other half of its sum over through shared memory:
//     warpgroup 0 writes d 0-31 and warpgroup 1 d 32-63, each its own
//     sum + the other's (a sum of two terms is the same in either order).
//   * dQ is a sum over every key of the walk: each tile's product starts
//     from zero and is added to the float32 sum in registers on the CUDA
//     cores (the tensor cores' accumulation truncates: one long wgmma sum
//     over a 1032-key causal walk drifts past the 2e-5 limit).
//   * Key tiles of 32 (N = 32 for S and dP): a tile's K, V and K^T as big
//     and small tf32 take 48 KB; 64-key tiles would take 96 KB a
//     warpgroup, and two of them beside Q and dO do not fit.
//   * A warpgroup's next tile (raw K and V rows) is copied by cp.async as
//     soon as this one is split, under this tile's products; rows past
//     Skv read as zeros.
//   * The element mask is applied only on tiles that cross the diagonal,
//     the window's edge, Sq or Skv.
//   * No atomics: a CTA owns its rows, each warpgroup walks its tiles in a
//     fixed order and the two sums meet in a fixed order, so the result
//     is the same bit for bit on every run.
// Shared memory: Q and dO as big and small tf32 (64 KB), each warpgroup's
// stage (2 x 48 KB) and raw tile (2 x 16 KB): 193 KB.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tf32_dq {

using namespace hopper;

constexpr int D = 64;
constexpr int BQ = 64;          // query rows of a CTA (wgmma M)
constexpr int BK = 32;          // keys of a tile (S's N)
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kThreads = 2 * kWG;
constexpr float kLog2e = 1.4426950408889634f;

// Operand tiles with 128-byte (32-float) swizzled rows: [64][32] (8 KB)
// and [32][32] (4 KB).
struct alignas(1024) Tile { float x[64 * 32]; };
struct alignas(1024) Half { float x[32 * 32]; };

// One key tile's operands (48 KB); at the end, half of a warpgroup's dQ
// sum for the other to add.
union Stage {
  struct {
    Half k[4];    // K [32 keys][64 d]: big d 0-31, 32-63; small 2-3
    Half v[4];    // V, the same
    Tile kt[2];   // K^T [64 d][32 keys, permuted]: big, small
  } t;
  float sum[16][kWG];
};

// A key tile as copied: [32][64] float32 each, chunks swizzled
// (raw_chunk_swz).
struct Raw {
  float k[BK * D];
  float v[BK * D];
};

struct Smem {
  Tile q[4];      // Q [64 rows][64 d]: big d 0-31, 32-63; small 2-3
  Tile dout[4];   // dO, the same
  Stage st[2];    // a warpgroup's
  Raw raw[2];     // a warpgroup's
};

// Keys key0 .. key0 + 31 of the K and V planes into a raw buffer by
// cp.async, by the warpgroup's thread l; keys past Skv read as zeros;
// chunk c of row r lands at chunk c ^ raw_chunk_swz(r).
__device__ __forceinline__ void load_tile(Raw& r, const float* kp,
                                          const float* vp, int key0, int Skv,
                                          int l) {
#pragma unroll
  for (int c = l; c < BK * 16; c += kWG) {
    const int row = c >> 4, part = c & 15;
    const bool ok = key0 + row < Skv;
    const size_t off = (size_t)(ok ? key0 + row : key0) * D + 4 * part;
    const int at = row * D + 4 * (part ^ raw_chunk_swz(row));
    cp_async16(r.k + at, kp + off, ok);
    cp_async16(r.v + at, vp + off, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int planes, int Hq, int Hkv,
                         int Sq, int Skv, float scale, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int nqt = (Sq + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)(blockIdx.x / planes);
  const int qplane = blockIdx.x % planes;
  const int kvplane = (qplane / Hq) * Hkv + (qplane % Hq) / (Hq / Hkv);
  const int q_lo = qt * BQ;
  const float* kp = k + (size_t)kvplane * Skv * D;
  const float* vp = v + (size_t)kvplane * Skv * D;
  int k_begin, k_end;
  flash::live_keys(mask, q_lo, min(Sq, q_lo + BQ) - 1, Skv, &k_begin,
                   &k_end);
  const int kt0 = k_begin / BK;
  const int n = k_end > k_begin ? (k_end + BK - 1) / BK - kt0 : 0;

  const int wg = threadIdx.x >> 7, l = threadIdx.x & (kWG - 1);
  const int warp = l >> 5, lane = l & 31;
  const int row0 = q_lo + 16 * warp + (lane >> 2);   // and row0 + 8
  const int c_lo = 2 * (lane & 3);                   // + 8j + {0, 1}
  const float scale_log2 = scale * kLog2e;
  auto& st = s.st[wg].t;
  Raw& raw = s.raw[wg];
  const int bar = 1 + wg;        // the warpgroup's named barrier

  // this warpgroup's first tile, then Q and dO by both
  if (wg < n) load_tile(raw, kp, vp, (kt0 + wg) * BK, Skv, l);
  cp_commit();
  const size_t qoff = (size_t)qplane * Sq;
  tf32_stage64<kThreads>(q + qoff * D, q_lo, Sq, s.q);
  tf32_stage64<kThreads>(dout + qoff * D, q_lo, Sq, s.dout);
  float lse2[2], dl[2];          // rows row0 (h 0) and row0 + 8 (h 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < Sq ? __ldg(lse + qoff + row) * kLog2e : 0.0f;
    dl[h] = row < Sq ? __ldg(delta + qoff + row) : 0.0f;
  }
  fence_proxy_async();
  __syncthreads();

  float dqa[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dqa[x] = 0.0f;

  for (int i = wg; i < n; i += 2) {
    cp_wait<0>();               // this thread's copies of tile i are in
    bar_sync(bar, kWG);         // everyone's; every warp is done with st
    tf32_split_rows32(raw.k, st.k, l);
    tf32_split_cols32(raw.k, st.kt, l);
    tf32_split_rows32(raw.v, st.v, l);
    fence_proxy_async();
    bar_sync(bar, kWG);         // st is written, raw is read
    if (i + 2 < n) load_tile(raw, kp, vp, (kt0 + i + 2) * BK, Skv, l);
    cp_commit();

    float sa[16], dpa[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) sa[x] = dpa[x] = 0.0f;
    wgmma_fence();
    tf32x3_k64_n32<false, false>(sa, &s.q[0], &s.q[1], &s.q[2], &s.q[3],
                                 &st.k[0], &st.k[1], &st.k[2], &st.k[3], 0);
    tf32x3_k64_n32<false, false>(dpa, &s.dout[0], &s.dout[1], &s.dout[2],
                                 &s.dout[3], &st.v[0], &st.v[1], &st.v[2],
                                 &st.v[3], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);

    // ---- P and dS on the fragments: query rows (rows), keys (cols)
    const int key0 = (kt0 + i) * BK;
    const bool whole =
        q_lo + BQ <= Sq && key0 + BK <= Skv &&
        (!mask.causal || key0 + BK - 1 <= mask.q_offset + q_lo) &&
        (mask.window <= 0 ||
         key0 > mask.q_offset + q_lo + BQ - 1 - mask.window);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = (x >> 1) & 1;
      const int row = row0 + 8 * h;
      const int key = key0 + 8 * (x >> 2) + c_lo + (x & 1);
      const int qp = mask.q_offset + row;
      const bool ok = whole || ((row < Sq) & (key < Skv) &
                                (!mask.causal | (key <= qp)) &
                                ((mask.window <= 0) |
                                 (key > qp - mask.window)));
      const float p = ok ? ex2(fmaf(sa[x], scale_log2, -lse2[h])) : 0.0f;
      dpa[x] = p * (dpa[x] - dl[h]) * scale;
    }
    uint32_t db[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tf32_frag(dpa, kk, db[kk], ds[kk]);
    float dqp[32];              // this tile's dQ
#pragma unroll
    for (int x = 0; x < 32; ++x) dqp[x] = 0.0f;
    wgmma_fence();
    tf32x3_rs_n64<4>(dqp, db, ds, &st.kt[0], &st.kt[0], &st.kt[1],
                     &st.kt[1]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqp);
#pragma unroll
    for (int x = 0; x < 32; ++x) dqa[x] += dqp[x];
  }

  // ---- the two sums meet: warpgroup 0 writes d 0-31 and hands its d
  // 32-63 (registers 16-31) over, warpgroup 1 the other way round
  __syncthreads();              // both are done with their stages
  float* give = s.st[wg].sum[0];
#pragma unroll
  for (int y = 0; y < 16; ++y)
    give[y * kWG + l] = wg == 0 ? dqa[16 + y] : dqa[y];
  __syncthreads();
  const float* take = s.st[1 - wg].sum[0];
  float* out = dq + qoff * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    float* orow = out + (size_t)row * D + 32 * wg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = 4 * j + 2 * h;
      const float y0 = wg == 0 ? dqa[y] : dqa[16 + y];
      const float y1 = wg == 0 ? dqa[y + 1] : dqa[16 + y + 1];
      *reinterpret_cast<float2*>(orow + 8 * j + c_lo) =
          make_float2(y0 + take[y * kWG + l], y1 + take[(y + 1) * kWG + l]);
    }
  }
}

constexpr size_t kSmem = sizeof(Smem) + 1024;   // + alignment slack

static int launch(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tf32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int planes = B * Hq, nqt = (Sq + BQ - 1) / BQ;
  flash_bwd_dq_tf32_kernel<<<planes * nqt, kThreads, kSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, planes, Hq, Hkv, Sq, Skv, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tf32_dq

// q, dout, dq: [B, Hq, Sq, 64]; k, v: [B, Hkv, Skv, 64], all float32,
// contiguous and 16-byte aligned; lse, delta: [B, Hq, Sq] float32. Mask
// arguments as flash_attention_fwd_tf32. Returns cudaGetLastError() of
// the launch.
extern "C" int flash_attention_bwd_dq_tf32(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dq,
                                           int B, int Hq, int Hkv, int Sq,
                                           int Skv, float scale, int causal,
                                           int window, int q_offset,
                                           void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tf32_dq::launch(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, lse, delta, (float*)dq, B, Hq, Hkv, Sq, Skv, scale,
      mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_bwd_dq_tf32_smem() {
  return (int)flash_tf32_dq::kSmem;
}
