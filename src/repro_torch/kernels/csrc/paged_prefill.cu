// Chunked paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_prefill_attention (body _paged_prefill_kernel). The query chunk
// [Hq, C, D] is read as its group-major view [Hkv, G*C, D] (the same memory:
// query head h = kv_head * G + gi), so row r of KV head h sits at absolute
// position q_offset + r % C. One CTA per (KV head, tile of kMaxRows rows)
// loads the keys below ctx, and no further than the tile's last visible
// position: later keys would add exact zeros. The two scalars q_offset
// and ctx = q_offset + chunk_len arrive as kernel arguments, so a chunk
// needs no device-to-host copy. What bounds it, and what the design does
// about that, is in paged_attention.cuh. It is the "simt" route (float32
// q, other head dims and block sizes); bf16 q over bf16 or int8 pools at
// head dim 64 runs paged_prefill_tc.cu.
//
// The speculative decoder's batched verify is this kernel with the
// lanes as the grid's z axis: every lane's draft window is a chunk of C
// decode positions attending through that lane's table, and a CTA of lane
// b reads the lane's q_offset (lane_ctx[b], the context before the window)
// and ctx (q_offset + lane_len[b]) from device memory; a prefill chunk is
// one lane with null lane arrays and its two scalars as arguments. A row's
// arithmetic is attend_rows', the decode kernel's: the same 32-key tiles
// from key 0, dealt to the same warps, each key's score summed in the same
// order, the warps merged in the same order. Keys a decode row never loads
// (past its own position) are masked here and add exact zeros, so each
// float32 row comes out bitwise as the decode kernel computes it at that
// position (the speculative decoder's contract).
#include "paged_attention.cuh"

// One CTA: lane blockIdx.z, KV head blockIdx.x, rows blockIdx.y *
// kMaxRows.. of the lane's group-major [Hkv, G*C, D] view of q / out.
template <int EPL, typename QT, typename KT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const QT* q, QT* out, const KT* kpool,
                         const KT* vpool, const float* kscale,
                         const float* vscale, const int* tables,
                         const int* lane_ctx, const int* lane_len, int Hq,
                         int Hkv, int NB, int bs, int T, int C, int q_offset,
                         int ctx, float scale) {
  const int b = blockIdx.z;
  if (lane_ctx != nullptr) {
    q_offset = lane_ctx[b];
    ctx = q_offset + lane_len[b];
  }
  const int h = blockIdx.x;
  const int gc = (Hq / Hkv) * C;
  const int r0 = blockIdx.y * paged::kMaxRows;
  const int R = min(paged::kMaxRows, gc - r0);
  int max_off = 0;   // the tile's furthest chunk offset
  for (int r = 0; r < R; ++r) max_off = max(max_off, (r0 + r) % C);
  const int nkeys =
      max(0, min(min(ctx, q_offset + max_off + 1), T * bs));
  const size_t off = (((size_t)b * Hkv + h) * gc + r0) * (32 * EPL);
  paged::attend_rows<EPL, QT, KT>(q + off, out + off, R, kpool, vpool,
                                  kscale, vscale, tables + (size_t)b * T,
                                  NB, bs, h, nkeys, true, q_offset, C, r0,
                                  scale);
}

// The call's scalars, passed down unchanged to the launch.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *tables, *lane_ctx, *lane_len;
  void* out;
  int B, Hq, Hkv, NB, bs, T, C, q_offset, ctx;
  float scale;
  cudaStream_t stream;
};

template <int EPL, typename QT, typename KT>
static int launch(const Args& a) {
  const int tiles =
      ((a.Hq / a.Hkv) * a.C + paged::kMaxRows - 1) / paged::kMaxRows;
  const size_t smem = paged::Smem<EPL, KT>::kBytes;
  auto kernel = paged_prefill_kernel<EPL, QT, KT>;
  const cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.Hkv, tiles, a.B), paged::kThreads, smem, a.stream>>>(
      (const QT*)a.q, (QT*)a.out, (const KT*)a.k, (const KT*)a.v, a.ks,
      a.vs, a.tables, a.lane_ctx, a.lane_len, a.Hq, a.Hkv, a.NB, a.bs, a.T,
      a.C, a.q_offset, a.ctx, a.scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
static int launch_d(int D, const Args& a) {
  switch (D) {
    case 32: return launch<1, QT, KT>(a);
    case 64: return launch<2, QT, KT>(a);
    case 128: return launch<4, QT, KT>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// B lanes of q: [B, Hq, C, D]; k/v: [Hkv, NB, bs, D]; ks/vs: [Hkv, NB,
// bs, 1] float32 for int8 pools, else null; tables: [B, T] int32; out:
// [B, Hq, C, D] in q's dtype. Lane b's chunk covers positions [q_offset,
// ctx): with lane_ctx / lane_len null (one prefill chunk, B = 1) the two
// scalars, else lane_ctx[b] and lane_ctx[b] + lane_len[b], [B] int32 on
// the device (the batched verify, each window's own K/V already in the
// pools). Rows at or past a lane's chunk length are finite garbage; a lane
// with ctx 0 gets zeros. D in {32, 64, 128}, all pointers 16-byte aligned.
// Returns cudaGetLastError() of the launch.
extern "C" int paged_prefill_attention(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* tables, const int* lane_ctx,
    const int* lane_len, void* out, int B, int Hq, int Hkv, int NB, int bs,
    int D, int T, int C, int q_offset, int ctx, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  const bool lanes = lane_ctx != nullptr;
  if (B < 1 || lanes != (lane_len != nullptr) || (!lanes && B != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, tables, lane_ctx, lane_len, out, B, Hq, Hkv,
               NB, bs, T, C, q_offset, ctx, scale, (cudaStream_t)stream};
  if (q_dtype == paged::kF32 && kv_dtype == paged::kF32)
    return launch_d<float, float>(D, a);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kBF16)
    return launch_d<bf16, bf16>(D, a);
  if (q_dtype == paged::kF32 && kv_dtype == paged::kI8)
    return launch_d<float, int8_t>(D, a);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kI8)
    return launch_d<bf16, int8_t>(D, a);
  return (int)cudaErrorInvalidValue;
}
