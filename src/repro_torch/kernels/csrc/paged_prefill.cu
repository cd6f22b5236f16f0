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
#include "paged_attention.cuh"

template <int EPL, typename QT, typename KT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const QT* q, QT* out, const KT* kpool,
                         const KT* vpool, const float* kscale,
                         const float* vscale, const int* table, int Hq,
                         int Hkv, int NB, int bs, int T, int C, int q_offset,
                         int ctx, float scale) {
  const int h = blockIdx.x;
  const int gc = (Hq / Hkv) * C;
  const int r0 = blockIdx.y * paged::kMaxRows;
  const int R = min(paged::kMaxRows, gc - r0);
  int max_off = 0;   // the tile's furthest chunk offset
  for (int r = 0; r < R; ++r) max_off = max(max_off, (r0 + r) % C);
  const int nkeys =
      max(0, min(min(ctx, q_offset + max_off + 1), T * bs));
  const size_t off = ((size_t)h * gc + r0) * (32 * EPL);
  paged::attend_rows<EPL, QT, KT>(q + off, out + off, R, kpool, vpool,
                                  kscale, vscale, table, NB, bs, h, nkeys,
                                  true, q_offset, C, r0, scale);
}

template <int EPL, typename QT, typename KT>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  void* out, int Hq, int Hkv, int NB, int bs, int T, int C,
                  int q_offset, int ctx, float scale, cudaStream_t stream) {
  const int tiles = ((Hq / Hkv) * C + paged::kMaxRows - 1) / paged::kMaxRows;
  const size_t smem = paged::Smem<EPL, KT>::kBytes;
  auto kernel = paged_prefill_kernel<EPL, QT, KT>;
  const cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hkv, tiles), paged::kThreads, smem, stream>>>(
          (const QT*)q, (QT*)out, (const KT*)k, (const KT*)v, ks, vs, table,
          Hq, Hkv, NB, bs, T, C, q_offset, ctx, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, const int* table,
                    void* out, int Hq, int Hkv, int NB, int bs, int T, int C,
                    int q_offset, int ctx, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<1, QT, KT>(q, k, v, ks, vs, table, out, Hq, Hkv,
                                      NB, bs, T, C, q_offset, ctx, scale, st);
    case 64: return launch<2, QT, KT>(q, k, v, ks, vs, table, out, Hq, Hkv,
                                      NB, bs, T, C, q_offset, ctx, scale, st);
    case 128: return launch<4, QT, KT>(q, k, v, ks, vs, table, out, Hq, Hkv,
                                       NB, bs, T, C, q_offset, ctx, scale,
                                       st);
  }
  return (int)cudaErrorInvalidValue;
}

// q: [Hq, C, D]; k/v: [Hkv, NB, bs, D]; ks/vs: [Hkv, NB, bs, 1] float32 for
// int8 pools, else null; table: [T] int32; out: [Hq, C, D] in q's dtype
// (rows at or past chunk_len = ctx - q_offset are finite garbage). D in
// {32, 64, 128}, all pointers 16-byte aligned. Returns cudaGetLastError()
// of the launch.
extern "C" int paged_prefill_attention(int q_dtype, int kv_dtype,
                                       const void* q, const void* k,
                                       const void* v, const float* ks,
                                       const float* vs, const int* table,
                                       void* out, int Hq, int Hkv, int NB,
                                       int bs, int D, int T, int C,
                                       int q_offset, int ctx, float scale,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == paged::kF32 && kv_dtype == paged::kF32)
    return launch_d<float, float>(D, q, k, v, ks, vs, table, out, Hq, Hkv,
                                  NB, bs, T, C, q_offset, ctx, scale, st);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kBF16)
    return launch_d<bf16, bf16>(D, q, k, v, ks, vs, table, out, Hq, Hkv, NB,
                                bs, T, C, q_offset, ctx, scale, st);
  if (q_dtype == paged::kF32 && kv_dtype == paged::kI8)
    return launch_d<float, int8_t>(D, q, k, v, ks, vs, table, out, Hq, Hkv,
                                   NB, bs, T, C, q_offset, ctx, scale, st);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kI8)
    return launch_d<bf16, int8_t>(D, q, k, v, ks, vs, table, out, Hq, Hkv,
                                  NB, bs, T, C, q_offset, ctx, scale, st);
  return (int)cudaErrorInvalidValue;
}
