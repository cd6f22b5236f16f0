// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// paged_decode_attention (body _paged_decode_kernel). One CTA per (KV head,
// lane) serves the g = Hq / Hkv query heads of that GQA group: it reads the
// lane's context length and physical block ids from device memory itself
// (the TPU's scalar prefetch has no counterpart) and loads only keys below
// ctx. What bounds it, and what the design does about that, is in
// paged_attention.cuh. It is the "simt" route (float32 q, other head dims
// and block sizes); bf16 q over bf16 or int8 pools at head dim 64 runs
// paged_decode_tma.cu.
#include "paged_attention.cuh"

template <int EPL, typename QT, typename KT>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(const QT* q, QT* out, const KT* kpool,
                        const KT* vpool, const float* kscale,
                        const float* vscale, const int* tables,
                        const int* ctx_lens, int Hq, int Hkv, int NB, int bs,
                        int T, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int nkeys = max(0, min(ctx_lens[b], T * bs));
  const size_t off = ((size_t)b * Hq + (size_t)h * g) * (32 * EPL);
  paged::attend_rows<EPL, QT, KT>(q + off, out + off, g, kpool, vpool,
                                  kscale, vscale, tables + (size_t)b * T, NB,
                                  bs, h, nkeys, false, 0, 1, 0, scale);
}

template <int EPL, typename QT, typename KT>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* tables,
                  const int* ctx, void* out, int B, int Hq, int Hkv, int NB,
                  int bs, int T, float scale, cudaStream_t stream) {
  const size_t smem = paged::Smem<EPL, KT>::kBytes;
  auto kernel = paged_decode_kernel<EPL, QT, KT>;
  const cudaError_t err = paged::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hkv, B), paged::kThreads, smem, stream>>>(
          (const QT*)q, (QT*)out, (const KT*)k, (const KT*)v, ks, vs, tables,
          ctx, Hq, Hkv, NB, bs, T, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, const int* tables,
                    const int* ctx, void* out, int B, int Hq, int Hkv, int NB,
                    int bs, int T, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<1, QT, KT>(q, k, v, ks, vs, tables, ctx, out, B,
                                      Hq, Hkv, NB, bs, T, scale, st);
    case 64: return launch<2, QT, KT>(q, k, v, ks, vs, tables, ctx, out, B,
                                      Hq, Hkv, NB, bs, T, scale, st);
    case 128: return launch<4, QT, KT>(q, k, v, ks, vs, tables, ctx, out, B,
                                       Hq, Hkv, NB, bs, T, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// q: [B, Hq, D]; k/v: [Hkv, NB, bs, D]; ks/vs: [Hkv, NB, bs, 1] float32 for
// int8 pools, else null; tables: [B, T] int32; ctx: [B] int32;
// out: [B, Hq, D] in q's dtype. D in {32, 64, 128}, Hq / Hkv <= 8, all
// pointers 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int paged_decode_attention(int q_dtype, int kv_dtype,
                                      const void* q, const void* k,
                                      const void* v, const float* ks,
                                      const float* vs, const int* tables,
                                      const int* ctx, void* out, int B,
                                      int Hq, int Hkv, int NB, int bs, int D,
                                      int T, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_dtype == paged::kF32 && kv_dtype == paged::kF32)
    return launch_d<float, float>(D, q, k, v, ks, vs, tables, ctx, out, B,
                                  Hq, Hkv, NB, bs, T, scale, st);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kBF16)
    return launch_d<bf16, bf16>(D, q, k, v, ks, vs, tables, ctx, out, B, Hq,
                                Hkv, NB, bs, T, scale, st);
  if (q_dtype == paged::kF32 && kv_dtype == paged::kI8)
    return launch_d<float, int8_t>(D, q, k, v, ks, vs, tables, ctx, out, B,
                                   Hq, Hkv, NB, bs, T, scale, st);
  if (q_dtype == paged::kBF16 && kv_dtype == paged::kI8)
    return launch_d<bf16, int8_t>(D, q, k, v, ks, vs, tables, ctx, out, B,
                                  Hq, Hkv, NB, bs, T, scale, st);
  return (int)cudaErrorInvalidValue;
}
