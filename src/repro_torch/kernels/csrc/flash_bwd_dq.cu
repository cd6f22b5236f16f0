// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's third pallas_call (body _bwd_dq_kernel). From the
// saved (q, k, v, lse), the output cotangent dO and delta = rowsum(dO*O)
// it computes dQ = sum_j dS_ij k_j with p = exp(s - lse) recomputed per key
// and dS = p * (dO.v_j - delta) * scale, accumulated in float32 and
// written in q's dtype. Masks are the forward's (flash_attention.cuh).
//
// What bounds it on an H100: operations, as the forward (three D-long
// products per visible (query, key) pair against the same O(S*D) bytes).
//
// What the design does about it, as a first, simple kernel: one CTA per
// (q tile, query head, batch), the KV axis a loop inside the CTA over the
// live tiles only; K and V tiles staged once in shared memory as float32
// and read by every row of the CTA; each query row's q, dO and dQ
// accumulator stay in the registers of its D/32 threads. No atomics: each
// CTA owns its dQ rows, so the result is the same bit for bit on every run.
// bf16 at head_dim 64 runs flash_bwd_dq_tc.cu on the tensor cores instead;
// this kernel keeps float32 and head_dims 32 and 128.
#include "flash_attention.cuh"

namespace flash {

template <int TPR, typename T>
__global__ void flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
    int Sq, int Skv, int BQ, int BK, float scale, Mask mask) {
  constexpr int D = 32 * TPR;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + BK * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int sub = threadIdx.x % TPR;
  const int q_lo = blockIdx.x * BQ;
  const int row = q_lo + threadIdx.x / TPR;
  const size_t qbase = (size_t)(b * Hq + h) * Sq * D;
  const size_t kbase = (size_t)(b * Hkv + hk) * Skv * D;
  const size_t rbase = (size_t)(b * Hq + h) * Sq;

  float qr[kOwn], dor[kOwn], acc[kOwn];
  load_own<TPR>(qr, q + qbase, row, Sq, sub);
  load_own<TPR>(dor, dout + qbase, row, Sq, sub);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.0f;
  const float lse_r = row < Sq ? lse[rbase + row] : 0.0f;
  const float delta_r = row < Sq ? delta[rbase + row] : 0.0f;

  int k_begin, k_end;
  live_keys(mask, q_lo, min(Sq, q_lo + BQ) - 1, Skv, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();
    load_tile<D>(ks, k + kbase, k0, BK, k0 + nk);
    load_tile<D>(vs, v + kbase, k0, BK, k0 + nk);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = row_sum<TPR>(dot_part<TPR>(qr, ks + j * D, sub)) * scale;
      const float dp = row_sum<TPR>(dot_part<TPR>(dor, vs + j * D, sub));
      const bool ok = row < Sq && mask(row, k0 + j);
      const float p = ok ? expf(s - lse_r) : 0.0f;
      const float ds = p * (dp - delta_r) * scale;
      axpy<TPR>(acc, ds, ks + j * D, sub);
    }
  }
  if (row < Sq) store_own<TPR>(dq + qbase, acc, row, sub);
}

template <int TPR, typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int BQ,
                  int BK, float scale, Mask mask, cudaStream_t stream) {
  constexpr int D = 32 * TPR;
  const size_t smem = 2 * (size_t)BK * D * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<TPR, T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, BQ * TPR, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Hq, Hkv, Sq, Skv, BQ, BK, scale, mask);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int BQ,
                    int BK, float scale, Mask mask, cudaStream_t st) {
  switch (D) {
    case 32: return launch<1, T>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                 Sq, Skv, BQ, BK, scale, mask, st);
    case 64: return launch<2, T>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                 Sq, Skv, BQ, BK, scale, mask, st);
    case 128: return launch<4, T>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv,
                                  Sq, Skv, BQ, BK, scale, mask, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

// q, dout, dq: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D], all of `dtype`
// (0 float32, 1 bf16) and contiguous; lse, delta: [B, Hq, Sq] float32.
// Tile and mask arguments as flash_attention_fwd. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int D, int BQ, int BK,
                                      float scale, int causal, int window,
                                      int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::launch_d<float>(D, q, k, v, dout, lse, delta, dq, B, Hq,
                                  Hkv, Sq, Skv, BQ, BK, scale, mask, st);
  if (dtype == flash::kBF16)
    return flash::launch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B,
                                          Hq, Hkv, Sq, Skv, BQ, BK, scale,
                                          mask, st);
  return (int)cudaErrorInvalidValue;
}
