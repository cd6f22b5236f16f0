// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (body _fwd_kernel). q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D]
// (float32 or bf16, query head h reads KV head h / (Hq/Hkv)) give
// o [B, Hq, Sq, D] in q's dtype and, optionally, the float32 row
// logsumexp lse [B, Hq, Sq]. Query row r sits at absolute position
// q_offset + r; causal and window masks follow the reference's _mask_block.
// As in the Pallas kernel, q, k and v are read as float32 and both
// products (q.k and p.v) are float32.
//
// What bounds it on an H100: operations. At the training shape (B 4,
// Hq 16, S 1024, D 64, causal) a call does about 8.6 GFLOP against 25 MB
// of q, k, v and o, about 340 flop per byte: above the bf16 ridge of the
// tensor cores, and far above what CUDA cores reach in float32.
//
// What the design does about it, as a first, simple kernel:
//   * one CTA per (q tile of BQ rows, query head, batch); the sequential KV
//     axis of the Pallas grid becomes a loop inside the CTA, with
//     (m, l, acc) in registers across it;
//   * the CTA walks only the KV tiles some of its rows can see (causal:
//     none past its last row; window: none before its first row's window);
//   * each BK-key tile of K and V is staged once in shared memory as
//     float32 and read by all BQ rows (broadcast loads, see
//     flash_attention.cuh for the thread layout);
//   * the online softmax rescales once per 16 keys, not per key.
// Tensor cores (mma/wgmma), TMA and sharing a KV tile across the GQA group
// are later work.
#include "flash_attention.cuh"

namespace flash {

template <int TPR, typename T>
__global__ void flash_fwd_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o,
                                 float* __restrict__ lse, int Hq, int Hkv,
                                 int Sq, int Skv, int BQ, int BK, float scale,
                                 Mask mask) {
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

  float qr[kOwn], acc[kOwn];
  load_own<TPR>(qr, q + qbase, row, Sq, sub);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;

  int k_begin, k_end;
  live_keys(mask, q_lo, min(Sq, q_lo + BQ) - 1, Skv, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();
    load_tile<D>(ks, k + kbase, k0, BK, k0 + nk);
    load_tile<D>(vs, v + kbase, k0, BK, k0 + nk);
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float s[kSub];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        const float d = row_sum<TPR>(dot_part<TPR>(qr, ks + j * D, sub));
        const bool ok = j < nk && row < Sq && mask(row, k0 + j);
        s[jj] = ok ? d * scale : kNegInf;
        if (ok) mx = fmaxf(mx, s[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        const bool ok = j < nk && row < Sq && mask(row, k0 + j);
        s[jj] = ok ? expf(s[jj] - m_new) : 0.0f;
        psum += s[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj)
        axpy<TPR>(acc, s[jj], vs + (j0 + jj) * D, sub);
      m = m_new;
    }
  }
  if (row >= Sq) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = acc[i] / lc;
  store_own<TPR>(o + qbase, acc, row, sub);
  if (lse != nullptr && sub == 0)
    lse[(size_t)(b * Hq + h) * Sq + row] = m + logf(lc);
}

template <int TPR, typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int BQ,
                  int BK, float scale, Mask mask, cudaStream_t stream) {
  constexpr int D = 32 * TPR;
  const size_t smem = 2 * (size_t)BK * D * sizeof(float);
  auto kernel = flash_fwd_kernel<TPR, T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, BQ * TPR, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq, Hkv, Sq, Skv,
      BQ, BK, scale, mask);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    void* o, float* lse, int B, int Hq, int Hkv, int Sq,
                    int Skv, int BQ, int BK, float scale, Mask mask,
                    cudaStream_t st) {
  switch (D) {
    case 32: return launch<1, T>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, BQ,
                                 BK, scale, mask, st);
    case 64: return launch<2, T>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, BQ,
                                 BK, scale, mask, st);
    case 128: return launch<4, T>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, BQ,
                                  BK, scale, mask, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

// q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; o: [B, Hq, Sq, D], all of
// `dtype` (0 float32, 1 bf16) and contiguous; lse: [B, Hq, Sq] float32 or
// null. D in {32, 64, 128}; BQ query rows and BK keys per tile, BQ*D/32 a
// multiple of 32 and at most 1024, BK a multiple of 16; window <= 0 is no
// window. Rows that see no key get o = 0. Returns cudaGetLastError() of
// the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int Hq, int Hkv, int Sq, int Skv, int D,
                                   int BQ, int BK, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::launch_d<float>(D, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                  BQ, BK, scale, mask, st);
  if (dtype == flash::kBF16)
    return flash::launch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, Hq, Hkv, Sq,
                                          Skv, BQ, BK, scale, mask, st);
  return (int)cudaErrorInvalidValue;
}
