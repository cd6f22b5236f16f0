// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's second pallas_call (body _bwd_dkv_kernel). For each
// key j of KV head hk it sums, over every query head of hk's GQA group and
// every query row i that sees j,
//   dV_j += p_ij dO_i   and   dK_j += dS_ij q_i,
// with p = exp(s - lse) recomputed and dS = p * (dO_i.v_j - delta_i) *
// scale; float32 accumulators, written in k's (v's) dtype. Query rows past
// Sq are never visited, so they contribute nothing.
//
// What bounds it on an H100: operations, four D-long products per visible
// (query, key) pair, the largest share of a training step's attention.
//
// What the design does about it, as a first, simple kernel: one CTA per
// (KV tile of BK keys, KV head, batch); the Pallas kernel's sequential
// (group x q block) axis is a loop inside the CTA over the group's query
// heads and the query tiles that can see the CTA's keys. Each key's k, v
// and dK/dV accumulators stay in the registers of its D/32 threads; each
// query tile (q, dO, lse, delta) is staged once in shared memory and read
// by every key of the CTA. No atomics: a CTA owns its keys' dK/dV rows and
// walks heads, tiles and rows in a fixed order, so the result is the same
// bit for bit on every run.
#include "flash_attention.cuh"

namespace flash {

template <int TPR, typename T>
__global__ void flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Hq, int Hkv, int Sq, int Skv, int BQ, int BK, float scale,
    Mask mask) {
  constexpr int D = 32 * TPR;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * D;
  float* lses = dos + BQ * D;
  float* deltas = lses + BQ;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int sub = threadIdx.x % TPR;
  const int k_lo = blockIdx.x * BK;
  const int key = k_lo + threadIdx.x / TPR;
  const size_t kbase = (size_t)(b * Hkv + hk) * Skv * D;

  float kr[kOwn], vr[kOwn], dka[kOwn], dva[kOwn];
  load_own<TPR>(kr, k + kbase, key, Skv, sub);
  load_own<TPR>(vr, v + kbase, key, Skv, sub);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) dka[i] = dva[i] = 0.0f;

  int r_begin, r_end;
  live_rows(mask, k_lo, min(Skv, k_lo + BK) - 1, Sq, &r_begin, &r_end);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qbase = (size_t)(b * Hq + h) * Sq * D;
    const size_t rbase = (size_t)(b * Hq + h) * Sq;
    for (int r0 = r_begin; r0 < r_end; r0 += BQ) {
      const int nr = min(BQ, r_end - r0);
      __syncthreads();
      load_tile<D>(qs, q + qbase, r0, BQ, r0 + nr);
      load_tile<D>(dos, dout + qbase, r0, BQ, r0 + nr);
      for (int i = threadIdx.x; i < nr; i += blockDim.x) {
        lses[i] = lse[rbase + r0 + i];
        deltas[i] = delta[rbase + r0 + i];
      }
      __syncthreads();
      for (int i = 0; i < nr; ++i) {
        const float s =
            row_sum<TPR>(dot_part<TPR>(kr, qs + i * D, sub)) * scale;
        const float dp = row_sum<TPR>(dot_part<TPR>(vr, dos + i * D, sub));
        const bool ok = key < Skv && mask(r0 + i, key);
        const float p = ok ? expf(s - lses[i]) : 0.0f;
        const float ds = p * (dp - deltas[i]) * scale;
        axpy<TPR>(dva, p, dos + i * D, sub);
        axpy<TPR>(dka, ds, qs + i * D, sub);
      }
    }
  }
  if (key < Skv) {
    store_own<TPR>(dk + kbase, dka, key, sub);
    store_own<TPR>(dv + kbase, dva, key, sub);
  }
}

template <int TPR, typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                  int BQ, int BK, float scale, Mask mask,
                  cudaStream_t stream) {
  constexpr int D = 32 * TPR;
  const size_t smem = (2 * (size_t)BQ * D + 2 * BQ) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<TPR, T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  kernel<<<grid, BK * TPR, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, Hkv, Sq, Skv, BQ, BK, scale, mask);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                    int Skv, int BQ, int BK, float scale, Mask mask,
                    cudaStream_t st) {
  switch (D) {
    case 32: return launch<1, T>(q, k, v, dout, lse, delta, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, BQ, BK, scale, mask, st);
    case 64: return launch<2, T>(q, k, v, dout, lse, delta, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, BQ, BK, scale, mask, st);
    case 128: return launch<4, T>(q, k, v, dout, lse, delta, dk, dv, B, Hq,
                                  Hkv, Sq, Skv, BQ, BK, scale, mask, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

// q, dout: [B, Hq, Sq, D]; k, v, dk, dv: [B, Hkv, Skv, D], all of `dtype`
// (0 float32, 1 bf16) and contiguous; lse, delta: [B, Hq, Sq] float32.
// BK keys per CTA (BK*D/32 a multiple of 32, at most 1024) and BQ query
// rows per staged tile; mask arguments as flash_attention_fwd. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_bwd_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       int B, int Hq, int Hkv, int Sq,
                                       int Skv, int D, int BQ, int BK,
                                       float scale, int causal, int window,
                                       int q_offset, void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::launch_d<float>(D, q, k, v, dout, lse, delta, dk, dv, B,
                                  Hq, Hkv, Sq, Skv, BQ, BK, scale, mask, st);
  if (dtype == flash::kBF16)
    return flash::launch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk,
                                          dv, B, Hq, Hkv, Sq, Skv, BQ, BK,
                                          scale, mask, st);
  return (int)cudaErrorInvalidValue;
}
