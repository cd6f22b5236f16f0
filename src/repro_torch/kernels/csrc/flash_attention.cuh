// Shared device code of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_preprocess.cu, flash_bwd_dkv.cu, flash_bwd_dq.cu): blocked GQA
// attention over [B, H, S, D] tensors with causal and sliding-window masks
// taken from absolute positions, computed in float32 on CUDA cores.
//
// Thread layout, used by every kernel here: a row of D = 32*TPR elements
// (a query row, or a key row in dK/dV) belongs to TPR = D/32 neighbouring
// threads of one warp. Thread `sub` of a row owns the eight float4 chunks
// c = k*TPR + sub (k = 0..7) of it, 32 elements, in registers. A dot
// product is a partial sum per thread and an xor-shuffle over the TPR
// threads, whose butterfly leaves the same sum in each of them. A tile of
// the other operand sits in shared memory as float32 rows, which every
// row of the CTA reads at the same time: the TPR threads of a row read
// neighbouring 16-byte chunks (no bank conflict) and the rows of a warp
// read the same ones (broadcast).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;   // the reference kernels' mask value
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOwn = 32;            // elements of a row one thread owns
constexpr int kSub = 16;            // keys per online-softmax step (fwd)

// dtype codes shared with kernels/ops.py
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Validity of (query row, key position) from absolute positions: the query
// row r sits at q_offset + r. The reference's _mask_block; window <= 0 is
// no window. Keys past kv_len never reach here (bounds checks).
struct Mask {
  int q_offset;
  int causal;
  int window;
  __device__ __forceinline__ bool operator()(int qrow, int kp) const {
    const int qp = q_offset + qrow;
    bool ok = true;
    if (causal) ok = kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
    return ok;
  }
};

// The chunk offset (in floats) of a thread's k-th owned chunk.
template <int TPR>
__device__ __forceinline__ int chunk(int k, int sub) {
  return 4 * (k * TPR + sub);
}

// Load a thread's 32 owned elements of row `row` of a [S, D] slab into
// registers as float32; zeros for row >= S.
template <int TPR, typename T>
__device__ __forceinline__ void load_own(float (&r)[kOwn], const T* slab,
                                         int row, int S, int sub) {
  constexpr int D = 32 * TPR;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * k + e] = row < S
          ? to_float(slab[(size_t)row * D + chunk<TPR>(k, sub) + e]) : 0.0f;
  }
}

template <int TPR, typename T>
__device__ __forceinline__ void store_own(T* slab, const float (&r)[kOwn],
                                          int row, int sub) {
  constexpr int D = 32 * TPR;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      slab[(size_t)row * D + chunk<TPR>(k, sub) + e] =
          from_float<T>(r[4 * k + e]);
  }
}

// Copy rows [row0, row0 + n) of a [S, D] slab into shared memory as float32
// rows of D; rows at or past S become zeros. All threads of the CTA take
// part; consecutive threads read consecutive elements.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* slab, int row0,
                                          int n, int S) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int row = row0 + i / D;
    dst[i] = row < S ? to_float(slab[(size_t)row0 * D + i]) : 0.0f;
  }
}

// A thread's partial dot product of its owned elements with shared row `x`.
template <int TPR>
__device__ __forceinline__ float dot_part(const float (&r)[kOwn],
                                          const float* x, int sub) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(x + chunk<TPR>(k, sub));
    acc = fmaf(r[4 * k], v.x, acc);
    acc = fmaf(r[4 * k + 1], v.y, acc);
    acc = fmaf(r[4 * k + 2], v.z, acc);
    acc = fmaf(r[4 * k + 3], v.w, acc);
  }
  return acc;
}

// Sum over the TPR threads of a row (every one of them gets the same sum).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// r += a * x for a thread's owned elements of shared row `x`.
template <int TPR>
__device__ __forceinline__ void axpy(float (&r)[kOwn], float a,
                                     const float* x, int sub) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(x + chunk<TPR>(k, sub));
    r[4 * k] = fmaf(a, v.x, r[4 * k]);
    r[4 * k + 1] = fmaf(a, v.y, r[4 * k + 1]);
    r[4 * k + 2] = fmaf(a, v.z, r[4 * k + 2]);
    r[4 * k + 3] = fmaf(a, v.w, r[4 * k + 3]);
  }
}

// Keys [begin, end) that some query row of [q_lo, q_hi] may see: exact for
// causal and window, as the reference's _block_live.
__device__ __forceinline__ void live_keys(const Mask& m, int q_lo, int q_hi,
                                          int Skv, int* begin, int* end) {
  *begin = 0;
  *end = Skv;
  if (m.causal) *end = min(Skv, m.q_offset + q_hi + 1);
  if (m.window > 0) *begin = max(0, m.q_offset + q_lo - m.window + 1);
}

// Query rows [begin, end) that may see some key of [k_lo, k_hi].
__device__ __forceinline__ void live_rows(const Mask& m, int k_lo, int k_hi,
                                          int Sq, int* begin, int* end) {
  *begin = 0;
  *end = Sq;
  if (m.causal) *begin = max(0, k_lo - m.q_offset);
  if (m.window > 0) *end = min(Sq, k_hi + m.window - m.q_offset);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
