// Flash-attention backward preprocess for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's first pallas_call (body _bwd_preprocess_kernel):
// delta = rowsum(dO * O) in float32, one value per query row, the softmax
// Jacobian's diagonal term that the dK/dV and dQ kernels subtract.
//
// What bounds it on an H100: bytes. It reads O and dO once (2*D elements a
// row) for 2*D flops and writes 4 bytes a row.
//
// What the design does about it: one warp per row; each lane loads its
// D/32 elements of O and dO, multiplies and adds them in float32, and the
// warp's xor-shuffle sum gives the row's delta, in a fixed order (the same
// bits on every run). No shared memory, no barrier.
#include "flash_attention.cuh"

namespace flash {

constexpr int kRowsPerBlock = 8;   // one warp per row

template <int EPL, typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    flash_bwd_preprocess_kernel(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // uniform across the warp
  const size_t base = (size_t)row * (32 * EPL) + lane;
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    acc = fmaf(to_float(o[base + 32 * e]), to_float(dout[base + 32 * e]),
               acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
static int launch(int D, const void* o, const void* dout, float* delta,
                  int rows, cudaStream_t st) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int threads = kRowsPerBlock * 32;
  switch (D) {
    case 32: flash_bwd_preprocess_kernel<1, T><<<blocks, threads, 0, st>>>(
                 (const T*)o, (const T*)dout, delta, rows); break;
    case 64: flash_bwd_preprocess_kernel<2, T><<<blocks, threads, 0, st>>>(
                 (const T*)o, (const T*)dout, delta, rows); break;
    case 128: flash_bwd_preprocess_kernel<4, T><<<blocks, threads, 0, st>>>(
                  (const T*)o, (const T*)dout, delta, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace flash

// o, dout: [rows, D] of `dtype` (0 float32, 1 bf16), contiguous; delta:
// [rows] float32. D in {32, 64, 128}. Returns cudaGetLastError() of the
// launch.
extern "C" int flash_attention_bwd_preprocess(int dtype, const void* o,
                                              const void* dout, float* delta,
                                              int rows, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash::launch<float>(D, o, dout, delta, rows, st);
  if (dtype == flash::kBF16)
    return flash::launch<__nv_bfloat16>(D, o, dout, delta, rows, st);
  return (int)cudaErrorInvalidValue;
}
