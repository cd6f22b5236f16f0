// Rowwise int8 dequantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py :: dequantize_int8
// (body _dequant_kernel): x = q * scale for rows of 128 int8 codes with one
// float32 scale each, the codec's decode of an uplinked delta. The result
// is one correctly rounded float32 multiply of the exactly converted code,
// so it is bitwise equal to the reference and to the plain version.
//
// What bounds it on an H100: bytes. Per element it reads 1 byte and writes
// 4 for one multiply.
//
// What the design does about it: one warp per row, as quantize.cu; each
// lane loads its 4 codes as one 32-bit word and the row's scale once, and
// stores its 4 results with one 16-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 8;   // one warp per row

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    dequantize_int8_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scale,
                           float* __restrict__ x, int M) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;   // uniform across the warp
  const size_t base = (size_t)row * kLanes + lane * 4;
  const char4 c = *reinterpret_cast<const char4*>(q + base);
  const float s = scale[row];
  *reinterpret_cast<float4*>(x + base) =
      make_float4(__fmul_rn(__int2float_rn(c.x), s),
                  __fmul_rn(__int2float_rn(c.y), s),
                  __fmul_rn(__int2float_rn(c.z), s),
                  __fmul_rn(__int2float_rn(c.w), s));
}

// q: [M, 128] int8; scale: [M, 1] float32; x: [M, 128] float32. All
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int dequantize_int8(const int8_t* q, const float* scale, float* x,
                               int M, void* stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  dequantize_int8_kernel<<<blocks, kRowsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(q, scale, x, M);
  return (int)cudaGetLastError();
}
