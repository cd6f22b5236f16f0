// Rowwise int8 stochastic quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py :: quantize_int8 (body
// _quant_kernel). Rows are 128 lanes of float32 with 32-bit random words
// beside them; each row gets a float32 absmax scale and int8 codes
// q = clip(floor(x / scale + bits * 2^-32), -127, 127), and an all-zero
// row gets scale 0.
//
// The scale is absmax times the float32 reciprocal of 127, not a division
// by 127: that is what the reference computes once XLA has folded its
// division by the constant into a multiplication, and the tests hold the
// port to the reference bitwise.
//
// What bounds it on an H100: bytes. Per element it reads 8 bytes (x and
// bits) and writes 1, for a handful of flops. The design moves each byte
// once: one warp owns one row, each lane loads 4 floats and 4 words with
// one 16-byte load apiece, the absmax is a shuffle reduction in registers,
// and each lane stores its 4 codes as one 32-bit word.
//
// Bitwise contract with the plain version: x / scale is a correctly
// rounded IEEE division (__fdiv_rn; never a reciprocal multiply, so the
// build never passes --use_fast_math), the bits go to float32 with round
// to nearest (__uint2float_rn), and the explicit _rn intrinsics keep the
// compiler from contracting the add into anything else.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 8;   // one warp per row
constexpr float kInvQmax = 0x1.020408p-7f;   // float32(1 / 127)

__device__ __forceinline__ signed char code(float x, uint32_t bits,
                                            float safe) {
  const float u = __fmul_rn(__uint2float_rn(bits), 2.3283064365386963e-10f);
  const float v = floorf(__fadd_rn(__fdiv_rn(x, safe), u));
  return (signed char)fminf(fmaxf(v, -127.0f), 127.0f);
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    quantize_int8_kernel(const float* __restrict__ x,
                         const uint32_t* __restrict__ bits,
                         int8_t* __restrict__ q, float* __restrict__ scale,
                         int M) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;   // uniform across the warp
  const size_t base = (size_t)row * kLanes + lane * 4;
  const float4 xv = *reinterpret_cast<const float4*>(x + base);
  const uint4 bv = *reinterpret_cast<const uint4*>(bits + base);
  float amax = fmaxf(fmaxf(fabsf(xv.x), fabsf(xv.y)),
                     fmaxf(fabsf(xv.z), fabsf(xv.w)));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(amax, kInvQmax);
  const float safe = amax > 0.0f ? s : 1.0f;
  char4 out;
  out.x = code(xv.x, bv.x, safe);
  out.y = code(xv.y, bv.y, safe);
  out.z = code(xv.z, bv.z, safe);
  out.w = code(xv.w, bv.w, safe);
  *reinterpret_cast<char4*>(q + base) = out;
  if (lane == 0) scale[row] = amax > 0.0f ? s : 0.0f;
}

// x: [M, 128] float32; bits: [M, 128] uint32; q: [M, 128] int8;
// scale: [M, 1] float32. All 16-byte aligned. Returns cudaGetLastError().
extern "C" int quantize_int8(const float* x, const uint32_t* bits, int8_t* q,
                             float* scale, int M, void* stream) {
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_int8_kernel<<<blocks, kRowsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(x, bits, q, scale, M);
  return (int)cudaGetLastError();
}
