// Flash-attention backward preprocess for Hopper (sm_90a), on 16-byte
// loads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_bwd's first pallas_call (body _bwd_preprocess_kernel):
// delta = rowsum(dO * O) in float32, one value per query row, the softmax
// Jacobian's diagonal term that the dK/dV and dQ kernels subtract.
//
// What bounds it on an H100: bytes. It reads O and dO once (2*D elements a
// row) for D FMAs and writes 4 bytes a row: at the training shape (65 536
// rows of bf16 D 64) 16.8 MB, about 5 us at 3.35 TB/s.
//
// Why flash_bwd_preprocess.cu (one warp a row) stays under half of that:
// its lanes load 2-byte elements, so a warp's load moves 64 bytes, and its
// 8-row CTAs hold 2 KB of input each. Too few bytes are in flight per SM,
// and CTA launch and tail take most of the time.
//
// What this design does about it:
//   * every load is 16 bytes (8 bf16 or 4 float32), a read-once stream
//     (ld.global.nc with L1::no_allocate);
//   * a row belongs to a group of T = D * esz / 16 neighbouring lanes, lane
//     c of the group holding the row's c-th 16-byte slice, so one load of
//     a warp covers 32 / T whole rows: 512 contiguous bytes;
//   * each thread carries kRows = 4 rows (its group's rows g, g + 32/T, ...
//     of the warp's tile) and issues all 8 loads before its first FMA: a
//     256-thread CTA has 32 KB in flight. 1, 2 and 4 rows a thread ran the
//     training shape equally fast on an H100; 8 ran slower (fewer CTAs
//     than SMs);
//   * a slice's products are float32 FMAs in element order from 0, then
//     log2(T) xor shuffles sum the group's partials; the order is fixed and
//     there are no atomics, so every run gives the same bits;
//   * the grid is at most the CTAs the card holds at once, each walking its
//     tiles (8 warps x kRows x 32/T rows) with a grid stride: any row count,
//     the last tile's missing rows loading nothing and storing nothing.
//
// Error bound (what the checks hold delta to): a product enters the row's
// sum through at most E = 16 / esz FMAs and log2(T) adds, at most 12
// roundings for D <= 128, each of relative size <= 2^-24, so |delta -
// exact| <= 12 * 2^-24 * sum_d |O * dO| to first order.
#include <algorithm>

#include "flash_attention.cuh"

namespace flash_vec {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;   // rows a thread carries

__device__ __forceinline__ uint4 ld_stream(const char* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Sum of a 16-byte slice's products, element 0 first, from zero.
__device__ __forceinline__ float slice_dot(const uint4& a, const uint4& b,
                                          float) {
  float acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), 0.0f);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

// bf16 pairs: a word's low half is the earlier element.
__device__ __forceinline__ float pair_fma(uint32_t a, uint32_t b, float acc) {
  acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(b & 0xffff0000u), acc);
}

__device__ __forceinline__ float slice_dot(const uint4& a, const uint4& b,
                                          __nv_bfloat16) {
  float acc = pair_fma(a.x, b.x, 0.0f);
  acc = pair_fma(a.y, b.y, acc);
  acc = pair_fma(a.z, b.z, acc);
  return pair_fma(a.w, b.w, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    preprocess_vec_kernel(const T* __restrict__ o,
                          const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows) {
  constexpr int kRowBytes = D * (int)sizeof(T);
  constexpr int kT = kRowBytes / 16;       // lanes of a row
  constexpr int kG = 32 / kT;              // rows of one warp load
  constexpr int kWarpRows = kG * kRows;
  constexpr long long kCtaRows = (long long)kWarps * kWarpRows;
  const int lane = threadIdx.x & 31;
  const int c = lane % kT;
  const long long lead = (threadIdx.x >> 5) * kWarpRows + lane / kT;
  const char* ob = reinterpret_cast<const char*>(o) + c * 16;
  const char* db = reinterpret_cast<const char*>(dout) + c * 16;
  // uniform across the CTA, so every lane reaches the shuffles
  for (long long tile = blockIdx.x; tile * kCtaRows < rows;
       tile += gridDim.x) {
    const long long first = tile * kCtaRows + lead;
    uint4 a[kRows], b[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long row = first + j * kG;
      if (row < rows) {
        a[j] = ld_stream(ob + row * kRowBytes);
        b[j] = ld_stream(db + row * kRowBytes);
      } else {
        a[j] = b[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float acc = slice_dot(a[j], b[j], T());
#pragma unroll
      for (int off = kT / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(flash::kFull, acc, off);
      const long long row = first + j * kG;
      if (c == 0 && row < rows) delta[row] = acc;
    }
  }
}

template <typename T, int D>
static int launch(const void* o, const void* dout, float* delta,
                  long long rows, cudaStream_t st) {
  constexpr long long kCtaRows = (long long)kWarps * kRows *
                                 (32 * 16 / (D * sizeof(T)));
  auto kern = preprocess_vec_kernel<T, D>;
  static int slots = 0;   // CTAs the card holds at once (first launch)
  if (slots == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, 0);
    slots = std::max(1, sms * per);
  }
  const long long tiles = (rows + kCtaRows - 1) / kCtaRows;
  const int grid = (int)std::min<long long>(tiles, slots);
  kern<<<grid, kThreads, 0, st>>>((const T*)o, (const T*)dout, delta, rows);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dim(int D, const void* o, const void* dout, float* delta,
                      long long rows, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(o, dout, delta, rows, st);
    case 64: return launch<T, 64>(o, dout, delta, rows, st);
    case 128: return launch<T, 128>(o, dout, delta, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_vec

// o, dout: [rows, D] of `dtype` (0 float32, 1 bf16), contiguous, 16-byte
// aligned; delta: [rows] float32; rows >= 1; D in {32, 64, 128}. Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_bwd_preprocess_vec(int dtype, const void* o,
                                                  const void* dout,
                                                  float* delta,
                                                  long long rows, int D,
                                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == flash::kF32)
    return flash_vec::launch_dim<float>(D, o, dout, delta, rows, st);
  if (dtype == flash::kBF16)
    return flash_vec::launch_dim<__nv_bfloat16>(D, o, dout, delta, rows,
                                                st);
  return (int)cudaErrorInvalidValue;
}
