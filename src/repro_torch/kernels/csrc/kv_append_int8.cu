// Fused int8 K/V append for the paged cache, Hopper (sm_90a).
//
// The serving route of the TPU kernel repro/kernels/quantize.py ::
// quantize_int8 (body _quant_kernel): the int8 KV cache quantizes every
// (token, kv-head) row of K and V with a per-row absmax scale and
// deterministic round-to-nearest (random word pinned to 2**31, u = 0.5),
// and scatters codes and scales into the pools. As separate operations (a
// float copy, padding to 128 lanes, a bits tensor, the quantize kernel, a
// slice copy, four index_put_ scatters) that is about fourteen device
// operations per layer and step, each with its host-side dispatch; this
// is one launch.
//
// Rows: k, v [P, R, D] (P leading planes: a layer's KV heads, or every
// layer's) in their own dtype (float32 or bf16), D <= 128, each read
// through its own plane and row strides (a layer's K and V are views of
// its projections' outputs, [N, Hkv, D] seen as [Hkv, N, D]: no copy).
// Position n in
// [0, N) takes row n (a zero row for n >= R) to pool block blk, offset o
// of every plane: (blk, o) = (phys[n], off[n]) when phys is given, else
// (table[n / bs], n % bs). Pools kq, vq [P, NB, bs, D] int8 and scales
// ks, vs [P, NB, bs] float32 are written in place.
//
// Bitwise contract with quantize_int8 on the zero-padded row and pinned
// bits: padding cannot change the absmax, so a row narrower than 128
// lanes is masked instead; scale = absmax * float32(1/127) (__fmul_rn with
// the same 0x1.020408p-7f), code = clip(floor(x / scale + 0.5)) with
// __fdiv_rn and __fadd_rn, an all-zero row scale 0 and code 0.
//
// What bounds it on an H100: the launch. A decode step's append is 16 KB
// of bf16 rows for 8 lanes; the kernel moves each byte once (one warp a
// row, each lane up to four elements, the absmax a shuffle reduction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kv_append {

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kRowsPerBlock = 8;      // one warp a row
constexpr float kInvQmax = 0x1.020408p-7f;   // float32(1 / 127)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ long long idx(const void* p, int is64,
                                         long long i) {
  return is64 ? reinterpret_cast<const long long*>(p)[i]
              : (long long)reinterpret_cast<const int*>(p)[i];
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32) kv_append_kernel(
    const T* __restrict__ k, const T* __restrict__ v, int8_t* __restrict__ kq,
    int8_t* __restrict__ vq, float* __restrict__ ks, float* __restrict__ vs,
    const void* __restrict__ phys, const void* __restrict__ off,
    const void* __restrict__ table, int idx64, long long ksp, long long ksn,
    long long vsp, long long vsn, int P, int R, int N, int D, int NB,
    int bs) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= 2LL * P * N) return;               // uniform across the warp
  const bool is_v = row >= (long long)P * N;
  const long long pr = is_v ? row - (long long)P * N : row;
  const int p = (int)(pr / N), n = (int)(pr % N);
  long long blk, o;
  if (phys != nullptr) {
    blk = idx(phys, idx64, n);
    o = idx(off, idx64, n);
  } else {
    blk = idx(table, idx64, n / bs);
    o = n % bs;
  }
  const T* src = is_v ? v + p * vsp + (long long)n * vsn
                      : k + p * ksp + (long long)n * ksn;
  float x[4];
  float amax = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u;
    x[u] = (e < D && n < R) ? to_f(src[e]) : 0.0f;
    amax = fmaxf(amax, fabsf(x[u]));
  }
  for (int s = 16; s > 0; s >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  const float sc = __fmul_rn(amax, kInvQmax);
  const float safe = amax > 0.0f ? sc : 1.0f;
  const long long slot = ((long long)p * NB + blk) * bs + o;
  int8_t* dst = (is_v ? vq : kq) + slot * D;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u;
    if (e < D) {
      const float c = floorf(__fadd_rn(__fdiv_rn(x[u], safe), 0.5f));
      dst[e] = (int8_t)fminf(fmaxf(c, -127.0f), 127.0f);
    }
  }
  if (lane == 0) (is_v ? vs : ks)[slot] = amax > 0.0f ? sc : 0.0f;
}

}  // namespace kv_append

// k, v: [P, R, D] rows (dtype code: float32 or bf16), element (p, n, e)
// of k at p ksp + n ksn + e (v likewise); kq, vq: [P, NB, bs, D] int8;
// ks, vs: [P, NB, bs] float32, contiguous. phys and
// off: [N] positions' block ids and offsets, or phys null and table
// [ceil(N / bs)] block ids; int64 when idx64, else int32. D <= 128.
// Returns cudaGetLastError() of the launch.
extern "C" int kv_append_int8(int dtype, const void* k, const void* v,
                              void* kq, void* vq, void* ks, void* vs,
                              const void* phys, const void* off,
                              const void* table, int idx64, long long ksp,
                              long long ksn, long long vsp, long long vsn,
                              int P, int R, int N, int D, int NB, int bs,
                              void* stream) {
  using namespace kv_append;
  if (D < 1 || D > 128 || P < 1 || N < 1 || bs < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = 2LL * P * N;
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) /
                                     kRowsPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  int8_t *q8 = (int8_t*)kq, *v8 = (int8_t*)vq;
  float *sk = (float*)ks, *sv = (float*)vs;
  if (dtype == kF32)
    kv_append_kernel<float><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        (const float*)k, (const float*)v, q8, v8, sk, sv, phys, off, table,
        idx64, ksp, ksn, vsp, vsn, P, R, N, D, NB, bs);
  else if (dtype == kBF16)
    kv_append_kernel<__nv_bfloat16><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, q8, v8, sk, sv,
        phys, off, table, idx64, ksp, ksn, vsp, vsn, P, R, N, D, NB, bs);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
