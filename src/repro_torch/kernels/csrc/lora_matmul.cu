// Fused base + low-rank matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lora_matmul.py :: lora_matmul (body
// _kernel): y = x @ W + scale * (x @ A) @ B for x [M, K], W [K, N],
// A [K, r], B [r, N]. As in the Pallas kernel, both products accumulate in
// float32, x @ A stays float32 (it is never rounded to the input dtype),
// the rank-r product with B is taken in float32, and acc + scale * low is
// rounded once to y's dtype.
//
// W, A and B are read through strides, so the backward's dx =
// lora_matmul(g, W^T, B^T, A^T) runs on transposed views without a copy:
// W is either k-major (row stride ldw, n contiguous) or n-major (k
// contiguous); A and B take any pair of strides.
//
// What bounds it on an H100: operations. At the distillation path's shapes
// (M = 4 x 1032 tokens, (K, N) in {(1024, 1024), (1024, 512), (4096, 1024)},
// r = 4, bf16) a call does 2*M*K*N + 2*M*K*r + 2*M*r*N flops, 4.4 to 34.8
// GFLOP, against 14 to 51 MB of x, W and y: 320 to 690 flops per byte,
// above the bf16 ridge of the tensor cores (about 295).
//
// What the design does about it, as a first, simple kernel:
//   * bf16: one CTA per 128 x 128 tile of y, 8 warps of 64 x 32 each on
//     mma.sync.m16n8k16 (bf16 operands, float32 accumulators). A product of
//     two bf16 values is exact in float32, so the tensor cores form the same
//     products as the Pallas kernel's float32 dot on upcast inputs; only the
//     order of the sums differs. The K loop stages 32-deep tiles of x and W
//     in shared memory, double-buffered, with the next tile's global loads
//     held in registers while the current one is multiplied; fragments come
//     from ldmatrix (.trans for a k-major W). x @ A rides along on the same
//     x fragments: each warp computes it for one 16-row slice of the CTA's
//     128 rows, with A zero-padded to 8 or 16 columns. The epilogue takes
//     (x @ A) @ B in float32 on CUDA cores from shared memory;
//   * float32 (tests, the float32 step check): a 64 x 64 tile on CUDA cores,
//     4 x 4 outputs a thread, no TF32;
//   * ragged M, N, K and odd strides are bounds checks on the loads and
//     stores; 16-byte loads are used where a row is aligned and whole.
// bf16 operands that TMA can describe (ops.lora_route: the distillation
// path's forward and dx) run lora_matmul_tc.cu on wgmma instead; this
// kernel keeps float32 and the other bf16 layouts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lora {

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kMaxRank = 16;

// ------------------------------------------------------------ bf16 path
constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
constexpr int kThreads = 256;          // 8 warps: 2 (M) x 4 (N)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive 16-bit elements from p, the first `valid` of them real
// and the rest zero; one 16-byte load when `vec` and all eight are valid.
__device__ __forceinline__ uint4 load8(const uint16_t* p, int valid,
                                       bool vec) {
  if (vec && valid == 8) return *reinterpret_cast<const uint4*>(p);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) v[e >> 1] |= (uint32_t)p[e] << (16 * (e & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool WT, int RP>
struct Smem {
  uint16_t xs[2][BM][BK + PAD];
  uint16_t ws[2][WT ? BN : BK][WT ? BK + PAD : BN + PAD];
  uint16_t as[2][RP][BK + PAD];   // A^T tile: factor column j, then k
};

template <int RP>
struct Epi {
  float xa[BM][RP + 1];           // +1: rows of a warp hit distinct banks
  float bs[RP][BN];
};

// W(k, n) = w[k * ldw + n] (WT false) or w[n * ldw + k] (WT true);
// A(k, j) = a[k * a_sk + j * a_sr]; B(j, n) = b[j * b_sr + n * b_sn].
template <bool WT, int RP>
__global__ void __launch_bounds__(kThreads)
    lora_mma_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ w,
                    const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ b, __nv_bfloat16* __restrict__ y,
                    int M, int N, int K, int r, int ldw, int a_sk, int a_sr,
                    int b_sr, int b_sn, float scale, int vec_x, int vec_w) {
  constexpr int kSmem = sizeof(Smem<WT, RP>) > sizeof(Epi<RP>)
                            ? sizeof(Smem<WT, RP>) : sizeof(Epi<RP>);
  __shared__ __align__(16) unsigned char raw[kSmem];
  Smem<WT, RP>& sm = *reinterpret_cast<Smem<WT, RP>*>(raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
  float xacc[RP / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
  for (int t = 0; t < RP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) xacc[t][e] = 0.0f;

  // per-thread share of a K tile: 2 chunks of x, 2 of W, RP*BK/256 of A
  constexpr int kA = RP * BK / kThreads;
  uint4 xr[2], wr[2];
  uint16_t ar[kA];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + row, gk = k0 + kc;
      const int valid = gm < M ? min(8, K - gk) : 0;
      xr[i] = load8(x + (size_t)gm * K + gk, valid, vec_x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      if constexpr (!WT) {
        const int kk = c >> 4, nc = (c & 15) * 8;
        const int gk = k0 + kk, gn = n0 + nc;
        const int valid = gk < K ? min(8, N - gn) : 0;
        wr[i] = load8(w + (size_t)gk * ldw + gn, valid, vec_w);
      } else {
        const int nn = c >> 2, kc = (c & 3) * 8;
        const int gn = n0 + nn, gk = k0 + kc;
        const int valid = gn < N ? min(8, K - gk) : 0;
        wr[i] = load8(w + (size_t)gn * ldw + gk, valid, vec_w);
      }
    }
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      int j, kk;
      if (a_sk == 1) { kk = e % BK; j = e / BK; }   // k contiguous
      else { j = e % RP; kk = e / RP; }
      const int gk = k0 + kk;
      ar[i] = (j < r && gk < K) ? a[(size_t)gk * a_sk + (size_t)j * a_sr]
                                : (uint16_t)0;
    }
  };

  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sm.xs[buf][c >> 2][(c & 3) * 8]) = xr[i];
      if constexpr (!WT)
        *reinterpret_cast<uint4*>(&sm.ws[buf][c >> 4][(c & 15) * 8]) = wr[i];
      else
        *reinterpret_cast<uint4*>(&sm.ws[buf][c >> 2][(c & 3) * 8]) = wr[i];
    }
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      int j, kk;
      if (a_sk == 1) { kk = e % BK; j = e / BK; }
      else { j = e % RP; kk = e / RP; }
      sm.as[buf][j][kk] = ar[i];
    }
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    load_tile(0);
    store_tile(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tile((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], &sm.xs[buf][wm * 64 + i * 16 + (lane & 15)]
                             [ks + (lane >> 4) * 8]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t t[4];
        const int nb = wn * 32 + jp * 16;
        if constexpr (!WT)
          ldsm_x4_trans(t, &sm.ws[buf][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [nb + (lane >> 4) * 8]);
        else
          ldsm_x4(t, &sm.ws[buf][nb + (lane & 7) + (lane >> 4) * 8]
                           [ks + ((lane >> 3) & 1) * 8]);
        bf[2 * jp][0] = t[0];
        bf[2 * jp][1] = t[1];
        bf[2 * jp + 1][0] = t[2];
        bf[2 * jp + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
      // x @ A: warp (wm, wn) owns rows wm*64 + wn*16 .. +16, the x
      // fragment af[wn] it already holds
#pragma unroll
      for (int t = 0; t < RP / 8; ++t) {
        const uint16_t* arow = sm.as[buf][t * 8 + (lane >> 2)];
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(arow + ks + 2 * (lane & 3));
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(arow + ks + 8 + 2 * (lane & 3));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i == wn) mma_bf16(xacc[t], af[i], b0, b1);
      }
    }
    if (kt + 1 < nk) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue: low = (x @ A) @ B in float32, y = acc + scale * low
  Epi<RP>& ep = *reinterpret_cast<Epi<RP>*>(raw);
  {
    const int row = wm * 64 + wn * 16 + (lane >> 2);
#pragma unroll
    for (int t = 0; t < RP / 8; ++t) {
      const int col = t * 8 + 2 * (lane & 3);
      ep.xa[row][col] = xacc[t][0];
      ep.xa[row][col + 1] = xacc[t][1];
      ep.xa[row + 8][col] = xacc[t][2];
      ep.xa[row + 8][col + 1] = xacc[t][3];
    }
  }
  for (int e = tid; e < RP * BN; e += kThreads) {
    const int j = e / BN, nn = e % BN, gn = n0 + nn;
    float v = 0.0f;
    if (j < r && gn < N) {
      const uint16_t bits = b[(size_t)j * b_sr + (size_t)gn * b_sn];
      v = __uint_as_float((uint32_t)bits << 16);
    }
    ep.bs[j][nn] = v;
  }
  __syncthreads();

  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 64 + i * 16 + (lane >> 2) + h * 8;
      const int gm = m0 + row;
      float xa[RP];
#pragma unroll
      for (int t = 0; t < RP; ++t) xa[t] = ep.xa[row][t];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + 2 * (lane & 3);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float low = 0.0f;
#pragma unroll
          for (int t = 0; t < RP; ++t) low = fmaf(xa[t], ep.bs[t][col + e], low);
          v[e] = acc[i][j][2 * h + e] + scale * low;
        }
        const int gn = n0 + col;
        if (gm >= M) continue;
        __nv_bfloat16* out = y + (size_t)gm * N + gn;
        if (pairs && gn + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (gn < N) out[0] = __float2bfloat16_rn(v[0]);
          if (gn + 1 < N) out[1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
  }
}

// --------------------------------------------------------- float32 path
constexpr int FM = 64, FN = 64, FK = 16;

template <int RP>
__global__ void __launch_bounds__(256)
    lora_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ y, int M, int N, int K, int r,
                    int w_sk, int w_sn, int a_sk, int a_sr, int b_sr, int b_sn,
                    float scale) {
  __shared__ float xs[FK][FM + 4];   // k-major: a thread's 4 rows in reach
  __shared__ float ws[FK][FN + 4];
  __shared__ float as[FK][RP];
  __shared__ float xa_s[FM][RP + 1];
  __shared__ float bs[RP][FN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  // x @ A: thread owns row tid / 4, factor columns tid % 4 + 4q
  const int xrow = tid / 4, xcol = tid % 4;
  float xacc[RP / 4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FM * FK; e += 256) {
      const int row = e / FK, kk = e % FK;
      const int gm = m0 + row, gk = k0 + kk;
      xs[kk][row] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int e = tid; e < FK * FN; e += 256) {
      int kk, nn;
      if (w_sn == 1) { kk = e / FN; nn = e % FN; }   // n contiguous
      else { nn = e / FK; kk = e % FK; }
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N)
                       ? w[(size_t)gk * w_sk + (size_t)gn * w_sn] : 0.0f;
    }
    for (int e = tid; e < FK * RP; e += 256) {
      int kk, j;
      if (a_sk == 1) { j = e / FK; kk = e % FK; }
      else { kk = e / RP; j = e % RP; }
      const int gk = k0 + kk;
      as[kk][j] = (j < r && gk < K)
                      ? a[(size_t)gk * a_sk + (size_t)j * a_sr] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      const float xv0 = xs[kk][xrow];
#pragma unroll
      for (int q = 0; q < RP / 4; ++q)
        xacc[q] = fmaf(xv0, as[kk][xcol + 4 * q], xacc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) xa_s[xrow][xcol + 4 * q] = xacc[q];
  for (int e = tid; e < RP * FN; e += 256) {
    const int j = e / FN, nn = e % FN, gn = n0 + nn;
    bs[j][nn] = (j < r && gn < N) ? b[(size_t)j * b_sr + (size_t)gn * b_sn]
                                  : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i, gm = m0 + row;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j, gn = n0 + col;
      if (gn >= N) continue;
      float low = 0.0f;
#pragma unroll
      for (int t = 0; t < RP; ++t) low = fmaf(xa_s[row][t], bs[t][col], low);
      y[(size_t)gm * N + gn] = acc[i][j] + scale * low;
    }
  }
}

template <bool WT, int RP>
void launch_mma(const void* x, const void* w, const void* a, const void* b,
                void* y, int M, int N, int K, int r, int ldw, int a_sk,
                int a_sr, int b_sr, int b_sn, float scale, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (ldw % 8 == 0) && ((uintptr_t)w % 16 == 0);
  lora_mma_kernel<WT, RP><<<grid, kThreads, 0, s>>>(
      (const uint16_t*)x, (const uint16_t*)w, (const uint16_t*)a,
      (const uint16_t*)b, (__nv_bfloat16*)y, M, N, K, r, ldw, a_sk, a_sr,
      b_sr, b_sn, scale, vec_x, vec_w);
}

template <int RP>
void launch_f32(const void* x, const void* w, const void* a, const void* b,
                void* y, int M, int N, int K, int r, int w_sk, int w_sn,
                int a_sk, int a_sr, int b_sr, int b_sn, float scale,
                cudaStream_t s) {
  const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  lora_f32_kernel<RP><<<grid, 256, 0, s>>>(
      (const float*)x, (const float*)w, (const float*)a, (const float*)b,
      (float*)y, M, N, K, r, w_sk, w_sn, a_sk, a_sr, b_sr, b_sn, scale);
}

}  // namespace lora

// y [M, N] = x [M, K] @ W + scale * (x @ A) @ B, all of dtype `dtype`
// (0 float32, 1 bfloat16); x and y contiguous; W(k, n) at
// w[k * w_sk + n * w_sn] with w_sn == 1 or w_sk == 1; A(k, j) at
// a[k * a_sk + j * a_sr]; B(j, n) at b[j * b_sr + n * b_sn]; 1 <= r <= 16.
// Returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int lora_matmul(int dtype, const void* x, const void* w,
                           const void* a, const void* b, void* y, int M, int N,
                           int K, int r, int w_sk, int w_sn, int a_sk, int a_sr,
                           int b_sr, int b_sn, float scale, void* stream) {
  using namespace lora;
  cudaStream_t s = (cudaStream_t)stream;
  if (r < 1 || r > kMaxRank || (w_sn != 1 && w_sk != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const bool wt = w_sn != 1;          // n-major W (a transposed view)
    const int ldw = wt ? w_sn : w_sk;
    if (r <= 8) {
      if (wt) launch_mma<true, 8>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr, b_sr, b_sn, scale, s);
      else launch_mma<false, 8>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr, b_sr, b_sn, scale, s);
    } else {
      if (wt) launch_mma<true, 16>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr, b_sr, b_sn, scale, s);
      else launch_mma<false, 16>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr, b_sr, b_sn, scale, s);
    }
  } else if (dtype == kF32) {
    if (r <= 4) launch_f32<4>(x, w, a, b, y, M, N, K, r, w_sk, w_sn, a_sk, a_sr, b_sr, b_sn, scale, s);
    else if (r <= 8) launch_f32<8>(x, w, a, b, y, M, N, K, r, w_sk, w_sn, a_sk, a_sr, b_sr, b_sn, scale, s);
    else launch_f32<16>(x, w, a, b, y, M, N, K, r, w_sk, w_sn, a_sk, a_sr, b_sr, b_sn, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
