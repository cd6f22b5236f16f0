// Fused base + low-rank matmul on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel repro/kernels/lora_matmul.py :: lora_matmul (body
// _kernel) for bf16 operands that TMA can describe, the route the
// distillation path runs; lora_matmul.cu keeps float32 and the other bf16
// layouts. y = x @ W + scale * (x @ A) @ B for x [M, K], W [K, N],
// A [K, r], B [r, N]: both products accumulate in float32, x @ A stays
// float32 (it is never rounded), the rank-r product with B is taken in
// float32 and acc + scale * low is rounded once to bf16, as in the Pallas
// kernel and lora_matmul.cu.
//
// W is one tensor map over its storage: k-major (the forward's w [K, N], n
// contiguous), read as an MN-major wgmma operand (the transpose bit), or
// n-major (the backward's dx = lora_matmul(g, W^T, B^T, A^T): w^T's k
// contiguous), read K-major. A and B are read through their strides.
//
// What bounds it on an H100: operations. At the distillation path's shapes
// (M = 4 x 1032, (K, N) in {(1024, 1024), (1024, 512), (4096, 1024)} and
// the transposes, r = 4) a call does 2 M K N + 2 M K r + 2 M r N flops,
// 4.4 to 34.8 GFLOP, against 14 to 51 MB: 320 to 690 flops per byte,
// above the bf16 ridge (about 295).
//
// What the design does about it:
//   * a CTA owns a 128 x 128 tile of y; two consumer warpgroups own 64 rows
//     each and issue m64n128k16 wgmmas with both operands in shared memory;
//   * a producer thread keeps a STAGES-deep ring of 64-deep x and W tiles
//     in flight by TMA (128-byte swizzle, full and empty mbarriers a
//     stage); rows and columns past M, N or K read as zeros, so ragged
//     edges cost no code in the loop;
//   * x @ A rides on the same x tile: A's 64 x r slice, zero-padded to RP
//     (8 or 16) factors, is the K-major B operand of an m64nRPk16 wgmma.
//     A's rows are r elements apart (8 bytes at r = 4), which TMA cannot
//     describe, so NA copy warps move each slice with ordinary loads into
//     the swizzled layout, each warp its own stages so that their loads'
//     latencies overlap, and publish it to the async proxy before they
//     arrive on the stage's full barrier;
//   * the epilogue gathers each row's RP float32 x @ A values within its
//     quad, forms scale * (x @ A) @ B on CUDA cores from B's slice (which
//     the copy warps stage in shared memory as float32 while the products
//     run), adds it to the accumulator and rounds once; stores are
//     bounds-checked.
#include "hopper.cuh"

namespace lora_tc {

using namespace hopper;

constexpr int BM = 128;         // rows of y a CTA: two warpgroups of 64
constexpr int BN = 128;         // columns of y a CTA (wgmma N)
constexpr int BK = 64;          // depth of a stage (128-byte rows)
constexpr int STAGES = 4;
constexpr int NA = 3;           // warps that copy A's slices and B
constexpr int kThreads = 2 * 128 + 32 + NA * 32;
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BYTES = BK * BN * 2;
constexpr int kMaxRank = 16;

template <int RP>
struct Smem {
  __nv_bfloat16 x[STAGES][BM * BK];   // K-major
  // WT: [BN n][BK k], K-major; else two [BK k][64 n] halves, MN-major
  __nv_bfloat16 w[STAGES][BK * BN];
  __nv_bfloat16 a[STAGES][RP * BK];   // A^T: factor j's BK values, K-major
  float bs[RP][BN];                   // B's slice, float32
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint64_t b_full;
};

// x @ A's product for one 16-deep step: n8 for RP 8, n16 for RP 16.
template <int RP>
__device__ __forceinline__ void mma_xa(float (&d)[RP / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (RP == 8) wgmma_ss_m64n8(d, da, db, 1);
  else wgmma_ss_m64n16(d, da, db, 1);
}

// The TMA thread: x and W tiles of every stage.
template <bool WT, int RP>
__device__ __forceinline__ void produce_tiles(Smem<RP>& s,
                                              const CUtensorMap& tx,
                                              const CUtensorMap& tw, int m0,
                                              int n0, int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&s.empty[st], ((kt / STAGES) & 1) ^ 1);
    mbar_expect_tx(&s.full[st], X_BYTES + W_BYTES);
    tma_load_2d(s.x[st], &tx, &s.full[st], kt * BK, m0);
    if constexpr (WT) {
      tma_load_2d(s.w[st], &tw, &s.full[st], kt * BK, n0);
    } else {
      tma_load_2d(s.w[st], &tw, &s.full[st], n0, kt * BK);
      tma_load_2d(s.w[st] + BK * 64, &tw, &s.full[st], n0 + 64, kt * BK);
    }
  }
}

// Copy warp `cw` (of NA): A's slices of stages cw, cw + NA, ..., then its
// share of B's slice.
template <int RP>
__device__ __forceinline__ void produce_factors(
    Smem<RP>& s, const uint16_t* __restrict__ a,
    const uint16_t* __restrict__ b, int cw, int n0, int N, int K, int r,
    int nk, int a_sk, int a_sr, int b_sr, int b_sn) {
  const int lane = threadIdx.x % 32;
  for (int kt = cw; kt < nk; kt += NA) {
    const int st = kt % STAGES;
    uint16_t v[2 * RP];
#pragma unroll
    for (int q = 0; q < 2 * RP; ++q) {
      const int j = q / 2, kk = lane + 32 * (q % 2);
      const int gk = kt * BK + kk;
      v[q] = (j < r && gk < K)
                 ? a[(size_t)gk * a_sk + (size_t)j * a_sr] : (uint16_t)0;
    }
    mbar_wait(&s.empty[st], ((kt / STAGES) & 1) ^ 1);
    unsigned char* dst = reinterpret_cast<unsigned char*>(s.a[st]);
#pragma unroll
    for (int q = 0; q < 2 * RP; ++q) {
      const int j = q / 2, kk = lane + 32 * (q % 2);
      *reinterpret_cast<uint16_t*>(dst + swizzle128(j * 128 + kk * 2)) = v[q];
    }
    fence_proxy_async();
    mbar_arrive(&s.full[st]);
  }
  for (int e = cw * 32 + lane; e < RP * BN; e += NA * 32) {
    const int j = e / BN, nn = e % BN, gn = n0 + nn;
    float val = 0.0f;
    if (j < r && gn < N)
      val = __uint_as_float(
          (uint32_t)b[(size_t)j * b_sr + (size_t)gn * b_sn] << 16);
    s.bs[j][nn] = val;
  }
  mbar_arrive(&s.b_full);
}

// A consumer warpgroup wg: rows m0 + 64 wg .. + 63 of the CTA's tile.
template <bool WT, int RP>
__device__ __forceinline__ void consume(Smem<RP>& s,
                                        __nv_bfloat16* __restrict__ y,
                                        int m0, int n0, int M, int N, int r,
                                        int nk, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  float acc[64], xa[RP / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) xa[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&s.full[st], (kt / STAGES) & 1);
    const uint64_t dx = desc_sw128(s.x[st] + wg * 64 * BK);
    const uint64_t dw = WT ? desc_sw128(s.w[st])
                           : desc_sw128_lbo(s.w[st], BK * 64 * 2);
    const uint64_t dxa = desc_sw128(s.a[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // a 16-deep step: 32 bytes along a K-major row, 16 rows (2048
      // bytes) down an MN-major tile
      wgmma_ss_m64n128<WT ? 0 : 1>(acc, dx + 2 * kk,
                                   dw + (WT ? 2 * kk : 128 * kk), 1);
      mma_xa<RP>(xa, dx + 2 * kk, dxa + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();          // stage kt - 1's products are done
    if (kt > 0 && lane == 0) mbar_arrive(&s.empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(xa);

  // ---- epilogue: y = acc + scale * (x @ A) @ B, rounded once
  // the RP x @ A values of this thread's rows (row0, row0 + 8): factor c
  // sits in register 4 (c / 8) + 2 h + c % 2 of quad lane (c % 8) / 2
  float xr[2][RP];
#pragma unroll
  for (int c = 0; c < RP; ++c) {
    const int src = (lane & ~3) | ((c & 7) >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xr[h][c] = __shfl_sync(0xffffffffu, xa[4 * (c / 8) + 2 * h + (c & 1)],
                             src);
  }
  mbar_wait(&s.b_full, 0);
  const int row0 = m0 + wg * 64 + 16 * (warp % 4) + lane / 4;
  const int c_lo = 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int col = 8 * jb + c_lo;
    float low[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int t = 0; t < RP; ++t) {
      if (t >= r) break;
      const float2 bv = *reinterpret_cast<const float2*>(&s.bs[t][col]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        low[h][0] = fmaf(xr[h][t], bv.x, low[h][0]);
        low[h][1] = fmaf(xr[h][t], bv.y, low[h][1]);
      }
    }
    const int gn = n0 + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + 8 * h;
      if (gm >= M || gn >= N) continue;
      const float v0 = acc[4 * jb + 2 * h] + scale * low[h][0];
      const float v1 = acc[4 * jb + 2 * h + 1] + scale * low[h][1];
      __nv_bfloat16* out = y + (size_t)gm * N + gn;
      if (pairs && gn + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0,
                                                                        v1);
      } else {
        out[0] = __float2bfloat16_rn(v0);
        if (gn + 1 < N) out[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// W(k, n) = w[k * ldw + n] (WT false) or w[n * ldw + k] (WT true);
// A(k, j) = a[k * a_sk + j * a_sr]; B(j, n) = b[j * b_sr + n * b_sn].
template <bool WT, int RP>
__global__ void __launch_bounds__(kThreads, 1)
lora_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const uint16_t* __restrict__ a,
                  const uint16_t* __restrict__ b,
                  __nv_bfloat16* __restrict__ y, int M, int N, int K, int r,
                  int a_sk, int a_sr, int b_sr, int b_sn, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem<RP>& s = *reinterpret_cast<Smem<RP>*>(align1024(smem_raw));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1 + 32);   // the TMA thread + one copy warp
      mbar_init(&s.empty[i], 8);       // one arrival per consumer warp
    }
    mbar_init(&s.b_full, NA * 32);
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 8) {                                // the TMA warp
    if (threadIdx.x % 32 == 0)
      produce_tiles<WT, RP>(s, tx, tw, m0, n0, nk);
  } else if (warp > 8) {                          // the copy warps
    produce_factors<RP>(s, a, b, warp - 9, n0, N, K, r, nk, a_sk, a_sr, b_sr,
                        b_sn);
  } else {
    consume<WT, RP>(s, y, m0, n0, M, N, r, nk, scale);
  }
}

template <bool WT, int RP>
static int launch(const void* x, const void* w, const void* a, const void* b,
                  void* y, int M, int N, int K, int r, int ldw, int a_sk,
                  int a_sr, int b_sr, int b_sn, float scale,
                  cudaStream_t stream) {
  CUtensorMap tx, tw;
  cudaError_t err = bf16_matrix_map(&tx, x, M, K, K, BM, BK);
  if (err == cudaSuccess)
    err = WT ? bf16_matrix_map(&tw, w, N, K, ldw, BN, BK)
             : bf16_matrix_map(&tw, w, K, N, ldw, BK, 64);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem<RP>) + 1024;   // + alignment slack
  auto kernel = lora_wgmma_kernel<WT, RP>;
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      tx, tw, (const uint16_t*)a, (const uint16_t*)b, (__nv_bfloat16*)y, M,
      N, K, r, a_sk, a_sr, b_sr, b_sn, scale);
  return (int)cudaGetLastError();
}

}  // namespace lora_tc

// y [M, N] = x [M, K] @ W + scale * (x @ A) @ B, all bf16; x and y
// contiguous, K >= 1 a multiple of 8; W(k, n) at w[k * w_sk + n * w_sn]
// with w_sn == 1 or w_sk == 1 and the other stride a multiple of 8; x and
// w 16-byte aligned; A(k, j) at a[k * a_sk + j * a_sr]; B(j, n) at
// b[j * b_sr + n * b_sn]; 1 <= r <= 16. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int lora_matmul_tc(const void* x, const void* w, const void* a,
                              const void* b, void* y, int M, int N, int K,
                              int r, int w_sk, int w_sn, int a_sk, int a_sr,
                              int b_sr, int b_sn, float scale, void* stream) {
  using namespace lora_tc;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wt = w_sn != 1;          // n-major W (a transposed view)
  const int ldw = wt ? w_sn : w_sk;
  if (r < 1 || r > kMaxRank || (wt && w_sk != 1) || K < 1 || K % 8 != 0 ||
      ldw % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (r <= 8)
    return wt ? launch<true, 8>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr,
                                b_sr, b_sn, scale, s)
              : launch<false, 8>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr,
                                 b_sr, b_sn, scale, s);
  return wt ? launch<true, 16>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr,
                               b_sr, b_sn, scale, s)
            : launch<false, 16>(x, w, a, b, y, M, N, K, r, ldw, a_sk, a_sr,
                                b_sr, b_sn, scale, s);
}

// Dynamic shared memory of a CTA for ranks up to rp (8 or 16), in bytes.
extern "C" int lora_matmul_tc_smem(int rp) {
  return rp <= 8 ? (int)sizeof(lora_tc::Smem<8>) + 1024
                 : (int)sizeof(lora_tc::Smem<16>) + 1024;
}
