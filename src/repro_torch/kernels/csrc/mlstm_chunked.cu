// Chunkwise stabilized mLSTM (xLSTM) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mlstm.py :: mlstm_chunked (body
// _kernel): the mLSTM recurrence of ref.mlstm_chunked_ref in the chunkwise
// form of models/recurrent.mlstm_chunk_body. For q, k, v [B, NH, S, DH]
// (k pre-scaled) and gates ig, lf [B, NH, S] it returns h [B, NH, S, DH]
// and the final state C [B, NH, DH, DH], n [B, NH, DH], m [B, NH]. Within a
// chunk of c steps, with b_t the inclusive cumsum of lf:
//   m_t = b_t + max(m_in, max_{j<=t} (i_j - b_j))
//   D_tj = exp(b_t - b_j + i_j - m_t)                    (j <= t only)
//   h_t = [sum_j D_tj (q_t.k_j) v_j + e^{m_in + b_t - m_t} C q_t] / den_t
//   den_t = max(|sum_j D_tj (q_t.k_j) + e^{m_in + b_t - m_t} n.q_t|, e^{-m_t})
// and the carry C' = e^{m_in + b_c - m_c} C + sum_j w_j v_j k_j^T with
// w_j = exp(b_c - b_j + i_j - m_c), n' likewise. den uses n_t.q_t written
// out as the sums above, which is the reference's (D k + e^{..} n).q.
// Everything is float32 (q, k, v may be bf16 and are upcast on load); h is
// rounded once to q's dtype. The optional initial state (C0, n0, m0) lets
// a segment continue; without it C = 0, n = 0, m = -1e30, as the Pallas
// kernel's _init. exp() of a masked (j > t) entry is never taken, and
// exp(m_in + b_t - m_t) at m_in = -1e30 is exactly 0.
//
// What bounds it on an H100: operations, on the CUDA cores (float32; one
// TF32 pass would change the function). At the serving path's shape (B 8, NH 4,
// S 512, DH 512, float32) the function needs 4 S DH^2 flops per (b, h) for
// C q and the C update, plus 4 DH flops per causal (t, j) pair inside a
// chunk for q.k and the P v product: 18.3 GFLOP at chunk 64, 0.27 ms at
// 67 TFLOP/s, against 202 MB of q, k, v, C0, h and C (0.06 ms at 3.35 TB/s).
//
// What the design does about it, as a first, simple kernel:
//   * The Pallas program keeps one (b, h)'s whole C in VMEM. At DH 512 that
//     is 1 MiB, far over an SM's 227 KB. So a CTA owns 64 rows of C (the v
//     dimension) for one (b, h): grid (DH / 64, NH, B), 256 CTAs on the
//     path, and walks the chunks in order. Its C slice (64 x DH float32,
//     139 KB at DH 512) stays in shared memory for the whole sequence.
//   * Per chunk of 64 steps: the gates' scans (cumsum, running max) on one
//     thread; then q and k stream through shared memory in 64-wide tiles
//     of the key dimension, giving S = q k^T [64, 64], C q for the CTA's
//     rows (one loop, sharing q's operand) and q.n; P = S o D in registers
//     (D only where j <= t); h's rows from P v and C q; then k streams
//     again for C += (w o v)^T k and n. Each tile's global loads are issued
//     into registers while the tile before it is multiplied. S, D, n and
//     den are the same for every row slice, and each CTA recomputes them:
//     c^2 DH + c DH against the c DH^2 of its C terms.
//   * Every product is one 64 x 64 output tile on 256 threads, 4 x 4
//     outputs a thread, operands k-major in shared memory with 16-byte
//     rows of 68 floats: each k step reads one float4 of each operand.
//   * Any S: the last chunk is masked (rows past S are zero and skipped).
// This is the "simt" route: mlstm_chunked_tc.cu (3xTF32 wgmma, S shared
// across a cluster) takes DH 64, 128, 256 and 512.
//
// Saved states: with non-null `sC, sn, sm, smt, sqn` (all or none; the
// training path's forward, ops._MlstmChunkedAD) the launch takes the kSave
// instantiation, which also writes what the backward
// (mlstm_chunked_bwd.cu) needs: each chunk's starting C, n and m, and
// every step's m_t and signed qn_t = sum_j P_tj + inter_t q_t.n, whose
// magnitude den_t takes. Serving passes null and runs the instantiation
// without the stores; h and the final state are the same bitwise either
// way.
//
// Phase clocks: with a non-null `prof`, thread 0 of every CTA adds the
// clock64() cycles between the CTA barriers that separate its phases to
// prof[kProfPhases] (loads, scans, S and C q, P, P v and h, update, all):
// the time each phase holds the CTA, summed over CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlstm {

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kC = 64;                // time steps per chunk
constexpr int kR = 64;                // rows of C a CTA owns
constexpr int kT = 64;                // key-dimension tile
constexpr int kLd = 68;               // row stride of a 64-wide smem tile:
                                      // 16-byte rows, conflict-free stores
constexpr int kThreads = 256;         // 16 x 16, 4 x 4 outputs each
constexpr int kPer = kC * kT / kThreads;   // tile elements per thread
constexpr float kMInit = -1e30f;
constexpr int kProfPhases = 7;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4][4], const float4& a,
                                     const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc[a][b] += sum_{k < n} A[k][4 ty + a] * B[k][4 tx + b]; both operands
// k-major with row stride kLd.
__device__ __forceinline__ void outer(float (&acc)[4][4],
                                      const float* __restrict__ A,
                                      const float* __restrict__ B, int n,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < n; ++k)
    fma4(acc, ld4(A + k * kLd + 4 * ty), ld4(B + k * kLd + 4 * tx));
}

// A 64 x 64 tile of rows [t0, t0 + cl) and columns [e0, e0 + ne) of a
// [S, Dh] matrix, zero-padded, through registers. Transposed (dst[e][t]):
// a warp takes 4 rows x 8 columns per step, so its global reads are 32-byte
// row pieces and its stores hit 32 distinct banks. Natural (dst[t][e]): a
// warp takes 32 consecutive columns of one row.
template <typename T>
__device__ __forceinline__ void load_tile(float (&r)[kPer],
                                          const T* __restrict__ src, int t0,
                                          int cl, int e0, int ne, int Dh,
                                          bool transposed) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    int t, e;
    if (transposed) {
      const int blk = it * 8 + warp;            // 8 e-blocks x 16 t-blocks
      e = (blk & 7) * 8 + (lane & 7);
      t = (blk >> 3) * 4 + (lane >> 3);
    } else {
      const int idx = it * kThreads + tid;
      t = idx >> 6;
      e = idx & 63;
    }
    r[it] = (t < cl && e < ne)
                ? to_f(src[(size_t)(t0 + t) * Dh + e0 + e]) : 0.f;
  }
}

__device__ __forceinline__ void store_tile(const float (&r)[kPer],
                                           float* __restrict__ dst,
                                           bool transposed) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    if (transposed) {
      const int blk = it * 8 + warp;
      const int e = (blk & 7) * 8 + (lane & 7);
      const int t = (blk >> 3) * 4 + (lane >> 3);
      dst[e * kLd + t] = r[it];
    } else {
      const int idx = it * kThreads + tid;
      dst[(idx >> 6) * kLd + (idx & 63)] = r[it];
    }
  }
}

size_t smem_bytes(int Dh) {
  // C slice, three 64 x 64 tiles, n, five gate rows, q.n partials, m
  return ((size_t)Dh * kLd + 3 * kT * kLd + Dh + 5 * kC + 4 * kC + 4) *
         sizeof(float);
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads) mlstm_chunked_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ lf, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    T* __restrict__ h, float* __restrict__ Cout, float* __restrict__ nout,
    float* __restrict__ mout, int S, int Dh, float* __restrict__ sC,
    float* __restrict__ sn, float* __restrict__ sm, float* __restrict__ smt,
    float* __restrict__ sqn, unsigned long long* __restrict__ prof) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // Cs[e][i] = C[r0 + i][e]
  float* T0 = Cs + (size_t)Dh * kLd;  // q^T tile, then P^T, then k tile
  float* T1 = T0 + kT * kLd;        // k^T tile
  float* Vs = T1 + kT * kLd;        // v[:, r0:r0+64], later scaled by w
  float* nv = Vs + kC * kLd;        // n, the whole DH (every CTA keeps it)
  float* bc = nv + Dh;              // lf, then its inclusive cumsum
  float* igs = bc + kC;             // input gate
  float* mt = igs + kC;             // stabilizer m_t
  float* inter = mt + kC;           // exp(m_in + b_t - m_t)
  float* wk = inter + kC;           // exp(b_c - b_j + i_j - m_c)
  float* qnp = wk + kC;             // [4][kC] partial sums of q_t . n
  float* mst = qnp + 4 * kC;        // [0]: m carried between chunks

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kR;
  const int nr = min(kR, Dh - r0);
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* qb = q + bh * S * Dh;
  const T* kb = k + bh * S * Dh;
  const T* vb = v + bh * S * Dh;
  const float* igb = ig + bh * S;
  const float* lfb = lf + bh * S;

  for (int idx = tid; idx < kR * Dh; idx += kThreads) {
    const int i = idx / Dh, e = idx - i * Dh;
    Cs[e * kLd + i] =
        (C0 != nullptr && i < nr) ? C0[(bh * Dh + r0 + i) * Dh + e] : 0.f;
  }
  for (int e = tid; e < Dh; e += kThreads)
    nv[e] = n0 != nullptr ? n0[bh * Dh + e] : 0.f;
  if (tid == 0) mst[0] = m0 != nullptr ? m0[bh] : kMInit;

  const bool timed = prof != nullptr && tid == 0;
  long long clk[kProfPhases] = {}, tick = timed ? clock64() : 0;
  const long long start = tick;
  auto lap = [&](int phase) {
    if (timed) {
      const long long now = clock64();
      clk[phase] += now - tick;
      tick = now;
    }
  };
  float rq[kPer], rk[kPer];
  for (int t0 = 0; t0 < S; t0 += kC) {
    const int cl = min(kC, S - t0);
    load_tile(rq, qb, t0, cl, 0, min(kT, Dh), Dh, true);
    load_tile(rk, kb, t0, cl, 0, min(kT, Dh), Dh, true);
    if (tid < kC) {
      igs[tid] = tid < cl ? igb[t0 + tid] : 0.f;
      bc[tid] = tid < cl ? lfb[t0 + tid] : 0.f;
    }
    __syncthreads();
    lap(0);
    const float m_in = mst[0];
    if (kSave) {              // the chunk's starting state, for the backward
      const int K = (S + kC - 1) / kC, ci = t0 / kC;
      float* Cst = sC + ((bh * K + ci) * Dh + r0) * Dh;
      for (int idx = tid; idx < nr * Dh; idx += kThreads) {
        const int i = idx / Dh, e = idx - i * Dh;
        Cst[(size_t)i * Dh + e] = Cs[e * kLd + i];
      }
      if (blockIdx.x == 0) {
        for (int e = tid; e < Dh; e += kThreads)
          sn[(bh * K + ci) * Dh + e] = nv[e];
        if (tid == 0) sm[bh * K + ci] = m_in;
      }
    }
    if (tid == 0) {       // the chunk's scans, in the reference's order
      float b = 0.f, M = -INFINITY;
      for (int t = 0; t < cl; ++t) {
        b += bc[t];
        bc[t] = b;
        M = fmaxf(M, igs[t] - b);
        mt[t] = b + fmaxf(m_in, M);
      }
    }
    __syncthreads();
    lap(1);
    const float m_out = mt[cl - 1], b_last = bc[cl - 1];
    const float carry = expf((m_in + b_last) - m_out);
    if (tid < kC) {
      const bool live = tid < cl;
      inter[tid] = live ? expf((m_in + bc[tid]) - mt[tid]) : 0.f;
      wk[tid] = live ? expf(((b_last - bc[tid]) + igs[tid]) - m_out) : 0.f;
    }

    // ---- q k^T, C q and q.n over 64-wide tiles of the key dimension; the
    // next tile's global loads are in flight while this one is multiplied
    float sacc[4][4] = {}, cacc[4][4] = {};
    float qn = 0.f;
    for (int e0 = 0; e0 < Dh; e0 += kT) {
      const int ne = min(kT, Dh - e0);
      store_tile(rq, T0, true);
      store_tile(rk, T1, true);
      __syncthreads();
      if (e0 + kT < Dh) {
        load_tile(rq, qb, t0, cl, e0 + kT, min(kT, Dh - e0 - kT), Dh, true);
        load_tile(rk, kb, t0, cl, e0 + kT, min(kT, Dh - e0 - kT), Dh, true);
      }
      const float* Cb = Cs + (size_t)e0 * kLd + 4 * tx;
#pragma unroll 4
      for (int kk = 0; kk < ne; ++kk) {
        const float4 a = ld4(T0 + kk * kLd + 4 * ty);
        fma4(sacc, a, ld4(T1 + kk * kLd + 4 * tx));
        fma4(cacc, a, ld4(Cb + kk * kLd));
      }
      {
        const int t = tid & 63, part = tid >> 6;
        for (int e = part * 16; e < min(part * 16 + 16, ne); ++e)
          qn = fmaf(T0[e * kLd + t], nv[e0 + e], qn);
      }
      __syncthreads();
    }
    lap(2);
    qnp[(tid >> 6) * kC + (tid & 63)] = qn;
    load_tile(rk, kb, t0, cl, 0, min(kT, Dh), Dh, false);   // for the update

    // ---- P = S o D (j <= t), its row sums; P^T and v's slice to smem
    float rs[4];
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
      rs[a] = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tx + b;
        p[a][b] = 0.f;
        if (j <= t && t < cl)
          p[a][b] = sacc[a][b] * expf(((bc[t] - bc[j]) + igs[j]) - mt[t]);
        rs[a] += p[a][b];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs[a] += __shfl_xor_sync(0xffffffffu, rs[a], off);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(T0 + (4 * tx + b) * kLd + 4 * ty) =
          make_float4(p[0][b], p[1][b], p[2][b], p[3][b]);
    for (int idx = tid; idx < kC * kR; idx += kThreads) {
      const int j = idx >> 6, i = idx & 63;
      Vs[j * kLd + i] =
          (j < cl && i < nr) ? to_f(vb[(size_t)(t0 + j) * Dh + r0 + i]) : 0.f;
    }
    __syncthreads();
    lap(3);

    // ---- h = (P v + inter * C q) / den for the CTA's rows
    float oacc[4][4] = {};
    outer(oacc, T0, Vs, cl, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
      if (t >= cl) continue;
      const float qnt = qnp[t] + qnp[kC + t] + qnp[2 * kC + t] +
                        qnp[3 * kC + t];
      const float qnv = rs[a] + inter[t] * qnt;
      const float den = fmaxf(fabsf(qnv), expf(-mt[t]));
      if (kSave && blockIdx.x == 0 && tx == 0) {
        smt[bh * S + t0 + t] = mt[t];
        sqn[bh * S + t0 + t] = qnv;
      }
      T* hrow = h + (bh * S + t0 + t) * Dh + r0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * tx + b;
        if (i < nr)
          hrow[i] = from_f<T>((oacc[a][b] + inter[t] * cacc[a][b]) / den);
      }
    }
    __syncthreads();
    lap(4);

    // ---- C = carry C + (w o v)^T k, n = carry n + w k
    for (int idx = tid; idx < kC * kR; idx += kThreads) {
      const int j = idx >> 6;
      Vs[j * kLd + (idx & 63)] *= wk[j];
    }
    for (int e0 = 0; e0 < Dh; e0 += kT) {
      const int ne = min(kT, Dh - e0);
      store_tile(rk, T0, false);
      __syncthreads();
      if (e0 + kT < Dh)
        load_tile(rk, kb, t0, cl, e0 + kT, min(kT, Dh - e0 - kT), Dh, false);
      float uacc[4][4] = {};
      outer(uacc, T0, Vs, cl, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = 4 * ty + a;
        if (e >= ne) continue;
        float4* crow = reinterpret_cast<float4*>(
            Cs + (size_t)(e0 + e) * kLd + 4 * tx);
        float4 c = *crow;
        c.x = carry * c.x + uacc[a][0];
        c.y = carry * c.y + uacc[a][1];
        c.z = carry * c.z + uacc[a][2];
        c.w = carry * c.w + uacc[a][3];
        *crow = c;
      }
      if (tid < ne) {
        float s = 0.f;
        for (int j = 0; j < cl; ++j) s = fmaf(wk[j], T0[j * kLd + tid], s);
        nv[e0 + tid] = carry * nv[e0 + tid] + s;
      }
      __syncthreads();
    }
    lap(5);
    if (tid == 0) mst[0] = m_out;
  }
  __syncthreads();
  if (timed) {
    clk[6] = clock64() - start;
    for (int p = 0; p < kProfPhases; ++p)
      atomicAdd(&prof[p], (unsigned long long)clk[p]);
  }

  for (int idx = tid; idx < nr * Dh; idx += kThreads) {
    const int i = idx / Dh, e = idx - i * Dh;
    Cout[(bh * Dh + r0 + i) * Dh + e] = Cs[e * kLd + i];
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < Dh; e += kThreads) nout[bh * Dh + e] = nv[e];
    if (tid == 0) mout[bh] = mst[0];
  }
}

template <typename T, bool kSave>
int launch_as(const void* q, const void* k, const void* v, const float* ig,
              const float* lf, const float* C0, const float* n0,
              const float* m0, void* h, float* C, float* n, float* m, int B,
              int NH, int S, int Dh, float* const* saved,
              unsigned long long* prof, cudaStream_t st) {
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunked_kernel<T, kSave>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Dh + kR - 1) / kR, NH, B);
  mlstm_chunked_kernel<T, kSave><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ig, lf, C0, n0, m0, (T*)h, C, n,
      m, S, Dh, saved[0], saved[1], saved[2], saved[3], saved[4], prof);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* lf, const float* C0, const float* n0,
           const float* m0, void* h, float* C, float* n, float* m, int B,
           int NH, int S, int Dh, float* const* saved,
           unsigned long long* prof, cudaStream_t st) {
  if (saved[0] != nullptr)
    return launch_as<T, true>(q, k, v, ig, lf, C0, n0, m0, h, C, n, m, B, NH,
                              S, Dh, saved, prof, st);
  return launch_as<T, false>(q, k, v, ig, lf, C0, n0, m0, h, C, n, m, B, NH,
                             S, Dh, saved, prof, st);
}

}  // namespace mlstm

// q, k, v: [B, NH, S, Dh] float32 or bf16 (dtype code), contiguous; ig,
// lf: [B, NH, S] float32; C0 [B, NH, Dh, Dh], n0 [B, NH, Dh], m0 [B, NH]
// float32, all three null or none; h: [B, NH, S, Dh] in q's dtype; C, n, m
// as C0, n0, m0. 1 <= Dh <= 512, S >= 1. sC [B, NH, K, Dh, Dh], sn
// [B, NH, K, Dh], sm [B, NH, K] (K = ceil(S / 64)), smt, sqn [B, NH, S]
// float32: the states the backward takes, all null (serving) or none.
// prof: null, or kProfPhases uint64 counters the phase clocks are added
// to. Returns cudaGetLastError().
extern "C" int mlstm_chunked(int dtype, const void* q, const void* k,
                             const void* v, const void* ig, const void* lf,
                             const void* C0, const void* n0, const void* m0,
                             void* h, void* C, void* n, void* m, int B,
                             int NH, int S, int Dh, void* sC, void* sn,
                             void* sm, void* smt, void* sqn, void* prof,
                             void* stream) {
  using namespace mlstm;
  if (Dh < 1 || Dh > 512 || S < 1 || B < 1 || NH < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *g = (const float*)ig, *f = (const float*)lf;
  const float *c0 = (const float*)C0, *nn0 = (const float*)n0,
              *mm0 = (const float*)m0;
  float *c = (float*)C, *nn = (float*)n, *mm = (float*)m;
  unsigned long long* pr = (unsigned long long*)prof;
  float* const saved[5] = {(float*)sC, (float*)sn, (float*)sm, (float*)smt,
                           (float*)sqn};
  if ((sC == nullptr) != (sn == nullptr) || (sC == nullptr) != (sm == nullptr)
      || (sC == nullptr) != (smt == nullptr)
      || (sC == nullptr) != (sqn == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float>(q, k, v, g, f, c0, nn0, mm0, h, c, nn, mm, B, NH, S,
                         Dh, saved, pr, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, g, f, c0, nn0, mm0, h, c, nn, mm, B,
                                 NH, S, Dh, saved, pr, st);
  return (int)cudaErrorInvalidValue;
}
