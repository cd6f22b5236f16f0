// Chunkwise stabilized mLSTM backward for Hopper (sm_90a), on the CUDA
// cores.
//
// Replaces no Pallas kernel: the reference has no backward kernel for the
// mLSTM (XLA differentiates its chunk body, repro/models/recurrent.py ::
// mlstm_chunk_body, under jax.checkpoint). It exists because the port's
// training path runs the hand-written forward (mlstm_chunked_tc.cu /
// mlstm_chunked.cu) on the card, and the gradient of that call needs a
// kernel of its own behind a torch.autograd.Function (ops._MlstmChunkedAD)
// rather than the plain version. It computes ref.mlstm_chunkwise_bwd_ref:
// for q, k, v, h, dh [B, NH, S, DH] (float32 or bf16) and gates ig, lf
// [B, NH, S] float32, with the forward's saved states (each 64-step
// chunk's starting C [DH, DH], n [DH], m, and every step's m_t and signed
// qn_t = n_t.q_t), it returns dq, dk, dv [B, NH, S, DH] and dig, dlf
// [B, NH, S], float32. No gradient reaches the initial or final state.
//
// The stabilizer m is held constant: every stabilized quantity is its
// unstabilized value times e^{-m}, so h does not depend on the m's and
// the gradient with them fixed is the true one. Within a chunk of c steps
// (b_t the inclusive cumsum of lf, the chunk's starting C, n, m_in; D_tj =
// e^{b_t - b_j + i_j - m_t} for j <= t, inter_t = e^{m_in + b_t - m_t},
// w_j = e^{b_c - b_j + i_j - m_c}, carry = e^{m_in + b_c - m_c}, den_t =
// max(|qn_t|, e^{-m_t}), P = (q k^T) o D):
//   dnum_t = dh_t / den_t
//   dqn_t  = -(dh_t . h_t) / den_t * [|qn| > e^{-m}: 1, ==: 1/2, <: 0]
//            * (qn >= 0 ? 1 : -1)          (JAX's max and abs slopes)
//   dP = dnum v^T + dqn (j <= t), dS = dP o D, dlogD = dP o P
//   dv = P^T dnum + w o (k dC'^T)          dk = dS^T q + w o (v dC' + dn')
//   dq = dS k + inter o (dnum C + dqn n)
//   dC = carry dC' + (inter o dnum)^T q    dn = carry dn' + (inter o dqn)^T q
// with dC', dn' the cotangent of the chunk's final state (0 after the
// last chunk), and the gates' gradients from the logs of D, inter, w and
// carry; dlf is the reverse cumsum of db within the chunk. exp() of a
// masked (j > t) entry is never taken.
//
// What bounds it on an H100: operations, on the CUDA cores (float32). At
// the training path's shape (B 4, NH 4, S 512, DH 512, chunks of 64) a
// (b, h) needs 8 S DH^2 flops for its four products with a DH x DH matrix
// (dC's recursion, dnum C, v dC', k dC'^T) and 10 DH flops a causal pair
// for the chunk's five [c, c] products (q k^T, dnum v^T, P^T dnum, dS k,
// dS^T q): 18.6 GFLOP, 0.28 ms at 67 TFLOP/s, against 269 MB of inputs
// and outputs (0.08 ms at 3.35 TB/s).
//
// The design, a simple first kernel in two launches, deterministic (no
// atomics; every sum in a fixed order, so two launches agree bitwise):
//   (a) mlstm_bwd_sweep_kernel, grid (DH / 64, NH, B): the reverse sweep.
//       A CTA owns 64 rows of dC (the v dimension) for one (b, h), kept in
//       shared memory (132 KB at DH 512; C itself, 1 MiB a (b, h), is far
//       over an SM's 227 KB), and the same 64-wide slice of dn. It walks
//       the chunks from the last, writes the carried dC', dn' of each
//       chunk to device memory, then adds the chunk's term: that product
//       sums over time only, so no CTA needs another's rows.
//   (b) mlstm_bwd_chunk_kernel, grid (chunks, NH, B): one CTA a chunk of
//       one (b, h), all chunks in parallel. The products that sum over the
//       rows of C (dnum C, v dC') and over its columns (k dC'^T) all run
//       inside the one CTA, over 64 x 64 tiles of C and dC' streamed from
//       device memory, so none needs a cross-CTA sum. Every product is a
//       64 x 64 output tile on 256 threads, 4 x 4 outputs a thread, both
//       operands k-major in shared memory (the forward SIMT kernel's
//       scheme). dC' is read twice (rows for k dC'^T, tiles for v dC'):
//       that costs traffic, not flops.
//   * With one CTA an SM (8 warps) little latency is hidden, so every
//     tile loop fetches its next tiles into registers (all loads issued
//     before any is used) while it multiplies the current ones.
// 128 CTAs of (b) at the training shape fill one wave of the 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlstm_bwd {

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kC = 64;                // time steps per chunk (the forward's)
constexpr int kT = 64;                // tile width
constexpr int kLd = 68;               // row stride of a 64-wide smem tile
constexpr int kThreads = 256;         // 16 x 16, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kC * kT / kThreads;   // tile elements per thread
constexpr int kTile = kT * kLd;            // floats of one smem tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// Element it of a thread's share of a 64 x 64 tile: row t and column e of
// the source. Transposed (dst[e][t]) a warp takes 4 rows x 8 columns a
// step, so its global reads are 32-byte row pieces and its stores hit 32
// distinct banks; natural (dst[t][e]), 32 consecutive columns of one row.
__device__ __forceinline__ void tile_pos(int it, bool transposed, int& t,
                                         int& e) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (transposed) {
    const int blk = it * kWarps + warp;         // 8 e-blocks x 16 t-blocks
    e = (blk & 7) * 8 + (lane & 7);
    t = (blk >> 3) * 4 + (lane >> 3);
  } else {
    const int idx = it * kThreads + tid;
    t = idx >> 6;
    e = idx & 63;
  }
}

// A thread's share of the tile of rows [t0, t0 + nt) and columns
// [e0, e0 + ne) of a row-major matrix with row stride ld, zero-padded,
// into registers: every load is issued before any is used, so one tile's
// (or several tiles') latency is paid once, and a loop can fetch its next
// tiles while it multiplies the current ones.
template <typename T>
__device__ __forceinline__ void fetch(float (&r)[kPer],
                                      const T* __restrict__ src, int t0,
                                      int nt, int e0, int ne, int ld,
                                      bool transposed) {
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    int t, e;
    tile_pos(it, transposed, t, e);
    r[it] = (t < nt && e < ne) ? to_f(src[(size_t)(t0 + t) * ld + e0 + e])
                               : 0.f;
  }
}

// The fetched share into shared memory, natural or transposed (as it was
// fetched); a row t's values divided by div[t], then multiplied by
// mul[t], where those are given (zero padding stays zero).
__device__ __forceinline__ void put(const float (&r)[kPer],
                                    float* __restrict__ dst, bool transposed,
                                    const float* div = nullptr,
                                    const float* mul = nullptr) {
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    int t, e;
    tile_pos(it, transposed, t, e);
    float x = r[it];
    if (div != nullptr && x != 0.f) x = x / div[t];
    if (mul != nullptr) x = mul[t] * x;
    if (transposed)
      dst[e * kLd + t] = x;
    else
      dst[t * kLd + e] = x;
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int t0,
                                          int nt, int e0, int ne, int ld,
                                          bool transposed,
                                          const float* div = nullptr,
                                          const float* mul = nullptr) {
  float r[kPer];
  fetch<T>(r, src, t0, nt, e0, ne, ld, transposed);
  put(r, dst, transposed, div, mul);
}

// Per-step values of one chunk, in shared memory (kC floats each).
struct Gates {
  float bc[kC];     // lf, then its inclusive cumsum b_t
  float igs[kC];    // input gate
  float mts[kC];    // the forward's m_t
  float qns[kC];    // the forward's signed n_t.q_t
  float inter[kC];  // e^{m_in + b_t - m_t}
  float wk[kC];     // e^{b_c - b_j + i_j - m_c}
  float den[kC];    // max(|qn_t|, e^{-m_t}); 1 past the chunk's end
  float dqn[kC];    // the cotangent of qn_t
  float scal[4];    // [0] carry
};

// The chunk's gates and dqn, from the saved m_t and qn_t (every thread
// calls it; it ends with the values visible to all). h.dh of each row is
// a warp's sum over DH in a fixed order.
template <typename T>
__device__ void chunk_gates(Gates& g, const float* __restrict__ igb,
                            const float* __restrict__ lfb,
                            const float* __restrict__ mtb,
                            const float* __restrict__ qnb,
                            const T* __restrict__ hb,
                            const T* __restrict__ dhb, float m_in, int t0,
                            int cl, int Dh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < kC) {
    const bool live = tid < cl;
    g.igs[tid] = live ? igb[t0 + tid] : 0.f;
    g.bc[tid] = live ? lfb[t0 + tid] : 0.f;
    g.mts[tid] = live ? mtb[t0 + tid] : 0.f;
    g.qns[tid] = live ? qnb[t0 + tid] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float b = 0.f;
    for (int t = 0; t < cl; ++t) {
      b += g.bc[t];
      g.bc[t] = b;
    }
  }
  __syncthreads();
  const float m_out = g.mts[cl - 1], b_last = g.bc[cl - 1];
  if (tid < kC) {
    const bool live = tid < cl;
    g.inter[tid] = live ? expf((m_in + g.bc[tid]) - g.mts[tid]) : 0.f;
    g.wk[tid] = live ? expf(((b_last - g.bc[tid]) + g.igs[tid]) - m_out)
                     : 0.f;
    g.den[tid] = live ? fmaxf(fabsf(g.qns[tid]), expf(-g.mts[tid])) : 1.f;
  }
  if (tid == 0) g.scal[0] = expf((m_in + b_last) - m_out);
  __syncthreads();
  for (int t = warp; t < kC; t += kWarps) {
    float s = 0.f;
    if (t < cl) {
      const T* hr = hb + (size_t)(t0 + t) * Dh;
      const T* dr = dhb + (size_t)(t0 + t) * Dh;
      for (int e = lane; e < Dh; e += 32) s = fmaf(to_f(dr[e]), to_f(hr[e]), s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      float d = 0.f;
      if (t < cl) {
        const float qn = g.qns[t], fl = expf(-g.mts[t]), a = fabsf(qn);
        const float share = a > fl ? 1.f : (a == fl ? 0.5f : 0.f);
        d = -s / g.den[t] * share * (qn >= 0.f ? 1.f : -1.f);
      }
      g.dqn[t] = d;
    }
  }
  __syncthreads();
}

// ------------------------------------------------ (a) the reverse sweep
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_sweep_kernel(
    const T* __restrict__ q, const T* __restrict__ h,
    const T* __restrict__ dh, const float* __restrict__ ig,
    const float* __restrict__ lf, const float* __restrict__ ms,
    const float* __restrict__ mt, const float* __restrict__ qn,
    float* __restrict__ dCs, float* __restrict__ dns, int S, int Dh,
    int ldc) {
  extern __shared__ float4 smem4[];
  float* dC = reinterpret_cast<float*>(smem4);  // dC[i][e], row stride ldc
  float* A = dC + (size_t)kT * ldc;   // (inter o dnum)[t][i]
  float* Bq = A + kTile;              // q[t][e]
  float* dn = Bq + kTile;             // dn over the CTA's e slice
  Gates& g = *reinterpret_cast<Gates*>(dn + kT);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kT, nr = min(kT, Dh - r0);
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int K = (S + kC - 1) / kC;
  const T* qb = q + bh * S * Dh;
  const T* hb = h + bh * S * Dh;
  const T* dhb = dh + bh * S * Dh;

  for (int idx = tid; idx < kT * ldc; idx += kThreads) dC[idx] = 0.f;
  if (tid < kT) dn[tid] = 0.f;
  __syncthreads();

  for (int kk = K - 1; kk >= 0; --kk) {
    const int t0 = kk * kC, cl = min(kC, S - t0);
    // the cotangent of chunk kk's final state, as the chunk kernel reads it
    float* dCk = dCs + ((bh * K + kk) * Dh + r0) * Dh;
    for (int idx = tid; idx < nr * Dh; idx += kThreads) {
      const int i = idx / Dh, e = idx - i * Dh;
      dCk[(size_t)i * Dh + e] = dC[i * ldc + e];
    }
    if (tid < nr) dns[(bh * K + kk) * Dh + r0 + tid] = dn[tid];
    chunk_gates<T>(g, ig + bh * S, lf + bh * S, mt + bh * S, qn + bh * S, hb,
                   dhb, ms[bh * K + kk], t0, cl, Dh);
    const float carry = g.scal[0];
    float rq[kPer];
    fetch<T>(rq, qb, t0, cl, 0, min(kT, Dh), Dh, false);
    load_tile<T>(A, dhb, t0, cl, r0, nr, Dh, false, g.den, g.inter);
    // dC = carry dC + (inter o dnum)^T q, 64 columns of e at a time, the
    // next q tile in flight while this one is multiplied
    for (int e0 = 0; e0 < Dh; e0 += kT) {
      put(rq, Bq, false);
      __syncthreads();
      if (e0 + kT < Dh)
        fetch<T>(rq, qb, t0, cl, e0 + kT, min(kT, Dh - e0 - kT), Dh, false);
      float acc[4][4];
      zero(acc);
      outer(acc, A, Bq, cl, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* row = reinterpret_cast<float4*>(
            dC + (size_t)(4 * ty + a) * ldc + e0 + 4 * tx);
        float4 c = *row;
        c.x = carry * c.x + acc[a][0];
        c.y = carry * c.y + acc[a][1];
        c.z = carry * c.z + acc[a][2];
        c.w = carry * c.w + acc[a][3];
        *row = c;
      }
      __syncthreads();
    }
    // dn = carry dn + (inter o dqn)^T q over the CTA's e slice
    if (tid < nr) {
      float s = 0.f;
      for (int t = 0; t < cl; ++t)
        s = fmaf(g.inter[t] * g.dqn[t],
                 to_f(qb[(size_t)(t0 + t) * Dh + r0 + tid]), s);
      dn[tid] = carry * dn[tid] + s;
    }
    __syncthreads();
  }
}

// ------------------------------------------ (b) the chunks in parallel
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ lf, const T* __restrict__ h,
    const T* __restrict__ dh, const float* __restrict__ Cs,
    const float* __restrict__ ns, const float* __restrict__ ms,
    const float* __restrict__ mt, const float* __restrict__ qn,
    const float* __restrict__ dCs, const float* __restrict__ dns,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dig, float* __restrict__ dlf, int S, int Dh,
    int dpad) {
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);   // four operand tiles
  float* X1 = X0 + kTile;
  float* X2 = X1 + kTile;
  float* X3 = X2 + kTile;
  float* Ps = X3 + kTile;       // P[t][j]
  float* dSs = Ps + kTile;      // dS[t][j]
  float* dSTs = dSs + kTile;    // dS^T[j][t]
  float* Ls = dSTs + kTile;     // dlogD[t][j]
  float* nv = Ls + kTile;       // the chunk's starting n
  float* dnv = nv + dpad;       // dn' (the chunk's final state's cotangent)
  float* red = dnv + dpad;      // [4][kC] x 2 partials, then kThreads
  float* rows = red + 2 * 4 * kC;   // [kC] each: row sums of dlogD, its
  float* cols = rows + kC;          // column sums, n.q_t, k_j.dn',
  float* nq = cols + kC;            // sum_e q X, sum_i v Z
  float* kd = nq + kC;
  float* dint = kd + kC;
  float* dwa = dint + kC;
  float* gw = dwa + kC;
  float* db = gw + kC;
  Gates& g = *reinterpret_cast<Gates*>(db + kC);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kk = blockIdx.x;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int K = gridDim.x;
  const int t0 = kk * kC, cl = min(kC, S - t0);
  const size_t off = bh * S * Dh;
  const T *qb = q + off, *kb = k + off, *vb = v + off, *hb = h + off,
          *dhb = dh + off;
  const float* Cb = Cs + (bh * K + kk) * Dh * Dh;
  const float* dCb = dCs + (bh * K + kk) * Dh * Dh;

  for (int e = tid; e < Dh; e += kThreads) {
    nv[e] = ns[(bh * K + kk) * Dh + e];
    dnv[e] = dns[(bh * K + kk) * Dh + e];
  }
  chunk_gates<T>(g, ig + bh * S, lf + bh * S, mt + bh * S, qn + bh * S, hb,
                 dhb, ms[bh * K + kk], t0, cl, Dh);
  const float carry = g.scal[0];

  // ---- S = q k^T, n.q_t and k_j.dn' over 64-wide tiles of e, and
  // U = dnum v^T over the same tiles of i; the next four tiles in flight
  // while these are multiplied
  float sacc[4][4], uacc[4][4];
  zero(sacc);
  zero(uacc);
  {
    float qnp = 0.f, kdp = 0.f;
    const int t = tid & 63, part = tid >> 6;
    float ra[kPer], rb[kPer], rc[kPer], rd[kPer];
    auto fetch4 = [&](int x0) {
      const int nx = min(kT, Dh - x0);
      fetch<T>(ra, qb, t0, cl, x0, nx, Dh, true);
      fetch<T>(rb, kb, t0, cl, x0, nx, Dh, true);
      fetch<T>(rc, dhb, t0, cl, x0, nx, Dh, true);
      fetch<T>(rd, vb, t0, cl, x0, nx, Dh, true);
    };
    fetch4(0);
    for (int x0 = 0; x0 < Dh; x0 += kT) {
      const int nx = min(kT, Dh - x0);
      put(ra, X0, true);
      put(rb, X1, true);
      put(rc, X2, true, g.den);
      put(rd, X3, true);
      __syncthreads();
      if (x0 + kT < Dh) fetch4(x0 + kT);
      outer(sacc, X0, X1, nx, ty, tx);
      outer(uacc, X2, X3, nx, ty, tx);
      for (int e = part * 16; e < min(part * 16 + 16, nx); ++e) {
        qnp = fmaf(X0[e * kLd + t], nv[x0 + e], qnp);
        kdp = fmaf(X1[e * kLd + t], dnv[x0 + e], kdp);
      }
      __syncthreads();
    }
    red[part * kC + t] = qnp;
    red[4 * kC + part * kC + t] = kdp;
  }
  if (tid < kC) {
    nq[tid] = red[tid] + red[kC + tid] + red[2 * kC + tid] +
              red[3 * kC + tid];
    kd[tid] = red[4 * kC + tid] + red[5 * kC + tid] + red[6 * kC + tid] +
              red[7 * kC + tid];
  }

  // ---- P = S o D, dP = U + dqn, dS = dP o D, dlogD = dP o P (j <= t)
  {
    float p[4][4], ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tx + b;
        float pv = 0.f, dsv = 0.f, lv = 0.f;
        if (j <= t && t < cl) {
          const float D = expf(((g.bc[t] - g.bc[j]) + g.igs[j]) - g.mts[t]);
          const float dP = uacc[a][b] + g.dqn[t];
          pv = sacc[a][b] * D;
          dsv = dP * D;
          lv = dP * pv;
        }
        p[a][b] = pv;
        ds[a][b] = dsv;
        Ls[t * kLd + j] = lv;
      }
      *reinterpret_cast<float4*>(Ps + t * kLd + 4 * tx) =
          make_float4(p[a][0], p[a][1], p[a][2], p[a][3]);
      *reinterpret_cast<float4*>(dSs + t * kLd + 4 * tx) =
          make_float4(ds[a][0], ds[a][1], ds[a][2], ds[a][3]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float4*>(dSTs + (4 * tx + b) * kLd + 4 * ty) =
          make_float4(ds[0][b], ds[1][b], ds[2][b], ds[3][b]);
  }
  __syncthreads();
  if (tid < kC) {
    float s = 0.f;
    for (int j = 0; j < kC; ++j) s += Ls[tid * kLd + j];
    rows[tid] = s;
  } else if (tid < 2 * kC) {
    const int j = tid - kC;
    float s = 0.f;
    for (int t = 0; t < kC; ++t) s += Ls[t * kLd + j];
    cols[j] = s;
  }

  // ---- dv = P^T dnum + w o (k dC'^T), 64 rows of i at a time; and
  // sum_i v_j[i] (k dC'^T)[j][i] for dw
  float dwp[4] = {0.f, 0.f, 0.f, 0.f};
  const int nt = (Dh + kT - 1) / kT;     // 64-wide tiles of DH
  float rk[kPer], rz[kPer];
  auto fetch2 = [&](int it) {            // (i, e) tile pair it
    const int i0 = it / nt * kT, e0 = it % nt * kT;
    const int ni = min(kT, Dh - i0), ne = min(kT, Dh - e0);
    fetch<T>(rk, kb, t0, cl, e0, ne, Dh, true);
    fetch<float>(rz, dCb, i0, ni, e0, ne, Dh, true);
  };
  fetch2(0);
  for (int i0 = 0; i0 < Dh; i0 += kT) {
    const int ni = min(kT, Dh - i0);
    load_tile<T>(X0, dhb, t0, cl, i0, ni, Dh, false, g.den);
    __syncthreads();
    float dva[4][4], za[4][4];
    zero(dva);
    zero(za);
    outer(dva, Ps, X0, cl, ty, tx);
    for (int e0 = 0; e0 < Dh; e0 += kT) {
      const int ne = min(kT, Dh - e0);
      const int it = i0 / kT * nt + e0 / kT;
      put(rk, X1, true);
      put(rz, X2, true);
      __syncthreads();
      if (it + 1 < nt * nt) fetch2(it + 1);
      outer(za, X1, X2, ne, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 4 * ty + a;
      if (j >= cl) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * tx + b;
        if (i >= ni) continue;
        const size_t at = (size_t)(t0 + j) * Dh + i0 + i;
        dv[off + at] = dva[a][b] + g.wk[j] * za[a][b];
        dwp[a] = fmaf(to_f(vb[at]), za[a][b], dwp[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      dwp[a] += __shfl_xor_sync(0xffffffffu, dwp[a], o);
    if (tx == 0) dwa[4 * ty + a] = dwp[a];
  }

  // ---- dq = dS k + inter o (dnum C + dqn n), dk = dS^T q + w o (v dC' +
  // dn'), 64 columns of e at a time; <C, dC'> and sum_e q_t[e] (dnum C)
  float dcp = 0.f, dip[4] = {0.f, 0.f, 0.f, 0.f};
  float ra[kPer], rb[kPer], rc[kPer], rd[kPer];
  auto fetch4 = [&](int it) {            // (e, i) tile pair it
    const int e0 = it / nt * kT, i0 = it % nt * kT;
    const int ne = min(kT, Dh - e0), ni = min(kT, Dh - i0);
    fetch<T>(ra, dhb, t0, cl, i0, ni, Dh, true);
    fetch<float>(rb, Cb, i0, ni, e0, ne, Dh, false);
    fetch<T>(rc, vb, t0, cl, i0, ni, Dh, true);
    fetch<float>(rd, dCb, i0, ni, e0, ne, Dh, false);
  };
  fetch4(0);
  for (int e0 = 0; e0 < Dh; e0 += kT) {
    const int ne = min(kT, Dh - e0);
    float xa[4][4], ya[4][4];
    zero(xa);
    zero(ya);
    for (int i0 = 0; i0 < Dh; i0 += kT) {
      const int ni = min(kT, Dh - i0);
      const int it = e0 / kT * nt + i0 / kT;
      put(ra, X0, true, g.den);
      put(rb, X1, false);
      put(rc, X2, true);
      put(rd, X3, false);
      __syncthreads();
      if (it + 1 < nt * nt) fetch4(it + 1);
      outer(xa, X0, X1, ni, ty, tx);
      outer(ya, X2, X3, ni, ty, tx);
#pragma unroll 4
      for (int u = 0; u < kPer; ++u) {
        const int idx = u * kThreads + tid;
        const int at = (idx >> 6) * kLd + (idx & 63);
        dcp = fmaf(X1[at], X3[at], dcp);
      }
      __syncthreads();
    }
    load_tile<T>(X0, kb, t0, cl, e0, ne, Dh, false);
    load_tile<T>(X1, qb, t0, cl, e0, ne, Dh, false);
    __syncthreads();
    float ska[4][4], sqa[4][4];
    zero(ska);
    zero(sqa);
    outer(ska, dSTs, X0, cl, ty, tx);
    outer(sqa, dSs, X1, cl, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = 4 * ty + a;
      if (r >= cl) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * tx + b;
        if (e >= ne) continue;
        const size_t at = (size_t)(t0 + r) * Dh + e0 + e;
        dq[off + at] =
            ska[a][b] + g.inter[r] * (xa[a][b] + g.dqn[r] * nv[e0 + e]);
        dk[off + at] = sqa[a][b] + g.wk[r] * (ya[a][b] + dnv[e0 + e]);
        dip[a] = fmaf(X1[r * kLd + e], xa[a][b], dip[a]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      dip[a] += __shfl_xor_sync(0xffffffffu, dip[a], o);
    if (tx == 0) dint[4 * ty + a] = dip[a];
  }
  red[tid] = dcp;
  __syncthreads();

  // ---- the gates: dcarry, db, dig, then dlf as db's reverse cumsum
  if (tid < kC) {
    float gwt = 0.f, dbt = 0.f, digt = 0.f;
    if (tid < cl) {
      const float di = dint[tid] + g.dqn[tid] * nq[tid];
      const float dw = dwa[tid] + kd[tid];
      gwt = dw * g.wk[tid];
      dbt = rows[tid] - cols[tid] + di * g.inter[tid] - gwt;
      digt = cols[tid] + gwt;
      dig[bh * S + t0 + tid] = digt;
    }
    gw[tid] = gwt;
    db[tid] = dbt;
  }
  __syncthreads();
  if (tid == 0) {
    float dc = 0.f;
    for (int i = 0; i < kThreads; ++i) dc += red[i];
    for (int e = 0; e < Dh; ++e) dc = fmaf(dnv[e], nv[e], dc);
    float sg = 0.f;
    for (int t = 0; t < cl; ++t) sg += gw[t];
    db[cl - 1] += sg + dc * carry;
    float acc = 0.f;
    for (int t = cl - 1; t >= 0; --t) {
      acc += db[t];
      dlf[bh * S + t0 + t] = acc;
    }
  }
}

size_t sweep_smem(int ldc) {
  return ((size_t)kT * ldc + 2 * kTile + kT) * sizeof(float) +
         sizeof(Gates);
}

size_t chunk_smem(int dpad) {
  return ((size_t)8 * kTile + 2 * dpad + 2 * 4 * kC + 9 * kC) *
             sizeof(float) + sizeof(Gates);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* lf, const void* h, const void* dh, const float* Cs,
           const float* ns, const float* ms, const float* mt,
           const float* qn, float* dq, float* dk, float* dv, float* dig,
           float* dlf, float* dCs, float* dns, int B, int NH, int S, int Dh,
           cudaStream_t st) {
  const int dpad = (Dh + kT - 1) / kT * kT;
  const int ldc = dpad + 4;
  const int K = (S + kC - 1) / kC;
  const size_t sa = sweep_smem(ldc), sb = chunk_smem(dpad);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_sweep_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mlstm_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sb);
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_sweep_kernel<T><<<dim3(dpad / kT, NH, B), kThreads, sa, st>>>(
      (const T*)q, (const T*)h, (const T*)dh, ig, lf, ms, mt, qn, dCs, dns, S,
      Dh, ldc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_chunk_kernel<T><<<dim3(K, NH, B), kThreads, sb, st>>>(
      (const T*)q, (const T*)k, (const T*)v, ig, lf, (const T*)h,
      (const T*)dh, Cs, ns, ms, mt, qn, dCs, dns, dq, dk, dv, dig, dlf, S,
      Dh, dpad);
  return (int)cudaGetLastError();
}

}  // namespace mlstm_bwd

// q, k, v, h, dh: [B, NH, S, Dh] float32 or bf16 (dtype code),
// contiguous; ig, lf, mt, qn: [B, NH, S] float32; Cs [B, NH, K, Dh, Dh],
// ns [B, NH, K, Dh], ms [B, NH, K] float32 with K = ceil(S / 64) (the
// forward kernels' state output); dq, dk, dv: [B, NH, S, Dh] float32;
// dig, dlf: [B, NH, S] float32; dCs, dns: scratch shaped as Cs and ns
// (the carried cotangents, written by the sweep). 1 <= Dh <= 512, S >= 1.
// Returns cudaGetLastError().
extern "C" int mlstm_chunked_bwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* ig,
                                 const void* lf, const void* h,
                                 const void* dh, const void* Cs,
                                 const void* ns, const void* ms,
                                 const void* mt, const void* qn, void* dq,
                                 void* dk, void* dv, void* dig, void* dlf,
                                 void* dCs, void* dns, int B, int NH, int S,
                                 int Dh, void* stream) {
  using namespace mlstm_bwd;
  if (Dh < 1 || Dh > 512 || S < 1 || B < 1 || NH < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *g = (const float*)ig, *f = (const float*)lf;
  const float *cs = (const float*)Cs, *nn = (const float*)ns,
              *mm = (const float*)ms, *tt = (const float*)mt,
              *qq = (const float*)qn;
  float *oq = (float*)dq, *ok = (float*)dk, *ov = (float*)dv,
        *oi = (float*)dig, *of = (float*)dlf, *sc = (float*)dCs,
        *sn = (float*)dns;
  if (dtype == kF32)
    return launch<float>(q, k, v, g, f, h, dh, cs, nn, mm, tt, qq, oq, ok,
                         ov, oi, of, sc, sn, B, NH, S, Dh, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, g, f, h, dh, cs, nn, mm, tt, qq,
                                 oq, ok, ov, oi, of, sc, sn, B, NH, S, Dh,
                                 st);
  return (int)cudaErrorInvalidValue;
}
