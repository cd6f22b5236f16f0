// Shared device code of the two SIMT paged-attention kernels
// (paged_decode.cu, paged_prefill.cu): one CTA attends up to kMaxRows
// query rows of one KV head through one lane's block table, with the
// online-softmax recurrence in float32. They are the "simt" route of
// kernels/ops.py :: paged_route: float32 q, and bf16 q at head dims or
// block sizes the TMA-fed kernels do not take. bf16 q over bf16 or int8
// pools at head dim 64 (the serving path) runs paged_decode_tma.cu and
// paged_prefill_tc.cu instead, whose shared design (whole blocks loaded
// by TMA through the block table, keys split over CTAs and merged in
// order, prefill's products on wgmma) is in paged_tma.cuh.
//
// What bounds it on an H100: the bytes of K/V read. A decode step reads
// every live K/V row of every lane once (2*ctx*D elements per lane and KV
// head) and does 4*g*D flops per row, far below the card's ~295 flop/byte
// ridge, so the kernel can at best run at memory speed; at serving sizes
// (a few MB per call) launch and latency dominate instead.
//
// What the design does about it:
//   * only keys below ctx are ever loaded: table slots past ceil(ctx/bs)
//     are never read, which also keeps a poisoned null block out of the
//     accumulator;
//   * the CTA's warps split the live keys into 32-key tiles and walk them
//     with no barrier: lane j of a warp owns key j of its tile, loads that
//     key's row with 16-byte loads and dots it with every query row of the
//     CTA (the g heads of a GQA group in decode, a tile of group-major
//     chunk rows in prefill), so each K row is read once per CTA and
//     shared by all its query rows;
//   * lane j also copies its key's V row into the warp's shared-memory
//     staging area, so K and V loads of a tile are in flight together;
//   * softmax statistics are warp shuffles; the value product walks the
//     staged V rows with each lane holding D/32 output columns,
//     broadcasting the probabilities by shuffle;
//   * int8 pools are dequantized in registers (a quarter of float32's
//     bytes); (m, l, acc) stay in registers and the warps' partial
//     results are merged once, through shared memory, at the end.
// A long context runs on one CTA per (KV head, lane) here; the TMA-fed
// kernels split it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr float kNegInf = -1e30f;   // mask value of the reference kernels
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;         // query rows per CTA
constexpr unsigned kFull = 0xffffffffu;

// dtype codes shared with kernels/ops.py
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

// One 16-byte load of a K row as floats: 4 float32, 8 bf16 or 16 int8.
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Dynamic shared memory of attend_rows<EPL, KT>: the query rows, each
// warp's staging of its tile's V rows (row stride padded by 16 bytes so
// lanes writing different rows hit different banks) and V scales — reused
// for the warps' partial accumulators at the end — and the warps' (m, l).
template <int EPL, typename KT>
struct Smem {
  static constexpr int D = 32 * EPL;
  static constexpr int kVStride = D * (int)sizeof(KT) + 16;   // bytes
  static constexpr size_t kQ = sizeof(float) * kMaxRows * D;
  static constexpr size_t kStage =
      (size_t)kWarps * 32 * (kVStride + sizeof(float));
  static constexpr size_t kAcc = sizeof(float) * kWarps * kMaxRows * D;
  static constexpr size_t kUnion = kStage > kAcc ? kStage : kAcc;
  static constexpr size_t kStats = sizeof(float) * 2 * kWarps * kMaxRows;
  static constexpr size_t kBytes = kQ + kUnion + kStats;
};

// Raise the dynamic shared-memory cap of `kernel` when `bytes` needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Attend R <= kMaxRows query rows (q, out: R contiguous rows of D = 32*EPL
// elements) of KV head h through `table`, over keys kp < nkeys (nkeys <=
// ctx). Every row sees kp < ctx; with `causal`, row r also needs
// kp <= q_offset + (r0 + r) % C. Launched with kThreads threads and
// Smem<EPL, KT>::kBytes of dynamic shared memory.
template <int EPL, typename QT, typename KT>
__device__ void attend_rows(const QT* __restrict__ q, QT* __restrict__ out,
                            int R, const KT* __restrict__ kpool,
                            const KT* __restrict__ vpool,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ table, int NB, int bs,
                            int h, int nkeys, bool causal, int q_offset,
                            int C, int r0, float scale) {
  using S = Smem<EPL, KT>;
  constexpr int D = S::D;
  constexpr int N = Chunk<KT>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + S::kQ;             // [warp][32][kVStride]
  float* Vsc = reinterpret_cast<float*>(stage + kWarps * 32 * S::kVStride);
  float* Accw = reinterpret_cast<float*>(stage);   // after the key loop
  float* Mw = reinterpret_cast<float*>(smem + S::kQ + S::kUnion);
  float* Lw = Mw + kWarps * kMaxRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* my_stage = stage + warp * 32 * S::kVStride;
  float* my_vsc = Vsc + warp * 32;

  for (int e = tid; e < kMaxRows * D; e += kThreads)
    Qs[e] = e < R * D ? to_float(q[e]) : 0.f;
  int qpos[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) qpos[r] = q_offset + (r0 + r) % C;
  float m[kMaxRows], l[kMaxRows], acc[kMaxRows][EPL];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();

  const int tiles = (nkeys + 31) / 32;
  for (int t = warp; t < tiles; t += kWarps) {
    // lane j owns key kp = 32 t + j: its K row is dotted with every query
    // row, its V row is staged for the value product below
    const int kp = t * 32 + lane;
    const bool live = kp < nkeys;
    float s[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) s[r] = 0.f;
    __syncwarp();   // the previous tile's staged V rows are consumed
    if (live) {
      const size_t row = ((size_t)h * NB + table[kp / bs]) * bs + kp % bs;
      const KT* krow = kpool + row * D;
      const uint4* vrow = reinterpret_cast<const uint4*>(vpool + row * D);
      uint4* vdst = reinterpret_cast<uint4*>(my_stage + lane * S::kVStride);
#pragma unroll
      for (int c = 0; c < D * (int)sizeof(KT) / 16; ++c) vdst[c] = vrow[c];
      my_vsc[lane] = vscale != nullptr ? vscale[row] : 1.f;
#pragma unroll 2
      for (int c = 0; c < D; c += N) {
        float kc[N];
        load_chunk(krow + c, kc);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < R) {
#pragma unroll
            for (int i = 0; i < N; ++i)
              s[r] = fmaf(Qs[r * D + c + i], kc[i], s[r]);
          }
        }
      }
      const float ks = kscale != nullptr ? kscale[row] : 1.f;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) s[r] = s[r] * ks * scale;
    }
    // online softmax over the tile, per query row (warp-uniform stats)
    float p[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      p[r] = 0.f;
      if (r < R) {
        const bool valid = live && (!causal || kp <= qpos[r]);
        const float m_new = fmaxf(m[r], warp_max(valid ? s[r] : kNegInf));
        p[r] = valid ? expf(s[r] - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
      }
    }
    __syncwarp();   // staged V rows visible to the whole warp
    // acc += p @ v over the tile's live keys; this lane's D/32 columns
    const int nv = min(32, nkeys - t * 32);
#pragma unroll 4
    for (int j = 0; j < nv; ++j) {
      const KT* vj = reinterpret_cast<const KT*>(my_stage + j * S::kVStride)
                     + lane * EPL;
      const float vsc = my_vsc[j];
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vv[e] = to_float(vj[e]) * vsc;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < R) {
          const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
        }
      }
    }
  }

  // merge the warps' partial (m, l, acc); Accw reuses the staging area
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (lane == 0) {
      Mw[warp * kMaxRows + r] = m[r];
      Lw[warp * kMaxRows + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      Accw[(warp * kMaxRows + r) * D + lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Mw[w * kMaxRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Mw[w * kMaxRows + r] - mx);
      lsum += Lw[w * kMaxRows + r] * f;
      a += Accw[w * kMaxRows * D + e] * f;
    }
    // ctx 0: l and acc are 0, and 0 / 1e-30 writes exact zeros
    out[e] = from_float<QT>(a / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace paged
