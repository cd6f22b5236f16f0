// Chunkwise stabilized mLSTM backward on Hopper's tensor cores (sm_90a):
// 3xTF32 wgmma products, a cluster of DH / 64 CTAs a chunk.
//
// Replaces no Pallas kernel: the reference has no backward kernel for the
// mLSTM (XLA differentiates its chunk body, repro/models/recurrent.py ::
// mlstm_chunk_body). It is the "wgmma" route of ops.mlstm_chunked_bwd at
// head widths DH in {64, 128, 256, 512}; mlstm_chunked_bwd.cu (float32 on
// the CUDA cores) keeps the other widths as the "simt" route. The function
// is that kernel's, exactly as mlstm_chunked_bwd.cu states it
// (ref.mlstm_chunkwise_bwd_ref): from q, k, v, h, dh [B, NH, S, DH]
// (float32 or bf16), the gates ig, lf and the forward's saved states (each
// 64-step chunk's starting C, n, m and every step's m_t, qn_t) it returns
// dq, dk, dv [B, NH, S, DH] and dig, dlf [B, NH, S], float32, with the
// stabilizer held constant; no atomics, so two launches agree bitwise.
//
// What bounds it on an H100: operations. At the training path's shape
// (B 4, NH 4, S 512, DH 512, chunks of 64, float32) it needs 18.6 GFLOP
// (8 S DH^2 a (b, h) for dC's recursion, dnum C, v dC' and k dC'^T, 10 DH
// a causal pair for q k^T, dnum v^T, P^T dnum, dS k and dS^T q): 0.113 ms
// at 3xTF32's 495 / 3 TFLOP/s, against 269 MB of inputs and outputs
// (0.080 ms at 3.35 TB/s).
//
// Numerics: 3xTF32, hopper.cuh's passes (as the forward,
// mlstm_chunked_tc.cuh): every float32 operand splits into tf32 big and
// small parts and a product is small.big + big.small + big.big, small
// passes first; a bf16 operand is exact in tf32 and drops its passes. The
// split truncates (split4 below) where hopper.cuh's rounds to nearest. The
// gates, P, dS, dlogD and every sum outside a product are float32 on the
// CUDA cores. One tf32 pass would break the card checks' 1e-4 of each
// gradient's largest magnitude (tests/test_torch_mlstm_bwd_tf32.py).
//
// The design, three launches on the caller's stream:
//   (a) mlstm_bwd_tc_gates_kernel, four CTAs a chunk: dqn_t = -(h_t .
//       dh_t) / den_t * [the max and abs slopes], 1 / den_t, the cumsum b_t
//       of lf, inter_t, w_t and the chunk's carry, into a scratch that both
//       wgmma kernels read, so neither needs a sum over all of DH or a scan.
//   (b) mlstm_bwd_tc_sweep_kernel, grid (DH / 64, NH, B), no cluster: the
//       reverse sweep. A CTA owns rows [64 r, 64 r + 64) of dC (the v
//       dimension) for one (b, h) as wgmma accumulators in registers (two
//       warpgroups, each every other 32-wide slab of e: the forward's C
//       layout), and the same slice of dn. Each chunk, from the last, it
//       stores the carried dC' (through shared memory, whole lines; with
//       <C, dC'> over its rows, C's blocks through a cp.async ring) and dn'
//       for (c), then adds (inter o dnum)^T q as C's update does in the
//       forward: M 64 (i), N DH (e), K 64 (time), A = (inter o dnum)^T as
//       register fragments (split once a chunk), B = q^T, 64 columns of e a
//       step, float32 q copied raw by cp.async into a ring two steps ahead
//       (bf16 q a step ahead in registers). 128 CTAs at the training shape:
//       one wave.
//   (c) mlstm_bwd_tc_chunk_kernel, grid (DH / 64, chunks, B NH), a cluster
//       of DH / 64 CTAs a (b, h, chunk): 1024 CTAs at the training shape
//       where the SIMT kernel had 128. CTA r owns the 64-wide slice r of dq
//       and dk (e) and of dv (i):
//         * 32-deep steps, the two warpgroups' products side by side with
//           no barrier between them, each M 64, N 64 with its A operand as
//           register fragments (split after its previous product is done)
//           and its B operand in its own two buffers of swizzled tiles: S
//           and U = dnum v^T over the CTA's slice of DH (warpgroup 0 and 1;
//           with n.q_t and k_j.dn'), then X = dnum C[:, r] and Y = v dC'[:,
//           r] (B = C^T and dC'^T, transposed by the split), then Z = k
//           dC'[r, :]^T in two halves of K. Each step's raw A and B blocks
//           come by cp.async through a ring two steps ahead (bf16 A a step
//           ahead in registers); S's and U's a step ahead in registers;
//         * S's and U's partials summed over the cluster in rank order
//           through distributed shared memory (a reduce-scatter, then an
//           all-gather: the forward's exchange), while X, Y and Z are handed
//           between the warpgroups through shared memory;
//         * P, dS and dlogD in float32 from the summed S and U, written as
//           the split A operands dS, dS^T and P^T, then dS k, dS^T q and P^T
//           dnum over the slice (K 64, both warpgroups, each 32 columns),
//           added to inter o (X + dqn n), w o (Y + dn') and w o Z on the
//           CUDA cores;
//         * the gates: each CTA's row partials (X . q, v . Z, n . q, k . dn',
//           the sweep's share of <C, dC'> + dn'. n) summed by rank 0 in rank
//           order, which writes dig and dlf (the reverse cumsum of db).
//       The measured phases (chip_smoke.py's phase split): the 26 steps
//       take about two thirds of a CTA's cycles, the split and the loads'
//       wait ahead of the products most of it.
#include <type_traits>

#include "mlstm_chunked_tc.cuh"

namespace mlstm_bwd_tc {

using namespace hopper;
using mlstm_tc::Tile;
using mlstm_tc::cluster_arrive;
using mlstm_tc::cluster_wait;

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kC = 64;                // time steps per chunk (the forward's)
constexpr int kThreads = 256;         // two consumer warpgroups
constexpr int kLdS = 68;              // row stride of the summed S and U
// Phase clocks (thread 0's clock64() between the points it passes, summed
// over a launch's CTAs), when the caller passes a buffer: the sweep's 0
// the dn' store and the chunk's loads issued, 1 gates, 2 A, steps: 3 dC'
// stores and B split, 4 barrier, 5 fetch and product issue, 6 wait and
// barrier; 7 dn, 8 the whole CTA. The chunk kernel's (after the sweep's,
// warpgroup 0's) 0 gates, steps: 2 B split, 3 barrier, 5 the previous
// product's wait, 4 A split, fetch and product issue; 1 X, Y and Z handed
// between the warpgroups; 6 the exchange, 7 P and dS, 8 dS k, dS^T q, P^T
// dnum and the stores, 9 the gates' sums, 10 the whole CTA.
constexpr int kSweepPhases = 9, kChunkPhases = 11;

struct Clock {
  long long clk[16];
};
// Adds the cycles since the last lap to phase p (thread 0, when timed).
struct Lap {
  Clock* c;
  long long tick, start;
  bool on;
  __device__ __forceinline__ Lap(Clock* c_, bool on_) : c(c_), on(on_) {
    tick = start = 0;
    if (on) {
      for (int i = 0; i < 16; ++i) c->clk[i] = 0;
      tick = start = clock64();
    }
  }
  __device__ __forceinline__ void operator()(int p) {
    if (on) {
      const long long now = clock64();
      c->clk[p] += now - tick;
      tick = now;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* prof, int n) {
    if (on) {
      c->clk[n - 1] = clock64() - start;
      for (int i = 0; i < n; ++i)
        atomicAdd(&prof[i], (unsigned long long)c->clk[i]);
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
// The generic address of the object at p in the shared memory of cluster
// rank `rank`: plain loads and stores through it are ordinary memory
// operations, so the compiler issues several before the first returns
// (and orders them against the cluster barriers' memory clobbers).
template <typename P>
__device__ __forceinline__ P* rank_ptr(P* p, int rank) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(r)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<P*>(r);
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// A thread's 4 x 4 block of a [64][64] source tile, which put transposes
// into operand tiles: source rows 4 a .. 4 a + 3, columns 4 b .. 4 b + 3.
// Lanes 0-7 of a warp take eight a's at one b, so a warp's loads fill
// whole 32-byte sectors and each quarter-warp's 16-byte stores into a
// swizzled tile hit eight different bank groups.
struct Quad {
  int a, b;
};
__device__ __forceinline__ Quad quad() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {(lane & 7) + 8 * (warp & 1), (lane >> 3) + 4 * (warp >> 1)};
}

// The block of the [64][64] tile at `src` (row stride ld) into registers;
// rows at or past `nvalid` read as zeros.
template <typename S>
__device__ __forceinline__ void fetch(float4 (&r)[4], const S* src, int ld,
                                      int nvalid, Quad q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * q.a + i;
    r[i] = row < nvalid ? ld4(src + (size_t)row * ld + 4 * q.b)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Each source row's values times rdiv[row] (the plain version's dh / den;
// a division here would be a call in the middle of the product pipeline).
__device__ __forceinline__ void scale_rows(float4 (&r)[4], Quad q,
                                           const float* rdiv) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = rdiv[4 * q.a + i];
    r[i] = make_float4(r[i].x * d, r[i].y * d, r[i].z * d, r[i].w * d);
  }
}

// x = big + small, big = x truncated to tf32 (the 13 low mantissa bits
// cleared: what wgmma reads of a float32 word) and small = x - big, exact;
// wgmma truncates small in turn, which leaves an error of 2^-20 |x|.
// The round-to-nearest split (hopper.cuh's, cvt.rna twice a value) was
// the largest single cost of the split passes on the card; this one is a
// mask and a subtraction.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  big = make_float4(tf32_trunc(x.x), tf32_trunc(x.y), tf32_trunc(x.z),
                    tf32_trunc(x.w));
  small = make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
}

// Four values as chunk k4 (k = 4 k4 .. 4 k4 + 3) of operand row `row`: big
// into t[k4 / 8], small into t[2 + k4 / 8] (K = 64 is two 32-wide tiles).
template <bool kExact>
__device__ __forceinline__ void st4(float4 v, Tile* t, int row, int k4) {
  const int h = k4 >> 3, ch = k4 & 7;
  if (kExact) {
    st_chunk(&t[h], row, ch, v);
    return;
  }
  float4 hi, lo;
  split4(v, hi, lo);
  st_chunk(&t[h], row, ch, hi);
  st_chunk(&t[2 + h], row, ch, lo);
}

// The block, transposed (operand row = source column, k = source row), as
// operand tiles t[0..3] (big k 0-31, 32-63; small the same).
template <bool kExact>
__device__ __forceinline__ void put(const float4 (&r)[4], Tile* t, Quad q) {
  st4<kExact>(make_float4(r[0].x, r[1].x, r[2].x, r[3].x), t, 4 * q.b, q.a);
  st4<kExact>(make_float4(r[0].y, r[1].y, r[2].y, r[3].y), t, 4 * q.b + 1,
              q.a);
  st4<kExact>(make_float4(r[0].z, r[1].z, r[2].z, r[3].z), t, 4 * q.b + 2,
              q.a);
  st4<kExact>(make_float4(r[0].w, r[1].w, r[2].w, r[3].w), t, 4 * q.b + 3,
              q.a);
}

// D += A B^T over K 64 (3xTF32, or fewer passes for exact operands): A in
// a[0..3], rows [32 g, 32 g + 32) of B in b[0..3]; one commit group.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma(float (&d)[16], const Tile* a,
                                    const Tile* b, int g) {
  wgmma_fence();
  tf32x3_k64_n32<kExactA, kExactB>(d, &a[0], &a[1], &a[2], &a[3], &b[0],
                                   &b[1], &b[2], &b[3], 32 * g);
  wgmma_commit();
}

__device__ __forceinline__ void zero16(float (&d)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = 0.f;
}

// Sum of a row partial over the 16 b's of a quad row set: lanes differ in
// lane >> 3, warps in warp >> 1; lanes with (lane >> 3) == 0 write the
// warp pair's sum to red[warp >> 1][row].
__device__ __forceinline__ void row_partial(float v, float (*red)[kC],
                                            int row) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  if (((threadIdx.x & 31) >> 3) == 0) red[(threadIdx.x >> 5) >> 1][row] = v;
}

// Per-step values of one chunk (kC floats each).
struct Gates {
  float bc[kC];     // the inclusive cumsum b_t of lf
  float igs[kC];    // input gate
  float mts[kC];    // the forward's m_t
  float inter[kC];  // e^{m_in + b_t - m_t}
  float wk[kC];     // e^{b_c - b_j + i_j - m_c}
  float rden[kC];   // 1 / max(|qn_t|, e^{-m_t}); 1 past the chunk's end
  float dqn[kC];    // the cotangent of qn_t; 0 past the end
  float scal[4];    // [0] carry
};

// The planes of the gates kernel's scratch ([B, NH, S] each, then carry
// [B, NH, K], then the sweep CTAs' shares of <C, dC'> [B, NH, K, DH / 64]):
// the chunk's inclusive cumsum of lf, inter, w, 1 / den, dqn.
enum GatePlane { kBc = 0, kInter, kWk, kRden, kDqn, kPlanes };

// The chunk's gates into g from the gates kernel's planes (gtb: the (b, h)
// base of plane 0, planes `rows` apart; carry: the chunk's carry), every
// thread calling; it ends with them visible to all.
__device__ void chunk_gates(Gates& g, const float* __restrict__ igb,
                            const float* __restrict__ mtb,
                            const float* __restrict__ gtb, size_t rows,
                            const float* __restrict__ carry, int t0,
                            int cl) {
  const int tid = threadIdx.x;
  if (tid < kC) {
    const bool live = tid < cl;
    const float* p = gtb + t0 + tid;
    g.igs[tid] = live ? igb[t0 + tid] : 0.f;
    g.mts[tid] = live ? mtb[t0 + tid] : 0.f;
    g.bc[tid] = live ? p[kBc * rows] : 0.f;
    g.inter[tid] = live ? p[kInter * rows] : 0.f;
    g.wk[tid] = live ? p[kWk * rows] : 0.f;
    g.rden[tid] = live ? p[kRden * rows] : 1.f;
    g.dqn[tid] = live ? p[kDqn * rows] : 0.f;
  }
  if (tid == 0) g.scal[0] = *carry;
  __syncthreads();
}

// ----------------------------------------------------- (a) the gates
// A CTA a quarter of a (chunk, (b, h)): dqn_t = -(h_t . dh_t) / den_t *
// [the max and abs slopes] and 1 / den_t, a warp two rows; warp 0 of the
// first quarter also scans lf (two steps a lane) and writes b_t, inter_t,
// w_t and the carry (as mlstm_chunked_bwd.cu computes them).
constexpr int kGateParts = 4;
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_tc_gates_kernel(
    const T* __restrict__ h, const T* __restrict__ dh,
    const float* __restrict__ ig, const float* __restrict__ lf,
    const float* __restrict__ ms, const float* __restrict__ mt,
    const float* __restrict__ qn, float* __restrict__ gt, int S, int Dh) {
  const int kk = blockIdx.x, K = gridDim.x;
  const size_t bh = blockIdx.y, rows = (size_t)gridDim.y * S;
  const int t0 = kk * kC, cl = min(kC, S - t0);
  const size_t base = bh * S + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRows = kC / kGateParts / (kThreads / 32);  // a warp's
  for (int u = 0; u < kRows; ++u) {
    const int t = kC / kGateParts * blockIdx.z + kRows * warp + u;
    if (t >= cl) break;
    const T* hr = h + (base + t) * Dh;
    const T* dr = dh + (base + t) * Dh;
    float sum = 0.f;
    for (int e = 4 * lane; e < Dh; e += 128) {
      const float4 a = ld4(hr + e), b = ld4(dr + e);
      sum = fmaf(b.x, a.x, sum);
      sum = fmaf(b.y, a.y, sum);
      sum = fmaf(b.z, a.z, sum);
      sum = fmaf(b.w, a.w, sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float x = qn[base + t], fl = expf(-mt[base + t]), a = fabsf(x);
      const float den = fmaxf(a, fl);
      const float share = a > fl ? 1.f : (a == fl ? 0.5f : 0.f);
      gt[kDqn * rows + base + t] =
          -sum / den * share * (x >= 0.f ? 1.f : -1.f);
      gt[kRden * rows + base + t] = 1.f / den;
    }
  }
  if (warp == 0 && blockIdx.z == 0) {   // the cumsum: a warp scan, two
    const int ta = 2 * lane, tb = ta + 1;  // steps a lane
    const bool va = ta < cl, vb = tb < cl;
    const float x0 = va ? lf[base + ta] : 0.f, x1 = vb ? lf[base + tb] : 0.f;
    float inc = x0 + x1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc = y + inc;
    }
    float exc = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) exc = 0.f;
    const float ba = exc + x0, bb = (exc + x0) + x1;
    const int last = cl - 1;
    const float b_last =
        __shfl_sync(0xffffffffu, (last & 1) ? bb : ba, last >> 1);
    const float m_in = ms[bh * K + kk], m_out = mt[base + last];
    const float b2[2] = {ba, bb};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = ta + u;
      if (t < cl) {
        const float mtt = mt[base + t], igt = ig[base + t];
        gt[kBc * rows + base + t] = b2[u];
        gt[kInter * rows + base + t] = expf((m_in + b2[u]) - mtt);
        gt[kWk * rows + base + t] = expf(((b_last - b2[u]) + igt) - m_out);
      }
    }
    if (lane == 0)
      gt[kPlanes * rows + bh * K + kk] = expf((m_in + b_last) - m_out);
  }
}

// ------------------------------------------------- (b) the reverse sweep
constexpr int kSweepRing = 3;   // raw q blocks: the step's and two ahead

struct SweepSmem {
  Tile b[2][4];       // q^T of 64 columns of e, two buffers
  Tile raw[kSweepRing][2];   // float32 q blocks [64 t][64 e] (16 KB each)
  Tile craw[kSweepRing][2];  // C blocks [64 i][64 e] at the same steps
  float stage[kC * 68];      // a step's 64 columns of dC', for the stores
  float rdc[kThreads / 32];  // <C, dC'> by warp
  Gates g;
  float dn[kC];       // dn over the CTA's e slice
  float red[kThreads];  // dn's update by quarter of the chunk
  Clock clk;
};

// Piece ch (16 bytes: 4 columns) of row t of a raw [64 t][64] float32
// block, the pieces of rows 4 a .. 4 a + 3 swizzled by a % 8 (the 4 x 4
// blocks that fetch reads meet no bank conflict).
__device__ __forceinline__ char* raw64t(Tile* t, int row, int ch) {
  return reinterpret_cast<char*>(t) + row * 256 +
         ((ch ^ ((row >> 2) & 7)) << 4);
}

// D[64 x 32] += A[64 x 8] B[8 x 32], A in registers (a tf32 fragment), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_tc_sweep_kernel(
    const T* __restrict__ q, const T* __restrict__ dh,
    const float* __restrict__ ig, const float* __restrict__ mt,
    const float* __restrict__ Cs, float* __restrict__ gt,
    float* __restrict__ dCs, float* __restrict__ dns, int S,
    unsigned long long* __restrict__ prof) {
  constexpr int NSW = DH / 64;                 // 64-wide steps of e
  constexpr bool X = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  SweepSmem& s = *reinterpret_cast<SweepSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x, g = tid >> 7, l = tid & 127;
  const int w = l >> 5, lane = tid & 31, t4 = lane & 3;
  const int r0 = 64 * blockIdx.x;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int K = (S + kC - 1) / kC;
  const Quad qd = quad();
  const int fr = 16 * w + (lane >> 2), fc = 2 * (lane & 3);
  const T* qb = q + bh * S * DH;
  const T* dhb = dh + bh * S * DH;

  Lap lap(&s.clk, prof != nullptr && tid == 0);
  // float32 q goes through a ring of raw blocks by cp.async, two steps
  // (64 columns of one chunk each, the chunks from the last) ahead of its
  // split, bf16 q into registers a step ahead; and the same steps' blocks
  // of C's rows [64 r, 64 r + 64) through a ring beside it, for <C, dC'>
  const int GS = K * NSW;
  auto copy_q = [&](int gs) {
    if (gs < GS) {
      const int kq = K - 1 - gs / NSW, c0 = 64 * (gs % NSW);
      const int tq = kq * kC, cq = min(kC, S - tq);
      Tile* slot = s.raw[gs % kSweepRing];
      char* cslot = reinterpret_cast<char*>(s.craw[gs % kSweepRing]);
      const float* cb = Cs + ((bh * K + kq) * DH + r0) * DH + c0;
      for (int u = tid; u < kC * 16; u += kThreads) {
        const int row = u >> 4, ch = u & 15;
        const bool ok = row < cq;
        if (!X)
          cp_async16(raw64t(slot, row, ch),
                     qb + (size_t)(tq + (ok ? row : 0)) * DH + c0 + 4 * ch,
                     ok);
        cp_async16(cslot + 16 * u, cb + (size_t)row * DH + 4 * ch, true);
      }
    }
    cp_commit();
  };
  copy_q(0);
  copy_q(1);
  float c[NSW][16];
#pragma unroll
  for (int sl = 0; sl < NSW; ++sl) zero16(c[sl]);
  if (tid < kC) s.dn[tid] = 0.f;
  cp_wait<1>();
  __syncthreads();

  for (int kk = K - 1; kk >= 0; --kk) {
    const int t0 = kk * kC, cl = min(kC, S - t0);
    const size_t at = bh * K + kk;
    // the cotangent of chunk kk's final state, as the chunk kernel reads
    // it: dn' here, each slab of dC' before its step scales it
    if (tid < kC) dns[at * DH + r0 + tid] = s.dn[tid];
    // A's fragments (and bf16 q's first 64 columns) in flight while the
    // gates load
    float4 rq[4];
    if (X) fetch(rq, qb + (size_t)t0 * DH, DH, cl, qd);
    float fa[32];             // A = (inter o dnum)^T [64 i][64 t]: k = t
#pragma unroll
    for (int kq = 0; kq < 8; ++kq)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = fr + 8 * (j & 1), t = 8 * kq + t4 + 4 * (j >> 1);
        fa[4 * kq + j] =
            t < cl ? ld1(dhb + (size_t)(t0 + t) * DH + r0 + i) : 0.f;
      }
    lap(0);
    const size_t rows = (size_t)gridDim.y * gridDim.z * S;
    chunk_gates(s.g, ig + bh * S, mt + bh * S, gt + bh * S, rows,
                gt + kPlanes * rows + at, t0, cl);
    const float carry = s.g.scal[0];
    lap(1);
    uint32_t ab[8][4], as[8][4];
#pragma unroll
    for (int kq = 0; kq < 8; ++kq)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 8 * kq + t4 + 4 * (j >> 1);
        const float x = s.g.inter[t] * (fa[4 * kq + j] * s.g.rden[t]);
        const float hi = tf32_trunc(x);
        ab[kq][j] = __float_as_uint(hi);
        as[kq][j] = __float_as_uint(x - hi);
      }
    lap(2);
    // dC = carry dC + A q, 64 columns of e a step (warpgroup g: slab
    // 2 sl + g), the next step's q in flight while this one multiplies
    const int gs0 = (K - 1 - kk) * NSW;
    float dcp = 0.f;          // <C, dC'> over the CTA's rows
#pragma unroll
    for (int sl = 0; sl < NSW; ++sl) {
      // dC''s 64 columns of this step through shared memory, so that each
      // row goes out as whole 256-byte lines
#pragma unroll
      for (int k = 0; k < 16; k += 2) {
        const int i = fr + 8 * ((k >> 1) & 1);
        const int e = 32 * g + 8 * (k >> 2) + fc;
        *reinterpret_cast<float2*>(&s.stage[i * 68 + e]) =
            make_float2(c[sl][k], c[sl][k + 1]);
      }
      if (!X) {               // this step's raw block is in the ring
        Tile* slot = s.raw[(gs0 + sl) % kSweepRing];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rq[i] = *reinterpret_cast<const float4*>(
              raw64t(slot, 4 * qd.a + i, qd.b));
        if (sl == (int)blockIdx.x) {   // the CTA's e slice: dn's update, a
          const int e = tid & (kC - 1), pt = tid >> 6;   // quarter of the
          float sum = 0.f;                               // steps a thread
#pragma unroll
          for (int j = 0; j < kC / 4; ++j) {
            const int t = pt * (kC / 4) + j;
            sum = fmaf(s.g.inter[t] * s.g.dqn[t],
                       reinterpret_cast<const float*>(
                           raw64t(slot, t, e >> 2))[e & 3],
                       sum);
          }
          s.red[pt * kC + e] = sum;
        }
      }
      put<X>(rq, s.b[sl & 1], qd);
      fence_proxy_async();
      lap(3);
      __syncthreads();
      lap(4);
      const float4* cblk = reinterpret_cast<const float4*>(
          s.craw[(gs0 + sl) % kSweepRing]);
      for (int u = tid; u < kC * 16; u += kThreads) {
        const int i = u >> 4, ch = u & 15;
        const float4 x =
            *reinterpret_cast<const float4*>(&s.stage[i * 68 + 4 * ch]);
        *reinterpret_cast<float4*>(
            &dCs[(at * DH + r0 + i) * DH + 64 * sl + 4 * ch]) = x;
        const float4 cv = cblk[u];
        dcp = fmaf(x.x, cv.x,
                   fmaf(x.y, cv.y, fmaf(x.z, cv.z, fmaf(x.w, cv.w, dcp))));
      }
      copy_q(gs0 + sl + 2);   // into the slot read a step ago
      if (X && sl + 1 < NSW)
        fetch(rq, qb + (size_t)t0 * DH + 64 * (sl + 1), DH, cl, qd);
#pragma unroll
      for (int k = 0; k < 16; ++k) c[sl][k] *= carry;
      const Tile* bt = s.b[sl & 1];
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        wgmma_tf32_rs_n32(c[sl], as[kq], tf32_kdesc(&bt[0], &bt[1], kq,
                                                    32 * g));
        if (!X)
          wgmma_tf32_rs_n32(c[sl], ab[kq], tf32_kdesc(&bt[2], &bt[3], kq,
                                                      32 * g));
      }
#pragma unroll
      for (int kq = 0; kq < 8; ++kq)
        wgmma_tf32_rs_n32(c[sl], ab[kq], tf32_kdesc(&bt[0], &bt[1], kq,
                                                    32 * g));
      wgmma_commit();
      lap(5);
      wgmma_wait<1>();
      cp_wait<1>();      // the next step's raw block is in
      __syncthreads();   // both warpgroups are done with the other buffer
      lap(6);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < NSW; ++sl) fence_regs(c[sl]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dcp += __shfl_xor_sync(0xffffffffu, dcp, o);
    if (lane == 0) s.rdc[tid >> 5] = dcp;
    // dn = carry dn + (inter o dqn)^T q over the CTA's e slice, a quarter
    // of the chunk's steps a thread (for float32 q, from the ring at the
    // slice's step), the quarters summed in order
    if (X) {
      const int e = tid & (kC - 1), pt = tid >> 6;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kC / 4; ++j) {
        const int t = pt * (kC / 4) + j;
        if (t < cl)
          sum = fmaf(s.g.inter[t] * s.g.dqn[t],
                     ld1(qb + (size_t)(t0 + t) * DH + r0 + e), sum);
      }
      s.red[pt * kC + e] = sum;
    }
    __syncthreads();
    if (tid < kC)
      s.dn[tid] = carry * s.dn[tid] +
                  (((s.red[tid] + s.red[kC + tid]) + s.red[2 * kC + tid]) +
                   s.red[3 * kC + tid]);
    if (tid == kC) {          // this CTA's rows of <C_k, dC'_k>
      float sum = 0.f;
      for (int i = 0; i < kThreads / 32; ++i) sum += s.rdc[i];
      gt[kPlanes * rows + gridDim.y * gridDim.z * K + at * NSW +
         blockIdx.x] = sum;
    }
    __syncthreads();
    lap(7);
  }
  lap.flush(prof, kSweepPhases);
}

// ------------------------------------------- (c) the chunks in parallel
// Piece ch (16 bytes) of row `row` of a raw [32][64] float32 block in an
// 8 KB tile, the pieces of rows 4 a .. 4 a + 3 swizzled by a, so that
// eight threads reading rows 4 a + i (a = 0 .. 7) at one piece meet no bank
// conflict.
__device__ __forceinline__ char* raw32t(Tile* t, int row, int ch) {
  return reinterpret_cast<char*>(t) + row * 256 +
         ((ch ^ ((row >> 2) & 7)) << 4);
}
__device__ __forceinline__ const char* raw32t(const Tile* t, int row,
                                              int ch) {
  return reinterpret_cast<const char*>(t) + row * 256 +
         ((ch ^ ((row >> 2) & 7)) << 4);
}

// A warpgroup thread's share (l = thread in the warpgroup) of a [64][32]
// operand tile: natural (operand row = source row, 32 source columns),
// the chunk c of rows a + 8 h + 16 i; or transposed (operand row = source
// column, from 32 source rows of 64 columns), the 4 x 4 block of source
// rows 4 ta .., columns 4 tb ... Both fill whole 32-byte sectors on the
// loads and meet no bank conflict on the 16-byte stores.
struct Q32 {
  int a, c, h, ta, tb;
};
__device__ __forceinline__ Q32 q32(int l) {
  const int lane = l & 31, w = l >> 5;
  return {lane & 7, (lane >> 3) + 4 * (w & 1), w >> 1, lane & 7,
          (lane >> 3) + 4 * w};
}
__device__ __forceinline__ int row32(bool nat, Q32 q, int i) {
  return nat ? q.a + 8 * q.h + 16 * i : 4 * q.ta + i;
}

template <typename S>
__device__ __forceinline__ void fetch32(float4 (&r)[4], const S* src, int ld,
                                        int nvalid, bool nat, Q32 q) {
  const int col = 4 * (nat ? q.c : q.tb);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row32(nat, q, i);
    r[i] = row < nvalid ? ld4(src + (size_t)row * ld + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The share as tiles big (t[0]) and small (t[1]) of one [64][32] operand.
template <bool kExact>
__device__ __forceinline__ void put32(const float4 (&r)[4], Tile* t, bool nat,
                                      Q32 q) {
  auto st = [&](float4 v, int row, int ch) {
    if (kExact) {
      st_chunk(&t[0], row, ch, v);
      return;
    }
    float4 hi, lo;
    split4(v, hi, lo);
    st_chunk(&t[0], row, ch, hi);
    st_chunk(&t[1], row, ch, lo);
  };
  if (nat) {
#pragma unroll
    for (int i = 0; i < 4; ++i) st(r[i], row32(true, q, i), q.c);
    return;
  }
  st(make_float4(r[0].x, r[1].x, r[2].x, r[3].x), 4 * q.tb, q.ta);
  st(make_float4(r[0].y, r[1].y, r[2].y, r[3].y), 4 * q.tb + 1, q.ta);
  st(make_float4(r[0].z, r[1].z, r[2].z, r[3].z), 4 * q.tb + 2, q.ta);
  st(make_float4(r[0].w, r[1].w, r[2].w, r[3].w), 4 * q.tb + 3, q.ta);
}

// Warpgroup thread's A fragments of a [64 rows][32 k] slab at src (row
// stride ld; rows at or past nvalid read as zeros), as the register-A
// wgmma takes them: for k step kk, rows fr and fr + 8 at k = 8 kk + t,
// then at 8 kk + t + 4 (t = lane % 4).
template <typename S>
__device__ __forceinline__ void fetch_frag(float (&a)[16], const S* src,
                                           int ld, int nvalid, int fr,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = fr + 8 * (j & 1), col = 8 * kk + t + 4 * (j >> 1);
      a[4 * kk + j] = row < nvalid ? ld1(src + (size_t)row * ld + col) : 0.f;
    }
}

// The fragments split into tf32 big and small parts (split4's split).
__device__ __forceinline__ void split_frag(const float (&a)[16],
                                           uint32_t (&big)[4][4],
                                           uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = a[4 * kk + j], hi = tf32_trunc(x);
      big[kk][j] = __float_as_uint(hi);
      small[kk][j] = __float_as_uint(x - hi);
    }
}

// D[64 x 64] += A B^T over K 32, 3xTF32 (fewer passes for exact
// operands): A in registers (big, small), B in tiles b[0] (big) and b[1]
// (small); small passes first; one commit group.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&ab)[4][4],
                                       const uint32_t (&as)[4][4],
                                       const Tile* b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (!kExactA) wgmma_tf32_rs_n64(d, as[kk], desc_sw128(&b[0]) + 2 * kk);
    if (!kExactB) wgmma_tf32_rs_n64(d, ab[kk], desc_sw128(&b[1]) + 2 * kk);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_rs_n64(d, ab[kk], desc_sw128(&b[0]) + 2 * kk);
  wgmma_commit();
}

struct ChunkSmem {
  Tile ops[2][8];     // the steps' B tiles ([64][32]): buffer p, warpgroup
                      // g's big ops[p][2 g], small ops[p][2 g + 1]; its
                      // ring slot ops[p][4 + 2 g ..] (raw A, raw B); after
                      // the steps, X, Y, Z0, Z1 and the last products'
                      // [64][64] operands
  float xs[kC * kC], xu[kC * kC];       // this CTA's S, U partials [t][j]
  float sf[kC * kLdS], uf[kC * kLdS];   // S, U summed over the cluster
  Gates g;
  float nv[kC], dnv[kC];      // n and dn' over the CTA's slice
  float rnq[kC], rkd[2][kC];            // n.q_t, k_j.dn' partials
  float rrow[4][kC], rcol[2][kC];       // dlogD's row and column sums
  float rows[kC], cols[kC];
  float rx[2][2][kC];         // X.q and v.Z by warpgroup
  float gx[4 * kC + 4];       // this CTA's gate partials (rank 0 reads)
  float gw[kC], db[kC];
  Clock clk;
};
constexpr int kLdX = 72;      // row stride of X, Y, Z0, Z1 handed between
                              // the warpgroups (in ops, after the steps)

// The chunk kernel's steps, 32 deep each: the two warpgroups run their
// own products side by side, with no barrier between them. Warpgroup g
// fetches its A operand straight into wgmma's register fragments and its
// B operand into its own two buffers of tiles ([64][32], big and small).
// Steps 0-1 (h, 32 columns of the CTA's slice each): S (g 0: A q, B k)
// and U (g 1: A dnum, B v); then 2 NC steps s: X (g 0: A dnum[:, 32 s ..],
// B C's 32 rows at the slice's columns, transposed) and Y (g 1: A v, B dC'
// likewise; warpgroup 0 also fetches that dC' block for <C, dC'>); then NC
// steps z: Z0 and Z1 (A k, B dC' at the slice's rows) over the two 32-wide
// halves of columns [64 z, 64 z + 64).
template <typename T, int NC>
struct ChunkSteps {
  static constexpr int DH = 64 * NC, NST = 2 + 3 * NC;
  static constexpr bool X = std::is_same<T, __nv_bfloat16>::value;
  const T *q, *k, *v, *dh;     // the chunk's first row
  const float *C, *dC;         // the chunk's starting C and dC'
  int r0, cl;

  // Warpgroup g's A fragments of step st.
  __device__ __forceinline__ void fetch_a(int st, int g, float (&fa)[16],
                                          int fr, int t) const {
    if (st >= NST) return;
    if (st < 2)
      fetch_frag(fa, (g == 0 ? q : dh) + r0 + 32 * st, DH, cl, fr, t);
    else if (st < 2 + 2 * NC)
      fetch_frag(fa, (g == 0 ? dh : v) + 32 * (st - 2), DH, cl, fr, t);
    else
      fetch_frag(fa, k + 64 * (st - 2 - 2 * NC) + 32 * g, DH, cl, fr, t);
  }

  // Warpgroup g's B share of step st < 2 (k or v over the slice).
  __device__ __forceinline__ void fetch_b(int st, int g, float4 (&fb)[4],
                                          Q32 qq) const {
    fetch32(fb, (g == 0 ? k : v) + r0 + 32 * st, DH, cl, true, qq);
  }

  // The raw operands of step st >= 2 into warpgroup g's ring slot by
  // cp.async, thread l a quarter of each block's 16-byte pieces: float32
  // A (dh, v or k: 64 rows of 32, rows past the chunk zero) into raw[0] in
  // the tiles' own swizzled layout (bf16 A goes through registers), and B
  // (C's or dC''s, always in range) into raw[1]: X and Y read 32 rows of
  // 64 columns (raw32t layout), Z 64 rows of 32 (the swizzled layout).
  __device__ __forceinline__ void copy_ab(int st, int g, Tile* raw,
                                          int l) const {
    if (st >= NST) return;
    if (!X) {
      const T* a = st < 2 + 2 * NC
                       ? (g == 0 ? dh : v) + 32 * (st - 2)
                       : k + 64 * (st - 2 - 2 * NC) + 32 * g;
      for (int u = l; u < 64 * 8; u += 128) {
        const int row = u >> 3, ch = u & 7;
        const bool ok = row < cl;
        cp_async16(reinterpret_cast<char*>(&raw[0]) + row * 128 +
                       ((ch ^ (row & 7)) << 4),
                   a + (size_t)(ok ? row : 0) * DH + 4 * ch, ok);
      }
    }
    if (st < 2 + 2 * NC) {
      const size_t at = (size_t)32 * (st - 2) * DH + r0;
      for (int u = l; u < 32 * 16; u += 128) {
        const int row = u >> 4, ch = u & 15;
        cp_async16(raw32t(&raw[1], row, ch),
                   (g == 0 ? C : dC) + at + (size_t)row * DH + 4 * ch, true);
      }
    } else {
      const size_t at =
          (size_t)r0 * DH + 64 * (st - 2 - 2 * NC) + 32 * g;
      for (int u = l; u < 64 * 8; u += 128) {
        const int row = u >> 3, ch = u & 7;
        cp_async16(reinterpret_cast<char*>(&raw[1]) + row * 128 +
                       ((ch ^ (row & 7)) << 4),
                   dC + at + (size_t)row * DH + 4 * ch, true);
      }
    }
  }

  // The thread's share of step st >= 2's raw B block (fb) and, for
  // float32, its A fragments (fa), from the ring slot.
  __device__ __forceinline__ void load_ab(int st, float (&fa)[16],
                                          float4 (&fb)[4], const Tile* raw,
                                          int fr, int t, Q32 qq) const {
    if (!X) {
      const char* base = reinterpret_cast<const char*>(&raw[0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = fr + 8 * (j & 1), col = 8 * kk + t + 4 * (j >> 1);
          fa[4 * kk + j] = reinterpret_cast<const float*>(
              base + row * 128 + (((col >> 2) ^ (row & 7)) << 4))[col & 3];
        }
    }
    if (st < 2 + 2 * NC) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fb[i] = *reinterpret_cast<const float4*>(
            raw32t(&raw[1], 4 * qq.ta + i, qq.tb));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row32(true, qq, i);
        fb[i] = *reinterpret_cast<const float4*>(
            reinterpret_cast<const char*>(&raw[1]) + row * 128 +
            ((qq.c ^ (row & 7)) << 4));
      }
    }
  }

  // Warpgroup g's B share of step st into its tiles b (big, small).
  __device__ __forceinline__ void put_b(int st, const float4 (&fb)[4],
                                        Tile* b, Q32 qq) const {
    if (st < 2)
      put32<X>(fb, b, true, qq);
    else
      put32<false>(fb, b, st >= 2 + 2 * NC, qq);
  }

  // Warpgroup g's product of step st (its A operand exact for bf16 q, v
  // and k, not for dnum; its B exact for k and v, not for C and dC').
  __device__ __forceinline__ void mma(int st, int g, float (&d)[32],
                                      const uint32_t (&ab)[4][4],
                                      const uint32_t (&as)[4][4],
                                      const Tile* b) const {
    if (st < 2) {
      if (g == 0)
        mma_rs<X, X>(d, ab, as, b);           // S: q, k
      else
        mma_rs<false, X>(d, ab, as, b);       // U: dnum, v
    } else if (st < 2 + 2 * NC) {
      if (g == 0)
        mma_rs<false, false>(d, ab, as, b);   // X: dnum, C^T
      else
        mma_rs<X, false>(d, ab, as, b);       // Y: v, dC'^T
    } else {
      mma_rs<X, false>(d, ab, as, b);         // Z0, Z1: k, dC'
    }
  }

  // Whether warpgroup g's A operand of step st is dnum (scaled by 1 / den).
  __device__ __forceinline__ bool a_is_dnum(int st, int g) const {
    return (st < 2 && g == 1) || (st >= 2 && st < 2 + 2 * NC && g == 0);
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_tc_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dh,
    const float* __restrict__ ig, const float* __restrict__ Cs,
    const float* __restrict__ ns, const float* __restrict__ mt,
    const float* __restrict__ dCs, const float* __restrict__ dns,
    const float* __restrict__ gt,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dig, float* __restrict__ dlf, int S,
    unsigned long long* __restrict__ prof) {
  constexpr int NC = DH / 64;                  // CTAs of a cluster
  using Steps = ChunkSteps<T, NC>;
  constexpr int NST = Steps::NST;
  constexpr bool X = Steps::X;
  extern __shared__ unsigned char smem_raw[];
  ChunkSmem& s = *reinterpret_cast<ChunkSmem*>(align1024(smem_raw));
  const int tid = threadIdx.x, g = tid >> 7, l = tid & 127;
  const int w = l >> 5, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x, r0 = 64 * r;       // rank, the CTA's slice
  const int kk = blockIdx.y, K = gridDim.y;
  const size_t bh = blockIdx.z;
  const int t0 = kk * kC, cl = min(kC, S - t0);
  const size_t at = bh * K + kk;
  const Quad qd = quad();
  const Q32 qq = q32(l);
  const int fr = 16 * w + (lane >> 2), fc = 2 * (lane & 3);
  const size_t off = (bh * S + t0) * DH;
  const Steps src{q + off, k + off, v + off, dh + off, Cs + at * DH * DH,
                  dCs + at * DH * DH, r0, cl};

  Lap lap(&s.clk, prof != nullptr && tid == 0);
  const int t4 = lane & 3;
  // the next step's operands in flight while this one is split and
  // multiplied: B's from the moment this step's B is in its tiles, A's
  // from the moment this step's fragments are split
  if (tid < kC) {
    s.nv[tid] = ns[at * DH + r0 + tid];
    s.dnv[tid] = dns[at * DH + r0 + tid];
  }
  const size_t rows = (size_t)gridDim.z * S;
  chunk_gates(s.g, ig + bh * S, mt + bh * S, gt + bh * S, rows,
              gt + kPlanes * rows + at, t0, cl);
  lap(0);
  float fa[16];
  float4 fb[4];
  src.fetch_b(0, g, fb, qq);
  src.fetch_a(0, g, fa, fr, t4);
  // the raw operands of steps 2 and 3, two steps ahead of their split, in
  // ring slots ops[p][4 + 2 g ..] (the B tiles take ops[p][2 g ..])
  src.copy_ab(2, g, &s.ops[0][4 + 2 * g], l);
  cp_commit();
  src.copy_ab(3, g, &s.ops[1][4 + 2 * g], l);
  cp_commit();

  float acc1[32], acc2[32], acc3[32];   // S or U; X or Y; Z0 or Z1
  float nqp[2] = {0.f, 0.f};  // n.q_t at rows fr, fr + 8 (warpgroup 0)
  float kdp[4] = {0.f, 0.f, 0.f, 0.f};  // k_j.dn' (warpgroup 0)
#pragma unroll
  for (int st = 0; st < NST; ++st) {
    Tile* b = &s.ops[st & 1][2 * g];
    Tile* raw = &s.ops[st & 1][4 + 2 * g];
    if (st >= 2) {            // step st's raw blocks are in the ring
      cp_wait<1>();
      bar_sync(1 + g, 128);
      src.load_ab(st, fa, fb, raw, fr, t4, qq);
    }
    if (st < 2 && g == 0) {   // n.q_t from q's fragments, k_j.dn' from k
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nqp[j & 1] = fmaf(fa[4 * kk + j],
                            s.nv[32 * st + 8 * kk + t4 + 4 * (j >> 1)],
                            nqp[j & 1]);
      const float* vec = s.dnv + 32 * st + 4 * qq.c;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kdp[i] += fb[i].x * vec[0] + fb[i].y * vec[1] + fb[i].z * vec[2] +
                  fb[i].w * vec[3];
    }
    // the B tiles while the previous product runs; its A fragments stay in
    // their registers until it is done
    src.put_b(st, fb, b, qq);
    if (st == 0) src.fetch_b(1, g, fb, qq);
    if (src.a_is_dnum(st, g)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) fa[j] *= s.g.rden[fr + 8 * (j & 1)];
    }
    fence_proxy_async();
    lap(2);
    bar_sync(1 + g, 128);     // the warpgroup's B tiles are in, its raw
    lap(3);                   // slot read
    if (st >= 2) {
      src.copy_ab(st + 2, g, raw, l);
      cp_commit();
    }
    wgmma_wait<0>();          // the previous product is done
    lap(5);
    uint32_t ab[4][4], as[4][4];
    split_frag(fa, ab, as);
    if (X || st + 1 < 2) src.fetch_a(st + 1, g, fa, fr, t4);
    if (st == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc1[x] = 0.f;
    }
    if (st == 2) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc2[x] = acc3[x] = 0.f;
    }
    if (st < 2)
      src.mma(st, g, acc1, ab, as, b);
    else if (st < 2 + 2 * NC)
      src.mma(st, g, acc2, ab, as, b);
    else
      src.mma(st, g, acc3, ab, as, b);
    lap(4);
    if (st == 1) {            // S and U are done: this CTA's partials
      wgmma_wait<0>();
      fence_regs(acc1);
      float* part = g == 0 ? s.xs : s.xu;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * jj + fc;
        *reinterpret_cast<float2*>(&part[fr * kC + j]) =
            make_float2(acc1[4 * jj], acc1[4 * jj + 1]);
        *reinterpret_cast<float2*>(&part[(fr + 8) * kC + j]) =
            make_float2(acc1[4 * jj + 2], acc1[4 * jj + 3]);
      }
      if (g == 0) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float x = nqp[hi];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          if (t4 == 0) s.rnq[fr + 8 * hi] = x;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = kdp[i];
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if ((lane >> 3) == 0) s.rkd[w & 1][row32(true, qq, i)] = x;
        }
      }
      cluster_arrive();       // the partials are in; read after the steps
    }
  }
  wgmma_wait<0>();
  cp_wait<0>();
  fence_regs(acc2);
  fence_regs(acc3);
  __syncthreads();
  // X, Y, Z0 and Z1 through shared memory, so that each warpgroup holds
  // its 32 columns of X, Y and Z = Z0 + Z1 for the steps after the exchange
  {
    float* xm = reinterpret_cast<float*>(&s.ops[0][0]);
    float* mine2 = xm + g * kC * kLdX;           // X (g 0) or Y (g 1)
    float* mine3 = xm + (2 + g) * kC * kLdX;     // Z0 or Z1
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * jj + fc;
      *reinterpret_cast<float2*>(&mine2[fr * kLdX + j]) =
          make_float2(acc2[4 * jj], acc2[4 * jj + 1]);
      *reinterpret_cast<float2*>(&mine2[(fr + 8) * kLdX + j]) =
          make_float2(acc2[4 * jj + 2], acc2[4 * jj + 3]);
      *reinterpret_cast<float2*>(&mine3[fr * kLdX + j]) =
          make_float2(acc3[4 * jj], acc3[4 * jj + 1]);
      *reinterpret_cast<float2*>(&mine3[(fr + 8) * kLdX + j]) =
          make_float2(acc3[4 * jj + 2], acc3[4 * jj + 3]);
    }
  }
  __syncthreads();
  float accX[16], accY[16], accZ[16];
  {
    const float* xm = reinterpret_cast<const float*>(&s.ops[0][0]);
#pragma unroll
    for (int kx = 0; kx < 16; ++kx) {
      const int row = fr + 8 * ((kx >> 1) & 1);
      const int col = 32 * g + 8 * (kx >> 2) + fc + (kx & 1);
      accX[kx] = xm[row * kLdX + col];
      accY[kx] = xm[kC * kLdX + row * kLdX + col];
      accZ[kx] = xm[2 * kC * kLdX + row * kLdX + col] +
                 xm[3 * kC * kLdX + row * kLdX + col];
    }
  }
  // the B operands of dS k, dS^T q and P^T dnum (the slice of k, q and dh,
  // transposed), and q and v at X's and Z's fragment positions (for dinter
  // and dw), all in flight through the exchange
  float4 ra[4], rb[4], rc[4];
  fetch(ra, src.k + r0, DH, cl, qd);
  fetch(rb, src.q + r0, DH, cl, qd);
  fetch(rc, src.dh + r0, DH, cl, qd);
  float qx[16], vz[16];
#pragma unroll
  for (int kx = 0; kx < 16; ++kx) {
    const int t = fr + 8 * ((kx >> 1) & 1);
    const int e = 32 * g + 8 * (kx >> 2) + fc + (kx & 1);
    const bool live = t < cl;
    qx[kx] = live ? ld1(src.q + (size_t)t * DH + r0 + e) : 0.f;
    vz[kx] = live ? ld1(src.v + (size_t)t * DH + r0 + e) : 0.f;
  }
  __syncthreads();            // every warpgroup has read X, Y, Z
  lap(1);

  // ---- S and U over the cluster: CTA r sums rows [RP r, RP r + RP) of
  // every CTA's partials in rank order and stores them into every CTA
  cluster_wait();
  {
    constexpr int RP = kC / NC, P4 = RP * kC / 4;
    for (int pos = tid; pos < 2 * P4; pos += kThreads) {
      const bool u = pos >= P4;
      const int idx = r * RP * kC + 4 * (pos - (u ? P4 : 0));
      const int row = idx / kC, col = idx % kC;
      const float* part = u ? s.xu : s.xs;
      float* sum_at = (u ? s.uf : s.sf) + row * kLdS + col;
      float4 x[NC];
#pragma unroll
      for (int rr = 0; rr < NC; ++rr)
        x[rr] = *reinterpret_cast<const float4*>(rank_ptr(&part[idx], rr));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < NC; ++rr) {
        sum.x += x[rr].x;
        sum.y += x[rr].y;
        sum.z += x[rr].z;
        sum.w += x[rr].w;
      }
#pragma unroll
      for (int rr = 0; rr < NC; ++rr)
        *reinterpret_cast<float4*>(rank_ptr(sum_at, rr)) = sum;
    }
  }
  cluster_arrive();
  cluster_wait();
  lap(6);

  // ---- P = S o D, dP = U + dqn, dS = dP o D, dlogD = dP o P (j <= t), a
  // 4 x 4 block a thread; dS, dS^T and P^T as split A operands
  Tile* const aq = &s.ops[0][0];    // dS [t][j]      (dq = dS k)
  Tile* const ak = &s.ops[0][4];    // dS^T [j][t]    (dk = dS^T q)
  Tile* const av = &s.ops[1][0];    // P^T [j][t]     (dv = P^T dnum)
  Tile* const bt = &s.ops[1][4];    // the B operand of each
  {
    float ds[4][4], p[4][4], colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * qd.a + i;
      const float4 sv = *reinterpret_cast<const float4*>(
          &s.sf[t * kLdS + 4 * qd.b]);
      const float4 uv = *reinterpret_cast<const float4*>(
          &s.uf[t * kLdS + 4 * qd.b]);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
      const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
      float rowp = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * qd.b + c;
        float pv = 0.f, dsv = 0.f, lv = 0.f;
        if (j <= t && t < cl) {
          const float D = expf(((s.g.bc[t] - s.g.bc[j]) + s.g.igs[j]) -
                               s.g.mts[t]);
          const float dP = ua[c] + s.g.dqn[t];
          pv = sa[c] * D;
          dsv = dP * D;
          lv = dP * pv;
        }
        p[i][c] = pv;
        ds[i][c] = dsv;
        rowp += lv;
        colp[c] += lv;
      }
      row_partial(rowp, s.rrow, t);
      st4<false>(make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]), aq, t,
                 qd.b);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = colp[c];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      if ((lane & 7) == 0) s.rcol[warp & 1][4 * qd.b + c] = x;
      const int j = 4 * qd.b + c;
      st4<false>(make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]), ak, j,
                 qd.a);
      st4<false>(make_float4(p[0][c], p[1][c], p[2][c], p[3][c]), av, j,
                 qd.a);
    }
  }
  // the B operand of dS k: k over the slice, transposed ([e][j])
  put<X>(ra, bt, qd);
  fence_proxy_async();
  __syncthreads();
  lap(7);
  if (tid < kC) {
    s.rows[tid] = s.rrow[0][tid] + s.rrow[1][tid] + s.rrow[2][tid] +
                  s.rrow[3][tid];
    s.cols[tid] = s.rcol[0][tid] + s.rcol[1][tid];
  }

  float acc[16];
  // dq = dS k + inter o (X + dqn n); X . q_t for dinter
  zero16(acc);
  mma<false, X>(acc, aq, bt, g);
  wgmma_wait<0>();
  fence_regs(acc);
  {
    float px[2] = {0.f, 0.f};
#pragma unroll
    for (int kx = 0; kx < 16; ++kx) {
      const int hi = (kx >> 1) & 1, t = fr + 8 * hi;
      const int e = 32 * g + 8 * (kx >> 2) + fc + (kx & 1);
      if (t < cl) {
        dq[off + (size_t)t * DH + r0 + e] =
            acc[kx] + s.g.inter[t] * (accX[kx] + s.g.dqn[t] * s.nv[e]);
        px[hi] = fmaf(accX[kx], qx[kx], px[hi]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float x = px[hi];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) s.rx[0][g][fr + 8 * hi] = x;
    }
  }
  __syncthreads();            // both warpgroups are done with bt
  // dk = dS^T q + w o (Y + dn')
  put<X>(rb, bt, qd);
  fence_proxy_async();
  __syncthreads();
  zero16(acc);
  mma<false, X>(acc, ak, bt, g);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kx = 0; kx < 16; ++kx) {
    const int j = fr + 8 * ((kx >> 1) & 1);
    const int e = 32 * g + 8 * (kx >> 2) + fc + (kx & 1);
    if (j < cl)
      dk[off + (size_t)j * DH + r0 + e] =
          acc[kx] + s.g.wk[j] * (accY[kx] + s.dnv[e]);
  }
  __syncthreads();
  // dv = P^T dnum + w o Z; v . Z_j for dw
  scale_rows(rc, qd, s.g.rden);
  put<false>(rc, bt, qd);
  fence_proxy_async();
  __syncthreads();
  zero16(acc);
  mma<false, false>(acc, av, bt, g);
  wgmma_wait<0>();
  fence_regs(acc);
  {
    float pz[2] = {0.f, 0.f};
#pragma unroll
    for (int kx = 0; kx < 16; ++kx) {
      const int hi = (kx >> 1) & 1, j = fr + 8 * hi;
      const int i = 32 * g + 8 * (kx >> 2) + fc + (kx & 1);
      if (j < cl) {
        dv[off + (size_t)j * DH + r0 + i] = acc[kx] + s.g.wk[j] * accZ[kx];
        pz[hi] = fmaf(vz[kx], accZ[kx], pz[hi]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float x = pz[hi];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((lane & 3) == 0) s.rx[1][g][fr + 8 * hi] = x;
    }
  }
  __syncthreads();
  lap(8);

  // ---- this CTA's gate partials, then rank 0 sums them in rank order
  if (tid < kC) {
    s.gx[tid] = s.rx[0][0][tid] + s.rx[0][1][tid];
    s.gx[kC + tid] = s.rx[1][0][tid] + s.rx[1][1][tid];
    s.gx[2 * kC + tid] = s.rnq[tid];
    s.gx[3 * kC + tid] = s.rkd[0][tid] + s.rkd[1][tid];
  } else if (tid == kC) {   // <C, dC'> over the rows r0.. (the sweep's)
    float dc = gt[kPlanes * rows + gridDim.z * K + at * NC + r];
    for (int e = 0; e < kC; ++e) dc = fmaf(s.dnv[e], s.nv[e], dc);
    s.gx[4 * kC] = dc;
  }
  cluster_arrive();
  cluster_wait();
  if (r == 0) {
    const float carry = s.g.scal[0];
    if (tid < kC) {
      float part[4][NC];
#pragma unroll
      for (int rr = 0; rr < NC; ++rr)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u][rr] = *rank_ptr(&s.gx[u * kC + tid], rr);
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < NC; ++rr)
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[u] += part[u][rr];
      float gwt = 0.f, dbt = 0.f;
      if (tid < cl) {
        const float di = sum[0] + s.g.dqn[tid] * sum[2];
        const float dw = sum[1] + sum[3];
        gwt = dw * s.g.wk[tid];
        dbt = s.rows[tid] - s.cols[tid] + di * s.g.inter[tid] - gwt;
        dig[bh * S + t0 + tid] = s.cols[tid] + gwt;
      }
      s.gw[tid] = gwt;
      s.db[tid] = dbt;
    }
    __syncthreads();
    if (tid < 32) {             // a warp, two steps a lane
      float dcr[NC];
#pragma unroll
      for (int rr = 0; rr < NC; ++rr) dcr[rr] = *rank_ptr(&s.gx[4 * kC], rr);
      float dc = 0.f;
#pragma unroll
      for (int rr = 0; rr < NC; ++rr) dc += dcr[rr];
      const int ta = 2 * tid, tb = ta + 1;
      float sg = s.gw[ta] + s.gw[tb];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sg += __shfl_xor_sync(0xffffffffu, sg, o);
      float da = s.db[ta], dbb = s.db[tb];
      if (ta == cl - 1) da += sg + dc * carry;
      if (tb == cl - 1) dbb += sg + dc * carry;
      // dlf: db's reverse cumsum within the chunk (0 past its end)
      float inc = da + dbb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, inc, o);
        if (tid + o < 32) inc = inc + y;
      }
      float exc = __shfl_down_sync(0xffffffffu, inc, 1);
      if (tid == 31) exc = 0.f;
      const float lb = dbb + exc, la = da + lb;
      if (ta < cl) dlf[bh * S + t0 + ta] = la;
      if (tb < cl) dlf[bh * S + t0 + tb] = lb;
    }
  }
  cluster_arrive();           // no CTA leaves while rank 0 reads its gx
  cluster_wait();
  lap(9);
  lap.flush(prof, kChunkPhases);
}

constexpr size_t kSweepSmem = sizeof(SweepSmem) + 1024;   // + alignment
constexpr size_t kChunkSmem = sizeof(ChunkSmem) + 1024;

template <typename T, int DH>
cudaLaunchConfig_t chunk_config(int B, int NH, int S, cudaStream_t st,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DH / 64, (S + kC - 1) / kC, B * NH);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kChunkSmem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DH / 64;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DH>
cudaError_t opt_in() {
  static cudaError_t done = cudaErrorNotReady;
  if (done != cudaSuccess) {
    done = cudaFuncSetAttribute(mlstm_bwd_tc_sweep_kernel<T, DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSweepSmem);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(mlstm_bwd_tc_chunk_kernel<T, DH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kChunkSmem);
  }
  return done;
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, const float* ig,
           const float* lf, const T* h, const T* dh, const float* Cs,
           const float* ns, const float* ms, const float* mt,
           const float* qn, float* dq, float* dk, float* dv, float* dig,
           float* dlf, float* dCs, float* dns, float* gt, int B, int NH,
           int S, unsigned long long* prof, cudaStream_t st) {
  cudaError_t err = opt_in<T, DH>();
  if (err != cudaSuccess) return (int)err;
  const int K = (S + kC - 1) / kC;
  mlstm_bwd_tc_gates_kernel<T>
      <<<dim3(K, B * NH, kGateParts), kThreads, 0, st>>>(
      h, dh, ig, lf, ms, mt, qn, gt, S, DH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_tc_sweep_kernel<T, DH>
      <<<dim3(DH / 64, NH, B), kThreads, kSweepSmem, st>>>(
          q, dh, ig, mt, Cs, gt, dCs, dns, S, prof);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = chunk_config<T, DH>(B, NH, S, st, attr);
  err = cudaLaunchKernelEx(&cfg, mlstm_bwd_tc_chunk_kernel<T, DH>, q, k, v,
                           dh, ig, Cs, ns, mt, (const float*)dCs,
                           (const float*)dns, (const float*)gt, dq, dk, dv,
                           dig, dlf, S,
                           prof != nullptr ? prof + kSweepPhases : nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v,
             const float* ig, const float* lf, const void* h,
             const void* dh, const float* Cs, const float* ns,
             const float* ms, const float* mt, const float* qn, float* dq,
             float* dk, float* dv, float* dig, float* dlf, float* dCs,
             float* dns, float* gt, int B, int NH, int S,
             unsigned long long* prof, cudaStream_t st) {
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
          *th = (const T*)h, *tdh = (const T*)dh;
  switch (Dh) {
    case 64:
      return launch<T, 64>(tq, tk, tv, ig, lf, th, tdh, Cs, ns, ms, mt, qn,
                           dq, dk, dv, dig, dlf, dCs, dns, gt, B, NH, S,
                           prof, st);
    case 128:
      return launch<T, 128>(tq, tk, tv, ig, lf, th, tdh, Cs, ns, ms, mt, qn,
                            dq, dk, dv, dig, dlf, dCs, dns, gt, B, NH, S,
                            prof, st);
    case 256:
      return launch<T, 256>(tq, tk, tv, ig, lf, th, tdh, Cs, ns, ms, mt, qn,
                            dq, dk, dv, dig, dlf, dCs, dns, gt, B, NH, S,
                            prof, st);
    case 512:
      return launch<T, 512>(tq, tk, tv, ig, lf, th, tdh, Cs, ns, ms, mt, qn,
                            dq, dk, dv, dig, dlf, dCs, dns, gt, B, NH, S,
                            prof, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mlstm_bwd_tc

// q, k, v, h, dh: [B, NH, S, Dh] float32 or bf16 (dtype code), contiguous
// and 16-byte aligned; ig, lf, mt, qn: [B, NH, S] float32; Cs [B, NH, K,
// Dh, Dh], ns [B, NH, K, Dh], ms [B, NH, K] float32 with K = ceil(S / 64)
// (the forward kernels' state output); dq, dk, dv: [B, NH, S, Dh]
// float32; dig, dlf: [B, NH, S] float32; dCs, dns: scratch shaped as Cs
// and ns (the carried cotangents, written by the sweep); gt: scratch of
// 5 B NH S + B NH K (1 + Dh / 64) floats (the gates kernel's planes and
// carries, the sweep's shares of <C, dC'>). Dh in {64, 128, 256, 512},
// S >= 1. prof: null, or kSweepPhases + kChunkPhases uint64 counters that
// thread 0 of every CTA adds the clock64() cycles of its phases to (the
// lists at kSweepPhases).
// Returns the launches' CUDA error (0 on success).
extern "C" int mlstm_chunked_bwd_tc(int dtype, const void* q, const void* k,
                                    const void* v, const void* ig,
                                    const void* lf, const void* h,
                                    const void* dh, const void* Cs,
                                    const void* ns, const void* ms,
                                    const void* mt, const void* qn, void* dq,
                                    void* dk, void* dv, void* dig, void* dlf,
                                    void* dCs, void* dns, void* gt, int B,
                                    int NH, int S, int Dh, void* prof,
                                    void* stream) {
  using namespace mlstm_bwd_tc;
  if (S < 1 || B < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *g = (const float*)ig, *f = (const float*)lf;
  const float *cs = (const float*)Cs, *nn = (const float*)ns,
              *mm = (const float*)ms, *tt = (const float*)mt,
              *qq = (const float*)qn;
  float *oq = (float*)dq, *ok = (float*)dk, *ov = (float*)dv,
        *oi = (float*)dig, *of = (float*)dlf, *sc = (float*)dCs,
        *sn = (float*)dns, *sd = (float*)gt;
  unsigned long long* pr = (unsigned long long*)prof;
  if (dtype == kF32)
    return dispatch<float>(Dh, q, k, v, g, f, h, dh, cs, nn, mm, tt, qq, oq,
                           ok, ov, oi, of, sc, sn, sd, B, NH, S, pr, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, g, f, h, dh, cs, nn, mm, tt,
                                   qq, oq, ok, ov, oi, of, sc, sn, sd, B, NH,
                                   S, pr, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a sweep (which 0) or chunk (which 1) CTA.
extern "C" int mlstm_chunked_bwd_tc_smem(int which) {
  return (int)(which == 0 ? mlstm_bwd_tc::kSweepSmem
                          : mlstm_bwd_tc::kChunkSmem);
}

// cudaOccupancyMaxActiveClusters of the chunk kernel at Dh 512 (the
// training path's width) for the given dtype and shape; a negative value
// is a CUDA error.
extern "C" int mlstm_chunked_bwd_tc_clusters(int dtype, int B, int NH,
                                             int S) {
  using namespace mlstm_bwd_tc;
  cudaLaunchAttribute attr[1];
  int n = 0;
  cudaError_t err;
  if (dtype == kF32) {
    err = opt_in<float, 512>();
    if (err != cudaSuccess) return -(int)err;
    const cudaLaunchConfig_t cfg = chunk_config<float, 512>(B, NH, S, 0, attr);
    err = cudaOccupancyMaxActiveClusters(
        &n, mlstm_bwd_tc_chunk_kernel<float, 512>, &cfg);
  } else {
    err = opt_in<__nv_bfloat16, 512>();
    if (err != cudaSuccess) return -(int)err;
    const cudaLaunchConfig_t cfg =
        chunk_config<__nv_bfloat16, 512>(B, NH, S, 0, attr);
    err = cudaOccupancyMaxActiveClusters(
        &n, mlstm_bwd_tc_chunk_kernel<__nv_bfloat16, 512>, &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}
