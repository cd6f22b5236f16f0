// Chunkwise stabilized mLSTM (xLSTM) on Hopper's tensor cores (sm_90a):
// 3xTF32 wgmma products, S = q k^T shared across a thread-block cluster.
// The kernel, shared by two libraries: mlstm_chunked_tc.cu instantiates it
// without the state writes (serving, and the route's launch checks),
// mlstm_chunked_tc_save.cu with them (the training path's forward), each
// in its own nvcc process so the two builds run side by side.
//
// Replaces the TPU kernel repro/kernels/mlstm.py :: mlstm_chunked (body
// _kernel) at head widths DH in {64, 128, 256, 512} (xlstm-350m's prefill
// runs DH 512); mlstm_chunked.cu keeps the other widths as the "simt"
// route. The function is that kernel's, exactly as mlstm_chunked.cu states
// it: for q, k, v [B, NH, S, DH] (k pre-scaled) and gates ig, lf [B, NH, S]
// it returns h [B, NH, S, DH] in q's dtype and the float32 final state
// C [B, NH, DH, DH], n [B, NH, DH], m [B, NH]; chunks of 64 steps, the
// last one masked; the optional initial state; exp() of a masked (j > t)
// entry never taken.
//
// What bounds it on an H100: operations. At the prefill's shape (B 8,
// NH 4, S 512, DH 512, float32, fresh state) the function needs 18.3
// GFLOP (4 S DH^2 a (b, h) for C q and the C update, 4 DH a causal pair
// for q.k and P v) against 202 MB: 0.27 ms at float32's 67 TFLOP/s on
// the CUDA cores, 0.11 ms at 3xTF32's 495 / 3 TFLOP/s on the tensor cores.
//
// Numerics: 3xTF32. Every float32 operand x of a product is split with
// round-to-nearest into tf32 parts big = rna(x) and small = rna(x - big),
// and the product is small.big + big.small + big.big, accumulated in
// float32 by wgmma: the error is at float32's own level (one tf32 pass is
// a thousand times worse). A bf16 operand is exact in tf32, its small part
// is 0 and its passes are dropped: S = q k^T is one pass for bf16 inputs,
// C q, P v and the update two. Gates, scans, P = S o D, den and h are
// float32 on the CUDA cores. The split, the swizzled stores and the tf32
// wgmmas are hopper.cuh's, shared with the float32 flash kernels.
//
// The design:
//   * A cluster of DH / 64 CTAs (the portable eight at DH 512) serves one
//     (b, h): CTA r owns rows [64 r, 64 r + 64) of C (the v dimension) and
//     the slice [64 r, 64 r + 64) of e (the key dimension) for S, q.n and
//     n. Each CTA computes S and q.n over its e slice only, and the
//     partials are summed through distributed shared memory: after a
//     cluster barrier, CTA r sums rows [64 r / NC, ...) of every CTA's
//     partial in rank order and stores them into every CTA (a
//     reduce-scatter, then an all-gather), and a second barrier publishes
//     the sum; C q's products run between A1 and the first. No CTA
//     recomputes another's S. The cost is occupancy: one CTA fits an SM
//     (the registers below) and the H100 holds 15 clusters of eight (120
//     CTAs; clusters of four, tried, also held only 120), so the
//     prefill's 256 CTAs run in three waves where 132 SMs would take two
//     (cudaOccupancyMaxActiveClusters, chip_smoke.py).
//   * C never leaves the registers. Two consumer warpgroups own the CTA's
//     64 x DH slice of C, each every other 32-wide slab of e (DH / 2
//     columns) as wgmma accumulators
//     (64 x 32 tiles, DH / 4 registers a thread). The update C = carry C +
//     v^T (w o k) accumulates into them; C q uses them as the register A
//     operand, split into big and small on the fly. Why: the SIMT kernel's
//     phase split (clock64, chip_smoke.py) puts 82% of its time in the two
//     products that touch C (S with C q 55%, the update 33%); C as big and
//     small halves in shared memory would take 256 KB at DH 512, over the
//     227 KB a CTA may have, and 32 rows a CTA in a 16-CTA cluster would
//     leave half of every 64-row wgmma empty. In registers C costs no
//     shared memory and no traffic; the price is one CTA an SM (up to 255
//     registers a thread), so the path's 32 clusters of 8 run in three
//     waves of at most 15.
//   * Operand layouts: tf32 wgmma reads both operands K-major. S = q k^T
//     and C q contract over e and read q and k as stored; P v and the
//     update contract over time j, so v and k go in time-minor (v^T, and
//     (w o k)^T with w folded in). The pass that splits big from small
//     writes each operand into its 128-byte-swizzled tile, transposed
//     where needed. A register-A fragment holds accumulator columns
//     (2t, 2t + 1) of each 8-column block in k slots (t, t + 4), so q and
//     k are stored with e permuted inside each 8-group to match.
//   * q, k and v come in as [64 x 32] slabs, two adjacent ones at a time,
//     through an 8-slot ring that runs a step ahead across chunks: the
//     next step's and the next chunk's tiles load while this one
//     computes. Every thread copies its share with cp.async (16 bytes
//     each); the barrier each step already has publishes them. A TMA
//     ring was tried first: its one issuing thread stalled on every box
//     and held both warpgroups at the next barrier. The copies' issue
//     still stalls about as long (chip_smoke.py's phase split), and two
//     steps ahead instead of one changed nothing: what it waits for is
//     not known yet.
//   * The chunk's cumsum of lf and running max are warp scans (one warp,
//     two steps a lane).
//   * h = (inter C q + P v) / den: each warpgroup finishes 32 of the
//     chunk's 64 steps, with the other warpgroup's half of C q through
//     shared memory.
//   * Saved states: the kSave instantiation (mlstm_chunked_tc_save.cu, the
//     training path's forward, ops._MlstmChunkedAD) also writes what the
//     backward (mlstm_chunked_bwd.cu) needs: each chunk's starting C (from
//     the registers, as the final state is written), n and m, and every
//     step's m_t and signed qn_t, whose magnitude den_t takes. Serving
//     runs the instantiation without the stores, the code it ran before
//     they existed; h and the final state are the same bitwise either
//     way.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace mlstm_tc {

using namespace hopper;

enum DType { kF32 = 0, kBF16 = 1 };   // dtype codes shared with ops.py
constexpr int kC = 64;          // time steps per chunk
constexpr int kW = 32;          // e-slab width: one 128-byte row of tf32
constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kRing = 8;        // raw-slab slots
constexpr int kAhead = 1;       // load steps in flight beyond the next
constexpr int kA1Loads = 6;     // q, k slices of e for S; v's 64 columns
constexpr float kMInit = -1e30f;
// Phase clocks (thread 0's clock64() between the points it passes, summed
// over chunks): 0 gates; A1: 1 start, 2 operands, q.n and n, 3 S and the
// partials; A2 steps: 4 start (the last step's products retiring), 5
// split, 6 barrier, 14 product issue, 15 copy issue; 7 A2's end; 8 the S
// exchange and P; 9 P v and h; B steps: 10 start, 11 split, 12 barrier,
// 13 product issue, 16 copy issue; 17 B's end; 18 the whole launch.
constexpr int kProfPhases = 19;

// Where the training path's forward saves the states the backward takes
// (all null for serving): C [B, NH, K, DH, DH], n [B, NH, K, DH], m
// [B, NH, K] at the start of each of the K chunks; m_t, qn [B, NH, S].
struct Saved {
  float *C, *n, *m, *mt, *qn;
};

// A [64 rows][32] tf32 operand tile, 128-byte swizzled (8 KB).
struct alignas(1024) Tile { float x[64 * kW]; };
// A [32 rows][32] tf32 operand tile (4 KB).
struct alignas(1024) Half { float x[32 * kW]; };

struct Smem {
  Tile ring[kRing];     // raw [64][32] slabs of q, k or v (T; bf16 uses half)
  // 8 tiles, by phase: A1 q big 0-1, q small 2-3, k big 4-5, k small 6-7;
  // A2 warpgroup g, buffer p: q big 4g + 2p, small 4g + 2p + 1;
  // P: P big 0-1, P small 2-3, C q halves 4 (warpgroup 0's), 5 (1's);
  // B warpgroup g, buffer p: (w o k)^T as Halves 8(2g + p) + {0, 1} big,
  // + {2, 3} small
  Tile ops[8];
  Tile vt[4];           // v^T [64 i][64 j]: big 0-1, small 2-3
  float xs[kC * kC];    // this CTA's S partial [t][j]
  float sf[kC * kC];    // S summed over the cluster
  float xqn[kC], qf[kC];   // q.n: this CTA's partial, the cluster's sum
  float igs[kC], bcs[kC], mts[kC], inter[kC], wks[kC], den[kC];
  float nown[kC];       // n over the CTA's e slice
  float scal[4];        // m carried between chunks, carry, m_out
  long long clk[kProfPhases];   // thread 0's phase clocks, when timed
};

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

// Eight consecutive elements of a raw slab row, as float.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Row `row`, 8-group `grp` of a raw [64][32] slab into operand tiles with
// e permuted inside the group: k slots 0-3 take e = 0, 2, 4, 6 and slots
// 4-7 take e = 1, 3, 5, 7 (the register-A fragment's order). `kExact`
// inputs (bf16) have no small part.
template <bool kExact, typename T>
__device__ __forceinline__ void put_perm(const T* raw, int row, int grp,
                                         Tile& big, Tile& small) {
  float x[8];
  load8(raw + row * kW + 8 * grp, x);
  if (kExact) {
    st_chunk(&big, row, 2 * grp, make_float4(x[0], x[2], x[4], x[6]));
    st_chunk(&big, row, 2 * grp + 1, make_float4(x[1], x[3], x[5], x[7]));
    return;
  }
  float b[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) tf32_split(x[i], b[i], s[i]);
  st_chunk(&big, row, 2 * grp, make_float4(b[0], b[2], b[4], b[6]));
  st_chunk(&big, row, 2 * grp + 1, make_float4(b[1], b[3], b[5], b[7]));
  st_chunk(&small, row, 2 * grp, make_float4(s[0], s[2], s[4], s[6]));
  st_chunk(&small, row, 2 * grp + 1, make_float4(s[1], s[3], s[5], s[7]));
}

// Four values as the big (and small) chunk c of row `row`.
template <bool kExact>
__device__ __forceinline__ void put4(float a, float b, float c, float d,
                                     void* big, void* small, int row,
                                     int chunk) {
  if (kExact) {
    st_chunk(big, row, chunk, make_float4(a, b, c, d));
    return;
  }
  float4 hi, lo;
  tf32_split4(make_float4(a, b, c, d), hi, lo);
  st_chunk(big, row, chunk, hi);
  st_chunk(small, row, chunk, lo);
}

// ------------------------------------------------- cluster (DSMEM)
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster4(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(a), "f"(v)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -------------------------------------------------------------- kernel
template <typename T, int DH>
struct Cfg {
  static constexpr int NC = DH / 64;        // CTAs of a cluster
  static constexpr int NS = DH / kW;        // 32-wide e slabs
  static constexpr int NSW = NS / 2;        // slabs a warpgroup owns
  static constexpr int L = kA1Loads + 2 * NS;   // slab loads a chunk
  static constexpr int NT = 1 + 2 * NSW;    // load steps a chunk
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowChunks = kW * (int)sizeof(T) / 16;  // a row
};

// The inputs of one CTA, for its loads.
template <typename T>
struct Src {
  const T *q, *k, *v;
  int S, bh, r;       // sequence, (b, h), rank in the cluster
};

// Slabs lam and lam + 1 (lam even) of the CTA's load sequence, into
// ring slots lam % kRing and (lam + 1) % kRing: 64 adjacent columns, so
// each row is one 256-byte (bf16: 128-byte) piece of global memory. Per
// chunk: q and k over the CTA's e slice (slabs 2r, 2r + 1), v's columns
// [64 r, 64 r + 64), then q's slabs in order (warpgroup g takes slab
// 2s + g at step s), then k's. Every thread copies its share of 16-byte
// pieces; rows past S read as zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_pair(Smem& s, const Src<T>& src,
                                          int lam) {
  using C = Cfg<T, DH>;
  const int ci = lam / C::L, li = lam % C::L;
  const T* base;
  int col;
  if (li < kA1Loads) {
    base = li < 2 ? src.q : li < 4 ? src.k : src.v;
    col = 64 * src.r;
  } else {
    int m = li - kA1Loads;
    base = src.q;
    if (m >= C::NS) {
      m -= C::NS;
      base = src.k;
    }
    col = kW * m;
  }
  const int t0 = ci * kC;
  constexpr int RC = C::kRowChunks;
  for (int c = threadIdx.x; c < kC * 2 * RC; c += kThreads) {
    const int row = c / (2 * RC), part = c % (2 * RC);
    const bool valid = t0 + row < src.S;
    const T* g = base + ((size_t)src.bh * src.S + (valid ? t0 + row : t0)) *
                            DH + col;
    char* dst = reinterpret_cast<char*>(
        s.ring[(lam + part / RC) % kRing].x);
    cp_async16(dst + (row * RC + part % RC) * 16,
               reinterpret_cast<const char*>(g) + part * 16, valid);
  }
}

// Load step `st` (of NT a chunk): A1's three pairs of slabs, or an A2 or
// B step's one; one copy group a step, empty past the last. At most eight
// slabs are in the ring at once (this step's and the next's).
template <typename T, int DH>
__device__ __forceinline__ void load_step(Smem& s, const Src<T>& src,
                                          int st, int nchunks) {
  using C = Cfg<T, DH>;
  const int ci = st / C::NT, sl = st % C::NT;
  if (ci < nchunks) {
    const int lam = ci * C::L + (sl == 0 ? 0 : kA1Loads + 2 * (sl - 1));
    const int n = sl == 0 ? kA1Loads / 2 : 1;
    for (int i = 0; i < n; ++i) load_pair<T, DH>(s, src, lam + 2 * i);
  }
  cp_commit();
}

template <typename T>
__device__ __forceinline__ const T* slab(Smem& s, int lam) {
  return reinterpret_cast<const T*>(s.ring[lam % kRing].x);
}

template <typename T, int DH, bool kSave>
__global__ void __launch_bounds__(kThreads, 1) mlstm_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ lf, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    T* __restrict__ h, float* __restrict__ Cout, float* __restrict__ nout,
    float* __restrict__ mout, int S, const Saved sv,
    unsigned long long* __restrict__ prof) {
  using C = Cfg<T, DH>;
  constexpr int NSW = C::NSW;
  constexpr bool X = C::kExact;
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int tid = threadIdx.x, g = tid >> 7, l = tid & 127;
  const int w = l >> 5, lane = tid & 31;
  const int r = blockIdx.x;                 // rank in the cluster
  const int r0 = 64 * r;                    // the CTA's rows of C and e
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int nchunks = (S + kC - 1) / kC;
  const Src<T> in{q, k, v, S, bh, r};
  const float* igb = ig + (size_t)bh * S;
  const float* lfb = lf + (size_t)bh * S;
  // accumulator fragment coordinates: rows fr, fr + 8; columns fc, fc + 1
  // of each 8-column block
  const int fr = 16 * w + (lane >> 2), fc = 2 * (lane & 3);

  // warp 0 holds the gates of the chunk it scans next: steps 2 lane and
  // 2 lane + 1, loaded a chunk ahead
  float gf[2] = {0.f, 0.f}, gi[2] = {0.f, 0.f};
  if (tid < 32)
    for (int u = 0; u < 2; ++u)
      if (2 * lane + u < S) {
        gf[u] = lfb[2 * lane + u];
        gi[u] = igb[2 * lane + u];
      }
  const bool timed = prof != nullptr && tid == 0;
  long long tick = 0;
  if (timed) {
    for (int i = 0; i < kProfPhases; ++i) s.clk[i] = 0;
    tick = clock64();
  }
  const long long start = tick;
  auto lap = [&](int phase) {
    if (timed) {
      const long long now = clock64();
      s.clk[phase] += now - tick;
      tick = now;
    }
  };
  for (int st = 0; st <= kAhead; ++st)
    load_step<T, DH>(s, in, st, nchunks);
  // C: warpgroup g owns the 32-wide e slabs 2 sl + g, sl < NSW
  float c[NSW][16];
#pragma unroll
  for (int sl = 0; sl < NSW; ++sl)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = r0 + fr + 8 * ((k >> 1) & 1);
      const int e = kW * (2 * sl + g) + 8 * (k >> 2) + fc + (k & 1);
      c[sl][k] = C0 != nullptr ? C0[((size_t)bh * DH + i) * DH + e] : 0.f;
    }
  if (tid < kC)
    s.nown[tid] = n0 != nullptr ? n0[(size_t)bh * DH + r0 + tid] : 0.f;
  if (tid == 0) s.scal[0] = m0 != nullptr ? m0[bh] : kMInit;
  cp_wait<kAhead>();            // step 0's copies are in
  __syncthreads();

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kC, cl = min(kC, S - t0);
    const int lam0 = ci * C::L, st0 = ci * C::NT;
    if (kSave) {                // the chunk's starting C and n
      const size_t at = (size_t)bh * nchunks + ci;
#pragma unroll
      for (int sl = 0; sl < NSW; ++sl)
#pragma unroll
        for (int k = 0; k < 16; k += 2) {
          const int i = r0 + fr + 8 * ((k >> 1) & 1);
          const int e = kW * (2 * sl + g) + 8 * (k >> 2) + fc;
          *reinterpret_cast<float2*>(&sv.C[(at * DH + i) * DH + e]) =
              make_float2(c[sl][k], c[sl][k + 1]);
        }
      if (tid < kC) sv.n[at * DH + r0 + tid] = s.nown[tid];
    }

    // ---- gates: warp scans of the cumsum and the running max
    if (tid < 32) {
      const float m_in = s.scal[0];
      if (kSave && r == 0 && lane == 0)
        sv.m[(size_t)bh * nchunks + ci] = m_in;
      const int ta = 2 * lane, tb = ta + 1;
      const bool va = ta < cl, vb = tb < cl;
      const float fa = gf[0], fb = gf[1], ia = gi[0], ib = gi[1];
#pragma unroll
      for (int u = 0; u < 2; ++u) {         // the next chunk's gates
        const int t = t0 + kC + 2 * lane + u;
        gf[u] = t < S ? lfb[t] : 0.f;
        gi[u] = t < S ? igb[t] : 0.f;
      }
      float inc = fa + fb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc = y + inc;
      }
      float exc = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) exc = 0.f;
      const float ba = exc + fa, bb = ba + fb;
      const float aa = va ? ia - ba : -INFINITY, ab = vb ? ib - bb : -INFINITY;
      float mx = fmaxf(aa, ab);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, mx, o);
        if (lane >= o) mx = fmaxf(y, mx);
      }
      float mex = __shfl_up_sync(0xffffffffu, mx, 1);
      if (lane == 0) mex = -INFINITY;
      const float Ma = fmaxf(mex, aa), Mb = fmaxf(Ma, ab);
      const float mta = ba + fmaxf(m_in, Ma), mtb = bb + fmaxf(m_in, Mb);
      const int last = cl - 1;
      const float m_out = __shfl_sync(0xffffffffu, (last & 1) ? mtb : mta,
                                      last >> 1);
      const float b_last = __shfl_sync(0xffffffffu, (last & 1) ? bb : ba,
                                       last >> 1);
      s.bcs[ta] = ba; s.bcs[tb] = bb;
      s.igs[ta] = ia; s.igs[tb] = ib;
      s.mts[ta] = mta; s.mts[tb] = mtb;
      s.inter[ta] = va ? expf((m_in + ba) - mta) : 0.f;
      s.inter[tb] = vb ? expf((m_in + bb) - mtb) : 0.f;
      s.wks[ta] = va ? expf(((b_last - ba) + ia) - m_out) : 0.f;
      s.wks[tb] = vb ? expf(((b_last - bb) + ib) - m_out) : 0.f;
      if (lane == 0) {
        s.scal[1] = expf((m_in + b_last) - m_out);
        s.scal[2] = m_out;
      }
    }
    __syncthreads();
    lap(0);
    const float carry = s.scal[1];

    // ---- A1: q and k over the CTA's e slice, v^T; q.n and n
    {
      const T* rq0 = slab<T>(s, lam0);
      const T* rq1 = slab<T>(s, lam0 + 1);
      const T* rk0 = slab<T>(s, lam0 + 2);
      const T* rk1 = slab<T>(s, lam0 + 3);
      const T* rv0 = slab<T>(s, lam0 + 4);
      const T* rv1 = slab<T>(s, lam0 + 5);
      lap(1);
      {                                     // (row, group) units of a slab
        const int row = tid >> 2, grp = tid & 3;
        put_perm<X>(rq0, row, grp, s.ops[0], s.ops[2]);
        put_perm<X>(rq1, row, grp, s.ops[1], s.ops[3]);
        put_perm<X>(rk0, row, grp, s.ops[4], s.ops[6]);
        put_perm<X>(rk1, row, grp, s.ops[5], s.ops[7]);
      }
#pragma unroll
      for (int it = 0; it < 4; ++it) {      // v^T: 64 i x 16 chunks of j
        const int i = tid & 63, jc = (tid >> 6) + 4 * it;
        const T* src = (i < 32 ? rv0 : rv1) + (i & 31);
        put4<X>(to_f(src[(4 * jc) * kW]), to_f(src[(4 * jc + 1) * kW]),
                to_f(src[(4 * jc + 2) * kW]), to_f(src[(4 * jc + 3) * kW]),
                &s.vt[jc >> 3], &s.vt[2 + (jc >> 3)], i, jc & 7);
      }
      {                                     // q.n over the e slice
        const int t = tid >> 2, e0 = 16 * (tid & 3);
        const T* src = (e0 < 32 ? rq0 : rq1) + t * kW + (e0 & 31);
        float qn = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          qn = fmaf(to_f(src[e]), s.nown[e0 + e], qn);
        qn += __shfl_xor_sync(0xffffffffu, qn, 1);
        qn += __shfl_xor_sync(0xffffffffu, qn, 2);
        if ((tid & 3) == 0) s.xqn[t] = qn;
      }
      float nnew;
      {                                     // n = carry n + sum_j w_j k_j
        const int e = tid >> 2, j0 = 16 * (tid & 3);
        const T* src = (e < 32 ? rk0 : rk1) + j0 * kW + (e & 31);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          acc = fmaf(s.wks[j0 + j], to_f(src[j * kW]), acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        nnew = carry * s.nown[e] + acc;
      }
      lap(2);
      cp_wait<kAhead - 1>();    // the next step's copies are in
      fence_proxy_async();
      __syncthreads();
      load_step<T, DH>(s, in, st0 + kAhead + 1, nchunks);
      if ((tid & 3) == 0) s.nown[tid >> 2] = nnew;

      // this CTA's S partial: warpgroup g takes the keys [32 g, 32 g + 32)
      float sp[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) sp[k] = 0.f;
      wgmma_fence();
      tf32x3_k64_n32<X, X>(sp, &s.ops[0], &s.ops[1], &s.ops[2], &s.ops[3],
                         &s.ops[4], &s.ops[5], &s.ops[6], &s.ops[7], 32 * g);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sp);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 32 * g + 8 * jj + fc;
        *reinterpret_cast<float2*>(&s.xs[fr * kC + j]) =
            make_float2(sp[4 * jj], sp[4 * jj + 1]);
        *reinterpret_cast<float2*>(&s.xs[(fr + 8) * kC + j]) =
            make_float2(sp[4 * jj + 2], sp[4 * jj + 3]);
      }
      cluster_arrive();
      __syncthreads();          // both S products are done with the tiles
      lap(3);
    }

    // ---- A2: C q, C as the register A operand, q streamed by slab
    float cq[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) cq[k] = 0.f;
#pragma unroll
    for (int sl = 0; sl < NSW; ++sl) {
      const T* raw = slab<T>(s, lam0 + kA1Loads + 2 * sl + g);
      lap(4);
      Tile& big = s.ops[4 * g + 2 * (sl & 1)];
      Tile& sml = s.ops[4 * g + 2 * (sl & 1) + 1];
#pragma unroll
      for (int it = 0; it < 2; ++it) {      // 256 (row, group) units
        const int u = l + 128 * it;
        put_perm<X>(raw, u >> 2, u & 3, big, sml);
      }
      lap(5);
      cp_wait<kAhead - 1>();
      fence_proxy_async();
      __syncthreads();
      lap(6);
      // two k steps at a time: their A fragments are 16 registers
#pragma unroll
      for (int k2 = 0; k2 < 4; k2 += 2) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          tf32_frag(c[sl], k2 + kk, ab[kk], as[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t db = desc_sw128(&big) + 2 * (k2 + kk);
          wgmma_tf32_rs_n64(cq, as[kk], db);
          if (!X)
            wgmma_tf32_rs_n64(cq, ab[kk],
                              desc_sw128(&sml) + 2 * (k2 + kk));
          wgmma_tf32_rs_n64(cq, ab[kk], db);
        }
      }
      wgmma_commit();
      lap(14);
      load_step<T, DH>(s, in, st0 + 1 + sl + kAhead + 1, nchunks);
      lap(15);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_regs(cq);
    __syncthreads();            // every C q product is done with its tiles
    lap(7);

    // ---- S and q.n over the cluster: CTA r sums rows [RP r, RP r + RP)
    // of every CTA's partial in rank order and stores them into every
    // CTA (a reduce-scatter, then an all-gather), between two barriers
    cluster_wait();
    {
      constexpr int RP = kC / C::NC, P4 = RP * kC / 4;
      const int base = r * RP * kC;
      for (int pos = tid; pos < P4; pos += kThreads) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int rr = 0; rr < C::NC; ++rr) {
          const float4 v = ld_cluster4(cluster_addr(&s.xs[base + 4 * pos],
                                                    rr));
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
#pragma unroll
        for (int rr = 0; rr < C::NC; ++rr)
          st_cluster4(cluster_addr(&s.sf[base + 4 * pos], rr), sum);
      }
      if (tid >= kThreads - RP) {
        const int t = r * RP + tid - (kThreads - RP);
        float qn = 0.f;
#pragma unroll
        for (int rr = 0; rr < C::NC; ++rr)
          qn += ld_cluster(cluster_addr(&s.xqn[t], rr));
#pragma unroll
        for (int rr = 0; rr < C::NC; ++rr)
          st_cluster(cluster_addr(&s.qf[t], rr), qn);
      }
    }
    cluster_arrive();
    cluster_wait();

    // ---- P = S o D, den; h
    {
      const int t = tid >> 2, jq = 16 * (tid & 3);
      const float bt = s.bcs[t], mt = s.mts[t];
      float rs = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j0 = jq + 4 * cc;
        const float4 sum = *reinterpret_cast<const float4*>(
            &s.sf[t * kC + j0]);
        float p[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q;
          p[q] = (j <= t && t < cl)
                     ? p[q] * expf(((bt - s.bcs[j]) + s.igs[j]) - mt) : 0.f;
          rs += p[q];
        }
        put4<false>(p[0], p[1], p[2], p[3], &s.ops[j0 >> 5],
                    &s.ops[2 + (j0 >> 5)], t, (j0 & 31) >> 2);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float qnv = rs + s.inter[t] * s.qf[t];
      if ((tid & 3) == 0)
        s.den[t] = t < cl ? fmaxf(fabsf(qnv), expf(-mt)) : 1.f;
      if (kSave && r == 0 && (tid & 3) == 0 && t < cl) {
        sv.mt[(size_t)bh * S + t0 + t] = mt;
        sv.qn[(size_t)bh * S + t0 + t] = qnv;
      }
      // each warpgroup hands over the half of C q the other finishes
      // (selects, not a runtime index: cq must stay in registers)
      float* red = s.ops[4 + g].x;
#pragma unroll
      for (int k = 0; k < 16; ++k) red[k * 128 + l] = g ? cq[k] : cq[16 + k];
    }
    fence_proxy_async();
    __syncthreads();
    lap(8);
    {
      const float* other = s.ops[5 - g].x;
      float hv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float mine = g ? cq[16 + k] : cq[k];
        const float theirs = other[k * 128 + l];
        const float sum = g == 0 ? mine + theirs : theirs + mine;
        const int t = 32 * g + 8 * (k >> 2) + fc + (k & 1);
        hv[k] = s.inter[t] * sum;
      }
      wgmma_fence();
      tf32x3_k64_n32<X, false>(hv, &s.vt[0], &s.vt[1], &s.vt[2], &s.vt[3],
                             &s.ops[0], &s.ops[1], &s.ops[2], &s.ops[3],
                             32 * g);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hv);
      T* hb = h + ((size_t)bh * S + t0) * DH + r0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = fr + 8 * ((k >> 1) & 1);
        const int t = 32 * g + 8 * (k >> 2) + fc + (k & 1);
        if (t < cl) hb[(size_t)t * DH + i] = from_f<T>(hv[k] / s.den[t]);
      }
    }
    __syncthreads();
    lap(9);

    // ---- B: C = carry C + v^T (w o k), k streamed by slab
#pragma unroll
    for (int sl = 0; sl < NSW; ++sl) {
      const T* raw = slab<T>(s, lam0 + kA1Loads + C::NS + 2 * sl + g);
      lap(10);
      Half* wk = reinterpret_cast<Half*>(&s.ops[4 * g + 2 * (sl & 1)]);
#pragma unroll
      for (int it = 0; it < 4; ++it) {      // 32 e x 16 chunks of j
        const int u = l + 128 * it;
        const int e = u & 31, jc = u >> 5, j = 4 * jc;
        const T* src = raw + j * kW + e;
        put4<false>(s.wks[j] * to_f(src[0]), s.wks[j + 1] * to_f(src[kW]),
                    s.wks[j + 2] * to_f(src[2 * kW]),
                    s.wks[j + 3] * to_f(src[3 * kW]), &wk[jc >> 3],
                    &wk[2 + (jc >> 3)], e, jc & 7);
      }
      lap(11);
      cp_wait<kAhead - 1>();
      fence_proxy_async();
      __syncthreads();
      lap(12);
#pragma unroll
      for (int k = 0; k < 16; ++k) c[sl][k] *= carry;
      wgmma_fence();
      tf32x3_k64_n32<X, false>(c[sl], &s.vt[0], &s.vt[1], &s.vt[2], &s.vt[3],
                             &wk[0], &wk[1], &wk[2], &wk[3], 0);
      wgmma_commit();
      lap(13);
      load_step<T, DH>(s, in, st0 + 1 + NSW + sl + kAhead + 1, nchunks);
      lap(16);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < NSW; ++sl) fence_regs(c[sl]);
    if (tid == 0) s.scal[0] = s.scal[2];
    __syncthreads();
    lap(17);
  }

#pragma unroll
  for (int sl = 0; sl < NSW; ++sl)
#pragma unroll
    for (int k = 0; k < 16; k += 2) {
      const int i = r0 + fr + 8 * ((k >> 1) & 1);
      const int e = kW * (2 * sl + g) + 8 * (k >> 2) + fc;
      *reinterpret_cast<float2*>(&Cout[((size_t)bh * DH + i) * DH + e]) =
          make_float2(c[sl][k], c[sl][k + 1]);
    }
  if (tid < kC) nout[(size_t)bh * DH + r0 + tid] = s.nown[tid];
  if (r == 0 && tid == 0) mout[bh] = s.scal[0];
  if (timed) {
    s.clk[kProfPhases - 1] = clock64() - start;
    for (int p = 0; p < kProfPhases; ++p)
      atomicAdd(&prof[p], (unsigned long long)s.clk[p]);
  }
}

constexpr size_t kSmem = sizeof(Smem) + 1024;   // + alignment slack

template <typename T, int DH>
cudaLaunchConfig_t config(int B, int NH, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DH / 64, NH, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DH / 64;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DH, bool kSave>
cudaError_t opt_in() {
  static cudaError_t done = cudaErrorNotReady;
  if (done != cudaSuccess)
    done = cudaFuncSetAttribute(mlstm_tc_kernel<T, DH, kSave>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmem);
  return done;
}

template <typename T, int DH, bool kSave>
int launch_as(const void* q, const void* k, const void* v, const float* ig,
              const float* lf, const float* C0, const float* n0,
              const float* m0, void* h, float* Cout, float* nout,
              float* mout, int B, int NH, int S, const Saved& sv,
              unsigned long long* prof, cudaStream_t st) {
  cudaError_t err = opt_in<T, DH, kSave>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T, DH>(B, NH, st, attr);
  err = cudaLaunchKernelEx(&cfg, mlstm_tc_kernel<T, DH, kSave>, (const T*)q,
                           (const T*)k, (const T*)v, ig, lf, C0, n0, m0,
                           (T*)h, Cout, nout, mout, S, sv, prof);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int max_clusters(int B, int NH) {
  cudaError_t err = opt_in<T, DH, false>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T, DH>(B, NH, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, mlstm_tc_kernel<T, DH, false>,
                                       &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, bool kSave>
int dispatch(int Dh, const void* q, const void* k, const void* v,
             const float* ig, const float* lf, const float* C0,
             const float* n0, const float* m0, void* h, float* C, float* n,
             float* m, int B, int NH, int S, const Saved& sv,
             unsigned long long* prof, cudaStream_t st) {
  switch (Dh) {
    case 64:
      return launch_as<T, 64, kSave>(q, k, v, ig, lf, C0, n0, m0, h, C, n,
                                     m, B, NH, S, sv, prof, st);
    case 128:
      return launch_as<T, 128, kSave>(q, k, v, ig, lf, C0, n0, m0, h, C, n,
                                      m, B, NH, S, sv, prof, st);
    case 256:
      return launch_as<T, 256, kSave>(q, k, v, ig, lf, C0, n0, m0, h, C, n,
                                      m, B, NH, S, sv, prof, st);
    case 512:
      return launch_as<T, 512, kSave>(q, k, v, ig, lf, C0, n0, m0, h, C, n,
                                      m, B, NH, S, sv, prof, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The body of both libraries' entry points: the argument checks and the
// dtype's instantiation.
template <bool kSave>
int run(int dtype, const void* q, const void* k, const void* v,
        const void* ig, const void* lf, const void* C0, const void* n0,
        const void* m0, void* h, void* C, void* n, void* m, int B, int NH,
        int S, int Dh, const Saved& sv, void* prof, void* stream) {
  if (S < 1 || B < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *g = (const float*)ig, *f = (const float*)lf;
  const float *c0 = (const float*)C0, *nn0 = (const float*)n0,
              *mm0 = (const float*)m0;
  float *c = (float*)C, *nn = (float*)n, *mm = (float*)m;
  unsigned long long* pr = (unsigned long long*)prof;
  if (dtype == kF32)
    return dispatch<float, kSave>(Dh, q, k, v, g, f, c0, nn0, mm0, h, c, nn,
                                  mm, B, NH, S, sv, pr, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16, kSave>(Dh, q, k, v, g, f, c0, nn0, mm0, h,
                                          c, nn, mm, B, NH, S, sv, pr, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mlstm_tc
