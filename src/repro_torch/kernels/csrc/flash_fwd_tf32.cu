// Flash-attention forward on Hopper's tensor cores (sm_90a), float32,
// D 64, every product 3xTF32 on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (body _fwd_kernel) for float32 inputs at head_dim 64,
// the route the FHDP step (flad-vision) and every other float32 path
// runs; flash_fwd.cu keeps float32 at head_dims 32 and 128, and
// flash_fwd_tc.cu bf16 at 64. It computes what flash_fwd.cu computes: q
// [B, Hq, Sq, 64], k/v [B, Hkv, Skv, 64] (query head h reads KV head
// h / (Hq/Hkv)) give o [B, Hq, Sq, 64] and, optionally, the row logsumexp
// lse [B, Hq, Sq]; query row r sits at absolute position q_offset + r;
// causal and window masks follow the reference's _mask_block; masked
// pairs get p = 0 exactly; a row that sees no key gets o = 0 and
// lse = -1e30, as on the SIMT route.
//
// Numerics: 3xTF32 (hopper.cuh). q, k and v split into tf32 big and small
// parts once, as they are staged; S = Q K^T and O += P V are each
// small.big + big.small + big.big on wgmma, accumulated in float32. The
// online softmax (the scaled scores, the running max, the rescale, p and
// the row sum from the float32 p), lse and the final division are float32
// on the CUDA cores; P is split on the fly as the register A operand of
// P V.
//
// What bounds it on an H100: operations. At the FHDP step's shape (B 2,
// Hq = Hkv 12, S 256, D 64, non-causal) a call needs 402.7 MFLOP against
// 6.3 MB: 0.00601 ms at float32's 67 TFLOP/s on the CUDA cores, 0.00244 ms
// at 3xTF32's 495 / 3 TFLOP/s on the tensor cores, 0.00189 ms for the
// bytes.
//
// What the design does about it:
//   * one CTA per (64-row query tile, query head, batch): 96 CTAs at the
//     FHDP shape, where the SIMT kernel's 128-row tiles gave 48; the last
//     query tiles (the most keys under a causal mask) launch first;
//   * two consumer warpgroups share the CTA's Q and split its live KV
//     tiles between them (warpgroup w takes tiles w, w + 2, ...), each
//     with its own running max, row sum and O; at the end warpgroup 1
//     hands its (m, l, O) to warpgroup 0 through shared memory and the
//     two merge. Each warpgroup runs its own pipeline on named barriers:
//     with one warpgroup a CTA, each SM scheduler had a single warp, and
//     the split passes and the softmax stalled on every instruction's
//     latency;
//   * a warpgroup's K and V tiles arrive as raw float32 [64][64] tiles by
//     cp.async (16 bytes a thread and copy), the next one issued as soon
//     as this one is split, so its copies run under this tile's products;
//     rows past Skv (or Sq, for Q) read as zeros, never as the next head's
//     rows;
//   * a split pass writes each tile's big and small tf32 parts into
//     128-byte-swizzled operand tiles: Q and K as stored (S contracts over
//     d, K-major for both), V transposed with its keys permuted inside
//     each 8-group to match P's register fragment (P V contracts over the
//     keys, and tf32 wgmma has no transpose bit);
//   * S is a shared-memory wgmma (24 m64n64k8 a tile); the softmax runs on
//     its accumulator fragment; P, split in registers, is the A operand of
//     P V (24 register-A m64n64k8): neither S nor P touches shared memory;
//     each tile's P V starts from zero and joins O (rescaled) in float32
//     on the CUDA cores, since the tensor cores' accumulation truncates;
//   * K of a warpgroup's next tile is split while its last P V still runs
//     on the tensor cores (K's operand tiles are free once S is read);
//   * only the live KV tiles (live_keys) are visited, and the element
//     mask is applied only to tiles that cross the causal diagonal, the
//     window's edge or Skv.
// Shared memory: Q as big and small tf32 (32 KB); each warpgroup's K and
// V^T (2 x 64 KB) and raw tile (2 x 32 KB): 224 KB, one CTA an SM.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace flash_tf32 {

using namespace hopper;

constexpr int D = 64;
constexpr int BQ = 64;          // query rows of a CTA (wgmma M)
constexpr int BK = 64;          // keys of a K/V tile
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kThreads = 2 * kWG;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A [64 rows][32] tf32 operand tile, 128-byte swizzled (8 KB).
struct alignas(1024) Tile { float x[64 * 32]; };

// A warpgroup's operands: K [64 keys][64 d] (big d 0-31, 32-63; small
// 2-3) and V^T [64 d][64 keys, permuted] (big keys 0-31, 32-63; small 2-3).
struct KV {
  Tile k[4];
  Tile vt[4];
};

// A K/V tile as copied: [64][64] float32 each, chunks swizzled
// (raw_chunk_swz); at the end, warpgroup 1's (m, l, O) for warpgroup 0
// to merge.
union Raw {
  struct {
    float k[BK * D];
    float v[BK * D];
  } t;
  struct {
    float acc[32][kWG];
    float m[2][kWG];
    float l[2][kWG];
  } out;
};

struct Smem {
  Tile q[4];    // Q [64 rows][64 d]: big d 0-31, 32-63; small 2-3
  KV kv[2];     // a warpgroup's
  Raw raw[2];   // a warpgroup's
};

// Rows [row0, row0 + 64) of a [rows, 64] plane into a raw [64][64]
// buffer, 16 bytes a copy, by the warpgroup's thread l; rows at or past
// `rows` read as zeros. Chunk c of row r lands at chunk
// c ^ raw_chunk_swz(r).
__device__ __forceinline__ void load_rows(float* dst, const float* plane,
                                          int row0, int rows, int l) {
#pragma unroll 4
  for (int c = l; c < 64 * 16; c += kWG) {
    const int r = c >> 4, part = c & 15;
    const bool valid = row0 + r < rows;
    const float* src =
        plane + (size_t)(valid ? row0 + r : row0) * D + 4 * part;
    cp_async16(dst + r * D + 4 * (part ^ raw_chunk_swz(r)), src,
               valid);
  }
}

// A raw [64][64] tile into big (t[0], t[1]) and small (t[2], t[3])
// operand tiles as stored, by the warpgroup's thread l. Eight neighbouring
// threads take one row's eight chunks of a tile: no bank conflict on
// either side.
__device__ __forceinline__ void split_rows(const float* raw, Tile* t,
                                           int l) {
#pragma unroll 4
  for (int u = l; u < 64 * 16; u += kWG) {
    const int r = u >> 4, c = u & 15;
    float4 b, s;
    tf32_split4(*reinterpret_cast<const float4*>(raw + r * D +
                                                 4 * (c ^ raw_chunk_swz(r))),
                b, s);
    st_chunk(&t[c >> 3], r, c & 7, b);
    st_chunk(&t[2 + (c >> 3)], r, c & 7, s);
  }
}

// A raw [64 keys][64] V tile into V^T big (t[0], t[1]) and small (t[2],
// t[3]): row d, 16-byte chunk gp = 2g + p holds keys 8g + p + {0, 2, 4, 6}
// (the register-A fragment's k order, hopper.cuh). A thread reads those
// four keys' chunk c and writes four rows d = 4c .. 4c + 3. Eight
// neighbouring threads take eight chunks gp of the same rows d: the
// stores meet no bank conflict, and raw_chunk_swz spreads the eight
// keys' reads over the banks.
__device__ __forceinline__ void split_cols(const float* raw, Tile* t,
                                           int l) {
#pragma unroll
  for (int u = l; u < 16 * 16; u += kWG) {
    const int gp = u & 15, c = u >> 4;
    const int key0 = 8 * (gp >> 1) + (gp & 1);
    float4 b[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf32_split4(*reinterpret_cast<const float4*>(
                      raw + (key0 + 2 * i) * D +
                      4 * (c ^ raw_chunk_swz(key0 + 2 * i))),
                  b[i], s[i]);
    const int t0 = gp >> 3, ch = gp & 7;
    st_chunk(&t[t0], 4 * c, ch, make_float4(b[0].x, b[1].x, b[2].x, b[3].x));
    st_chunk(&t[t0], 4 * c + 1, ch,
             make_float4(b[0].y, b[1].y, b[2].y, b[3].y));
    st_chunk(&t[t0], 4 * c + 2, ch,
             make_float4(b[0].z, b[1].z, b[2].z, b[3].z));
    st_chunk(&t[t0], 4 * c + 3, ch,
             make_float4(b[0].w, b[1].w, b[2].w, b[3].w));
    st_chunk(&t[2 + t0], 4 * c, ch,
             make_float4(s[0].x, s[1].x, s[2].x, s[3].x));
    st_chunk(&t[2 + t0], 4 * c + 1, ch,
             make_float4(s[0].y, s[1].y, s[2].y, s[3].y));
    st_chunk(&t[2 + t0], 4 * c + 2, ch,
             make_float4(s[0].z, s[1].z, s[2].z, s[3].z));
    st_chunk(&t[2 + t0], 4 * c + 3, ch,
             make_float4(s[0].w, s[1].w, s[2].w, s[3].w));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int planes, int Hq, int Hkv,
                      int Sq, int Skv, float scale_log2, flash::Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));
  const int nqt = (Sq + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)(blockIdx.x / planes);
  const int qplane = blockIdx.x % planes;
  const int kvplane = (qplane / Hq) * Hkv + (qplane % Hq) / (Hq / Hkv);
  const int q_lo = qt * BQ;
  const float* kp = k + (size_t)kvplane * Skv * D;
  const float* vp = v + (size_t)kvplane * Skv * D;

  const int wg = threadIdx.x >> 7, l = threadIdx.x & (kWG - 1);
  const int warp = l >> 5, lane = l & 31;
  const int row0 = q_lo + 16 * warp + (lane >> 2);   // and row0 + 8
  const int c_lo = 2 * (lane & 3);                   // + 8j + {0, 1}
  int k_begin, k_end;
  flash::live_keys(mask, q_lo, min(Sq, q_lo + BQ) - 1, Skv, &k_begin,
                   &k_end);
  const int kt0 = k_begin / BK;
  const int n = k_end > k_begin ? (k_end + BK - 1) / BK - kt0 : 0;
  KV& kv = s.kv[wg];
  Raw& raw = s.raw[wg];

  // this warpgroup's first tile, then Q by both (16-byte loads, split)
  if (wg < n) {
    load_rows(raw.t.k, kp, (kt0 + wg) * BK, Skv, l);
    load_rows(raw.t.v, vp, (kt0 + wg) * BK, Skv, l);
  }
  cp_commit();
  tf32_stage64<kThreads>(q + (size_t)qplane * Sq * D, q_lo, Sq, s.q);
  __syncthreads();

  // O = sum over tiles of P V, rescaled: each tile's P V starts from zero
  // in pv (wgmma) and is added to acc in float32 when it is done
  float acc[32], pv[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = pv[x] = 0.0f;
  float m[2] = {flash::kNegInf, flash::kNegInf};   // log2 domain, finite
  float lp[2] = {0.0f, 0.0f};                      // this thread's part
  float corr[2] = {1.0f, 1.0f};                    // acc's rescale
  uint32_t pb[8][4], ps[8][4];   // P's fragments, read while P V runs
  const int bar = 1 + wg;        // the warpgroup's named barrier

  for (int j = wg; j < n; j += 2) {
    cp_wait<0>();               // this thread's copies of tile j are in
    bar_sync(bar, kWG);         // everyone's; every warp is past S
    split_rows(raw.t.k, kv.k, l);   // while the last P V runs
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      acc[x] = fmaf(acc[x], corr[(x >> 1) & 1], pv[x]);
    bar_sync(bar, kWG);         // every warp's last P V is done with V^T
    split_cols(raw.t.v, kv.vt, l);
    fence_proxy_async();
    bar_sync(bar, kWG);         // the operand tiles are written, raw read
    if (j + 2 < n) {
      load_rows(raw.t.k, kp, (kt0 + j + 2) * BK, Skv, l);
      load_rows(raw.t.v, vp, (kt0 + j + 2) * BK, Skv, l);
    }
    cp_commit();

    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
    wgmma_fence();
    tf32x3_k64_n64(sc, &s.q[0], &s.q[1], &s.q[2], &s.q[3], &kv.k[0],
                   &kv.k[1], &kv.k[2], &kv.k[3]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // ---- online softmax on S's fragment: rows row0 (h 0), row0 + 8 (h 1)
    const int key0 = (kt0 + j) * BK;
    const bool whole =
        key0 + BK <= Skv &&
        (!mask.causal || key0 + BK - 1 <= mask.q_offset + q_lo) &&
        (mask.window <= 0 ||
         key0 > mask.q_offset + q_lo + BQ - 1 - mask.window);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int key = key0 + 8 * (x >> 2) + c_lo + (x & 1);
      const int qpos = mask.q_offset + row0 + 8 * ((x >> 1) & 1);
      const bool ok = whole || ((key < Skv) &
                                (!mask.causal | (key <= qpos)) &
                                ((mask.window <= 0) |
                                 (key > qpos - mask.window)));
      sc[x] = ok ? sc[x] * scale_log2 : -INFINITY;
    }
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * h], sc[4 * jj + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int h = (x >> 1) & 1;
      sc[x] = ex2(sc[x] - m[h]);          // -inf (masked) -> 0
      part[h] += sc[x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lp[h] = lp[h] * corr[h] + part[h];

    // ---- this tile's P V into pv: P split in registers, V^T big, small
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) tf32_frag(sc, kk, pb[kk], ps[kk]);
#pragma unroll
    for (int x = 0; x < 32; ++x) pv[x] = 0.0f;
    wgmma_fence();
    tf32x3_rs_n64<8>(pv, pb, ps, &kv.vt[0], &kv.vt[1], &kv.vt[2],
                     &kv.vt[3]);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(pv);
#pragma unroll
  for (int x = 0; x < 32; ++x)
    acc[x] = fmaf(acc[x], corr[(x >> 1) & 1], pv[x]);
  float lt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lt[h] = lp[h];
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 1);
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 2);
  }

  // ---- warpgroup 1 hands (m, l, O) over; warpgroup 0 merges and writes
  // o = O / l and lse = m ln2 + log l
  __syncthreads();              // both are done with their raw tiles
  auto& out = s.raw[1].out;
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < 32; ++x) out.acc[x][l] = acc[x];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out.m[h][l] = m[h];
      out.l[h][l] = lt[h];
    }
  }
  __syncthreads();
  if (wg == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = out.m[h][l];
    const float mm = fmaxf(m[h], m1);
    a0[h] = ex2(m[h] - mm);     // 1 for a row that sees no key
    a1[h] = ex2(m1 - mm);
    lt[h] = lt[h] * a0[h] + out.l[h][l] * a1[h];
    m[h] = mm;
  }
  const size_t plane = (size_t)qplane * Sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float lc = fmaxf(lt[h], 1e-30f);
    float* orow = o + (plane + row) * D;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int x = 4 * jj + 2 * h;
      const float y0 = fmaf(acc[x], a0[h], out.acc[x][l] * a1[h]);
      const float y1 = fmaf(acc[x + 1], a0[h], out.acc[x + 1][l] * a1[h]);
      *reinterpret_cast<float2*>(orow + 8 * jj + c_lo) =
          make_float2(y0 / lc, y1 / lc);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[plane + row] =
          lt[h] > 0.0f ? m[h] * kLn2 + logf(lt[h]) : flash::kNegInf;
  }
}

constexpr size_t kSmem = sizeof(Smem) + 1024;   // + alignment slack

static int launch(const float* q, const float* k, const float* v, float* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                  float scale, flash::Mask mask, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int planes = B * Hq, nqt = (Sq + BQ - 1) / BQ;
  flash_fwd_tf32_kernel<<<planes * nqt, kThreads, kSmem, stream>>>(
      q, k, v, o, lse, planes, Hq, Hkv, Sq, Skv, scale * kLog2e, mask);
  return (int)cudaGetLastError();
}

}  // namespace flash_tf32

// q: [B, Hq, Sq, 64]; k, v: [B, Hkv, Skv, 64]; o: [B, Hq, Sq, 64], all
// float32, contiguous and 16-byte aligned; lse: [B, Hq, Sq] float32 or
// null. Hq a multiple of Hkv; window <= 0 is no window. Rows that see no
// key get o = 0 and lse = -1e30. Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int Hq, int Hkv, int Sq,
                                        int Skv, float scale, int causal,
                                        int window, int q_offset,
                                        void* stream) {
  const flash::Mask mask{q_offset, causal, window};
  return flash_tf32::launch((const float*)q, (const float*)k,
                            (const float*)v, (float*)o, lse, B, Hq, Hkv, Sq,
                            Skv, scale, mask, (cudaStream_t)stream);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int flash_attention_fwd_tf32_smem() {
  return (int)flash_tf32::kSmem;
}
