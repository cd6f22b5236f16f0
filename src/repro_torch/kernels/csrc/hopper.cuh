// Hopper building blocks shared by the tensor-core kernels
// (flash_fwd_tc.cu, flash_bwd_dkv_tc.cu, flash_bwd_dq_tc.cu,
// flash_fwd_tc128.cu, flash_bwd_dkv_tc128.cu, lora_matmul_tc.cu,
// mlstm_chunked_tc.cu, flash_fwd_tf32.cu, flash_bwd_dkv_tf32.cu,
// flash_bwd_dq_tf32.cu): mbarriers, TMA tile loads, cp.async copies,
// shared-memory matrix descriptors, warpgroup MMAs (wgmma) and register
// hand-over between warpgroups (setmaxnreg), as PTX; and the 3xTF32
// float32 products (the section "3xTF32" below states their own
// conventions).
//
// Conventions, all for bf16 tiles of 64-element (128-byte) rows:
//   * TMA writes a tile into shared memory with the 128-byte swizzle, so a
//     tile must start on a 1024-byte boundary (one swizzle atom: 8 rows);
//   * a K-major operand (the reduction axis contiguous, as a row-major
//     [rows, 64] tile read along its rows) is described with SBO = 1024
//     (8 rows) and advances 32 bytes per 16-deep step;
//   * an MN-major operand (the reduction axis along the rows: the same
//     tile read down its columns) is described with SBO = 1024 and
//     advances 16 rows (2048 bytes) per 16-deep step, and the wgmma takes
//     it with the transpose bit set;
//   * an MN-major operand wider than 64 (a [16k, 128] B tile) is two
//     64-column halves, each a TMA box of its own; the descriptor's LBO is
//     the byte distance from the first half to the second;
//   * a wgmma's accumulator fragment of a 64 x N tile: thread t of warp w
//     of the warpgroup holds, for n8 column block j, d[4j + 0..1] at row
//     16w + t/4 and d[4j + 2..3] at row 16w + t/4 + 8, columns
//     8j + 2(t%4) + 0..1. Two consecutive n8 blocks (eight registers),
//     packed to bf16 pairs, are exactly the A fragment of one 16-deep
//     step of a register-A wgmma: a product's P goes into the next
//     product without touching shared memory.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that
// lasts about ten seconds (a deadlock: no legitimate wait comes near it)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// As mbar_wait, for a warpgroup that raised its register budget
// (reg_alloc): a trap in its code makes ptxas allocate that code within
// the kernel's entry budget (spilling and serializing its wgmmas), so
// after about ten seconds this wait returns instead and the warpgroup
// goes on with whatever the buffer holds. The producer's waits still
// trap: a launch whose barriers deadlock ends either way, with a fault or
// with wrong values, and never hangs the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done && clock64() - t0 <= (1LL << 34));
}

// ------------------------------------------------------------------- TMA
// Copy the box at coordinates (c0, c1, c2) (innermost first) of a 3-D
// tensor map into shared memory; completion is counted on `bar`.
// Coordinates past the tensor's extent read zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copy the box at coordinates (c0, c1) (innermost first) of a 2-D tensor
// map into shared memory, as tma_load_3d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Named barrier `id` (1 to 15; 0 is __syncthreads') over `threads`
// threads, a multiple of 32: one warpgroup syncs without the others.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Hand registers between warpgroups: every thread of the calling
// warpgroup lowers (dealloc) or raises (alloc) its register budget to N,
// a multiple of 8 in [24, 256]. A producer warpgroup that needs few gives
// them up and the consumer warpgroups take them; the kernel must branch
// into the roles once, right after its set-up, and never reconverge, or
// ptxas ignores the request (warning C7508).
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma, TMA) once a barrier orders them before the reader.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset `off` within a 1024-byte-aligned tile, 128-byte swizzled
// as TMA writes it: the 16-byte chunk index XOR the row index mod 8.
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// The shared-memory address `p` rounded up to a 1024-byte boundary.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ----------------------------------------------------------------- wgmma
// Descriptor of a bf16 operand tile in shared memory with the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)1 << 16;             // LBO: unused by these layouts
  d |= (uint64_t)(1024 >> 4) << 32;   // SBO: 8 rows of 128 bytes
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

// As desc_sw128 with the leading byte offset `lbo`: the distance between
// the 64-column halves of an MN-major operand wider than 64.
__device__ __forceinline__ uint64_t desc_sw128_lbo(const void* p,
                                                   uint32_t lbo) {
  return (desc_sw128(p) & ~((uint64_t)0x3FFF << 16)) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight (they
// complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Make the compiler treat an accumulator as written here, so that no read
// or write of it moves across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x on the special-function unit; -inf gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] = A[64 x 16] B[16 x 64], as wgmma_ss_m64n64 with scale-d
// false; D is written only, so its old values are never read.
__device__ __forceinline__ void wgmma_ss_m64n64_zero(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),
        "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs laid out
// as an accumulator fragment), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A K-major in shared memory, B
// K-major (TB 0) or MN-major (TB 1: the transpose bit) in shared memory;
// scale_d 0 writes D without reading it.
template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs laid
// out as an accumulator fragment), B MN-major (transposed) in shared
// memory as two 64-column halves, LBO apart (desc_sw128_lbo).
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n16(float (&d)[8], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 8] (+)= A[64 x 16] B[16 x 8], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n8(float (&d)[4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3 "
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------- 64 x 64 x 64 products
// D = A B^T over a 64-deep reduction (four 16-deep steps): A and B are
// [64, 64] bf16 tiles in shared memory, read along their rows (K-major).
__device__ __forceinline__ void mma_ss_k64(float (&d)[32], const void* a,
                                           const void* b) {
  const uint64_t da = desc_sw128(a), db = desc_sw128(b);
  wgmma_ss_m64n64_zero(d, da, db);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_ss_m64n64(d, da + 2 * kk, db + 2 * kk);
}

// D += A B over a 64-deep reduction: A the bf16 fragments of pack_frag,
// B a [64, 64] bf16 tile in shared memory read down its columns
// (MN-major), 16 rows a step.
__device__ __forceinline__ void mma_rs_k64(float (&d)[32],
                                           const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_m64n64_tb(d, a[kk], desc_sw128(b + kk * 16 * 64));
}

// ------------------------------------------------ head_dim 128 products
// A [64, 128] bf16 tile is two [64, 64] halves (columns 0-63, then 64-127)
// of HALF128_BYTES each, one TMA box apiece (bf16_cols_map): the 128-byte
// swizzle takes rows of 64 elements at most.
constexpr int HALF128_BYTES = 64 * 64 * 2;

// D = A B^T over a 128-deep reduction (eight 16-deep steps): A and B are
// [64, 128] tiles as two halves each, read along their rows (K-major).
__device__ __forceinline__ void mma_ss_k128(float (&d)[32], const void* a,
                                            const void* b) {
  const char* a1 = reinterpret_cast<const char*>(a) + HALF128_BYTES;
  const char* b1 = reinterpret_cast<const char*>(b) + HALF128_BYTES;
  mma_ss_k64(d, a, b);
  const uint64_t da = desc_sw128(a1), db = desc_sw128(b1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n64(d, da + 2 * kk, db + 2 * kk);
}

// D[64 x 128] += A B over a K-deep reduction (K / 16 steps): A the bf16
// fragments of pack_frags, B K rows of a [64, 128] tile (two halves; `b`
// at the first of those rows in the first half) read down its columns
// (MN-major), 16 rows a step; one m64n128 wgmma a step, whose
// descriptor's LBO steps from the first half to the second.
template <int K, int HALF_BYTES = HALF128_BYTES>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[K / 16][4],
                                            const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs_m64n128_tb(d, a[kk],
                        desc_sw128_lbo(b + kk * 16 * 64, HALF_BYTES));
}

// D[64 x 128] = A B^T over a 128-deep reduction, 128 columns: A a [64, 128]
// tile and B a [128, 128] one, each as two 64-column halves (A's
// HALF128_BYTES apart, B's twice that), both K-major.
__device__ __forceinline__ void mma_ss_k128_n128(float (&d)[64],
                                                 const void* a,
                                                 const void* b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint64_t da = desc_sw128(reinterpret_cast<const char*>(a) +
                                   h * HALF128_BYTES);
    const uint64_t db = desc_sw128(reinterpret_cast<const char*>(b) +
                                   2 * h * HALF128_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n128<0>(d, da + 2 * kk, db + 2 * kk, h + kk > 0);
  }
}

// A 64 x 64 float32 accumulator fragment as the bf16 A fragments of a
// 64-deep product, one per 16-deep step.
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A 64 x 16K float32 accumulator fragment as the bf16 A fragments of a
// 16K-deep product (pack_frag at K = 4).
template <int K>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[K][4],
                                           const float (&x)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// The same fragment split in two: hi = bf16(x) and lo = bf16(x - hi), so
// that hi + lo carries x to about 2^-16 of itself where one bf16
// rounding keeps 2^-9. A product then takes two passes, lo's first.
__device__ __forceinline__ void pack_frag_split(uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4],
                                                const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// -------------------------------------------------------------- cp.async
// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- 3xTF32
// Float32 products on the tensor cores. Every float32 operand x splits
// with round-to-nearest into tf32 parts big = rna(x) and small =
// rna(x - big) (x - big is exact), and a product is small.big + big.small
// + big.big, accumulated in float32 by wgmma: the error is at float32's
// own level, where one tf32 pass is about a thousand times worse. An
// operand that is exact in tf32 (bf16) has no small part, and its passes
// are dropped. The tensor cores' float32 accumulation truncates (each
// wgmma's sum rounds toward zero), so a product issues its small passes
// first, while the sum is still small, and a long sum (a flash
// kernel's dK, dV or O over many tiles) is not left in one accumulator:
// each tile's product starts from zero and is added in float32 on the
// CUDA cores.
//
// Conventions:
//   * tf32 wgmma reads both shared-memory operands K-major and has no
//     transpose bit: an operand that a product contracts over its rows is
//     stored transposed by the pass that splits it;
//   * an operand tile is [rows][32] floats: 128-byte rows with the
//     128-byte swizzle (st_chunk), 1024-byte aligned, described with
//     SBO = 1024 (8 rows) and advanced 32 bytes per 8-deep k step; a K of
//     64 is two such tiles (tf32_kdesc);
//   * a register-A fragment of one 8-deep k step (tf32_frag) takes
//     columns 8 kk .. 8 kk + 7 of a 64 x N accumulator fragment: thread t
//     of a quad holds columns 2t and 2t + 1 there, which the fragment's
//     layout puts in k slots t and t + 4. So the B operand that multiplies
//     an accumulator's values stores its k rows permuted inside each
//     8-group: slots 0-3 hold rows 0, 2, 4, 6 and slots 4-7 rows 1, 3, 5,
//     7 (a 16-byte chunk 2g + p of a B row holds rows 8g + p + {0, 2, 4,
//     6}).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32 (small exact: x - big is exact).
__device__ __forceinline__ void tf32_split(float x, float& big,
                                           float& small) {
  big = __uint_as_float(tf32_rna(x));
  small = __uint_as_float(tf32_rna(x - big));
}

__device__ __forceinline__ void tf32_split4(float4 x, float4& big,
                                            float4& small) {
  tf32_split(x.x, big.x, small.x);
  tf32_split(x.y, big.y, small.y);
  tf32_split(x.z, big.z, small.z);
  tf32_split(x.w, big.w, small.w);
}

// The chunk swizzle of row r of a raw float32 tile (rows of 64 floats,
// as copied): chunk c of row r is kept at chunk c ^ raw_chunk_swz(r). A
// pass that writes a transposed operand in the permuted k order reads
// chunk c of rows 8g + p + 2i for eight (g, p) at a time (g < 4, p < 2):
// the swizzle puts those eight on different bank groups, where rows of
// 256 bytes would put them all on one.
__device__ __forceinline__ int raw_chunk_swz(int r) {
  return ((r >> 3) & 3) | ((r & 1) << 2);
}

// Store 16-byte chunk c (columns 4c..4c+3) of row `row` of a swizzled
// operand tile with 128-byte rows.
__device__ __forceinline__ void st_chunk(void* tile, int row, int c,
                                         float4 v) {
  *reinterpret_cast<float4*>(reinterpret_cast<char*>(tile) + row * 128 +
                             ((c ^ (row & 7)) << 4)) = v;
}

// Rows lo .. lo + 63 of a [S, 64] float32 plane into big (t[0], t[1]:
// columns 0-31, 32-63) and small (t[2], t[3]) [64][32] operand tiles as
// stored, by all kThreads threads of the CTA; rows past S are zeros.
// Eight neighbouring threads take one row's eight chunks of a tile: no
// bank conflict.
template <int kThreads, class T>
__device__ __forceinline__ void tf32_stage64(const float* plane, int lo,
                                             int S, T* t) {
#pragma unroll
  for (int u = threadIdx.x; u < 64 * 16; u += kThreads) {
    const int r = u >> 4, c = u & 15;
    const float4 x =
        lo + r < S ? __ldg(reinterpret_cast<const float4*>(
                         plane + (size_t)(lo + r) * 64 + 4 * c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b, s;
    tf32_split4(x, b, s);
    st_chunk(&t[c >> 3], r, c & 7, b);
    st_chunk(&t[2 + (c >> 3)], r, c & 7, s);
  }
}

// A raw [32][64] float32 tile (as copied: chunks swizzled by
// raw_chunk_swz) into big (t[0], t[1]) and small (t[2], t[3]) [32][32]
// operand tiles as stored, by thread l of a warpgroup: eight neighbouring
// threads take eight chunks of a row, no bank conflict on either side.
template <class T>
__device__ __forceinline__ void tf32_split_rows32(const float* raw, T* t,
                                                  int l) {
#pragma unroll
  for (int u = l; u < 32 * 16; u += 128) {
    const int r = u >> 4, c = u & 15;
    float4 b, s;
    tf32_split4(*reinterpret_cast<const float4*>(raw + r * 64 +
                                                 4 * (c ^ raw_chunk_swz(r))),
                b, s);
    st_chunk(&t[c >> 3], r, c & 7, b);
    st_chunk(&t[2 + (c >> 3)], r, c & 7, s);
  }
}

// The same raw tile transposed into big tt[0] and small tt[1] [64][32]
// operand tiles, by thread l of a warpgroup: row d = 4c + e, chunk gp =
// 2g + p holds raw rows 8g + p + {0, 2, 4, 6}, the register fragment's k
// order. Eight neighbouring threads take the eight chunks gp of the same
// rows d: the stores meet no bank conflict, and raw_chunk_swz spreads
// the reads.
template <class T>
__device__ __forceinline__ void tf32_split_cols32(const float* raw, T* tt,
                                                  int l) {
  const int gp = l & 7, c = l >> 3;
  const int rb = 8 * (gp >> 1) + (gp & 1);
  float4 b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tf32_split4(*reinterpret_cast<const float4*>(
                    raw + (rb + 2 * e) * 64 +
                    4 * (c ^ raw_chunk_swz(rb + 2 * e))),
                b[e], s[e]);
  st_chunk(&tt[0], 4 * c, gp, make_float4(b[0].x, b[1].x, b[2].x, b[3].x));
  st_chunk(&tt[0], 4 * c + 1, gp,
           make_float4(b[0].y, b[1].y, b[2].y, b[3].y));
  st_chunk(&tt[0], 4 * c + 2, gp,
           make_float4(b[0].z, b[1].z, b[2].z, b[3].z));
  st_chunk(&tt[0], 4 * c + 3, gp,
           make_float4(b[0].w, b[1].w, b[2].w, b[3].w));
  st_chunk(&tt[1], 4 * c, gp, make_float4(s[0].x, s[1].x, s[2].x, s[3].x));
  st_chunk(&tt[1], 4 * c + 1, gp,
           make_float4(s[0].y, s[1].y, s[2].y, s[3].y));
  st_chunk(&tt[1], 4 * c + 2, gp,
           make_float4(s[0].z, s[1].z, s[2].z, s[3].z));
  st_chunk(&tt[1], 4 * c + 3, gp,
           make_float4(s[0].w, s[1].w, s[2].w, s[3].w));
}

// D[64 x 32] += A[64 x 8] B[8 x 32], both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], A in registers (a tf32 fragment), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Descriptor of k step kk (8 deep) of a K-major operand whose K = 64 is
// two 32-wide tiles `t0` and `t1`, starting `row` rows in.
__device__ __forceinline__ uint64_t tf32_kdesc(const void* t0,
                                               const void* t1, int kk,
                                               int row) {
  const char* base = reinterpret_cast<const char*>(kk < 4 ? t0 : t1);
  return desc_sw128(base + row * 128) + 2 * (kk & 3);
}

// 3xTF32 (or, with an exact A or B, two or one passes) over a 64-deep
// contraction: D += A B^T with A [64][64] in tiles (a0, a1 | as0, as1)
// and B rows [brow, brow + 32) of (b0, b1 | bs0, bs1); the small passes
// of every k step first, then the big ones. (In the mLSTM, skipping the
// steps a short chunk or the causal mask leaves zero was measured slower:
// the branch costs more than the products it saves.)
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void tf32x3_k64_n32(
    float (&d)[16], const void* a0, const void* a1, const void* as0,
    const void* as1, const void* b0, const void* b1, const void* bs0,
    const void* bs1, int brow) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (!kExactA)
      wgmma_tf32_n32(d, tf32_kdesc(as0, as1, kk, 0),
                     tf32_kdesc(b0, b1, kk, brow));
    if (!kExactB)
      wgmma_tf32_n32(d, tf32_kdesc(a0, a1, kk, 0),
                     tf32_kdesc(bs0, bs1, kk, brow));
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_n32(d, tf32_kdesc(a0, a1, kk, 0),
                   tf32_kdesc(b0, b1, kk, brow));
}

// 3xTF32 over a 64-deep contraction, 64 columns: D += A B^T with A and B
// [64][64] each in tiles (x0, x1 | xs0, xs1), small passes first.
__device__ __forceinline__ void tf32x3_k64_n64(
    float (&d)[32], const void* a0, const void* a1, const void* as0,
    const void* as1, const void* b0, const void* b1, const void* bs0,
    const void* bs1) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_tf32_n64(d, tf32_kdesc(as0, as1, kk, 0), tf32_kdesc(b0, b1, kk, 0));
    wgmma_tf32_n64(d, tf32_kdesc(a0, a1, kk, 0), tf32_kdesc(bs0, bs1, kk, 0));
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_n64(d, tf32_kdesc(a0, a1, kk, 0), tf32_kdesc(b0, b1, kk, 0));
}

// The big and small register-A fragments of k step kk (columns 8 kk ..
// 8 kk + 7) of a 64 x N float32 accumulator fragment x, split on the fly:
// registers {0, 1, 2, 3} take x[4 kk + {0, 2, 1, 3}] (rows r and r + 8 at
// column 2t, then at 2t + 1: k slots t and t + 4).
template <int N>
__device__ __forceinline__ void tf32_frag(const float (&x)[N], int kk,
                                          uint32_t (&big)[4],
                                          uint32_t (&small)[4]) {
  const int o[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float hi, lo;
    tf32_split(x[4 * kk + o[i]], hi, lo);
    big[i] = __float_as_uint(hi);
    small[i] = __float_as_uint(lo);
  }
}

// 3xTF32 over K k steps with A in registers: D += A B, A's big and small
// fragments a k step, B K-major in tiles (b0, b1 | bs0, bs1) (32 deep
// each; a B of K <= 4 steps passes its one tile twice); small passes
// first.
template <int K>
__device__ __forceinline__ void tf32x3_rs_n64(float (&d)[32],
                                              const uint32_t (&big)[K][4],
                                              const uint32_t (&small)[K][4],
                                              const void* b0, const void* b1,
                                              const void* bs0,
                                              const void* bs1) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    wgmma_tf32_rs_n64(d, small[kk], tf32_kdesc(b0, b1, kk, 0));
    wgmma_tf32_rs_n64(d, big[kk], tf32_kdesc(bs0, bs1, kk, 0));
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_tf32_rs_n64(d, big[kk], tf32_kdesc(b0, b1, kk, 0));
}

}  // namespace hopper

// --------------------------------------------------------- host: tensor maps
namespace hopper {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 tensor [planes, rows, 64], read in
// boxes of `box_rows` x 64 with the 128-byte swizzle; rows past `rows`
// read as zeros, so a box never spills into the next plane.
inline cudaError_t bf16_rows_map(CUtensorMap* map, const void* base,
                                 int planes, int rows, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {64 * 2, (cuuint64_t)rows * 64 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a contiguous bf16 tensor [planes, rows, cols] (cols a
// multiple of 64), read in boxes of `box_rows` rows x 64 columns with the
// 128-byte swizzle: a 64-column half of a row block is one box (its
// coordinate c0 = 0 or 64 at cols 128). Rows past `rows` read as zeros.
inline cudaError_t bf16_cols_map(CUtensorMap* map, const void* base,
                                 int planes, int rows, int cols,
                                 int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a bf16 matrix of `rows` rows of `cols` elements,
// `ld` elements apart (a multiple of 8; a 16-byte aligned base), read in
// boxes of box_rows x box_cols with the 128-byte swizzle (box_cols 64);
// elements past either edge read as zeros.
inline cudaError_t bf16_matrix_map(CUtensorMap* map, const void* base,
                                   int rows, int cols, long long ld,
                                   int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
