// Chunkwise stabilized mLSTM (xLSTM) on Hopper's tensor cores (sm_90a),
// without the training path's state writes.
//
// Replaces the TPU kernel repro/kernels/mlstm.py :: mlstm_chunked (body
// _kernel) at head widths DH in {64, 128, 256, 512}: serving's prefill
// and every launch that needs no saved states. The kernel, what bounds
// it and its design are in mlstm_chunked_tc.cuh; mlstm_chunked_tc_save.cu
// is the same kernel with the state writes.
#include "mlstm_chunked_tc.cuh"

// q, k, v: [B, NH, S, Dh] float32 or bf16 (dtype code), contiguous and
// 16-byte aligned; ig, lf: [B, NH, S] float32; C0 [B, NH, Dh, Dh], n0
// [B, NH, Dh], m0 [B, NH] float32, all three null or none; h: [B, NH, S,
// Dh] in q's dtype; C, n, m as C0, n0, m0. Dh in {64, 128, 256, 512},
// S >= 1. prof: null, or kProfPhases uint64 counters that thread 0 of
// every CTA adds the clock64() cycles of its phases to (the list at
// kProfPhases).
// Returns the launch's CUDA error (0 on success).
extern "C" int mlstm_chunked_tc(int dtype, const void* q, const void* k,
                                const void* v, const void* ig,
                                const void* lf, const void* C0,
                                const void* n0, const void* m0, void* h,
                                void* C, void* n, void* m, int B, int NH,
                                int S, int Dh, void* prof, void* stream) {
  return mlstm_tc::run<false>(dtype, q, k, v, ig, lf, C0, n0, m0, h, C, n,
                              m, B, NH, S, Dh, mlstm_tc::Saved{}, prof,
                              stream);
}

// cudaOccupancyMaxActiveClusters for the launch at Dh 512 (the prefill's
// width) of the given dtype; a negative value is a CUDA error.
extern "C" int mlstm_chunked_tc_clusters(int dtype, int B, int NH) {
  using namespace mlstm_tc;
  return dtype == kF32 ? max_clusters<float, 512>(B, NH)
                       : max_clusters<__nv_bfloat16, 512>(B, NH);
}

// Dynamic shared memory of a CTA, in bytes.
extern "C" int mlstm_chunked_tc_smem() { return (int)mlstm_tc::kSmem; }
