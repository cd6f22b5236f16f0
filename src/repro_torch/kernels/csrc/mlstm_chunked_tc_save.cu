// Chunkwise stabilized mLSTM (xLSTM) on Hopper's tensor cores (sm_90a),
// with the state writes the backward (mlstm_chunked_bwd.cu) takes.
//
// Replaces the TPU kernel repro/kernels/mlstm.py :: mlstm_chunked (body
// _kernel) on the training path: the forward of ops._MlstmChunkedAD at
// head widths DH in {64, 128, 256, 512}. It is mlstm_chunked_tc.cuh's
// kernel in its kSave instantiation: beside h and the final state it
// writes each 64-step chunk's starting C, n and m and every step's m_t
// and signed qn_t; h and the final state are bitwise those of
// mlstm_chunked_tc.cu. Its own library, so nvcc builds the two
// instantiation sets side by side.
#include "mlstm_chunked_tc.cuh"

// As mlstm_chunked_tc (mlstm_chunked_tc.cu), plus sC [B, NH, K, Dh, Dh],
// sn [B, NH, K, Dh], sm [B, NH, K] (K = ceil(S / 64)), smt, sqn [B, NH,
// S] float32, none null. Returns the launch's CUDA error (0 on success).
extern "C" int mlstm_chunked_tc_save(int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* ig, const void* lf,
                                     const void* C0, const void* n0,
                                     const void* m0, void* h, void* C,
                                     void* n, void* m, int B, int NH, int S,
                                     int Dh, void* sC, void* sn, void* sm,
                                     void* smt, void* sqn, void* prof,
                                     void* stream) {
  if (sC == nullptr || sn == nullptr || sm == nullptr || smt == nullptr ||
      sqn == nullptr)
    return (int)cudaErrorInvalidValue;
  const mlstm_tc::Saved sv{(float*)sC, (float*)sn, (float*)sm, (float*)smt,
                           (float*)sqn};
  return mlstm_tc::run<true>(dtype, q, k, v, ig, lf, C0, n0, m0, h, C, n, m,
                             B, NH, S, Dh, sv, prof, stream);
}
