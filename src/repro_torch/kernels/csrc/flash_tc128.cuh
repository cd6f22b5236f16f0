// The work plan shared by the head_dim-128 flash kernels that walk K/V
// tiles for fixed query rows: flash_fwd_tc128.cu (the forward, 128-key
// tiles) and flash_bwd_dq_tc128.cu (dQ, 64-key tiles).
//
// An item is a pair of 64-row query tiles (rows 128 pr .. 128 pr + 127 of
// one query plane; consumer warpgroup g takes query tile 2 pr + g), and
// the pair streams the union of its two tiles' live K/V tiles. Items are
// numbered heaviest pair first (under a causal mask a later pair sees
// more keys), planes fastest, so that the planes of one KV head run
// together and share its tiles in the L2. The grid is persistent: CTA c
// takes item c of the first round, G - 1 - c of the second, and so on (a
// snake over the rounds, so that every CTA's sum of work is about the
// same), G CTAs in all.
#pragma once

#include "flash_attention.cuh"

namespace flash_tc128 {

constexpr int kPairRows = 64;   // query rows of a warpgroup's tile

struct Sched {
  int Hq, Hkv, planes, npair, items, G;
  // the item of CTA c in round r, or -1 past the last
  __device__ __forceinline__ int item(int c, int r) const {
    const int i = r * G + ((r & 1) ? G - 1 - c : c);
    return i < items ? i : -1;
  }
  __device__ __forceinline__ int pair(int i) const {
    return npair - 1 - i / planes;
  }
  __device__ __forceinline__ int qplane(int i) const { return i % planes; }
  __device__ __forceinline__ int kvplane(int i) const {
    const int p = i % planes;
    return (p / Hq) * Hkv + (p % Hq) / (Hq / Hkv);
  }
};

// The schedule of a launch over B * Hq query planes of Sq rows on `sms`
// SMs, one CTA an SM.
inline Sched make_sched(int B, int Hq, int Hkv, int Sq, int sms) {
  Sched w;
  w.Hq = Hq;
  w.Hkv = Hkv;
  w.planes = B * Hq;
  w.npair = ((Sq + kPairRows - 1) / kPairRows + 1) / 2;
  w.items = w.planes * w.npair;
  w.G = w.items < sms ? w.items : sms;
  return w;
}

// The live BK-key tiles [kt0, kt0 + n) of the query tile at q_lo; none
// when q_lo >= Sq.
template <int BK>
__device__ __forceinline__ void live_tiles(const flash::Mask& mask, int q_lo,
                                           int Sq, int Skv, int* kt0,
                                           int* n) {
  *kt0 = 0;
  *n = 0;
  if (q_lo >= Sq) return;
  int k_begin, k_end;
  flash::live_keys(mask, q_lo, min(Sq, q_lo + kPairRows) - 1, Skv,
                   &k_begin, &k_end);
  if (k_end <= k_begin) return;
  *kt0 = k_begin / BK;
  *n = (k_end + BK - 1) / BK - *kt0;
}

// The BK-key tiles [u0, u1) that the pair at rows 128 pr streams: the
// union of its two query tiles' live tiles (under a plain causal mask
// both warpgroups see the same tiles).
template <int BK>
__device__ __forceinline__ void pair_tiles(const flash::Mask& mask, int pr,
                                           int Sq, int Skv, int* u0,
                                           int* u1) {
  int a0, n0, a1, n1;
  live_tiles<BK>(mask, 2 * pr * kPairRows, Sq, Skv, &a0, &n0);
  live_tiles<BK>(mask, (2 * pr + 1) * kPairRows, Sq, Skv, &a1, &n1);
  if (n0 == 0) a0 = a1, n0 = n1;
  if (n1 == 0) a1 = a0, n1 = n0;
  *u0 = min(a0, a1);
  *u1 = max(a0 + n0, a1 + n1);
}

}  // namespace flash_tc128
