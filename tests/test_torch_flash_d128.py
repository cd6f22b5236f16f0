"""The flash kernels at head_dim 128 on the CPU.

The port's flash forward and backward wrappers (their plain versions on
the CPU) against the reference's Pallas kernels in interpret mode, on the
same numpy inputs, at head_dim 128 and GQA groups of 5 (Hq 5 over Hkv 1,
as qwen3-14b's 40 over 8) and 1: o, lse, dq, dk, dv and delta at atol
1e-5 (float32 math on both sides, in different orders) in the causal,
windowed, offset (Sq < Skv), ragged and unmasked cases of
``tests/test_torch_flash.py``. Then ``ops.flash_route``'s table: bf16 at
head_dim 128 sends the forward, dK/dV and dQ to their tensor-core
kernels ("wgmma128"). Last, the work plans of
``csrc/flash_fwd_tc128.cu``, ``csrc/flash_bwd_dkv_tc128.cu`` and
``csrc/flash_bwd_dq_tc128.cu``, repeated in Python: every visible
(query, key) pair is computed by exactly one consumer warpgroup, and
every tile a CTA streams is waited for and released by each of its
consumers (no deadlock, no copy left in flight).
"""
import itertools

import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import ops

ATOL = 1e-5
D = 128

#: (Sq, Skv, mask options), as tests/test_torch_flash.py's CASES
CASES = {
    "causal": (64, 64, dict(causal=True)),
    "window": (48, 48, dict(causal=True, window=9)),
    "offset": (40, 64, dict(causal=True, q_offset=24)),
    "ragged": (37, 37, dict(causal=True)),
    "noncausal": (40, 64, dict(causal=False)),
}
#: (Hq, Hkv): a GQA group of 5 and of 1
GROUPS = {"g5": (5, 1), "g1": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, sq, skv, hq, hkv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, hq, sq, D)).astype(np.float32)
    k = rng.standard_normal((1, hkv, skv, D)).astype(np.float32)
    v = rng.standard_normal((1, hkv, skv, D)).astype(np.float32)
    do = rng.standard_normal((1, hq, sq, D)).astype(np.float32)
    return q, k, v, do


def _close(want, got):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("case", CASES)
def test_flash_d128_matches_pallas(case, group):
    """Forward (o, lse) and backward (delta, dq, dk, dv) at head_dim 128
    against the Pallas kernels in interpret mode."""
    sq, skv, kw = CASES[case]
    q, k, v, do = _qkv(11, sq, skv, *GROUPS[group])
    o, lse = jfa.flash_attention(q, k, v, block_q=16, block_k=16,
                                 return_lse=True, interpret=True, **kw)
    want = jfa.flash_attention_bwd(q, k, v, o, lse, do, block_q=16,
                                   block_k=16, interpret=True, **kw)
    T = torch.from_numpy
    got_o, got_lse = ops.flash_attention(T(q), T(k), T(v), return_lse=True,
                                         **kw)
    _close(o, got_o)
    _close(lse, got_lse)
    got = ops.flash_attention_bwd(T(q), T(k), T(v), got_o, got_lse, T(do),
                                  **kw)
    for w, g in zip(want, got):
        _close(w, g)
    delta = ops.flash_attention_bwd_preprocess(got_o, T(do))
    _close((np.asarray(o) * do).sum(-1), delta)


def test_flash_route_table():
    """bf16 at head_dim 128: the forward, dK/dV and dQ on "wgmma128";
    float32 at 128 and every dtype at 32 on "simt"; head_dim 64
    unchanged (bf16 "wgmma", float32 "tf32x3")."""
    bf16, f32 = torch.bfloat16, torch.float32
    want = {(bf16, 128): ("wgmma128", "wgmma128", "wgmma128"),
            (f32, 128): ("simt", "simt", "simt"),
            (bf16, 32): ("simt", "simt", "simt"),
            (f32, 32): ("simt", "simt", "simt"),
            (bf16, 64): ("wgmma", "wgmma", "wgmma"),
            (f32, 64): ("tf32x3", "tf32x3", "tf32x3")}
    for (dtype, d), routes in want.items():
        got = tuple(ops.flash_route(kind, dtype, d)
                    for kind in ("fwd", "dkv", "dq"))
        assert got == routes, (dtype, d, got)
    counted = ops.route_counts()
    assert "wgmma128" in counted["flash_attention"]
    assert "wgmma128" in counted["flash_attention_bwd_dkv"]
    assert "wgmma128" in counted["flash_attention_bwd_dq"]


# ----------------------------------------------- the kernels' work plans
BQ = 64       # query rows of a warpgroup's tile (all three kernels)
FWD_BK = 128  # keys of the forward's K/V tiles
DKV_BK = 64   # keys of a dK/dV CTA
DQ_BK = 64    # keys of dQ's K/V tiles


def _live_keys(q_lo, q_hi, skv, causal, window, q_offset):
    """flash::live_keys: keys [begin, end) rows q_lo..q_hi may see."""
    begin, end = 0, skv
    if causal:
        end = min(skv, q_offset + q_hi + 1)
    if window:
        begin = max(0, q_offset + q_lo - window + 1)
    return begin, end


def _live_rows(k_lo, k_hi, sq, causal, window, q_offset):
    """flash::live_rows: query rows [begin, end) that may see keys
    k_lo..k_hi."""
    begin, end = 0, sq
    if causal:
        begin = max(0, k_lo - q_offset)
    if window:
        end = min(sq, k_hi + window - q_offset)
    return begin, end


def _sees(row, key, causal, window, q_offset):
    qp = q_offset + row
    return (not causal or key <= qp) and (not window or key > qp - window)


def _tiles(q_lo, sq, skv, mk, bk=FWD_BK):
    """flash_tc128.cuh live_tiles<bk> (the forward's 128, dQ's 64): (kt0,
    n) of the query tile at q_lo."""
    if q_lo >= sq:
        return 0, 0
    kb, ke = _live_keys(q_lo, min(sq, q_lo + BQ) - 1, skv, *mk)
    if ke <= kb:
        return 0, 0
    return kb // bk, -(-ke // bk) - kb // bk


def _snake(c, r, g, items):
    """flash_tc128.cuh Sched::item: CTA c's item in round r, or -1."""
    i = r * g + (g - 1 - c if r & 1 else c)
    return i if i < items else -1


def _fwd_plan(sq, skv, mk, planes=3, g=4, bk=FWD_BK):
    """Per (plane, query tile), the K/V tiles (of ``bk`` keys: the
    forward's 128, dQ's 64) its warpgroup computes, walking each CTA's
    items as the kernel does; asserts each item's ring protocol (each
    consumer passes or uses every streamed tile, its own tiles inside
    the stream)."""
    nqt = -(-sq // BQ)
    npair = (nqt + 1) // 2
    items = planes * npair
    g = min(g, items)
    done = {}
    for c in range(g):
        r = 0
        while _snake(c, r, g, items) >= 0:
            i = _snake(c, r, g, items)
            pr, plane = npair - 1 - i // planes, i % planes
            (a0, n0), (a1, n1) = (_tiles(2 * pr * BQ, sq, skv, mk, bk),
                                  _tiles((2 * pr + 1) * BQ, sq, skv, mk, bk))
            if n0 == 0:
                a0, n0 = a1, n1
            if n1 == 0:
                a1, n1 = a0, n0
            u0, u1 = min(a0, a1), max(a0 + n0, a1 + n1)
            for wg in range(2):
                qt = 2 * pr + wg
                kt0, n = _tiles(qt * BQ, sq, skv, mk, bk)
                if n:
                    assert u0 <= kt0 and kt0 + n <= u1
                if qt * BQ < sq:
                    assert (plane, qt) not in done
                    done[(plane, qt)] = set(range(kt0, kt0 + n))
            r += 1
    assert sorted(done) == [(p, t) for p in range(planes)
                            for t in range(nqt)]
    return done


#: (Sq, Skv, mask options): the card tests' tile edges and the training
#: shape's masks (causal, window, offset, none)
PLAN_CASES = {"sq1": (1, 77, dict(q_offset=76)),
              "ragged-offset": (100, 130, dict(q_offset=30)),
              "window": (300, 300, dict(window=40)),
              "tiny-window": (200, 200, dict(window=1)),
              "full": (70, 90, dict(causal=False)),
              "full-window": (130, 70, dict(causal=False, window=20)),
              "no-key": (64, 64, dict(window=8, q_offset=60)),
              "odd-pairs": (5 * 64 + 3, 5 * 64 + 3, {}),
              "train": (1024, 1024, {})}


def _mk(kw):
    return (kw.get("causal", True), kw.get("window"), kw.get("q_offset", 0))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_forward_plan_covers_every_visible_pair(case):
    """Every (query row, key) pair the mask lets through lies in a K/V
    tile that the row's warpgroup computes."""
    sq, skv, kw = PLAN_CASES[case]
    mk = _mk(kw)
    done = _fwd_plan(sq, skv, mk)
    for row, key in itertools.product(range(sq), range(skv)):
        if _sees(row, key, *mk):
            assert key // FWD_BK in done[(0, row // BQ)], (row, key)


@pytest.mark.parametrize("items", [1, 7, 131, 132, 133, 640])
def test_forward_schedule_deals_every_item_once(items):
    """The persistent forward's snake: over G = min(items, 132) CTAs
    every item is taken exactly once, and no CTA's work (pair index + 1,
    the causal cost) exceeds the mean by more than one item's."""
    g = min(items, 132)
    npair = 8
    taken, load = [], []
    for c in range(g):
        mine, r = [], 0
        while _snake(c, r, g, items) >= 0:
            mine.append(_snake(c, r, g, items))
            r += 1
        taken += mine
        load.append(sum(npair - (i * npair) // items for i in mine))
    assert sorted(taken) == list(range(items))
    assert max(load) - sum(load) / g <= npair


@pytest.mark.parametrize("case", PLAN_CASES)
def test_dkv_plan_covers_every_visible_pair(case):
    """The dK/dV walk: a CTA of 64 keys visits the live query tiles of
    every head of the group, its two warpgroups taking them in turn;
    every visible (row, key) pair of every head is in exactly one
    warpgroup's tiles."""
    sq, skv, kw = PLAN_CASES[case]
    mk = _mk(kw)
    g = 3
    seen = {}
    for kb in range(-(-skv // DKV_BK)):
        k_lo = kb * DKV_BK
        rb, re_ = _live_rows(k_lo, min(skv, k_lo + DKV_BK) - 1, sq, *mk)
        rt0 = rb // BQ
        n_rt = -(-re_ // BQ) - rt0 if re_ > rb else 0
        for i in range(g * n_rt):
            wg, head, rt = i % 2, i // n_rt, rt0 + i % n_rt
            assert 0 <= rt * BQ < sq
            for row in range(rt * BQ, min(sq, rt * BQ + BQ)):
                for key in range(k_lo, min(skv, k_lo + DKV_BK)):
                    if _sees(row, key, *mk):
                        assert (head, row, key) not in seen
                        seen[(head, row, key)] = wg
    want = sum(_sees(r, k, *mk) for r in range(sq) for k in range(skv))
    assert len(seen) == g * want


@pytest.mark.parametrize("case", PLAN_CASES)
def test_dq_plan_covers_every_visible_pair(case):
    """dQ's schedule is the forward's with 64-key tiles: over the
    persistent snake every (query tile, head) is dealt exactly once, each
    warpgroup's live tiles lie inside its pair's stream (it passes the
    rest), and every visible (query row, key) pair lies in a 64-key tile
    that the row's warpgroup multiplies into its dQ."""
    sq, skv, kw = PLAN_CASES[case]
    mk = _mk(kw)
    done = _fwd_plan(sq, skv, mk, bk=DQ_BK)
    for row, key in itertools.product(range(sq), range(skv)):
        if _sees(row, key, *mk):
            assert key // DQ_BK in done[(0, row // BQ)], (row, key)
    for (_, qt), tiles in done.items():       # no tile past the keys
        assert all(0 <= j * DQ_BK < skv for j in tiles), (qt, tiles)
