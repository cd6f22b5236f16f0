"""The float32 flash kernels' 3xTF32 arithmetic, emulated on the CPU.

``csrc/flash_fwd_tf32.cu``, ``csrc/flash_bwd_dkv_tf32.cu`` and
``csrc/flash_bwd_dq_tf32.cu`` run every product of the float32 flash
forward, dK/dV and dQ on wgmma in tf32 with float32 accumulation, as
3xTF32: each float32 operand x splits with
round-to-nearest (ties away, ``cvt.rna.tf32.f32``) into big = rna(x) and
small = rna(x - big), and a product is small.big + big.small + big.big.
The forward walks 64-row query tiles over the live 64-key tiles, the
even tiles in one warpgroup and the odd ones in the other, each with an
online softmax in the log2 domain (scores scaled by scale * log2 e,
masked to -inf, max, rescale, p = 2^(x - m), the row sum from the
float32 p, each tile's P V added to O in float32), then merges the two
(m, l, O); lse = m ln 2 + log l, -1e30 for a row that sees no key.
dK/dV works in the transposed frame, 64 keys a CTA, 32-row query tiles
over the GQA group's heads, again the even and the odd tiles of the
walk in two sums added at the end: S^T = K Q^T, dP^T = V dO^T, P^T =
2^(S^T scale log2 e - lse log2 e) (0 where masked), dS^T = P^T (dP^T -
delta) scale, dV += P^T dO, dK += dS^T Q. dQ is dK/dV's mirror image:
64 query rows a CTA over the live 32-key tiles of their KV head, the
even and the odd tiles in two sums added at the end: S = Q K^T, dP =
dO V^T, P = 2^(S scale log2 e - lse log2 e) (0 where masked), dS = P (dP
- delta) scale, dQ += dS K. P, P^T, dS^T and dS are split on the fly as
register A operands, whose k slots hold the accumulator's columns in the
order of the wgmma fragment; the B operand they multiply (V^T, dO^T,
Q^T, K^T) is stored with its rows permuted to match.
:func:`fwd_emulated`, :func:`dkv_emulated` and :func:`dq_emulated` do
exactly that, with the
tf32 rounding as bit arithmetic on float32 tensors and each register-A
product taken slot by slot through both layouts. (The emulation rounds
each float32 sum to nearest; the tensor cores truncate theirs, which is
why the kernels add each tile's products in float32 and why the card
checks, not these, hold that part.)

Held to the card checks' limits (``chip_smoke.py``): o and lse within
1e-5 (``FLASH_ATOL_F32``), dK, dV and dQ within 2e-5
(``FLASH_GRAD_ATOL_F32``), against the float32 plain versions at the
FHDP step's shape (S 256, D 64, non-causal; B and H cut to 1 x 2) and
at causal GQA, ragged, window and q_offset cases, and against the
reference's Pallas kernels in interpret mode. One tf32 pass instead of
three breaks them, which is why the kernels pay for three; and a B
operand stored in the natural row order breaks them, so the permutation
is held here as well as on the card.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import ref

ATOL, GRAD_ATOL = 1e-5, 2e-5       # chip_smoke.py's FLASH_*ATOL_F32
NEG = -1e30                        # flash_attention.cuh's kNegInf
BQ_FWD, BK_FWD = 64, 64            # flash_fwd_tf32.cu's tiles
BK_BWD, BQ_BWD = 64, 32            # flash_bwd_dkv_tf32.cu's tiles
BQ_DQ, BK_DQ = 64, 32              # flash_bwd_dq_tf32.cu's tiles
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)

#: (B, Hq, Hkv, Sq, Skv, mask options): the FHDP step's attention (B and
#: H cut), causal GQA, ragged lengths, a window, Sq < Skv with an offset
CASES = {
    "fhdp": (1, 2, 2, 256, 256, dict(causal=False)),
    "causal-gqa": (1, 4, 2, 128, 128, dict(causal=True)),
    "ragged": (1, 2, 1, 100, 90, dict(causal=False)),
    "window": (1, 2, 2, 160, 160, dict(causal=True, window=40)),
    "offset": (1, 2, 1, 70, 130, dict(causal=True, q_offset=60)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm(a, b, passes):
    """a @ b with tf32 operands: 3 passes (3xTF32) or 1."""
    ab, bb = split(a)[0], split(b)[0]
    if passes == 1:
        return ab @ bb
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


# ---------------------------------------------------- register fragments
#: hopper.cuh's tf32_frag: register i of a k step's A fragment takes the
#: accumulator register 4 kk + O[i]
O = (0, 2, 1, 3)


def a_slot_columns():
    """The accumulator column (within an 8-group) that each k slot of a
    tf32 register-A fragment holds: accumulator register 4j + e of a quad
    thread t sits at row 8 (e >> 1) (+ the thread's row), column 2t +
    (e & 1); A register i at row 8 (i & 1), k slot t + 4 (i >> 1) (the
    wgmma fragment layouts)."""
    cols = [None] * 8
    for t in range(4):
        for i, e in enumerate(O):
            assert (i & 1) == (e >> 1)          # the same row
            cols[t + 4 * (i >> 1)] = 2 * t + (e & 1)
    return cols


def b_slot_rows():
    """The B operand row (within an 8-group) the kernels' split pass
    stores in each k slot: 16-byte chunk p of a group holds rows p + {0,
    2, 4, 6}."""
    return [p + 2 * i for p in range(2) for i in range(4)]


def slot_order(n, slots):
    return torch.tensor([8 * g + s for g in range(n // 8) for s in slots])


def mm_slots(a, b, passes, b_rows=None):
    """a @ b as the register-A wgmmas take it: a's columns through the
    fragment's k slots, b's rows as the split pass stored them."""
    n = a.shape[-1]
    ia = slot_order(n, a_slot_columns())
    ib = slot_order(n, b_rows or b_slot_rows())
    return mm(a[..., ia], b[..., ib, :], passes)


# ------------------------------------------------------------- the masks
def _visible(rows, keys, skv, causal, window, q_offset):
    """[rows, keys] pairs the mask lets through (flash::Mask)."""
    qp = (q_offset + rows)[:, None]
    ok = (keys < skv)[None, :].expand(len(rows), len(keys))
    if causal:
        ok = ok & (keys[None, :] <= qp)
    if window:
        ok = ok & (keys[None, :] > qp - window)
    return ok


def _live_keys(q_lo, q_hi, skv, causal, window, q_offset):
    begin, end = 0, skv
    if causal:
        end = min(skv, q_offset + q_hi + 1)
    if window:
        begin = max(0, q_offset + q_lo - window + 1)
    return begin, end


def _live_rows(k_lo, k_hi, sq, causal, window, q_offset):
    begin, end = 0, sq
    if causal:
        begin = max(0, k_lo - q_offset)
    if window:
        end = min(sq, k_hi + window - q_offset)
    return begin, end


def _rows(x, lo, n):
    """Rows [lo, lo + n) of x [..., S, D], zeros past S."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    hi = min(lo + n, x.shape[-2])
    if hi > lo:
        out[..., :hi - lo, :] = x[..., lo:hi, :]
    return out


# ---------------------------------------------------------- the kernels
def fwd_emulated(q, k, v, *, scale, causal=True, window=None, q_offset=0,
                 passes=3, b_rows=None):
    """flash_fwd_tf32.cu: (o, lse) for q [B, Hq, Sq, 64], k/v [B, Hkv, Skv,
    64] float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    o = torch.zeros_like(q)
    lse = torch.zeros((b, hq, sq))
    for q_lo in range(0, sq, BQ_FWD):
        qt = _rows(q, q_lo, BQ_FWD)
        rows = torch.arange(q_lo, q_lo + BQ_FWD)
        kb, ke = _live_keys(q_lo, min(sq, q_lo + BQ_FWD) - 1, skv, causal,
                            window, q_offset)
        # (m, l, O) of each warpgroup: tiles j = wg, wg + 2, ...
        m = [torch.full((b, hq, BQ_FWD), NEG) for _ in range(2)]
        l = [torch.zeros((b, hq, BQ_FWD)) for _ in range(2)]
        acc = [torch.zeros((b, hq, BQ_FWD, d)) for _ in range(2)]
        kt0 = kb // BK_FWD
        n = -(-ke // BK_FWD) - kt0 if ke > kb else 0
        for j in range(n):
            wg = j % 2
            key0 = (kt0 + j) * BK_FWD
            s = mm(qt, _rows(kx, key0, BK_FWD).transpose(-1, -2), passes)
            ok = _visible(rows, torch.arange(key0, key0 + BK_FWD), skv,
                          causal, window, q_offset)
            x = torch.where(ok, s * sl2, float("-inf"))
            m_new = torch.maximum(m[wg], x.amax(-1))
            corr = torch.exp2(m[wg] - m_new)
            p = torch.exp2(x - m_new[..., None])
            l[wg] = l[wg] * corr + p.sum(-1)
            acc[wg] = acc[wg] * corr[..., None] + mm_slots(
                p, _rows(vx, key0, BK_FWD), passes, b_rows)
            m[wg] = m_new
        mm_ = torch.maximum(m[0], m[1])
        a0, a1 = torch.exp2(m[0] - mm_), torch.exp2(m[1] - mm_)
        lt = l[0] * a0 + l[1] * a1
        out = acc[0] * a0[..., None] + acc[1] * a1[..., None]
        keep = slice(0, min(BQ_FWD, sq - q_lo))
        o[:, :, q_lo:q_lo + BQ_FWD] = (
            out / lt.clamp_min(1e-30)[..., None])[:, :, keep]
        lse[:, :, q_lo:q_lo + BQ_FWD] = torch.where(
            lt > 0, mm_ * LN2 + torch.log(lt), NEG)[:, :, keep]
    return o, lse


def dkv_emulated(q, k, v, do, lse, delta, *, scale, causal=True,
                 window=None, q_offset=0, passes=3, b_rows=None):
    """flash_bwd_dkv_tf32.cu: (dk, dv) for the forward's inputs, its lse,
    dO and delta, all float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    scale = torch.tensor(scale, dtype=torch.float32)
    lse2 = lse * LOG2E
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k_lo in range(0, skv, BK_BWD):
        kt, vt = _rows(k, k_lo, BK_BWD), _rows(v, k_lo, BK_BWD)
        keys = torch.arange(k_lo, k_lo + BK_BWD)
        rb, re = _live_rows(k_lo, min(skv, k_lo + BK_BWD) - 1, sq, causal,
                            window, q_offset)
        # each warpgroup's sums: walk tiles i = head n_rt + t, i % 2 its
        dka = [torch.zeros((b, hkv, BK_BWD, d)) for _ in range(2)]
        dva = [torch.zeros((b, hkv, BK_BWD, d)) for _ in range(2)]
        rt0 = rb // BQ_BWD
        n_rt = -(-re // BQ_BWD) - rt0 if re > rb else 0
        for head in range(g):
            heads = torch.arange(hkv) * g + head
            for t in range(n_rt):
                wg = (head * n_rt + t) % 2
                r0 = (rt0 + t) * BQ_BWD
                qt = _rows(q[:, heads], r0, BQ_BWD)
                dot = _rows(do[:, heads], r0, BQ_BWD)
                cols = slice(r0, r0 + BQ_BWD)
                pad = BQ_BWD - lse2[..., cols].shape[-1]
                l2 = torch.nn.functional.pad(lse2[:, heads, cols], (0, pad))
                dl = torch.nn.functional.pad(delta[:, heads, cols], (0, pad))
                st = mm(kt, qt.transpose(-1, -2), passes)
                dpt = mm(vt, dot.transpose(-1, -2), passes)
                ok = _visible(torch.arange(r0, r0 + BQ_BWD), keys, skv,
                              causal, window, q_offset).T
                ok = ok & (torch.arange(r0, r0 + BQ_BWD) < sq)[None, :]
                p = torch.where(ok, torch.exp2(st * sl2 - l2[..., None, :]),
                                0.0)
                ds = p * (dpt - dl[..., None, :]) * scale
                dva[wg] = dva[wg] + mm_slots(p, dot, passes, b_rows)
                dka[wg] = dka[wg] + mm_slots(ds, qt, passes, b_rows)
        hi = min(skv, k_lo + BK_BWD)
        dk[:, :, k_lo:hi] = (dka[0] + dka[1])[:, :, :hi - k_lo]
        dv[:, :, k_lo:hi] = (dva[0] + dva[1])[:, :, :hi - k_lo]
    return dk, dv


def dq_emulated(q, k, v, do, lse, delta, *, scale, causal=True,
                window=None, q_offset=0, passes=3, b_rows=None):
    """flash_bwd_dq_tf32.cu: dq for the forward's inputs, its lse, dO and
    delta, all float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    scale = torch.tensor(scale, dtype=torch.float32)
    lse2 = lse * LOG2E
    dq = torch.zeros_like(q)
    for q_lo in range(0, sq, BQ_DQ):
        qt, dot = _rows(q, q_lo, BQ_DQ), _rows(do, q_lo, BQ_DQ)
        rows = torch.arange(q_lo, q_lo + BQ_DQ)
        cols = slice(q_lo, q_lo + BQ_DQ)
        pad = BQ_DQ - lse2[..., cols].shape[-1]
        l2 = torch.nn.functional.pad(lse2[..., cols], (0, pad))
        dl = torch.nn.functional.pad(delta[..., cols], (0, pad))
        kb, ke = _live_keys(q_lo, min(sq, q_lo + BQ_DQ) - 1, skv, causal,
                            window, q_offset)
        # each warpgroup's sum: tiles j = wg, wg + 2, ...
        acc = [torch.zeros((b, hq, BQ_DQ, d)) for _ in range(2)]
        kt0 = kb // BK_DQ
        n = -(-ke // BK_DQ) - kt0 if ke > kb else 0
        for j in range(n):
            key0 = (kt0 + j) * BK_DQ
            kt, vt = _rows(kx, key0, BK_DQ), _rows(vx, key0, BK_DQ)
            s = mm(qt, kt.transpose(-1, -2), passes)
            dp = mm(dot, vt.transpose(-1, -2), passes)
            ok = _visible(rows, torch.arange(key0, key0 + BK_DQ), skv,
                          causal, window, q_offset)
            ok = ok & (rows < sq)[:, None]
            p = torch.where(ok, torch.exp2(s * sl2 - l2[..., None]), 0.0)
            ds = p * (dp - dl[..., None]) * scale
            acc[j % 2] = acc[j % 2] + mm_slots(ds, kt, passes, b_rows)
        keep = min(BQ_DQ, sq - q_lo)
        dq[:, :, q_lo:q_lo + keep] = (acc[0] + acc[1])[:, :, :keep]
    return dq


# ----------------------------------------------------------------- tests
def _inputs(seed, b, hq, hkv, sq, skv, d=64):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]
    return [torch.from_numpy(a) for a in arrs]


def _err(a, b):
    return float((a - b).abs().max())


def _plain(q, k, v, do, kw):
    sc = q.shape[-1] ** -0.5
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    delta = ref.flash_attention_bwd_preprocess_ref(o, do)
    dk, dv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                             scale=sc, **kw)
    return o, lse, delta, dk, dv


def _plain_dq(q, k, v, do, lse, delta, kw):
    return ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                          scale=q.shape[-1] ** -0.5, **kw)


def test_register_fragment_and_b_layout_agree():
    """The k order of a register-A fragment (from the fragment layouts and
    tf32_frag's register choice) is the order the split pass stores B's
    rows in: slots 0-3 take rows 0, 2, 4, 6 and slots 4-7 rows 1, 3, 5,
    7."""
    assert a_slot_columns() == b_slot_rows() == [0, 2, 4, 6, 1, 3, 5, 7]
    a = torch.randn(3, 64)
    bm = torch.randn(64, 5)
    np.testing.assert_allclose(mm_slots(a, bm, 3), a @ bm, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_forward_emulation_meets_the_card_limits(case):
    b, hq, hkv, sq, skv, kw = CASES[case]
    q, k, v, do = _inputs(1, b, hq, hkv, sq, skv)
    o, lse, _, _, _ = _plain(q, k, v, do, kw)
    eo, elo = fwd_emulated(q, k, v, scale=64 ** -0.5, **kw)
    assert torch.isfinite(eo).all() and torch.isfinite(elo).all()
    assert _err(eo, o) <= ATOL, _err(eo, o)
    assert _err(elo, lse) <= ATOL, _err(elo, lse)


@pytest.mark.parametrize("case", CASES)
def test_dkv_emulation_meets_the_card_limits(case):
    b, hq, hkv, sq, skv, kw = CASES[case]
    q, k, v, do = _inputs(2, b, hq, hkv, sq, skv)
    _, lse, delta, dk, dv = _plain(q, k, v, do, kw)
    edk, edv = dkv_emulated(q, k, v, do, lse, delta, scale=64 ** -0.5, **kw)
    assert _err(edk, dk) <= GRAD_ATOL, _err(edk, dk)
    assert _err(edv, dv) <= GRAD_ATOL, _err(edv, dv)


@pytest.mark.parametrize("case", CASES)
def test_dq_emulation_meets_the_card_limits(case):
    b, hq, hkv, sq, skv, kw = CASES[case]
    q, k, v, do = _inputs(6, b, hq, hkv, sq, skv)
    _, lse, delta, _, _ = _plain(q, k, v, do, kw)
    dq = _plain_dq(q, k, v, do, lse, delta, kw)
    edq = dq_emulated(q, k, v, do, lse, delta, scale=64 ** -0.5, **kw)
    assert torch.isfinite(edq).all()
    assert _err(edq, dq) <= GRAD_ATOL, _err(edq, dq)


def test_rows_that_see_no_key():
    """A window past the last key: with q_offset 60 and window 8, query
    rows 11 and later see no key. o = 0 and lse = -1e30 there, as on the
    SIMT route and in the plain version; they add nothing to dK/dV."""
    q, k, v, do = _inputs(3, 1, 2, 2, 64, 64)
    kw = dict(causal=True, window=8, q_offset=60)
    o, lse, delta, dk, dv = _plain(q, k, v, do, kw)
    eo, elo = fwd_emulated(q, k, v, scale=0.125, **kw)
    assert not eo[:, :, 11:].any() and eo[:, :, :11].abs().min() > 0
    assert bool((elo[:, :, 11:] == NEG).all())
    assert _err(eo, o) <= ATOL and _err(elo, lse) <= ATOL
    edk, edv = dkv_emulated(q, k, v, do, lse, delta, scale=0.125, **kw)
    assert _err(edk, dk) <= GRAD_ATOL and _err(edv, dv) <= GRAD_ATOL
    edq = dq_emulated(q, k, v, do, lse, delta, scale=0.125, **kw)
    assert not edq[:, :, 11:].any()
    assert _err(edq, _plain_dq(q, k, v, do, lse, delta, kw)) <= GRAD_ATOL


def test_emulation_matches_the_pallas_kernels():
    """At a small non-causal D-64 shape, against the reference's Pallas
    forward, dK/dV and dQ in interpret mode (float32 on both sides)."""
    q, k, v, do = _inputs(4, 1, 2, 1, 40, 72)
    kw = dict(causal=False)
    npy = [t.numpy() for t in (q, k, v, do)]
    jo, jlse = jfa.flash_attention(*npy[:3], block_q=16, block_k=16,
                                   return_lse=True, interpret=True, **kw)
    jdq, jdk, jdv = jfa.flash_attention_bwd(*npy[:3], jo, jlse, npy[3],
                                          block_q=16, block_k=16,
                                          interpret=True, **kw)
    eo, elo = fwd_emulated(q, k, v, scale=0.125, **kw)
    np.testing.assert_allclose(eo.numpy(), np.asarray(jo), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(elo.numpy(), np.asarray(jlse), rtol=0,
                               atol=ATOL)
    lse = torch.from_numpy(np.array(jlse))
    delta = (torch.from_numpy(np.array(jo)) * do).sum(-1)
    edk, edv = dkv_emulated(q, k, v, do, lse, delta, scale=0.125, **kw)
    np.testing.assert_allclose(edk.numpy(), np.asarray(jdk), rtol=0,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(edv.numpy(), np.asarray(jdv), rtol=0,
                               atol=GRAD_ATOL)
    edq = dq_emulated(q, k, v, do, lse, delta, scale=0.125, **kw)
    np.testing.assert_allclose(edq.numpy(), np.asarray(jdq), rtol=0,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("fault", ["one-pass", "natural-b-order"])
def test_a_cheaper_or_misordered_kernel_breaks_the_limits(fault):
    """One tf32 pass instead of three (about 2^-11 of each operand lost),
    or a B operand stored in the natural row order under the register
    fragment's permuted k slots, leaves the card limits at the FHDP
    shape: the checks see both."""
    b, hq, hkv, sq, skv, kw = CASES["fhdp"]
    q, k, v, do = _inputs(5, b, hq, hkv, sq, skv)
    o, lse, delta, dk, dv = _plain(q, k, v, do, kw)
    bad = (dict(passes=1) if fault == "one-pass"
           else dict(b_rows=list(range(8))))
    eo, _ = fwd_emulated(q, k, v, scale=0.125, **kw, **bad)
    edk, edv = dkv_emulated(q, k, v, do, lse, delta, scale=0.125, **kw,
                            **bad)
    edq = dq_emulated(q, k, v, do, lse, delta, scale=0.125, **kw, **bad)
    assert _err(eo, o) > ATOL
    assert max(_err(edk, dk), _err(edv, dv)) > GRAD_ATOL
    assert _err(edq, _plain_dq(q, k, v, do, lse, delta, kw)) > GRAD_ATOL
    assert math.isfinite(_err(eo, o))
