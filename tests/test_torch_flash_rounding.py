"""The rounding design of the bf16 tensor-core flash kernels, emulated in
plain PyTorch on the CPU and held to the limit the card check applies.

``csrc/flash_fwd_tc.cu``, ``csrc/flash_bwd_dkv_tc.cu`` and
``csrc/flash_bwd_dq_tc.cu`` take bf16 operands with float32 accumulation,
as the float32 plain versions do, but round intermediates to bf16 where
the plain versions keep float32:

  * forward: P, once per 64-key tile of the online softmax (relative to
    that tile's running max), before the P V product; the row sum l comes
    from the float32 P;
  * dK/dV: P^T and dS^T, before the dV and dK products;
  * dQ: dS, once per 64-key tile, before the dS K product.

This file repeats that arithmetic tile by tile in float32 with the same
roundings and holds it against :func:`ref.flash_attention_ref`,
:func:`ref.flash_attention_bwd_dkv_ref` and
:func:`ref.flash_attention_bwd_dq_ref` at the training and distillation
paths' sequence lengths (1024 causal, 1032 causal, a 256-key window, and
q_offset 256 with Sq 768) at B 1, Hq 2, Hkv 1, D 64: o, dk, dv and dq
within one bf16 ulp of the largest magnitude (2^-7 of it), lse within
1e-5 of its magnitude: the limits ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` apply to the kernels on the card. Inputs
come from numpy with a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

BF16_ULP = 2.0 ** -7
BK = 64                      # keys of a tile (flash_fwd_tc.cu)
D = 64
CASES = {"causal-1024": (1024, 1024, {}),
         "distill-1032": (1032, 1032, {}),
         "window-256": (1024, 1024, {"window": 256}),
         "offset-256": (768, 1024, {"q_offset": 256})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(sq, skv, seed):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    return bf16(1, 2, sq, D), bf16(1, 1, skv, D), bf16(1, 1, skv, D), \
        bf16(1, 2, sq, D)


def _round(x):
    return x.to(torch.bfloat16).float()


def _mask(sq, skv, kw):
    return ref.attention_mask(sq, skv, causal=True, window=kw.get("window"),
                              q_offset=kw.get("q_offset", 0), device="cpu")


def forward_bf16_route(q, k, v, **kw):
    """The tensor-core forward's arithmetic: an online softmax over
    64-key tiles, P rounded to bf16 before P V, l from float32 P."""
    sq, skv = q.shape[2], k.shape[2]
    scale = D ** -0.5
    mask = _mask(sq, skv, kw)
    qf, kf, vf = q.float()[0], k.float()[0, 0], v.float()[0, 0]
    m = torch.full((2, sq, 1), ref.NEG_INF)
    l = torch.zeros((2, sq, 1))
    acc = torch.zeros((2, sq, D))
    for k0 in range(0, skv, BK):
        s = qf @ kf[k0:k0 + BK].T * scale
        s = torch.where(mask[:, k0:k0 + BK], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _round(p) @ vf[k0:k0 + BK]
        m = m_new
    o = (acc / l.clamp_min(1e-30)).to(torch.bfloat16)[None]
    return o, (m + torch.log(l))[None, ..., 0]


def dkv_bf16_route(q, k, v, do, lse, delta, **kw):
    """The tensor-core dK/dV's arithmetic: p and dS in float32, rounded
    to bf16 before the dV and dK products, sums over both query heads."""
    sq, skv = q.shape[2], k.shape[2]
    scale = D ** -0.5
    mask = _mask(sq, skv, kw)
    qf, kf, vf, dof = q.float()[0], k.float()[0, 0], v.float()[0, 0], \
        do.float()[0]
    s = qf @ kf.T * scale
    p = torch.where(mask, torch.exp(s - lse[0, :, :, None]), 0.0)
    ds = p * (dof @ vf.T - delta[0, :, :, None]) * scale
    dv = torch.einsum("hqk,hqd->kd", _round(p), dof)
    dk = torch.einsum("hqk,hqd->kd", _round(ds), qf)
    return (dk.to(torch.bfloat16)[None, None],
            dv.to(torch.bfloat16)[None, None])


def dq_bf16_route(q, k, v, do, lse, delta, **kw):
    """The tensor-core dQ's arithmetic, tile by tile over 64-key tiles:
    p and dS in float32, dS rounded to bf16 before the dS K product,
    which accumulates in float32; dQ rounded once to bf16."""
    sq, skv = q.shape[2], k.shape[2]
    scale = D ** -0.5
    mask = _mask(sq, skv, kw)
    qf, kf, vf, dof = q.float()[0], k.float()[0, 0], v.float()[0, 0], \
        do.float()[0]
    acc = torch.zeros((2, sq, D))
    for k0 in range(0, skv, BK):
        kt, vt = kf[k0:k0 + BK], vf[k0:k0 + BK]
        s = qf @ kt.T * scale
        p = torch.where(mask[:, k0:k0 + BK], torch.exp(s - lse[0, :, :, None]),
                        0.0)
        ds = p * (dof @ vt.T - delta[0, :, :, None]) * scale
        acc = acc + _round(ds) @ kt
    return acc.to(torch.bfloat16)[None]


def _within_ulp(got, want):
    err = float((got.float() - want.float()).abs().max())
    tol = BF16_ULP * float(want.float().abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("case", CASES)
def test_forward_rounding_within_one_bf16_ulp(case):
    sq, skv, kw = CASES[case]
    q, k, v, _ = _inputs(sq, skv, 0)
    o, lse = forward_bf16_route(q, k, v, **kw)
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert o.dtype == ro.dtype == torch.bfloat16
    _within_ulp(o, ro)
    assert float((lse - rlse).abs().max()) <= 1e-5 * max(
        1.0, float(rlse.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_dkv_rounding_within_one_bf16_ulp(case):
    sq, skv, kw = CASES[case]
    q, k, v, do = _inputs(sq, skv, 1)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    delta = ref.flash_attention_bwd_preprocess_ref(o, do)
    dk, dv = dkv_bf16_route(q, k, v, do, lse, delta, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=D ** -0.5, **kw)
    _within_ulp(dk, rdk)
    _within_ulp(dv, rdv)



@pytest.mark.parametrize("case", CASES)
def test_dq_rounding_within_one_bf16_ulp(case):
    sq, skv, kw = CASES[case]
    q, k, v, do = _inputs(sq, skv, 2)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    delta = ref.flash_attention_bwd_preprocess_ref(o, do)
    dq = dq_bf16_route(q, k, v, do, lse, delta, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         scale=D ** -0.5, **kw)
    assert dq.dtype == rdq.dtype == torch.bfloat16
    _within_ulp(dq, rdq)
