"""The plain mLSTM chunk body's decay mask, taken before the exponent.

``ref.mlstm_chunk_body`` masks the decay matrix's upper triangle before
exp() is taken, as the kernels do. The reference (``models/recurrent
.mlstm_chunk_body``) exponentiates the whole [c, c] matrix and masks
afterwards: the forward values are the same, but once a masked entry
overflows to inf its gradient is inf * 0 = NaN. These tests hold h
bitwise to the mask-after form and the gradients of sum(h) with respect
to ig finite in four cases where the mask-after form gives NaN in three
(the cases of ROADMAP queue C).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


def _mask_after_body(C, n, m, q, k, v, ig, lf):
    """The reference's chunk body as it was ported: exp() of the whole
    decay matrix, then the mask."""
    c = q.shape[2]
    b_ = torch.cumsum(lf, dim=-1)
    M = torch.cummax(ig - b_, dim=-1).values
    m_t = b_ + torch.maximum(m[..., None], M)
    D = b_[..., :, None] - b_[..., None, :] + ig[..., None, :] \
        - m_t[..., :, None]
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    D = torch.where(tri, torch.exp(D), 0.0)
    S = torch.einsum("bhtd,bhjd->bhtj", q, k)
    inter = torch.exp(m[..., None] + b_ - m_t)
    num = torch.einsum("bhtj,bhjd->bhtd", S * D, v) \
        + inter[..., None] * torch.einsum("bhij,bhtj->bhti", C, q)
    n_t = torch.einsum("bhtj,bhjd->bhtd", D, k) \
        + inter[..., None] * n[..., None, :]
    den = torch.maximum(torch.einsum("bhtd,bhtd->bht", n_t, q).abs(),
                        torch.exp(-m_t))[..., None]
    return num / den


def _case(chunk, log_f, spike):
    """q, k, v [1, 1, chunk, 16], ig [1, 1, chunk] (one entry 90 above
    the rest with ``spike``), lf constant ``log_f``; a fresh state."""
    rng = np.random.default_rng(11)
    dh = 16

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = rand(1, 1, chunk, dh), rand(1, 1, chunk, dh) * dh ** -0.5, \
        rand(1, 1, chunk, dh)
    ig = rand(1, 1, chunk)
    if spike:
        ig[..., chunk // 2] += 90.0
    lf = torch.full((1, 1, chunk), log_f)
    state = ref._mlstm_init_state(q, None, None, None)
    return state, q, k, v, ig, lf


CASES = [(256, -0.3, False), (256, -0.4, False), (64, -1.5, False),
         (64, 0.0, True)]
IDS = ["c256-logf-0.3", "c256-logf-0.4", "c64-logf-1.5", "c64-ig-spike"]


@pytest.mark.parametrize("chunk,log_f,spike", CASES, ids=IDS)
def test_mask_before_exp_keeps_h_and_the_gradients_finite(chunk, log_f,
                                                          spike):
    (C, n, m), q, k, v, ig, lf = _case(chunk, log_f, spike)
    if spike:
        lf = torch.nn.functional.logsigmoid(torch.full_like(lf, 2.0))
    ig_new = ig.clone().requires_grad_()
    h = ref.mlstm_chunk_body(C, n, m, q, k, v, ig_new, lf)[3]
    (g_new,) = torch.autograd.grad(h.sum(), ig_new)
    ig_old = ig.clone().requires_grad_()
    h_old = _mask_after_body(C, n, m, q, k, v, ig_old, lf)
    (g_old,) = torch.autograd.grad(h_old.sum(), ig_old)
    assert torch.equal(h, h_old)
    assert bool(torch.isfinite(h).all())
    assert bool(torch.isfinite(g_new).all())
    nan_old = int(torch.isnan(g_old).sum())
    if (chunk, log_f) == (256, -0.3):
        assert nan_old == 0
    else:
        assert nan_old > 0        # the mask-after form's NaN gradients
        finite = torch.isfinite(g_old)
        assert torch.allclose(g_new[finite], g_old[finite], rtol=1e-5,
                              atol=1e-6)
