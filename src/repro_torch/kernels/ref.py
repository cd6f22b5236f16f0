"""Plain PyTorch versions of the hand-written kernels (port of the oracles
in ``repro/kernels/ref.py``).

Each function computes what its CUDA kernel computes, op for op, with
ordinary tensor code. They are what a kernel wrapper in
:mod:`repro_torch.kernels.ops` runs for a tensor on the CPU, and the
oracle the kernels are held against on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``). Layouts are the reference's at every
argument, so the CPU tests feed both packages the same numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
INV_QMAX = 0.007874015718698502   #: float32(1 / 127), exactly
LANES = 128                       #: the quantizer's row width
NEAREST_BITS = 1 << 31            #: random word giving u = 0.5: nearest


def _gather_pages(pages, table, scales=None):
    """pages [Hkv, NB, bs, D] through ``table`` (any int shape) ->
    float32 [Hkv, *table.shape, bs, D], dequantized when ``scales``."""
    idx = table.long()
    out = pages[:, idx].float()
    if scales is not None:
        out = out * scales[:, idx]
    return out


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                               *, scale: Optional[float] = None,
                               k_scales=None, v_scales=None):
    """q: [B, Hq, D]; k_pages/v_pages: [Hkv, NB, bs, D]; block_tables:
    [B, T] int32; ctx_lens: [B] int32. Gathers each lane's logical KV
    view through its table, dequantizes when scales are given, masks
    positions >= ctx_len and runs softmax attention in float32. Lanes
    with ``ctx_lens == 0`` return zeros. Positions past ``ctx_len`` are
    zeroed before the value product, so a dead slot pointing at a
    poisoned null block cannot leak NaN into a live lane — the kernel
    never loads such a block at all. Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    g = hq // hkv
    t = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gather_pages(k_pages, block_tables, k_scales)  # [Hkv, B, T, bs, D]
    v = _gather_pages(v_pages, block_tables, v_scales)
    k = k.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    v = v.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    kp = torch.arange(t * bs, device=q.device)
    mask = kp[None, :] < ctx_lens.long()[:, None]            # [B, T*bs]
    v = torch.where(mask[:, None, :, None], v, 0.0)
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    o = torch.where((ctx_lens > 0)[:, None, None, None], o, 0.0)
    return o.reshape(b, hq, d).to(q.dtype)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_table,
                                q_offset: int, ctx_len: int, *,
                                scale: Optional[float] = None,
                                k_scales=None, v_scales=None):
    """q: [Hq, C, D] (row ``c`` at absolute position ``q_offset + c``);
    k_pages/v_pages: [Hkv, NB, bs, D] pools already holding the chunk's
    own K/V; block_table: [T] int32. Causal mask from absolute positions
    (``kp <= q_offset + c`` and ``kp < ctx_len``); rows past ``chunk_len
    = ctx_len - q_offset`` are padding and come back finite but
    meaningless. Returns [Hq, C, D] in q's dtype."""
    hq, c, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    g = hq // hkv
    t = block_table.shape[0]
    scale = scale if scale is not None else d ** -0.5
    k = _gather_pages(k_pages, block_table, k_scales).reshape(hkv, t * bs, d)
    v = _gather_pages(v_pages, block_table, v_scales).reshape(hkv, t * bs, d)
    kp = torch.arange(t * bs, device=q.device)
    v = torch.where((kp < ctx_len)[None, :, None], v, 0.0)
    qg = q.reshape(hkv, g, c, d).float()
    s = torch.einsum("hgcd,hkd->hgck", qg, k) * scale
    qp = q_offset + torch.arange(c, device=q.device)
    mask = (kp[None, :] <= qp[:, None]) & (kp[None, :] < ctx_len)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("hgck,hkd->hgcd", p, v)
    return o.reshape(hq, c, d).to(q.dtype)


def paged_verify_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens,
                               chunk_lens, *, scale: Optional[float] = None,
                               k_scales=None, v_scales=None):
    """The speculative decoder's verify: q [B, Hq, C, D] (row c of lane b
    at position ``ctx_lens[b] + c``); k_pages/v_pages: [Hkv, NB, bs, D]
    pools already holding every window's own K/V; block_tables: [B, T]
    int32; ctx_lens, chunk_lens: [B] int32. Lane b is
    :func:`paged_prefill_attention_ref` of its chunk with ``q_offset =
    ctx_lens[b]`` and ``ctx_len = ctx_lens[b] + chunk_lens[b]``, all lanes
    at once: row (b, c) sees keys ``kp <= ctx_lens[b] + c`` and ``kp <
    ctx_len``. Rows at or past a lane's chunk_len come back finite but
    meaningless; a lane with chunk_len 0 returns zeros. Returns [B, Hq,
    C, D] in q's dtype."""
    b, hq, c, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    g = hq // hkv
    t = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gather_pages(k_pages, block_tables, k_scales)  # [Hkv, B, T, bs, D]
    v = _gather_pages(v_pages, block_tables, v_scales)
    k = k.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    v = v.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    kp = torch.arange(t * bs, device=q.device)
    start = ctx_lens.long()[:, None]                         # [B, 1]
    end = start + chunk_lens.long()[:, None]
    v = torch.where((kp[None, :] < end)[:, None, :, None], v, 0.0)
    qg = q.reshape(b, hkv, g, c, d).float()
    s = torch.einsum("bhgcd,bhkd->bhgck", qg, k) * scale
    qp = start + torch.arange(c, device=q.device)[None, :]  # [B, C]
    mask = ((kp[None, None, :] <= qp[:, :, None])
            & (kp[None, None, :] < end[:, :, None]))         # [B, C, T*bs]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgck,bhkd->bhgcd", p, v)
    o = torch.where((chunk_lens > 0)[:, None, None, None, None], o, 0.0)
    return o.reshape(b, hq, c, d).to(q.dtype)


def verify_decode_gap_bound(q, k_pages, v_pages, block_tables, ctx_lens,
                            chunk_lens, *, scale: Optional[float] = None,
                            k_scales=None, v_scales=None):
    """How far apart, at most, the float32 outputs of the bf16 verify
    (``csrc/paged_prefill_tc.cu``, P split into two bf16 parts) and of
    the paged decode kernel (``csrc/paged_decode_tma.cu``, P in float32)
    can be for the same query row over the same keys, before each is
    rounded to bf16. Arguments as :func:`paged_verify_attention_ref`.
    Returns float64 [B, Hq, C, D]; rows at or past a lane's window are
    meaningless.

    With u = 2^-23 (one float32 rounding, truncation included, as the
    tensor cores' sums do), s_j the row's exact logit in base 2 (scale *
    log2(e) * q.k_j), A_j the same over |q| and |k_j|, m the row's
    largest s_j and n the keys the row sees, each kernel computes, to
    first order:
      * s_j within (D + 4) u A_j (D products summed in some order, the
        scale, int8's row scale, the fused subtraction of m) plus u |s_j
        - m|; 2^(s_j - m) by ex2.approx within 2^-22 more, so each weight
        p_j within rho_j = 2^((D + 4) u A_j + u |s_j - m|) (1 + 2^-22) - 1
        of itself;
      * the normalized weight w_j = p_j / l within rho_j + max rho + n u
        (l is a sum of n weights; the running-max corrections multiply
        acc and l alike and cancel);
      * acc_i = sum_j p_j v_ji within n u (decode) or 2n u (the verify's
        two passes) of sum_j p_j |v_ji|, and the verify's split P within
        2^-16 of p_j (int8: of p_j times V's row scale);
      * the split-K merges, the scale products and the final division
        within 32 u of the output's sum_j w_j |v_ji|.
    The two kernels' gap is the sum of both error budgets:
      sum_j w_j |v_ji| (2 rho_j + 2 max rho + 2^-16 + (5n + 32) u)."""
    b, hq, c, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    g, t = hq // hkv, block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    u = 2.0 ** -23
    base2 = scale * 1.4426950408889634
    k = _gather_pages(k_pages, block_tables, k_scales).double()
    v = _gather_pages(v_pages, block_tables, v_scales).double()
    k = k.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    v = v.permute(1, 0, 2, 3, 4).reshape(b, hkv, t * bs, d)
    kp = torch.arange(t * bs, device=q.device)
    start = ctx_lens.long()[:, None]
    end = start + chunk_lens.long()[:, None]
    seen = (kp[None, :] < end)[:, None, :, None]                # [B,1,K,1]
    k, v = (torch.where(seen, x, 0.0) for x in (k, v))    # the null block
    qp = start + torch.arange(c, device=q.device)[None, :]
    mask = ((kp[None, None, :] <= qp[:, :, None])
            & (kp[None, None, :] < end[:, :, None]))[:, None, None]
    qg = q.double().reshape(b, hkv, g, c, d)
    s = torch.einsum("bhgcd,bhkd->bhgck", qg, k) * base2
    a = torch.einsum("bhgcd,bhkd->bhgck", qg.abs(), k.abs()) * base2
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True).clamp_min(-1e300)
    w = torch.where(mask, torch.exp2(s - m), 0.0)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-300)
    gap = torch.where(mask, (d + 4) * u * a + u * (s - m).abs(), 0.0)
    rho = torch.where(mask, torch.exp2(gap) * (1 + 2.0 ** -22) - 1, 0.0)
    n = mask.sum(-1, keepdim=True).double()
    per = (2 * rho + 2 * rho.amax(-1, keepdim=True) + 2.0 ** -16
           + (5 * n + 32) * u)
    out = torch.einsum("bhgck,bhkd->bhgcd", w * per, v.abs())
    return out.reshape(b, hq, c, d)


def quantize_int8_ref(x, bits):
    """Rowwise-absmax int8 stochastic quantization. x: [M, 128] float;
    bits: [M, 128] torch.uint32 raw random words. Returns (q int8
    [M, 128], scale float32 [M, 1]); all-zero rows emit scale 0 / q 0.
    The scale is ``absmax * float32(1/127)`` — the reference's compiled
    arithmetic, where XLA folds the division by the constant 127 into a
    multiplication — the bits go to float32 through int64 (round to
    nearest, as the reference's uint32 -> float32 conversion), and
    ``x / scale`` is a correctly rounded division: the codes match the
    kernel and the reference bitwise."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    safe = torch.where(absmax > 0.0,
                       absmax * torch.full_like(absmax, INV_QMAX),
                       torch.ones_like(absmax))
    u = bits.to(torch.int64).to(torch.float32) * (2.0 ** -32)
    q = torch.clamp(torch.floor(xf / safe + u), -127.0, 127.0).to(torch.int8)
    scale = torch.where(absmax > 0.0, safe, torch.zeros_like(absmax))
    return q, scale


def _quantize_rows_nearest(x):
    """x [..., D] (D <= 128) -> (int8 [..., D], float32 scales [..., 1]):
    each row zero-padded to 128 lanes and quantized by
    :func:`quantize_int8_ref` with every random word pinned to 2**31."""
    lead, d = x.shape[:-1], x.shape[-1]
    rows = F.pad(x.reshape(-1, d).float(), (0, LANES - d))
    bits = torch.full(rows.shape, -NEAREST_BITS, dtype=torch.int32,
                      device=x.device).view(torch.uint32)
    q, scale = quantize_int8_ref(rows, bits)
    return q[:, :d].reshape(x.shape), scale.reshape(*lead, 1)


def quantize_kv_append_ref(k_pool, v_pool, k_scale, v_scale, k_rows, v_rows,
                           phys=None, off=None, *, table=None) -> None:
    """The int8 KV cache's append as separate operations: quantize K and V
    rows (:func:`_quantize_rows_nearest`), then scatter codes and scales
    into the pools in place. With ``phys``/``off`` row n of [..., R, D]
    goes to ``pool[..., phys[n], off[n]]``; with ``table`` the rows are
    zero-padded to whole blocks of bs and fill blocks ``table[:nb]``."""
    if table is None:
        phys, off = phys.long(), off.long()
        kq, ks = _quantize_rows_nearest(k_rows)
        vq, vs = _quantize_rows_nearest(v_rows)
        k_pool[..., phys, off, :] = kq
        v_pool[..., phys, off, :] = vq
        k_scale[..., phys, off, :] = ks
        v_scale[..., phys, off, :] = vs
        return
    bs, d = k_pool.shape[-2], k_pool.shape[-1]
    s = k_rows.shape[-2]
    pad = (-s) % bs
    if pad:
        k_rows = F.pad(k_rows, (0, 0, 0, pad))
        v_rows = F.pad(v_rows, (0, 0, 0, pad))
    nb = (s + pad) // bs
    lead = k_rows.shape[:-2]
    kq, ks = _quantize_rows_nearest(k_rows.reshape(*lead, nb, bs, d))
    vq, vs = _quantize_rows_nearest(v_rows.reshape(*lead, nb, bs, d))
    row = table[:nb].long()
    k_pool[..., row, :, :] = kq
    v_pool[..., row, :, :] = vq
    k_scale[..., row, :, :] = ks
    v_scale[..., row, :, :] = vs


def paged_decode_append_attention_ref(q, k_rows, v_rows, k_pages, v_pages,
                                      block_tables, ctx_lens, phys, off, *,
                                      scale: Optional[float] = None,
                                      k_scales=None, v_scales=None):
    """A decode step's layer as separate operations: row b of k_rows/
    v_rows [Hkv, B, D] into slot (phys[b], off[b]) of the pools, in place
    (:func:`quantize_kv_append_ref` for int8 pools, else a cast copy),
    then :func:`paged_decode_attention_ref` over ctx_lens + 1 keys."""
    if k_scales is not None:
        quantize_kv_append_ref(k_pages, v_pages, k_scales, v_scales, k_rows,
                               v_rows, phys, off)
    else:
        p, o = phys.long(), off.long()
        k_pages[:, p, o] = k_rows.to(k_pages.dtype)
        v_pages[:, p, o] = v_rows.to(v_pages.dtype)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      ctx_lens + 1, scale=scale,
                                      k_scales=k_scales, v_scales=v_scales)


def dequantize_int8_ref(q, scale, *, dtype=torch.float32):
    """Inverse of :func:`quantize_int8_ref`: ``q * scale`` — one float32
    multiply by the scale tensor (never by a Python scalar, which torch
    may turn into something else on CUDA), bitwise equal to the kernel."""
    return (q.float() * scale).to(dtype)


# --------------------------------------------------------- flash attention
def _acc(t) -> torch.dtype:
    """The float type the flash kernels compute in: float32, or float64
    for float64 inputs (the plain route's gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_mask(sq: int, skv: int, *, causal: bool,
                   window: Optional[int], q_offset: int, device):
    """[Sq, Skv] validity from absolute positions: query row r sits at
    ``q_offset + r`` (the reference's ``_mask_block``)."""
    qp = q_offset + torch.arange(sq, device=device)
    kp = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    return mask


def _grouped(x, hkv: int):
    """[B, Hq, S, D] -> [B, Hkv, G, S, D] (query head h = kv head * G + g)."""
    b, hq = x.shape[:2]
    return x.reshape(b, hkv, hq // hkv, *x.shape[2:])


def flash_attention_ref(q, k, v, *, scale: Optional[float] = None,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, return_lse: bool = False):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]. GQA attention with masks
    from absolute positions, q, k and v read as float32 and both products
    in float32 — the Pallas kernel's precision, not ``dense_mha``'s (which
    casts p to v's dtype). Masked pairs get p = 0 exactly, so a row that
    sees no key returns 0 (the kernels skip such pairs too). Returns o in
    q's dtype and, with ``return_lse``, the float32 row logsumexp
    [B, Hq, Sq]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = _acc(q)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, hkv).to(acc),
                     k.to(acc)) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(acc)) / l
    o = o.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(l)).reshape(b, hq, sq)


def flash_attention_bwd_preprocess_ref(o, do):
    """delta = rowsum(dO * O) in float32: [B, Hq, Sq, D] -> [B, Hq, Sq]."""
    acc = _acc(o)
    return (o.to(acc) * do.to(acc)).sum(dim=-1)


def _bwd_scores(q, k, v, do, lse, delta, *, scale, causal, window,
                q_offset):
    """The recomputed p = exp(s - lse) and dS = p * (dO.v - delta) * scale
    in the grouped layout [B, Hkv, G, Sq, Skv], masked pairs 0."""
    hkv = k.shape[1]
    sq, skv = q.shape[2], k.shape[2]
    acc = _acc(q)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, hkv).to(acc),
                     k.to(acc)) * scale
    p = torch.where(mask, torch.exp(s - _grouped(lse, hkv)[..., None]), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(do, hkv).to(acc),
                      v.to(acc))
    ds = p * (dp - _grouped(delta, hkv)[..., None]) * scale
    return p, ds


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *, scale: float,
                                causal: bool = True,
                                window: Optional[int] = None,
                                q_offset: int = 0):
    """(dK, dV) [B, Hkv, Skv, D], summed over each KV head's query group,
    accumulated in float32 and returned in k's (v's) dtype."""
    p, ds = _bwd_scores(q, k, v, do, lse, delta, scale=scale, causal=causal,
                        window=window, q_offset=q_offset)
    hkv = k.shape[1]
    acc = _acc(q)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, _grouped(do, hkv).to(acc))
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, _grouped(q, hkv).to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *, scale: float,
                               causal: bool = True,
                               window: Optional[int] = None,
                               q_offset: int = 0):
    """dQ [B, Hq, Sq, D] = dS @ K, accumulated in float32, in q's dtype."""
    _, ds = _bwd_scores(q, k, v, do, lse, delta, scale=scale, causal=causal,
                        window=window, q_offset=q_offset)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(_acc(q)))
    return dq.reshape(q.shape).to(q.dtype)


def lora_matmul_ref(x, w, a, b, *, scale: float = 1.0):
    """y = x @ w + scale * (x @ a) @ b: both products and the rank-r
    product in float32, one rounding to x's dtype.

    x: [M, K]; w: [K, N]; a: [K, r]; b: [r, N]."""
    xf = x.float()
    low = (xf @ a.float()) @ b.float()
    return (xf @ w.float() + scale * low).to(x.dtype)


# ------------------------------------------------------------------ mLSTM
def _mlstm_init_state(q, C0, n0, m0):
    """(C, n, m) float32 from the given initial state, or the fresh one:
    C = 0, n = 0, m = -1e30."""
    b, nh, _, dh = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((b, nh, dh, dh), **kw) if C0 is None else C0.float()
    n = torch.zeros((b, nh, dh), **kw) if n0 is None else n0.float()
    m = torch.full((b, nh), NEG_INF, **kw) if m0 is None else m0.float()
    return C, n, m


def mlstm_chunked_ref(q, k, v, ig, lf, *, C0=None, n0=None, m0=None):
    """Stabilized mLSTM over the sequence, step by step: the exact
    recurrence the chunked kernel reproduces (the reference's oracle).

    q/k/v: [B, NH, S, DH] (k pre-scaled); ig/lf: [B, NH, S]; optional
    initial (C0 [B, NH, DH, DH], n0 [B, NH, DH], m0 [B, NH]). Returns
    (h [B, NH, S, DH] in q's dtype, (C, n, m) float32 final states)."""
    C, n, m = _mlstm_init_state(q, C0, n0, m0)
    qf, kf, vf = q.float(), k.float(), v.float()
    igf, lff = ig.float(), lf.float()
    hs = []
    for t in range(q.shape[2]):
        q_t, k_t, v_t = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        i_t, lf_t = igf[:, :, t], lff[:, :, t]
        m_new = torch.maximum(lf_t + m, i_t)
        fs = torch.exp(lf_t + m - m_new)[..., None]
        is_ = torch.exp(i_t - m_new)[..., None]
        C = fs[..., None] * C + is_[..., None] * (v_t[..., :, None]
                                                  * k_t[..., None, :])
        n = fs * n + is_ * k_t
        num = torch.einsum("bhij,bhj->bhi", C, q_t)
        den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q_t).abs(),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    return torch.stack(hs, dim=2).to(q.dtype), (C, n, m)


def mlstm_chunk_body(C, n, m, q, k, v, ig, lf):
    """One chunk of the stabilized mLSTM in parallel (the reference's
    ``models/recurrent.mlstm_chunk_body``, the per-step recurrence
    unrolled exactly).

    q/k/v: [B, NH, c, DH] float32; ig/lf: [B, NH, c]; carry C [B, NH, DH,
    DH], n [B, NH, DH], m [B, NH]. Returns (C', n', m', h [B, NH, c, DH]).

    With b_t = cumsum(lf) (inclusive) and M_t = running max of (i_j - b_j):
      m_t   = b_t + max(m_in, M_t)
      h_t   = [ sum_{j<=t} e^{b_t-b_j+i_j-m_t} v_j (k_j.q_t)
                + e^{m_in+b_t-m_t} C_in q_t ] / den_t
    The decay matrix is masked before its exponent is taken, as the
    kernels do: exp() of a masked (j > t) entry, which may overflow, is
    never taken, so its gradient is 0 and never inf * 0 = NaN (the
    reference exponentiates the whole matrix and masks afterwards: the
    same forward values, NaN gradients once an entry overflows)."""
    return _mlstm_chunk(C, n, m, q, k, v, ig, lf)[:4]


def _mlstm_chunk(C, n, m, q, k, v, ig, lf):
    """:func:`mlstm_chunk_body`, also returning what the backward needs
    of each step: m_t [B, NH, c] and qn_t [B, NH, c], the signed n_t.q_t
    whose magnitude den_t = max(|qn_t|, e^{-m_t}) takes."""
    c = q.shape[2]
    b_ = torch.cumsum(lf, dim=-1)
    a_ = ig - b_
    M = torch.cummax(a_, dim=-1).values
    m_t = b_ + torch.maximum(m[..., None], M)
    m_out = m_t[..., -1]
    D = b_[..., :, None] - b_[..., None, :] + ig[..., None, :] \
        - m_t[..., :, None]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.exp(torch.where(tri, D, float("-inf")))
    S = torch.einsum("bhtd,bhjd->bhtj", q, k)
    inter = torch.exp(m[..., None] + b_ - m_t)
    num = torch.einsum("bhtj,bhjd->bhtd", S * D, v) \
        + inter[..., None] * torch.einsum("bhij,bhtj->bhti", C, q)
    n_t = torch.einsum("bhtj,bhjd->bhtd", D, k) \
        + inter[..., None] * n[..., None, :]
    qn = torch.einsum("bhtd,bhtd->bht", n_t, q)
    den = torch.maximum(qn.abs(), torch.exp(-m_t))[..., None]
    h = num / den
    w_k = torch.exp(b_[..., -1:] - b_ + ig - m_out[..., None])
    carry = torch.exp(m + b_[..., -1] - m_out)
    C_out = carry[..., None, None] * C \
        + torch.einsum("bhtd,bhte->bhde", v * w_k[..., None], k)
    n_out = carry[..., None] * n + torch.einsum("bhtd,bht->bhd", k, w_k)
    return C_out, n_out, m_out, h, m_t, qn


def mlstm_chunkwise_ref(q, k, v, ig, lf, *, chunk: int = 64, C0=None,
                        n0=None, m0=None, states: bool = False):
    """The chunked kernel's function, chunk by chunk: :func:`mlstm_chunk_body`
    over chunks of ``chunk`` steps, the last one shorter when ``chunk``
    does not divide S. Arguments and returns as :func:`mlstm_chunked_ref`;
    q, k and v are read as float32.

    With ``states`` it also returns what :func:`mlstm_chunkwise_bwd_ref`
    takes, as a third item: (Cs [B, NH, K, DH, DH], ns [B, NH, K, DH],
    ms [B, NH, K]) — each of the K chunks' starting state — and (m_t,
    qn_t) [B, NH, S] of every step. h and the final state are the same
    bitwise either way."""
    C, n, m = _mlstm_init_state(q, C0, n0, m0)
    qf, kf, vf = q.float(), k.float(), v.float()
    igf, lff = ig.float(), lf.float()
    hs, saved = [], ([], [], [], [], [])
    for t0 in range(0, q.shape[2], chunk):
        sl = slice(t0, t0 + chunk)
        if states:
            for keep, x in zip(saved, (C, n, m)):
                keep.append(x)
        C, n, m, h, m_t, qn = _mlstm_chunk(
            C, n, m, qf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
            igf[:, :, sl], lff[:, :, sl])
        hs.append(h)
        if states:
            saved[3].append(m_t)
            saved[4].append(qn)
    out = torch.cat(hs, dim=2).to(q.dtype)
    if not states:
        return out, (C, n, m)
    return out, (C, n, m), (torch.stack(saved[0], 2),
                            torch.stack(saved[1], 2),
                            torch.stack(saved[2], 2),
                            torch.cat(saved[3], 2), torch.cat(saved[4], 2))


def _mlstm_chunk_bwd(C, n, m, q, k, v, ig, lf, m_t, qn, h, dh, dC, dn):
    """One chunk's gradients with every stabilizer held constant (see
    :func:`mlstm_chunkwise_bwd_ref`). C, n, m: the chunk's starting state;
    m_t, qn: the forward's per-step values; h, dh: its output and the
    output's cotangent; dC, dn: the cotangent of the chunk's final state.
    Returns (dq, dk, dv, dig, dlf, dC_in, dn_in), float32."""
    c = q.shape[2]
    b_ = torch.cumsum(lf, dim=-1)
    m_out = m_t[..., -1]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.exp(torch.where(
        tri, b_[..., :, None] - b_[..., None, :] + ig[..., None, :]
        - m_t[..., :, None], float("-inf")))
    inter = torch.exp(m[..., None] + b_ - m_t)
    w = torch.exp(b_[..., -1:] - b_ + ig - m_out[..., None])
    carry = torch.exp(m + b_[..., -1] - m_out)
    P = torch.einsum("bhtd,bhjd->bhtj", q, k) * D
    floor = torch.exp(-m_t)
    den = torch.maximum(qn.abs(), floor)
    dnum = dh / den[..., None]
    # den = max(|qn|, e^{-m}): the max splits a tie evenly and |x| takes
    # slope +1 at 0, as JAX differentiates both
    share = torch.where(qn.abs() > floor, 1.0,
                        torch.where(qn.abs() == floor, 0.5, 0.0))
    dqn = -(dh * h).sum(-1) / den * share * torch.where(qn >= 0, 1.0, -1.0)
    dP = torch.where(tri, torch.einsum("bhti,bhji->bhtj", dnum, v)
                     + dqn[..., None], 0.0)
    dS = dP * D
    dlogD = dP * P
    Z = torch.einsum("bhje,bhie->bhji", k, dC)         # dC k_j
    X = torch.einsum("bhti,bhie->bhte", dnum, C)       # C^T dnum_t
    dv = torch.einsum("bhtj,bhti->bhji", P, dnum) + w[..., None] * Z
    dk = torch.einsum("bhtj,bhte->bhje", dS, q) + w[..., None] * (
        torch.einsum("bhji,bhie->bhje", v, dC) + dn[..., None, :])
    dq = torch.einsum("bhtj,bhje->bhte", dS, k) + inter[..., None] * (
        X + dqn[..., None] * n[..., None, :])
    dinter = (X * q).sum(-1) + dqn * torch.einsum("bhe,bhte->bht", n, q)
    dw = (v * Z).sum(-1) + torch.einsum("bhe,bhje->bhj", dn, k)
    dcarry = (dC * C).sum((-2, -1)) + (dn * n).sum(-1)
    gw = dw * w
    db = dlogD.sum(-1) - dlogD.sum(-2) + dinter * inter - gw
    db[..., -1] += gw.sum(-1) + dcarry * carry
    dig = dlogD.sum(-2) + gw
    dlf = db.flip(-1).cumsum(-1).flip(-1)
    dC_in = carry[..., None, None] * dC + torch.einsum(
        "bhti,bhte->bhie", inter[..., None] * dnum, q)
    dn_in = carry[..., None] * dn + torch.einsum("bht,bhte->bhe",
                                                 inter * dqn, q)
    return dq, dk, dv, dig, dlf, dC_in, dn_in


def mlstm_chunkwise_bwd_ref(q, k, v, ig, lf, h, dh, states, *,
                            chunk: int = 64):
    """Gradients (dq, dk, dv [B, NH, S, DH], dig, dlf [B, NH, S], float32)
    of the chunkwise mLSTM's output h through its cotangent ``dh``, from
    ``states`` as :func:`mlstm_chunkwise_ref` returns them for the same
    ``chunk``; no gradient reaches the initial or final state.

    Every stabilized quantity is its unstabilized value times e^{-m}
    (C_k, num_t, n_t.q_t and den_t alike), so h_t = num_t^u / max(|(n.q)
    _t^u|, 1) for any values of the m's: its derivative along every m is
    0, and the gradient with the m's held constant is the true one.
    Autodiff through cummax and maximum reaches the same value up to
    rounding. So no gradient goes through the running max; the gates'
    come through the logs of the decay D_tj = e^{b_t - b_j + i_j - m_t},
    of inter_t = e^{m_in + b_t - m_t}, of w_j = e^{b_c - b_j + i_j - m_c}
    and of the carry e^{m_in + b_c - m_c}, and dlf is the reverse cumsum
    of db within each chunk (b restarts at every chunk). The chunks go in
    reverse, carrying dC and dn; exp() of a masked (j > t) entry is never
    taken."""
    Cs, ns, ms, mts, qns = states
    qf, kf, vf = q.float(), k.float(), v.float()
    igf, lff = ig.float(), lf.float()
    hf, dhf = h.float(), dh.float()
    b, nh, s, dh_ = q.shape
    dC = torch.zeros((b, nh, dh_, dh_), dtype=torch.float32, device=q.device)
    dn = torch.zeros((b, nh, dh_), dtype=torch.float32, device=q.device)
    out = [torch.empty((b, nh, s, dh_), dtype=torch.float32, device=q.device)
           for _ in range(3)]
    out += [torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
            for _ in range(2)]
    for kk in reversed(range(-(-s // chunk))):
        sl = slice(kk * chunk, kk * chunk + chunk)
        *g, dC, dn = _mlstm_chunk_bwd(
            Cs[:, :, kk], ns[:, :, kk], ms[:, :, kk], qf[:, :, sl],
            kf[:, :, sl], vf[:, :, sl], igf[:, :, sl], lff[:, :, sl],
            mts[:, :, sl], qns[:, :, sl], hf[:, :, sl], dhf[:, :, sl], dC,
            dn)
        for o, x in zip(out, g):
            o[:, :, sl] = x
    return tuple(out)
