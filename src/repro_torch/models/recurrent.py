"""Recurrent cells: the xLSTM's mLSTM and sLSTM (arXiv:2405.04517) and
Hymba's Mamba heads (port of ``repro/models/recurrent.py``).

The cells expose, as in the reference:
  init_*(gen, cfg, device, lead)     -> params
  apply_*_seq(p, x, cfg, state)      -> (y, final_state)   # prefill
  apply_*_step(p, x_t, state, cfg)   -> (y_t, new_state)   # decode
  init_*_state(cfg, batch, device)   -> state dict

The mLSTM's sequence part runs through :func:`repro_torch.kernels.ops
.mlstm_chunked`: the hand-written chunkwise kernel on the card, its plain
chunkwise version on the CPU; when autograd records it, through
:func:`repro_torch.kernels.ops.mlstm_chunked_ad`, whose backward is the
hand-written backward kernel (the reference differentiates the chunk body
with XLA). The sLSTM is a true nonlinear recurrence (h_{t-1} feeds the
gates through a matmul), which the reference leaves to XLA: here it is
plain PyTorch, a Python loop over time steps, and autograd takes its
backward. The Mamba's selective scan is XLA in the reference too: here
plain PyTorch, a sequential carry across chunks and a doubling scan
within one (log2 of the chunk's length steps over [B, c, d_inner, N]
float32, never a loop over time steps).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, mlstm_chunk_body  # noqa: F401
from repro_torch.models.blocks import _normal


def _norm(x, scale, eps=1e-6):
    """RMS norm in float32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _log_sigmoid(x):
    """-softplus(-x) with JAX's softplus, logaddexp(x, 0) (torch's
    ``softplus`` turns into the identity above 20)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def _causal_conv(x, w):
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out


# ================================================================ mLSTM =====
def mlstm_dims(cfg: ModelConfig):
    di = cfg.ssm.expand * cfg.d_model
    nh = cfg.num_heads
    return di, nh, di // nh


def init_mlstm(gen, cfg: ModelConfig, device,
               lead: Tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    di, nh, _ = mlstm_dims(cfg)
    dt, f32 = cfg.dtype, torch.float32
    s, si = d ** -0.5, di ** -0.5
    b_if = torch.cat([torch.zeros(nh), torch.linspace(3.0, 6.0, nh)])
    return {
        "ln": torch.ones(lead + (d,), dtype=dt, device=device),
        "w_in": _normal(gen, lead + (d, 2 * di), s, dt, device),
        "conv": _normal(gen, lead + (cfg.ssm.conv_kernel, di), 0.1, dt,
                        device),
        "wq": _normal(gen, lead + (di, di), si, dt, device),
        "wk": _normal(gen, lead + (di, di), si, dt, device),
        "wv": _normal(gen, lead + (di, di), si, dt, device),
        "w_if": _normal(gen, lead + (di, 2 * nh), si, f32, device),
        "b_if": b_if.to(device).expand(lead + (2 * nh,)).clone(),
        "gn": torch.ones(lead + (di,), dtype=dt, device=device),
        "w_out": _normal(gen, lead + (di, d), si, dt, device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    di, nh, dh = mlstm_dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, nh, dh, dh), **kw),
        "n": torch.zeros((batch, nh, dh), **kw),
        "m": torch.full((batch, nh), NEG_INF, **kw),
        "conv": torch.zeros((batch, cfg.ssm.conv_kernel - 1, di),
                            dtype=cfg.dtype, device=device),
    }


def _mlstm_qkvgates(p, x, cfg: ModelConfig, conv_state=None):
    """Heads q, k (pre-scaled), v [B, NH, S, DH] float32 contiguous, gates
    ig, lf [B, NH, S] float32, the output gate's input z and the new conv
    window (None without ``conv_state``)."""
    di, nh, dh = mlstm_dims(cfg)
    xz = _norm(x, p["ln"]) @ p["w_in"]
    xi, z = xz.split(di, dim=-1)
    if conv_state is not None:   # prepend the cached conv inputs
        xi_full = torch.cat([conv_state, xi], dim=1)
        new_conv = xi_full[:, -(cfg.ssm.conv_kernel - 1):, :]
        s = xi.shape[1]
        w = p["conv"]
        xi = xi_full[:, 0:s] * w[0]
        for i in range(1, w.shape[0]):
            xi = xi + xi_full[:, i:i + s] * w[i]
    else:
        xi = _causal_conv(xi, p["conv"])
        new_conv = None
    xi = F.silu(xi)
    b, s, _ = xi.shape

    def heads(t):
        return t.reshape(b, s, nh, dh).transpose(1, 2).float().contiguous()

    q = heads(xi @ p["wq"])
    k = heads(xi @ p["wk"]) * dh ** -0.5
    v = heads(xi @ p["wv"])
    gates = xi.float() @ p["w_if"] + p["b_if"]
    ig, fg = gates.split(nh, dim=-1)                  # [B, S, NH]
    lf = _log_sigmoid(fg)
    return (q, k, v, ig.transpose(1, 2).contiguous(),
            lf.transpose(1, 2).contiguous(), z, new_conv)


def _mlstm_update(C, n, m, q_t, k_t, v_t, i_t, lf_t):
    """One stabilized mLSTM step. C [B, NH, DH, DH]; q/k/v [B, NH, DH];
    i/lf [B, NH]."""
    m_new = torch.maximum(lf_t + m, i_t)
    fs = torch.exp(lf_t + m - m_new)[..., None]
    is_ = torch.exp(i_t - m_new)[..., None]
    C_new = fs[..., None] * C + is_[..., None] * (v_t[..., :, None]
                                                  * k_t[..., None, :])
    n_new = fs * n + is_ * k_t
    num = torch.einsum("bhij,bhj->bhi", C_new, q_t)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n_new, q_t).abs(),
                        torch.exp(-m_new))[..., None]
    return C_new, n_new, m_new, num / den


def _mlstm_out(p, h, z, x_dtype):
    """[B, NH, S, DH] cell output -> y [B, S, d]: h in x's dtype, group
    norm, the silu(z) output gate and the down projection."""
    b, nh, s, dh = h.shape
    h = h.transpose(1, 2).reshape(b, s, nh * dh).to(x_dtype)
    return (_norm(h, p["gn"]) * F.silu(z)) @ p["w_out"]


def _chunk(s: int, chunk: int) -> int:
    """The reference's chunk: the largest divisor of s that is <= chunk."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def apply_mlstm_seq(p, x, cfg: ModelConfig, state=None, chunk: int = 256):
    """x: [B, S, d] -> (y [B, S, d], final_state). The conv window is
    carried (zeros for a fresh state), so chunked prefill and segment
    continuation match token-by-token decode. The sequence part is one
    :func:`repro_torch.kernels.ops.mlstm_chunked` call from the state's
    (C, n, m); ``chunk`` sets the plain route's chunk as the reference
    picks it (the largest divisor of S up to ``chunk``); the kernel
    tiles the sequence its own way. With grad enabled the call is
    :func:`repro_torch.kernels.ops.mlstm_chunked_ad` (the forward kernel
    saving each chunk's state, the backward kernel in the backward pass);
    serving, under no_grad, runs the forward kernel alone."""
    b, s, _ = x.shape
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)
    q, k, v, ig, lf, z, new_conv = _mlstm_qkvgates(
        p, x, cfg, conv_state=state["conv"])
    cell = ops.mlstm_chunked_ad if torch.is_grad_enabled() \
        else ops.mlstm_chunked
    h, (C, n, m) = cell(
        q, k, v, ig, lf, chunk=_chunk(s, chunk),
        C0=state["C"].contiguous(), n0=state["n"].contiguous(),
        m0=state["m"].contiguous())
    y = _mlstm_out(p, h, z, x.dtype)
    return y, {"C": C, "n": n, "m": m, "conv": new_conv}


def apply_mlstm_step(p, x_t, state, cfg: ModelConfig):
    """x_t: [B, 1, d]."""
    q, k, v, ig, lf, z, new_conv = _mlstm_qkvgates(
        p, x_t, cfg, conv_state=state["conv"])
    C, n, m, h = _mlstm_update(state["C"], state["n"], state["m"],
                               q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               ig[:, :, 0], lf[:, :, 0])
    y = _mlstm_out(p, h[:, :, None], z, x_t.dtype)
    return y, {"C": C, "n": n, "m": m, "conv": new_conv}


# ================================================================ sLSTM =====
def init_slstm(gen, cfg: ModelConfig, device,
               lead: Tuple[int, ...] = ()) -> dict:
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    dt, f32 = cfg.dtype, torch.float32
    b = torch.cat([torch.zeros(d), torch.linspace(3.0, 6.0, d),
                   torch.zeros(2 * d)])
    return {
        "ln": torch.ones(lead + (d,), dtype=dt, device=device),
        "w": _normal(gen, lead + (d, 4 * d), d ** -0.5, f32, device),
        "r": _normal(gen, lead + (nh, dh, 4 * dh), dh ** -0.5, f32, device),
        "b": b.to(device).expand(lead + (4 * d,)).clone(),
        "gn": torch.ones(lead + (d,), dtype=dt, device=device),
        "w_out": _normal(gen, lead + (d, d), d ** -0.5, dt, device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    d, nh = cfg.d_model, cfg.num_heads
    shape = (batch, nh, d // nh)
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **kw), "n": torch.zeros(shape, **kw),
            "h": torch.zeros(shape, **kw),
            "m": torch.full(shape, NEG_INF, **kw)}


def _slstm_step(p, x_t, st, cfg: ModelConfig):
    """x_t: [B, d] (pre-normed); the heads' recurrence."""
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    b = x_t.shape[0]
    pre = x_t.float() @ p["w"] + p["b"]                       # [B, 4d]
    rec = torch.einsum("bhj,hjk->bhk", st["h"], p["r"])       # [B, NH, 4dh]
    pre = pre.reshape(b, nh, 4 * dh) + rec
    ig, fg, zg, og = pre.split(dh, dim=-1)
    log_f = _log_sigmoid(fg)
    m_new = torch.maximum(log_f + st["m"], ig)
    fs, is_ = torch.exp(log_f + st["m"] - m_new), torch.exp(ig - m_new)
    c = fs * st["c"] + is_ * torch.tanh(zg)
    n = fs * st["n"] + is_
    h = torch.sigmoid(og) * c / torch.clamp_min(n, 1e-6)
    return h.reshape(b, d), {"c": c, "n": n, "h": h, "m": m_new}


def apply_slstm_seq(p, x, cfg: ModelConfig, state=None):
    """x: [B, S, d] -> (y, final_state), one step at a time (the
    reference's chunked scan only sets its backward's remat; the port's
    training checkpoints the whole layer, :func:`repro_torch.models.xlstm
    .forward`). Autograd records the loop for the backward."""
    b, s, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    xn = _norm(x, p["ln"])
    hs = []
    for t in range(s):
        h, state = _slstm_step(p, xn[:, t], state, cfg)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _norm(h, p["gn"]) @ p["w_out"], state


def apply_slstm_step(p, x_t, state, cfg: ModelConfig):
    xn = _norm(x_t, p["ln"])
    h, state = _slstm_step(p, xn[:, 0], state, cfg)
    y = _norm(h[:, None, :].to(x_t.dtype), p["gn"]) @ p["w_out"]
    return y, state


# ================================================================ Mamba =====
def mamba_dims(cfg: ModelConfig):
    di = cfg.ssm.expand * cfg.d_model
    return di, cfg.ssm.state_size


def _softplus(x):
    """JAX's softplus, logaddexp(x, 0) (torch's ``softplus`` turns into
    the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen, cfg: ModelConfig, device,
               lead: Tuple[int, ...] = ()) -> dict:
    """The reference's Mamba heads: ``b_dt``, ``A_log`` and ``D`` are
    float32 beside leaves in the model dtype."""
    d = cfg.d_model
    di, n = mamba_dims(cfg)
    r = max(16, d // 16)
    dt, f32 = cfg.dtype, torch.float32
    si = di ** -0.5
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32)).expand(di, n)
    return {
        "ln": torch.ones(lead + (d,), dtype=dt, device=device),
        "w_in": _normal(gen, lead + (d, 2 * di), d ** -0.5, dt, device),
        "conv": _normal(gen, lead + (cfg.ssm.conv_kernel, di), 0.1, dt,
                        device),
        "wB": _normal(gen, lead + (di, n), si, dt, device),
        "wC": _normal(gen, lead + (di, n), si, dt, device),
        "w_dt1": _normal(gen, lead + (di, r), si, dt, device),
        "w_dt2": _normal(gen, lead + (r, di), r ** -0.5, dt, device),
        "b_dt": torch.full(lead + (di,), -4.6, dtype=f32, device=device),
        "A_log": a_log.to(device).expand(lead + (di, n)).clone(),
        "D": torch.ones(lead + (di,), dtype=f32, device=device),
        "w_out": _normal(gen, lead + (di, d), si, dt, device),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    di, n = mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm.conv_kernel - 1, di),
                                dtype=cfg.dtype, device=device)}


def _mamba_proj(p, x, cfg: ModelConfig, conv_state):
    """(xf, z, dt, B, C, A, new conv window): the input projection, the
    causal conv from the cached window ``conv_state`` (both callers carry
    one, zeros for a fresh state), and the selective scan's float32
    inputs."""
    di, _ = mamba_dims(cfg)
    xz = _norm(x, p["ln"]) @ p["w_in"]
    xi, z = xz.split(di, dim=-1)
    xi_full = torch.cat([conv_state, xi], dim=1)
    new_conv = xi_full[:, -(cfg.ssm.conv_kernel - 1):, :]
    s, w = xi.shape[1], p["conv"]
    xi = xi_full[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        xi = xi + xi_full[:, i:i + s] * w[i]
    xf = F.silu(xi).float()
    dt = _softplus(xf @ p["w_dt1"].float() @ p["w_dt2"].float()
                   + p["b_dt"])                                # [B, S, di]
    Bm = xf @ p["wB"].float()                                  # [B, S, N]
    Cm = xf @ p["wC"].float()
    A = -torch.exp(p["A_log"])                                 # [di, N]
    return xf, z, dt, Bm, Cm, A, new_conv


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 (h_{-1}
    folded into b_0): log2(c) steps of the reference's ``combine``, each
    step t taking (a_{t-d} a_t, a_t b_{t-d} + b_t) from the pair d back.
    Returns every h_t."""
    c, d = a.shape[1], 1
    while d < c:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_mamba_seq(p, x, cfg: ModelConfig, state=None, chunk: int = 256):
    """x: [B, S, d] -> (y [B, S, d], final state). The reference's chunked
    selective scan: a sequential carry across chunks (the largest divisor
    of S up to ``chunk``) and, within a chunk, a doubling scan
    (:func:`_doubling_scan`) over [B, c, d_inner, N] float32."""
    b, s, _ = x.shape
    if state is None:
        state = init_mamba_state(cfg, b, x.device)
    xf, z, dt, Bm, Cm, A, new_conv = _mamba_proj(p, x, cfg,
                                                 conv_state=state["conv"])
    c = _chunk(s, chunk)
    h, ys = state["h"], []
    for j in range(0, s, c):
        dtc, Bc = dt[:, j:j + c], Bm[:, j:j + c]
        dA = torch.exp(dtc[..., None] * A)                     # [B,c,di,N]
        dBx = (dtc * xf[:, j:j + c])[..., None] * Bc[:, :, None, :]
        dBx = torch.cat([dBx[:, :1] + dA[:, :1] * h[:, None], dBx[:, 1:]],
                        dim=1)
        hs = _doubling_scan(dA, dBx)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cm[:, j:j + c]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + p["D"] * xf
    out = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return out, {"h": h, "conv": new_conv}


def apply_mamba_step(p, x_t, state, cfg: ModelConfig):
    """x_t: [B, 1, d]."""
    xf, z, dt, Bm, Cm, A, new_conv = _mamba_proj(p, x_t, cfg,
                                                 conv_state=state["conv"])
    dA = torch.exp(dt[:, 0, :, None] * A)                      # [B,di,N]
    dBx = (dt[:, 0] * xf[:, 0])[..., None] * Bm[:, 0, None, :]
    h = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + p["D"] * xf[:, 0]
    out = (y[:, None, :].to(x_t.dtype) * F.silu(z)) @ p["w_out"]
    return out, {"h": h, "conv": new_conv}
