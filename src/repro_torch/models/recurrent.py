"""Recurrent cells of the xLSTM (arXiv:2405.04517): mLSTM and sLSTM (port
of the first two thirds of ``repro/models/recurrent.py``; its Mamba cell
comes with the Hymba slice).

Both cells expose, as in the reference:
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
backward.
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
