"""Core transformer building blocks (port of ``repro/models/blocks.py``).

Conventions, as in the reference:
  * params are nested dicts of tensors (or a :class:`repro_torch.models.lm
    .ParamTree`, which indexes the same way); every ``init_*`` returns one;
  * activations flow as [batch, seq, d_model]; attention internals use
    [batch, heads, seq, head_dim];
  * all softmax/statistics in float32 regardless of param dtype.

Every ``init_*`` draws from an explicit ``torch.Generator`` on the target
device; ``lead`` prepends a layer axis for the layer-stacked block params.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distill.lora import lora_linear
from repro_torch.kernels import ops

NEG_INF = -1e30


def _normal(gen, shape, std, dtype, device):
    if device.type == "meta":        # shapes only (lm.abstract_params)
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)    # in place: one float32 copy at a time


# ---------------------------------------------------------------- norms ----
def init_rmsnorm(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rms_norm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_tables(positions, d: int, theta: float):
    """(sin, cos) [B, 1, S, d/2] float32 of the rotary angles at
    ``positions`` ([B, S] or [S]); one pair serves every layer."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs   # [B,1,S,half]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """Rotate x [B, H, S, D] by tables from :func:`rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: [B, H, S, D]; positions: [B, S] or [S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ------------------------------------------------------------ attention ----
def init_attention(gen, cfg: ModelConfig, device,
                   lead: Tuple[int, ...] = (), cross: bool = False) -> dict:
    """Projections of one attention block; ``cross`` (cross-attention)
    leaves out the QKV bias and the qk-norm scales, as the reference."""
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.dtype
    p = {
        "wq": _normal(gen, lead + (d, nq * hd), d ** -0.5, dt, device),
        "wk": _normal(gen, lead + (d, nkv * hd), d ** -0.5, dt, device),
        "wv": _normal(gen, lead + (d, nkv * hd), d ** -0.5, dt, device),
        "wo": _normal(gen, lead + (nq * hd, d), (nq * hd) ** -0.5, dt,
                      device),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros(lead + (n * hd,), dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dt, device=device)
    return p


def _split_heads(x, n: int, hd: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)  # [B,N,S,D]


def _head_rmsnorm(x, scale, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def dense_mha(q, k, v, *, scale: float, q_pos, kv_pos, causal: bool,
              window: Optional[int]):
    """Plain attention. q: [B,Nq,Sq,D]; k,v: [B,Nkv,Skv,D]; scores and
    softmax in float32, the value product in v's dtype."""
    b, nq, sq, d = q.shape
    nkv = k.shape[1]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    mask = kv_pos[None, :] >= 0
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return o.reshape(b, nq, sq, d)


def _adapted_matmul(p: dict, name: str, x, lora, lora_scale: float):
    """``x @ p[name]``, with the leaf's LoRA factors fused in when the
    factor subtree ``lora`` carries them: the fused base + low-rank
    kernel (:func:`repro_torch.distill.lora.lora_linear`), so the merged
    weight is never formed."""
    f = None if lora is None else lora.get(name)
    if f is None:
        return x @ p[name]
    return lora_linear(x, p[name], f, lora_scale)


def qkv(p, x, cfg: ModelConfig, rot, lora=None, lora_scale: float = 1.0):
    """Projections, head split, optional head norms and rope by the
    ``rot = rope_tables(...)`` pair: x [B, S, d] -> q [B, Hq, S, D], k/v
    [B, Hkv, S, D] (the paged engine shares it). ``lora``: the block's
    attention factor subtree, or None."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = (_adapted_matmul(p, name, x, lora, lora_scale)
               for name in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, nq, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)
    if "q_norm" in p:
        q = _head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = _head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def _contiguous_positions(positions) -> bool:
    """True iff ``positions`` ([S] or batch-uniform [B, S]) are
    non-negative and consecutive — row i at ``positions[0] + i``, the
    layout the flash kernels' absolute-position masks assume. Reads the
    values on the host (a device sync for a CUDA tensor)."""
    p = positions.detach().cpu()
    row = p if p.dim() == 1 else p[0]
    if p.dim() == 2 and not bool((p == row[None]).all()):
        return False
    if row.numel() == 0 or int(row[0]) < 0:
        return False
    return row.numel() == 1 or bool((row[1:] - row[:-1] == 1).all())


def attention(p, x, cfg: ModelConfig, *, positions, cache=None, rot=None,
              causal: bool = True, window: Optional[int] = None,
              cross_kv=None, cross_pos=None,
              positions_contiguous: Optional[bool] = None, lora=None,
              lora_scale: float = 1.0):
    """Self-attention (causal unless ``causal=False``), with or without a
    contiguous KV cache, or cross-attention.

    With ``cache`` the new K/V rows are written into it in place (see
    :func:`update_kv_cache`) and :func:`dense_mha` runs over the whole
    cache. Without one — training and whole-prompt forwards — the
    reference's gate applies: contiguous positions and a head_dim the
    kernels take go through :func:`repro_torch.kernels.ops
    .flash_attention_ad` (``q_offset = Skv - S``, tiles from the config's
    ``attn_block_q/k``), which runs the kernels on the card and their
    plain versions on the CPU. Anything else takes :func:`dense_mha` on
    the CPU and raises on the card.
    ``cross_kv`` = (k, v) [B, Hkv, Skv, D] at key positions ``cross_pos``
    makes it cross-attention: the queries get no rope, and
    :func:`dense_mha` runs on every device, as the reference never hands
    cross-attention to its kernel.
    ``positions_contiguous`` vouches for the layout (None checks the
    values); ``rot`` passes precomputed :func:`rope_tables` for
    ``positions``. ``lora``: optional factor subtree of this block's
    attention params ({"wq": {"A", "B"}, ...}); adapted projections run
    the fused base + low-rank kernel with ``lora_scale``. Returns
    (output, cache)."""
    b, s, _ = x.shape
    nq, hd = cfg.num_heads, cfg.hd
    scale = hd ** -0.5
    q_pos = positions if positions.dim() == 1 else positions[0]
    if cross_kv is not None:
        q = _adapted_matmul(p, "wq", x, lora, lora_scale)
        if "bq" in p:
            q = q + p["bq"]
        q = _split_heads(q, nq, hd)
        if "q_norm" in p:
            q = _head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k, v = cross_kv
        o = dense_mha(q, k, v, scale=scale, q_pos=q_pos, kv_pos=cross_pos,
                      causal=causal, window=window)
        o = o.transpose(1, 2).reshape(b, s, nq * hd)
        return _adapted_matmul(p, "wo", o, lora, lora_scale).to(x.dtype), \
            cache
    if rot is None:
        rot = rope_tables(positions, hd, cfg.rope_theta)
    q, k, v = qkv(p, x, cfg, rot, lora, lora_scale)
    if cache is not None:
        k, v, kv_pos, cache = update_kv_cache(cache, k, v, positions)
        o = dense_mha(q, k, v, scale=scale, q_pos=q_pos, kv_pos=kv_pos,
                      causal=causal, window=window)
    else:
        if positions_contiguous is None:
            positions_contiguous = _contiguous_positions(positions)
        if positions_contiguous and hd in ops.HEAD_DIMS:
            o = ops.flash_attention_ad(
                q.contiguous(), k.contiguous(), v.contiguous(), scale,
                causal, window, k.shape[2] - s, block_q=cfg.attn_block_q,
                block_k=cfg.attn_block_k)
        elif x.device.type == "cpu":
            o = dense_mha(q, k, v, scale=scale, q_pos=q_pos, kv_pos=q_pos,
                          causal=causal, window=window)
        else:
            raise NotImplementedError(
                f"cache-free attention on {x.device} runs the flash "
                f"kernels, which need contiguous positions and a head_dim "
                f"in {ops.HEAD_DIMS} (head_dim {hd}, contiguous "
                f"{positions_contiguous})")
    o = o.transpose(1, 2).reshape(b, s, nq * hd)
    return _adapted_matmul(p, "wo", o, lora, lora_scale).to(x.dtype), cache


# ------------------------------------------------------------- kv cache ----
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                  stacked: int = 0) -> dict:
    """cache_len is the ring size (== window for sliding-window attention)."""
    shape = (batch, cfg.num_kv_heads, cache_len, cfg.hd)
    if stacked:
        shape = (stacked,) + shape
    pos_shape = (stacked, cache_len) if stacked else (cache_len,)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.full(pos_shape, -1, dtype=torch.int32, device=device),
    }


def update_kv_cache(cache: dict, k_new, v_new, positions):
    """Write new K/V at ring positions IN PLACE (the reference returns a
    new cache); return the full cache views and the cache.

    k_new: [B, Nkv, S_new, D]; positions: [S_new] or [B, S_new] (shared
    ring index — batch-uniform positions assumed)."""
    ring = cache["k"].shape[2]
    pos1 = positions if positions.dim() == 1 else positions[0]
    idx = (pos1 % ring).long()
    cache["k"][:, :, idx] = k_new.to(cache["k"].dtype)
    cache["v"][:, :, idx] = v_new.to(cache["v"].dtype)
    cache["pos"][idx] = pos1.to(torch.int32)
    return cache["k"], cache["v"], cache["pos"], cache


# ----------------------------------------------------------------- ffn -----
def init_mlp(gen, cfg: ModelConfig, device,
             lead: Tuple[int, ...] = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    return {
        "wi": _normal(gen, lead + (d, f), d ** -0.5, dt, device),
        "wg": _normal(gen, lead + (d, f), d ** -0.5, dt, device),
        "wo": _normal(gen, lead + (f, d), f ** -0.5, dt, device),
    }


def mlp(p, x, lora=None, lora_scale: float = 1.0):
    h = F.silu(_adapted_matmul(p, "wg", x, lora, lora_scale)) \
        * _adapted_matmul(p, "wi", x, lora, lora_scale)
    return _adapted_matmul(p, "wo", h, lora, lora_scale)


# ------------------------------------------------------------ embedding ----
def init_embedding(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": _normal(gen, (vocab, d), d ** -0.5, dtype, device)}


def embed(p, tokens):
    return p["table"][tokens.long()]


def unembed(p, x):
    """Tied-embedding logits in float32 (the reference's
    ``preferred_element_type=float32``)."""
    return x.float() @ p["table"].float().T


def init_linear(gen, din: int, dout: int, dtype, device,
                bias: bool = False) -> dict:
    p = {"w": _normal(gen, (din, dout), din ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y
