"""Encoder-decoder backbone for the audio (SeamlessM4T-style)
architecture (port of ``repro/models/encdec.py``).

The audio frontend (mel + conformer conv feature extractor) is a stub,
as in the reference: the batch carries precomputed frame embeddings of
shape [B, S_enc, prefix_dim]; the model owns a projector, a
bidirectional encoder stack, and a causal decoder stack with
cross-attention.

Parameters keep the reference's nested-dict layout, each stack's block
parameters on a leading layer axis (a :class:`repro_torch.models.lm
.ParamTree`); where the reference scans a stack, a Python loop walks
per-layer views. Cache-free self-attention (the encoder always; the
decoder in training) runs the flash-attention kernels through
:func:`repro_torch.models.blocks.attention`, the encoder's without a
causal mask; with a contiguous KV cache (prefill and decode) the
decoder's self-attention takes :func:`repro_torch.models.blocks
.dense_mha`, and cross-attention always does, as the reference never
hands either to its kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.lm import ParamTree, layer


def init_enc_block(gen, cfg: ModelConfig, device, lead=()) -> dict:
    dt = cfg.dtype
    return {
        "ln1": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "attn": B.init_attention(gen, cfg, device, lead),
        "ln2": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "ffn": B.init_mlp(gen, cfg, device, lead),
    }


def init_dec_block(gen, cfg: ModelConfig, device, lead=()) -> dict:
    dt = cfg.dtype
    return {
        "ln1": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "attn": B.init_attention(gen, cfg, device, lead),
        "ln_x": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "xattn": B.init_attention(gen, cfg, device, lead, cross=True),
        "ln2": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "ffn": B.init_mlp(gen, cfg, device, lead),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the reference draws from a JAX key; tests bridge one tree
    instead)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = cfg.dtype
    return ParamTree({
        "frontend": B.init_linear(gen, cfg.prefix_dim, cfg.d_model, dt,
                                  device),
        "enc_blocks": init_enc_block(gen, cfg, device, (cfg.enc_layers,)),
        "enc_ln": B.init_rmsnorm(cfg.d_model, dt, device),
        "embed": B.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device),
        "dec_blocks": init_dec_block(gen, cfg, device, (cfg.dec_layers,)),
        "ln_f": B.init_rmsnorm(cfg.d_model, dt, device),
        "head": B.init_linear(gen, cfg.d_model, cfg.vocab_size, dt, device),
    })


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the ``meta`` device."""
    return init(cfg, device="meta").to_dict()


def enc_block(lp, h, cfg: ModelConfig, pos, rot, window=None):
    """One encoder block: bidirectional self-attention with rope (the
    flash kernels without a causal mask), then the SwiGLU FFN."""
    a, _ = B.attention(lp["attn"], B.rms_norm(lp["ln1"], h, cfg.norm_eps),
                       cfg, positions=pos, rot=rot, causal=False,
                       window=window, positions_contiguous=True)
    h = h + a
    return h + B.mlp(lp["ffn"], B.rms_norm(lp["ln2"], h, cfg.norm_eps))


def encode(params, cfg: ModelConfig, frames, *, window: Optional[int] = None,
           remat: bool = False):
    """frames: [B, S_enc, prefix_dim] -> memory [B, S_enc, d], after
    ``enc_ln``. ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    x = B.linear(params["frontend"], frames.to(cfg.dtype))
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rot = B.rope_tables(pos, cfg.hd, cfg.rope_theta)
    blocks = params["enc_blocks"]
    for l in range(cfg.enc_layers):
        lp = layer(blocks, l)
        if remat and torch.is_grad_enabled():
            x = checkpoint(enc_block, lp, x, cfg, pos, rot, window,
                           use_reentrant=False)
        else:
            x = enc_block(lp, x, cfg, pos, rot, window)
    return B.rms_norm(params["enc_ln"], x, cfg.norm_eps)


def cross_kv_of(xattn, memory, cfg: ModelConfig):
    """One decoder layer's cross K/V [B, Hkv, S_enc, D] from ``memory``
    [B, S_enc, d] (no rope, no bias)."""
    b, s, _ = memory.shape
    nkv, hd = cfg.num_kv_heads, cfg.hd
    k = (memory @ xattn["wk"]).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (memory @ xattn["wv"]).reshape(b, s, nkv, hd).transpose(1, 2)
    return k, v


def make_cross_kv(params, cfg: ModelConfig, memory):
    """Every decoder layer's cross K/V from the encoder memory, stacked
    (k, v) [L, B, Hkv, S_enc, D]."""
    xattn = params["dec_blocks"]["xattn"]
    pairs = [cross_kv_of(layer(xattn, l), memory, cfg)
             for l in range(cfg.dec_layers)]
    return (torch.stack([k for k, _ in pairs]),
            torch.stack([v for _, v in pairs]))


def dec_block(lp, h, ck, cv, cfg: ModelConfig, positions, rot, *,
              cache=None, window=None, contiguous=None):
    """One decoder block: causal self-attention with rope (over ``cache``
    in place when given), cross-attention without rope over (ck, cv),
    then the SwiGLU FFN."""
    a, _ = B.attention(lp["attn"], B.rms_norm(lp["ln1"], h, cfg.norm_eps),
                       cfg, positions=positions, cache=cache, rot=rot,
                       window=window, positions_contiguous=contiguous)
    h = h + a
    mem_pos = torch.arange(ck.shape[2], dtype=torch.int32, device=h.device)
    xa, _ = B.attention(lp["xattn"], B.rms_norm(lp["ln_x"], h, cfg.norm_eps),
                        cfg, positions=positions, cross_kv=(ck, cv),
                        cross_pos=mem_pos, causal=False)
    h = h + xa
    return h + B.mlp(lp["ffn"], B.rms_norm(lp["ln2"], h, cfg.norm_eps))


def decode(params, cfg: ModelConfig, tokens, cross_kv, *, positions=None,
           caches: Optional[dict] = None, window: Optional[int] = None,
           logits_slice: Optional[int] = None, hidden_only: bool = False,
           remat: bool = False):
    """tokens: [B, S_dec] int; cross_kv: stacked (k, v) from
    :func:`make_cross_kv`. Returns (logits [B, S, V] float32 — or the
    final-norm hidden states with ``hidden_only`` — , caches).

    ``caches`` (:func:`init_cache`) are updated IN PLACE and returned;
    the reference returns new ones. ``positions`` None means 0 .. S - 1,
    contiguous. ``remat`` recomputes each block in the backward pass; it
    needs ``caches=None``."""
    x = B.embed(params["embed"], tokens)
    contiguous = None
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        contiguous = True
    rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)
    ck_all, cv_all = cross_kv
    blocks = params["dec_blocks"]
    for l in range(cfg.dec_layers):
        lc = None if caches is None else {k: c[l] for k, c in caches.items()}
        args = (layer(blocks, l), x, ck_all[l], cv_all[l], cfg, positions,
                rot)
        kw = dict(cache=lc, window=window, contiguous=contiguous)
        if remat and lc is None and torch.is_grad_enabled():
            x = checkpoint(dec_block, *args, use_reentrant=False, **kw)
        else:
            x = dec_block(*args, **kw)
    x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    if hidden_only:
        return x, caches
    return B.linear(params["head"], x).float(), caches


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """The decoder's layer-stacked contiguous KV cache."""
    return B.init_kv_cache(cfg, batch, cache_len, device,
                           stacked=cfg.dec_layers)
