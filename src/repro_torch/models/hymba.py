"""Hymba-style hybrid blocks (arXiv:2411.13676; port of
``repro/models/hymba.py``): parallel attention heads and Mamba heads on
the same input, fused by the mean of their per-path norms, then a SwiGLU
FFN.

Parameters keep the reference's nested-dict layout, block parameters
stacked on a leading layer axis ``[L, ...]`` (a :class:`repro_torch
.models.lm.ParamTree`); where the reference scans the stack,
:func:`forward` walks per-layer views with a Python loop, as
:func:`repro_torch.models.lm.forward` does. Cache-free attention
(training, a whole-prompt forward) runs the flash-attention kernels
through :func:`repro_torch.models.blocks.attention`; with a contiguous
KV cache (legacy serving) it takes :func:`repro_torch.models.blocks
.dense_mha`, as the reference does. The Mamba heads are
:mod:`repro_torch.models.recurrent`'s plain PyTorch cell.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models.lm import ParamTree, layer


def init_block(gen, cfg: ModelConfig, device, lead=()) -> dict:
    dt = cfg.dtype
    return {
        "ln1": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "attn": B.init_attention(gen, cfg, device, lead),
        "mamba": R.init_mamba(gen, cfg, device, lead),
        "attn_norm": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "ssm_norm": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "ln2": B.init_rmsnorm(cfg.d_model, dt, device, lead),
        "ffn": B.init_mlp(gen, cfg, device, lead),
    }


def apply_block(p, x, cfg: ModelConfig, *, positions, rot=None,
                kv_cache=None, ssm_state=None, window: Optional[int] = None,
                step: bool = False,
                positions_contiguous: Optional[bool] = None):
    """One block; returns (x, kv_cache, new Mamba state). ``kv_cache`` is
    written in place (:func:`repro_torch.models.blocks.attention`)."""
    h = B.rms_norm(p["ln1"], x, cfg.norm_eps)
    a, new_kv = B.attention(p["attn"], h, cfg, positions=positions,
                            cache=kv_cache, rot=rot, window=window,
                            positions_contiguous=positions_contiguous)
    if step:
        s, new_ssm = R.apply_mamba_step(p["mamba"], x, ssm_state, cfg)
    else:
        s, new_ssm = R.apply_mamba_seq(p["mamba"], x, cfg, state=ssm_state)
    fused = 0.5 * (B.rms_norm(p["attn_norm"], a, cfg.norm_eps)
                   + B.rms_norm(p["ssm_norm"], s, cfg.norm_eps))
    x = x + fused
    x = x + B.mlp(p["ffn"], B.rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, new_kv, new_ssm


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the reference draws from a JAX key; tests bridge one tree
    instead)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return ParamTree({
        "embed": B.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.dtype, device),
        "blocks": init_block(gen, cfg, device, (cfg.num_layers,)),
        "ln_f": B.init_rmsnorm(cfg.d_model, cfg.dtype, device),
        "head": B.init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                              device),
    })


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the ``meta`` device."""
    return init(cfg, device="meta").to_dict()


def init_state(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    """{"kv": the layer-stacked contiguous cache, "ssm": the Mamba states
    stacked [L, ...]}."""
    one = R.init_mamba_state(cfg, batch, device)
    return {"kv": B.init_kv_cache(cfg, batch, cache_len, device,
                                  stacked=cfg.num_layers),
            "ssm": {k: v.expand((cfg.num_layers,) + v.shape).clone()
                    for k, v in one.items()}}


def _train_block(lp, x, cfg, positions, rot, window, contiguous):
    return apply_block(lp, x, cfg, positions=positions, rot=rot,
                       window=window, positions_contiguous=contiguous)[0]


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            states=None, window: Optional[int] = None, step: bool = False,
            logits_slice: Optional[int] = None, hidden_only: bool = False,
            remat: bool = False):
    """tokens: [B, S] int. Returns (logits [B, S, V] float32 — or the
    final-norm hidden states with ``hidden_only`` — , states, aux).

    ``states`` (from :func:`init_state`) are updated IN PLACE and
    returned; the reference returns new ones. ``step`` runs the Mamba
    heads' one-token step. ``remat`` recomputes each block in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``); it needs ``states=None``. ``aux`` is a zero, for
    the reference's signature. ``params`` may be the module or its nested
    dict."""
    x = B.embed(params["embed"], tokens)
    contiguous = None
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        contiguous = True
    rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)
    blocks = params["blocks"]
    for l in range(cfg.num_layers):
        lp = layer(blocks, l)
        if states is None:
            if remat and torch.is_grad_enabled():
                x = checkpoint(_train_block, lp, x, cfg, positions, rot,
                               window, contiguous, use_reentrant=False)
            else:
                x = _train_block(lp, x, cfg, positions, rot, window,
                                 contiguous)
            continue
        lssm = {k: v[l] for k, v in states["ssm"].items()}
        x, _, new = apply_block(
            lp, x, cfg, positions=positions, rot=rot,
            kv_cache={k: c[l] for k, c in states["kv"].items()},
            ssm_state=lssm, window=window, step=step,
            positions_contiguous=contiguous)
        for k, v in new.items():
            lssm[k].copy_(v)
    x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden_only:
        return x, states, aux
    return B.linear(params["head"], x).float(), states, aux
