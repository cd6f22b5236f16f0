"""Decoder-only LM for the dense family (port of ``repro/models/lm.py``).

The model is an ``nn.Module`` (:class:`LM`) whose parameters keep the
reference's nested-dict layout, block parameters stacked on a leading
layer axis ``[L, ...]``. Where the reference scans the stack with
``lax.scan``, :func:`forward` walks it with a Python loop over per-layer
views (:func:`layer`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B


class ParamTree(nn.Module):
    """An ``nn.Module`` over a nested dict of tensors: sub-dicts become
    child modules, tensors trainable parameters. ``p["name"]`` and
    ``"name" in p`` read it like the reference's dict pytrees."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        if name in self._modules:
            return self._modules[name]
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._parameters

    def to_dict(self) -> dict:
        """The nested dict of tensors (leaves are the parameters)."""
        out = {k: m.to_dict() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


def layer(tree, l: int):
    """Views of layer ``l`` of a layer-stacked tree, as a nested dict."""
    if isinstance(tree, torch.Tensor):
        return tree[l]
    items = tree.to_dict() if isinstance(tree, ParamTree) else tree
    return {k: layer(v, l) for k, v in items.items()}


class LM(ParamTree):
    """The decoder's parameters plus its config; calling it runs
    :func:`forward`."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens, **kw):
        return forward(self, self.cfg, tokens, **kw)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe.num_experts:
        raise NotImplementedError(
            f"the port covers the dense decoder so far, not {cfg.name!r} "
            f"({cfg.family})")


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> LM:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the reference draws from a JAX key; the two
    streams differ, so cross-package tests bridge one tree instead)."""
    _check_family(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    lead = (cfg.num_layers,)
    tree = {
        "embed": B.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.dtype, device),
        "blocks": {
            "ln1": B.init_rmsnorm(cfg.d_model, cfg.dtype, device, lead),
            "attn": B.init_attention(gen, cfg, device, lead),
            "ln2": B.init_rmsnorm(cfg.d_model, cfg.dtype, device, lead),
            "ffn": B.init_mlp(gen, cfg, device, lead),
        },
        "ln_f": B.init_rmsnorm(cfg.d_model, cfg.dtype, device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = B.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     cfg.dtype, device)
    if cfg.prefix_tokens:   # vision features -> d_model (the AD-LLM)
        tree["projector"] = B.init_linear(gen, cfg.prefix_dim, cfg.d_model,
                                          cfg.dtype, device)
    return LM(cfg, tree)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the ``meta`` device (no
    memory), as the reference's ``abstract_params``."""
    return init(cfg, device="meta").to_dict()


def apply_block(p, x, cfg: ModelConfig, *, positions, cache=None, rot=None,
                window: Optional[int] = None,
                positions_contiguous: Optional[bool] = None, lora=None,
                lora_scale: float = 1.0):
    """One block; ``lora`` is this layer's factor subtree (or None)."""
    lora = lora or {}
    a, cache = B.attention(p["attn"], B.rms_norm(p["ln1"], x, cfg.norm_eps),
                           cfg, positions=positions, cache=cache, rot=rot,
                           window=window,
                           positions_contiguous=positions_contiguous,
                           lora=lora.get("attn"), lora_scale=lora_scale)
    x = x + a
    h = B.rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + B.mlp(p["ffn"], h, lora.get("ffn"), lora_scale), cache


def logits_of(params, cfg: ModelConfig, h):
    """Final-norm output ``h`` [..., d] -> float32 logits [..., V]."""
    if cfg.tie_embeddings:
        return B.unembed(params["embed"], h)
    return B.linear(params["head"], h).float()


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            caches: Optional[dict] = None, window: Optional[int] = None,
            remat: bool = False, logits_slice: Optional[int] = None,
            hidden_only: bool = False, prefix_embeds=None, lora=None,
            lora_scale: float = 1.0):
    """tokens: [B, S] int. Returns (logits [B, S, V] float32 — or the
    final-norm hidden states with ``hidden_only`` — , caches, aux).

    ``caches`` is a layer-stacked contiguous cache from :func:`init_cache`;
    it is updated in place and returned. Without one, attention runs the
    flash-attention kernels (:func:`repro_torch.models.blocks.attention`).
    ``window`` is the sliding attention window (None: full causal).
    ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, the reference's per-block
    ``jax.checkpoint``); it needs ``caches=None``.
    ``prefix_embeds`` [B, P, F] (the AD-LLM's vision features) go through
    ``projector`` in the model dtype and sit before the token embeddings,
    at positions 0..P-1; their rows are dropped after the final norm.
    ``lora`` is a factor tree from :func:`repro_torch.distill.lora
    .init_lora`: factors on the block stack run through the fused base +
    low-rank kernel with ``lora_scale``; factors anywhere else raise.
    ``aux`` is the (zero) MoE auxiliary loss, kept for the reference's
    return signature. ``params`` may be the module or its nested dict."""
    _check_family(cfg)
    lora_blocks = None
    if lora is not None:
        bad = sorted(k for k, v in lora.items() if k != "blocks" and v)
        if bad:
            raise NotImplementedError(
                f"LoRA factors outside the block stack are not supported "
                f"by the fused forward (got factors under {bad}); adapt "
                f"only block projections or fold with merge_lora instead")
        lora_blocks = lora.get("blocks")
    x = B.embed(params["embed"], tokens)
    npfx = 0
    if prefix_embeds is not None:
        pfx = B.linear(params["projector"], prefix_embeds.to(x.dtype))
        x = torch.cat([pfx, x], dim=1)
        npfx = pfx.shape[1]
    contiguous = None
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        contiguous = True
    rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)
    blocks = params["blocks"]
    for l in range(cfg.num_layers):
        lc = None if caches is None else {k: c[l] for k, c in caches.items()}
        kw = dict(positions=positions, rot=rot, window=window,
                  positions_contiguous=contiguous, lora_scale=lora_scale,
                  lora=None if lora_blocks is None
                  else layer(lora_blocks, l))
        if remat and lc is None and torch.is_grad_enabled():
            x, _ = checkpoint(apply_block, layer(blocks, l), x, cfg,
                              use_reentrant=False, **kw)
        else:
            x, _ = apply_block(layer(blocks, l), x, cfg, cache=lc, **kw)
    x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
    if npfx:
        x = x[:, npfx:]
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden_only:
        return x, caches, aux
    return logits_of(params, cfg, x), caches, aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> dict:
    return B.init_kv_cache(cfg, batch, cache_len, device,
                           stacked=cfg.num_layers)
