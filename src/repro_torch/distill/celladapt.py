"""CELLAdapt's AD-LLM (port of the parts of ``repro/distill/celladapt.py``
that ``distill_fl`` runs; paper §3.3/§5.2).

The AD-LLM is the decoder LM fed vision-encoder features as prefix
embeddings plus context tokens (navigation and notice instructions); it
regresses future waypoints from its last hidden state.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.tree import tree_map


def adllm_config(base: ModelConfig, *, feature_dim: int = 256,
                 feature_tokens: int = 64, num_waypoints: int = 10
                 ) -> ModelConfig:
    return base.replace(prefix_tokens=feature_tokens,
                        prefix_dim=feature_dim,
                        num_waypoints=num_waypoints)


def init_adllm(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """The decoder's params (with the prefix ``projector``) plus a
    ``wp_head`` linear with a bias, as a nested dict of tensors that need
    no grad (a frozen base; training makes its own live copies). The
    decoder draws from a generator seeded with ``seed``, the head from
    one seeded with ``seed + 1``."""
    device = torch.device(device)
    params = tree_map(lambda p: p.detach(),
                      lm.init(cfg, seed=seed, device=device).to_dict())
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(seed + 1)
    params["wp_head"] = B.init_linear(gen, cfg.d_model,
                                      cfg.num_waypoints * 2, cfg.dtype,
                                      device, bias=True)
    return params


def adllm_waypoints(params, cfg: ModelConfig, features, tokens,
                    window=None):
    """features: [B, P, F] vision-encoder output; tokens: [B, S] context.
    Returns float32 waypoints [B, W, 2] regressed from the last hidden
    state."""
    x, _, _ = lm.forward(params, cfg, tokens, prefix_embeds=features,
                         window=window, hidden_only=True)
    h = x[:, -1]
    wp = B.linear(params["wp_head"], h).float()
    return wp.reshape(h.shape[0], cfg.num_waypoints, 2)


def waypoint_l1(pred, target):
    """Mean |pred - target|, with JAX's derivative of abs: +1 where the
    difference is exactly 0 (torch's ``abs`` gives 0 there). It matters:
    a pod student starts each round equal to its teacher (B = 0), so its
    first step meets the alignment term at exactly 0."""
    d = pred - target
    return torch.where(d >= 0, d, -d).mean()
