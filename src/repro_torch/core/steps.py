"""Step functions (port of ``repro/core/steps.py``):

``make_train_step``   — loss + grad + optimizer update (train shapes)
``make_prefill_step`` — context ingestion into the decode state
``make_serve_step``   — one-token decode against a KV cache / SSM state
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.common import effective_window
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import Adam
from repro_torch.tree import flatten, unflatten


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    optimizer: Optional[Adam] = None, *, remat: bool = True,
                    grad_accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics). ``params`` is a nested dict of tensors; the step leaves it
    unchanged and returns new ones. ``remat`` recomputes each block's
    activations in the backward pass (the reference's ``jax.checkpoint``
    per block), which runs its attention forward a second time.

    ``grad_accum > 1`` splits the batch into that many microbatches (the
    leading axis, in order) and accumulates their gradients in float32,
    each divided by ``grad_accum``, before one optimizer update; the loss
    and every metric are the microbatches' mean."""
    model = build_model(cfg)
    opt = optimizer or Adam()
    window = effective_window(cfg, shape)

    def grads_of(live, spec, batch):
        with torch.enable_grad():
            loss, metrics = model.loss(unflatten(spec, live), batch,
                                       window=window, remat=remat)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        flat, spec = flatten(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        if grad_accum <= 1:
            loss, metrics, grads = grads_of(live, spec, batch)
        else:
            a = grad_accum
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            losses, mets = [], []
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, met_i, g = grads_of(live, spec, mb)
                acc = [x + gi.float() / a for x, gi in zip(acc, g)]
                losses.append(loss_i)
                mets.append(met_i)
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).float().mean()
                       for k in mets[0]}
        params, opt_state = opt.update(
            unflatten(spec, list(grads)), opt_state,
            unflatten(spec, [p.detach() for p in flat]))
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    """prefill_step(params, batch, state) -> (logits [B, 1, V], state)."""
    model = build_model(cfg)
    window = effective_window(cfg, shape)

    def prefill_step(params, batch, state):
        if cfg.family == "ssm":
            return model.prefill(params, batch, state)
        return model.prefill(params, batch, state, window=window)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig):
    """serve_step(params, tokens [B, 1], state, pos) -> (logits, state)."""
    model = build_model(cfg)
    window = effective_window(cfg, shape)

    def serve_step(params, tokens, state, pos):
        if cfg.family == "ssm":
            return model.decode_step(params, tokens, state, pos)
        return model.decode_step(params, tokens, state, pos, window=window)

    return serve_step
