"""Shared config helpers (port of ``repro.configs.common``): the reduced
smoke variant, the effective attention window, and the dense family's
input specs and random batches."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config import LONG_CONTEXT_WINDOW, ModelConfig, ShapeConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model 128, tiny
    vocab, float32 — the same shrink the reference applies (an xLSTM
    keeps 4 KV heads and puts an sLSTM block every 2 layers)."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"the port covers the dense and ssm families so far, not "
            f"{cfg.family!r}")
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
              head_dim=32, d_ff=256, vocab_size=512, param_dtype="float32",
              q_chunk=64, kv_chunk=64)
    if cfg.family == "ssm":
        kw["num_kv_heads"] = 4
        kw["ssm"] = dataclasses.replace(cfg.ssm, slstm_every=2)
    return cfg.replace(name=cfg.name + "-smoke", **kw)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port covers the dense family so far, not {cfg.family!r}")


def effective_window(cfg: ModelConfig, shape: ShapeConfig):
    """long_500k forces a sliding window on full-attention families (SSM
    paths are already O(1))."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return LONG_CONTEXT_WINDOW
    return cfg.window


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Batch leaves as {name: (shape, dtype)} for train/prefill steps of
    the dense family (decode: one token per row)."""
    _check_dense(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.is_decode:
        return {"tokens": ((b, 1), torch.int32)}
    return {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                   gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """A random batch matching :func:`input_specs`, drawn from ``gen`` on
    its device; ``lead`` prepends axes (clients, local steps). The
    reference draws from a JAX key: the streams differ, so tests that
    compare the packages feed both the same numpy batch instead."""
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        out[name] = torch.randint(0, max(cfg.vocab_size, 2), lead + shp,
                                  generator=gen, dtype=dtype,
                                  device=gen.device)
    return out
