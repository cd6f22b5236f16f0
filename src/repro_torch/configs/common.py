"""Shared config helpers (port of ``repro.configs.common``): the reduced
smoke variant, the effective attention window, and the input specs and
random batches of the dense, ssm, hybrid, encdec and vision families."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.config import LONG_CONTEXT_WINDOW, ModelConfig, ShapeConfig

#: the families whose configs, input specs and batches the port covers
FAMILIES = ("dense", "ssm", "hybrid", "encdec", "vision")

#: frames of encoder memory during enc-dec decode (the cross K/V of a
#: decode state made without a prefill)
ENC_MEMORY_DECODE = 4096


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model 128, tiny
    vocab, float32 — the same shrink the reference applies (an xLSTM
    keeps 4 KV heads and puts an sLSTM block every 2 layers; Hymba's
    Mamba state shrinks to 8; an encoder-decoder keeps one encoder and
    one decoder layer, 4 KV heads and 64-wide frames; the vision encoder
    takes 32-wide features and keeps its waypoints, light classes and
    128 tokens a modality).
    Fields it does not name (the QKV bias, the qk-norm, rope_theta) keep
    the config's values, as the reference's ``cfg.replace`` does."""
    _check_family(cfg)
    kw = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
              head_dim=32, d_ff=256, vocab_size=512, param_dtype="float32",
              q_chunk=64, kv_chunk=64)
    if cfg.family == "ssm":
        kw["num_kv_heads"] = 4
        kw["ssm"] = dataclasses.replace(cfg.ssm, slstm_every=2)
    if cfg.family == "hybrid":
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_size=8)
    if cfg.family == "encdec":
        kw["enc_layers"] = 1
        kw["dec_layers"] = 1
        kw["num_kv_heads"] = 4
        kw["prefix_dim"] = 64
    if cfg.family == "vision":
        kw["prefix_dim"] = 32
        kw["num_waypoints"] = cfg.num_waypoints
        kw["num_light_classes"] = cfg.num_light_classes
    return cfg.replace(name=cfg.name + "-smoke", **kw)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port covers the families {FAMILIES} so far, not "
            f"{cfg.family!r}")


def effective_window(cfg: ModelConfig, shape: ShapeConfig):
    """long_500k forces a sliding window on full-attention families (SSM
    paths are already O(1))."""
    if shape.name == "long_500k" and cfg.family not in ("ssm",):
        return LONG_CONTEXT_WINDOW
    return cfg.window


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Batch leaves as {name: (shape, dtype)} for train/prefill steps of
    the dense, ssm and hybrid families (decode: one token per row), the
    encoder-decoder (``seq_len / 2`` float32 frames of ``prefix_dim``
    features and ``seq_len / 2`` tokens and labels; decode: one token)
    and the vision encoder (rgb and lidar features, waypoint and light
    labels; ``seq_len`` does not apply)."""
    _check_family(cfg)
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vision":
        p = cfg.prefix_tokens or 64
        return {"rgb": ((b, p, cfg.prefix_dim), torch.float32),
                "lidar": ((b, p, cfg.prefix_dim), torch.float32),
                "waypoints": ((b, cfg.num_waypoints, 2), torch.float32),
                "light": ((b,), torch.int32)}
    if cfg.family == "encdec" and not shape.is_decode:
        half = s // 2
        return {"frames": ((b, half, cfg.prefix_dim), torch.float32),
                "tokens": ((b, half), torch.int32),
                "labels": ((b, half), torch.int32)}
    if shape.is_decode:
        return {"tokens": ((b, 1), torch.int32)}
    return {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                   gen: torch.Generator, lead: Tuple[int, ...] = ()) -> dict:
    """A random batch matching :func:`input_specs`, drawn from ``gen`` on
    its device; ``lead`` prepends axes (clients, local steps): integer
    leaves uniform below the vocabulary (``light`` below the light
    classes), float leaves standard normal. The reference draws from a
    JAX key: the streams differ, so tests that compare the packages feed
    both the same numpy batch instead."""
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(lead + shp, generator=gen, dtype=dtype,
                                    device=gen.device)
            continue
        hi = cfg.num_light_classes if name == "light" else cfg.vocab_size
        out[name] = torch.randint(0, max(hi, 2), lead + shp, generator=gen,
                                  dtype=dtype, device=gen.device)
    return out
