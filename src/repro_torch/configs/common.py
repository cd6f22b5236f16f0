"""Shared config helpers (port of ``repro.configs.common.reduced``)."""
from __future__ import annotations

from repro_torch.config import ModelConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of a dense decoder: 2 layers, d_model 128, tiny
    vocab, float32 — the same shrink the reference applies."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port covers the dense family so far, not {cfg.family!r}")
    return cfg.replace(name=cfg.name + "-smoke", num_layers=2, d_model=128,
                       num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                       vocab_size=512, param_dtype="float32", q_chunk=64,
                       kv_chunk=64)
