"""Architecture registry of the port: ``get_config(name)`` returns the
published config, ``reduced(cfg)`` its CPU-smoke variant."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig
from repro_torch.configs.common import reduced  # noqa: F401

#: architectures ported so far (the reference registers twelve)
ARCH_IDS = ["qwen2_5_32b", "qwen3_32b", "xlstm_350m", "yi_34b",
            "hymba_1_5b", "qwen3_14b", "flad_vision", "flad_adllm",
            "seamless_m4t_large_v2"]


def _canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    if _canon(name) not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{_canon(name)}").CONFIG
