"""Qwen3-32B: qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family] (port of
``repro.configs.qwen3_32b``)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)
