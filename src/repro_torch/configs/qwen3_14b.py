"""Qwen3-14B: qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family] (port of
``repro.configs.qwen3_14b``)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)
