"""Qwen2.5-32B: GQA kv=8, QKV bias [hf:Qwen/Qwen2.5-0.5B scaled family]
(port of ``repro.configs.qwen2_5_32b``)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
