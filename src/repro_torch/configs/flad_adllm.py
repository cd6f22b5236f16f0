"""FLAD's edge AD-LLM (paper §5.2): a LLaMA-style decoder distilled from the
cloud LLM and LoRA-fine-tuned at the edge (port of
``repro.configs.flad_adllm``)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="flad-adllm",
    family="dense",
    num_layers=16,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=4096,
    vocab_size=32000,
    rope_theta=1e4,
)
