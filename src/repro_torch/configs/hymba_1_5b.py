"""Hymba-1.5B: parallel attention + mamba heads per block, ssm_state=16
[arXiv:2411.13676] (port of ``repro.configs.hymba_1_5b``)."""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=1e4,
    ssm=SSMConfig(state_size=16, conv_kernel=4, expand=2),
)
