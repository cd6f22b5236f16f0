"""SeamlessM4T-large-v2 backbone: enc-dec transformer [arXiv:2308.11596]
(port of ``repro.configs.seamless_m4t_large_v2``). 24 layers total (12
enc + 12 dec); the mel/conformer audio frontend is a stub feeding 1024-d
frame embeddings."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=1e4,
    prefix_dim=1024,   # stub audio frontend feature width
)
