"""xLSTM-350M: sLSTM + mLSTM blocks in a 7:1 layout [arXiv:2405.04517]
(port of ``repro.configs.xlstm_350m``)."""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,            # xLSTM blocks carry internal 2x expansion, no FFN
    vocab_size=50304,
    ssm=SSMConfig(state_size=0, conv_kernel=4, slstm_every=8, expand=2),
)
