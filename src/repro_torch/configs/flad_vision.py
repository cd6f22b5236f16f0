"""FLAD's own vision encoder (paper Fig. 1/3): multimodal RGB + LiDAR token
fusion transformer with waypoint and traffic-light heads, about 100 M
parameters; the model FHDP trains across vehicles (port of
``repro.configs.flad_vision``)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="flad-vision",
    family="vision",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=0,
    prefix_tokens=128,     # patch/pillar tokens per modality
    prefix_dim=256,        # stub backbone feature width
    num_waypoints=10,
    num_light_classes=4,
    param_dtype="float32",
)
