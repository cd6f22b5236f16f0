"""FLAD's own vision encoder (port of ``repro/models/vision_encoder.py``;
paper §4.1.3, "Complexity of Vision Encoder").

RGB and LiDAR features (the stub backbones' output: synthetic patch and
pillar features) are projected to d_model, tagged by modality and fused
by a transformer encoder of non-causal self-attention blocks; a
query-based decoder (one cross-attention over the encoder's features)
reads the waypoints and the traffic-light class. This is the model FHDP
trains across vehicles (:mod:`repro_torch.core.pipeline`).

On the card the encoder's self-attention runs the flash kernels
(non-causal); the decoder's cross-attention is plain
:func:`repro_torch.models.blocks.dense_mha` on every device, as the
reference leaves it to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.lm import ParamTree, layer


def init_enc_block(gen, cfg: ModelConfig, device, lead=()) -> dict:
    """One encoder block (the reference's ``encdec.init_enc_block``);
    ``lead`` prepends the layer axis."""
    d = cfg.d_model
    return {
        "ln1": B.init_rmsnorm(d, cfg.dtype, device, lead),
        "attn": B.init_attention(gen, cfg, device, lead),
        "ln2": B.init_rmsnorm(d, cfg.dtype, device, lead),
        "ffn": B.init_mlp(gen, cfg, device, lead),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the reference draws from a JAX key; the streams
    differ, so cross-package tests bridge one tree instead). Block
    parameters are stacked on a leading layer axis."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, dt = cfg.d_model, cfg.dtype
    nq = cfg.num_waypoints + 1   # waypoint queries + 1 traffic-light query
    return ParamTree({
        "rgb_proj": B.init_linear(gen, cfg.prefix_dim, d, dt, device),
        "lidar_proj": B.init_linear(gen, cfg.prefix_dim, d, dt, device),
        "modality_emb": B._normal(gen, (2, d), 0.02, dt, device),
        "blocks": init_enc_block(gen, cfg, device, (cfg.num_layers,)),
        "ln_f": B.init_rmsnorm(d, dt, device),
        "queries": B._normal(gen, (nq, d), 0.02, dt, device),
        "dec_attn": B.init_attention(gen, cfg, device, cross=True),
        "dec_ln": B.init_rmsnorm(d, dt, device),
        "wp_head": B.init_linear(gen, d, 2, dt, device, bias=True),
        "light_head": B.init_linear(gen, d, cfg.num_light_classes, dt,
                                    device, bias=True),
    })


def embed(params, cfg: ModelConfig, batch):
    """The two modalities' tokens, projected and tagged: [B, Pr + Pl, d]."""
    rgb = B.linear(params["rgb_proj"], batch["rgb"].to(cfg.dtype))
    lid = B.linear(params["lidar_proj"], batch["lidar"].to(cfg.dtype))
    return torch.cat([rgb + params["modality_emb"][0],
                      lid + params["modality_emb"][1]], dim=1)


def enc_block(lp, h, cfg: ModelConfig, positions, rot=None):
    """One encoder block: non-causal self-attention and the MLP."""
    a, _ = B.attention(lp["attn"], B.rms_norm(lp["ln1"], h, cfg.norm_eps),
                       cfg, positions=positions, rot=rot, causal=False,
                       positions_contiguous=True)
    h = h + a
    return h + B.mlp(lp["ffn"], B.rms_norm(lp["ln2"], h, cfg.norm_eps))


def heads(params, cfg: ModelConfig, x):
    """Encoder output x [B, P, d] -> (features [B, P, d], waypoints
    [B, W, 2] float32, light logits [B, C] float32): the final norm and
    the query decoder's cross-attention over the features."""
    feats = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
    b = feats.shape[0]
    q = params["queries"][None].expand((b,) + params["queries"].shape)
    nkv, hd = cfg.num_kv_heads, cfg.hd
    k = (feats @ params["dec_attn"]["wk"]).reshape(b, -1, nkv, hd) \
        .transpose(1, 2)
    v = (feats @ params["dec_attn"]["wv"]).reshape(b, -1, nkv, hd) \
        .transpose(1, 2)
    qpos = torch.arange(q.shape[1], dtype=torch.int32, device=x.device)
    kpos = torch.arange(feats.shape[1], dtype=torch.int32, device=x.device)
    dec, _ = B.attention(params["dec_attn"],
                         B.rms_norm(params["dec_ln"], q, cfg.norm_eps), cfg,
                         positions=qpos, cross_kv=(k, v), cross_pos=kpos,
                         causal=False)
    dec = dec + q
    wp = B.linear(params["wp_head"], dec[:, :cfg.num_waypoints]).float()
    light = B.linear(params["light_head"], dec[:, -1]).float()
    return feats, wp, light


def forward(params, cfg: ModelConfig, batch, **_):
    """batch {'rgb': [B, Pr, F], 'lidar': [B, Pl, F]} -> {'waypoints':
    [B, W, 2], 'light_logits': [B, C], 'features': [B, P, d]}."""
    x = embed(params, cfg, batch)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rot = B.rope_tables(pos, cfg.hd, cfg.rope_theta)
    for l in range(cfg.num_layers):
        x = enc_block(layer(params["blocks"], l), x, cfg, pos, rot)
    feats, wp, light = heads(params, cfg, x)
    return {"waypoints": wp, "light_logits": light, "features": feats}


def head_loss(wp, light, batch):
    """(l1 + ce, {"l1", "ce"}): the waypoints' mean L1 and the light
    class's cross-entropy. The L1 writes ``where(d >= 0, d, -d)``: JAX's
    derivative of abs at 0 is +1, torch's 0."""
    d = wp - batch["waypoints"]
    l1 = torch.where(d >= 0, d, -d).mean()
    logp = torch.log_softmax(light, dim=-1)
    ce = -torch.gather(logp, -1, batch["light"].long()[:, None]).mean()
    return l1 + ce, {"l1": l1, "ce": ce}


def loss_fn(params, cfg: ModelConfig, batch):
    """(l1 + ce, {"l1", "ce", "acc"}) of :func:`forward` on ``batch``."""
    out = forward(params, cfg, batch)
    loss, metrics = head_loss(out["waypoints"], out["light_logits"], batch)
    acc = (out["light_logits"].argmax(-1) == batch["light"].long()) \
        .float().mean()
    return loss, dict(metrics, acc=acc)
