"""Model and input-shape configuration (port of ``repro.config``).

Mirrors the reference's :class:`ModelConfig` field for field so a config
reads the same in both packages; ``dtype`` is a torch dtype here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0          # per-expert FFN hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State for xLSTM / Mamba-style recurrent paths."""
    state_size: int = 16       # per-head recurrent state dim (mamba N)
    conv_kernel: int = 4       # depthwise conv width (mamba)
    slstm_every: int = 0       # xlstm: 1-in-k blocks are sLSTM (0 = none)
    expand: int = 2            # mamba inner expansion


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    enc_layers: int = 0
    dec_layers: int = 0
    window: Optional[int] = None
    prefix_tokens: int = 0
    prefix_dim: int = 0
    num_waypoints: int = 0
    num_light_classes: int = 0
    param_dtype: str = "bfloat16"
    q_chunk: int = 512
    kv_chunk: int = 1024
    attn_block_q: int = 128
    attn_block_k: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (the async engine's compute-time model) ----
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        nq, nkv = self.num_heads, self.num_kv_heads
        V = self.vocab_size
        emb = V * d
        out = 0 if self.tie_embeddings else V * d

        def attn_params() -> int:
            p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * hd
            if self.qk_norm:
                p += 2 * hd
            return p + 2 * d  # two RMSNorm vectors per block

        def ffn_params() -> int:
            if self.moe.num_experts:
                e = self.moe.num_experts
                return d * e + e * 3 * d * self.moe.d_expert
            return 3 * d * self.d_ff  # SwiGLU

        def mlstm_params() -> int:
            di = self.ssm.expand * d
            # in-proj (x,z), out-proj, q/k/v projections, gates, conv
            return d * 2 * di + di * d + 3 * di * di + 2 * di + d

        def block_params() -> int:
            if self.family == "ssm":
                return mlstm_params() + ffn_params() + 2 * d
            if self.family == "hybrid":
                return attn_params() + mlstm_params() + ffn_params()
            return attn_params() + ffn_params()

        n = self.num_layers * block_params() + emb + out + d
        if self.family == "encdec":
            # decoder blocks additionally carry cross-attention
            n += self.dec_layers * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d + d)
        if self.prefix_tokens:
            n += self.prefix_dim * d  # projector
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if not self.moe.num_experts:
            return self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        full = self.param_count()
        expert_p = self.num_layers * e * 3 * self.d_model * self.moe.d_expert
        return full - expert_p + expert_p * k // e


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: sliding window used when a full-attention architecture runs long_500k
LONG_CONTEXT_WINDOW = 8192
