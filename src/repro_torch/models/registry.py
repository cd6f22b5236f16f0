"""Uniform model interface (port of ``repro/models/registry.py``, dense,
ssm, hybrid, encdec and vision families): ``build_model(cfg)`` returns a :class:`Model`
whose members are plain functions, as the reference's.

The dense ``loss`` is the reference's ``_build_lm`` loss — the decoder's
final hidden states into the chunked cross-entropy, never materializing
the [B, S, V] logits; its ``prefill``/``decode_step`` run the
contiguous-cache forward (plain attention over the cache, as the
reference runs XLA there). The ssm family is the xLSTM: its ``loss`` is
the same chunked cross-entropy over ``xlstm.forward``'s hidden states
(the mLSTM's forward and backward kernels, every layer checkpointed),
``prefill`` runs the mLSTM's chunkwise kernel, ``decode_step`` the cells'
one-token steps. The hybrid family is Hymba
(:mod:`repro_torch.models.hymba`): the same chunked cross-entropy, its
attention on the flash kernels in training and on plain attention over
the contiguous cache in ``prefill``/``decode_step``, its Mamba heads
plain PyTorch. The encdec family is the encoder-decoder
(:mod:`repro_torch.models.encdec`): its ``loss`` encodes the frames
(the flash kernels without a causal mask), makes the cross K/V and runs
the decoder (the flash kernels, causal) into the same chunked
cross-entropy; ``prefill`` encodes, replaces the state's cross K/V and
fills the decoder's contiguous cache, ``decode_step`` attends over both
with plain attention, as the reference. The vision family is FLAD's vision
encoder (:mod:`repro_torch.models.vision_encoder`): its ``loss`` trains
it; it has no decode path, and ``prefill``/``decode_step`` raise, as the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import encdec, hymba, lm, vision_encoder, xlstm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]          # (seed, device) -> params
    loss: Callable[..., Any]          # (params, batch) -> (loss, metrics)
    init_state: Callable[..., Any]    # (batch, cache_len, device) -> state
    prefill: Callable[..., Any]       # (params, batch, state)
    decode_step: Callable[..., Any]   # (params, tokens, state, pos)
    # prefill and decode_step return (logits [B, S, V] float32, state)


def _hidden_ce(params, x, labels, aux):
    """Chunked CE from final hidden states."""
    from repro_torch.train.losses import chunked_ce, head_weight
    loss, metrics = chunked_ce(x, head_weight(params), labels)
    return loss + aux, dict(metrics, aux=aux)


# -------------------------------------------------------------- dense ----
def _build_lm(cfg: ModelConfig) -> Model:
    lm._check_family(cfg)

    def init(seed: int = 0, device="cuda"):
        return lm.init(cfg, seed=seed, device=device)

    def loss(params, batch, *, remat=True, window=None):
        x, _, aux = lm.forward(params, cfg, batch["tokens"], window=window,
                               remat=remat, hidden_only=True)
        return _hidden_ce(params, x, batch["labels"], aux)

    def init_state(batch: int, cache_len: int, device="cuda"):
        return {"caches": lm.init_cache(cfg, batch, cache_len, device)}

    def prefill(params, batch, state, *, window=None):
        logits, caches, _ = lm.forward(params, cfg, batch["tokens"],
                                       caches=state["caches"], window=window,
                                       logits_slice=1)
        return logits, {"caches": caches}

    def decode_step(params, tokens, state, pos, *, window=None):
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=tokens.device)
        logits, caches, _ = lm.forward(params, cfg, tokens,
                                       positions=positions,
                                       caches=state["caches"], window=window)
        return logits, {"caches": caches}

    return Model(cfg, init, loss, init_state, prefill, decode_step)


# ---------------------------------------------------------------- ssm ----
def _build_xlstm(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda"):
        return xlstm.init(cfg, seed=seed, device=device)

    def loss(params, batch, *, remat=True, window=None):
        # every layer is checkpointed whatever ``remat`` says, as the
        # reference's sequence form remats each one (xlstm.forward)
        x, _, aux = xlstm.forward(params, cfg, batch["tokens"],
                                  hidden_only=True)
        return _hidden_ce(params, x, batch["labels"], aux)

    def init_state(batch: int, cache_len: int, device="cuda"):
        return xlstm.init_state(cfg, batch, device)

    def prefill(params, batch, state):
        logits, st, _ = xlstm.forward(params, cfg, batch["tokens"],
                                      states=state, logits_slice=1)
        return logits, st

    def decode_step(params, tokens, state, pos):
        logits, st, _ = xlstm.forward(params, cfg, tokens, states=state,
                                      step=True)
        return logits, st

    return Model(cfg, init, loss, init_state, prefill, decode_step)


# ------------------------------------------------------------- hybrid ----
def _build_hymba(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda"):
        return hymba.init(cfg, seed=seed, device=device)

    def loss(params, batch, *, remat=True, window=None):
        x, _, aux = hymba.forward(params, cfg, batch["tokens"],
                                  window=window, hidden_only=True,
                                  remat=remat)
        return _hidden_ce(params, x, batch["labels"], aux)

    def init_state(batch: int, cache_len: int, device="cuda"):
        return hymba.init_state(cfg, batch, cache_len, device)

    def prefill(params, batch, state, *, window=None):
        logits, st, _ = hymba.forward(params, cfg, batch["tokens"],
                                      states=state, window=window,
                                      logits_slice=1)
        return logits, st

    def decode_step(params, tokens, state, pos, *, window=None):
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=tokens.device)
        logits, st, _ = hymba.forward(params, cfg, tokens,
                                      positions=positions, states=state,
                                      window=window, step=True)
        return logits, st

    return Model(cfg, init, loss, init_state, prefill, decode_step)


# ------------------------------------------------------------- encdec ----
def _build_encdec(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda"):
        return encdec.init(cfg, seed=seed, device=device)

    def loss(params, batch, *, remat=True, window=None):
        memory = encdec.encode(params, cfg, batch["frames"], window=window,
                               remat=remat)
        cross = encdec.make_cross_kv(params, cfg, memory)
        x, _ = encdec.decode(params, cfg, batch["tokens"], cross,
                             window=window, hidden_only=True, remat=remat)
        return _hidden_ce(params, x, batch["labels"],
                          torch.zeros((), dtype=torch.float32,
                                      device=x.device))

    def init_state(batch: int, cache_len: int, device="cuda"):
        # cross_kv is replaced by prefill; its zeros (one buffer for K and
        # V, as the reference's) let a decode without a prefill run
        from repro_torch.configs.common import ENC_MEMORY_DECODE
        ck = torch.zeros((cfg.dec_layers, batch, cfg.num_kv_heads,
                          ENC_MEMORY_DECODE, cfg.hd), dtype=cfg.dtype,
                         device=device)
        return {"caches": encdec.init_cache(cfg, batch, cache_len, device),
                "cross_kv": (ck, ck)}

    def prefill(params, batch, state, *, window=None):
        memory = encdec.encode(params, cfg, batch["frames"], window=window)
        cross = encdec.make_cross_kv(params, cfg, memory)
        logits, caches = encdec.decode(params, cfg, batch["tokens"], cross,
                                       caches=state["caches"], window=window,
                                       logits_slice=1)
        return logits, {"caches": caches, "cross_kv": cross}

    def decode_step(params, tokens, state, pos, *, window=None):
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=tokens.device)
        logits, caches = encdec.decode(params, cfg, tokens,
                                       state["cross_kv"],
                                       positions=positions,
                                       caches=state["caches"], window=window)
        return logits, {"caches": caches, "cross_kv": state["cross_kv"]}

    return Model(cfg, init, loss, init_state, prefill, decode_step)


# ------------------------------------------------------------- vision ----
def _build_vision(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, device="cuda"):
        return vision_encoder.init(cfg, seed=seed, device=device)

    def loss(params, batch, *, remat=True, window=None):
        return vision_encoder.loss_fn(params, cfg, batch)

    def unsupported(*a, **k):
        raise NotImplementedError("vision encoder has no decode path")

    return Model(cfg, init, loss, lambda *a, **k: {}, unsupported,
                 unsupported)


FAMILIES = {"dense": _build_lm, "ssm": _build_xlstm,
            "hybrid": _build_hymba, "encdec": _build_encdec,
            "vision": _build_vision}


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of a dense, ssm, hybrid or encdec config on the
    ``meta`` device (shapes and dtypes only), as the reference's
    ``_abstract_init``."""
    if cfg.family == "ssm":
        return xlstm.abstract_params(cfg)
    if cfg.family == "hybrid":
        return hymba.abstract_params(cfg)
    if cfg.family == "encdec":
        return encdec.abstract_params(cfg)
    return lm.abstract_params(cfg)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port covers the families {sorted(FAMILIES)} so far, "
            f"not {cfg.name!r} ({cfg.family})")
    return FAMILIES[cfg.family](cfg)
