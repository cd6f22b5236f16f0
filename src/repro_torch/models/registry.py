"""Uniform model interface (port of ``repro/models/registry.py``, dense
family only): ``build_model(cfg)`` returns a :class:`Model` whose
``loss(params, batch)`` is the reference's ``_build_lm`` loss — the
decoder's final hidden states into the chunked cross-entropy, never
materializing the [B, S, V] logits."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.config import ModelConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    loss: Callable[..., Any]          # (params, batch) -> (loss, metrics)


def _hidden_ce(params, x, labels, aux):
    """Chunked CE from final hidden states."""
    from repro_torch.train.losses import chunked_ce, head_weight
    loss, metrics = chunked_ce(x, head_weight(params), labels)
    return loss + aux, dict(metrics, aux=aux)


def build_model(cfg: ModelConfig) -> Model:
    lm._check_family(cfg)

    def loss(params, batch, *, remat=True, window=None):
        x, _, aux = lm.forward(params, cfg, batch["tokens"], window=window,
                               remat=remat, hidden_only=True)
        return _hidden_ce(params, x, batch["labels"], aux)

    return Model(cfg, loss)
