"""LoRA adapters over parameter trees (port of ``repro/distill/lora.py``;
paper §2.5/§5.2: PEFT makes on-vehicle and edge personalization feasible
under memory constraints).

``init_lora`` creates {"A", "B"} factors for every 2-D (or layer-stacked)
weight whose leaf name matches ``targets``; ``merge_lora`` folds
``w + scale * A @ B`` into a copy of the params (serving); ``lora_linear``
keeps the factors separate and runs the fused base + low-rank kernel
(:func:`repro_torch.kernels.ops.lora_matmul_ad`), so fine-tuning never
forms the merged weight and only (A, B) receive gradients.

The factor tree holds the adapted leaves only. The reference's holds
None at every other leaf, which its flatten drops, so leaf ``i`` of the
two trees is the same factor (:mod:`repro_torch.bridge` carries them
across).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import ops

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _items(tree, path=()):
    """(path, leaf) pairs in flatten (sorted-key) order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    else:
        yield path, tree


def _as_dict(params):
    return params.to_dict() if hasattr(params, "to_dict") else params


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_lora(params, cfg: LoRAConfig, *, seed: int = 0) -> dict:
    """Factors for every leaf of ``params`` whose name (its last key) is
    in ``cfg.targets`` and that has at least two dims: A [..., din, r]
    normal with std din**-0.5, B [..., r, dout] zeros, both float32, on
    the leaf's device, A drawn in flatten order from a ``torch.Generator``
    seeded with ``seed``; leading (layer) axes are kept. Meta leaves give
    meta factors (shapes only, for wire accounting).

    Raises ``ValueError`` when no leaf matches ``cfg.targets``: an empty
    factor tree would make fine-tuning a silent no-op."""
    items = list(_items(_as_dict(params)))
    out: dict = {}
    gen = None
    for path, leaf in items:
        if path[-1] not in cfg.targets or leaf.dim() < 2:
            continue
        din, dout = leaf.shape[-2:]
        lead = tuple(leaf.shape[:-2])
        dev = leaf.device
        if dev.type == "meta":
            a = torch.empty(lead + (din, cfg.rank), device=dev)
        else:
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
            a = torch.randn(lead + (din, cfg.rank), generator=gen,
                            device=dev) * din ** -0.5
        b = torch.zeros(lead + (cfg.rank, dout), device=dev)
        _set(out, path, {"A": a, "B": b})
    if not out:
        adaptable = sorted({p[-1] for p, leaf in items if leaf.dim() >= 2})
        raise ValueError(
            f"LoRA targets {tuple(cfg.targets)} match no parameter leaf — "
            f"fine-tuning would be a no-op (zero trainable factors); "
            f"adaptable 2-D leaf names in this tree: {adaptable}")
    return out


def _factor_at(lora, path):
    for k in path:
        if not isinstance(lora, dict) or k not in lora:
            return None
        lora = lora[k]
    return lora if isinstance(lora, dict) and "A" in lora else None


def merge_lora(params, lora: dict, cfg: LoRAConfig) -> dict:
    """A new param tree with ``w + scale * A @ B`` (float32, cast back to
    w's dtype) at every adapted leaf, batched over leading stack axes;
    other leaves are shared with ``params``."""
    out: dict = {}
    for path, leaf in _items(_as_dict(params)):
        f = _factor_at(lora, path)
        if f is not None:
            delta = torch.einsum("...ir,...ro->...io", f["A"].float(),
                                 f["B"].float()) * cfg.scale
            leaf = (leaf.float() + delta).to(leaf.dtype)
        _set(out, path, leaf)
    return out


def lora_linear(x, w, factors: dict, scale: float):
    """Adapted linear ``x @ w + scale * (x @ A) @ B`` through the fused
    kernel, differentiable (closed-form backward, dx through the same
    kernel). x: [..., K]; w: [K, N]; factors: {"A": [K, r], "B": [r, N]},
    cast to w's dtype as the reference does. Every adapted projection of
    ``lm.forward(lora=...)`` runs here."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = ops.lora_matmul_ad(x2, w, factors["A"].to(w.dtype),
                           factors["B"].to(w.dtype), scale=scale)
    return y.reshape(lead + (w.shape[-1],))


def apply_lora(x, w, factors: dict, cfg: LoRAConfig):
    """:func:`lora_linear` with the scale taken from a :class:`LoRAConfig`."""
    return lora_linear(x, w, factors, cfg.scale)


def lora_param_count(lora: dict) -> int:
    return sum(leaf.numel() for _, leaf in _items(lora))
