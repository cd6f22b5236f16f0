"""Flat-file checkpointing (port of ``repro/train/checkpoint.py``): a
numpy ``.npz`` of a path-flattened tree, in the reference's layout, so a
checkpoint crosses between the packages both ways.

Keys are the ``/``-joined paths of the tree's dict keys, ``__step__``
holds the step, and an optional JSON
sidecar ``<path>.meta.json`` holds metadata (the strategy's stage
templates). A bfloat16 leaf is stored as its raw 16-bit pattern with
numpy's two-byte void dtype, ``|V2`` — what the reference writes for a
bfloat16 array, having no bfloat16 of numpy's own — and loads back
bitwise as ``torch.bfloat16``. (The reference's own ``load`` cannot read
those leaves back: numpy has no cast from ``|V2`` to bfloat16.)
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_RAW16 = np.dtype("V2")


def _items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys sorted (the reference's
    leaf order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW16)
        return t.numpy()
    return np.asarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return _npz_path(path)[:-len(".npz")] + ".meta.json"


def save(path: str, tree, step: int = 0, meta: Optional[dict] = None) -> None:
    """Save a tree; ``meta`` (JSON-serializable) is written as a sidecar
    next to the .npz — structured strategies record their stage templates
    there so a checkpoint can be merged/restaged without out-of-band
    knowledge of the layout it was taken under."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _items(tree)}
    np.savez(path, __step__=np.asarray(step), **flat)
    if meta is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)


def load_meta(path: str) -> Optional[dict]:
    """The checkpoint's sidecar metadata, or None if it was saved bare."""
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "Vui":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if arr.dtype.kind == "V":
        raise TypeError(f"a raw {arr.dtype} leaf only loads as bfloat16, "
                        f"not {dtype}")
    return torch.from_numpy(arr.copy()).to(dtype)


def load(path: str, like, device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a nested dict of tensors;
    shapes must match): each
    leaf takes the dtype of ``like``'s and goes to ``device`` (default:
    the ``like`` leaf's own, the CPU for a meta tensor)."""
    with np.load(_npz_path(path)) as data:
        step = int(data["__step__"])
        flat = {k: data[k] for k in data.files if k != "__step__"}

    def restore(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: {arr.shape} != {tuple(leaf.shape)}")
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        return _to_torch(arr, leaf.dtype).to(dev)

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        return restore(_SEP.join(prefix), tree)

    return build(like), step
