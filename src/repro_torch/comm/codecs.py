"""Update codecs for the uplink (port of ``repro/comm/codecs.py``).

Every codec maps a flat float leaf to a wire payload and back, and
reports the payload's wire size. Lossy codecs run with **error
feedback**: the un-transmitted remainder of round t is added to the
update of round t+1 (:func:`roundtrip_stacked` carries the residual
tree), so the compression error telescopes.

  ``none``  float32 passthrough (4 B/elem)
  ``int8``  rowwise-absmax stochastic int8 (1 B/elem + 4 B per 128-lane
            row) through the hand-written quantize/dequantize kernels
  ``topk``  magnitude top-k sparsification (8 B per kept element)

Randomness crosses as explicit uint32 words, as the quantize kernel takes
them: ``encode(flat, bits)``, and :func:`roundtrip_stacked` takes a
*bits source* ``bits(leaf_index, client_index, shape) -> uint32 tensor``
instead of the reference's PRNG key. The default source draws from a
``torch.Generator`` (:class:`GeneratorBits`); a test that compares the
packages hands in the reference's own ``jax.random.bits``.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, Optional, Tuple, Type

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import LANES
from repro_torch.tree import flatten, leaves, tree_map, unflatten

_REGISTRY: Dict[str, Type["Codec"]] = {}

BitsSource = Callable[[int, int, Tuple[int, ...]], torch.Tensor]


def register_codec(name: str) -> Callable[[type], type]:
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_codec(name: str, **options) -> "Codec":
    """Instantiate a registered codec; unknown names list valid ones."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: "
            f"{', '.join(available_codecs())}") from None
    return cls(**options)


class Codec(abc.ABC):
    """Flat-leaf wire codec."""

    name: str = ""
    #: lossless codecs skip the error-feedback residual entirely
    lossless: bool = False

    def bits_shape(self, size: int) -> Optional[Tuple[int, ...]]:
        """Shape of the uint32 random words one [size] leaf's encode
        takes, or None for a deterministic codec."""
        return None

    @abc.abstractmethod
    def encode(self, flat: torch.Tensor, bits: Optional[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """flat float [N] -> wire payload (dict of tensors)."""

    @abc.abstractmethod
    def decode(self, payload: Dict[str, torch.Tensor], size: int
               ) -> torch.Tensor:
        """Wire payload -> float32 [size] (what the edge reconstructs)."""

    @abc.abstractmethod
    def nbytes(self, size: int) -> int:
        """Wire bytes for one [size] leaf."""

    def edge_nbytes(self, size: int, members: int) -> int:
        """Wire bytes for an edge pod's aggregated update of one [size]
        leaf (``members`` vehicles); dense formats keep the client's."""
        return self.nbytes(size)


@register_codec("none")
class IdentityCodec(Codec):
    """float32 passthrough — the uncompressed FedAvg wire format."""

    lossless = True

    def encode(self, flat, bits=None):
        return {"values": flat.float()}

    def decode(self, payload, size):
        return payload["values"]

    def nbytes(self, size):
        return 4 * size


@register_codec("int8")
class Int8Codec(Codec):
    """Rowwise-absmax int8 with unbiased stochastic rounding: the flat
    leaf is packed into rows of 128 lanes (zero-padded tail) for the
    quantize kernel; one float32 scale per row rides along."""

    def _rows(self, size: int) -> int:
        return -(-size // LANES)

    def bits_shape(self, size):
        return (self._rows(size), LANES)

    def encode(self, flat, bits):
        rows = self._rows(flat.numel())
        x = torch.zeros((rows * LANES,), dtype=torch.float32,
                        device=flat.device)
        x[:flat.numel()] = flat.float()
        q, scale = ops.quantize_int8(x.reshape(rows, LANES), bits)
        return {"q": q, "scale": scale}

    def decode(self, payload, size):
        x = ops.dequantize_int8(payload["q"], payload["scale"])
        return x.reshape(-1)[:size]

    def nbytes(self, size):
        return size + 4 * self._rows(size)


@register_codec("topk")
class TopKCodec(Codec):
    """Magnitude top-k sparsification: the k largest-|.| entries as
    (float32 value, int32 index) pairs, scattered into zeros at the
    edge. ``k_frac`` is the kept fraction (>= 1 element)."""

    def __init__(self, *, k_frac: float = 0.05):
        if not 0.0 < k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {k_frac}")
        self.k_frac = k_frac

    def k(self, size: int) -> int:
        return max(1, min(size, int(round(self.k_frac * size))))

    def encode(self, flat, bits=None):
        f = flat.float()
        _, idx = torch.topk(f.abs(), self.k(f.numel()))
        return {"values": f[idx], "indices": idx.to(torch.int32)}

    def decode(self, payload, size):
        out = torch.zeros((size,), dtype=torch.float32,
                          device=payload["values"].device)
        out[payload["indices"].long()] = payload["values"]
        return out

    def nbytes(self, size):
        return 8 * self.k(size)

    def edge_nbytes(self, size, members):
        # the pod average's support is the union of its members' top-k
        # sets; past that, dense float32 wins
        union = min(members * self.k(size), size)
        return min(8 * union, 4 * size)


class GeneratorBits:
    """The default bits source: uint32 words from a ``torch.Generator``
    on ``device``, drawn in call order."""

    def __init__(self, seed: int, device="cuda"):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def __call__(self, leaf: int, client: int, shape) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31, tuple(shape),
                             generator=self.gen, dtype=torch.int32,
                             device=self.gen.device).view(torch.uint32)


# ---- tree-level error-feedback transport ---------------------------------

def tree_nbytes(codec: Codec, tree) -> int:
    """Wire bytes for one client's update of this tree."""
    return sum(codec.nbytes(leaf.numel()) for leaf in leaves(tree))


def tree_edge_nbytes(codec: Codec, tree, members: int) -> int:
    """Wire bytes for an edge pod's aggregated update of this tree."""
    return sum(codec.edge_nbytes(leaf.numel(), members)
               for leaf in leaves(tree))


def roundtrip_leaf(codec: Codec, leaf, residual, bits=None):
    """Encode + decode one leaf with error feedback: ``(decoded,
    new_residual)``, the latter zeros for lossless codecs."""
    x = leaf.float() + residual
    flat = x.reshape(-1)
    decoded = codec.decode(codec.encode(flat, bits), flat.numel())
    decoded = decoded.reshape(leaf.shape)
    if codec.lossless:
        return decoded, torch.zeros_like(residual)
    return decoded, x - decoded


def roundtrip_stacked(codec: Codec, stacked, residual,
                      bits: Optional[BitsSource] = None):
    """Per-client wire roundtrip of a client-stacked [C, ...] tree.

    ``residual`` is each client's float32 error-feedback state (same
    structure). Leaves go in flatten order and, within a leaf, client by
    client; client ``c``'s encode of leaf ``i`` takes ``bits(i, c,
    codec.bits_shape(size))``. The reference splits its key the same way
    (per leaf, then per client). ``bits`` defaults to a fresh
    :class:`GeneratorBits` on the tree's device."""
    leaves_, spec = flatten(stacked)
    res_leaves = leaves(residual)
    if bits is None:
        bits = GeneratorBits(0, leaves_[0].device)
    dec_cols, res_cols = [], []
    for i, (leaf, res) in enumerate(zip(leaves_, res_leaves)):
        shape = codec.bits_shape(leaf[0].numel())
        dec, new_res = torch.empty_like(res), torch.empty_like(res)
        for c in range(leaf.shape[0]):
            words = None if shape is None else bits(i, c, shape)
            dec[c], new_res[c] = roundtrip_leaf(codec, leaf[c], res[c], words)
        dec_cols.append(dec)
        res_cols.append(new_res)
    return unflatten(spec, dec_cols), unflatten(spec, res_cols)


def zero_residual(stacked):
    """Fresh float32 error-feedback state for a client-stacked tree."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), stacked)
