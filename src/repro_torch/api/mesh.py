"""Declarative mesh of the port (port of ``repro/api/mesh.py``).

:class:`MeshSpec` keeps the reference's dims, axis names and parsing:
``(2, 4)`` is data 2 x model 4 and ``(2, 2, 2)`` pod x data x model
(FLAD's mapping: ``pod`` = cloud regions, ``data`` = vehicles / edge FL
clients, ``model`` = the pipeline stages of one vehicle cluster).

The port runs on one card, so :meth:`MeshSpec.build` returns a
:class:`Mesh` that holds only the axis sizes and the torch device: no
process group is formed and nothing is forked. The FHDP step
(:mod:`repro_torch.core.pipeline`) runs every rank's work in one process
on that device, rank after rank, with the reference's collectives as
plain tensor operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AXES = ("pod", "data", "model")

_LATER = ("the production meshes come with the dry-run slice of the port "
          "(A8 in ROADMAP.md), which lowers for meshes no card holds")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh on one device: ``shape`` maps each axis name to its size
    (in ``axis_names`` order, as the reference's ``Mesh.shape``)."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def fl_clients(self) -> int:
        """FL client columns: the product of the pod and data axes."""
        return math.prod(n for a, n in self.shape.items() if a != "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: dims + axis names (+ the reference's device
    count and production switches).

    ``dims``     trailing-aligned against ``(pod, data, model)`` unless
                 ``axes`` is given: ``(2, 4)`` -> data=2, model=4.
    ``devices``  None or 0: the ranks share the one device; N: the
                 reference forces N host devices, so N below the mesh's
                 size raises, as the reference's does when too few
                 devices exist.
    ``production``/``multi_pod`` select the reference's deployment
                 meshes, which come with the dry-run slice and raise.
    """

    dims: Tuple[int, ...] = (2, 4)
    axes: Optional[Tuple[str, ...]] = None
    devices: Optional[int] = None
    production: bool = False
    multi_pod: bool = False

    @classmethod
    def parse(cls, spec: Union["MeshSpec", str, Sequence[int], None], *,
              devices: Optional[int] = None) -> "MeshSpec":
        """Coerce ``--mesh``-style input ('2,4', (2, 4), MeshSpec, None)."""
        if spec is None:
            return cls(devices=devices)
        if isinstance(spec, MeshSpec):
            return spec if devices is None else \
                dataclasses.replace(spec, devices=devices)
        try:
            if isinstance(spec, str):
                dims = tuple(int(x) for x in spec.split(","))
            else:
                dims = tuple(int(x) for x in spec)
        except (TypeError, ValueError):
            raise ValueError(
                f"mesh spec {spec!r}: expected comma-separated ints like "
                f"'2,4' (data,model) or '2,4,4' (pod,data,model)") from None
        if not 1 <= len(dims) <= len(AXES):
            raise ValueError(f"mesh dims {dims}: want 1..{len(AXES)} axes")
        return cls(dims=dims, devices=devices)

    def _check_ported(self) -> None:
        if self.production or self.multi_pod:
            raise NotImplementedError(_LATER)

    @property
    def size(self) -> int:
        self._check_ported()
        return math.prod(self.dims)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        self._check_ported()
        return self.axes or AXES[-len(self.dims):]

    @property
    def fl_clients(self) -> int:
        """FL client columns: the product of the pod and data axes."""
        return math.prod(n for a, n in zip(self.axis_names, self.dims)
                         if a != "model")

    def build(self, device="cuda") -> Mesh:
        """The mesh on ``device``: every rank runs there."""
        names = self.axis_names
        if len(names) != len(self.dims) or len(set(names)) != len(names) \
                or not set(names) <= set(AXES):
            raise ValueError(f"mesh axes {names} do not fit dims "
                             f"{self.dims} (axes from {AXES})")
        if self.devices and self.devices < self.size:
            raise RuntimeError(
                f"need {self.size} devices, have {self.devices}: the mesh "
                f"{dict(zip(names, self.dims))} has {self.size} ranks")
        return Mesh(dict(zip(names, self.dims)), torch.device(device))
