"""Vehicle fleet model (copy of ``Vehicle``, ``parse_fleet`` and
``t_uplink`` from ``repro/sched/costmodel.py``; the pipeline cost model
around them is not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Vehicle:
    """A participant: compute (FLOP/s), memory (bytes), link (bytes/s),
    stability score (Eq. 5) and predicted dwell time (s)."""
    vid: int
    cmp: float
    mem: float
    com: float
    stb: float = 1.0
    dwl: float = 1e9


# The paper's Jetson testbed (Table 1).
JETSON_NX = dict(cmp=0.404e12, mem=8e9, com=0.125e9)
JETSON_NANO = dict(cmp=0.472e12, mem=8e9, com=0.125e9)
JETSON_AGX = dict(cmp=3.85e12, mem=32e9, com=0.25e9)

#: the reference's modeled TPU v5e participant (its HardwareConfig)
TPU_CHIP = dict(cmp=197e12, mem=16 * 2 ** 30, com=50e9)

#: named vehicle classes for the declarative fleet spec ("nano*4,agx*2")
FLEET_PRESETS = {"nano": JETSON_NANO, "nx": JETSON_NX, "agx": JETSON_AGX,
                 "tpu": TPU_CHIP}


def make_fleet(specs: Sequence[dict], *, stb: Optional[Sequence[float]] = None,
               dwl: Optional[Sequence[float]] = None) -> List[Vehicle]:
    out = []
    for i, s in enumerate(specs):
        out.append(Vehicle(i, s["cmp"], s["mem"], s["com"],
                           stb[i] if stb is not None else s.get("stb", 1.0),
                           dwl[i] if dwl is not None else s.get("dwl", 1e9)))
    return out


def parse_fleet(spec) -> List[Vehicle]:
    """Coerce a fleet declaration into vehicles.

    Accepts "nano*4,agx*2"-style preset strings (see :data:`FLEET_PRESETS`),
    a sequence of spec dicts (``cmp``/``mem``/``com`` required, ``stb``/
    ``dwl`` optional), or a sequence of :class:`Vehicle` (passed through).
    """
    if isinstance(spec, str):
        dicts = []
        for part in spec.split(","):
            name, _, mult = part.strip().partition("*")
            if name not in FLEET_PRESETS:
                raise ValueError(
                    f"unknown vehicle class {name!r}; presets: "
                    f"{', '.join(sorted(FLEET_PRESETS))}")
            dicts += [dict(FLEET_PRESETS[name])] * (int(mult) if mult else 1)
        return make_fleet(dicts)
    spec = list(spec)
    if all(isinstance(v, Vehicle) for v in spec):
        return spec
    return make_fleet([dict(s) for s in spec])


def t_uplink(nbytes: float, v: Vehicle) -> float:
    """One-way vehicle -> edge transfer of ``nbytes`` over the vehicle's
    V2X link."""
    return nbytes / v.com
