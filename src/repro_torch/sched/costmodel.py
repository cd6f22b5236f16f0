"""Analytic pipeline cost model (port of ``repro/sched/costmodel.py``;
paper Eqs. 7-10).

The paper measures per-module computation ``M_cmp`` (FLOPs/sample), memory
footprint ``M_cap`` (bytes, ~10x params for training state), and boundary
activation volume ``M_com``. Timing:

  t_cmp = M_cmp * N_batch * nu / (cmp_v * mu)          (Eq. 8)
  t_com = 2 * M_com * N_batch * nu / com_v             (Eq. 9)
  t_path(p, P) = sum t_cmp + sum t_com (non-final)     (Eq. 10)

``mu`` (GPU utilization 0.3-0.7) and ``nu`` (memory-bandwidth overhead
1.1-1.5) keep the paper's calibration. Every cost is a Python float
computed in the reference's order, so unit costs and path times equal
the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.config import ModelConfig

BYTES_PER_PARAM_TRAIN = 10  # activations+grads+optimizer (paper §4.1.1)

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


def demo_fleet(unit_cap: float) -> List[dict]:
    """The heterogeneous 5-vehicle fixture of the reference's repartition
    example and benchmark: vehicle memories/compute sized (in units of
    one model unit's training footprint ``unit_cap``) so SWIFT must span
    multiple vehicles — two fast 2-unit hosts, a small 1-unit host, and
    two roomy-but-slow stragglers a single-vehicle pipeline would
    bottleneck on."""
    return [
        dict(cmp=1.0e12, mem=2.2 * unit_cap, com=0.10e9, stb=0.95),
        dict(cmp=0.8e12, mem=2.2 * unit_cap, com=0.10e9, stb=0.85),
        dict(cmp=0.5e12, mem=1.2 * unit_cap, com=0.05e9, stb=0.70),
        dict(cmp=0.3e12, mem=4.5 * unit_cap, com=0.25e9, stb=0.60),
        dict(cmp=0.3e12, mem=4.5 * unit_cap, com=0.25e9, stb=0.50),
    ]


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


@dataclasses.dataclass(frozen=True)
class Unit:
    """One partitionable model unit (paper: a DAG node after topo-sort;
    here: a transformer block or frontend module)."""
    name: str
    cap: float        # training memory footprint (bytes)
    cmp: float        # FLOPs per sample (fwd+bwd)
    com: float        # boundary activation bytes per sample


def model_units(cfg: ModelConfig, *, seq_len: int = 1024,
                dtype_bytes: int = 2,
                num_units: Optional[int] = None) -> List[Unit]:
    """Units for an architecture: per-block FLOPs/bytes from the config.

    fwd+bwd FLOPs ~= 6 * params_per_block * tokens (dense); the boundary
    volume is the residual stream [seq, d_model]. ``num_units`` overrides
    the unit count (default: one per layer) while preserving the model's
    total cost.
    """
    d = cfg.d_model
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def attn_params():
        return d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 2 * d

    def ffn_params():
        if cfg.moe.num_experts:
            k = cfg.moe.top_k
            return d * cfg.moe.num_experts \
                + k * 3 * d * cfg.moe.d_expert  # active params per token
        return 3 * d * cfg.d_ff

    def ffn_store():
        if cfg.moe.num_experts:
            return d * cfg.moe.num_experts \
                + cfg.moe.num_experts * 3 * d * cfg.moe.d_expert
        return 3 * d * cfg.d_ff

    blk_active = attn_params() + ffn_params()
    blk_store = attn_params() + ffn_store()
    n = num_units or cfg.num_layers
    scale = cfg.num_layers / n
    units = []
    for i in range(n):
        cmp_ = (6 * blk_active * seq_len
                + 4 * nq * hd * seq_len * seq_len) * scale
        units.append(Unit(
            f"block{i}",
            cap=blk_store * dtype_bytes * BYTES_PER_PARAM_TRAIN / 2 * scale,
            cmp=cmp_,
            com=seq_len * d * dtype_bytes))
    return units


def vision_encoder_units(cfg: ModelConfig, *, tokens: int = 256,
                         dtype_bytes: int = 4) -> List[Unit]:
    """The paper's own vision encoder DAG (RGB, LiDAR, Enc, Dec modules),
    as the topo-sorted unit list the scheduler partitions."""
    from repro_torch.sched.graph import vision_encoder_graph
    g = vision_encoder_graph(cfg, tokens=tokens, dtype_bytes=dtype_bytes)
    return [Unit(n.name, n.cap, n.cmp, n.com) for n in g.topo_sorted()]


@dataclasses.dataclass(frozen=True)
class CostParams:
    mu: float = 0.5      # compute utilization (paper: 0.3-0.7)
    nu: float = 1.3      # memory-bandwidth overhead (paper: 1.1-1.5)
    n_batch: int = 16    # samples per epoch step


def t_cmp(units_cmp: float, v: Vehicle, cp: CostParams) -> float:
    return units_cmp * cp.n_batch * cp.nu / (v.cmp * cp.mu)       # Eq. 8


def t_com(boundary_bytes: float, v: Vehicle, cp: CostParams) -> float:
    return 2.0 * boundary_bytes * cp.n_batch * cp.nu / v.com      # Eq. 9


def t_uplink(nbytes: float, v: Vehicle) -> float:
    """One-way vehicle -> edge transfer of ``nbytes`` over the vehicle's
    V2X link (contrast :func:`t_com`, the per-step boundary-activation
    exchange of Eq. 9)."""
    return nbytes / v.com


def path_time(path: Sequence[Vehicle], partition: Sequence[Sequence[Unit]],
              cp: CostParams) -> float:
    """Eq. 10: sum of stage compute plus inter-stage communication."""
    total = 0.0
    for i, (v, units) in enumerate(zip(path, partition)):
        total += t_cmp(sum(u.cmp for u in units), v, cp)
        if i < len(path) - 1 and units:
            total += t_com(units[-1].com, v, cp)
    return total


def partition_feasible(path: Sequence[Vehicle],
                       partition: Sequence[Sequence[Unit]]) -> bool:
    """Eq. 11 c2: every stage fits its vehicle's memory."""
    return all(sum(u.cap for u in units) <= v.mem
               for v, units in zip(path, partition))


def pipeline_throughput(path, partition, cp: CostParams,
                        microbatches: int = 8) -> float:
    """Samples/s under GPipe pipelining: bottleneck-stage-bound with the
    (M + S - 1)/M bubble factor."""
    stage_times = []
    for i, (v, units) in enumerate(zip(path, partition)):
        t = t_cmp(sum(u.cmp for u in units), v, cp) / cp.n_batch
        if i < len(path) - 1 and units:
            t += t_com(units[-1].com, v, cp) / cp.n_batch
        stage_times.append(t)
    bottleneck = max(stage_times) if stage_times else 1e9
    bubble = (microbatches + len(path) - 1) / microbatches
    return 1.0 / (bottleneck * bubble)
