"""Preventive pipeline-template pregeneration (port of
``repro/recovery/templates.py``; paper §4.2).

For every vehicle v in a cluster, pre-compute the pipeline the cluster
would run if v departed — template generation runs concurrently with
training, so on failure the replacement deploys without replanning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.sched.costmodel import CostParams, Unit, Vehicle
from repro_torch.sched.swift import (DoubleDQN, Pipeline, dqn_pipeline,
                                     phase1_greedy)


@dataclasses.dataclass
class TemplateSet:
    active: Pipeline
    # vid -> pipeline for the cluster WITHOUT that vehicle (None: infeasible)
    on_departure: Dict[int, Optional[Pipeline]]


def pregenerate(vehicles: Sequence[Vehicle], units: Sequence[Unit],
                cp: Optional[CostParams] = None,
                agent: Optional[DoubleDQN] = None,
                active: Optional[Pipeline] = None) -> TemplateSet:
    """Build the active pipeline plus one preventive template per potential
    departure (paper: 'pre-generates pipeline configurations for potential
    stage disconnections'). ``active`` overrides the phase-1 choice — used
    when the caller already ran full SWIFT and deployed its winner."""
    cp = cp or CostParams()
    if active is None:
        active = phase1_greedy(vehicles, units, cp)
    if active is None:
        raise ValueError("cluster cannot host the model at all")
    on_dep: Dict[int, Optional[Pipeline]] = {}
    for v in vehicles:
        rest = [w for w in vehicles if w.vid != v.vid]
        pipe = None
        if agent is not None:
            pipe = dqn_pipeline(agent, rest, units, cp)
        if pipe is None:
            pipe = phase1_greedy(rest, units, cp)
        on_dep[v.vid] = pipe
    return TemplateSet(active, on_dep)


def partition_ranges(pipe: Pipeline) -> Dict[int, tuple]:
    """vid -> (unit_start, unit_end) of its stage in the unit sequence."""
    out, off = {}, 0
    for v, units in zip(pipe.path, pipe.partition):
        out[v.vid] = (off, off + len(units))
        off += len(units)
    return out


def redistribution_bytes(old: Pipeline, new: Pipeline) -> float:
    """Bytes that must move to switch old -> new: every unit whose hosting
    vehicle changed (paper: 'distributes only modified model partitions')."""
    old_owner = {}
    off = 0
    for v, units in zip(old.path, old.partition):
        for u in units:
            old_owner[off] = (v.vid, u.cap)
            off += 1
    moved = 0.0
    off = 0
    for v, units in zip(new.path, new.partition):
        for u in units:
            owner = old_owner.get(off)
            if owner is None or owner[0] != v.vid:
                moved += u.cap
            off += 1
    return moved


def full_redistribution_bytes(pipe: Pipeline) -> float:
    return sum(u.cap for units in pipe.partition for u in units)
