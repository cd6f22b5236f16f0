"""Fault injection for the simulated vehicular cluster (port of
``repro/recovery/failures.py``; paper §4.2 / §6.3).

Failures are vehicle departures/disconnects drawn from per-vehicle hazard
rates derived from dwell predictions. The simulator drives the recovery
benchmarks; the *mechanism* under test (template diff, partial
redistribution, backup restore) is the real implementation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sched.costmodel import Vehicle


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    time: float
    vid: int
    kind: str         # 'departure' | 'disconnect' (transient)


def sample_failures(vehicles: Sequence[Vehicle], horizon: float, *,
                    seed: int = 0, disconnect_rate: float = 0.2
                    ) -> List[FailureEvent]:
    """Departure at the (noisy) end of each dwell window; Poisson transient
    disconnects on top."""
    rng = np.random.default_rng(seed)
    events: List[FailureEvent] = []
    for v in vehicles:
        dep = v.dwl * rng.uniform(0.7, 1.1)
        if dep < horizon:
            events.append(FailureEvent(float(dep), v.vid, "departure"))
        n = rng.poisson(disconnect_rate * horizon / 3600.0)
        for t in rng.uniform(0, horizon, n):
            events.append(FailureEvent(float(t), v.vid, "disconnect"))
    return sorted(events, key=lambda e: e.time)
