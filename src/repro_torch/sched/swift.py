"""SWIFT — Speedy Weight-based Intelligent Fast Two-phase scheduler
(port of ``repro/sched/swift.py``; paper §4.1.3).

Phase 1 (quick start): greedy matching over stability-ordered vehicles —
each vehicle takes the largest contiguous unit range its memory allows.
Stable vehicles sit in EARLY stages (they must persist longest).

Phase 2: for every remaining vehicle v_j (ascending stability) as the
first stage of a new pipeline, a double-DQN jointly picks (vehicle, units)
per stage (Eq. 11's coupled partition+order; reward Eq. 12). This gives
the |V| essential pipelines so every vehicle heads one pipeline — the
data-utilization requirement FHDP is built on.

Also provides :func:`greedy_matching` — the single-resource baseline the
paper compares against (Fig. 6): it optimizes memory fit only, ignoring
the compute/communication balance, and becomes infeasible or bottlenecked
as cluster size / model size grow.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sched.costmodel import CostParams, Unit, Vehicle, path_time
from repro_torch.sched.dqn import DQNConfig, DoubleDQN

N_MAX = 12                       # max cluster size the policy supports
CHUNK_OPTIONS = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass
class Pipeline:
    path: List[Vehicle]
    partition: List[List[Unit]]          # units per stage
    time: float

    def template(self) -> Tuple[int, ...]:
        return tuple(len(u) for u in self.partition)


# --------------------------------------------------------------------------
# Phase 1: greedy stability-ordered quick start
# --------------------------------------------------------------------------
def phase1_greedy(vehicles: Sequence[Vehicle], units: Sequence[Unit],
                  cp: CostParams) -> Optional[Pipeline]:
    """Stability-descending greedy: each stage takes the largest prefix of
    remaining units that fits memory (paper: 'each vehicle receiving the
    maximum partition size that satisfies its memory constraint')."""
    order = sorted(vehicles, key=lambda v: -v.stb)
    remaining = list(units)
    path, partition = [], []
    for v in order:
        if not remaining:
            break
        take, cap = [], 0.0
        while remaining and cap + remaining[0].cap <= v.mem:
            cap += remaining[0].cap
            take.append(remaining.pop(0))
        if not take:
            continue
        path.append(v)
        partition.append(take)
    if remaining:
        return None
    return Pipeline(path, partition, path_time(path, partition, cp))


def greedy_matching(vehicles: Sequence[Vehicle], units: Sequence[Unit],
                    cp: CostParams) -> Optional[Pipeline]:
    """The baseline: memory-greedy in arrival order (single-resource
    optimization, no stability/time awareness)."""
    remaining = list(units)
    path, partition = [], []
    for v in vehicles:
        if not remaining:
            break
        take, cap = [], 0.0
        while remaining and cap + remaining[0].cap <= v.mem:
            cap += remaining[0].cap
            take.append(remaining.pop(0))
        if take:
            path.append(v)
            partition.append(take)
    if remaining:
        return None
    return Pipeline(path, partition, path_time(path, partition, cp))


# --------------------------------------------------------------------------
# Phase 2: DQN pipeline generation
# --------------------------------------------------------------------------
class PipelineEnv:
    """Episode: build one pipeline for a cluster.

    Action a = vehicle_idx * len(CHUNK_OPTIONS) + chunk_idx assigns the
    next CHUNK_OPTIONS[chunk_idx] units (clipped to remaining) to that
    vehicle as the next stage. State = Eq. 11's five components flattened:
    remaining capacity, per-vehicle (used, mem-ratio, t_cmp, t_com), and
    the partial path encoding.
    """

    def __init__(self, vehicles: Sequence[Vehicle], units: Sequence[Unit],
                 cp: CostParams, head: Optional[int] = None,
                 w=(1.0, 0.5, 0.25, 0.25)):
        self.vehicles = list(vehicles)[:N_MAX]
        if head is not None and not 0 <= head < len(self.vehicles):
            raise ValueError(
                f"head index {head} outside the fleet window of "
                f"{len(self.vehicles)} vehicles (fleets larger than "
                f"N_MAX={N_MAX} must be windowed first; see window_fleet)")
        self.units = list(units)
        self.cp = cp
        self.head = head
        self.w = w
        total_cap = sum(u.cap for u in units) or 1.0
        total_cmp = sum(u.cmp for u in units) or 1.0
        self.cap_norm = total_cap
        self.cmp_norm = total_cmp
        self.n_actions = N_MAX * len(CHUNK_OPTIONS)
        self.obs_dim = 2 + N_MAX * 5
        self.reset()

    def reset(self):
        self.next_unit = 0
        self.used = [False] * len(self.vehicles)
        self.path: List[Vehicle] = []
        self.partition: List[List[Unit]] = []
        self.done = False
        if self.head is not None:
            self._assign(self.head, self._max_units(self.head, cap_only=True,
                                                    limit=CHUNK_OPTIONS[-1]))
        return self.obs(), self.mask()

    def _max_units(self, vi, cap_only=False, limit=10 ** 9):
        v = self.vehicles[vi]
        cap, cnt = 0.0, 0
        for u in self.units[self.next_unit:]:
            if cap + u.cap > v.mem or cnt >= limit:
                break
            cap += u.cap
            cnt += 1
        return cnt

    def _assign(self, vi, count):
        count = min(count, len(self.units) - self.next_unit)
        take = self.units[self.next_unit:self.next_unit + count]
        self.next_unit += count
        self.used[vi] = True
        self.path.append(self.vehicles[vi])
        self.partition.append(take)

    def obs(self) -> np.ndarray:
        rem_cap = sum(u.cap for u in self.units[self.next_unit:]) \
            / self.cap_norm
        rem_cmp = sum(u.cmp for u in self.units[self.next_unit:]) \
            / self.cmp_norm
        feats = [rem_cap, rem_cmp]
        for i in range(N_MAX):
            if i < len(self.vehicles):
                v = self.vehicles[i]
                assigned = sum(u.cap for p, u_ in zip(self.path,
                                                      self.partition)
                               if p.vid == v.vid for u in u_) \
                    if self.used[i] else 0.0
                feats += [1.0 if self.used[i] else 0.0,
                          min(assigned / max(v.mem, 1.0), 1.0),
                          v.cmp * 1e-12, v.com * 1e-9, v.stb]
            else:
                feats += [1.0, 0.0, 0.0, 0.0, 0.0]
        return np.asarray(feats, np.float32)

    def mask(self) -> np.ndarray:
        m = np.zeros(self.n_actions, np.float32)
        if self.done or self.next_unit >= len(self.units):
            return m
        for i, v in enumerate(self.vehicles):
            if self.used[i]:
                continue
            mx = self._max_units(i)
            for j, c in enumerate(CHUNK_OPTIONS):
                if min(c, len(self.units) - self.next_unit) <= mx and mx > 0:
                    m[i * len(CHUNK_OPTIONS) + j] = 1.0
        return m

    def step(self, action: int):
        vi, ci = divmod(action, len(CHUNK_OPTIONS))
        if vi >= len(self.vehicles):
            # slot beyond the (possibly truncated) fleet: invalid action,
            # penalized like any other instead of indexing out of range
            self.done = True
            return self.obs(), self.mask(), -5.0, True
        count = CHUNK_OPTIONS[ci]
        v = self.vehicles[vi]
        count = min(count, len(self.units) - self.next_unit)
        take = self.units[self.next_unit:self.next_unit + count]
        cap = sum(u.cap for u in take)
        valid = (not self.used[vi]) and cap <= v.mem and count > 0
        w1, w2, w3, w4 = self.w
        if not valid:
            self.done = True
            return self.obs(), self.mask(), -5.0, True
        tc = sum(u.cmp for u in take) * self.cp.n_batch * self.cp.nu \
            / (v.cmp * self.cp.mu)
        tm = 2 * take[-1].com * self.cp.n_batch * self.cp.nu / v.com
        r = w1 * (-(tc + tm)) + w2 * 1.0 + w3 * 1.0 + w4 * 1.0   # Eq. 12
        self._assign(vi, count)
        finished = self.next_unit >= len(self.units)
        stuck = not finished and not self.mask().any()
        if finished:
            r -= path_time(self.path, self.partition, self.cp)   # terminal
        if stuck:
            r -= 5.0
        self.done = finished or stuck
        return self.obs(), self.mask(), r, self.done

    def result(self) -> Optional[Pipeline]:
        if self.next_unit < len(self.units):
            return None
        return Pipeline(self.path, self.partition,
                        path_time(self.path, self.partition, self.cp))


def train_policy(cluster_sampler, *, episodes: int = 800, seed: int = 0,
                 cp: Optional[CostParams] = None,
                 device="cuda") -> DoubleDQN:
    """Train the phase-2 policy on clusters drawn from ``cluster_sampler()``
    -> (vehicles, units); the Q-net lives on ``device``."""
    cp = cp or CostParams()
    probe = PipelineEnv(*cluster_sampler(), cp)
    agent = DoubleDQN(DQNConfig(obs_dim=probe.obs_dim,
                                n_actions=probe.n_actions), seed=seed,
                      device=device)
    for _ in range(episodes):
        vehicles, units = cluster_sampler()
        env = PipelineEnv(vehicles, units, cp)
        obs, mask = env.reset()
        while not env.done:
            a = agent.act(obs, mask)
            nxt, nmask, r, done = env.step(a)
            agent.record(obs, a, r, nxt, nmask, float(done))
            agent.learn()
            obs, mask = nxt, nmask
    return agent


def window_fleet(vehicles: Sequence[Vehicle], head_idx: int,
                 n_max: int = N_MAX) -> Tuple[List[Vehicle], int]:
    """Contiguous window of at most ``n_max`` vehicles containing
    ``head_idx``. Returns ``(window, head_in_window)`` with
    ``window[head_in_window] is vehicles[head_idx]`` — the policy sees a
    fleet it supports while the intended head vehicle stays the head
    (clamping the index instead would pin the WRONG vehicle as head)."""
    vehicles = list(vehicles)
    if not 0 <= head_idx < len(vehicles):
        raise ValueError(f"head_idx {head_idx} out of range "
                         f"for fleet of {len(vehicles)}")
    if len(vehicles) <= n_max:
        return vehicles, head_idx
    start = min(max(0, head_idx - n_max // 2), len(vehicles) - n_max)
    return vehicles[start:start + n_max], head_idx - start


def dqn_pipeline(agent: DoubleDQN, vehicles: Sequence[Vehicle],
                 units: Sequence[Unit], cp: CostParams,
                 head: Optional[int] = None) -> Optional[Pipeline]:
    env = PipelineEnv(vehicles, units, cp, head=head)
    obs, mask = env.reset()
    while not env.done and mask.any():
        a = agent.act(obs, mask, explore=False)
        obs, mask, _, _ = env.step(a)
    return env.result()


# --------------------------------------------------------------------------
# SWIFT: the two-phase scheduler
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SwiftResult:
    initial: Optional[Pipeline]          # phase-1 quick-start pipeline
    essential: Dict[int, Pipeline]       # head vehicle id -> pipeline
    phase1_s: float
    phase2_s: float


def swift(vehicles: Sequence[Vehicle], units: Sequence[Unit], *,
          agent: Optional[DoubleDQN] = None,
          cp: Optional[CostParams] = None) -> SwiftResult:
    """Two-phase SWIFT. Phase 1 returns immediately usable pipelines;
    phase 2 builds the essential pipeline set (one per head vehicle,
    ascending stability) with the DQN, falling back to phase-1 greedy
    when the learned policy dead-ends (the paper's refinement loop)."""
    cp = cp or CostParams()
    t0 = time.perf_counter()
    initial = phase1_greedy(vehicles, units, cp)
    t1 = time.perf_counter()

    essential: Dict[int, Pipeline] = {}
    if initial is not None:
        head0 = initial.path[0].vid
        essential[head0] = initial
    rest = sorted([v for v in vehicles
                   if initial is None or v.vid != initial.path[0].vid],
                  key=lambda v: v.stb)       # ascending stability
    for v in rest:
        pipe = None
        if agent is not None:
            idx = next(i for i, w in enumerate(vehicles) if w.vid == v.vid)
            win, head = window_fleet(vehicles, idx)
            pipe = dqn_pipeline(agent, win, units, cp, head=head)
        if pipe is None:
            reordered = [v] + [w for w in sorted(vehicles,
                                                 key=lambda x: -x.stb)
                               if w.vid != v.vid]
            pipe = phase1_greedy_ordered(reordered, units, cp)
        if pipe is not None:
            essential[v.vid] = pipe
    t2 = time.perf_counter()
    return SwiftResult(initial, essential, t1 - t0, t2 - t1)


def phase1_greedy_ordered(order: Sequence[Vehicle], units: Sequence[Unit],
                          cp: CostParams) -> Optional[Pipeline]:
    remaining = list(units)
    path, partition = [], []
    for v in order:
        if not remaining:
            break
        take, cap = [], 0.0
        while remaining and cap + remaining[0].cap <= v.mem:
            cap += remaining[0].cap
            take.append(remaining.pop(0))
        if take:
            path.append(v)
            partition.append(take)
    if remaining:
        return None
    return Pipeline(path, partition, path_time(path, partition, cp))


def units_to_layer_template(pipe: Pipeline, stages: int) -> Tuple[int, ...]:
    """Map a SWIFT pipeline (unit counts per stage) onto a fixed-width SPMD
    stage template for core/pipeline.py.

    Pipelines shorter than ``stages`` pad with zero-layer stages. Pipelines
    LONGER than the SPMD width fold the overflow stages' units into the
    last SPMD stage — checked against that stage's vehicle memory — so no
    model unit is ever silently dropped (``sum(template) == len(units)``
    always holds).
    """
    counts = list(pipe.template())
    if len(counts) > stages:
        tail = [u for part in pipe.partition[stages - 1:] for u in part]
        host = pipe.path[stages - 1]
        need = sum(u.cap for u in tail)
        if need > host.mem:
            raise ValueError(
                f"cannot fold a {len(counts)}-stage pipeline into {stages} "
                f"SPMD stages: the folded tail needs {need:.3e} B but the "
                f"stage-{stages - 1} vehicle {host.vid} has {host.mem:.3e} B")
        counts = counts[:stages - 1] + [len(tail)]
    counts = counts + [0] * (stages - len(counts))
    return tuple(counts)
