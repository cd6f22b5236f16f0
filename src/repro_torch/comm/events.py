"""Discrete-event engine for asynchronous vehicle-edge-cloud FL (port of
``repro/comm/events.py``).

The synchronous ``hier_fl`` round runs every vehicle, pod and the cloud
in lockstep. This module inverts that control flow: a priority queue of
timestamped events drives the fabric.

  ``LocalStepDone``    a vehicle finished its local steps (compute-time
                       model over ``Vehicle.cmp``, optional jitter)
  ``UplinkArrived``    its coded update crossed the V2X link
                       (:func:`repro_torch.sched.costmodel.t_uplink`)
  ``BackhaulArrived``  an edge pod's partial aggregate crossed the metro
                       backhaul to the cloud
  ``CloudDeadline``    the cloud's merge clock ticked: merge whatever
                       commits arrived, with **observed** staleness lags,
                       and re-broadcast to idle vehicles
  ``PodMigration``     a vehicle moved between edge pods
                       (:meth:`repro_torch.comm.topology.Topology
                       .reassign`), driven by DTMC trajectories from
                       :mod:`repro_torch.sched.mobility`

Edges commit partial aggregates (:func:`repro_torch.comm.hierarchy
.edge_commit`) whenever their members arrive — without waiting for
stragglers when a merge clock is set — and the cloud merges commits at
deadlines (:func:`repro_torch.comm.hierarchy.cloud_merge_at`), feeding
the observed arrival lags into ``staleness_weights``.

The schedule is numpy and standard-library arithmetic only, the
reference's to the bit: the same topology, codec, compute model, clock
and seed give the reference's event log, and with a tracer its trace,
byte for byte. With ``clock=None`` (the infinite deadline), zero jitter
and no migrations the engine IS the synchronous round: the cloud merges
exactly when every vehicle's update has arrived, and the merged params
are bitwise those of ``make_hier_round`` (the ``async_hier_fl``
strategy's sync-equivalence guarantee).

Where the reference runs every wave over the whole client stack and
masks the non-members out afterwards (for fixed jit shapes), the port
trains only a wave's members, one after another, and writes their rows
in place: the same rows come out, with member ``c`` of wave ``w`` taking
the codec bits ``bits_fn(w)(leaf, c, shape)``. A wave's compute is
``len(members)`` local trainings and ``leaves x len(members)`` codec
roundtrips, which :attr:`AsyncHierFLEngine.wave_members` records.

Event ordering ties break by ``(timestamp, sequence-id)``: replaying a
seed reproduces the event log and the final params.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, ClassVar, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comm.topology import Topology
from repro_torch.sched.costmodel import t_uplink
from repro_torch.sched.mobility import GridWorld, make_patterns

# ---- events ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalStepDone:
    t: float
    vehicle: int
    kind: ClassVar[str] = "local_step_done"


@dataclasses.dataclass(frozen=True)
class UplinkArrived:
    t: float
    vehicle: int
    nbytes: int
    kind: ClassVar[str] = "uplink_arrived"


@dataclasses.dataclass(frozen=True)
class BackhaulArrived:
    t: float
    edge: int
    commit_id: int
    kind: ClassVar[str] = "backhaul_arrived"


@dataclasses.dataclass(frozen=True)
class CloudDeadline:
    t: float
    index: int
    kind: ClassVar[str] = "cloud_deadline"


@dataclasses.dataclass(frozen=True)
class PodMigration:
    t: float
    vehicle: int
    src: int
    dst: int
    kind: ClassVar[str] = "pod_migration"


@dataclasses.dataclass(frozen=True)
class MobilityTick:
    t: float
    index: int
    kind: ClassVar[str] = "mobility_tick"


@dataclasses.dataclass(frozen=True)
class EdgeFlush:
    t: float
    edge: int
    gen: int
    kind: ClassVar[str] = "edge_flush"


def _log_entry(ev) -> Tuple:
    d = dataclasses.asdict(ev)
    t = d.pop("t")
    return (ev.kind, t) + tuple(v for _, v in sorted(d.items()))


class EventQueue:
    """Min-heap of events keyed ``(timestamp, sequence-id)`` — identical
    timestamps pop in push order, so runs replay identically across
    platforms (heapq never compares the event payloads themselves)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0

    def push(self, ev) -> None:
        heapq.heappush(self._heap, (ev.t, self._seq, ev))
        self._seq += 1

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek_t(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def __len__(self) -> int:
        return len(self._heap)


# ---- timing models --------------------------------------------------------


@dataclasses.dataclass
class ComputeModel:
    """Per-vehicle local-round compute time: ``flops`` of one local round
    (all local steps) at the vehicle's effective throughput ``cmp * mu``
    (paper Eq. 8's utilization), times a multiplicative jitter drawn
    uniformly from ``[1, 1 + jitter]`` per (vehicle, round)."""

    flops: float
    mu: float = 0.5
    jitter: float = 0.0

    def time_s(self, vehicle, rng) -> float:
        t = self.flops / (vehicle.cmp * self.mu)
        if self.jitter > 0.0:
            t *= 1.0 + float(rng.uniform(0.0, self.jitter))
        return t


def default_compute_flops(cfg, shape, local_steps: int = 1) -> float:
    """fwd+bwd FLOPs of one local round: 6 * active params * tokens."""
    tokens = shape.global_batch * shape.seq_len * max(local_steps, 1)
    return 6.0 * cfg.active_param_count() * tokens


# ---- mobility -> migration events ----------------------------------------


@dataclasses.dataclass(frozen=True)
class MobilitySpec:
    """DTMC mobility driving ``PodMigration`` events: vehicles random-walk
    a ``size x size`` grid under :func:`repro_torch.sched.mobility
    .make_patterns` patterns; a vehicle migrates to the nearest edge pod
    when it leaves the ``radius``-cell comm range of its current pod's
    home cell."""

    size: int = 6
    n_patterns: int = 3
    radius: int = 2
    persistence: float = 0.55
    seed: int = 0


class FleetMobility:
    """Live mobility state: one cell + pattern per vehicle, one home cell
    per edge pod (spread along the grid diagonal)."""

    def __init__(self, spec: MobilitySpec, topology: Topology):
        self.spec = spec
        self.world: GridWorld = make_patterns(
            spec.size, spec.n_patterns, seed=spec.seed,
            persistence=spec.persistence)
        E, C = topology.n_edges, topology.n_clients
        coords = (np.round(np.linspace(0, spec.size - 1, E)).astype(int)
                  if E > 1 else np.array([spec.size // 2]))
        self.edge_cells = coords * spec.size + coords
        self.patterns = np.arange(C) % spec.n_patterns
        self.cells = self.edge_cells[topology.client_edge].copy()
        self.histories: List[List[int]] = [[int(c)] for c in self.cells]

    def advance(self, vehicle: int, rng) -> int:
        c = int(rng.choice(self.world.n_cells,
                           p=self.world.patterns[self.patterns[vehicle],
                                                 self.cells[vehicle]]))
        self.cells[vehicle] = c
        self.histories[vehicle].append(c)
        return c

    def out_of_range(self, vehicle: int, edge: int) -> bool:
        return int(self.world.cell_dist(
            self.cells[vehicle], self.edge_cells[edge])) > self.spec.radius

    def nearest_edge(self, vehicle: int) -> int:
        d = self.world.cell_dist(self.cells[vehicle], self.edge_cells)
        return int(np.argmin(d))        # ties -> lowest edge index


def time_to_migration(world: GridWorld, traj, speed: float,
                      radius: int) -> float:
    """Seconds until ``traj`` leaves the ``radius``-cell comm range of its
    start cell, on the dwell-data timescale of
    :func:`repro_torch.sched.dwell.synthetic_dwell_data` (2.0 s per newly
    entered cell at unit speed); capped at the route end."""
    start = int(traj[0])
    visited = {start}
    for c in traj[1:]:
        visited.add(int(c))
        if int(world.cell_dist(start, int(c))) > radius:
            break
    return len(visited) * 2.0 / speed


# ---- the compute program --------------------------------------------------


class HierFLProgram:
    """The compute pieces of the async fabric — the algebra of
    ``make_hier_round`` split at the event boundaries: one vehicle's local
    steps, its delta from its base broadcast, the codec roundtrip with
    error feedback over a wave's member stack, per-pod ``edge_commit``
    and clocked ``cloud_merge_at``. Composed in the synchronous schedule
    they give the fused round's params bit for bit."""

    def __init__(self, cfg, shape, optimizer, codec, *, remat: bool = False):
        from repro_torch.comm.hierarchy import cloud_merge_at, edge_commit
        from repro_torch.core.fedavg import make_local_train
        from repro_torch.core.steps import make_train_step

        self.codec = codec
        self.local_train = make_local_train(
            make_train_step(cfg, shape, optimizer, remat=remat))
        self.commit = edge_commit
        self.merge = cloud_merge_at

    @staticmethod
    def delta(params, base):
        from repro_torch.tree import tree_map
        return tree_map(lambda a, g: a.float() - g, params, base)

    def roundtrip(self, deltas, residual, bits):
        from repro_torch.comm.codecs import roundtrip_stacked
        return roundtrip_stacked(self.codec, deltas, residual, bits)


@dataclasses.dataclass
class _Commit:
    partial: object               # float32 partial-average tree (or None)
    weight: object                # scalar total member weight
    vehicles: Tuple[int, ...]
    base_version: int
    base_time: float
    nbytes: int
    edge: int
    t_commit: float
    t_arrive: float = math.nan


@dataclasses.dataclass
class _Buffered:
    vehicle: int
    delta: object
    weight: float
    base_version: int
    base_time: float


def _rows(stacked, idx):
    """Rows ``idx`` of a client-stacked tree, as a stacked tree."""
    import torch

    from repro_torch.tree import tree_map
    return tree_map(lambda x: x[torch.as_tensor(idx, device=x.device)],
                    stacked)


# ---- the engine -----------------------------------------------------------


class AsyncHierFLEngine:
    """Event-time engine of one asynchronous hierarchical-FL fabric.

    ``clock``: cloud merge period in simulated seconds; ``None`` means
    the infinite deadline — the cloud merges exactly when every
    vehicle's update has arrived (the synchronous special case).
    ``program=None`` runs the schedule timing-only (no tensors).
    ``bits_fn(wave) -> bits source`` gives the codec's random words of a
    wave (``(leaf, client, shape) -> uint32 tensor``); None draws them
    from a :class:`repro_torch.comm.codecs.GeneratorBits` seeded with
    ``seed`` on the params' device.

    The engine treats :class:`Topology` as mutable over time: every
    ``PodMigration`` swaps ``self.topo`` for ``topo.reassign(vehicle,
    edge)``, so ``client_edge`` / ``member_indices`` always describe the
    live assignment.
    """

    def __init__(self, topology: Topology, bytes_per_client: int,
                 edge_nbytes_fn: Callable[[int], int], *,
                 program: Optional[HierFLProgram] = None,
                 compute: Optional[ComputeModel] = None,
                 client_weights: Optional[np.ndarray] = None,
                 clock: Optional[float] = None, decay: float = 0.5,
                 flush_every: Optional[float] = None,
                 mobility: Optional[MobilitySpec] = None,
                 migrate_every: Optional[float] = None,
                 seed: int = 0,
                 bits_fn: Optional[Callable] = None,
                 tracer=None, metrics=None):
        if clock is not None and clock <= 0:
            raise ValueError(f"clock must be positive or None, got {clock}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.topo0 = topology
        self.bytes_per_client = int(bytes_per_client)
        self.edge_nbytes_fn = edge_nbytes_fn
        self.program = program
        self.compute = compute or ComputeModel(flops=1e9)
        self.client_w = (np.ones(topology.n_clients, np.float32)
                         if client_weights is None
                         else np.asarray(client_weights, np.float32))
        if self.client_w.shape != (topology.n_clients,):
            raise ValueError(
                f"client_weights has shape {self.client_w.shape}, expected "
                f"({topology.n_clients},)")
        topology.validate_pod_weights(self.client_w)
        self.clock = clock
        self.decay = decay
        self.flush_every = flush_every if flush_every is not None else clock
        self.mobility_spec = mobility
        self.migrate_every = migrate_every
        self.seed = seed
        self.bits_fn = bits_fn
        self.topo = topology
        self.version = 0
        #: optional :class:`repro_torch.obs.Tracer` — sim-time spans on
        #: one track per vehicle/edge/cloud. None (the default) means no
        #: callback fires: event log, params and metrics are bitwise
        #: those of an untraced run.
        self.tracer = tracer
        #: optional :class:`repro_torch.obs.MetricsRegistry` the engine
        #: publishes wire bytes / observed staleness / migrations into
        self.metrics = metrics

    # ---- lifecycle -----------------------------------------------------
    def reset(self, client_params=None, client_opt=None,
              round_batches_fn=None) -> None:
        """Start a run from client-stacked params and Adam state (copied:
        the engine updates its own rows in place and leaves the caller's
        state as it was)."""
        C = self.topo0.n_clients
        self.C = C
        self.topo = self.topo0
        self.now = 0.0
        self.queue = EventQueue()
        self.rng = np.random.default_rng(self.seed)
        self.event_log: List[Tuple] = []
        self.version = 0
        self.n_migrations = 0
        self.state = ["idle"] * C
        self._wave_open: set = set()
        self.wave_count = 0
        #: the members each wave trained, in wave order
        self.wave_members: List[Tuple[int, ...]] = []
        self._delta: List = [None] * C
        self.last_metrics: Dict[str, np.ndarray] = {}
        self.base_version = np.zeros(C, np.int64)
        self.base_time = np.zeros(C, np.float64)
        self.edge_buffers: List[List[_Buffered]] = \
            [[] for _ in range(self.topo0.n_edges)]
        self.flush_gen = [0] * self.topo0.n_edges
        self.commits: Dict[int, _Commit] = {}
        self._next_commit = 0
        self.cloud_buffer: List[int] = []
        self.bytes_up = 0
        self.bytes_backhaul = 0
        self._bytes_up_mark = 0
        self._bytes_backhaul_mark = 0
        self._batches_fn = round_batches_fn
        self.mobility = (FleetMobility(self.mobility_spec, self.topo0)
                         if self.mobility_spec is not None else None)
        self._uplink_t0 = np.zeros(C, np.float64)   # LocalStepDone times
        self._uplink_t1 = np.zeros(C, np.float64)   # UplinkArrived times
        if self.tracer is not None:
            self._declare_tracks()
        if self.program is not None:
            from repro_torch.comm.codecs import GeneratorBits, zero_residual
            from repro_torch.train.optimizer import AdamState
            from repro_torch.tree import leaves, tree_map
            if client_params is None:
                raise ValueError("a compute program needs client params")
            self.client_params = tree_map(lambda x: x.clone(),
                                          client_params)
            self.client_opt = AdamState(
                client_opt.step.clone(),
                tree_map(lambda x: x.clone(), client_opt.m),
                tree_map(lambda x: x.clone(), client_opt.v))
            self.residual = zero_residual(client_params)
            self.global_params = tree_map(lambda x: x[0].clone(),
                                          client_params)
            #: each vehicle's base: the global params it was broadcast
            self.base_params: List = [self.global_params] * C
            if self.bits_fn is None:
                gen = GeneratorBits(self.seed,
                                    leaves(client_params)[0].device)
                self.bits_fn = lambda wave: gen
        else:
            self.client_params = client_params
            self.client_opt = client_opt
            self.global_params = None
        self._broadcast(range(C), 0.0)
        if self.clock is not None:
            self.queue.push(CloudDeadline(self.clock, 1))
        if self.mobility is not None and self.migrate_every is not None:
            self.queue.push(MobilityTick(self.migrate_every, 1))

    # ---- tracing (repro_torch.obs) -------------------------------------
    def _declare_tracks(self) -> None:
        from repro_torch.obs import trace as T
        tr = self.tracer
        tr.process(T.FL_PID, "fl-fabric", sort_index=1)
        tr.track(T.FL_PID, T.CLOUD_TID, "cloud")
        for e in range(self.topo0.n_edges):
            tr.track(T.FL_PID, T.edge_tid(e), f"edge {e}")
        for i, v in enumerate(self.topo0.vehicles):
            tr.track(T.FL_PID, T.vehicle_tid(i),
                     f"vehicle {i} (vid {v.vid})")

    # ---- event dispatch ------------------------------------------------
    def handle(self, ev) -> Optional[Dict]:
        """Process one event; returns the merge record when the event
        closed a cloud round, else None."""
        self.now = ev.t
        self.event_log.append(_log_entry(ev))
        if isinstance(ev, LocalStepDone):
            return self._on_local_done(ev)
        if isinstance(ev, UplinkArrived):
            return self._on_uplink(ev)
        if isinstance(ev, BackhaulArrived):
            return self._on_backhaul(ev)
        if isinstance(ev, CloudDeadline):
            return self._on_deadline(ev)
        if isinstance(ev, EdgeFlush):
            return self._on_flush(ev)
        if isinstance(ev, MobilityTick):
            return self._on_mobility(ev)
        if isinstance(ev, PodMigration):
            return self._on_migration(ev)
        raise TypeError(f"unknown event {ev!r}")

    # ---- vehicle lifecycle ---------------------------------------------
    def _broadcast(self, vehicles, t: float) -> None:
        ids = [i for i in vehicles if self.state[i] == "idle"]
        if not ids:
            return
        if self.program is not None:
            from repro_torch.tree import tree_map
            for i in ids:
                tree_map(lambda x, g, _i=i: x[_i].copy_(g),
                         self.client_params, self.global_params)
                self.base_params[i] = self.global_params
        for i in ids:
            self.base_version[i] = self.version
            self.base_time[i] = t
            self.state[i] = "computing"
            self._wave_open.add(i)
            dt = self.compute.time_s(self.topo.vehicles[i], self.rng)
            self.queue.push(LocalStepDone(t + dt, i))

    def _run_wave(self) -> None:
        members = sorted(self._wave_open)
        self._wave_open.clear()
        w = self.wave_count
        self.wave_count += 1
        self.wave_members.append(tuple(members))
        if self.program is None:
            return
        import torch

        from repro_torch.core.fedavg import _write, client_slice
        from repro_torch.tree import tree_map
        batches = self._batches_fn(w)
        deltas = []
        for i in members:
            params, opt, metrics = self.program.local_train(
                client_slice(self.client_params, i),
                client_slice(self.client_opt, i),
                client_slice(batches, i))
            deltas.append(self.program.delta(params,
                                             self.base_params[i]))
            _write(self.client_params, i, self.C, params)
            _write(self.client_opt, i, self.C, opt)
            del params, opt
            for k, v in metrics.items():
                buf = self.last_metrics.setdefault(
                    k, np.full((self.C,), np.nan, np.float64))
                buf[i] = float(v)
        stacked = tree_map(lambda *xs: torch.stack(xs), *deltas)
        del deltas
        bits = self.bits_fn(w)
        decoded, new_res = self.program.roundtrip(
            stacked, _rows(self.residual, members),
            lambda leaf, j, shape: bits(leaf, members[j], shape))
        del stacked
        for j, i in enumerate(members):
            tree_map(lambda r, n, _j=j, _i=i: r[_i].copy_(n[_j]),
                     self.residual, new_res)
            self._delta[i] = tree_map(lambda x, _j=j: x[_j].clone(),
                                      decoded)

    def _on_local_done(self, ev: LocalStepDone) -> None:
        i = ev.vehicle
        if i in self._wave_open:
            self._run_wave()
        self.state[i] = "uplink"
        self._uplink_t0[i] = ev.t
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            from repro_torch.obs.profile import kernel_cost_args
            self.tracer.complete(
                "compute", float(self.base_time[i]), ev.t,
                pid=T.FL_PID, tid=T.vehicle_tid(i), cat="compute",
                args=dict(kernel_cost_args(flops=self.compute.flops),
                          vehicle=i,
                          base_version=int(self.base_version[i])))
        dt = t_uplink(self.bytes_per_client, self.topo.vehicles[i])
        self.queue.push(UplinkArrived(ev.t + dt, i, self.bytes_per_client))
        return None

    # ---- edge tier ------------------------------------------------------
    def _on_uplink(self, ev: UplinkArrived) -> None:
        i = ev.vehicle
        self.bytes_up += ev.nbytes
        self.state[i] = "idle"
        e = int(self.topo.client_edge[i])
        if any(b.vehicle == i for b in self.edge_buffers[e]):
            # a fast vehicle lapped the pod's flush timer: forward the
            # current partial first so one commit never carries the same
            # member twice (which would double its aggregation weight)
            self._commit(e, ev.t)
        self._uplink_t1[i] = ev.t
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            self.tracer.complete(
                "uplink", float(self._uplink_t0[i]), ev.t,
                pid=T.FL_PID, tid=T.vehicle_tid(i), cat="comm",
                args={"vehicle": i, "edge": e, "nbytes": ev.nbytes})
        if self.metrics is not None:
            self.metrics.counter(
                "fl_uplink_bytes",
                "coded V2X uplink bytes per edge pod").inc(ev.nbytes, edge=e)
        self.edge_buffers[e].append(_Buffered(
            i, self._delta[i], float(self.client_w[i]),
            int(self.base_version[i]), float(self.base_time[i])))
        self._delta[i] = None
        return self._edge_check(e, ev.t)

    def _edge_check(self, e: int, t: float) -> None:
        """Commit when every current member has arrived; otherwise (async
        only) arm the flush timer so stragglers cannot gate the pod."""
        buf = self.edge_buffers[e]
        if not buf:
            return None
        have = {b.vehicle for b in buf}
        if set(self.topo.edges[e]).issubset(have):
            self._commit(e, t)
        elif self.flush_every is not None and len(buf) == 1:
            self.flush_gen[e] += 1
            self.queue.push(EdgeFlush(t + self.flush_every, e,
                                      self.flush_gen[e]))
        return None

    def _on_flush(self, ev: EdgeFlush) -> None:
        if ev.gen == self.flush_gen[ev.edge] and \
                self.edge_buffers[ev.edge]:
            self._commit(ev.edge, ev.t)
        return None

    def _commit(self, e: int, t: float) -> None:
        entries = self.edge_buffers[e]
        self.edge_buffers[e] = []
        self.flush_gen[e] += 1          # invalidate any armed flush
        if len({b.vehicle for b in entries}) != len(entries):
            raise RuntimeError(
                f"edge pod {e} commit carries a duplicate member — the "
                f"weighted-mean invariant would break: {entries}")
        pos = {v: k for k, v in enumerate(self.topo.edges[e])}
        entries.sort(key=lambda b: pos.get(b.vehicle, self.C + b.vehicle))
        partial, weight = None, float(sum(b.weight for b in entries))
        if self.program is not None:
            import torch

            from repro_torch.tree import leaves, tree_map
            stacked = tree_map(lambda *xs: torch.stack(xs),
                               *[b.delta for b in entries])
            w_m = torch.tensor([b.weight for b in entries],
                               dtype=torch.float32,
                               device=leaves(stacked)[0].device)
            partial, weight = self.program.commit(stacked, w_m)
            del stacked
        nbytes = int(self.edge_nbytes_fn(len(entries)))
        cid = self._next_commit
        self._next_commit += 1
        self.commits[cid] = _Commit(
            partial, weight, tuple(b.vehicle for b in entries),
            min(b.base_version for b in entries),
            min(b.base_time for b in entries), nbytes, e, t)
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            for b in entries:
                # arrow from each member's uplink-span end into the
                # backhaul span that starts at the commit time
                self.tracer.flow(
                    "uplink->commit", float(self._uplink_t1[b.vehicle]),
                    T.FL_PID, T.vehicle_tid(b.vehicle),
                    t, T.FL_PID, T.edge_tid(e))
        dt = nbytes / self.topo.backhaul_bw + self.topo.backhaul_latency
        self.queue.push(BackhaulArrived(t + dt, e, cid))

    # ---- cloud tier -----------------------------------------------------
    def _on_backhaul(self, ev: BackhaulArrived) -> Optional[Dict]:
        c = self.commits[ev.commit_id]
        c.t_arrive = ev.t
        self.bytes_backhaul += c.nbytes
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            self.tracer.complete(
                "backhaul", float(c.t_commit), ev.t,
                pid=T.FL_PID, tid=T.edge_tid(c.edge), cat="comm",
                args={"edge": c.edge, "commit": ev.commit_id,
                      "nbytes": c.nbytes, "n_vehicles": len(c.vehicles),
                      "base_version": int(c.base_version)})
        if self.metrics is not None:
            self.metrics.counter(
                "fl_backhaul_bytes",
                "partial-aggregate backhaul bytes per edge pod").inc(
                    c.nbytes, edge=c.edge)
        self.cloud_buffer.append(ev.commit_id)
        if self.clock is None:
            covered = sum(len(self.commits[i].vehicles)
                          for i in self.cloud_buffer)
            if covered == self.C:       # the synchronous barrier
                return self._merge(ev.t)
        return None

    def _on_deadline(self, ev: CloudDeadline) -> Optional[Dict]:
        self.queue.push(CloudDeadline(ev.t + self.clock, ev.index + 1))
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            self.tracer.instant(
                "cloud_deadline", ev.t, pid=T.FL_PID, tid=T.CLOUD_TID,
                cat="clock", args={"index": ev.index,
                                   "pending": len(self.cloud_buffer)})
        if self.cloud_buffer:
            return self._merge(ev.t)
        self._broadcast(range(self.C), ev.t)    # restart idle vehicles
        return None

    def _merge(self, t: float) -> Dict:
        ids = sorted(self.cloud_buffer,
                     key=lambda i: (self.commits[i].edge, i))
        self.cloud_buffer = []
        commits = [self.commits.pop(i) for i in ids]
        from repro_torch.comm.hierarchy import staleness_weights
        if self.clock is None:
            stale = np.ones(len(commits), np.float32)
            lags = np.zeros(len(commits))
        else:
            observed = np.array([c.t_arrive - c.base_time
                                 for c in commits])
            stale = staleness_weights(observed, self.clock,
                                      decay=self.decay)
            lags = np.maximum(0.0, np.ceil(observed / self.clock) - 1.0)
        if self.program is not None:
            self.global_params = self.program.merge(
                self.global_params,
                tuple(c.partial for c in commits),
                tuple(c.weight for c in commits), stale)
        self.version += 1
        covered = sum(len(c.vehicles) for c in commits)
        metrics: Dict = {
            "t_sim": float(t),
            "round_version": float(self.version),
            "n_commits": float(len(commits)),
            "n_vehicles": float(covered),
            "staleness_min": float(stale.min()),
            "staleness_mean": float(stale.mean()),
            "lag_max": float(lags.max()),
            "comm_bytes_up": float(self.bytes_up - self._bytes_up_mark),
            "comm_bytes_backhaul": float(
                self.bytes_backhaul - self._bytes_backhaul_mark),
        }
        self._bytes_up_mark = self.bytes_up
        self._bytes_backhaul_mark = self.bytes_backhaul
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            self.tracer.complete(
                "merge", t, t, pid=T.FL_PID, tid=T.CLOUD_TID, cat="merge",
                args={"version": self.version, "n_commits": len(commits),
                      "n_vehicles": covered,
                      "staleness_mean": float(stale.mean()),
                      "lag_max": float(lags.max())})
            for c in commits:
                # arrow from each backhaul-span end into the merge mark
                self.tracer.flow("commit->merge", float(c.t_arrive),
                                 T.FL_PID, T.edge_tid(c.edge),
                                 t, T.FL_PID, T.CLOUD_TID)
            self.tracer.counter(
                "wire bytes", t,
                {"uplink": self.bytes_up, "backhaul": self.bytes_backhaul},
                pid=T.FL_PID)
        if self.metrics is not None:
            self.metrics.counter("fl_merges", "cloud merges").inc()
            h = self.metrics.histogram(
                "fl_observed_staleness_s",
                "commit arrival lag behind its base broadcast (sim s)")
            for c in commits:
                h.observe(float(c.t_arrive - c.base_time))
        for k, v in self.last_metrics.items():
            metrics[k] = v.copy()
        self._broadcast(range(self.C), t)
        return metrics

    # ---- mobility -------------------------------------------------------
    def _on_mobility(self, ev: MobilityTick) -> None:
        self.queue.push(MobilityTick(ev.t + self.migrate_every,
                                     ev.index + 1))
        for i in range(self.C):
            self.mobility.advance(i, self.rng)
            cur = int(self.topo.client_edge[i])
            if self.mobility.out_of_range(i, cur):
                dst = self.mobility.nearest_edge(i)
                if dst != cur and len(self.topo.edges[cur]) > 1:
                    self.queue.push(PodMigration(ev.t, i, cur, dst))
        return None

    def _on_migration(self, ev: PodMigration) -> None:
        i = ev.vehicle
        cur = int(self.topo.client_edge[i])
        if cur != ev.src or len(self.topo.edges[cur]) == 1:
            return None                 # a same-tick migration got there first
        self.topo = self.topo.reassign(i, ev.dst)
        self.n_migrations += 1
        if self.tracer is not None:
            from repro_torch.obs import trace as T
            self.tracer.instant(
                "pod_migration", ev.t, pid=T.FL_PID, tid=T.vehicle_tid(i),
                cat="mobility", args={"src": ev.src, "dst": ev.dst})
        if self.metrics is not None:
            self.metrics.counter(
                "fl_migrations", "completed pod migrations").inc()
        # membership changed: either pod may now be complete
        self._edge_check(ev.src, ev.t)
        self._edge_check(ev.dst, ev.t)
        return None


# ---- timing-only schedule exploration -------------------------------------


def simulate_schedule(topology: Topology, *, bytes_per_client: int = 2 ** 21,
                      clock: Optional[float] = None, decay: float = 0.5,
                      compute_flops: float = 4.7e11, jitter: float = 0.0,
                      migrate_every: Optional[float] = None,
                      mobility: Optional[MobilitySpec] = None,
                      rounds: int = 10, seed: int = 0,
                      max_events: int = 1_000_000,
                      tracer=None, metrics=None) -> Dict:
    """Run the event schedule with no tensors — merge cadence, observed
    staleness and migration counts for a topology + clock."""
    if mobility is None and migrate_every is not None:
        mobility = MobilitySpec(seed=seed)
    engine = AsyncHierFLEngine(
        topology, bytes_per_client, lambda m: bytes_per_client,
        compute=ComputeModel(flops=compute_flops, jitter=jitter),
        clock=clock, decay=decay, mobility=mobility,
        migrate_every=migrate_every, seed=seed,
        tracer=tracer, metrics=metrics)
    engine.reset()
    merges: List[Dict] = []
    for _ in range(max_events):
        if len(merges) >= rounds:
            break
        ev = engine.queue.pop()
        if ev is None:
            raise RuntimeError(
                "event queue drained before the schedule finished — the "
                "fabric deadlocked (a pod is waiting on a member that "
                "will never arrive)")
        rec = engine.handle(ev)
        if rec is not None:
            merges.append(rec)
    if len(merges) < rounds:
        raise RuntimeError(
            f"schedule produced only {len(merges)} of {rounds} merges "
            f"within max_events={max_events} — clock too small for the "
            f"fabric's arrival rate?")
    return {
        "merges": merges,
        "sim_time_s": engine.now,
        "mean_period_s": (engine.now / len(merges)) if merges else math.inf,
        "mean_staleness": float(np.mean(
            [m["staleness_mean"] for m in merges])) if merges else 1.0,
        "n_migrations": engine.n_migrations,
        "events": len(engine.event_log),
        "event_log": engine.event_log,
    }
