"""Declarative vehicle -> edge -> cloud topology with link models (port
of ``repro/comm/topology.py``).

A :class:`Topology` names which vehicles sit under which edge pod and
what the links carry: each vehicle's ``com`` bandwidth is its uplink to
the edge, and a shared ``backhaul_bw`` models the edge -> cloud links.
:meth:`Topology.hier_round_stats` turns a round's wire bytes into bytes
on the wire and a simulated round time, and
:meth:`Topology.flat_round_stats` does the same for flat FedAvg, where
every payload crosses the backhaul; :meth:`Topology.reassign` moves a
vehicle between pods.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.sched.costmodel import Vehicle, parse_fleet, t_uplink

#: default edge -> cloud backhaul (bytes/s) — metro fiber, not V2X radio
DEFAULT_BACKHAUL_BW = 1.25e9
#: one-way edge -> cloud latency floor (s)
DEFAULT_BACKHAUL_LATENCY = 0.01


@dataclasses.dataclass(frozen=True)
class Topology:
    """Vehicles grouped under edge pods, with link bandwidths."""

    vehicles: Tuple[Vehicle, ...]
    #: per-edge tuple of indices into ``vehicles``
    edges: Tuple[Tuple[int, ...], ...]
    backhaul_bw: float = DEFAULT_BACKHAUL_BW
    backhaul_latency: float = DEFAULT_BACKHAUL_LATENCY

    def __post_init__(self):
        seen = [i for members in self.edges for i in members]
        if sorted(seen) != list(range(len(self.vehicles))):
            raise ValueError(
                f"edges must partition the {len(self.vehicles)} vehicles "
                f"exactly; got memberships {self.edges}")
        if any(not members for members in self.edges):
            raise ValueError("every edge pod needs at least one vehicle")
        if self.backhaul_bw <= 0:
            raise ValueError("backhaul_bw must be positive")
        member_idx = tuple(np.asarray(members, np.int64)
                           for members in self.edges)
        ce = np.empty(len(self.vehicles), np.int64)
        for e, idx in enumerate(member_idx):
            ce[idx] = e
        ce.setflags(write=False)
        object.__setattr__(self, "_member_indices", member_idx)
        object.__setattr__(self, "_client_edge", ce)

    @property
    def n_clients(self) -> int:
        return len(self.vehicles)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def member_indices(self) -> Tuple[np.ndarray, ...]:
        """Per-edge index arrays into the client axis (cached)."""
        return self._member_indices

    @property
    def client_edge(self) -> np.ndarray:
        """[C] edge index of each client; cached and read-only."""
        return self._client_edge

    def validate_pod_weights(self, weights) -> None:
        """Raise if any pod's member weights are degenerate (a pod whose
        members sum to zero would 0/0 its partial average)."""
        from repro_torch.core.fedavg import check_weights
        w = np.asarray(weights, np.float32)
        for e, idx in enumerate(self.member_indices):
            try:
                check_weights(w[idx])
            except ValueError as err:
                raise ValueError(
                    f"edge pod {e} (vehicles {self.edges[e]}): {err}"
                ) from None

    def reassign(self, vehicle: int, edge: int) -> "Topology":
        """The successor topology with ``vehicle`` moved to ``edge`` (this
        one is unchanged); the source pod must keep a member."""
        if not 0 <= vehicle < self.n_clients:
            raise ValueError(f"no vehicle {vehicle} in this topology")
        if not 0 <= edge < self.n_edges:
            raise ValueError(f"no edge pod {edge} in this topology")
        src = int(self.client_edge[vehicle])
        if src == edge:
            return self
        if len(self.edges[src]) == 1:
            raise ValueError(
                f"cannot migrate vehicle {vehicle}: it is the last member "
                f"of edge pod {src}")
        edges = [tuple(i for i in members if i != vehicle)
                 for members in self.edges]
        edges[edge] = edges[edge] + (vehicle,)
        return dataclasses.replace(self, edges=tuple(edges))

    @classmethod
    def from_fleet(cls, fleet, n_edges: int, *,
                   backhaul_bw: float = DEFAULT_BACKHAUL_BW,
                   backhaul_latency: float = DEFAULT_BACKHAUL_LATENCY
                   ) -> "Topology":
        """Group a fleet into ``n_edges`` contiguous pods, as even as the
        head count allows."""
        vehicles = tuple(parse_fleet(fleet))
        c = len(vehicles)
        if not 1 <= n_edges <= c:
            raise ValueError(
                f"need 1 <= n_edges <= {c} vehicles, got {n_edges}")
        base, extra = divmod(c, n_edges)
        edges, start = [], 0
        for e in range(n_edges):
            size = base + (1 if e < extra else 0)
            edges.append(tuple(range(start, start + size)))
            start += size
        return cls(vehicles, tuple(edges), backhaul_bw=backhaul_bw,
                   backhaul_latency=backhaul_latency)

    def uplink_times(self, bytes_per_client: float) -> np.ndarray:
        """[C] seconds for each vehicle to push one payload to its edge."""
        return np.array([t_uplink(bytes_per_client, v)
                         for v in self.vehicles])

    def hier_round_stats(self, bytes_per_client: float,
                         bytes_per_edge=None) -> Dict:
        """Bytes on the wire and simulated time for one hierarchical
        round: each vehicle uploads to its edge, each edge forwards ONE
        payload (``bytes_per_edge``, scalar or per edge; default the
        client's) to the cloud. An edge's update arrives when its slowest
        member has uploaded plus the backhaul transfer; the round closes
        on the last edge."""
        if bytes_per_edge is None:
            bytes_per_edge = bytes_per_client
        per_edge = np.broadcast_to(
            np.asarray(bytes_per_edge, np.float64), (self.n_edges,))
        up = self.uplink_times(bytes_per_client)
        arrivals = np.array([
            up[list(members)].max()
            + per_edge[e] / self.backhaul_bw + self.backhaul_latency
            for e, members in enumerate(self.edges)])
        return {
            "uplink_bytes": int(bytes_per_client) * self.n_clients,
            "backhaul_bytes": int(per_edge.sum()),
            "edge_arrival_s": arrivals,
            "round_time_s": float(arrivals.max()),
        }


    def flat_round_stats(self, bytes_per_client: float) -> Dict:
        """The no-edge-aggregation baseline on the same links: all C
        payloads transit the backhaul unreduced, one after another."""
        up = self.uplink_times(bytes_per_client)
        backhaul = (self.n_clients * bytes_per_client / self.backhaul_bw
                    + self.backhaul_latency)
        round_time = float(up.max() + backhaul)
        return {
            "uplink_bytes": int(bytes_per_client) * self.n_clients,
            "backhaul_bytes": int(bytes_per_client) * self.n_clients,
            "edge_arrival_s": np.full(self.n_edges, round_time),
            "round_time_s": round_time,
        }


def parse_topology(spec, *, backhaul_bw: float = DEFAULT_BACKHAUL_BW,
                   backhaul_latency: float = DEFAULT_BACKHAUL_LATENCY
                   ) -> Topology:
    """A :class:`Topology` (passed through), an ``"E@FLEET"`` string —
    ``"2@nano*2,agx*2"`` is 2 edge pods over that 4-vehicle fleet — or a
    plain fleet spec (one edge pod over the whole fleet)."""
    if isinstance(spec, Topology):
        return spec
    n_edges = 1
    if isinstance(spec, str) and "@" in spec:
        head, _, spec = spec.partition("@")
        try:
            n_edges = int(head)
        except ValueError:
            raise ValueError(
                f"topology spec must look like 'E@FLEET' with integer E, "
                f"got {head!r}") from None
    return Topology.from_fleet(spec, n_edges, backhaul_bw=backhaul_bw,
                               backhaul_latency=backhaul_latency)
