"""Two-tier aggregation over an explicit topology (port of
``repro/comm/hierarchy.py``).

``edge_aggregate`` computes each edge pod's weighted partial average of
its members' updates; ``cloud_merge`` combines the edge partials,
optionally down-weighting stale edges (``decay ** lag``).
``pod_slice``/``pod_broadcast`` carry per-pod state (``distill_fl``'s
personalized adapters). ``make_hier_round`` is the whole round the
``hier_fl`` strategy runs:
local steps per client, the per-client codec roundtrip with error
feedback, edge partial averages, the cloud merge and the broadcast.

The aggregation is also split into its event-time halves, which the
discrete-event engine (:mod:`repro_torch.comm.events`) runs piecewise:
per-pod :func:`edge_commit` (an edge partially averages whichever
members have arrived) and clocked :func:`cloud_merge_at` (the cloud
merges the commits it holds, with observed staleness multipliers).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.comm.codecs import BitsSource, Codec, roundtrip_stacked
from repro_torch.comm.topology import Topology
from repro_torch.tree import leaves, tree_map


def edge_commit(member_stacked, member_weights):
    """One pod's partial aggregate: a member-stacked [M, ...] tree and [M]
    weights -> (float32 partial-average tree, scalar total weight), the
    per-pod piece of :func:`edge_aggregate` (the same operations, so a
    pod's commit is bitwise its row of the edge tree)."""
    first = leaves(member_stacked)[0]
    wm = torch.as_tensor(member_weights, dtype=torch.float32).to(
        first.device)

    def part(x):
        wb = wm.reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * wb).sum(dim=0) / wm.sum()

    return tree_map(part, member_stacked), wm.sum()


def edge_aggregate(stacked, weights, topology: Topology, *,
                   validated: bool = False):
    """Client-stacked [C, ...] tree -> (edge-stacked [E, ...] tree, [E]
    edge weights). Each edge's partial average is weighted by its
    members' ``weights`` (uniform when None) and computed in float32; the
    edge weight is the members' total, so a weighted merge downstream
    gives the global weighted mean. ``validated=True`` skips the per-pod
    degenerate-weight check (done once when the round is built)."""
    first = leaves(stacked)[0]
    n = first.shape[0]
    if n != topology.n_clients:
        raise ValueError(
            f"client axis has {n} entries but the topology declares "
            f"{topology.n_clients} vehicles")
    w = (torch.ones((n,), dtype=torch.float32) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32))
    if weights is not None and not validated:
        topology.validate_pod_weights(w.numpy())
    w = w.to(first.device)
    idx = [torch.as_tensor(m, device=first.device)
           for m in topology.member_indices]

    def edges(x):
        parts = []
        for m in idx:
            wm = w[m]
            wb = wm.reshape((-1,) + (1,) * (x.dim() - 1))
            parts.append((x[m].float() * wb).sum(dim=0) / wm.sum())
        return torch.stack(parts).to(x.dtype)

    edge_w = torch.stack([w[m].sum() for m in idx])
    return tree_map(edges, stacked), edge_w


def cloud_merge(edge_stacked, edge_weights, staleness=None):
    """Edge-stacked [E, ...] tree -> global [...] tree. ``staleness``:
    optional [E] multipliers (1 = fresh) on the edge weights before
    normalization."""
    w = torch.as_tensor(edge_weights, dtype=torch.float32)
    if staleness is not None:
        w = w * torch.as_tensor(staleness, dtype=torch.float32,
                                device=w.device)

    def merge(x):
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return ((x.float() * wb).sum(dim=0) / w.sum().to(x.device)
                ).to(x.dtype)

    return tree_map(merge, edge_stacked)


def cloud_merge_at(global_params, partials, partial_weights,
                   staleness=None):
    """The clocked half of the split round: merge committed edge partials
    (float32 trees from :func:`edge_commit`, with their scalar weights)
    into the current global params; ``staleness``: optional
    [len(partials)] multipliers from each commit's observed lag (1 =
    landed within the current deadline window). Returns the new global
    params, the merged delta applied on top of ``global_params``.

    The partials stay float32 up to the merge, as in :func:`make_hier_round`
    (the reference casts them to the params' dtype first, which rounds a
    bfloat16 model's merged delta twice more; for float32 params the two
    are the same), so with every commit of a round the merge is bitwise
    the fused round's."""
    edge_tree = tree_map(lambda g, *parts: torch.stack(parts),
                         global_params, *partials)
    device = leaves(global_params)[0].device
    w = torch.stack([torch.as_tensor(x, dtype=torch.float32).to(device)
                     for x in partial_weights])
    merged = cloud_merge(edge_tree, w, staleness)
    return tree_map(lambda g, d: (g.float() + d).to(g.dtype),
                    global_params, merged)


def pod_slice(stacked, topology: Topology):
    """Client-stacked [C, ...] tree -> edge-stacked [E, ...] tree taking
    each pod's first member. Valid whenever pod members hold identical
    state, the invariant the pod-broadcast rounds keep (every member
    starts a round from its pod's shared adapter)."""
    idx = [int(members[0]) for members in topology.member_indices]
    return tree_map(lambda x: x[torch.as_tensor(idx, device=x.device)],
                    stacked)


def pod_broadcast(edge_stacked, topology: Topology):
    """Edge-stacked [E, ...] tree -> client-stacked [C, ...] tree: every
    vehicle receives its own pod's state (the personalized counterpart
    of ``core.fedavg.broadcast_round``, which sends one tree to all)."""
    ce = [int(e) for e in topology.client_edge]
    return tree_map(lambda x: x[torch.as_tensor(ce, device=x.device)],
                    edge_stacked)


def hierarchical_mean(stacked, weights, topology: Topology,
                      staleness=None):
    """Explicit two-tier (edge, then cloud) weighted mean of a
    client-stacked tree — the fabric-aware form of ``fedavg``."""
    edge_tree, edge_w = edge_aggregate(stacked, weights, topology)
    return cloud_merge(edge_tree, edge_w, staleness)


def staleness_weights(arrivals, deadline: float, *,
                      decay: float = 0.5) -> np.ndarray:
    """[E] multipliers from predicted edge arrival times: an edge landing
    within ``deadline`` is fresh (1.0), one landing in the following
    round is one round stale (``decay``), and so on."""
    if deadline <= 0:
        raise ValueError(f"deadline must be positive, got {deadline}")
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    lag = np.maximum(0.0, np.ceil(np.asarray(arrivals, np.float64)
                                  / deadline) - 1.0)
    return (decay ** lag).astype(np.float32)


def make_hier_round(cfg, shape, optimizer, topology: Topology,
                    codec: Codec, *, local_steps: int = 1,
                    remat: bool = False, client_weights=None,
                    staleness: Optional[np.ndarray] = None):
    """One hierarchical FL round over client-stacked params.

    hier_round(client_params, client_opt, batches, residual, bits) ->
    (client_params', client_opt', metrics, residual'): ``batches`` carry
    [C, E, B, ...] leaves, ``residual`` is the codec's per-client
    error-feedback state and ``bits`` the round's source of random words
    (see :func:`repro_torch.comm.codecs.roundtrip_stacked`). Clients send
    **deltas** from the round's broadcast params (client 0's at round
    start) through the codec; edges partially average the decoded
    deltas, the cloud merges the edge partials and every client gets the
    new global params."""
    from repro_torch.core.fedavg import (broadcast_round, check_weights,
                                         make_local_train, map_clients)
    from repro_torch.core.steps import make_train_step

    step = make_train_step(cfg, shape, optimizer, remat=remat)
    w = None if client_weights is None else check_weights(client_weights)
    if w is not None:
        topology.validate_pod_weights(w.numpy())
    local_train = make_local_train(step)

    def hier_round(client_params, client_opt, batches, residual,
                   bits: Optional[BitsSource] = None):
        n = leaves(client_params)[0].shape[0]
        if w is not None and tuple(w.shape) != (n,):
            raise ValueError(
                f"client_weights has shape {tuple(w.shape)}, expected "
                f"({n},)")
        global_params = tree_map(lambda x: x[0], client_params)
        params, opts, metrics = map_clients(local_train, client_params,
                                            client_opt, batches)
        deltas = tree_map(lambda after, g: after.float() - g[None], params,
                          global_params)
        del params
        decoded, residual = roundtrip_stacked(codec, deltas, residual, bits)
        del deltas
        edge_tree, edge_w = edge_aggregate(decoded, w, topology,
                                           validated=True)
        merged = cloud_merge(edge_tree, edge_w, staleness)
        new_global = tree_map(lambda g, d: (g.float() + d).to(g.dtype),
                              global_params, merged)
        return broadcast_round(new_global, n), opts, metrics, residual

    return hier_round
