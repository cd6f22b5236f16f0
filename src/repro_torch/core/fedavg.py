"""Federated averaging over client-stacked parameter trees (port of
``repro/core/fedavg.py``).

Client trees carry a leading client axis [C, ...]. Where the reference
``vmap``s the local steps over that axis, the port loops over the
clients one after another (:func:`map_clients`) and writes each client's
results into the stacked outputs.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.train.optimizer import AdamState
from repro_torch.tree import leaves, tree_map


def stack_clients(params, n_clients: int):
    """Replicate params into a leading client axis [C, ...] (a copy)."""
    return tree_map(
        lambda x: x.detach()[None].expand((n_clients,) + x.shape)
        .contiguous(), params)


def check_weights(weights) -> torch.Tensor:
    """Validate aggregation weights: a degenerate vector (all-zero,
    negative, or non-finite sum) would NaN the global params through the
    normalizing division."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    total = float(w.sum())
    if not math.isfinite(total) or total <= 0.0:
        raise ValueError(
            f"degenerate aggregation weights (sum={total}): the "
            f"normalizing division would NaN the global params; weights "
            f"must be finite with a positive sum")
    return w


def fedavg(client_params, *, weights=None, topology=None):
    """Average client-stacked params [C, ...] -> global params [...].

    ``weights``: optional [C] client weights; ``topology``: aggregate over
    the explicit vehicle -> edge -> cloud fabric (edge partial averages,
    then the cloud merge) instead of a flat client-axis mean."""
    if weights is not None:
        weights = check_weights(weights)
    if topology is not None:
        from repro_torch.comm.hierarchy import hierarchical_mean
        return hierarchical_mean(client_params, weights, topology)
    if weights is None:
        return tree_map(lambda x: x.float().mean(dim=0).to(x.dtype),
                        client_params)
    w = weights / weights.sum()

    def wmean(x):
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * wb).sum(dim=0).to(x.dtype)

    return tree_map(wmean, client_params)


def broadcast_round(global_params, n_clients: int):
    """Cloud -> edge -> vehicle model distribution for the next round."""
    return stack_clients(global_params, n_clients)


def client_slice(tree, c: int):
    """Client ``c``'s view of a client-stacked tree (or AdamState)."""
    if isinstance(tree, AdamState):
        return AdamState(tree.step[c], client_slice(tree.m, c),
                         client_slice(tree.v, c))
    return tree_map(lambda x: x[c], tree)


def _write(out, c: int, n: int, tree):
    """Copy client ``c``'s result into the stacked [n, ...] outputs,
    allocating them on the first client."""
    if isinstance(tree, AdamState):
        if out is None:
            out = AdamState(None, None, None)
        return AdamState(_write(out.step, c, n, tree.step),
                         _write(out.m, c, n, tree.m),
                         _write(out.v, c, n, tree.v))
    if out is None:
        out = tree_map(lambda x: torch.empty((n,) + x.shape, dtype=x.dtype,
                                             device=x.device), tree)
    tree_map(lambda o, x: o[c].copy_(x), out, tree)
    return out


def map_clients(local_train: Callable, client_params, client_opt, batches):
    """Run ``local_train`` for every client of the stacked inputs, one
    client at a time; returns the stacked (params, opt_state, metrics).
    Each client's results are copied into the stacked outputs as soon as
    they exist, so at most one client's temporaries live at a time."""
    n = leaves(client_params)[0].shape[0]
    params = opts = metrics = None
    for c in range(n):
        p, o, m = local_train(client_slice(client_params, c),
                              client_slice(client_opt, c),
                              client_slice(batches, c))
        params = _write(params, c, n, p)
        opts = _write(opts, c, n, o)
        metrics = _write(metrics, c, n, m)
    return params, opts, metrics


def make_local_train(step: Callable):
    """One client's E local steps: (params, opt_state, steps_batches) ->
    (params', opt_state', last-step metrics); ``steps_batches`` leaves
    carry a leading local-step axis [E, ...]."""

    def local_train(params, opt_state, steps_batches):
        n_steps = leaves(steps_batches)[0].shape[0]
        metrics = None
        for e in range(n_steps):
            params, opt_state, metrics = step(
                params, opt_state, tree_map(lambda x: x[e], steps_batches))
        return params, opt_state, metrics

    return local_train


def make_fl_round(cfg, shape, optimizer, *, local_steps: int = 1,
                  remat: bool = True, client_weights=None):
    """One flat FL round over client-stacked params: fl_round(client_params,
    client_opt, batches) -> (client_params', client_opt', metrics), with
    ``batches`` leaves [C, E, B, ...]."""
    from repro_torch.core.steps import make_train_step
    step = make_train_step(cfg, shape, optimizer, remat=remat)
    w = None if client_weights is None else check_weights(client_weights)
    local_train = make_local_train(step)

    def fl_round(client_params, client_opt, batches):
        n = leaves(client_params)[0].shape[0]
        if w is not None and tuple(w.shape) != (n,):
            raise ValueError(
                f"client_weights has shape {tuple(w.shape)}, expected "
                f"({n},) to match the client axis")
        params, opts, metrics = map_clients(local_train, client_params,
                                            client_opt, batches)
        avg = fedavg(params, weights=w)
        return broadcast_round(avg, n), opts, metrics

    return fl_round
