"""Host-side training loops (port of ``repro/train/loop.py``).

``train_loop`` drives any (params, opt, batch) -> (params, opt, metrics)
step; ``fl_loop`` drives FL rounds over client-stacked state;
``async_fl_loop`` drives the discrete-event engine of
:mod:`repro_torch.comm.events` — the loop pops timestamped events and
the events drive the compute, inverting ``fl_loop``'s control flow.
``LoopHooks`` holds the loops' side effects: logging, the edge backup,
checkpoints, per-step, per-round and per-event callbacks, live
repartitioning, and the tracer and metrics registry. History entries
keep scalar metrics as floats and per-client metrics whole under a
``per_client/`` prefix.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.recovery.backup import EdgeBackup
from repro_torch.train.checkpoint import save as _save_checkpoint

def _identity(tree):
    return tree


def _split_metrics(metrics: Dict):
    """(scalars as floats, non-scalars as numpy under ``per_client/``)."""
    scalars, arrays = {}, {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if np.ndim(v) == 0:
            scalars[k] = float(v)
        else:
            arrays[f"per_client/{k}"] = np.asarray(v)
    return scalars, arrays


def _fmt_metrics(scalars: Dict, arrays: Dict) -> str:
    parts = [f"{k}={v:.4f}" for k, v in scalars.items()]
    parts += [f"{k.split('/', 1)[1]}[mean]={np.nanmean(v):.4f}"
              for k, v in arrays.items()]
    return " ".join(parts)


@dataclasses.dataclass
class LoopHooks:
    """Side effects of one training/FL loop, in one place.

    ``backup_view`` maps the loop's raw params (which may be a stage
    container or client-stacked tree) to what EdgeBackup should snapshot.
    None means raw params — except under ``Session.run``, which defaults
    it to the strategy's merged flat params so snapshots are redeployable
    by recovery's ``restage`` under any template.
    """

    log_every: int = 10
    log_fn: Callable = print
    backup: Optional[EdgeBackup] = None
    backup_view: Optional[Callable] = None
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    #: JSON-serializable dict (or zero-arg callable returning one) saved as
    #: a sidecar next to each checkpoint — Session.run defaults it to the
    #: strategy name + live stage templates so structured checkpoints can
    #: be restaged without out-of-band knowledge
    checkpoint_meta: Optional[object] = None
    #: optional user callback (step_or_round_idx, params, metrics) -> None
    on_step: Optional[Callable] = None
    #: FL-round callback (round_idx, metrics) -> None; for ``hier_fl`` the
    #: metrics carry ``comm_bytes_up``, ``comm_bytes_backhaul`` and
    #: ``sim_round_s`` from the topology's link models
    on_round: Optional[Callable] = None
    #: event-time callback (event) -> None, fired for every event the
    #: ``async_fl_loop`` engine pops (LocalStepDone / UplinkArrived /
    #: BackhaulArrived / CloudDeadline / PodMigration / ...)
    on_event: Optional[Callable] = None
    #: live dynamic repartitioning hook (paper §4.2 executed in-loop):
    #: (idx, step_fn, params, opt) -> None to keep going, or a replacement
    #: (step_fn, params, opt) after a template switch
    repartition: Optional[Callable] = None
    #: optional :class:`repro_torch.obs.Tracer` — ``async_fl_loop`` hands
    #: it to the event engine (sim-time spans per vehicle/edge/cloud
    #: track); the wall-clock loops have no sim timeline and ignore it
    tracer: Optional[object] = None
    #: optional :class:`repro_torch.obs.MetricsRegistry`: every logged
    #: round's scalar metrics are published into it; ``async_fl_loop``
    #: also hands it to the engine
    metrics: Optional[object] = None

    def after_step(self, i: int, params, metrics=None) -> None:
        if self.backup is not None:
            view = self.backup_view or _identity
            self.backup.maybe_backup(i, lambda: view(params))
        if self.checkpoint_path and self.checkpoint_every and \
                (i + 1) % self.checkpoint_every == 0:
            meta = self.checkpoint_meta() if callable(self.checkpoint_meta) \
                else self.checkpoint_meta
            _save_checkpoint(self.checkpoint_path, params, step=i + 1,
                             meta=meta)
        if self.on_step is not None:
            self.on_step(i, params, metrics)

    def maybe_repartition(self, i: int, step_fn, params, opt_state):
        """Apply the repartition hook; returns the (possibly swapped)
        loop state."""
        if self.repartition is not None:
            swapped = self.repartition(i, step_fn, params, opt_state)
            if swapped is not None:
                return swapped
        return step_fn, params, opt_state

    def should_log(self, i: int) -> bool:
        return (i + 1) % self.log_every == 0 or i == 0


def train_loop(step_fn: Callable, params, opt_state, batch_iter, *,
               steps: int, hooks: Optional[LoopHooks] = None) -> Dict:
    """``steps`` steps of ``step_fn`` over batches from ``batch_iter``; the
    default cadence logs the first step and every tenth."""
    hooks = hooks or LoopHooks()
    hist = []
    t0 = time.time()
    for i in range(steps):
        batch = next(batch_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        hooks.after_step(i, params, metrics)
        if hooks.should_log(i):
            m, per_client = _split_metrics(metrics)
            if hooks.metrics is not None:
                hooks.metrics.publish_scalars(m)
            hist.append(dict(m, **per_client, step=i + 1,
                             t_wall_s=time.time() - t0))
            rate = (i + 1) / (time.time() - t0)
            hooks.log_fn(f"[train] step {i+1:5d} "
                         + _fmt_metrics(m, per_client)
                         + f" ({rate:.2f} it/s)")
        step_fn, params, opt_state = hooks.maybe_repartition(
            i, step_fn, params, opt_state)
    return {"params": params, "opt_state": opt_state, "history": hist,
            "step_fn": step_fn}


def fl_loop(fl_round: Callable, client_params, client_opt,
            round_batches_fn: Callable, *, rounds: int,
            hooks: Optional[LoopHooks] = None, teacher=None) -> Dict:
    """round_batches_fn(round_idx) -> client-stacked batches [C, E, B, ...].
    Rounds are few and each is expensive, so the default cadence logs
    every round.

    ``teacher``: the student/teacher split of federated distillation —
    optional frozen params handed to every round as
    ``fl_round(client_params, client_opt, batches, teacher)``; the loop
    carries only the trainable student side."""
    hooks = hooks or LoopHooks(log_every=1)
    extra = () if teacher is None else (teacher,)
    hist = []
    t0 = time.time()
    for r in range(rounds):
        batches = round_batches_fn(r)
        client_params, client_opt, metrics = fl_round(client_params,
                                                      client_opt, batches,
                                                      *extra)
        hooks.after_step(r, client_params, metrics)
        if hooks.on_round is not None:
            hooks.on_round(r, metrics)
        if hooks.should_log(r):
            m, per_client = _split_metrics(metrics)
            if hooks.metrics is not None:
                hooks.metrics.publish_scalars(m)
            hist.append(dict(m, **per_client, round=r + 1,
                             t_wall_s=time.time() - t0))
            hooks.log_fn(f"[fl] round {r+1:4d} "
                         + _fmt_metrics(m, per_client))
        fl_round, client_params, client_opt = hooks.maybe_repartition(
            r, fl_round, client_params, client_opt)
    return {"client_params": client_params, "client_opt": client_opt,
            "history": hist, "step_fn": fl_round}


def async_fl_loop(engine, client_params, client_opt,
                  round_batches_fn: Callable, *, rounds: int,
                  hooks: Optional[LoopHooks] = None,
                  until_time: Optional[float] = None,
                  max_events: int = 2_000_000) -> Dict:
    """Drive an :class:`repro_torch.comm.events.AsyncHierFLEngine` until
    ``rounds`` cloud merges (or simulated ``until_time``) have happened.

    The loop pops timestamped events off the engine's priority queue and
    each event drives the compute it stands for (a wave's local steps at
    ``LocalStepDone``, a pod's partial aggregate at commit, the
    staleness-weighted merge at ``CloudDeadline``).
    ``round_batches_fn(wave_idx)`` supplies client-stacked batches like
    ``fl_loop``'s ``round_batches_fn``; in the synchronous case (no merge
    clock) waves and rounds coincide.

    One history entry per cloud merge, on both clocks (``t_wall_s``,
    ``t_sim_s``); ``hooks.on_event`` sees every event, ``hooks.on_round``
    every merge."""
    hooks = hooks or LoopHooks(log_every=1)
    # observability rides in on the hooks: the engine owns the sim clock,
    # so it (not this loop) emits the spans and fabric metrics
    if hooks.tracer is not None and getattr(engine, "tracer", None) is None:
        engine.tracer = hooks.tracer
    if hooks.metrics is not None and getattr(engine, "metrics", None) is None:
        engine.metrics = hooks.metrics
    engine.reset(client_params, client_opt, round_batches_fn)
    hist = []
    merges = 0
    t0 = time.time()
    for _ in range(max_events):
        if merges >= rounds:
            break
        if until_time is not None and engine.queue.peek_t() > until_time:
            break
        ev = engine.queue.pop()
        if ev is None:
            raise RuntimeError(
                f"event queue drained after {merges} merges "
                f"(wanted {rounds}) — the fabric deadlocked; with "
                f"clock=None every pod must eventually hear from all "
                f"its members")
        rec = engine.handle(ev)
        if hooks.on_event is not None:
            hooks.on_event(ev)
        if rec is None:
            continue
        hooks.after_step(merges, engine.client_params, rec)
        if hooks.on_round is not None:
            hooks.on_round(merges, rec)
        if hooks.should_log(merges):
            m, per_client = _split_metrics(rec)
            if hooks.metrics is not None:
                hooks.metrics.publish_scalars(m)
            hist.append(dict(m, **per_client, round=merges + 1,
                             t_wall_s=time.time() - t0,
                             t_sim_s=float(engine.now)))
            hooks.log_fn(f"[async-fl] merge {merges+1:4d} "
                         f"t={engine.now:9.3f}s "
                         + _fmt_metrics(m, per_client))
        merges += 1
    else:
        raise RuntimeError(
            f"async_fl_loop exceeded max_events={max_events} before "
            f"{rounds} merges — runaway event schedule")
    return {"client_params": engine.client_params,
            "client_opt": engine.client_opt,
            "global_params": engine.global_params,
            "history": hist, "event_log": engine.event_log,
            "sim_time_s": engine.now, "merges": merges,
            "step_fn": engine}
