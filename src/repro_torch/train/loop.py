"""Host-side training loops (port of ``repro/train/loop.py``:
``LoopHooks``, ``train_loop`` and ``fl_loop``).

``train_loop`` drives any (params, opt, batch) -> (params, opt, metrics)
step; ``fl_loop`` drives FL rounds over client-stacked state;
``LoopHooks`` holds the loops' side effects: logging, the edge backup,
checkpoints, a per-step callback and live repartitioning. History
entries keep scalar metrics as floats and per-client metrics whole under
a ``per_client/`` prefix. Sim-time tracing comes with the observability
slice: its hook raises if it is set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.recovery.backup import EdgeBackup
from repro_torch.train.checkpoint import save as _save_checkpoint

#: hooks of the reference that later slices of the port bring
_LATER_HOOKS = {
    "tracer": "sim-time tracing (observability slice)",
}


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
    #: live dynamic repartitioning hook (paper §4.2 executed in-loop):
    #: (idx, step_fn, params, opt) -> None to keep going, or a replacement
    #: (step_fn, params, opt) after a template switch
    repartition: Optional[Callable] = None
    tracer: Optional[object] = None
    #: optional :class:`repro_torch.obs.MetricsRegistry`: every logged
    #: round's scalar metrics are published into it
    metrics: Optional[object] = None

    def check_ported(self) -> None:
        for name, what in _LATER_HOOKS.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"LoopHooks.{name}: {what} comes with a later slice of "
                    f"the port")

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
    hooks.check_ported()
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
    hooks.check_ported()
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
