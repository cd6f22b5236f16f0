"""Quick recovery orchestration (port of ``repro/recovery/recover.py``;
paper §4.2 + Fig. 5b).

Three strategies are modeled with the same communication substrate so their
times are comparable (the paper's 5 s vs 30 s vs 50 s):

  * ``template``  — FLAD: deploy the pre-generated template, move only the
    diff of model partitions, keep the communication stack (reassign stage
    ids). time = diff_bytes/bw + reassign overhead.
  * ``elastic``   — Elastic-TorchRun-style: keep processes, re-plan from
    scratch, redistribute every partition.
  * ``relaunch``  — tear down, re-init the stack, re-plan, redistribute
    everything, reload from backup.

:class:`Repartitioner` executes the ``template`` strategy for real on a
running :class:`repro_torch.api.Session`: on a scheduled vehicle
departure it looks up the pre-generated template, merges the live stage
params, restages them under the new template, rebuilds the FHDP step,
and hands the loop the swapped (step, params, opt) — the paper's
5-second recovery executed instead of modeled. Its times are host-clock
seconds read after ``torch.cuda.synchronize()``, so on the card they
include the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.recovery.templates import (TemplateSet,
                                            full_redistribution_bytes,
                                            pregenerate,
                                            redistribution_bytes)
from repro_torch.sched.costmodel import CostParams, Unit, Vehicle
from repro_torch.sched.swift import Pipeline, phase1_greedy

# fixed overheads (seconds) — calibrated to the paper's testbed numbers:
# relaunch pays full process/RPC re-init; elastic keeps processes but
# re-plans and re-establishes groups; template only reassigns stage ids.
REINIT_S = {"template": 0.5, "elastic": 8.0, "relaunch": 20.0}


@dataclasses.dataclass
class RecoveryOutcome:
    strategy: str
    ok: bool
    seconds: float
    moved_bytes: float
    replan_s: float
    new_pipeline: Optional[Pipeline]


def recover(strategy: str, templates: TemplateSet, failed_vid: int,
            vehicles: Sequence[Vehicle], units: Sequence[Unit],
            cp: Optional[CostParams] = None,
            link_bw: float = 0.125e9) -> RecoveryOutcome:
    """Execute one recovery after ``failed_vid`` departs."""
    cp = cp or CostParams()
    rest = [v for v in vehicles if v.vid != failed_vid]
    t0 = time.perf_counter()
    if strategy == "template":
        new = templates.on_departure.get(failed_vid)
        replan = time.perf_counter() - t0     # lookup only
        if new is None:
            return RecoveryOutcome(strategy, False, 0.0, 0.0, replan, None)
        moved = redistribution_bytes(templates.active, new)
    else:
        new = phase1_greedy(rest, units, cp)  # replanning from scratch
        replan = time.perf_counter() - t0
        if new is None:
            return RecoveryOutcome(strategy, False, 0.0, 0.0, replan, None)
        moved = full_redistribution_bytes(new)
    seconds = REINIT_S[strategy] + replan + moved / link_bw
    return RecoveryOutcome(strategy, True, seconds, moved, replan, new)


# --------------------------------------------------------------------------
# Live dynamic repartitioning (scheduler -> runtime, executed not modeled)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RepartitionEvent:
    """One executed template switch on the live runtime."""
    step: int
    vid: int
    old_template: Dict[str, tuple]
    new_template: Dict[str, tuple]
    lookup_s: float         # pre-generated template lookup (the paper's win)
    restage_s: float        # merge live stage params + restage under new
    rebuild_s: float        # rebuild the FHDP step
    total_s: float          # lookup + restage + rebuild (the switch itself)
    refresh_s: float        # re-pregenerate preventive templates for the
    #                         shrunken fleet; synchronous here (the paper
    #                         overlaps it with training), so it also stalls
    #                         the loop but is NOT part of the switch time
    moved_bytes: float      # analytic diff the edge would redistribute
    params_identical: bool  # merged params bit-identical across the restage

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["old_template"] = {k: list(v) for k, v in self.old_template.items()}
        d["new_template"] = {k: list(v) for k, v in self.new_template.items()}
        return d


def fresh_zero2_opt(pp, mesh, *, fed_sgd: bool = True, step=None):
    """ZeRO-2 optimizer state for a freshly restaged param container on
    the mesh's device. Adam moments cannot survive a template change
    (their flat shards are laid out per stage), so they restart; the step
    counter is carried over to keep the bias-correction schedule."""
    from repro_torch.core import pipeline as pl

    D = mesh.shape.get("data", 1)
    opt = pl.zero2_init(pp, D, sharded=fed_sgd and D > 1,
                        pods=1 if fed_sgd else mesh.shape.get("pod", 1))
    if step is not None:
        opt["step"] = torch.as_tensor(step, dtype=torch.int32,
                                      device=opt["step"].device).clone()
    return opt


def _synced(device) -> float:
    """The host clock once ``device`` has finished its queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Repartitioner:
    """LoopHooks.repartition hook: simulated departures -> live restages.

    ``schedule`` maps step index -> departing vehicle id. The session's
    strategy must speak the SWIFT protocol (``swift_pipeline``): expose
    ``templates``, ``active_pipeline``, ``departure_template(vid)`` and
    ``adopt_departure(vid, pipe)``.
    """

    def __init__(self, session, schedule: Dict[int, int], *,
                 log_fn: Optional[Callable] = print):
        self.session = session
        self.schedule = {int(k): int(v) for k, v in schedule.items()}
        self.events: List[RepartitionEvent] = []
        self.log_fn = log_fn

    def __call__(self, step_idx: int, step_fn, params, opt_state
                 ) -> Optional[Tuple[Callable, Any, Any]]:
        vid = self.schedule.pop(step_idx, None)
        if vid is None:
            return None
        return self.depart(step_idx, vid, params, opt_state)

    def depart(self, step_idx: int, vid: int, params, opt_state
               ) -> Tuple[Callable, Any, Any]:
        """Execute the departure of ``vid`` against the live state."""
        from repro_torch.core import pipeline as pl
        from repro_torch.recovery.backup import restage
        from repro_torch.tree import leaves

        ses = self.session
        strat = ses.strategy
        dev = ses.mesh.device
        old_templates = {k: tuple(v) for k, v in strat.templates.items()}
        t0 = _synced(dev)
        new_templates, pipe = strat.departure_template(vid)
        lookup_s = time.perf_counter() - t0
        moved = redistribution_bytes(strat.active_pipeline, pipe)

        t1 = time.perf_counter()
        merged = pl.merge_stage_params(params, old_templates)
        pp2 = restage(merged, ses.cfg, new_templates, ses.mesh)
        opt2 = fresh_zero2_opt(pp2, ses.mesh, step=opt_state["step"]
                               if isinstance(opt_state, dict)
                               and "step" in opt_state else None)
        restage_s = _synced(dev) - t1

        t2 = time.perf_counter()
        step2 = ses.rebuild(templates=new_templates, state=(pp2, opt2))
        rebuild_s = _synced(dev) - t2
        t3 = time.perf_counter()
        strat.adopt_departure(vid, pipe)
        refresh_s = time.perf_counter() - t3

        merged2 = pl.merge_stage_params(pp2, new_templates)
        identical = all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(leaves(merged), leaves(merged2)))
        ev = RepartitionEvent(
            step=step_idx, vid=vid, old_template=old_templates,
            new_template={k: tuple(v) for k, v in new_templates.items()},
            lookup_s=lookup_s, restage_s=restage_s, rebuild_s=rebuild_s,
            total_s=lookup_s + restage_s + rebuild_s, refresh_s=refresh_s,
            moved_bytes=moved, params_identical=identical)
        self.events.append(ev)
        if self.log_fn is not None:
            self.log_fn(
                f"[repartition] step {step_idx}: vehicle {vid} departed — "
                f"template {ev.old_template} -> {ev.new_template} in "
                f"{ev.total_s * 1e3:.1f} ms (lookup {lookup_s * 1e3:.2f} ms, "
                f"restage {restage_s * 1e3:.1f} ms, rebuild "
                f"{rebuild_s * 1e3:.1f} ms; +{refresh_s * 1e3:.1f} ms "
                f"template refresh); params identical: {identical}")
        return step2, pp2, opt2


def run_failure_sequence(vehicles: Sequence[Vehicle], units: Sequence[Unit],
                         failures: Sequence, strategy: str,
                         cp: Optional[CostParams] = None,
                         agent=None) -> Dict:
    """Replay a failure trace; re-pregenerate templates after each accepted
    departure (the paper's concurrent template refresh)."""
    cp = cp or CostParams()
    alive = list(vehicles)
    templates = pregenerate(alive, units, cp, agent=agent)
    total_s, n_ok, n_fail = 0.0, 0, 0
    for ev in failures:
        if ev.vid not in [v.vid for v in alive]:
            continue
        out = recover(strategy, templates, ev.vid, alive, units, cp)
        if not out.ok:
            n_fail += 1
            continue
        total_s += out.seconds
        n_ok += 1
        if ev.kind == "departure":
            alive = [v for v in alive if v.vid != ev.vid]
            if len(alive) >= 2:
                try:
                    templates = pregenerate(alive, units, cp, agent=agent)
                except ValueError:
                    break
    return {"strategy": strategy, "recoveries": n_ok, "failed": n_fail,
            "total_recovery_s": total_s,
            "mean_recovery_s": total_s / max(n_ok, 1)}
