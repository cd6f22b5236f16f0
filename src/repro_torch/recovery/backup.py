"""Edge-aided backup (port of ``repro/recovery/backup.py``; paper §4.2):
the edge server (master) snapshots the merged model every ``interval``
steps; recovery restores from the latest snapshot and redeploys under a
(possibly different) stage template.

Snapshots live in host memory, the analogue of the edge server's disk:
every leaf is copied to the CPU (``.to("cpu", copy=True)``: on the CPU,
``.cpu()`` would hand back the live tensor itself), so later steps
cannot alias a snapshot. Works with the tensor strategy's flat params
and FHDP stage containers alike.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass
class Snapshot:
    step: int
    tree: Any
    wall_time: float


class EdgeBackup:
    def __init__(self, interval: int = 5):
        self.interval = interval
        self._latest: Optional[Snapshot] = None
        self.backups_taken = 0
        #: host seconds of each backup taken (the view and the copy,
        #: after the device finished the step)
        self.seconds: list = []

    def maybe_backup(self, step: int, params) -> bool:
        """``params`` may be a tree or a zero-arg thunk returning one —
        the thunk form defers (possibly expensive) snapshot-view work to
        the steps that actually back up."""
        if step % self.interval != 0:
            return False
        t0 = time.perf_counter()
        if callable(params):
            params = params()
        host = tree_map(lambda x: x.detach().to("cpu", copy=True), params)
        self._latest = Snapshot(step, host, time.time())
        self.backups_taken += 1
        self.seconds.append(time.perf_counter() - t0)
        return True

    @property
    def latest(self) -> Optional[Snapshot]:
        return self._latest

    def restore(self):
        """(a copy of the latest snapshot's tree, its step)."""
        if self._latest is None:
            raise RuntimeError("no backup available")
        return tree_map(torch.clone, self._latest.tree), self._latest.step


def restage(merged_params, cfg, new_templates, mesh):
    """Re-deploy a merged (backup) model under a new stage template on
    the mesh's device — recovery's 'deploy pre-generated template' step
    for the FHDP runtime."""
    from repro_torch.core import pipeline as pl
    return pl.stage_params_from(
        tree_map(lambda x: x.to(mesh.device), merged_params), cfg,
        new_templates)
