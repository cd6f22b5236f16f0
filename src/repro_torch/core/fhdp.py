"""FHDP = FL (over data/pod) x pipeline (over model): state and rounds
(port of ``repro/core/fhdp.py``).

  * :func:`init_fhdp` — stage-stacked params and ZeRO-2 Adam state on the
    mesh's device;
  * :func:`make_fl_pipeline_round` — E local pipelined steps per FL
    client column with no cross-column sync, then hierarchical FedAvg
    (vehicle -> edge -> cloud, paper Fig. 1).

The reference's ``build_pipeline_lowered`` (the dry-run lowering) comes
with the dry-run slice of the port.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.common import effective_window
from repro_torch.core import pipeline as pl


def init_fhdp(cfg: ModelConfig, mesh, seed: int = 0, *,
              templates: Optional[Dict] = None, fed_sgd: bool = True):
    """(pp, opt, templates): the model's params from ``seed`` in the
    pipeline layout, and its Adam moments (ZeRO-2 over ``data`` with
    ``fed_sgd``, whole per column without), on ``mesh.device``."""
    from repro_torch.models.registry import build_model
    S = mesh.shape["model"]
    D = mesh.shape.get("data", 1)
    templates = templates or pl.make_templates(cfg, S)
    params = build_model(cfg).init(seed=seed, device=mesh.device)
    pp = pl.stage_params_from(params, cfg, templates)
    opt = pl.zero2_init(pp, D, sharded=fed_sgd and D > 1,
                        pods=1 if fed_sgd else mesh.shape.get("pod", 1))
    return pp, opt, templates


def make_fl_pipeline_round(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                           local_steps: int = 1,
                           templates: Optional[Dict] = None,
                           learning_rate: float = 3e-4,
                           remat: bool = True,
                           microbatches: Optional[int] = None):
    """One FedAvg round of FHDP: each data column (FL client cluster) runs
    pipelined local steps on its own rows of each batch with no
    cross-column traffic, then the params are averaged over the columns
    (edge = ``data``, cloud = ``pod``). ``fl_round(pp, opt, batches)``
    takes batches with a leading local-step axis [E, B, ...] (E sets the
    step count, as in the reference) and returns (pp, opt, the last
    step's metrics)."""
    window = effective_window(cfg, shape)
    step, h = pl.make_fhdp_train_step(
        cfg, shape, mesh, remat=remat, window=window, fed_sgd=False,
        learning_rate=learning_rate, microbatches=microbatches,
        templates=templates)

    def fl_round(pp, opt, batches):
        cols = pl.column_params(pp, mesh)
        metrics = None
        steps = next(iter(batches.values())).shape[0]
        for e in range(steps):
            cols, opt, metrics = step(
                cols, opt, {k: v[e] for k, v in batches.items()})
        return pl.fedavg_stage_params(cols, mesh), opt, metrics

    return fl_round, h
