"""Dwell-time prediction (paper §4.1.1; port of ``repro/sched/dwell.py``):
MAPE regression over route features with a wide-and-deep-recurrent
(WDR) regressor.

The paper cites the WDR travel-time architecture [32]: a wide (linear)
path over the route's cells, a deep MLP path over its end cells and
speed, and a recurrent (GRU) path over the cell sequence. Loss:
min_R sum |a_i - R(b_i)| / a_i + Omega(R).

:class:`WDR` holds the reference's parameter dict as ``nn.Parameter``s
under the same names; :func:`wdr_forward` and :func:`mape_loss` are
functions of such a dict, so the reference's params bridged in
(:func:`repro_torch.bridge.wdr_from_numpy`) compute what the reference
computes. The GRU keeps the reference's
cell as written: its reset gate is computed and multiplied by zero, so
the candidate is ``tanh(c)``. :func:`train_dwell_model` trains with the
port's Adam (lr 1e-2, clip 1.0) as the reference does; its initial
weights come from a ``torch.Generator``, so they differ from the
reference's unless bridged in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.train.optimizer import Adam
from repro_torch.tree import leaves

#: the reference's parameter names, in its (sorted) flatten order
PARAM_NAMES = ("cell_emb", "deep_b1", "deep_b2", "deep_w1", "deep_w2",
               "gru_b", "gru_wh", "gru_wx", "out_b", "out_w", "wide_w")


@dataclasses.dataclass(frozen=True)
class WDRConfig:
    n_cells: int
    route_len: int
    emb: int = 16
    hidden: int = 32
    l2: float = 1e-4


def init_wdr(cfg: WDRConfig, seed: int = 0, device="cuda"
             ) -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales, drawn from a torch generator."""
    gen = torch.Generator().manual_seed(seed)
    e, h = cfg.emb, cfg.hidden

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    p = {
        "cell_emb": normal(cfg.n_cells, e) * 0.1,
        "wide_w": torch.zeros((cfg.n_cells,)),
        "deep_w1": normal(e * 2 + 2, h) * (e * 2 + 2) ** -0.5,
        "deep_b1": torch.zeros((h,)),
        "deep_w2": normal(h, h) * h ** -0.5,
        "deep_b2": torch.zeros((h,)),
        "gru_wx": normal(e, 3 * h) * e ** -0.5,
        "gru_wh": normal(h, 3 * h) * h ** -0.5,
        "gru_b": torch.zeros((3 * h,)),
        "out_w": normal(2 * h + 1, 1) * 0.1,
        "out_b": torch.zeros((1,)),
    }
    return {k: v.to(device) for k, v in p.items()}


def _gru(p, xs: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """xs: [L, B, e] -> the last hidden state [B, h]."""
    for x in xs:
        z = x @ p["gru_wx"] + h @ p["gru_wh"] + p["gru_b"]
        r, u, c = torch.chunk(z, 3, dim=-1)
        r, u = torch.sigmoid(r), torch.sigmoid(u)
        cand = torch.tanh(c + r * 0)
        h = (1 - u) * h + u * cand
    return h


def wdr_forward(p, routes: torch.Tensor, speeds: torch.Tensor
                ) -> torch.Tensor:
    """routes: [B, L] int cell ids; speeds: [B] average speed. Returns the
    predicted dwell [B] (softplus: positive)."""
    routes = routes.long()
    emb = p["cell_emb"][routes]                       # [B, L, e]
    wide = p["wide_w"][routes].sum(dim=1)             # [B]
    deep_in = torch.cat([emb[:, 0], emb[:, -1], speeds[:, None],
                         torch.ones_like(speeds)[:, None]], dim=-1)
    deep = torch.relu(deep_in @ p["deep_w1"] + p["deep_b1"])
    deep = torch.relu(deep @ p["deep_w2"] + p["deep_b2"])
    h0 = torch.zeros((routes.shape[0], p["gru_wh"].shape[0]),
                     dtype=emb.dtype, device=emb.device)
    rec = _gru(p, emb.transpose(0, 1), h0)
    feats = torch.cat([deep, rec, wide[:, None]], dim=-1)
    z = feats @ p["out_w"] + p["out_b"]
    return torch.logaddexp(z, torch.zeros_like(z))[:, 0]   # softplus


def mape_loss(p, routes, speeds, dwell, l2: float = 1e-4):
    """(MAPE + l2 * sum of squares over the params in flatten order,
    predictions)."""
    pred = wdr_forward(p, routes, speeds)
    mape = torch.mean(torch.abs(dwell - pred)
                      / torch.clamp(dwell, min=1e-3))
    reg = 0
    for w in leaves(dict(p)):
        reg = reg + torch.sum(w ** 2)
    return mape + l2 * reg, pred


class WDR(nn.Module):
    """The WDR regressor: the reference's parameter dict as
    ``nn.Parameter``s of the same names."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        missing = set(PARAM_NAMES) ^ set(params)
        if missing:
            raise ValueError(f"WDR params differ from the reference's "
                             f"names by {sorted(missing)}")
        for k in PARAM_NAMES:
            self.register_parameter(k, nn.Parameter(params[k].detach()
                                                    .clone()))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.params().items()}

    def forward(self, routes, speeds):
        return wdr_forward(self.params(), routes, speeds)


def synthetic_dwell_data(world, n: int, route_len: int, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Routes from the DTMC + ground-truth dwell = f(route length in
    cells, speed) + noise — the 'historical edge server data' of §4.1.1
    (numpy: the reference's draws exactly)."""
    from repro_torch.sched.mobility import sample_trajectory
    rng = np.random.default_rng(seed)
    K = world.patterns.shape[0]
    routes = np.zeros((n, route_len), np.int32)
    speeds = np.zeros(n, np.float32)
    dwell = np.zeros(n, np.float32)
    for i in range(n):
        k = rng.integers(K)
        start = rng.integers(world.n_cells)
        traj = sample_trajectory(world, k, start, route_len - 1, rng)
        routes[i] = traj
        speed = rng.uniform(0.5, 1.5)
        speeds[i] = speed
        path_cells = len(np.unique(traj))
        dwell[i] = (path_cells * 2.0 / speed) * rng.uniform(0.9, 1.1)
    return routes, speeds, dwell


def fit_dwell(params: Dict[str, torch.Tensor], routes, speeds, dwell, *,
              steps: int, opt: Optional[Adam] = None
              ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """``steps`` Adam steps on the MAPE loss from ``params``; returns the
    new params and each step's loss (before its update), as the
    reference's jitted step reports it."""
    opt = opt or Adam(lr=1e-2, grad_clip=1.0)
    params = {k: v.detach() for k, v in params.items()}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        loss, _ = mape_loss(p, routes, speeds, dwell)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        params, state = opt.update(grads, state,
                                   {k: v.detach() for k, v in p.items()})
        losses.append(float(loss.detach()))
    return params, losses


def train_dwell_model(world, *, route_len: int = 12, n_train: int = 512,
                      steps: int = 300, seed: int = 0, params=None,
                      device="cuda"):
    """Fit the WDR regressor; returns (WDR module, predict_fn,
    final MAPE loss). ``params``: initial weights (a dict of tensors or
    numpy arrays, e.g. the reference's), else :func:`init_wdr`."""
    cfg = WDRConfig(n_cells=world.n_cells, route_len=route_len)
    if params is None:
        params = init_wdr(cfg, seed, device)
    else:
        params = {k: v.to(device) if isinstance(v, torch.Tensor)
                  else torch.tensor(np.asarray(v), device=device)
                  for k, v in params.items()}
    routes, speeds, dwell = synthetic_dwell_data(world, n_train, route_len,
                                                 seed)
    routes, speeds, dwell = (torch.as_tensor(x, device=device)
                             for x in (routes, speeds, dwell))
    params, losses = fit_dwell(params, routes, speeds, dwell, steps=steps)
    model = WDR(params)

    def predict(routes_, speeds_):
        with torch.no_grad():
            return model(torch.as_tensor(routes_, device=device),
                         torch.as_tensor(speeds_, device=device))

    return model, predict, losses[-1] if losses else float("inf")
