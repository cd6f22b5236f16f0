"""xLSTM stack (sLSTM + mLSTM blocks), arXiv:2405.04517 (port of
``repro/models/xlstm.py``).

Layout: ``slstm_every``-sized super-blocks, each (slstm_every - 1) mLSTM
blocks followed by one sLSTM block (the xLSTM[7:1] pattern for
slstm_every=8). Parameters and states are stacked [n_super, k, ...] as in
the reference; where it scans them with ``lax.scan``, :func:`forward`
walks per-layer views with Python loops (as :func:`repro_torch.models.lm
.forward` does).

Training (no states given, grad enabled) recomputes every mLSTM and sLSTM
layer in the backward pass (``torch.utils.checkpoint``), as the
reference's sequence form remats each mLSTM layer and the sLSTM's chunks
whatever its ``remat`` says: one layer's saved chunk states (128 MiB at
xlstm-350m's training shape, B 4, S 512) are alive at a time, not 21
layers'. It keeps no recurrent states; the reference's loss discards
them too.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models.lm import ParamTree, layer


def _layout(cfg: ModelConfig):
    k = cfg.ssm.slstm_every or cfg.num_layers
    assert cfg.num_layers % k == 0, (cfg.num_layers, k)
    return cfg.num_layers // k, k - 1   # (n_super, mlstm_per_super)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the reference draws from a JAX key; tests bridge one tree
    instead). As in the reference, a super-block holds at least one mLSTM
    layer's parameters even when ``slstm_every`` is 1."""
    n_super, n_m = _layout(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return ParamTree({
        "embed": B.init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                                  device),
        "mlstm": R.init_mlstm(gen, cfg, device, lead=(n_super, max(n_m, 1))),
        "slstm": R.init_slstm(gen, cfg, device, lead=(n_super,)),
        "ln_f": B.init_rmsnorm(cfg.d_model, cfg.dtype, device),
        "head": B.init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                              device),
    })


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes, on the ``meta`` device."""
    return init(cfg, device="meta").to_dict()


def _stack(one: dict, reps) -> dict:
    return {k: v.expand(tuple(reps) + v.shape).clone() for k, v in one.items()}


def init_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    n_super, n_m = _layout(cfg)
    return {"mlstm": _stack(R.init_mlstm_state(cfg, batch, device),
                            (n_super, max(n_m, 1))),
            "slstm": _stack(R.init_slstm_state(cfg, batch, device),
                            (n_super,))}


def _store(views: dict, new: dict) -> None:
    for k, v in new.items():
        views[k].copy_(v)


def _super_block(params, x, cfg: ModelConfig, states, step: bool):
    """One super-block: its mLSTM layers, then its sLSTM layer. ``params``
    and ``states`` are this super-block's (mLSTM stacked [k, ...]); the
    new states are written into ``states`` in place."""
    mp, sp = params
    ms, ss = states
    for j in range(next(iter(ms.values())).shape[0]):
        lp, lst = layer(mp, j), layer(ms, j)
        if step:
            y, nst = R.apply_mlstm_step(lp, x, lst, cfg)
        else:
            y, nst = R.apply_mlstm_seq(lp, x, cfg, state=lst)
        x = x + y
        _store(lst, nst)
    if step:
        y, nst = R.apply_slstm_step(sp, x, ss, cfg)
    else:
        y, nst = R.apply_slstm_seq(sp, x, cfg, state=ss)
    _store(ss, nst)
    return x + y


def _mlstm_layer(lp, x, cfg: ModelConfig):
    return x + R.apply_mlstm_seq(lp, x, cfg)[0]


def _slstm_layer(sp, x, cfg: ModelConfig):
    return x + R.apply_slstm_seq(sp, x, cfg)[0]


def train_mlstm_unit(mp, x, cfg: ModelConfig):
    """One super-block's mLSTM layers ([k, ...] stacked) from fresh
    states, each layer checkpointed; no state is kept. The FHDP step's
    ssm units are this and :func:`train_slstm_unit`."""
    for j in range(next(iter(mp.values())).shape[0]):
        x = checkpoint(_mlstm_layer, layer(mp, j), x, cfg,
                       use_reentrant=False)
    return x


def train_slstm_unit(sp, x, cfg: ModelConfig):
    """One super-block's sLSTM layer from a fresh state, checkpointed."""
    return checkpoint(_slstm_layer, sp, x, cfg, use_reentrant=False)


def forward(params, cfg: ModelConfig, tokens, *, states=None, step=False,
            logits_slice=None, hidden_only=False):
    """tokens: [B, S] int. Returns (logits [B, S, V] float32 — or the
    final-norm hidden states with ``hidden_only`` — , states, aux).

    ``states`` (from :func:`init_state`; fresh ones when None) are
    updated IN PLACE and returned — the reference returns new ones.
    ``step`` runs each cell's one-token decode step (S = 1) instead of
    its sequence form. ``aux`` is a zero, for the reference's signature.
    ``params`` may be the module or its nested dict.

    With no ``states`` and grad enabled (training) every layer is
    checkpointed and the returned states are None. The reference's
    ``remat`` adds a super-block checkpoint on top of that; the per-layer
    one already holds one layer's activations at a time, and nesting
    would run each layer's forward a third time, so the port has no such
    flag."""
    x = B.embed(params["embed"], tokens)
    train = states is None and not step and torch.is_grad_enabled()
    if states is None and not train:
        states = init_state(cfg, tokens.shape[0], x.device)
    n_super, _ = _layout(cfg)
    for s in range(n_super):
        blocks = (layer(params["mlstm"], s), layer(params["slstm"], s))
        if train:
            x = train_slstm_unit(blocks[1],
                                 train_mlstm_unit(blocks[0], x, cfg), cfg)
            continue
        x = _super_block(
            blocks, x, cfg,
            (layer(states["mlstm"], s), layer(states["slstm"], s)), step)
    x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hidden_only:
        return x, states, aux
    return B.linear(params["head"], x).float(), states, aux
