"""Parameters across the two packages, through numpy.

:func:`params_from_numpy` turns the reference's parameter tree — nested
dicts of arrays as ``repro.models.lm.init`` builds them, handed over as
numpy arrays — into the port's :class:`repro_torch.models.lm.LM`, and
:func:`params_to_numpy` goes back. :func:`tree_from_numpy` and
:func:`tree_to_numpy` do the same for any nested dict, client-stacked
[C, ...] trees included, and :func:`fl_state_from_numpy` turns an FL
strategy's state — client-stacked params and Adam state — into the
port's. This is how both packages compute on the same weights in the
tests. The xLSTM's parameters and decode states (``repro.models.xlstm``'s
[n_super, k, ...]-stacked trees) cross through :func:`tree_from_numpy`
and :func:`tree_to_numpy` as they are, each leaf keeping its dtype: the
mLSTM gates and the sLSTM's weights are float32 beside bfloat16 ones.

LoRA factor trees cross too. The reference's factor tree (and the Adam
moments over it) has the params' structure with None at every leaf that
is not adapted; the port's holds the adapted leaves only, so
:func:`tree_from_numpy` drops None leaves and the dicts they leave
empty, and :func:`factors_to_reference` puts them back. The AD-LLM's
params (``projector``, ``wp_head``) are ordinary nested dicts.

The FHDP pipeline's stage container (``{"shared", "stacks", "masks"}``)
crosses through :func:`tree_from_numpy` and :func:`tree_to_numpy` too,
its bool masks included; its ZeRO-2 Adam state crosses through
:func:`zero2_from_numpy` and :func:`zero2_to_numpy`, in the reference's
global layouts (stacks ``[S, D, n]``, the rest ``[D, n]``). Where each
(pod, data) column keeps its own moments (local steps on a mesh with
pods) the port holds all ``pods * D`` columns on that axis; the
reference holds pod p's on pod p's devices and shows pod 0's.

The SWIFT scheduler's Q-net (the reference's ``DoubleDQN.online`` and
``.target``, dicts of float32 arrays) crosses through
:func:`dqn_from_numpy` and :func:`dqn_to_numpy`, so both packages' agents
start from the same weights.

bfloat16 crosses as its raw 16-bit words: numpy has no bfloat16 of its
own (JAX's arrays come out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses), so a bfloat16 leaf goes in through
an int16 view and comes back as a ``uint16`` array of the same bits —
``arr.view(ml_dtypes.bfloat16)`` restores the reference's dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import AdamState
from repro_torch.tree import tree_map


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def tree_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays (any leading axes) as torch tensors
    on ``device``; every leaf is copied. None leaves, and dicts left
    empty without them, are dropped (a reference LoRA factor tree)."""
    if isinstance(tree, dict):
        out = {k: tree_from_numpy(v, device) for k, v in tree.items()
               if v is not None}
        return {k: v for k, v in out.items() if not isinstance(v, dict) or v}
    return _leaf_to_torch(tree, torch.device(device))


def fl_state_from_numpy(client_params: dict, step, m: dict, v: dict,
                        device="cuda"):
    """An FL round strategy's state from the reference's, as numpy:
    client-stacked params and the stacked ``AdamState(step [C], m, v)``
    -> (client_params, AdamState) of torch tensors on ``device``."""
    return (tree_from_numpy(client_params, device),
            AdamState(_leaf_to_torch(step, torch.device(device)),
                      tree_from_numpy(m, device), tree_from_numpy(v, device)))


def zero2_from_numpy(opt: dict, device="cuda", *, pods: int = 1) -> dict:
    """The reference's FHDP Adam state ``{"step", "m", "v"}`` (numpy) as
    the port's; ``pods`` > 1 gives every pod the moments the reference
    shows (pod 0's), for state whose moments are whole per column."""
    def widen(x):
        x = np.asarray(x)
        return np.concatenate([x] * pods, axis=-2) if pods > 1 else x

    return {"step": _leaf_to_torch(opt["step"], torch.device(device)),
            "m": tree_from_numpy(tree_map(widen, opt["m"]), device),
            "v": tree_from_numpy(tree_map(widen, opt["v"]), device)}


def zero2_to_numpy(opt: dict, data_size: int) -> dict:
    """The port's FHDP Adam state as the reference's arrays read back:
    the first ``data_size`` columns (pod 0's) of each moment."""
    cut = lambda x: x[..., :data_size, :]                 # noqa: E731
    return {"step": tree_to_numpy(opt["step"]),
            "m": tree_map(cut, tree_to_numpy(opt["m"])),
            "v": tree_map(cut, tree_to_numpy(opt["v"]))}


def params_from_numpy(tree: dict, device="cuda", *,
                      cfg: Optional[ModelConfig] = None) -> LM:
    """The reference's parameter tree (numpy leaves) as the port's module
    on ``device``; every leaf is copied, never shared with the array.
    ``cfg`` is only needed to call the module itself."""
    return LM(cfg, tree_from_numpy(tree, device))


def tree_to_numpy(tree):
    """A nested dict of tensors as numpy arrays (bfloat16 leaves as their
    ``uint16`` bit patterns)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def factors_to_reference(factors: dict, params: dict):
    """A port factor tree as the reference's: the structure of
    ``params`` (a nested dict, of any leaves), with the factor dict
    {"A", "B"} as numpy where the port has one and None elsewhere."""
    out = {}
    for k, v in params.items():
        f = factors.get(k) if isinstance(factors, dict) else None
        if isinstance(f, dict) and "A" in f:
            out[k] = tree_to_numpy(f)
        elif isinstance(v, dict):
            out[k] = factors_to_reference(f or {}, v)
        else:
            out[k] = None
    return out


def params_to_numpy(module: LM) -> dict:
    """The port's parameters as the reference's nested dict of numpy
    arrays (bfloat16 leaves as their ``uint16`` bit patterns)."""
    return tree_to_numpy(module.to_dict())


def dqn_from_numpy(agent, online: dict, target: Optional[dict] = None):
    """Give the port's :class:`repro_torch.sched.dqn.DoubleDQN` the
    reference agent's Q-net params (numpy; ``target`` defaults to a copy
    of ``online``) on the agent's device; its Adam state restarts, as a
    fresh agent's. Returns the agent."""
    agent.set_params(tree_from_numpy(online, agent.device),
                     None if target is None
                     else tree_from_numpy(target, agent.device))
    return agent


def dqn_to_numpy(agent):
    """(online, target) Q-net params of the port's agent as the
    reference's dicts of numpy arrays."""
    return tree_to_numpy(agent.online), tree_to_numpy(agent.target)
