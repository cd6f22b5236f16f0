"""Federated personalized distillation (port of
``repro/distill/federated.py``; paper §3.3/§5.2 as a strategy).

The cloud AD-LLM is warmed once on public (IID) driving data and then
frozen as the **teacher**; each vehicle trains a LoRA **student** — the
same base weights plus per-pod (A, B) factors — on its pod's non-IID
partition. The student loss is

    L = L1(student_wp, ground truth)
      + kd_weight * ( L1(student_wp, teacher_wp)
                      + logit_weight * KL(teacher || student) @ kd_temp )

The student forward never forms merged weights: every adapted projection
runs the fused base + low-rank kernel (``ops.lora_matmul_ad``) through
``lm.forward(lora=...)``, and only factor deltas ride the comm fabric —
codec roundtrips with error feedback, per-pod edge partial averages, a
staleness-aware cloud merge. Each round ends with

    pod_adapter' = (1 - mix) * (pod_adapter + pod_delta)
                 + mix * cloud_merge(all pods)

so ``mix=1`` is global FedAvg of adapters and ``mix=0`` fully local
per-pod training. Where the reference ``vmap``s the students, the port
runs the clients one after another (``core.fedavg.map_clients``). The
base is never differentiated: it is handed over as tensors that need no
grad, so autograd forms no dW and only the factors' grads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.comm.codecs import BitsSource, Codec, roundtrip_stacked
from repro_torch.comm.hierarchy import (cloud_merge, edge_aggregate,
                                        pod_broadcast, pod_slice)
from repro_torch.comm.topology import Topology
from repro_torch.config import ModelConfig
from repro_torch.distill.celladapt import waypoint_l1
from repro_torch.distill.lora import LoRAConfig
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.train.optimizer import Adam
from repro_torch.tree import flatten, tree_map, unflatten


def _hidden(params, cfg: ModelConfig, batch, *, lora=None,
            lora_scale: float = 1.0):
    h, _, _ = lm.forward(params, cfg, batch["tokens"],
                         prefix_embeds=batch["features"], hidden_only=True,
                         lora=lora, lora_scale=lora_scale)
    return h


def _waypoints(params, cfg: ModelConfig, h):
    wp = B.linear(params["wp_head"], h[:, -1]).float()
    return wp.reshape(h.shape[0], cfg.num_waypoints, 2)


def make_student_loss(acfg: ModelConfig, lora_cfg: LoRAConfig, *,
                      kd_weight: float = 0.3, kd_temp: float = 2.0,
                      logit_weight: float = 0.1):
    """loss(factors, base, batch) -> (loss, metrics) for one LoRA student.

    Only ``factors`` is differentiated; ``base`` is both the student's
    frozen backbone and — run without the adapter, under no_grad (the
    reference's stop_gradient) — the teacher. The KL runs over the whole
    vocabulary in float32."""

    def loss_fn(factors, base, batch):
        h = _hidden(base, acfg, batch, lora=factors,
                    lora_scale=lora_cfg.scale)
        s_wp = _waypoints(base, acfg, h)
        task = waypoint_l1(s_wp, batch["waypoints"])
        with torch.no_grad():
            th = _hidden(base, acfg, batch)
            t_wp = _waypoints(base, acfg, th)
            gt = torch.log_softmax(lm.logits_of(base, acfg, th) / kd_temp,
                                   dim=-1)
        align = waypoint_l1(s_wp, t_wp)
        at = torch.log_softmax(lm.logits_of(base, acfg, h) / kd_temp,
                               dim=-1)
        kl = (gt.exp() * (gt - at)).sum(-1).mean() * kd_temp * kd_temp
        loss = task + kd_weight * (align + logit_weight * kl)
        return loss, {"loss": loss, "task_l1": task, "kd_l1": align,
                      "kd_kl": kl}

    return loss_fn


def _frozen(base):
    """Views of the base that need no grad (an LM's parameters do)."""
    if isinstance(base, lm.ParamTree):
        base = base.to_dict()
    return tree_map(lambda t: t.detach(), base)


def make_student_step(loss_fn, optimizer: Adam):
    """step(factors, opt_state, batch, base) -> (factors', opt_state',
    metrics): one local step of a student."""

    def step(factors, opt_state, batch, base):
        flat, spec = flatten(factors)
        live = [f.detach().requires_grad_(True) for f in flat]
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(spec, live), base, batch)
            grads = torch.autograd.grad(loss, live)
        factors, opt_state = optimizer.update(
            unflatten(spec, list(grads)), opt_state,
            unflatten(spec, [f.detach() for f in flat]))
        return factors, opt_state, {k: v.detach() for k, v in
                                    metrics.items()}

    return step


def make_distill_round(acfg: ModelConfig, optimizer: Adam,
                       topology: Topology, codec: Codec, *,
                       lora_cfg: LoRAConfig, kd_weight: float = 0.3,
                       kd_temp: float = 2.0, logit_weight: float = 0.1,
                       mix: float = 0.5,
                       client_weights=None,
                       staleness: Optional[np.ndarray] = None):
    """One federated-distillation round over client-stacked LoRA factors.

    distill_round(client_factors, client_opt, batches, base, residual,
    bits) -> (client_factors', client_opt', metrics, residual').

    ``batches`` carry [C, E, B, ...] leaves (``features``, ``tokens``,
    ``waypoints``); ``base`` is the frozen teacher/backbone shared by all
    students; ``residual`` is the codec's per-client error-feedback state
    over the **factor** tree and ``bits`` its source of random words
    (:func:`repro_torch.comm.codecs.roundtrip_stacked`). Pod members start
    each round from their pod's shared adapter, so client deltas are
    w.r.t. their own pod; ``pod_slice``/``pod_broadcast`` carry the
    per-pod state across the round and ``cloud_merge`` supplies the
    ``mix`` share of global structure. The local steps are the leading
    step axis [E] of ``batches``."""
    from repro_torch.core.fedavg import (check_weights, make_local_train,
                                         map_clients)

    step = make_student_step(
        make_student_loss(acfg, lora_cfg, kd_weight=kd_weight,
                          kd_temp=kd_temp, logit_weight=logit_weight),
        optimizer)
    w = None if client_weights is None else check_weights(client_weights)
    if w is not None:
        topology.validate_pod_weights(w.numpy())
    if not 0.0 <= mix <= 1.0:
        raise ValueError(f"mix must be in [0, 1], got {mix}")

    def distill_round(client_factors, client_opt, batches, base, residual,
                      bits: Optional[BitsSource] = None):
        base = _frozen(base)
        start = client_factors
        local_train = make_local_train(
            lambda f, o, b: step(f, o, b, base))
        factors, opts, metrics = map_clients(local_train, client_factors,
                                             client_opt, batches)
        # adapter-only uplink: factor deltas w.r.t. the round's pod state
        deltas = tree_map(lambda a, s: a.float() - s.float(), factors,
                          start)
        decoded, residual = roundtrip_stacked(codec, deltas, residual, bits)
        edge_delta, edge_w = edge_aggregate(decoded, w, topology,
                                            validated=True)
        pod_partial = tree_map(lambda s, d: s.float() + d,
                               pod_slice(start, topology), edge_delta)
        global_f = cloud_merge(pod_partial, edge_w, staleness)
        pod_new = tree_map(lambda p, g: (1.0 - mix) * p + mix * g[None],
                           pod_partial, global_f)
        return (pod_broadcast(pod_new, topology), opts, metrics, residual)

    return distill_round


def warmup_base(params, acfg: ModelConfig, batches, *, lr: float = 1e-3):
    """Supervised waypoint warmup of the whole AD-LLM on pooled public
    data — the cloud stage that trains ``wp_head`` (and settles the
    backbone) before it freezes as the distillation teacher. ``batches``:
    dicts of tensors on the params' device. Returns (params, per-step
    losses); the params need no grad."""
    opt = Adam(lr=lr)
    flat, spec = flatten(_frozen(params))
    state = opt.init(unflatten(spec, flat))
    losses = []
    for batch in batches:
        live = [t.detach().requires_grad_(True) for t in flat]
        with torch.enable_grad():
            tree = unflatten(spec, live)
            loss = waypoint_l1(_waypoints(tree, acfg,
                                          _hidden(tree, acfg, batch)),
                               batch["waypoints"])
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss never reads (the LM head) gets a zero grad, as
        # in the reference, and so no update
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        new, state = opt.update(unflatten(spec, grads), state,
                                unflatten(spec, flat))
        flat = flatten(new)[0]
        losses.append(float(loss.detach()))
    return unflatten(spec, flat), losses


@torch.no_grad()
def greedy_agreement(target, draft, cfg: ModelConfig, tokens, *,
                     draft_lora=None, lora_scale: float = 1.0) -> float:
    """Teacher-forced greedy next-token agreement of ``draft`` with
    ``target`` over ``tokens`` [B, S] — the analytical predictor of
    speculative-decode acceptance.

    Both models see the same ground-truth prefixes, so a position counts
    as agreeing iff the draft's greedy token equals the target's at that
    prefix — exactly the event the serving tier's greedy exact-match
    verifier accepts. ``draft_lora`` runs the draft as base + factors
    through the fused kernel (no merged weights); otherwise ``draft`` is
    a full param tree."""
    dev = target["embed"]["table"].device
    toks = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)
    tl, _, _ = lm.forward(target, cfg, toks)
    dl, _, _ = lm.forward(draft, cfg, toks, lora=draft_lora,
                          lora_scale=lora_scale)
    return float((tl.argmax(-1) == dl.argmax(-1)).float().mean())


def waypoint_eval(base, acfg: ModelConfig, data, *, lora=None,
                  lora_scale: float = 1.0) -> float:
    """Mean waypoint L1 of (base [+ adapter]) over a held-out dataset of
    numpy arrays."""
    base = _frozen(base)
    dev = flatten(base)[0][0].device
    batch = {k: torch.as_tensor(np.array(data[k]), device=dev)
             for k in ("features", "tokens", "waypoints")}
    with torch.no_grad():
        h = _hidden(base, acfg, batch, lora=lora, lora_scale=lora_scale)
        return float(waypoint_l1(_waypoints(base, acfg, h),
                                 batch["waypoints"]))
