"""FHDP intra-cluster pipeline parallelism on one card (port of
``repro/core/pipeline.py``; paper §4, Fig. 3).

The ``model`` mesh axis holds the pipeline stages of one vehicle
cluster; ``data`` (and ``pod``) hold the FL client columns. The
reference runs a GPipe microbatch schedule as one ``lax.scan`` over
ticks inside ``shard_map``, one device a rank. The port keeps its layout
and its arithmetic and runs every rank on one device
(:class:`repro_torch.api.mesh.Mesh`), rank after rank, in one process:

* **Collectives become tensor operations.** ``ppermute`` along the stage
  ring hands stage s's output to stage s + 1: here the output is passed
  on as the next stage's input; the ``all_gather`` of the ranks'
  embeddings is a ``cat``; the ``psum`` of the final-stage activations
  and of the loss over ``model`` is a sum over the microbatches; the
  ``pmean`` over the FL axes (the loss, and :func:`fedavg_stage_params`)
  is a mean over the columns.
* **No tick schedule; the bubbles are skipped.** Each microbatch whose
  loss the reference keeps runs through stages 0 .. S - 1 in turn, one
  microbatch after another. A microbatch's chain of stages depends on no
  other microbatch, so the reference's ticks only order the same calls.
  The reference also runs the fill and drain ticks, on zeros or on
  re-feeds of the last microbatch, and throws the results away:
  ``fins[S-1:]`` drops the last stage's outputs before tick S - 1, and
  rank 0's re-feeds after tick M - 1 reach the last stage only after
  tick T - 1. Nothing of them reaches the loss, so skipping them changes
  no value and no gradient.
* **The gradient keeps the reference's scale.** Under ``shard_map``
  without replication checks the transpose of each ``psum`` is a
  ``psum``, so the reference's Adam sees the gradient of the mean loss
  times pod x data^2 x model (FedSGD) or times model (local steps); the
  port multiplies by the same factors (see ``make_fhdp_train_step``), so
  that its moments equal the reference's and optimizer state can cross
  between the packages.
* **Per-layer remat** is ``torch.utils.checkpoint`` with
  ``use_reentrant=False`` (the reference's ``jax.checkpoint`` with
  nothing saveable).

A later multi-GPU slice can swap the plain operations for
``torch.distributed`` collectives behind the same functions; nothing
here forms a process group.

Paper-faithful elements, as in the reference: every rank embeds its own
share of the column batch and only the embeddings reach the pipeline
head; unequal stage templates stack layers to ``[S, Lmax, ...]`` with a
validity mask; :func:`rotate_stages` rolls stage ownership around the
ring. Optimizer state is ZeRO-2: the flat Adam moments of each leaf are
split over ``data`` when gradients are synchronized every step.

**The ssm family runs in the flat model's order.** An xLSTM's units
are its super-blocks' mLSTM layers (one unit a super-block) and its
sLSTM layers; the reference's adapter lays them out stack after stack
(every mLSTM unit, then every sLSTM unit), so with two super-blocks or
more its FHDP step computes m0 m1 .. s0 s1 .. where ``xlstm.forward``
computes m0 s0 m1 s1 ... The port keeps the reference's two stacks and
unit counts, and SWIFT's flat per-stage count sequence, but lays the
sequence out as the flat model runs it (:attr:`FamilyAdapter.unit_order`)
and applies each stage's units in that order (:func:`stage_plan`), so
the FHDP step trains the network the flat model serves. With one
super-block both orders agree.

**The carried activation.** Between stages the step carries what the
family's ``embed`` makes: one tensor [b, s, d] for the decoder, xLSTM,
Hymba and vision families; for the encoder-decoder a dict of the encoder
stream ``enc`` and the decoder stream ``dec`` (the reference's dict,
without its zero ``mem`` and ``enc_done`` flag: the first decoder unit
freezes ``enc_ln(enc)`` as ``mem`` and drops ``enc``, and later units
find ``mem`` in the dict). The rows of a microbatch and the ranks' cat
act on every leaf; each stream takes its own positions and rope tables;
a block gets the shared params too.

Stage container (:func:`stage_params_from`): ``{"shared": params outside
the stacks, "stacks": {name: [S, Lmax, ...]}, "masks": {name: [S,
Lmax]}}``. With local steps (``fed_sgd=False``) the columns' params
diverge within a round, so the step takes and returns a column-stacked
container (:func:`column_params`: every shared and stacked leaf with a
leading [pod x data] axis) and :func:`fedavg_stage_params` averages it
back. The reference holds those copies on the columns' devices behind a
layout replicated over the FL axes, where reading it gives column 0's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import blocks as B
from repro_torch.tree import flatten, tree_map, unflatten


# --------------------------------------------------------------------------
# Stage templates
# --------------------------------------------------------------------------
def balanced_template(num_layers: int, stages: int) -> Tuple[int, ...]:
    """Even split; the first ``num_layers % stages`` stages get one extra."""
    base, rem = divmod(num_layers, stages)
    return tuple(base + (1 if s < rem else 0) for s in range(stages))


def template_offsets(template: Sequence[int]) -> Tuple[int, ...]:
    off, out = 0, []
    for c in template:
        out.append(off)
        off += c
    return tuple(out)


def _stage_index(template: Sequence[int]):
    """(layer index [S, Lmax], validity [S, Lmax]) of a template; padded
    slots repeat layer 0."""
    lmax = max(max(template), 1)
    offsets = template_offsets(template)
    idx = [[offsets[s] + i if i < n else 0 for i in range(lmax)]
           for s, n in enumerate(template)]
    valid = [[i < n for i in range(lmax)] for n in template]
    return idx, valid


def stack_stages(blocks, template: Sequence[int]):
    """[L, ...] stacked blocks -> ([S, Lmax, ...] padded, mask [S, Lmax]).

    Padded slots repeat layer 0 (their values are masked out), as the
    reference's."""
    idx, valid = _stage_index(template)
    leaves, spec = flatten(blocks)
    dev = leaves[0].device
    index = torch.tensor(idx, dtype=torch.long, device=dev)
    mask = torch.tensor(valid, dtype=torch.bool, device=dev)
    return unflatten(spec, [x[index] for x in leaves]), mask


def rotate_stages(stage_tree, shift: int):
    """Roll stage ownership around the ring (the paper's stage rotation)."""
    return tree_map(lambda x: torch.roll(x, shift, dims=0), stage_tree)


# --------------------------------------------------------------------------
# Family adapters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FamilyAdapter:
    stack_order: Tuple[str, ...]
    split: Callable      # params -> (shared, {name: [L, ...]})
    counts: Callable     # cfg -> {name: L}
    #: (shared, batch, cfg) -> activation: [b, s, d], or a dict of them
    embed: Callable
    #: (stack, layer_params, act, cfg, window, pos, rot, shared) -> act
    block: Callable
    loss: Callable       # (shared, act, batch_mb, cfg) -> (loss_sum, n, metrics)
    #: cfg -> the stack of every unit in the flat model's order (None:
    #: the stacks one after another, in ``stack_order``)
    unit_order: Optional[Callable] = None
    #: the block checkpoints its own layers in training, so the step does
    #: not wrap it in another checkpoint
    remats_itself: bool = False

    def units(self, cfg: ModelConfig) -> Tuple[str, ...]:
        """The stack name of every unit, in the order the model runs
        them."""
        if self.unit_order is not None:
            return tuple(self.unit_order(cfg))
        counts = self.counts(cfg)
        return tuple(n for n in self.stack_order for _ in range(counts[n]))


def _lm_split(params):
    return ({k: v for k, v in params.items() if k != "blocks"},
            {"blocks": params["blocks"]})


# The reference's activations carry the MoE auxiliary loss beside x; it is
# zero for the families ported here, so the port leaves it out.
def _tok_embed(shared, batch, cfg):
    return B.embed(shared["embed"], batch["tokens"])


def _head_ce_loss(shared, x, batch, cfg):
    from repro_torch.train.losses import chunked_ce, head_weight
    x = B.rms_norm(shared["ln_f"], x, cfg.norm_eps)
    labels = batch["labels"]
    loss, metrics = chunked_ce(x, head_weight(shared), labels, seq_chunk=512)
    n = float(labels.numel())
    return loss * n, n, metrics


def _seq_positions(x, cfg):
    """Positions 0 .. s - 1 of an activation [b, s, d] and their rope
    tables."""
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return pos, B.rope_tables(pos, cfg.hd, cfg.rope_theta)


# ---- decoder LM (dense) ----
def _lm_block(stack, lp, x, cfg, window, pos, rot, shared=None):
    from repro_torch.models.lm import apply_block
    out, _ = apply_block(lp, x, cfg, positions=pos, rot=rot, window=window,
                         positions_contiguous=True)
    return out


# ---- xLSTM (a unit: one super-block's mLSTM layers, or its sLSTM) ----
def _xlstm_split(params):
    return ({k: v for k, v in params.items() if k not in ("mlstm", "slstm")},
            {"mlstm": params["mlstm"], "slstm": params["slstm"]})


def _xlstm_block(stack, lp, x, cfg, window, pos, rot, shared=None):
    """One unit as :func:`repro_torch.models.xlstm.forward` trains it,
    each layer checkpointed (one layer's saved chunk states alive at a
    time, not a unit's)."""
    from repro_torch.models import xlstm
    unit = (xlstm.train_mlstm_unit if stack == "mlstm"
            else xlstm.train_slstm_unit)
    return unit(lp, x, cfg)


# ---- Hymba hybrid ----
def _hymba_block(stack, lp, x, cfg, window, pos, rot, shared=None):
    from repro_torch.models.hymba import apply_block
    out, _, _ = apply_block(lp, x, cfg, positions=pos, rot=rot,
                            window=window, positions_contiguous=True)
    return out


# ---- encoder-decoder: enc stack then dec stack, memory frozen in-band ----
def _encdec_split(params):
    return ({k: v for k, v in params.items()
             if k not in ("enc_blocks", "dec_blocks")},
            {"enc": params["enc_blocks"], "dec": params["dec_blocks"]})


def _encdec_embed(shared, batch, cfg):
    return {"enc": B.linear(shared["frontend"],
                            batch["frames"].to(cfg.dtype)),
            "dec": B.embed(shared["embed"], batch["tokens"])}


def _encdec_block(stack, lp, act, cfg, window, pos, rot, shared=None):
    """An encoder unit updates ``enc``; the first decoder unit freezes
    ``enc_ln(enc)`` as the memory ``mem`` (the flat model's
    :func:`repro_torch.models.encdec.encode` output) and every decoder
    unit attends over its own layer's cross K/V of it."""
    from repro_torch.models import encdec
    if stack == "enc":
        return dict(act, enc=encdec.enc_block(lp, act["enc"], cfg,
                                              pos["enc"], rot["enc"],
                                              window))
    mem = act.get("mem")
    if mem is None:
        mem = B.rms_norm(shared["enc_ln"], act["enc"], cfg.norm_eps)
    ck, cv = encdec.cross_kv_of(lp["xattn"], mem, cfg)
    dec = encdec.dec_block(lp, act["dec"], ck, cv, cfg, pos["dec"],
                           rot["dec"], window=window, contiguous=True)
    return {"dec": dec, "mem": mem}


def _encdec_loss(shared, act, batch, cfg):
    return _head_ce_loss(shared, act["dec"], batch, cfg)


# ---- the paper's vision encoder ----
def _vision_embed(shared, batch, cfg):
    from repro_torch.models.vision_encoder import embed
    return embed(shared, cfg, batch)


def _vision_block(stack, lp, x, cfg, window, pos, rot, shared=None):
    from repro_torch.models.vision_encoder import enc_block
    return enc_block(lp, x, cfg, pos, rot)


def _vision_loss(shared, x, batch, cfg):
    from repro_torch.models.vision_encoder import head_loss, heads
    _, wp, light = heads(shared, cfg, x)
    loss, metrics = head_loss(wp, light, batch)
    n = float(x.shape[0])
    return loss * n, n, metrics


#: families of the reference whose pipeline adapters later slices bring
_LATER_FAMILIES = {"moe": "the moe family (A7)", "vlm": "the vlm config (A7)"}


def get_adapter(cfg: ModelConfig) -> FamilyAdapter:
    fam = cfg.family
    if fam == "dense" and not cfg.moe.num_experts:
        return FamilyAdapter(("blocks",), _lm_split,
                             lambda c: {"blocks": c.num_layers},
                             _tok_embed, _lm_block, _head_ce_loss)
    if fam == "ssm":
        from repro_torch.models.xlstm import _layout

        def counts(c):
            n_super, _ = _layout(c)
            return {"mlstm": n_super, "slstm": n_super}

        return FamilyAdapter(
            ("mlstm", "slstm"), _xlstm_split, counts, _tok_embed,
            _xlstm_block, _head_ce_loss,
            unit_order=lambda c: ("mlstm", "slstm") * _layout(c)[0],
            remats_itself=True)
    if fam == "hybrid":
        return FamilyAdapter(("blocks",), _lm_split,
                             lambda c: {"blocks": c.num_layers},
                             _tok_embed, _hymba_block, _head_ce_loss)
    if fam == "encdec":
        return FamilyAdapter(("enc", "dec"), _encdec_split,
                             lambda c: {"enc": c.enc_layers,
                                        "dec": c.dec_layers},
                             _encdec_embed, _encdec_block, _encdec_loss)
    if fam == "vision":
        return FamilyAdapter(("blocks",), _lm_split,
                             lambda c: {"blocks": c.num_layers},
                             _vision_embed, _vision_block, _vision_loss)
    if fam in _LATER_FAMILIES:
        raise NotImplementedError(
            f"the FHDP pipeline of the {fam} family comes with "
            f"{_LATER_FAMILIES[fam]}; ported: dense, ssm, hybrid, encdec "
            f"and vision")
    raise ValueError(fam)


# --------------------------------------------------------------------------
# Stage-stacked parameter container
# --------------------------------------------------------------------------
def template_from_sequence(cfg: ModelConfig, seq: Sequence[int]
                           ) -> Dict[str, Tuple[int, ...]]:
    """Split a flat per-stage unit-count template over the model's stacks.

    ``seq[s]`` counts units of the model's unit sequence (the adapter's
    :meth:`FamilyAdapter.units`: the flat model's order, which for the
    single-stack families is the reference's concatenation) assigned to
    stage ``s``; a stack's template counts its units in each stage.
    Raises if the sequence does not cover the model exactly: a template
    that drops or invents layers must never reach the runtime."""
    adapter = get_adapter(cfg)
    counts = adapter.counts(cfg)
    units = adapter.units(cfg)
    seq = tuple(int(c) for c in seq)
    if sum(seq) != len(units) or min(seq, default=0) < 0:
        raise ValueError(
            f"stage template {seq} covers {sum(seq)} layers but the model "
            f"has {len(units)} ({counts}); refusing to drop/invent layers")
    offs = template_offsets(seq)
    return {name: tuple(units[o:o + n].count(name)
                        for o, n in zip(offs, seq))
            for name in adapter.stack_order}


def stage_plan(cfg: ModelConfig, templates: Dict[str, Sequence[int]]
               ) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
    """Each stage's units as (stack, slot) pairs, in the order the flat
    model runs them (:meth:`FamilyAdapter.units`); slot ``i`` of a
    stack's stage ``s`` holds that stack's unit ``sum(template[:s]) +
    i``."""
    where: Dict[str, list] = {}
    for pos, name in enumerate(get_adapter(cfg).units(cfg)):
        where.setdefault(name, []).append(pos)
    stages = len(next(iter(templates.values())))
    plan = []
    for s in range(stages):
        items = []
        for name, tmpl in templates.items():
            off = sum(tmpl[:s])
            items += [(where[name][off + i], name, i)
                      for i in range(tmpl[s])]
        plan.append(tuple((name, i) for _, name, i in sorted(items)))
    return tuple(plan)


def make_templates(cfg: ModelConfig, stages: int,
                   template: Optional[Dict[str, Sequence[int]]] = None
                   ) -> Dict[str, Tuple[int, ...]]:
    """Per-stack stage templates: the given ones, or the unit sequence
    (:meth:`FamilyAdapter.units`) split evenly across ``stages``."""
    if template is not None:
        return {k: tuple(v) for k, v in template.items()}
    total = len(get_adapter(cfg).units(cfg))
    return template_from_sequence(cfg, balanced_template(total, stages))


def _as_dict(params):
    return params.to_dict() if hasattr(params, "to_dict") else params


def stage_params_from(params, cfg: ModelConfig,
                      templates: Dict[str, Sequence[int]]):
    """Flat params (a nested dict or a ParamTree) -> {'shared', 'stacks':
    {name: [S, Lmax, ...]}, 'masks': {name: [S, Lmax]}}."""
    shared, stacks = get_adapter(cfg).split(_as_dict(params))
    out_stacks, masks = {}, {}
    with torch.no_grad():
        for name, blocks in stacks.items():
            out_stacks[name], masks[name] = stack_stages(blocks,
                                                         templates[name])
    return {"shared": tree_map(torch.Tensor.detach, shared),
            "stacks": out_stacks, "masks": masks}


#: the flat params' name of each stack
_STACK_TO_PARAM = {"enc": "enc_blocks", "dec": "dec_blocks"}


def merge_stage_params(pp, templates: Dict[str, Sequence[int]]):
    """Inverse of :func:`stage_params_from` (bitwise)."""
    merged = dict(pp["shared"])
    for name, st in pp["stacks"].items():
        tmpl = templates[name]

        def unstack(x):
            with torch.no_grad():
                return torch.cat([x[s, :n] for s, n in enumerate(tmpl)
                                  if n])

        merged[_STACK_TO_PARAM.get(name, name)] = tree_map(unstack, st)
    return merged


# --------------------------------------------------------------------------
# ZeRO-2 optimizer state (flat, data-sharded Adam moments)
# --------------------------------------------------------------------------
def _flat_shard(n: int, d: int) -> int:
    return (n + d - 1) // d


def zero2_init(pp, data_size: int, sharded: bool = True, pods: int = 1):
    """Adam moments, flat per leaf, in the reference's global layouts:
    stacks ``[S, D, n]`` (each stage's leaf flattened), the rest ``[D,
    n]``. ``sharded=True`` (ZeRO-2, valid when gradients are synchronized
    every step) splits each flat leaf over ``data``: ``n`` is its padded
    size over D. ``sharded=False`` keeps it whole per column, for FedAvg
    local steps; then ``pods`` > 1 widens the column axis to pod x data
    (``[S, pods * D, n]``, column ``p * D + d``), since each (pod, data)
    column keeps its own moments. Non-float leaves (the masks) get empty
    ``[D, 0]`` moments, as in the reference."""
    cols = data_size if sharded else data_size * pods

    def shard(x, staged):
        if not x.is_floating_point():
            return torch.zeros(((x.shape[0], cols, 0) if staged
                                else (cols, 0)), dtype=torch.float32,
                               device=x.device)
        n = x.numel() // x.shape[0] if staged else x.numel()
        if sharded:
            n = _flat_shard(n, data_size)
        return torch.zeros(((x.shape[0], cols, n) if staged else (cols, n)),
                           dtype=torch.float32, device=x.device)

    def moments():
        return {k: tree_map(lambda x, s=(k == "stacks"): shard(x, s), v)
                for k, v in pp.items()}

    dev = flatten(pp)[0][0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": moments(), "v": moments()}


def column_params(pp, mesh):
    """The container with every shared and stacked leaf expanded to a
    leading [pod x data] column axis (views, no copies): the form the
    local-steps step (``fed_sgd=False``) takes and returns."""
    c = mesh.fl_clients
    grow = lambda x: x.expand((c,) + tuple(x.shape))      # noqa: E731
    return {"shared": tree_map(grow, pp["shared"]),
            "stacks": tree_map(grow, pp["stacks"]), "masks": pp["masks"]}


def fedavg_stage_params(pp, mesh):
    """Round-boundary FedAvg for ``fed_sgd=False`` training: the mean of
    the column-stacked params over the FL columns (edge aggregation over
    ``data``, cloud aggregation over ``pod``: the reference's ``pmean``
    over both, a sum divided by the count)."""
    c = mesh.fl_clients
    avg = lambda x: x.sum(0) / c if x.is_floating_point() else x[0]  # noqa
    return {"shared": tree_map(avg, pp["shared"]),
            "stacks": tree_map(avg, pp["stacks"]), "masks": pp["masks"]}


# --------------------------------------------------------------------------
# The pipelined train step
# --------------------------------------------------------------------------
def _layer_views(stacks, lmax: Dict[str, int]):
    """{name: [[layer tree of stage s, slot i] for i] for s}: views from
    one unbind per leaf of the [S, Lmax, ...] stacks (so the backward
    stacks each leaf's gradient once)."""
    out = {}
    for name, st in stacks.items():
        leaves, spec = flatten(st)
        lead = lmax[name]
        parts = [x.reshape((-1,) + tuple(x.shape[2:])).unbind(0)
                 for x in leaves]
        stages = len(parts[0]) // lead
        out[name] = [[unflatten(spec, [q[s * lead + i] for q in parts])
                      for i in range(lead)] for s in range(stages)]
    return out


def _rows(tree, start: int, size: int):
    return {k: v[start:start + size] for k, v in tree.items()}


def make_fhdp_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                         microbatches: Optional[int] = None,
                         templates: Optional[Dict[str, Sequence[int]]] = None,
                         learning_rate: float = 3e-4, remat: bool = True,
                         window: Optional[int] = None, fed_sgd: bool = True):
    """Build the FHDP pipelined train step on ``mesh``'s device.

    Returns ``(step, helpers)``; ``step(pp, opt, batch) -> (pp, opt,
    metrics)`` over the stage-param container (:func:`stage_params_from`)
    and its ZeRO-2 moments (:func:`zero2_init`); the step leaves its
    arguments unchanged. ``batch`` is the global batch; column c of the
    FL axes (pod-major) takes rows ``c * B_col`` onwards.

    ``fed_sgd=True`` synchronizes gradients across the FL columns every
    step (FL with one local step); its ``loss`` is the mean of the
    columns' losses. ``fed_sgd=False`` runs local steps with no
    cross-column sync on a column-stacked container
    (:func:`column_params`), averaged by :func:`fedavg_stage_params` at
    round boundaries (FedAvg, paper §3.1); its ``loss`` is column 0's,
    the value the reference's replicated output shows.

    The step's own Adam (b1 0.9, b2 0.95, eps 1e-8, bias-corrected, in
    float32, cast back to the param dtype) sees the reference's gradient
    scale: see the comments at ``scale``. ``helpers`` holds the
    ``templates``, the microbatch count ``microbatches`` and size ``mb``
    and the FL column count ``columns``.
    """
    adapter = get_adapter(cfg)
    S = mesh.shape["model"]
    D = mesh.shape.get("data", 1)
    pods = mesh.shape.get("pod", 1)
    C = D * pods
    Bg = shape.global_batch
    if Bg % C:
        raise ValueError(f"global batch {Bg} does not split over {C} FL "
                         f"columns (pod {pods} x data {D})")
    B_col = Bg // C                      # per-pipeline-column batch
    # microbatch geometry: one microbatch per rank when the column batch
    # allows; columns smaller than the stage count run a partial stream
    if microbatches:
        M = microbatches
        if not (M <= S or M % S == 0) or B_col % M:
            raise ValueError(f"{M} microbatches do not fit {S} stages and "
                             f"a column batch of {B_col}")
        mb = B_col // M
    else:
        mb = max(1, B_col // S)
        M = B_col // mb
    per = max(M // S, 1)                 # loss slots of a rank
    share = per * mb                     # samples each rank embeds
    # the microbatches whose loss the reference keeps: rank r scores
    # microbatches r * per .. r * per + per - 1, clamped and masked where
    # M < S; when M % S != 0 the last M - S * per are never scored
    K = min(M, S * per)
    templates = templates or make_templates(cfg, S)
    plan = stage_plan(cfg, templates)
    wrap = remat and not adapter.remats_itself
    lmax = {k: max(max(t), 1) for k, t in templates.items()}
    lr = learning_rate
    zero2 = fed_sgd and D > 1
    b1, b2, eps = 0.9, 0.95, 1e-8
    # The reference's Adam sees the gradient of the summed column losses
    # (what autograd gives here) times:
    #   S  the transpose of the loss's psum over ``model`` (a psum, under
    #      shard_map without replication checks);
    #   D  (ZeRO-2 only) psum_scatter over ``data`` sums the gradient
    #      that the sync's psum over the FL axes has already summed.
    # The sync's own psum over the FL axes is the sum over columns. So
    # FedSGD scales the mean-loss gradient by pod x data^2 x model, local
    # steps each column's by model.
    scale = float(S * (D if zero2 else 1))

    def stage_fwd(s, layers, shared, x, pos, rot):
        for name, i in plan[s]:          # the flat model's order
            lp = layers[name][s][i]      # padded slots: never planned
            if wrap and torch.is_grad_enabled():
                x = checkpoint(adapter.block, name, lp, x, cfg, window,
                               pos, rot, shared, use_reentrant=False)
            else:
                x = adapter.block(name, lp, x, cfg, window, pos, rot,
                                  shared)
        return x

    def column_loss(shared, layers, batch):
        """(loss sum / count) of one FL column: each kept microbatch
        through every stage (the GPipe schedule's work, bubbles skipped)."""
        # every rank embeds its own share of the column batch; only the
        # embeddings reach the pipeline head (the all_gather: a cat)
        embeds = [adapter.embed(shared, _rows(
            batch, min(r * share, B_col - share), share), cfg)
            for r in range(S)]
        act_all = tree_map(lambda *xs: torch.cat(xs), *embeds)
        if isinstance(act_all, dict):    # each stream its own positions
            pr = {k: _seq_positions(t, cfg) for k, t in act_all.items()}
            pos, rot = ({k: v[i] for k, v in pr.items()} for i in (0, 1))
        else:
            pos, rot = _seq_positions(act_all, cfg)
        loss, cnt = 0.0, 0.0
        for m in range(K):
            x = tree_map(lambda t: t[m * mb:(m + 1) * mb], act_all)
            for s in range(S):           # the stage ring's ppermute
                x = stage_fwd(s, layers, shared, x, pos, rot)
            lsum, n, _ = adapter.loss(shared, x, _rows(batch, m * mb, mb),
                                      cfg)
            loss, cnt = loss + lsum, cnt + n
        return loss / max(cnt, 1.0)

    def adam(p, g, m, v, bc1, bc2, staged):
        """One leaf's update in the moments' layout; p and g are a leaf
        ([...] or, with a column axis, [C, ...]) of the container."""
        lead = p.shape[0] if staged else 1
        if fed_sgd:
            gf = g.reshape(lead, -1)
            n = gf.shape[1]
            width = m.shape[-2] * m.shape[-1]        # D x shard, or 1 x n
            gl = F.pad(gf, (0, width - n)).reshape(m.shape)
            pf = F.pad(p.reshape(lead, -1).float(), (0, width - n))
        else:   # whole per column: [C, n] or [S, C, n] (stage first)
            gl = g.reshape(m.shape[1], m.shape[0], -1).transpose(0, 1) \
                if staged else g.reshape(m.shape)
            pf = p.float()
        m2 = b1 * m + (1 - b1) * gl
        v2 = b2 * v + (1 - b2) * gl * gl
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if fed_sgd:
            new = (pf - lr * u.reshape(lead, -1))[:, :n]
        else:
            new = pf - lr * (u.transpose(0, 1) if staged else u) \
                .reshape(p.shape)
        return new.reshape(p.shape).to(p.dtype), m2, v2

    def step(pp, opt, batch):
        sh_leaves, sh_spec = flatten(pp["shared"])
        st_leaves, st_spec = flatten(pp["stacks"])
        live = [x.detach().requires_grad_() for x in sh_leaves + st_leaves]
        with torch.enable_grad():
            shared = unflatten(sh_spec, live[:len(sh_leaves)])
            stacks = unflatten(st_spec, live[len(sh_leaves):])
            losses = []
            if fed_sgd:                  # one set of params for all columns
                layers = _layer_views(stacks, lmax)
            else:
                col_sh = [unflatten(sh_spec, list(z)) for z in zip(
                    *[x.unbind(0) for x in live[:len(sh_leaves)]])]
                col_st = [unflatten(st_spec, list(z)) for z in zip(
                    *[x.unbind(0) for x in live[len(sh_leaves):]])]
            for c in range(C):
                rows = _rows(batch, c * B_col, B_col)
                if fed_sgd:
                    losses.append(column_loss(shared, layers, rows))
                else:
                    losses.append(column_loss(
                        col_sh[c], _layer_views(col_st[c], lmax), rows))
            grads = torch.autograd.grad(sum(losses), live,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float() * scale
                 for p, g in zip(live, grads)]
        t = (opt["step"] + 1)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
        new_p, new_m, new_v = [], [], []
        moments = [flatten(opt[k]["shared"])[0] + flatten(opt[k]["stacks"])[0]
                   for k in ("m", "v")]
        for i, (p, g) in enumerate(zip(sh_leaves + st_leaves, grads)):
            p2, m2, v2 = adam(p, g, moments[0][i], moments[1][i], bc1, bc2,
                              staged=i >= len(sh_leaves))
            new_p.append(p2)
            new_m.append(m2)
            new_v.append(v2)
        ns = len(sh_leaves)

        def container(vals, masks):
            return {"shared": unflatten(sh_spec, vals[:ns]),
                    "stacks": unflatten(st_spec, vals[ns:]), "masks": masks}

        pp2 = container(new_p, pp["masks"])
        opt2 = {"step": t, "m": container(new_m, opt["m"]["masks"]),
                "v": container(new_v, opt["v"]["masks"])}
        losses = torch.stack([x.detach() for x in losses])
        loss = losses.sum() / C if fed_sgd else losses[0]
        return pp2, opt2, {"loss": loss}

    helpers = {"templates": templates, "microbatches": M, "mb": mb,
               "columns": C}
    return step, helpers
