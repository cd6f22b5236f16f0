"""Strategy protocol + registry (port of ``repro/api/strategies.py``).

A :class:`Strategy` owns what an execution mode needs:

  * ``init(cfg, shape, mesh, seed) -> (params_like, opt_like)`` —
    trainable state in the strategy's layout on ``mesh.device``;
  * ``make_step(cfg, shape, mesh) -> step`` — ``(params, opt, batch) ->
    (params, opt, metrics)``, a whole FL round for round strategies;
  * :meth:`Strategy.merge_params`, the flat model params of a state.

The port runs on one card: every strategy takes the session's one-device
:class:`repro_torch.api.mesh.Mesh`, whose ``device`` holds the state; the
FHDP strategies also shape their columns and stages by its axes. Ported: ``tensor`` (the single-model baseline step),
``pipeline`` (FHDP: FL columns x pipeline stages), ``swift_pipeline``
(FHDP whose stage templates come from the SWIFT scheduler over a
declared heterogeneous fleet, with pre-generated departure templates for
live repartitioning), ``fl_pipeline`` (FedAvg rounds of FHDP local
steps), ``fedavg`` (flat FedAvg rounds over client-stacked params),
``hier_fl`` (the same rounds over the explicit vehicle -> edge -> cloud
fabric of :mod:`repro_torch.comm`), ``async_hier_fl`` (that fabric
driven by the discrete-event engine of :mod:`repro_torch.comm.events`)
and ``distill_fl`` (per-pod LoRA students distilled from a frozen
AD-LLM, adapter deltas on the fabric). The sharding specs
(``param_specs``), which only shape a lowering, raise
``NotImplementedError``.
"""
from __future__ import annotations

import abc
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.common import concrete_batch

_REGISTRY: Dict[str, Type["Strategy"]] = {}

_SPECS_LATER = ("sharding specs only shape a lowering for a multi-device "
                "mesh; they come with the dry-run slice of the port (A8 in "
                "ROADMAP.md)")


def register_strategy(name: str) -> Callable[[type], type]:
    """Class decorator adding a Strategy to the registry under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_strategy(name: str, **options) -> "Strategy":
    """Instantiate a registered strategy; unknown names raise
    ValueError."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: "
            f"{', '.join(available_strategies())}") from None
    return cls(**options)


class Strategy(abc.ABC):
    """One way to realize FLAD training (see module docstring)."""

    name: str = ""
    #: which loop Session.run runs ("step" -> train_loop; "round" ->
    #: fl_loop; "distill" -> fl_loop with the frozen base as the teacher;
    #: "async" -> async_fl_loop over the strategy's event engine)
    loop: str = "round"

    def __init__(self, *, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    @abc.abstractmethod
    def init(self, cfg: ModelConfig, shape: ShapeConfig, mesh, seed: int
             ) -> Tuple[Any, Any]:
        """Materialize (params_like, opt_like) in this strategy's layout."""

    @abc.abstractmethod
    def make_step(self, cfg: ModelConfig, shape: ShapeConfig, mesh
                  ) -> Callable:
        """(params, opt, batch) -> (params, opt, metrics)."""

    def param_specs(self, cfg: ModelConfig, mesh):
        """PartitionSpec tree of the reference's layout: not on one card."""
        raise NotImplementedError(f"{self.name}: {_SPECS_LATER}")

    def merge_params(self, state, cfg: Optional[ModelConfig] = None):
        """Collapse strategy state to flat model params."""
        return state[0]

    @abc.abstractmethod
    def default_batch(self, cfg: ModelConfig, shape: ShapeConfig,
                      gen: torch.Generator):
        """One synthetic batch matching ``make_step``'s input, drawn from
        ``gen``."""


@register_strategy("tensor")
class TensorStrategy(Strategy):
    """The single-model baseline (the reference's SPMD data/tensor-parallel
    step, FedSGD by the implicit gradient mean): one model, one Adam."""

    loop = "step"

    def __init__(self, *, learning_rate: float = 1e-3, remat: bool = True,
                 grad_accum: int = 1):
        super().__init__(learning_rate=learning_rate)
        self.remat = remat
        self.grad_accum = grad_accum

    def _optimizer(self):
        from repro_torch.train.optimizer import Adam
        return Adam(lr=self.learning_rate)

    def init(self, cfg, shape, mesh, seed):
        from repro_torch.models.registry import build_model
        from repro_torch.tree import tree_map
        params = tree_map(torch.Tensor.detach, build_model(cfg).init(
            seed=seed, device=mesh.device).to_dict())
        return params, self._optimizer().init(params)

    def make_step(self, cfg, shape, mesh):
        from repro_torch.core.steps import make_train_step
        return make_train_step(cfg, shape, self._optimizer(),
                               remat=self.remat, grad_accum=self.grad_accum)

    def default_batch(self, cfg, shape, gen):
        return concrete_batch(cfg, shape, gen)


@register_strategy("pipeline")
class PipelineStrategy(Strategy):
    """FHDP: FL columns (pod x data) x pipeline stages (model), on the
    session's one-device mesh (:mod:`repro_torch.core.pipeline`)."""

    loop = "step"

    def __init__(self, *, learning_rate: float = 1e-3, remat: bool = True,
                 templates: Optional[Dict] = None,
                 microbatches: Optional[int] = None):
        super().__init__(learning_rate=learning_rate)
        self.remat = remat
        self.templates = templates
        self.microbatches = microbatches
        self.helpers: Optional[Dict] = None

    def resolve_templates(self, cfg, mesh) -> Dict:
        """Stage templates are shared by init and make_step — pin them."""
        if self.templates is None:
            from repro_torch.core import pipeline as pl
            self.templates = pl.make_templates(cfg, mesh.shape["model"])
        return self.templates

    def init(self, cfg, shape, mesh, seed):
        from repro_torch.core.fhdp import init_fhdp
        pp, opt, self.templates = init_fhdp(
            cfg, mesh, seed, templates=self.resolve_templates(cfg, mesh))
        return pp, opt

    def make_step(self, cfg, shape, mesh):
        from repro_torch.core import pipeline as pl
        step, self.helpers = pl.make_fhdp_train_step(
            cfg, shape, mesh, learning_rate=self.learning_rate,
            remat=self.remat, templates=self.resolve_templates(cfg, mesh),
            microbatches=self.microbatches)
        return step

    def merge_params(self, state, cfg=None):
        from repro_torch.core import pipeline as pl
        return pl.merge_stage_params(state[0], self.templates)

    def default_batch(self, cfg, shape, gen):
        return concrete_batch(cfg, shape, gen)


@register_strategy("swift_pipeline")
class SwiftPipelineStrategy(PipelineStrategy):
    """FHDP with SWIFT-scheduled stage templates + live repartitioning.

    Closes the scheduler -> runtime loop: model units come from the cost
    model (:func:`repro_torch.sched.costmodel.model_units`), SWIFT
    schedules the declared heterogeneous ``fleet`` over them, the winning
    pipeline is bridged to a per-stack stage template for the FHDP step,
    and departure templates are pre-generated (paper §4.2) so a mid-run
    vehicle departure swaps templates via
    :class:`repro_torch.recovery.recover.Repartitioner` instead of
    replanning.

    ``fleet``: "nano*4,agx*2"-style preset string, spec dicts, or
    :class:`~repro_torch.sched.costmodel.Vehicle` list (see
    ``parse_fleet``). ``agent``: an optional trained
    :class:`~repro_torch.sched.dqn.DoubleDQN` for SWIFT's phase 2.
    """

    loop = "step"

    def __init__(self, *, learning_rate: float = 1e-3, remat: bool = True,
                 microbatches: Optional[int] = None,
                 fleet="nano*4,agx*2", seq_len: int = 512,
                 cost=None, agent=None):
        super().__init__(learning_rate=learning_rate, remat=remat,
                         templates=None, microbatches=microbatches)
        from repro_torch.sched.costmodel import CostParams, parse_fleet
        self.vehicles = parse_fleet(fleet)
        self.seq_len = seq_len
        self.cost = cost or CostParams()
        self.agent = agent
        self.units = None
        self.swift_result = None
        self.active_pipeline = None
        self.template_set = None
        self._cfg = None
        self._stages: Optional[int] = None

    # ---- scheduling -------------------------------------------------------
    def schedule(self, cfg: ModelConfig, stages: int):
        """Run SWIFT once over (fleet x model units) and pre-generate the
        departure templates; cached for the strategy's lifetime."""
        if self.swift_result is not None:
            return self.swift_result
        from repro_torch.core.pipeline import get_adapter
        from repro_torch.recovery.templates import TemplateSet, pregenerate
        from repro_torch.sched.costmodel import model_units
        from repro_torch.sched.swift import swift, units_to_layer_template
        self._cfg, self._stages = cfg, stages
        n_units = sum(get_adapter(cfg).counts(cfg).values())
        self.units = model_units(cfg, seq_len=self.seq_len,
                                 num_units=n_units)
        self.swift_result = swift(self.vehicles, self.units,
                                  agent=self.agent, cp=self.cost)
        candidates = [self.swift_result.initial] \
            + list(self.swift_result.essential.values())
        feasible = []
        for pipe in candidates:
            if pipe is None:
                continue
            try:
                units_to_layer_template(pipe, stages)
            except ValueError:
                continue        # cannot fold onto this SPMD width
            feasible.append(pipe)
        if not feasible:
            raise ValueError(
                f"SWIFT found no pipeline for {len(self.vehicles)} vehicles "
                f"x {len(self.units)} units that maps onto {stages} SPMD "
                f"stages; grow the fleet's memory or the mesh's model axis")
        self.active_pipeline = min(feasible, key=lambda p: p.time)
        try:
            ts = pregenerate(
                self.vehicles, self.units, self.cost, agent=self.agent,
                active=self.active_pipeline)
            on_dep = self._foldable_only(ts.on_departure)
        except ValueError:
            on_dep = {}
        self.template_set = TemplateSet(self.active_pipeline, on_dep)
        return self.swift_result

    def _foldable_only(self, on_departure):
        """Drop (-> None) departure pipelines that cannot fold onto the
        SPMD width now, so an unrecoverable departure is reported as 'no
        feasible template' up front instead of failing mid-training."""
        from repro_torch.sched.swift import units_to_layer_template
        out = {}
        for vid, pipe in on_departure.items():
            if pipe is not None:
                try:
                    units_to_layer_template(pipe, self._stages)
                except ValueError:
                    pipe = None
            out[vid] = pipe
        return out

    def resolve_templates(self, cfg, mesh) -> Dict:
        if self.templates is None:
            from repro_torch.core.pipeline import template_from_sequence
            from repro_torch.sched.swift import units_to_layer_template
            stages = mesh.shape["model"]
            self.schedule(cfg, stages)
            seq = units_to_layer_template(self.active_pipeline, stages)
            self.templates = template_from_sequence(cfg, seq)
        return self.templates

    # ---- live-repartition protocol (recovery.recover.Repartitioner) -------
    def departure_template(self, vid: int):
        """(per-stack templates, pipeline) pre-generated for ``vid``'s
        departure — the paper's template lookup, no replanning."""
        if self.template_set is None:
            raise RuntimeError("schedule() has not run; build the session "
                               "(resolve_templates) first")
        pipe = self.template_set.on_departure.get(vid)
        if pipe is None:
            raise ValueError(
                f"no feasible pre-generated template for the departure of "
                f"vehicle {vid} (remaining fleet cannot host the model)")
        from repro_torch.core.pipeline import template_from_sequence
        from repro_torch.sched.swift import units_to_layer_template
        seq = units_to_layer_template(pipe, self._stages)
        return template_from_sequence(self._cfg, seq), pipe

    def adopt_departure(self, vid: int, pipe) -> None:
        """Commit a departure: shrink the fleet, promote ``pipe`` to
        active, and refresh the preventive templates for the remaining
        fleet (the paper's concurrent template regeneration)."""
        from repro_torch.recovery.templates import TemplateSet, pregenerate
        self.vehicles = [v for v in self.vehicles if v.vid != vid]
        self.active_pipeline = pipe
        on_dep = {}
        if len(self.vehicles) >= 2:
            try:
                on_dep = self._foldable_only(
                    pregenerate(self.vehicles, self.units, self.cost,
                                agent=self.agent, active=pipe).on_departure)
            except ValueError:
                on_dep = {}
        self.template_set = TemplateSet(pipe, on_dep)


@register_strategy("fl_pipeline")
class FLPipelineStrategy(PipelineStrategy):
    """FedAvg rounds of FHDP-pipelined local steps (paper Fig. 1)."""

    loop = "round"

    def __init__(self, *, learning_rate: float = 1e-3, local_steps: int = 1,
                 remat: bool = True, templates: Optional[Dict] = None,
                 microbatches: Optional[int] = None):
        super().__init__(learning_rate=learning_rate, remat=remat,
                         templates=templates, microbatches=microbatches)
        self.local_steps = local_steps

    def init(self, cfg, shape, mesh, seed):
        from repro_torch.core.fhdp import init_fhdp
        pp, opt, self.templates = init_fhdp(
            cfg, mesh, seed, templates=self.resolve_templates(cfg, mesh),
            fed_sgd=False)
        return pp, opt

    def make_step(self, cfg, shape, mesh):
        from repro_torch.core.fhdp import make_fl_pipeline_round
        fl_round, self.helpers = make_fl_pipeline_round(
            cfg, shape, mesh, local_steps=self.local_steps,
            learning_rate=self.learning_rate, remat=self.remat,
            templates=self.resolve_templates(cfg, mesh),
            microbatches=self.microbatches)
        return fl_round

    def default_batch(self, cfg, shape, gen):
        return concrete_batch(cfg, shape, gen, lead=(self.local_steps,))


@register_strategy("fedavg")
class FedAvgStrategy(Strategy):
    """FedAvg rounds over client-stacked flat params (paper §3.1)."""

    loop = "round"

    def __init__(self, *, learning_rate: float = 1e-3, local_steps: int = 1,
                 clients: int = 0, remat: bool = False,
                 client_weights: Optional[Any] = None):
        super().__init__(learning_rate=learning_rate)
        self.local_steps = local_steps
        self.clients = clients
        self.remat = remat
        #: [C] aggregation weights (paper: data-volume weighted); None=mean
        self.client_weights = client_weights

    def _optimizer(self):
        from repro_torch.train.optimizer import Adam
        return Adam(lr=self.learning_rate)

    def n_clients(self) -> int:
        if not self.clients:
            raise ValueError(
                "fedavg needs clients=N: the port has no device mesh to "
                "derive the client count from")
        return self.clients

    def init(self, cfg, shape, mesh, seed):
        from repro_torch.core.fedavg import stack_clients
        from repro_torch.models.registry import build_model
        device = mesh.device
        params0 = build_model(cfg).init(seed=seed, device=device).to_dict()
        cp = stack_clients(params0, self.n_clients())
        return cp, self._optimizer().init(cp)._replace(
            step=torch.zeros((self.n_clients(),), dtype=torch.int32,
                             device=device))

    def make_step(self, cfg, shape, mesh):
        from repro_torch.core.fedavg import make_fl_round
        return make_fl_round(cfg, shape, self._optimizer(),
                             local_steps=self.local_steps, remat=self.remat,
                             client_weights=self.client_weights)

    def merge_params(self, state, cfg=None):
        from repro_torch.core.fedavg import fedavg
        return fedavg(state[0], weights=self.client_weights)

    def default_batch(self, cfg, shape, gen):
        return concrete_batch(cfg, shape, gen,
                              lead=(self.n_clients(), self.local_steps))


@register_strategy("hier_fl")
class HierFLStrategy(FedAvgStrategy):
    """FedAvg rounds over the explicit comm fabric (paper §3.1, Fig. 1).

    Clients transmit round deltas through a lossy ``codec`` with
    error-feedback residuals, edge pods partially average the decoded
    updates, and the cloud merges edge partials — down-weighting edges
    the link models predict to miss the round deadline when
    ``async_decay`` is set. Bytes on the wire and the simulated round
    time ride along in every round's metrics.

    ``topology``: a :class:`repro_torch.comm.Topology` or an ``"E@FLEET"``
    spec; the client count is its vehicle head count. ``codec``: ``none``
    | ``int8`` | ``topk``. ``codec_bits``: optional ``fn(round, leaf,
    client, shape) -> uint32 tensor`` supplying the codec's random words
    (the tests pass the reference's); by default they come from a
    ``torch.Generator`` seeded from the init seed.
    """

    loop = "round"

    def __init__(self, *, learning_rate: float = 1e-3, local_steps: int = 1,
                 remat: bool = False, topology="2@nano*2,agx*2",
                 codec: str = "none",
                 codec_options: Optional[Dict] = None,
                 client_weights: Optional[Any] = None,
                 async_decay: Optional[float] = None,
                 async_deadline: Optional[float] = None,
                 codec_bits: Optional[Callable] = None,
                 seed: int = 0):
        from repro_torch.comm.codecs import Codec, get_codec
        from repro_torch.comm.topology import parse_topology
        self.topology = parse_topology(topology)
        super().__init__(learning_rate=learning_rate,
                         local_steps=local_steps,
                         clients=self.topology.n_clients, remat=remat,
                         client_weights=client_weights)
        self.codec = codec if isinstance(codec, Codec) \
            else get_codec(codec, **(codec_options or {}))
        if async_deadline is not None and async_decay is None:
            raise ValueError(
                "async_deadline only affects the staleness-aware async "
                "merge; set async_decay to enable it")
        self.async_decay = async_decay
        self.async_deadline = async_deadline
        self.codec_bits = codec_bits
        #: seed of the default bits stream when make_step runs without
        #: init(); under Session it derives from the session's seed
        self.seed = seed
        self.comm_stats: Optional[Dict] = None
        self._residual = None
        self._bits = None
        self._round = 0

    def _wire_tree(self, cfg):
        """The tree whose bytes ride the uplink, on the meta device (full
        params here; ``distill_fl`` sends the LoRA factor tree)."""
        from repro_torch.models.registry import abstract_params
        return abstract_params(cfg)

    def _round_stats(self, cfg) -> Dict:
        """Per-round wire accounting from the link models."""
        from repro_torch.comm.codecs import tree_edge_nbytes, tree_nbytes
        from repro_torch.comm.hierarchy import staleness_weights
        ptree = self._wire_tree(cfg)
        per_client = tree_nbytes(self.codec, ptree)
        per_edge = [tree_edge_nbytes(self.codec, ptree, len(members))
                    for members in self.topology.edges]
        stats = self.topology.hier_round_stats(per_client, per_edge)
        stats["bytes_per_client"] = per_client
        if self.async_decay is not None:
            # the cloud closes the round at the deadline (default: the
            # median edge arrival) and discounts the rest
            deadline = self.async_deadline \
                if self.async_deadline is not None \
                else float(np.median(stats["edge_arrival_s"]))
            stats["staleness"] = staleness_weights(
                stats["edge_arrival_s"], deadline, decay=self.async_decay)
            stats["round_time_s"] = deadline
        else:
            stats["staleness"] = None
        return stats

    def init(self, cfg, shape, mesh, seed):
        from repro_torch.comm.codecs import GeneratorBits
        state = super().init(cfg, shape, mesh, seed)
        self._residual = None           # fresh error-feedback state
        self._round = 0
        # the codec's rounding stream derives from the init seed, so a
        # re-init restarts it
        self._bits = GeneratorBits(seed + 1, mesh.device)
        return state

    def _wire_metrics(self, cfg) -> Dict:
        """This round's wire accounting as round metrics."""
        stats = self._round_stats(cfg)
        self.comm_stats = stats
        return {
            "comm_bytes_up": float(stats["uplink_bytes"]),
            "comm_bytes_backhaul": float(stats["backhaul_bytes"]),
            "sim_round_s": float(stats["round_time_s"]),
        }

    def _round_bits(self, device):
        """The codec's bits source for the next round: ``codec_bits`` at
        this round when given, else the strategy's generator stream."""
        from repro_torch.comm.codecs import GeneratorBits
        if self._bits is None:
            self._bits = GeneratorBits(self.seed, device)
        if self.codec_bits is None:
            return self._bits
        r = self._round
        return lambda leaf, client, shp: self.codec_bits(r, leaf, client,
                                                         shp)

    def make_step(self, cfg, shape, mesh):
        from repro_torch.comm.codecs import zero_residual
        from repro_torch.comm.hierarchy import make_hier_round

        wire_metrics = self._wire_metrics(cfg)
        hier_round = make_hier_round(
            cfg, shape, self._optimizer(), self.topology, self.codec,
            local_steps=self.local_steps, remat=self.remat,
            client_weights=self.client_weights,
            staleness=self.comm_stats["staleness"])

        def round_fn(client_params, client_opt, batches):
            if self._residual is None:
                self._residual = zero_residual(client_params)
            bits = self._round_bits(mesh.device)
            client_params, client_opt, metrics, self._residual = \
                hier_round(client_params, client_opt, batches,
                           self._residual, bits)
            self._round += 1
            return client_params, client_opt, dict(metrics, **wire_metrics)

        return round_fn

    def merge_params(self, state, cfg=None):
        from repro_torch.core.fedavg import fedavg
        return fedavg(state[0], weights=self.client_weights,
                      topology=self.topology)


@register_strategy("async_hier_fl")
class AsyncHierFLStrategy(HierFLStrategy):
    """Event-driven hierarchical FL (paper §3.1's parallelized
    collaborative training): the fabric of ``hier_fl`` driven by the
    discrete-event engine of :mod:`repro_torch.comm.events`.

    ``clock``: the cloud's merge period in simulated seconds; ``None`` is
    the infinite deadline, the synchronous case, bitwise ``hier_fl``
    (same topology, codec, seed and bits, zero jitter, no migrations).
    With a finite clock, edge pods flush partial aggregates instead of
    waiting for stragglers and the cloud down-weights late commits by
    ``decay ** observed_lag``. ``compute_flops`` sizes the per-vehicle
    compute-time model (default: 6 x params x tokens of a local round);
    ``compute_jitter`` adds up to that fraction of uniform slowdown per
    (vehicle, wave). ``migrate_every`` turns on DTMC mobility: every
    that many simulated seconds each vehicle takes a grid step and moves
    to the nearest edge pod once it leaves its pod's comm radius.
    ``codec_bits``: optional ``fn(wave, leaf, client, shape) -> uint32
    tensor``, ``wave`` counted from 0 in each run; by default the bits
    come from the strategy's generator stream, the one ``hier_fl`` draws
    from, in the same order when every wave is the whole fleet.
    """

    loop = "async"

    def __init__(self, *, learning_rate: float = 1e-3, local_steps: int = 1,
                 remat: bool = False, topology="2@nano*2,agx*2",
                 codec: str = "none",
                 codec_options: Optional[Dict] = None,
                 client_weights: Optional[Any] = None,
                 clock: Optional[float] = None, decay: float = 0.5,
                 flush_every: Optional[float] = None,
                 compute_flops: Optional[float] = None,
                 compute_jitter: float = 0.0,
                 migrate_every: Optional[float] = None,
                 mobility: Optional[Any] = None,
                 codec_bits: Optional[Callable] = None,
                 sim_seed: int = 0, seed: int = 0):
        super().__init__(learning_rate=learning_rate,
                         local_steps=local_steps, remat=remat,
                         topology=topology, codec=codec,
                         codec_options=codec_options,
                         client_weights=client_weights,
                         codec_bits=codec_bits, seed=seed)
        self.clock = clock
        self.decay = decay
        self.flush_every = flush_every
        self.compute_flops = compute_flops
        self.compute_jitter = compute_jitter
        self.migrate_every = migrate_every
        self.mobility = mobility
        self.sim_seed = sim_seed
        self.engine = None

    def make_step(self, cfg, shape, mesh):
        from repro_torch.comm.codecs import tree_edge_nbytes, tree_nbytes
        from repro_torch.comm.events import (AsyncHierFLEngine, ComputeModel,
                                             HierFLProgram, MobilitySpec,
                                             default_compute_flops)

        self.comm_stats = self._round_stats(cfg)    # predicted, for info
        program = HierFLProgram(cfg, shape, self._optimizer(), self.codec,
                                remat=self.remat)
        ptree = self._wire_tree(cfg)
        flops = self.compute_flops if self.compute_flops is not None \
            else default_compute_flops(cfg, shape, self.local_steps)
        mobility = self.mobility
        if mobility is None and self.migrate_every is not None:
            mobility = MobilitySpec(seed=self.sim_seed)
        # the engine reaches the strategy's bits through a weak reference:
        # no strategy <-> engine cycle, so a dropped Session frees the
        # engine's device state at once, not at the next garbage collection
        self.engine = AsyncHierFLEngine(
            self.topology, tree_nbytes(self.codec, ptree),
            lambda m: tree_edge_nbytes(self.codec, ptree, m),
            program=program,
            compute=ComputeModel(flops=flops, jitter=self.compute_jitter),
            client_weights=self.client_weights,
            clock=self.clock, decay=self.decay,
            flush_every=self.flush_every, mobility=mobility,
            migrate_every=self.migrate_every, seed=self.sim_seed,
            bits_fn=lambda w, _s=weakref.ref(self): _s()._wave_bits(
                w, mesh.device))
        return self.engine

    def _wave_bits(self, wave: int, device):
        """The codec's bits source of a run's wave ``wave``."""
        from repro_torch.comm.codecs import GeneratorBits
        if self._bits is None:
            self._bits = GeneratorBits(self.seed, device)
        if self.codec_bits is None:
            return self._bits
        return lambda leaf, client, shp: self.codec_bits(wave, leaf, client,
                                                         shp)

    def merge_params(self, state, cfg=None):
        """The engine's global params once it has merged, else the
        hierarchical mean of the client rows."""
        if self.engine is not None and self.engine.version > 0:
            return self.engine.global_params
        return super().merge_params(state, cfg)


@register_strategy("distill_fl")
class DistillFLStrategy(HierFLStrategy):
    """Federated personalized distillation (paper §3.3/§5.2): the cloud
    AD-LLM teaches per-pod LoRA students and **only adapter deltas ride
    the fabric**.

    ``init`` warms the AD-LLM on public (IID) driving data
    (``warmup_steps`` supervised waypoint steps), freezes it as the
    teacher and backbone, and hands every vehicle the same LoRA factor
    tree (B = 0). Each round
    (:func:`repro_torch.distill.federated.make_distill_round`) the
    students take ``local_steps`` distillation steps on their pod's
    non-IID partition through the fused base + low-rank kernel, factor
    deltas go through the codec with error feedback, pods partially
    average, and the cloud merge is blended back per pod (``mix``).

    State is ``({"base": frozen params, "factors": [C, ...] factor
    tree}, client Adam state)``; :meth:`merge_params` gives the global
    view (base + cloud-merged adapter) and :meth:`pod_params` a pod's
    personalized model. ``codec_bits`` as for ``hier_fl``.
    """

    loop = "distill"

    def __init__(self, *, learning_rate: float = 1e-2,
                 local_steps: int = 1, topology="2@nano*2,agx*2",
                 codec: str = "int8",
                 codec_options: Optional[Dict] = None,
                 client_weights: Optional[Any] = None,
                 async_decay: Optional[float] = None,
                 async_deadline: Optional[float] = None,
                 codec_bits: Optional[Callable] = None, seed: int = 0,
                 lora_rank: int = 4, lora_alpha: Optional[float] = None,
                 lora_targets: Optional[Tuple[str, ...]] = None,
                 kd_weight: float = 0.3, kd_temp: float = 2.0,
                 logit_weight: float = 0.1, mix: float = 0.5,
                 warmup_steps: int = 20, warmup_lr: float = 1e-3,
                 feature_dim: int = 32, feature_tokens: int = 8,
                 num_waypoints: int = 6, n_towns: int = 4,
                 samples_per_vehicle: int = 256, heldout: int = 64,
                 beta: float = 0.1, data_seed: int = 0):
        from repro_torch.distill.lora import DEFAULT_TARGETS, LoRAConfig
        super().__init__(learning_rate=learning_rate,
                         local_steps=local_steps, topology=topology,
                         codec=codec, codec_options=codec_options,
                         client_weights=client_weights,
                         async_decay=async_decay,
                         async_deadline=async_deadline,
                         codec_bits=codec_bits, seed=seed)
        self.lora_cfg = LoRAConfig(
            rank=lora_rank,
            alpha=float(lora_alpha if lora_alpha is not None
                        else 2 * lora_rank),
            targets=tuple(lora_targets or DEFAULT_TARGETS))
        self.kd_weight = kd_weight
        self.kd_temp = kd_temp
        self.logit_weight = logit_weight
        self.mix = mix
        self.warmup_steps = warmup_steps
        self.warmup_lr = warmup_lr
        self.feature_dim = feature_dim
        self.feature_tokens = feature_tokens
        self.num_waypoints = num_waypoints
        self.n_towns = n_towns
        self.samples_per_vehicle = samples_per_vehicle
        self.heldout = heldout
        self.beta = beta
        self.data_seed = data_seed
        self.warmup_history: Optional[list] = None
        self._base = None
        self._data = None
        self._round_ctr = 0

    # ---- configs / data ---------------------------------------------------
    def adllm_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The AD-LLM view of the session config (prefix features and a
        waypoint head); the base ``cfg`` still drives serving."""
        from repro_torch.distill.celladapt import adllm_config
        if cfg.family != "dense":
            raise ValueError(
                f"distill_fl needs a dense AD-LLM config, got family "
                f"{cfg.family!r}")
        return adllm_config(cfg, feature_dim=self.feature_dim,
                            feature_tokens=self.feature_tokens,
                            num_waypoints=self.num_waypoints)

    def _driving_cfg(self):
        from repro_torch.data.synthetic import DrivingDataConfig
        return DrivingDataConfig(n_towns=self.n_towns,
                                 patches=self.feature_tokens,
                                 feature_dim=self.feature_dim,
                                 num_waypoints=self.num_waypoints,
                                 seed=self.data_seed)

    def datasets(self, cfg, shape):
        """(per-vehicle train sets, per-pod held-out sets, pod mixtures)
        as numpy — built once per strategy lifetime, bit-equal to the
        reference's."""
        if self._data is None:
            from repro_torch.data.partition import pod_datasets
            self._data = pod_datasets(
                self._driving_cfg(), self.topology.member_indices,
                self.samples_per_vehicle, seq_len=shape.seq_len,
                vocab=self.adllm_cfg(cfg).vocab_size, beta=self.beta,
                seed=self.data_seed, heldout=self.heldout)
        return self._data

    def warmup_batches(self, cfg, shape):
        """The public-data batches of the supervised warmup, as numpy."""
        from repro_torch.data.partition import adllm_public_dataset
        from repro_torch.data.pipeline import batches as data_batches
        gb = shape.global_batch
        pub = adllm_public_dataset(
            self._driving_cfg(), max(self.warmup_steps * gb, gb),
            seq_len=shape.seq_len, vocab=self.adllm_cfg(cfg).vocab_size,
            seed=self.data_seed + 31)
        it = data_batches(pub, gb, seed=self.data_seed,
                          epochs=self.warmup_steps)
        return [b for _, b in zip(range(self.warmup_steps), it)]

    # ---- wire accounting: only the factor tree rides the uplink -----------
    def _wire_tree(self, cfg):
        from repro_torch.distill.celladapt import init_adllm
        from repro_torch.distill.lora import init_lora
        return init_lora(init_adllm(self.adllm_cfg(cfg), device="meta"),
                         self.lora_cfg)

    # ---- strategy protocol ------------------------------------------------
    def init(self, cfg, shape, mesh, seed):
        """Base from ``seed`` (warmed up), factors from ``seed + 2``, the
        codec's bits from ``seed + 1``."""
        from repro_torch.comm.codecs import GeneratorBits
        from repro_torch.core.fedavg import stack_clients
        from repro_torch.distill.celladapt import init_adllm
        from repro_torch.distill.federated import warmup_base
        from repro_torch.distill.lora import init_lora
        acfg = self.adllm_cfg(cfg)
        device = mesh.device
        base = init_adllm(acfg, seed=seed, device=device)
        if self.warmup_steps:
            warm = [{k: torch.as_tensor(v, device=device)
                     for k, v in b.items()}
                    for b in self.warmup_batches(cfg, shape)]
            base, self.warmup_history = warmup_base(base, acfg, warm,
                                                    lr=self.warmup_lr)
        factors = init_lora(base, self.lora_cfg, seed=seed + 2)
        n = self.topology.n_clients
        cf = stack_clients(factors, n)
        opt = self._optimizer().init(cf)._replace(
            step=torch.zeros((n,), dtype=torch.int32, device=device))
        self._base = base
        self._residual = None
        self._round = 0
        self._round_ctr = 0
        self._bits = GeneratorBits(seed + 1, device)
        return {"base": base, "factors": cf}, opt

    def make_step(self, cfg, shape, mesh):
        from repro_torch.comm.codecs import zero_residual
        from repro_torch.distill.federated import make_distill_round

        wire_metrics = self._wire_metrics(cfg)
        distill_round = make_distill_round(
            self.adllm_cfg(cfg), self._optimizer(), self.topology,
            self.codec, lora_cfg=self.lora_cfg, kd_weight=self.kd_weight,
            kd_temp=self.kd_temp, logit_weight=self.logit_weight,
            mix=self.mix, client_weights=self.client_weights,
            staleness=self.comm_stats["staleness"])

        def round_fn(client_factors, client_opt, batches, base):
            if self._residual is None:
                self._residual = zero_residual(client_factors)
            bits = self._round_bits(mesh.device)
            client_factors, client_opt, metrics, self._residual = \
                distill_round(client_factors, client_opt, batches, base,
                              self._residual, bits)
            self._round += 1
            return client_factors, client_opt, dict(metrics,
                                                    **wire_metrics)

        return round_fn

    def _unpack(self, params_like):
        if isinstance(params_like, dict) and "base" in params_like \
                and "factors" in params_like:
            return params_like["base"], params_like["factors"]
        if self._base is None:
            raise RuntimeError(
                "distill_fl has no frozen base yet; init the session "
                "(build/run) before asking for a merged view")
        return self._base, params_like

    def merge_params(self, state, cfg=None):
        """Global view: base + cloud-merged (hierarchical-mean) adapter."""
        from repro_torch.comm.hierarchy import hierarchical_mean
        from repro_torch.distill.lora import merge_lora
        base, factors = self._unpack(state[0])
        gf = hierarchical_mean(factors, self.client_weights, self.topology)
        return merge_lora(base, gf, self.lora_cfg)

    def teacher_params(self, state=None):
        """The frozen cloud teacher (warmed-up base, no adapter)."""
        if state is not None:
            return self._unpack(state[0])[0]
        if self._base is None:
            raise RuntimeError(
                "distill_fl has no frozen base yet; init the session "
                "(build/run) before asking for the teacher")
        return self._base

    def pod_params(self, state, pod: int):
        """Pod ``pod``'s personalized model: base + that pod's adapter
        (the mean of its members' factors) folded in."""
        from repro_torch.distill.lora import merge_lora
        from repro_torch.tree import tree_map
        base, factors = self._unpack(state[0])
        members = self.topology.member_indices
        if not 0 <= pod < len(members):
            raise ValueError(
                f"pod {pod} out of range for {len(members)} edge pods")
        idx = [int(i) for i in members[pod]]
        pf = tree_map(lambda x: x[torch.as_tensor(idx, device=x.device)]
                      .float().mean(dim=0), factors)
        return merge_lora(base, pf, self.lora_cfg)

    def default_batch(self, cfg, shape, gen):
        """The next round's [C, E, B, ...] batches from the vehicles'
        datasets (the generator only names the device: the data is
        numpy's, as the reference's)."""
        from repro_torch.data.pipeline import client_round_batches
        train, _, _ = self.datasets(cfg, shape)
        b = client_round_batches(train, self.local_steps,
                                 shape.global_batch,
                                 round_idx=self._round_ctr)
        self._round_ctr += 1
        return {k: torch.as_tensor(v, device=gen.device)
                for k, v in b.items()}
