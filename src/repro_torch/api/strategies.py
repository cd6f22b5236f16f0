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
``pipeline`` (FHDP: FL columns x pipeline stages), ``fl_pipeline``
(FedAvg rounds of FHDP local steps), ``fedavg`` (flat FedAvg rounds over
client-stacked params), ``hier_fl`` (the same rounds over the explicit
vehicle -> edge -> cloud fabric of :mod:`repro_torch.comm`) and
``distill_fl`` (per-pod LoRA students distilled from a frozen AD-LLM,
adapter deltas on the fabric). The reference's other strategies raise
``NotImplementedError`` by name; so do the sharding specs
(``param_specs``), which only shape a lowering.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.configs.common import concrete_batch

_REGISTRY: Dict[str, Type["Strategy"]] = {}

#: strategies of the reference that later slices of the port bring
LATER = ("swift_pipeline", "async_hier_fl")

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
    """Instantiate a registered strategy; the reference's strategies that
    are not ported yet raise NotImplementedError, unknown names
    ValueError."""
    if name in LATER:
        raise NotImplementedError(
            f"strategy {name!r} comes with a later slice of the port "
            f"(ported: {', '.join(available_strategies())})")
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
    #: fl_loop; "distill" -> fl_loop with the frozen base as the teacher)
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
        from repro_torch.models.lm import init
        device = mesh.device
        params0 = init(cfg, seed=seed, device=device).to_dict()
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
        from repro_torch.models.lm import abstract_params
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
