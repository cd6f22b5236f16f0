"""Strategy protocol + registry (port of ``repro/api/strategies.py``).

A :class:`Strategy` owns what an execution mode needs:

  * ``init(cfg, shape, device, seed) -> (params_like, opt_like)`` —
    trainable state in the strategy's layout on ``device``;
  * ``make_step(cfg, shape, device) -> step`` — ``(params, opt, batch) ->
    (params, opt, metrics)``, a whole FL round for round strategies;
  * :meth:`Strategy.merge_params`, the flat model params of a state.

The reference takes a device mesh where this port takes one ``device``:
the port runs on one card. Ported: ``fedavg`` (flat FedAvg rounds over
client-stacked params) and ``hier_fl`` (the same rounds over the explicit
vehicle -> edge -> cloud fabric of :mod:`repro_torch.comm`). The
reference's other strategies raise ``NotImplementedError`` by name.
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
LATER = ("tensor", "pipeline", "swift_pipeline", "fl_pipeline",
         "async_hier_fl", "distill_fl")


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
    #: which driver Session.run uses ("round" -> fl_loop)
    loop: str = "round"

    def __init__(self, *, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    @abc.abstractmethod
    def init(self, cfg: ModelConfig, shape: ShapeConfig, device, seed: int
             ) -> Tuple[Any, Any]:
        """Materialize (params_like, opt_like) in this strategy's layout."""

    @abc.abstractmethod
    def make_step(self, cfg: ModelConfig, shape: ShapeConfig, device
                  ) -> Callable:
        """(params, opt, batch) -> (params, opt, metrics)."""

    def merge_params(self, state, cfg: Optional[ModelConfig] = None):
        """Collapse strategy state to flat model params."""
        return state[0]

    @abc.abstractmethod
    def default_batch(self, cfg: ModelConfig, shape: ShapeConfig,
                      gen: torch.Generator):
        """One synthetic batch matching ``make_step``'s input, drawn from
        ``gen``."""


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

    def init(self, cfg, shape, device, seed):
        from repro_torch.core.fedavg import stack_clients
        from repro_torch.models.lm import init
        params0 = init(cfg, seed=seed, device=device).to_dict()
        cp = stack_clients(params0, self.n_clients())
        return cp, self._optimizer().init(cp)._replace(
            step=torch.zeros((self.n_clients(),), dtype=torch.int32,
                             device=device))

    def make_step(self, cfg, shape, device):
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

    def _round_stats(self, cfg) -> Dict:
        """Per-round wire accounting from the link models."""
        from repro_torch.comm.codecs import tree_edge_nbytes, tree_nbytes
        from repro_torch.comm.hierarchy import staleness_weights
        from repro_torch.models.lm import abstract_params
        ptree = abstract_params(cfg)
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

    def init(self, cfg, shape, device, seed):
        from repro_torch.comm.codecs import GeneratorBits
        state = super().init(cfg, shape, device, seed)
        self._residual = None           # fresh error-feedback state
        self._round = 0
        # the codec's rounding stream derives from the init seed, so a
        # re-init restarts it
        self._bits = GeneratorBits(seed + 1, device)
        return state

    def make_step(self, cfg, shape, device):
        from repro_torch.comm.codecs import GeneratorBits, zero_residual
        from repro_torch.comm.hierarchy import make_hier_round

        stats = self._round_stats(cfg)
        self.comm_stats = stats
        hier_round = make_hier_round(
            cfg, shape, self._optimizer(), self.topology, self.codec,
            local_steps=self.local_steps, remat=self.remat,
            client_weights=self.client_weights,
            staleness=stats["staleness"])
        wire_metrics = {
            "comm_bytes_up": float(stats["uplink_bytes"]),
            "comm_bytes_backhaul": float(stats["backhaul_bytes"]),
            "sim_round_s": float(stats["round_time_s"]),
        }

        def round_fn(client_params, client_opt, batches):
            if self._bits is None:
                self._bits = GeneratorBits(self.seed, device)
            if self._residual is None:
                self._residual = zero_residual(client_params)
            r = self._round
            bits = self._bits if self.codec_bits is None else (
                lambda leaf, client, shp: self.codec_bits(r, leaf, client,
                                                          shp))
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
