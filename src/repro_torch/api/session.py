"""``Session`` — the port's way to stand up FLAD training (port of
``repro/api/session.py``).

A Session composes a model config (``arch``, default ``flad-vision``,
any of ``repro_torch.configs.ARCH_IDS``;
the CPU-smoke reduced variant unless ``full=True``), an input shape, a
:class:`~repro_torch.api.mesh.MeshSpec` (default data 2 x model 4), a
registered :class:`~repro_torch.api.strategies.Strategy` (default
``pipeline``, FHDP) and :class:`~repro_torch.train.loop.LoopHooks` (log,
edge backup, checkpoint, live repartition), on one ``device`` (default
``"cuda"``): the mesh's ranks all run there::

    from repro_torch.api import Session
    out = Session().run(50)                   # FHDP on reduced flad-vision
    out = Session("flad-adllm", strategy="hier_fl", codec="int8",
                  shape="1024x4", full=True).run(2)
    from repro_torch.recovery.recover import Repartitioner
    ses = Session(strategy="swift_pipeline", mesh="2,2")   # SWIFT templates
    ses.build()         # vehicle 0 leaves after step index 1:
    ses.run(4, hooks=LoopHooks(repartition=Repartitioner(ses, {1: 0})))

The defaults are the reference's: with no arguments both Sessions train
reduced flad-vision with the ``pipeline`` strategy on a (2, 4) mesh, 2
sequences a rank.

``Session.serve`` serves the session's model: the legacy static-batch
scheduler (:func:`repro_torch.api.serving.serve_requests`) or the
continuous-batching tier (:func:`repro_torch.serve.serve_continuous`);
it needs no step of the session's strategy. ``run(trace=)`` records
the event engine's sim-time spans (async strategies),
``serve(trace=)`` the continuous scheduler's final warm pass, and
``run(profile=)`` wraps the loop in a ``torch.profiler`` capture.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.api.mesh import Mesh, MeshSpec
from repro_torch.api.strategies import Strategy, get_strategy
from repro_torch.config import INPUT_SHAPES, ModelConfig, ShapeConfig


def load_config(arch: str, *, full: bool = False) -> ModelConfig:
    """An arch name's ModelConfig — the reduced variant by default,
    the published scale with ``full=True``."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    return cfg if full else reduced(cfg)


def resolve_shape(shape: Union[ShapeConfig, str, None], *,
                  kind: str = "train") -> Optional[ShapeConfig]:
    """Accept a ShapeConfig, a named shape, 'SEQxBATCH', or None."""
    if shape is None or isinstance(shape, ShapeConfig):
        return shape
    if shape in INPUT_SHAPES:
        return INPUT_SHAPES[shape]
    s, b = (int(x) for x in shape.lower().split("x"))
    return ShapeConfig("cli", s, b, kind)


class Session:
    """One FLAD workload: config x shape x mesh x strategy x hooks on a
    device. ``mesh``: a MeshSpec, '2,4'-style text or dims (None: the
    default (2, 4))."""

    def __init__(self, arch: Optional[str] = None, *,
                 cfg: Optional[ModelConfig] = None, full: bool = False,
                 shape: Union[ShapeConfig, str, None] = None, mesh=None,
                 strategy: Union[str, Strategy] = "pipeline",
                 learning_rate: float = 1e-3, seed: int = 0, hooks=None,
                 device="cuda", **strategy_options):
        if cfg is None:
            cfg = load_config(arch or "flad-vision", full=full)
        self.cfg = cfg
        self.device = torch.device(device)
        self._mesh: Optional[Mesh] = None
        self.mesh_spec = MeshSpec.parse(mesh)
        self.seed = seed
        self.hooks = hooks
        if isinstance(strategy, Strategy):
            if strategy_options:
                raise ValueError(
                    f"strategy options {sorted(strategy_options)} are "
                    f"ignored when passing a Strategy instance; set them "
                    f"on the instance or pass the strategy by name")
            self.strategy = strategy
        else:
            self.strategy = get_strategy(strategy,
                                         learning_rate=learning_rate,
                                         **strategy_options)
        #: default shape: 128-token sequences, 2 per mesh rank
        self.shape = resolve_shape(shape) or ShapeConfig(
            "session", 128, 2 * self.mesh_spec.size, "train")
        self._built: Optional[Tuple[Callable, Any]] = None
        self.state: Optional[Tuple[Any, Any]] = None
        self.history: list = []

    @property
    def mesh(self) -> Mesh:
        """The session's mesh on its device (built once)."""
        if self._mesh is None:
            self._mesh = self.mesh_spec.build(self.device)
        return self._mesh

    def build(self, *, init: bool = True
              ) -> Tuple[Callable, Optional[Tuple[Any, Any]]]:
        """(step_fn, state): the strategy's step (or round) function and
        its state on this session's device. Cached; ``init=False`` skips
        the state (the caller supplies its own)."""
        if self._built is None:
            step = self.strategy.make_step(self.cfg, self.shape, self.mesh)
            self._built = (step, None)
        if init and self._built[1] is None:
            state = self.strategy.init(self.cfg, self.shape, self.mesh,
                                       self.seed)
            self._built = (self._built[0], state)
            self.state = state
        return self._built

    def rebuild(self, *, templates=None, state=None) -> Callable:
        """Drop the cached step and rebuild it — the runtime half of live
        dynamic repartitioning. ``templates`` replaces a template-bearing
        strategy's stage templates first; ``state`` becomes the session
        state (default: keep the current state — the session is never
        silently re-initialized)."""
        if templates is not None:
            if not hasattr(self.strategy, "templates"):
                raise ValueError(
                    f"strategy {self.strategy.name!r} has no stage "
                    f"templates to replace")
            self.strategy.templates = {k: tuple(v)
                                       for k, v in templates.items()}
        step = self.strategy.make_step(self.cfg, self.shape, self.mesh)
        if state is not None:
            self.state = state
        self._built = (step, self.state)
        return step

    def _checkpoint_meta(self) -> dict:
        """Sidecar metadata for checkpoints: enough to restage the raw
        (stage/client-stacked) container later."""
        meta = {"strategy": self.strategy.name, "arch": self.cfg.name}
        templates = getattr(self.strategy, "templates", None)
        if templates:
            meta["templates"] = {k: list(v) for k, v in templates.items()}
        return meta

    def merged_params(self, state=None):
        """Flat model params view of the current (or given) state."""
        state = state if state is not None else self.state
        if state is None:
            raise RuntimeError("no state yet; call build()/run() first")
        return self.strategy.merge_params(state, self.cfg)

    def default_batches(self, salt: int = 1) -> Iterator:
        """Endless synthetic step (or round) batches from a generator
        seeded with ``seed + salt`` on the session's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + salt)
        while True:
            yield self.strategy.default_batch(self.cfg, self.shape, gen)

    def run(self, steps: int, *, state=None, batches=None, hooks=None,
            trace=None, metrics=None, profile=None) -> Dict:
        """Train for ``steps`` steps (``train_loop``), FL rounds for round
        strategies (``fl_loop``), or cloud merges for the async strategy
        (``async_fl_loop``), and return the loop output.

        ``state``: (params, opt) to start from instead of the strategy's
        init (for ``distill_fl``, params is ``{"base", "factors"}``: the
        loop carries only the factors and hands the frozen base to every
        round as the teacher);
        ``batches``: an iterable of step batches; for round strategies a
        ``fn(round_idx) -> round batch`` or an iterable of round batches
        (default: synthetic; the async engine takes one a wave, so a
        finite list is cycled);
        ``trace``: a :class:`repro_torch.obs.Tracer` or a path — the event
        engine's sim-time spans (async strategies only: the sim clock
        lives there; a path is written when the loop returns,
        ``out["trace_path"]``);
        ``metrics``: a :class:`repro_torch.obs.MetricsRegistry` or a path
        that collects every logged round's scalar metrics and the
        engine's fabric counters (``out["metrics_path"]`` when a path);
        ``profile``: a :class:`repro_torch.obs.ProfileOptions` — the loop
        under a ``torch.profiler`` capture (``out["profile_path"]``).
        All three default off and add no work when off.

        An edge backup in ``hooks`` snapshots the merged flat params
        unless the hooks name a ``backup_view``; checkpoints get
        :meth:`_checkpoint_meta` as their sidecar unless the hooks name a
        ``checkpoint_meta``. A repartition hook may swap the step
        mid-run; the session keeps the swapped one."""
        from repro_torch.obs import MetricsRegistry, profiled, resolve_tracer
        from repro_torch.train.loop import LoopHooks, train_loop
        tracer, trace_path = resolve_tracer(trace)
        if tracer is not None and self.strategy.loop != "async":
            raise ValueError(
                f"trace= needs an async strategy (the event engine owns "
                f"the simulated clock); {self.strategy.name!r} runs a "
                f"{self.strategy.loop!r} loop — pass metrics= instead")
        if isinstance(metrics, str):
            registry, metrics_path = MetricsRegistry(), metrics
        else:
            registry, metrics_path = metrics, None
        step, init_state = self.build(init=state is None)
        if state is not None:
            init_state = state
        hooks = hooks or self.hooks or (
            LoopHooks() if self.strategy.loop == "step"
            else LoopHooks(log_every=1))
        if hooks.backup is not None and hooks.backup_view is None:
            # default the edge snapshot to the merged flat model, the form
            # recovery's restage() redeploys under a new template
            hooks = dataclasses.replace(
                hooks, backup_view=lambda p: self.strategy.merge_params(
                    (p, None), self.cfg))
        if hooks.checkpoint_path and hooks.checkpoint_meta is None:
            # record the live layout next to structured checkpoints (bound
            # method, so a mid-run repartition is reflected at save time)
            hooks = dataclasses.replace(
                hooks, checkpoint_meta=self._checkpoint_meta)
        if tracer is not None and hooks.tracer is None:
            hooks = dataclasses.replace(hooks, tracer=tracer)
        if registry is not None and hooks.metrics is None:
            hooks = dataclasses.replace(hooks, metrics=registry)
        params, opt = init_state
        with profiled(profile):
            if self.strategy.loop == "step":
                it = iter(batches) if batches is not None \
                    else self.default_batches()
                out = train_loop(step, params, opt, it, steps=steps,
                                 hooks=hooks)
                state = (out["params"], out["opt_state"])
            else:
                out = self._run_rounds(step, params, opt, batches, steps,
                                       hooks)
                state = (out["client_params"], out["client_opt"])
        if profile is not None and profile.trace_dir is not None:
            out["profile_path"] = profile.path
        if trace_path is not None:
            out["trace_path"] = tracer.save(trace_path)
        return self._finish(out["step_fn"], state, out, metrics_path,
                            registry)

    def _run_rounds(self, step, params, opt, batches, steps, hooks
                    ) -> Dict:
        """The round, distill and async loops of :meth:`run`."""
        from repro_torch.train.loop import async_fl_loop, fl_loop
        loop = self.strategy.loop
        if batches is None:
            it = self.default_batches()
            round_fn = lambda r: next(it)                # noqa: E731
        elif callable(batches):
            round_fn = batches
        else:
            if loop == "async" and hasattr(batches, "__len__"):
                # the event engine takes one batch a broadcast WAVE, and
                # async waves outnumber cloud merges: cycle a finite list
                batches = itertools.cycle(batches)
            round_fn = lambda r, _it=iter(batches): next(_it)  # noqa: E731
        if loop == "async":
            return async_fl_loop(step, params, opt, round_fn, rounds=steps,
                                 hooks=hooks)
        if loop == "distill":
            base = params["base"]
            out = fl_loop(step, params["factors"], opt, round_fn,
                          rounds=steps, hooks=hooks, teacher=base)
            out["client_params"] = {"base": base,
                                    "factors": out["client_params"]}
            return out
        return fl_loop(step, params, opt, round_fn, rounds=steps,
                       hooks=hooks)

    def _finish(self, step, state, out, metrics_path, registry):
        self.state = state
        self._built = (step, self.state)
        self.history.extend(out["history"])
        if metrics_path is not None:
            out["metrics_path"] = registry.save(metrics_path)
        return out

    def serve(self, *, requests: int = 3, batch: int = 8, context: int = 64,
              decode_steps: int = 16, params=None, scheduler: str = "legacy",
              sampling: str = "greedy", temperature: float = 1.0,
              pod: Optional[int] = None, trace=None,
              speculative: bool = False, draft_pod: Optional[int] = None,
              log_fn=print, **serve_options) -> Dict:
        """Serve the session's model on its device; uses the trained
        params when the session has run, else a fresh init from its seed.

        ``scheduler="legacy"``: the static-batch loop
        (:func:`repro_torch.api.serving.serve_requests`): ``requests``
        batches of ``batch`` prompts of ``context`` tokens, each one
        prefill and ``decode_steps`` decode steps. ``scheduler=
        "continuous"``: the paged-KV continuous-batching tier
        (:func:`repro_torch.serve.serve_continuous`): ``requests`` is the
        trace length, ``batch`` the lanes, ``context`` the monolithic
        prefill bucket; ``serve_options`` pass through. ``trace`` (a
        :class:`repro_torch.obs.Tracer` or a path) records the final warm
        pass's queue/lane spans on the simulated clock — continuous
        scheduler only; the legacy loop has no sim clock.

        ``pod``: serve edge pod ``pod``'s personalized model — the
        strategy's ``pod_params`` view (``distill_fl``: the base weights
        with that pod's LoRA adapter folded in) instead of the global
        merge.

        ``speculative``: draft-verify speculative decoding (continuous
        scheduler, greedy only). The draft model defaults to the target
        weights (self-draft); ``draft_pod`` drafts with pod
        ``draft_pod``'s distilled student — the same base weights with
        that pod's factors merged in, no second checkpoint
        (``distill_fl`` only). ``draft_k`` and ``preemption`` ride
        through ``serve_options``."""
        if pod is not None:
            if params is not None:
                raise ValueError("pass either params or pod, not both")
            if not hasattr(self.strategy, "pod_params"):
                raise ValueError(
                    f"strategy {self.strategy.name!r} has no per-pod "
                    f"personalized view (pod= needs distill_fl)")
            if self.state is None:
                raise RuntimeError("no state yet; run() before serving "
                                   "a personalized pod model")
            params = self.strategy.pod_params(self.state, pod)
        if draft_pod is not None and not speculative:
            raise ValueError("draft_pod= needs speculative=True")
        if speculative:
            if scheduler != "continuous":
                raise ValueError("speculative decoding needs "
                                 "scheduler='continuous'")
            serve_options["speculative"] = True
            if draft_pod is not None:
                if not hasattr(self.strategy, "pod_params"):
                    raise ValueError(
                        f"strategy {self.strategy.name!r} has no per-pod "
                        f"student to draft with (draft_pod= needs "
                        f"distill_fl)")
                if self.state is None:
                    raise RuntimeError(
                        "no state yet; run() before drafting with a "
                        "distilled pod student")
                serve_options["draft_params"] = self.strategy.pod_params(
                    self.state, draft_pod)
        if params is None and self.state is not None:
            params = self.merged_params()
        if scheduler == "continuous":
            from repro_torch.serve import serve_continuous
            return serve_continuous(self.cfg, params=params, seed=self.seed,
                                    slots=batch, max_context=context,
                                    num_requests=requests, sampling=sampling,
                                    temperature=temperature, trace=trace,
                                    device=self.device, log_fn=log_fn,
                                    **serve_options)
        if trace is not None:
            raise ValueError(
                "trace= needs scheduler='continuous' (the legacy static "
                "loop has no simulated clock to put spans on)")
        if scheduler != "legacy":
            raise ValueError(f"unknown scheduler {scheduler!r} "
                             "(legacy|continuous)")
        from repro_torch.api.serving import serve_requests
        return serve_requests(self.cfg, batch=batch, context=context,
                              decode_steps=decode_steps, requests=requests,
                              params=params, seed=self.seed,
                              sampling=sampling, temperature=temperature,
                              device=self.device, log_fn=log_fn,
                              **serve_options)
