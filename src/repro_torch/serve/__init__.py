"""repro_torch.serve — the edge serving tier on the card (port of
``repro/serve``).

Paged KV-cache (:mod:`repro_torch.serve.kvcache`), paged prefill/decode/
verify engine and its speculative draft proposer
(:mod:`repro_torch.serve.engine`), continuous-batching scheduler with
draft-verify speculative decoding and preemption
(:mod:`repro_torch.serve.scheduler`) and the fleet load generator
(:mod:`repro_torch.serve.loadgen`). :func:`serve_continuous` wires them
together behind one call.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.serve.engine import DraftEngine, PagedEngine
from repro_torch.serve.kvcache import (BlockAllocator, PagedCacheSpec,
                                       PrefixCache)
from repro_torch.serve.loadgen import (PrefillCostModel, SpecDecodeCostModel,
                                       drive, generate_fleet_requests,
                                       generate_pod_requests)
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["BlockAllocator", "ContinuousScheduler", "DraftEngine",
           "PagedCacheSpec", "PagedEngine", "PrefillCostModel",
           "PrefixCache", "ServeRequest", "SpecDecodeCostModel", "drive",
           "generate_fleet_requests", "generate_pod_requests",
           "int8_cache_fidelity", "serve_continuous"]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def int8_cache_fidelity(cfg: ModelConfig, params, requests, streams: Dict,
                        *, block_size: int = 8, max_context: int = 32,
                        prefill: str = "monolithic", prefill_chunk: int = 8,
                        device="cuda") -> Dict:
    """Teacher-forced int8-vs-model-dtype cache comparison.

    Replays each request's greedy ``streams`` (rid -> token list) through
    BOTH a model-dtype and an int8-cache engine, feeding the stream's
    token at every step regardless of what either engine would sample,
    so the reported disagreement is the per-position rate at which cache
    quantization alone changes the greedy token. Returns
    ``{"disagreement", "positions", "max_logit_drift"}``."""
    if prefill not in ("monolithic", "chunked"):
        raise ValueError(f"prefill must be monolithic|chunked, "
                         f"got {prefill!r}")
    cap = max(len(r.prompt) + len(streams[r.rid]) for r in requests)
    engines = {}
    for name, quant in (("fp32", False), ("int8", True)):
        spec = PagedCacheSpec.for_requests(1, cap, block_size=block_size,
                                           quantized=quant)
        engines[name] = PagedEngine(cfg, spec, max_context=max_context,
                                    slots=1, device=device)
    mism = tot = 0
    drift = 0.0
    for r in requests:
        stream = streams[r.rid]
        state = {}
        for name, eng in engines.items():
            alloc = BlockAllocator(eng.spec)
            blocks = alloc.alloc(
                eng.spec.blocks_needed(len(r.prompt) + len(stream)))
            tbl = np.zeros((1, eng.spec.max_blocks_per_req), np.int32)
            tbl[0, :len(blocks)] = blocks
            pools = eng.init_pools()
            if prefill == "chunked":
                pos, plen = 0, len(r.prompt)
                while pos < plen:
                    clen = min(prefill_chunk, plen - pos)
                    buf = np.zeros(prefill_chunk, np.int32)
                    buf[:clen] = np.asarray(r.prompt[pos:pos + clen],
                                            np.int32)
                    logits, pools = eng.prefill_chunk(params, pools, buf,
                                                      tbl[0], pos, clen)
                    pos += clen
            else:
                toks, length = eng.pad_prompt(r.prompt)
                logits, k, v = eng.prefill(params, toks, length)
                pools = eng.write_prefill(pools, k, v, tbl[0])
            state[name] = [pools, tbl, logits]
        for i in range(len(stream)):
            l32, l8 = state["fp32"][2], state["int8"][2]
            drift = max(drift, float((l32 - l8).abs().max()))
            if int(l32.argmax()) != int(l8.argmax()):
                mism += 1
            tot += 1
            if i == len(stream) - 1:
                break
            tok = np.asarray([stream[i]], np.int32)
            ctx = np.asarray([len(r.prompt) + i], np.int32)
            for name, eng in engines.items():
                pools, tbl, _ = state[name]
                logits, pools = eng.decode(params, pools, tok, tbl, ctx)
                state[name] = [pools, tbl, logits]
    return {"disagreement": mism / max(1, tot), "positions": tot,
            "max_logit_drift": drift}


def serve_continuous(cfg: ModelConfig, *, params=None, seed: int = 0,
                     slots: int = 4, block_size: int = 8,
                     max_context: int = 32, cache: str = "fp32",
                     policy: str = "continuous",
                     prefill: str = "chunked", prefill_chunk: int = 16,
                     prefix_cache: bool = False,
                     sampling: str = "greedy",
                     temperature: float = 1.0,
                     fleet: str = "nano*2,agx*2", num_requests: int = 12,
                     max_prompt: Optional[int] = None,
                     deadline_s: float = 4.0,
                     short_new: tuple = (4, 8), long_new: tuple = (32, 48),
                     long_frac: float = 0.2, warm_passes: int = 1,
                     requests=None, dt_step: float = 0.01,
                     prefill_cost=None, trace=None,
                     speculative: bool = False, draft_k: int = 4,
                     draft_params=None, preemption: Optional[bool] = None,
                     device="cuda",
                     log_fn: Optional[Callable] = print) -> Dict:
    """Serve a fleet request trace through the paged engine on ``device``.

    Runs the trace with identical requests: a cold pass (includes the
    first kernel builds and launches), then ``warm_passes`` passes on
    fresh schedulers whose best wall time defines the steady-state
    throughput. ``cache`` is ``"fp32"`` (pools in the model's dtype, the
    reference's name) or ``"int8"``. ``prefill`` selects chunked paged
    prefill (one ``prefill_chunk``-token chunk per step, interleaved with
    decode) or the monolithic bucketed baseline; ``prefix_cache`` turns
    on pod prefix-block sharing (chunked only). Pass ``requests`` to
    serve a custom trace instead of the built-in fleet trace. ``params``
    defaults to :func:`repro_torch.models.lm.init` seeded with ``seed``.
    Wall times end in a device synchronize. ``speculative=True`` turns on
    draft-verify speculative decoding (``draft_k`` drafts per lane per
    step from ``draft_params`` — e.g. a distilled pod student; defaults
    to self-drafting with the target weights) and, under chunked
    prefill, block-level preemption (override with ``preemption``); its
    sim clock defaults to a :class:`SpecDecodeCostModel`, which charges
    the draft forwards and the verify chunk. ``trace`` (a
    :class:`repro_torch.obs.Tracer` or a path) records the FINAL warm pass
    — one steady pass, not the cold one with the kernel builds — as
    sim-time queue/lane spans; a path is saved before returning.

    Returns the loadgen report plus both throughputs and the per-request
    token streams."""
    if cache not in ("fp32", "int8"):
        raise ValueError(f"cache must be fp32|int8, got {cache!r}")
    from repro_torch.obs import resolve_tracer
    tracer, trace_path = resolve_tracer(trace)
    if speculative and prefill_cost is None:
        # price draft forwards + the verify chunk instead of silently
        # charging k extra full target steps on the sim clock
        prefill_cost = SpecDecodeCostModel()
    from repro_torch.models import lm

    device = torch.device(device)
    if params is None:
        params = lm.init(cfg, seed=seed, device=device)
    max_prompt = max_prompt if max_prompt is not None else max_context // 2
    max_new_cap = max(short_new[1], long_new[1])
    if requests is not None:
        cap_tokens = max(len(r.prompt) + r.max_new_tokens
                         for r in requests)
    else:
        cap_tokens = max_prompt + max_new_cap
    spec = PagedCacheSpec.for_requests(slots, cap_tokens,
                                       block_size=block_size,
                                       quantized=(cache == "int8"))
    engine = PagedEngine(cfg, spec, max_context=max_context, slots=slots,
                         device=device)

    def fresh_requests():
        if requests is not None:
            return copy.deepcopy(requests)
        return generate_fleet_requests(
            fleet, num_requests=num_requests, max_prompt=max_prompt,
            seed=seed, deadline_s=deadline_s, short_new=short_new,
            long_new=long_new, long_frac=long_frac,
            vocab_size=cfg.vocab_size)

    def fresh_scheduler(tracer=None):
        return ContinuousScheduler(engine, params, policy=policy,
                                   prefill=prefill,
                                   prefill_chunk=prefill_chunk,
                                   prefix_cache=prefix_cache,
                                   sampling=sampling,
                                   temperature=temperature, seed=seed,
                                   tracer=tracer,
                                   speculative=speculative, draft_k=draft_k,
                                   draft_params=draft_params,
                                   preemption=preemption)

    def timed_pass(tracer=None):
        t0 = time.perf_counter()
        sched = fresh_scheduler(tracer)
        report = drive(sched, fresh_requests(), dt_step=dt_step,
                       prefill_cost=prefill_cost)
        _synchronize(device)
        return sched, report, time.perf_counter() - t0

    sched, _, cold_s = timed_pass()
    cold_toks = sched.total_new_tokens
    warm_s = float("inf")
    n_warm = max(1, warm_passes)
    for p in range(n_warm):
        sched, report, s = timed_pass(tracer if p == n_warm - 1 else None)
        warm_s = min(warm_s, s)
    if trace_path is not None:
        tracer.save(trace_path)

    report.update({
        "policy": policy,
        "prefill": prefill,
        "cache": cache,
        "slots": slots,
        "block_size": block_size,
        "device": str(device),
        "seconds_cold": cold_s,
        "tokens_per_s": cold_toks / max(cold_s, 1e-9),
        "seconds_warm": warm_s,
        "warm_tokens_per_s": report["total_new_tokens"]
        / max(warm_s, 1e-9),
        "sequences": {r.rid: list(r.tokens) for r in sched.finished},
    })
    if trace_path is not None:
        report["trace_path"] = trace_path
    if log_fn:
        if speculative:
            log_fn(f"[serve:specdec] k={draft_k} "
                   f"acceptance={report['acceptance_rate']:.2f} "
                   f"({report['accepted_drafts']}/"
                   f"{report['proposed_drafts']} drafts), "
                   f"{report.get('preemptions', 0)} preemptions")
        log_fn(f"[serve:{policy}/{cache}] {report['requests']} requests, "
               f"{report['total_new_tokens']} tokens in "
               f"{report['decode_steps']} decode steps on {device}; "
               f"{report['warm_tokens_per_s']:.1f} tok/s warm "
               f"({report['tokens_per_s']:.1f} cold), "
               f"p50 {report['p50_latency_s'] * 1e3:.0f}ms / "
               f"p99 {report['p99_latency_s'] * 1e3:.0f}ms sim latency")
    return report
