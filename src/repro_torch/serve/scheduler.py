"""Continuous-batching scheduler over the paged engine (port of
``repro/serve/scheduler.py`` without speculative decoding, preemption and
tracing, which come with later slices).

Requests occupy one of ``slots`` fixed batch lanes. Every decode step
runs ONE fused forward over all lanes; the scheduler decides which
request sits in which lane:

  * ``policy="continuous"`` — a lane is refilled the moment its request
    finishes (vLLM-style continuous batching);
  * ``policy="rebatch"`` — the static-batching baseline: a wave is
    admitted only when all lanes are empty.

Prefill is decoupled from admission (Sarathi-style chunked prefill):
``_admit`` only reserves a lane and its blocks; AT MOST ONE prefill unit
runs per :meth:`step` (one fixed-size chunk in ``prefill="chunked"``
mode, one full bucketed prefill in ``prefill="monolithic"`` mode),
interleaved with the fused decode over every prefill-complete lane.
Lanes still prefilling are masked out of the decode batch (table, ctx
and token zeroed — they behave exactly like dead lanes pointing at the
null block).

Chunked mode optionally shares pod prompt prefixes through a
:class:`repro_torch.serve.kvcache.PrefixCache` (refcounted block sharing,
copy-on-write of the last block when a whole prompt is cached).
Admission is gated by the :class:`repro_torch.serve.kvcache
.BlockAllocator` (all-or-nothing reservation of prompt +
max_new_tokens) and ``max_inflight_blocks``; cold prefix entries are
LRU-evicted before admission gives up.

Determinism: greedy decoding makes the token streams a pure function of
(params, prompts). Temperature sampling draws from one
``torch.Generator`` seeded with ``seed`` on the engine's device, so a run
is reproducible given its seed (its draws differ from the reference's
JAX keys).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import kvcache as KC
from repro_torch.serve.engine import PagedEngine

_POLICIES = ("continuous", "rebatch")
_PREFILL_MODES = ("chunked", "monolithic")


@dataclasses.dataclass
class ServeRequest:
    """One generation request flowing through the scheduler."""
    rid: int
    prompt: np.ndarray                 # [s] int32
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: float = math.inf
    # filled by the scheduler:
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (arrival -> first sampled token)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_s

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Time spent waiting for a lane (arrival -> admission)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.arrival_s

    @property
    def met_deadline(self) -> bool:
        return self.t_done is not None and self.t_done <= self.deadline_s


class ContinuousScheduler:
    """Admit/prefill/decode/retire requests against a :class:`PagedEngine`."""

    def __init__(self, engine: PagedEngine, params, *,
                 policy: str = "continuous",
                 prefill: str = "chunked", prefill_chunk: int = 32,
                 prefix_cache: bool = False,
                 max_inflight_blocks: Optional[int] = None,
                 sampling: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, tracer=None, metrics=None,
                 speculative: bool = False,
                 preemption: Optional[bool] = None):
        if speculative or preemption:
            raise NotImplementedError(
                "speculative decoding and preemption come with the "
                "speculative-decoding slice of the port")
        if tracer is not None:
            raise NotImplementedError(
                "tracing comes with the observability slice of the port")
        if policy not in _POLICIES:
            raise ValueError(f"unknown policy {policy!r} ({_POLICIES})")
        if prefill not in _PREFILL_MODES:
            raise ValueError(
                f"unknown prefill mode {prefill!r} ({_PREFILL_MODES})")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefix_cache and prefill != "chunked":
            raise ValueError(
                "prefix_cache requires prefill='chunked' (monolithic "
                "write_prefill would clobber shared blocks)")
        self.engine = engine
        self.params = params
        self.policy = policy
        self.prefill_mode = prefill
        self.prefill_chunk = int(prefill_chunk)
        self.spec = engine.spec
        self.slots = engine.slots
        self.max_inflight_blocks = (max_inflight_blocks
                                    if max_inflight_blocks is not None
                                    else self.spec.num_blocks - 1)
        self.allocator = KC.BlockAllocator(self.spec)
        self.prefix: Optional[KC.PrefixCache] = (
            KC.PrefixCache(self.allocator) if prefix_cache else None)
        self.sampler = engine.make_sampler(sampling, temperature)
        self.generator = torch.Generator(device=engine.device)
        self.generator.manual_seed(seed)

        self.pools = engine.init_pools()
        self.tables = np.zeros((self.slots, self.spec.max_blocks_per_req),
                               np.int32)
        self.ctx = np.zeros(self.slots, np.int32)
        self.pending_tok = np.zeros(self.slots, np.int32)
        self.active: List[Optional[ServeRequest]] = [None] * self.slots
        self.blocks: List[Optional[List[int]]] = [None] * self.slots
        self.prefill_pos = np.zeros(self.slots, np.int32)
        self.prefill_done = np.zeros(self.slots, bool)
        self._prefill_queue: Deque[int] = collections.deque()
        self.waiting: Deque[ServeRequest] = collections.deque()
        self.finished: List[ServeRequest] = []
        # counters for the bench report
        self.decode_steps_run = 0
        self.prefills_run = 0            # monolithic full prefills
        self.prefill_chunks_run = 0
        self.total_new_tokens = 0
        # per-step cost stats for the loadgen's sim clock
        self.last_stats: Dict[str, int] = {}
        # requests stamped (first token / done) during the current step;
        # the loadgen finalizes their timestamps to the step's END time
        self.step_events: List[ServeRequest] = []
        # always-on registry (host-side dict updates only): the report
        # reads pool-occupancy stats from it
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    # ---- bookkeeping --------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.active)

    @property
    def idle(self) -> bool:
        return self.num_active == 0 and not self.waiting

    def submit(self, req: ServeRequest) -> None:
        if len(req.prompt) + req.max_new_tokens > self.engine.spec.max_tokens_per_req:
            raise ValueError(f"request {req.rid} needs "
                             f"{len(req.prompt) + req.max_new_tokens} tokens "
                             f"> table capacity")
        if (self.prefill_mode == "monolithic"
                and len(req.prompt) > self.engine.max_context):
            raise ValueError(f"request {req.rid} prompt exceeds max_context")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.waiting.append(req)

    def _retire(self, slot: int, t: float) -> None:
        req = self.active[slot]
        req.t_done = t
        self.step_events.append(req)
        self.finished.append(req)
        self.allocator.release(self.blocks[slot])
        self._clear_slot(slot)

    def _clear_slot(self, slot: int) -> None:
        self.active[slot] = None
        self.blocks[slot] = None
        self.tables[slot] = 0
        self.ctx[slot] = 0
        self.pending_tok[slot] = 0
        self.prefill_pos[slot] = 0
        self.prefill_done[slot] = False

    # ---- admission ----------------------------------------------------
    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh blocks under the inflight cap, LRU-evicting
        cold prefix-registry entries once if they are what's in the way."""
        def fits() -> bool:
            return (self.allocator.in_use + n <= self.max_inflight_blocks
                    and n <= self.allocator.free_blocks)
        if not fits() and self.prefix is not None:
            deficit = max(n - self.allocator.free_blocks,
                          self.allocator.in_use + n
                          - self.max_inflight_blocks)
            self.prefix.evict(deficit)
        if not fits():
            return None
        return self.allocator.alloc(n)

    def _admit(self, t: float) -> None:
        """Reserve lanes + blocks for waiting requests (bookkeeping only —
        prompt compute happens one prefill unit per :meth:`step`)."""
        if self.policy == "rebatch" and self.num_active > 0:
            return                      # wave semantics: drain first
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            prompt = np.asarray(req.prompt, np.int32)
            need = self.spec.blocks_needed(len(req.prompt)
                                           + req.max_new_tokens)
            shared: List[int] = []
            cow_src: Optional[int] = None
            resume = 0
            if self.prefix is not None:
                shared, cow_src, resume = self.prefix.match(prompt)
            fresh_need = need - len(shared)
            fresh = self._try_alloc(fresh_need)
            if fresh is None:
                # Undo the prefix refs and keep FIFO order (don't starve
                # the head by admitting a smaller request behind it).
                undo = shared + ([cow_src] if cow_src is not None else [])
                if undo:
                    self.allocator.release(undo)
                break
            self.waiting.popleft()
            if cow_src is not None:
                # Whole prompt was cached: clone the last shared block so
                # the final-token recompute writes a private copy.
                self.pools = self.engine.copy_block(self.pools, cow_src,
                                                    fresh[0])
                self.allocator.release([cow_src])
            if req.t_admit is None:
                req.t_admit = t
            self.active[slot] = req
            self.blocks[slot] = shared + fresh
            self.tables[slot] = 0
            self.tables[slot, :need] = shared + fresh
            self.ctx[slot] = 0
            self.pending_tok[slot] = 0
            self.prefill_pos[slot] = resume
            self.prefill_done[slot] = False
            self._prefill_queue.append(slot)

    # ---- prefill work -------------------------------------------------
    def _finish_prefill(self, slot: int, logits, t: float) -> None:
        req = self.active[slot]
        first = int(self.sampler(logits, self.generator)[0])
        req.tokens.append(first)
        req.t_first_token = t
        self.step_events.append(req)
        self.total_new_tokens += 1
        self.ctx[slot] = len(req.prompt)
        self.pending_tok[slot] = first
        self.prefill_done[slot] = True
        if self.prefix is not None:
            self.prefix.insert(np.asarray(req.prompt, np.int32),
                               self.tables[slot])
        if len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, t)

    def _run_prefill(self, t: float) -> None:
        """Run AT MOST ONE prefill unit: the oldest admitted lane still
        prefilling gets one chunk (chunked) or its whole bucketed prefill
        (monolithic)."""
        while self._prefill_queue and (
                self.active[self._prefill_queue[0]] is None
                or self.prefill_done[self._prefill_queue[0]]):
            self._prefill_queue.popleft()
        if not self._prefill_queue:
            return
        slot = self._prefill_queue[0]
        prompt = np.asarray(self.active[slot].prompt, np.int32)
        plen = len(prompt)
        if self.prefill_mode == "monolithic":
            toks, length = self.engine.pad_prompt(prompt)
            logits, k, v = self.engine.prefill(self.params, toks, length)
            self.pools = self.engine.write_prefill(self.pools, k, v,
                                                   self.tables[slot])
            self.prefills_run += 1
            self.prefill_pos[slot] = plen
            mc = self.engine.max_context
            self.last_stats["prefill_padded_tokens"] = mc
            self.last_stats["prefill_attn_mac"] = mc ** 2
            self.last_stats["prefill_wasted_tokens"] = mc - plen
            self._prefill_queue.popleft()
            self._finish_prefill(slot, logits, t)
            return
        c = self.prefill_chunk
        pos = int(self.prefill_pos[slot])
        clen = min(c, plen - pos)
        buf = np.zeros(c, np.int32)
        buf[:clen] = prompt[pos:pos + clen]
        logits, self.pools = self.engine.prefill_chunk(
            self.params, self.pools, buf, self.tables[slot], pos, clen)
        self.prefill_chunks_run += 1
        self.prefill_pos[slot] = pos + clen
        self.last_stats["prefill_padded_tokens"] = c
        self.last_stats["prefill_attn_mac"] = c * (pos + clen)
        self.last_stats["prefill_wasted_tokens"] = c - clen
        if pos + clen == plen:
            self._prefill_queue.popleft()
            self._finish_prefill(slot, logits, t)

    # ---- one step -----------------------------------------------------
    def step(self, t: float = 0.0) -> int:
        """Admit what fits, run at most one prefill unit, then one fused
        decode step across every prefill-complete lane. Returns the
        number of decode tokens emitted this step (``self.last_stats``
        carries the step's prefill cost breakdown for the sim clock)."""
        self.last_stats = {"prefill_padded_tokens": 0, "prefill_attn_mac": 0,
                           "prefill_wasted_tokens": 0}
        self.step_events = []
        self._admit(t)
        self._run_prefill(t)
        ready = np.array([self.active[i] is not None and self.prefill_done[i]
                          for i in range(self.slots)])
        if not ready.any():
            self._sample_metrics(0)
            return 0
        # Lanes still prefilling are masked to the dead-lane contract so
        # the fused decode never writes into their (possibly shared)
        # blocks: table 0 -> null block, ctx 0, token 0. The engine
        # copies these host arrays to the device before it launches.
        dec_tables = np.where(ready[:, None], self.tables, 0)
        dec_ctx = np.where(ready, self.ctx, 0).astype(np.int32)
        dec_tok = np.where(ready, self.pending_tok, 0).astype(np.int32)
        logits, self.pools = self.engine.decode(
            self.params, self.pools, dec_tok, dec_tables, dec_ctx)
        self.decode_steps_run += 1
        nxt = self.sampler(logits, self.generator).cpu().numpy()
        emitted = 0
        for slot in np.flatnonzero(ready):
            req = self.active[slot]
            self.ctx[slot] += 1
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.pending_tok[slot] = tok
            self.total_new_tokens += 1
            emitted += 1
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(slot, t)
        self._sample_metrics(emitted)
        return emitted

    def _sample_metrics(self, emitted: int) -> None:
        """Per-step registry samples (host dicts only): pool occupancy +
        its high-watermark, prefill waste, decode tokens, prefix hits."""
        m = self.metrics
        m.gauge("serve_pool_blocks_in_use",
                "KV block-pool occupancy per step (peak = watermark)"
                ).set(self.allocator.in_use)
        m.gauge("serve_pool_blocks_free",
                "free KV blocks per step").set(self.allocator.free_blocks)
        pad = self.last_stats.get("prefill_padded_tokens", 0)
        waste = self.last_stats.get("prefill_wasted_tokens", 0)
        if pad:
            m.counter("serve_prefill_padded_tokens",
                      "padded prompt tokens pushed through prefill"
                      ).inc(pad)
        if waste:
            m.counter("serve_prefill_wasted_tokens",
                      "padding beyond real prompt tokens").inc(waste)
        if emitted:
            m.counter("serve_decode_tokens", "decode tokens emitted"
                      ).inc(emitted)
        if self.prefix is not None:
            m.gauge("serve_prefix_hits", "prefix-cache hits (cumulative)"
                    ).set(self.prefix.hits)
            m.gauge("serve_prefix_misses",
                    "prefix-cache misses (cumulative)"
                    ).set(self.prefix.misses)
