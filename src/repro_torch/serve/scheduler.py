"""Continuous-batching scheduler over the paged engine (port of
``repro/serve/scheduler.py``).

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
LRU-evicted before admission gives up. With ``preemption`` (the default
in speculative mode under chunked prefill) admission has one more lever:
preempt the lowest-priority live lane — latest deadline, then latest
arrival — if it ranks strictly below the incoming request. The victim's
computed K/V chain (prompt, or prompt + emitted stream) is re-registered
in the prefix cache so its resume is a cache hit, its blocks go back
through the refcounted allocator, and it requeues at the head of the
waiting line behind the request that displaced it. Greedy resume is
exact: chunked prefill replays only the uncached tail of the chain and
the stream continues from its recorded last token.

``speculative=True`` replaces the per-step single-token decode with
draft-verify speculative decoding: a :class:`repro_torch.serve.engine
.DraftEngine` (e.g. the pod's distilled student) proposes up to
``draft_k`` greedy tokens per lane (``draft_k + 1`` batched draft
forwards, so the draft pools stay stream-complete even on a full accept),
then ONE batched target forward scores every draft position
(:meth:`PagedEngine.verify`, whose attention is one launch of the
batched verify kernel). Greedy exact-match acceptance emits the matched
prefix plus the target's own next token; the rejected tail's K/V rows
are rolled back bitwise (:func:`repro_torch.serve.kvcache.gather_rows`
snapshot before the verify append, :func:`repro_torch.serve.kvcache
.scatter_rows` restore after) and the lane's context rewinds to the
accepted length. Lanes near completion shrink their window to the tokens
they may still emit, which keeps every append inside the blocks reserved
at admission. With float32 params the streams are bitwise those of plain
greedy decode (every emitted token is the target's argmax given exactly
the prefix before it, and the verify kernel computes each float32 row in
the decode kernel's order); in bf16 the verify's k+1-row products round
differently from decode's one-row ones, so the streams can differ.

Host state: every array the scheduler hands to the engine is copied to
the device before the launch that reads it (the engine's ``_to_device``
makes a fresh tensor, never a view of the numpy buffer), so the
scheduler may mutate ``tables``/``ctx``/``pending_tok`` right after a
call.

Tracing: with a :class:`repro_torch.obs.Tracer` the scheduler emits the
reference's sim-time spans — a queue track (admission waits), a specdec
track (each speculative step's draft and verify) and one track per lane
(prefill chunks, first tokens, decode spans, preemptions) — plus a KV
block counter. Spans that end at a step's end, known only once the
load generator has priced the step, are deferred and emitted by
:meth:`ContinuousScheduler.flush_trace`. With no tracer no callback
fires, and the streams are bitwise those of a traced run.

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
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import trace as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import kernel_cost_args
from repro_torch.serve import kvcache as KC
from repro_torch.serve.engine import DraftEngine, PagedEngine, _to_device

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
    #: stable id echoed in every span this request produces in a trace
    #: (defaults to ``rid``; callers multiplexing several traces can set
    #: their own correlation id)
    trace_id: Optional[int] = None
    # filled by the scheduler:
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    def __post_init__(self):
        if self.trace_id is None:
            self.trace_id = self.rid

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
                 speculative: bool = False, draft_k: int = 4,
                 draft_params=None,
                 preemption: Optional[bool] = None):
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
        if speculative and sampling != "greedy":
            raise ValueError(
                "speculative decoding is defined by greedy exact-match "
                "acceptance; sampling must be 'greedy'")
        if preemption is None:
            # A lane's draft window is funded out of its admission
            # reservation, so speculative mode leans on preemption for
            # pool pressure; chunked prefill is what makes a preempted
            # lane's resume replay only the uncached tail.
            preemption = speculative and prefill == "chunked"
        if preemption and prefill != "chunked":
            raise ValueError(
                "preemption requires prefill='chunked' (a resumed chain "
                "can exceed the monolithic prefill bucket)")
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
        self.speculative = bool(speculative)
        self.preemption = bool(preemption)
        self.draft: Optional[DraftEngine] = None
        if self.speculative:
            # No draft model supplied -> self-draft with the target
            # weights (acceptance 1.0 in float32; smokes and plumbing).
            self.draft = DraftEngine(
                engine, params if draft_params is None else draft_params,
                draft_k=draft_k)
        self.draft_k = int(draft_k)

        self.pools = engine.init_pools()
        self.tables = np.zeros((self.slots, self.spec.max_blocks_per_req),
                               np.int32)
        self.ctx = np.zeros(self.slots, np.int32)
        self.pending_tok = np.zeros(self.slots, np.int32)
        self.active: List[Optional[ServeRequest]] = [None] * self.slots
        self.blocks: List[Optional[List[int]]] = [None] * self.slots
        self.prefill_pos = np.zeros(self.slots, np.int32)
        self.prefill_done = np.zeros(self.slots, bool)
        # per-slot prefill token chain: the prompt, or — for a request
        # resumed after preemption — prompt + the emitted stream whose
        # K/V the lane had already computed (all but the pending token)
        self._chain: List[Optional[np.ndarray]] = [None] * self.slots
        self._prefill_queue: Deque[int] = collections.deque()
        self.waiting: Deque[ServeRequest] = collections.deque()
        self.finished: List[ServeRequest] = []
        # counters for the bench report
        self.decode_steps_run = 0
        self.prefills_run = 0            # monolithic full prefills
        self.prefill_chunks_run = 0
        self.total_new_tokens = 0
        self.spec_steps_run = 0
        self.draft_forwards_run = 0
        self.proposed_drafts = 0         # draft tokens verify could use
        self.accepted_drafts = 0
        self.preemptions = 0
        # per-step cost stats for the loadgen's sim clock
        self.last_stats: Dict[str, int] = {}
        # requests stamped (first token / done) during the current step;
        # the loadgen finalizes their timestamps to the step's END time
        self.step_events: List[ServeRequest] = []
        #: optional :class:`repro_torch.obs.Tracer`: queue/lane spans on
        #: the sim clock; spans ending at the step's END are deferred as
        #: callables and emitted by :meth:`flush_trace`. None -> no
        #: callbacks, bitwise-identical streams.
        self.tracer = tracer
        if self.tracer is not None:
            self.tracer.process(T.SERVE_PID, "serving", sort_index=2)
            self.tracer.track(T.SERVE_PID, T.QUEUE_TID, "queue")
            if self.speculative:
                self.tracer.track(T.SERVE_PID, T.SPEC_TID, "specdec")
            for s in range(self.slots):
                self.tracer.track(T.SERVE_PID, T.lane_tid(s), f"lane {s}")
        self._pending_trace: List = []
        # always-on registry (host-side dict updates only): the report
        # reads pool-occupancy stats from it
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # register the speculative instruments eagerly so a spec
        # scheduler's snapshot always carries them, samples or not
        if self.speculative:
            self._accepted_hist()
        if self.preemption:
            self._preempt_counter()

    def _accepted_hist(self):
        return self.metrics.histogram(
            "serve_spec_accepted_len",
            "accepted draft tokens per lane per speculative step",
            buckets=tuple(float(i) for i in range(self.draft_k + 1)))

    def _preempt_counter(self):
        return self.metrics.counter(
            "serve_preemptions",
            "live lanes preempted to fund a higher-priority admission")

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
        if self.tracer is not None:
            def emit(t_end, cost_model, *, req=req, slot=slot):
                t0 = (req.t_first_token if req.t_first_token is not None
                      else req.t_done)
                self.tracer.complete(
                    "decode", t0, req.t_done, pid=T.SERVE_PID,
                    tid=T.lane_tid(slot), cat="decode",
                    args={"trace_id": req.trace_id, "rid": req.rid,
                          "new_tokens": len(req.tokens),
                          "latency_s": req.latency_s,
                          "met_deadline": req.met_deadline})
            self._pending_trace.append(emit)
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
        self._chain[slot] = None

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

    @staticmethod
    def _priority(req: ServeRequest):
        """Scheduling priority key; LARGER sorts lower-priority (latest
        deadline, then latest arrival, then highest rid)."""
        return (req.deadline_s, req.arrival_s, req.rid)

    def _pick_victim(self, incoming: ServeRequest) -> Optional[int]:
        """Lowest-priority live lane ranking strictly below ``incoming``
        (a preempted request can never preempt its displacer back, so
        admission cannot thrash)."""
        worst_slot = None
        worst = None
        for slot in range(self.slots):
            r = self.active[slot]
            if r is None:
                continue
            if worst is None or self._priority(r) > self._priority(worst):
                worst, worst_slot = r, slot
        if worst is None or self._priority(worst) <= self._priority(incoming):
            return None
        return worst_slot

    @staticmethod
    def _full_chain(req: ServeRequest) -> np.ndarray:
        """Prompt + every emitted token but the pending one: the chain a
        resumed request prefills (the whole prompt before its first)."""
        prompt = np.asarray(req.prompt, np.int32)
        if not req.tokens:
            return prompt
        return np.concatenate([prompt,
                               np.asarray(req.tokens[:-1], np.int32)])

    def _computed_chain(self, slot: int) -> np.ndarray:
        """The token chain whose K/V the lane holds: the prefilled prefix
        of its chain, or — once decoding — every emitted token except the
        pending one (its K/V is written by the NEXT forward)."""
        if not self.prefill_done[slot]:
            return np.asarray(self._chain[slot],
                              np.int32)[:int(self.prefill_pos[slot])]
        return self._full_chain(self.active[slot])

    def _preempt(self, slot: int, t: float) -> None:
        """Evict a live lane to fund a higher-priority admission.

        The lane's computed chain is re-registered in the prefix cache
        (so its resume replays only the uncached tail), its blocks are
        released through the refcounted allocator — registered blocks
        survive on the registry's reference — and the request requeues
        at the head of the waiting line."""
        req = self.active[slot]
        if self.prefix is not None:
            chain = self._computed_chain(slot)
            if len(chain) >= self.spec.block_size:
                self.prefix.insert(chain, self.tables[slot])
        self.preemptions += 1
        self._preempt_counter().inc()
        if self.tracer is not None:
            self.tracer.instant(
                "preempted", t, pid=T.SERVE_PID, tid=T.lane_tid(slot),
                cat="preempt",
                args={"trace_id": req.trace_id, "rid": req.rid,
                      "emitted_tokens": len(req.tokens)})
        self.allocator.release(self.blocks[slot])
        self._prefill_queue = collections.deque(
            s for s in self._prefill_queue if s != slot)
        self._clear_slot(slot)
        self.waiting.appendleft(req)

    def _admit(self, t: float) -> None:
        """Reserve lanes + blocks for waiting requests (bookkeeping only —
        prompt compute happens one prefill unit per :meth:`step`)."""
        if self.policy == "rebatch" and self.num_active > 0:
            return                      # wave semantics: drain first
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            # A request resumed after preemption prefills its full
            # computed chain (prompt + emitted stream minus the pending
            # token); greedy replay of the tail is exact.
            chain = self._full_chain(req)
            need = self.spec.blocks_needed(len(req.prompt)
                                           + req.max_new_tokens)
            shared: List[int] = []
            cow_src: Optional[int] = None
            resume = 0
            if self.prefix is not None:
                shared, cow_src, resume = self.prefix.match(chain)
            fresh_need = need - len(shared)
            fresh = self._try_alloc(fresh_need)
            if fresh is None and self.preemption:
                # Pop the incoming request first so preempted victims
                # requeue BEHIND it at the head of the line.
                self.waiting.popleft()
                while fresh is None:
                    victim = self._pick_victim(req)
                    if victim is None:
                        break
                    self._preempt(victim, t)
                    fresh = self._try_alloc(fresh_need)
                self.waiting.appendleft(req)
            if fresh is None:
                # Undo the prefix refs and keep FIFO order (don't starve
                # the head by admitting a smaller request behind it).
                undo = shared + ([cow_src] if cow_src is not None else [])
                if undo:
                    self.allocator.release(undo)
                break
            self.waiting.popleft()
            if cow_src is not None:
                # Whole chain was cached: clone the last shared block so
                # the final-token recompute writes a private copy.
                self.pools = self.engine.copy_block(self.pools, cow_src,
                                                    fresh[0])
                if self.draft is not None:
                    self.draft.copy_block(cow_src, fresh[0])
                self.allocator.release([cow_src])
            if req.t_admit is None:
                req.t_admit = t
            if self.tracer is not None:
                self.tracer.complete(
                    "queued", req.arrival_s, t, pid=T.SERVE_PID,
                    tid=T.QUEUE_TID, cat="queue",
                    args={"trace_id": req.trace_id, "rid": req.rid,
                          "slot": slot, "prompt_tokens": len(req.prompt),
                          "shared_blocks": len(shared),
                          "resume_tokens": resume,
                          "cow": cow_src is not None})
            self.active[slot] = req
            self.blocks[slot] = shared + fresh
            self.tables[slot] = 0
            self.tables[slot, :need] = shared + fresh
            self.ctx[slot] = 0
            self.pending_tok[slot] = 0
            self.prefill_pos[slot] = resume
            self.prefill_done[slot] = False
            self._chain[slot] = chain
            self._prefill_queue.append(slot)

    # ---- prefill work -------------------------------------------------
    def _finish_prefill(self, slot: int, logits, t: float) -> None:
        req = self.active[slot]
        chain = self._chain[slot]
        if req.tokens:
            # Preemption resume: the chain's last-token logits reproduce
            # the already-recorded pending token (greedy replay is
            # exact); pin it rather than re-emitting into the stream.
            first = int(req.tokens[-1])
        else:
            first = int(self.sampler(logits, self.generator)[0])
            req.tokens.append(first)
            req.t_first_token = t
            self.step_events.append(req)
            if self.tracer is not None:
                def emit(t_end, cost_model, *, req=req, slot=slot):
                    self.tracer.instant(
                        "first_token", req.t_first_token, pid=T.SERVE_PID,
                        tid=T.lane_tid(slot), cat="ttft",
                        args={"trace_id": req.trace_id, "rid": req.rid,
                              "ttft_s": req.ttft_s})
                self._pending_trace.append(emit)
            self.total_new_tokens += 1
        self.ctx[slot] = len(chain)
        self.pending_tok[slot] = first
        self.prefill_done[slot] = True
        if self.prefix is not None:
            self.prefix.insert(chain, self.tables[slot])
        if len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, t)

    def _run_prefill(self, t: float) -> None:
        """Run AT MOST ONE prefill unit: the oldest admitted lane still
        prefilling gets one chunk (chunked) or its whole bucketed prefill
        (monolithic). In speculative mode every unit is mirrored through
        the draft engine (same chunk, draft params, draft pools) so the
        draft cache tracks the target's logical layout."""
        while self._prefill_queue and (
                self.active[self._prefill_queue[0]] is None
                or self.prefill_done[self._prefill_queue[0]]):
            self._prefill_queue.popleft()
        if not self._prefill_queue:
            return
        slot = self._prefill_queue[0]
        req = self.active[slot]
        chain = self._chain[slot]
        plen = len(chain)
        if self.prefill_mode == "monolithic":
            toks, length = self.engine.pad_prompt(chain)
            logits, k, v = self.engine.prefill(self.params, toks, length)
            self.pools = self.engine.write_prefill(self.pools, k, v,
                                                   self.tables[slot])
            if self.draft is not None:
                self.draft.prefill(toks, length)
                self.draft.write_prefill(self.tables[slot])
                self._add_stat("draft_forwards", 1)
            self.prefills_run += 1
            self.prefill_pos[slot] = plen
            mc = self.engine.max_context
            self.last_stats["prefill_padded_tokens"] = mc
            self.last_stats["prefill_attn_mac"] = mc ** 2
            self.last_stats["prefill_wasted_tokens"] = mc - plen
            if self.tracer is not None:
                self._pending_prefill_span(
                    "prefill", t, slot, req, 0, plen, mc, mc ** 2)
            self._prefill_queue.popleft()
            self._finish_prefill(slot, logits, t)
            return
        c = self.prefill_chunk
        pos = int(self.prefill_pos[slot])
        clen = min(c, plen - pos)
        buf = np.zeros(c, np.int32)
        buf[:clen] = chain[pos:pos + clen]
        logits, self.pools = self.engine.prefill_chunk(
            self.params, self.pools, buf, self.tables[slot], pos, clen)
        if self.draft is not None:
            self.draft.prefill_chunk(buf, self.tables[slot], pos, clen)
            self._add_stat("draft_forwards", 1)
        self.prefill_chunks_run += 1
        self.prefill_pos[slot] = pos + clen
        self.last_stats["prefill_padded_tokens"] = c
        self.last_stats["prefill_attn_mac"] = c * (pos + clen)
        self.last_stats["prefill_wasted_tokens"] = c - clen
        if self.tracer is not None:
            self._pending_prefill_span("prefill_chunk", t, slot, req,
                                       pos, pos + clen, c, c * (pos + clen))
        if pos + clen == plen:
            self._prefill_queue.popleft()
            self._finish_prefill(slot, logits, t)

    # ---- tracing (repro_torch.obs) ------------------------------------
    def _pending_prefill_span(self, name: str, t0: float, slot: int, req,
                              tok0: int, tok1: int, padded: int,
                              mac: int) -> None:
        """Defer a prefill span until the step's end is known."""
        def emit(t_end, cost_model, *, name=name, t0=t0, slot=slot,
                 req=req, tok0=tok0, tok1=tok1, padded=padded, mac=mac):
            self.tracer.complete(
                name, t0, t_end, pid=T.SERVE_PID, tid=T.lane_tid(slot),
                cat="prefill",
                args=dict(kernel_cost_args(padded_tokens=padded,
                                           attn_mac=mac,
                                           cost_model=cost_model),
                          trace_id=req.trace_id, rid=req.rid,
                          tokens=[tok0, tok1]))
        self._pending_trace.append(emit)

    def flush_trace(self, t_end: float, cost_model=None) -> None:
        """Emit the step's deferred spans now that its sim-time end (and
        optionally the :class:`repro_torch.serve.loadgen.PrefillCostModel`
        that priced it) is known. The caller restamps ``step_events``
        first, so request timestamps inside spans are final."""
        if self._pending_trace:
            for fn in self._pending_trace:
                fn(t_end, cost_model)
            self._pending_trace = []

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
            self._sample_metrics(t, 0)
            return 0
        if self.speculative:
            emitted = self._spec_step(ready, t)
            self._sample_metrics(t, emitted)
            return emitted
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
        self._sample_metrics(t, emitted)
        return emitted

    def _add_stat(self, key: str, n: int) -> None:
        self.last_stats[key] = self.last_stats.get(key, 0) + n

    def _spec_step(self, ready: np.ndarray, t: float) -> int:
        """One draft-verify speculative step over every ready lane.

        Drafts up to ``draft_k`` greedy tokens per lane through the draft
        engine, verifies all of them in ONE batched target forward
        (:meth:`PagedEngine.verify`), emits the exact-match prefix plus
        the target's own next token, and rolls the rejected tail's K/V
        back bitwise. Per-lane windows shrink to the tokens a lane may
        still emit, so appends never leave the blocks reserved at
        admission."""
        k = self.draft_k
        c = k + 1
        bs = self.spec.block_size
        dev = self.engine.device
        remaining = np.array(
            [self.active[s].max_new_tokens - len(self.active[s].tokens)
             if ready[s] else 0 for s in range(self.slots)], np.int32)
        window = np.minimum(c, remaining)               # [slots]
        live = window > 0
        dec_tables = np.where(live[:, None], self.tables, 0).astype(np.int32)
        ctx = np.where(live, self.ctx, 0).astype(np.int32)
        pend = np.where(live, self.pending_tok, 0).astype(np.int32)

        drafts = self.draft.propose(pend, dec_tables, ctx, window)
        self.draft_forwards_run += k + 1
        self._add_stat("draft_forwards", k + 1)

        # rollback snapshot of every pool row the verify append may touch
        cols = np.arange(c, dtype=np.int32)[None, :]
        positions = ctx[:, None] + cols                 # [slots, C]
        valid = cols < window[:, None]
        safe_pos = np.where(valid, positions, 0)
        phys = np.take_along_axis(dec_tables, safe_pos // bs, axis=1)
        phys = np.where(valid, phys, 0).astype(np.int32)
        off = np.where(valid, safe_pos % bs, 0).astype(np.int32)
        saved = KC.gather_rows(self.pools, _to_device(phys.reshape(-1), dev),
                               _to_device(off.reshape(-1), dev))

        tokens = np.concatenate([pend[:, None], drafts], axis=1)
        logits, self.pools = self.engine.verify(
            self.params, self.pools, tokens, dec_tables, ctx, window)
        self.decode_steps_run += 1
        self.spec_steps_run += 1
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

        # greedy exact-match acceptance (pure; mutations follow rollback)
        accepted = np.zeros(self.slots, np.int32)
        for slot in np.flatnonzero(live):
            w = int(window[slot])
            a = 0
            while a < w - 1 and greedy[slot, a] == drafts[slot, a]:
                a += 1
            accepted[slot] = a

        # roll the rejected tail back to the never-drafted pool state
        restore = valid & (cols > accepted[:, None])
        if restore.any():
            r_phys = np.where(restore, phys, 0).reshape(-1)
            r_off = np.where(restore, off, 0).reshape(-1)
            self.pools = KC.scatter_rows(self.pools, saved,
                                         _to_device(r_phys, dev),
                                         _to_device(r_off, dev))

        hist = self._accepted_hist()
        emitted = 0
        for slot in np.flatnonzero(live):
            req = self.active[slot]
            w = int(window[slot])
            a = int(accepted[slot])
            out = [int(x) for x in drafts[slot, :a]] + [int(greedy[slot, a])]
            req.tokens.extend(out)
            self.ctx[slot] = int(ctx[slot]) + a + 1
            self.pending_tok[slot] = out[-1]
            self.total_new_tokens += len(out)
            emitted += len(out)
            self.proposed_drafts += w - 1
            self.accepted_drafts += a
            hist.observe(float(a))
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(slot, t)

        n_live = int(live.sum())
        verify_tokens = int(window.sum())
        verify_mac = int(sum(int(w) * (int(cx) + int(w))
                             for w, cx in zip(window, ctx) if w > 0))
        self._add_stat("verify_tokens", verify_tokens)
        self._add_stat("verify_attn_mac", verify_mac)
        if self.tracer is not None:
            def emit_spec(t_end, cost_model, *, t0=t, n_live=n_live,
                          verify_tokens=verify_tokens,
                          verify_mac=verify_mac, emitted=emitted,
                          acc=int(accepted.sum())):
                mid = t0 + (t_end - t0) * 0.5
                self.tracer.complete(
                    "draft", t0, mid, pid=T.SERVE_PID, tid=T.SPEC_TID,
                    cat="spec",
                    args={"forwards": k + 1, "lanes": n_live})
                self.tracer.complete(
                    "verify", mid, t_end, pid=T.SERVE_PID, tid=T.SPEC_TID,
                    cat="spec",
                    args={"tokens": verify_tokens, "attn_mac": verify_mac,
                          "accepted_drafts": acc, "emitted": emitted})
            self._pending_trace.append(emit_spec)
        return emitted

    def run_to_completion(self, requests: Sequence[ServeRequest],
                          max_steps: int = 100_000) -> List[ServeRequest]:
        """Convenience driver: submit everything at t=0 and step until
        drained (the loadgen drives arrivals through real event time)."""
        for r in requests:
            self.submit(r)
        steps = 0
        while not self.idle:
            self.step(float(steps))
            # no cost model here: the step's end is the next integer tick
            self.flush_trace(float(steps) + 1.0)
            steps += 1
            if steps > max_steps:
                raise RuntimeError("scheduler failed to drain")
        return self.finished

    def _sample_metrics(self, t: float, emitted: int) -> None:
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
        if self.tracer is not None:
            self.tracer.counter("kv blocks", t,
                                {"in_use": self.allocator.in_use},
                                pid=T.SERVE_PID)
