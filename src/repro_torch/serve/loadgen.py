"""Fleet load generator: vehicle request arrivals -> scheduler -> report
(port of ``repro/serve/loadgen.py``).

Each vehicle in a :func:`repro_torch.sched.costmodel.parse_fleet` fleet
emits inference requests whose *arrival times* are its request epoch plus
the V2X uplink time of the prompt payload; each request carries a
deadline (arrival + ``deadline_s``). Decode lengths are drawn bimodal —
mostly short control-style replies with a heavy tail of long plans.
Traces are drawn from numpy generators seeded with ``seed``, so they come
out identical to the reference's.

The simulated clock advances ``dt_step`` per scheduler step (plus the
prefill compute the step ran, under a :class:`PrefillCostModel`, and the
draft forwards and verify chunk of a speculative step, under a
:class:`SpecDecodeCostModel`) and
jumps to the next arrival when the scheduler goes idle; it orders
admissions and scores deadlines. Wall-clock throughput comes from real
timers around the same loop (:func:`repro_torch.serve.serve_continuous`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.comm.events import EventQueue
from repro_torch.sched.costmodel import parse_fleet, t_uplink
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

#: serialized prompt-token payload over V2X (int32 id + embedding-free
#: metadata; the KV never leaves the edge)
BYTES_PER_PROMPT_TOKEN = 64


@dataclasses.dataclass(frozen=True)
class RequestArrival:
    """A vehicle's inference request landing at the edge."""
    t: float
    rid: int
    vehicle: int
    kind: ClassVar[str] = "request_arrival"


def generate_fleet_requests(fleet_spec, *, num_requests: int,
                            max_prompt: int, seed: int = 0,
                            period_s: float = 0.05,
                            deadline_s: float = 2.0,
                            short_new: tuple = (4, 8),
                            long_new: tuple = (32, 48),
                            long_frac: float = 0.2,
                            vocab_size: int = 512
                            ) -> List[ServeRequest]:
    """Deterministic request trace for a declarative fleet spec.

    Vehicles round-robin request epochs ``period_s`` apart; each arrival
    is delayed by its prompt's uplink time over that vehicle's V2X link.
    Decode lengths are bimodal (``long_frac`` of requests draw from
    ``long_new``, the rest from ``short_new``)."""
    fleet = parse_fleet(fleet_spec) if isinstance(fleet_spec, str) \
        else list(fleet_spec)
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(num_requests):
        v = fleet[rid % len(fleet)]
        plen = int(rng.integers(2, max_prompt + 1))
        prompt = rng.integers(1, vocab_size, (plen,)).astype(np.int32)
        if rng.random() < long_frac:
            lo, hi = long_new
        else:
            lo, hi = short_new
        max_new = int(rng.integers(lo, hi + 1))
        epoch = (rid // len(fleet)) * period_s
        arrival = epoch + t_uplink(plen * BYTES_PER_PROMPT_TOKEN, v)
        out.append(ServeRequest(rid=rid, prompt=prompt,
                                max_new_tokens=max_new,
                                arrival_s=arrival,
                                deadline_s=arrival + deadline_s))
    return out


def generate_pod_requests(fleet_spec, *, num_requests: int, pods: int = 2,
                          template_len: int = 24, max_suffix: int = 8,
                          seed: int = 0, period_s: float = 0.05,
                          deadline_s: float = 2.0,
                          short_new: tuple = (4, 8),
                          long_new: tuple = (32, 48),
                          long_frac: float = 0.2,
                          vocab_size: int = 512) -> List[ServeRequest]:
    """Pod-templated request trace: shared prefix + unique suffix.

    FLAD's vehicles cluster into geographic pods whose AD prompts share a
    templated scene/instruction preamble; only the tail (ego state, query)
    differs per vehicle. Each of ``pods`` pods draws one fixed
    ``template_len``-token template, and every request from that pod's
    vehicles is ``template + suffix`` with a unique 1..``max_suffix``
    token suffix — exactly the shape the serving tier's prefix cache
    exploits. Arrivals/deadlines/decode lengths follow
    :func:`generate_fleet_requests`."""
    fleet = parse_fleet(fleet_spec) if isinstance(fleet_spec, str) \
        else list(fleet_spec)
    rng = np.random.default_rng(seed)
    templates = [rng.integers(1, vocab_size, (template_len,)).astype(np.int32)
                 for _ in range(pods)]
    out = []
    for rid in range(num_requests):
        v = fleet[rid % len(fleet)]
        pod = (rid % len(fleet)) % pods
        slen = int(rng.integers(1, max_suffix + 1))
        suffix = rng.integers(1, vocab_size, (slen,)).astype(np.int32)
        prompt = np.concatenate([templates[pod], suffix])
        if rng.random() < long_frac:
            lo, hi = long_new
        else:
            lo, hi = short_new
        max_new = int(rng.integers(lo, hi + 1))
        epoch = (rid // len(fleet)) * period_s
        arrival = epoch + t_uplink(len(prompt) * BYTES_PER_PROMPT_TOKEN, v)
        out.append(ServeRequest(rid=rid, prompt=prompt,
                                max_new_tokens=max_new,
                                arrival_s=arrival,
                                deadline_s=arrival + deadline_s))
    return out


@dataclasses.dataclass(frozen=True)
class PrefillCostModel:
    """Sim-time surcharge for the prefill compute a step actually ran.

    ``s_per_token`` prices the linear work (embed/qkv/ffn) of every
    *padded* prompt token the step pushed through the model —
    ``max_context`` for a monolithic prefill, the chunk size for a
    chunked one — and ``s_per_mac`` prices attention score entries
    (query rows x visible keys). The defaults are nominal edge-GPU
    magnitudes; the TTFT gate compares two runs under the SAME model, so
    only the ratio matters."""
    s_per_token: float = 5e-5
    s_per_mac: float = 2e-9

    def step_cost(self, stats: Dict) -> float:
        return (stats.get("prefill_padded_tokens", 0) * self.s_per_token
                + stats.get("prefill_attn_mac", 0) * self.s_per_mac)


@dataclasses.dataclass(frozen=True)
class SpecDecodeCostModel(PrefillCostModel):
    """Sim-time pricing for speculative draft-verify steps.

    A speculative step's target-side cost IS the ``dt_step`` every step
    already pays — the batched verify is one target forward, weight-load
    bound like a plain decode step — so the surcharges here are only what
    speculation ADDS: ``s_per_draft_forward`` per draft-model forward
    (the distilled compact student, deployed at a fraction of the
    teacher's cost — the default is dt_step/8), plus the verify chunk's
    extra linear work (``verify_tokens`` x ``s_per_token``) and attention
    score MACs (``verify_attn_mac`` x ``s_per_mac``). Draft prefill
    mirroring is charged one draft forward per mirrored unit. What
    speculation BUYS is up to ``draft_k + 1`` tokens per lane out of that
    single priced step instead of one."""
    s_per_draft_forward: float = 0.00125

    def step_cost(self, stats: Dict) -> float:
        return (super().step_cost(stats)
                + stats.get("draft_forwards", 0) * self.s_per_draft_forward
                + stats.get("verify_tokens", 0) * self.s_per_token
                + stats.get("verify_attn_mac", 0) * self.s_per_mac)


def _pct(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            int(math.ceil(p / 100.0 * len(sorted_vals))) - 1)
    return sorted_vals[max(0, i)]


def drive(scheduler: ContinuousScheduler,
          requests: Sequence[ServeRequest], *,
          dt_step: float = 0.01,
          prefill_cost: Optional[PrefillCostModel] = None,
          max_steps: int = 1_000_000) -> Dict:
    """Push the request trace through the scheduler in event-time order.

    Arrivals enter a :class:`EventQueue`; the simulated clock advances
    ``dt_step`` per scheduler step (plus the step's prefill compute under
    ``prefill_cost``, when given) and jumps forward when the scheduler is
    idle and the next arrival is still in flight. Returns the latency /
    TTFT / deadline report."""
    q = EventQueue()
    by_rid = {}
    for r in requests:
        q.push(RequestArrival(t=r.arrival_s, rid=r.rid, vehicle=0))
        by_rid[r.rid] = r
    t = 0.0
    steps = 0
    pref_tokens = pref_mac = 0
    while len(q) or not scheduler.idle:
        # drain every arrival that has landed by now
        while len(q) and q.peek_t() <= t:
            ev = q.pop()
            scheduler.submit(by_rid[ev.rid])
        if scheduler.idle:
            if not len(q):
                break
            t = q.peek_t()          # nothing in flight: jump to next landing
            continue
        scheduler.step(t)
        pref_tokens += scheduler.last_stats.get("prefill_padded_tokens", 0)
        pref_mac += scheduler.last_stats.get("prefill_attn_mac", 0)
        t_end = t + dt_step
        if prefill_cost is not None:
            t_end += prefill_cost.step_cost(scheduler.last_stats)
        # first-token / completion events happen when the step's compute
        # finishes, not when it is issued — finalize their timestamps to
        # the step's end so a prefill's cost lands in its own TTFT
        for r in scheduler.step_events:
            if r.t_first_token == t:
                r.t_first_token = t_end
            if r.t_done == t:
                r.t_done = t_end
        # deferred spans read the (now final) restamped timestamps
        scheduler.flush_trace(t_end, cost_model=prefill_cost)
        t = t_end
        steps += 1
        if steps > max_steps:
            raise RuntimeError("loadgen failed to drain the request trace")

    done = scheduler.finished
    lats = sorted(r.latency_s for r in done if r.latency_s is not None)
    ttfts = sorted(r.ttft_s for r in done if r.ttft_s is not None)
    waits = sorted(r.queue_wait_s for r in done
                   if r.queue_wait_s is not None)
    # A request that never emitted a token before the drain has no
    # meaningful deadline outcome (its ttft_s/queue_wait_s are None, not
    # stale zeros) — score the SLO only over requests that started.
    scored = [r for r in done if r.t_first_token is not None]

    report = {
        "requests": len(done),
        "unstarted_requests": len(done) - len(scored),
        "total_new_tokens": scheduler.total_new_tokens,
        "decode_steps": scheduler.decode_steps_run,
        "prefills": scheduler.prefills_run,
        "prefill_chunks": scheduler.prefill_chunks_run,
        "prefill_padded_tokens": pref_tokens,
        "prefill_attn_mac": pref_mac,
        "sim_time_s": t,
        "p50_latency_s": _pct(lats, 50.0),
        "p99_latency_s": _pct(lats, 99.0),
        "p50_ttft_s": _pct(ttfts, 50.0),
        "p99_ttft_s": _pct(ttfts, 99.0),
        "p50_queue_wait_s": _pct(waits, 50.0),
        "p99_queue_wait_s": _pct(waits, 99.0),
        "deadline_hit_rate": (sum(r.met_deadline for r in scored)
                              / max(1, len(scored))),
    }
    if scheduler.speculative:
        prop = scheduler.proposed_drafts
        report.update({
            "spec_steps": scheduler.spec_steps_run,
            "draft_forwards": scheduler.draft_forwards_run,
            "proposed_drafts": prop,
            "accepted_drafts": scheduler.accepted_drafts,
            "acceptance_rate": scheduler.accepted_drafts / max(1, prop),
        })
    if scheduler.preemption:
        report["preemptions"] = scheduler.preemptions
    pool = scheduler.metrics.gauge("serve_pool_blocks_in_use").stats()
    if pool is not None:
        report["pool_blocks_mean"] = pool["mean"]
        report["pool_blocks_peak"] = pool["peak"]
    if scheduler.prefix is not None:
        pc = scheduler.prefix
        report.update({
            "prefix_hits": pc.hits,
            "prefix_misses": pc.misses,
            "prefix_hit_rate": pc.hits / max(1, pc.hits + pc.misses),
            "prefix_cached_tokens": pc.cached_tokens,
            "prefix_blocks_saved": pc.shared_blocks,
        })
    return report
