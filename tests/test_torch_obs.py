"""The port's observability layer against the reference on the CPU: the
tracer's units, metadata dedupe, flow ids and numpy args (byte for byte
the reference's ``Tracer``), the trace validator's verdicts on the
reference's negative cases, the profiling hooks, and tracing the
continuous scheduler at ``reduced(flad_adllm)`` in float32: the zero-cost
contract (a traced run's streams bitwise an untraced run's) and the
traced pass against the reference's trace, event by event."""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.models import lm as jlm
from repro.obs import Tracer as JTracer
from repro.obs import kernel_cost_args as jax_cost_args
from repro.serve import (PrefillCostModel as JPrefillCost,
                         SpecDecodeCostModel as JSpecCost,
                         generate_pod_requests as jax_pod,
                         serve_continuous as jax_serve)
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.obs import (FL_PID, SERVE_PID, ProfileOptions, Tracer,
                             kernel_cost_args, profiled, resolve_tracer)
from repro_torch.obs import validate as V
from repro_torch.obs.trace import (CLOUD_TID, QUEUE_TID, SPEC_TID, lane_tid,
                                   vehicle_tid)
from repro_torch.serve import (ContinuousScheduler, PagedCacheSpec,
                               PagedEngine, PrefillCostModel, ServeRequest,
                               SpecDecodeCostModel, generate_pod_requests,
                               serve_continuous)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_validator():
    spec = importlib.util.spec_from_file_location(
        "validate_trace", os.path.join(REPO, "scripts", "validate_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VT = _reference_validator()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- tracer primitives, against the reference's Tracer ---------------------

def _both(build):
    """The same calls on the port's and the reference's tracer."""
    a, b = Tracer(), JTracer()
    build(a)
    build(b)
    return a, b


def test_tracer_metadata_dedupes_and_flow_ids_increment():
    def build(tr):
        tr.process(FL_PID, "fl", sort_index=1)
        tr.process(FL_PID, "fl", sort_index=1)          # a no-op
        tr.track(FL_PID, CLOUD_TID, "cloud")
        tr.track(FL_PID, CLOUD_TID, "cloud")
        assert tr.flow("a", 0.0, FL_PID, 1, 1.0, FL_PID, 2) == 0
        assert tr.flow("b", 1.0, FL_PID, 2, 2.0, FL_PID, 1) == 1

    port, ref = _both(build)
    assert [e["ph"] for e in port.events][:3] == ["M", "M", "M"]
    assert all(e["bp"] == "e" for e in port.events if e["ph"] == "f")
    assert port.to_bytes() == ref.to_bytes()


def test_tracer_span_units_and_clamping():
    def build(tr):
        tr.complete("work", 1.5, 2.0, pid=FL_PID, tid=3, cat="c",
                    args={"k": 1})
        tr.complete("tick", 2.0, 2.0, pid=FL_PID, tid=3)   # zero width
        tr.complete("back", 3.0, 2.5, pid=FL_PID, tid=3)   # clamped to 0
        tr.instant("mark", 0.25, pid=SERVE_PID, tid=QUEUE_TID, scope="p")
        tr.counter("c", 1.0, {"x": 3, "y": np.float32(0.5)},
                   pid=SERVE_PID)

    port, ref = _both(build)
    a, b, c = [e for e in port.events if e["ph"] == "X"]
    assert a["ts"] == 1.5e6 and a["dur"] == 0.5e6
    assert b["dur"] == 0.0 and c["dur"] == 0.0
    assert V.validate(port.events) == []
    assert port.to_bytes() == ref.to_bytes()
    assert len(port) == len(ref) == 5


def test_tracer_serializes_numpy_args_like_the_reference(tmp_path):
    def build(tr):
        tr.complete("s", 0.0, np.float64(1.0), pid=1, tid=1,
                    args={"n": np.int64(3), "v": np.float32(0.5),
                          "xs": np.arange(2)})

    port, ref = _both(build)
    raw = port.to_bytes()
    assert raw == ref.to_bytes() == _both(build)[0].to_bytes()
    assert json.loads(raw)["traceEvents"][0]["args"] == {
        "n": 3, "v": 0.5, "xs": [0, 1]}
    path = port.save(str(tmp_path / "t.json"))
    with open(path, "rb") as f:
        assert f.read() == raw
    assert V.validate_file(path) == []


def test_resolve_tracer_forms():
    assert resolve_tracer(None) == (None, None)
    tr = Tracer()
    assert resolve_tracer(tr) == (tr, None)
    got, path = resolve_tracer("t.json")
    assert isinstance(got, Tracer) and path == "t.json"
    assert vehicle_tid(2) == 1002 and lane_tid(1) == 11


# ---- the validator: the reference's negative cases -------------------------

@pytest.mark.parametrize("events,needle", [
    ([{"ph": "Z", "name": "x", "pid": 1, "tid": 1, "ts": 0}], "unknown ph"),
    ([{"ph": "X", "name": "", "pid": 1, "tid": 1, "ts": 0, "dur": 1}],
     "missing/empty name"),
    ([{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0, "dur": -1}],
     "bad dur"),
    ([{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": -2, "dur": 1}],
     "bad ts"),
    ([{"ph": "X", "name": "x", "pid": "p", "tid": 1, "ts": 0, "dur": 1}],
     "non-integer pid"),
    ([{"ph": "C", "name": "c", "pid": 1, "tid": 0, "ts": 0,
       "args": {"v": "hi"}}], "non-numeric series"),
    ([{"ph": "C", "name": "c", "pid": 1, "tid": 0, "ts": 0, "args": {}}],
     "missing args"),
    ([{"ph": "f", "name": "w", "pid": 1, "tid": 1, "ts": 1, "id": 9,
       "bp": "e"}], "no prior s"),
    ([{"ph": "s", "name": "w", "pid": 1, "tid": 1, "ts": 0, "id": 9},
      {"ph": "s", "name": "w", "pid": 1, "tid": 1, "ts": 1, "id": 9}],
     "reused"),
    ([{"ph": "s", "name": "w", "pid": 1, "tid": 1, "ts": 0, "id": 9}],
     "never finished"),
    ([{"ph": "s", "name": "w", "pid": 1, "tid": 1, "ts": 5, "id": 9},
      {"ph": "f", "name": "w", "pid": 1, "tid": 2, "ts": 1, "id": 9,
       "bp": "e"}], "ends before"),
    ([{"ph": "s", "name": "w", "pid": 1, "tid": 1, "ts": 0, "id": 9},
      {"ph": "f", "name": "w", "pid": 1, "tid": 2, "ts": 1, "id": 9}],
     "bp='e'"),
    ([{"ph": "M", "name": "weird_meta", "pid": 1, "tid": 0, "args": {}}],
     "unknown metadata"),
    ([{"ph": "M", "name": "thread_name", "pid": 1, "tid": 0, "args": {}}],
     "args missing"),
])
def test_validator_verdicts_match_the_reference(events, needle):
    errors = V.validate(events)
    assert any(needle in e for e in errors), errors
    assert errors == VT.validate(events)


def test_validator_top_level(tmp_path):
    assert V.validate([]) == []
    p = tmp_path / "bad.json"
    p.write_text("[1, 2]")
    assert V.validate_file(str(p)) == VT.validate_file(str(p)) == [
        "top level must be an object with 'traceEvents'"]
    assert V.main([str(p)]) == 1


# ---- profiling hooks --------------------------------------------------------

def test_profiled_disabled_is_a_noop_and_enabled_exports(tmp_path):
    with profiled(None) as prof:
        assert prof is None
    with profiled(ProfileOptions()) as prof:        # trace_dir=None
        assert prof is None
    opts = ProfileOptions(trace_dir=str(tmp_path / "prof"))
    with profiled(opts) as prof:
        assert prof is not None
        torch.ones(8) @ torch.ones(8)
    with open(opts.path) as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") or "dot" in e.get("name", "")
               for e in doc["traceEvents"])


def test_kernel_cost_args_price_like_the_reference():
    port = PrefillCostModel(s_per_token=1e-3, s_per_mac=1e-6)
    ref = JPrefillCost(s_per_token=1e-3, s_per_mac=1e-6)
    for kw in (dict(padded_tokens=10, attn_mac=100), dict(flops=5e9),
               dict(flops=1.0), {}):
        assert kernel_cost_args(**kw, cost_model=port) == \
            jax_cost_args(**kw, cost_model=ref)
    assert kernel_cost_args() == {}


# ---- tracing the continuous scheduler ---------------------------------------

@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jax_reduced(jax_get_config("flad_adllm"))
    cfg = reduced(get_config("flad-adllm"))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, bridge.params_from_numpy(tree, "cpu", cfg=cfg)


def _serve_opts(pod_requests, vocab, cost):
    """The reference's tracing trace: a pod-templated trace (shared
    prefix, unique suffixes) through the chunked + prefix-cache
    scheduler, the MAC cost model on the sim clock."""
    reqs = pod_requests("nano*1,agx*1", num_requests=4, pods=1,
                        template_len=8, max_suffix=4, seed=0,
                        short_new=(3, 4), long_new=(5, 6), long_frac=0.5,
                        vocab_size=vocab)
    return dict(requests=reqs, slots=2, block_size=4, max_context=16,
                prefill="chunked", prefill_chunk=4, prefix_cache=True,
                prefill_cost=cost, log_fn=None)


def _events(tracer):
    return json.loads(tracer.to_bytes())["traceEvents"]


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["plain", "speculative"])
def test_serve_trace_equals_the_reference(lm_setup, speculative):
    """Zero cost (streams bitwise an untraced run's, the trace byte
    deterministic) and the traced warm pass equal to the reference's
    trace event by event (float32 params, greedy)."""
    jcfg, jparams, cfg, params = lm_setup
    opts = _serve_opts(generate_pod_requests, cfg.vocab_size,
                       SpecDecodeCostModel() if speculative
                       else PrefillCostModel())
    kw = dict(speculative=True, draft_k=3) if speculative else {}
    plain = serve_continuous(cfg, params=params, device="cpu", **opts, **kw)
    traces = []
    for _ in range(2):
        tr = Tracer()
        rep = serve_continuous(cfg, params=params, device="cpu", trace=tr,
                               **opts, **kw)
        assert rep["sequences"] == plain["sequences"]
        traces.append(tr)
    assert traces[0].to_bytes() == traces[1].to_bytes()
    events = _events(traces[0])
    assert V.validate(events) == []

    jopts = _serve_opts(jax_pod, jcfg.vocab_size,
                        JSpecCost() if speculative else JPrefillCost())
    jtr = JTracer()
    jrep = jax_serve(jcfg, params=jparams, trace=jtr, **jopts, **kw)
    assert rep["sequences"] == jrep["sequences"]
    want = _events(jtr)
    assert len(events) == len(want)
    for got, ref in zip(events, want):
        assert got == ref
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"queued", "prefill_chunk", "decode"} <= names
    if speculative:
        spec = [e for e in events if e["ph"] == "X" and e["tid"] == SPEC_TID]
        assert {e["name"] for e in spec} == {"draft", "verify"}
        assert sum(e["name"] == "verify" for e in spec) == rep["spec_steps"]


def test_serve_trace_path_and_launcher(lm_setup, tmp_path):
    _, _, cfg, params = lm_setup
    path = str(tmp_path / "serve.json")
    rep = serve_continuous(cfg, params=params, device="cpu",
                           num_requests=3, trace=path, log_fn=None)
    assert rep["trace_path"] == path and V.validate_file(path) == []
    plain = serve_continuous(cfg, params=params, device="cpu",
                             num_requests=3, log_fn=None)
    assert plain["sequences"] == rep["sequences"]
    assert "trace_path" not in plain
    from repro_torch.launch import serve as launch
    out = str(tmp_path / "launch.json")
    rep = launch.main(["--scheduler", "continuous", "--requests", "2",
                       "--trace", out, "--device", "cpu"])
    assert rep["trace_path"] == out and V.validate_file(out) == []


def test_scheduler_tracks_and_trace_ids(lm_setup):
    _, _, cfg, params = lm_setup
    spec = PagedCacheSpec.for_requests(2, 16, block_size=4)
    eng = PagedEngine(cfg, spec, max_context=8, slots=2, device="cpu")
    tr = Tracer()
    sched = ContinuousScheduler(eng, params, tracer=tr, speculative=True,
                                draft_k=2)
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=r, prompt=rng.integers(
        1, cfg.vocab_size, (4,)).astype(np.int32), max_new_tokens=5,
        trace_id=40 + r) for r in range(3)]
    done = sched.run_to_completion(reqs)
    assert len(done) == 3
    events = _events(tr)
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tracks == {QUEUE_TID: "queue", SPEC_TID: "specdec",
                      lane_tid(0): "lane 0", lane_tid(1): "lane 1"}
    queued = [e for e in events if e["name"] == "queued"]
    assert sorted(e["args"]["trace_id"] for e in queued) == [40, 41, 42]
    assert any(e["ph"] == "C" and e["name"] == "kv blocks" for e in events)
    assert V.validate(events) == []
    assert ServeRequest(7, np.zeros(3, np.int32), 2).trace_id == 7
