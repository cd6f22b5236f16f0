"""The port's serving slice against the reference on the CPU, at
``reduced(flad_adllm)`` in float32: the parameter bridge, norms and rope,
the paged engine's logits (atol 2e-4), the load generator's traces, the
host-side block bookkeeping and the scheduler's greedy streams (exact)."""
import copy

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.models import blocks as JB
from repro.models import lm as jlm
from repro.serve import kvcache as JKC
from repro.serve import (BlockAllocator as JAllocator, PagedCacheSpec as
                         JSpec, PagedEngine as JEngine, PrefixCache as
                         JPrefix, generate_fleet_requests as jax_fleet,
                         generate_pod_requests as jax_pod,
                         int8_cache_fidelity as jax_fidelity,
                         serve_continuous as jax_serve)
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks as TB
from repro_torch.models import lm as tlm
from repro_torch.serve import (BlockAllocator, ContinuousScheduler,
                               PagedCacheSpec, PagedEngine, PrefixCache,
                               generate_fleet_requests, generate_pod_requests,
                               int8_cache_fidelity, serve_continuous)
from repro_torch.serve import kvcache as KC

ATOL = 2e-4
FLEET = "nano*2,agx*2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """One reduced float32 model, as the reference's tree and bridged."""
    jcfg = jax_reduced(jax_get_config("flad_adllm"))
    cfg = reduced(get_config("flad-adllm"))
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, bridge.params_from_numpy(tree, "cpu", cfg=cfg)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ----------------------------------------------------------------- bridge --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(dtype):
    jcfg = jax_reduced(jax_get_config("flad_adllm")).replace(param_dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(1), jcfg))
    module = bridge.params_from_numpy(tree, "cpu")
    assert {p.dtype for p in module.parameters()} == {getattr(torch, dtype)}
    back = dict(_leaves(bridge.params_to_numpy(module)))
    for name, want in _leaves(tree):
        got = back[name]
        if dtype == "bfloat16":
            assert got.dtype == np.uint16
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8), err_msg=name)


# ------------------------------------------------------------ norms, rope --
def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    got = TB.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = JB.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for pos in (np.arange(5, dtype=np.int32) + 7,
                rng.integers(0, 300, (2, 5)).astype(np.int32)):
        got = TB.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
        want = JB.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lm_forward_matches_reference(setup):
    """Cache-free (the plain attention on the CPU) and incremental decode
    through a contiguous cache."""
    jcfg, cfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 9)
                                             ).astype(np.int32)
    want, _, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got, _, _ = tp(torch.from_numpy(toks))      # the module runs forward
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    cache = tlm.init_cache(cfg, 2, 12, device="cpu")
    _, cache, _ = tlm.forward(tp, cfg, torch.from_numpy(toks[:, :8]),
                              caches=cache)
    step, _, _ = tlm.forward(tp, cfg, torch.from_numpy(toks[:, 8:]),
                             positions=torch.tensor([8], dtype=torch.int32),
                             caches=cache)
    np.testing.assert_allclose(step[:, 0].detach().numpy(),
                               np.asarray(want)[:, 8], atol=ATOL)


# ------------------------------------------------------------ paged engine --
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_paged_engine_logits_match_reference(setup, quantized):
    """prefill_chunk (first, middle, partial last chunk of two prompts)
    then decode steps of both lanes, logits compared at every call."""
    jcfg, cfg, jp, tp = setup
    bs, c, slots = 4, 8, 2
    jspec = JSpec.for_requests(slots, 40, block_size=bs, quantized=quantized)
    spec = PagedCacheSpec.for_requests(slots, 40, block_size=bs,
                                       quantized=quantized)
    jeng = JEngine(jcfg, jspec, max_context=16, slots=slots)
    teng = PagedEngine(cfg, spec, max_context=16, slots=slots, device="cpu")
    jpools, tpools = jeng.init_pools(), teng.init_pools()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (19, 6)]
    alloc = BlockAllocator(spec)
    tables = np.zeros((slots, spec.max_blocks_per_req), np.int32)
    pend = np.zeros(slots, np.int32)
    for lane, p in enumerate(prompts):
        blocks = alloc.alloc(spec.blocks_needed(len(p) + 6))
        tables[lane, :len(blocks)] = blocks
        for pos in range(0, len(p), c):
            clen = min(c, len(p) - pos)
            buf = np.zeros(c, np.int32)
            buf[:clen] = p[pos:pos + clen]
            jl, jpools = jeng.prefill_chunk(jp, jpools, jnp.asarray(buf),
                                            jnp.asarray(tables[lane]), pos,
                                            clen)
            tl, tpools = teng.prefill_chunk(tp, tpools, buf, tables[lane],
                                            pos, clen)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        pend[lane] = int(np.argmax(np.asarray(jl)[0]))
    ctx = np.array([len(p) for p in prompts], np.int32)
    for _ in range(5):
        jl, jpools = jeng.decode(jp, jpools, jnp.array(pend),
                                 jnp.array(tables), jnp.array(ctx))
        tl, tpools = teng.decode(tp, tpools, pend, tables, ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        pend = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        ctx = ctx + 1


def test_quantize_rows_matches_reference():
    x = np.random.default_rng(4).standard_normal((3, 5, 7, 32)
                                                 ).astype(np.float32)
    jq, js = JKC.quantize_rows(jnp.asarray(x))
    tq, ts = KC.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(KC.dequantize_rows(tq, ts).numpy(),
                                  np.asarray(JKC.dequantize_rows(jq, js)))


# --------------------------------------------------------------- loadgen ----
def test_request_traces_match_reference():
    a = generate_fleet_requests(FLEET, num_requests=9, max_prompt=20, seed=3)
    b = jax_fleet(FLEET, num_requests=9, max_prompt=20, seed=3)
    c = generate_pod_requests(FLEET, num_requests=9, template_len=12, seed=4)
    d = jax_pod(FLEET, num_requests=9, template_len=12, seed=4)
    for mine, theirs in ((a, b), (c, d)):
        assert len(mine) == len(theirs)
        for r, s in zip(mine, theirs):
            np.testing.assert_array_equal(r.prompt, s.prompt)
            assert (r.rid, r.max_new_tokens, r.arrival_s, r.deadline_s) == \
                (s.rid, s.max_new_tokens, s.arrival_s, s.deadline_s)


# ------------------------------------------------- allocator, prefix cache --
def test_block_bookkeeping_matches_reference():
    """One random op sequence through both packages' allocator + prefix
    registry: every return value and every refcount agrees."""
    rng = np.random.default_rng(5)
    spec_args = dict(num_blocks=12, block_size=4, max_blocks_per_req=5)
    sides = []
    for alloc_cls, prefix_cls, spec_cls in (
            (BlockAllocator, PrefixCache, PagedCacheSpec),
            (JAllocator, JPrefix, JSpec)):
        alloc = alloc_cls(spec_cls(**spec_args))
        sides.append((alloc, prefix_cls(alloc)))
    templates = [rng.integers(1, 50, 9).astype(np.int32) for _ in range(2)]
    held = [[], []]
    for step in range(60):
        op = rng.integers(0, 4)
        prompt = np.concatenate([templates[rng.integers(0, 2)],
                                 rng.integers(1, 50, rng.integers(0, 6))
                                 .astype(np.int32)])
        n = int(rng.integers(1, 4))
        outs = []
        for i, (alloc, prefix) in enumerate(sides):
            if op == 0:
                got = alloc.alloc(n)
                if got:
                    held[i].append(got)
            elif op == 1 and held[i]:
                got = alloc.release(held[i].pop(0))
            elif op == 2:
                got = prefix.match(prompt)
                shared, cow, _ = got
                if shared or cow is not None:
                    held[i].append(shared + ([cow] if cow is not None
                                             else []))
            elif op == 3 and held[i]:
                blocks = held[i][-1]
                table = blocks + [0] * (5 - len(blocks))
                got = prefix.insert(prompt[:4 * len(blocks)], table)
            else:
                got = prefix.evict(int(n))
            outs.append((got, alloc.free_blocks, len(prefix),
                         prefix.hits, prefix.misses,
                         sorted(alloc._refs.items())))
        assert outs[0] == outs[1], (step, op)


# -------------------------------------------------------------- scheduler ---
def _pod_trace(fn, cfg):
    return fn(FLEET, num_requests=8, template_len=20, max_suffix=6,
              vocab_size=cfg.vocab_size)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("prefill", ["chunked", "monolithic"])
def test_serve_continuous_streams_match_reference(setup, prefill, cache):
    """Greedy streams are identical token for token, and so is the
    scheduler's own accounting: chunked prefill runs a pod trace with the
    prefix cache on, monolithic prefill the plain fleet trace."""
    jcfg, cfg, jp, tp = setup
    kw = dict(num_requests=8, slots=4, prefill=prefill, cache=cache,
              prefix_cache=prefill == "chunked", log_fn=None)
    jkw, tkw = dict(kw), dict(kw)
    if prefill == "chunked":
        jkw["requests"] = _pod_trace(jax_pod, jcfg)
        tkw["requests"] = _pod_trace(generate_pod_requests, cfg)
    want = jax_serve(jcfg, params=jp, **jkw)
    got = serve_continuous(cfg, params=tp, device="cpu", **tkw)
    assert got["sequences"] == want["sequences"]
    for key in ("requests", "total_new_tokens", "decode_steps",
                "prefill_chunks", "prefills", "prefill_padded_tokens",
                "p50_latency_s", "p99_ttft_s", "deadline_hit_rate",
                "prefix_hits", "prefix_blocks_saved", "pool_blocks_peak"):
        assert got.get(key) == want.get(key), key
    if prefill == "chunked":
        assert got["prefix_hits"] > 0


def test_int8_cache_fidelity_matches_reference(setup):
    jcfg, cfg, jp, tp = setup
    reqs = generate_fleet_requests(FLEET, num_requests=3, max_prompt=12,
                                   seed=1)
    streams = {r.rid: list(np.random.default_rng(r.rid).integers(
        1, cfg.vocab_size, 5)) for r in reqs}
    kw = dict(block_size=4, max_context=8, prefill="chunked",
              prefill_chunk=8)
    want = jax_fidelity(jcfg, jp, jax_fleet(FLEET, num_requests=3,
                                             max_prompt=12, seed=1),
                        streams, **kw)
    got = int8_cache_fidelity(cfg, tp, reqs, streams, device="cpu", **kw)
    assert got["positions"] == want["positions"]
    assert got["disagreement"] == want["disagreement"]
    assert abs(got["max_logit_drift"] - want["max_logit_drift"]) < ATOL


def test_temperature_sampling_is_seeded(setup):
    _, cfg, _, tp = setup
    runs = [serve_continuous(cfg, params=tp, device="cpu", num_requests=4,
                             sampling="temperature", temperature=0.8,
                             seed=s, log_fn=None)["sequences"]
            for s in (3, 3, 4)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_later_slices_raise(setup, tmp_path):
    _, cfg, _, tp = setup
    spec = PagedCacheSpec.for_requests(2, 16, block_size=4)
    eng = PagedEngine(cfg, spec, max_context=8, slots=2, device="cpu")
    # speculative decoding, preemption (tests/test_torch_spec.py) and
    # tracing (tests/test_torch_obs.py) are ported: the scheduler takes a
    # tracer and names its tracks, the legacy launcher refuses --trace
    # as the reference's does
    from repro_torch.obs import Tracer
    tr = Tracer()
    ContinuousScheduler(eng, tp, tracer=tr)
    assert [e["name"] for e in tr.events][:2] == ["process_name",
                                                  "process_sort_index"]
    path = str(tmp_path / "t.json")
    rep = serve_continuous(cfg, params=tp, device="cpu", trace=path,
                           num_requests=2, log_fn=None)
    assert rep["trace_path"] == path
    from repro_torch.launch import serve as launch
    with pytest.raises(SystemExit, match="continuous"):
        launch.main(["--trace", "t.json", "--device", "cpu"])
    rep = launch.main(["--scheduler", "continuous", "--trace", path,
                       "--requests", "2", "--device", "cpu"])
    assert rep["trace_path"] == path
    # cache-free forward runs the flash-attention wrapper, which has no
    # kernel and no plain version for a meta tensor
    with pytest.raises(RuntimeError, match="no kernel"):
        tlm.forward(copy.deepcopy(tp).to("meta"), cfg,
                    torch.zeros((1, 3), dtype=torch.int32, device="meta"))


def test_launcher_serves_on_cpu():
    from repro_torch.launch import serve as launch
    rep = launch.main(["--device", "cpu", "--scheduler", "continuous",
                       "--requests", "2", "--slots", "2", "--cache", "int8"])
    assert rep["requests"] == 2 and rep["device"] == "cpu"
    assert len(rep["sequences"]) == 2
