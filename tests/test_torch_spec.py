"""The port's speculative decoding and preemption against the reference on
the CPU, at the reference's smoke size (``reduced(flad_adllm)`` in
float32, 2 lanes, blocks of 4, chunks of 4, draft_k 3):

  * the K/V rollback (``gather_rows``/``scatter_rows``) is bitwise the
    reference's, in fp32 and int8 pools (codes AND scales);
  * the verify's plain version (``ops.paged_verify_attention`` on CPU
    tensors) against the reference's per-lane Pallas prefill calls in
    interpret mode (atol 1e-5, float32 math on both sides), and row by
    row against the plain decode it stands for;
  * the reference's contract (``tests/test_serve.py``'s
    ``test_speculative_streams_bit_identical``): speculative streams are
    bitwise those of plain greedy decode, in fp32 and int8 cache mode,
    with a self-draft (acceptance 1.0) and with an unrelated random draft
    that is rejected nearly always and rolls back every step; the same
    streams and the same accounting (spec steps, draft forwards,
    acceptance, sim time) as the reference's own speculative run;
  * preemption: the victim's resumed stream is bitwise its unpressured
    one, and the reference's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serve import (ContinuousScheduler as JScheduler,
                         PagedCacheSpec as JSpec, PagedEngine as JEngine,
                         ServeRequest as JRequest,
                         SpecDecodeCostModel as JSpecCost,
                         generate_pod_requests as jax_pod,
                         serve_continuous as jax_serve)
from repro.serve import kvcache as JKC
from repro_torch import bridge
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.serve import (ContinuousScheduler, PagedCacheSpec,
                               PagedEngine, PrefillCostModel, ServeRequest,
                               SpecDecodeCostModel, generate_pod_requests,
                               serve_continuous)
from repro_torch.serve import kvcache as KC
from test_torch_kernels import _pools, _t, _tables

ATOL = 1e-5
DRAFT_K = 3
COMMON = dict(slots=2, block_size=4, max_context=16, prefill="chunked",
              prefill_chunk=4, prefix_cache=True, log_fn=None,
              warm_passes=1)
#: report keys that are host-clock measurements, not accounting
CLOCK_KEYS = ("seconds_cold", "seconds_warm", "tokens_per_s",
              "warm_tokens_per_s", "device")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The reference's smoke model and an unrelated draft (PRNGKey 7), as
    JAX trees and bridged to the port."""
    jcfg = jax_reduced(jax_get_config("flad_adllm")).replace(
        param_dtype="float32")
    cfg = reduced(get_config("flad-adllm")).replace(param_dtype="float32")
    out = [jcfg, cfg]
    for seed in (0, 7):
        jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        out += [jp, bridge.params_from_numpy(tree, "cpu", cfg=cfg)]
    return tuple(out)


# ------------------------------------------------------------ rollback ----
def _rollback_cycle(salt, quantized):
    """The reference's draft-append-then-reject cycle, through both
    packages on the same numpy pools: the port's pools equal the
    reference's bitwise after the draft append and after the (partial)
    restore, and the restore leaves every block but the null one as it
    was, except the accepted rows."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=8,
                      num_heads=2, num_kv_heads=1, d_ff=16, vocab_size=32,
                      param_dtype="float32")
    kw = dict(num_blocks=5, block_size=4, max_blocks_per_req=4,
              quantized=quantized)
    spec = PagedCacheSpec(**kw)
    rng = np.random.default_rng(salt)
    shapes = {k: tuple(p.shape) for k, p in
              KC.init_pools(cfg, spec, "cpu").items()}
    if quantized:
        before = {k: (rng.integers(-127, 128, s).astype(np.int8)
                      if k in ("k", "v") else
                      rng.random(s).astype(np.float32))
                  for k, s in shapes.items()}
    else:
        before = {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()}
    w = int(rng.integers(1, 9))
    start = int(rng.integers(0, 16 - w))
    pos = np.arange(start, start + w)
    phys = (1 + pos // spec.block_size).astype(np.int32)
    off = (pos % spec.block_size).astype(np.int32)
    accepted = int(rng.integers(0, w + 1))
    keep = np.arange(w) < accepted
    r_phys = np.where(keep, 0, phys).astype(np.int32)
    r_off = np.where(keep, 0, off).astype(np.int32)

    jpools = {k: jnp.asarray(v) for k, v in before.items()}
    jsaved = JKC.gather_rows(jpools, jnp.asarray(phys), jnp.asarray(off))
    garbage = {k: (rng.integers(-127, 128, r.shape).astype(np.int8)
                   if r.dtype == jnp.int8 else
                   rng.standard_normal(r.shape).astype(np.float32))
               for k, r in jsaved.items()}
    jdraft = JKC.scatter_rows(jpools, {k: jnp.asarray(g) for k, g in
                                       garbage.items()},
                              jnp.asarray(phys), jnp.asarray(off))
    jback = JKC.scatter_rows(jdraft, jsaved, jnp.asarray(r_phys),
                             jnp.asarray(r_off))

    pools = {k: torch.from_numpy(v.copy()) for k, v in before.items()}
    saved = KC.gather_rows(pools, torch.from_numpy(phys),
                           torch.from_numpy(off))
    for k in saved:
        assert torch.equal(saved[k], torch.from_numpy(np.array(jsaved[k])))
    KC.scatter_rows(pools, {k: torch.from_numpy(g) for k, g in
                            garbage.items()},
                    torch.from_numpy(phys), torch.from_numpy(off))
    for k in pools:
        np.testing.assert_array_equal(pools[k].numpy()[:, :, 1:],
                                      np.asarray(jdraft[k])[:, :, 1:])
    KC.scatter_rows(pools, saved, torch.from_numpy(r_phys),
                    torch.from_numpy(r_off))
    for k in pools:
        got = pools[k].numpy()
        want = before[k].copy()
        if accepted:
            want[:, :, phys[:accepted], off[:accepted]] = \
                garbage[k][:, :, :accepted]
        # block 0 is garbage by contract; everything else must be exact
        np.testing.assert_array_equal(got[:, :, 1:], want[:, :, 1:],
                                      err_msg=k)
        np.testing.assert_array_equal(got[:, :, 1:],
                                      np.asarray(jback[k])[:, :, 1:],
                                      err_msg=k)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_rollback_is_bitwise_the_reference(quantized):
    rng = np.random.default_rng(11)
    for _ in range(12):
        _rollback_cycle(int(rng.integers(0, 1 << 20)), quantized)


# ------------------------------------------------------ verify attention ---
def _verify_inputs(int8, seed):
    """Four lanes: a dead one (ctx 0, window 0, null table), a full
    window, a partial window across a block boundary, a window at ctx
    0; GQA 2, head_dim 32, blocks of 8, a NaN-poisoned null block."""
    rng = np.random.default_rng(seed)
    hq, hkv, d, bs, c = 4, 2, 32, 8, 4
    ctx = np.array([0, 13, 6, 0], np.int32)
    win = np.array([0, 4, 3, 2], np.int32)
    tables, nb = _tables(rng, list(ctx + win), bs, spare_slots=1)
    k, v, ks, vs = _pools(rng, hkv, nb, bs, d, int8)
    q = rng.standard_normal((len(ctx), hq, c, d)).astype(np.float32)
    return q, k, v, ks, vs, tables, ctx, win


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_verify_matches_reference_kernel(int8):
    """The port's verify (its plain version here) against the reference's
    ``paged_verify_attention``, one interpret-mode Pallas prefill call a
    lane; rows past a lane's window are garbage by contract, a dead lane
    returns zeros."""
    q, k, v, ks, vs, tables, ctx, win = _verify_inputs(int8, 5 + int8)
    want = np.asarray(jops.paged_verify_attention(
        *map(jnp.asarray, (q, k, v, tables, ctx, win)),
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), interpret=True))
    before = ops.launch_counts()
    got = ops.paged_verify_attention(
        *map(_t, (q, k, v, tables, ctx, win)), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    assert ops.launch_counts() == before        # the plain version
    assert got.shape == q.shape and np.isfinite(got).all()
    for b, w in enumerate(win):
        np.testing.assert_allclose(got[b, :, :w], want[b, :, :w], rtol=0,
                                   atol=ATOL)
    assert not got[win == 0].any()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_verify_rows_are_decode_rows(int8):
    """Row c of lane b is what plain decode computes at position ctx + c
    with ctx + c + 1 keys visible."""
    q, k, v, ks, vs, tables, ctx, win = _verify_inputs(int8, 9 + int8)
    got = ops.paged_verify_attention(
        *map(_t, (q, k, v, tables, ctx, win)), k_scales=_t(ks),
        v_scales=_t(vs))
    for c in range(q.shape[2]):
        live = win > c
        dec = ops.paged_decode_attention(
            _t(q[:, :, c]), _t(k), _t(v), _t(tables),
            _t(np.where(live, ctx + c + 1, 0).astype(np.int32)),
            k_scales=_t(ks), v_scales=_t(vs))
        np.testing.assert_allclose(got[live, :, c].numpy(),
                                   dec[live].numpy(), rtol=0, atol=1e-6)


def test_verify_checks_its_inputs():
    q, k, v, _, _, tables, ctx, win = _verify_inputs(False, 1)
    args = [_t(x) for x in (q, k, v, tables, ctx, win)]
    for i, bad in ((4, _t(ctx.astype(np.int64))), (5, _t(win[:2])),
                   (0, _t(q[0])), (3, _t(tables[:2]))):
        call = list(args)
        call[i] = bad
        with pytest.raises(ValueError):
            ops.paged_verify_attention(*call)


# ------------------------------------------------------------- streams ----
def _spec_trace(fn, cfg, n=6, seed=3):
    return fn("nano*1,agx*1", num_requests=n, pods=2, template_len=8,
              max_suffix=4, seed=seed, short_new=(3, 6), long_new=(8, 12),
              long_frac=0.4, vocab_size=cfg.vocab_size)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_speculative_streams_bit_identical(setup, cache):
    """The reference's contract on the port: self-drafting (acceptance
    1.0) and an unrelated random draft (every speculative step rolls
    back) both reproduce the non-speculative greedy streams bitwise, in
    fp32 and int8 cache mode, while speculation still wins sim time at
    high acceptance; and each run equals the reference's own run on the
    same params, stream for stream and in every accounting key."""
    jcfg, cfg, jp, tp, jd, td = setup
    kw = dict(COMMON, cache=cache)
    base = serve_continuous(cfg, params=tp, device="cpu",
                            requests=_spec_trace(generate_pod_requests, cfg),
                            prefill_cost=PrefillCostModel(), **kw)
    want_base = jax_serve(jcfg, params=jp,
                          requests=_spec_trace(jax_pod, jcfg), **kw)
    assert base["sequences"] == want_base["sequences"]
    runs = {}
    for name, draft, jdraft in (("self", None, None), ("reject", td, jd)):
        got = serve_continuous(
            cfg, params=tp, device="cpu", speculative=True, draft_k=DRAFT_K,
            draft_params=draft, prefill_cost=SpecDecodeCostModel(),
            requests=_spec_trace(generate_pod_requests, cfg), **kw)
        want = jax_serve(
            jcfg, params=jp, speculative=True, draft_k=DRAFT_K,
            draft_params=jdraft, prefill_cost=JSpecCost(),
            requests=_spec_trace(jax_pod, jcfg), **kw)
        assert got["sequences"] == base["sequences"], name
        for key in want:
            if key not in CLOCK_KEYS:
                assert got[key] == want[key], (name, key)
        runs[name] = got
    spec, rej = runs["self"], runs["reject"]
    assert spec["spec_steps"] > 0
    assert spec["acceptance_rate"] == 1.0
    assert spec["decode_steps"] < base["decode_steps"]
    assert spec["sim_time_s"] < base["sim_time_s"]
    assert rej["acceptance_rate"] < 0.2 and rej["proposed_drafts"] > 0


def test_speculative_validation(setup):
    _, cfg, _, tp, _, _ = setup
    spec = PagedCacheSpec.for_requests(1, 16, block_size=4)
    eng = PagedEngine(cfg, spec, max_context=8, slots=1, device="cpu")
    with pytest.raises(ValueError):             # greedy-only by definition
        ContinuousScheduler(eng, tp, speculative=True,
                            sampling="temperature")
    with pytest.raises(ValueError):             # resume needs chunked
        ContinuousScheduler(eng, tp, prefill="monolithic", preemption=True)
    with pytest.raises(ValueError):             # draft_k >= 1
        ContinuousScheduler(eng, tp, speculative=True, draft_k=0)
    # speculative + monolithic is allowed, preemption just defaults off
    s = ContinuousScheduler(eng, tp, speculative=True, prefill="monolithic")
    assert s.speculative and not s.preemption
    assert ContinuousScheduler(eng, tp, speculative=True).preemption


def test_speculative_monolithic_streams(setup):
    """The monolithic prefill mirrors into the draft pools too."""
    _, cfg, _, tp, _, td = setup
    kw = dict(COMMON, prefill="monolithic", prefix_cache=False,
              cache="fp32", device="cpu")
    base = serve_continuous(cfg, params=tp, num_requests=4, **kw)
    for draft in (None, td):
        got = serve_continuous(cfg, params=tp, num_requests=4,
                               speculative=True, draft_k=2,
                               draft_params=draft, **kw)
        assert got["sequences"] == base["sequences"]


# ---------------------------------------------------------- preemption ----
def _preemption_requests(cls, vocab, deadlines):
    rng = np.random.default_rng(4)
    pa = rng.integers(1, vocab, (6,)).astype(np.int32)
    pb = rng.integers(1, vocab, (6,)).astype(np.int32)
    return [cls(rid=0, prompt=pa.copy(), max_new_tokens=8,
                deadline_s=deadlines[0]),
            cls(rid=1, prompt=pb.copy(), max_new_tokens=4,
                deadline_s=deadlines[1])]


def _pressured(sched, reqs, flush=False):
    """Admit and decode request 0 a little, then submit request 1 and
    step until drained."""
    ra, rb = reqs
    sched.submit(ra)
    steps = 0
    for _ in range(4):
        sched.step(float(steps))
        if flush:
            sched.flush_trace(steps + 1.0)
        steps += 1
    assert len(ra.tokens) > 0 and not sched.idle
    sched.submit(rb)
    while not sched.idle:
        sched.step(float(steps))
        if flush:
            sched.flush_trace(steps + 1.0)
        steps += 1
        assert steps < 200
    return {r.rid: list(r.tokens) for r in sched.finished}


def test_preemption_resume_exact(setup):
    """A tight pool and a later arrival with a tighter deadline preempt
    the live lane; the victim's resume replays through the prefix cache
    and its stream is bitwise its unpressured one and the reference's.
    With the deadlines flipped nothing is preempted."""
    jcfg, cfg, jp, tp, _, _ = setup
    spec = PagedCacheSpec.for_requests(2, 16, block_size=4)
    eng = PagedEngine(cfg, spec, max_context=8, slots=2, device="cpu")
    kw = dict(prefill="chunked", prefill_chunk=4, prefix_cache=True)
    oracle = ContinuousScheduler(eng, tp, **kw)
    want = {r.rid: list(r.tokens) for r in oracle.run_to_completion(
        _preemption_requests(ServeRequest, cfg.vocab_size, (100.0, 1.0)))}

    # each request needs 4 blocks; a 5-block cap cannot host both
    sched = ContinuousScheduler(eng, tp, preemption=True,
                                max_inflight_blocks=5, **kw)
    got = _pressured(sched, _preemption_requests(
        ServeRequest, cfg.vocab_size, (100.0, 1.0)))
    assert got == want
    assert sched.preemptions == 1
    assert [r.rid for r in sched.finished] == [1, 0]   # B jumped the line
    assert sched.allocator.in_use == sched.prefix.registered_blocks
    m = sched.metrics.snapshot()["metrics"]
    assert m["serve_preemptions"]["series"][0]["value"] == 1.0

    jeng = JEngine(jcfg, JSpec.for_requests(2, 16, block_size=4),
                   max_context=8, slots=2)
    jsched = JScheduler(jeng, jp, preemption=True, max_inflight_blocks=5,
                        **kw)
    assert _pressured(jsched, _preemption_requests(
        JRequest, cfg.vocab_size, (100.0, 1.0)), flush=True) == got
    assert jsched.preemptions == sched.preemptions

    s2 = ContinuousScheduler(eng, tp, preemption=True,
                             max_inflight_blocks=5, **kw)
    _pressured(s2, _preemption_requests(ServeRequest, cfg.vocab_size,
                                        (1.0, 100.0)))
    assert s2.preemptions == 0
    assert [r.rid for r in s2.finished] == [0, 1]


def test_preemption_with_speculation_keeps_streams(setup):
    """The same pressure on a speculative scheduler (self-draft, so
    preemption's resume also mirrors the draft pools): streams unchanged
    and one preemption."""
    _, cfg, _, tp, _, _ = setup
    spec = PagedCacheSpec.for_requests(2, 16, block_size=4)
    eng = PagedEngine(cfg, spec, max_context=8, slots=2, device="cpu")
    kw = dict(prefill="chunked", prefill_chunk=4, prefix_cache=True)
    want = {r.rid: list(r.tokens) for r in ContinuousScheduler(
        eng, tp, **kw).run_to_completion(copy.deepcopy(
            _preemption_requests(ServeRequest, cfg.vocab_size,
                                 (100.0, 1.0))))}
    # draft_k 1: request 0 is still live when request 1 arrives
    sched = ContinuousScheduler(eng, tp, speculative=True, draft_k=1,
                                max_inflight_blocks=5, **kw)
    got = _pressured(sched, _preemption_requests(
        ServeRequest, cfg.vocab_size, (100.0, 1.0)))
    assert got == want and sched.preemptions == 1


def test_host_arrays_are_copied_before_launch(setup, monkeypatch):
    """The scheduler mutates its numpy tables, contexts and pending tokens
    right after each engine call; every array the engine and the rollback
    read is a fresh tensor, never a view of such a buffer (the fault
    behind the reference's intermittent paged-vs-contiguous test)."""
    from repro_torch.serve import engine as E
    a = np.arange(6, dtype=np.int32)
    t = E._to_device(a, torch.device("cpu"))
    a[:] = -1
    assert t.tolist() == list(range(6))
    seen = []
    to_device = E._to_device

    def recording(x, device, dtype=torch.int32):
        out = to_device(x, device, dtype)
        if isinstance(x, np.ndarray):
            seen.append((x, out))
        return out

    monkeypatch.setattr(E, "_to_device", recording)
    import repro_torch.serve.scheduler as S
    monkeypatch.setattr(S, "_to_device", recording)
    _, cfg, _, tp, _, _ = setup
    serve_continuous(cfg, params=tp, device="cpu", speculative=True,
                     draft_k=2, num_requests=3, **COMMON)
    assert seen
    for x, out in seen:
        assert not np.shares_memory(x, out.numpy())
