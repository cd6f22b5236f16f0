"""The port's event-driven async FL slice against the reference on the
CPU: the split aggregation (``edge_commit``, ``cloud_merge_at``), the
mobility model and the dwell-time regressor, the timing-only schedule
(event log and trace byte for byte the reference's), and
``async_hier_fl`` at ``reduced(flad_adllm)`` (float32) with the int8
codec: a clocked run with jitter and pod migrations against the
reference's (event log and trace equal, params within two quantization
steps, the few elements whose grads lie at float32 noise within Adam's
largest step per such update), sync equivalence with the port's ``hier_fl``
(bitwise), and the zero-cost contract of its tracer (bitwise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LoopHooks as JHooks, Session as JSession
from repro.comm.events import (AsyncHierFLEngine as JEngine,
                               ComputeModel as JCompute,
                               MobilitySpec as JMobility,
                               simulate_schedule as jax_schedule,
                               time_to_migration as jax_ttm)
from repro.comm.hierarchy import (cloud_merge_at as jax_merge_at,
                                  edge_commit as jax_commit)
from repro.comm.topology import parse_topology as jax_topology
from repro.obs import MetricsRegistry as JRegistry, Tracer as JTracer
from repro.sched import dwell as JD
from repro.sched import mobility as JM
from repro.train.optimizer import Adam as JAdam
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.comm.events import (AsyncHierFLEngine, BackhaulArrived,
                                     CloudDeadline, ComputeModel, EventQueue,
                                     LocalStepDone, MobilitySpec,
                                     UplinkArrived, simulate_schedule,
                                     time_to_migration)
from repro_torch.comm.hierarchy import cloud_merge_at, edge_commit
from repro_torch.comm.topology import parse_topology
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs import validate as V
from repro_torch.sched import dwell as TD
from repro_torch.sched import mobility as TM
from repro_torch.train.optimizer import Adam
from repro_torch.tree import leaves
from test_torch_fl import NEAR_EPS, adam_denominators

SPEC = "2@nano*2,agx*2"
TOPO, JTOPO = parse_topology(SPEC), jax_topology(SPEC)
C = 4
QUIET = dict(log_every=1, log_fn=lambda *a, **k: None)
#: the reference's busiest test schedule (clocked merges, stragglers
#: under jitter, DTMC migrations) with mobility steps every 0.02 s, so
#: that 3 merges see a pod migration and a merge of 2 vehicles
ASYNC = dict(clock=0.05, compute_flops=5e9, compute_jitter=0.3,
             migrate_every=0.02)
SCHEDULES = [
    dict(clock=None, compute_flops=4.7e11, rounds=4),
    dict(clock=0.4, compute_flops=4.7e11, rounds=10),
    dict(clock=0.4, compute_flops=4.7e11, jitter=0.3, migrate_every=0.5,
         rounds=6, seed=7),
    dict(clock=0.05, compute_flops=5e9, jitter=0.3, migrate_every=0.05,
         rounds=10, seed=0, mobility=(5, 1, 1)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mobility(cls, size_radius_seed):
    size, radius, seed = size_radius_seed
    return cls(size=size, radius=radius, seed=seed)


# ---- the event queue and the split aggregation ----------------------------

def test_event_queue_breaks_ties_by_sequence():
    q = EventQueue()
    for ev in (LocalStepDone(1.0, 3), UplinkArrived(1.0, 1, 10),
               CloudDeadline(1.0, 0), LocalStepDone(0.5, 0),
               BackhaulArrived(1.0, 0, 2)):
        q.push(ev)
    assert [q.pop() for _ in range(5)] == [
        LocalStepDone(0.5, 0), LocalStepDone(1.0, 3),
        UplinkArrived(1.0, 1, 10), CloudDeadline(1.0, 0),
        BackhaulArrived(1.0, 0, 2)]
    assert q.pop() is None and q.peek_t() == np.inf


def _stacked(seed, c=C):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((c, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((c, 300)).astype(np.float32)}


def test_edge_commit_and_cloud_merge_at_match_the_reference():
    stacked = _stacked(0)
    w = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    g = {"a": np.ones((6, 5), np.float32), "b": np.zeros((300,), np.float32)}
    parts, jparts = [], []
    for idx in TOPO.member_indices:
        sub = {k: v[idx] for k, v in stacked.items()}
        parts.append(edge_commit(bridge.tree_from_numpy(sub, "cpu"),
                                 torch.from_numpy(w[idx])))
        jparts.append(jax_commit(sub, jnp.asarray(w[idx])))
    for (p, pw), (jp, jw) in zip(parts, jparts):
        assert float(pw) == float(jw)
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    for stale in (None, np.asarray([1.0, 0.25], np.float32)):
        got = cloud_merge_at(bridge.tree_from_numpy(g, "cpu"),
                             [p for p, _ in parts], [x for _, x in parts],
                             stale)
        want = jax_merge_at(g, [p for p, _ in jparts],
                            [x for _, x in jparts],
                            None if stale is None else jnp.asarray(stale))
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)


def test_edge_commits_are_the_edge_aggregate_rows_bitwise():
    from repro_torch.comm.hierarchy import cloud_merge, edge_aggregate
    stacked = bridge.tree_from_numpy(_stacked(1), "cpu")
    edge_tree, edge_w = edge_aggregate(stacked, None, TOPO)
    commits = [edge_commit({k: v[torch.as_tensor(idx)]
                            for k, v in stacked.items()},
                           torch.ones(len(idx)))
               for idx in TOPO.member_indices]
    for e, (part, total) in enumerate(commits):
        assert torch.equal(total, edge_w[e])
        assert all(torch.equal(part[k], edge_tree[k][e]) for k in part)
    g = {"a": torch.ones((6, 5)), "b": torch.zeros((300,))}
    fused = cloud_merge(edge_tree, edge_w)
    split = cloud_merge_at(g, [c[0] for c in commits],
                           [c[1] for c in commits],
                           np.ones(2, np.float32))
    assert all(torch.equal(g[k] + fused[k], split[k]) for k in g)


# ---- mobility and dwell ------------------------------------------------------

def test_mobility_matches_the_reference():
    world, jworld = TM.make_patterns(5, 3, seed=4), JM.make_patterns(
        5, 3, seed=4)
    np.testing.assert_array_equal(world.patterns, jworld.patterns)
    for seed in range(3):
        t = TM.sample_trajectory(world, seed % 3, 7, 10,
                                 np.random.default_rng(seed))
        j = JM.sample_trajectory(jworld, seed % 3, 7, 10,
                                 np.random.default_rng(seed))
        np.testing.assert_array_equal(t, j)
    rng = np.random.default_rng(3)
    h1 = JM.sample_trajectory(jworld, 0, 12, 4, rng)
    h2 = JM.sample_trajectory(jworld, 1, 13, 4, rng)
    np.testing.assert_allclose(TM.pattern_posterior(world, h1),
                               JM.pattern_posterior(jworld, h1), atol=1e-12)
    np.testing.assert_allclose(TM.future_distribution(world, h1, 5),
                               JM.future_distribution(jworld, h1, 5),
                               atol=1e-12)
    for fn, args in ((("expected_relative_distance"), (h1, h2, 4)),
                     ("stability_score", (h1, h2, 4)),
                     ("in_range_probability", (h1, h2, 3, 2))):
        assert abs(getattr(TM, fn)(world, *args)
                   - getattr(JM, fn)(jworld, *args)) <= 1e-12, fn
    for speed in (0.5, 1.0, 1.5):
        assert time_to_migration(world, h1, speed, 1) == jax_ttm(
            jworld, h1, speed, 1)


def test_fleet_mobility_matches_the_reference():
    from repro.comm.events import FleetMobility as JFleet

    from repro_torch.comm.events import FleetMobility
    mob = FleetMobility(MobilitySpec(size=5, radius=1, seed=1), TOPO)
    jmob = JFleet(JMobility(size=5, radius=1, seed=1), JTOPO)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        for i in range(C):
            assert mob.advance(i, rng) == jmob.advance(i, jrng)
            e = int(TOPO.client_edge[i])
            assert mob.out_of_range(i, e) == jmob.out_of_range(i, e)
            assert mob.nearest_edge(i) == jmob.nearest_edge(i)
    assert mob.histories == jmob.histories


@pytest.fixture(scope="module")
def dwell_setup():
    world = JM.make_patterns(5, 3, seed=2)
    data = JD.synthetic_dwell_data(world, 64, 10, seed=0)
    cfg = JD.WDRConfig(n_cells=world.n_cells, route_len=10)
    jp = JD.init_wdr(jax.random.PRNGKey(0), cfg)
    return world, data, jp


def test_dwell_forward_from_bridged_params(dwell_setup):
    world, (routes, speeds, dwell), jp = dwell_setup
    tworld = TM.make_patterns(5, 3, seed=2)
    for got, want in zip(TD.synthetic_dwell_data(tworld, 64, 10, seed=0),
                         (routes, speeds, dwell)):
        np.testing.assert_array_equal(got, want)
    model = bridge.wdr_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pred = model(torch.from_numpy(routes), torch.from_numpy(speeds))
    want = JD.wdr_forward(jp, jnp.asarray(routes), jnp.asarray(speeds))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    loss, _ = TD.mape_loss(model.params(), torch.from_numpy(routes),
                           torch.from_numpy(speeds),
                           torch.from_numpy(dwell))
    jloss, _ = JD.mape_loss(jp, routes, speeds, dwell)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5


def test_dwell_mape_trajectory_matches_the_reference(dwell_setup):
    """20 Adam steps (lr 1e-2, clip 1.0) from the same weights: each
    step's loss within 1e-4 of the reference's."""
    _, (routes, speeds, dwell), jp = dwell_setup
    opt = JAdam(lr=1e-2, grad_clip=1.0)

    @jax.jit
    def step(params, state):
        (loss, _), grads = jax.value_and_grad(
            lambda p: JD.mape_loss(p, routes, speeds, dwell),
            has_aux=True)(params)
        params, state = opt.update(grads, state, params)
        return params, state, loss

    params, state, want = jp, opt.init(jp), []
    for _ in range(20):
        params, state, loss = step(params, state)
        want.append(float(loss))
    start = bridge.wdr_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, got = TD.fit_dwell(start.params(), torch.from_numpy(routes),
                          torch.from_numpy(speeds), torch.from_numpy(dwell),
                          steps=20)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[-1] < got[0]


def test_train_dwell_model_runs_from_the_reference_init(dwell_setup):
    world, _, jp = dwell_setup
    model, predict, mape = TD.train_dwell_model(
        TM.make_patterns(5, 3, seed=2), route_len=10, n_train=64, steps=3,
        params=jax.tree.map(np.asarray, jp), device="cpu")
    routes, speeds, _ = TD.synthetic_dwell_data(world, 4, 10, seed=1)
    pred = predict(routes, speeds)
    assert pred.shape == (4,) and bool((pred > 0).all())
    assert np.isfinite(mape)
    assert set(model.to_numpy()) == set(TD.PARAM_NAMES)


# ---- the timing-only schedule ----------------------------------------------

@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=["sync", "clocked", "migrating", "busiest"])
def test_schedule_event_log_and_trace_equal_the_reference(kw):
    kw = dict(kw)
    mob = kw.pop("mobility", None)
    tr, jtr, reg, jreg = Tracer(), JTracer(), MetricsRegistry(), JRegistry()
    got = simulate_schedule(
        TOPO, tracer=tr, metrics=reg,
        mobility=None if mob is None else _mobility(MobilitySpec, mob),
        **kw)
    want = jax_schedule(
        JTOPO, tracer=jtr, metrics=jreg,
        mobility=None if mob is None else _mobility(JMobility, mob), **kw)
    assert got == want
    assert tr.to_bytes() == jtr.to_bytes()
    assert reg.snapshot() == jreg.snapshot()
    assert V.validate(tr.events) == []
    plain = simulate_schedule(
        TOPO, mobility=None if mob is None else _mobility(MobilitySpec, mob),
        **kw)
    assert plain == got                        # tracing costs nothing


def test_lapped_vehicle_never_double_counted_in_one_commit():
    topo = parse_topology("2@nano*1,agx*3")
    committed = []

    class Recorder(AsyncHierFLEngine):
        def _commit(self, e, t):
            committed.append(tuple(b.vehicle for b in self.edge_buffers[e]))
            super()._commit(e, t)

    eng = Recorder(topo, 2 ** 21, lambda m: 2 ** 21,
                   compute=ComputeModel(flops=4.7e11), clock=0.4,
                   flush_every=0.9)
    jeng = JEngine(jax_topology("2@nano*1,agx*3"), 2 ** 21,
                   lambda m: 2 ** 21, compute=JCompute(flops=4.7e11),
                   clock=0.4, flush_every=0.9)
    eng.reset()
    jeng.reset()
    merges = 0
    while merges < 8:
        ev = eng.queue.pop()
        merges += eng.handle(ev) is not None
        jeng.handle(jeng.queue.pop())
    assert eng.event_log == jeng.event_log
    assert committed.count((1,)) >= 2
    assert all(len(set(c)) == len(c) for c in committed)


def test_engine_rejects_bad_options():
    with pytest.raises(ValueError, match="clock"):
        AsyncHierFLEngine(TOPO, 100, lambda m: 100, clock=-1.0)
    with pytest.raises(ValueError, match="decay"):
        AsyncHierFLEngine(TOPO, 100, lambda m: 100, decay=0.0)
    with pytest.raises(ValueError, match="edge pod 0"):
        AsyncHierFLEngine(TOPO, 100, lambda m: 100,
                          client_weights=[0.0, 0.0, 1.0, 1.0])


# ---- async_hier_fl at reduced flad-adllm -------------------------------------

def _batches(w):
    rng = np.random.default_rng(100 + w)
    return {k: rng.integers(0, 512, (C, 2, 2, 64)).astype(np.int32)
            for k in ("tokens", "labels")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _session(strategy, **kw):
    return Session("flad-adllm", strategy=strategy, shape="64x2",
                   topology=SPEC, codec="int8", local_steps=2,
                   device="cpu", **kw)


def record_near_eps_steps(monkeypatch):
    """Patch the port's Adam to keep, per element, the smallest nonzero
    sqrt(v_hat) any update met and the number of updates (over vehicles
    and steps) that met one below NEAR_EPS. Returns (minima, counts), two
    lists of leaves in flatten order, filled as the run goes."""
    low, count = [], []
    update = Adam.update

    def recording(self, grads, state, params):
        new, st = update(self, grads, state, params)
        den = adam_denominators(st.v, self.b2, float(st.step))
        hit = [(x < NEAR_EPS).int() for x in den]
        low[:] = den if not low else [torch.minimum(a, b)
                                      for a, b in zip(low, den)]
        count[:] = hit if not count else [a + b for a, b in zip(count, hit)]
        return new, st

    monkeypatch.setattr(Adam, "update", recording)
    return low, count


def adam_step_bound(b1, b2, steps):
    """The largest |m_hat| / sqrt(v_hat) Adam can reach in its first
    ``steps`` steps, whatever the grads: by Cauchy-Schwarz on m_t = (1 -
    b1) sum_k b1^k g_(t-k) against v_t = (1 - b2) sum_k b2^k g_(t-k)^2,
    |m_t| <= (1 - b1) sqrt(sum_k (b1^2 / b2)^k) sqrt(v_t / (1 - b2)),
    then the bias corrections (1 - b1^t) and sqrt(1 - b2^t). eps only
    shrinks a step, so one step moves an element by at most lr times
    this."""
    r = b1 * b1 / b2
    return max((1 - b1) / np.sqrt(1 - b2) * np.sqrt((1 - r ** t) / (1 - r))
               * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
               for t in range(1, steps + 1))


def test_async_run_equals_the_reference():
    """3 merges with a clock, jitter, DTMC migrations and the int8 codec:
    the event log and the trace bytes the reference's; the global params
    within two quantization steps of the reference's, each wave's codec
    bits the ones the reference's key split gives its rows.

    The elements whose Adam update met a nonzero sqrt(v_hat) below
    NEAR_EPS (10 * eps) are held otherwise, and may be at most 0.1% of
    the params. Such an element got a grad at float32 noise, a sum that
    cancels to ~1e-7 of the grad's norm, often into a v that was 0: here
    the largest, an embedding element, met -3.4e-7 in the port and
    -5.1e-8 in the reference at one vehicle's step 4, and each package
    moved it by its own share of a full Adam step (4.4e-4 against 2.1e-4
    at lr 1e-3), and again at steps 5 and 6 as m decayed; with seed 1 and
    other batches the largest such element took the same path (2.6e-7
    into a zero v). A grad at noise can land anywhere between 0 and a
    full step in either package, so each near-eps step may part the two
    by twice the largest Adam step, lr * adam_step_bound (1.004 lr for
    b1 0.9, b2 0.95 over 6 steps), and the merges only average the
    vehicles' rows: an element is held to two quantization steps plus 2
    lr adam_step_bound per update that met sqrt(v_hat) below NEAR_EPS.
    (test_torch_fl_int8.py holds such elements to 1e-4 flat, a tenth of
    the lr, over hier_fl's 2 x 2 steps: a reading, not a bound.)"""
    jopts = dict(ASYNC, mobility=JMobility(size=5, radius=1, seed=1))
    js = JSession("flad-adllm", strategy="async_hier_fl", mesh=(1,),
                  shape="64x2", topology=SPEC, codec="int8", local_steps=2,
                  **jopts)
    _, (jp, jo) = js.build()
    sizes = [int(np.prod(x.shape[1:])) for x in jax.tree.leaves(jp)]
    state = bridge.fl_state_from_numpy(_np(jp), np.asarray(jo.step),
                                       _np(jo.m), _np(jo.v), "cpu")
    # the reference engine's stream: its run key, split once a wave into
    # (next key, the wave's subkey), then per leaf, then per client
    chain, subs, cache, current = [js.strategy._key], [], {}, {}
    jtr = JTracer()
    jout = js.run(3, batches=_batches, trace=jtr, hooks=JHooks(**QUIET))

    def codec_bits(wave, leaf, client, shape):
        while len(subs) <= wave:
            k, sub = jax.random.split(chain[-1])
            chain.append(k)
            subs.append(sub)
        if (wave, leaf) not in cache:
            cache[wave, leaf] = jax.random.split(
                jax.random.split(subs[wave], len(sizes))[leaf], C)
        words = np.asarray(jax.random.bits(cache[wave, leaf][client],
                                           tuple(shape), jnp.uint32))
        current["leaf"] = leaf
        return torch.from_numpy(words.view(np.int32).copy()).view(
            torch.uint32)

    scales = [[] for _ in sizes]
    quantize = ops.quantize_int8

    def recording(x, b):
        q, s = quantize(x, b)
        scales[current["leaf"]].append(s)
        return q, s

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ops, "quantize_int8", recording)
        low, hits = record_near_eps_steps(mp)
        tr = Tracer()
        ts = _session("async_hier_fl", codec_bits=codec_bits,
                      mobility=MobilitySpec(size=5, radius=1, seed=1),
                      **ASYNC)
        out = ts.run(3, state=state, trace=tr, hooks=LoopHooks(**QUIET),
                     batches=lambda w: bridge.tree_from_numpy(_batches(w),
                                                              "cpu"))
    finally:
        mp.undo()
    assert out["event_log"] == jout["event_log"]
    assert tr.to_bytes() == jtr.to_bytes()
    kinds = {e[0] for e in out["event_log"]}
    assert {"pod_migration", "edge_flush"} <= kinds
    assert [h["n_vehicles"] for h in out["history"]] == [4.0, 4.0, 2.0]
    eng = ts.strategy.engine
    assert sum(map(len, eng.wave_members)) * len(sizes) == sum(
        map(len, scales))
    want = jax.tree.leaves(js.merged_params())
    steps = [2 * np.max(np.stack([np.repeat(s.numpy(), ops.LANES, 1)
                                  .reshape(-1)[:sizes[i]] for s in sc]), 0
                        ).reshape(w.shape)
             for i, (sc, w) in enumerate(zip(scales, want))]
    n_adam = int(ts.state[1].step.max())
    assert n_adam == 2 * max(sum(i in m for m in eng.wave_members)
                             for i in range(C))
    opt = ts.strategy._optimizer()
    full = opt.lr * adam_step_bound(opt.b1, opt.b2, n_adam)
    near = total = 0
    worst = 0.0
    for w, g, lo, hit, tol in zip(want, leaves(ts.merged_params()), low,
                                  hits, steps):
        d = np.abs(g.numpy() - np.asarray(w))
        flag = lo.numpy() < NEAR_EPS
        assert not ((d > tol) & ~flag).any(), float(d[~flag].max())
        near_tol = tol + 2 * full * hit.numpy()
        assert not (d > near_tol)[flag].any(), float(d[flag].max())
        worst = max(worst, float((d[flag] / near_tol[flag]).max(
            initial=0.0)))
        near += int(flag.sum())
        total += d.size
    assert near <= 1e-3 * total, (near, total)
    print(f"near-eps params: {near} of {total}, the farthest at {worst:.4f} "
          f"of its bound (a full Adam step {full:.4g})")


def test_sync_mode_is_hier_fl_bitwise():
    """clock=None, no jitter, no migration: three merges equal three
    hier_fl rounds bit for bit (client params, Adam state, the global
    params), with the same default codec bits."""
    hier = _session("hier_fl")
    hier.run(3, hooks=LoopHooks(**QUIET))
    asyn = _session("async_hier_fl")
    out = asyn.run(3, hooks=LoopHooks(**QUIET))
    assert out["merges"] == 3
    for x, y in zip(leaves(hier.state[0]), leaves(asyn.state[0])):
        assert torch.equal(x, y)
    assert torch.equal(hier.state[1].step, asyn.state[1].step)
    for x, y in zip(leaves(hier.state[1].m) + leaves(hier.state[1].v),
                    leaves(asyn.state[1].m) + leaves(asyn.state[1].v)):
        assert torch.equal(x, y)
    for x, y in zip(leaves(hier.state[0]), leaves(asyn.merged_params())):
        assert torch.equal(x[0], y)
    kinds = [e[0] for e in out["event_log"]]
    assert kinds.count("backhaul_arrived") == 3 * TOPO.n_edges
    assert kinds.count("uplink_arrived") == 3 * TOPO.n_clients
    assert asyn.strategy.engine.wave_members == [(0, 1, 2, 3)] * 3


def test_async_tracing_is_bitwise_zero_cost(tmp_path):
    """A traced run's params, event log and metrics equal an untraced
    run's; the same seed traced twice gives the same bytes; the history
    rides both clocks; the launcher writes the same trace."""
    opts = dict(ASYNC, mobility=MobilitySpec(size=5, radius=1, seed=1))
    base = _session("async_hier_fl", **opts)
    ref = base.run(3, hooks=LoopHooks(**QUIET))
    runs = []
    for _ in range(2):
        tr, reg = Tracer(), MetricsRegistry()
        ses = _session("async_hier_fl", **opts)
        runs.append((ses, ses.run(3, hooks=LoopHooks(**QUIET), trace=tr,
                                  metrics=reg), tr, reg))
    (s1, o1, t1, r1), (_, o2, t2, _) = runs
    assert o1["event_log"] == ref["event_log"] == o2["event_log"]
    for x, y in zip(leaves(base.state[0]), leaves(s1.state[0])):
        assert torch.equal(x, y)
    for a, b in zip(ref["history"], o1["history"]):
        assert {k: v for k, v in a.items() if k != "t_wall_s"
                and not k.startswith("per_client")} == \
            {k: v for k, v in b.items() if k != "t_wall_s"
             and not k.startswith("per_client")}
    assert t1.to_bytes() == t2.to_bytes()
    assert V.validate(t1.events) == []
    assert sum(e["name"] == "merge" for e in t1.events) == o1["merges"]
    assert o1["history"][-1]["t_sim_s"] == o1["sim_time_s"]
    names = set(r1.snapshot()["metrics"])
    assert {"fl_merges", "fl_uplink_bytes", "fl_backhaul_bytes",
            "fl_observed_staleness_s", "fl_migrations"} <= names
    assert "trace_path" not in ref

    from repro_torch.launch import train as launch
    path = str(tmp_path / "trace.json")
    out = launch.main(["--device", "cpu", "--arch", "flad-adllm",
                       "--strategy", "async_hier_fl", "--codec", "int8",
                       "--local-steps", "2", "--steps", "3", "--shape",
                       "64x2", "--async-clock", "0.05", "--migrate-every",
                       "0.05", "--compute-jitter", "0.3", "--trace", path])
    assert out["trace_path"] == path and V.validate_file(path) == []
    assert out["session"].strategy.engine.clock == 0.05


def test_trace_needs_an_async_strategy_and_profile_runs(tmp_path):
    with pytest.raises(ValueError, match="async"):
        _session("hier_fl").run(1, trace=Tracer())
    from repro_torch.obs import ProfileOptions
    opts = ProfileOptions(trace_dir=str(tmp_path / "prof"))
    out = _session("async_hier_fl").run(1, hooks=LoopHooks(**QUIET),
                                        profile=opts)
    assert out["profile_path"] == opts.path
    with open(opts.path) as f:
        assert '"traceEvents"' in f.read()


def test_bf16_sync_mode_keeps_the_partials_float32():
    """With bf16 params the reference's cloud_merge_at rounds the edge
    partials to bf16 before the merge, so its sync mode parts from its
    own hier_fl round; the port keeps them float32 and stays bitwise
    hier_fl's. One round of one local step, reduced flad-adllm in bf16,
    int8 codec."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.common import reduced as jax_reduced

    from repro_torch.configs import get_config, reduced
    kw = dict(shape="32x2", topology=SPEC, codec="int8", seed=3)
    jcfg = jax_reduced(jax_get_config("flad_adllm")).replace(
        param_dtype="bfloat16")
    cfg = reduced(get_config("flad-adllm")).replace(param_dtype="bfloat16")
    ref, port = {}, {}
    for strategy in ("hier_fl", "async_hier_fl"):
        s = JSession(cfg=jcfg, strategy=strategy, mesh=(1,), **kw)
        s.run(1, hooks=JHooks(**QUIET))
        ref[strategy] = [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(s.state[0])]
        s = Session(cfg=cfg, strategy=strategy, device="cpu", **kw)
        s.run(1, hooks=LoopHooks(**QUIET))
        port[strategy] = leaves(s.state[0])
    differ = sum(int((a != b).sum()) for a, b in zip(ref["hier_fl"],
                                                      ref["async_hier_fl"]))
    print(f"reference, bf16: {differ} of "
          f"{sum(a.size for a in ref['hier_fl'])} params differ")
    assert differ > 0
    assert port["hier_fl"][0].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(port["hier_fl"],
                                                 port["async_hier_fl"]))
