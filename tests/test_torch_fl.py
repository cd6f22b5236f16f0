"""The port's FL round against the reference on the CPU: the update codecs
(int8 fed the reference's own ``jax.random.bits`` along its key chain:
codes, scales, decoded values and residuals bitwise; top-k by exact index
and value), the topology's wire accounting, the two-tier aggregation,
and a two-round ``hier_fl`` run through ``Session.run`` at
``reduced(flad_adllm)`` in float32 with the lossless codec, started from
the reference Session's own initial state and fed the same batches.

Tolerance of the two-round run: the wire metrics are equal exactly, the
per-client losses within 1e-5 and the global params within 2e-5, except
where Adam's eps amplifies a grad. Adam's step is m_hat / (sqrt(v_hat) +
eps): where some update meets a nonzero sqrt(v_hat) below 10 * eps, a
last-bit difference in a grad moves the param by up to lr times a visible
fraction. Those near-eps elements (264 of 426624 on these inputs; the
port and the reference differ by at most 7.0e-5 there, by at most 1.9e-6
everywhere else) are held to 1e-4, a tenth of the learning rate, and may
be at most 0.1% of the params. The reference disagrees with itself the
same way: its XLA and Pallas attention paths leave 3 global params more
than 2e-5 apart (at most 2.7e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LoopHooks as JHooks, Session as JSession
from repro.comm import codecs as jcodecs
from repro.comm import hierarchy as jhier
from repro.comm.topology import parse_topology as jax_topology
from repro_torch import bridge
from repro_torch.api import (LoopHooks, Session, available_strategies,
                              get_strategy)
from repro_torch.comm import codecs, hierarchy
from repro_torch.comm.topology import parse_topology
from repro_torch.core.fedavg import fedavg
from repro_torch.train.optimizer import Adam
from repro_torch.tree import leaves

TOPO = "2@nano*2,agx*2"
C = 4
NEAR_EPS = 1e-7       # 10 * Adam's eps: the grads it amplifies
NEAR_EPS_ATOL = 1e-4  # a tenth of the learning rate


def adam_denominators(v, b2, step):
    """Adam's sqrt(v_hat) per element of each leaf of ``v``, with +inf
    where v is 0 (a grad that was exactly 0 moves nothing)."""
    bc2 = 1.0 - b2 ** step
    return [torch.where(x > 0, torch.sqrt(x / bc2), torch.inf)
            for x in leaves(v)]


def record_adam_denominators(monkeypatch):
    """Patch the port's Adam to keep, per element, the smallest nonzero
    sqrt(v_hat) that any update met (over clients, steps and rounds).
    Returns the list it keeps the leaf minima in, in flatten order."""
    low = []
    update = Adam.update

    def recording(self, grads, state, params):
        new, st = update(self, grads, state, params)
        den = adam_denominators(st.v, self.b2, float(st.step))
        low[:] = den if not low else [torch.minimum(a, b)
                                      for a, b in zip(low, den)]
        return new, st

    monkeypatch.setattr(Adam, "update", recording)
    return low


def assert_params_close(want, got, low, atol):
    """Every element of the ``got`` leaves within ``atol`` (a number, or
    one array per leaf) of ``want``, except the near-eps ones (``low`` <
    NEAR_EPS), which are held to NEAR_EPS_ATOL and may be at most 0.1% of
    the elements. Returns (near-eps count, element count)."""
    if np.isscalar(atol):
        atol = [atol] * len(low)
    near = total = 0
    for w, g, lo, tol in zip(want, got, low, atol):
        d = np.abs(g.detach().numpy() - np.asarray(w))
        flag = lo.numpy() < NEAR_EPS
        assert d.max() <= NEAR_EPS_ATOL, d.max()
        bad = (d > tol) & ~flag
        assert not bad.any(), (int(bad.sum()), float(d[bad].max()))
        near += int(flag.sum())
        total += d.size
    assert near <= 1e-3 * total, (near, total)
    return near, total


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(key, shape):
    """The reference's uint32 words for ``key``, as a torch uint32."""
    b = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return torch.from_numpy(b.view(np.int32).copy()).view(torch.uint32)


def _stacked(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((C, 300)).astype(np.float32),
            "b": {"u": (rng.standard_normal((C, 17, 9)) * 1e-3
                        ).astype(np.float32),
                  "z": np.zeros((C, 5), np.float32)}}
    res = {"w": rng.standard_normal((C, 300)).astype(np.float32) * 0.01,
           "b": {"u": np.zeros((C, 17, 9), np.float32),
                 "z": np.zeros((C, 5), np.float32)}}
    return tree, res


def test_int8_roundtrip_matches_reference_bitwise():
    tree, res = _stacked(0)
    key = jax.random.PRNGKey(5)
    want_dec, want_res = jcodecs.roundtrip_stacked(
        jcodecs.Int8Codec(), tree, res, key)
    # the reference's chain: one key per leaf, then one per client
    leaf_keys = jax.random.split(key, len(jax.tree.leaves(tree)))

    def bits(leaf, client, shape):
        return _bits(jax.random.split(leaf_keys[leaf], C)[client], shape)

    got_dec, got_res = codecs.roundtrip_stacked(
        codecs.Int8Codec(), bridge.tree_from_numpy(tree, "cpu"),
        bridge.tree_from_numpy(res, "cpu"), bits)
    for w, g in zip(jax.tree.leaves(want_dec) + jax.tree.leaves(want_res),
                    leaves(got_dec) + leaves(got_res)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    # the wire payload itself: codes and scales of every client's leaf
    jc, tc = jcodecs.Int8Codec(), codecs.Int8Codec()
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        for c in range(C):
            flat = leaf[c].reshape(-1)
            kk = jax.random.split(leaf_keys[i], C)[c]
            want = jc.encode(jnp.asarray(flat), kk)
            got = tc.encode(torch.from_numpy(flat.copy()),
                            bits(i, c, tc.bits_shape(flat.size)))
            np.testing.assert_array_equal(got["q"].numpy(),
                                          np.asarray(want["q"]))
            np.testing.assert_array_equal(got["scale"].numpy(),
                                          np.asarray(want["scale"]))
    assert tc.nbytes(300) == jc.nbytes(300) == 300 + 4 * 3


@pytest.mark.parametrize("k_frac", [0.05, 0.3, 1.0])
def test_topk_matches_reference_exactly(k_frac):
    rng = np.random.default_rng(1)
    flat = rng.standard_normal(1000).astype(np.float32)
    assert len(np.unique(np.abs(flat))) == flat.size    # tie-free input
    jc = jcodecs.get_codec("topk", k_frac=k_frac)
    tc = codecs.get_codec("topk", k_frac=k_frac)
    want = jc.encode(jnp.asarray(flat), None)
    got = tc.encode(torch.from_numpy(flat), None)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["values"].numpy(),
                                  np.asarray(want["values"]))
    np.testing.assert_array_equal(tc.decode(got, flat.size).numpy(),
                                  np.asarray(jc.decode(want, flat.size)))
    assert tc.nbytes(1000) == jc.nbytes(1000)
    assert tc.edge_nbytes(1000, 3) == jc.edge_nbytes(1000, 3)


def test_lossless_roundtrip_and_registry():
    tree, res = _stacked(2)
    dec, new_res = codecs.roundtrip_stacked(
        codecs.get_codec("none"), bridge.tree_from_numpy(tree, "cpu"),
        bridge.tree_from_numpy(res, "cpu"))
    for w, r, g, gr in zip(jax.tree.leaves(tree), jax.tree.leaves(res),
                           leaves(dec), leaves(new_res)):
        np.testing.assert_array_equal(g.numpy(), w + r)
        assert not gr.any()
    assert codecs.available_codecs() == jcodecs.available_codecs()
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("zstd")
    with pytest.raises(ValueError, match="k_frac"):
        codecs.get_codec("topk", k_frac=0.0)


def test_topology_and_aggregation_match_reference():
    spec = "3@nano*2,agx*3,nx"
    jt, tt = jax_topology(spec), parse_topology(spec)
    assert tt.edges == jt.edges
    for codec in ("none", "int8", "topk"):
        per_edge = [jcodecs.get_codec(codec).edge_nbytes(5000, len(m))
                    for m in jt.edges]
        want = jt.hier_round_stats(1234567, per_edge)
        got = tt.hier_round_stats(1234567, per_edge)
        assert got["uplink_bytes"] == want["uplink_bytes"]
        assert got["backhaul_bytes"] == want["backhaul_bytes"]
        assert got["round_time_s"] == want["round_time_s"]
        np.testing.assert_array_equal(got["edge_arrival_s"],
                                      want["edge_arrival_s"])
    flat_j, flat_t = jt.flat_round_stats(777777), tt.flat_round_stats(777777)
    assert flat_t["round_time_s"] == flat_j["round_time_s"]
    assert flat_t["backhaul_bytes"] == flat_j["backhaul_bytes"]
    assert tt.reassign(0, 2).edges == jt.reassign(0, 2).edges
    with pytest.raises(ValueError, match="last member"):
        parse_topology("2@nano,agx").reassign(0, 1)
    arrivals = [0.3, 1.7, 2.2]
    np.testing.assert_array_equal(
        hierarchy.staleness_weights(arrivals, 1.0, decay=0.5),
        jhier.staleness_weights(arrivals, 1.0, decay=0.5))

    rng = np.random.default_rng(3)
    stacked = {"a": rng.standard_normal((6, 7, 3)).astype(np.float32),
               "b": rng.standard_normal((6, 11)).astype(np.float32)}
    weights = np.array([1.0, 2.0, 0.5, 3.0, 1.0, 4.0], np.float32)
    stale = np.array([1.0, 0.5, 0.25], np.float32)
    jedge, jw = jhier.edge_aggregate(stacked, jnp.asarray(weights), jt)
    tedge, tw = hierarchy.edge_aggregate(
        bridge.tree_from_numpy(stacked, "cpu"), weights, tt)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    want = jhier.cloud_merge(jedge, jw, stale)
    got = hierarchy.cloud_merge(tedge, tw, stale)
    for w, g in zip(jax.tree.leaves(want), leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    flat = fedavg(bridge.tree_from_numpy(stacked, "cpu"), weights=weights)
    two_tier = fedavg(bridge.tree_from_numpy(stacked, "cpu"),
                      weights=weights, topology=tt)
    for a, b in zip(leaves(flat), leaves(two_tier)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="edge pod 0"):
        fedavg(bridge.tree_from_numpy(stacked, "cpu"),
               weights=[0.0, 0.0, 1.0, 1.0, 1.0, 1.0], topology=tt)


def test_strategy_registry():
    assert available_strategies() == ("distill_fl", "fedavg", "fl_pipeline",
                                      "hier_fl", "pipeline",
                                      "swift_pipeline", "tensor")
    with pytest.raises(NotImplementedError, match="later slice"):
        get_strategy("async_hier_fl")
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("nope")
    with pytest.raises(ValueError, match="async_decay"):
        get_strategy("hier_fl", async_deadline=1.0)
    s = get_strategy("hier_fl", topology=TOPO, codec="int8",
                     async_decay=0.5)
    hier = dict(arch="flad-adllm", strategy="hier_fl", device="cpu")
    stats = s._round_stats(Session(**hier).cfg)
    assert stats["staleness"].shape == (2,)
    assert (stats["staleness"] > 0).all() and (stats["staleness"] <= 1).all()
    with pytest.raises(NotImplementedError, match="later slice"):
        Session(**hier, hooks=LoopHooks(tracer=object())).run(1)
    with pytest.raises(NotImplementedError, match="observability"):
        Session(**hier).run(1, trace="t.json")


def _quiet(hooks_cls):
    return hooks_cls(log_every=1, log_fn=lambda *a, **k: None)


def test_identity_codec_round_is_flat_fedavg():
    """With the lossless codec and uniform weights the fabric round is
    the flat FedAvg round (port only, no JAX)."""
    kw = dict(arch="flad-adllm", shape="32x2", local_steps=2, device="cpu")
    hier = Session(strategy="hier_fl", topology=TOPO, codec="none", **kw)
    flat = Session(strategy="fedavg", clients=C, **kw)
    seen = []
    hooks = _quiet(LoopHooks)
    hooks.on_round = lambda r, m: seen.append((r, m))
    out = hier.run(2, hooks=hooks)
    flat.run(2, hooks=_quiet(LoopHooks))
    stats = hier.strategy.comm_stats
    assert [r for r, _ in seen] == [0, 1]
    for _, m in seen:
        assert m["comm_bytes_up"] == stats["uplink_bytes"]
        assert m["sim_round_s"] == stats["round_time_s"]
        assert m["loss"].shape == (C,)
    assert [h["round"] for h in out["history"]] == [1, 2]
    assert "loss" not in out["history"][0]      # per-client, kept whole
    assert out["history"][0]["per_client/loss"].shape == (C,)
    for a, b in zip(leaves(hier.merged_params()),
                    leaves(flat.merged_params())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_hier_fl_none_codec_matches_reference(monkeypatch):
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, 512, (C, 2, 2, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    js = JSession("flad-adllm", strategy="hier_fl", mesh=(1,),
                  shape="64x2", topology=TOPO, codec="none", local_steps=2)
    _, (jp, jo) = js.build()
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    state = bridge.fl_state_from_numpy(np_(jp), np.asarray(jo.step),
                                       np_(jo.m), np_(jo.v), "cpu")
    jout = js.run(2, batches=batches, hooks=_quiet(JHooks))

    low = record_adam_denominators(monkeypatch)
    ts = Session("flad-adllm", strategy="hier_fl", shape="64x2",
                 topology=TOPO, codec="none", local_steps=2, device="cpu")
    tout = ts.run(2, state=state,
                  batches=[bridge.tree_from_numpy(b, "cpu") for b in batches],
                  hooks=_quiet(LoopHooks))

    for jh, th in zip(jout["history"], tout["history"]):
        for k in ("comm_bytes_up", "comm_bytes_backhaul", "sim_round_s"):
            assert th[k] == jh[k], k
        np.testing.assert_allclose(th["per_client/loss"],
                                   jh["per_client/loss"], atol=1e-5)
    near, total = assert_params_close(jax.tree.leaves(js.merged_params()),
                                      leaves(ts.merged_params()), low, 2e-5)
    print(f"near-eps params held to {NEAR_EPS_ATOL}: {near} of {total}")
