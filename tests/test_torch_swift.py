"""The port's SWIFT scheduler (``repro_torch.sched``) against the reference
on the CPU.

Pure Python, held exactly (``==`` on Python floats, computed in the
reference's order): the cost model's units (``model_units``,
``vision_encoder_units``) for full and reduced flad-vision and
flad-adllm; SWIFT's pipelines (``swift``, ``phase1_greedy``,
``greedy_matching``, ``pregenerate``, ``units_to_layer_template``:
templates, vehicle orders and path times) on several fleets, among them
the five-vehicle fleet ``chip_smoke.py`` trains over at full width; the
availability clustering. No params are built.

The double DQN, from the reference agent's Q-net weights bridged into
the port (``bridge.dqn_from_numpy``): ``q_values`` within 1e-6; the same
epsilon-greedy actions and replay samples (both on numpy's generator
with the same seed); after a few ``learn()`` steps on the same
transitions the online params within the FHDP step tests' tolerances
(``tests/test_torch_pipeline.py``: atol 2e-5, except where Adam's
sqrt(v_hat) is below 100 eps — there a last-bit grad difference moves
the update by up to lr — held to 2 lr a step and at most 0.1% of the
elements); and SWIFT with each package's agent builds the same
pipelines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.common import reduced as jax_reduced
from repro.recovery import templates as jtemplates
from repro.sched import clustering as jclustering
from repro.sched import costmodel as jcost
from repro.sched import dqn as jdqn
from repro.sched import swift as jswift
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.recovery import templates as templates
from repro_torch.sched import clustering, costmodel, dqn, swift
#: the five vehicles chip_smoke.py's swift phase trains over
from test_torch_trajectory import swift_fleet as card_fleet

Q_ATOL = 1e-6
PARAM_ATOL = 2e-5
NEAR_EPS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, full):
    cfg, jcfg = get_config(arch), jax_config(arch)
    return (cfg, jcfg) if full else (reduced(cfg), jax_reduced(jcfg))


@pytest.mark.parametrize("arch", ["flad_vision", "flad_adllm"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_units_equal_reference(arch, full):
    cfg, jcfg = configs(arch, full)
    for kw in (dict(), dict(seq_len=512, num_units=cfg.num_layers),
               dict(seq_len=64, dtype_bytes=4, num_units=3)):
        assert costmodel.model_units(cfg, **kw) == [
            costmodel.Unit(**vars(u)) for u in jcost.model_units(jcfg, **kw)]
    if cfg.family == "vision":
        for kw in (dict(), dict(tokens=64, dtype_bytes=2)):
            assert costmodel.vision_encoder_units(cfg, **kw) == [
                costmodel.Unit(**vars(u))
                for u in jcost.vision_encoder_units(jcfg, **kw)]
    if full and arch == "flad_vision":
        # the unit the card's fleet is sized in (ISSUE: 94,387,200 B)
        assert costmodel.model_units(cfg, seq_len=512)[0].cap == 94387200.0


def _fleet_case(name):
    """(port vehicles, reference vehicles, port units, reference units)."""
    cfg, jcfg = configs("flad_vision", True)
    units, junits = (costmodel.model_units(cfg, seq_len=512),
                     jcost.model_units(jcfg, seq_len=512))
    if name == "default":
        spec = "nano*4,agx*2"
    elif name == "card":
        spec = card_fleet(units[0].cap)
    elif name == "demo":
        cfg, jcfg = configs("flad_adllm", True)
        units, junits = costmodel.model_units(cfg), jcost.model_units(jcfg)
        spec = costmodel.demo_fleet(units[0].cap)
        assert spec == jcost.demo_fleet(junits[0].cap)
    elif name == "graph":
        units, junits = (costmodel.vision_encoder_units(cfg),
                         jcost.vision_encoder_units(jcfg))
        spec = "nx*2,nano*3,agx"
    else:                       # a mixed fleet with drawn stabilities
        rng = np.random.default_rng(7)
        cap = units[0].cap
        spec = [dict(cmp=float(c), mem=float(m) * cap, com=float(b),
                     stb=float(s))
                for c, m, b, s in zip(rng.uniform(0.3e12, 4e12, 9),
                                      rng.uniform(0.8, 5.5, 9),
                                      rng.uniform(0.05e9, 0.3e9, 9),
                                      rng.uniform(0.2, 1.0, 9))]
    return (costmodel.parse_fleet(spec), jcost.parse_fleet(spec), units,
            junits)


def _pipe(p):
    """A pipeline as comparable plain data (None stays None)."""
    if p is None:
        return None
    return (p.template(), [v.vid for v in p.path], p.time,
            [[u.name for u in part] for part in p.partition])


@pytest.mark.parametrize("fleet", ["default", "card", "demo", "graph",
                                   "mixed"])
def test_swift_pipelines_match_reference(fleet):
    vs, jvs, units, junits = _fleet_case(fleet)
    cp, jcp = costmodel.CostParams(), jcost.CostParams()
    assert [vars(v) for v in vs] == [vars(v) for v in jvs]
    for name in ("phase1_greedy", "greedy_matching"):
        assert _pipe(getattr(swift, name)(vs, units, cp)) == \
            _pipe(getattr(jswift, name)(jvs, junits, jcp)), name
    res, jres = swift.swift(vs, units, cp=cp), jswift.swift(jvs, junits,
                                                            cp=jcp)
    assert _pipe(res.initial) == _pipe(jres.initial)
    assert {k: _pipe(p) for k, p in res.essential.items()} == \
        {k: _pipe(p) for k, p in jres.essential.items()}
    pipes = [res.initial] + list(res.essential.values())
    jpipes = [jres.initial] + list(jres.essential.values())
    for p, jp in zip(pipes, jpipes):
        for stages in (2, 4):
            if p is None:
                continue
            try:
                want = jswift.units_to_layer_template(jp, stages)
            except ValueError as e:
                with pytest.raises(ValueError, match="cannot fold"):
                    swift.units_to_layer_template(p, stages)
                assert "cannot fold" in str(e)
                continue
            assert swift.units_to_layer_template(p, stages) == want
    if res.initial is None:
        with pytest.raises(ValueError, match="cannot host"):
            jtemplates.pregenerate(jvs, junits, jcp)
        with pytest.raises(ValueError, match="cannot host"):
            templates.pregenerate(vs, units, cp)
        return
    ts = templates.pregenerate(vs, units, cp)
    jts = jtemplates.pregenerate(jvs, junits, jcp)
    assert _pipe(ts.active) == _pipe(jts.active)
    assert {k: _pipe(p) for k, p in ts.on_departure.items()} == \
        {k: _pipe(p) for k, p in jts.on_departure.items()}
    for k, p in ts.on_departure.items():
        if p is not None:
            jp = jts.on_departure[k]
            assert templates.redistribution_bytes(ts.active, p) == \
                jtemplates.redistribution_bytes(jts.active, jp)
            assert templates.partition_ranges(p) == \
                jtemplates.partition_ranges(jp)
    if fleet == "card":
        # the issue's templates: (4, 4, 3, 1) headed by vehicle 0; the
        # departure of vehicle 0 gives (4, 3, 3, 2)
        assert swift.units_to_layer_template(ts.active, 4) == (4, 4, 3, 1)
        assert ts.active.path[0].vid == 0
        assert swift.units_to_layer_template(ts.on_departure[0], 4) == \
            (4, 3, 3, 2)
    if fleet == "default":
        # every vehicle holds the whole model: a departure never changes
        # the template at full width (ROADMAP queue C)
        assert {swift.units_to_layer_template(p, 4)
                for p in ts.on_departure.values()} == {(12, 0, 0, 0)}


def test_cost_functions_match_reference():
    vs, jvs, units, junits = _fleet_case("mixed")
    cp, jcp = costmodel.CostParams(mu=0.4, nu=1.2, n_batch=8), \
        jcost.CostParams(mu=0.4, nu=1.2, n_batch=8)
    parts = [units[:3], units[3:4], units[4:9], units[9:]]
    jparts = [junits[:3], junits[3:4], junits[4:9], junits[9:]]
    path, jpath = vs[:4], jvs[:4]
    assert costmodel.path_time(path, parts, cp) == \
        jcost.path_time(jpath, jparts, jcp)
    assert costmodel.partition_feasible(path, parts) == \
        jcost.partition_feasible(jpath, jparts)
    for mb in (1, 8):
        assert costmodel.pipeline_throughput(path, parts, cp, mb) == \
            jcost.pipeline_throughput(jpath, jparts, jcp, mb)
    for v, jv in zip(vs, jvs):
        assert costmodel.t_cmp(3e12, v, cp) == jcost.t_cmp(3e12, jv, jcp)
        assert costmodel.t_com(5e6, v, cp) == jcost.t_com(5e6, jv, jcp)
        assert costmodel.t_uplink(5e6, v) == jcost.t_uplink(5e6, jv)
    assert costmodel.BYTES_PER_PARAM_TRAIN == jcost.BYTES_PER_PARAM_TRAIN
    w, hw = swift.window_fleet(vs, 7, n_max=4), jswift.window_fleet(jvs, 7,
                                                                   n_max=4)
    assert ([v.vid for v in w[0]], w[1]) == ([v.vid for v in hw[0]], hw[1])


def test_cluster_fleet_matches_reference():
    rng = np.random.default_rng(3)
    spec = [dict(cmp=float(c), mem=float(m), com=0.1e9, stb=float(s),
                 dwl=float(d))
            for c, m, s, d in zip(rng.uniform(0.3e12, 4e12, 12),
                                  rng.uniform(1e9, 12e9, 12),
                                  rng.uniform(0.2, 1.0, 12),
                                  rng.uniform(10, 600, 12))]
    vs, jvs = costmodel.parse_fleet(spec), jcost.parse_fleet(spec)
    pairs = {(i, j): float(rng.uniform()) for i in range(12)
             for j in range(12)}
    for m_cap, m_cmp in ((20e9, 5e14), (6e9, 1e14), (60e9, 5e15)):
        kw = dict(m_cap=m_cap, m_cmp=m_cmp)
        task, jtask = clustering.TrainingTask(**kw), \
            jclustering.TrainingTask(**kw)
        split = clustering.availability_split(vs, task)
        jsplit = jclustering.availability_split(jvs, jtask)
        assert [[v.vid for v in g] for g in split] == \
            [[v.vid for v in g] for g in jsplit]
        for opts in (dict(), dict(stability=pairs), dict(max_size=3)):
            got = clustering.cluster_fleet(vs, task, **opts)
            want = jclustering.cluster_fleet(jvs, jtask, **opts)
            assert [[v.vid for v in c] for c in got[0]] == \
                [[v.vid for v in c] for c in want[0]]
            assert [v.vid for v in got[1]] == [v.vid for v in want[1]]


# ------------------------------------------------------------------- DQN
def _agents(cfg_kw, seed=0):
    jagent = jdqn.DoubleDQN(jdqn.DQNConfig(**cfg_kw), seed=seed)
    agent = dqn.DoubleDQN(dqn.DQNConfig(**cfg_kw), seed=seed, device="cpu")
    online = jax.tree.map(np.asarray, jagent.online)
    return bridge.dqn_from_numpy(agent, online), jagent


def _near_eps_close(got, want, v, step, lr, steps):
    """The step tests' rule: atol PARAM_ATOL, except where sqrt(v_hat) is
    below NEAR_EPS but not 0 (held to 2 lr a step, at most 0.1% of
    elements)."""
    bc2 = 1.0 - 0.95 ** step
    near = total = 0
    for k in sorted(want):
        d = np.abs(got[k] - np.asarray(want[k]))
        v_k = np.asarray(v[k])
        den = np.where(v_k > 0, np.sqrt(v_k / bc2), np.inf)
        flag = den < NEAR_EPS
        assert d.max() <= 2 * lr * steps, (k, d.max())
        assert not ((d > PARAM_ATOL) & ~flag).any(), (k, d.max())
        near += int(flag.sum())
        total += d.size
    assert near <= 1e-3 * total, (near, total)


def test_dqn_matches_reference_from_bridged_weights():
    kw = dict(obs_dim=swift.PipelineEnv(*_fleet_case("card")[::2],
                                        costmodel.CostParams()).obs_dim,
              n_actions=swift.N_MAX * len(swift.CHUNK_OPTIONS), batch=16,
              target_update=3, eps_decay_steps=20)
    agent, jagent = _agents(kw)
    got_online, got_target = bridge.dqn_to_numpy(agent)
    for k, w in jagent.online.items():
        assert np.array_equal(got_online[k], np.asarray(w))
        assert np.array_equal(got_target[k], np.asarray(w))
    rng = np.random.default_rng(11)
    obs = rng.standard_normal((32, kw["obs_dim"])).astype(np.float32)
    q = dqn.q_values(agent.online, torch.from_numpy(obs)).numpy()
    jq = np.asarray(jdqn.q_values(jagent.online, jnp.asarray(obs)))
    np.testing.assert_allclose(q, jq, rtol=0, atol=Q_ATOL)
    # the same exploration draws and greedy picks, masked alike
    for t in range(24):
        mask = (rng.uniform(size=kw["n_actions"]) < 0.3).astype(np.float32)
        explore = t % 3 != 0
        assert agent.act(obs[t], mask, explore) == \
            jagent.act(obs[t], mask, explore)
        agent.step_count = jagent.step_count = t
    # the same transitions, then learn() on both
    for t in range(40):
        nmask = (rng.uniform(size=kw["n_actions"]) < 0.5).astype(np.float32)
        tr = (obs[t % 32], int(rng.integers(kw["n_actions"])),
              float(rng.standard_normal()), obs[(t + 1) % 32], nmask,
              float(t % 7 == 0))
        agent.record(*tr)
        jagent.record(*tr)
    agent.step_count = jagent.step_count = 0
    steps = 5
    for _ in range(steps):
        loss, jloss = agent.learn(), jagent.learn()
        assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert agent.step_count == jagent.step_count
    assert int(agent.opt_state.step) == int(jagent.opt_state.step) == steps
    got_online, got_target = bridge.dqn_to_numpy(agent)
    _near_eps_close(got_online, jagent.online, jagent.opt_state.v, steps,
                    kw.get("lr", 1e-3), steps)
    # the target net took the online net at step 3 (target_update)
    assert not np.array_equal(got_target["w1"], got_online["w1"])
    assert agent.rng.random() == jagent.rng.random()


@pytest.mark.parametrize("fleet", ["card", "mixed"])
def test_swift_with_bridged_agents_matches_reference(fleet):
    vs, jvs, units, junits = _fleet_case(fleet)
    cp, jcp = costmodel.CostParams(), jcost.CostParams()
    probe = swift.PipelineEnv(vs, units, cp)
    agent, jagent = _agents(dict(obs_dim=probe.obs_dim,
                                 n_actions=probe.n_actions), seed=4)
    res = swift.swift(vs, units, agent=agent, cp=cp)
    jres = jswift.swift(jvs, junits, agent=jagent, cp=jcp)
    assert {k: _pipe(p) for k, p in res.essential.items()} == \
        {k: _pipe(p) for k, p in jres.essential.items()}
    for head in range(len(vs)):
        win, h = swift.window_fleet(vs, head)
        jwin, jh = jswift.window_fleet(jvs, head)
        assert _pipe(swift.dqn_pipeline(agent, win, units, cp, head=h)) == \
            _pipe(jswift.dqn_pipeline(jagent, jwin, junits, jcp, head=jh))
    ts = templates.pregenerate(vs, units, cp, agent=agent)
    jts = jtemplates.pregenerate(jvs, junits, jcp, agent=jagent)
    assert {k: _pipe(p) for k, p in ts.on_departure.items()} == \
        {k: _pipe(p) for k, p in jts.on_departure.items()}


def test_pipeline_env_matches_reference():
    """The environment's observations, masks and rewards, step by step,
    under one action sequence drawn from the valid actions."""
    vs, jvs, units, junits = _fleet_case("card")
    cp, jcp = costmodel.CostParams(), jcost.CostParams()
    rng = np.random.default_rng(5)
    for head in (None, 2):
        env = swift.PipelineEnv(vs, units, cp, head=head)
        jenv = jswift.PipelineEnv(jvs, junits, jcp, head=head)
        obs, mask = env.reset()
        jobs, jmask = jenv.reset()
        while True:
            assert np.array_equal(obs, jobs) and np.array_equal(mask, jmask)
            if env.done or not mask.any():
                break
            a = int(rng.choice(np.flatnonzero(mask)))
            obs, mask, r, done = env.step(a)
            jobs, jmask, jr, jdone = jenv.step(a)
            assert (r, done) == (jr, jdone)
        assert _pipe(env.result()) == _pipe(jenv.result())


def test_policy_entry_points_default_to_the_card():
    import inspect
    for fn in (dqn.DoubleDQN.__init__, dqn.init_qnet, swift.train_policy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    agent = swift.train_policy(
        lambda: _fleet_case("card")[::2], episodes=3, seed=1, device="cpu")
    assert agent.device.type == "cpu" and agent.replay.n > 0
    res = swift.swift(*_fleet_case("card")[::2], agent=agent)
    assert all(sum(p.template()) == 12 for p in res.essential.values())
