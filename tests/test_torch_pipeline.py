"""The port's FHDP pipeline (``repro_torch.core.pipeline``) against the
reference on the CPU: the stage layout (balanced and unequal templates,
``template_from_sequence``'s refusal of a bad cover, stage rotation,
``merge_stage_params(stage_params_from(p)) == p`` bitwise, the ZeRO-2
moment layouts) and the pipelined train step on reduced flad-adllm on
the conftest meshes (2, 4), (2, 2) and (2, 2, 2), fed the reference's
own initial params and the same numpy batches. The meshes' batches
cover the reference's microbatch geometries: a column batch smaller
than the stage count (clamped ranks), one microbatch a stage, and a
microbatch count the stages do not divide (the reference scores only the
first S * (M // S) microbatches).

Each mesh runs the reference's jitted step twice, and the port's step
once from the reference's initial state and once from the reference's
state after step 1 (bridged), so both steps are compared from the same
inputs; the port's own second step (from its own first) is held to the
reference's loss too. Tolerances (float32, the reference at "highest"
matmul precision):
  * loss: relative 1e-5;
  * Adam moments m and v: every element within rtol 1e-5 plus 1e-5 of
    its leaf's largest |value|. The reference's moments see the gradient
    of the mean loss times pod x data^2 x model (FedSGD; ZeRO-2's
    psum_scatter sums over ``data`` what the sync's psum already summed);
    a port with another factor is off by a whole factor here;
  * updated params: atol 2e-5, except the near-eps ones. Adam's step is
    m_hat / (sqrt(v_hat) + eps), and its derivative in g is about eps /
    sqrt(v_hat)^2: where a grad is a rounding residue (the waypoint L1's
    counts of +-1/N cancel, as do some CE grads), its relative error is
    of order 1, and the update moves by up to lr * eps / sqrt(v_hat).
    The reference scales the grads by up to 16 here (see above), so a
    residue the flat model sees at 1e-8 reaches Adam at 1.6e-7. Elements
    where an update meets a nonzero sqrt(v_hat) below 100 * eps (either
    package's; there the move is at most lr / 100 = 1e-5, half the atol)
    are held to 2 * lr a step and may be at most 0.1% of the elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as JShape
from repro.configs import get_config as jax_config
from repro.configs.common import reduced as jax_reduced
from repro.core import pipeline as jpl
from repro.models import build_model as jax_model
from repro_torch import bridge
from repro_torch.api.mesh import MeshSpec
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline as pl
from repro_torch.models.registry import build_model
from repro_torch.tree import leaves

LR = 1e-3
NEAR_EPS = 1e-6        # 100 * Adam's eps: the grads it amplifies
PARAM_ATOL = 2e-5
MOMENT_RTOL = 1e-5
LOSS_RTOL = 1e-5
#: mesh fixture -> (dims, global batch, template) for reduced flad-adllm:
#: M < S (clamped ranks) under a SWIFT-style unequal template (stage 0
#: holds both layers, the other stages none), M = S, and M = 3 over S = 2
#: (M % S != 0)
DENSE_MESHES = {"mesh24": ((2, 4), 4, {"blocks": (2, 0, 0, 0)}),
                "mesh22": ((2, 2), 8, None),
                "mesh222": ((2, 2, 2), 12, None)}
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def numpy_batch(cfg, bg, seed):
    """A numpy batch both packages take (the reduced config's shapes)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vision":
        p, f = cfg.prefix_tokens, cfg.prefix_dim
        return {"rgb": rng.standard_normal((bg, p, f)).astype(np.float32),
                "lidar": rng.standard_normal((bg, p, f)).astype(np.float32),
                "waypoints": rng.standard_normal(
                    (bg, cfg.num_waypoints, 2)).astype(np.float32),
                "light": rng.integers(0, cfg.num_light_classes, (bg,))
                .astype(np.int32)}
    return {k: rng.integers(0, cfg.vocab_size, (bg, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference_steps():
    """The module's jitted reference FHDP steps, one per (config, mesh,
    batch, options): ``get(jcfg, jmesh, bg, **options) -> (jitted step,
    helpers)``, built at first use."""
    cache = {}

    def get(jcfg, jmesh, bg, **options):
        key = (jcfg.name, jcfg.num_layers, jcfg.d_model,
               tuple(jmesh.shape.items()), bg,
               repr(sorted(options.items())))
        if key not in cache:
            step, h = jpl.make_fhdp_train_step(
                jcfg, JShape("t", SEQ, bg, "train"), jmesh, **options)
            cache[key] = (jax.jit(step), h)
        return cache[key]

    return get


def run_reference(reference_steps, arch, jmesh, bg, *, fed_sgd=True,
                  templates=None, steps=2, seed=0):
    """The reference's jitted FHDP step from its own init, ``steps`` times
    on one numpy batch: (cfg, batch, [(pp, opt) before each step and
    after the last], [loss of each step]) as numpy."""
    jcfg = jax_reduced(jax_config(arch))
    params = jax_model(jcfg).init(jax.random.PRNGKey(seed))
    batch = numpy_batch(jcfg, bg, seed + 1)
    jstep, h = reference_steps(jcfg, jmesh, bg, learning_rate=LR,
                               fed_sgd=fed_sgd, templates=templates)
    pp = jpl.stage_params_from(params, jcfg, h["templates"])
    D = jmesh.shape["data"]
    opt = jpl.zero2_init(pp, D, sharded=fed_sgd and D > 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    states, losses = [(np_tree(pp), np_tree(opt))], []
    for _ in range(steps):
        pp, opt, m = jstep(pp, opt, jb)
        states.append((np_tree(pp), np_tree(opt)))
        losses.append(float(m["loss"]))
    return h["templates"], batch, states, losses


def port_step(arch, dims, bg, templates, *, fed_sgd=True):
    cfg = reduced(get_config(arch))
    mesh = MeshSpec(dims).build("cpu")
    step, h = pl.make_fhdp_train_step(
        cfg, ShapeConfig("t", SEQ, bg, "train"), mesh, learning_rate=LR,
        fed_sgd=fed_sgd, templates=templates)
    return cfg, mesh, step, h


def state_to_torch(state, pods=1):
    pp, opt = state
    return bridge.tree_from_numpy(pp, "cpu"), bridge.zero2_from_numpy(
        opt, "cpu", pods=pods)


def denominators(pp, opt, zero2):
    """Adam's sqrt(v_hat) per element of each float leaf of ``pp`` (the
    reference's layout, column 0), +inf where v is 0."""
    bc2 = 1.0 - 0.95 ** int(opt["step"])
    out = []
    for part in ("shared", "stacks"):
        for p, v in zip(jax.tree.leaves(pp[part]),
                        jax.tree.leaves(opt["v"][part])):
            staged = part == "stacks"
            lead = p.shape[0] if staged else 1
            n = p.size // lead
            v = v.reshape(lead, -1)[:, :n] if zero2 else \
                (v[:, 0] if staged else v[:1]).reshape(lead, -1)
            den = np.where(v > 0, np.sqrt(v / bc2), np.inf)
            out.append(den.reshape(p.shape))
    return out


def float_leaves(pp):
    return [np.asarray(x) for part in ("shared", "stacks")
            for x in jax.tree.leaves(pp[part])]


def assert_params_close(got, want, dens, steps):
    """Float leaves of ``got`` within PARAM_ATOL of ``want``, except the
    near-eps elements (smallest denominator in ``dens`` below NEAR_EPS),
    held to 2 * lr a step and at most 0.1% of the elements."""
    near = total = 0
    for g, w, den in zip(float_leaves(got), float_leaves(want), dens):
        d = np.abs(g - w)
        flag = den < NEAR_EPS
        assert d.max() <= 2 * LR * steps, d.max()
        bad = (d > PARAM_ATOL) & ~flag
        assert not bad.any(), (int(bad.sum()), float(d[bad].max()))
        near += int(flag.sum())
        total += d.size
    assert near <= 1e-3 * total, (near, total)
    return near


def assert_moments_close(got, want):
    """Every m and v element within MOMENT_RTOL of the reference's plus
    MOMENT_RTOL of its leaf's largest |value|; the layouts equal."""
    for k in ("m", "v"):
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if w.size:
                np.testing.assert_allclose(
                    g, w, rtol=MOMENT_RTOL,
                    atol=MOMENT_RTOL * float(np.abs(w).max()), err_msg=k)
    assert int(got["step"]) == int(want["step"])


def compare_steps(reference_steps, arch, jmesh, dims, bg, *,
                  templates=None):
    """Two FHDP steps of the port against the reference's (see the module
    docstring); returns the near-eps count."""
    tmpl, batch, states, losses = run_reference(reference_steps, arch,
                                                jmesh, bg,
                                                templates=templates)
    cfg, mesh, step, h = port_step(arch, dims, bg, tmpl)
    tb = torch_batch(batch)
    D = dims[-2]
    zero2 = D > 1
    near = 0
    mine = None
    for i in range(2):
        pp, opt, m = step(*state_to_torch(states[i]), tb)
        rel = abs(float(m["loss"]) - losses[i]) / abs(losses[i])
        assert rel <= LOSS_RTOL, (i, float(m["loss"]), losses[i])
        got_pp = bridge.tree_to_numpy(pp)
        got_opt = bridge.zero2_to_numpy(opt, D)
        want_pp, want_opt = states[i + 1]
        assert_moments_close(got_opt, want_opt)
        dens = [np.minimum(a, b) for a, b in zip(
            denominators(want_pp, want_opt, zero2),
            denominators(got_pp, got_opt, zero2))]
        near += assert_params_close(got_pp, want_pp, dens, 1)
        if i == 0:
            mine = (pp, opt)
    # the port's own second step, from its own first
    _, _, m2 = step(*mine, tb)
    assert abs(float(m2["loss"]) - losses[1]) <= LOSS_RTOL * abs(losses[1])
    return near, h


# ------------------------------------------------------------------ layout
def test_templates_match_reference():
    for layers, stages in ((12, 4), (2, 4), (16, 3), (5, 2)):
        assert pl.balanced_template(layers, stages) == \
            jpl.balanced_template(layers, stages)
        t = pl.balanced_template(layers, stages)
        assert pl.template_offsets(t) == jpl.template_offsets(t)
    for arch in ("flad_adllm", "flad_vision"):
        cfg, jcfg = reduced(get_config(arch)), jax_reduced(jax_config(arch))
        for s in (1, 2, 4):
            assert pl.make_templates(cfg, s) == jpl.make_templates(jcfg, s)
        for seq in ((2, 0), (0, 2), (1, 0, 1)):
            assert pl.template_from_sequence(cfg, seq) == \
                jpl.template_from_sequence(jcfg, seq)


@pytest.mark.parametrize("seq", [(1, 0), (2, 1), (3, -1), ()])
def test_template_from_sequence_refuses_a_bad_cover(seq):
    cfg = reduced(get_config("flad-adllm"))       # 2 layers
    with pytest.raises(ValueError, match="refusing"):
        pl.template_from_sequence(cfg, seq)


def test_other_families_raise_by_name():
    cfg = reduced(get_config("flad-adllm")).replace(family="moe")
    with pytest.raises(NotImplementedError, match="moe family"):
        pl.get_adapter(cfg)


def test_reference_ssm_fhdp_reorders_the_stack(mesh24):
    """Why the port's ssm adapter waits (ROADMAP A6b, queue C): the
    reference's adapter stacks every mlstm unit before every slstm unit,
    so its FHDP step equals the flat model with one super-block and
    computes another network with two (m0 m1 s0 s1 against m0 s0 m1
    s1). Flat vs FHDP loss of reduced xlstm_350m on the (2, 4) mesh,
    shape 64x8, key 0: equal (relative 1e-5) at num_layers 2, more than
    1e-3 apart at 4."""
    from repro.configs.common import concrete_batch as jax_batch
    shape = JShape("t", 64, 8, "train")
    losses = {}
    for layers in (2, 4):
        jcfg = jax_reduced(jax_config("xlstm_350m")).replace(
            num_layers=layers)
        model = jax_model(jcfg)
        key = jax.random.PRNGKey(0)
        params = model.init(key)
        batch = jax_batch(jcfg, shape, key)
        flat, _ = model.loss(params, batch, remat=False)
        step, h = jpl.make_fhdp_train_step(jcfg, shape, mesh24)
        pp = jpl.stage_params_from(params, jcfg, h["templates"])
        opt = jpl.zero2_init(pp, mesh24.shape["data"])
        _, _, metrics = jax.jit(step)(pp, opt, batch)
        losses[layers] = (float(flat), float(metrics["loss"]),
                          h["templates"])
    print(f"flat vs FHDP loss by num_layers: {losses}")
    for layers, (flat, fhdp, _) in losses.items():
        rel = abs(fhdp - flat) / abs(flat)
        assert (rel <= 1e-5) if layers == 2 else (rel > 1e-3), (layers,
                                                                losses)


@pytest.mark.parametrize("arch,template", [
    ("flad_adllm", {"blocks": (1, 1, 0, 0)}),
    ("flad_adllm", {"blocks": (2, 0, 0, 0)}),
    ("flad_adllm", {"blocks": (0, 1, 0, 1)})])
def test_stage_params_match_reference_and_merge_back_bitwise(arch,
                                                             template):
    jcfg = jax_reduced(jax_config(arch))
    jp = np_tree(jax_model(jcfg).init(jax.random.PRNGKey(3)))
    jpp = np_tree(jpl.stage_params_from(jp, jcfg, template))
    params = bridge.tree_from_numpy(jp, "cpu")
    pp = pl.stage_params_from(params, reduced(get_config(arch)), template)
    got = bridge.tree_to_numpy(pp)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jpp),
                            jax.tree.leaves(got)):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    merged = pl.merge_stage_params(pp, template)
    for a, b in zip(leaves(merged), leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # ZeRO-2 moments: the reference's layouts, sharded and per column
    for D, sharded in ((2, True), (2, False), (1, False), (3, True)):
        want = np_tree(jpl.zero2_init(jpp, D, sharded=sharded))
        got = bridge.tree_to_numpy(pl.zero2_init(pp, D, sharded=sharded))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert w.shape == g.shape and w.dtype == g.dtype
    # per-column moments on a pod mesh: every (pod, data) column
    wide = pl.zero2_init(pp, 2, sharded=False, pods=2)
    assert wide["m"]["stacks"]["blocks"]["ffn"]["wi"].shape[1] == 4


def test_rotation_matches_reference():
    jcfg = jax_reduced(jax_config("flad_adllm"))
    jp = jax_model(jcfg).init(jax.random.PRNGKey(1))
    tmpl = {"blocks": (1, 0, 1, 0)}
    jpp = jpl.stage_params_from(jp, jcfg, tmpl)
    pp = bridge.tree_from_numpy(np_tree(jpp), "cpu")
    for shift in (1, -1, 3):
        want = np_tree(jpl.rotate_stages(jpp["stacks"], shift))
        got = bridge.tree_to_numpy(pl.rotate_stages(pp["stacks"], shift))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert np.array_equal(w, g)
    back = pl.rotate_stages(pl.rotate_stages(pp["stacks"], 3), -3)
    for a, b in zip(leaves(back), leaves(pp["stacks"])):
        assert torch.equal(a, b)


def test_zero2_bridge_round_trip():
    jcfg = jax_reduced(jax_config("flad_adllm"))
    jpp = jpl.stage_params_from(jax_model(jcfg).init(jax.random.PRNGKey(2)),
                                jcfg, {"blocks": (1, 1)})
    opt = np_tree(jpl.zero2_init(jpp, 2, sharded=False))
    rng = np.random.default_rng(0)
    opt["m"] = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(x.dtype), opt["m"])
    for pods in (1, 2):
        port = bridge.zero2_from_numpy(opt, "cpu", pods=pods)
        assert port["m"]["shared"]["embed"]["table"].shape[0] == 2 * pods
        back = bridge.zero2_to_numpy(port, 2)
        for w, g in zip(jax.tree.leaves(opt), jax.tree.leaves(back)):
            assert np.array_equal(np.asarray(w), g)


def test_mesh_spec_matches_reference():
    from repro.api.mesh import MeshSpec as JMeshSpec
    for spec in ("2,4", (2, 2, 2), "4", None):
        j, t = JMeshSpec.parse(spec), MeshSpec.parse(spec)
        assert (j.dims, j.size, j.axis_names) == (t.dims, t.size,
                                                   t.axis_names)
    mesh = MeshSpec.parse("2,2,2").build("cpu")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.fl_clients == 4 and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="comma-separated"):
        MeshSpec.parse("2x4")
    with pytest.raises(RuntimeError, match="need 8 devices"):
        MeshSpec.parse("2,4", devices=4).build("cpu")
    assert MeshSpec.parse("2,4", devices=8).build("cpu").size == 8
    for kw in (dict(production=True), dict(multi_pod=True)):
        with pytest.raises(NotImplementedError, match="A8"):
            MeshSpec(**kw).build("cpu")


# -------------------------------------------------------------- the step
@pytest.mark.parametrize("mesh_name", sorted(DENSE_MESHES))
def test_fhdp_step_matches_reference_dense(mesh_name, request,
                                          reference_steps):
    dims, bg, tmpl = DENSE_MESHES[mesh_name]
    compare_steps(reference_steps, "flad_adllm",
                  request.getfixturevalue(mesh_name), dims, bg,
                  templates=tmpl)
    if tmpl is None:
        return
    # the unequal template computes the flat model's loss too
    cfg = reduced(get_config("flad-adllm"))
    jcfg = jax_reduced(jax_config("flad_adllm"))
    params = bridge.tree_from_numpy(
        np_tree(jax_model(jcfg).init(jax.random.PRNGKey(0))), "cpu")
    batch = torch_batch(numpy_batch(cfg, bg, 1))
    flat = float(build_model(cfg).loss(params, batch)[0].detach())
    _, mesh, step, _ = port_step("flad_adllm", dims, bg, tmpl)
    pp = pl.stage_params_from(params, cfg, tmpl)
    _, _, m = step(pp, pl.zero2_init(pp, 2), batch)
    assert abs(float(m["loss"]) - flat) <= 1e-5 * abs(flat)
