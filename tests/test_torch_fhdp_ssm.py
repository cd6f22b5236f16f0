"""The port's ssm FHDP adapter (``repro_torch.core.pipeline``, family
``ssm``) against the reference on the CPU, in float32.

The reference's adapter lays an xLSTM's units out stack after stack (every
mLSTM unit, then every sLSTM unit), so with two super-blocks or more its
FHDP step computes another network than ``xlstm.forward``
(``test_torch_pipeline.py::test_reference_ssm_fhdp_reorders_the_stack``).
The port keeps the reference's stacks and unit counts but lays the unit
sequence out in the flat model's order (m0 s0 m1 s1 ..). So:

  * with one super-block (``reduced(xlstm_350m)``), where both orders
    agree, the port's step equals the reference's ``make_fhdp_train_step``:
    the loss within relative 1e-5, the Adam moments as
    ``test_torch_pipeline.py`` holds them, the params within 2e-5 except
    the near-eps ones (Adam's eps amplifies last-bit grad differences;
    the sLSTM's saturated forget gate puts many grads there, so they may
    be up to 2% of the elements, as in ``test_torch_xlstm_train.py``);
  * with two and three super-blocks the port's FHDP loss equals the
    reference's flat ``model.loss`` within relative 1e-5, where the
    reference's own FHDP loss is more than 1e-3 away; under a SWIFT-style
    unequal template too;
  * the port's FHDP gradient, read back from Adam's first moment and
    merged with ``merge_stage_params``, equals the port's flat gradient
    within 1e-5 of each leaf's largest;
  * the flat-order template split is a cover of both stacks, stage by
    stage.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as JShape
from repro.configs import get_config as jax_config
from repro.configs.common import concrete_batch as jax_batch
from repro.configs.common import reduced as jax_reduced
from repro.core import pipeline as jpl
from repro.models import build_model as jax_model
from repro_torch import bridge
from repro_torch.api.mesh import MeshSpec
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline as pl
from repro_torch.models.registry import build_model
from repro_torch.tree import flatten, tree_map, unflatten
from test_torch_pipeline import (LOSS_RTOL, NEAR_EPS, PARAM_ATOL,  # noqa
                                 assert_moments_close, denominators,
                                 float_leaves, port_step, reference_steps,
                                 run_reference, state_to_torch, torch_batch)

NEAR_SHARE = 2e-2      # of the elements, near-eps (see the docstring)
LR = 1e-3
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(layers):
    jcfg = jax_reduced(jax_config("xlstm_350m")).replace(num_layers=layers)
    cfg = reduced(get_config("xlstm-350m")).replace(num_layers=layers)
    return jcfg, cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("layers,seq,want", [
    (2, (1, 1, 0, 0), {"mlstm": (1, 0, 0, 0), "slstm": (0, 1, 0, 0)}),
    (4, (2, 0, 2, 0), {"mlstm": (1, 0, 1, 0), "slstm": (1, 0, 1, 0)}),
    (6, (1, 2, 0, 3), {"mlstm": (1, 1, 0, 1), "slstm": (0, 1, 0, 2)}),
    (6, (3, 3), {"mlstm": (2, 1), "slstm": (1, 2)})])
def test_flat_order_template_split_is_a_cover(layers, seq, want):
    jcfg, cfg = _cfgs(layers)
    got = pl.template_from_sequence(cfg, seq)
    assert got == want
    n_super = layers // 2
    for name, t in got.items():                    # each stack covered
        assert sum(t) == n_super and min(t) >= 0, (name, t)
    assert tuple(sum(t[s] for t in got.values())
                 for s in range(len(seq))) == seq  # each stage's count
    # the plan walks the stages in the flat model's order, and each
    # stack's slots in order: concatenated, m0 s0 m1 s1 ..
    flat, seen = [], {"mlstm": 0, "slstm": 0}
    for s, units in enumerate(pl.stage_plan(cfg, got)):
        assert [i for n, i in units if n == "mlstm"] == list(
            range(got["mlstm"][s]))
        for name, _ in units:
            flat.append((name, seen[name]))
            seen[name] += 1
    assert flat == [(n, j) for j in range(n_super)
                    for n in ("mlstm", "slstm")]
    # the reference concatenates the stacks: the same only at one
    # super-block
    ref = jpl.template_from_sequence(jcfg, seq)
    assert (ref == got) == (layers == 2), ref


@pytest.mark.parametrize("seq", [(1, 2, 0, 2), (2, 2, 2, 1), (7, -1)])
def test_ssm_template_refuses_a_bad_cover(seq):
    _, cfg = _cfgs(6)
    with pytest.raises(ValueError, match="refusing"):
        pl.template_from_sequence(cfg, seq)


# -------------------------------------------------------------- the step
def test_one_super_block_step_matches_reference(mesh24, reference_steps):
    """Loss, Adam moments and params after one step from the same state."""
    tmpl, batch, states, losses = run_reference(
        reference_steps, "xlstm_350m", mesh24, 8, steps=1)
    cfg, mesh, step, h = port_step("xlstm_350m", (2, 4), 8, tmpl)
    assert h["templates"] == tmpl == {"mlstm": (1, 0, 0, 0),
                                      "slstm": (0, 1, 0, 0)}
    pp, opt, m = step(*state_to_torch(states[0]), torch_batch(batch))
    rel = abs(float(m["loss"]) - losses[0]) / abs(losses[0])
    assert rel <= LOSS_RTOL, (float(m["loss"]), losses[0])
    got_pp, got_opt = bridge.tree_to_numpy(pp), bridge.zero2_to_numpy(opt, 2)
    want_pp, want_opt = states[1]
    assert_moments_close(got_opt, want_opt)
    near = total = 0
    for g, w, lo, hi in zip(float_leaves(got_pp), float_leaves(want_pp),
                            denominators(want_pp, want_opt, True),
                            denominators(got_pp, got_opt, True)):
        d = np.abs(g - w)
        flag = np.minimum(lo, hi) < NEAR_EPS
        assert d.max() <= 2 * LR, d.max()
        bad = (d > PARAM_ATOL) & ~flag
        assert not bad.any(), (int(bad.sum()), float(d[bad].max()))
        near, total = near + int(flag.sum()), total + d.size
    print(f"near-eps params held to 2 lr: {near} of {total}")
    assert near <= NEAR_SHARE * total, (near, total)


@pytest.mark.parametrize("layers,seq", [(4, None), (6, (1, 2, 0, 3))])
def test_fhdp_loss_is_the_flat_models(mesh24, layers, seq):
    """Reduced xlstm_350m on the (2, 4) mesh, shape 64x8, key 0 (the
    inputs of ``test_reference_ssm_fhdp_reorders_the_stack``): the port's
    FHDP loss within relative 1e-5 of the reference's flat loss, the
    reference's own FHDP loss more than 1e-3 away (balanced templates;
    the SWIFT-style template (1, 2, 0, 3) holds stage 2 empty)."""
    jcfg, cfg = _cfgs(layers)
    shape = JShape("t", 64, 8, "train")
    key = jax.random.PRNGKey(0)
    jparams = jax_model(jcfg).init(key)
    batch = jax_batch(jcfg, shape, key)
    flat, _ = jax_model(jcfg).loss(jparams, batch, remat=False)
    flat = float(flat)
    tmpl = None if seq is None else pl.template_from_sequence(cfg, seq)
    if seq is None:
        jstep, h = jpl.make_fhdp_train_step(jcfg, shape, mesh24)
        jpp = jpl.stage_params_from(jparams, jcfg, h["templates"])
        _, _, jm = jax.jit(jstep)(jpp, jpl.zero2_init(jpp, 2), batch)
        assert abs(float(jm["loss"]) - flat) > 1e-3 * abs(flat)
    mesh = MeshSpec((2, 4)).build("cpu")
    step, h = pl.make_fhdp_train_step(cfg, ShapeConfig("t", 64, 8, "train"),
                                      mesh, learning_rate=LR,
                                      templates=tmpl)
    pp = pl.stage_params_from(bridge.tree_from_numpy(_np(jparams), "cpu"),
                              cfg, h["templates"])
    _, _, m = step(pp, pl.zero2_init(pp, 2), torch_batch(_np(batch)))
    assert abs(float(m["loss"]) - flat) <= LOSS_RTOL * abs(flat), (
        float(m["loss"]), flat)


def test_fhdp_gradient_is_the_flat_gradient():
    """On a (1, 4) mesh (one column of 4 one-sample microbatches, every
    one scored, no ZeRO-2 split) Adam's first moment after one step is
    0.1 x model x the gradient of the column's mean loss, the flat loss;
    merged back per stack it equals the port's flat gradient."""
    _, cfg = _cfgs(6)
    seq = (1, 2, 0, 3)
    tmpl = pl.template_from_sequence(cfg, seq)
    params = build_model(cfg).init(seed=5, device="cpu").to_dict()
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 48)).astype(np.int32))
        for k in ("tokens", "labels")}
    flat, spec = flatten(params)
    live = [p.detach().requires_grad_() for p in flat]
    loss, _ = build_model(cfg).loss(unflatten(spec, live), batch)
    want = unflatten(spec, list(torch.autograd.grad(loss, live)))
    mesh = MeshSpec((1, 4)).build("cpu")
    step, h = pl.make_fhdp_train_step(cfg, ShapeConfig("t", 48, 4, "train"),
                                      mesh, learning_rate=LR,
                                      templates=tmpl)
    assert h["microbatches"] == 4 and h["mb"] == 1
    pp = pl.stage_params_from(params, cfg, tmpl)
    _, opt, m = step(pp, pl.zero2_init(pp, 1, sharded=False), batch)
    loss = float(loss.detach())
    assert abs(float(m["loss"]) - loss) <= 1e-6 * loss

    def grad(mm, p):
        return (mm / (0.1 * 4)).reshape(p.shape)

    got = pl.merge_stage_params(
        {part: tree_map(grad, opt["m"][part], pp[part])
         for part in ("shared", "stacks")}, tmpl)
    for a, b in zip(flatten(got)[0], flatten(want)[0]):
        assert a.shape == b.shape
        err = float((a - b.float()).abs().max())
        assert err <= GRAD_RTOL * float(b.abs().max()), (err, b.shape)
