"""FHDP on reduced flad-vision, the port against the reference on the CPU:
the pipelined train step on the conftest meshes (2, 4), (2, 2) and (2, 2,
2) (two steps; loss, Adam moments and params as in
``tests/test_torch_pipeline.py``, whose tolerances and near-eps rule
apply), an ``fl_pipeline`` round through both packages' round functions,
and the ``pipeline`` and ``fl_pipeline`` strategies through
``Session.run``.

The ``fl_pipeline`` round runs 2 local steps on each data column with no
cross-column sync, then averages the columns. The reference keeps each
column's diverged params on that column's devices behind a layout
replicated over ``data``, and its step's ``loss`` metric is column 0's
(reading the replicated value gives device 0's). The port holds the
columns explicitly and reports column 0's loss. Compared: the params
after the FedAvg (the near-eps rule over both local steps); the per-
column moments (rtol 1e-5 plus 1e-4 of the leaf's largest |value|: the
first step's near-eps params move the second step's grads; the moments
see each column's grads times ``model``, the transpose of the loss's
psum); and the metric, column 0's loss of the last local step, within
1e-4 relative (the first step's near-eps params move it by up to 2e-5
relative). A port-only test shows the metric is column 0's and not the
columns' mean; the step tests above pin a single step to 1e-5.
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
from repro.core.fhdp import make_fl_pipeline_round as jax_fl_round
from repro.models import build_model as jax_model
from repro_torch import bridge
from repro_torch.api import LoopHooks, MeshSpec, Session
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline as pl
from repro_torch.core.fhdp import init_fhdp, make_fl_pipeline_round
from repro_torch.models.registry import build_model
from repro_torch.tree import leaves
from test_torch_pipeline import (LR, MOMENT_RTOL, assert_params_close,
                                 compare_steps, denominators, np_tree,
                                 numpy_batch, reference_steps,  # noqa: F401
                                 torch_batch)

#: mesh fixture -> (dims, global batch) for reduced flad-vision: one
#: sample a microbatch and a stage (M = S = 4); two a microbatch (M = S
#: = 2); a pod axis with one sample a microbatch (M = S = 2)
VISION_MESHES = {"mesh24": ((2, 4), 8), "mesh22": ((2, 2), 8),
                 "mesh222": ((2, 2, 2), 8)}
ROUND_BATCH, LOCAL = 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mesh_name", sorted(VISION_MESHES))
def test_fhdp_step_matches_reference_vision(mesh_name, request,
                                           reference_steps):
    dims, bg = VISION_MESHES[mesh_name]
    _, h = compare_steps(reference_steps, "flad_vision",
                         request.getfixturevalue(mesh_name), dims, bg)
    S, cols = dims[-1], bg // h["columns"]
    assert h["mb"] == max(1, cols // S)


def test_first_step_loss_is_the_flat_models():
    """The reference's own equivalence check (tests/test_pipeline.py): the
    pipelined loss equals the flat model's on the same params and batch."""
    cfg = reduced(get_config("flad-vision"))
    params = build_model(cfg).init(seed=0, device="cpu").to_dict()
    batch = torch_batch(numpy_batch(cfg, 8, 5))
    flat = float(build_model(cfg).loss(params, batch)[0].detach())
    mesh = MeshSpec((2, 4)).build("cpu")
    step, _ = pl.make_fhdp_train_step(cfg, ShapeConfig("t", 1, 8, "train"),
                                      mesh)
    pp = pl.stage_params_from(params, cfg, pl.make_templates(cfg, 4))
    _, _, m = step(pp, pl.zero2_init(pp, 2), batch)
    assert abs(float(m["loss"]) - flat) <= 1e-5 * abs(flat)


def test_attention_routes_of_both_fhdp_steps(mesh24, monkeypatch):
    """Where each package's FHDP step sends its self-attention. The
    port's pipeline block passes ``positions_contiguous=True``, as its
    flat forward does, so every encoder layer reaches the flash gate,
    non-causal: once per (column, microbatch, layer) in the forward and
    once more in the backward's recompute (per-layer remat), the counts
    ``chip_smoke.py`` holds the card's launches to. The reference's
    pipeline block passes nothing, and under ``jit`` its positions are a
    tracer that ``_contiguous_positions`` cannot read, so even with the
    kernel backend on its step never reaches the kernel, while its flat
    loss does: the CPU parity tests compare the reference's dense
    attention with the port's (plain on the CPU) flash attention, the
    same arithmetic up to summation order."""
    from repro.kernels import ops as jops
    from repro.models import blocks as jblocks
    from repro_torch.kernels import ops

    calls = []
    real = ops.flash_attention_ad

    def counting(q, k, v, scale, causal, *args, **kw):
        calls.append(causal)
        return real(q, k, v, scale, causal, *args, **kw)

    monkeypatch.setattr(ops, "flash_attention_ad", counting)
    cfg = reduced(get_config("flad-vision"))
    mesh = MeshSpec((2, 4)).build("cpu")
    pp, opt, _ = init_fhdp(cfg, mesh, 0)
    step, h = pl.make_fhdp_train_step(
        cfg, ShapeConfig("t", 1, ROUND_BATCH, "train"), mesh)
    step(pp, opt, torch_batch(numpy_batch(cfg, ROUND_BATCH, 6)))
    assert calls == [False] * (2 * h["columns"] * h["microbatches"]
                               * cfg.num_layers)

    traced = []
    monkeypatch.setattr(jops, "flash_attention_ad",
                        lambda q, k, v, scale, causal, *a, **kw:
                        traced.append(causal) or q)
    monkeypatch.setattr(jblocks, "_KERNEL_BACKEND", True)
    jcfg = jax_reduced(jax_config("flad_vision"))
    params = jax_model(jcfg).init(jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in
              numpy_batch(jcfg, ROUND_BATCH, 6).items()}
    jstep, jh = jpl.make_fhdp_train_step(
        jcfg, JShape("t", 1, ROUND_BATCH, "train"), mesh24)
    jpp = jpl.stage_params_from(params, jcfg, jh["templates"])
    jax.eval_shape(jstep, jpp, jpl.zero2_init(jpp, 2), jbatch)
    assert traced == []
    jax.eval_shape(lambda p: jax_model(jcfg).loss(p, jbatch)[0], params)
    assert traced == [False]     # the layer scan's body, traced once


def test_fl_pipeline_round_matches_reference(mesh24):
    jcfg = jax_reduced(jax_config("flad_vision"))
    params = jax_model(jcfg).init(jax.random.PRNGKey(0))
    batches = [numpy_batch(jcfg, ROUND_BATCH, 10 + e) for e in range(LOCAL)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jround, h = jax_fl_round(jcfg, JShape("t", 1, ROUND_BATCH, "train"),
                             mesh24, local_steps=LOCAL, learning_rate=LR)
    jpp = jpl.stage_params_from(params, jcfg, h["templates"])
    jopt = jpl.zero2_init(jpp, 2, sharded=False)
    start = (np_tree(jpp), np_tree(jopt))
    want_pp, want_opt, want_m = np_tree(jax.jit(jround)(
        jpp, jopt, {k: jnp.asarray(v) for k, v in stacked.items()}))

    cfg = reduced(get_config("flad-vision"))
    mesh = MeshSpec((2, 4)).build("cpu")
    shape = ShapeConfig("t", 1, ROUND_BATCH, "train")
    fl_round, _ = make_fl_pipeline_round(cfg, shape, mesh,
                                         local_steps=LOCAL, learning_rate=LR)
    pp = bridge.tree_from_numpy(start[0], "cpu")
    opt = bridge.zero2_from_numpy(start[1], "cpu")
    pp2, opt2, m = fl_round(pp, opt, torch_batch(stacked))
    got_pp = bridge.tree_to_numpy(pp2)
    got_opt = bridge.zero2_to_numpy(opt2, 2)
    want = float(want_m["loss"])
    assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
    for k in ("m", "v"):
        for g, w in zip(jax.tree.leaves(got_opt[k]),
                        jax.tree.leaves(want_opt[k])):
            assert g.shape == w.shape
            if w.size:
                np.testing.assert_allclose(
                    g, w, rtol=MOMENT_RTOL,
                    atol=1e-4 * float(np.abs(w).max()))
    # near-eps elements: the smallest denominator any column's update met
    # (the port's per-step moments, and the reference's after the round)
    step, _ = pl.make_fhdp_train_step(cfg, shape, mesh, fed_sgd=False,
                                      learning_rate=LR)
    cols, o = pl.column_params(pp, mesh), opt
    seen = [bridge.zero2_to_numpy(opt2, 2), want_opt]
    for e in range(LOCAL):
        cols, o, _ = step(cols, o, {k: v[e] for k, v in
                                    torch_batch(stacked).items()})
        seen.append(bridge.zero2_to_numpy(o, 2))
    dens = None
    for st in seen:
        for c in range(2):
            col = {k: jax.tree.map(lambda x, c=c: x[..., c:c + 1, :],
                                   st[k]) for k in ("m", "v")}
            col["step"] = st["step"]
            d = denominators(want_pp, col, False)
            dens = d if dens is None else [np.minimum(a, b)
                                           for a, b in zip(dens, d)]
    assert_params_close(got_pp, want_pp, dens, LOCAL)
    # the per-column moments differ: the columns trained apart
    wi = got_opt["m"]["stacks"]["blocks"]["ffn"]["wi"]
    assert not np.allclose(wi[:, 0], wi[:, 1])


def test_fl_pipeline_metric_is_column_zero(mesh24):
    """The round's metric is column 0's loss: with the columns' batches
    apart, it differs from the mean of the columns' losses."""
    cfg = reduced(get_config("flad-vision"))
    mesh = MeshSpec((2, 4)).build("cpu")
    pp, opt, _ = init_fhdp(cfg, mesh, 0, fed_sgd=False)
    batch = torch_batch(numpy_batch(cfg, ROUND_BATCH, 3))
    step, _ = pl.make_fhdp_train_step(
        cfg, ShapeConfig("t", 1, ROUND_BATCH, "train"), mesh, fed_sgd=False)
    _, _, m = step(pl.column_params(pp, mesh), opt, batch)
    params = pl.merge_stage_params(pp, pl.make_templates(cfg, 4))
    model = build_model(cfg)
    col = [float(model.loss(params, {k: v[c * 4:(c + 1) * 4]
                                     for k, v in batch.items()})[0])
           for c in range(2)]
    assert abs(float(m["loss"]) - col[0]) <= 1e-5 * abs(col[0])
    assert abs(col[0] - col[1]) > 1e-3


def test_pipeline_session_runs_and_merges():
    """``pipeline`` and ``fl_pipeline`` through Session.run on the CPU:
    history, a descending loss over four steps on one batch, and merged
    params with the flat model's leaf shapes."""
    quiet = LoopHooks(log_every=1, log_fn=lambda *a, **k: None)
    cfg = reduced(get_config("flad-vision"))
    batch = torch_batch(numpy_batch(cfg, 8, 4))
    ses = Session("flad-vision", mesh="2,2", shape="1x8", device="cpu",
                  learning_rate=2e-3)
    out = ses.run(4, batches=[batch] * 4, hooks=quiet)
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4]
    assert losses[-1] < losses[0]
    flat = build_model(cfg).init(seed=0, device="cpu").to_dict()
    merged = ses.merged_params()
    assert [t.shape for t in leaves(merged)] == \
        [t.shape for t in leaves(flat)]
    fl = Session("flad-vision", strategy="fl_pipeline", mesh="2,2",
                 shape="1x8", device="cpu", local_steps=2)
    out = fl.run(1, hooks=quiet)
    assert out["history"][0]["round"] == 1
    assert np.isfinite(out["history"][0]["loss"])
    assert [t.shape for t in leaves(fl.merged_params())] == \
        [t.shape for t in leaves(flat)]
