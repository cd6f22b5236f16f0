"""The port's hybrid family (Hymba: ``repro_torch.models.hymba`` and the
Mamba cell of ``repro_torch.models.recurrent``) against the reference on
the CPU, at ``reduced(hymba_1_5b)`` in float32, fed the reference's own
parameters through the bridge and the same numpy inputs.

Tolerances (float32; the reference at "highest" matmul precision; the
reference's associative scan and the port's doubling scan multiply the
same factors in other orders):
  * the Mamba cell's outputs and states within 1e-5, its sequence form
    against its own one-token steps within 5e-5 (states 1e-6), as
    ``tests/test_recurrent.py`` holds the reference's;
  * logits within 2e-4, as the dense serving tests hold them;
  * the loss within 1e-5, each gradient within 1e-4 of its leaf's
    largest;
  * greedy tokens exactly;
  * two ``hier_fl`` rounds: the wire metrics equal, the per-client losses
    within 1e-5, the global params within 2e-5 except where Adam's eps
    amplifies a grad (the near-eps rule of ROADMAP queue C: held to 1e-4,
    and the elements it exempts from 2e-5 at most 0.1% of the params).
    Here 3% of the params meet a sqrt(v_hat) below 1e-7, nearly all in
    the Mamba's dt path (``w_dt1``, ``w_dt2``, ``A_log``: dt starts at
    softplus(-4.6) = 0.01, so their grads are of Adam's eps), and those
    still land within 5e-7; so the cap counts the exempted elements, not
    every near-eps one;
  * the hybrid FHDP step as ``test_torch_pipeline.py`` holds the dense
    one (loss, Adam moments), its params under the same rule as the
    rounds' (near-eps below 100 x Adam's eps, as there). Its blocks
    run the flash kernels' plain version here, the reference's pipeline
    block plain attention under ``jit``: the same arithmetic on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LoopHooks as JHooks, Session as JSession
from repro.config import ShapeConfig as JShape
from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.core import steps as jsteps
from repro.models import build_model as jax_build_model
from repro.models import recurrent as JR
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline as pl
from repro_torch.models import hymba
from repro_torch.models import recurrent as R
from repro_torch.models.registry import abstract_params, build_model
from repro_torch.tree import leaves
from test_torch_fl import NEAR_EPS, NEAR_EPS_ATOL, record_adam_denominators
from test_torch_pipeline import NEAR_EPS as FHDP_NEAR_EPS
from test_torch_pipeline import (LOSS_RTOL, PARAM_ATOL,  # noqa: F401
                                 assert_moments_close, denominators,
                                 float_leaves, port_step, reference_steps,
                                 run_reference, state_to_torch, torch_batch)

CELL_ATOL = 1e-5
LOGIT_ATOL = 2e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
TOPO = "2@nano*2,agx*2"
C, ROUNDS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("hymba_1_5b"))
    cfg = reduced(get_config("hymba-1.5b"))
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, bridge.tree_from_numpy(_np(jparams), "cpu")


def test_config_and_params_match_reference(setup):
    jcfg, cfg, jparams, tp = setup
    assert cfg.family == "hybrid" and cfg.ssm.state_size == 8
    assert get_config("hymba_1_5b").ssm.state_size == 16
    want = dict(_leaves(_np(jparams)))
    got = dict(_leaves(abstract_params(cfg)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape, name
        # b_dt, A_log and D are float32 beside leaves in the model dtype
        assert str(t.dtype).endswith(str(w.dtype)), (name, t.dtype, w.dtype)
    full = abstract_params(get_config("hymba-1.5b"))
    assert full["blocks"]["mamba"]["A_log"].dtype == torch.float32
    assert full["blocks"]["mamba"]["w_in"].dtype == torch.bfloat16


# ------------------------------------------------------------------ Mamba
def _mamba(setup, layer=1):
    jcfg, cfg, jparams, tp = setup
    jp = jax.tree_util.tree_map(lambda a: a[layer],
                                jparams["blocks"]["mamba"])
    return jcfg, cfg, jp, bridge.tree_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("s,chunk", [(40, 16), (48, 256), (7, 4)])
def test_mamba_seq_and_step_match_reference(setup, s, chunk):
    """The sequence form from a nonzero state (h and the conv window),
    then three one-token steps, against the reference's."""
    jcfg, cfg, jp, tp = _mamba(setup)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s + 3, cfg.d_model)).astype(np.float32)
    di, n = R.mamba_dims(cfg)
    st = {"h": 0.1 * rng.standard_normal((2, di, n)).astype(np.float32),
          "conv": rng.standard_normal(
              (2, cfg.ssm.conv_kernel - 1, di)).astype(np.float32)}
    jy, jst = JR.apply_mamba_seq(jp, jnp.asarray(x[:, :s]), jcfg,
                                 state={k: jnp.asarray(v)
                                        for k, v in st.items()},
                                 chunk=chunk)
    ty, tst = R.apply_mamba_seq(tp, torch.from_numpy(x[:, :s]), cfg,
                                state={k: torch.from_numpy(v)
                                       for k, v in st.items()},
                                chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=CELL_ATOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=CELL_ATOL, err_msg=k)
    for t in range(s, s + 3):
        jy, jst = JR.apply_mamba_step(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                      jcfg)
        ty, tst = R.apply_mamba_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tst, cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=CELL_ATOL)
        np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                                   atol=CELL_ATOL)


@pytest.mark.parametrize("s,chunk", [(16, 8), (64, 64), (64, 8), (33, 16)])
def test_mamba_seq_matches_its_steps(setup, s, chunk):
    """The doubling scan against the recurrence one token at a time (the
    reference's ``test_mamba_chunked_matches_stepwise``)."""
    _, cfg, _, tp = _mamba(setup, 0)
    x = torch.from_numpy(np.random.default_rng(s + chunk).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    st = R.init_mamba_state(cfg, 2, "cpu")
    ys = []
    for t in range(s):
        y, st = R.apply_mamba_step(tp, x[:, t:t + 1], st, cfg)
        ys.append(y)
    got, fin = R.apply_mamba_seq(tp, x, cfg, chunk=chunk)
    assert float((got - torch.cat(ys, 1)).abs().max()) < 5e-5
    assert float((fin["h"] - st["h"]).abs().max()) < 1e-6
    assert torch.equal(fin["conv"], st["conv"])


# ------------------------------------------------------------------ model
def test_forward_prefill_and_decode_match_reference(setup):
    jcfg, cfg, jparams, tp = setup
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12)
                                             ).astype(np.int32)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    from repro.models import hymba as jh
    want, _, _ = jh.forward(jparams, jcfg, jnp.asarray(toks))
    got, _, _ = hymba.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    jst = jm.init_state(2, 16)
    with torch.no_grad():
        tst = tm.init_state(2, 16, "cpu")
        jl, jst = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :9])},
                             jst)
        tl, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :9])},
                             tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tl[:, 0].numpy(),
                                   np.asarray(want)[:, 8], atol=LOGIT_ATOL)
        for pos in range(9, 12):
            tok = toks[:, pos:pos + 1]
            jl, jst = jm.decode_step(jparams, jnp.asarray(tok), jst, pos)
            tl, tst = tm.decode_step(tp, torch.from_numpy(tok), tst, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL)
            np.testing.assert_allclose(tl[:, 0].numpy(),
                                       np.asarray(want)[:, pos],
                                       atol=LOGIT_ATOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst["ssm"][k].numpy(),
                                       np.asarray(jst["ssm"][k]),
                                       atol=CELL_ATOL, err_msg=k)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(setup, remat):
    """S 96 with the reference's Mamba chunk (the largest divisor of S up
    to 256): one chunk; remat recomputes each block in the backward."""
    jcfg, cfg, jparams, _ = setup
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
             for k in ("tokens", "labels")}

    def jloss(p):
        return jax_build_model(jcfg).loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)

    (want, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tree = bridge.tree_from_numpy(_np(jparams), "cpu")
    named = list(_leaves(tree))
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = build_model(cfg).loss(
        tree, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat=remat)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    assert abs(float(loss.detach()) - float(want)) <= LOSS_ATOL
    jg = dict(_leaves(_np(jgrads)))
    for (name, _), g in zip(named, grads):
        w = jg[name]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), (name, err)


# ---------------------------------------------------------------- serving
def test_legacy_session_serve_tokens_match_reference(setup):
    """``Session.serve(scheduler="legacy")``'s greedy streams against the
    reference's prefill and serve steps on the same prompts (the port
    draws them from a torch.Generator seeded with the session's seed)."""
    jcfg, cfg, jparams, tp = setup
    batch, context, steps, seed = 2, 10, 4, 3
    rep = Session("hymba-1.5b", device="cpu", seed=seed).serve(
        scheduler="legacy", batch=batch, context=context,
        decode_steps=steps, requests=2, params=tp, log_fn=None)
    gen = torch.Generator().manual_seed(seed)
    shape = JShape("serve", context + steps, batch, "decode")
    prefill = jsteps.make_prefill_step(jcfg, shape)
    serve = jsteps.make_serve_step(jcfg, shape)
    jm = jax_build_model(jcfg)
    for got in rep["sequences"]:
        ctx = torch.randint(0, cfg.vocab_size, (batch, context),
                            generator=gen, dtype=torch.int32).numpy()
        st = jm.init_state(batch, context + steps)
        logits, st = prefill(jparams, {"tokens": jnp.asarray(ctx)}, st)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out = [tok]
        for i in range(steps):
            logits, st = serve(jparams, tok, st, context + i)
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            out.append(tok)
        want = np.concatenate([np.asarray(t) for t in out], 1)
        assert np.array_equal(got.numpy(), want), (got, want)


def test_launcher_serves_hymba_on_cpu():
    from repro_torch.launch import serve as launch
    rep = launch.main(["--arch", "hymba-1.5b", "--scheduler", "legacy",
                       "--device", "cpu", "--batch", "2", "--context", "9",
                       "--decode-steps", "2", "--requests", "2"])
    assert len(rep["sequences"]) == 2 and rep["total_tokens"] == 12


# --------------------------------------------------------------- training
def test_hier_fl_rounds_match_reference(monkeypatch):
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, 512, (C, 2, 2, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(ROUNDS)]
    js = JSession("hymba-1.5b", strategy="hier_fl", mesh=(1,),
                  shape="64x2", topology=TOPO, codec="none", local_steps=2)
    _, (jp, jo) = js.build()
    state = bridge.fl_state_from_numpy(_np(jp), np.asarray(jo.step),
                                       _np(jo.m), _np(jo.v), "cpu")
    jout = js.run(ROUNDS, batches=batches,
                  hooks=JHooks(log_every=1, log_fn=lambda *a, **k: None))
    low = record_adam_denominators(monkeypatch)
    ts = Session("hymba-1.5b", strategy="hier_fl", shape="64x2",
                 topology=TOPO, local_steps=2, device="cpu", codec="none")
    tout = ts.run(ROUNDS, state=state,
                  batches=[bridge.tree_from_numpy(b, "cpu")
                           for b in batches],
                  hooks=LoopHooks(log_every=1, log_fn=lambda *a, **k: None))
    for jh, th in zip(jout["history"], tout["history"]):
        for k in ("comm_bytes_up", "comm_bytes_backhaul", "sim_round_s"):
            assert th[k] == jh[k], k
        np.testing.assert_allclose(th["per_client/loss"],
                                   jh["per_client/loss"], atol=LOSS_ATOL)
    _assert_close([g.detach().numpy() for g in leaves(ts.merged_params())],
                  jax.tree.leaves(js.merged_params()),
                  [x.numpy() for x in low], 2e-5, NEAR_EPS, NEAR_EPS_ATOL)


def _assert_close(got, want, low, atol, near_eps, near_atol):
    """The near-eps rule over leaf lists (numpy): every element within
    ``atol`` except near-eps ones (``low`` below ``near_eps``), held to
    ``near_atol``; the exempted elements at most 0.1% of them."""
    near = exempt = total = 0
    for g, w, lo in zip(got, want, low):
        d = np.abs(np.asarray(g) - np.asarray(w))
        flag = np.asarray(lo) < near_eps
        assert d.max() <= near_atol, d.max()
        assert not ((d > atol) & ~flag).any(), float(d[~flag].max())
        near += int(flag.sum())
        exempt += int(((d > atol) & flag).sum())
        total += d.size
    print(f"near-eps params: {near} of {total}, {exempt} beyond {atol}")
    assert exempt <= 1e-3 * total, (exempt, total)


def test_hybrid_fhdp_step_matches_reference(mesh24, reference_steps):
    """Two steps from the reference's states (the step after each) and the
    port's own second step, as ``test_torch_pipeline.py::compare_steps``
    runs them, params held by :func:`_assert_close`."""
    tmpl, batch, states, losses = run_reference(reference_steps,
                                                "hymba_1_5b", mesh24, 8)
    assert tmpl == {"blocks": (1, 1, 0, 0)}
    _, _, step, _ = port_step("hymba_1_5b", (2, 4), 8, tmpl)
    tb = torch_batch(batch)
    mine = None
    for i in range(2):
        pp, opt, m = step(*state_to_torch(states[i]), tb)
        assert abs(float(m["loss"]) - losses[i]) <= LOSS_RTOL * abs(
            losses[i]), (i, float(m["loss"]), losses[i])
        got_pp, got_opt = bridge.tree_to_numpy(pp), bridge.zero2_to_numpy(
            opt, 2)
        want_pp, want_opt = states[i + 1]
        assert_moments_close(got_opt, want_opt)
        dens = [np.minimum(a, b) for a, b in zip(
            denominators(want_pp, want_opt, True),
            denominators(got_pp, got_opt, True))]
        _assert_close(float_leaves(got_pp), float_leaves(want_pp), dens,
                      PARAM_ATOL, FHDP_NEAR_EPS, 2 * 1e-3)
        mine = mine or (pp, opt)
    _, _, m2 = step(*mine, tb)
    assert abs(float(m2["loss"]) - losses[1]) <= LOSS_RTOL * abs(losses[1])


def test_other_families_still_raise():
    cfg = reduced(get_config("hymba-1.5b")).replace(family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        pl.get_adapter(cfg)
    assert pl.get_adapter(reduced(get_config("hymba-1.5b"))).units(
        reduced(get_config("hymba-1.5b"))) == ("blocks", "blocks")
    # the paged engine serves the dense family only, as the reference's
    from repro_torch.serve import PagedCacheSpec, PagedEngine
    with pytest.raises(NotImplementedError, match="dense"):
        PagedEngine(reduced(get_config("hymba-1.5b")),
                    PagedCacheSpec.for_requests(1, 16, block_size=4),
                    max_context=8, slots=1, device="cpu")
