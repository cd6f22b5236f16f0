"""The port's encoder-decoder family (``repro_torch.models.encdec``, its
registry builder, the ``frames`` branch of legacy serving and the encdec
FHDP adapter) against the reference on the CPU, at
``reduced(seamless_m4t_large_v2)`` in float32 (one encoder and one
decoder layer) and at a 2 + 2-layer variant of it, which a stacking or
order mistake cannot pass, fed the reference's own parameters through
the bridge and the same numpy frames and tokens.

Tolerances (float32; the reference at "highest" matmul precision, its
flash attention in Pallas interpret mode, the port's the kernels' plain
version):
  * the encoder memory and the cross K/V within 1e-5;
  * logits within 2e-4, as the dense and Hymba serving tests hold them;
  * the loss within 1e-5, each gradient within 1e-4 of its leaf's
    largest;
  * greedy tokens exactly;
  * two ``hier_fl`` rounds: the wire metrics equal, the per-client losses
    within 1e-5, the global params within 2e-5 except where Adam's eps
    amplifies a grad (the near-eps rule of ROADMAP queue C, as
    ``test_torch_hymba.py`` applies it: held to 1e-4, the elements it
    exempts at most 0.1% of the params);
  * the FHDP step as ``test_torch_pipeline.py`` holds the dense one
    (loss relative 1e-5, Adam moments), its params under the same rule
    (near-eps below 100 x Adam's eps); the FHDP loss against the flat
    ``Model.loss`` on the same params within 1e-5 (relative). The
    reference's adapter runs the flat model's order (every encoder unit,
    then every decoder unit), so the port's step is held to its step
    directly.
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
from repro.core import pipeline as jpl
from repro.core import steps as jsteps
from repro.models import build_model as jax_build_model
from repro.models import encdec as JE
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.api.mesh import MeshSpec
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.configs.common import ENC_MEMORY_DECODE, input_specs
from repro_torch.core import pipeline as pl
from repro_torch.models import encdec
from repro_torch.models.registry import abstract_params, build_model
from repro_torch.tree import leaves
from test_torch_fl import NEAR_EPS, NEAR_EPS_ATOL, record_adam_denominators
from test_torch_hymba import _assert_close
from test_torch_pipeline import NEAR_EPS as FHDP_NEAR_EPS
from test_torch_pipeline import (LOSS_RTOL, PARAM_ATOL, SEQ,  # noqa: F401
                                 assert_moments_close, denominators,
                                 float_leaves, np_tree, reference_steps,
                                 state_to_torch, torch_batch)

ARCH = "seamless-m4t-large-v2"
MEM_ATOL = 1e-5
LOGIT_ATOL = 2e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
FLAT_RTOL = 1e-5
LR = 1e-3
TOPO = "2@nano*2,agx*2"
C, ROUNDS = 4, 2
#: (encoder layers, decoder layers) of each variant: the reduced config's
#: and the 2 + 2-layer one
VARIANTS = {"1+1": (1, 1), "2+2": (2, 2)}


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


def configs(variant="1+1"):
    """(reference cfg, port cfg) of a variant of the reduced config."""
    e, d = VARIANTS[variant]
    kw = dict(enc_layers=e, dec_layers=d, num_layers=e + d)
    return (jax_reduced(jax_get_config("seamless_m4t_large_v2")).replace(**kw),
            reduced(get_config(ARCH)).replace(**kw))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def setup(request):
    jcfg, cfg = configs(request.param)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, bridge.tree_from_numpy(_np(jparams), "cpu")


def numpy_inputs(cfg, b, s_enc, s_dec, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s_enc, cfg.prefix_dim)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32))


# ------------------------------------------------------------ config, tree
def test_config_and_params_match_reference():
    want, got = jax_get_config("seamless_m4t_large_v2"), get_config(ARCH)
    for name in ("name", "family", "num_layers", "enc_layers", "dec_layers",
                 "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                 "vocab_size", "rope_theta", "prefix_dim", "param_dtype",
                 "norm_eps", "qkv_bias", "qk_norm", "tie_embeddings",
                 "window"):
        assert getattr(got, name) == getattr(want, name), name
    jcfg, cfg = configs()
    for name in ("enc_layers", "dec_layers", "num_kv_heads", "prefix_dim",
                 "d_model", "vocab_size", "param_dtype"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.enc_layers, cfg.dec_layers, cfg.num_kv_heads,
            cfg.prefix_dim) == (1, 1, 4, 64)
    assert ENC_MEMORY_DECODE == 4096
    for c, jc in ((cfg, jcfg), (get_config(ARCH), want)):
        wtree = dict(_leaves(jax.eval_shape(jax_build_model(jc).init,
                                            jax.random.PRNGKey(0))))
        gtree = dict(_leaves(abstract_params(c)))
        assert sorted(gtree) == sorted(wtree)
        for name, w in wtree.items():
            assert tuple(gtree[name].shape) == w.shape, name
            assert str(gtree[name].dtype).endswith(str(w.dtype)), name
    n = sum(x.numel() for x in leaves(abstract_params(get_config(ARCH))))
    assert n == 1_280_796_672
    # the input specs: half the sequence of frames, half of tokens
    specs = input_specs(cfg, ShapeConfig("t", 32, 2, "train"))
    assert specs == {"frames": ((2, 16, 64), torch.float32),
                     "tokens": ((2, 16), torch.int32),
                     "labels": ((2, 16), torch.int32)}
    assert input_specs(cfg, ShapeConfig("d", 32, 2, "decode")) == {
        "tokens": ((2, 1), torch.int32)}


def test_bridge_round_trips_bitwise():
    """The reference's params (float32, and bfloat16 as its raw words)
    cross into the port and back bit for bit."""
    jcfg, cfg = configs("2+2")
    for dt in ("float32", "bfloat16"):
        jp = _np(jax_build_model(jcfg.replace(param_dtype=dt)).init(
            jax.random.PRNGKey(5)))
        back = bridge.tree_to_numpy(bridge.tree_from_numpy(jp, "cpu"))
        for (name, w), (_, g) in zip(_leaves(jp), _leaves(back)):
            assert np.array_equal(np.asarray(w).view(g.dtype), g), name
        if dt == "bfloat16":
            tree = bridge.tree_from_numpy(jp, "cpu")
            assert tree["dec_blocks"]["xattn"]["wq"].dtype == torch.bfloat16


# ------------------------------------------------------------------ model
def test_encode_cross_kv_and_decode_match_reference(setup):
    """encode, make_cross_kv, decode without a cache, and decode over a
    cache (a 9-token prompt, then three one-token steps), at an encoder
    length that differs from the decoder's."""
    jcfg, cfg, jparams, tp = setup
    frames, toks, _ = numpy_inputs(cfg, 2, 24, 12, 1)
    jmem = JE.encode(jparams, jcfg, jnp.asarray(frames))
    mem = encdec.encode(tp, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(mem.detach().numpy(), np.asarray(jmem),
                               atol=MEM_ATOL)
    jcross = JE.make_cross_kv(jparams, jcfg, jmem)
    cross = encdec.make_cross_kv(tp, cfg, mem)
    for g, w in zip(cross, jcross):
        assert tuple(g.shape) == (cfg.dec_layers, 2, cfg.num_kv_heads, 24,
                                  cfg.hd)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=MEM_ATOL)
    want, _ = JE.decode(jparams, jcfg, jnp.asarray(toks), jcross)
    got, _ = encdec.decode(tp, cfg, torch.from_numpy(toks), cross)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    with torch.no_grad():
        jc = JE.init_cache(jcfg, 2, 16)
        tc = encdec.init_cache(cfg, 2, 16, "cpu")
        cross = tuple(x.detach() for x in cross)
        jl, jc = JE.decode(jparams, jcfg, jnp.asarray(toks[:, :9]), jcross,
                           caches=jc)
        tl, tc = encdec.decode(tp, cfg, torch.from_numpy(toks[:, :9]),
                               cross, caches=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for pos in range(9, 12):
            p = np.full((1,), pos, np.int32)
            jl, jc = JE.decode(jparams, jcfg, jnp.asarray(toks[:, pos:pos + 1]),
                               jcross, positions=jnp.asarray(p), caches=jc)
            tl, tc = encdec.decode(tp, cfg,
                                   torch.from_numpy(toks[:, pos:pos + 1]),
                                   cross, positions=torch.from_numpy(p),
                                   caches=tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL)
            np.testing.assert_allclose(tl[:, 0].numpy(),
                                       np.asarray(want)[:, pos],
                                       atol=LOGIT_ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=MEM_ATOL, err_msg=k)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(setup, remat):
    jcfg, cfg, jparams, _ = setup
    frames, toks, labels = numpy_inputs(cfg, 2, 40, 32, 4)
    batch = {"frames": frames, "tokens": toks, "labels": labels}

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


def test_prefill_and_decode_step_match_reference(setup):
    """Model.prefill (its state's zero cross K/V replaced by the
    encoder's) and three decode steps against the reference's, and
    against the cache-free decode at the same positions; a decode step
    without a prefill runs over the zero cross K/V in both packages."""
    jcfg, cfg, jparams, tp = setup
    frames, toks, _ = numpy_inputs(cfg, 2, 20, 12, 2)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jmem = JE.encode(jparams, jcfg, jnp.asarray(frames))
    flat, _ = JE.decode(jparams, jcfg, jnp.asarray(toks),
                        JE.make_cross_kv(jparams, jcfg, jmem))
    with torch.no_grad():
        jst, tst = jm.init_state(2, 16), tm.init_state(2, 16, "cpu")
        ck, cv = tst["cross_kv"]
        assert tuple(ck.shape) == (cfg.dec_layers, 2, cfg.num_kv_heads,
                                   ENC_MEMORY_DECODE, cfg.hd)
        assert not ck.any() and ck is cv
        tok = toks[:, :1]
        jl, _ = jm.decode_step(jparams, jnp.asarray(tok), jst, 0)
        tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tst, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        jst, tst = jm.init_state(2, 16), tm.init_state(2, 16, "cpu")
        req = {"frames": frames, "tokens": toks[:, :9]}
        jl, jst = jm.prefill(jparams, {k: jnp.asarray(v)
                                       for k, v in req.items()}, jst)
        tl, tst = tm.prefill(tp, {k: torch.from_numpy(v)
                                  for k, v in req.items()}, tst)
        assert tuple(tst["cross_kv"][0].shape)[3] == 20
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(flat)[:, 8],
                                   atol=LOGIT_ATOL)
        for pos in range(9, 12):
            tok = toks[:, pos:pos + 1]
            jl, jst = jm.decode_step(jparams, jnp.asarray(tok), jst, pos)
            tl, tst = tm.decode_step(tp, torch.from_numpy(tok), tst, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL)
            np.testing.assert_allclose(tl[:, 0].numpy(),
                                       np.asarray(flat)[:, pos],
                                       atol=LOGIT_ATOL)


# ---------------------------------------------------------------- serving
def test_legacy_session_serve_tokens_match_reference(setup):
    """``Session.serve(scheduler="legacy")``'s greedy streams against the
    reference's prefill and serve steps on the same frames and prompts
    (the port draws the prompt's tokens, then its frames, from a
    torch.Generator seeded with the session's seed)."""
    jcfg, cfg, jparams, tp = setup
    batch, context, steps, seed = 2, 10, 4, 3
    rep = Session(cfg=cfg, device="cpu", seed=seed).serve(
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
        frames = torch.randn((batch, context, cfg.prefix_dim),
                             generator=gen).numpy()
        st = jm.init_state(batch, context + steps)
        logits, st = prefill(jparams, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(ctx)}, st)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out = [tok]
        for i in range(steps):
            logits, st = serve(jparams, tok, st, context + i)
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            out.append(tok)
        want = np.concatenate([np.asarray(t) for t in out], 1)
        assert np.array_equal(got.numpy(), want), (got, want)


def test_launchers_serve_and_train_encdec_on_cpu():
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    rep = launch_serve.main(["--arch", ARCH, "--scheduler", "legacy",
                             "--device", "cpu", "--batch", "2", "--context",
                             "9", "--decode-steps", "2", "--requests", "2"])
    assert len(rep["sequences"]) == 2 and rep["total_tokens"] == 12
    for strategy in ("tensor", "pipeline"):
        out = launch_train.main(["--arch", ARCH, "--device", "cpu",
                                 "--strategy", strategy, "--shape", "32x8",
                                 "--steps", "2"])
        last = out["history"][-1]
        assert last["step"] == 1 and np.isfinite(last["loss"]), strategy


def test_continuous_scheduler_stays_dense_only():
    """The paged engine serves the dense family only, as the reference's
    (``repro/serve/engine.py``)."""
    from repro_torch.serve import PagedCacheSpec, PagedEngine
    with pytest.raises(NotImplementedError, match="dense"):
        PagedEngine(reduced(get_config(ARCH)),
                    PagedCacheSpec.for_requests(1, 16, block_size=4),
                    max_context=8, slots=1, device="cpu")


# --------------------------------------------------------------- training
def test_hier_fl_rounds_match_reference(monkeypatch):
    rng = np.random.default_rng(7)
    batches = [{"frames": rng.standard_normal((C, 2, 2, 32, 64))
                .astype(np.float32),
                **{k: rng.integers(0, 512, (C, 2, 2, 32)).astype(np.int32)
                   for k in ("tokens", "labels")}} for _ in range(ROUNDS)]
    js = JSession("seamless_m4t_large_v2", strategy="hier_fl", mesh=(1,),
                  shape="64x2", topology=TOPO, codec="none", local_steps=2)
    _, (jp, jo) = js.build()
    state = bridge.fl_state_from_numpy(_np(jp), np.asarray(jo.step),
                                       _np(jo.m), _np(jo.v), "cpu")
    jout = js.run(ROUNDS, batches=batches,
                  hooks=JHooks(log_every=1, log_fn=lambda *a, **k: None))
    low = record_adam_denominators(monkeypatch)
    ts = Session(ARCH, strategy="hier_fl", shape="64x2", topology=TOPO,
                 local_steps=2, device="cpu", codec="none")
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


# ------------------------------------------------------------------- FHDP
def _fhdp_batch(cfg, bg, seed):
    frames, toks, labels = numpy_inputs(cfg, bg, SEQ // 2, SEQ // 2, seed)
    return {"frames": frames, "tokens": toks, "labels": labels}


def test_fhdp_adapter_units_and_merge(setup):
    """The unit sequence (every encoder unit, then every decoder unit),
    the reference's stage container bitwise, and the merge back into the
    flat tree's ``enc_blocks``/``dec_blocks``."""
    jcfg, cfg, jparams, tp = setup
    adapter = pl.get_adapter(cfg)
    e, d = cfg.enc_layers, cfg.dec_layers
    assert adapter.units(cfg) == ("enc",) * e + ("dec",) * d
    tmpl = pl.make_templates(cfg, 4)
    assert tmpl == jpl.make_templates(jcfg, 4)
    pp = pl.stage_params_from(tp, cfg, tmpl)
    want = np_tree(jpl.stage_params_from(jparams, jcfg, tmpl))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(bridge.tree_to_numpy(pp))):
        assert np.array_equal(g, w), path
    merged = pl.merge_stage_params(pp, tmpl)
    assert sorted(merged) == sorted(tp)
    for a, b in zip(leaves(merged), leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant,template", [
    ("1+1", None),
    ("2+2", {"enc": (1, 1, 0, 0), "dec": (0, 1, 1, 0)})])
def test_fhdp_step_matches_reference(variant, template, mesh24,
                                     reference_steps):
    """Two steps from the reference's states (the step after each) and the
    port's own second step, as ``test_torch_hymba.py`` holds the hybrid
    one; the mixed template puts encoder unit 1 and decoder unit 0 on
    stage 1. The first loss also equals the flat Model.loss."""
    jcfg, cfg = configs(variant)
    bg = 8
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    batch = _fhdp_batch(cfg, bg, 1)
    jstep, h = reference_steps(jcfg, mesh24, bg, learning_rate=LR,
                               templates=template)
    tmpl = h["templates"]
    if template is None:
        assert tmpl == {"enc": (1, 0, 0, 0), "dec": (0, 1, 0, 0)}
    pp = jpl.stage_params_from(jparams, jcfg, tmpl)
    opt = jpl.zero2_init(pp, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    states, losses = [(np_tree(pp), np_tree(opt))], []
    for _ in range(2):
        pp, opt, m = jstep(pp, opt, jb)
        states.append((np_tree(pp), np_tree(opt)))
        losses.append(float(m["loss"]))
    step, _ = pl.make_fhdp_train_step(
        cfg, ShapeConfig("t", SEQ, bg, "train"),
        MeshSpec((2, 4)).build("cpu"), learning_rate=LR, templates=tmpl)
    tb = torch_batch(batch)
    flat = float(build_model(cfg).loss(
        bridge.tree_from_numpy(_np(jparams), "cpu"), tb)[0].detach())
    assert abs(losses[0] - flat) <= FLAT_RTOL * abs(flat), (losses[0], flat)
    mine = None
    for i in range(2):
        tpp, topt, m = step(*state_to_torch(states[i]), tb)
        assert abs(float(m["loss"]) - losses[i]) <= LOSS_RTOL * abs(
            losses[i]), (i, float(m["loss"]), losses[i])
        got_pp, got_opt = bridge.tree_to_numpy(tpp), bridge.zero2_to_numpy(
            topt, 2)
        want_pp, want_opt = states[i + 1]
        assert_moments_close(got_opt, want_opt)
        dens = [np.minimum(a, b) for a, b in zip(
            denominators(want_pp, want_opt, True),
            denominators(got_pp, got_opt, True))]
        _assert_close(float_leaves(got_pp), float_leaves(want_pp), dens,
                      PARAM_ATOL, FHDP_NEAR_EPS, 2 * LR)
        mine = mine or (tpp, topt)
    _, _, m2 = step(*mine, tb)
    assert abs(float(m2["loss"]) - losses[1]) <= LOSS_RTOL * abs(losses[1])
