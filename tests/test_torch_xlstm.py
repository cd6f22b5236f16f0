"""The port's xLSTM serving slice against the reference on the CPU, at
``reduced(xlstm_350m)`` in float32: ``xlstm.forward``'s logits, prefill
plus decode through the step functions (greedy streams equal), the
port's incremental decode against its full forward, the bridge over the
stacked parameter and state trees, and ``Session.serve`` / the launcher
with the legacy scheduler for both ported architectures.

Tolerances: logits within 2e-5 of the largest reference logit magnitude
(float32; the mLSTM's chunk sums, the sLSTM's steps and the matmuls run
in other orders); greedy streams exactly equal; the port's incremental
decode against a fresh prefill of the same prefix within 1e-4 of the
largest logit (the chunkwise prefill and the stepwise decode are two
algorithms for one recurrence).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as JShape
from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.core import steps as jsteps
from repro.models import build_model as jax_build_model
from repro.models import xlstm as jx
from repro_torch import bridge
from repro_torch.api import Session
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core import steps as tsteps
from repro_torch.kernels import ops
from repro_torch.models import xlstm as tx
from repro_torch.models.registry import build_model

RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """One reduced float32 xLSTM: the reference's params and the port's
    bridged copy."""
    jcfg = jax_reduced(jax_get_config("xlstm_350m"))
    cfg = reduced(get_config("xlstm-350m"))
    jparams = jx.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, bridge.tree_from_numpy(tree, "cpu")


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    tol = rtol * max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_reduced_config_matches_reference(setup):
    jcfg, cfg, _, _ = setup
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "vocab_size", "param_dtype"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.ssm.slstm_every == jcfg.ssm.slstm_every == 2
    assert cfg.ssm.expand == jcfg.ssm.expand
    assert cfg.ssm.conv_kernel == jcfg.ssm.conv_kernel


@pytest.mark.parametrize("s", [16, 29])
def test_forward_matches_reference(setup, s):
    jcfg, cfg, jparams, tp = setup
    toks = _tokens(1, 2, s, cfg.vocab_size)
    want, jst, _ = jx.forward(jparams, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, tst, _ = tx.forward(tp, cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want, RTOL, "logits")
    for name, g in _leaves(tst):
        w = dict(_leaves(jst))[name]
        _close(g.numpy(), w, RTOL, f"state {name}")


def test_prefill_and_decode_match_reference(setup):
    """Prefill 12 tokens, then 6 greedy decode steps through each
    package's step functions on the same numpy prompts."""
    jcfg, cfg, jparams, tp = setup
    batch, context, steps = 2, 12, 6
    jshape = JShape("serve", context + steps, batch, "decode")
    shape = ShapeConfig("serve", context + steps, batch, "decode")
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, jshape))
    jdec = jax.jit(jsteps.make_serve_step(jcfg, jshape))
    tpre = tsteps.make_prefill_step(cfg, shape)
    tdec = tsteps.make_serve_step(cfg, shape)
    ctx = _tokens(2, batch, context, cfg.vocab_size)
    jl, jst = jpre(jparams, {"tokens": jnp.asarray(ctx)},
                   jmodel.init_state(batch, shape.seq_len))
    n0 = ops.mlstm_chunked.launches
    with torch.no_grad():
        tl, tst = tpre(tp, {"tokens": torch.from_numpy(ctx)},
                       model.init_state(batch, shape.seq_len, "cpu"))
        _close(tl.numpy(), jl, RTOL, "prefill logits")
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1).to(torch.int32)
        for i in range(steps):
            assert np.array_equal(np.asarray(jtok), ttok.numpy()), i
            jl, jst = jdec(jparams, jtok, jst, context + i)
            tl, tst = tdec(tp, ttok, tst, context + i)
            _close(tl.numpy(), jl, RTOL, f"decode step {i} logits")
            jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
            ttok = tl[:, -1:].argmax(dim=-1).to(torch.int32)
    assert ops.mlstm_chunked.launches == n0     # CPU: the plain version


def test_incremental_decode_matches_forward(setup):
    """Prefill + single-token steps reproduce a fresh prefill of each
    longer prefix (the port's own consistency, as the reference's
    ``test_incremental_decode_matches_forward``)."""
    _, cfg, _, tp = setup
    batch, context, steps = 2, 8, 4
    shape = ShapeConfig("serve", context + steps, batch, "decode")
    model = build_model(cfg)
    toks = torch.from_numpy(_tokens(3, batch, context + steps,
                                    cfg.vocab_size))
    with torch.no_grad():
        logits, state = model.prefill(
            tp, {"tokens": toks[:, :context]},
            model.init_state(batch, shape.seq_len, "cpu"))
        inc = [logits[:, -1]]
        for i in range(steps - 1):
            logits, state = model.decode_step(
                tp, toks[:, context + i:context + i + 1], state, context + i)
            inc.append(logits[:, -1])
        for i, got in enumerate(inc):
            full, _ = model.prefill(
                tp, {"tokens": toks[:, :context + i]},
                model.init_state(batch, shape.seq_len, "cpu"))
            _close(got.numpy(), full[:, -1].numpy(), 1e-4, f"step {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_stacked_trees(dtype):
    """Params and decode states cross both ways bitwise, each leaf keeping
    its dtype (float32 gates and sLSTM weights beside model-dtype ones),
    and the port's own init builds the reference's tree."""
    jcfg = jax_reduced(jax_get_config("xlstm_350m")).replace(
        param_dtype=dtype)
    cfg = reduced(get_config("xlstm-350m")).replace(param_dtype=dtype)
    trees = {"params": jx.init(jax.random.PRNGKey(4), jcfg),
             "state": jx.init_state(jcfg, 2)}
    ported = {"params": tx.init(cfg, device="cpu").to_dict(),
              "state": tx.init_state(cfg, 2, "cpu")}
    for kind, jtree in trees.items():
        tree = jax.tree_util.tree_map(np.asarray, jtree)
        tt = bridge.tree_from_numpy(tree, "cpu")
        back = dict(_leaves(bridge.tree_to_numpy(tt)))
        mine = dict(_leaves(ported[kind]))
        assert set(mine) == set(back), kind
        for name, want in _leaves(tree):
            got = back[name]
            if want.dtype.name == "bfloat16":
                assert got.dtype == np.uint16, name
                got = got.view(ml_dtypes.bfloat16)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
                name
            assert str(mine[name].dtype).split(".")[-1] == want.dtype.name, \
                name
            assert tuple(mine[name].shape) == want.shape, name
    dtypes = {n: t.dtype for n, t in _leaves(ported["params"])}
    assert dtypes["mlstm/w_if"] == dtypes["slstm/r"] == torch.float32
    assert dtypes["mlstm/wq"] == getattr(torch, dtype)


@pytest.mark.parametrize("arch", ["xlstm-350m", "flad-adllm"])
def test_session_serves_with_the_legacy_scheduler(arch):
    rep = Session(arch, device="cpu", seed=3).serve(
        scheduler="legacy", batch=2, context=10, decode_steps=3, requests=2,
        log_fn=None)
    assert rep["device"] == "cpu" and rep["total_tokens"] == 2 * 2 * 4
    cfg = reduced(get_config(arch))
    for seqs in rep["sequences"]:
        assert tuple(seqs.shape) == (2, 4) and seqs.dtype == torch.int32
        assert int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size
    assert bool(torch.isfinite(rep["last_logits"]).all())
    again = Session(arch, device="cpu", seed=3).serve(
        scheduler="legacy", batch=2, context=10, decode_steps=3, requests=2,
        log_fn=None)
    assert all(torch.equal(a, b) for a, b in zip(rep["sequences"],
                                                 again["sequences"]))


@pytest.mark.parametrize("arch", ["xlstm-350m", "flad-adllm"])
def test_launcher_serves_legacy_on_cpu(arch):
    from repro_torch.launch import serve as launch
    rep = launch.main(["--arch", arch, "--scheduler", "legacy", "--device",
                       "cpu", "--batch", "2", "--context", "9",
                       "--decode-steps", "2", "--requests", "2"])
    assert len(rep["sequences"]) == 2 and rep["total_tokens"] == 12


def test_later_parts_of_serving_raise():
    session = Session("xlstm-350m", strategy="hier_fl", device="cpu")
    # tracing is ported; the legacy loop has no sim clock, so it refuses
    # a trace as the reference's does
    with pytest.raises(ValueError, match="continuous"):
        session.serve(trace="t.json")
    # per-pod and speculative serving are ported; here they refuse as the
    # reference's do: hier_fl has no pod view, legacy cannot speculate
    for kw, match in ((dict(pod=0), "per-pod"),
                      (dict(speculative=True), "speculative")):
        with pytest.raises(ValueError, match=match):
            session.serve(**kw)
    # the paged engine serves the dense family only, as the reference's
    with pytest.raises(NotImplementedError, match="dense"):
        session.serve(scheduler="continuous", log_fn=None)
