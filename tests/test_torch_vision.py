"""flad-vision in the port against the reference on the CPU: the config and
its reduced variant, the encoder's forward and loss (atol 1e-5, the
reference's params bridged), non-causal self-attention and the decoder's
cross-attention, the ``tensor`` strategy's train step with
``grad_accum=2`` (flad-vision and flad-adllm; the reference's
``make_train_step``), and the reference's defaults: ``Session()`` and
the training launcher with no arguments run FHDP (``pipeline``) on
reduced flad-vision over a (2, 4) mesh with 16 sequences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as JShape
from repro.configs import get_config as jax_config
from repro.configs.common import input_specs as jax_input_specs
from repro.configs.common import reduced as jax_reduced
from repro.core.steps import make_train_step as jax_train_step
from repro.models import blocks as JB
from repro.models import build_model as jax_model
from repro.models import vision_encoder as jvision
from repro.train.optimizer import Adam as JAdam
from repro_torch import bridge
from repro_torch.api import Session, available_strategies
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.configs.common import concrete_batch, input_specs
from repro_torch.core.steps import make_train_step
from repro_torch.models import blocks as B
from repro_torch.models import vision_encoder
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import Adam
from repro_torch.tree import leaves
from test_torch_pipeline import np_tree, numpy_batch, torch_batch

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_and_reduced_match_reference():
    for full in (True, False):
        want = jax_config("flad_vision")
        got = get_config("flad-vision")
        if not full:
            want, got = jax_reduced(want), reduced(got)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "hd", "prefix_tokens",
                  "prefix_dim", "num_waypoints", "num_light_classes",
                  "param_dtype", "rope_theta", "norm_eps"):
            assert getattr(got, f) == getattr(want, f), f
    shape = ShapeConfig("t", 64, 3, "train")
    specs = input_specs(reduced(get_config("flad-vision")), shape)
    jspecs = jax_input_specs(jax_reduced(jax_config("flad_vision")),
                             JShape("t", 64, 3, "train"))
    assert {k: v[0] for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    b = concrete_batch(reduced(get_config("flad-vision")), shape,
                       torch.Generator().manual_seed(0))
    assert b["light"].dtype == torch.int32 and int(b["light"].max()) < 4
    assert b["rgb"].dtype == torch.float32


@pytest.mark.parametrize("layers", [2, 3])
def test_forward_and_loss_match_reference(layers):
    jcfg = jax_reduced(jax_config("flad_vision")).replace(num_layers=layers)
    cfg = reduced(get_config("flad-vision")).replace(num_layers=layers)
    jp = jax_model(jcfg).init(jax.random.PRNGKey(layers))
    batch = numpy_batch(cfg, 3, layers)
    want, (wloss, wmet) = jax.jit(lambda p, b: (
        jvision.forward(p, jcfg, b), jvision.loss_fn(p, jcfg, b)))(jp, batch)
    params = bridge.tree_from_numpy(np_tree(jp), "cpu")
    tb = torch_batch(batch)
    got = vision_encoder.forward(params, cfg, tb)
    loss, met = build_model(cfg).loss(params, tb)
    for k in ("waypoints", "light_logits", "features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    assert abs(float(loss) - float(wloss)) <= ATOL
    for k in ("l1", "ce", "acc"):
        assert abs(float(met[k]) - float(wmet[k])) <= ATOL, k


def test_attention_noncausal_and_cross_match_reference():
    jcfg = jax_reduced(jax_config("flad_vision"))
    cfg = reduced(get_config("flad-vision"))
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    for cross in (False, True):
        jp = JB.init_attention(key, jcfg, cross=cross)
        p = bridge.tree_from_numpy(np_tree(jp), "cpu")
        assert set(p) == set(B.init_attention(
            torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
            cross=cross))
        kw, tkw = {}, {}
        if cross:
            mem = rng.standard_normal((2, 2, 13, 32)).astype(np.float32)
            kw = dict(cross_kv=(mem, mem[:, :, ::-1]),
                      cross_pos=np.arange(13, dtype=np.int32))
            tkw = dict(cross_kv=tuple(torch.from_numpy(np.array(m))
                                      for m in kw["cross_kv"]),
                       cross_pos=torch.arange(13, dtype=torch.int32))
        want, _ = JB.attention(jp, x, jcfg, positions=pos, causal=False,
                               **kw)
        got, _ = B.attention(p, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos), causal=False,
                             **tkw)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


def test_vision_has_no_decode_path():
    model = build_model(reduced(get_config("flad-vision")))
    with pytest.raises(NotImplementedError, match="decode"):
        model.decode_step(None, None, None, 0)
    with pytest.raises(NotImplementedError, match="decode"):
        model.prefill(None, None, None)


@pytest.mark.parametrize("arch,bg", [("flad_vision", 4), ("flad_adllm", 4)])
def test_tensor_step_grad_accum_matches_reference(arch, bg):
    """The ``tensor`` strategy's step with grad_accum=2: float32 microbatch
    grads, each divided by 2, summed, one Adam update (with the global-norm
    clip); loss and metrics the microbatches' mean. Params within 2e-5,
    the near-eps ones within 2 * lr and at most 0.1% of them: as in
    ``tests/test_torch_fl.py`` (the same Adam, unscaled grads), those
    where sqrt(v_hat) is below 10 * eps in either package."""
    jcfg, cfg = jax_reduced(jax_config(arch)), reduced(get_config(arch))
    jp = jax_model(jcfg).init(jax.random.PRNGKey(7))
    batch = numpy_batch(cfg, bg, 8)
    shape = ShapeConfig("t", 32, bg, "train")
    jstep = jax.jit(jax_train_step(jcfg, JShape("t", 32, bg, "train"),
                                   JAdam(lr=1e-3), grad_accum=2))
    jopt = JAdam(lr=1e-3).init(jp)
    wp, wo, wm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    params = bridge.tree_from_numpy(np_tree(jp), "cpu")
    step = make_train_step(cfg, shape, Adam(lr=1e-3), grad_accum=2)
    gp, go, gm = step(params, Adam(lr=1e-3).init(params),
                      torch_batch(batch))
    assert set(gm) == set(wm)
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-5 * max(
            1.0, abs(float(wm[k]))), k
    near = total = 0
    for g, w, gv, wv in zip(leaves(gp), jax.tree.leaves(np_tree(wp)),
                            leaves(go.v), jax.tree.leaves(np_tree(wo.v))):
        den = np.sqrt(np.minimum(*[np.where(v > 0, v, np.inf) for v in (
            gv.numpy(), wv)]) / 0.05)
        d = np.abs(g.numpy() - w)
        flag = den < 1e-7
        assert d.max() <= 2e-3 and not ((d > 2e-5) & ~flag).any()
        near, total = near + int(flag.sum()), total + d.size
    assert near <= 1e-3 * total
    # equal microbatches: their mean loss is the whole batch's
    whole = make_train_step(cfg, shape, Adam(lr=1e-3))
    _, _, m1 = whole(params, Adam(lr=1e-3).init(params), torch_batch(batch))
    assert abs(float(m1["loss"]) - float(gm["loss"])) <= 1e-5 * abs(
        float(gm["loss"]))


def test_session_defaults_are_the_references():
    from repro.api import Session as JSession
    js, ts = JSession(), Session(device="cpu")
    assert ts.cfg.name == js.cfg.name == "flad-vision-smoke"
    assert ts.strategy.name == js.strategy.name == "pipeline"
    assert ts.mesh_spec.dims == js.mesh_spec.dims == (2, 4)
    assert ts.mesh_spec.axis_names == js.mesh_spec.axis_names
    assert ts.shape.global_batch == js.shape.global_batch == 16
    assert ts.strategy.loop == js.strategy.loop == "step"
    assert ts.mesh.shape == {"data": 2, "model": 4}
    assert "tensor" in available_strategies()


def test_default_session_trains_on_cpu():
    """``Session(device="cpu").run(2)``: FHDP on reduced flad-vision over a
    (2, 4) mesh, 16 sequences a step (2 columns of 8, microbatches of 2),
    its first loss pinned to the value this seed gives."""
    ses = Session(device="cpu")
    out = ses.run(2)
    h = ses.strategy.helpers
    assert (h["microbatches"], h["mb"], h["columns"]) == (4, 2, 2)
    assert h["templates"] == {"blocks": (1, 1, 0, 0)}
    assert out["history"][0]["step"] == 1
    assert out["history"][0]["loss"] == pytest.approx(2.164144, abs=1e-5)
    pp, opt = ses.state
    assert int(opt["step"]) == 2
    assert opt["m"]["stacks"]["blocks"]["ffn"]["wi"].shape[:2] == (4, 2)


def test_train_launcher_defaults_run_fhdp_on_cpu(capsys):
    from repro_torch.launch import train as launch
    args = launch.build_parser().parse_args([])
    assert (args.arch, args.strategy, args.mesh, args.devices) == \
        ("flad-vision", "pipeline", "2,4", 0)
    out = launch.main(["--device", "cpu", "--steps", "2"])
    assert "[train] done:" in capsys.readouterr().out
    assert out["history"][0]["loss"] == pytest.approx(2.164144, abs=1e-5)
    assert out["session"].strategy.name == "pipeline"
    assert out["session"].shape.global_batch == 16
    tensor = launch.main(["--device", "cpu", "--steps", "1", "--strategy",
                          "tensor"])
    # the same seed and batch: the flat model's loss
    assert tensor["history"][0]["loss"] == pytest.approx(2.164144, abs=1e-5)
    fedavg = launch.main(["--device", "cpu", "--steps", "1", "--strategy",
                          "fedavg", "--arch", "flad-adllm", "--shape",
                          "16x2", "--mesh", "2,2,1"])
    assert fedavg["session"].strategy.n_clients() == 4
    with pytest.raises(RuntimeError, match="need 8 devices"):
        launch.main(["--device", "cpu", "--steps", "1", "--devices", "2"])
