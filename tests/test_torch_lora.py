"""The port's fused LoRA matmul, the LoRA factor trees and the adapted
AD-LLM forward against the reference on the CPU.

The wrapper's plain version (``ref.lora_matmul_ref``, what a CPU tensor
runs) is held against the reference's Pallas kernel in interpret mode,
and its autograd (the closed-form backward, dx through the wrapper on
transposed views) against ``jax.vjp`` of ``ops.lora_matmul_ad``, on the
reference's own test shapes, ragged (100, 96, 132) included. Tolerance:
float32 outputs within 1e-5 of the largest magnitude (both sides sum
float32 products in different orders); bf16 outputs within one bf16 ulp
at the largest magnitude (each side rounds a float32 value once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.common import reduced as jax_reduced
from repro.distill import celladapt as jcelladapt
from repro.distill import federated as jfed
from repro.distill import lora as jlora
from repro.distill.celladapt import adllm_config as jax_adllm_config
from repro.distill.celladapt import init_adllm as jax_init_adllm
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.distill import celladapt, federated, lora
from repro_torch.distill.celladapt import adllm_config
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.tree import leaves

SHAPES = [(128, 256, 192, 8, 0.5), (64, 512, 64, 16, 2.0),
          (256, 128, 128, 4, 1.0), (100, 96, 132, 4, 1.0)]
F32_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(want: np.ndarray, dtype) -> float:
    """1e-5 of the largest magnitude (float32), one bf16 ulp there (bf16)."""
    peak = float(np.abs(want).max())
    if dtype == "float32":
        return F32_RTOL * peak
    return 2.0 ** (np.floor(np.log2(peak)) - 7)


def _operands(seed, dtype, *shapes):
    """Torch tensors of ``dtype`` and the same values as JAX arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if dtype == "bfloat16":
            t = t.to(torch.bfloat16)
            j = jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        else:
            j = jnp.asarray(t.numpy())
        out.append((t, j))
    return out


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r,scale", SHAPES)
def test_lora_matmul_matches_pallas(dtype, m, k, n, r, scale):
    (x, jx), (w, jw), (a, ja), (b, jb) = _operands(
        m + k, dtype, (m, k), (k, n), (k, r), (r, n))
    want = _np(jops.lora_matmul_ad(jx, jw, ja, jb, scale=scale, block_m=64,
                                   block_n=64, block_k=64, interpret=True))
    got = ops.lora_matmul(x, w, a, b, scale=scale)
    assert got.dtype == x.dtype and got.shape == (m, n)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _tol(want, dtype), (err, _tol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r,scale", [SHAPES[0], SHAPES[3]])
def test_lora_matmul_ad_grads_match_reference(dtype, m, k, n, r, scale):
    ops_ = _operands(7 * m + n, dtype, (m, k), (k, n), (k, r), (r, n),
                     (m, n))
    (g, jg) = ops_.pop()
    live = [t.detach().clone().requires_grad_() for t, _ in ops_]
    y = ops.lora_matmul_ad(*live, scale=scale)
    grads = torch.autograd.grad(y, live, g)
    _, vjp = jax.vjp(
        lambda *t: jops.lora_matmul_ad(*t, scale=scale, block_m=64,
                                       block_n=64, block_k=64,
                                       interpret=True),
        *(j for _, j in ops_))
    for name, got, want in zip(("dx", "dw", "da", "db"), grads, vjp(jg)):
        want = _np(want)
        assert got.dtype == live[0].dtype and got.shape == want.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= _tol(want, dtype), (name, err, _tol(want, dtype))


def test_lora_backward_forms_only_what_autograd_asks(monkeypatch):
    """dx goes through the wrapper (a kernel launch on the card) only
    when x needs a grad, and dw is never formed for a frozen w."""
    calls = []
    plain = ref.lora_matmul_ref
    monkeypatch.setattr(ref, "lora_matmul_ref",
                        lambda *t, **kw: calls.append(t) or plain(*t, **kw))
    rng = np.random.default_rng(3)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((6, 8), (8, 5)))
    a = torch.zeros((8, 2), requires_grad=True)
    b = torch.ones((2, 5), requires_grad=True)
    y = ops.lora_matmul_ad(x, w, a, b, scale=2.0)
    assert len(calls) == 1
    da, db = torch.autograd.grad(y.sum(), (a, b))
    assert len(calls) == 1                 # x needs no grad: no dx call
    xg = x.clone().requires_grad_()
    y = ops.lora_matmul_ad(xg, w, a, b, scale=2.0)
    dx, = torch.autograd.grad(y.sum(), (xg,))
    assert len(calls) == 3                 # forward + dx
    t = calls[-1]                          # dx on transposed views
    assert t[1].data_ptr() == w.data_ptr() and t[1].shape == (5, 8)
    torch.testing.assert_close(dx, torch.ones(6, 5) @ w.T + 2.0 * (
        torch.ones(6, 5) @ b.detach().T) @ a.detach().T)
    assert ops.launch_counts()["lora_matmul"] == 0


@pytest.mark.parametrize("bad", ["rank", "dtype", "x_layout", "w_layout",
                                 "shape"])
def test_lora_matmul_checks_its_inputs(bad):
    x, w = torch.zeros((4, 8)), torch.zeros((8, 6))
    a, b = torch.zeros((8, 2)), torch.zeros((2, 6))
    if bad == "rank":
        a, b = torch.zeros((8, 17)), torch.zeros((17, 6))
    elif bad == "dtype":
        w = w.to(torch.bfloat16)
    elif bad == "x_layout":
        x = torch.zeros((8, 4)).T
    elif bad == "w_layout":
        w = torch.zeros((16, 12))[::2, ::2]
    else:
        b = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        ops.lora_matmul(x, w, a, b)


# ------------------------------------------------------ factor trees, model
def _acfgs():
    jcfg = jax_adllm_config(jax_reduced(jax_config("flad_adllm")),
                            feature_dim=32, feature_tokens=8,
                            num_waypoints=6)
    tcfg = adllm_config(reduced(get_config("flad-adllm")), feature_dim=32,
                        feature_tokens=8, num_waypoints=6)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def adllm():
    """The reference's AD-LLM params and rank-4 factors with a random B
    (so the low-rank term matters), as JAX trees and as the port's."""
    jcfg, tcfg = _acfgs()
    jp = jax_init_adllm(jax.random.PRNGKey(0), jcfg)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    jf = jlora.init_lora(jax.random.PRNGKey(1), jp, lcfg)
    rng = np.random.default_rng(5)
    jf = jax.tree.map(
        lambda f: {"A": f["A"], "B": jnp.asarray(
            rng.standard_normal(f["B"].shape).astype(np.float32) * 0.05)},
        jf, is_leaf=lambda v: isinstance(v, dict) and "A" in v)
    tp = bridge.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tf = bridge.tree_from_numpy(jax.tree.map(np.asarray, jf), "cpu")
    return jcfg, tcfg, jp, jf, tp, tf, lcfg


def test_init_lora_and_merge_through_bridge(adllm):
    jcfg, tcfg, jp, jf, tp, tf, lcfg = adllm
    tcf = lora.LoRAConfig(rank=4, alpha=8.0)
    port = lora.init_lora(tp, tcf, seed=0)
    want = jlora.init_lora(jax.random.PRNGKey(0), jp, lcfg)
    # same adapted leaves, in the same flatten order, of the same shapes
    jl = jax.tree.leaves(want)
    assert [tuple(x.shape) for x in jl] == \
        [tuple(x.shape) for x in leaves(port)]
    assert len(jl) == 10 and lora.lora_param_count(port) == sum(
        x.size for x in jl)
    for f in (port["blocks"]["attn"]["wq"], port["blocks"]["ffn"]["wo"]):
        assert not f["B"].any()
        din = f["A"].shape[-2]
        assert abs(float(f["A"].std()) * din ** 0.5 - 1.0) < 0.1
    # the reference's structure back, None where nothing is adapted
    back = bridge.factors_to_reference(tf, jax.tree.map(np.asarray, jp))
    assert jax.tree.structure(back, is_leaf=lambda v: v is None) == \
        jax.tree.structure(jf, is_leaf=lambda v: v is None)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jf)):
        np.testing.assert_array_equal(x, np.asarray(y))
    # merged weights
    jm = jax.tree.leaves(jlora.merge_lora(jp, jf, lcfg))
    tm = leaves(lora.merge_lora(tp, tf, tcf))
    assert len(jm) == len(tm)
    for x, y in zip(jm, tm):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="match no parameter leaf"):
        lora.init_lora(tp, lora.LoRAConfig(targets=("nope",)))


def test_forward_with_prefix_and_lora_matches_reference(adllm):
    jcfg, tcfg, jp, jf, tp, tf, lcfg = adllm
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    feats = rng.standard_normal((2, 8, 32)).astype(np.float32)
    for factors in (None, "lora"):
        jl, _, _ = jlm.forward(jp, jcfg, jnp.asarray(tokens),
                               prefix_embeds=jnp.asarray(feats),
                               lora=None if factors is None else jf,
                               lora_scale=lcfg.scale)
        tl, _, _ = lm.forward(tp, tcfg, torch.from_numpy(tokens),
                              prefix_embeds=torch.from_numpy(feats),
                              lora=None if factors is None else tf,
                              lora_scale=lcfg.scale)
        want = np.asarray(jl)
        assert tl.shape == (2, 16, 512)
        err = np.abs(tl.numpy() - want).max()
        assert err <= F32_RTOL * np.abs(want).max(), (factors, err)
    # the waypoint head on the last hidden state, and its held-out L1
    jwp = jcelladapt.adllm_waypoints(jp, jcfg, jnp.asarray(feats),
                                     jnp.asarray(tokens))
    twp = celladapt.adllm_waypoints(tp, tcfg, torch.from_numpy(feats),
                                    torch.from_numpy(tokens))
    np.testing.assert_allclose(twp.detach().numpy(), np.asarray(jwp),
                               rtol=0, atol=F32_RTOL)
    data = {"features": feats, "tokens": tokens,
            "waypoints": rng.standard_normal((2, 6, 2)).astype(np.float32)}
    want = jfed.waypoint_eval(jp, jcfg, data, lora=jf,
                              lora_scale=lcfg.scale)
    got = federated.waypoint_eval(tp, tcfg, data, lora=tf,
                                  lora_scale=lcfg.scale)
    assert abs(got - want) <= F32_RTOL * abs(want)
    with pytest.raises(NotImplementedError, match="outside the block"):
        lm.forward(tp, tcfg, torch.from_numpy(tokens),
                   prefix_embeds=torch.from_numpy(feats),
                   lora=dict(tf, head={"w": tf["blocks"]["attn"]["wq"]}))
