"""The four dense configs at head_dim 128 (qwen2.5-32b, qwen3-14b,
qwen3-32b, yi-34b) in the port against the reference on the CPU: their
registration and published fields, ``reduced()`` field for field (the
QKV bias and the qk-norm kept, as the reference's ``cfg.replace`` keeps
them), and at the reduced size in float32, fed the reference's own
parameters through the bridge:
  * ``Model.loss`` within 1e-5 and each gradient within 1e-4 of its
    leaf's largest;
  * the paged engine's logits (prefill chunks, then decode steps) within
    2e-4, with nonzero QKV biases and head norms: both sit between the
    projections and rope, where the reference puts them;
  * ``serve_continuous``'s greedy streams and accounting exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serve import PagedCacheSpec as JSpec, PagedEngine as JEngine
from repro.serve import serve_continuous as jax_serve
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models.registry import build_model
from repro_torch.serve import (BlockAllocator, PagedCacheSpec, PagedEngine,
                               serve_continuous)

ARCHS = ["qwen2_5_32b", "qwen3_14b", "qwen3_32b", "yi_34b"]
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_ATOL = 2e-4


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
def models():
    """{arch: (jcfg, cfg, reference params, bridged params)}, reduced."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(jax_get_config(arch))
        jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        out[arch] = (jcfg, reduced(get_config(arch)), jp,
                     bridge.tree_from_numpy(_np(jp), "cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_registration_and_reduced_match_reference(arch):
    assert arch in ARCH_IDS and arch in JAX_ARCH_IDS
    full, jfull = get_config(arch.replace("_", "-")), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.hd == 128 and full.family == "dense"
    assert dataclasses.asdict(reduced(full)) == dataclasses.asdict(
        jax_reduced(jfull))
    small = reduced(full)
    assert (small.qkv_bias, small.qk_norm) == (full.qkv_bias, full.qk_norm)
    assert small.rope_theta == full.rope_theta
    assert full.param_count() == jfull.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    jcfg, cfg, jparams, _ = models[arch]
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
             for k in ("tokens", "labels")}

    def jloss(p):
        return jax_build_model(jcfg).loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()})

    (want, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tree = bridge.tree_from_numpy(_np(jparams), "cpu")
    named = list(_leaves(tree))
    assert ("blocks/attn/bq" in dict(named)) == cfg.qkv_bias
    assert ("blocks/attn/q_norm" in dict(named)) == cfg.qk_norm
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = build_model(cfg).loss(
        tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in named])
    assert abs(float(loss.detach()) - float(want)) <= LOSS_ATOL
    jg = dict(_leaves(_np(jgrads)))
    for (name, _), g in zip(named, grads):
        w = jg[name]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_logits_match_reference(models, arch):
    """Nonzero QKV biases and head norms (the init leaves them at 0 and
    1), so that their order against rope shows: prefill chunks of two
    prompts, then three decode steps of both lanes."""
    jcfg, cfg, jp, _ = models[arch]
    rng = np.random.default_rng(2)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    attn = jp["blocks"]["attn"]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in attn:
            attn[name] = attn[name] + 0.3 * rng.standard_normal(
                attn[name].shape).astype(np.float32)
    tp = bridge.params_from_numpy(jp, "cpu", cfg=cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    bs, c, slots = 4, 8, 2
    jspec = JSpec.for_requests(slots, 40, block_size=bs)
    spec = PagedCacheSpec.for_requests(slots, 40, block_size=bs)
    jeng = JEngine(jcfg, jspec, max_context=16, slots=slots)
    teng = PagedEngine(cfg, spec, max_context=16, slots=slots, device="cpu")
    jpools, tpools = jeng.init_pools(), teng.init_pools()
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (13, 6)]
    alloc = BlockAllocator(spec)
    tables = np.zeros((slots, spec.max_blocks_per_req), np.int32)
    pend = np.zeros(slots, np.int32)
    for lane, p in enumerate(prompts):
        blocks = alloc.alloc(spec.blocks_needed(len(p) + 4))
        tables[lane, :len(blocks)] = blocks
        for pos in range(0, len(p), c):
            clen = min(c, len(p) - pos)
            buf = np.zeros(c, np.int32)
            buf[:clen] = p[pos:pos + clen]
            jl, jpools = jeng.prefill_chunk(jp, jpools, jnp.asarray(buf),
                                            jnp.asarray(tables[lane]), pos,
                                            clen)
            tl, tpools = teng.prefill_chunk(tp, tpools, buf, tables[lane],
                                            pos, clen)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL)
        pend[lane] = int(np.argmax(np.asarray(jl)[0]))
    ctx = np.array([len(p) for p in prompts], np.int32)
    for _ in range(3):
        jl, jpools = jeng.decode(jp, jpools, jnp.array(pend),
                                 jnp.array(tables), jnp.array(ctx))
        tl, tpools = teng.decode(tp, tpools, pend, tables, ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        pend = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        ctx = ctx + 1


@pytest.mark.parametrize("cache", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_tokens_match_reference(models, arch, cache):
    """The continuous scheduler over a fleet trace with chunked prefill:
    the greedy streams token for token, and the scheduler's accounting."""
    jcfg, cfg, jp, _ = models[arch]
    tp = bridge.params_from_numpy(_np(jp), "cpu", cfg=cfg)
    kw = dict(num_requests=4, slots=2, prefill="chunked", prefill_chunk=8,
              block_size=4, max_context=48, cache=cache, log_fn=None)
    want = jax_serve(jcfg, params=jp, **kw)
    got = serve_continuous(cfg, params=tp, device="cpu", **kw)
    assert got["sequences"] == want["sequences"]
    for key in ("requests", "total_new_tokens", "decode_steps",
                "prefill_chunks", "prefills"):
        assert got.get(key) == want.get(key), key
