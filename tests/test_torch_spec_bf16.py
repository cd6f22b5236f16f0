"""Speculative decoding in bfloat16 on the CPU, both packages: at the
size of ``tests/test_torch_spec.py`` (``reduced(flad_adllm)``, here with
bfloat16 params, 2 lanes, blocks of 4, chunks of 4, draft_k 3, its
trace), a self-drafted speculative stream equals plain greedy decode's
token for token, in the reference and in the port (its plain versions),
in both cache modes.

This settles where the card's bf16 gap comes from: on the H100 the
port's bf16 self-drafted streams match plain decode on only part of
their tokens (``chip_smoke.py``'s speculative phase reports it; float32
streams are gated bitwise there). Neither package diverges here, so the
gap belongs to the port's card path — its bf16 verify and decode run on
different kernels with different roundings — not to the reference's
algorithm.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.models import lm as jlm
from repro.serve import SpecDecodeCostModel as JSpecCost
from repro.serve import generate_pod_requests as jax_pod
from repro.serve import serve_continuous as jax_serve
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.serve import (PrefillCostModel, SpecDecodeCostModel,
                               generate_pod_requests, serve_continuous)
from test_torch_spec import COMMON, DRAFT_K, _spec_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_bf16_self_draft_streams_equal_plain_decode(cache):
    jcfg = jax_reduced(jax_get_config("flad_adllm")).replace(
        param_dtype="bfloat16")
    cfg = reduced(get_config("flad-adllm")).replace(param_dtype="bfloat16")
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu", cfg=cfg)
    kw = dict(COMMON, cache=cache)
    want = jax_serve(jcfg, params=jp, requests=_spec_trace(jax_pod, jcfg),
                     **kw)
    jspec = jax_serve(jcfg, params=jp, speculative=True, draft_k=DRAFT_K,
                      prefill_cost=JSpecCost(),
                      requests=_spec_trace(jax_pod, jcfg), **kw)
    assert jspec["spec_steps"] > 0 and jspec["acceptance_rate"] == 1.0
    assert jspec["sequences"] == want["sequences"]
    base = serve_continuous(cfg, params=tp, device="cpu",
                            requests=_spec_trace(generate_pod_requests, cfg),
                            prefill_cost=PrefillCostModel(), **kw)
    spec = serve_continuous(cfg, params=tp, device="cpu", speculative=True,
                            draft_k=DRAFT_K,
                            prefill_cost=SpecDecodeCostModel(),
                            requests=_spec_trace(generate_pod_requests, cfg),
                            **kw)
    assert spec["spec_steps"] > 0 and spec["acceptance_rate"] == 1.0
    assert spec["sequences"] == base["sequences"]
