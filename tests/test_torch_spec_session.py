"""The speculative slice's entry points on the CPU: the draft's teacher-
forced greedy agreement (``distill.federated.greedy_agreement``) against
the reference's, ``Session.serve(pod=, speculative=, draft_pod=)`` end to
end on a ``distill_fl`` session (streams bitwise the non-speculative
ones, float32), its argument checks as the reference's, and the serving
launcher's ``--speculative``/``--draft-k`` and its default scheduler,
``legacy`` as the reference's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.distill import federated as jfed
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.configs import get_config, reduced
from repro_torch.distill import federated
from repro_torch.launch import serve as launch

TOPO = "2@nano*2,agx*2"
QUIET = dict(log_every=1, log_fn=lambda *a, **k: None)
SERVE = dict(scheduler="continuous", requests=3, batch=2, context=12,
             block_size=4, max_prompt=6, short_new=(3, 4), long_new=(6, 8),
             log_fn=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def distilled():
    """A port ``distill_fl`` session after one round (two warmup steps)."""
    ses = Session("flad-adllm", strategy="distill_fl", shape="16x8",
                  codec="int8", device="cpu", topology=TOPO, local_steps=1,
                  lora_rank=4, warmup_steps=2)
    ses.run(1, hooks=LoopHooks(**QUIET))
    return ses


def test_greedy_agreement_matches_reference():
    """Full draft trees and a draft as base + LoRA factors (the fused
    kernel's plain version here, the Pallas kernel in interpret mode
    there), on the same numpy-seeded params and tokens."""
    jcfg = jax_reduced(jax_get_config("flad_adllm"))
    cfg = reduced(get_config("flad-adllm"))
    trees = [jax.tree_util.tree_map(np.asarray, jlm.init(
        jax.random.PRNGKey(s), jcfg)) for s in (0, 7)]
    ported = [bridge.params_from_numpy(t, "cpu", cfg=cfg) for t in trees]
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    L, d, r = cfg.num_layers, cfg.d_model, 4
    lora = {"blocks": {"attn": {"wq": {
        "A": (rng.standard_normal((L, d, r)) * d ** -0.5).astype(np.float32),
        "B": (rng.standard_normal((L, r, cfg.num_heads * cfg.hd))
              * 0.05).astype(np.float32)}}}}
    for draft, kw in ((1, {}), (0, {"draft_lora": lora}), (0, {})):
        want = jfed.greedy_agreement(
            trees[0], trees[draft], jcfg, toks,
            **{k: jax.tree_util.tree_map(jax.numpy.asarray, v)
               for k, v in kw.items()})
        got = federated.greedy_agreement(
            ported[0], ported[draft], cfg, toks,
            **{k: bridge.tree_from_numpy(v, "cpu") for k, v in kw.items()})
        # the same count of agreeing positions (the two means round the
        # float32 quotient differently)
        assert round(got * toks.size) == round(want * toks.size), \
            (draft, kw.keys())
        if draft == 0 and not kw:
            assert got == 1.0               # a model agrees with itself
        if draft == 1:
            assert got < 1.0


def test_session_serve_pod_and_draft_pod(distilled):
    """A pod's personalized model serves end to end; drafting with
    another pod's distilled student (or itself) keeps the streams bitwise
    the non-speculative ones, with the acceptance the report counts."""
    ses = distilled
    out = ses.serve(pod=1, **SERVE)
    assert out["requests"] == 3 and out["total_new_tokens"] > 0
    for draft_pod in (1, 0):
        spec = ses.serve(pod=1, speculative=True, draft_pod=draft_pod,
                         draft_k=2, **SERVE)
        assert spec["sequences"] == out["sequences"], draft_pod
        assert spec["spec_steps"] > 0 and spec["proposed_drafts"] > 0
        if draft_pod == 1:
            assert spec["acceptance_rate"] == 1.0
    # the global merge with a self-draft, as the reference's smoke test
    glob = ses.serve(**SERVE)
    assert ses.serve(speculative=True, draft_k=2, **SERVE)["sequences"] \
        == glob["sequences"]


def test_session_serve_argument_checks(distilled):
    ses = distilled
    with pytest.raises(ValueError, match="pod"):
        ses.serve(pod=0, params={}, log_fn=None)
    with pytest.raises(ValueError, match="speculative"):
        ses.serve(speculative=True, log_fn=None)    # legacy can't speculate
    with pytest.raises(ValueError, match="speculative"):
        ses.serve(scheduler="continuous", draft_pod=0, log_fn=None)
    with pytest.raises(ValueError, match="out of range"):
        ses.serve(pod=5, **SERVE)
    tensor = Session("flad-adllm", strategy="hier_fl",
                     device="cpu")                  # hier_fl: no pod view
    with pytest.raises(ValueError, match="per-pod"):
        tensor.serve(pod=0, **SERVE)
    with pytest.raises(ValueError, match="draft"):
        tensor.serve(speculative=True, draft_pod=0, **SERVE)
    with pytest.raises(RuntimeError, match="run"):
        Session("flad-adllm", strategy="distill_fl", device="cpu",
                topology=TOPO).serve(pod=0, **SERVE)


def test_launcher_defaults_to_the_legacy_scheduler():
    """The reference's launcher defaults to ``--scheduler legacy``; so
    does the port's, and ``--speculative`` asks for the continuous one."""
    args = launch.build_parser().parse_args([])
    assert args.scheduler == "legacy" and args.draft_k == 4
    assert not args.speculative
    rep = launch.main(["--device", "cpu", "--batch", "2", "--context", "8",
                       "--decode-steps", "2", "--requests", "1"])
    assert rep["total_tokens"] == 2 * 3 and "warm_tokens_per_s" in rep
    with pytest.raises(SystemExit, match="continuous"):
        launch.main(["--device", "cpu", "--speculative"])


def test_launcher_speculative_on_cpu():
    argv = ["--device", "cpu", "--scheduler", "continuous", "--requests",
            "3", "--slots", "2", "--block-size", "4", "--cache", "int8"]
    base = launch.main(argv)
    spec = launch.main(argv + ["--speculative", "--draft-k", "2"])
    assert spec["sequences"] == base["sequences"]
    assert spec["acceptance_rate"] == 1.0 and spec["spec_steps"] > 0
    assert spec["preemptions"] == 0
