"""A two-round ``hier_fl`` run with the int8 codec through the port's
``Session.run`` against the reference's, at ``reduced(flad_adllm)`` in
float32, from the reference Session's own initial state, on the same
batches and with the reference's own codec bits (``jax.random.bits``
along its key chain: per round, per leaf, per client).

What is held:
  * round 1's int8 codes: at least 99.9% equal. Each package quantizes
    its own local-training deltas, and a last-bit difference in a delta
    can flip a stochastic rounding;
  * the global params after two rounds: every element within two
    quantization steps (2 * the row's scale, the largest over rounds and
    clients), except the elements where Adam's eps amplifies a grad
    (some update met a nonzero sqrt(v_hat) below 10 * eps), which are
    held to 1e-4 (a tenth of the learning rate) and may be at most 0.1%
    of the params; see test_torch_fl.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LoopHooks as JHooks, Session as JSession
from repro.config import ShapeConfig as JShape
from repro.core.fedavg import make_local_train as jax_local_train
from repro.core.steps import make_train_step as jax_train_step
from repro.train.optimizer import Adam as JAdam, AdamState as JAdamState
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.kernels import ops
from repro_torch.tree import leaves
from test_torch_fl import assert_params_close, record_adam_denominators

TOPO = "2@nano*2,agx*2"
C, ROUNDS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_hier_fl_int8_matches_reference(monkeypatch):
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, 512, (C, 2, 2, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(ROUNDS)]
    js = JSession("flad-adllm", strategy="hier_fl", mesh=(1,),
                  shape="64x2", topology=TOPO, codec="int8", local_steps=2)
    _, (jp, jo) = js.build()
    sizes = [int(np.prod(x.shape[1:])) for x in jax.tree.leaves(jp)]

    # the reference's codec bits: round keys split from the strategy's
    # stream, then one key per leaf, then one per client
    key, bits = js.strategy._key, {}
    for r in range(ROUNDS):
        key, sub = jax.random.split(key)
        for i, lk in enumerate(jax.random.split(sub, len(sizes))):
            for c, kk in enumerate(jax.random.split(lk, C)):
                words = np.asarray(jax.random.bits(
                    kk, (-(-sizes[i] // ops.LANES), ops.LANES), jnp.uint32))
                bits[r, i, c] = torch.from_numpy(
                    words.view(np.int32).copy()).view(torch.uint32)

    def codec_bits(r, leaf, client, shape):
        assert tuple(shape) == tuple(bits[r, leaf, client].shape)
        return bits[r, leaf, client]

    # round 1's deltas on the reference side, client by client
    jstep = jax_train_step(js.cfg, JShape("cli", 64, 2, "train"),
                           JAdam(lr=1e-3), remat=False)
    jlocal = jax.jit(jax_local_train(jstep))
    jdeltas = []
    for c in range(C):
        client = lambda t: jax.tree.map(lambda x: x[c], t)  # noqa: E731
        after, _, _ = jlocal(client(jp),
                             JAdamState(jo.step[c], client(jo.m),
                                        client(jo.v)),
                             client(batches[0]))
        jdeltas.append([np.asarray(a, np.float32) - np.asarray(g[0])
                        for a, g in zip(jax.tree.leaves(after),
                                        jax.tree.leaves(jp))])

    state = bridge.fl_state_from_numpy(_np(jp), np.asarray(jo.step),
                                       _np(jo.m), _np(jo.v), "cpu")
    js.run(ROUNDS, batches=batches,
           hooks=JHooks(log_every=1, log_fn=lambda *a, **k: None))

    calls = []
    quantize = ops.quantize_int8

    def recording(x, b):
        q, s = quantize(x, b)
        calls.append((x.clone(), b, q, s))
        return q, s

    monkeypatch.setattr(ops, "quantize_int8", recording)
    low = record_adam_denominators(monkeypatch)
    ts = Session("flad-adllm", strategy="hier_fl", shape="64x2",
                 topology=TOPO, codec="int8", local_steps=2, device="cpu",
                 codec_bits=codec_bits)
    ts.run(ROUNDS, state=state,
           batches=[bridge.tree_from_numpy(b, "cpu") for b in batches],
           hooks=LoopHooks(log_every=1, log_fn=lambda *a, **k: None))
    monkeypatch.undo()
    n = len(sizes)
    assert len(calls) == ROUNDS * n * C

    # round 1's codes: the port's own against the reference's deltas
    # through the same (bitwise-equal) quantizer and the same bits
    same = total = 0
    for i in range(n):
        for c in range(C):
            x, b, q, _ = calls[i * C + c]
            rows = torch.zeros(x.numel())
            rows[:sizes[i]] = torch.from_numpy(jdeltas[c][i].reshape(-1))
            jq, _ = quantize(rows.reshape(x.shape), b)
            same += int((jq == q).sum())
            total += q.numel()
    assert same >= 0.999 * total, (same, total)

    # the global params: two quantization steps of each element's row
    want = jax.tree.leaves(js.merged_params())
    steps = [2 * np.max(np.stack([
        np.repeat(calls[(r * n + i) * C + c][3].numpy(), ops.LANES, 1
                  ).reshape(-1)[:sizes[i]]
        for r in range(ROUNDS) for c in range(C)]), 0).reshape(w.shape)
        for i, w in enumerate(want)]
    near, total = assert_params_close(want, leaves(ts.merged_params()),
                                      low, steps)
    print(f"near-eps params held to 1e-4: {near} of {total}")
