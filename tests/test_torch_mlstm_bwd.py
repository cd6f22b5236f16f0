"""The mLSTM's backward on the CPU: the plain chunkwise backward
(``ref.mlstm_chunkwise_bwd_ref``, every stabilizer held constant) against
the reference's gradient (``jax.vjp`` of a ``lax.scan`` of its
``models/recurrent.mlstm_chunk_body``) and against ``torch.autograd``
through the port's plain chunk body (which differentiates the running
max); the autograd Function ``ops.mlstm_chunked_ad`` on CPU tensors.

Inputs are made with numpy from a seed and handed to both packages:
q, v standard normal, k scaled by DH^-0.5, ig standard normal, lf = log
sigmoid(N(2, 1)). On these gates the reference's gradients are finite.
Elsewhere its chunk body exponentiates the decay matrix before masking
it, and once a masked entry overflows its gradient is NaN (ROADMAP queue
C); the port masks first. The scan needs equal chunks, so the JAX cases
take S a multiple of the chunk; the ragged last chunk is held here
against autograd and on the card against the kernel.

Tolerances: against JAX each gradient within 1e-4 of its largest
magnitude (float32 in both, other summation orders, and den = max(|n.q|,
e^-m) divides and can magnify them); against autograd through the same
package's plain body within 1e-5 (the same sums, the running max's
branch instead of the held m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recurrent import mlstm_chunk_body as jax_chunk_body
from repro_torch.kernels import ops, ref

B, NH, DH = 2, 2, 16
JAX_RTOL = 1e-4
AUTOGRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s, state):
    """(q, k, v, ig, lf), the initial state or None, and the cotangent
    dh, all numpy float32."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    lf = -np.logaddexp(0.0, -(r(B, NH, s) + 2.0)).astype(np.float32)
    args = (r(B, NH, s, DH), r(B, NH, s, DH) * np.float32(DH ** -0.5),
            r(B, NH, s, DH), r(B, NH, s), lf)
    init = None
    if state:
        init = (r(B, NH, DH, DH) * np.float32(0.1),
                r(B, NH, DH) * np.float32(0.1), r(B, NH))
    return args, init, r(B, NH, s, DH)


def _fresh():
    return (np.zeros((B, NH, DH, DH), np.float32),
            np.zeros((B, NH, DH), np.float32),
            np.full((B, NH), -1e30, np.float32))


def _jax_grads(args, init, dh, chunk):
    """The reference's gradients of h: jax.vjp of its chunk body scanned
    over equal chunks."""
    s = args[0].shape[2]
    nc = s // chunk

    def split(t, heads=True):
        if heads:
            return t.reshape(B, NH, nc, chunk, -1).transpose(2, 0, 1, 3, 4)
        return t.reshape(B, NH, nc, chunk).transpose(2, 0, 1, 3)

    def run(q, k, v, ig, lf):
        def body(carry, inp):
            C, n, m, h = jax_chunk_body(*carry, *inp)
            return (C, n, m), h

        _, hs = jax.lax.scan(
            body, tuple(jnp.asarray(x) for x in init or _fresh()),
            (split(q), split(k), split(v), split(ig, False),
             split(lf, False)))
        return hs.transpose(1, 2, 0, 3, 4).reshape(B, NH, s, DH)

    h, vjp = jax.vjp(run, *(jnp.asarray(a) for a in args))
    return np.asarray(h), [np.asarray(g) for g in vjp(jnp.asarray(dh))]


def _torch_state(init):
    if init is None:
        return {}
    return dict(zip(("C0", "n0", "m0"), (torch.from_numpy(x) for x in init)))


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all(), f"{what}: the reference is not finite"
    err = float(np.abs(got - want).max())
    tol = rtol * float(np.abs(want).max())
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("s,chunk", [(192, 16), (256, 64)],
                         ids=["S192-c16", "S256-c64"])
@pytest.mark.parametrize("state", [False, True], ids=["fresh", "state"])
def test_plain_backward_matches_the_reference(s, chunk, state):
    args, init, dh = _inputs(11 + s + state, s, state)
    want_h, want = _jax_grads(args, init, dh, chunk)
    t = [torch.from_numpy(a) for a in args]
    h, _, states = ref.mlstm_chunkwise_ref(*t, chunk=chunk, states=True,
                                           **_torch_state(init))
    _close(h.numpy(), want_h, 2e-5, "h")
    got = ref.mlstm_chunkwise_bwd_ref(*t, h, torch.from_numpy(dh), states,
                                      chunk=chunk)
    for name, g, w in zip(("dq", "dk", "dv", "dig", "dlf"), got, want):
        _close(g.numpy(), w, JAX_RTOL, name)


def _autograd(t, init, dh, chunk):
    """torch.autograd through the port's plain chunk body, chunk by chunk
    (the last one may be shorter)."""
    ins = [x.clone().requires_grad_() for x in t]
    given = [None] * 3 if init is None else [torch.from_numpy(x)
                                             for x in init]
    C, n, m = ref._mlstm_init_state(t[0], *given)
    hs = []
    for t0 in range(0, t[0].shape[2], chunk):
        sl = slice(t0, t0 + chunk)
        C, n, m, h = ref.mlstm_chunk_body(C, n, m,
                                          *(x[:, :, sl] for x in ins))
        hs.append(h)
    return torch.autograd.grad(torch.cat(hs, 2), ins, dh)


@pytest.mark.parametrize("s,chunk,state", [
    (64, 64, False), (50, 16, True), (100, 64, True), (37, 5, False)],
    ids=["one-chunk", "ragged-state", "ragged-64", "odd-chunk"])
def test_stop_gradient_matches_autograd(s, chunk, state):
    """The m-constant formulas equal autograd through cummax and maximum
    up to rounding: h does not depend on the stabilizers."""
    args, init, dh = _inputs(5 + s, s, state)
    t = [torch.from_numpy(a) for a in args]
    h, _, states = ref.mlstm_chunkwise_ref(*t, chunk=chunk, states=True,
                                           **_torch_state(init))
    got = ref.mlstm_chunkwise_bwd_ref(*t, h, torch.from_numpy(dh), states,
                                      chunk=chunk)
    want = _autograd(t, init, torch.from_numpy(dh), chunk)
    for name, g, w in zip(("dq", "dk", "dv", "dig", "dlf"), got, want):
        _close(g.numpy(), w.numpy(), AUTOGRAD_RTOL, name)


def test_states_leave_the_forward_bitwise():
    """The forward that keeps the backward's states returns the same h
    and final state bitwise; the states have the documented shapes."""
    args, init, _ = _inputs(3, 77, True)
    t = [torch.from_numpy(a) for a in args]
    kw = _torch_state(init)
    h0, fin0 = ref.mlstm_chunkwise_ref(*t, chunk=16, **kw)
    h, fin, states = ref.mlstm_chunkwise_ref(*t, chunk=16, states=True, **kw)
    assert torch.equal(h, h0)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin0))
    nc = 5
    assert [tuple(x.shape) for x in states] == [
        (B, NH, nc, DH, DH), (B, NH, nc, DH), (B, NH, nc), (B, NH, 77),
        (B, NH, 77)]
    assert torch.equal(states[0][:, :, 0], kw["C0"])
    assert torch.equal(states[2][:, :, 0], kw["m0"])


def test_function_on_the_cpu():
    """ops.mlstm_chunked_ad on CPU tensors: h bitwise the plain forward's,
    the gradients bitwise the plain backward's at the caller's chunk, no
    kernel launch."""
    args, init, dh = _inputs(7, 90, True)
    t = [torch.from_numpy(a) for a in args]
    kw = _torch_state(init)
    ins = [x.clone().requires_grad_() for x in t]
    n0 = dict(ops.launch_counts())
    h, (C, n, m) = ops.mlstm_chunked_ad(*ins, chunk=32, **kw)
    want_h, want_fin, states = ref.mlstm_chunkwise_ref(*t, chunk=32,
                                                       states=True, **kw)
    assert torch.equal(h.detach(), want_h)
    assert all(torch.equal(a.detach(), b)
               for a, b in zip((C, n, m), want_fin))
    got = torch.autograd.grad(h, ins, torch.from_numpy(dh))
    want = ref.mlstm_chunkwise_bwd_ref(*t, want_h, torch.from_numpy(dh),
                                       states, chunk=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == n0


def test_function_refuses_state_gradients():
    """No gradient flows through the final state or into the initial one:
    either raises rather than being dropped."""
    args, init, _ = _inputs(8, 40, True)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    kw = _torch_state(init)
    h, (C, n, m) = ops.mlstm_chunked_ad(*ins, chunk=16, **kw)
    for final in (C, n, m):
        with pytest.raises(RuntimeError, match="final state"):
            torch.autograd.grad((h.sum() + final.sum()), ins,
                                retain_graph=True)
    kw["C0"].requires_grad_()
    h, _ = ops.mlstm_chunked_ad(*ins, chunk=16, **kw)
    with pytest.raises(RuntimeError, match="initial state"):
        h.sum().backward()


def test_backward_wrapper_checks_its_states():
    args, _, dh = _inputs(9, 40, False)
    t = [torch.from_numpy(a) for a in args]
    h, _, states = ref.mlstm_chunkwise_ref(*t, chunk=16, states=True)
    with pytest.raises(ValueError, match="states"):
        ops.mlstm_chunked_bwd(*t, h, torch.from_numpy(dh), states, chunk=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.mlstm_chunked_bwd(*t, h.double(), torch.from_numpy(dh), states,
                              chunk=16)
