"""The port's mLSTM against the reference on the CPU: the plain chunkwise
``mlstm_chunked`` against the Pallas kernel (interpret mode) and the
step-by-step oracle, and the recurrent cells on bridged
``reduced(xlstm_350m)`` params.

Tolerances, each relative to the largest magnitude of the reference's
output (float32 unless named):
  * plain chunkwise vs the Pallas kernel at the same chunk: h 5e-5 (the
    same sums in another order; den = |n_t.q_t| can cancel, which
    magnifies the difference where it is small), C, n and m 1e-6;
    bf16 h one bf16 ulp (2^-7), the state as float32;
  * plain chunkwise vs the step-by-step oracle (another algorithm): h,
    C, n and m 2e-5;
  * the cells' outputs and states vs the reference's: 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import reduced as jax_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recurrent as JR
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import recurrent as TR

BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, nh, s, dh):
    """q, k (pre-scaled), v, ig and lf = log sigmoid(f - 2) as float32
    numpy, as the reference's kernel test draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, s, dh), dtype=np.float32)
    k = rng.standard_normal((b, nh, s, dh), dtype=np.float32) * dh ** -0.5
    v = rng.standard_normal((b, nh, s, dh), dtype=np.float32)
    ig = rng.standard_normal((b, nh, s), dtype=np.float32)
    f = rng.standard_normal((b, nh, s), dtype=np.float32) - 2.0
    lf = -np.logaddexp(-f, np.float32(0.0))
    return q, k, v, ig, lf


def _state(seed, b, nh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nh, dh, dh), dtype=np.float32) * 0.1,
            rng.standard_normal((b, nh, dh), dtype=np.float32) * 0.1,
            rng.standard_normal((b, nh), dtype=np.float32))


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    tol = rtol * max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nh,s,dh,chunk", [
    (2, 3, 128, 32, 32),
    (1, 2, 64, 64, 16),
    (1, 1, 96, 16, 96),   # single chunk
])
def test_plain_matches_pallas_kernel(dtype, b, nh, s, dh, chunk):
    q, k, v, ig, lf = _inputs(1, b, nh, s, dh)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    hj, (Cj, nj, mj) = jops.mlstm_chunked(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(ig),
        jnp.asarray(lf), chunk=chunk, interpret=True)
    n0 = ops.mlstm_chunked.launches
    ht, (Ct, nt, mt) = ops.mlstm_chunked(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)),
        torch.from_numpy(ig), torch.from_numpy(lf), chunk=chunk)
    assert ops.mlstm_chunked.launches == n0        # the plain version ran
    assert ht.dtype == td and Ct.dtype == torch.float32
    _close(_np(ht), hj.astype(jnp.float32),
           5e-5 if dtype == "float32" else BF16_ULP, "h")
    for name, got, want in (("C", Ct, Cj), ("n", nt, nj), ("m", mt, mj)):
        _close(_np(got), want, 1e-6 if dtype == "float32" else 1e-5, name)


@pytest.mark.parametrize("s,chunk,with_state", [
    (48, 16, False), (48, 16, True),
    (37, 16, False), (37, 16, True),   # ragged: a last chunk of 5 steps
])
def test_plain_matches_stepwise_oracle(s, chunk, with_state):
    b, nh, dh = 2, 2, 32
    q, k, v, ig, lf = _inputs(2, b, nh, s, dh)
    state = _state(3, b, nh, dh) if with_state else (None,) * 3
    names = ("C0", "n0", "m0")
    jkw = {n: jnp.asarray(x) for n, x in zip(names, state) if x is not None}
    tkw = {n: torch.from_numpy(x) for n, x in zip(names, state)
           if x is not None}
    hj, fin_j = jref.mlstm_chunked_ref(*(jnp.asarray(x)
                                         for x in (q, k, v, ig, lf)), **jkw)
    ht, fin_t = ops.mlstm_chunked(*(torch.from_numpy(x)
                                    for x in (q, k, v, ig, lf)),
                                  chunk=chunk, **tkw)
    _close(_np(ht), hj, 2e-5, "h")
    for name, got, want in zip("Cnm", fin_t, fin_j):
        _close(_np(got), want, 2e-5, name)
    # the port's own stepwise oracle is the reference's
    hs, fin_s = ref.mlstm_chunked_ref(*(torch.from_numpy(x)
                                        for x in (q, k, v, ig, lf)), **tkw)
    _close(_np(hs), hj, 2e-5, "stepwise h")
    _close(_np(fin_s[0]), fin_j[0], 2e-5, "stepwise C")


def test_wrapper_checks_inputs():
    q, k, v, ig, lf = (torch.from_numpy(x) for x in _inputs(4, 1, 2, 8, 16))
    with pytest.raises(ValueError, match="all of C0"):
        ops.mlstm_chunked(q, k, v, ig, lf, C0=torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros(1, 1, 2, 520)
        ops.mlstm_chunked(big, big, big, torch.zeros(1, 1, 2),
                          torch.zeros(1, 1, 2))
    with pytest.raises(ValueError, match="share"):
        ops.mlstm_chunked(q, k.bfloat16(), v, ig, lf)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_chunked(q.transpose(2, 3).contiguous().transpose(2, 3),
                          k, v, ig, lf)
    # no plain version for a device without a kernel: no fallback
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.mlstm_chunked(*(t.to("meta") for t in (q, k, v, ig, lf)))


# ------------------------------------------------------------- the cells --
@pytest.fixture(scope="module")
def cells():
    """reduced(xlstm_350m) mLSTM and sLSTM params: the reference's, and
    bridged to the port."""
    jcfg = jax_reduced(jax_get_config("xlstm_350m"))
    cfg = reduced(get_config("xlstm-350m"))
    jm = JR.init_mlstm(jax.random.PRNGKey(0), jcfg)
    js = JR.init_slstm(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, {"m": jm, "s": js})
    tp = bridge.tree_from_numpy(tree, "cpu")
    return jcfg, cfg, jm, js, tp["m"], tp["s"]


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d),
                                                      dtype=np.float32)


def _close_states(tst, jst, what):
    for key in jst:
        _close(_np(tst[key]), jst[key], 2e-5, f"{what} state {key}")


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("s", [24, 37])   # 37: prime, one chunk of 37
def test_cell_seq_matches_reference(cells, cell, s):
    jcfg, cfg, jm, js, tm, ts = cells
    x = _x(5, 2, s, cfg.d_model)
    if cell == "mlstm":
        yj, sj = JR.apply_mlstm_seq(jm, jnp.asarray(x), jcfg)
        yt, st = TR.apply_mlstm_seq(tm, torch.from_numpy(x), cfg)
    else:
        yj, sj = JR.apply_slstm_seq(js, jnp.asarray(x), jcfg)
        yt, st = TR.apply_slstm_seq(ts, torch.from_numpy(x), cfg)
    _close(_np(yt), yj, 2e-5, f"{cell} y")
    _close_states(st, sj, cell)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_state_carried_across_segments(cells, cell):
    """Two segments with the state carried, then five decode steps, in
    both packages: every output and the final state agree."""
    jcfg, cfg, jm, js, tm, ts = cells
    x = _x(6, 2, 53, cfg.d_model)
    jp, tp = (jm, tm) if cell == "mlstm" else (js, ts)
    jseq = JR.apply_mlstm_seq if cell == "mlstm" else JR.apply_slstm_seq
    tseq = TR.apply_mlstm_seq if cell == "mlstm" else TR.apply_slstm_seq
    jstep = JR.apply_mlstm_step if cell == "mlstm" else JR.apply_slstm_step
    tstep = TR.apply_mlstm_step if cell == "mlstm" else TR.apply_slstm_step
    y1j, sj = jseq(jp, jnp.asarray(x[:, :32]), jcfg)
    y2j, sj = jseq(jp, jnp.asarray(x[:, 32:48]), jcfg, state=sj)
    y1t, st = tseq(tp, torch.from_numpy(x[:, :32]), cfg)
    y2t, st = tseq(tp, torch.from_numpy(x[:, 32:48]), cfg, state=st)
    _close(_np(y1t), y1j, 2e-5, "segment 1")
    _close(_np(y2t), y2j, 2e-5, "segment 2")
    _close_states(st, sj, "after two segments")
    for t in range(48, 53):
        yj, sj = jstep(jp, jnp.asarray(x[:, t:t + 1]), sj, jcfg)
        yt, st = tstep(tp, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        _close(_np(yt), yj, 2e-5, f"step {t}")
    _close_states(st, sj, "after the steps")
