"""The tensor-core mLSTM backward's arithmetic, emulated on the CPU.

``csrc/mlstm_chunked_bwd_tc.cu`` runs every product of the chunkwise
mLSTM backward on wgmma in tf32 with float32 accumulation, as 3xTF32:
each float32 operand x splits into big = x truncated to tf32 (its 13 low
mantissa bits cleared, what wgmma reads of a float32 word) and small = x -
big, which wgmma truncates in turn, and a product is small.big + big.small
+ big.big. The products: the sweep's
(inter o dnum)^T q (dC's recursion); in each chunk, S = q k^T and U = dnum
v^T summed over the cluster's 64-wide slices of DH in rank order, X =
dnum C, Y = v dC', Z = k dC'^T, then dS k, dS^T q and P^T dnum. Every
other value (dqn, the gates, P, dS, dlogD, the row partials summed by
rank, db and its reverse cumsum) is float32 on the CUDA cores.
:func:`bwd_emulated` computes exactly that, with the tf32 rounding as bit
arithmetic on float32 tensors.

Held to the card checks' tolerance (``chip_smoke.py``'s MLSTM_BWD_RTOL)
against the float32 plain backward (``ref.mlstm_chunkwise_bwd_ref``,
chunk 64, on the plain forward's states): every gradient within 1e-4 of
its largest magnitude. One tf32 pass instead of three breaks it, which is
why the kernel pays for three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

RTOL = 1e-4                   # chip_smoke.py's MLSTM_BWD_RTOL
CHUNK, SLICE = 64, 64         # chunk steps; a cluster rank's slice of DH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """float32 truncated to tf32: the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def mm(a, b, passes):
    """a @ b (batched) with tf32 operands as wgmma reads them: 3 passes
    (3xTF32, the small ones first) or 1."""
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return ab @ bb
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


def by_rank(fn, dh):
    """sum over the cluster's ranks r (in rank order) of fn(slice r)."""
    out = None
    for e0 in range(0, dh, SLICE):
        x = fn(slice(e0, e0 + SLICE))
        out = x if out is None else out + x
    return out


def bwd_emulated(q, k, v, ig, lf, h, dh, states, passes=3):
    """The wgmma route's function (ref.mlstm_chunkwise_bwd_ref's
    arguments, float32 [B, NH, S, DH] tensors, chunks of 64)."""
    Cs, ns, ms, mts, qns = states
    b, nh, s, d = q.shape
    floor = torch.exp(-mts)
    den_all = torch.maximum(qns.abs(), floor)
    share = torch.where(qns.abs() > floor, 1.0,
                        torch.where(qns.abs() == floor, 0.5, 0.0))
    dqn_all = -(dh * h).sum(-1) / den_all * share * torch.where(
        qns >= 0, 1.0, -1.0)
    nck = -(-s // CHUNK)
    # (b) the sweep: the carried dC' and dn' of every chunk
    dC = torch.zeros((b, nh, d, d))
    dn = torch.zeros((b, nh, d))
    carried = [None] * nck
    for kk in reversed(range(nck)):
        sl = slice(kk * CHUNK, kk * CHUNK + CHUNK)
        carried[kk] = (dC, dn)
        lfc, mt = lf[:, :, sl], mts[:, :, sl]
        b_ = torch.cumsum(lfc, dim=-1)
        inter = torch.exp(ms[:, :, kk, None] + b_ - mt)
        carry = torch.exp(ms[:, :, kk] + b_[..., -1] - mt[..., -1])
        a = inter[..., None] * (dh[:, :, sl] * (1.0 / den_all[:, :, sl,
                                                              None]))
        dC = carry[..., None, None] * dC + mm(a.transpose(-1, -2),
                                              q[:, :, sl], passes)
        dn = carry[..., None] * dn + torch.einsum(
            "bht,bhte->bhe", inter * dqn_all[:, :, sl], q[:, :, sl])
    # (c) every chunk
    out = [torch.empty((b, nh, s, d)) for _ in range(3)]
    out += [torch.empty((b, nh, s)) for _ in range(2)]
    for kk in range(nck):
        sl = slice(kk * CHUNK, kk * CHUNK + CHUNK)
        grads = _chunk(Cs[:, :, kk], ns[:, :, kk], ms[:, :, kk],
                       q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl],
                       lf[:, :, sl], mts[:, :, sl], den_all[:, :, sl],
                       dqn_all[:, :, sl], dh[:, :, sl], *carried[kk], passes)
        for o, x in zip(out, grads):
            o[:, :, sl] = x
    return tuple(out)


def _chunk(C, n, m, q, k, v, ig, lf, m_t, den, dqn, dh, dC, dn, passes):
    c, d = q.shape[2], q.shape[3]
    b_ = torch.cumsum(lf, dim=-1)
    m_out = m_t[..., -1]
    tri = torch.ones((c, c), dtype=torch.bool).tril()
    D = torch.exp(torch.where(
        tri, b_[..., :, None] - b_[..., None, :] + ig[..., None, :]
        - m_t[..., :, None], float("-inf")))
    inter = torch.exp(m[..., None] + b_ - m_t)
    w = torch.exp(b_[..., -1:] - b_ + ig - m_out[..., None])
    carry = torch.exp(m + b_[..., -1] - m_out)
    dnum = dh * (1.0 / den[..., None])     # the kernels scale by 1 / den
    T = lambda x: x.transpose(-1, -2)   # noqa: E731
    S = by_rank(lambda r: mm(q[..., r], T(k[..., r]), passes), d)
    U = by_rank(lambda r: mm(dnum[..., r], T(v[..., r]), passes), d)
    P = S * D
    dP = torch.where(tri, U + dqn[..., None], 0.0)
    dS = dP * D
    dlogD = dP * P
    X = mm(dnum, C, passes)
    Y = mm(v, dC, passes)
    Z = mm(k, T(dC), passes)
    dq = mm(dS, k, passes) + inter[..., None] * (X + dqn[..., None]
                                                 * n[..., None, :])
    dk = mm(T(dS), q, passes) + w[..., None] * (Y + dn[..., None, :])
    dv = mm(T(P), dnum, passes) + w[..., None] * Z
    dinter = by_rank(lambda r: (X[..., r] * q[..., r]).sum(-1), d) \
        + dqn * by_rank(lambda r: (q[..., r] * n[..., None, r]).sum(-1), d)
    dw = by_rank(lambda r: (v[..., r] * Z[..., r]).sum(-1), d) \
        + by_rank(lambda r: (k[..., r] * dn[..., None, r]).sum(-1), d)
    dcarry = by_rank(lambda r: (dC[..., r, :] * C[..., r, :]).sum((-2, -1))
                     + (dn[..., r] * n[..., r]).sum(-1), d)
    gw = dw * w
    db = dlogD.sum(-1) - dlogD.sum(-2) + dinter * inter - gw
    db[..., -1] += gw.sum(-1) + dcarry * carry
    dig = dlogD.sum(-2) + gw
    dlf = db.flip(-1).cumsum(-1).flip(-1)
    return dq, dk, dv, dig, dlf


def _inputs(seed, b, nh, s, d, state):
    """The card checks' draw (chip_smoke.py's _mlstm_inputs), from numpy,
    the forward's states (plain, chunk 64) and a random cotangent."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    args = (rand(b, nh, s, d), rand(b, nh, s, d) * d ** -0.5,
            rand(b, nh, s, d), rand(b, nh, s),
            torch.nn.functional.logsigmoid(rand(b, nh, s) + 2.0))
    kw = {}
    if state:
        kw = dict(C0=rand(b, nh, d, d) * 0.1, n0=rand(b, nh, d) * 0.1,
                  m0=rand(b, nh))
    h, _, states = ref.mlstm_chunkwise_ref(*args, chunk=CHUNK, states=True,
                                           **kw)
    return args, h, rand(b, nh, s, d), states


def _errors(got, want):
    """Each gradient's max |error| / its largest |want|."""
    return {name: float((g - w).abs().max()) / float(w.abs().max())
            for name, g, w in zip(("dq", "dk", "dv", "dig", "dlf"), got,
                                  want)}


@pytest.mark.parametrize("b,nh,s,d,state", [
    (1, 2, 200, 64, True),     # a ragged last chunk, an initial state
    (1, 1, 128, 128, False),   # two ranks, the fresh state of training
    (2, 1, 150, 128, True),
], ids=["dh64-ragged-state", "dh128-fresh", "dh128-ragged-state"])
def test_3xtf32_meets_the_card_tolerance(b, nh, s, d, state):
    args, h, dh, states = _inputs(11, b, nh, s, d, state)
    want = ref.mlstm_chunkwise_bwd_ref(*args, h, dh, states, chunk=CHUNK)
    err = _errors(bwd_emulated(*args, h, dh, states, passes=3), want)
    assert max(err.values()) <= RTOL, err


def test_one_tf32_pass_breaks_the_card_tolerance():
    args, h, dh, states = _inputs(11, 1, 1, 128, 128, False)
    want = ref.mlstm_chunkwise_bwd_ref(*args, h, dh, states, chunk=CHUNK)
    one = _errors(bwd_emulated(*args, h, dh, states, passes=1), want)
    three = _errors(bwd_emulated(*args, h, dh, states, passes=3), want)
    assert max(one.values()) > RTOL, one
    # three passes are over a hundred times closer
    assert max(three.values()) * 100 < max(one.values()), (one, three)
