"""The tensor-core mLSTM kernel's arithmetic, emulated on the CPU.

``csrc/mlstm_chunked_tc.cu`` runs every product of the chunkwise mLSTM
(S = q k^T, C q, P v and the update v^T (w o k)) on wgmma in tf32 with
float32 accumulation, as 3xTF32: each float32 operand x splits with
round-to-nearest (ties away, ``cvt.rna.tf32.f32``) into big = rna(x) and
small = rna(x - big), and a product is small.big + big.small + big.big.
S is summed over the cluster's 64-wide slices of e in rank order, the
gates' cumsum is a warp scan over pairs of steps, and the rest is float32.
:func:`chunk_emulated` does exactly that, with the tf32 rounding as bit
arithmetic on float32 tensors.

Held to the card checks' tolerances (``chip_smoke.py``), against the
float32 plain version (``ref.mlstm_chunkwise_ref``, chunk 64): h within
5e-5 of its largest magnitude (``MLSTM_H_RTOL_F32``), C, n and m within
1e-5 (``MLSTM_STATE_RTOL``). One tf32 pass instead of three breaks them,
which is why the kernel pays for three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

H_RTOL, STATE_RTOL = 5e-5, 1e-5       # chip_smoke.py's MLSTM_*_RTOL*
CHUNK, SLICE = 64, 64         # chunk steps; a cluster rank's e slice


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b, passes):
    """a @ b with tf32 operands: 3 passes (3xTF32) or 1."""
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return ab @ bb
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


def warp_cumsum(x):
    """The kernel's inclusive cumsum of 64 steps: lane l holds steps 2l and
    2l + 1, a Kogge-Stone scan of the pair sums, then each lane's two."""
    pair = x[..., 0::2] + x[..., 1::2]                 # [..., 32]
    inc = pair.clone()
    o = 1
    while o < 32:
        shifted = torch.zeros_like(inc)
        shifted[..., o:] = inc[..., :-o]
        inc = torch.where(torch.arange(32) >= o, shifted + inc, inc)
        o *= 2
    exc = torch.zeros_like(inc)
    exc[..., 1:] = inc[..., :-1]
    b0 = exc + x[..., 0::2]
    b1 = b0 + x[..., 1::2]
    return torch.stack((b0, b1), dim=-1).reshape(x.shape)


def chunk_emulated(C, n, m, q, k, v, ig, lf, cl, passes):
    """One chunk of 64 steps (rows past ``cl`` zero) for one (b, h):
    C [DH, DH], n [DH], m scalar tensor; q, k, v [64, DH]; ig, lf [64].
    Returns (C', n', m', h [64, DH]) as the kernel computes them."""
    dh = q.shape[1]
    live = torch.arange(CHUNK) < cl
    lf = torch.where(live, lf, 0.0)
    b = warp_cumsum(lf)
    a = torch.where(live, ig - b, float("-inf"))
    M = torch.cummax(a, dim=0).values
    mt = b + torch.maximum(m, M)
    m_out, b_last = mt[cl - 1], b[cl - 1]
    inter = torch.where(live, torch.exp((m + b) - mt), 0.0)
    wk = torch.where(live, torch.exp(((b_last - b) + ig) - m_out), 0.0)
    carry = torch.exp((m + b_last) - m_out)
    # S and q.n: each CTA's 64-wide slice of e, summed in rank order
    S = torch.zeros((CHUNK, CHUNK))
    qn = torch.zeros(CHUNK)
    for e0 in range(0, dh, SLICE):
        sl = slice(e0, e0 + SLICE)
        S = S + mm(q[:, sl], k[:, sl].T, passes)
        qn = qn + q[:, sl] @ n[sl]
    tri = torch.ones((CHUNK, CHUNK), dtype=torch.bool).tril() \
        & live[:, None]
    D = torch.exp(torch.where(tri, ((b[:, None] - b[None, :]) + ig[None, :])
                              - mt[:, None], float("-inf")))
    P = S * D
    den = torch.where(live, torch.maximum((P.sum(1) + inter * qn).abs(),
                                          torch.exp(-mt)), 1.0)
    cq = mm(C, q.T, passes).T                          # [t, i]
    h = (inter[:, None] * cq + mm(P, v, passes)) / den[:, None]
    C = carry * C + mm(v.T, wk[:, None] * k, passes)
    n = carry * n + (wk[:, None] * k).sum(0)
    return C, n, m_out, h


def mlstm_emulated(q, k, v, ig, lf, C0=None, n0=None, m0=None, passes=3):
    """The kernel's function for q, k, v [B, NH, S, DH]: returns (h in
    q's dtype, (C, n, m))."""
    b, nh, s, dh = q.shape
    C, n, m = ref._mlstm_init_state(q, C0, n0, m0)
    C, n, m = C.clone(), n.clone(), m.clone()
    h = torch.zeros((b, nh, s, dh))
    for bi in range(b):
        for hi in range(nh):
            Cx, nx, mx = C[bi, hi], n[bi, hi], m[bi, hi]
            for t0 in range(0, s, CHUNK):
                cl = min(CHUNK, s - t0)

                def rows(x):
                    out = torch.zeros((CHUNK,) + x.shape[3:])
                    out[:cl] = x[bi, hi, t0:t0 + cl].float()
                    return out
                Cx, nx, mx, hx = chunk_emulated(
                    Cx, nx, mx, rows(q), rows(k), rows(v), rows(ig),
                    rows(lf), cl, passes)
                h[bi, hi, t0:t0 + cl] = hx[:cl]
            C[bi, hi], n[bi, hi], m[bi, hi] = Cx, nx, mx
    return h.to(q.dtype), (C, n, m)


def _inputs(seed, b, nh, s, dh, dtype, state):
    """The card checks' draw (chip_smoke.py's _mlstm_inputs), from numpy."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    args = (rand(b, nh, s, dh).to(dtype),
            (rand(b, nh, s, dh) * dh ** -0.5).to(dtype),
            rand(b, nh, s, dh).to(dtype), rand(b, nh, s),
            torch.nn.functional.logsigmoid(rand(b, nh, s) + 2.0))
    kw = {}
    if state:
        kw = dict(C0=rand(b, nh, dh, dh) * 0.1, n0=rand(b, nh, dh) * 0.1,
                  m0=rand(b, nh))
    return args, kw


def _errors(got, want):
    """Each of h, C, n, m: max |error| / max(1, largest |want|)."""
    out = {}
    for name, g, w in zip("hCnm", (got[0], *got[1]), (want[0], *want[1])):
        peak = max(1.0, float(w.float().abs().max()))
        out[name] = float((g.float() - w.float()).abs().max()) / peak
    return out


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tf32(x), want)
    big = tf32(torch.tensor([0.1]))
    assert float((torch.tensor([0.1]) - big).abs()) <= 2.0 ** -11 * 0.1
    # the split is exact: big + small == x to within small's own rounding
    x = torch.randn(1000)
    b_ = tf32(x)
    assert float((x - (b_ + tf32(x - b_))).abs().max()) <= \
        2.0 ** -21 * float(x.abs().max())


@pytest.mark.parametrize("b,nh,s,dh,dtype,state", [
    (1, 1, 128, 512, torch.float32, False),    # one (b, h) at the path's DH
    (1, 2, 100, 64, torch.float32, True),      # reduced: masked last chunk
    (1, 1, 96, 128, torch.bfloat16, True),     # bf16 inputs: fewer passes
], ids=["dh512-s128", "dh64-ragged-state", "bf16-dh128"])
def test_3xtf32_meets_the_card_tolerances(b, nh, s, dh, dtype, state):
    args, kw = _inputs(7, b, nh, s, dh, dtype, state)
    want = ref.mlstm_chunkwise_ref(*args, chunk=CHUNK, **kw)
    err = _errors(mlstm_emulated(*args, **kw, passes=3), want)
    h_tol = H_RTOL if dtype == torch.float32 else 2.0 ** -7
    assert err["h"] <= h_tol, err
    for name in "Cnm":
        assert err[name] <= STATE_RTOL, (name, err)


def test_one_tf32_pass_breaks_the_card_tolerances():
    args, kw = _inputs(7, 1, 1, 128, 512, torch.float32, False)
    want = ref.mlstm_chunkwise_ref(*args, chunk=CHUNK, **kw)
    one = _errors(mlstm_emulated(*args, **kw, passes=1), want)
    three = _errors(mlstm_emulated(*args, **kw, passes=3), want)
    assert one["h"] > H_RTOL and one["C"] > STATE_RTOL, one
    # three passes are over a hundred times closer
    assert three["h"] * 100 < one["h"] and three["C"] * 100 < one["C"]


def test_warp_cumsum_is_a_cumsum():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 64)).astype(np.float32))
    got = warp_cumsum(x)
    want = torch.cumsum(x.double(), dim=-1)
    assert float((got.double() - want).abs().max()) < 1e-5
