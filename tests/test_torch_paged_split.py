"""The arithmetic of the TMA-fed paged kernels, emulated in plain PyTorch
on the CPU and held against the plain versions and the reference's Pallas
kernels in interpret mode.

``csrc/paged_decode_tma.cu`` and ``csrc/paged_prefill_tc.cu`` split a
lane's keys over CTAs of at least :data:`ops.SPLIT_KEYS` keys (the plan
is :func:`ops.paged_splits`, the function that sizes their grids;
``csrc/paged_prefill_tc128.cu`` splits down to one 64-key tile a CTA,
:func:`ops.prefill_splits`), walk each split in 64-key tiles with an online softmax in the log2 domain, and merge
the splits' partial (m, l, acc) in split order, a split that saw no key
carrying m = -1e30, l = 0, acc = 0. Decode runs on the CUDA cores in
float32: each of four warps keeps its own statistics over keys 16w..16w+15
of every tile, merged at the end; int8 K scales multiply the score and V
scales fold into the probability. At head_dim 128
(``csrc/paged_decode_tma128.cu``) the plan and the merge are the same and
eight warps take 8 keys each of a tile (four lanes a key, each owning
four of the 128 output columns for P V). Prefill runs on wgmma: int8 blocks
become bf16 (exact), K's scale multiplies S's columns, and P, with V's
scale folded in, is rounded to bf16 before P V (at head_dim 128 split in
two bf16 parts, as the verify's); the row sum takes the float32 P. A KV head's G*C query rows go in tiles of the route's rows
(``ops.PREFILL_KERNELS``): 64 at head_dim 64, 128 at head_dim 128
(``csrc/paged_prefill_tc128.cu``, two warpgroups of 64 rows), which
also sizes the split plan. The batched verify runs the prefill kernel with P split into
bf16 hi = bf16(p) and lo = bf16(p - hi), two products into one float32
accumulator: here its rows land within one bf16 ulp of the decode
emulation's at the same positions, where one rounding of P does not, and
within ``ref.verify_decode_gap_bound`` (the card checks' gate, derived
from the two kernels' accumulation orders), which a dropped key breaks.

This file repeats that arithmetic step by step on inputs whose q, K and V
are bf16 values held in float32 (the kernels' operands, exactly), with
lanes at ctx 0 and 1, lanes ending exactly on a split boundary (384, 768)
and one key past one (385), a chunk whose early rows see no key in its
second split, a NaN-poisoned null block behind every dead table slot, and
GQA groups 1, 2 and 8 (prefill's group 8 spans two 64-row tiles); decode
also at head_dim 128 with the dense configs' groups 5 and 8, prefill with
their groups 5, 7 and 8 (80, 112 and 128 rows: one 128-row tile).

Tolerances: decode's emulation is float32 throughout and is held to 1e-5
of the plain version and of the Pallas kernel (orders of summation and
exp2 against exp differ); prefill's rounds P to bf16 (8 significant
bits: a relative 2^-8 of each probability at most), so its output may
move by 2^-8 of the largest |V| (dequantized), held to that plus 1e-5.
Ctx-0 lanes must be exact zeros and every output finite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

LOG2E = 1.4426950408889634
NEG = -1e30                  # the kernels' finite mask value
KT = 64                      # keys of a ring tile
D, BS = 64, 16               # the TMA route's head dim and a block size
#: decode's consumer warps at each head dim: KT / warps keys a warp of
#: every tile
DECODE_WARPS = {64: 4, 128: 8}
#: lanes at ctx 0 and 1, ending exactly on a split boundary (384, 768)
#: and one key past one (385); the tables' 928 keys split in three
DECODE_CTX = [0, 1, 384, 768, 385, 900]
#: (q_offset, chunk_len): the first chunk; one whose rows at 376..383 see
#: no key in its second split; one ending exactly on a split boundary; a
#: partial last chunk
CHUNKS = [(0, 16), (376, 16), (752, 16), (890, 7)]
C = 16
GROUPS = {"g1": (2, 2), "g2": (4, 2), "g8": (8, 1)}    # (Hq, Hkv)
#: decode's (Hq, Hkv, head dim): GROUPS at 64, the dense configs' groups
#: of 5 (qwen3-14b's 40/8) and 8 (qwen3-32b's 64/8) at 128
DECODE_GROUPS = {**{k: (*v, D) for k, v in GROUPS.items()},
                 "g5-d128": (5, 1, 128), "g8-d128": (8, 1, 128)}
#: the CTAs a KV head's keys split over at each of CHUNKS (one row tile):
#: at least 384 keys a split at head dim 64, one 64-key tile at 128
PREFILL_SPLIT_COUNTS = {64: [1, 2, 2, 3], 128: [1, 7, 12, 15]}
#: prefill's (Hq, Hkv, head dim): GROUPS at 64, the dense configs' groups
#: of 5, 7 (yi-34b's 56/8) and 8 at 128, one KV head each
PREFILL_GROUPS = {**{k: (*v, D) for k, v in GROUPS.items()},
                  "g5-d128": (5, 1, 128), "g7-d128": (7, 1, 128),
                  "g8-d128": (8, 1, 128)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float()


def _inputs(rng, hkv, ctx_list, int8, d=D):
    """Pools [hkv, NB, BS, d] with the null block 0 poisoned (values, or
    int8 scales) and lane tables over shuffled blocks, dead slots on
    block 0."""
    need = [-(-c // BS) for c in ctx_list]
    t = max(need) + 1
    nb = 2 + sum(need)
    tables = np.zeros((len(ctx_list), t), np.int32)
    phys, i = rng.permutation(np.arange(1, nb)), 0
    for lane, n in enumerate(need):
        tables[lane, :n] = phys[i:i + n]
        i += n
    shape = (hkv, nb, BS, d)
    if int8:
        k = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        v = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        ks = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        vs = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        ks[:, 0] = vs[:, 0] = float("nan")
        return torch.from_numpy(tables), k, v, ks, vs
    k, v = _bf16(rng, shape), _bf16(rng, shape)
    k[:, 0] = v[:, 0] = float("nan")
    return torch.from_numpy(tables), k, v, None, None


def _rows(pool, scales, table_row, h, lo, kend):
    """Keys lo..kend-1 of one lane and KV head, through the live table
    slots only (as the producer loads them): (rows float32 [n, D], their
    scales [n], 1 for float pools)."""
    blocks = table_row[lo // BS:-(-kend // BS)].long()
    x = pool[h, blocks].reshape(-1, pool.shape[-1])[lo % BS:][:kend - lo]
    x = x.float()
    if scales is None:
        return x, torch.ones(kend - lo)
    s = scales[h, blocks].reshape(-1)[lo % BS:][:kend - lo]
    return x, s


def combine(parts):
    """Partial results (m [r], l [r], acc [r, D]) combined in order into
    one, as paged_tma.cuh's merge_splits: weights 2^(m_s - max m); a part
    that saw no key has l = acc = 0 and gets weight 0."""
    mx = torch.full_like(parts[0][0], NEG)
    for m, _, _ in parts:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(mx)
    a = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp2(m - mx)
        lsum = lsum + l * f
        a = a + acc * f[:, None]
    return mx, lsum, a


def merge(parts):
    """The output of merged parts: acc / l (no key at all: 0 / 1e-30)."""
    _, lsum, a = combine(parts)
    return a / torch.clamp(lsum, min=1e-30)[:, None]


def decode_emulated(q, k, v, ks, vs, tables, ctx_lens, scale, drop=0):
    """paged_decode_tma.cu's arithmetic (paged_decode_tma128.cu's at
    head_dim 128): [B, Hq, D] float32. ``drop`` keys are left out at the
    end of split 0 of a lane that splits (a fault for the card checks to
    see)."""
    b, hq, d = q.shape
    hkv = k.shape[0]
    g = hq // hkv
    nw = DECODE_WARPS[d]
    kpw = KT // nw
    t = tables.shape[1]
    nsplit, per = ops.paged_splits(t * BS, b * hkv)
    out = torch.zeros((b, hq, d))
    for lane in range(b):
        ctx = min(int(ctx_lens[lane]), t * BS)
        nlive = max(1, -(-ctx // per))
        assert nlive <= nsplit
        for h in range(hkv):
            qs = q[lane, h * g:(h + 1) * g].float() * (scale * LOG2E)
            parts = []
            for sp in range(nlive):
                lo = sp * per
                kend = min(ctx, lo + per) - (drop if sp == 0 < nlive - 1
                                             else 0)
                warps = [(torch.full((g,), NEG), torch.zeros(g),
                          torch.zeros((g, d))) for _ in range(nw)]
                for t0 in range(lo, kend, KT):
                    for w in range(nw):   # keys kpw w .. kpw w + kpw - 1
                        k0 = t0 + kpw * w
                        k1 = min(k0 + kpw, kend)
                        if k1 <= k0:
                            continue
                        kr, ksc = _rows(k, ks, tables[lane], h, k0, k1)
                        vr, vsc = _rows(v, vs, tables[lane], h, k0, k1)
                        x = (qs @ kr.T) * ksc[None]
                        m, l, acc = warps[w]
                        m_new = torch.maximum(m, x.max(dim=1).values)
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new[:, None])
                        warps[w] = (m_new, l * corr + p.sum(1),
                                    acc * corr[:, None] + (p * vsc) @ vr)
                parts.append(combine(warps))     # the CTA's partial
            out[lane, h * g:(h + 1) * g] = merge(parts)
    return out


def prefill_route(d):
    """The wgmma prefill route at head dim ``d`` (bf16 q over bf16 pools
    at block size BS)."""
    return ops.paged_route("prefill", torch.bfloat16, torch.bfloat16, d, BS)


def prefill_tile(d):
    """The query rows of a CTA of :func:`prefill_route` (``d``)."""
    return ops.PREFILL_KERNELS[prefill_route(d)].rows


def prefill_emulated(q, k, v, ks, vs, table, q_offset, ctx_len, scale,
                     drop=0, split_p=None):
    """paged_prefill_tc.cu's arithmetic (paged_prefill_tc128.cu's at head
    dim 128), in row tiles of :func:`prefill_tile` of q's head dim: [Hq,
    C, D] float32 (rows past chunk_len included); ``drop`` as
    :func:`decode_emulated`; ``split_p``: P V as the verify route takes
    it, two bf16 parts (None: as a prefill chunk's launch takes it on
    the head dim's route, ``ops.PREFILL_KERNELS``)."""
    hq, c, d = q.shape
    hkv = k.shape[0]
    rows = hq // hkv * c
    tile = prefill_tile(d)
    if split_p is None:
        split_p = ops.PREFILL_KERNELS[prefill_route(d)].split_p
    keys = min(ctx_len, table.shape[0] * BS)
    tiles = -(-rows // tile)
    nsplit, per = ops.prefill_splits(prefill_route(d), keys, hkv * tiles)
    scale_log2 = scale * LOG2E
    qg = q.float().reshape(hkv, rows, d)
    out = torch.zeros((hkv, rows, d))
    for h in range(hkv):
        for r0 in range(0, rows, tile):
            qt = qg[h, r0:r0 + tile]
            pos = q_offset + (r0 + torch.arange(qt.shape[0])) % c
            parts = []
            for sp in range(nsplit):
                lo = sp * per
                kend = min(keys, lo + per) - (drop if sp == 0 < nsplit - 1
                                              else 0)
                m = torch.full((qt.shape[0],), NEG)
                l = torch.zeros(qt.shape[0])
                acc = torch.zeros((qt.shape[0], d))
                for t0 in range(lo, kend, KT):
                    t1 = min(t0 + KT, kend)
                    kr, ksc = _rows(k, ks, table, h, t0, t1)
                    vr, vsc = _rows(v, vs, table, h, t0, t1)
                    s = (qt @ kr.T) * ksc[None]
                    ok = torch.arange(t0, t1)[None] <= pos[:, None]
                    s = torch.where(ok, s, -torch.inf)
                    m_new = torch.maximum(m, s.max(1).values * scale_log2)
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(s * scale_log2 - m_new[:, None])
                    l = l * corr + p.sum(1)
                    pv = p * vsc[None]
                    hi = pv.to(torch.bfloat16).float()
                    pv = hi + (pv - hi).to(torch.bfloat16).float() \
                        if split_p else hi
                    acc = acc * corr[:, None] + pv @ vr
                    m = m_new
                parts.append((m, l, acc))
            out[h, r0:r0 + qt.shape[0]] = merge(parts)
    return out.reshape(hq, c, d)


def _t2j(x):
    return None if x is None else jnp.asarray(x.numpy())


def _vmax(v, vs):
    return float((v.float() * (1.0 if vs is None else vs)).nan_to_num(
        0.0).abs().max())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("group", DECODE_GROUPS)
def test_decode_split_emulation(group, int8):
    hq, hkv, d = DECODE_GROUPS[group]
    rng = np.random.default_rng(30 + hq + int8)
    tables, k, v, ks, vs = _inputs(rng, hkv, DECODE_CTX, int8, d)
    q = _bf16(rng, (len(DECODE_CTX), hq, d))
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32)
    assert ops.paged_splits(tables.shape[1] * BS,
                            len(DECODE_CTX) * hkv) == (3, 384)
    got = decode_emulated(q, k, v, ks, vs, tables, ctx, d ** -0.5)
    want = ref.paged_decode_attention_ref(q, k, v, tables, ctx,
                                          k_scales=ks, v_scales=vs)
    pallas = np.asarray(jops.paged_decode_attention(
        _t2j(q), _t2j(k), _t2j(v), _t2j(tables), _t2j(ctx),
        k_scales=_t2j(ks), v_scales=_t2j(vs), interpret=True))
    assert torch.isfinite(got).all()
    assert not got[ctx == 0].any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("group", PREFILL_GROUPS)
def test_prefill_split_emulation(group, int8):
    hq, hkv, d = PREFILL_GROUPS[group]
    rng = np.random.default_rng(40 + hq + int8 + (d != D))
    ctx_max = max(o + n for o, n in CHUNKS)
    tables, k, v, ks, vs = _inputs(rng, hkv, [ctx_max], int8, d)
    tol = 2.0 ** -8 * _vmax(v, vs) + 1e-5
    splits = []
    for q_offset, chunk_len in CHUNKS:
        q = _bf16(rng, (hq, C, d))
        args = (q, k, v, tables[0], q_offset, q_offset + chunk_len)
        got = prefill_emulated(q, k, v, ks, vs, tables[0], q_offset,
                               q_offset + chunk_len, d ** -0.5)
        want = ref.paged_prefill_attention_ref(*args, k_scales=ks,
                                               v_scales=vs)
        pallas = np.asarray(jops.paged_prefill_attention(
            _t2j(q), _t2j(k), _t2j(v), _t2j(tables[0]), q_offset,
            q_offset + chunk_len, k_scales=_t2j(ks), v_scales=_t2j(vs),
            interpret=True))
        assert torch.isfinite(got).all()
        live = slice(0, chunk_len)
        torch.testing.assert_close(got[:, live], want[:, live], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(got[:, live].numpy(), pallas[:, live],
                                   rtol=0, atol=tol)
        splits.append(ops.prefill_splits(
            prefill_route(d), min(q_offset + chunk_len, tables.shape[1] * BS),
            hkv * -(-hq // hkv * C // prefill_tile(d)))[0])
    assert splits == PREFILL_SPLIT_COUNTS[d]


def _ulps(a, b):
    """bf16 ulps between two bf16 tensors (as ordered integers)."""
    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


#: the verify windows' (Hq, Hkv, head dim): flad-adllm's GQA group 2 at
#: 64 and qwen3-14b's group 5 at 128, a KV head each
VERIFY_HEADS = {64: (4, 2, D), 128: (5, 1, 128)}


@pytest.mark.parametrize("int8,d", [(False, 64), (True, 64), (False, 128),
                                    (True, 128)],
                         ids=["bf16", "int8", "bf16-d128", "int8-d128"])
def test_split_p_verify_rows_within_a_bf16_ulp_of_decode(int8, d):
    """A verify window of 5 rows (flad-adllm's GQA group 2, 2 KV heads;
    at head dim 128 qwen3-14b's group 5) at the end of a 900-key context:
    with P split, every bf16 row is within one ulp of the decode
    emulation's row at its position; with P rounded once (the route
    before the split) some rows are not."""
    hq, hkv, _ = VERIFY_HEADS[d]
    c, q_offset = 5, 895
    rng = np.random.default_rng(50 + int8 + (d != D))
    tables, k, v, ks, vs = _inputs(rng, hkv, [q_offset + c], int8, d)
    q = _bf16(rng, (hq, c, d))
    dec = decode_emulated(
        q.transpose(0, 1), k, v, ks, vs, tables.expand(c, -1),
        torch.arange(q_offset + 1, q_offset + c + 1), d ** -0.5)
    dec = dec.to(torch.bfloat16)
    worst = {}
    for split in (True, False):
        got = prefill_emulated(q, k, v, ks, vs, tables[0], q_offset,
                               q_offset + c, d ** -0.5, split_p=split)
        ulps = _ulps(got.transpose(0, 1).to(torch.bfloat16), dec)
        worst[split] = int(ulps.max())
    assert worst[True] <= 1, worst
    assert worst[False] > 1, worst


def beyond_the_gap_bound(got, dec, bound):
    """The largest share of ``bound`` (ref.verify_decode_gap_bound) that
    |got - dec| (bf16 rows) takes beyond one bf16 ulp of the larger of
    the two: above 1, an element lies farther from the decode kernel's
    than the two kernels' arithmetic allows."""
    g, w = got.double(), dec.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    past = ((g - w).abs() - ulp).clamp_min(0)
    return float(torch.where(past > 0, past / bound, 0.0).max())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_verify_decode_gap_bound_holds_and_sees_a_dropped_key(int8):
    """The 5-row window of the test above: the split verify's emulated
    rows lie within the derived gap bound (plus one ulp) of the decode
    emulation's, and leaving out split 0's last key breaks it."""
    hq, hkv, c, q_offset = 4, 2, 5, 895
    rng = np.random.default_rng(50 + int8)
    tables, k, v, ks, vs = _inputs(rng, hkv, [q_offset + c], int8)
    q = _bf16(rng, (hq, c, D))
    dec = decode_emulated(
        q.transpose(0, 1), k, v, ks, vs, tables.expand(c, -1),
        torch.arange(q_offset + 1, q_offset + c + 1), D ** -0.5)
    bound = ref.verify_decode_gap_bound(
        q[None], k, v, tables, torch.tensor([q_offset], dtype=torch.int32),
        torch.tensor([c], dtype=torch.int32), scale=D ** -0.5, k_scales=ks,
        v_scales=vs)[0].transpose(0, 1)
    use = [beyond_the_gap_bound(prefill_emulated(
        q, k, v, ks, vs, tables[0], q_offset, q_offset + c, D ** -0.5,
        split_p=True, drop=drop).transpose(0, 1).to(torch.bfloat16),
        dec.to(torch.bfloat16), bound) for drop in (0, 1)]
    assert use[0] <= 1.0 < use[1], use


@pytest.mark.parametrize("case", ["empty-split", "all-empty", "one-split"])
def test_merge_weights(case):
    """A split that saw no key (m = -1e30, l = 0, acc = 0) gets weight 0
    and adds no NaN; with no key anywhere the output is exactly 0; one
    split is its own acc / l."""
    live = (torch.tensor([3.0, -2.0]), torch.tensor([2.0, 4.0]),
            torch.arange(2 * D, dtype=torch.float32).reshape(2, D))
    empty = (torch.full((2,), NEG), torch.zeros(2), torch.zeros((2, D)))
    parts = {"empty-split": [empty, live, empty], "all-empty": [empty] * 3,
             "one-split": [live]}[case]
    got = merge(parts)
    assert torch.isfinite(got).all()
    want = (torch.zeros((2, D)) if case == "all-empty"
            else live[2] / live[1][:, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


#: the card checks' bound on each output row of a bf16 paged kernel
#: (``chip_smoke.py``'s PAGED_RTOL, ``tests/test_torch_cuda.py``'s): this
#: share of the row's largest |float32 plain value|, plus 1e-5
CARD_RTOL = {"decode": 2.0 ** -8, "prefill": 2.0 ** -7}


def _row_use(got, want, rtol):
    """The largest share of its row's card bound that an error of ``got``
    (rounded to bf16, as the kernels write it) takes."""
    err = (got.to(torch.bfloat16).float() - want).abs()
    return float((err / (rtol * want.abs().amax(-1, keepdim=True)
                         + 1e-5)).max())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind,drop", [("decode", 1), ("prefill", 16)])
def test_card_row_bound_sees_a_dropped_key(kind, drop, int8):
    """The row bound of the card checks holds the emulated kernels'
    output and is broken when split 0 leaves out its last key (decode:
    lanes at 385, 768 and 900 keys) or its last 16-key block (prefill: a
    chunk ending on the second split's boundary at 768)."""
    hq, hkv = GROUPS["g2"]
    rng = np.random.default_rng(50 + int8)
    scale = D ** -0.5
    if kind == "decode":
        tables, k, v, ks, vs = _inputs(rng, hkv, DECODE_CTX, int8)
        q = _bf16(rng, (len(DECODE_CTX), hq, D))
        ctx = torch.tensor(DECODE_CTX, dtype=torch.int32)
        want = ref.paged_decode_attention_ref(q, k, v, tables, ctx,
                                              k_scales=ks, v_scales=vs)

        def run(n):
            return decode_emulated(q, k, v, ks, vs, tables, ctx, scale,
                                   drop=n)
    else:
        q_offset, chunk_len = CHUNKS[2]
        ctx_len = q_offset + chunk_len
        tables, k, v, ks, vs = _inputs(rng, hkv, [ctx_len], int8)
        q = _bf16(rng, (hq, C, D))
        want = ref.paged_prefill_attention_ref(
            q, k, v, tables[0], q_offset, ctx_len, k_scales=ks,
            v_scales=vs)[:, :chunk_len]

        def run(n):
            return prefill_emulated(q, k, v, ks, vs, tables[0], q_offset,
                                    ctx_len, scale, drop=n)[:, :chunk_len]
    assert _row_use(run(0), want, CARD_RTOL[kind]) <= 1.0
    assert _row_use(run(drop), want, CARD_RTOL[kind]) > 2.0
