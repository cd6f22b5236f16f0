"""The hand-written kernels against their plain versions on the card.

Marked ``cuda``: without a CUDA device every test skips. On a machine
with one (no JAX needed — this file imports only the port):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 attention 1e-5 (both sides compute in float32, in
different orders; 2e-5 for flash gradients, sums over many rows);
bfloat16 paged attention 2e-2 at the serving shapes; at 4096 keys and
at the TMA-fed kernels' other shapes, against the float32 plain version,
each output row within 2^-8 of its largest magnitude + 1e-5 for decode
(one bfloat16 rounding of a float32 result: half an ulp) and for the
batched verify (which carries P in two bf16 parts), 2^-7 for prefill
(whose wgmma route at head_dim 64 rounds P to bfloat16 once; at 128 it
splits P as the verify does), and all within 2e-2; the
verify's bf16 rows within one bf16 ulp of the decode kernel's at the
same positions; on the route ``ops.paged_route`` names, bitwise
repeatable;
bfloat16 flash outputs one bfloat16 ulp at the largest magnitude (2^-7 of
it), on the tensor-core routes (head_dim 64, wgmma; head_dim 128,
wgmma128) as on the SIMT one,
and float32 at head_dim 64 on the 3xTF32 route (tf32x3) at the float32
limits, whose route counts each test checks; the quantizer, the dequantizer and
the fused int8 K/V append bitwise (the append outside the null block);
the decode kernels' fused append-and-decode bitwise the separate append
and decode, in pools and output;
the flash backward and the wgmma mLSTM bitwise equal across runs (no
atomics); the mLSTM kernels' (wgmma and SIMT) float32 h within 5e-5 of
its largest magnitude (den = |n.q| can cancel and magnify the order of
the sums) and their state within 1e-5, bf16 h one bf16 ulp there, and
the two kernels within twice those of each other; the mLSTM backward's
gradients, on both its routes (3xTF32 wgmma and SIMT), within 1e-4 of
each one's largest magnitude of the plain backward's on the same saved
states, bitwise repeatable, and a checkpointed layer's gradients within
1e-4 of the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged(rng, dev, dtype, hkv, bs, d, ctx_list):
    need = [-(-c // bs) for c in ctx_list]
    nb = 2 + sum(need)
    tables = np.zeros((len(ctx_list), max(need) + 1), np.int32)
    phys, i = rng.permutation(np.arange(1, nb)), 0
    for lane, n in enumerate(need):
        tables[lane, :n] = phys[i:i + n]
        i += n
    shape = (hkv, nb, bs, d)
    if dtype == torch.int8:
        k = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        v = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        ks = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        vs = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        ks[:, 0] = vs[:, 0] = float("nan")      # poisoned null block
        pools = (k, v, ks, vs)
    else:
        k = torch.tensor(rng.standard_normal(shape), dtype=dtype)
        v = torch.tensor(rng.standard_normal(shape), dtype=dtype)
        k[:, 0] = v[:, 0] = float("nan")
        pools = (k, v, None, None)
    return (torch.tensor(tables, device=dev),
            *[None if t is None else t.to(dev) for t in pools])


CASES = [(torch.float32, torch.float32, 1e-5),
         (torch.bfloat16, torch.bfloat16, 2e-2),
         (torch.float32, torch.int8, 1e-5),
         (torch.bfloat16, torch.int8, 2e-2)]
IDS = ["f32", "bf16", "f32-int8", "bf16-int8"]


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", CASES, ids=IDS)
@pytest.mark.parametrize("hq,hkv,d,bs", [(16, 8, 64, 16), (4, 4, 32, 8)],
                         ids=["flad-gqa2", "mha"])
def test_paged_decode_kernel(dev, q_dtype, kv_dtype, atol, hq, hkv, d, bs):
    rng = np.random.default_rng(0)
    ctx_list = [0, 1, bs, 3 * bs + 5, 0, 200]
    tables, k, v, ks, vs = _paged(rng, dev, kv_dtype, hkv, bs, d, ctx_list)
    q = torch.tensor(rng.standard_normal((len(ctx_list), hq, d)),
                     dtype=q_dtype, device=dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    n = ops.paged_decode_attention.launches
    routes = ops.route_counts()["paged_decode_attention"]
    route = ops.paged_route("decode", q_dtype, kv_dtype, d, bs)
    got = ops.paged_decode_attention(q, k, v, tables, ctx, k_scales=ks,
                                     v_scales=vs)
    want = ref.paged_decode_attention_ref(q, k, v, tables, ctx, k_scales=ks,
                                          v_scales=vs)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == n + 1
    assert ops.route_counts()["paged_decode_attention"] == {
        **routes, route: routes[route] + 1}
    assert torch.isfinite(got).all() and not got[ctx == 0].any()
    assert float((got.float() - want.float()).abs().max()) <= atol


#: (Hq, Hkv, head dim) of the prefill card tests: flad-adllm's heads,
#: and the dense configs' at head_dim 128: groups 5 (qwen3-14b's 40/8), 7
#: (yi-34b's 56/8) and 8 (qwen3-32b's 64/8), 80-128 rows of a 16-row chunk
#: a KV head, one 128-row tile of the wgmma128 route
PREFILL_HEADS = {"flad-gqa2": (16, 8, 64), "g5-d128": (40, 8, 128),
                 "g7-d128": (56, 8, 128), "g8-d128": (64, 8, 128)}


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", CASES, ids=IDS)
@pytest.mark.parametrize("q_offset,chunk_len", [(0, 16), (48, 16), (96, 5)],
                         ids=["first", "middle", "partial-last"])
@pytest.mark.parametrize("heads", PREFILL_HEADS)
def test_paged_prefill_kernel(dev, q_dtype, kv_dtype, atol, q_offset,
                              chunk_len, heads):
    rng = np.random.default_rng(1)
    (hq, hkv, d), bs, c = PREFILL_HEADS[heads], 16, 16
    tables, k, v, ks, vs = _paged(rng, dev, kv_dtype, hkv, bs, d, [101])
    q = torch.tensor(rng.standard_normal((hq, c, d)), dtype=q_dtype,
                     device=dev)
    args = (q, k, v, tables[0], q_offset, q_offset + chunk_len)
    routes = ops.route_counts()["paged_prefill_attention"]
    route = ops.paged_route("prefill", q_dtype, kv_dtype, d, bs)
    got = ops.paged_prefill_attention(*args, k_scales=ks, v_scales=vs)
    want = ref.paged_prefill_attention_ref(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert ops.route_counts()["paged_prefill_attention"] == {
        **routes, route: routes[route] + 1}
    assert torch.isfinite(got).all()
    err = (got[:, :chunk_len].float() - want[:, :chunk_len].float()).abs()
    assert float(err.max()) <= atol


#: each output row of a bf16 paged kernel vs the float32 plain version:
#: within this share of the row's largest |value| + PAGED_ROW_ATOL
PAGED_RTOL = {"decode": 2.0 ** -8, "prefill": 2.0 ** -7}
PAGED_ROW_ATOL = 1e-5


def _rows_within(got, want, rtol):
    """Each row (last axis) of ``got`` within ``rtol`` of the float32
    ``want`` row's largest |value| + PAGED_ROW_ATOL, all within 2e-2."""
    err = (got.float() - want).abs()
    tol = rtol * want.abs().amax(-1, keepdim=True) + PAGED_ROW_ATOL
    assert bool((err <= tol).all()), float((err / tol).max())
    assert float(err.max()) <= 2e-2


#: 4096 keys (a flad-adllm context the paged engine takes): ctx 0, 1, 16,
#: 4095, 4096, and lanes ending on and just past a split boundary of the
#: TMA-fed kernels (from the split plan of 8 lanes x 8 KV heads)
KV = {"bf16": torch.bfloat16, "int8": torch.int8}


def _long_ctx(lanes=8, hkv=8):
    per = ops.paged_splits(4096, lanes * hkv)[1]
    return [0, 1, 16, 4095, 4096, per, 2 * per, per + 1]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_4096_keys(dev, kv, d):
    """bf16 q at 4096 keys on the route ``ops.paged_route`` names (head
    dim 64: the TMA-fed kernel, "tma"; 128: its own, "tma128"; 32: the
    SIMT one), each row within PAGED_RTOL of the float32 plain version,
    ctx-0 lanes exactly 0, two calls bitwise equal."""
    rng = np.random.default_rng(5)
    hq, hkv, bs = 16, 8, 16
    ctx_list = _long_ctx()
    tables, k, v, ks, vs = _paged(rng, dev, KV[kv], hkv, bs, d, ctx_list)
    q = torch.tensor(rng.standard_normal((len(ctx_list), hq, d)),
                     dtype=torch.bfloat16, device=dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    route = ops.paged_route("decode", q.dtype, KV[kv], d, bs)
    assert route == {64: "tma", 128: "tma128"}.get(d, "simt")
    routes = ops.route_counts()["paged_decode_attention"]
    kw = dict(k_scales=ks, v_scales=vs)
    got = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    again = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, ctx, **kw)
    torch.cuda.synchronize()
    assert ops.route_counts()["paged_decode_attention"] == {
        **routes, route: routes[route] + 2}
    assert torch.equal(got, again)
    assert torch.isfinite(got).all() and not got[ctx == 0].any()
    _rows_within(got, want, PAGED_RTOL["decode"])


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("d,hq", [(32, 16), (64, 16), (128, 16), (128, 40),
                                  (128, 56), (128, 64)])
def test_paged_prefill_4096_keys(dev, kv, d, hq):
    """A 16-row chunk ending at 4096 keys and a partial one, bf16 q, on
    the route ``ops.paged_route`` names (head dim 64 "wgmma", 128
    "wgmma128", also at the dense configs' groups 5, 7 and 8; 32 the SIMT
    kernel), each row below chunk_len within PAGED_RTOL of the float32
    plain version, two calls bitwise equal."""
    rng = np.random.default_rng(6)
    hkv, bs, c = 8, 16, 16
    tables, k, v, ks, vs = _paged(rng, dev, KV[kv], hkv, bs, d, [4096])
    route = ops.paged_route("prefill", torch.bfloat16, KV[kv], d, bs)
    assert route == {64: "wgmma", 128: "wgmma128"}.get(d, "simt")
    kw = dict(k_scales=ks, v_scales=vs)
    for q_offset, chunk_len in ((4080, 16), (4088, 5)):
        q = torch.tensor(rng.standard_normal((hq, c, d)),
                         dtype=torch.bfloat16, device=dev)
        args = (q, k, v, tables[0], q_offset, q_offset + chunk_len)
        routes = ops.route_counts()["paged_prefill_attention"]
        got = ops.paged_prefill_attention(*args, **kw)
        again = ops.paged_prefill_attention(*args, **kw)
        want = ref.paged_prefill_attention_ref(q.float(), *args[1:], **kw)
        torch.cuda.synchronize()
        assert ops.route_counts()["paged_prefill_attention"] == {
            **routes, route: routes[route] + 2}
        assert torch.equal(got, again)
        assert torch.isfinite(got).all()
        _rows_within(got[:, :chunk_len], want[:, :chunk_len],
                     PAGED_RTOL["prefill"])


#: (Hq, Hkv, block size) of the TMA-fed kernels beyond the serving shape:
#: GQA groups 1, 4 and 8 (prefill's group 8 is 128 rows: two row tiles)
#: and block sizes 8, 32 and 64 (int8 takes 16 and up)
TMA_SHAPES = {"g1": (8, 8, 16), "g4": (16, 4, 16), "g8": (16, 2, 16),
              "bs8": (16, 8, 8), "bs32": (16, 8, 32), "bs64": (16, 8, 64)}


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("shape", TMA_SHAPES)
def test_paged_tma_routes_at_other_groups_and_blocks(dev, kv, shape):
    """Decode and prefill of bf16 q at head dim 64 over other GQA groups
    and block sizes, on the route ``ops.paged_route`` names, each row
    within PAGED_RTOL of the float32 plain versions, ctx-0 lanes exactly
    0, contexts that split."""
    hq, hkv, bs = TMA_SHAPES[shape]
    rng = np.random.default_rng(8)
    ctx_list = [0, 1, bs, 700, 385, 2000]
    tables, k, v, ks, vs = _paged(rng, dev, KV[kv], hkv, bs, 64, ctx_list)
    q = torch.tensor(rng.standard_normal((len(ctx_list), hq, 64)),
                     dtype=torch.bfloat16, device=dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    kw = dict(k_scales=ks, v_scales=vs)
    routes = ops.route_counts()
    got = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, ctx, **kw)
    qc = torch.tensor(rng.standard_normal((hq, 16, 64)),
                      dtype=torch.bfloat16, device=dev)
    pre = ops.paged_prefill_attention(qc, k, v, tables[5], 1990, 2000, **kw)
    pwant = ref.paged_prefill_attention_ref(qc.float(), k, v, tables[5],
                                            1990, 2000, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, kind in (("paged_decode_attention", "decode"),
                       ("paged_prefill_attention", "prefill")):
        route = ops.paged_route(kind, torch.bfloat16, KV[kv], 64, bs)
        assert route == ("simt" if kv == "int8" and bs == 8
                         else ops.PAGED_ROUTES[kind])
        assert after[name] == {**routes[name], route: routes[name][route] + 1}
    assert torch.isfinite(got).all() and not got[ctx == 0].any()
    _rows_within(got, want, PAGED_RTOL["decode"])
    assert torch.isfinite(pre).all()
    _rows_within(pre[:, :10], pwant[:, :10], PAGED_RTOL["prefill"])


#: (Hq, Hkv, block size) of the head_dim-128 decode kernel: the dense
#: configs' groups 5 (qwen3-14b's 40/8), 7 (yi-34b's 56/8) and 8
#: (qwen3-32b's 64/8) at their block 16, a group of 1, and block sizes 8
#: (bf16 only), 32 and 64
D128_DECODE = {"g5": (40, 8, 16), "g7": (56, 8, 16), "g8": (64, 8, 16),
               "g1": (4, 4, 16), "g5-bs8": (5, 1, 8), "g5-bs32": (5, 1, 32),
               "g5-bs64": (10, 2, 64)}
#: ctx 0, one key, a lane ending exactly on a split boundary of the
#: 384-key plan, one key past it, two splits and a ragged third
D128_DECODE_CTX = [0, 1, 16, 383, 384, 385, 768, 1000]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("shape", D128_DECODE)
def test_paged_decode_d128_at_split_edges(dev, kv, shape):
    """bf16 q at head_dim 128 over bf16 or int8 pools with the null
    block NaN-poisoned behind every dead table slot: on the route
    ``ops.paged_route`` names ("tma128"; int8 at block 8 "simt"), the
    keys split in 384-key runs, each row within PAGED_RTOL of the
    float32 plain version, ctx-0 lanes exactly 0, two calls bitwise
    equal; the SIMT kernel on the same inputs (``route="simt"``, as
    chip_smoke.py times it) within the same bound."""
    hq, hkv, bs = D128_DECODE[shape]
    rng = np.random.default_rng(9)
    ctx_list = D128_DECODE_CTX
    tables, k, v, ks, vs = _paged(rng, dev, KV[kv], hkv, bs, 128, ctx_list)
    assert ops.paged_splits(tables.shape[1] * bs,
                            len(ctx_list) * hkv)[1] == 384
    q = torch.tensor(rng.standard_normal((len(ctx_list), hq, 128)),
                     dtype=torch.bfloat16, device=dev)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    route = ops.paged_route("decode", q.dtype, KV[kv], 128, bs)
    assert route == ("simt" if kv == "int8" and bs == 8 else "tma128")
    kw = dict(k_scales=ks, v_scales=vs)
    routes = ops.route_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    again = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    simt = ops._paged_decode(q, k, v, tables, ctx, scale=128 ** -0.5,
                             route="simt", **kw)
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, ctx, **kw)
    torch.cuda.synchronize()
    grew = {r: n - routes[r] for r, n in
            ops.route_counts()["paged_decode_attention"].items()}
    want_grew = {**dict.fromkeys(grew, 0), "simt": 1}
    want_grew[route] += 2
    assert grew == want_grew
    assert torch.equal(got, again)
    for out in (got, simt):
        assert torch.isfinite(out).all() and not out[ctx == 0].any()
        _rows_within(out, want, PAGED_RTOL["decode"])


#: (Hq, Hkv, block size) of the head_dim-128 prefill kernel: the dense
#: configs' groups 5, 7 and 8 at block 16, and block sizes 8 (bf16 only),
#: 32 and 64
D128_PREFILL = {"g5": (40, 8, 16), "g7": (56, 8, 16), "g8": (64, 8, 16),
                "g5-bs8": (5, 1, 8), "g5-bs32": (5, 1, 32),
                "g5-bs64": (10, 2, 64)}
#: (q_offset, chunk_len): chunks ending at the most keys one CTA takes
#: (256) and one past them, exactly on a split boundary (384 keys), one key
#: past it, and on another at 768
D128_PREFILL_CHUNKS = [(240, 16), (241, 16), (368, 16), (369, 16), (760, 8)]


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("shape", D128_PREFILL)
def test_paged_prefill_d128_at_split_edges(dev, kv, shape):
    """bf16 q at head_dim 128 over bf16 or int8 pools with the null block
    NaN-poisoned behind every dead table slot: chunks whose contexts end
    at 256 keys (one CTA), 257, 384, 385 and 768 (split in 64-key tiles:
    ``ops.prefill_splits``), on the route
    ``ops.paged_route`` names ("wgmma128"; int8 at block 8 "simt"), each
    live row within PAGED_RTOL of the float32 plain version, two calls
    bitwise equal; the SIMT kernel on the same inputs (``route="simt"``,
    as chip_smoke.py times it) within the same bound."""
    hq, hkv, bs = D128_PREFILL[shape]
    rng = np.random.default_rng(10)
    tables, k, v, ks, vs = _paged(rng, dev, KV[kv], hkv, bs, 128, [768])
    route = ops.paged_route("prefill", torch.bfloat16, KV[kv], 128, bs)
    assert route == ("simt" if kv == "int8" and bs == 8 else "wgmma128")
    kw = dict(k_scales=ks, v_scales=vs)
    for q_offset, chunk_len in D128_PREFILL_CHUNKS:
        ctx_len = q_offset + chunk_len
        q = torch.tensor(rng.standard_normal((hq, 16, 128)),
                         dtype=torch.bfloat16, device=dev)
        args = (q, k, v, tables[0], q_offset, ctx_len)
        routes = ops.route_counts()["paged_prefill_attention"]
        got = ops.paged_prefill_attention(*args, **kw)
        again = ops.paged_prefill_attention(*args, **kw)
        simt = ops._paged_prefill(*args, scale=128 ** -0.5, route="simt",
                                  **kw)
        want = ref.paged_prefill_attention_ref(q.float(), *args[1:], **kw)
        torch.cuda.synchronize()
        grew = {r: n - routes[r] for r, n in
                ops.route_counts()["paged_prefill_attention"].items()}
        want_grew = {**dict.fromkeys(grew, 0), "simt": 1}
        want_grew[route] += 2
        assert grew == want_grew
        assert torch.equal(got, again)
        for out in (got, simt):
            assert torch.isfinite(out).all()
            _rows_within(out[:, :chunk_len], want[:, :chunk_len],
                         PAGED_RTOL["prefill"])


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_float32_q_takes_the_simt_route(dev, kv):
    """float32 q (the float32 oracle's path) launches the SIMT kernels
    at head dim 64 and block 16, within 1e-5 of the plain versions."""
    rng = np.random.default_rng(7)
    kv_dtype = torch.float32 if kv == "f32" else torch.int8
    tables, k, v, ks, vs = _paged(rng, dev, kv_dtype, 8, 16, 64,
                                  [300, 0, 17])
    q = torch.tensor(rng.standard_normal((3, 16, 64)), dtype=torch.float32,
                     device=dev)
    ctx = torch.tensor([300, 0, 17], dtype=torch.int32, device=dev)
    kw = dict(k_scales=ks, v_scales=vs)
    before = ops.route_counts()
    got = ops.paged_decode_attention(q, k, v, tables, ctx, **kw)
    qc = torch.tensor(rng.standard_normal((16, 16, 64)), dtype=torch.float32,
                      device=dev)
    pre = ops.paged_prefill_attention(qc, k, v, tables[0], 288, 300, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        assert after[name] == {**before[name],
                               "simt": before[name]["simt"] + 1}
    want = ref.paged_decode_attention_ref(q, k, v, tables, ctx, **kw)
    pwant = ref.paged_prefill_attention_ref(qc, k, v, tables[0], 288, 300,
                                            **kw)
    assert float((got - want).abs().max()) <= 1e-5
    assert float((pre[:, :12] - pwant[:, :12]).abs().max()) <= 1e-5


@pytest.mark.parametrize("pinned", [False, True], ids=["random", "pinned"])
def test_quantize_kernel_bitwise(dev, pinned):
    rng = np.random.default_rng(2)
    m = 1000
    x = torch.tensor(rng.standard_normal((m, ops.LANES))
                     * rng.uniform(1e-3, 1e3, (m, 1)), dtype=torch.float32)
    x[3] = 0.0
    x[5, 64:] = 0.0
    if pinned:
        bits = np.full((m, ops.LANES), 1 << 31, np.uint32)
    else:
        bits = rng.integers(0, 2 ** 32, (m, ops.LANES),
                            dtype=np.uint64).astype(np.uint32)
    x = x.to(dev)
    bits = torch.from_numpy(bits.view(np.int32)).to(dev).view(torch.uint32)
    q, s = ops.quantize_int8(x, bits)
    qr, sr = ref.quantize_int8_ref(x, bits)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(s[3]) == 0.0 and not q[3].any()


FLASH_CASES = {"causal": (128, 128, {}), "ragged": (100, 100, {}),
               "offset": (96, 160, {"q_offset": 64}),
               "window": (128, 128, {"window": 40}),
               "full": (64, 80, {"causal": False})}


def _flash(dev, dtype, sq, skv, seed=0, b=2, hq=4, hkv=2, d=64):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rand(b, hq, sq, d), rand(b, hkv, skv, d), rand(b, hkv, skv, d),
            rand(b, hq, sq, d))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_match_plain(dev, dtype, case):
    sq, skv, kw = FLASH_CASES[case]
    q, k, v, do = _flash(dev, dtype, sq, skv)
    before, routes = ops.launch_counts(), ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    after = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_preprocess",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    # float32 at head_dim 64: the forward, dK/dV and dQ on 3xTF32 wgmma
    # (tf32x3)
    want = ({"fwd": "wgmma", "dkv": "wgmma", "dq": "wgmma"}
            if dtype == torch.bfloat16 else
            {"fwd": "tf32x3", "dkv": "tf32x3", "dq": "tf32x3"})
    for name, kind in (("flash_attention", "fwd"),
                       ("flash_attention_bwd_dkv", "dkv"),
                       ("flash_attention_bwd_dq", "dq")):
        route = want[kind]
        assert ops.route_counts()[name][route] == routes[name][route] + 1
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    sc = q.shape[-1] ** -0.5
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=sc, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale=sc,
                                         **kw)
    rdelta = ref.flash_attention_bwd_preprocess_ref(o, do)
    torch.cuda.synchronize()
    for label, got, want in (("o", o, ro), ("lse", lse, rlse),
                             ("delta", delta, rdelta), ("dk", dk, rdk),
                             ("dv", dv, rdv), ("dq", dq, rdq)):
        assert torch.isfinite(got).all(), label
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32:
            tol = 2e-5 if label in ("dk", "dv", "dq") else 1e-5
        elif label in ("lse", "delta"):
            tol = 1e-5 * max(1.0, float(want.abs().max()))
        else:
            tol = 2.0 ** -7 * float(want.float().abs().max())
        assert err <= tol, (label, err, tol)


def _flash_close(label, got, want, dtype):
    """The flash limits: float32 1e-5 (2e-5 for gradients); bf16 outputs
    one bf16 ulp of the largest magnitude, float32 statistics 1e-5 of
    theirs."""
    assert torch.isfinite(got).all(), label
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        tol = 2e-5 if label in ("dk", "dv", "dq") else 1e-5
    elif label in ("lse", "delta"):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
    else:
        tol = 2.0 ** -7 * float(want.float().abs().max())
    assert err <= tol, (label, err, tol)


#: (Sq, Skv, mask options, Hq, Hkv): the tensor-core kernels at their tile
#: edges: one query row (seeing 77 keys), Sq and Skv no multiples of 64 or
#: 128, GQA groups of 1, 3 and 4, the distillation path's 1032 rows, no
#: causal mask
TC_EDGES = {"sq1": (1, 77, {"q_offset": 76}, 4, 2),
            "ragged-offset": (100, 130, {"q_offset": 30}, 4, 2),
            "g1": (200, 200, {}, 2, 2),
            "g3-window": (300, 300, {"window": 40}, 6, 2),
            "g4": (150, 150, {}, 8, 2),
            "distill-1032": (1032, 1032, {}, 2, 1),
            "full": (70, 90, {"causal": False}, 4, 2)}


@pytest.mark.parametrize("case", TC_EDGES)
def test_flash_tensor_core_route_at_tile_edges(dev, case):
    """bf16 at head_dim 64 launches the wgmma forward, dK/dV and dQ
    kernels (their route counts move, the SIMT ones do not), within the
    bf16 limits of the plain versions, dK/dV bitwise repeatable."""
    sq, skv, kw, hq, hkv = TC_EDGES[case]
    q, k, v, do = _flash(dev, torch.bfloat16, sq, skv, seed=3, b=1, hq=hq,
                         hkv=hkv)
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, n in (("flash_attention", 1), ("flash_attention_bwd_dkv", 2),
                    ("flash_attention_bwd_dq", 1)):
        assert after[name] == {**before[name],
                               "wgmma": before[name]["wgmma"] + n}, name
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=64 ** -0.5, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         scale=64 ** -0.5, **kw)
    for label, got, want in (("o", o, ro), ("lse", lse, rlse),
                             ("dk", dk, rdk), ("dv", dv, rdv),
                             ("dq", dq, rdq)):
        _flash_close(label, got, want, torch.bfloat16)


#: the encoder-decoder's flash layout (seamless-m4t-large-v2: a GQA
#: group of 1, 16/16 heads of 64): B 4 at its training length and a
#: ragged frame count, without and with a causal mask
ENCDEC_S = [512, 500]


@pytest.mark.parametrize("causal", [False, True],
                         ids=["non-causal", "causal"])
@pytest.mark.parametrize("s", ENCDEC_S)
def test_flash_group_1_matches_plain(dev, s, causal):
    """bf16 at the group of 1: the forward, preprocess, dK/dV and dQ on
    their routes (wgmma; the preprocess on vec), within the bf16 limits
    of the plain versions, the backward bitwise repeatable."""
    q, k, v, do = _flash(dev, torch.bfloat16, s, s, seed=21, b=4, hq=16,
                         hkv=16)
    kw = {"causal": causal}
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, route, n in (("flash_attention", "wgmma", 1),
                           ("flash_attention_bwd_preprocess", "vec", 2),
                           ("flash_attention_bwd_dkv", "wgmma", 2),
                           ("flash_attention_bwd_dq", "wgmma", 2)):
        assert after[name] == {**before[name],
                               route: before[name][route] + n}, name
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
    sc = 64 ** -0.5
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=sc, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale=sc,
                                         **kw)
    for label, got, want in (
            ("o", o, ro), ("lse", lse, rlse),
            ("delta", delta, ref.flash_attention_bwd_preprocess_ref(o, do)),
            ("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq)):
        _flash_close(label, got, want, torch.bfloat16)


def test_encdec_serving_launches_the_flash_forward_only(dev):
    """An encoder-decoder (bf16, 2 + 2 layers, 4/4 heads of 64) served by
    the legacy scheduler: each prefill's encoder one flash forward a
    layer on wgmma, non-causal; the decoder's self- and cross-attention
    plain over the contiguous cache, so no other kernel launches; finite
    logits and token ids within the vocabulary."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("seamless-m4t-large-v2")).replace(
        enc_layers=2, dec_layers=2, num_layers=4, num_heads=4,
        num_kv_heads=4, head_dim=64, d_model=256, param_dtype="bfloat16")
    ops.reset_launch_counts()
    rep = Session(cfg=cfg, device=dev, seed=5).serve(
        scheduler="legacy", batch=2, context=64, decode_steps=4,
        requests=2, log_fn=None)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = cfg.enc_layers * 2
    assert counts == want
    routes = ops.route_counts()["flash_attention"]
    assert routes == {**dict.fromkeys(routes, 0),
                      "wgmma": want["flash_attention"]}
    assert torch.isfinite(rep["last_logits"]).all()
    for seqs in rep["sequences"]:
        assert seqs.shape == (2, 5)
        assert 0 <= int(seqs.min()) and int(seqs.max()) < cfg.vocab_size


@pytest.mark.parametrize("d", [32, 128])
def test_flash_bf16_at_other_head_dims_takes_the_simt_route(dev, d):
    """bf16 away from head_dim 64: at 32 the forward, dK/dV and dQ launch
    the SIMT kernels; at 128 their own tensor-core kernels (route
    wgmma128); each counted on its route."""
    q, k, v, do = _flash(dev, torch.bfloat16, 96, 96, seed=4, d=d)
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, kind in (("flash_attention", "fwd"),
                       ("flash_attention_bwd_dkv", "dkv"),
                       ("flash_attention_bwd_dq", "dq")):
        route = "wgmma128" if d == 128 else "simt"
        assert ops.flash_route(kind, torch.bfloat16, d) == route
        assert after[name] == {**before[name],
                               route: before[name][route] + 1}, name
    ro = ref.flash_attention_ref(q, k, v)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=d ** -0.5)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         scale=d ** -0.5)
    for label, got, want in (("o", o, ro), ("dk", dk, rdk), ("dv", dv, rdv),
                             ("dq", dq, rdq)):
        _flash_close(label, got, want, torch.bfloat16)


#: (Sq, Skv, mask options, Hq, Hkv): the head_dim-128 tensor-core
#: kernels at GQA groups of 1, 5 (qwen3-14b's 40/8), 7 (yi-34b's 56/8) and
#: 8 (qwen3-32b's 64/8) and at their tile edges: one query row, Sq and Skv
#: no multiples of 64, an odd number of query tiles (a pair with one
#: tile), Sq < Skv with an offset, a window, no causal mask, rows that see
#: no key; and dQ's: a window under an offset whose two query tiles walk
#: different 64-key tiles (each passes some of the other's), Skv one past
#: a 64-key tile, and more pairs than SMs (the persistent grid's rounds)
TC128_EDGES = {"g1-ragged": (200, 200, {}, 2, 2),
               "g5-causal": (256, 256, {}, 5, 1),
               "g5-sq1": (1, 77, {"q_offset": 76}, 5, 1),
               "g5-ragged-offset": (100, 130, {"q_offset": 30}, 5, 1),
               "g7-window": (300, 300, {"window": 40}, 7, 1),
               "g8-full": (70, 90, {"causal": False}, 8, 1),
               "g8-odd-pairs": (323, 323, {}, 16, 2),
               "g5-no-key": (64, 64, {"window": 8, "q_offset": 60}, 5, 1),
               "g5-window-offset": (130, 450, {"window": 100,
                                               "q_offset": 320}, 5, 1),
               "g5-skv-65": (65, 65, {}, 5, 1),
               "g5-rounds": (1024, 1024, {}, 40, 8)}


@pytest.mark.parametrize("case", TC128_EDGES)
def test_flash_d128_tensor_core_route_at_tile_edges(dev, case):
    """bf16 at head_dim 128 launches the wgmma128 forward, dK/dV and dQ
    kernels (their route counts move, no other does), within the bf16
    limits of the plain versions; dK/dV and dQ bitwise repeatable. Holds
    the forward's and dQ's pairs of query tiles, the m64n128 P V and
    dS K whose descriptors step from one column half to the other, and
    the dK/dV's two partial sums at every edge of ``TC128_EDGES``."""
    sq, skv, kw, hq, hkv = TC128_EDGES[case]
    q, k, v, do = _flash(dev, torch.bfloat16, sq, skv, seed=12, b=1, hq=hq,
                         hkv=hkv, d=128)
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq_again = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, route, n in (("flash_attention", "wgmma128", 1),
                           ("flash_attention_bwd_dkv", "wgmma128", 2),
                           ("flash_attention_bwd_dq", "wgmma128", 2)):
        assert after[name] == {**before[name],
                               route: before[name][route] + n}, name
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    assert torch.equal(dq, dq_again)
    sc = 128 ** -0.5
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=sc, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale=sc,
                                         **kw)
    for label, got, want in (("o", o, ro), ("lse", lse, rlse),
                             ("dk", dk, rdk), ("dv", dv, rdv),
                             ("dq", dq, rdq)):
        _flash_close(label, got, want, torch.bfloat16)


@pytest.mark.parametrize("hq", [40, 56, 64])
def test_flash_d128_dkv_is_bitwise_repeatable(dev, hq):
    """The head_dim-128 dK/dV adds its two warpgroups' partial sums in a
    fixed order with no atomics: two runs equal bit for bit at the dense
    configs' head layouts (40, 56 or 64 query heads over 8), causal, and
    within the bf16 limits of the plain version; the SIMT kernel on the
    same inputs (``route="simt"``, as chip_smoke.py times it) too."""
    q, k, v, do = _flash(dev, torch.bfloat16, 384, 384, seed=13, b=1, hq=hq,
                         hkv=8, d=128)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    kw = dict(scale=128 ** -0.5, causal=True, window=None, q_offset=0)
    first = ops._flash_dkv_card(q, k, v, do, lse, delta, **kw)
    second = ops._flash_dkv_card(q, k, v, do, lse, delta, **kw)
    simt = ops._flash_dkv_card(q, k, v, do, lse, delta, route="simt", **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               **kw)
    for got in (first, simt):
        _flash_close("dk", got[0], rdk, torch.bfloat16)
        _flash_close("dv", got[1], rdv, torch.bfloat16)


@pytest.mark.parametrize("hq", [40, 56, 64])
def test_flash_d128_dq_is_bitwise_repeatable(dev, hq):
    """The head_dim-128 dQ sums each warpgroup's key tiles in a fixed
    order with no atomics: two runs equal bit for bit at the dense
    configs' head layouts (40, 56 or 64 query heads over 8), causal, and
    within the bf16 limits of the plain version; the SIMT kernel on the
    same inputs (``route="simt"``, as chip_smoke.py times it) too."""
    q, k, v, do = _flash(dev, torch.bfloat16, 384, 384, seed=14, b=1, hq=hq,
                         hkv=8, d=128)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    kw = dict(scale=128 ** -0.5, causal=True, window=None, q_offset=0)
    first = ops._flash_dq_card(q, k, v, do, lse, delta, **kw)
    second = ops._flash_dq_card(q, k, v, do, lse, delta, **kw)
    simt = ops._flash_dq_card(q, k, v, do, lse, delta, route="simt", **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    for got in (first, simt):
        _flash_close("dq", got, rdq, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_tensor_core_route_needs_aligned_inputs(dev, dtype):
    """TMA (bf16) and cp.async (float32, 3xTF32) read 16 bytes at a time
    from the bases: a contiguous tensor one element off raises, and
    nothing is launched."""
    n = 2 * 4 * 64 * 64
    q = torch.zeros(n + 1, dtype=dtype, device=dev)[1:].view(
        1, 4, 64 * 2, 64)
    k = torch.zeros((1, 2, 128, 64), dtype=dtype, device=dev)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, k, k)
    assert ops.launch_counts() == before


def test_flash_backward_is_bitwise_repeatable(dev):
    """dQ, dK and dV equal bit for bit across two runs; bf16 at head_dim
    64, so dK/dV and dQ both run their wgmma kernels."""
    q, k, v, do = _flash(dev, torch.bfloat16, 200, 200, seed=1)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    before = ops.route_counts()
    first = ops.flash_attention_bwd(q, k, v, o, lse, do)
    second = ops.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert after[name]["wgmma"] == before[name]["wgmma"] + 2, name
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", TC_EDGES)
def test_flash_tf32_route_at_tile_edges(dev, case):
    """float32 at head_dim 64 launches the 3xTF32 forward, dK/dV and dQ
    kernels (route tf32x3), at the tile edges of ``TC_EDGES`` (one row,
    ragged Sq and Skv, Sq < Skv with an offset, a window, GQA groups of 1
    to 4), within the float32 limits of the plain versions; dK/dV and dQ
    bitwise repeatable."""
    sq, skv, kw, hq, hkv = TC_EDGES[case]
    q, k, v, do = _flash(dev, torch.float32, sq, skv, seed=5, b=1, hq=hq,
                         hkv=hkv)
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq_again = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, route, n in (("flash_attention", "tf32x3", 1),
                           ("flash_attention_bwd_dkv", "tf32x3", 2),
                           ("flash_attention_bwd_dq", "tf32x3", 2)):
        assert after[name] == {**before[name],
                               route: before[name][route] + n}, name
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    assert torch.equal(dq, dq_again)
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=64 ** -0.5, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         scale=64 ** -0.5, **kw)
    for label, got, want in (("o", o, ro), ("lse", lse, rlse),
                             ("dk", dk, rdk), ("dv", dv, rdv),
                             ("dq", dq, rdq)):
        _flash_close(label, got, want, torch.float32)


@pytest.mark.parametrize("d", [32, 128])
def test_flash_f32_at_other_head_dims_takes_the_simt_route(dev, d):
    """The 3xTF32 kernels take head_dim 64 only: float32 at 32 and 128
    launches the SIMT forward, dK/dV and dQ."""
    q, k, v, do = _flash(dev, torch.float32, 96, 96, seed=6, d=d)
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert after[name] == {**before[name],
                               "simt": before[name]["simt"] + 1}
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=d ** -0.5)
    for label, got, want in (("o", o, ref.flash_attention_ref(q, k, v)),
                             ("dk", dk, rdk), ("dv", dv, rdv)):
        _flash_close(label, got, want, torch.float32)


def test_flash_tf32_dkv_is_bitwise_repeatable(dev):
    """The 3xTF32 dK/dV walks heads and tiles in a fixed order with no
    atomics: two runs equal bit for bit, at a causal GQA shape."""
    q, k, v, do = _flash(dev, torch.float32, 300, 300, seed=7)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    before = ops.route_counts()["flash_attention_bwd_dkv"]["tf32x3"]
    first = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    second = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert (ops.route_counts()["flash_attention_bwd_dkv"]["tf32x3"]
            == before + 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_f32_simt_dq_still_matches_plain(dev):
    """The SIMT dQ that the 3xTF32 one replaced at head_dim 64 stays
    reachable (``_flash_dq_card(route="simt")``, how chip_smoke.py times
    it beside the new one): within the float32 limit of the plain
    version, counted on its own route, at a causal GQA shape."""
    q, k, v, do = _flash(dev, torch.float32, 300, 300, seed=10)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    kw = dict(scale=64 ** -0.5, causal=True, window=None, q_offset=0)
    before = ops.route_counts()["flash_attention_bwd_dq"]
    sdq = ops._flash_dq_card(q, k, v, do, lse, delta, route="simt", **kw)
    dq = ops._flash_dq_card(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert ops.route_counts()["flash_attention_bwd_dq"] == {
        **before, "simt": before["simt"] + 1,
        "tf32x3": before["tf32x3"] + 1}
    want = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    _flash_close("dq", sdq, want, torch.float32)
    _flash_close("dq", dq, want, torch.float32)


def test_flash_f32_rows_that_see_no_key(dev):
    """With q_offset 60 and a window of 8 over 64 keys, query rows 11 and
    later see no key: both float32 routes give o = 0 and lse = -1e30
    there, the same lse as each other everywhere within 1e-5, dK/dV
    within the gradient limit of each other, and dQ = 0 there and within
    that limit elsewhere."""
    q, k, v, do = _flash(dev, torch.float32, 64, 64, seed=8)
    kw = dict(scale=64 ** -0.5, causal=True, window=8, q_offset=60)
    o, lse = ops._flash_fwd_card(q, k, v, return_lse=True, **kw)
    so, slse = ops._flash_fwd_card(q, k, v, return_lse=True, route="simt",
                                   **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dkv = ops._flash_dkv_card(q, k, v, do, lse, delta, **kw)
    sdkv = ops._flash_dkv_card(q, k, v, do, lse, delta, route="simt", **kw)
    dq = ops._flash_dq_card(q, k, v, do, lse, delta, **kw)
    sdq = ops._flash_dq_card(q, k, v, do, lse, delta, route="simt", **kw)
    torch.cuda.synchronize()
    for got in (dq, sdq):
        assert not got[:, :, 11:].any()
    _flash_close("dq", dq, sdq, torch.float32)
    for got in (o, so):
        assert not got[:, :, 11:].any() and bool(got[:, :, :11].abs().gt(0)
                                                  .all())
    for got in (lse, slse):
        assert bool((got[:, :, 11:] == -1e30).all())
    _flash_close("o", o, so, torch.float32)
    _flash_close("lse", lse, slse, torch.float32)
    for a, b in zip(dkv, sdkv):
        _flash_close("dk", a, b, torch.float32)


def test_flash_autograd_under_checkpoint_runs_the_tf32_kernels(dev):
    """The autograd Function under torch.utils.checkpoint (the FHDP
    step's per-layer remat): the forward twice and dK/dV and dQ once on
    tf32x3, the gradients within the float32 limit of plain attention's."""
    q, k, v, do = _flash(dev, torch.float32, 256, 256, seed=9, hq=4,
                         hkv=4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = ops.route_counts()
    o = torch.utils.checkpoint.checkpoint(
        lambda a, b, c: ops.flash_attention_ad(a, b, c, causal=False),
        q, k, v, use_reentrant=False)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    after = ops.route_counts()
    for name, route, n in (("flash_attention", "tf32x3", 2),
                           ("flash_attention_bwd_dkv", "tf32x3", 1),
                           ("flash_attention_bwd_dq", "tf32x3", 1)):
        assert after[name] == {**before[name],
                               route: before[name][route] + n}, name
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v,
                                                       causal=False),
                               (q, k, v), do)
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= 2e-5


def test_flash_autograd_runs_the_kernels(dev):
    q, k, v, do = _flash(dev, torch.float32, 64, 64, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = ops.launch_counts()
    o = ops.flash_attention_ad(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_bwd_dkv"]
            == before["flash_attention_bwd_dkv"] + 1)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v),
                               (q, k, v), do)
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= 2e-5


def test_dequantize_kernel_bitwise(dev):
    rng = np.random.default_rng(3)
    m = 1000
    q = torch.tensor(rng.integers(-127, 128, (m, ops.LANES)),
                     dtype=torch.int8).to(dev)
    scale = torch.tensor(rng.uniform(1e-6, 1e3, (m, 1)),
                         dtype=torch.float32).to(dev)
    scale[7] = 0.0
    got = ops.dequantize_int8(q, scale)
    want = ref.dequantize_int8_ref(q, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _lora(dev, dtype, m, k, n, r, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x, w, a, b, gy = (torch.randn(s, generator=g) * std for s, std in (
        ((m, k), 1.0), ((k, n), k ** -0.5), ((k, r), k ** -0.5),
        ((r, n), 0.1), ((m, n), 1.0)))
    return [t.to(dtype).to(dev) for t in (x, w, a, b, gy)]


def _lora_tol(dtype, want):
    peak = float(want.float().abs().max())
    return (1e-5 if dtype == torch.float32 else 2.0 ** -7) * peak


#: (M, K, N, r) and the route a bf16 call takes in either layout: the
#: ragged case's row stride 132 is no multiple of 8, so it stays on the
#: mma.sync kernel; the rest are TMA-describable and go to wgmma (K 40 and
#: N 8 included: each one partial tile)
LORA_CASES = [(256, 1024, 512, 4, "wgmma"), (1000, 96, 132, 8, "simt"),
              (130, 200, 72, 16, "wgmma"), (33, 40, 8, 1, "wgmma")]


@pytest.mark.parametrize("m,k,n,r,bf16_route", LORA_CASES,
                         ids=["path-like", "ragged", "rank16", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["forward", "dx"])
def test_lora_kernel_matches_plain(dev, dtype, m, k, n, r, bf16_route,
                                   layout):
    """The fused LoRA kernel against its plain version: float32 within
    1e-5 of the largest magnitude (sums in another order), bf16 within a
    bf16 ulp there (one rounding of a float32 value on each side); the
    dx layout reads transposed views of w, b and a, as the backward
    does. Each launch is counted on the route ``ops.lora_route`` names:
    float32 always on the "simt" route (the mma.sync / float32 kernel)."""
    x, w, a, b, gy = _lora(dev, dtype, m, k, n, r)
    args = (x, w, a, b) if layout == "forward" else (gy, w.T, b.T, a.T)
    route = bf16_route if dtype == torch.bfloat16 else "simt"
    assert ops.lora_route(dtype, args[0].shape, args[1].stride(),
                          args[0].data_ptr(), args[1].data_ptr()) == route
    before = ops.launch_counts()["lora_matmul"]
    routes = ops.route_counts()["lora_matmul"]
    got = ops.lora_matmul(*args, scale=2.0)
    want = ref.lora_matmul_ref(*args, scale=2.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lora_matmul"] == before + 1
    after = ops.route_counts()["lora_matmul"]
    assert after == {**routes, route: routes[route] + 1}
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) \
        <= _lora_tol(dtype, want)


#: the distillation path's adapted projections (M 4 x 1032, r 4)
LORA_PATH = {"wq/attn.wo": (1024, 1024), "wk/wv": (1024, 512),
             "ffn.wo": (4096, 1024)}


@pytest.mark.parametrize("shape", LORA_PATH)
@pytest.mark.parametrize("layout", ["forward", "dx"])
def test_lora_path_shapes_run_the_wgmma_kernel(dev, shape, layout):
    """The distillation path's three shapes at M 4128, forward and dx,
    launch the wgmma kernel and agree with the plain version within a
    bf16 ulp of the largest magnitude."""
    k, n = LORA_PATH[shape]
    x, w, a, b, gy = _lora(dev, torch.bfloat16, 4 * 1032, k, n, 4, seed=2)
    args = (x, w, a, b) if layout == "forward" else (gy, w.T, b.T, a.T)
    routes = ops.route_counts()["lora_matmul"]
    got = ops.lora_matmul(*args, scale=2.0)
    want = ref.lora_matmul_ref(*args, scale=2.0)
    torch.cuda.synchronize()
    assert ops.route_counts()["lora_matmul"] == {
        "wgmma": routes["wgmma"] + 1, "simt": routes["simt"]}
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) \
        <= _lora_tol(torch.bfloat16, want)


def test_lora_unaligned_base_takes_the_mma_kernel(dev):
    """TMA reads from 16-byte aligned bases: bf16 x one element into its
    storage goes to the mma.sync kernel, and agrees with the plain
    version all the same."""
    x, w, a, b, _ = _lora(dev, torch.bfloat16, 130, 64, 72, 4, seed=3)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xs[1:] = x.reshape(-1)
    xv = xs[1:].view(x.shape)
    routes = ops.route_counts()["lora_matmul"]
    got = ops.lora_matmul(xv, w, a, b, scale=2.0)
    want = ref.lora_matmul_ref(x, w, a, b, scale=2.0)
    torch.cuda.synchronize()
    assert ops.route_counts()["lora_matmul"] == {
        "wgmma": routes["wgmma"], "simt": routes["simt"] + 1}
    assert float((got.float() - want.float()).abs().max()) \
        <= _lora_tol(torch.bfloat16, want)


def test_lora_autograd_runs_the_kernel(dev):
    """lora_matmul_ad: the kernel forward, dx through the kernel on
    transposed views, da and db as float32 products; no dw for a frozen
    w."""
    x, w, a, b, gy = _lora(dev, torch.float32, 300, 256, 192, 4, seed=1)
    x, a, b = (t.requires_grad_() for t in (x, a, b))
    before = ops.launch_counts()["lora_matmul"]
    y = ops.lora_matmul_ad(x, w, a, b, scale=0.5)
    grads = torch.autograd.grad(y, (x, a, b), gy)
    assert ops.launch_counts()["lora_matmul"] == before + 2
    want = torch.autograd.grad(ref.lora_matmul_ref(x, w, a, b, scale=0.5),
                               (x, a, b), gy)
    for got, exp in zip(grads, want):
        assert float((got - exp).abs().max()) <= _lora_tol(torch.float32,
                                                           exp)


def _mlstm(dev, dtype, b, nh, s, dh, state, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((b, nh, s, dh), generator=g) for _ in range(3))
    args = [q.to(dtype).to(dev), (k * dh ** -0.5).to(dtype).to(dev),
            v.to(dtype).to(dev), torch.randn((b, nh, s), generator=g).to(dev),
            torch.nn.functional.logsigmoid(
                torch.randn((b, nh, s), generator=g) + 2.0).to(dev)]
    kw = {}
    if state:
        kw = {name: t.to(dev) for name, t in (
            ("C0", torch.randn((b, nh, dh, dh), generator=g) * 0.1),
            ("n0", torch.randn((b, nh, dh), generator=g) * 0.1),
            ("m0", torch.randn((b, nh), generator=g)))}
    return args, kw


MLSTM_CASES = [(2, 4, 512, 512, False), (1, 4, 333, 512, True),
               (2, 4, 100, 64, True), (1, 3, 70, 16, False),
               (1, 2, 129, 40, True), (2, 2, 1, 128, True)]


@pytest.mark.parametrize("b,nh,s,dh,state", MLSTM_CASES,
                         ids=["path-width", "ragged-state", "dh64", "dh16",
                              "dh40", "one-step"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_kernel_matches_plain(dev, dtype, b, nh, s, dh, state):
    args, kw = _mlstm(dev, dtype, b, nh, s, dh, state)
    before = ops.launch_counts()["mlstm_chunked"]
    h, fin = ops.mlstm_chunked(*args, **kw)
    want_h, want_fin = ref.mlstm_chunkwise_ref(*args, chunk=64, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_chunked"] == before + 1
    assert h.dtype == dtype and all(t.dtype == torch.float32 for t in fin)
    for name, got, want in zip("hCnm", (h, *fin), (want_h, *want_fin)):
        assert bool(torch.isfinite(got).all()), name
        peak = max(1.0, float(want.float().abs().max()))
        rtol = (1e-5 if name != "h" else
                5e-5 if dtype == torch.float32 else 2.0 ** -7)
        assert float((got.float() - want.float()).abs().max()) \
            <= rtol * peak, name


def test_mlstm_cuda_never_takes_the_plain_path(dev, monkeypatch):
    """A CUDA tensor launches the kernel: the plain versions are never
    called, in the wrapper or in a prefill through the cell."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import recurrent

    def boom(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(ref, "mlstm_chunkwise_ref", boom)
    monkeypatch.setattr(ref, "mlstm_chunk_body", boom)
    args, kw = _mlstm(dev, torch.float32, 1, 2, 40, 32, True)
    before = ops.launch_counts()["mlstm_chunked"]
    ops.mlstm_chunked(*args, **kw)
    cfg = reduced(get_config("xlstm-350m"))
    g = torch.Generator(device=dev).manual_seed(0)
    p = recurrent.init_mlstm(g, cfg, dev)
    x = torch.randn((2, 37, cfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        y, st = recurrent.apply_mlstm_seq(p, x, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlstm_chunked"] == before + 2
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st["C"]).all())


@pytest.mark.parametrize("b,nh,s,dh,state", [
    (2, 4, 512, 512, False), (1, 4, 333, 512, True), (2, 3, 100, 128, True),
    (1, 2, 70, 256, False), (2, 4, 129, 64, True), (1, 2, 1, 512, True)],
    ids=["path-width", "ragged-state", "dh128", "dh256", "dh64", "one-step"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_wgmma_route_matches_simt(dev, dtype, b, nh, s, dh, state):
    """The tensor-core kernel (3xTF32 wgmma, S shared across a cluster)
    and the SIMT kernel on the same inputs: each within the plain
    version's tolerances, and within those of each other; the wrapper
    counts the launch on the wgmma route."""
    args, kw = _mlstm(dev, dtype, b, nh, s, dh, state)
    st = (kw.get("C0"), kw.get("n0"), kw.get("m0"))
    assert ops.mlstm_route(dtype, dh) == "wgmma"
    before = ops.route_counts()["mlstm_chunked"]
    new = ops.mlstm_chunked(*args, **kw)
    assert ops.route_counts()["mlstm_chunked"] == {
        "wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    old = ops._mlstm_card(*args, *st, route="simt")
    want = ref.mlstm_chunkwise_ref(*args, chunk=64, **kw)
    torch.cuda.synchronize()
    for i, name in enumerate("hCnm"):
        got = (new[0], *new[1])[i]
        simt = (old[0], *old[1])[i]
        exp = (want[0], *want[1])[i]
        assert bool(torch.isfinite(got).all()), name
        peak = max(1.0, float(exp.float().abs().max()))
        rtol = (1e-5 if name != "h" else
                5e-5 if dtype == torch.float32 else 2.0 ** -7)
        for t in (got, simt):
            assert float((t.float() - exp.float()).abs().max()) \
                <= rtol * peak, name
        assert float((got.float() - simt.float()).abs().max()) \
            <= 2 * rtol * peak, name


def test_mlstm_wgmma_is_bitwise_repeatable(dev):
    """No atomics: the cluster sums S in rank order, so two launches give
    the same bits."""
    args, kw = _mlstm(dev, torch.float32, 1, 4, 200, 512, True)
    a = ops.mlstm_chunked(*args, **kw)
    b = ops.mlstm_chunked(*args, **kw)
    torch.cuda.synchronize()
    for x, y in zip((a[0], *a[1]), (b[0], *b[1])):
        assert torch.equal(x, y)


MLSTM_BWD_CASES = [(2, 4, 512, 512, False), (1, 4, 333, 512, True),
                   (2, 2, 100, 64, True), (1, 2, 129, 40, True)]
MLSTM_BWD_IDS = ["path-width", "ragged-state", "dh64", "dh40-simt"]
MLSTM_BWD_GRADS = ("dq", "dk", "dv", "dig", "dlf")


def _mlstm_bwd_inputs(dev, dtype, b, nh, s, dh, state, seed=5):
    args, kw = _mlstm(dev, dtype, b, nh, s, dh, state)
    g = torch.Generator(device="cpu").manual_seed(seed)
    dh_ = torch.randn((b, nh, s, dh), generator=g).to(dev, dtype)
    return args, kw, dh_


@pytest.mark.parametrize("route", ["routed", "simt"])
@pytest.mark.parametrize("b,nh,s,dh,state", MLSTM_BWD_CASES,
                         ids=MLSTM_BWD_IDS)
def test_mlstm_bwd_kernel_matches_plain(dev, b, nh, s, dh, state, route):
    """Each route's backward kernels against the plain backward on the
    same saved states (the forward kernel's, chunks of 64), each gradient
    within 1e-4 of its largest magnitude (float32 both, in other
    summation orders; den = max(|n.q|, e^-m) divides and can magnify
    them). "routed" is the wrapper's own choice: wgmma at DH 64 and 512,
    simt at DH 40; "simt" asks for the SIMT kernels by name. The forward
    with the state writes gives h and the final state bitwise those
    without."""
    args, kw, dh_ = _mlstm_bwd_inputs(dev, torch.float32, b, nh, s, dh,
                                      state)
    h0, fin0 = ops.mlstm_chunked(*args, **kw)
    h, fin, states = ops.mlstm_chunked(*args, **kw, states=True)
    assert torch.equal(h, h0) and all(torch.equal(x, y)
                                      for x, y in zip(fin, fin0))
    want_route = ("simt" if route == "simt" or dh not in ops.MLSTM_TC_DH
                  else "wgmma")
    before = dict(ops.route_counts()["mlstm_chunked_bwd"])
    if route == "simt":
        got = ops._mlstm_bwd_card(*args, h, dh_, states, route="simt")
    else:
        got = ops.mlstm_chunked_bwd(*args, h, dh_, states)
    want = ref.mlstm_chunkwise_bwd_ref(*args, h, dh_, states, chunk=64)
    torch.cuda.synchronize()
    after = ops.route_counts()["mlstm_chunked_bwd"]
    before[want_route] += 1
    assert after == before
    for name, x, y in zip(MLSTM_BWD_GRADS, got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape, name
        assert bool(torch.isfinite(x).all()), name
        peak = float(y.abs().max())
        assert float((x - y).abs().max()) <= 1e-4 * peak, name


@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_mlstm_bwd_kernel_takes_bf16_inputs(dev, route):
    """bf16 q, k, v, h and dh (the wgmma route drops the passes of their
    exact tf32 parts; the SIMT kernel reads them as float32) against the
    plain backward on the same values, within the float32 case's 1e-4 of
    each gradient's largest magnitude."""
    args, kw, dh_ = _mlstm_bwd_inputs(dev, torch.bfloat16, 1, 4, 200, 512,
                                      True)
    h, _, states = ops.mlstm_chunked(*args, **kw, states=True)
    before = ops.route_counts()["mlstm_chunked_bwd"][route]
    got = ops._mlstm_bwd_card(*args, h, dh_, states, route=route)
    want = ref.mlstm_chunkwise_bwd_ref(*args, h, dh_, states, chunk=64)
    torch.cuda.synchronize()
    assert ops.route_counts()["mlstm_chunked_bwd"][route] == before + 1
    for name, x, y in zip(MLSTM_BWD_GRADS, got, want):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()), \
            name


@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_mlstm_bwd_is_bitwise_repeatable(dev, route):
    """No atomics: every sum of either route's backward (the wgmma
    cluster's sums in rank order) runs in a fixed order."""
    args, kw, dh_ = _mlstm_bwd_inputs(dev, torch.float32, 1, 4, 200, 512,
                                      True)
    h, _, states = ops.mlstm_chunked(*args, **kw, states=True)
    a = ops._mlstm_bwd_card(*args, h, dh_, states, route=route)
    b = ops._mlstm_bwd_card(*args, h, dh_, states, route=route)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["dh40", "misaligned"])
def test_mlstm_bwd_route_selection(dev, case, monkeypatch):
    """The wgmma route takes DH in MLSTM_TC_DH with 16-byte aligned
    bases; DH 40 and a base 4 bytes in go to the SIMT kernels, and no
    plain version runs. Asking the wgmma route for them raises."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for name in ("mlstm_chunkwise_bwd_ref", "_mlstm_chunk_bwd"):
        monkeypatch.setattr(ref, name, boom)
    dh = 40 if case == "dh40" else 64
    args, kw, dh_ = _mlstm_bwd_inputs(dev, torch.float32, 1, 2, 77, dh,
                                      False)
    h, _, states = ops.mlstm_chunked(*args, **kw, states=True)
    if case == "misaligned":
        def shifted(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            out = buf[1:].view(t.shape)
            out.copy_(t)
            return out
        args = [shifted(args[0]), *args[1:]]
        assert args[0].data_ptr() % 16
    assert ops.mlstm_route(torch.float32, dh) == (
        "simt" if case == "dh40" else "wgmma")
    before = dict(ops.route_counts()["mlstm_chunked_bwd"])
    got = ops.mlstm_chunked_bwd(*args, h, dh_, states)
    torch.cuda.synchronize()
    after = ops.route_counts()["mlstm_chunked_bwd"]
    assert after == {"wgmma": before["wgmma"], "simt": before["simt"] + 1}
    assert all(bool(torch.isfinite(x).all()) for x in got)
    with pytest.raises(ValueError, match="route"):
        ops._mlstm_bwd_card(*args, h, dh_, states, route="wgmma")


def test_mlstm_ad_cuda_never_takes_the_plain_path(dev, monkeypatch):
    """CUDA tensors through the autograd Function launch the forward and
    backward kernels, both on route wgmma at DH 64: no plain version
    runs, either half."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for name in ("mlstm_chunkwise_ref", "mlstm_chunk_body", "_mlstm_chunk",
                 "mlstm_chunkwise_bwd_ref", "_mlstm_chunk_bwd"):
        monkeypatch.setattr(ref, name, boom)
    args, kw, dh_ = _mlstm_bwd_inputs(dev, torch.float32, 1, 2, 77, 64,
                                      False)
    ins = [t.clone().requires_grad_() for t in args]
    before = ops.launch_counts()
    routes = ops.route_counts()
    h, _ = ops.mlstm_chunked_ad(*ins)
    grads = torch.autograd.grad(h, ins, dh_)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["mlstm_chunked"] == before["mlstm_chunked"] + 1
    assert after["mlstm_chunked_bwd"] == before["mlstm_chunked_bwd"] + 1
    now = ops.route_counts()
    assert now["mlstm_chunked"]["wgmma"] == routes["mlstm_chunked"]["wgmma"] + 1
    assert now["mlstm_chunked_bwd"] == {
        "wgmma": routes["mlstm_chunked_bwd"]["wgmma"] + 1,
        "simt": routes["mlstm_chunked_bwd"]["simt"]}
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mlstm_layer_grad_under_checkpoint_runs_both_kernels(dev):
    """torch.autograd through apply_mlstm_seq under a checkpoint, as
    training runs it: the forward kernel twice (the recompute), the
    backward kernel once; the input's and every parameter's gradient
    within 1e-4 of its largest magnitude of the same on the CPU (the
    plain versions at the reference's chunk)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import recurrent
    cfg = reduced(get_config("xlstm-350m"))
    g = torch.Generator(device="cpu").manual_seed(3)
    p = recurrent.init_mlstm(g, cfg, torch.device("cpu"))
    x = torch.randn((2, 150, cfg.d_model), generator=g)
    w = torch.randn((2, 150, cfg.d_model), generator=g)

    def grads(device):
        lp = {k: v.to(device).requires_grad_() for k, v in p.items()}
        xi = x.to(device).requires_grad_()
        y = checkpoint(lambda a, b: recurrent.apply_mlstm_seq(a, b, cfg)[0],
                       lp, xi, use_reentrant=False)
        out = torch.autograd.grad((y * w.to(device)).sum(),
                                  [xi, *lp.values()])
        return [t.cpu() for t in out]

    before = ops.launch_counts()
    got = grads(dev)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["mlstm_chunked"] == before["mlstm_chunked"] + 2
    assert after["mlstm_chunked_bwd"] == before["mlstm_chunked_bwd"] + 1
    for a, b in zip(got, grads("cpu")):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _pools_int8(dev, lead, nb, bs, d, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (*lead, nb, bs, d)
    return [torch.randint(-127, 128, shape, generator=g,
                          dtype=torch.int32).to(torch.int8).to(dev)
            for _ in range(2)] + [
        torch.rand((*lead, nb, bs, 1), generator=g).to(dev)
        for _ in range(2)]


@pytest.mark.parametrize("mode", ["decode", "chunk", "prefill"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kv_append_kernel_bitwise(dev, dtype, mode):
    """The fused int8 append against its plain version, bitwise outside
    the null block (whose contents are garbage by contract): a decode
    append with a dead lane at (null, 0), a prefill chunk whose padding
    rows go to the null block, and every layer's prefill through a table
    with a null entry and a partial last block; the appends' rows as the
    engine hands them over (a transposed view, read through its
    strides); int32 and int64 indices; head_dim 64 (masked under 128
    lanes) and 128."""
    g = torch.Generator(device="cpu").manual_seed(4)
    nb, bs = 40, 16
    for d in (64, 128):
        lead = (3, 8) if mode == "prefill" else (8,)
        n = {"decode": 8, "chunk": 16, "prefill": 100}[mode]
        k = (torch.randn((*lead, n, d), generator=g) * 4).to(dtype).to(dev)
        v = (torch.randn((*lead, n, d), generator=g) * 4).to(dtype).to(dev)
        if mode != "prefill":       # the engine's layout: [N, Hkv, D]^T
            k = k.transpose(0, 1).contiguous().transpose(0, 1)
            v = torch.cat([v, v], dim=-1)[..., :d]   # V: rows 2d apart
        k[..., 2, :] = 0.0
        perm = torch.randperm(nb - 1, generator=g) + 1
        if mode == "decode":
            idx = dict(phys=torch.where(torch.arange(n) == 3, 0, perm[:n]),
                       off=torch.arange(n) * 3 % bs)
        elif mode == "chunk":
            idx = dict(phys=torch.where(torch.arange(n) < 9, perm[0], 0),
                       off=torch.arange(n) % bs)
        else:
            idx = dict(table=torch.cat([perm[:5], torch.zeros(2).long(),
                                        perm[5:7]]))
        for wide in (torch.int64, torch.int32):
            kw = {key: t.to(wide).to(dev) for key, t in idx.items()}
            base = _pools_int8(dev, lead, nb, bs, d, seed=d)
            got = [t.clone() for t in base]
            want = [t.clone() for t in base]
            before = ops.launch_counts()["quantize_kv_append"]
            ops.quantize_kv_append(*got, k, v, **kw)
            ref.quantize_kv_append_ref(*want, k, v, **kw)
            torch.cuda.synchronize()
            assert ops.launch_counts()["quantize_kv_append"] == before + 1
            live = (slice(None),) * len(lead) + (slice(1, None),)
            for a, b_ in zip(got, want):
                a, b_ = a[live], b_[live]
                bits = torch.uint8 if a.dtype == torch.int8 else torch.int32
                assert torch.equal(a.view(bits), b_.view(bits))


# --------------------------------------- the decode step's fused append
#: (Hq, Hkv, head_dim) of the serving decodes that fuse the append:
#: flad-adllm's 16/8 at 64 (route tma), the dense configs' 40/8, 56/8 and
#: 64/8 at 128 (route tma128)
APPEND_HEADS = [(16, 8, 64), (40, 8, 128), (56, 8, 128), (64, 8, 128)]


def _append_case(rng, dev, kv_dtype, hkv, d, bs, ctx_list):
    """Tables with room for each lane's appended key (a dead lane's table
    all null, its slot (null, 0)), pools with a NaN-poisoned null block,
    every live lane's target slot holding a sentinel (int8: codes 127,
    scale 1e3; bf16: 1e4) so that a stale read of it cannot pass."""
    need = [-(-(c + 1) // bs) if c else 0 for c in ctx_list]
    nb = 2 + sum(need)
    tables = np.zeros((len(ctx_list), max(need) + 1), np.int32)
    perm, i = rng.permutation(np.arange(1, nb)), 0
    for lane, n in enumerate(need):
        tables[lane, :n] = perm[i:i + n]
        i += n
    ctx = np.asarray(ctx_list, np.int32)
    lanes = np.arange(len(ctx_list))
    phys = np.where(ctx > 0, tables[lanes, ctx // bs], 0)
    off = np.where(ctx > 0, ctx % bs, 0)
    shape = (hkv, nb, bs, d)
    live = ctx > 0
    if kv_dtype == torch.int8:
        k = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        v = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)
        ks = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        vs = torch.tensor(rng.uniform(1e-3, 2e-2, shape[:3] + (1,)),
                          dtype=torch.float32)
        ks[:, 0] = vs[:, 0] = float("nan")
        for t, sentinel in ((k, 127), (v, 127), (ks, 1e3), (vs, 1e3)):
            t[:, phys[live], off[live]] = sentinel
        pools = [k, v, ks, vs]
    else:
        k = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)
        v = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)
        k[:, 0] = v[:, 0] = float("nan")
        for t in (k, v):
            t[:, phys[live], off[live]] = 1e4
        pools = [k, v, None, None]
    return (torch.tensor(tables, device=dev),
            torch.tensor(ctx, device=dev),
            torch.tensor(phys, device=dev), torch.tensor(off, device=dev),
            [None if t is None else t.to(dev) for t in pools])


@pytest.mark.parametrize("ctx_max", [300, 4096])
@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("heads", APPEND_HEADS,
                         ids=[f"{h}/{k}-d{d}" for h, k, d in APPEND_HEADS])
def test_decode_append_fused_matches_the_separate_pair(dev, heads, kv,
                                                       ctx_max):
    """``ops.paged_decode_append_attention`` (one launch of the TMA-fed
    decode kernel's fused entry point) against the separate pair on the
    same inputs (``ops.quantize_kv_append`` or two scatters, then
    ``ops.paged_decode_attention`` over ctx + 1 keys): pools and output
    bitwise, every target slot first holding a sentinel; 8 lanes with a
    dead one, at the serving shape (to ctx 300, one split) and at 4096
    keys (lanes ending on and past split boundaries, several splits);
    rows as the engine hands them over (a transposed view); one fused
    launch and no stand-alone append."""
    hq, hkv, d = heads
    bs = 16
    rng = np.random.default_rng(hq + d + ctx_max)
    if ctx_max == 300:
        ctx_list = [0, 1, 15, 16, 47, 100, 256, 299]
    else:
        per = ops.paged_splits(4096 + bs, 8 * hkv)[1]
        ctx_list = [0, 1, 16, 4095, per - 1, per, 2 * per - 1, 4000]
    tables, ctx, phys, off, pools = _append_case(
        rng, dev, KV[kv], hkv, d, bs, ctx_list)
    b = len(ctx_list)
    q = torch.tensor(rng.standard_normal((b, hq, d)), dtype=torch.bfloat16,
                     device=dev)
    rows = [torch.tensor(rng.standard_normal((b, hkv, d)) * 3,
                         dtype=torch.bfloat16, device=dev).transpose(0, 1)
            for _ in range(2)]
    rows[0][2, 5] = 0.0                      # an all-zero row
    route = {64: "tma", 128: "tma128"}[d]
    assert ops.decode_fuses_append(q.dtype, KV[kv], d, bs)
    fused = [None if t is None else t.clone() for t in pools]
    pair = [None if t is None else t.clone() for t in pools]
    counts = ops.launch_counts()
    routes = ops.route_counts()["paged_decode_append_attention"]
    got = ops.paged_decode_append_attention(
        q, *rows, fused[0], fused[1], tables, ctx, phys, off,
        k_scales=fused[2], v_scales=fused[3])
    torch.cuda.synchronize()
    now = ops.launch_counts()
    assert {n: now[n] - counts[n] for n in now if now[n] != counts[n]} == {
        "paged_decode_append_attention": 1}
    assert ops.route_counts()["paged_decode_append_attention"] == {
        **routes, route: routes[route] + 1}
    if kv == "int8":
        ops.quantize_kv_append(*pair, *rows, phys, off)
    else:
        pair[0][:, phys, off] = rows[0]
        pair[1][:, phys, off] = rows[1]
    want = ops.paged_decode_attention(q, pair[0], pair[1], tables, ctx + 1,
                                      k_scales=pair[2], v_scales=pair[3])
    torch.cuda.synchronize()
    for a, b_ in zip(fused, pair):
        if a is not None:
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                a.element_size()]
            assert torch.equal(a.view(bits), b_.view(bits))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.isfinite(got).all()


# ------------------------------------------- the flash backward preprocess
PRE_ROWS = [(4 * 16 * 1024, "training"), (4 * 16 * 1032, "distillation"),
            (999, "ragged"), (1, "one row")]


@pytest.mark.parametrize("rows,case", PRE_ROWS, ids=[c for _, c in PRE_ROWS])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_preprocess_vec_kernel(dev, dtype, d, rows, case):
    """The 16-byte-load kernel (route "vec", every launch by default):
    each row of delta within 13 * 2^-24 * sum_d |O dO| + 1e-30 of the
    float64 sum (at most 12 roundings on a product's way), as close to
    the one-warp-a-row kernel, and bitwise repeatable."""
    g = torch.Generator(device=dev).manual_seed(rows + d)
    scale = 10.0 ** (torch.rand((rows, 1), generator=g, device=dev) * 9 - 6)
    o, do = (torch.randn((1, 1, rows, d), generator=g, device=dev)
             * scale.sqrt() for _ in "od")
    o, do = o.to(dtype), do.to(dtype)
    before = ops.route_counts()["flash_attention_bwd_preprocess"]
    got = ops.flash_attention_bwd_preprocess(o, do)
    again = ops.flash_attention_bwd_preprocess(o, do)
    old = ops._preprocess_card(o, do, "simt")
    torch.cuda.synchronize()
    assert ops.route_counts()["flash_attention_bwd_preprocess"] == {
        "vec": before["vec"] + 2, "simt": before["simt"] + 1}
    assert torch.equal(got, again)
    prod = o.double() * do.double()
    exact, mag = prod.sum(-1), prod.abs().sum(-1)
    bound = 13 * 2.0 ** -24 * mag + 1e-30
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((got.double() - old.double()).abs() <= 2 * bound).all())


# ------------------------------------------------- the speculative verify
#: lanes: dead (window 0), a full window of 5, a partial one across a
#: block boundary, a window at ctx 0, a long context
VERIFY_CTX = [0, 47, 30, 0, 290]
VERIFY_WIN = [0, 5, 3, 5, 5]


@pytest.mark.parametrize("q_dtype,kv_dtype,atol", CASES, ids=IDS)
@pytest.mark.parametrize("heads", ["flad-gqa2", "g5-d128"])
def test_paged_verify_kernel(dev, q_dtype, kv_dtype, atol, heads):
    """One launch for all lanes on the route ``ops.paged_route`` names for
    prefill (head dim 64 "wgmma", 128 "wgmma128" for bf16 q): against the
    plain version (bf16 each row within 2^-8 of its largest |value|,
    float32 within 1e-5), a dead lane zeros; float32 rows bitwise the
    paged decode kernel's at each position (the speculative contract),
    bf16 elements within one bf16 ulp of them plus the two kernels'
    derived float32 gap (ref.verify_decode_gap_bound)."""
    rng = np.random.default_rng(3)
    (hq, hkv, d), bs, c = PREFILL_HEADS[heads], 16, 5
    ctx = np.array(VERIFY_CTX, np.int32)
    win = np.array(VERIFY_WIN, np.int32)
    tables, k, v, ks, vs = _paged(rng, dev, kv_dtype, hkv, bs, d,
                                  list(ctx + win))
    q = torch.tensor(rng.standard_normal((len(ctx), hq, c, d)),
                     dtype=q_dtype, device=dev)
    tc, tw = (torch.tensor(a, device=dev) for a in (ctx, win))
    kw = dict(k_scales=ks, v_scales=vs)
    route = ops.paged_route("prefill", q_dtype, kv_dtype, d, bs)
    before = ops.route_counts()["paged_verify_attention"]
    got = ops.paged_verify_attention(q, k, v, tables, tc, tw, **kw)
    again = ops.paged_verify_attention(q, k, v, tables, tc, tw, **kw)
    torch.cuda.synchronize()
    assert ops.route_counts()["paged_verify_attention"] == {
        **before, route: before[route] + 2}
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert not got[0].any()
    want = ref.paged_verify_attention_ref(q.float(), k, v, tables, tc, tw,
                                          **kw)
    for b, w in enumerate(win):
        if w == 0:
            continue                # the dead lane: zeros, checked above
        if q_dtype == torch.bfloat16:
            _rows_within(got[b, :, :w], want[b, :, :w], PAGED_RTOL["decode"])
        else:
            err = (got[b, :, :w] - want[b, :, :w]).abs()
            assert float(err.max()) <= atol
    gap = ref.verify_decode_gap_bound(q, k, v, tables, tc, tw, **kw)
    for col in range(c):
        live = win > col
        seen = torch.tensor(np.where(live, ctx + col + 1, 0)
                            .astype(np.int32), device=dev)
        dec = ops.paged_decode_attention(q[:, :, col].contiguous(), k, v,
                                         tables, seen, **kw)
        torch.cuda.synchronize()
        if q_dtype == torch.float32:
            assert torch.equal(got[live, :, col], dec[live]), col
        else:
            assert _gap_use(got[live, :, col], dec[live],
                            gap[live, :, col]) <= 1.0, col


def _bf16_ulps(a, b):
    """bf16 ulps between two bf16 tensors (bit patterns as ordered
    integers)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def _gap_use(got, want, gap):
    """The largest share of ``gap`` (ref.verify_decode_gap_bound) that
    |got - want| (bf16) takes beyond one bf16 ulp of the larger of the
    two: above 1, an element lies farther from the decode kernel's than
    the two kernels' arithmetic allows."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    past = ((g - w).abs() - ulp).clamp_min(0)
    return float(torch.where(past > 0, past / gap, 0.0).max())


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_verify_rows_within_a_bf16_ulp_of_decode(dev, kv_dtype):
    """flad-adllm's heads (16 over 8, D 64) and 8 lanes of windows up to
    5 rows: with P split (the verify's route) every bf16 element is within
    one bf16 ulp of the paged decode kernel's at its position over the
    same keys plus the two kernels' derived float32 gap
    (ref.verify_decode_gap_bound), and fewer elements lie more than one
    ulp apart than with P rounded once (the kernel before the split); the
    shares of bitwise-equal rows and the largest ulp distances are
    printed."""
    rng = np.random.default_rng(9)
    hq, hkv, d, bs, c = 16, 8, 64, 16, 5
    ctx = np.array([0, 1, 16, 47, 100, 203, 256, 290], np.int32)
    win = np.array([0, 5, 5, 5, 3, 5, 1, 5], np.int32)
    tables, k, v, ks, vs = _paged(rng, dev, kv_dtype, hkv, bs, d,
                                  list(ctx + win))
    q = torch.tensor(rng.standard_normal((len(ctx), hq, c, d)),
                     dtype=torch.bfloat16, device=dev)
    tc, tw = (torch.tensor(a, device=dev) for a in (ctx, win))
    route = ops.paged_route("prefill", q.dtype, kv_dtype, d, bs)
    assert route == "wgmma"
    outs = {split: ops._prefill_launch(
        route, q, k, v, tables, tc, tw, 0, 0, d ** -0.5, ks, vs,
        "paged_verify_attention", split_p=split) for split in (True, False)}
    assert torch.equal(outs[True], ops.paged_verify_attention(
        q, k, v, tables, tc, tw, k_scales=ks, v_scales=vs))
    gap = ref.verify_decode_gap_bound(q, k, v, tables, tc, tw,
                                      k_scales=ks, v_scales=vs)
    use = {True: 0.0, False: 0.0}
    same, far, ulps = ({True: 0, False: 0} for _ in range(3))
    total = 0
    for col in range(c):
        live = win > col
        seen = torch.tensor(np.where(live, ctx + col + 1, 0)
                            .astype(np.int32), device=dev)
        dec = ops.paged_decode_attention(q[:, :, col].contiguous(), k, v,
                                         tables, seen, k_scales=ks,
                                         v_scales=vs)
        torch.cuda.synchronize()
        total += int(live.sum()) * hq
        for split, out in outs.items():
            row = out[live, :, col]
            apart = _bf16_ulps(row, dec[live])
            use[split] = max(use[split],
                             _gap_use(row, dec[live], gap[live, :, col]))
            same[split] += int((row == dec[live]).all(-1).sum())
            far[split] += int((apart > 1).sum())
            ulps[split] = max(ulps[split], int(apart.max()))
    print(f"rows bitwise the decode kernel's: P split {same[True]}/{total}, "
          f"P rounded once {same[False]}/{total}; elements past one ulp "
          f"{far}, at most {ulps} ulps; share of ulp + gap bound {use}")
    assert use[True] <= 1.0, use
    assert far[True] < far[False], far


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_speculative_streams_bitwise_on_the_card(dev, cache):
    """Reduced flad-adllm in float32 on the card: self-drafted and
    randomly drafted speculative streams bitwise those of plain decode."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.serve import generate_pod_requests, serve_continuous
    cfg = reduced(get_config("flad-adllm")).replace(param_dtype="float32")
    params = lm.init(cfg, seed=0, device=dev)
    reqs = generate_pod_requests(
        "nano*1,agx*1", num_requests=6, pods=2, template_len=8,
        max_suffix=4, seed=3, short_new=(3, 6), long_new=(8, 12),
        long_frac=0.4, vocab_size=cfg.vocab_size)
    kw = dict(params=params, slots=2, block_size=16, max_context=16,
              prefill="chunked", prefill_chunk=4, prefix_cache=True,
              cache=cache, requests=reqs, log_fn=None, device=dev)
    base = serve_continuous(cfg, **kw)
    for draft in (None, lm.init(cfg, seed=7, device=dev)):
        before = ops.launch_counts()["paged_verify_attention"]
        spec = serve_continuous(cfg, speculative=True, draft_k=3,
                                draft_params=draft, **kw)
        assert spec["sequences"] == base["sequences"]
        assert ops.launch_counts()["paged_verify_attention"] - before == \
            2 * cfg.num_layers * spec["spec_steps"]


# ------------------------------------------------- the async engine
def test_async_merge_under_profiled_names_the_kernels(dev, tmp_path):
    """One async_hier_fl merge of reduced flad-adllm (int8 codec) under
    ``profiled``: the exported Chrome trace names the flash kernels and
    the codec's, and the launches follow the engine's waves."""
    import json

    from repro_torch.api import LoopHooks, Session
    from repro_torch.obs import ProfileOptions
    ses = Session("flad-adllm", strategy="async_hier_fl", shape="64x2",
                  codec="int8", local_steps=2, clock=0.05,
                  compute_flops=5e9, device=dev)
    opts = ProfileOptions(trace_dir=str(tmp_path))
    ops.reset_launch_counts()
    out = ses.run(1, hooks=LoopHooks(log_every=1, log_fn=lambda *a: None),
                  profile=opts)
    counts = ops.launch_counts()
    trained = sum(map(len, ses.strategy.engine.wave_members))
    steps = trained * 2 * ses.cfg.num_layers
    assert counts["flash_attention"] == counts["flash_attention_bwd_dq"] \
        == steps > 0
    assert counts["quantize_int8"] == counts["dequantize_int8"] > 0
    with open(out["profile_path"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    for want in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "quantize_int8_kernel", "dequantize_int8_kernel"):
        assert any(want in n for n in names), (want, sorted(names)[:20])
