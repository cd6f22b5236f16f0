"""A serving decode step's layer in one call
(``ops.paged_decode_append_attention``) on the CPU.

On the card, bf16 q on the TMA-fed decode routes ("tma" at head_dim 64,
"tma128" at 128) launches the decode kernel's fused entry point: the CTA
of a (lane, KV head)'s last live split writes the lane's new K/V row into
its pool slot and then reads it back by TMA. Every other route appends
first (``ops.quantize_kv_append`` for int8 pools, two scatters for the
others) and launches the SIMT decode kernel. Here:

  * the plain version, which the CPU route runs, leaves the pools bitwise
    those of the stand-alone append (``ref.quantize_kv_append_ref`` for
    int8, a cast copy for bf16) and returns bitwise the separate append
    followed by ``ref.paged_decode_attention_ref`` over ctx + 1 keys, over
    pool dtype x head_dim x block size x one split or several, with a
    dead lane at (null block, 0);
  * the same inputs through the JAX reference (``serve/kvcache``'s
    ``append_token`` and the decode kernel's oracle): pools bitwise, the
    output within one bf16 rounding of each row's largest value;
  * the split plan the kernel walks (``ops.paged_splits``, as the decode
    launch sizes it) puts every lane's appended key in the last tile of
    its last live split, the CTA that writes it;
  * which decodes fuse (a route table in the style of
    ``test_torch_paged_route.py``) and the wrapper's input checks;
  * the paged engine's decode step on the CPU stays bitwise the old
    composition (``kvcache.append_token``, then ``paged_decode_attention``
    over ctx + 1) in logits and pools, for float32 and bf16 models over
    model-dtype and int8 caches.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.serve import kvcache as JKC
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import lm as tlm
from repro_torch.serve import PagedCacheSpec, PagedEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import kvcache as KC

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
HQ, HKV, B = 4, 2, 5
#: lane contexts (keys before the append); lane 2 is dead (ctx 0, its
#: table all null, its row to the null block at offset 0)
ONE_SPLIT = [37, 5, 0, 16, 63]
SEVERAL = [900, 385, 0, 1000, 767]
#: one bf16 rounding of a float32 result, against the JAX reference
ROW_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _inputs(seed, int8, d, bs, ctx_list):
    """Numpy inputs: pools with the null block poisoned (NaN values, or
    NaN scales for int8), tables over shuffled blocks with room for the
    appended key, the rows' slots, bf16-valued q and rows."""
    rng = np.random.default_rng(seed)
    need = [-(-(c + 1) // bs) if c else 0 for c in ctx_list]
    t = max(need) + 1
    nb = 2 + sum(need)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, t), np.int32)
    i = 0
    for lane, n in enumerate(need):
        tables[lane, :n] = perm[i:i + n]
        i += n
    ctx = np.asarray(ctx_list, np.int32)
    phys = np.where(ctx > 0, tables[np.arange(B), ctx // bs], 0)
    off = np.where(ctx > 0, ctx % bs, 0)
    shape = (HKV, nb, bs, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32)
        ks[:, 0] = vs[:, 0] = np.nan
        pools = (k, v, ks, vs)
    else:
        k = _bf16(rng.standard_normal(shape).astype(np.float32))
        v = _bf16(rng.standard_normal(shape).astype(np.float32))
        k[:, 0] = v[:, 0] = np.nan
        pools = (k, v, None, None)
    q = _bf16(rng.standard_normal((B, HQ, d)).astype(np.float32))
    kr = _bf16(rng.standard_normal((HKV, B, d)).astype(np.float32) * 2)
    vr = _bf16(rng.standard_normal((HKV, B, d)).astype(np.float32) * 2)
    kr[1, 3] = 0.0                          # an all-zero row
    return (q, kr, vr, pools, tables, ctx, phys.astype(np.int64),
            off.astype(np.int64))


def _torch_pools(pools, int8):
    k, v, ks, vs = pools
    if int8:
        return [torch.from_numpy(x.copy()) for x in (k, v, ks, vs)]
    return [torch.from_numpy(x.copy()).to(BF16) for x in (k, v)] + [None,
                                                                    None]


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(
        torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("splits", ["one", "several"])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_fused_plain_matches_separate_and_reference(pool, d, bs, splits):
    int8 = pool == "int8"
    ctx_list = ONE_SPLIT if splits == "one" else SEVERAL
    q, kr, vr, pools, tables, ctx, phys, off = _inputs(
        d + bs + int8, int8, d, bs, ctx_list)
    tq, tkr, tvr = (torch.from_numpy(x).to(BF16) for x in (q, kr, vr))
    tt, tc = torch.from_numpy(tables), torch.from_numpy(ctx)
    tp, to = torch.from_numpy(phys), torch.from_numpy(off)
    scale = d ** -0.5

    # the kernel's split plan: this case's number of splits, and every
    # lane's appended key in the last tile of its last live split
    nsplit, per = ops.paged_splits(tables.shape[1] * bs, B * HKV)
    assert (nsplit > 1) == (splits == "several")
    if splits == "several":
        assert max(-(-(c + 1) // per) for c in ctx_list) > 1
    for c in ctx_list:
        keys = min(c + 1, tables.shape[1] * bs)
        last = max(1, -(-keys // per)) - 1          # the writing CTA
        lo, kend = last * per, min(keys, last * per + per)
        assert lo <= c < kend
        assert (c - lo) // 64 == -(-(kend - lo) // 64) - 1   # last tile

    fused = _torch_pools(pools, int8)
    out = ops.paged_decode_append_attention(
        tq, tkr, tvr, fused[0], fused[1], tt, tc, tp, to, scale=scale,
        k_scales=fused[2], v_scales=fused[3])
    sep = _torch_pools(pools, int8)
    if int8:
        ref.quantize_kv_append_ref(*sep, tkr, tvr, tp, to)
    else:
        sep[0][:, tp, to] = tkr
        sep[1][:, tp, to] = tvr
    want = ref.paged_decode_attention_ref(
        tq, sep[0], sep[1], tt, tc + 1, scale=scale, k_scales=sep[2],
        v_scales=sep[3])
    for a, b in zip(fused, sep):
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(out), _bits(want))
    assert bool(torch.isfinite(out.float()).all())

    # the JAX reference: its append, then its decode oracle over ctx + 1.
    # Its oracle multiplies masked keys' values by a zero weight, so the
    # null block's NaN poison is zeros on its side (and in the comparison)
    jdt = jnp.bfloat16
    clean = [None if x is None else np.nan_to_num(x) for x in pools]
    jpools = {"k": jnp.asarray(clean[0]) if int8 else jnp.asarray(
        clean[0], jdt), "v": jnp.asarray(clean[1]) if int8 else jnp.asarray(
        clean[1], jdt)}
    if int8:
        jpools.update(k_scale=jnp.asarray(clean[2]),
                      v_scale=jnp.asarray(clean[3]))
    jspec = JKC.PagedCacheSpec(num_blocks=pools[0].shape[1], block_size=bs,
                               max_blocks_per_req=tables.shape[1],
                               quantized=int8)
    jout = JKC.append_token(jpools, jspec, jnp.asarray(kr, jdt),
                            jnp.asarray(vr, jdt), jnp.asarray(phys),
                            jnp.asarray(off))
    keys = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    for key, got in zip(keys, fused):
        jw = np.asarray(jout[key])
        gw = np.nan_to_num(got.float().numpy())
        gw = gw.astype(ml_dtypes.bfloat16) if got.dtype == BF16 else (
            gw.astype(got.numpy().dtype))
        assert np.array_equal(gw.view(np.uint8), jw.view(np.uint8)), key
    jwant = np.asarray(jref.paged_decode_attention_ref(
        jnp.asarray(q, jdt), jout["k"], jout["v"], jnp.asarray(tables),
        jnp.asarray(ctx + 1), scale=scale, k_scales=jout.get("k_scale"),
        v_scales=jout.get("v_scale")), np.float32)
    got = out.float().numpy()
    tol = ROW_RTOL * np.abs(jwant).max(-1, keepdims=True) + 1e-6
    assert (np.abs(got - jwant) <= tol).all()


#: (q dtype, pool dtype, head_dim, block size) -> whether a card call is
#: one fused launch ("fused": the TMA-fed decode writes the rows) or the
#: stand-alone append and then the SIMT decode ("separate")
FUSES = {
    "serving bf16 cache": (BF16, BF16, 64, 16, "fused"),
    "serving int8 cache": (BF16, I8, 64, 16, "fused"),
    "dense bf16 cache": (BF16, BF16, 128, 16, "fused"),
    "dense int8 cache": (BF16, I8, 128, 16, "fused"),
    "bf16 bs 8": (BF16, BF16, 64, 8, "fused"),
    "bf16 d 128 bs 64": (BF16, BF16, 128, 64, "fused"),
    "int8 bs 32": (BF16, I8, 64, 32, "fused"),
    "int8 d 128 bs 64": (BF16, I8, 128, 64, "fused"),
    # the float32 speculative gate runs and every shape the TMA-fed
    # kernels refuse keep the stand-alone append
    "float32 cache": (F32, F32, 64, 16, "separate"),
    "float32 q int8 cache": (F32, I8, 64, 16, "separate"),
    "float32 d 128": (F32, F32, 128, 16, "separate"),
    "int8 bs 8": (BF16, I8, 64, 8, "separate"),
    "bf16 bs 24": (BF16, BF16, 64, 24, "separate"),
    "bf16 d 32": (BF16, BF16, 32, 16, "separate"),
    "int8 d 128 bs 8": (BF16, I8, 128, 8, "separate"),
}


@pytest.mark.parametrize("case", list(FUSES))
def test_which_decodes_fuse_the_append(case):
    q_dtype, kv_dtype, d, bs, want = FUSES[case]
    fuses = ops.decode_fuses_append(q_dtype, kv_dtype, d, bs)
    assert fuses == (want == "fused")
    route = ops.paged_route("decode", q_dtype, kv_dtype, d, bs)
    assert route == ({64: "tma", 128: "tma128"}[d] if fuses else "simt")


def test_fused_counts_are_their_own():
    """The fused wrapper has its own launch count and route keys (its
    launches are told apart from the stand-alone append's and decode's);
    the CPU route counts nothing."""
    ops.reset_launch_counts()
    assert ops.launch_counts()["paged_decode_append_attention"] == 0
    assert ops.route_counts()["paged_decode_append_attention"] == {
        "tma": 0, "simt": 0, "tma128": 0}
    q, kr, vr, pools, tables, ctx, phys, off = _inputs(0, True, 64, 16,
                                                       ONE_SPLIT)
    p = _torch_pools(pools, True)
    ops.paged_decode_append_attention(
        torch.from_numpy(q).to(BF16), torch.from_numpy(kr).to(BF16),
        torch.from_numpy(vr).to(BF16), p[0], p[1], torch.from_numpy(tables),
        torch.from_numpy(ctx), torch.from_numpy(phys), torch.from_numpy(off),
        k_scales=p[2], v_scales=p[3])
    assert not any(ops.launch_counts().values())


BAD = {
    "rows shape": dict(k_rows=lambda a: a[:, :-1]),
    "rows dtype": dict(k_rows=lambda a: a.float(), v_rows=lambda a: a.float()),
    "rows differ in dtype": dict(v_rows=lambda a: a.float()),
    "strided row": dict(k_rows=lambda a: a.repeat_interleave(2, -1)[..., ::2]),
    "phys dtype": dict(phys=lambda a: a.to(torch.int16)),
    "off dtype differs": dict(off=lambda a: a.int()),
    "ctx_lens dtype": dict(ctx_lens=lambda a: a.long()),
    "tables dtype": dict(block_tables=lambda a: a.long()),
    "strided phys": dict(phys=lambda a: a.repeat_interleave(2)[::2],
                         off=lambda a: a.repeat_interleave(2)[::2]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_input_checks_raise_before_writing(case):
    q, kr, vr, pools, tables, ctx, phys, off = _inputs(1, True, 64, 16,
                                                       ONE_SPLIT)
    p = _torch_pools(pools, True)
    before = [t.clone() for t in p]
    args = dict(q=torch.from_numpy(q).to(BF16),
                k_rows=torch.from_numpy(kr).to(BF16),
                v_rows=torch.from_numpy(vr).to(BF16), k_pages=p[0],
                v_pages=p[1], block_tables=torch.from_numpy(tables),
                ctx_lens=torch.from_numpy(ctx), phys=torch.from_numpy(phys),
                off=torch.from_numpy(off))
    for name, fn in BAD[case].items():
        args[name] = fn(args[name])
    with pytest.raises(ValueError):
        ops.paged_decode_append_attention(k_scales=p[2], v_scales=p[3],
                                          **args)
    for a, b in zip(p, before):
        assert torch.equal(_bits(a), _bits(b))


class _OldDecode:
    """The kernels module with the decode step's layer as it was before
    the fold: ``kvcache.append_token``, then ``paged_decode_attention``
    over ctx + 1 keys."""

    def __init__(self, spec):
        self.spec = spec

    def paged_decode_append_attention(self, q, k_rows, v_rows, k_pages,
                                      v_pages, block_tables, ctx_lens, phys,
                                      off, *, scale, k_scales, v_scales):
        pools = {"k": k_pages, "v": v_pages}
        if k_scales is not None:
            pools.update(k_scale=k_scales, v_scale=v_scales)
        KC.append_token(pools, self.spec, k_rows, v_rows, phys, off)
        return ops.paged_decode_attention(
            q, k_pages, v_pages, block_tables, ctx_lens + 1, scale=scale,
            k_scales=k_scales, v_scales=v_scales)

    def __getattr__(self, name):
        return getattr(ops, name)


@pytest.mark.parametrize("cache", ["model", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_decode_bitwise_the_old_composition(dtype, cache,
                                                   monkeypatch):
    cfg = reduced(get_config("flad-adllm")).replace(param_dtype=dtype)
    params = tlm.init(cfg, seed=0, device="cpu")
    slots, bs = 3, 4
    spec = PagedCacheSpec.for_requests(slots, 40, block_size=bs,
                                       quantized=cache == "int8")
    eng = PagedEngine(cfg, spec, max_context=16, slots=slots, device="cpu")
    rng = np.random.default_rng(5)
    # lane 1 dead (table all null, ctx 0), the others mid-block and at a
    # block's first slot
    tables = np.zeros((slots, spec.max_blocks_per_req), np.int32)
    tables[0, :3] = [3, 7, 2]
    tables[2, :4] = [5, 1, 9, 4]
    ctx0 = np.array([9, 0, 12], np.int32)
    base = eng.init_pools()
    for t in base.values():
        x = (rng.integers(-127, 128, t.shape) if t.dtype == I8
             else rng.standard_normal(t.shape) * 1e-2)
        t.copy_(torch.from_numpy(x.astype(np.float32)).to(t.dtype))
    pools = {k: t.clone() for k, t in base.items()}
    old = {k: t.clone() for k, t in base.items()}
    toks = np.array([11, 0, 29], np.int32)
    ctx = ctx0.copy()
    for _ in range(3):
        got, pools = eng.decode(params, pools, toks, tables, ctx)
        with monkeypatch.context() as m:
            m.setattr(engine_mod, "kops", _OldDecode(spec))
            want, old = eng.decode(params, old, toks, tables, ctx)
        assert torch.equal(_bits(got), _bits(want))
        for key in pools:
            assert torch.equal(_bits(pools[key]), _bits(old[key])), key
        toks = torch.argmax(got, -1).to(torch.int32).numpy()
        toks[1] = 0
        ctx = np.where(ctx0 > 0, ctx + 1, 0).astype(np.int32)
