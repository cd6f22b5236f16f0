"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode, on the same
numpy inputs: paged decode and chunked paged prefill attention (atol 1e-5,
float32 math on both sides) and the int8 quantizer (bitwise); and every
ctypes binding against the C entry point it calls."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(rng, hkv, nb, bs, d, int8):
    """Random pools with the null block 0 poisoned by NaN (values for
    float pools, scales for int8 pools)."""
    shape = (hkv, nb, bs, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, shape[:3] + (1,)).astype(np.float32)
        ks[:, 0] = np.nan
        vs[:, 0] = np.nan
        return k, v, ks, vs
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[:, 0] = np.nan
    v[:, 0] = np.nan
    return k, v, None, None


def _tables(rng, ctx_list, bs, spare_slots=1):
    """Lane tables over shuffled physical blocks; dead slots -> block 0."""
    need = [-(-c // bs) for c in ctx_list]
    t = max(need) + spare_slots
    nb = 1 + sum(need) + 1
    phys = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(ctx_list), t), np.int32)
    i = 0
    for lane, n in enumerate(need):
        tables[lane, :n] = phys[i:i + n]
        i += n
    return tables, nb


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa2", "mha"])
def test_paged_decode_matches_reference_kernel(hq, hkv, int8):
    """Dead lanes (ctx 0, table all null), a full block, partial blocks
    and a NaN-poisoned null block behind every dead slot."""
    rng = np.random.default_rng(7 + hq * hkv + int8)
    bs, d = 8, 32
    ctx_list = [0, 5, 8, 17, 0, 23]
    tables, nb = _tables(rng, ctx_list, bs)
    k, v, ks, vs = _pools(rng, hkv, nb, bs, d, int8)
    q = rng.standard_normal((len(ctx_list), hq, d)).astype(np.float32)
    ctx = np.asarray(ctx_list, np.int32)
    want = np.asarray(jops.paged_decode_attention(
        _j(q), _j(k), _j(v), _j(tables), _j(ctx), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True))
    got = ops.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(tables), _t(ctx), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[ctx == 0].any()          # ctx 0 lanes: exact zeros


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("q_offset,chunk_len", [(0, 8), (8, 8), (16, 3)],
                         ids=["first", "middle", "partial-last"])
def test_paged_prefill_matches_reference_kernel(q_offset, chunk_len, int8):
    """A C-row chunk at q_offset through one lane's table; rows past
    chunk_len are garbage by contract and not compared."""
    rng = np.random.default_rng(11 + q_offset + int8)
    hq, hkv, d, bs, c = 4, 2, 32, 8, 8
    ctx_len = q_offset + chunk_len
    tables, nb = _tables(rng, [19], bs, spare_slots=2)
    k, v, ks, vs = _pools(rng, hkv, nb, bs, d, int8)
    q = rng.standard_normal((hq, c, d)).astype(np.float32)
    want = np.asarray(jops.paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(tables[0]), q_offset, ctx_len,
        k_scales=_j(ks), v_scales=_j(vs), interpret=True))
    got = ops.paged_prefill_attention(
        _t(q), _t(k), _t(v), _t(tables[0]), q_offset, ctx_len,
        k_scales=_t(ks), v_scales=_t(vs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :chunk_len], want[:, :chunk_len],
                               rtol=0, atol=ATOL)


def _quant_inputs(rng, bits_kind):
    m = 200
    x = (rng.standard_normal((m, ops.LANES))
         * rng.uniform(1e-3, 1e3, (m, 1))).astype(np.float32)
    x[3] = 0.0                             # all-zero row -> scale 0, q 0
    x[7, 32:] = 0.0                        # a zero-padded head_dim-32 row
    x[9, :] = x[9, 0]                      # every lane at the absmax
    if bits_kind == "pinned":
        bits = np.full((m, ops.LANES), 1 << 31, np.uint32)
    else:
        bits = rng.integers(0, 2 ** 32, (m, ops.LANES),
                            dtype=np.uint64).astype(np.uint32)
        bits[0, :4] = [0, 1, 2 ** 32 - 1, 2 ** 31 - 1]
    return x, bits


@pytest.mark.parametrize("bits_kind", ["random", "pinned"])
def test_quantize_int8_bitwise(bits_kind):
    x, bits = _quant_inputs(np.random.default_rng(3), bits_kind)
    wq, ws = jops.quantize_int8(jnp.asarray(x), jnp.asarray(bits),
                                interpret=True)
    gq, gs = ops.quantize_int8(torch.from_numpy(x), torch.from_numpy(bits))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32),
                                  np.asarray(ws).view(np.uint32))
    assert gs[3].item() == 0.0 and not gq[3].any()


def test_dequantize_int8_ref_matches_reference():
    x, bits = _quant_inputs(np.random.default_rng(5), "random")
    q, s = ops.quantize_int8(torch.from_numpy(x), torch.from_numpy(bits))
    want = jops.dequantize_int8(jnp.asarray(q.numpy()),
                                jnp.asarray(s.numpy()), interpret=True)
    np.testing.assert_array_equal(ref.dequantize_int8_ref(q, s).numpy(),
                                  np.asarray(want))


def _meta_calls():
    q = torch.empty((2, 4, 32), device="meta")
    pools = torch.empty((2, 5, 8, 32), device="meta")
    tables = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    ctx = torch.zeros((2,), dtype=torch.int32, device="meta")
    x = torch.empty((4, ops.LANES), device="meta")
    bits = torch.empty((4, ops.LANES), dtype=torch.uint32, device="meta")
    return [
        ("paged_decode_attention_ref",
         lambda: ops.paged_decode_attention(q, pools, pools, tables, ctx)),
        ("paged_prefill_attention_ref",
         lambda: ops.paged_prefill_attention(
             torch.empty((4, 1, 32), device="meta"), pools, pools,
             tables[0], 0, 1)),
        ("quantize_int8_ref", lambda: ops.quantize_int8(x, bits)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrappers_never_fall_back(which, monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device with no kernel must not run the plain version."""
    name, call = _meta_calls()[which]
    ran = []
    monkeypatch.setattr(ref, name, lambda *a, **k: ran.append(name))
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no kernel"):
        call()
    assert ran == [] and ops.launch_counts() == before


def test_plain_route_counts_no_launch():
    rng = np.random.default_rng(0)
    x, bits = _quant_inputs(rng, "pinned")
    before = ops.launch_counts()
    ops.quantize_int8(torch.from_numpy(x), torch.from_numpy(bits))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "scales"])
def test_wrappers_check_their_inputs(bad):
    rng = np.random.default_rng(1)
    tables, nb = _tables(rng, [5, 9], 8)
    k, v, _, _ = _pools(rng, 2, nb, 8, 32, False)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    tables, ctx = torch.from_numpy(tables), torch.tensor([5, 9],
                                                         dtype=torch.int32)
    kw = {}
    if bad == "dtype":
        tables = tables.long()
    elif bad == "shape":
        q = q[..., :16].contiguous()
    elif bad == "contiguity":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        kw = dict(k_scales=torch.ones(k.shape[:3] + (1,)),
                  v_scales=torch.ones(k.shape[:3] + (1,)))
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, k, v, tables, ctx, **kw)


#: C parameter type -> the ctypes type its binding must declare
_CTYPES = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "float": ctypes.c_float, "int": ctypes.c_int}


@pytest.mark.parametrize("stem", list(build.SIGNATURES))
def test_binding_matches_the_entry_point(stem):
    """Each library's ctypes argtypes match its extern "C" entry point,
    parameter by parameter (a wrong one would pass garbage to the
    launch without an error)."""
    name, argtypes = build.SIGNATURES[stem]
    src = (build.CSRC / f"{stem}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert m, f"no entry point {name} in csrc/{stem}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = ["ptr" if "*" in p else p.rsplit(" ", 1)[0] for p in params]
    assert [_CTYPES[k] for k in kinds] == list(argtypes), params
