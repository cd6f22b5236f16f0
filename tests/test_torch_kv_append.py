"""The int8 KV cache's fused append (``ops.quantize_kv_append``) on the CPU.

Its plain version (``ref.quantize_kv_append_ref``) is what the CPU route
runs and what ``csrc/kv_append_int8.cu`` is held to on the card, bitwise
outside the null block. Here it is held bitwise to the composition the
serving path ran before the fused kernel (``kvcache.quantize_rows`` on
rows zero-padded to 128 lanes with the pinned word 2**31, then four
scatters) and to the JAX reference's ``serve/kvcache`` append and
prefill write, for bf16 and float32 rows at head_dim 64 (under the 128
lanes): the decode append's shape, a prefill chunk's and the monolithic
prefill's all-layers write through a table. The wrapper's input checks
raise before anything is written.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serve import kvcache as JKC
from repro_torch.kernels import ops, ref
from repro_torch.serve import kvcache as KC

L, HKV, NB, BS, D = 3, 4, 12, 16, 64
SPEC = KC.PagedCacheSpec(num_blocks=NB, block_size=BS, max_blocks_per_req=6,
                         quantized=True)
JSPEC = JKC.PagedCacheSpec(num_blocks=NB, block_size=BS,
                           max_blocks_per_req=6, quantized=True)


def _pools(rng, lead):
    """Random int8 pools and scales (block 0, the null block, included)."""
    shape = (*lead, NB, BS, D)
    return {"k": rng.integers(-127, 128, shape).astype(np.int8),
            "v": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.random((*lead, NB, BS, 1), dtype=np.float32),
            "v_scale": rng.random((*lead, NB, BS, 1), dtype=np.float32)}


def _rows(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[..., 1, :] = 0.0                         # an all-zero row
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _old_append(pools, k, v, phys, off):
    """kvcache.append_token's int8 branch before the fused kernel."""
    kq, ks = KC.quantize_rows(k)
    vq, vs = KC.quantize_rows(v)
    phys, off = phys.long(), off.long()
    pools["k"][:, phys, off] = kq
    pools["v"][:, phys, off] = vq
    pools["k_scale"][:, phys, off] = ks
    pools["v_scale"][:, phys, off] = vs


def _old_prefill(pools, k, v, table):
    """kvcache.write_prefill's int8 branch before the fused kernel."""
    s = k.shape[2]
    pad = (-s) % BS
    kb = torch.nn.functional.pad(k, (0, 0, 0, pad)).reshape(L, HKV, -1, BS, D)
    vb = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(L, HKV, -1, BS, D)
    row = table[:kb.shape[2]].long()
    kq, ks = KC.quantize_rows(kb)
    vq, vs = KC.quantize_rows(vb)
    pools["k"][:, :, row] = kq
    pools["v"][:, :, row] = vq
    pools["k_scale"][:, :, row] = ks
    pools["v_scale"][:, :, row] = vs


def _same_outside_null(got, want, lead):
    live = (slice(None),) * lead + (slice(1, None),)
    for key in ("k", "v", "k_scale", "v_scale"):
        a = np.asarray(got[key])[live]
        b = np.asarray(want[key])[live]
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8 if a.itemsize == 1 else np.uint32),
            b.view(np.uint8 if b.itemsize == 1 else np.uint32)), key


# (rows, lane-or-chunk positions): a decode step of 6 lanes with a dead
# one at (null, 0), and a 16-row prefill chunk with 7 live rows
APPEND_CASES = {
    "decode": (np.array([3, 5, 0, 7, 9, 11]), np.array([0, 15, 0, 4, 8, 2])),
    "chunk": (np.where(np.arange(16) < 7, 6, 0).astype(np.int64),
              np.arange(16) % BS),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_append_ref_matches_old_composition_and_reference(case, dtype):
    rng = np.random.default_rng(1)
    phys, off = APPEND_CASES[case]
    base = _pools(rng, (HKV,))
    k = _rows(rng, (HKV, len(phys), D), dtype)
    v = _rows(rng, (HKV, len(phys), D), dtype)
    new = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    old = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    ref.quantize_kv_append_ref(new["k"], new["v"], new["k_scale"],
                               new["v_scale"], _torch(k, dtype),
                               _torch(v, dtype), torch.from_numpy(phys),
                               torch.from_numpy(off))
    _old_append(old, _torch(k, dtype), _torch(v, dtype),
                torch.from_numpy(phys), torch.from_numpy(off))
    _same_outside_null(new, old, 1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jout = JKC.append_token({key: jnp.asarray(t) for key, t in base.items()},
                            JSPEC, jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                            jnp.asarray(phys, jnp.int32),
                            jnp.asarray(off, jnp.int32))
    _same_outside_null(new, jout, 1)
    # through the serving path's own call, on the CPU route
    mine = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    KC.append_token(mine, SPEC, _torch(k, dtype), _torch(v, dtype),
                    torch.from_numpy(phys), torch.from_numpy(off))
    _same_outside_null(mine, new, 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [37, 48])
def test_prefill_ref_matches_old_composition_and_reference(s, dtype):
    """Every layer's K/V through a table whose fourth block is the null
    block; 37 rows leave the last block partly padded."""
    rng = np.random.default_rng(2)
    table = np.array([5, 2, 9, 0, 0, 0], np.int32)
    base = _pools(rng, (L, HKV))
    k = _rows(rng, (L, HKV, s, D), dtype)
    v = _rows(rng, (L, HKV, s, D), dtype)
    new = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    old = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    ref.quantize_kv_append_ref(new["k"], new["v"], new["k_scale"],
                               new["v_scale"], _torch(k, dtype),
                               _torch(v, dtype), table=torch.from_numpy(table))
    _old_prefill(old, _torch(k, dtype), _torch(v, dtype),
                 torch.from_numpy(table))
    _same_outside_null(new, old, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jout = JKC.write_prefill({key: jnp.asarray(t) for key, t in base.items()},
                             JSPEC, jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                             jnp.asarray(table))
    _same_outside_null(new, jout, 2)
    mine = {key: torch.from_numpy(t.copy()) for key, t in base.items()}
    KC.write_prefill(mine, SPEC, _torch(k, dtype), _torch(v, dtype),
                     torch.from_numpy(table))
    _same_outside_null(mine, new, 2)


def _args(**over):
    """Valid decode-append arguments with ``over`` replacing some."""
    pools = [torch.zeros((HKV, NB, BS, D), dtype=torch.int8) for _ in "kv"] \
        + [torch.zeros((HKV, NB, BS, 1)) for _ in "kv"]
    kw = dict(k_pool=pools[0], v_pool=pools[1], k_scale=pools[2],
              v_scale=pools[3], k_rows=torch.randn(HKV, 4, D),
              v_rows=torch.randn(HKV, 4, D),
              phys=torch.tensor([1, 2, 3, 4]), off=torch.tensor([0, 1, 2, 3]))
    kw.update(over)
    return kw


BAD = {
    "pool-not-int8": dict(k_pool=torch.zeros((HKV, NB, BS, D))),
    "pools-differ": dict(v_pool=torch.zeros((HKV, NB, BS, 32),
                                            dtype=torch.int8)),
    "head-dim-over-128": dict(
        k_pool=torch.zeros((HKV, NB, BS, 256), dtype=torch.int8),
        v_pool=torch.zeros((HKV, NB, BS, 256), dtype=torch.int8)),
    "scale-shape": dict(k_scale=torch.zeros((HKV, NB, BS))),
    "scale-dtype": dict(v_scale=torch.zeros((HKV, NB, BS, 1),
                                            dtype=torch.float64)),
    "rows-dtype": dict(k_rows=torch.randn(HKV, 4, D).half(),
                       v_rows=torch.randn(HKV, 4, D).half()),
    "rows-lead": dict(k_rows=torch.randn(2, 4, D), v_rows=torch.randn(2, 4, D)),
    "rows-differ": dict(v_rows=torch.randn(HKV, 5, D)),
    "phys-length": dict(phys=torch.tensor([1, 2, 3])),
    "phys-dtype": dict(phys=torch.tensor([1.0, 2, 3, 4]),
                       off=torch.tensor([0.0, 1, 2, 3])),
    "off-dtype-differs": dict(off=torch.tensor([0, 1, 2, 3],
                                               dtype=torch.int32)),
    "no-index": dict(phys=None, off=None),
    "both-indexings": dict(table=torch.tensor([1, 2], dtype=torch.int32)),
    "short-table": dict(phys=None, off=None,
                        table=torch.zeros(0, dtype=torch.int32)),
    "rows-not-contiguous": dict(k_rows=torch.randn(HKV, D, 4).transpose(1, 2),
                                v_rows=torch.randn(HKV, D, 4).transpose(1, 2)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_bad_inputs(case):
    kw = _args(**BAD[case])
    before = [t.clone() for t in (kw["k_pool"], kw["v_pool"])]
    with pytest.raises(ValueError):
        ops.quantize_kv_append(**kw)
    assert all(torch.equal(a, b) for a, b in
               zip(before, (kw["k_pool"], kw["v_pool"])))


def test_rows_read_through_their_strides():
    """K and V as the engine hands them over: a transposed view of the
    projection's [N, Hkv, D] output, written as the contiguous rows are;
    leading dims that cannot flatten in place are refused."""
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.standard_normal((5, HKV, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((5, HKV, D)).astype(np.float32))
    phys, off = torch.tensor([1, 2, 3, 4, 5]), torch.tensor([0, 1, 2, 3, 4])
    got, want = _args(), _args()
    names = ("k_pool", "v_pool", "k_scale", "v_scale")
    ops.quantize_kv_append(*(got[n] for n in names), k.transpose(0, 1),
                           v.transpose(0, 1), phys, off)
    ops.quantize_kv_append(*(want[n] for n in names),
                           k.transpose(0, 1).contiguous(),
                           v.transpose(0, 1).contiguous(), phys, off)
    for n in names:
        assert torch.equal(got[n], want[n])
    pools = [torch.zeros((2, HKV, NB, BS, D), dtype=torch.int8)
             for _ in "kv"] + [torch.zeros((2, HKV, NB, BS, 1)) for _ in "kv"]
    rows = torch.randn(HKV, 2, 3, D).transpose(0, 1)    # [2, Hkv, 3, D]
    with pytest.raises(ValueError):
        ops.quantize_kv_append(*pools, rows, rows,
                               table=torch.tensor([1], dtype=torch.int32))


def test_wrapper_on_the_cpu_is_the_plain_version():
    kw = _args()
    ops.quantize_kv_append(**kw)
    want = _args(k_rows=kw["k_rows"], v_rows=kw["v_rows"])
    ref.quantize_kv_append_ref(*(want[n] for n in (
        "k_pool", "v_pool", "k_scale", "v_scale", "k_rows", "v_rows",
        "phys", "off")))
    for n in ("k_pool", "v_pool", "k_scale", "v_scale"):
        assert torch.equal(kw[n], want[n])
    assert ops.launch_counts()["quantize_kv_append"] == 0
