"""The flash-attention and dequantize wrappers of the port on the CPU
(their plain versions) against the reference's Pallas kernels in
interpret mode, on the same numpy inputs: forward o and lse and backward
dq/dk/dv/delta at atol 1e-5 (float32 math on both sides, in different
orders), for causal, windowed, offset (Sq < Skv) and ragged cases; the
autograd wrapper against ``torch.autograd.gradcheck`` in float64; the
dequantizer bitwise; and the wrappers' input checks and no-fallback
rule."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import quantize as jqz
from repro_torch.kernels import ops, ref

ATOL = 1e-5

#: (Sq, Skv, mask options): causal, windowed, q_offset > 0 (Sq < Skv), a
#: ragged length that is no multiple of the 16-row tiles, and no mask at
#: all (the FHDP step's attention) with Sq < Skv
CASES = {
    "causal": (64, 64, dict(causal=True)),
    "window": (48, 48, dict(causal=True, window=9)),
    "offset": (40, 64, dict(causal=True, q_offset=24)),
    "ragged": (37, 37, dict(causal=True)),
    "noncausal": (40, 64, dict(causal=False)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny CPU ops: a thread pool only adds contention under xdist
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, sq, skv, b=2, hq=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def _close(want, got, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_flash_forward_matches_pallas(case):
    sq, skv, kw = CASES[case]
    q, k, v, _ = _qkv(0, sq, skv)
    o, lse = jfa.flash_attention(q, k, v, block_q=16, block_k=16,
                                 return_lse=True, interpret=True, **kw)
    T = torch.from_numpy
    got_o, got_lse = ops.flash_attention(T(q), T(k), T(v), return_lse=True,
                                         **kw)
    _close(o, got_o)
    _close(lse, got_lse)
    assert torch.equal(ops.flash_attention(T(q), T(k), T(v), **kw), got_o)


@pytest.mark.parametrize("case", CASES)
def test_flash_backward_matches_pallas(case):
    sq, skv, kw = CASES[case]
    q, k, v, do = _qkv(1, sq, skv)
    o, lse = jfa.flash_attention(q, k, v, block_q=16, block_k=16,
                                 return_lse=True, interpret=True, **kw)
    want = jfa.flash_attention_bwd(q, k, v, o, lse, do, block_q=16,
                                   block_k=16, interpret=True, **kw)
    T = torch.from_numpy
    got = ops.flash_attention_bwd(T(q), T(k), T(v), T(np.array(o)),
                                  T(np.array(lse)), T(do), **kw)
    for w, g in zip(want, got):
        _close(w, g)
    delta = ops.flash_attention_bwd_preprocess(T(np.array(o)), T(do))
    _close((np.asarray(o) * do).sum(-1), delta)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                         window=5),
                                dict(causal=False, q_offset=3)],
                         ids=["causal", "window", "full"])
def test_flash_autograd_gradcheck(kw):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 7, 32), generator=g, dtype=torch.float64)
    k = torch.randn((1, 1, 10, 32), generator=g, dtype=torch.float64)
    v = torch.randn((1, 1, 10, 32), generator=g, dtype=torch.float64)
    kw = dict(kw, q_offset=3)

    def fn(q, k, v):
        return ops.flash_attention_ad(q, k, v, **kw)

    assert torch.autograd.gradcheck(
        fn, tuple(t.requires_grad_() for t in (q, k, v)), atol=1e-6)


def test_dequantize_matches_pallas_bitwise():
    rng = np.random.default_rng(2)
    m = 300
    q = rng.integers(-127, 128, (m, ops.LANES)).astype(np.int8)
    scale = (rng.uniform(1e-6, 1e2, (m, 1))
             * rng.choice([0.0, 1.0], (m, 1), p=[0.1, 0.9])
             ).astype(np.float32)
    want = np.asarray(jqz.dequantize_int8(q, scale, interpret=True))
    got = ops.dequantize_int8(torch.from_numpy(q), torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_new_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no plain version: every new wrapper raises, and no launch
    is counted."""
    m = torch.device("meta")
    q = torch.zeros((1, 2, 8, 32), device=m)
    kv = torch.zeros((1, 1, 8, 32), device=m)
    stats = torch.zeros((1, 2, 8), device=m)
    calls = [
        lambda: ops.flash_attention(q, kv, kv),
        lambda: ops.flash_attention_bwd_preprocess(q, q),
        lambda: ops.flash_attention_bwd_dkv(q, kv, kv, q, stats, stats),
        lambda: ops.flash_attention_bwd_dq(q, kv, kv, q, stats, stats),
        lambda: ops.dequantize_int8(
            torch.zeros((4, ops.LANES), dtype=torch.int8, device=m),
            torch.zeros((4, 1), device=m)),
        lambda: ops.lora_matmul(
            torch.zeros((4, 8), device=m), torch.zeros((8, 6), device=m),
            torch.zeros((8, 2), device=m), torch.zeros((2, 6), device=m)),
        lambda: ops.mlstm_chunked(q, q, q, stats, stats),
        lambda: ops.mlstm_chunked_bwd(q, q, q, stats, stats, q, q, (q,) * 5),
        lambda: ops.quantize_kv_append(
            *[torch.zeros((2, 3, 4, 32), dtype=torch.int8, device=m)
              for _ in "kv"],
            *[torch.zeros((2, 3, 4, 1), device=m) for _ in "kv"],
            *[torch.zeros((2, 5, 32), device=m) for _ in "kv"],
            *[torch.zeros(5, dtype=torch.int64, device=m) for _ in "po"]),
        lambda: ops.paged_verify_attention(
            q, kv, kv, torch.zeros((1, 3), dtype=torch.int32,
                                   device=m),
            *[torch.zeros(1, dtype=torch.int32, device=m) for _ in "cl"]),
        lambda: ops.paged_decode_append_attention(
            torch.zeros((1, 2, 32), device=m),
            *[torch.zeros((1, 1, 32), device=m) for _ in "kv"],
            kv, kv, torch.zeros((1, 3), dtype=torch.int32, device=m),
            torch.zeros(1, dtype=torch.int32, device=m),
            *[torch.zeros(1, dtype=torch.int64, device=m) for _ in "po"]),
    ]
    before = ops.launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="no kernel"):
            call()
    assert ops.launch_counts() == before
    assert len(ops.KERNELS) == 14


def test_wrappers_check_their_inputs():
    q = torch.zeros((1, 2, 8, 32))
    kv = torch.zeros((1, 1, 8, 32))
    for bad in (dict(window=0), dict(block_q=0)):
        with pytest.raises(ValueError):
            ops.flash_attention(q, kv, kv, **bad)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(torch.zeros((1, 2, 8, 48)),
                            torch.zeros((1, 1, 8, 48)),
                            torch.zeros((1, 1, 8, 48)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(torch.zeros((1, 2, 32, 8)).transpose(2, 3),
                            kv, kv)
    with pytest.raises(ValueError, match="int8"):
        ops.dequantize_int8(torch.zeros((4, ops.LANES)),
                            torch.zeros((4, 1)))
    assert ref.flash_attention_ref(q, kv, kv).shape == q.shape


