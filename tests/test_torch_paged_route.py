"""Which kernel a card launch of the paged wrappers takes, and over how
many CTAs it splits a lane's keys.

``ops.paged_route`` decides from the dtypes, the head dim and the block
size alone, before any launch: bf16 q over bf16 or int8 pools at head dim
64 whose blocks TMA can land as whole 128-byte-swizzled atoms goes to the
Hopper kernels (decode ``"tma"``: ``csrc/paged_decode_tma.cu``; prefill
``"wgmma"``: ``csrc/paged_prefill_tc.cu``), at head dim 128 to their
own (decode ``"tma128"``: ``csrc/paged_decode_tma128.cu``; prefill
``"wgmma128"``: ``csrc/paged_prefill_tc128.cu``; the same block sizes),
everything else to the SIMT kernels (``"simt"``). The serving paths'
shapes (flad-adllm: head dim 64; the dense configs: head dim 128; block
size 16, bf16 q over bf16 or int8 pools) must all take the Hopper
kernels; float32 q must not. The speculative verify takes the prefill's
route. ``ops.paged_splits`` sizes the grid's split axis from the keys a
call can see: decode's table width, prefill's ctx_len. Runs on the CPU:
no kernel is launched.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8

#: (q dtype, pool dtype, head dim, block size) -> the route of decode
#: and prefill ("fast": "tma" and "wgmma"; a pair: decode's, prefill's)
ROUTES = {
    "serving bf16 cache": (BF16, BF16, 64, 16, "fast"),
    "serving int8 cache": (BF16, I8, 64, 16, "fast"),
    "bf16 bs 8": (BF16, BF16, 64, 8, "fast"),
    "bf16 bs 32": (BF16, BF16, 64, 32, "fast"),
    "bf16 bs 64": (BF16, BF16, 64, 64, "fast"),
    "int8 bs 32": (BF16, I8, 64, 32, "fast"),
    "int8 bs 64": (BF16, I8, 64, 64, "fast"),
    # an int8 block of 8 keys is 512 bytes: half a swizzle atom
    "int8 bs 8": (BF16, I8, 64, 8, "simt"),
    # blocks that do not tile a 64-key stage, or no whole 8-row atom
    "bf16 bs 4": (BF16, BF16, 64, 4, "simt"),
    "bf16 bs 24": (BF16, BF16, 64, 24, "simt"),
    "bf16 bs 128": (BF16, BF16, 64, 128, "simt"),
    # head dim 32 keeps the SIMT kernels; at 128 both kinds take their
    # TMA-fed kernels (two 128-byte boxes a bf16 block, one an int8 block):
    # decode on the CUDA cores, prefill on wgmma
    "bf16 d 32": (BF16, BF16, 32, 16, "simt"),
    "bf16 d 128": (BF16, BF16, 128, 16, ("tma128", "wgmma128")),
    "int8 d 128": (BF16, I8, 128, 16, ("tma128", "wgmma128")),
    "bf16 d 128 bs 8": (BF16, BF16, 128, 8, ("tma128", "wgmma128")),
    "bf16 d 128 bs 32": (BF16, BF16, 128, 32, ("tma128", "wgmma128")),
    "bf16 d 128 bs 64": (BF16, BF16, 128, 64, ("tma128", "wgmma128")),
    "int8 d 128 bs 32": (BF16, I8, 128, 32, ("tma128", "wgmma128")),
    "int8 d 128 bs 64": (BF16, I8, 128, 64, ("tma128", "wgmma128")),
    # the 128-wide blocks the route refuses: no whole 8-line atom, no
    # whole number of blocks a 64-key stage, int8 scales of eight keys (a
    # stage's eight 128-byte scale slots would not fit its row)
    "bf16 d 128 bs 4": (BF16, BF16, 128, 4, "simt"),
    "bf16 d 128 bs 24": (BF16, BF16, 128, 24, "simt"),
    "bf16 d 128 bs 128": (BF16, BF16, 128, 128, "simt"),
    "int8 d 128 bs 8": (BF16, I8, 128, 8, "simt"),
    "float32 d 128": (F32, F32, 128, 16, "simt"),
    "float32 q, int8 pools d 128": (F32, I8, 128, 16, "simt"),
    # float32 q: the float32 oracle's route
    "float32": (F32, F32, 64, 16, "simt"),
    "float32 q, int8 pools": (F32, I8, 64, 16, "simt"),
}


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("case", ROUTES)
def test_route_choice(case, kind):
    q_dtype, kv_dtype, d, bs, route = ROUTES[case]
    if isinstance(route, tuple):
        want = route[kind == "prefill"]
    else:
        want = ops.PAGED_ROUTES[kind] if route == "fast" else "simt"
    assert ops.paged_route(kind, q_dtype, kv_dtype, d, bs) == want


#: (keys a call can see, (lane, KV head) pairs) -> (CTAs a pair splits
#: them over, keys each): 384 keys a split at least, up to 256 CTAs a call
#: and 64 splits a pair, then longer splits
SPLITS = {(1, 1): (1, 384), (128, 1): (1, 384), (384, 1): (1, 384),
          (385, 1): (2, 384), (768, 1): (2, 384), (769, 1): (3, 384),
          (4096, 1): (11, 384), (24576, 1): (64, 384),
          (24577, 1): (55, 448), (100000, 1): (63, 1600),
          # the serving shapes: decode's 8 lanes x 8 KV heads (tables of
          # 128 and 320 keys, and 4096); prefill's 8 KV heads x one 32-row
          # tile (ctx 295, 392 and 4096)
          (128, 64): (1, 384), (320, 64): (1, 384), (4096, 64): (4, 1024),
          (295, 8): (1, 384), (392, 8): (2, 384), (4096, 8): (11, 384),
          (4096, 300): (1, 4096),
          # the CPU emulation's decode: 6 lanes x 2 KV heads, 928 keys
          (928, 12): (3, 384)}


@pytest.mark.parametrize("keys,heads", SPLITS)
def test_split_plan(keys, heads):
    n, per = ops.paged_splits(keys, heads)
    assert (n, per) == SPLITS[keys, heads]
    assert per % 64 == 0 and n <= ops.MAX_SPLITS
    assert (n - 1) * per < keys <= n * per      # no split is empty


#: the head_dim-128 prefill's plan (``ops.prefill_splits("wgmma128",
#: keys, Hkv * row tiles)``): one CTA up to 256 keys (four tiles), past
#: them one 64-key tile a CTA at least, up to 128 CTAs a call: the serving
#: chunks (ctx 16, 112, 256, 257, 295, 384, 385 over 8 KV heads), 4096
#: keys, a verify of 8 lanes over 320-key tables, one KV head
PREFILL128_SPLITS = {(16, 8): (1, 256), (112, 8): (1, 256),
                     (256, 8): (1, 256), (257, 8): (5, 64),
                     (295, 8): (5, 64), (384, 8): (6, 64),
                     (385, 8): (7, 64), (4096, 8): (16, 256),
                     (320, 64): (2, 192), (897, 1): (15, 64),
                     (8192, 1): (64, 128)}


@pytest.mark.parametrize("keys,heads", PREFILL128_SPLITS)
def test_prefill128_split_plan(keys, heads):
    n, per = ops.prefill_splits("wgmma128", keys, heads)
    assert (n, per) == PREFILL128_SPLITS[keys, heads]
    assert per % 64 == 0 and n <= ops.MAX_SPLITS
    assert n == 1 or n * heads <= 128
    assert (n - 1) * per < keys <= n * per
    assert ops.prefill_splits("wgmma", keys, heads) == ops.paged_splits(
        keys, heads)


def test_serving_table_runs_one_split():
    """The serving path's tables (max_context 128, block 16: 8 slots)
    launch one CTA a (lane, KV head): nothing to merge."""
    assert ops.paged_splits(8 * 16, 8 * 8) == (1, ops.SPLIT_KEYS)


def test_cpu_calls_count_no_route():
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 4, 16, 64)).astype(
        np.float32)).to(BF16)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(
        np.float32)).to(BF16)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    ctx = torch.tensor([20, 5], dtype=torch.int32)
    before = ops.route_counts()
    ops.paged_decode_attention(q, k, k, tables, ctx)
    ops.paged_prefill_attention(q[0][:, None].expand(4, 4, 64).contiguous(),
                                k, k, tables[0], 16, 20)
    assert ops.route_counts() == before
    assert set(before["paged_decode_attention"]) == {"tma", "tma128", "simt"}
    assert set(before["paged_prefill_attention"]) == {"wgmma", "wgmma128",
                                                      "simt"}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("d,want", [(64, "wgmma"), (128, "wgmma128"),
                                    (32, "simt")])
@pytest.mark.parametrize("wrapper", ["prefill", "verify"])
def test_prefill_and_verify_launch_on_the_route(monkeypatch, wrapper, d,
                                                want, kv):
    """A card call of paged prefill and of the batched verify reaches the
    launch on the prefill route ``ops.paged_route`` names for its head
    dim (the dense configs' 128: "wgmma128"), with P split in two bf16
    parts for the verify and for a chunk on a route whose
    ``ops.PREFILL_KERNELS`` entry splits P (head dim 128), and counts it
    under that route. The launch itself is replaced: it records its route
    and returns q's shape."""
    launched = []

    def launch(route, q, *args, split_p):
        launched.append((route, split_p))
        return torch.empty_like(q)

    fn = (ops.paged_prefill_attention if wrapper == "prefill"
          else ops.paged_verify_attention)
    monkeypatch.setattr(ops, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(ops, "_prefill_launch", launch)
    monkeypatch.setattr(fn, "routes", dict(fn.routes))
    monkeypatch.setattr(fn, "launches", fn.launches)
    rng = np.random.default_rng(2)
    hq, hkv, bs, c = 40, 8, 16, 5
    shape = (hkv, 4, bs, d)
    if kv == "int8":
        k = torch.tensor(rng.integers(-127, 128, shape), dtype=I8)
        kw = dict(k_scales=torch.ones(shape[:3] + (1,)),
                  v_scales=torch.ones(shape[:3] + (1,)))
    else:
        k = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(BF16)
        kw = {}
    if wrapper == "prefill":
        q = torch.zeros((hq, c, d), dtype=BF16)
        out = fn(q, k, k, torch.tensor([1, 2], dtype=torch.int32), 20, 25,
                 **kw)
    else:
        q = torch.zeros((2, hq, c, d), dtype=BF16)
        tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
        out = fn(q, k, k, tables, torch.tensor([20, 5], dtype=torch.int32),
                 torch.tensor([5, 3], dtype=torch.int32), **kw)
    assert out.shape == q.shape
    chunk_split = want != "simt" and ops.PREFILL_KERNELS[want].split_p
    assert launched == [(want, wrapper == "verify" or chunk_split)]
    assert chunk_split == (d == 128)
    assert ops.route_counts()[fn.__name__][want] == 1
