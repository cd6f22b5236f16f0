"""One wrapper per hand-written kernel (port of ``repro/kernels/ops.py``).

Dispatch is by the device of the tensors and nothing else:

  * tensors on the CPU run the kernel's plain PyTorch version
    (:mod:`repro_torch.kernels.ref`);
  * tensors on a CUDA device launch the kernel — built at first use by
    :mod:`repro_torch.kernels.build` — on the current stream. A failed
    build or launch raises; there is no fallback to the plain version;
  * any other device raises.

Every wrapper checks device, dtype, shape and contiguity on both routes,
and carries a plain integer ``launches`` that counts its kernel launches
(plain-version calls do not count). The flash forward, dK/dV and dQ
wrappers choose their kernel by dtype and head width
(:func:`flash_route`): bf16 at head_dim 64 goes to a tensor-core kernel
(wgmma on TMA-fed tiles); bf16 at head_dim 128 to their own
tensor-core kernels ("wgmma128"); float32 at head_dim 64 to a 3xTF32
wgmma kernel ("tf32x3": every product three tf32 passes, float32's own
error); the rest (float32 at 128, every dtype at 32) to a SIMT kernel.
The LoRA matmul sends bf16 operands that TMA can describe to a wgmma
kernel and the rest to its mma.sync / float32 kernel
(:func:`lora_route`). The paged decode and prefill wrappers send bf16 q
over bf16 or int8 pools at head_dim 64 to TMA-fed kernels that split the
keys over CTAs (decode on the CUDA cores, prefill on wgmma), at head_dim
128 to their own TMA-fed kernels (decode "tma128", prefill "wgmma128", on
wgmma with a 128-row tile), and the rest to their SIMT kernels
(:func:`paged_route`); a serving decode step's layer
(:func:`paged_decode_append_attention`) appends the lanes' new K/V rows
inside the TMA-fed decode kernel's launch (its fused entry point), and
on the SIMT route appends first; the speculative decoder's batched verify
(:func:`paged_verify_attention`) takes the prefill's route, one launch
for all lanes. The chunkwise mLSTM sends float32 and bf16 at head widths
64, 128, 256 and 512 to a 3xTF32 wgmma kernel whose cluster shares S
across a (b, h)'s CTAs, and other widths to its SIMT kernel
(:func:`mlstm_route`); its backward (:func:`mlstm_chunked_bwd`, under
the autograd Function of :func:`mlstm_chunked_ad`) is one SIMT kernel
pair on the CUDA cores. The flash backward's preprocess launches its
16-byte-load kernel on every call ("vec"); its one-warp-a-row kernel
runs only when asked for ("simt"). Their ``routes`` dict counts the
launches of each (:func:`route_counts`). The int8 KV cache's append
outside a TMA-route decode step (prefill chunks, the monolithic prefill,
the verify, the SIMT route) is one launch of its own
(:func:`quantize_kv_append`), the serving route of the quantizer.
"""
from __future__ import annotations

import functools
import operator
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LANES = ref.LANES    #: fixed lane width of the quantization row layout
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128)   #: head widths the attention kernels take
MAX_GROUP = 8                #: kMaxRows: GQA group size a decode CTA serves


def _on_card(*tensors) -> bool:
    """True to launch the kernel, False to run the plain version."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise RuntimeError(f"no kernel and no plain version for device {dev}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _contiguous(**tensors) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _aligned(**tensors) -> None:
    """The kernels read pool rows with 16-byte loads."""
    for name, t in tensors.items():
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


# ------------------------------------------------------- paged attention
SPLIT_KEYS = 384        #: keys of a CTA's split, at least (whole 64s)
MAX_SPLITS = 64         #: splits a (lane, KV head) merges, at most
SPLIT_CTAS = 256        #: CTAs a call splits up to: about two an SM
#: the route key of each paged wrapper's Hopper kernel at head_dim 64:
#: decode runs on the CUDA cores fed by TMA (``csrc/paged_decode_tma.cu``),
#: prefill on wgmma (``csrc/paged_prefill_tc.cu``); both name the SIMT
#: kernel "simt"
PAGED_ROUTES = {"decode": "tma", "prefill": "wgmma"}
#: every Hopper route of each paged kind: each also has its head_dim-128
#: kernel (the dense configs' serving): decode ``csrc/paged_decode_tma128.cu``
#: ("tma128"), prefill ``csrc/paged_prefill_tc128.cu`` ("wgmma128")
PAGED_HOPPER = {"decode": ("tma", "tma128"), "prefill": ("wgmma", "wgmma128")}
#: the head_dim each Hopper paged route takes
PAGED_HEAD_DIM = {"tma": 64, "wgmma": 64, "tma128": 128, "wgmma128": 128}


class PrefillKernel(NamedTuple):
    """A wgmma paged-prefill route's kernel and its work plan."""
    stem: str          #: ``csrc/<stem>.cu``
    rows: int          #: query rows of a CTA (a KV head's G*C rows in tiles)
    whole_keys: int    #: keys one CTA takes without a split, at most
    split_keys: int    #: keys of a CTA's split past them, at least
    split_ctas: int    #: CTAs a call splits up to
    split_p: bool      #: a prefill chunk's P enters P V as two bf16 parts
                       #: (the verify's always does), else rounded once


#: each wgmma paged-prefill route's kernel and plan (:func:`prefill_splits`).
#: Head_dim 64: one warpgroup of 64 rows, the paged kernels' split plan.
#: Head_dim 128: two warpgroups of 64 rows, so that the dense configs'
#: groups of 5-8 at a 16-row chunk (80-128 rows) read each K/V block once;
#: a CTA takes one SM (its Q tile and ring hold 164 KB) and its 128-row
#: products bound it by the tensor cores, so past four tiles a call splits
#: its keys down to one tile a CTA, up to one wave of the H100's 132 SMs
#: (up to four tiles, a split and its merge cost about as much as they
#: save). P is split there for a prefill chunk too: at head_dim 128 one
#: bf16 rounding of P put a qwen3-14b int8-cache prefill row past the card
#: checks' row bound (2^-7 of its largest |value|); the kernel has no
#: rounded-once form
PREFILL_KERNELS = {
    "wgmma": PrefillKernel("paged_prefill_tc", 64, SPLIT_KEYS, SPLIT_KEYS,
                           SPLIT_CTAS, False),
    "wgmma128": PrefillKernel("paged_prefill_tc128", 128, 256, 64, 128,
                              True)}


@functools.lru_cache(maxsize=256)
def paged_route(kind: str, q_dtype, kv_dtype, head_dim: int,
                block_size: int) -> str:
    """The kernel a card launch of paged ``kind`` ("decode" or "prefill")
    takes: a TMA-fed kernel for bf16 q over bf16 or int8 pools whose
    blocks TMA can land as whole 128-byte-swizzled atoms, else "simt"
    (``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``: float32 q, other
    head dims and blocks); each Hopper route of :data:`PAGED_HOPPER`
    [kind] takes the head_dim :data:`PAGED_HEAD_DIM` names. At head_dim
    64 both kinds (route :data:`PAGED_ROUTES` [kind]): a bf16 block of bs
    128-byte rows is one box, whole 1024-byte atoms at block size 8, 16,
    32 or 64; an int8 block (64-byte rows, two a line) at 16, 32 or 64.
    At head_dim 128 both kinds too (decode "tma128", prefill "wgmma128",
    one ring of paged_tma.cuh at DD 128): a bf16 row is 256 bytes, two
    boxes of bs 128-byte lines (whole atoms at bs % 8 == 0: 8, 16, 32,
    64); an int8 row is 128 bytes, one box (whole at bs % 8 == 0 too),
    but int8 takes 16, 32 or 64 as at 64: each block's bs float scales
    land in a 128-byte slot of the stage's scale row, and 64 / 8 blocks
    of eight would not fit it. The dense configs serve at block 16.
    Block sizes must divide the 64-key stage."""
    sizes = (16, 32, 64) if kv_dtype == torch.int8 else (8, 16, 32, 64)
    fast = (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and block_size in sizes)
    for route in PAGED_HOPPER[kind] if fast else ():
        if PAGED_HEAD_DIM[route] == head_dim:
            return route
    return "simt"


@functools.lru_cache(maxsize=1024)
def paged_splits(keys: int, heads: int = 1, min_keys: int = SPLIT_KEYS,
                 ctas: int = SPLIT_CTAS):
    """(CTAs, keys each) each of ``heads`` (lane, KV head) pairs (decode:
    B * Hkv; prefill: Hkv * row tiles) of the TMA-fed kernels splits
    ``keys`` over (decode: the table width T * bs, since ctx_lens lives
    on the device; prefill: min(ctx_len, T * bs)): enough CTAs that the
    call has up to ``ctas`` (:data:`SPLIT_CTAS`), each at least
    ``min_keys`` (:data:`SPLIT_KEYS`) keys, at most :data:`MAX_SPLITS`,
    and a whole number of 64-key tiles. Above one CTA, the last of a pair
    to finish merges the splits' (m, l, acc) in split order."""
    keys = max(1, int(keys))
    n = min(-(-keys // min_keys), max(1, -(-ctas // int(heads))),
            MAX_SPLITS)
    per = max(min_keys, -(-(-(-keys // n)) // 64) * 64)
    return -(-keys // per), per


def prefill_splits(route: str, keys: int, heads: int):
    """(CTAs, keys each) of a wgmma prefill launch on ``route``:
    :func:`paged_splits` on the route's plan (:data:`PREFILL_KERNELS`),
    ``heads`` = Hkv * row tiles (times lanes for the verify): one CTA up
    to ``whole_keys`` keys, past them splits of ``split_keys`` keys at
    least. On the head_dim-64 route both are :data:`SPLIT_KEYS`, the paged
    kernels' plan."""
    k = PREFILL_KERNELS[route]
    least = k.whole_keys if keys <= k.whole_keys else k.split_keys
    return paged_splits(keys, heads, least, k.split_ctas)


def _partial_floats(rows: int, d: int) -> int:
    """Floats of one split's (acc, m, l) for ``rows`` query rows, in
    whole float4s (paged_tma.cuh's partial_floats)."""
    return -(-rows * (d + 2) // 4) * 4


_SCRATCH = {}


def _split_scratch(t, stream: int, nsplit: int, n_heads: int,
                   floats: int):
    """(workspace, counters) of a split launch: ``floats`` float32 per
    (head, split) for the partial results, and an int32 arrival counter
    per head, zero before the launch and reset to zero by the CTA that
    merges. Both are kept per (device, stream) and only grow: launches
    on one stream run in order, so each finds the counters at zero and
    the workspace free. (None, None) when nothing splits."""
    if nsplit == 1:
        return None, None
    key = (t.device, stream)
    ws, ctr = _SCRATCH.get(key, (None, None))
    need = n_heads * nsplit * floats
    if ws is None or ws.numel() < need:
        ws = torch.empty(need, dtype=torch.float32, device=t.device)
    if ctr is None or ctr.numel() < n_heads:
        ctr = torch.zeros(n_heads, dtype=torch.int32, device=t.device)
    _SCRATCH[key] = (ws, ctr)
    return ws, ctr


def _check_pools(q, k_pages, v_pages, k_scales, v_scales):
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q must be float32 or bfloat16, got {q.dtype}")
    _require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
             "k_pages/v_pages must be matching [Hkv, NB, bs, D] pools")
    _require(k_pages.dtype == v_pages.dtype, "k/v pools differ in dtype")
    hkv, _, bs, d = k_pages.shape
    _require(q.numel() > 0, "empty query")
    _require(q.shape[-1] == d, f"head_dim {q.shape[-1]} != pool's {d}")
    _require(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    quantized = k_scales is not None
    _require(quantized == (v_scales is not None),
             "pass both k_scales and v_scales, or neither")
    if quantized:
        _require(k_pages.dtype == torch.int8,
                 "scales are given, so the pools must be int8")
        for s in (k_scales, v_scales):
            _require(s.dtype == torch.float32
                     and tuple(s.shape) == (*k_pages.shape[:3], 1),
                     "scales must be float32 [Hkv, NB, bs, 1]")
        _contiguous(k_scales=k_scales, v_scales=v_scales)
    else:
        _require(k_pages.dtype == q.dtype,
                 f"pools of {k_pages.dtype} need int8 scales or q of that "
                 f"dtype (q is {q.dtype})")
    _contiguous(q=q, k_pages=k_pages, v_pages=v_pages)
    return hkv, bs, d


def _pick_route(kind, route, q, k_pages, bs, d):
    best = paged_route(kind, q.dtype, k_pages.dtype, d, bs)
    route = route or best
    _require(route in (best, "simt"), f"paged {kind}: route {route!r} "
             f"cannot take these operands (it takes {best!r} or 'simt')")
    return route


def paged_decode_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           scale: Optional[float] = None, k_scales=None,
                           v_scales=None):
    """q: [B, Hq, D] decode queries; k_pages/v_pages: [Hkv, NB, bs, D]
    pools (float32/bfloat16 as q, or int8 with ``k_scales``/``v_scales``
    [Hkv, NB, bs, 1] float32); block_tables: [B, T] int32; ctx_lens: [B]
    int32 visible KV lengths (0 returns zeros). Returns [B, Hq, D].

    On the card the kernel follows :func:`paged_route`: bf16 q over bf16
    or int8 pools at head_dim 64 launches ``csrc/paged_decode_tma.cu``
    (keys split over CTAs by :func:`paged_splits`, blocks loaded by TMA),
    at head_dim 128 ``csrc/paged_decode_tma128.cu`` (the same plan, a
    256-byte bf16 row loaded as two boxes, four lanes a key), everything
    else the SIMT kernel; ``paged_decode_attention.routes`` counts the
    launches of each ("tma", "tma128", "simt")."""
    return _paged_decode(q, k_pages, v_pages, block_tables, ctx_lens,
                         scale=scale, k_scales=k_scales, v_scales=v_scales)


def _check_decode(q, k_pages, v_pages, block_tables, ctx_lens, k_scales,
                  v_scales):
    """The paged decode's input checks; returns (Hkv, bs, D)."""
    _require(q.dim() == 3, "q must be [B, Hq, D]")
    hkv, bs, d = _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    b, hq, _ = q.shape
    _require(hq % hkv == 0, f"Hq {hq} is not a multiple of Hkv {hkv}")
    _require(block_tables.dtype == torch.int32 and block_tables.dim() == 2
             and block_tables.shape[0] == b, "block_tables must be [B, T] "
             "int32")
    _require(ctx_lens.dtype == torch.int32 and tuple(ctx_lens.shape) == (b,),
             "ctx_lens must be [B] int32")
    _contiguous(block_tables=block_tables, ctx_lens=ctx_lens)
    _require(hq // hkv <= MAX_GROUP,
             f"GQA group {hq // hkv} > {MAX_GROUP} query heads per KV head")
    return hkv, bs, d


def _paged_decode(q, k_pages, v_pages, block_tables, ctx_lens, *, scale,
                  k_scales, v_scales, route: Optional[str] = None):
    """:func:`paged_decode_attention` on ``route`` (None: the one
    :func:`paged_route` picks; "simt" also takes what the Hopper kernel
    takes, so both can be compared on the same inputs)."""
    hkv, bs, d = _check_decode(q, k_pages, v_pages, block_tables, ctx_lens,
                               k_scales, v_scales)
    b, hq, _ = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    scales = () if k_scales is None else (k_scales, v_scales)
    if not _on_card(q, k_pages, v_pages, block_tables, ctx_lens, *scales):
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, ctx_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    _aligned(k_pages=k_pages, v_pages=v_pages)
    route = _pick_route("decode", route, q, k_pages, bs, d)
    out = torch.empty_like(q)
    nb, t = k_pages.shape[1], block_tables.shape[1]
    if route == "simt":
        err = build.load("paged_decode")(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], _ptr(q),
            _ptr(k_pages), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales),
            _ptr(block_tables), _ptr(ctx_lens), _ptr(out), b, hq, hkv, nb,
            bs, d, t, scale, _stream(q))
    else:
        err = _decode_tma_launch(q, k_pages, v_pages, block_tables,
                                 ctx_lens, scale, k_scales, v_scales, out, b)
    _raise_on(err, f"paged_decode_attention ({route})")
    paged_decode_attention.launches += 1
    paged_decode_attention.routes[route] += 1
    return out


def _decode_tma_launch(q, k_pages, v_pages, block_tables, ctx_lens, scale,
                       k_scales, v_scales, out, plan_lanes: int,
                       rows=None) -> int:
    """One launch of the TMA-fed decode kernel of q's head_dim
    (``csrc/paged_decode_tma.cu`` at 64, ``csrc/paged_decode_tma128.cu``
    at 128; inputs already checked) over q's B lanes, its keys split by
    :func:`paged_splits` as for ``plan_lanes`` lanes (a row's arithmetic
    depends on its lane's keys and that plan only). With ``rows`` =
    (k_rows, v_rows, phys, off) the launch first appends them and attends
    over ctx_lens + 1 keys (:func:`paged_decode_append_attention`).
    Returns the kernel's error code."""
    b, hq, d = q.shape
    hkv, nb, bs, _ = k_pages.shape
    t = block_tables.shape[1]
    stream = _stream(q)
    nsplit, per = paged_splits(t * bs, plan_lanes * hkv)
    ws, ctr = _split_scratch(q, stream, nsplit, b * hkv,
                             _partial_floats(hq // hkv, d))
    stem = {64: "paged_decode_tma", 128: "paged_decode_tma128"}[d]
    if rows is None:
        append = (None, None, None, None, 0, 0, 0, 0, 0)
    else:
        kr, vr, phys, off = rows
        append = (_ptr(kr), _ptr(vr), _ptr(phys), _ptr(off),
                  int(phys.dtype == torch.int64), *kr.stride()[:2],
                  *vr.stride()[:2])
    return build.load(stem)(
        _DTYPE_CODES[k_pages.dtype], _ptr(q), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scales), _ptr(v_scales), _ptr(block_tables), _ptr(ctx_lens),
        _ptr(out), _ptr(ws), _ptr(ctr), *append, b, hq, hkv, nb, bs, t,
        nsplit, per, scale, stream)


def decode_fuses_append(q_dtype, kv_dtype, head_dim: int,
                        block_size: int) -> bool:
    """True when a card call of :func:`paged_decode_append_attention` is
    one launch of a TMA-fed decode kernel that writes the rows itself
    (:func:`paged_route` "tma" or "tma128"); False when the stand-alone
    append goes first and the SIMT decode kernel after it."""
    return (paged_route("decode", q_dtype, kv_dtype, head_dim, block_size)
            in PAGED_HOPPER["decode"])


def paged_decode_append_attention(q, k_rows, v_rows, k_pages, v_pages,
                                  block_tables, ctx_lens, phys, off, *,
                                  scale: Optional[float] = None,
                                  k_scales=None, v_scales=None):
    """A serving decode step's layer: append each lane's new K/V row to the
    pools, in place, then attend over its ctx_lens + 1 keys.

    q: [B, Hq, D]; k_rows/v_rows: [Hkv, B, D] in q's dtype, each row
    contiguous (a transposed view of a projection's output is read in
    place, through its strides); k_pages/v_pages, block_tables, scales as
    :func:`paged_decode_attention`; ctx_lens: [B] int32, the keys before
    the append (the new row's position); phys/off: [B] int32 or int64,
    the slot (block, offset) lane b's row goes to (a dead lane points at
    the null block, 0). Int8 pools take the rows as
    :func:`quantize_kv_append` writes them, other pools a cast copy.
    Returns [B, Hq, D] as ``paged_decode_attention`` over ctx_lens + 1.

    On the card, bf16 q on a TMA-fed decode route (:func:`paged_route`:
    "tma" at head_dim 64, "tma128" at 128) launches that kernel's fused
    entry point once: the CTA holding key ctx of its (lane, KV head)
    writes the rows before it loads them, pools bitwise the stand-alone
    append's and output bitwise the separate append and decode's. Every
    other route (float32 q, other head dims and blocks: "simt") appends
    with :func:`quantize_kv_append` (int8) or two scatters, then launches
    :func:`paged_decode_attention`, whose counts take those launches.
    ``launches`` and ``routes`` ("tma", "tma128"; "simt" stays 0) count
    the fused launches alone."""
    hkv, bs, d = _check_decode(q, k_pages, v_pages, block_tables, ctx_lens,
                               k_scales, v_scales)
    b = q.shape[0]
    _require(k_rows.dtype == q.dtype and v_rows.dtype == q.dtype,
             f"k_rows/v_rows must be {q.dtype}, as q")
    _require(tuple(k_rows.shape) == (hkv, b, d)
             and v_rows.shape == k_rows.shape,
             f"k_rows/v_rows must be [Hkv, B, D] = {(hkv, b, d)}")
    _require(k_rows.stride(-1) == 1 and v_rows.stride(-1) == 1,
             "k_rows/v_rows must have contiguous rows")
    _require(phys.dim() == 1 and tuple(phys.shape) == (b,)
             and off.shape == phys.shape and off.dtype == phys.dtype
             and phys.dtype in (torch.int32, torch.int64),
             "phys and off must be [B] int32 or int64 of one dtype")
    _contiguous(phys=phys, off=off)
    scale = float(scale) if scale is not None else d ** -0.5
    scales = () if k_scales is None else (k_scales, v_scales)
    if not _on_card(q, k_rows, v_rows, k_pages, v_pages, block_tables,
                    ctx_lens, phys, off, *scales):
        return ref.paged_decode_append_attention_ref(
            q, k_rows, v_rows, k_pages, v_pages, block_tables, ctx_lens,
            phys, off, scale=scale, k_scales=k_scales, v_scales=v_scales)
    if not decode_fuses_append(q.dtype, k_pages.dtype, d, bs):
        if k_scales is not None:
            quantize_kv_append(k_pages, v_pages, k_scales, v_scales, k_rows,
                               v_rows, phys, off)
        else:
            p, o = phys.long(), off.long()
            k_pages[:, p, o] = k_rows.to(k_pages.dtype)
            v_pages[:, p, o] = v_rows.to(v_pages.dtype)
        return _paged_decode(q, k_pages, v_pages, block_tables, ctx_lens + 1,
                             scale=scale, k_scales=k_scales,
                             v_scales=v_scales)
    _aligned(k_pages=k_pages, v_pages=v_pages)
    per = d // 16               # elements a lane reads in one vector load
    for name, r in (("k_rows", k_rows), ("v_rows", v_rows)):
        _require(r.stride(0) % per == 0 and r.stride(1) % per == 0
                 and r.data_ptr() % (per * r.element_size()) == 0,
                 f"{name}: plane and row strides must be multiples of {per} "
                 f"and the base {per * r.element_size()}-byte aligned")
    route = paged_route("decode", q.dtype, k_pages.dtype, d, bs)
    out = torch.empty_like(q)
    err = _decode_tma_launch(q, k_pages, v_pages, block_tables, ctx_lens,
                             scale, k_scales, v_scales, out, b,
                             rows=(k_rows, v_rows, phys, off))
    _raise_on(err, f"paged_decode_append_attention ({route})")
    paged_decode_append_attention.launches += 1
    paged_decode_append_attention.routes[route] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_table, q_offset: int,
                            ctx_len: int, *, scale: Optional[float] = None,
                            k_scales=None, v_scales=None):
    """q: [Hq, C, D] query chunk (row c at position q_offset + c);
    k_pages/v_pages: [Hkv, NB, bs, D] pools already holding the chunk's
    own K/V (dtype rules as :func:`paged_decode_attention`); block_table:
    [T] int32; q_offset/ctx_len: host ints (ctx_len = q_offset +
    chunk_len), passed to the kernel as arguments. Returns [Hq, C, D];
    rows past chunk_len are finite garbage.

    On the card the kernel follows :func:`paged_route`: bf16 q over bf16
    or int8 pools at head_dim 64 launches ``csrc/paged_prefill_tc.cu``
    (a KV head's G*C query rows in 64-row tiles, S and P V on wgmma,
    keys split over CTAs by :func:`paged_splits` of ctx_len), at head_dim
    128 ``csrc/paged_prefill_tc128.cu`` (route "wgmma128": 128-row tiles,
    two consumer warpgroups, a 256-byte bf16 row loaded as two boxes, keys
    split down to one 64-key tile a CTA: :func:`prefill_splits`; P into P
    V as two bf16 parts: :data:`PREFILL_KERNELS`),
    everything else the SIMT kernel;
    ``paged_prefill_attention.routes`` counts the launches of each
    ("wgmma", "wgmma128", "simt")."""
    return _paged_prefill(q, k_pages, v_pages, block_table, q_offset,
                          ctx_len, scale=scale, k_scales=k_scales,
                          v_scales=v_scales)


def _paged_prefill(q, k_pages, v_pages, block_table, q_offset, ctx_len, *,
                   scale, k_scales, v_scales, route: Optional[str] = None):
    """:func:`paged_prefill_attention` on ``route``, as
    :func:`_paged_decode`."""
    _require(q.dim() == 3, "q must be [Hq, C, D]")
    hkv, bs, d = _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    hq, c, _ = q.shape
    _require(hq % hkv == 0, f"Hq {hq} is not a multiple of Hkv {hkv}")
    _require(block_table.dtype == torch.int32 and block_table.dim() == 1,
             "block_table must be [T] int32")
    _contiguous(block_table=block_table)
    q_offset, ctx_len = operator.index(q_offset), operator.index(ctx_len)
    _require(0 <= q_offset < ctx_len <= q_offset + c,
             f"need 0 <= q_offset {q_offset} < ctx_len {ctx_len} <= "
             f"q_offset + C")
    scale = float(scale) if scale is not None else d ** -0.5
    scales = () if k_scales is None else (k_scales, v_scales)
    if not _on_card(q, k_pages, v_pages, block_table, *scales):
        return ref.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_table, q_offset, ctx_len, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    route = _pick_route("prefill", route, q, k_pages, bs, d)
    out = _prefill_launch(route, q, k_pages, v_pages, block_table, None,
                          None, q_offset, ctx_len, scale, k_scales, v_scales,
                          "paged_prefill_attention",
                          split_p=(route in PREFILL_KERNELS
                                   and PREFILL_KERNELS[route].split_p))
    paged_prefill_attention.launches += 1
    paged_prefill_attention.routes[route] += 1
    return out


def _prefill_launch(route, q, k_pages, v_pages, tables, lane_ctx, lane_len,
                    q_offset, ctx_len, scale, k_scales, v_scales, name, *,
                    split_p: bool):
    """One launch of the paged prefill kernel on ``route`` (inputs
    already checked): q [B, Hq, C, D] or one chunk's [Hq, C, D], tables
    [B, T] or [T]. Each lane's chunk is [lane_ctx[b], lane_ctx[b] +
    lane_len[b]) from the device, or [q_offset, ctx_len) when the lane
    arrays are None. ``split_p`` (the wgmma routes): P enters P V as two
    bf16 parts (hi, lo), else rounded once to bf16 ("wgmma" only: the
    "wgmma128" kernel refuses it). The route's row tiles
    and split plan are :data:`PREFILL_KERNELS` [route]. Raises on a
    failed launch; returns the output."""
    _aligned(k_pages=k_pages, v_pages=v_pages)
    hkv, nb, bs, d = k_pages.shape
    hq, c = q.shape[-3:-1]
    b, t = (q.shape[0] if q.dim() == 4 else 1), tables.shape[-1]
    out = torch.empty_like(q)
    stream = _stream(q)
    pools = (_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scales),
             _ptr(v_scales), _ptr(tables), _ptr(lane_ctx), _ptr(lane_len),
             _ptr(out))
    if route == "simt":
        err = build.load("paged_prefill")(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], *pools, b,
            hq, hkv, nb, bs, d, t, c, q_offset, ctx_len, scale, stream)
    else:
        _aligned(q=q)
        kern = PREFILL_KERNELS[route]
        tiles = b * -(-(hq // hkv * c) // kern.rows)
        keys = t * bs if lane_ctx is not None else min(ctx_len, t * bs)
        nsplit, per = prefill_splits(route, keys, hkv * tiles)
        ws, ctr = _split_scratch(q, stream, nsplit, hkv * tiles,
                                 _partial_floats(kern.rows, d))
        err = build.load(kern.stem)(
            _DTYPE_CODES[k_pages.dtype], *pools, _ptr(ws), _ptr(ctr), b, hq,
            hkv, nb, bs, t, c, q_offset, ctx_len, nsplit, per, int(split_p),
            scale, stream)
    _raise_on(err, f"{name} ({route})")
    return out


def paged_verify_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                           chunk_lens, *, scale: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """The speculative decoder's verify: every lane's draft window at
    once. q: [B, Hq, C, D] (row c of lane b at position ``ctx_lens[b] +
    c``); k_pages/v_pages: [Hkv, NB, bs, D] pools already holding the
    windows' own K/V (dtype rules as :func:`paged_decode_attention`);
    block_tables: [B, T] int32; ctx_lens, chunk_lens: [B] int32 on q's
    device (lane b's window covers positions [ctx_lens[b], ctx_lens[b] +
    chunk_lens[b])). Returns [B, Hq, C, D];
    rows at or past a lane's chunk_len are finite garbage, a dead lane
    (ctx 0, window 0) gets zeros.

    The reference calls the paged prefill kernel once a lane. On the card
    this is ONE launch of the paged prefill kernel with the lane as a grid
    axis, reading each lane's window from device memory, routed as
    :func:`paged_prefill_attention`: bf16 q over bf16 or int8 pools at
    head_dim 64 on ``csrc/paged_prefill_tc.cu`` (route "wgmma"), at 128
    on ``csrc/paged_prefill_tc128.cu`` ("wgmma128"; keys
    split by :func:`prefill_splits` of the table width, since the windows
    live on the device; P enters P V as two bf16 parts, so it keeps
    about 2^-16 of itself as the decode kernel's float32 P does, where a
    prefill chunk at head_dim 64 rounds it once), everything else on
    ``csrc/paged_prefill.cu`` ("simt"), where each float32 row is computed
    in the paged decode kernel's order (the speculative contract: streams
    bitwise equal to plain decode). ``paged_verify_attention.routes``
    counts the launches of each."""
    _require(q.dim() == 4, "q must be [B, Hq, C, D]")
    hkv, bs, d = _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    b, hq, c, _ = q.shape
    _require(hq % hkv == 0, f"Hq {hq} is not a multiple of Hkv {hkv}")
    _require(block_tables.dtype == torch.int32 and block_tables.dim() == 2
             and block_tables.shape[0] == b, "block_tables must be [B, T] "
             "int32")
    for name, t in (("ctx_lens", ctx_lens), ("chunk_lens", chunk_lens)):
        _require(t.dtype == torch.int32 and tuple(t.shape) == (b,),
                 f"{name} must be [B] int32")
    _contiguous(block_tables=block_tables, ctx_lens=ctx_lens,
                chunk_lens=chunk_lens)
    scale = float(scale) if scale is not None else d ** -0.5
    scales = () if k_scales is None else (k_scales, v_scales)
    if not _on_card(q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens,
                    *scales):
        return ref.paged_verify_attention_ref(
            q, k_pages, v_pages, block_tables, ctx_lens, chunk_lens,
            scale=scale, k_scales=k_scales, v_scales=v_scales)
    route = paged_route("prefill", q.dtype, k_pages.dtype, d, bs)
    out = _prefill_launch(route, q, k_pages, v_pages, block_tables, ctx_lens,
                          chunk_lens, 0, 0, scale, k_scales, v_scales,
                          "paged_verify_attention", split_p=True)
    paged_verify_attention.launches += 1
    paged_verify_attention.routes[route] += 1
    return out


def quantize_int8(x, bits):
    """Rowwise int8 stochastic quantization of x [M, 128] float32 with
    explicit random words ``bits`` [M, 128] torch.uint32. Returns (q int8
    [M, 128], scale float32 [M, 1]); all-zero rows emit scale 0 / q 0.
    Bitwise equal to :func:`repro_torch.kernels.ref.quantize_int8_ref`."""
    _require(x.dim() == 2 and x.shape[1] == LANES,
             f"quantize rows must be [M, {LANES}], got {tuple(x.shape)}")
    _require(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _require(bits.dtype == torch.uint32 and bits.shape == x.shape,
             "bits must be uint32 of x's shape")
    _contiguous(x=x, bits=bits)
    if not _on_card(x, bits):
        return ref.quantize_int8_ref(x, bits)
    _aligned(x=x, bits=bits)
    m = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    err = build.load("quantize")(_ptr(x), _ptr(bits), _ptr(q), _ptr(scale),
                                 m, _stream(x))
    _raise_on(err, "quantize_int8")
    quantize_int8.launches += 1
    return q, scale


def quantize_kv_append(k_pool, v_pool, k_scale, v_scale, k_rows, v_rows,
                       phys=None, off=None, *, table=None) -> None:
    """Quantize K and V rows to int8 and write them into the paged pools,
    in place, in one launch: the int8 KV cache's append.

    Pools k_pool/v_pool: int8 [..., NB, bs, D] (D <= 128), scales
    k_scale/v_scale: float32 [..., NB, bs, 1]; rows k_rows/v_rows:
    [..., R, D] float32 or bf16 with the pools' leading dims, each row
    contiguous (a transposed view of a projection's output is read in
    place, through its strides). Either
    ``phys``/``off`` ([R] int32 or int64 block ids and in-block offsets:
    row n goes to ``pool[..., phys[n], off[n]]``, the decode and chunk
    append), or ``table`` ([T] int32 or int64 block ids: the rows fill
    blocks ``table[:ceil(R / bs)]`` in order, the last one padded with
    zero rows, the monolithic prefill's write). Each row is quantized as
    :func:`quantize_int8` quantizes it zero-padded to 128 lanes with the
    pinned random word 2**31 (round to nearest): codes and scales are
    bitwise :func:`repro_torch.kernels.ref.quantize_kv_append_ref`'s."""
    _require(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
             "the pools must be int8")
    _require(k_pool.dim() >= 4 and v_pool.shape == k_pool.shape,
             "k_pool/v_pool must be matching [..., NB, bs, D] pools")
    lead, (nb, bs, d) = k_pool.shape[:-3], k_pool.shape[-3:]
    _require(1 <= d <= LANES, f"head_dim {d} > {LANES} lanes")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.dtype == torch.float32
                 and t.shape == k_pool.shape[:-1] + (1,),
                 f"{name} must be float32 [..., NB, bs, 1]")
    _require(k_rows.dtype in (torch.float32, torch.bfloat16)
             and v_rows.dtype == k_rows.dtype,
             "k_rows/v_rows must share float32 or bfloat16")
    _require(k_rows.dim() == len(lead) + 2 and v_rows.shape == k_rows.shape
             and k_rows.shape[:-2] == lead and k_rows.shape[-1] == d,
             "k_rows/v_rows must be [..., R, D] with the pools' leading "
             "dims and D")
    r = k_rows.shape[-2]
    idx = (phys, off) if table is None else (table,)
    for t in idx:
        _require(t is not None and t.dim() == 1
                 and t.dtype in (torch.int32, torch.int64),
                 "phys/off or table must be 1-D int32 or int64")
    if table is None:
        _require(phys.shape == off.shape == (r,)
                 and off.dtype == phys.dtype,
                 "phys and off must be [R] of one dtype")
        n = r
    else:
        _require(phys is None and off is None,
                 "pass phys and off, or table")
        n = -(-r // bs) * bs
        _require(table.shape[0] * bs >= n, "the table has too few blocks")
    _contiguous(k_pool=k_pool, v_pool=v_pool, k_scale=k_scale,
                v_scale=v_scale)
    _require(k_rows.stride(-1) == 1 and v_rows.stride(-1) == 1,
             "k_rows/v_rows must have contiguous rows")
    planes = functools.reduce(operator.mul, lead, 1)
    try:            # one stride a plane: the leading dims flatten in place
        flat = [t.view(planes, r, d) for t in (k_rows, v_rows)]
    except RuntimeError:
        raise ValueError("k_rows/v_rows' leading dims must flatten without "
                         "a copy") from None
    if not _on_card(k_pool, v_pool, k_scale, v_scale, k_rows, v_rows, *idx):
        ref.quantize_kv_append_ref(k_pool, v_pool, k_scale, v_scale, k_rows,
                                   v_rows, phys, off, table=table)
        return
    if r == 0:
        return
    err = build.load("kv_append_int8")(
        _DTYPE_CODES[k_rows.dtype], _ptr(flat[0]), _ptr(flat[1]),
        _ptr(k_pool), _ptr(v_pool), _ptr(k_scale), _ptr(v_scale), _ptr(phys),
        _ptr(off), _ptr(table), int(idx[0].dtype == torch.int64),
        *flat[0].stride()[:2], *flat[1].stride()[:2], planes, r, n, d, nb,
        bs, _stream(k_rows))
    _raise_on(err, "quantize_kv_append")
    quantize_kv_append.launches += 1


def dequantize_int8(q, scale):
    """Inverse of :func:`quantize_int8`: ``q * scale`` for q [M, 128] int8
    and scale [M, 1] float32, as float32 [M, 128].
    Bitwise equal to :func:`repro_torch.kernels.ref.dequantize_int8_ref`."""
    _require(q.dim() == 2 and q.shape[1] == LANES,
             f"dequantize rows must be [M, {LANES}], got {tuple(q.shape)}")
    _require(q.dtype == torch.int8, f"q must be int8, got {q.dtype}")
    _require(scale.dtype == torch.float32
             and tuple(scale.shape) == (q.shape[0], 1),
             "scale must be float32 [M, 1]")
    _contiguous(q=q, scale=scale)
    if not _on_card(q, scale):
        return ref.dequantize_int8_ref(q, scale)
    _aligned(q=q)
    x = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return x
    err = build.load("dequantize")(_ptr(q), _ptr(scale), _ptr(x),
                                   q.shape[0], _stream(q))
    _raise_on(err, "dequantize_int8")
    dequantize_int8.launches += 1
    return x


# --------------------------------------------------------- flash attention
#: threads a SIMT flash CTA may have: the kernels take up to 214
#: registers a thread (ptxas), and the SM's 64K registers hold 256 such
SIMT_THREADS = 256
TC_HEAD_DIM = 64              #: head_dim of the tensor-core flash kernels
#: the flash kernels with a bf16 tensor-core route at head_dim 128
#: (route "wgmma128": ``csrc/flash_fwd_tc128.cu``,
#: ``csrc/flash_bwd_dkv_tc128.cu``, ``csrc/flash_bwd_dq_tc128.cu``)
TC128_FLASH = ("fwd", "dkv", "dq")
#: the flash kernels with a float32 3xTF32 wgmma route at head_dim 64
TF32_FLASH = ("fwd", "dkv", "dq")


def _check_qkv(q, k, v):
    """Shapes, dtypes and layout of a flash-attention call; returns
    (B, Hq, Sq, D, Hkv, Skv)."""
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             "q must be [B, Hq, Sq, D] and k/v matching [B, Hkv, Skv, D]")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _require(k.shape[0] == b and k.shape[3] == d,
             f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    _require(hq % hkv == 0, f"Hq {hq} is not a multiple of Hkv {hkv}")
    _require(sq > 0 and skv > 0, "empty query or key sequence")
    _require(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    _require(q.dtype == k.dtype == v.dtype,
             f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _contiguous(q=q, k=k, v=v)
    return b, hq, sq, d, hkv, skv


def _attn_args(*, scale, window, q_offset, block_q, block_k, d):
    """Normalized (scale, window, q_offset); ``block_q``/``block_k`` must
    be positive (they shape only the SIMT kernels' tiles, see
    :func:`_simt_tiles`)."""
    scale = float(scale) if scale is not None else d ** -0.5
    if window is not None:
        window = operator.index(window)
        _require(window >= 1, f"window must be >= 1, got {window}")
    q_offset = operator.index(q_offset)
    _require(block_q >= 1 and block_k >= 1, "block sizes must be >= 1")
    return scale, window, q_offset


def _simt_tiles(block_q, block_k, sq, skv, d):
    """The SIMT kernels' tiles (BQ, BK): the requested blocks, clamped to
    the sequence like the reference's ``_block_and_pad`` and to what a
    CTA of :data:`SIMT_THREADS` threads holds (D/32 threads a row), then
    rounded up to whole warps. The tensor-core kernels fix their own
    tiles."""
    rows = SIMT_THREADS // (d // 32)          # flash_attention.cuh layout
    bq = -(-min(block_q, sq, rows) // 32) * 32
    bk = -(-min(block_k, skv, rows) // 32) * 32
    return bq, bk


@functools.lru_cache(maxsize=64)
def flash_route(kind: str, dtype, head_dim: int) -> str:
    """The kernel a card launch of flash ``kind`` ("fwd", "dkv" or "dq")
    takes: at head_dim :data:`TC_HEAD_DIM`, bf16 the tensor-core kernel
    (``csrc/flash_*_tc.cu``, route "wgmma") and float32 the 3xTF32 wgmma
    kernel (``csrc/flash_{fwd,bwd_dkv,bwd_dq}_tf32.cu``, route "tf32x3");
    at head_dim 128, bf16 their tensor-core kernels
    (``csrc/flash_{fwd,bwd_dkv,bwd_dq}_tc128.cu``, route "wgmma128");
    everything else (float32 at 128, every dtype at 32) the SIMT kernel
    (``csrc/flash_{fwd,bwd_dkv,bwd_dq}.cu``, route "simt")."""
    if head_dim == TC_HEAD_DIM and dtype == torch.bfloat16:
        return "wgmma"
    if head_dim == 128 and dtype == torch.bfloat16 and kind in TC128_FLASH:
        return "wgmma128"
    if head_dim == TC_HEAD_DIM and dtype == torch.float32 and (
            kind in TF32_FLASH):
        return "tf32x3"
    return "simt"


def _flash_pick(kind, route, q):
    best = flash_route(kind, q.dtype, q.shape[-1])
    route = route or best
    _require(route in (best, "simt"), f"flash {kind}: route {route!r} "
             f"cannot take these operands (it takes {best!r} or 'simt')")
    return route


def _card_dtype(t) -> int:
    _require(t.dtype in (torch.float32, torch.bfloat16),
             f"the flash kernels take float32 or bfloat16, not {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 128,
                    block_k: int = 128, return_lse: bool = False):
    """Blocked GQA attention. q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]
    (float32 or bfloat16, contiguous); query row r at absolute position
    ``q_offset + r``; causal and ``window`` masks as the reference's.
    Returns o [B, Hq, Sq, D] in q's dtype (and the float32 row logsumexp
    [B, Hq, Sq] with ``return_lse``).

    On the card the kernel follows :func:`flash_route`: bf16 at head_dim
    64 launches ``csrc/flash_fwd_tc.cu`` (wgmma on TMA-fed tiles, its own
    64 x 64 tiles, p rounded to bf16 for p.v); bf16 at head_dim 128
    ``csrc/flash_fwd_tc128.cu`` (the same arithmetic, two query tiles of
    one head a CTA); float32 at head_dim 64 ``csrc/flash_fwd_tf32.cu``
    (3xTF32 wgmma, its own 64 x 64 tiles, the softmax in float32); the
    rest the SIMT kernel (``csrc/flash_fwd.cu``, all float32), whose
    query and KV tiles ``block_q``/``block_k`` set. ``flash_attention.routes`` counts the
    launches of each."""
    b, hq, sq, d, hkv, skv = _check_qkv(q, k, v)
    scale, window, q_offset = _attn_args(
        scale=scale, window=window, q_offset=q_offset, block_q=block_q,
        block_k=block_k, d=d)
    if not _on_card(q, k, v):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, q_offset=q_offset,
                                       return_lse=return_lse)
    return _flash_fwd_card(q, k, v, scale=scale, causal=causal,
                           window=window, q_offset=q_offset,
                           block_q=block_q, block_k=block_k,
                           return_lse=return_lse)


def _flash_fwd_card(q, k, v, *, scale, causal, window, q_offset,
                    block_q=128, block_k=128, return_lse=False,
                    route: Optional[str] = None):
    """The card launch of :func:`flash_attention` (inputs already checked
    and normalized) on ``route``: :func:`flash_route`'s choice by default,
    "simt" to time the SIMT kernel on the same inputs."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    code = _card_dtype(q)
    route = _flash_pick("fwd", route, q)
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    mask = (int(causal), window or 0, q_offset)
    if route != "simt":
        _aligned(q=q, k=k, v=v)       # 16-byte copies from the bases
        stem = {"wgmma": "flash_fwd_tc", "wgmma128": "flash_fwd_tc128",
                "tf32x3": "flash_fwd_tf32"}[route]
        err = build.load(stem)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), b, hq, hkv, sq,
            skv, scale, *mask, _stream(q))
    else:
        bq, bk = _simt_tiles(block_q, block_k, sq, skv, d)
        err = build.load("flash_fwd")(
            code, _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), b, hq, hkv,
            sq, skv, d, bq, bk, scale, *mask, _stream(q))
    _raise_on(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return (o, lse) if return_lse else o


def _check_bwd(q, k, v, do, lse, delta):
    b, hq, sq, d, hkv, skv = _check_qkv(q, k, v)
    _require(do.shape == q.shape and do.dtype == q.dtype,
             "do must match q in shape and dtype")
    stats = ref._acc(q)
    for name, t in (("lse", lse), ("delta", delta)):
        _require(tuple(t.shape) == (b, hq, sq) and t.dtype == stats,
                 f"{name} must be {stats} [B, Hq, Sq]")
    _contiguous(do=do, lse=lse, delta=delta)
    return b, hq, sq, d, hkv, skv


def flash_attention_bwd_preprocess(o, do):
    """delta = rowsum(dO * O) in float32: o, do [B, Hq, Sq, D] ->
    [B, Hq, Sq].

    On the card every launch takes ``csrc/flash_bwd_preprocess_vec.cu``
    (route "vec": 16-byte loads, a row to D * esz / 16 lanes, four rows a
    thread, a grid-stride walk); ``flash_attention_bwd_preprocess.routes``
    counts the launches of it and of the one-warp-a-row kernel it
    replaced ("simt", launched only by :func:`_preprocess_card`)."""
    _require(o.dim() == 4 and do.shape == o.shape and do.dtype == o.dtype,
             "o and do must be matching [B, Hq, Sq, D]")
    _require(o.shape[-1] in HEAD_DIMS,
             f"head_dim {o.shape[-1]} not in {HEAD_DIMS}")
    _contiguous(o=o, do=do)
    if not _on_card(o, do):
        return ref.flash_attention_bwd_preprocess_ref(o, do)
    return _preprocess_card(o, do)


def _preprocess_card(o, do, route: str = "vec"):
    """The card launch of :func:`flash_attention_bwd_preprocess` (inputs
    already checked) on ``route``: "vec", or "simt" to time the
    one-warp-a-row kernel ``csrc/flash_bwd_preprocess.cu`` on the same
    inputs."""
    stem = {"vec": "flash_bwd_preprocess_vec",
            "simt": "flash_bwd_preprocess"}[route]
    delta = torch.empty(o.shape[:3], dtype=torch.float32, device=o.device)
    rows, d = o.numel() // o.shape[-1], o.shape[-1]
    if rows == 0:
        return delta
    if route == "vec":
        _aligned(o=o, do=do)          # 16-byte loads from the bases
    err = build.load(stem)(_card_dtype(o), _ptr(o), _ptr(do), _ptr(delta),
                           rows, d, _stream(o))
    _raise_on(err, f"flash_attention_bwd_preprocess ({route})")
    flash_attention_bwd_preprocess.launches += 1
    flash_attention_bwd_preprocess.routes[route] += 1
    return delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale=None,
                            causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0,
                            block_q: int = 128, block_k: int = 128):
    """(dK, dV) [B, Hkv, Skv, D] in k's dtype from the forward's q, k, v,
    its lse, the cotangent ``do`` and ``delta``; each KV head sums its
    query group. Deterministic: no atomics.

    On the card the kernel follows :func:`flash_route`: bf16 at head_dim
    64 launches ``csrc/flash_bwd_dkv_tc.cu`` (all four products on wgmma
    in the transposed frame, p and dS rounded to bf16 for the dV and dK
    products, its own tiles); bf16 at head_dim 128
    ``csrc/flash_bwd_dkv_tc128.cu`` (the same arithmetic, 64 keys a CTA,
    its two warpgroups' partial sums added in a fixed order); float32 at
    head_dim 64
    ``csrc/flash_bwd_dkv_tf32.cu`` (the same frame, every product 3xTF32,
    p and dS float32, its own tiles); the other head_dims the SIMT kernel
    (``csrc/flash_bwd_dkv.cu``, all float32, tiles from
    ``block_q``/``block_k``). ``flash_attention_bwd_dkv.routes`` counts the
    launches of each."""
    b, hq, sq, d, hkv, skv = _check_bwd(q, k, v, do, lse, delta)
    scale, window, q_offset = _attn_args(
        scale=scale, window=window, q_offset=q_offset, block_q=block_q,
        block_k=block_k, d=d)
    if not _on_card(q, k, v, do, lse, delta):
        return ref.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, scale=scale, causal=causal,
            window=window, q_offset=q_offset)
    return _flash_dkv_card(q, k, v, do, lse, delta, scale=scale,
                           causal=causal, window=window, q_offset=q_offset,
                           block_q=block_q, block_k=block_k)


def _flash_dkv_card(q, k, v, do, lse, delta, *, scale, causal, window,
                    q_offset, block_q=128, block_k=128,
                    route: Optional[str] = None):
    """The card launch of :func:`flash_attention_bwd_dkv` (inputs already
    checked and normalized) on ``route``: :func:`flash_route`'s choice by
    default, "simt" to time the SIMT kernel on the same inputs."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    code = _card_dtype(q)
    route = _flash_pick("dkv", route, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mask = (int(causal), window or 0, q_offset)
    if route != "simt":
        _aligned(q=q, k=k, v=v, do=do)
        stem = {"wgmma": "flash_bwd_dkv_tc",
                "wgmma128": "flash_bwd_dkv_tc128",
                "tf32x3": "flash_bwd_dkv_tf32"}[route]
        err = build.load(stem)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dk), _ptr(dv), b, hq, hkv, sq, skv, scale, *mask,
            _stream(q))
    else:
        bq, bk = _simt_tiles(block_q, block_k, sq, skv, d)
        err = build.load("flash_bwd_dkv")(
            code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), b, hq, hkv, sq, skv, d, bq, bk,
            scale, *mask, _stream(q))
    _raise_on(err, f"flash_attention_bwd_dkv ({route})")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.routes[route] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, scale=None,
                           causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0, block_q: int = 128,
                           block_k: int = 128):
    """dQ [B, Hq, Sq, D] in q's dtype from the same inputs as
    :func:`flash_attention_bwd_dkv`. Deterministic: no atomics.

    On the card the kernel follows :func:`flash_route`: bf16 at head_dim
    64 launches the tensor-core kernel (``csrc/flash_bwd_dq_tc.cu``: S, dP
    and dQ on wgmma, dS rounded to bf16 for the dQ product, its own
    tiles); bf16 at head_dim 128 ``csrc/flash_bwd_dq_tc128.cu`` (the same
    arithmetic, the forward's schedule: two query tiles of one head a
    CTA, dealt heaviest first over a persistent grid); float32 at
    head_dim 64 ``csrc/flash_bwd_dq_tf32.cu`` (the same three products,
    every one 3xTF32, dS float32, its own tiles); the rest the SIMT kernel
    (``csrc/flash_bwd_dq.cu``, all float32, tiles from
    ``block_q``/``block_k``).
    ``flash_attention_bwd_dq.routes`` counts the launches of each."""
    b, hq, sq, d, hkv, skv = _check_bwd(q, k, v, do, lse, delta)
    scale, window, q_offset = _attn_args(
        scale=scale, window=window, q_offset=q_offset, block_q=block_q,
        block_k=block_k, d=d)
    if not _on_card(q, k, v, do, lse, delta):
        return ref.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, delta, scale=scale, causal=causal,
            window=window, q_offset=q_offset)
    return _flash_dq_card(q, k, v, do, lse, delta, scale=scale,
                          causal=causal, window=window, q_offset=q_offset,
                          block_q=block_q, block_k=block_k)


def _flash_dq_card(q, k, v, do, lse, delta, *, scale, causal, window,
                   q_offset, block_q=128, block_k=128,
                   route: Optional[str] = None):
    """The card launch of :func:`flash_attention_bwd_dq` (inputs already
    checked and normalized) on ``route``: :func:`flash_route`'s choice by
    default, "simt" to time the SIMT kernel on the same inputs."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    code = _card_dtype(q)
    route = _flash_pick("dq", route, q)
    dq = torch.empty_like(q)
    mask = (int(causal), window or 0, q_offset)
    if route != "simt":
        _aligned(q=q, k=k, v=v, do=do)
        stem = {"wgmma": "flash_bwd_dq_tc",
                "wgmma128": "flash_bwd_dq_tc128",
                "tf32x3": "flash_bwd_dq_tf32"}[route]
        err = build.load(stem)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), b, hq, hkv, sq, skv, scale, *mask, _stream(q))
    else:
        bq, bk = _simt_tiles(block_q, block_k, sq, skv, d)
        err = build.load("flash_bwd_dq")(
            code, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dq), b, hq, hkv, sq, skv, d, bq, bk, scale,
            *mask, _stream(q))
    _raise_on(err, f"flash_attention_bwd_dq ({route})")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.routes[route] += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, *, scale=None,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, block_q: int = 128,
                        block_k: int = 128):
    """Gradients (dq, dk, dv) from the saved ``(q, k, v, o, lse)`` and the
    output cotangent ``do``: the preprocess, dK/dV and dQ kernels in turn
    (the reference's ``flash_attention_bwd``)."""
    delta = flash_attention_bwd_preprocess(o, do)
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_offset,
              block_q=block_q, block_k=block_k)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttentionAD(torch.autograd.Function):
    """Kernel forward saving ``(q, k, v, o, lse)``; kernel backward (the
    reference's ``_fa_ad`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_offset, block_q,
                block_k):
        opts = dict(scale=scale, causal=causal, window=window,
                    q_offset=q_offset, block_q=block_q, block_k=block_k)
        o, lse = flash_attention(q, k, v, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_ad(q, k, v, scale=None, causal=True, window=None,
                       q_offset=0, *, block_q=128, block_k=128):
    """Differentiable flash attention: the forward kernel, and the three
    backward kernels in the backward pass (the reference's
    ``flash_attention_ad``)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttentionAD.apply(q, k, v, scale, bool(causal), window,
                                   q_offset, int(block_q), int(block_k))


# ------------------------------------------------------------ LoRA matmul
MAX_RANK = 16                 #: kMaxRank of lora_matmul.cu


def lora_route(dtype, x_shape, w_strides, x_ptr: int = 0,
               w_ptr: int = 0) -> str:
    """The kernel a card launch of :func:`lora_matmul` takes, from the
    operands' dtype, x's shape [M, K] (x is contiguous), w's strides and
    the two base addresses: ``"wgmma"`` (``csrc/lora_matmul_tc.cu``) for
    bf16 operands that TMA can describe — K and w's non-unit stride
    multiples of 8 elements, x and w 16-byte aligned — else ``"simt"``
    (``csrc/lora_matmul.cu``: mma.sync for bf16, CUDA cores for
    float32; the key every routed wrapper gives its kernel that is not
    on wgmma)."""
    sk, sn = w_strides
    ldw = sn if sn != 1 else sk        # the stride that is not the unit one
    k = x_shape[1]
    tma = (k >= 1 and k % 8 == 0 and ldw % 8 == 0 and x_ptr % 16 == 0
           and w_ptr % 16 == 0)
    return "wgmma" if dtype == torch.bfloat16 and tma else "simt"


def lora_matmul(x, w, a, b, *, scale: float = 1.0):
    """Fused ``y = x @ w + scale * (x @ a) @ b``: both products and the
    rank-r product in float32, x @ a never rounded, y rounded once to x's
    dtype. x: [M, K] contiguous; w: [K, N]; a: [K, r]; b: [r, N]; all four
    float32 or all bfloat16, 1 <= r <= 16. w, a and b may be strided
    views: w needs one unit stride (a transposed view is fine), a and b
    take any, so the backward's ``lora_matmul(g, w.T, b.T, a.T)`` copies
    nothing.

    On the card the kernel follows :func:`lora_route`: bf16 operands
    that TMA can describe (the distillation path's forward and dx) launch
    the wgmma kernel, everything else the mma.sync / float32 kernel;
    ``lora_matmul.routes`` counts the launches of each."""
    _require(all(t.dim() == 2 for t in (x, w, a, b)),
             "x, w, a and b must be 2-D")
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    _require(w.shape[0] == k and a.shape[0] == k
             and tuple(b.shape) == (r, n),
             f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, a "
             f"{tuple(a.shape)}, b {tuple(b.shape)} do not chain")
    _require(1 <= r <= MAX_RANK, f"rank {r} not in [1, {MAX_RANK}]")
    _require(x.dtype in (torch.float32, torch.bfloat16)
             and w.dtype == a.dtype == b.dtype == x.dtype,
             f"x, w, a, b must share float32 or bfloat16, got {x.dtype}, "
             f"{w.dtype}, {a.dtype}, {b.dtype}")
    _contiguous(x=x)
    _require(w.stride(0) == 1 or w.stride(1) == 1,
             "w needs a unit stride along one axis")
    scale = float(scale)
    if not _on_card(x, w, a, b):
        return ref.lora_matmul_ref(x, w, a, b, scale=scale)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    route = lora_route(x.dtype, x.shape, w.stride(), x.data_ptr(),
                       w.data_ptr())
    if route == "wgmma":
        err = build.load("lora_matmul_tc")(
            _ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(y), m, n, k, r,
            *w.stride(), *a.stride(), *b.stride(), scale, _stream(x))
    else:
        err = build.load("lora_matmul")(
            _DTYPE_CODES[x.dtype], _ptr(x), _ptr(w), _ptr(a), _ptr(b),
            _ptr(y), m, n, k, r, *w.stride(), *a.stride(), *b.stride(),
            scale, _stream(x))
    _raise_on(err, f"lora_matmul ({route})")
    lora_matmul.launches += 1
    lora_matmul.routes[route] += 1
    return y


class _LoraMatmulAD(torch.autograd.Function):
    """The fused kernel forward; the reference's closed-form VJP
    (``ops._lora_ad_bwd``) backward:

      dx = lora_matmul(g, w^T, b^T, a^T)   (the same kernel, transposed
                                            views)
      dw = x^T g;  da = scale * x^T (g b^T);  db = scale * (x a)^T g

    the last three as float32 products. Each is computed only when
    autograd asks for it: with a frozen base no dw is formed, and the
    first layer's dx is skipped when its input needs no grad."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return lora_matmul(x, w, a, b, scale=scale)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        g = g.contiguous()
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        dx = dw = da = db = None
        if need_x:
            dx = lora_matmul(g, w.T, b.T, a.T, scale=s).to(x.dtype)
        if need_w or need_a or need_b:
            xf, gf = x.float(), g.float()
            if need_w:
                dw = (xf.T @ gf).to(w.dtype)
            if need_a:
                da = (s * (xf.T @ (gf @ b.float().T))).to(a.dtype)
            if need_b:
                db = (s * ((xf @ a.float()).T @ gf)).to(b.dtype)
        return dx, dw, da, db, None


def lora_matmul_ad(x, w, a, b, *, scale: float = 1.0):
    """Differentiable :func:`lora_matmul` (the reference's
    ``lora_matmul_ad``): the kernel forward, dx through the same kernel
    in the backward pass."""
    return _LoraMatmulAD.apply(x, w, a, b, float(scale))


# ------------------------------------------------------------------ mLSTM
MLSTM_MAX_DH = 512            #: head widths mlstm_chunked.cu takes
MLSTM_TC_DH = (64, 128, 256, 512)   #: widths mlstm_chunked_tc.cu takes
MLSTM_CARD_CHUNK = 64         #: the kernels' chunk (kC of all three)


@functools.lru_cache(maxsize=64)
def mlstm_route(dtype, dh: int) -> str:
    """The kernel a card launch of :func:`mlstm_chunked` takes: "wgmma"
    (``csrc/mlstm_chunked_tc.cu``: 3xTF32 on the tensor cores, a cluster
    of DH / 64 CTAs sharing S) for float32 or bf16 at head width DH in
    :data:`MLSTM_TC_DH`, else "simt" (``csrc/mlstm_chunked.cu``, float32
    on the CUDA cores, any DH up to :data:`MLSTM_MAX_DH`). Inputs whose
    bases are not 16-byte aligned (TMA's rule) take "simt" too. The
    backward, :func:`mlstm_chunked_bwd`, takes the same route:
    ``csrc/mlstm_chunked_bwd_tc.cu`` or ``csrc/mlstm_chunked_bwd.cu``."""
    return ("wgmma" if dtype in (torch.float32, torch.bfloat16)
            and dh in MLSTM_TC_DH else "simt")


def mlstm_chunked(q, k, v, ig, lf, *, chunk: int = 64, C0=None, n0=None,
                  m0=None, states: bool = False):
    """Stabilized chunkwise mLSTM. q/k/v: [B, NH, S, DH] (k pre-scaled),
    all float32 or all bfloat16; ig/lf: [B, NH, S] float32; optional
    initial state C0 [B, NH, DH, DH], n0 [B, NH, DH], m0 [B, NH] float32
    (all three or none; none starts from C = 0, n = 0, m = -1e30).
    Returns (h [B, NH, S, DH] in q's dtype, (C, n, m) float32), and with
    ``states`` a third item: what :func:`mlstm_chunked_bwd` takes, as
    :func:`repro_torch.kernels.ref.mlstm_chunkwise_ref` returns it (on the
    card for the kernels' chunks of :data:`MLSTM_CARD_CHUNK`); h and the
    final state are the same bitwise either way.

    The kernels walk the sequence in chunks of 64 steps, their own tiling,
    and take any S >= 1; :func:`mlstm_route` picks the kernel and
    ``mlstm_chunked.routes`` counts the launches of each. ``chunk`` is the
    plain version's chunk length (the last chunk may be shorter): any
    chunking computes the same recurrence and differs only in rounding,
    so the CPU route takes the caller's chunk to match the reference's
    sums."""
    _require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
             "q, k and v must be matching [B, NH, S, DH]")
    b, nh, s, dh = q.shape
    _require(s >= 1 and b >= 1 and nh >= 1, "empty batch, heads or sequence")
    _require(1 <= dh <= MLSTM_MAX_DH, f"head_dim {dh} not in [1, "
             f"{MLSTM_MAX_DH}]")
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k.dtype == v.dtype == q.dtype,
             f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
             f"{k.dtype}, {v.dtype}")
    for name, t in (("ig", ig), ("lf", lf)):
        _require(t.dtype == torch.float32 and tuple(t.shape) == (b, nh, s),
                 f"{name} must be float32 [B, NH, S]")
    state = (C0, n0, m0)
    _require(all(t is None for t in state) or all(t is not None
                                                  for t in state),
             "pass all of C0, n0, m0 or none")
    given = C0 is not None
    if given:
        for name, t, shp in (("C0", C0, (b, nh, dh, dh)),
                             ("n0", n0, (b, nh, dh)), ("m0", m0, (b, nh))):
            _require(t.dtype == torch.float32 and tuple(t.shape) == shp,
                     f"{name} must be float32 {list(shp)}")
        _contiguous(C0=C0, n0=n0, m0=m0)
    _contiguous(q=q, k=k, v=v, ig=ig, lf=lf)
    chunk = operator.index(chunk)
    _require(chunk >= 1, f"chunk must be >= 1, got {chunk}")
    extra = (C0, n0, m0) if given else ()
    if not _on_card(q, k, v, ig, lf, *extra):
        return ref.mlstm_chunkwise_ref(q, k, v, ig, lf, chunk=chunk, C0=C0,
                                       n0=n0, m0=m0, states=states)
    return _mlstm_card(q, k, v, ig, lf, C0, n0, m0, states=states)


def _mlstm_card(q, k, v, ig, lf, C0=None, n0=None, m0=None, *, route=None,
                prof=None, states: bool = False):
    """The card launch of :func:`mlstm_chunked` (inputs already checked)
    on ``route``: :func:`mlstm_route`'s choice by default, "simt" to time
    the SIMT kernel on the same inputs. ``prof``: a CUDA int64 tensor the
    kernel adds its phase clocks to (7 for the SIMT kernel, 6 for the
    wgmma kernel; the sources list the phases). ``states``: also write
    and return the states the backward takes."""
    b, nh, s, dh = q.shape
    best = mlstm_route(q.dtype, dh)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        best = "simt"
    route = route or best
    _require(route in (best, "simt"), f"mlstm: route {route!r} cannot take "
             f"these operands (it takes {best!r} or 'simt')")
    h = torch.empty_like(q)
    kw = dict(dtype=torch.float32, device=q.device)
    C = torch.empty((b, nh, dh, dh), **kw)
    n = torch.empty((b, nh, dh), **kw)
    m = torch.empty((b, nh), **kw)
    saved = ()
    if states:
        nc = -(-s // MLSTM_CARD_CHUNK)
        saved = (torch.empty((b, nh, nc, dh, dh), **kw),
                 torch.empty((b, nh, nc, dh), **kw),
                 torch.empty((b, nh, nc), **kw),
                 torch.empty((b, nh, s), **kw), torch.empty((b, nh, s), **kw))
    args = (_DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(ig),
            _ptr(lf), _ptr(C0), _ptr(n0), _ptr(m0), _ptr(h), _ptr(C),
            _ptr(n), _ptr(m), b, nh, s, dh)
    # the wgmma kernel's state-writing instantiation is a library of its
    # own (csrc/mlstm_chunked_tc_save.cu); the SIMT kernel takes the
    # state pointers, null for serving
    saved_ptrs = [_ptr(t) for t in saved] if states else [None] * 5
    if route == "simt":
        stem, extra = "mlstm_chunked", saved_ptrs
    else:
        stem = "mlstm_chunked_tc_save" if states else "mlstm_chunked_tc"
        extra = saved_ptrs if states else []
    err = build.load(stem)(*args, *extra, _ptr(prof), _stream(q))
    _raise_on(err, f"mlstm_chunked ({route})")
    mlstm_chunked.launches += 1
    mlstm_chunked.routes[route] += 1
    if states:
        return h, (C, n, m), saved
    return h, (C, n, m)


def mlstm_chunked_bwd(q, k, v, ig, lf, h, dh, states, *, chunk: int = 64):
    """Gradients (dq, dk, dv [B, NH, S, DH], dig, dlf [B, NH, S], all
    float32) of :func:`mlstm_chunked`'s h through its cotangent ``dh``,
    from the ``states`` that ``mlstm_chunked(..., states=True)`` returned
    on the same device; h and dh in q's dtype. No gradient reaches the
    initial or final state.

    On the card it launches the kernels of :func:`mlstm_route`'s
    route (each a reverse sweep carrying dC and dn, then every chunk in
    parallel), the states being those of the kernels' chunks;
    ``mlstm_chunked_bwd.launches`` counts its calls (one a call, whatever
    its kernels) and ``mlstm_chunked_bwd.routes`` the calls of each route.
    On the CPU it runs
    :func:`repro_torch.kernels.ref.mlstm_chunkwise_bwd_ref` at ``chunk``,
    the chunk the states were made with."""
    _require(q.dim() == 4 and all(t.shape == q.shape
                                  for t in (k, v, h, dh)),
             "q, k, v, h and dh must be matching [B, NH, S, DH]")
    b, nh, s, d = q.shape
    _require(1 <= d <= MLSTM_MAX_DH, f"head_dim {d} not in [1, "
             f"{MLSTM_MAX_DH}]")
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and all(t.dtype == q.dtype for t in (k, v, h, dh)),
             f"q, k, v, h, dh must share float32 or bfloat16, got "
             f"{[t.dtype for t in (q, k, v, h, dh)]}")
    for name, t in (("ig", ig), ("lf", lf)):
        _require(t.dtype == torch.float32 and tuple(t.shape) == (b, nh, s),
                 f"{name} must be float32 [B, NH, S]")
    chunk = operator.index(chunk)
    _require(chunk >= 1, f"chunk must be >= 1, got {chunk}")
    on_card = _on_card(q, k, v, ig, lf, h, dh, *states)
    nc = -(-s // (MLSTM_CARD_CHUNK if on_card else chunk))
    shapes = ((b, nh, nc, d, d), (b, nh, nc, d), (b, nh, nc), (b, nh, s),
              (b, nh, s))
    _require(len(states) == 5 and all(
        t.dtype == torch.float32 and tuple(t.shape) == shp
        for t, shp in zip(states, shapes)),
        f"states must be float32 {[list(x) for x in shapes]}, got "
        f"{[(t.dtype, list(t.shape)) for t in states]}")
    _contiguous(q=q, k=k, v=v, ig=ig, lf=lf, h=h, dh=dh,
                **{f"states[{i}]": t for i, t in enumerate(states)})
    if not on_card:
        return ref.mlstm_chunkwise_bwd_ref(q, k, v, ig, lf, h, dh, states,
                                           chunk=chunk)
    return _mlstm_bwd_card(q, k, v, ig, lf, h, dh, states)


def _mlstm_bwd_card(q, k, v, ig, lf, h, dh, states, *, route=None,
                    prof=None):
    """The card launch of :func:`mlstm_chunked_bwd` (inputs already
    checked) on ``route``: :func:`mlstm_route`'s choice by default,
    "simt" to time the SIMT kernels on the same inputs. ``prof``: a CUDA
    int64 tensor the wgmma route's kernels add their phase clocks to (9
    for the sweep, then 11 for the chunk kernel; the source lists the
    phases)."""
    b, nh, s, d = q.shape
    best = mlstm_route(q.dtype, d)
    if any(t.data_ptr() % 16 for t in (q, k, v, h, dh)):
        best = "simt"
    route = route or best
    _require(route in (best, "simt"), f"mlstm_chunked_bwd: route "
             f"{route!r} cannot take these operands (it takes {best!r} or "
             f"'simt')")
    _require(prof is None or route == "wgmma", "mlstm_chunked_bwd: only "
             "the wgmma route keeps phase clocks")
    kw = dict(dtype=torch.float32, device=q.device)
    grads = (torch.empty((b, nh, s, d), **kw), torch.empty((b, nh, s, d),
                                                           **kw),
             torch.empty((b, nh, s, d), **kw), torch.empty((b, nh, s), **kw),
             torch.empty((b, nh, s), **kw))
    # the carried dC' and dn' (written by the sweep), and for the wgmma
    # route its gates kernel's planes (cumsum, inter, w, 1 / den, dqn),
    # each chunk's carry and its sweep CTAs' shares of <C, dC'>
    scratch = [torch.empty(states[0].shape, **kw),
               torch.empty(states[1].shape, **kw)]
    extra = []
    if route == "wgmma":
        scratch.append(torch.empty(
            5 * b * nh * s + states[2].numel() * (1 + d // 64), **kw))
        extra = [_ptr(prof)]
    err = build.load("mlstm_chunked_bwd_tc" if route == "wgmma"
                     else "mlstm_chunked_bwd")(
        _DTYPE_CODES[q.dtype], *(_ptr(t) for t in (q, k, v, ig, lf, h, dh)),
        *(_ptr(t) for t in states), *(_ptr(t) for t in grads),
        *(_ptr(t) for t in scratch), b, nh, s, d, *extra, _stream(q))
    _raise_on(err, f"mlstm_chunked_bwd ({route})")
    mlstm_chunked_bwd.launches += 1
    mlstm_chunked_bwd.routes[route] += 1
    return grads


class _MlstmChunkedAD(torch.autograd.Function):
    """The forward kernel writing the states the backward needs; the
    backward kernel (:func:`mlstm_chunked_bwd`) in the backward pass. On
    the CPU both halves are the plain versions at the caller's chunk.

    Only h carries a gradient. The final state (C, n, m) is returned as a
    differentiable output so that a gradient reaching it raises instead of
    being dropped; so does a gradient asked of the initial state."""

    @staticmethod
    def forward(ctx, q, k, v, ig, lf, C0, n0, m0, chunk):
        h, (C, n, m), states = mlstm_chunked(q, k, v, ig, lf, chunk=chunk,
                                             C0=C0, n0=n0, m0=m0, states=True)
        ctx.save_for_backward(q, k, v, ig, lf, h, *states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        if dC is not None or dn is not None or dm is not None:
            raise RuntimeError(
                "mlstm_chunked_ad: no gradient flows through the final state "
                "(C, n, m); the training path differentiates h only, as the "
                "reference's loss does")
        if any(ctx.needs_input_grad[5:8]):
            raise RuntimeError("mlstm_chunked_ad: no gradient flows into "
                               "the initial state (C0, n0, m0)")
        if dh is None:
            return (None,) * 9
        q, k, v, ig, lf, h, *states = ctx.saved_tensors
        dq, dk, dv, dig, dlf = mlstm_chunked_bwd(
            q, k, v, ig, lf, h, dh.to(h.dtype).contiguous(), states,
            chunk=ctx.chunk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dig, dlf,
                None, None, None, None)


def mlstm_chunked_ad(q, k, v, ig, lf, *, chunk: int = 64, C0=None, n0=None,
                     m0=None):
    """Differentiable :func:`mlstm_chunked`: the forward kernel, saving
    each chunk's state, and :func:`mlstm_chunked_bwd` in the backward
    pass (the reference leaves the chunk body's gradient to XLA's
    autodiff). Returns (h, (C, n, m)) as :func:`mlstm_chunked`."""
    h, C, n, m = _MlstmChunkedAD.apply(q, k, v, ig, lf, C0, n0, m0,
                                       operator.index(chunk))
    return h, (C, n, m)


KERNELS = (paged_decode_attention, paged_decode_append_attention,
           paged_prefill_attention, paged_verify_attention, quantize_int8,
           quantize_kv_append, dequantize_int8, flash_attention,
           flash_attention_bwd_preprocess, flash_attention_bwd_dkv,
           flash_attention_bwd_dq, lora_matmul, mlstm_chunked,
           mlstm_chunked_bwd)
#: wrappers with two kernels behind them -> the route key of the Hopper
#: kernel; each launch is counted by route too: that key, or "simt" for
#: the other kernel (for the LoRA matmul its mma.sync / float32 kernel);
#: the three flash kernels count their float32 3xTF32 kernel's launches
#: as "tf32x3" beside them (:data:`TF32_ROUTED`) and their bf16
#: head_dim-128 kernel's as "wgmma128" (:data:`TC128_ROUTED`); the paged
#: wrappers their head_dim-128 kernel's as "tma128" (decode and the fused
#: append-and-decode) and "wgmma128" (prefill and the verify). The fused
#: append-and-decode counts its fused launches only: its "simt" stays 0
#: (on that route the stand-alone append and paged_decode_attention
#: launch and count)
ROUTED = {flash_attention: "wgmma", flash_attention_bwd_dkv: "wgmma",
          flash_attention_bwd_dq: "wgmma", lora_matmul: "wgmma",
          paged_decode_attention: PAGED_ROUTES["decode"],
          paged_decode_append_attention: PAGED_ROUTES["decode"],
          paged_prefill_attention: PAGED_ROUTES["prefill"],
          paged_verify_attention: PAGED_ROUTES["prefill"],
          mlstm_chunked: "wgmma", flash_attention_bwd_preprocess: "vec",
          mlstm_chunked_bwd: "wgmma"}
TF32_ROUTED = (flash_attention, flash_attention_bwd_dkv,
               flash_attention_bwd_dq)
TC128_ROUTED = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn, fast in ROUTED.items():
        fn.routes = {fast: 0, "simt": 0}
    for fn in TF32_ROUTED:
        fn.routes["tf32x3"] = 0
    for fn in TC128_ROUTED:
        fn.routes["wgmma128"] = 0
    for fn, kind in ((paged_decode_attention, "decode"),
                     (paged_decode_append_attention, "decode"),
                     (paged_prefill_attention, "prefill"),
                     (paged_verify_attention, "prefill")):
        for route in PAGED_HOPPER[kind]:
            fn.routes[route] = 0


reset_launch_counts()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def route_counts() -> dict:
    """{wrapper: {Hopper route: n, "simt": n}} of the routed wrappers
    (and "tf32x3": n and "wgmma128": n for the flash forward, dK/dV and
    dQ, "tma128": n for paged decode and the fused append-and-decode,
    "wgmma128": n for paged prefill and the verify)."""
    return {fn.__name__: dict(fn.routes) for fn in ROUTED}
