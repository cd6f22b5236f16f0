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
(plain-version calls do not count).
"""
from __future__ import annotations

import operator
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LANES = 128          #: fixed lane width of the quantization row layout
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


def paged_decode_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           scale: Optional[float] = None, k_scales=None,
                           v_scales=None):
    """q: [B, Hq, D] decode queries; k_pages/v_pages: [Hkv, NB, bs, D]
    pools (float32/bfloat16 as q, or int8 with ``k_scales``/``v_scales``
    [Hkv, NB, bs, 1] float32); block_tables: [B, T] int32; ctx_lens: [B]
    int32 visible KV lengths (0 returns zeros). Returns [B, Hq, D]."""
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
    scale = float(scale) if scale is not None else d ** -0.5
    scales = () if k_scales is None else (k_scales, v_scales)
    if not _on_card(q, k_pages, v_pages, block_tables, ctx_lens, *scales):
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, ctx_lens, scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    _aligned(k_pages=k_pages, v_pages=v_pages)
    out = torch.empty_like(q)
    err = build.load("paged_decode")(
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], _ptr(q),
        _ptr(k_pages), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales),
        _ptr(block_tables), _ptr(ctx_lens), _ptr(out), b, hq, hkv,
        k_pages.shape[1], bs, d, block_tables.shape[1], scale, _stream(q))
    _raise_on(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_table, q_offset: int,
                            ctx_len: int, *, scale: Optional[float] = None,
                            k_scales=None, v_scales=None):
    """q: [Hq, C, D] query chunk (row c at position q_offset + c);
    k_pages/v_pages: [Hkv, NB, bs, D] pools already holding the chunk's
    own K/V (dtype rules as :func:`paged_decode_attention`); block_table:
    [T] int32; q_offset/ctx_len: host ints (ctx_len = q_offset +
    chunk_len), passed to the kernel as arguments. Returns [Hq, C, D];
    rows past chunk_len are finite garbage."""
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
    _aligned(k_pages=k_pages, v_pages=v_pages)
    out = torch.empty_like(q)
    err = build.load("paged_prefill")(
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], _ptr(q),
        _ptr(k_pages), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales),
        _ptr(block_table), _ptr(out), hq, hkv, k_pages.shape[1], bs, d,
        block_table.shape[0], c, q_offset, ctx_len, scale, _stream(q))
    _raise_on(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
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


KERNELS = (paged_decode_attention, paged_prefill_attention, quantize_int8)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
