"""Paged KV-cache manager: block-table allocation over a fixed pool
(port of ``repro/serve/kvcache.py``).

Physical KV storage is a fixed pool of ``num_blocks`` blocks of
``block_size`` tokens per (layer, kv-head), and each in-flight request
holds a *logical* view — a row of physical block ids — so admission and
eviction never copy or compact KV state. Physical block 0 is reserved as
the null block: dead table slots point at it, its contents are garbage
by design, and the paged kernels never load it for a live position.

Two cache modes share the layout:

  * model-dtype pools — K/V stored as written;
  * int8 pools — every (token, kv-head) row is quantized with a per-row
    absmax scale, stored beside as [..., 1] float32, the way the
    ``quantize_int8`` kernel quantizes it zero-padded to its 128-lane
    layout (padding cannot change a row's absmax) with the random-bits
    input pinned to 2**31 — ``floor(x + 0.5)`` — so cache quantization
    is deterministic round-to-nearest: a cache entry must read back
    identically every step. Each append (K and V of every row, codes and
    scales) is one launch of the fused kernel
    :func:`repro_torch.kernels.ops.quantize_kv_append`, except a decode
    step's on the TMA-fed routes: there the decode kernel writes the rows
    itself, bitwise the same
    (:func:`repro_torch.kernels.ops.paged_decode_append_attention`).

Host-side allocation (:class:`BlockAllocator`, :class:`PrefixCache`) is
plain Python, copied from the reference. Unlike the reference's pure
functions, :func:`write_prefill`, :func:`append_token` and
:func:`scatter_rows` write into the pool tensors IN PLACE (``pool[l, :,
phys, off] = rows``) and return the same dict; :func:`gather_rows`
returns copies, the speculative decoder's rollback snapshot.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import LANES

#: pinned random-bits word giving u = 0.5 — deterministic round-to-nearest
NEAREST_BITS = 1 << 31


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Pool geometry: ``num_blocks`` physical blocks (block 0 reserved as
    the null block) of ``block_size`` tokens; request tables are
    ``max_blocks_per_req`` wide; ``quantized`` selects int8 pools."""
    num_blocks: int
    block_size: int
    max_blocks_per_req: int
    quantized: bool = False

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if self.block_size < 1 or self.max_blocks_per_req < 1:
            raise ValueError("block_size/max_blocks_per_req must be >= 1")

    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    @property
    def max_tokens_per_req(self) -> int:
        return self.max_blocks_per_req * self.block_size

    @classmethod
    def for_requests(cls, slots: int, max_tokens: int, block_size: int = 16,
                     quantized: bool = False, headroom: int = 1
                     ) -> "PagedCacheSpec":
        """A pool sized so ``slots`` concurrent requests of up to
        ``max_tokens`` always fit, plus the null block and ``headroom``
        spare blocks."""
        per_req = -(-max_tokens // block_size)
        return cls(num_blocks=1 + slots * per_req + headroom,
                   block_size=block_size, max_blocks_per_req=per_req,
                   quantized=quantized)


class BlockAllocator:
    """Refcounted free-list allocator over the physical pool (host-side).

    Allocation is all-or-nothing: ``alloc(n)`` returns ``None`` when the
    pool cannot cover the whole request, so admission never strands a
    partially-allocated request. Block 0 never enters the free list.

    Every live block carries a reference count: ``alloc`` hands blocks
    out at refcount 1, ``share`` increments (prefix-cache sharing — a
    second request mapping the same physical template blocks), and
    ``release`` decrements, returning a block to the free list only when
    its count reaches zero. Releasing a block more times than it is
    currently held (in one call or across calls) raises — the double-free
    safety net predates refcounting and survives it. Shared blocks are
    read-only by contract; a writer must drop its share and copy first
    (copy-on-write, orchestrated by the scheduler via
    ``PagedEngine.copy_block``)."""

    def __init__(self, spec: PagedCacheSpec):
        self.spec = spec
        self._free: List[int] = list(range(spec.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.spec.num_blocks - 1) - len(self._free)

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 when free)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free) or n > self.spec.max_blocks_per_req:
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def share(self, blocks: Sequence[int]) -> None:
        """Increment the refcount of already-live blocks (all-or-nothing:
        validates every id before touching any count)."""
        for b in blocks:
            if not 0 < b < self.spec.num_blocks:
                raise ValueError(f"block id {b} outside the pool")
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"share of free block {b}")
        for b in blocks:
            self._refs[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        counts: Dict[int, int] = {}
        for b in blocks:
            if not 0 < b < self.spec.num_blocks:
                raise ValueError(f"block id {b} outside the pool")
            counts[b] = counts.get(b, 0) + 1
        for b, n in counts.items():
            if n > self._refs.get(b, 0):
                raise ValueError(f"double free of block {b}")
        for b, n in counts.items():
            self._refs[b] -= n
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)


class PrefixCache:
    """Pod prefix registry: full-block token chains -> physical blocks.

    Fleet prompts are templated per pod (shared prefix + unique suffix),
    so the KV state of the template blocks is identical across a pod's
    requests — K/V rows are a pure function of the token prefix. The
    registry maps each *full* block of a finished prompt, keyed by the
    entire token prefix up to that block boundary (a collision-free
    realization of token-hash chaining: matching key m+1 implies key m
    matched), to the physical block holding its K/V. A later request
    walks its own prompt's chain, maps every hit via
    ``BlockAllocator.share`` instead of recomputing, and resumes chunked
    prefill at the first uncached token.

    Only blocks whose ``block_size`` tokens are all prompt tokens are
    ever registered — decode appends land at position >= len(prompt),
    i.e. in later blocks — so registered blocks are immutable for the
    lifetime of the registration. When a prompt is covered end-to-end by
    cached blocks the model still owes the last token's logits; the last
    matched block is returned as ``cow_src`` for the scheduler to
    copy-on-write (copy to a private block, drop the share) so the
    recompute of that final token never writes into a shared block.

    Entries are LRU-ordered; :meth:`evict` frees registry-only blocks
    (refcount 1) from the cold end when admission runs out of pool."""

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._map: "OrderedDict[tuple, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.cached_tokens = 0
        self.shared_blocks = 0     # pool blocks a request mapped vs computed

    def __len__(self) -> int:
        return len(self._map)

    def _chain_keys(self, prompt: Sequence[int]):
        bs = self.allocator.spec.block_size
        for m in range(len(prompt) // bs):
            yield tuple(prompt[:(m + 1) * bs])

    def match(self, prompt: Sequence[int]):
        """Longest registered full-block prefix of ``prompt``.

        Returns ``(shared, cow_src, resume_pos)``: ``shared`` are the
        physical blocks to map read-only into the request's table (each
        already incref'd here), ``cow_src`` is the incref'd block the
        scheduler must copy-on-write when the whole prompt was covered
        (else None), and ``resume_pos`` is the first prompt position
        chunked prefill still has to compute."""
        blocks = []
        for key in self._chain_keys(prompt):
            b = self._map.get(key)
            if b is None:
                break
            blocks.append(b)
            self._map.move_to_end(key)
        if not blocks:
            self.misses += 1
            return [], None, 0
        cow_src = None
        bs = self.allocator.spec.block_size
        resume = len(blocks) * bs
        if resume == len(prompt):
            # Whole prompt cached; recompute only the final token for its
            # logits, through a private copy of its block.
            cow_src = blocks.pop()
            resume = len(prompt) - 1
        self.allocator.share(blocks + ([cow_src] if cow_src is not None
                                       else []))
        self.hits += 1
        self.cached_tokens += resume
        self.shared_blocks += len(blocks)   # the CoW copy is not a saving
        return blocks, cow_src, resume

    def insert(self, prompt: Sequence[int], table: Sequence[int]) -> None:
        """Register ``prompt``'s full blocks out of a finished prefill's
        ``table`` (logical order). Already-registered chains keep their
        existing block; new registrations hold one registry ref."""
        for m, key in enumerate(self._chain_keys(prompt)):
            if key in self._map:
                self._map.move_to_end(key)
                continue
            b = int(table[m])
            self.allocator.share([b])
            self._map[key] = b

    def evict(self, want_blocks: int) -> int:
        """Drop cold registry-only entries (refcount 1 — no live request
        shares them) until ``want_blocks`` blocks were freed or no entry
        is evictable. Returns the number freed."""
        freed = 0
        for key in list(self._map):
            if freed >= want_blocks:
                break
            b = self._map[key]
            if self.allocator.refcount(b) == 1:
                del self._map[key]
                self.allocator.release([b])
                freed += 1
        return freed

    @property
    def registered_blocks(self) -> int:
        return len(set(self._map.values()))


# ---------------------------------------------------------------- pools ----
def init_pools(cfg: ModelConfig, spec: PagedCacheSpec, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Layer-stacked physical pools: k/v [L, Hkv, NB, bs, D] (+ float32
    [..., 1] absmax scales in int8 mode)."""
    shape = (cfg.num_layers, cfg.num_kv_heads, spec.num_blocks,
             spec.block_size, cfg.hd)
    if spec.quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def quantize_rows(x):
    """Deterministic round-to-nearest int8 quantization of the trailing
    axis: x [..., D] float -> (q int8 [..., D], scale float32 [..., 1]).
    Rows are zero-padded to the kernel's 128-lane layout; padding is
    absmax-neutral so the scales are exactly those of the D-wide rows."""
    lead, d = x.shape[:-1], x.shape[-1]
    if d > LANES:
        raise NotImplementedError(f"head_dim {d} > {LANES} lanes")
    rows = F.pad(x.reshape(-1, d).float(), (0, LANES - d))
    # the word 2**31 as int32 bits, viewed as the kernel's uint32 input
    bits = torch.full(rows.shape, -NEAREST_BITS, dtype=torch.int32,
                      device=x.device).view(torch.uint32)
    q, scale = kops.quantize_int8(rows, bits)
    return q[:, :d].reshape(x.shape), scale.reshape(*lead, 1)


def dequantize_rows(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def write_prefill(pools: Dict, spec: PagedCacheSpec, k_layers, v_layers,
                  table_row) -> Dict:
    """Scatter one request's contiguous prefill K/V into its pool blocks,
    in place.

    k_layers/v_layers: [L, Hkv, S, D] (S is the padded prefill buffer —
    rows past the true context length are garbage and stay masked by
    ``ctx_lens``); table_row: [T] int32, trailing entries null. Blocks
    beyond the request's allocation scatter into the null block, which is
    garbage by contract."""
    if spec.quantized:
        kops.quantize_kv_append(pools["k"], pools["v"], pools["k_scale"],
                                pools["v_scale"], k_layers, v_layers,
                                table=table_row)
        return pools
    l, hkv, s, d = k_layers.shape
    bs = spec.block_size
    pad = (-s) % bs
    if pad:
        k_layers = F.pad(k_layers, (0, 0, 0, pad))
        v_layers = F.pad(v_layers, (0, 0, 0, pad))
    nb = (s + pad) // bs
    kb = k_layers.reshape(l, hkv, nb, bs, d)
    vb = v_layers.reshape(l, hkv, nb, bs, d)
    row = table_row[:nb].long()
    pools["k"][:, :, row] = kb.to(pools["k"].dtype)
    pools["v"][:, :, row] = vb.to(pools["v"].dtype)
    return pools


def gather_rows(pools: Dict, phys, off) -> Dict:
    """Snapshot pool rows at ``(phys, off)`` token positions.

    ``phys``/``off``: [N] int physical block ids and in-block offsets, on
    the pools' device. Returns ``{key: [L, Hkv, N, ...]}`` — copies of the
    exact stored rows (int8 codes AND their scales in quantized mode), so
    a later :func:`scatter_rows` restores them bitwise. This is the
    speculative decoder's rollback snapshot: taken over a lane's draft
    window before the batched verify appends draft K/V, then written back
    over the rejected tail so the pools are indistinguishable from never
    having drafted."""
    phys, off = phys.long(), off.long()
    return {key: p[:, :, phys, off] for key, p in pools.items()}


def scatter_rows(pools: Dict, rows: Dict, phys, off) -> Dict:
    """Write :func:`gather_rows` snapshots back at ``(phys, off)``, in
    place.

    Callers mask a *partial* restore by redirecting kept positions to the
    null block (``phys = where(rejected, phys, 0)``); duplicate writes
    into block 0 are harmless by the null-block contract."""
    phys, off = phys.long(), off.long()
    for key, p in pools.items():
        p[:, :, phys, off] = rows[key].to(p.dtype)
    return pools


def append_token(pools: Dict, spec: PagedCacheSpec, k_tok, v_tok, phys, off
                 ) -> Dict:
    """Write token K/V rows into one layer's pools, in place.

    k_tok/v_tok: [Hkv, N, D] (a single layer's new rows, rows in the
    middle so the value matches ``pools[:, phys, off]``); pools here are
    the [Hkv, NB, bs, D] views of one layer; phys/off: [N] physical block
    id and in-block offset. Inactive rows point at (null, 0) — duplicate
    writes there are harmless."""
    if spec.quantized:
        kops.quantize_kv_append(pools["k"], pools["v"], pools["k_scale"],
                                pools["v_scale"], k_tok, v_tok, phys, off)
        return pools
    phys, off = phys.long(), off.long()
    pools["k"][:, phys, off] = k_tok.to(pools["k"].dtype)
    pools["v"][:, phys, off] = v_tok.to(pools["v"].dtype)
    return pools
