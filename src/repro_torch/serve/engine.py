"""Paged-cache prefill/decode forward for the dense decoder (port of
``repro/serve/engine.py``).

Splits :func:`repro_torch.models.lm.forward` at the KV boundary so the
serving tier runs against the block pools of
:mod:`repro_torch.serve.kvcache`:

  * **prefill** (monolithic) runs the contiguous forward over the prompt
    padded to a fixed ``max_context`` bucket and returns the last true
    token's logits plus the layer-stacked K/V to scatter into blocks;
  * **prefill_chunk** runs one fixed-size prompt chunk of one request
    straight into its pool blocks — each layer appends the chunk's K/V
    and attends through the block table with the chunked paged-prefill
    kernel (:func:`repro_torch.kernels.ops.paged_prefill_attention`);
  * **decode** runs one token per lane for all ``slots`` lanes — each
    layer appends the token's K/V into its physical block and attends
    with the paged decode kernel
    (:func:`repro_torch.kernels.ops.paged_decode_attention`). Dead lanes
    point at the null block with ctx 0 and cost nothing in the kernel.

The layer walk is a Python loop over per-layer views of the stacked
parameters and pools; K/V rows are written into the pools IN PLACE, and
every method still returns the pools, as the reference's pure functions
return new ones. Host arrays handed in (tables, context lengths, tokens)
are copied to the device before use, so the caller may mutate them
right after the call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.serve import kvcache as KC

_PAGED_FAMILIES = ("dense",)


def _to_device(x, device, dtype=torch.int32) -> torch.Tensor:
    """A device tensor holding ``x`` — a fresh copy of a host array (never
    a view of its buffer), or ``x`` itself if it already is one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


class PagedEngine:
    """Paged prefill/decode forwards for one (cfg, spec, slots) on one
    device."""

    def __init__(self, cfg: ModelConfig, spec: KC.PagedCacheSpec, *,
                 max_context: int, slots: int, device="cuda"):
        if cfg.family not in _PAGED_FAMILIES:
            raise NotImplementedError(
                f"the port's paged serving covers the families "
                f"{_PAGED_FAMILIES}; {cfg.family!r} comes with a later slice")
        if cfg.window is not None:
            raise NotImplementedError(
                "paged serving assumes full causal attention (window=None)")
        if max_context > spec.max_tokens_per_req:
            raise ValueError(
                f"max_context {max_context} exceeds the table capacity "
                f"{spec.max_tokens_per_req} tokens")
        self.cfg = cfg
        self.spec = spec
        self.max_context = int(max_context)
        self.slots = int(slots)
        self.device = torch.device(device)
        # (params, their layer views, pools, their layer views)
        self._views = (None, None, None, None)

    # ---- pools --------------------------------------------------------
    def init_pools(self) -> Dict:
        return KC.init_pools(self.cfg, self.spec, self.device)

    def _layer_views(self, params, pools):
        """Per-layer views of the stacked params and pools, rebuilt only
        when a different params or pools object comes in: the host, not the
        card, bounds a decode step, and re-slicing every layer on every
        step was part of that cost. Pool tensors are written in place and
        never replaced, so a cached view stays valid as long as its dict."""
        p0, lp, q0, lq = self._views
        if p0 is not params:
            p0, lp = params, [lm.layer(params["blocks"], l)
                              for l in range(self.cfg.num_layers)]
        if q0 is not pools:
            q0, lq = pools, [{k: t[l] for k, t in pools.items()}
                             for l in range(self.cfg.num_layers)]
        self._views = (p0, lp, q0, lq)
        return lp, lq

    # ---- prefill ------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens, length: int) -> Tuple:
        """tokens: [1, max_context] int32 (padded); length: the true
        prompt length. Returns (last-token logits [1, V], k [L, Hkv, Smax,
        D], v)."""
        cfg = self.cfg
        tokens = _to_device(tokens, self.device)
        caches = lm.init_cache(cfg, 1, self.max_context, self.device)
        x, caches, _ = lm.forward(params, cfg, tokens, caches=caches,
                                  hidden_only=True)
        logits = lm.logits_of(params, cfg, x[:, int(length) - 1])
        return logits, caches["k"][:, 0], caches["v"][:, 0]

    @torch.no_grad()
    def write_prefill(self, pools, k_layers, v_layers, table_row) -> Dict:
        return KC.write_prefill(pools, self.spec, k_layers, v_layers,
                                _to_device(table_row, self.device))

    # ---- shared layer body -------------------------------------------
    def _layer(self, lp, lpools, x, rot, phys, off, attend):
        """One block: qkv + rope, K/V append into the pools, paged
        attention through ``attend(q, lpools)``, wo, FFN."""
        cfg = self.cfg
        h = B.rms_norm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = B.qkv(lp["attn"], h, cfg, rot)
        # rows [Hkv, N, D] in the order of phys/off (lane- or chunk-major)
        n_kv = cfg.num_kv_heads
        k_rows = k.transpose(0, 1).reshape(n_kv, -1, cfg.hd)
        v_rows = v.transpose(0, 1).reshape(n_kv, -1, cfg.hd)
        KC.append_token(lpools, self.spec, k_rows, v_rows, phys, off)
        o = attend(q, lpools)
        x = x + (o @ lp["attn"]["wo"]).to(x.dtype)
        hh = B.rms_norm(lp["ln2"], x, cfg.norm_eps)
        return x + B.mlp(lp["ffn"], hh)

    # ---- chunked prefill ---------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, params, pools, tokens, table, q_offset: int,
                      chunk_len: int) -> Tuple:
        """One prompt chunk of ONE request straight into its pool blocks.

        tokens: [C] int32 (rows past ``chunk_len`` are padding); table:
        [T] int32 logical->physical; q_offset/chunk_len: host ints (the
        chunk covers positions [q_offset, q_offset + chunk_len)). Padding
        rows write into the null block. Returns (logits [1, V] of the
        chunk's last true row — only meaningful on the final chunk — and
        the pools)."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        nq, hd = cfg.num_heads, cfg.hd
        q_offset, chunk_len = int(q_offset), int(chunk_len)
        tokens = _to_device(tokens, dev)
        table = _to_device(table, dev)
        c = tokens.shape[0]
        t = table.shape[0]

        x = B.embed(params["embed"], tokens[None])         # [1, C, d]
        pos = q_offset + torch.arange(c, dtype=torch.int32, device=dev)
        positions = pos[None]                              # [1, C]
        blk = (pos // spec.block_size).long().clamp(max=t - 1)
        live = torch.arange(c, device=dev) < chunk_len
        phys = torch.where(live, table[blk], 0).long()     # [C]
        off = (pos % spec.block_size).long()
        rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)

        def attend(q, lp):
            o = kops.paged_prefill_attention(
                q[0], lp["k"], lp["v"], table, q_offset,
                q_offset + chunk_len, scale=hd ** -0.5,
                k_scales=lp.get("k_scale"), v_scales=lp.get("v_scale"))
            return o.transpose(0, 1).reshape(1, c, nq * hd)   # [1, C, Hq*D]

        for lp, lpools in zip(*self._layer_views(params, pools)):
            x = self._layer(lp, lpools, x, rot, phys, off, attend)
        h = B.rms_norm(params["ln_f"], x[:, chunk_len - 1], cfg.norm_eps)
        return lm.logits_of(params, cfg, h), pools

    @torch.no_grad()
    def copy_block(self, pools, src: int, dst: int) -> Dict:
        """Copy-on-write helper: clone physical block ``src`` into ``dst``
        across every pool tensor (block axis 2 of [L, Hkv, NB, bs, D])."""
        for p in pools.values():
            p[:, :, int(dst)] = p[:, :, int(src)]
        return pools

    # ---- decode -------------------------------------------------------
    @torch.no_grad()
    def decode(self, params, pools, tokens, tables, ctx_lens) -> Tuple:
        """One decode step for all slots.

        tokens: [slots] int32 (the pending token per lane); tables:
        [slots, T] int32; ctx_lens: [slots] int32 (KV written so far —
        the pending token's position). Returns (logits [slots, V], the
        pools)."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        nq, hd = cfg.num_heads, cfg.hd
        tokens = _to_device(tokens, dev)
        tables = _to_device(tables, dev)
        ctx_lens = _to_device(ctx_lens, dev)
        slots = tokens.shape[0]

        x = B.embed(params["embed"], tokens[:, None])      # [slots, 1, d]
        positions = ctx_lens[:, None]                      # [slots, 1]
        blk = (ctx_lens // spec.block_size).long().clamp(
            max=tables.shape[1] - 1)[:, None]
        phys = tables.gather(1, blk)[:, 0].long()          # [slots]
        off = (ctx_lens % spec.block_size).long()
        seen = ctx_lens + 1
        rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)

        def attend(q, lp):
            o = kops.paged_decode_attention(
                q[:, :, 0], lp["k"], lp["v"], tables, seen, scale=hd ** -0.5,
                k_scales=lp.get("k_scale"), v_scales=lp.get("v_scale"))
            return o.reshape(slots, 1, nq * hd)

        for lp, lpools in zip(*self._layer_views(params, pools)):
            x = self._layer(lp, lpools, x, rot, phys, off, attend)
        x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return lm.logits_of(params, cfg, x)[:, 0], pools

    # ---- sampling -----------------------------------------------------
    def make_sampler(self, sampling: str = "greedy",
                     temperature: float = 1.0):
        """sampler(logits [B, V], generator) -> tokens [B] int32. Greedy
        ignores the generator; temperature sampling draws from it."""
        if sampling == "greedy":
            def sample(logits, generator):
                return torch.argmax(logits, dim=-1).to(torch.int32)
        elif sampling == "temperature":
            t = float(temperature)

            def sample(logits, generator):
                probs = torch.softmax(logits.float() / t, dim=-1)
                return torch.multinomial(probs, 1, generator=generator
                                         )[:, 0].to(torch.int32)
        else:
            raise ValueError(
                f"unknown sampling {sampling!r} (greedy|temperature)")
        return sample

    def pad_prompt(self, prompt) -> Tuple:
        """Host helper: right-pad a [s] prompt to the fixed prefill
        bucket. Returns (tokens [1, max_context] int32 on the device,
        length)."""
        s = len(prompt)
        if s > self.max_context:
            raise ValueError(f"prompt length {s} > max_context "
                             f"{self.max_context}")
        buf = np.zeros((1, self.max_context), np.int32)
        buf[0, :s] = np.asarray(prompt, np.int32)
        return _to_device(buf, self.device), s
