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
    over it in one call
    (:func:`repro_torch.kernels.ops.paged_decode_append_attention`: on
    the TMA-fed routes one launch of the paged decode kernel, which
    writes the rows itself). Dead lanes point at the null block with ctx
    0 and cost nothing in the kernel;
  * **verify** scores a speculative draft window of k + 1 tokens per lane
    in one target forward: each layer appends the windows' K/V and
    attends with ONE launch of the batched verify kernel
    (:func:`repro_torch.kernels.ops.paged_verify_attention`, a window
    being a chunk of decode positions through the lane's table).

:class:`DraftEngine` runs the same forwards with a draft model's params
and a pool set of its own.

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
        # {"params" | "pools": [(object, its layer views)]}, newest last
        self._views = {"params": [], "pools": []}

    # ---- pools --------------------------------------------------------
    def init_pools(self) -> Dict:
        return KC.init_pools(self.cfg, self.spec, self.device)

    def _cached_views(self, kind: str, obj, make):
        """The layer views of ``obj``, kept for the two newest objects of
        each kind: the target's and, under speculative decoding, the
        draft model's params and pools, whose forwards alternate."""
        for o, views in self._views[kind]:
            if o is obj:
                return views
        views = make()
        self._views[kind] = (self._views[kind] + [(obj, views)])[-2:]
        return views

    def _layer_views(self, params, pools):
        """Per-layer views of the stacked params and pools, rebuilt only
        when a different params or pools object comes in: the host, not the
        card, bounds a decode step, and re-slicing every layer on every
        step was part of that cost. Pool tensors are written in place and
        never replaced, so a cached view stays valid as long as its dict."""
        n = self.cfg.num_layers
        lp = self._cached_views("params", params, lambda: [
            lm.layer(params["blocks"], l) for l in range(n)])
        lq = self._cached_views("pools", pools, lambda: [
            {k: t[l] for k, t in pools.items()} for l in range(n)])
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
    def _layer(self, lp, lpools, x, rot, attend):
        """One block: qkv + rope, the K/V append into the pools and paged
        attention through ``attend(q, k_rows, v_rows, lpools)``, wo,
        FFN."""
        cfg = self.cfg
        h = B.rms_norm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = B.qkv(lp["attn"], h, cfg, rot)
        # rows [Hkv, N, D] in the order of phys/off (lane- or chunk-major)
        n_kv = cfg.num_kv_heads
        k_rows = k.transpose(0, 1).reshape(n_kv, -1, cfg.hd)
        v_rows = v.transpose(0, 1).reshape(n_kv, -1, cfg.hd)
        o = attend(q, k_rows, v_rows, lpools)
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

        def attend(q, k_rows, v_rows, lp):
            KC.append_token(lp, spec, k_rows, v_rows, phys, off)
            o = kops.paged_prefill_attention(
                q[0], lp["k"], lp["v"], table, q_offset,
                q_offset + chunk_len, scale=hd ** -0.5,
                k_scales=lp.get("k_scale"), v_scales=lp.get("v_scale"))
            return o.transpose(0, 1).reshape(1, c, nq * hd)   # [1, C, Hq*D]

        for lp, lpools in zip(*self._layer_views(params, pools)):
            x = self._layer(lp, lpools, x, rot, attend)
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
        rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)

        def attend(q, k_rows, v_rows, lp):
            o = kops.paged_decode_append_attention(
                q[:, :, 0], k_rows, v_rows, lp["k"], lp["v"], tables,
                ctx_lens, phys, off, scale=hd ** -0.5,
                k_scales=lp.get("k_scale"), v_scales=lp.get("v_scale"))
            return o.reshape(slots, 1, nq * hd)

        for lp, lpools in zip(*self._layer_views(params, pools)):
            x = self._layer(lp, lpools, x, rot, attend)
        x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return lm.logits_of(params, cfg, x)[:, 0], pools

    # ---- speculative verify -------------------------------------------
    @torch.no_grad()
    def verify(self, params, pools, tokens, tables, ctx_lens,
               chunk_lens) -> Tuple:
        """Score a draft window of C = k+1 tokens per lane in ONE target
        forward (the speculative-decode verify pass).

        tokens: [slots, C] int32 — column 0 is the lane's pending token,
        columns 1..k its greedy draft proposals; tables: [slots, T];
        ctx_lens: [slots] int32 (KV written so far — column c sits at
        position ctx + c); chunk_lens: [slots] int32 per-lane window (rows
        at or past a lane's chunk_len write into the null block and give
        meaningless logits; a dead lane has ctx 0, table 0, window 0).
        Each layer appends the windows' K/V rows (lane-major) and attends
        through the lanes' tables in one launch of the batched verify
        kernel. Returns (logits [slots, C, V], the pools): row c of a
        lane is the next-token distribution after draft position c."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        nq, hd = cfg.num_heads, cfg.hd
        tokens = _to_device(tokens, dev)
        tables = _to_device(tables, dev)
        ctx_lens = _to_device(ctx_lens, dev)
        chunk_lens = _to_device(chunk_lens, dev)
        slots, c = tokens.shape

        x = B.embed(params["embed"], tokens)               # [slots, C, d]
        cols = torch.arange(c, dtype=torch.int32, device=dev)
        positions = ctx_lens[:, None] + cols[None, :]      # [slots, C]
        valid = cols[None, :] < chunk_lens[:, None]
        safe_pos = torch.where(valid, positions, 0)
        blk = (safe_pos // spec.block_size).long().clamp(
            max=tables.shape[1] - 1)
        phys = torch.where(valid, tables.gather(1, blk), 0).reshape(-1)
        off = torch.where(valid, safe_pos % spec.block_size, 0).reshape(-1)
        phys, off = phys.long(), off.long()                # [slots * C]
        rot = B.rope_tables(positions, cfg.hd, cfg.rope_theta)

        def attend(q, k_rows, v_rows, lp):
            KC.append_token(lp, spec, k_rows, v_rows, phys, off)
            o = kops.paged_verify_attention(
                q, lp["k"], lp["v"], tables, ctx_lens, chunk_lens,
                scale=hd ** -0.5, k_scales=lp.get("k_scale"),
                v_scales=lp.get("v_scale"))              # [slots, Hq, C, D]
            return o.transpose(1, 2).reshape(slots, c, nq * hd)

        for lp, lpools in zip(*self._layer_views(params, pools)):
            x = self._layer(lp, lpools, x, rot, attend)
        x = B.rms_norm(params["ln_f"], x, cfg.norm_eps)
        return lm.logits_of(params, cfg, x), pools

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


class DraftEngine:
    """Speculative-decode draft proposer sharing the target's machinery.

    Runs the *target* :class:`PagedEngine`'s forwards with the draft
    model's params (e.g. the distilled pod student: base + merged LoRA
    factors from ``DistillFLStrategy.pod_params`` — no second
    checkpoint) and a pool set of its own. Block tables and context
    lengths are the scheduler's: K/V rows are a pure function of the
    token prefix, so the target's logical layout — prefix-shared blocks
    included, which the scheduler mirrors into the draft pools at prefill
    and copy-on-write time — is valid for the draft pools verbatim."""

    def __init__(self, engine: PagedEngine, params, *, draft_k: int):
        if draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        self.engine = engine
        self.spec = engine.spec
        self.params = params
        self.draft_k = int(draft_k)
        self.pools = engine.init_pools()
        self._mirror_kv = None

    def propose(self, tokens, tables, ctx_lens, window) -> np.ndarray:
        """Greedily draft up to ``draft_k`` tokens per lane.

        tokens: [slots] int32 pending tokens; tables: [slots, T];
        ctx_lens: [slots]; window: [slots] per-lane draft budget
        (min(draft_k + 1, tokens the lane may still emit); 0 masks a lane
        out). Runs ``draft_k + 1`` batched draft decode forwards — forward
        i deposits token i's K/V at position ctx + i and proposes token
        i+1 — so even after a full accept the draft pools hold the true
        stream's K/V at every position below the new context length. A
        lane is masked to the dead-lane contract for forwards at or past
        its window, keeping appends inside its funded blocks. Each
        forward gets fresh host arrays (the engine copies them to the
        device). Returns drafts [slots, draft_k] int32 (zeros past a
        lane's window)."""
        slots = len(tokens)
        drafts = np.zeros((slots, self.draft_k), np.int32)
        tok = np.array(tokens, np.int32)
        tables = np.array(tables, np.int32)
        ctx = np.array(ctx_lens, np.int32)
        window = np.array(window, np.int32)
        for i in range(self.draft_k + 1):
            live = window > i
            t_i = np.where(live, tok, 0).astype(np.int32)
            tab_i = np.where(live[:, None], tables, 0).astype(np.int32)
            c_i = np.where(live, ctx + i, 0).astype(np.int32)
            logits, self.pools = self.engine.decode(
                self.params, self.pools, t_i, tab_i, c_i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            if i < self.draft_k:
                drafts[:, i] = np.where(window > i + 1, tok, 0)
        return drafts

    # ---- prefill mirroring (scheduler-driven) -------------------------
    def prefill(self, tokens, length) -> None:
        """Monolithic mirror: run the draft model's bucketed prefill and
        keep only its K/V (the stream samples from the target)."""
        _, k, v = self.engine.prefill(self.params, tokens, length)
        self._mirror_kv = (k, v)

    def write_prefill(self, table_row) -> None:
        k, v = self._mirror_kv
        self.pools = self.engine.write_prefill(self.pools, k, v, table_row)
        self._mirror_kv = None

    def prefill_chunk(self, tokens, table, pos, clen) -> None:
        """Chunked mirror: same chunk, draft params, draft pools."""
        _, self.pools = self.engine.prefill_chunk(
            self.params, self.pools, tokens, table, pos, clen)

    def copy_block(self, src, dst) -> None:
        """Copy-on-write mirror for whole-prompt prefix hits."""
        self.pools = self.engine.copy_block(self.pools, src, dst)
