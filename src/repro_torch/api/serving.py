"""Prefill + decode serving with a static batch (port of
``repro/api/serving.py``): the legacy scheduler behind
``Session.serve(scheduler="legacy")``.

Each request batch draws ``batch`` prompts of ``context`` tokens (an
encoder-decoder also ``context`` standard-normal frames of
``prefix_dim`` features a prompt, after the tokens), runs one prefill
into a fresh decode state and ``decode_steps`` one-token steps.
Throughput is reported two ways: ``tokens_per_s`` spans every request
batch (the first one pays the kernels' build and first launches), while
``warm_tokens_per_s`` is timed from the second batch onward; with a single
batch it falls back to the cold number. Wall times end in a device
synchronize.

Prompts and temperature samples come from two ``torch.Generator``\\ s on
the serving device, seeded with ``seed`` and ``seed + 1`` (the reference
splits a JAX key; the streams differ, so the tests feed both packages the
same numpy prompts through the step functions). Greedy decoding draws no
random numbers.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig


def _make_sampler(sampling: str, temperature: float):
    """sampler(logits [B, 1, V], gen) -> [B, 1] int32; greedy ignores
    ``gen``."""
    if sampling == "greedy":
        def sample(logits, gen):
            return logits.argmax(dim=-1).to(torch.int32)
    elif sampling == "temperature":
        t = float(temperature)

        def sample(logits, gen):
            probs = torch.softmax(logits.float() / t, dim=-1)
            flat = probs.reshape(-1, probs.shape[-1])
            tok = torch.multinomial(flat, 1, generator=gen)
            return tok.reshape(logits.shape[:-1]).to(torch.int32)
    else:
        raise ValueError(f"unknown sampling {sampling!r} "
                         "(greedy|temperature)")
    return sample


def serve_requests(cfg: ModelConfig, *, batch: int = 8, context: int = 64,
                   decode_steps: int = 16, requests: int = 3, params=None,
                   seed: int = 0, sampling: str = "greedy",
                   temperature: float = 1.0, device="cuda",
                   log_fn: Optional[Callable] = print) -> Dict:
    """Serve ``requests`` batches: one prefill + ``decode_steps`` decodes.

    ``params`` defaults to a fresh ``model.init`` seeded with ``seed`` on
    ``device``. Returns the generated sequences ([batch, decode_steps + 1]
    int32 each), token-throughput accounting (cold and warm), the last
    decode step's logits and the device."""
    from repro_torch.core.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build_model
    from repro_torch.serve import _synchronize

    device = torch.device(device)
    shape = ShapeConfig("serve", context + decode_steps, batch, "decode")
    model = build_model(cfg)
    if params is None:
        params = model.init(seed=seed, device=device)
    prefill = make_prefill_step(cfg, shape)
    serve = make_serve_step(cfg, shape)
    sample = _make_sampler(sampling, temperature)
    prompt_gen = torch.Generator(device=device)
    prompt_gen.manual_seed(seed)
    sample_gen = torch.Generator(device=device)
    sample_gen.manual_seed(seed + 1)

    sequences = []
    total_toks = warm_toks = 0
    warm_dt = 0.0
    logits = None
    t0 = time.perf_counter()
    with torch.no_grad():
        for r in range(requests):
            t_req = time.perf_counter()
            ctx = torch.randint(0, cfg.vocab_size, (batch, context),
                                generator=prompt_gen, device=device,
                                dtype=torch.int32)
            req = {"tokens": ctx}
            if cfg.family == "encdec":
                req["frames"] = torch.randn(
                    (batch, context, cfg.prefix_dim), generator=prompt_gen,
                    device=device)
            state = model.init_state(batch, shape.seq_len, device)
            logits, state = prefill(params, req, state)
            tok = sample(logits[:, -1:], sample_gen)
            out = [tok]
            for i in range(decode_steps):
                logits, state = serve(params, tok, state, context + i)
                tok = sample(logits[:, -1:], sample_gen)
                out.append(tok)
            seqs = torch.cat(out, dim=1)
            _synchronize(device)
            sequences.append(seqs)
            total_toks += seqs.numel()
            if r > 0:                  # batch 0 pays the kernels' builds
                warm_toks += seqs.numel()
                warm_dt += time.perf_counter() - t_req
            if log_fn:
                log_fn(f"[serve] request batch {r}: generated "
                       f"{tuple(seqs.shape)} first row: "
                       f"{seqs[0, :8].tolist()}")
    dt = time.perf_counter() - t0
    warm_tps = (warm_toks / warm_dt) if warm_dt > 0 else total_toks / dt
    if log_fn:
        log_fn(f"[serve] {total_toks} tokens in {dt:.2f}s "
               f"({total_toks / dt:.1f} tok/s incl. first launches, "
               f"{warm_tps:.1f} tok/s warm)")
    return {"sequences": sequences, "total_tokens": total_toks,
            "seconds": dt, "tokens_per_s": total_toks / dt,
            "warm_tokens_per_s": warm_tps, "last_logits": logits,
            "device": device.type}
