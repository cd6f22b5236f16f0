#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written kernels from src/repro_torch/kernels/csrc
     with nvcc for sm_90a, and prints the build time;
  3. holds each kernel against its plain PyTorch version on the card at
     flad-adllm's serving shapes (8 lanes, block size 16, chunk 16,
     contexts up to 300 tokens) and times both with CUDA events;
  4. serves flad-adllm at full width and depth (bf16, random weights from
     a seed) through the continuous scheduler with chunked prefill, once
     with the model-dtype KV cache and once with the int8 cache, and
     checks that the kernels' launch counters moved as the path requires;
  5. holds the paged path against the contiguous-cache forward
     (plain attention), teacher-forced, and measures the int8 cache's
     greedy disagreement;
  6. prints one JSON line describing every ported kernel;
  7. prints {"ok": true, "device": {...}} as its last line.

Any failed check raises, so the script exits non-zero and prints no
result line. It also exits non-zero when torch sees no CUDA device, and
when run without the repository's src/ beside it. It never imports JAX
or the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
SLOTS, BLOCK, CHUNK = 8, 16, 16
DECODE_CTX = [0, 1, 16, 47, 100, 203, 256, 300]   # ctx 0 + partial blocks
PREFILL_CHUNKS = [(0, 16), (112, 16), (288, 7)]   # (q_offset, chunk_len)
ATOL_BF16 = 2e-2               # attention output, bf16, vs float32 plain
# logits of the whole 16-layer path, paged (kernels) vs contiguous (plain
# attention), teacher-forced: float32 differs only in summation order;
# bf16 also rounds the attention output at different points
ORACLE_ATOL_F32 = 1e-4
ORACLE_ATOL_BF16 = 0.25
TRACE = dict(fleet="nano*2,agx*2", num_requests=12, max_prompt=96, seed=0)
LIBRARY_NOTE = ("no single PyTorch call computes paged attention through "
                "a block table or this stochastic int8 quantizer")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, iters=200, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match=None, iters=50):
    """Mean device time per call of ``fn`` from torch.profiler's CUDA
    trace: the summed durations of the kernels whose name contains
    ``match`` (every kernel when None), divided by ``iters``. None when
    the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if match is None or match in evt.key:
            total += (getattr(evt, "device_time_total", 0)
                      or getattr(evt, "cuda_time_total", 0))
    return total / iters / 1e3 if total > 0 else None


def timings(kernel_fn, plain_fn, match):
    """(kernel device ms, plain device ms, kernel ms per call on the host
    clock incl. the wrapper) — device times from the profiler, falling
    back to CUDA events over back-to-back calls when it saw nothing."""
    call = time_ms(kernel_fn)
    k = device_ms(kernel_fn, match)
    p = device_ms(plain_fn, None, iters=20)
    return (k if k is not None else call,
            p if p is not None else time_ms(plain_fn, iters=50), call)


def bound(nbytes, flops, flops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# ------------------------------------------------------------ kernel inputs
def paged_pools(torch, cfg, kv_dtype, nb, seed, dev):
    """Random [Hkv, NB, bs, D] pools (+ scales for int8) with the null
    block 0 poisoned: NaN values (float) or NaN scales (int8)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.num_kv_heads, nb, BLOCK, cfg.hd)
    if kv_dtype == torch.int8:
        kq = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
        vq = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
        ks = torch.rand(shape[:3] + (1,), generator=g, device=dev) * 2e-2
        vs = torch.rand(shape[:3] + (1,), generator=g, device=dev) * 2e-2
        ks[:, 0] = float("nan")
        vs[:, 0] = float("nan")
        return kq, vq, ks, vs
    k = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
    v = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
    k[:, 0] = float("nan")
    v[:, 0] = float("nan")
    return k, v, None, None


def block_tables(ctx_list, t, rng):
    """Per-lane tables over shuffled physical blocks 1..; dead slots 0."""
    need = [-(-c // BLOCK) for c in ctx_list]
    phys = rng.permutation(np.arange(1, 1 + sum(need))).astype(np.int32)
    tables = np.zeros((len(ctx_list), t), np.int32)
    i = 0
    for lane, n in enumerate(need):
        tables[lane, :n] = phys[i:i + n]
        i += n
    return tables, 1 + sum(need)


def kernel_checks(torch, cfg, dev):
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    t = -(-max(DECODE_CTX) // BLOCK) + 1
    out = {}

    # ---- paged decode: bf16 and int8 pools, NaN-poisoned null block
    tables_np, nb = block_tables(DECODE_CTX, t, rng)
    tables = torch.tensor(tables_np, device=dev)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, hq, d), device=dev).to(torch.bfloat16)
    rows = sum(DECODE_CTX)
    errs, times = [], {}
    for name, kv_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, nb + 1, 1, dev)
        args = (q, k, v, tables, ctx)
        kw = dict(k_scales=ks, v_scales=vs)
        got = ops.paged_decode_attention(*args, **kw)
        want = ref.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"decode {name}: non-finite")
        check(bool((got[0] == 0).all()), f"decode {name}: ctx-0 lane != 0")
        err = float((got.float() - want.float()).abs().max())
        check(err <= ATOL_BF16, f"decode {name}: max err {err} > {ATOL_BF16}")
        errs.append(err)
        times[name] = timings(
            lambda: ops.paged_decode_attention(*args, **kw),
            lambda: ref.paged_decode_attention_ref(*args, **kw),
            "paged_decode_kernel")
        print(f"[kernel] paged_decode_attention {name} pools: max|err| "
              f"{err:.3e} (atol {ATOL_BF16}); device: kernel "
              f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms; "
              f"host clock per call {times[name][2]:.5f} ms")
    # main path: bf16 pools
    nbytes = (2 * q.numel() * 2 + 2 * rows * hkv * d * 2
              + tables.numel() * 4 + ctx.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * rows * hq * d, BF16_FLOPS_PER_S)
    out["paged_decode_attention"] = dict(
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:304",
        max_abs_err=max(errs), ms=times["bf16"][0], plain_ms=times["bf16"][1],
        call_ms=times["bf16"][2], bound_ms=b_ms, bound_by=b_by,
        int8_ms=times["int8"][0], int8_plain_ms=times["int8"][1])

    # ---- paged prefill: first, middle and partial last chunk
    ctx_max = max(o + c for o, c in PREFILL_CHUNKS)
    t1 = -(-ctx_max // BLOCK) + 1
    tbl_np, nb1 = block_tables([ctx_max], t1, rng)
    table = torch.tensor(tbl_np[0], device=dev)
    errs, times = [], {}
    for name, kv_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, nb1 + 1, 2, dev)
        kw = dict(k_scales=ks, v_scales=vs)
        for off, clen in PREFILL_CHUNKS:
            qc = torch.randn((hq, CHUNK, d), device=dev).to(torch.bfloat16)
            args = (qc, k, v, table, off, off + clen)
            got = ops.paged_prefill_attention(*args, **kw)
            want = ref.paged_prefill_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"prefill {name} @{off}: non-finite")
            err = float((got[:, :clen].float()
                         - want[:, :clen].float()).abs().max())
            check(err <= ATOL_BF16,
                  f"prefill {name} @{off}: max err {err} > {ATOL_BF16}")
            errs.append(err)
        # time the partial last chunk, the longest context
        times[name] = timings(
            lambda: ops.paged_prefill_attention(*args, **kw),
            lambda: ref.paged_prefill_attention_ref(*args, **kw),
            "paged_prefill_kernel")
        print(f"[kernel] paged_prefill_attention {name} pools: max|err| "
              f"{max(errs):.3e} (atol {ATOL_BF16}); device: kernel "
              f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms; "
              f"host clock per call {times[name][2]:.5f} ms (chunk at "
              f"{off}, {clen} rows)")
    off, clen = PREFILL_CHUNKS[-1]
    ctx_len = off + clen
    nbytes = (2 * hq * CHUNK * d * 2 + 2 * ctx_len * hkv * d * 2
              + table.numel() * 4)
    flops = 4 * hq * d * sum(off + c + 1 for c in range(clen))
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    out["paged_prefill_attention"] = dict(
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/flash_attention.py:442",
        max_abs_err=max(errs), ms=times["bf16"][0], plain_ms=times["bf16"][1],
        call_ms=times["bf16"][2], bound_ms=b_ms, bound_by=b_by,
        int8_ms=times["int8"][0], int8_plain_ms=times["int8"][1])

    # ---- quantize: bitwise, random and pinned bits, an all-zero row
    m = hkv * CHUNK                 # rows of one layer's chunk K (or V)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((m, ops.LANES), generator=g, device=dev)
    x[:, cfg.hd:] = 0.0             # head_dim 64 zero-padded to 128 lanes
    x[5] = 0.0
    random_bits = torch.tensor(
        rng.integers(0, 2 ** 32, (m, ops.LANES), dtype=np.uint64)
        .astype(np.uint32).view(np.int32), device=dev).view(torch.uint32)
    pinned = torch.full((m, ops.LANES), -(1 << 31), dtype=torch.int32,
                        device=dev).view(torch.uint32)
    for name, bits in (("random", random_bits), ("pinned", pinned)):
        qk, sk = ops.quantize_int8(x, bits)
        qr, sr = ref.quantize_int8_ref(x, bits)
        torch.cuda.synchronize()
        check(torch.equal(qk, qr) and torch.equal(sk, sr),
              f"quantize ({name} bits) differs from the plain version: "
              f"{int((qk != qr).sum())} codes, {int((sk != sr).sum())} "
              f"scales")
        check(float(sk[5]) == 0.0 and not bool(qk[5].any()),
              "quantize: zero row must give scale 0 and q 0")
    ms, plain, call = timings(lambda: ops.quantize_int8(x, pinned),
                              lambda: ref.quantize_int8_ref(x, pinned),
                              "quantize_int8_kernel")
    print(f"[kernel] quantize_int8: bitwise equal (random and pinned bits, "
          f"zero row); device: kernel {ms:.5f} ms, plain {plain:.5f} ms; "
          f"host clock per call {call:.5f} ms ({m} rows)")
    nbytes = m * ops.LANES * (4 + 4 + 1) + m * 4
    b_ms, b_by = bound(nbytes, 4 * m * ops.LANES, F32_FLOPS_PER_S)
    out["quantize_int8"] = dict(
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:70", max_abs_err=0.0,
        ms=ms, plain_ms=plain, call_ms=call, bound_ms=b_ms, bound_by=b_by)
    return out


# --------------------------------------------------------------- main path
def serve_main_path(torch, cfg, params, dev):
    """Serve a fleet trace with both cache modes; returns launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serve import serve_continuous
    totals = {name: 0 for name in ops.launch_counts()}
    reports = {}
    for cache in ("fp32", "int8"):
        ops.reset_launch_counts()
        rep = serve_continuous(
            cfg, params=params, device=dev, cache=cache, prefill="chunked",
            prefill_chunk=CHUNK, slots=SLOTS, block_size=BLOCK,
            max_context=128, warm_passes=1, **TRACE)
        counts = ops.launch_counts()
        passes = 2                  # one cold pass + one warm pass
        L = cfg.num_layers
        check(rep["requests"] == 12 and rep["unstarted_requests"] == 0,
              f"{cache}: not every request finished")
        check(all(0 <= tok < cfg.vocab_size
                  for s in rep["sequences"].values() for tok in s),
              f"{cache}: token id out of range")
        want = {
            "paged_decode_attention": passes * L * rep["decode_steps"],
            "paged_prefill_attention": passes * L * rep["prefill_chunks"],
            "quantize_int8": (passes * 2 * L * (rep["decode_steps"]
                                                + rep["prefill_chunks"])
                              if cache == "int8" else 0),
        }
        check(counts == want, f"{cache}: launches {counts} != {want}")
        for name in totals:
            totals[name] += counts[name]
        print(f"[serve] cache={cache}: {rep['requests']} requests, "
              f"{rep['total_new_tokens']} tokens, {rep['decode_steps']} "
              f"decode steps, {rep['prefill_chunks']} prefill chunks; warm "
              f"{rep['warm_tokens_per_s']:.1f} tok/s (cold "
              f"{rep['tokens_per_s']:.1f}); launches {counts}")
        reports[cache] = rep
    for name, n in totals.items():
        check(n > 0, f"{name} was never launched on the main path")
    return totals, reports


def profile_decode(torch, cfg, params, dev, steps=10):
    """Warm decode steps with all lanes live: wall time per step on the
    host clock, and the device's busy time per step from torch.profiler
    (the summed kernel, copy and fill durations on the one stream)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (ContinuousScheduler, PagedCacheSpec,
                                   PagedEngine, generate_fleet_requests)
    spec = PagedCacheSpec.for_requests(SLOTS, 96 + 110, block_size=BLOCK)
    eng = PagedEngine(cfg, spec, max_context=128, slots=SLOTS, device=dev)
    sched = ContinuousScheduler(eng, params, prefill="chunked",
                                prefill_chunk=CHUNK)
    for r in generate_fleet_requests(
            TRACE["fleet"], num_requests=SLOTS, max_prompt=96, seed=1,
            short_new=(100, 110), long_new=(100, 110),
            vocab_size=cfg.vocab_size):
        sched.submit(r)
    while not (sched.num_active == SLOTS and sched.prefill_done.all()):
        sched.step()

    def run():
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:60])
                  for e in prof.key_averages())[::-1]
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"[profile] warm decode step, {SLOTS} live lanes: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms (idle "
          f"{100 * (1 - busy / wall):.1f}%), {launches} device ops/step, "
          f"{SLOTS / wall * 1e3:.0f} tok/s")
    for t, n, key in rows[:6]:
        print(f"[profile]   {t:.4f} ms/step in {n:4d} x {key}")
    return wall, busy


def contiguous_oracle(torch, cfg, params, dev, streams, prompts):
    """Teacher-forced paged engine (kernels) vs lm.forward with a
    contiguous cache (plain attention); max logit difference and argmax
    agreement over every position."""
    from repro_torch.models import lm
    from repro_torch.serve import BlockAllocator, PagedCacheSpec, PagedEngine
    cap = max(len(p) + len(s) for p, s in zip(prompts, streams))
    spec = PagedCacheSpec.for_requests(1, cap, block_size=BLOCK)
    eng = PagedEngine(cfg, spec, max_context=cap, slots=1, device=dev)
    drift, agree, total = 0.0, 0, 0
    with torch.no_grad():
        for prompt, stream in zip(prompts, streams):
            blocks = BlockAllocator(spec).alloc(spec.blocks_needed(
                len(prompt) + len(stream)))
            tbl = np.zeros((1, spec.max_blocks_per_req), np.int32)
            tbl[0, :len(blocks)] = blocks
            pools = eng.init_pools()
            for pos in range(0, len(prompt), CHUNK):
                clen = min(CHUNK, len(prompt) - pos)
                buf = np.zeros(CHUNK, np.int32)
                buf[:clen] = prompt[pos:pos + clen]
                paged, pools = eng.prefill_chunk(params, pools, buf, tbl[0],
                                                 pos, clen)
            cache = lm.init_cache(cfg, 1, cap, dev)
            toks = torch.tensor(np.asarray(prompt, np.int32)[None], device=dev)
            dense, cache, _ = lm.forward(params, cfg, toks, caches=cache)
            dense = dense[:, -1]
            for i, tok in enumerate(stream):
                check(bool(torch.isfinite(paged).all()
                           and torch.isfinite(dense).all()),
                      "non-finite logits")
                drift = max(drift, float((paged - dense).abs().max()))
                agree += int(paged.argmax()) == int(dense.argmax())
                total += 1
                if i == len(stream) - 1:
                    break
                p = len(prompt) + i
                paged, pools = eng.decode(params, pools,
                                          np.array([tok], np.int32), tbl,
                                          np.array([p], np.int32))
                dense, cache, _ = lm.forward(
                    params, cfg, torch.tensor([[tok]], dtype=torch.int32,
                                              device=dev),
                    positions=torch.tensor([p], dtype=torch.int32,
                                           device=dev), caches=cache)
                dense = dense[:, -1]
    return drift, agree / total, total


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import lm
    from repro_torch.serve import generate_fleet_requests, int8_cache_fidelity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else kind
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"[build] {len(report)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for stem, r in report.items():
        for line in r["log"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")

    # 3. kernels against their plain versions
    cfg = get_config("flad-adllm")
    kernels = kernel_checks(torch, cfg, dev)

    # 4. the main path: serve flad-adllm at full width and depth
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e6:.1f} M params in {cfg.param_dtype}"
          f" ({time.perf_counter() - t0:.1f} s to init)")
    launches, reports = serve_main_path(torch, cfg, params, dev)
    profile_decode(torch, cfg, params, dev)

    # 5. paged path vs contiguous oracle, teacher-forced on served streams
    seqs = reports["fp32"]["sequences"]
    trace = generate_fleet_requests(
        TRACE["fleet"], num_requests=TRACE["num_requests"],
        max_prompt=TRACE["max_prompt"], seed=TRACE["seed"], deadline_s=4.0,
        vocab_size=cfg.vocab_size)
    reqs = sorted(trace, key=lambda r: -len(r.prompt))[:4]
    streams = {r.rid: seqs[r.rid] for r in reqs}
    for dtype, atol in (("float32", ORACLE_ATOL_F32),
                        ("bfloat16", ORACLE_ATOL_BF16)):
        c = cfg.replace(param_dtype=dtype)
        p = params if dtype == "bfloat16" else lm.LM(
            c, _cast(params.to_dict(), torch.float32))
        drift, agree, n = contiguous_oracle(
            torch, c, p, dev, [streams[r.rid] for r in reqs],
            [r.prompt for r in reqs])
        print(f"[oracle] {dtype}: paged (kernels) vs contiguous (plain) "
              f"logits over {n} teacher-forced positions: max|diff| "
              f"{drift:.3e} (atol {atol}), argmax agreement {agree:.3f}")
        check(drift <= atol, f"{dtype} paged-vs-contiguous drift {drift}")
    fid = int8_cache_fidelity(cfg, params, reqs, streams, block_size=BLOCK,
                              max_context=128, prefill="chunked",
                              prefill_chunk=CHUNK, device=dev)
    print(f"[oracle] int8 cache vs bf16 cache, teacher-forced: greedy "
          f"disagreement {fid['disagreement']:.4f} over {fid['positions']} "
          f"positions, max logit drift {fid['max_logit_drift']:.3e}")

    # 6. one line per ported kernel
    print(f"[kernels] library_ms is null: {LIBRARY_NOTE}")
    rows = []
    for name, k in kernels.items():
        rows.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"], "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None,
                     **{x: k[x] for x in ("call_ms", "int8_ms",
                                          "int8_plain_ms") if x in k}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
