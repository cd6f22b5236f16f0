#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the twenty-nine hand-written kernel libraries from
     src/repro_torch/kernels/csrc with nvcc for sm_90a, all at once, and
     prints the build time; checks that the twelve tensor-core libraries'
     (flash forward, dK/dV, dQ; the bf16 head_dim-128 flash forward,
     dK/dV and dQ; the float32 3xTF32 flash forward, dK/dV and dQ; LoRA
     matmul; paged prefill; chunkwise mLSTM) SASS holds HGMMA (wgmma)
     instructions and prints their registers, spills and shared memory
     (the head_dim-128 trio must report no spill, no serialized wgmma and
     no ignored setmaxnreg), and the TMA-fed paged decode kernels' (head
     dims 64 and 128) registers and spills;
  3. holds each kernel against its plain PyTorch version on the card and
     times both, and the PyTorch library call where one computes the same
     function: the serving kernels at flad-adllm's serving shapes (8
     lanes, block size 16, chunk 16, contexts up to 300 tokens) and the
     paged ones also at 4096 keys and at ctx 1, each beside the SIMT
     kernel it replaced and a gather + SDPA composition, the batched
     speculative verify (one launch for 8 lanes' draft windows, bf16 on
     the wgmma prefill kernel with P in two bf16 parts, every row within
     a bf16 ulp of the decode kernel's, beside the same kernel with P
     rounded once, in turns; float32 on the SIMT one with every row
     bitwise the decode kernel's, beside its bound; beside the
     reference's per-lane prefill launches and a gather + SDPA
     composition), quantize_int8
     at the codec's shapes (one client's embedding and ffn.wi deltas,
     256000 and 524288 rows, beside the bytes bound; the old 128-row
     serving shape kept as history), the int8
     cache's fused K/V append (bitwise, beside the composition it
     replaced), the flash-attention forward and its three backward
     kernels at the training shape (B 4, Hq 16, Hkv 8, S 1024, D 64) in
     bf16 (the forward, dK/dV and dQ on their tensor-core kernels) and
     float32 (the forward, dK/dV and dQ on their 3xTF32 wgmma kernels,
     timed in turns beside the SIMT kernels they replaced) with ragged,
     offset and windowed cases and the distillation
     path's 1032 rows, and in float32 at the FHDP step's shape
     (non-causal, B 2, Hq = Hkv 12, S 256, D 64, beside float32 SDPA and
     the replaced SIMT kernels, with bounds on the CUDA cores and at
     3xTF32), the
     backward's preprocess on its 16-byte-load kernel row by row at
     every (dtype, D) with ragged and grid-stride row counts, timed in
     turns beside the one-warp-a-row kernel it replaced and torch.bmm
     with a float32 output, dequantize
     on one ffn.wi leaf's rows, and the fused LoRA matmul at the
     distillation path's shapes (M 4128; (K, N) of wq/wo, wk/wv and
     ffn.wo; r 4; forward and the backward's transposed dx; bf16 on the
     wgmma kernel, timed beside the mma.sync kernel it replaced, and
     float32) with ragged and rank-16 cases and its autograd wrapper's
     dx, da and db, and the chunkwise mLSTM at the xLSTM prefill's shape
     (B 8, NH 4, S 512, DH 512, float32) with ragged-S, initial-state,
     bf16 and DH-64 cases
     (the 3xTF32 wgmma kernel timed beside the SIMT kernel it replaced,
     both against the plain version and a float64 run, with both
     kernels' phase splits), and the mLSTM's backward kernel pair at the
     xLSTM training shape (B 4, NH 4, S 512, DH 512, float32, fresh
     state) and at a ragged S with an initial state, against the plain
     backward on the states the forward kernel saved, bitwise over two
     launches, beside the forward with and without its state writes
     (bitwise the same h and final state); paged decode and prefill at
     head_dim 128 (qwen3-14b's 40/8 heads, 4096 keys, bf16 and int8
     pools; checked again at 56/8 and 64/8 heads; a batched verify of 8
     lanes), decode on its TMA-fed kernel and prefill on its wgmma one,
     each timed in turns with its SIMT kernel on the same inputs, beside
     the plain version and the gather + SDPA composition; the decode
     step's fused append-and-decode (one launch of the TMA-fed decode
     kernel that writes the lanes' K/V rows before it reads them) at head
     dims 64 (16/8 heads) and 128 (40/8), 8 lanes to 300 keys and at 4096
     keys, bf16 and int8 pools, pools and output bitwise the stand-alone
     append followed by the decode kernel, timed in turns with that pair
     and with the decode kernel alone; the flash
     forward, preprocess, dK/dV and dQ at head_dim 128 (B 2, Hq 40, Hkv
     8, S 1024: the forward, dK/dV and dQ on their
     head_dim-128 wgmma kernels, timed in turns with the SIMT kernels on
     the same inputs; checked again at 56/8 and 64/8 heads) and at
     Hymba's GQA group of 5 (B 4, Hq 25, Hkv 5, S 512, D 64: the wgmma
     kernels) and at the encoder-decoder's group of 1 (16/16 heads of
     64: the serving prefill's encoder, B 8, S 512, non-causal, the
     forward only; the training's encoder and decoder, B 4, S 512,
     non-causal and causal) beside the plain versions and SDPA with the
     same mask;
  4. serves flad-adllm at full width and depth (bf16, random weights from
     a seed) through the continuous scheduler with chunked prefill, with
     the model-dtype KV cache and with the int8 cache, checking the
     kernels' launch counts (every paged launch on its Hopper route,
     every decode step's layer one fused append-and-decode launch, every
     int8 prefill chunk's append one launch of its own, no
     quantize_int8); serves the
     trace again with its final warm pass traced (repro_torch.obs) into
     chiprun_out/chip_smoke/serve_trace.json: streams bitwise the
     untraced run's, the file valid; profiles a decode step with each
     cache, fused and as it ran before the fold (device operations a
     step both ways); and holds the paged path against the contiguous-cache
     forward (plain attention);
 4b. serves the same trace with speculative decoding (draft_k 4): float32
     params with fp32 and int8 caches, each with a self-draft and a random
     draft, streams gated bitwise equal to plain decode's with exact launch
     counts (every verify one launch a layer and step); bf16 self-drafted,
     reported (acceptance, tokens/s, tokens equal to plain decode) with
     the verify's P split and, in the same call, rounded once and with
     every row through the decode kernel's arithmetic (a probe); where a
     bf16 stream still parts from plain decode, a probe at its first
     differing token compares the verify's row with the decode step
     layer by layer, under both, and names the first operation where
     they part; one
     float32 preemption run whose streams equal the unpressured run's;
  5. trains flad-adllm at full width and depth through the training
     launcher: two hier_fl rounds of 4 clients (2 edge pods), 2 local
     steps each, 4 x 1024 tokens a step, int8 uplinks; checks the exact
     launch counts (the flash forward, dK/dV and dQ all on their
     tensor-core route, the preprocess on its vec kernel), finite
     losses, moved params and the wire
     metrics against
     the topology's formulas;
 5b. runs async_hier_fl (the event-driven engine) on the same model and
     fabric: with no clock, one merge bitwise one hier_fl round from the
     same state, batches and codec bits; with the merge clock at half the
     sync merge's simulated time, compute jitter 0.2 and DTMC pod
     migrations, 4 merges traced into chiprun_out/chip_smoke/
     async_trace.json (a merge of fewer than 4 vehicles, a migration, the
     trace valid, an untraced rerun bitwise the same params and event
     log), exact launches from the engine's waves (every vehicle a wave
     trains: 2 local steps x 16 layers a flash kernel, one quantize and
     one dequantize a leaf); one more merge under profiled(), whose
     exported trace names the flash and codec kernels, with the device's
     busy and idle share;
  6. runs one float32 local train step through the kernels and through
     plain attention and compares the loss, the grads and the updated
     params; profiles one bf16 local step and its flash kernels' share;
  7. runs federated distillation of flad-adllm's AD-LLM view at full
     width and depth through the training launcher: 2 warmup steps of
     the whole model, then two distill_fl rounds of 4 rank-4 LoRA
     students, 2 local steps each, 4 x (1024 + 8 prefix) tokens a step,
     int8 factor uplinks; checks the exact launch counts (the flash
     kernels and the LoRA matmul on their tensor-core routes), finite
     losses, the
     base bitwise unchanged, moved factors and the wire metrics over the
     factor tree;
  8. runs one float32 distill local step through the kernels and through
     the plain versions and compares the loss, the factor grads and the
     updated factors; profiles one bf16 distill local step and its flash
     kernels' share;
 8b. trains flad-vision at full width and depth (12 layers, d_model 768,
     float32, random weights from a seed) by FHDP through the ported
     Session with the reference's defaults: the pipeline strategy on a
     (2, 4) mesh (2 FL columns x 4 stages, all on the card), 16 samples
     a step, lr 1e-3: 8 steps on one batch (the reference's descent
     check), the first loss held to the flat model's, the exact flash
     launches (float32: the forward, dK/dV and dQ on the 3xTF32 route,
     the preprocess on vec);
     the same Session from the reference trajectory's start (the port's
     CPU init, numpy batches), 4 steps on fresh batches and 8 on one,
     each loss against the reference's full-width CPU run; one step
     through the kernels against plain attention (loss, Adam moments,
     params); profiles a step; one fl_pipeline round of 2 local steps
     whose merged params have the flat model's shapes; reports whether
     the 8 steps on one batch descended (at this lr the reference's
     loss rises there too);
 8c. trains flad-vision at full width by SWIFT-scheduled FHDP with a live
     template switch: the swift_pipeline strategy over a five-vehicle
     fleet (template (4, 4, 3, 1)), from the reference trajectory's
     start, 4 steps with vehicle 0 departing after step index 1
     (template (4, 3, 3, 2): merged, restaged, the step rebuilt, Adam's
     moments restarted), an edge backup and a checkpoint every 2 steps;
     checks the templates, the restage bitwise, the shrunken fleet, the
     exact flash launches by route, each loss against the reference's
     full-width CPU run of the same departure, the checkpoint (sidecar,
     params bitwise) and the latest backup restaged under the balanced
     template; reports the switch's, the backups' and the checkpoint's
     times and the step before and after; trains a DQN policy on the
     card (20 episodes) and runs SWIFT with it;
  9. serves xlstm-350m at full width and depth (bf16, random weights from
     a seed) through the serving launcher's legacy static-batch scheduler
     (Session.serve): 3 request batches of 8 x 512-token prompts and 32
     decode steps; checks the exact mLSTM kernel launch count (21 a
     prefill, all on the wgmma route), finite logits and token ids;
     profiles a prefill and a
     decode step; holds a float32 prefill plus decode steps through the
     kernel against the same through the plain version;
 9b. trains xlstm-350m at full width and depth (24 layers, d_model 1024,
     DH 512, vocab 50304, bf16, random weights from a seed) through the
     training launcher: two hier_fl rounds over 2 vehicles (2@nano,agx),
     2 local steps of 4 x 512 tokens, int8 uplinks; checks the exact
     launch counts (the mLSTM forward on the wgmma route twice a layer and
     step, the checkpoint's recompute included, the backward once, one
     quantize and one dequantize a leaf, vehicle and round), finite
     losses, moved params, the wire metrics against the topology's
     formulas, peak memory; holds one float32 local step through the
     kernels against the plain chunkwise mLSTM with autograd (loss,
     grads, updated params, the flad-adllm step's limits); profiles a
     warm bf16 local step;
 9c. serves qwen3-14b at full width and depth (40 layers, 14.77 B bf16
     params from a seed) through the continuous scheduler over the
     serving phase's trace with both caches, and qwen2.5-32b, qwen3-32b
     and yi-34b at full width cut to 4 layers (32.8-34.4 B params do not
     fit beside a KV pool) over the model-dtype cache, each held to the
     contiguous oracle, every decode step's layer one fused
     append-and-decode launch on its TMA-fed route (tma128) and every
     prefill launch on wgmma128 (head_dim 128), each launch of the
     cold pass held to its plain version on the same inputs, the warm
     pass's tokens/s beside the SIMT decode kernel's earlier reading;
     trains qwen3-14b cut to 2 layers by the tensor strategy (a
     batch's loss through the flash kernels held to plain attention, then
     the steps: the forward, dK/dV and dQ on wgmma128); serves
     Hymba-1.5b at full
     width and depth with the legacy scheduler (no kernel), holds a
     loss through the flash kernels to plain attention, trains it by
     the tensor strategy (every flash launch on wgmma at Hq 25 / Hkv 5)
     and profiles a step (the Mamba scan's share); runs xlstm-350m's
     FHDP step at full width (the pipeline strategy on a (2, 4) mesh,
     each stage's units in the flat model's order; 8 sequences of 256
     tokens, cut from 512 for the script's time limit), its first loss
     held to the flat Model.loss, every mLSTM launch on wgmma; serves
     seamless-m4t-large-v2 at full width and depth (12 + 12 layers,
     16/16 heads of 64, vocab 256206, 1.28 B bf16 params from a seed)
     with the legacy scheduler (2 batches of 8 requests of 512 frames
     and 512 prompt tokens, 32 decode steps: each prefill's encoder 12
     flash launches on wgmma, non-causal, nothing else), holds a
     4 x (512 + 512) batch's loss through the flash kernels to plain
     attention, trains it by the tensor strategy (3 steps, exact flash
     launches on wgmma) and profiles a step, and runs its FHDP step on a
     (2, 4) mesh (24 units over 4 stages; 8 sequences of 128 frames and
     128 tokens), its first loss held to the flat Model.loss;
 10. prints one JSON line describing every ported kernel (with the new
     shapes' times and launches as its head_dim_128, hymba_group_5 and
     encdec_g1_* entries, the head_dim-128 forward, dK/dV, dQ and decode kernels
     as lines of their own, and the decode step's fused append-and-decode
     as a line of its own; the decode lines count their kernels' launches
     through both wrappers), the card's name and power limit, and {"ok": true,
     "device": {...}} last.

With --paged it stops after the build and the paged kernels' checks
(step 3's first part), with --decode-append after the build and the
fused append-and-decode's checks, with --mlstm after the build, the
mLSTM kernels' and the fused int8 append's checks, with --spec after
the build, the
verify's and the preprocess's checks, the serving path, its traced pass
and step 4b,
with --vision after the build, the flash kernels at the FHDP shape and
step 8b, with --swift after the build and step 8c, with --async after
the build and step 5b, with --xlstm-train after the build, the mLSTM
backward's checks and step 9b, with --dense after the build, the
head_dim-128 kernels' checks and the dense part of step 9c, with
--flash128 after the build, the head_dim-128 flash kernels' checks (at
40/8, 56/8 and 64/8 heads, timed at 40/8) and the dense training phase,
with --hymba
after the build, the group-5 flash checks and the Hymba part, with
--encdec after the build, the group-1 flash checks and the
encoder-decoder part, with
--xlstm-fhdp after the build and the FHDP part at 512 tokens with a
profiled step (minutes: its trace holds about 2.9 million kernels);
none prints a result line. The trace files go to
chiprun_out/chip_smoke/ under the checkout.

Any failed check raises, so the script exits non-zero and prints no
result line. It also exits non-zero when torch sees no CUDA device, and
when run without the repository's src/ beside it. It never imports JAX
or the JAX package.
"""
import ctypes
import json
import math
import re
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
# paged attention, kernel vs the float32 plain version: a kernel computes
# in float32 and rounds its output to bf16 once (half a bf16 ulp: 2^-8 of
# a row's largest |value| at most); prefill's wgmma route also rounds P
# (with int8 V's scale folded in) to bf16. Each output row (D values) is
# held to this share of its own largest |plain value| plus 1e-5, and the
# whole output to ATOL_BF16 as an outer bound.
PAGED_RTOL = {"decode": 2.0 ** -8, "prefill": 2.0 ** -7}
PAGED_ROW_ATOL = 1e-5
# logits of the whole 16-layer path, paged (kernels) vs contiguous (plain
# attention), teacher-forced: float32 differs only in summation order;
# bf16 also rounds the attention output at different points
ORACLE_ATOL_F32 = 1e-4
ORACLE_ATOL_BF16 = 0.25
TRACE = dict(fleet="nano*2,agx*2", num_requests=12, max_prompt=96, seed=0)
LIBRARY_NOTE = ("no single PyTorch call computes paged attention through "
                "a block table or this stochastic int8 quantizer")
# paged attention at 4096 keys (a flad-adllm context the paged engine
# takes: the config sets no position limit): decode lanes all at 4096 for
# timing, and a ragged list for correctness with ctx 0, 1, 16, 4095, 4096
# and lanes ending on and just past a split boundary (long_decode_ctx);
# prefill a 16-row chunk ending at 4096 and a partial one
LONG_CTX = 4096
LONG_PREFILL_CHUNKS = [(4080, 16), (4088, 5)]
COMPOSITION_NOTE = ("composition_ms: gather K/V through the table into "
                    "contiguous [B, Hkv, T*bs, D] (dequantized for int8), "
                    "then one scaled_dot_product_attention with the mask "
                    "and enable_gqa: no one call")
# the training slice: flash attention at the local step's shape
B, HQ, HKV, S, D = 4, 16, 8, 1024, 64
FLASH_CASES = [("causal", S, S, {}), ("ragged", 1000, 1000, {}),
               ("offset", 768, S, {"q_offset": 256}),
               ("window", S, S, {"window": 256}),
               ("distill", S + 8, S + 8, {})]   # 8 prefix feature tokens
# kernel vs plain: float32 differs only in summation order; bf16 outputs
# are each one bf16 rounding of a float32 value, so two of them may be a
# bf16 ulp apart at the largest magnitude (2^-7 of it)
FLASH_ATOL_F32 = 1e-5          # o, lse, delta
FLASH_GRAD_ATOL_F32 = 2e-5     # dq, dk, dv (sums over up to 2048 rows)
BF16_ULP = 2.0 ** -7
# the wrappers with a tensor-core (wgmma) route beside another: the flash
# kernels' SIMT route (float32, head_dims 32 and 128) and the LoRA
# matmul's mma.sync / float32 kernel: (tensor-core library, its
# shared-memory query and argument, profiler names of the tensor-core and
# the other route's kernel)
TC_KERNELS = {
    "flash_attention": ("flash_fwd_tc", "flash_attention_fwd_tc_smem", (2,),
                        "flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_tc",
                                "flash_attention_bwd_dkv_tc_smem", (),
                                "flash_bwd_dkv_wgmma_kernel",
                                "flash_bwd_dkv_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_tc",
                               "flash_attention_bwd_dq_tc_smem", (2,),
                               "flash_bwd_dq_wgmma_kernel",
                               "flash_bwd_dq_kernel"),
    "lora_matmul": ("lora_matmul_tc", "lora_matmul_tc_smem", (8,),
                    "lora_wgmma_kernel", "lora_mma_kernel"),
}
# the flash wrappers' float32 route at head_dim 64 (route tf32x3: 3xTF32
# wgmma, every float32 path's forward, dK/dV and dQ): (library, its
# shared-memory query, profiler name); TC_KERNELS' last names are the
# SIMT kernels the other float32 launches (head_dims 32 and 128) take
TF32_KERNELS = {
    "flash_attention": ("flash_fwd_tf32", "flash_attention_fwd_tf32_smem",
                        "flash_fwd_tf32_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_tf32",
                                "flash_attention_bwd_dkv_tf32_smem",
                                "flash_bwd_dkv_tf32_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_tf32",
                               "flash_attention_bwd_dq_tf32_smem",
                               "flash_bwd_dq_tf32_kernel"),
}
# the flash kernels' bf16 route at head_dim 128 (route wgmma128): (library,
# its shared-memory query, profiler name)
D128_KERNELS = {
    "flash_attention": ("flash_fwd_tc128", "flash_attention_fwd_tc128_smem",
                        "flash_fwd_d128_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_tc128",
                                "flash_attention_bwd_dkv_tc128_smem",
                                "flash_bwd_dkv_d128_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_tc128",
                               "flash_attention_bwd_dq_tc128_smem",
                               "flash_bwd_dq_d128_kernel"),
}
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor-core peak
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3   # three tf32 passes a product
# the paged wrappers' Hopper libraries: (stem, profiler name, runs wgmma)
PAGED_LIBS = {"paged_decode_attention": ("paged_decode_tma",
                                         "paged_decode_tma_kernel", False),
              "paged_prefill_attention": ("paged_prefill_tc",
                                          "paged_prefill_wgmma_kernel",
                                          True)}
# the paged wrappers' head_dim-128 Hopper kernels (decode's on the CUDA
# cores, route tma128; prefill's on wgmma, route wgmma128): (stem,
# profiler name, its route)
PAGED128_LIBS = {"paged_decode_attention": ("paged_decode_tma128",
                                            "paged_decode_tma128_kernel",
                                            "tma128"),
                 "paged_prefill_attention": ("paged_prefill_tc128",
                                             "paged_prefill_tc128_kernel",
                                             "wgmma128")}
# the decode step's layer in one call: the TMA-fed decode kernels' fused
# entry point appends the lanes' K/V rows and attends over them (the same
# kernels as PAGED_LIBS' and PAGED128_LIBS' decode)
FUSED = "paged_decode_append_attention"
# the paged wrappers a serving run launches through: decode's stand-alone
# wrapper (the float32 route), the fused one (the bf16 main paths),
# prefill's
SERVE_PAGED = ("paged_decode_attention", FUSED, "paged_prefill_attention")
# the SIMT paged kernels' profiler names
PAGED_SIMT_NAMES = {"paged_decode_attention": "paged_decode_kernel",
                    "paged_prefill_attention": "paged_prefill_kernel"}
FLASH_NAMES = {"flash_attention": "flash_fwd",
               "flash_attention_bwd_preprocess": "flash_bwd_preprocess",
               "flash_attention_bwd_dkv": "flash_bwd_dkv",
               "flash_attention_bwd_dq": "flash_bwd_dq"}
TOPOLOGY, ROUNDS, CLIENTS, LOCAL_STEPS = "2@nano*2,agx*2", 2, 4, 2
TRAIN_ARGV = ["--arch", "flad-adllm", "--full", "--strategy", "hier_fl",
              "--topology", TOPOLOGY, "--codec", "int8", "--local-steps",
              str(LOCAL_STEPS), "--steps", str(ROUNDS), "--shape",
              f"{S}x{B}", "--device", "cuda"]
NANO_BPS, AGX_BPS = 0.125e9, 0.25e9        # sched/costmodel.py presets
BACKHAUL_BPS, BACKHAUL_S = 1.25e9, 0.01    # comm/topology.py defaults
# float32 local step, kernels vs plain attention: the loss and the grads
# differ only in summation order; Adam's first step lr * g / (|g| + eps)
# turns that into a visible difference where a grad is nonzero and below
# 10 * eps (a sign can flip there), so those near-eps params are counted
# and held only to 2 * lr, the most two such steps can differ by; all
# others to 1e-5
STEP_LOSS_ATOL = 1e-4
STEP_GRAD_RTOL = 1e-4          # of each leaf's largest grad
STEP_PARAM_ATOL = 1e-5
NEAR_EPS = 1e-7
# the distillation slice: flad-adllm's AD-LLM view (8 prefix feature
# tokens of width 32, 6 waypoints), rank-4 LoRA on attn.{wq,wk,wv,wo} and
# ffn.wo, 2 warmup steps of the whole model before it freezes
PREFIX, FEATURES, WAYPOINTS, RANK, WARMUP = 8, 32, 6, 4, 2
LORA_M = B * (S + PREFIX)      # rows of an adapted projection's input
LORA_SHAPES = [("wq/attn.wo", 1024, 1024), ("wk/wv", 1024, 512),
               ("ffn.wo", 4096, 1024)]
LORA_RTOL_F32 = 1e-5           # of the output's largest magnitude
DISTILL_ARGV = ["--arch", "flad-adllm", "--full", "--strategy", "distill_fl",
                "--topology", TOPOLOGY, "--codec", "int8", "--local-steps",
                str(LOCAL_STEPS), "--steps", str(ROUNDS), "--shape",
                f"{S}x{B}", "--lora-rank", str(RANK), "--distill-warmup",
                str(WARMUP), "--device", "cuda"]
FACTOR_LEAVES = 10             # A and B of attn.{wk,wo,wq,wv} and ffn.wo
DISTILL_LOSS_ATOL = 1e-5
L2_FLUSH_BYTES = 256 * 2 ** 20  # five times the H100's 50 MB L2
# the xLSTM serving slice: xlstm-350m through the legacy scheduler
XB, XCTX, XDECODE, XREQ = 8, 512, 32, 3
XLSTM_ARGV = ["--arch", "xlstm-350m", "--full", "--scheduler", "legacy",
              "--batch", str(XB), "--context", str(XCTX), "--decode-steps",
              str(XDECODE), "--requests", str(XREQ), "--device", "cuda"]
MLSTM_CHUNK = 64               # the kernel's chunk (mlstm_chunked.cu kC)
# mLSTM kernel vs its plain version at chunk 64: float32 h within 5e-5 of
# its largest magnitude (den = |n.q| can cancel and magnify the order of
# the sums), C, n and m within 1e-5; bf16 h one bf16 ulp of the largest
MLSTM_H_RTOL_F32, MLSTM_STATE_RTOL = 5e-5, 1e-5
# float32 prefill + decode, kernel vs plain version (the path's chunk,
# 256): logits within 1e-4 of the largest magnitude
XLSTM_LOGIT_RTOL = 1e-4
XLSTM_F32_STEPS = 4
# the xLSTM training slice: xlstm-350m by hier_fl over 2 vehicles (flad-
# adllm's 317 M params peak at 55.6-55.9 GiB over 4; xlstm-350m's 519 M
# over 4 would need about 91 GiB), one per edge pod, 2 local steps of
# 4 x 512 tokens, int8 uplinks, bf16 with random weights from a seed
XT_TOPOLOGY, XT_CLIENTS, XT_B, XT_S = "2@nano,agx", 2, 4, 512
XT_ARGV = ["--arch", "xlstm-350m", "--full", "--strategy", "hier_fl",
           "--topology", XT_TOPOLOGY, "--codec", "int8", "--local-steps",
           str(LOCAL_STEPS), "--steps", str(ROUNDS), "--shape",
           f"{XT_S}x{XT_B}", "--device", "cuda"]
# the mLSTM backward kernel against the plain backward on the same saved
# states: each gradient within 1e-4 of its largest magnitude (float32 in
# both, other summation orders; den = max(|n.q|, e^-m) divides and can
# magnify them)
MLSTM_BWD_RTOL = 1e-4
MLSTM_BWD_NAME = "mlstm_bwd"      # every kernel of both routes
# the wgmma route's phase clocks (csrc/mlstm_chunked_bwd_tc.cu lists them)
MLSTM_BWD_PHASES = {
    "sweep": ("dn' store, loads issued", "gates", "A split",
              "dC' stores, B split", "B barrier", "fetch, product issue",
              "product wait, barrier", "dn"),
    "chunk": ("gates", "X, Y, Z hand-over", "B split", "barrier",
              "A split, fetch, product issue", "previous product wait",
              "exchange", "P and dS", "dS k, dS^T q, P^T dnum",
              "gate sums")}
MLSTM_BWD_LIBRARY_NOTE = ("no PyTorch call computes the chunkwise mLSTM's "
                          "backward; the reference leaves it to XLA's "
                          "autodiff")
# the flash backward's preprocess, delta = rowsum(dO * O) in float32: its
# vec kernel (csrc/flash_bwd_preprocess_vec.cu) on every path launch, the
# one-warp-a-row kernel it replaced timed beside it in turns
PRE = "flash_attention_bwd_preprocess"
PRE_NAMES = {"vec": "preprocess_vec_kernel",
             "simt": "flash_bwd_preprocess_kernel"}
# delta's row bound. A product reaches the vec kernel's row sum through at
# most 12 roundings (16 / esz FMAs, then log2(D * esz / 16) shuffle adds;
# D <= 128); the plain version on the card (the products, then torch's sum
# of a contiguous float32 row) through at most D / 4 + 4. Each rounding
# errs by at most 2^-24 of a partial sum, and a partial is at most sum_d
# |O dO|, so each side is within depth * 2^-24 * sum_d |O dO| of the exact
# sum (to first order), both depths are at most D / 2 for D >= 32, and D *
# 2^-24 * sum_d |O dO| bounds their difference; 1e-30 lets an all-zero row
# through. Against a float64 run the kernel alone is held to 13 * 2^-24
# (12 roundings, with room for the second-order terms). A dropped 16-byte
# slice of a row moves it by about 8 / D of sum_d |O dO|, far past either
# bound (tests/test_torch_preprocess.py); the single bound flash_checks
# holds delta to stays as the outer one.
PRE_ROW_ULPS_F64 = 13
PRE_ROW_ATOL = 1e-30
# preprocess cases, (label, dtype, B, Hq, Sq, D), all held row by row and
# bitwise repeatable: the timed shapes (the training shape in bf16 and
# float32, the distillation path's 1032 rows, bf16 at D 32 and 128);
# ragged row counts (999 and 3) in both dtypes at every D; and two that
# outgrow one pass of the resident CTAs, so the grid stride runs
PRE_TIMED = [("train", "bfloat16", B, HQ, S, D),
             ("distill", "bfloat16", B, HQ, S + 8, D),
             ("f32", "float32", B, HQ, S, D),
             ("d32", "bfloat16", B, HQ, S, 32),
             ("d128", "bfloat16", B, HQ, S, 128)]
PRE_RAGGED = [(f"ragged {dt} D{d} {3 * sq} rows", dt, 1, 3, sq, d)
              for dt in ("bfloat16", "float32") for d in (32, 64, 128)
              for sq in (333, 1)] + [
    ("stride bfloat16 D64", "bfloat16", 4, 16, 2200, 64),
    ("stride float32 D128", "float32", 2, 16, 2000, 128)]
PREPROCESS_LIBRARY_NOTE = (
    "torch.bmm(o [rows, 1, D], dO [rows, D, 1], out_dtype=float32): one "
    "call, bf16 products summed in float32")
# the speculative phase: draft_k drafts a lane a step (the launcher's
# default), so a verify window is 5 rows; the verify kernel alone at the
# serving shape: 8 lanes (a dead one, partial windows, a window across a
# block boundary, one near ctx 300)
SPEC_K = 4
VERIFY_CTX = [0, 1, 16, 47, 100, 203, 256, 290]
VERIFY_WIN = [0, 5, 5, 5, 3, 5, 1, 5]
# the verify's float32 rows vs the float32 plain version: 1e-5 of each
# row's largest |value| (both sides float32, in different orders)
VERIFY_RTOL_F32 = 1e-5
# step 5b, async_hier_fl: merges, the compute jitter, and the mobility
# grid of the reference's busiest engine test (5 x 5 cells, radius 1),
# whose first seed moves a vehicle between pods within 4 merges here
ASYNC_MERGES = 4
ASYNC_JITTER = 0.2
ASYNC_MOBILITY = dict(size=5, radius=1, seed=0)
# where the phases write their trace files (inside the checkout, ignored)
OUT = ROOT / "chiprun_out" / "chip_smoke"
# the verify's bf16 rows vs the paged decode kernel's rows at the same
# positions: both keep P to float32 precision (the verify as two bf16
# parts), so they differ by the order of their sums and P's split only.
# The gate: every element within one bf16 ulp plus the two kernels'
# worst-case float32 gap (ref.verify_decode_gap_bound, derived from their
# accumulation orders). The elements more than VERIFY_ULPS apart, the
# largest ulp distance and the bitwise shares are reported beside it;
# with P split fewer elements must lie past one ulp than with P rounded
# once (the kernel before the split)
VERIFY_ULPS = 1
SPEC_LIBRARY_NOTE = ("no single PyTorch call attends every lane's draft "
                     "window through its block table")
# tf32 passes of the wgmma mLSTM's products: 3xTF32 for float32 inputs;
# bf16 inputs are exact in tf32, so their products need two (S one)
MLSTM_TC_PASSES = {"float32": 3, "bfloat16": 2}
MLSTM_NAMES = {"wgmma": "mlstm_tc_kernel", "simt": "mlstm_chunked_kernel"}
# phase clocks of the two mLSTM kernels (their sources list them)
MLSTM_PHASES = {"simt": ("loads", "scans", "S and C q", "P", "P v and h",
                         "update"),
                "wgmma": ("gates", "A1 start", "A1 operands, q.n, n",
                          "A1 S", "A2 start", "A2 split", "A2 barrier",
                          "A2 end", "S exchange, P", "P v, h", "B start",
                          "B split", "B barrier", "B product issue",
                          "A2 product issue", "A2 copy issue",
                          "B copy issue", "B end")}
APPEND_LIBRARY_NOTE = ("no single PyTorch call quantizes rows and "
                       "scatters codes and scales into paged pools")
MLSTM_LIBRARY_NOTE = ("no single PyTorch call computes the stabilized "
                      "chunkwise mLSTM recurrence")


# the FHDP slice: flad-vision (12 layers, d_model 768, 12 heads of 64,
# d_ff 3072, float32) through the pipeline strategy on a (2, 4) mesh (2 FL
# columns x 4 stages, every rank on the one card) with the reference
# Session's defaults: 16 sequences (2 a rank), microbatches of 2, 4 a
# column, and its learning rate, 1e-3
VISION_SESSION = dict(arch="flad-vision", full=True, strategy="pipeline",
                      mesh="2,4")
VISION_GEOMETRY = (4, 2, 2)      # (microbatches, mb, FL columns)
# the reference's descent check (8 steps on one batch); a round's local
# steps
VISION_STEPS, VISION_LOCAL = 8, 2
# The reference's FHDP step at full width on the CPU (8 forced host
# devices), from the port's init with seed 0 (torch's CPU generator)
# bridged to it, on numpy batches (``numpy_batches`` below) at lr 1e-3:
# ``PYTHONPATH=src python tests/test_torch_trajectory.py --full``, where
# the port's CPU step keeps within 6.9e-6 of these on fresh batches and,
# on one batch, 3.1e-6 over the first two steps (later steps there
# amplify rounding: 8.1e-5 at the third, 1.1e-2 at the seventh).
VISION_REF_SEEDS = {"fresh": 31, "one_batch": 32}
VISION_REF_LOSSES = {
    "fresh": (2.279392, 10.733290, 9.164496, 10.903973),
    "one_batch": (2.150192, 2.277108, 13.599813, 15.682858, 15.804132,
                  19.989166, 9.017068, 8.842516)}
VISION_REF_GATED = {"fresh": 4, "one_batch": 2}  # steps held to the rtol
VISION_REF_RTOL = 1e-4
VMB, VH, VS = 2, 12, 256         # an attention call: B = mb, Hq = Hkv, S
VISION_LOSS_RTOL = 1e-5          # pipelined vs flat model, float32
# one FHDP step through the kernels vs plain attention (float32, summation
# order only): moments within rtol 1e-5 plus 1e-5 of the leaf's largest
# |value|; params within 1e-5 except the near-eps ones (Adam's sqrt(v_hat)
# below 100 eps: the step's gradient scale, pod x data^2 x model = 16
# here, lifts rounding residues to there), held to 2 * lr
VISION_MOMENT_RTOL = 1e-5
VISION_NEAR_EPS = 1e-6
VISION_PARAM_ATOL = 1e-5
# the FHDP step's float32 flash launches: each wrapper's route and its
# kernel's profiler name (the forward, dK/dV and dQ on 3xTF32 wgmma, the
# preprocess on its vec kernel)
VISION_ROUTES = {"flash_attention": "tf32x3",
                 "flash_attention_bwd_dkv": "tf32x3",
                 "flash_attention_bwd_dq": "tf32x3", PRE: "vec"}
VISION_NAMES = {**{fn: t[2] for fn, t in TF32_KERNELS.items()},
                PRE: PRE_NAMES["vec"]}
# The swift phase: flad-vision at full width under the swift_pipeline
# strategy (SWIFT's templates, pre-generated departure templates) on the
# (2, 4) mesh, at the Session's lr and 16 samples, over a fleet of five
# vehicles (Jetson Nano compute and link) whose memories, in units of one
# flad-vision unit's training footprint at seq_len 512 (94387200 B, the
# strategy's default), force SWIFT to span four of them: template (4, 4,
# 3, 1) headed by vehicle 0, and after vehicle 0 departs (4, 3, 3, 2).
# The launcher's default fleet, nano*4,agx*2, fits the whole model on one
# vehicle, so a departure there never changes the template.
SWIFT_SESSION = dict(VISION_SESSION, strategy="swift_pipeline", seq_len=512)
SWIFT_FLEET = dict(cmp=0.472e12, com=0.125e9, mem=(4.5, 4.5, 3.5, 3.5, 3.5),
                   stb=(0.9, 0.8, 0.7, 0.6, 0.5))
SWIFT_STEPS, SWIFT_DEPART = 4, {1: 0}    # vehicle 0 leaves after step 1
SWIFT_TEMPLATES = ((4, 4, 3, 1), (4, 3, 3, 2))
SWIFT_BACKUP_EVERY, SWIFT_CKPT_EVERY = 2, 2
SWIFT_DQN_EPISODES = 20
# Both packages' swift_pipeline Session at full width on the CPU, from
# the port's init with seed 0 (torch's CPU generator) bridged to the
# reference, on numpy batches from seed 31 (numpy_vision_batches), each
# with a Repartitioner departing SWIFT_DEPART:
# ``PYTHONPATH=src python tests/test_torch_trajectory.py --full --swift``
# gives the reference's losses below, and the port's CPU run within
# 1.0e-7, 3.6e-6, 4.1e-6 and 3.4e-5 of them, so all four steps are held
# to VISION_REF_RTOL. The first three equal the "fresh" trajectory's (the
# template changes no arithmetic); the fourth is the first step on the
# restarted moments, whose bias correction continues from step 3.
SWIFT_REF_SEED = 31
SWIFT_REF_LOSSES = (2.279392, 10.733290, 9.164496, 14.160181)
SWIFT_REF_GATED = 4               # steps held to VISION_REF_RTOL


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


_FLUSH = {}


def flush_l2():
    """Overwrite a float64 buffer five times the size of the L2, so that
    the next call reads its inputs from HBM as the main path does (it
    calls each kernel once on freshly written tensors)."""
    import torch
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.float64,
                                    device="cuda")
    _FLUSH["buf"].fill_(1.0)


def _device_totals(prof, counts=False):
    """{kernel name: summed device time in us} of a profile, or with
    ``counts`` {kernel name: recorded launches}."""
    out = {}
    for evt in prof.key_averages():
        t = (getattr(evt, "device_time_total", 0)
             or getattr(evt, "cuda_time_total", 0))
        if t > 0:
            out[evt.key] = evt.count if counts else t
    return out


def _flush_keys():
    """Names of the device kernels that flush_l2 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if "keys" not in _FLUSH:
        flush_l2()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_l2()
            torch.cuda.synchronize()
        _FLUSH["keys"] = set(_device_totals(prof))
    return _FLUSH["keys"]


def device_ms(fn, match=None, iters=50):
    """Mean device time per call of ``fn`` with a cold L2, from
    torch.profiler's CUDA trace: each call follows flush_l2, whose kernel
    is left out of the sum. Sums the durations of the kernels whose name
    contains ``match`` (every kernel when None), divided by ``iters``.
    When the profiler recorded no device time (it sometimes records
    nothing), CUDA events over back-to-back calls (warm L2) instead, with
    a note. When the trace holds fewer than ``iters`` launches of the
    ``match`` kernel (it can drop records), the mean over those it holds,
    with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    skip = _flush_keys()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    total = sum(t for key, t in _device_totals(prof).items()
                if key not in skip and (match is None or match in key))
    if total > 0 and match is not None:
        n = sum(c for key, c in _device_totals(prof, counts=True).items()
                if key not in skip and match in key)
        if n < iters:
            print(f"[timing] the profiler recorded {n} of {iters} launches "
                  f"of {match}; the mean over those")
            return total / n / 1e3
    if total > 0:
        return total / iters / 1e3
    print(f"[timing] the profiler recorded no device time for "
          f"{match or 'a call'}; CUDA events (warm L2) instead")
    return time_ms(fn, iters=iters, warmup=2)


def timings(kernel_fn, plain_fn, match):
    """(kernel device ms, plain device ms, kernel ms per call on the host
    clock incl. the wrapper) — device times from :func:`device_ms`."""
    call = time_ms(kernel_fn)
    return (device_ms(kernel_fn, match), device_ms(plain_fn, None, iters=20),
            call)


def in_turns(new_fn, old_fn, new_match, old_match):
    """(new ms, old ms): two kernels on the same inputs timed by device_ms
    (cold L2) in turns, new, old, old, new, each the mean of its two
    runs, so that a drift of the card's clock during the four falls on
    both alike."""
    new = device_ms(new_fn, new_match)
    old = device_ms(old_fn, old_match)
    old = (old + device_ms(old_fn, old_match)) / 2
    new = (new + device_ms(new_fn, new_match)) / 2
    return new, old


def bound(nbytes, flops, flops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def check_routes(ops, counts, path, fns=TC_KERNELS):
    """Every launch of the routed wrappers ``fns`` (the flash forward,
    dK/dV and dQ and the LoRA matmul; on the serving path the paged
    pair) on a bf16 main path went through its Hopper kernel, none
    through "simt"; returns the route counts."""
    routes = ops.route_counts()
    fast = {fn.__name__: key for fn, key in ops.ROUTED.items()}
    for fn in fns:
        want = dict.fromkeys(routes[fn], 0)
        want[fast[fn]] = counts[fn]
        check(routes[fn] == want, f"{path}: {fn} launches by route "
              f"{routes[fn]} != {want}")
    return routes


def per_launch(rows, kernels):
    """Each tensor-core flash kernel's device ms a launch in profile rows
    (ms a step, launches a step, name), beside its ``flash_checks`` time
    (cold L2, one launch at a time) from ``kernels``' JSON rows."""
    out = {}
    for fn in FLASH_NAMES:
        if fn not in TC_KERNELS:
            continue
        name = TC_KERNELS[fn][3]
        hits = [r for r in rows if name in r[2]]
        n = sum(r[1] for r in hits)
        if n:
            out[name] = (sum(r[0] for r in hits) / n, n,
                         kernels[fn]["ms"] if kernels else None)
    print("[profile]   tensor-core flash kernels a launch in the step vs "
          "alone (flash_checks): " + ", ".join(
              f"{k} {ms:.5f} ms x {n} vs {alone:.5f} ms"
              if alone else f"{k} {ms:.5f} ms x {n}"
              for k, (ms, n, alone) in out.items()))
    return out


def flash_kernel(fn, route):
    """The profiler name of flash wrapper ``fn``'s kernel on ``route``."""
    if route == "wgmma128":
        return D128_KERNELS[fn][2]
    if route == "tf32x3":
        return TF32_KERNELS[fn][2]
    return TC_KERNELS[fn][3 if route == "wgmma" else 4]


def flash_split(rows):
    """(total ms, {kernel: ms}) of the flash kernels in profile rows
    (ms, count, name), by profiler name."""
    names = [TC_KERNELS[n][3] for n in FLASH_NAMES if n in TC_KERNELS] + [
        f"{stem}_kernel" for stem in FLASH_NAMES.values()] + [
        t[2] for t in TF32_KERNELS.values()] + [
        t[2] for t in D128_KERNELS.values()] + [PRE_NAMES["vec"]]
    split = {n: sum(r[0] for r in rows if n in r[2]) for n in names}
    split = {n: t for n, t in split.items() if t > 0}
    return sum(split.values()), split


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


def _decode_composition(torch, q, k, v, ks, vs, tables, ctx, scale):
    """The yardstick of paged decode (no one PyTorch call computes it):
    gather each lane's K/V through its table into contiguous
    [B, Hkv, T*bs, D] (dequantized for int8 pools), then one
    scaled_dot_product_attention with the ctx mask and enable_gqa."""
    F = torch.nn.functional
    hkv, _, bs, d = k.shape
    b, t = tables.shape
    idx = tables.long()

    def gather(pool, sc):
        x = pool[:, idx]                                # [Hkv, B, T, bs, D]
        if sc is not None:
            x = (x.float() * sc[:, idx]).to(q.dtype)
        return x.transpose(0, 1).reshape(b, hkv, t * bs, d)

    mask = (torch.arange(t * bs, device=q.device)[None] < ctx[:, None])
    return F.scaled_dot_product_attention(
        q[:, :, None], gather(k, ks), gather(v, vs),
        attn_mask=mask[:, None, None], scale=scale, enable_gqa=True)


def _prefill_composition(torch, q, k, v, ks, vs, table, q_offset, ctx_len,
                         scale):
    """The yardstick of paged prefill: the chunk's lane gathered as in
    _decode_composition, then one SDPA with the causal mask from absolute
    positions and enable_gqa."""
    F = torch.nn.functional
    hkv, _, bs, d = k.shape
    t, c = table.shape[0], q.shape[1]
    idx = table.long()

    def gather(pool, sc):
        x = pool[:, idx]                                # [Hkv, T, bs, D]
        if sc is not None:
            x = (x.float() * sc[:, idx]).to(q.dtype)
        return x.reshape(1, hkv, t * bs, d)

    kp = torch.arange(t * bs, device=q.device)
    qp = q_offset + torch.arange(c, device=q.device)
    mask = (kp[None] <= qp[:, None]) & (kp[None] < ctx_len)
    return F.scaled_dot_product_attention(
        q[None], gather(k, ks), gather(v, vs), attn_mask=mask, scale=scale,
        enable_gqa=True)


def _decode_work(cfg, ctx_list, esz, b):
    """(bytes, flops) of one decode call: q read and o written once (bf16),
    each live K/V row read once (and its scale for int8), the tables and
    ctx_lens once."""
    rows = sum(ctx_list)
    nbytes = (2 * b * cfg.num_heads * cfg.hd * 2
              + 2 * rows * cfg.num_kv_heads * (cfg.hd * esz
                                               + (4 if esz == 1 else 0)))
    return nbytes, 4 * rows * cfg.num_heads * cfg.hd


def _paged_run(torch, label, new_fn, old_fn, want_fn, rtol, want_route,
               ops, wrapper, zero_rows=None, rows=None):
    """One paged case: the Hopper kernel (through the wrapper) and the
    SIMT kernel it replaced, each held against the float32 plain version
    ``want_fn`` (over ``rows`` of the output when given): every row
    within ``rtol`` of its largest |plain value| + PAGED_ROW_ATOL, all
    within ATOL_BF16; finite, exact zeros in ``zero_rows``, the wrapper's
    launch on ``want_route`` and two calls bitwise equal. Returns (max
    error of the new kernel, of the old one) and (the largest share of
    its row's bound an error takes, new and old)."""
    before = ops.route_counts()[wrapper]
    got = new_fn()
    again = new_fn()
    grew = {r: n - before[r] for r, n in ops.route_counts()[wrapper].items()}
    check(grew == {**dict.fromkeys(grew, 0), want_route: 2},
          f"{label}: launches by route {grew}, want two on {want_route}")
    old = old_fn()
    want = want_fn()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: two calls differ")
    sel = (lambda x: x) if rows is None else rows
    want = sel(want).float()
    tol = rtol * want.abs().amax(-1, keepdim=True) + PAGED_ROW_ATOL
    errs, uses = [], []
    for kind, out in (("new", got), ("old", old)):
        check(bool(torch.isfinite(out).all()), f"{label} ({kind}): "
              "non-finite")
        if zero_rows is not None:
            check(not bool(out[zero_rows].any()),
                  f"{label} ({kind}): a ctx-0 lane is not exactly 0")
        diff = (sel(out).float() - want).abs()
        err, use = float(diff.max()), float((diff / tol).max())
        check(use <= 1.0, f"{label} ({kind}): a row's error is {use:.3f} "
              f"of its bound ({rtol:.3e} of its largest |value| + "
              f"{PAGED_ROW_ATOL})")
        check(err <= ATOL_BF16, f"{label} ({kind}): max err {err:.3e} > "
              f"{ATOL_BF16}")
        errs.append(err)
        uses.append(use)
    return errs, uses


def _paged_times(torch, new_fn, old_fn, plain_fn, comp_fn, names):
    """Cold-L2 device ms of the new kernel, the old kernel, the plain
    version and the composition yardstick, and each wrapper's host clock
    per call in turns (old, new, new, old)."""
    def dev(fn, match, iters=50):
        return device_ms(fn, match, iters)

    new_ms, old_ms = dev(new_fn, names[0]), dev(old_fn, names[1])
    plain = dev(plain_fn, None, iters=20)
    comp = dev(comp_fn, None, iters=20)
    calls = [time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
    return dict(ms=new_ms, old_ms=old_ms, plain_ms=plain,
                composition_ms=comp, call_ms=(calls[1] + calls[2]) / 2,
                old_call_ms=(calls[0] + calls[3]) / 2, calls=calls)


def paged_checks(torch, cfg, dev, rng):
    """Paged decode and prefill on the card: the Hopper kernels (through
    the wrappers) and the SIMT kernels they replaced (the wrappers' simt
    route, same inputs), each against the plain version, at the headline
    serving shapes (8 lanes up to ctx 300; chunks at 0, 112 and 288), at
    4096 keys (a ragged lane list with ctx 0, 1, 16, 4095, 4096 and lanes
    ending on and just past split boundaries; chunks at 4080 and a
    partial one at 4088) and with every lane at ctx 1, bf16 and int8
    pools with a NaN-poisoned null block; timed with a cold L2 beside
    the plain version and the gather + SDPA composition. Returns the two
    kernels' JSON rows."""
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    scale = d ** -0.5
    out = {}
    esz = {"bf16": 2, "int8": 1}
    dtypes = (("bf16", torch.bfloat16), ("int8", torch.int8))

    # ---- decode
    t = -(-max(DECODE_CTX) // BLOCK) + 1
    tables_np, nb = block_tables(DECODE_CTX, t, rng)
    q = torch.randn((SLOTS, hq, d), device=dev).to(torch.bfloat16)
    cases = {"headline": (DECODE_CTX, torch.tensor(tables_np, device=dev),
                          nb, 1, True)}
    lrng = np.random.default_rng(18)
    tl = LONG_CTX // BLOCK
    per = ops.paged_splits(LONG_CTX, SLOTS * hkv)[1]    # split boundaries
    ragged = [0, 1, 16, LONG_CTX - 1, LONG_CTX, per, 2 * per, per + 1]
    for name, ctx_list, timed in (("long", [LONG_CTX] * SLOTS, True),
                                  ("long-ragged", ragged, False),
                                  ("ctx1", [1] * SLOTS, True)):
        tw = t if name == "ctx1" else tl
        tnp, n = block_tables(ctx_list, tw, lrng)
        cases[name] = (ctx_list, torch.tensor(tnp, device=dev), n, 3, timed)
    rows = {}
    errs = [0.0, 0.0]
    for case, (ctx_list, tables, n, seed, timed) in cases.items():
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        zero = ctx == 0
        for name, kv_dtype in dtypes:
            k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, n + 1, seed, dev)
            kw = dict(scale=scale, k_scales=ks, v_scales=vs)
            args = (q, k, v, tables, ctx)
            new_fn = lambda: ops.paged_decode_attention(*args, **kw)
            old_fn = lambda: ops._paged_decode(*args, route="simt", **kw)
            plain_fn = lambda: ref.paged_decode_attention_ref(*args, **kw)
            want_fn = lambda: ref.paged_decode_attention_ref(
                q.float(), *args[1:], **kw)
            comp_fn = lambda: _decode_composition(torch, q, k, v, ks, vs,
                                                  tables, ctx, scale)
            route = ops.paged_route("decode", q.dtype, kv_dtype, d, BLOCK)
            names = (PAGED_LIBS["paged_decode_attention"][1]
                     if route != "simt" else "paged_decode_kernel",
                     "paged_decode_kernel")
            e, use = _paged_run(torch, f"decode {case} {name}", new_fn,
                                old_fn, want_fn, PAGED_RTOL["decode"], route,
                                ops, "paged_decode_attention",
                                zero_rows=zero)
            errs = [max(a, b) for a, b in zip(errs, e)]
            nsplit = ops.paged_splits(tables.shape[1] * BLOCK,
                                      len(ctx_list) * hkv)[0]
            msg = (f"[kernel] paged_decode_attention {case} {name} pools "
                   f"({len(ctx_list)} lanes, ctx {min(ctx_list)}.."
                   f"{max(ctx_list)}, T {tables.shape[1]}, {nsplit} "
                   f"splits): "
                   f"max|err| new {e[0]:.3e}, old {e[1]:.3e} (atol "
                   f"{ATOL_BF16}), worst row at {use[0]:.3f} / {use[1]:.3f} "
                   f"of its bound (2^-8 of its largest |value| + "
                   f"{PAGED_ROW_ATOL}); bitwise repeatable")
            if timed:
                r = _paged_times(torch, new_fn, old_fn, plain_fn, comp_fn,
                                 names)
                nbytes, flops = _decode_work(cfg, ctx_list, esz[name],
                                             len(ctx_list))
                nbytes += tables.numel() * 4 + ctx.numel() * 4
                r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
                rows[(case, name)] = r
                msg += (f"; device: new {r['ms']:.5f} ms, old "
                        f"{r['old_ms']:.5f} ms, plain {r['plain_ms']:.5f} "
                        f"ms, composition (gather + SDPA) "
                        f"{r['composition_ms']:.5f} ms; bound "
                        f"{r['bound_ms']:.5f} ms ({r['bound_by']}); host "
                        f"clock per call new {r['call_ms']:.5f} ms, old "
                        f"{r['old_call_ms']:.5f} ms (old, new, new, old: "
                        + ", ".join(f"{c:.5f}" for c in r["calls"]) + ")")
            print(msg)
            del k, v, ks, vs
    out["paged_decode_attention"] = _paged_row(
        rows, errs, "paged_decode_tma.cu", "paged_decode.cu", "304")

    # ---- prefill: first, middle and partial last chunk (headline), two
    # chunks at 4096 keys, one row at ctx 1
    ctx_max = max(o + c for o, c in PREFILL_CHUNKS)
    t1 = -(-ctx_max // BLOCK) + 1
    tbl_np, nb1 = block_tables([ctx_max], t1, rng)
    ltbl_np, nbl = block_tables([LONG_CTX], LONG_CTX // BLOCK, lrng)
    cases = {"headline": (PREFILL_CHUNKS, torch.tensor(tbl_np[0], device=dev),
                          nb1, 2),
             "long": (LONG_PREFILL_CHUNKS,
                      torch.tensor(ltbl_np[0], device=dev), nbl, 4),
             "ctx1": ([(0, 1)], torch.tensor(tbl_np[0], device=dev), nb1, 2)}
    rows = {}
    errs = [0.0, 0.0]
    for case, (chunks, table, n, seed) in cases.items():
        for name, kv_dtype in dtypes:
            k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, n + 1, seed, dev)
            kw = dict(scale=scale, k_scales=ks, v_scales=vs)
            for off, clen in chunks:
                qc = torch.randn((hq, CHUNK, d), device=dev).to(torch.bfloat16)
                args = (qc, k, v, table, off, off + clen)
                new_fn = lambda: ops.paged_prefill_attention(*args, **kw)
                old_fn = lambda: ops._paged_prefill(*args, route="simt", **kw)
                plain_fn = lambda: ref.paged_prefill_attention_ref(*args,
                                                                   **kw)
                want_fn = lambda: ref.paged_prefill_attention_ref(
                    qc.float(), *args[1:], **kw)
                comp_fn = lambda: _prefill_composition(
                    torch, qc, k, v, ks, vs, table, off, off + clen, scale)
                route = ops.paged_route("prefill", qc.dtype, kv_dtype, d,
                                        BLOCK)
                names = (PAGED_LIBS["paged_prefill_attention"][1]
                         if route != "simt" else "paged_prefill_kernel",
                         "paged_prefill_kernel")
                e, use = _paged_run(
                    torch, f"prefill {case} {name} @{off}+{clen}", new_fn,
                    old_fn, want_fn, PAGED_RTOL["prefill"], route, ops,
                    "paged_prefill_attention",
                    rows=lambda x, c=clen: x[:, :c])
                errs = [max(a, b) for a, b in zip(errs, e)]
                nsplit = ops.prefill_splits(
                    route, min(off + clen, table.shape[0] * BLOCK),
                    hkv * -(-hq // hkv * CHUNK
                            // ops.PREFILL_KERNELS[route].rows))[0]
                print(f"[kernel] paged_prefill_attention {case} {name} pools "
                      f"(chunk at {off}, {clen} rows, ctx {off + clen}, "
                      f"{nsplit} splits): max|err| new {e[0]:.3e}, old "
                      f"{e[1]:.3e} (atol {ATOL_BF16}), worst row at "
                      f"{use[0]:.3f} / {use[1]:.3f} of its bound (2^-7 of "
                      f"its largest |value| + {PAGED_ROW_ATOL}); bitwise "
                      "repeatable")
            # time the case's last chunk (headline: the partial one at 288)
            off, clen = chunks[-1] if case != "long" else chunks[0]
            args = (qc, k, v, table, off, off + clen)
            r = _paged_times(torch, new_fn, old_fn, plain_fn, comp_fn, names)
            ctx_len = off + clen
            nbytes = (2 * hq * CHUNK * d * 2
                      + 2 * ctx_len * hkv * (d * esz[name]
                                             + (4 if name == "int8" else 0))
                      + table.numel() * 4)
            flops = 4 * hq * d * sum(off + c + 1 for c in range(clen))
            r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                 BF16_FLOPS_PER_S)
            rows[(case, name)] = r
            print(f"[kernel] paged_prefill_attention {case} {name} pools, "
                  f"timed chunk at {off}, {clen} rows: device: new "
                  f"{r['ms']:.5f} ms, old {r['old_ms']:.5f} ms, plain "
                  f"{r['plain_ms']:.5f} ms, composition (gather + SDPA) "
                  f"{r['composition_ms']:.5f} ms; bound {r['bound_ms']:.5f} "
                  f"ms ({r['bound_by']}); host clock per call new "
                  f"{r['call_ms']:.5f} ms, old {r['old_call_ms']:.5f} ms "
                  "(old, new, new, old: "
                  + ", ".join(f"{c:.5f}" for c in r["calls"]) + ")")
            del k, v, ks, vs
    out["paged_prefill_attention"] = _paged_row(
        rows, errs, "paged_prefill_tc.cu", "paged_prefill.cu", "442")
    return out


def _verify_composition(torch, q, k, v, ks, vs, tables, ctx, win, scale):
    """The yardstick of the batched verify: every lane's K/V gathered as
    in _decode_composition, then one SDPA over [B, Hq, C, D] with each
    lane's causal window mask and enable_gqa."""
    F = torch.nn.functional
    hkv, _, bs, d = k.shape
    b, t = tables.shape
    c = q.shape[2]
    idx = tables.long()

    def gather(pool, sc):
        x = pool[:, idx]                                # [Hkv, B, T, bs, D]
        if sc is not None:
            x = (x.float() * sc[:, idx]).to(q.dtype)
        return x.transpose(0, 1).reshape(b, hkv, t * bs, d)

    kp = torch.arange(t * bs, device=q.device)
    qp = ctx[:, None] + torch.arange(c, device=q.device)[None]   # [B, C]
    mask = ((kp[None, None] <= qp[:, :, None])
            & (kp[None, None] < (ctx + win)[:, None, None]))
    return F.scaled_dot_product_attention(
        q, gather(k, ks), gather(v, vs), attn_mask=mask[:, None],
        scale=scale, enable_gqa=True)


def _bf16_ulps(torch, a, b):
    """bf16 ulps between two bf16 tensors: their bit patterns as ordered
    integers (sign-magnitude to two's complement), subtracted."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def verify_vs_decode(torch, ops, q, k, v, tables, ctx_np, win_np, kw,
                     outs, bound=None):
    """Each live row of the verify outputs ``outs`` ({name: [B, Hq, C,
    D]}) against the paged decode kernel's output for the same query row
    over the same keys (lane b's row c sees positions < ctx[b] + c + 1).
    ``bound`` (bf16: ref.verify_decode_gap_bound of the inputs, float64
    [B, Hq, C, D]): how far the two kernels' float32 values may lie apart.
    Returns {name: dict(rows bitwise equal, rows, elements bitwise equal,
    elements, largest distance in bf16 ulps (float32: |difference|),
    elements more than one ulp apart, the largest |difference| of those
    over its row's largest |decode value|; bf16 also the elements farther
    than one ulp + the bound and the largest share of the bound taken
    beyond one ulp)}."""
    dev = q.device
    c = q.shape[2]
    stats = {name: dict(bitwise_rows=0, rows=0, bitwise_elements=0,
                        elements=0, max_ulps=0.0, over_1_ulp=0,
                        over_1_ulp_rel=0.0, over_bound=0, bound_use=0.0)
             for name in outs}
    for col in range(c):
        on = win_np > col
        if not on.any():
            continue
        seen = torch.tensor(np.where(on, ctx_np + col + 1, 0)
                            .astype(np.int32), device=dev)
        dec = ops.paged_decode_attention(q[:, :, col].contiguous(), k, v,
                                         tables, seen, **kw)
        torch.cuda.synchronize()
        sel = torch.tensor(on, device=dev)
        for name, out in outs.items():
            row, want = out[:, :, col][sel], dec[sel]
            st = stats[name]
            st["bitwise_rows"] += int((row == want).all(-1).sum())
            st["rows"] += int(row.shape[0] * row.shape[1])
            st["bitwise_elements"] += int((row == want).sum())
            st["elements"] += int(row.numel())
            if q.dtype != torch.bfloat16:
                st["max_ulps"] = max(st["max_ulps"],
                                     float((row - want).abs().max()))
                continue
            ulps = _bf16_ulps(torch, row, want)
            st["max_ulps"] = max(st["max_ulps"], float(ulps.max()))
            far = ulps > 1
            st["over_1_ulp"] += int(far.sum())
            gap = (row.double() - want.double()).abs()
            if far.any():
                rel = gap / want.double().abs().amax(-1, keepdim=True)
                st["over_1_ulp_rel"] = max(st["over_1_ulp_rel"],
                                           float(rel[far].max()))
            mag = torch.maximum(row.double().abs(), want.double().abs())
            ulp = torch.exp2(torch.floor(torch.log2(
                mag.clamp_min(2.0 ** -126))) - 7)
            past = (gap - ulp).clamp_min(0)
            use = torch.where(past > 0, past / bound[:, :, col][sel], 0.0)
            st["over_bound"] += int((use > 1).sum())
            st["bound_use"] = max(st["bound_use"], float(use.max()))
    return stats


def _verify_launch(ops, route, q, k, v, tables, ctx, win, scale, ks, vs,
                   split_p):
    """One launch of the verify's wgmma kernel, counted nowhere: P split
    in two bf16 parts (the route's arithmetic) or rounded once to bf16
    (the kernel before the split, a prefill chunk's), to time and compare
    the two on the same inputs."""
    return ops._prefill_launch(route, q, k, v, tables, ctx, win, 0, 0,
                               scale, ks, vs, "paged_verify_attention",
                               split_p=split_p)


def verify_checks(torch, cfg, dev):
    """The batched speculative verify (``ops.paged_verify_attention``, one
    launch for all lanes) at the serving shape: 8 lanes with draft windows
    of up to SPEC_K + 1 rows (:data:`VERIFY_CTX`, :data:`VERIFY_WIN`: a
    dead lane, partial windows), bf16 and int8 pools under bf16 q (the
    wgmma route) and float32 and int8 pools under float32 q (the SIMT
    route), a NaN-poisoned null block. Each against the float32 plain
    version row by row (bf16: 2^-8 of a row's largest |value| + 1e-5, the
    decode kernel's bound, since the verify carries P in two bf16 parts;
    float32: 1e-5 of it), a dead lane exactly zero, two calls bitwise
    equal, one launch a call on the route paged_route names; every row
    against the paged decode kernel's at its position (verify_vs_decode):
    float32 rows bitwise (the speculative contract), bf16 elements within
    one bf16 ulp plus the kernels' derived float32 gap bound, fewer past
    VERIFY_ULPS ulp than with P rounded once (the kernel before the
    split), the shares of bitwise-equal rows and elements reported for
    both. Timed (cold L2) beside the plain version, the gather + SDPA
    composition and the per-lane loop of paged prefill launches the
    reference makes; bf16 q also in turns against the kernel with P
    rounded once, float32 q (the SIMT route) beside its CUDA-core bound.
    Returns its JSON row."""
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    scale = d ** -0.5
    c = SPEC_K + 1
    ctx_np, win_np = np.array(VERIFY_CTX), np.array(VERIFY_WIN)
    t = -(-int((ctx_np + win_np).max()) // BLOCK) + 1
    tables_np, nb = block_tables(list(ctx_np + win_np), t,
                                 np.random.default_rng(21))
    tables = torch.tensor(tables_np, device=dev)
    ctx = torch.tensor(ctx_np, dtype=torch.int32, device=dev)
    win = torch.tensor(win_np, dtype=torch.int32, device=dev)
    live = [(b, w) for b, w in enumerate(VERIFY_WIN) if w > 0]
    keys = sum(int(cx) + int(w) for cx, w in zip(VERIFY_CTX, VERIFY_WIN)
               if w > 0)
    flops = 4 * hq * d * sum(cx + j + 1 for cx, w in
                             zip(VERIFY_CTX, VERIFY_WIN) for j in range(w))
    wgmma_name = PAGED_LIBS["paged_prefill_attention"][1]
    rows, errs, vs_decode = {}, {}, {}
    for q_name, q_dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
        q = torch.randn((SLOTS, hq, c, d), device=dev).to(q_dtype)
        qsz = 2 if q_dtype == torch.bfloat16 else 4
        for kv_name, kv_dtype in ((q_name, q_dtype), ("int8", torch.int8)):
            label = f"verify {q_name} q, {kv_name} pools"
            k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, nb + 1, 5, dev)
            kw = dict(scale=scale, k_scales=ks, v_scales=vs)
            args = (q, k, v, tables, ctx, win)
            route = ops.paged_route("prefill", q_dtype, kv_dtype, d, BLOCK)
            before = ops.route_counts()["paged_verify_attention"]
            got = ops.paged_verify_attention(*args, **kw)
            again = ops.paged_verify_attention(*args, **kw)
            want = ref.paged_verify_attention_ref(q.float(), *args[1:], **kw)
            torch.cuda.synchronize()
            grew = {r: n - before[r] for r, n in
                    ops.route_counts()["paged_verify_attention"].items()}
            check(grew == {**dict.fromkeys(grew, 0), route: 2},
                  f"{label}: launches by route {grew}, want two on {route}")
            check(torch.equal(got, again), f"{label}: two calls differ")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            check(not bool(got[0].any()), f"{label}: the dead lane is not "
                  "exactly 0")
            rtol = (PAGED_RTOL["decode"] if q_dtype == torch.bfloat16
                    else VERIFY_RTOL_F32)
            atol = PAGED_ROW_ATOL if q_dtype == torch.bfloat16 else 0.0
            err, use = 0.0, 0.0
            for b, w in live:
                wr = want[b, :, :w].float()
                diff = (got[b, :, :w].float() - wr).abs()
                tol = rtol * wr.abs().amax(-1, keepdim=True) + atol
                err = max(err, float(diff.max()))
                use = max(use, float((diff / tol).max()))
            check(use <= 1.0, f"{label}: a row's error is {use:.3f} of its "
                  f"bound ({rtol:.3e} of its largest |value| + {atol})")
            # each row against the paged decode kernel at its position;
            # bf16 also with P rounded once (the verify before the split)
            outs, gap = {"verify": got}, None
            if q_dtype == torch.bfloat16:
                outs["P rounded once"] = _verify_launch(
                    ops, route, *args, scale, ks, vs, split_p=False)
                gap = ref.verify_decode_gap_bound(*args, **kw)
            cmp = verify_vs_decode(torch, ops, q, k, v, tables, ctx_np,
                                   win_np, kw, outs, gap)
            print(f"[kernel] paged_verify_attention {label} vs the paged "
                  f"decode kernel: {json.dumps(cmp)}")
            st = cmp["verify"]
            if q_dtype == torch.float32:
                check(st["bitwise_rows"] == st["rows"],
                      f"{label}: {st['rows'] - st['bitwise_rows']} of "
                      f"{st['rows']} rows differ from the paged decode "
                      "kernel's")
            else:
                once = cmp["P rounded once"]
                check(st["over_bound"] == 0,
                      f"{label}: {st['over_bound']} elements farther from "
                      f"the paged decode kernel's than one bf16 ulp + the "
                      f"kernels' float32 gap bound (beyond the ulp, "
                      f"{st['bound_use']:.3f} of it)")
                check(st["over_1_ulp"] < once["over_1_ulp"],
                      f"{label}: with P split {st['over_1_ulp']} elements "
                      f"lie more than {VERIFY_ULPS} bf16 ulp from the "
                      f"decode kernel's, with P rounded once "
                      f"{once['over_1_ulp']}")
                vs_decode[kv_name] = cmp
            errs[(q_name, kv_name)] = err
            msg = (f"[kernel] paged_verify_attention {label} ({SLOTS} lanes, "
                   f"windows {VERIFY_WIN} at ctx {VERIFY_CTX}, route "
                   f"{route}): max|err| {err:.3e}, worst row at {use:.3f} "
                   f"of its bound; rows vs the decode kernel's: " + "; ".join(
                       f"{name} {x['bitwise_rows']}/{x['rows']} bitwise, at "
                       f"most {x['max_ulps']:.4g} "
                       f"{'ulps' if q_dtype == torch.bfloat16 else 'apart'}"
                       for name, x in cmp.items())
                   + "; bitwise repeatable")
            del outs, gap
            esz = {torch.bfloat16: 2, torch.int8: 1,
                   torch.float32: 4}[kv_dtype]
            nbytes = (2 * SLOTS * hq * c * d * qsz + tables.numel() * 4
                      + 2 * SLOTS * 4
                      + 2 * keys * hkv * (d * esz + (4 if esz == 1 else 0)))
            if q_dtype == torch.bfloat16:
                lanes = [b for b, _ in live]
                per_lane = lambda: [ops.paged_prefill_attention(
                    q[b], k, v, tables[b], VERIFY_CTX[b],
                    VERIFY_CTX[b] + VERIFY_WIN[b], **kw) for b in lanes]
                split_ms, unsplit_ms = in_turns(
                    lambda: _verify_launch(ops, route, *args, scale, ks, vs,
                                           split_p=True),
                    lambda: _verify_launch(ops, route, *args, scale, ks, vs,
                                           split_p=False),
                    wgmma_name, wgmma_name)
                r = dict(
                    ms=device_ms(lambda: ops.paged_verify_attention(
                        *args, **kw), wgmma_name),
                    split_ms_in_turns=split_ms,
                    p_rounded_once_ms_in_turns=unsplit_ms,
                    per_lane_ms=device_ms(per_lane, wgmma_name),
                    plain_ms=device_ms(lambda: ref.paged_verify_attention_ref(
                        *args, **kw), None, iters=20),
                    composition_ms=device_ms(lambda: _verify_composition(
                        torch, q, k, v, ks, vs, tables, ctx, win, scale),
                        None, iters=20),
                    call_ms=time_ms(lambda: ops.paged_verify_attention(
                        *args, **kw)),
                    per_lane_call_ms=time_ms(per_lane))
                r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
                rows[kv_name] = r
                msg += (f"; device: kernel {r['ms']:.5f} ms (one launch); "
                        f"in turns P split {split_ms:.5f} ms against P "
                        f"rounded once {unsplit_ms:.5f} ms; the "
                        f"reference's per-lane prefill launches "
                        f"({len(lanes)}) {r['per_lane_ms']:.5f} ms, plain "
                        f"{r['plain_ms']:.5f} ms, composition (gather + "
                        f"SDPA) {r['composition_ms']:.5f} ms; bound "
                        f"{r['bound_ms']:.5f} ms ({r['bound_by']}); host "
                        f"clock per call {r['call_ms']:.5f} ms, per-lane "
                        f"loop {r['per_lane_call_ms']:.5f} ms")
            else:
                simt_name = "paged_prefill_kernel"
                r = dict(ms=device_ms(lambda: ops.paged_verify_attention(
                    *args, **kw), simt_name),
                    plain_ms=device_ms(lambda: ref.paged_verify_attention_ref(
                        *args, **kw), None, iters=20))
                r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                     F32_FLOPS_PER_S)
                rows[f"f32_{kv_name}"] = r
                msg += (f"; device (SIMT route): kernel {r['ms']:.5f} ms, "
                        f"plain {r['plain_ms']:.5f} ms; bound "
                        f"{r['bound_ms']:.5f} ms ({r['bound_by']}, float32 "
                        f"on the CUDA cores)")
            print(msg)
            del k, v, ks, vs, got, again, want
    head = rows["bf16"]
    return dict(source="src/repro_torch/kernels/csrc/paged_prefill_tc.cu",
                simt_source="src/repro_torch/kernels/csrc/paged_prefill.cu",
                replaces="src/repro/kernels/flash_attention.py:442",
                max_abs_err=errs[("bf16", "bf16")],
                f32_max_abs_err=errs[("f32", "f32")],
                library_ms=None, library_call=SPEC_LIBRARY_NOTE,
                composition_call=COMPOSITION_NOTE,
                headline=f"{SLOTS} lanes, windows {VERIFY_WIN}, bf16",
                vs_decode=vs_decode,
                **{k: head[k] for k in ("ms", "split_ms_in_turns",
                                        "p_rounded_once_ms_in_turns",
                                        "per_lane_ms", "plain_ms",
                                        "composition_ms", "call_ms",
                                        "per_lane_call_ms", "bound_ms",
                                        "bound_by")},
                **{f"int8_{k}": rows["int8"][k] for k in (
                    "ms", "split_ms_in_turns", "p_rounded_once_ms_in_turns",
                    "per_lane_ms", "plain_ms", "composition_ms",
                    "bound_ms")},
                **{f"{name}_{k}": rows[name][k] for name in ("f32_f32",
                                                             "f32_int8")
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


def _paged_row(rows, errs, src, simt_src, line):
    """A paged kernel's JSON row: the headline bf16 case's numbers under
    the common keys, every other case's under ``<case>_<dtype>_<key>``."""
    head = rows[("headline", "bf16")]
    row = dict(source=f"src/repro_torch/kernels/csrc/{src}",
               simt_source=f"src/repro_torch/kernels/csrc/{simt_src}",
               replaces=f"src/repro/kernels/flash_attention.py:{line}",
               max_abs_err=errs[0], old_max_abs_err=errs[1],
               library_ms=None, library_call=LIBRARY_NOTE,
               composition_call=COMPOSITION_NOTE,
               **{k: head[k] for k in ("ms", "old_ms", "plain_ms",
                                       "composition_ms", "call_ms",
                                       "old_call_ms", "bound_ms",
                                       "bound_by")})
    for (case, name), r in rows.items():
        prefix = ("" if case == "headline" else f"{case}_") + (
            "" if name == "bf16" else f"{name}_")
        if prefix:
            row.update({prefix + k: r[k] for k in (
                "ms", "old_ms", "plain_ms", "composition_ms", "call_ms",
                "old_call_ms", "bound_ms")})
    return row


def kernel_checks(torch, cfg, dev):
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    hkv = cfg.num_kv_heads
    out = paged_checks(torch, cfg, dev, rng)

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
    b_ms, _ = bound(m * ops.LANES * (4 + 4 + 1) + m * 4,
                    4 * m * ops.LANES, F32_FLOPS_PER_S)
    print(f"[kernel] quantize_int8: bitwise equal (random and pinned bits, "
          f"zero row); device: kernel {ms:.5f} ms, plain {plain:.5f} ms; "
          f"bound {b_ms:.7f} ms; host clock per call {call:.5f} ms ({m} "
          f"rows, the old serving shape)")
    out["quantize_int8"] = dict(
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:70", max_abs_err=0.0,
        m128_ms=ms, m128_plain_ms=plain, m128_call_ms=call,
        m128_bound_ms=b_ms, **codec_quantize(torch, cfg, dev))
    out["quantize_kv_append"] = append_checks(torch, cfg, dev)
    return out


def codec_quantize(torch, cfg, dev):
    """quantize_int8 at the codec's own shapes: a hier_fl round quantizes
    each client's whole leaf delta, packed in rows of 128 lanes, one
    launch a leaf and client. Times flad-adllm's embedding and ffn.wi
    leaves (cold L2, bitwise against the plain version) beside the bytes
    bound (x and the random words read, 4 + 4 bytes an element, the codes
    written, 1, and a 4-byte scale a row); returns the JSON keys, headed
    by ffn.wi, the largest leaf."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    names = _leaf_names(lm.abstract_params(cfg))
    sizes = _leaf_sizes(torch, cfg)
    rows_by_leaf = {n: -(-k // ops.LANES) for n, k in zip(names, sizes)}
    keys = {}
    for label, leaf in (("embed", "embed.table"), ("ffn_wi", "blocks.ffn.wi")):
        m = rows_by_leaf[leaf]
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn((m, ops.LANES), generator=g, device=dev) * 1e-3
        bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, ops.LANES),
                             generator=g, device=dev,
                             dtype=torch.int32).view(torch.uint32)
        q, sc = ops.quantize_int8(x, bits)
        qr, sr = ref.quantize_int8_ref(x, bits)
        torch.cuda.synchronize()
        check(torch.equal(q, qr) and torch.equal(sc, sr),
              f"quantize ({leaf}, {m} rows) differs from the plain version")
        del q, sc, qr, sr
        ms = device_ms(lambda: ops.quantize_int8(x, bits),
                       "quantize_int8_kernel", iters=20)
        plain = device_ms(lambda: ref.quantize_int8_ref(x, bits), None,
                          iters=5)
        nbytes = m * ops.LANES * (4 + 4 + 1) + m * 4
        b_ms, b_by = bound(nbytes, 4 * m * ops.LANES, F32_FLOPS_PER_S)
        print(f"[kernel] quantize_int8 codec, {leaf} ({m} rows): bitwise "
              f"equal; device (cold L2): kernel {ms:.5f} ms, plain "
              f"{plain:.5f} ms; bound {b_ms:.5f} ms ({b_by}): "
              f"{100 * b_ms / ms:.1f}% of it; "
              f"{nbytes / ms / 1e9:.2f} TB/s")
        pre = "" if label == "ffn_wi" else f"{label}_"
        keys.update({f"{pre}ms": ms, f"{pre}plain_ms": plain,
                     f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by,
                     f"{pre}rows": m})
        del x, bits
        torch.cuda.empty_cache()
    keys["headline"] = (f"the codec on one client's ffn.wi delta "
                        f"({rows_by_leaf['blocks.ffn.wi']} rows)")
    keys["rows_by_leaf"] = rows_by_leaf
    return keys


def _bits(torch, t):
    """A tensor's bits, for bitwise comparison."""
    return t.view(torch.uint8) if t.element_size() == 1 else t.view(
        torch.int32)


def _ops_per_call(torch, fn, n=10):
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if (getattr(e, "device_time_total", 0)
                   or getattr(e, "cuda_time_total", 0)) > 0) / n


def append_checks(torch, cfg, dev):
    """The int8 KV cache's fused append (``quantize_kv_append``) against
    its plain version, bitwise outside the null block, at the serving
    path's shapes: a decode step's append (8 lanes, one of them dead at
    the null block), a prefill chunk's (16 rows, 7 live) and the
    monolithic prefill's all-layers write through a table; bf16 rows (the
    path) and float32. Timed beside its plain version and beside the
    composition serving ran before (float copy, padding to 128 lanes, the
    pinned bits, the quantize_int8 kernel, a slice copy, four scatters),
    with each one's device operations a call. Returns the JSON row (the
    decode append as the headline)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import kvcache as KC
    hkv, d, L = cfg.num_kv_heads, cfg.hd, cfg.num_layers
    spec = KC.PagedCacheSpec.for_requests(SLOTS, 96 + 48, block_size=BLOCK,
                                          quantized=True)
    nb = spec.num_blocks
    g = torch.Generator(device=dev).manual_seed(12)

    def pools(lead):
        shape = (*lead, nb, BLOCK, d)
        return [torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
                for _ in range(2)] + [
            torch.rand((*lead, nb, BLOCK, 1), generator=g, device=dev)
            for _ in range(2)]

    def composition(p, k, v, phys=None, off=None, table=None):
        pk = dict(zip(("k", "v", "k_scale", "v_scale"), p))
        if table is None:
            kq, ks = KC.quantize_rows(k)
            vq, vs = KC.quantize_rows(v)
            phys, off = phys.long(), off.long()
            pk["k"][:, phys, off] = kq
            pk["v"][:, phys, off] = vq
            pk["k_scale"][:, phys, off] = ks
            pk["v_scale"][:, phys, off] = vs
        else:
            s_ = k.shape[-2]
            nbk = -(-s_ // BLOCK)
            pad = nbk * BLOCK - s_
            kb = torch.nn.functional.pad(k, (0, 0, 0, pad)).reshape(
                L, hkv, nbk, BLOCK, d)
            vb = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(
                L, hkv, nbk, BLOCK, d)
            kq, ks = KC.quantize_rows(kb)
            vq, vs = KC.quantize_rows(vb)
            row = table[:nbk].long()
            pk["k"][:, :, row] = kq
            pk["v"][:, :, row] = vq
            pk["k_scale"][:, :, row] = ks
            pk["v_scale"][:, :, row] = vs

    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    cases = {
        # decode: 8 lanes, lane 5 dead (null block, offset 0)
        "decode": ((hkv,), SLOTS,
                   dict(phys=torch.where(torch.arange(SLOTS, device=dev) == 5,
                                         0, perm[:SLOTS]),
                        off=torch.arange(SLOTS, device=dev) * 2 % BLOCK)),
        # a prefill chunk: 16 rows, 7 live, padding rows to the null block
        "chunk": ((hkv,), CHUNK,
                  dict(phys=torch.where(torch.arange(CHUNK, device=dev) < 7,
                                        perm[SLOTS], 0),
                       off=torch.arange(CHUNK, device=dev) % BLOCK)),
        # monolithic prefill: every layer, 100 rows through a 9-block
        # table whose 7th block is the null block
        "prefill": ((L, hkv), 100,
                    dict(table=torch.cat([perm[9:15], torch.zeros(
                        3, dtype=perm.dtype, device=dev)]).to(torch.int32))),
    }
    rows = {}
    for label, (lead, n, idx) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            k = torch.randn((*lead, n, d), generator=g, device=dev).to(dtype)
            v = torch.randn((*lead, n, d), generator=g, device=dev).to(dtype)
            k[..., 3, :] = 0.0                  # an all-zero row
            base = pools(lead)
            got = [t.clone() for t in base]
            want = [t.clone() for t in base]
            old = [t.clone() for t in base]
            ops.quantize_kv_append(*got, k, v, **idx)
            ref.quantize_kv_append_ref(*want, k, v, **idx)
            composition(old, k, v, **idx)
            torch.cuda.synchronize()
            live = (slice(None),) * len(lead) + (slice(1, None),)
            for a, b_, c in zip(got, want, old):
                a, b_, c = (_bits(torch, t[live]) for t in (a, b_, c))
                check(torch.equal(a, b_), f"quantize_kv_append {label} "
                      f"{dtype}: differs from the plain version outside the "
                      f"null block")
                check(torch.equal(b_, c), f"quantize_kv_append {label} "
                      f"{dtype}: the plain version differs from the "
                      f"composition")
            if dtype != torch.bfloat16:
                continue
            fn = (lambda: ops.quantize_kv_append(*got, k, v, **idx))
            plain_fn = (lambda: ref.quantize_kv_append_ref(*want, k, v,
                                                           **idx))
            comp_fn = (lambda: composition(old, k, v, **idx))
            ms, plain, call = timings(fn, plain_fn, "kv_append_kernel")
            comp = device_ms(comp_fn, None, iters=20)
            comp_call = time_ms(comp_fn, iters=50)
            ops_new, ops_comp = _ops_per_call(torch, fn), _ops_per_call(
                torch, comp_fn)
            m = 2 * math.prod(lead) * (-(-n // BLOCK) * BLOCK
                                       if "table" in idx else n)
            nbytes = (2 * math.prod(lead) * n * d * 2 + m * (d + 4)
                      + (2 * n * 8 if "phys" in idx else 0))
            b_ms, b_by = bound(nbytes, 4 * m * d, F32_FLOPS_PER_S)
            rows[label] = dict(ms=ms, plain_ms=plain, call_ms=call,
                               composition_ms=comp,
                               composition_call_ms=comp_call,
                               ops=ops_new, composition_ops=ops_comp,
                               bound_ms=b_ms, bound_by=b_by)
            print(f"[kernel] quantize_kv_append {label} ({m} rows of "
                  f"{d}, bf16 in): bitwise equal to the plain version and "
                  f"to the composition serving ran before (bf16 and "
                  f"float32 rows, outside the null block); device: kernel "
                  f"{ms:.5f} ms, plain {plain:.5f} ms, the old composition "
                  f"{comp:.5f} ms; device operations a call: kernel "
                  f"{ops_new:.0f}, composition {ops_comp:.0f}; host clock "
                  f"per call: kernel {call:.5f} ms, composition "
                  f"{comp_call:.5f} ms; bound {b_ms:.7f} ms ({b_by})")
    head = rows["decode"]
    return dict(source="src/repro_torch/kernels/csrc/kv_append_int8.cu",
                replaces="src/repro/kernels/quantize.py:70", max_abs_err=0.0,
                library_ms=None, library_call=APPEND_LIBRARY_NOTE,
                headline="decode append: 8 lanes x 8 KV heads, bf16 rows",
                **head, cases=rows)


APPEND_DECODE_LIBRARY_NOTE = ("no single PyTorch call appends rows to paged "
                              "pools and attends through a block table")
#: its kernel phase's lanes, by keys after the append: the serving shape
#: (lane 0 dead, 0 here: a null table, ctx 0, its row to (null block, 0),
#: which it then reads as its one key; lane 1 at its first key) and every
#: lane at 4096 keys (several splits)
APPEND_DECODE_KEYS = {"serving": DECODE_CTX, "long": [LONG_CTX] * SLOTS}


def _append_decode_case(torch, cfg, dev, kv_dtype, keys, t, seed, rng):
    """Inputs of one fused append-and-decode case: ``keys`` [B] keys each
    lane sees after the append (0: a dead lane, whose null table row and
    ctx 0 put its row at (null block, 0) and its one key there), a
    t-wide table, pools with a NaN-poisoned null block and every live
    lane's target slot holding a sentinel (int8: codes 127 and scale 1e3;
    bf16: 1e4), bf16 q and the rows as the engine hands them over ([Hkv,
    B, D], a transposed view). Returns (q, rows, tables, ctx, phys, off,
    pools)."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    tnp, n = block_tables(keys, t, rng)
    pre = np.maximum(np.asarray(keys) - 1, 0)
    phys_np = tnp[np.arange(len(keys)), pre // BLOCK].astype(np.int64)
    pools = list(paged_pools(torch, cfg, kv_dtype, n + 1, seed, dev))
    live = torch.tensor(phys_np[phys_np > 0], device=dev)
    live_off = torch.tensor((pre % BLOCK)[phys_np > 0], device=dev)
    for i, t_ in enumerate(pools):
        if t_ is not None:
            t_[:, live, live_off] = (1e4 if kv_dtype != torch.int8
                                     else 127 if i < 2 else 1e3)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn((len(keys), hq, d), generator=g, device=dev).to(
        torch.bfloat16)
    rows = [(torch.randn((len(keys), hkv, d), generator=g, device=dev)
             * 3).to(torch.bfloat16).transpose(0, 1) for _ in range(2)]
    rows[0][1, 2] = 0.0                         # an all-zero row
    return (q, rows, torch.tensor(tnp, device=dev),
            torch.tensor(pre, dtype=torch.int32, device=dev),
            torch.tensor(phys_np, device=dev),
            torch.tensor(pre % BLOCK, dtype=torch.int64, device=dev), pools)


def _pair_append(ops, pools, rows, phys, off):
    """The stand-alone append the fused launch replaces: the int8 cache's
    quantize_kv_append, or the model-dtype cache's two scatters."""
    if pools[2] is not None:
        ops.quantize_kv_append(*pools, *rows, phys, off)
    else:
        pools[0][:, phys, off] = rows[0]
        pools[1][:, phys, off] = rows[1]


def decode_append_checks(torch, dev):
    """The decode step's fused append-and-decode
    (``ops.paged_decode_append_attention``: one launch of the TMA-fed
    decode kernel's fused entry point) on flad-adllm's heads (16/8, head
    dim 64, route tma) and qwen3-14b's (40/8, head dim 128, route tma128),
    at the serving shape (8 lanes to 300 keys after the append, one of
    them dead) and at 4096 keys (several splits), over bf16 and int8 pools
    with a NaN-poisoned null block and a sentinel in every target slot:
    pools bitwise the separate pair's (the stand-alone append, then the
    decode kernel over ctx + 1) and the plain version's, the output
    bitwise the pair's and within the decode row bound of the float32
    plain version, two calls bitwise equal, one fused launch and no
    stand-alone append a call. Timed with a cold L2 in turns (fused, pair,
    decode alone, decode alone, pair, fused) beside the plain version,
    with each one's host clock and device operations a call. Returns the
    JSON row (the head_dim-64 serving case over bf16 pools as the
    headline)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(41)
    out, errs = {}, [0.0]
    for arch in ("flad-adllm", DENSE_FULL):
        cfg = get_config(arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        route = {64: "tma", 128: "tma128"}[d]
        kname = (PAGED_LIBS if d == 64 else PAGED128_LIBS)[
            "paged_decode_attention"][1]
        scale = d ** -0.5
        for case, keys in APPEND_DECODE_KEYS.items():
            t = (-(-max(keys) // BLOCK) + 1 if case == "serving"
                 else LONG_CTX // BLOCK)
            for name, kv_dtype, esz in (("bf16", torch.bfloat16, 2),
                                        ("int8", torch.int8, 1)):
                check(ops.decode_fuses_append(torch.bfloat16, kv_dtype, d,
                                              BLOCK), f"{FUSED} D{d} "
                      f"{name}: the decode does not fuse the append")
                q, rows, tables, ctx, phys, off, base = _append_decode_case(
                    torch, cfg, dev, kv_dtype, keys, t, 7, rng)
                seen = ctx + 1
                fused, pair, plain = ([None if x is None else x.clone()
                                       for x in base] for _ in range(3))

                def fused_fn():
                    return ops.paged_decode_append_attention(
                        q, *rows, fused[0], fused[1], tables, ctx, phys, off,
                        scale=scale, k_scales=fused[2], v_scales=fused[3])

                def alone_fn():
                    return ops.paged_decode_attention(
                        q, pair[0], pair[1], tables, seen, scale=scale,
                        k_scales=pair[2], v_scales=pair[3])

                def pair_fn():
                    _pair_append(ops, pair, rows, phys, off)
                    return alone_fn()

                def plain_fn():
                    return ref.paged_decode_append_attention_ref(
                        q, *rows, plain[0], plain[1], tables, ctx, phys, off,
                        scale=scale, k_scales=plain[2], v_scales=plain[3])

                label = f"{FUSED} D{d} Hq{hq} Hkv{hkv} {case} {name}"
                counts = ops.launch_counts()
                routes = ops.route_counts()[FUSED]
                got = fused_fn()
                torch.cuda.synchronize()
                now = ops.launch_counts()
                grew = {k: now[k] - counts[k] for k in now
                        if now[k] != counts[k]}
                check(grew == {FUSED: 1} and ops.route_counts()[FUSED][route]
                      == routes[route] + 1, f"{label}: launches {grew}, "
                      f"want one fused launch on {route}")
                want = pair_fn()
                plain_fn()
                again = fused_fn()
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{label}: two calls differ")
                check(torch.equal(got.view(torch.int16),
                                  want.view(torch.int16)),
                      f"{label}: the output differs from the separate "
                      f"append and decode's")
                for i, (a, b_, c_) in enumerate(zip(fused, pair, plain)):
                    if a is None:
                        continue
                    a, b_, c_ = (_bits(torch, x) for x in (a, b_, c_))
                    check(torch.equal(a, b_) and torch.equal(a, c_),
                          f"{label}: pool {i} differs from the separate "
                          f"append's or the plain version's")
                ref32 = ref.paged_decode_attention_ref(
                    q.float(), fused[0], fused[1], tables, seen, scale=scale,
                    k_scales=fused[2], v_scales=fused[3])
                tol = (PAGED_RTOL["decode"]
                       * ref32.abs().amax(-1, keepdim=True) + PAGED_ROW_ATOL)
                diff = (got.float() - ref32).abs()
                err, use = float(diff.max()), float((diff / tol).max())
                check(bool(torch.isfinite(got).all()) and use <= 1.0,
                      f"{label}: a row's error is {use:.3f} of its bound")
                errs[0] = max(errs[0], err)
                # cold L2, in turns: fused, pair, alone, alone, pair, fused
                f1 = device_ms(fused_fn, kname)
                p1 = device_ms(pair_fn, None)
                a1 = device_ms(alone_fn, kname)
                a2 = device_ms(alone_fn, kname)
                p2 = device_ms(pair_fn, None)
                f2 = device_ms(fused_fn, kname)
                calls = [time_ms(f) for f in (fused_fn, pair_fn, pair_fn,
                                              fused_fn)]
                r = dict(ms=(f1 + f2) / 2, pair_ms=(p1 + p2) / 2,
                         decode_ms=(a1 + a2) / 2,
                         plain_ms=device_ms(plain_fn, None, iters=20),
                         call_ms=(calls[0] + calls[3]) / 2,
                         pair_call_ms=(calls[1] + calls[2]) / 2,
                         ops=_ops_per_call(torch, fused_fn),
                         pair_ops=_ops_per_call(torch, pair_fn),
                         turns=[f1, p1, a1, a2, p2, f2])
                nbytes, flops = _decode_work(cfg, [max(k, 1) for k in keys],
                                             esz, SLOTS)
                nbytes += (tables.numel() + ctx.numel()) * 4 + 2 * SLOTS * 8
                nbytes += 2 * hkv * SLOTS * d * 2       # the rows read
                r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
                out[f"D{d} {case} {name}"] = r
                print(f"[kernel] {label} ({SLOTS} lanes, {min(keys)}.."
                      f"{max(keys)} keys after the append, {route}): pools "
                      f"bitwise the separate append's and the plain "
                      f"version's (every target slot a sentinel first), "
                      f"output bitwise the separate pair's, max|err| "
                      f"{err:.3e} vs float32 plain (worst row {use:.3f} of "
                      f"its bound); device (cold L2, in turns): fused "
                      f"{r['ms']:.5f} ms, pair (append + decode) "
                      f"{r['pair_ms']:.5f} ms, decode alone "
                      f"{r['decode_ms']:.5f} ms (fused - decode "
                      f"{r['ms'] - r['decode_ms']:+.5f} ms), plain "
                      f"{r['plain_ms']:.5f} ms; bound {r['bound_ms']:.7f} "
                      f"ms ({r['bound_by']}); device operations a call: "
                      f"fused {r['ops']:.0f}, pair {r['pair_ops']:.0f}; "
                      f"host clock per call: fused {r['call_ms']:.5f} ms, "
                      f"pair {r['pair_call_ms']:.5f} ms; turns "
                      + ", ".join(f"{x:.5f}" for x in r["turns"]))
                del q, rows, base, fused, pair, plain
    head = out["D64 serving bf16"]
    return dict(source="src/repro_torch/kernels/csrc/paged_decode_tma.cu",
                source_d128="src/repro_torch/kernels/csrc/"
                            "paged_decode_tma128.cu",
                replaces="src/repro/kernels/flash_attention.py:304",
                also_replaces="src/repro/kernels/quantize.py:70 (the int8 "
                              "cache's append of a decode step)",
                max_abs_err=errs[0], library_ms=None,
                library_call=APPEND_DECODE_LIBRARY_NOTE,
                headline="flad-adllm's decode step layer: 8 lanes to 300 "
                         "keys, bf16 pools",
                **{k: head[k] for k in ("ms", "pair_ms", "decode_ms",
                                        "plain_ms", "call_ms",
                                        "pair_call_ms", "ops", "pair_ops",
                                        "bound_ms", "bound_by")},
                cases=out)


# ------------------------------------------------------- training kernels
def _pairs(sq, skv, causal=True, window=None, q_offset=0):
    """Visible (query, key) pairs of one head: the work the data needs."""
    total = 0
    for r in range(sq):
        qp = q_offset + r
        hi = min(skv, qp + 1) if causal else skv
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _flash_inputs(torch, dev, dtype, sq, skv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rand(B, HQ, sq, D), rand(B, HKV, skv, D), rand(B, HKV, skv, D),
            rand(B, HQ, sq, D))


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def flash_checks(torch, dev):
    """The flash forward and the three backward kernels against their
    plain versions (bf16 and float32; causal, ragged, offset, window, the
    distillation path's 1032 rows), the backward bitwise equal across two
    runs, every bf16 forward, dK/dV and dQ launch on the tensor-core route,
    every float32 one on the 3xTF32 route; timings at the causal training
    shape (the float32 forward, dK/dV and dQ beside the SIMT kernels they
    replaced, in turns). Returns the kernels' JSON rows (bf16, the main
    path's dtype, with the float32 kernels' times beside)."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    errs = {k: 0.0 for k in ("fwd", "pre", "dkv", "dq")}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        routes0 = ops.route_counts()
        for case, sq, skv, kw in FLASH_CASES:
            q, k, v, do = _flash_inputs(torch, dev, dtype, sq, skv, 4)
            o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                               **kw)
            delta = ops.flash_attention_bwd_preprocess(o, do)
            rdelta = ref.flash_attention_bwd_preprocess_ref(o, do)
            bkw = dict(scale=D ** -0.5, **kw)
            dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw)
            dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                       delta, **bkw)
            rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                 **bkw)
            again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(again,
                                                        (dq, dk, dv))),
                  f"flash backward {name} {case}: two runs differ")
            pairs = [("o", o, ro), ("lse", lse, rlse),
                     ("delta", delta, rdelta), ("dk", dk, rdk),
                     ("dv", dv, rdv), ("dq", dq, rdq)]
            for label, got, want in pairs:
                check(bool(torch.isfinite(got).all()),
                      f"flash {name} {case} {label}: non-finite")
                err = _err(got, want)
                if dtype == torch.float32:
                    tol = (FLASH_GRAD_ATOL_F32 if label in ("dk", "dv", "dq")
                           else FLASH_ATOL_F32)
                elif label in ("lse", "delta"):      # float32 outputs
                    tol = FLASH_ATOL_F32 * max(1.0, float(want.abs().max()))
                else:
                    tol = BF16_ULP * float(want.float().abs().max())
                check(err <= tol, f"flash {name} {case} {label}: max err "
                      f"{err:.3e} > {tol:.3e}")
                if dtype == torch.bfloat16:
                    key = {"o": "fwd", "lse": "fwd", "delta": "pre",
                           "dk": "dkv", "dv": "dkv", "dq": "dq"}[label]
                    errs[key] = max(errs[key], err)
            print(f"[kernel] flash {name} {case} (Sq {sq}, Skv {skv}): "
                  + ", ".join(f"{lab} {_err(a, b):.2e}"
                              for lab, a, b in pairs)
                  + "; backward bitwise repeatable")
            del o, lse, ro, rlse, rdk, rdv, rdq, again
        # one forward and two dK/dV and dQ launches a case (the direct
        # call and flash_attention_bwd's), all on this dtype's route
        grew = {fn: {r: n - routes0[fn][r] for r, n in c.items()}
                for fn, c in ops.route_counts().items()}
        want = {fn: dict.fromkeys(c, 0) for fn, c in grew.items()}
        for fn, kind, n in (("flash_attention", "fwd", 1),
                            ("flash_attention_bwd_dkv", "dkv", 2),
                            ("flash_attention_bwd_dq", "dq", 2)):
            want[fn][ops.flash_route(kind, dtype, D)] = n * len(FLASH_CASES)
        # and two preprocess launches, both on its vec kernel
        want[PRE]["vec"] = 2 * len(FLASH_CASES)
        check(grew == want, f"flash {name}: launches by route {grew} != "
              f"{want}")
        print(f"[kernel] flash {name}: launches by route {grew}")

    rows, f32_ms = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _flash_inputs(torch, dev, dtype, S, S, 5)
        o, lse = ops.flash_attention(q, k, v, return_lse=True)
        delta = ops.flash_attention_bwd_preprocess(o, do)
        sc = D ** -0.5
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)
        lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), None, iters=20)
        lib_bwd = device_ms(lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do, retain_graph=True), None, iters=20)
        esz = 2 if dtype == torch.bfloat16 else 4
        # the profiler name of each wrapper's kernel in this dtype
        match = {n: f"{stem}_kernel" for n, stem in FLASH_NAMES.items()}
        for n in FLASH_NAMES:
            if n in TC_KERNELS:
                match[n] = TC_KERNELS[n][3 if esz == 2 else 4]
            if esz == 4 and n in TF32_KERNELS:
                match[n] = TF32_KERNELS[n][2]
        runs = {
            "flash_attention": (
                lambda: ops.flash_attention(q, k, v, return_lse=True),
                lambda: ref.flash_attention_ref(q, k, v, return_lse=True),
                lib_fwd),
            "flash_attention_bwd_dkv": (
                lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                lambda: ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                        delta, scale=sc),
                lib_bwd),
            "flash_attention_bwd_dq": (
                lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                lambda: ref.flash_attention_bwd_dq_ref(q, k, v, do, lse,
                                                       delta, scale=sc),
                lib_bwd),
        }
        rate = BF16_FLOPS_PER_S if esz == 2 else F32_FLOPS_PER_S
        nq, nkv, stat = B * HQ * S * D, B * HKV * S * D, B * HQ * S
        pairs = B * HQ * _pairs(S, S)
        work = {   # bytes each input read once and output written once
            "flash_attention": ((2 * nq + 2 * nkv) * esz + 4 * stat,
                                4 * D * pairs),
            "flash_attention_bwd_dkv": ((2 * nq + 4 * nkv) * esz
                                        + 8 * stat, 8 * D * pairs),
            "flash_attention_bwd_dq": ((3 * nq + 2 * nkv) * esz + 8 * stat,
                                       6 * D * pairs),
        }
        old = {   # float32: the SIMT kernels the 3xTF32 ones replaced
            "flash_attention": lambda: ops._flash_fwd_card(
                q, k, v, scale=sc, causal=True, window=None, q_offset=0,
                return_lse=True, route="simt"),
            "flash_attention_bwd_dkv": lambda: ops._flash_dkv_card(
                q, k, v, do, lse, delta, scale=sc, causal=True, window=None,
                q_offset=0, route="simt"),
            "flash_attention_bwd_dq": lambda: ops._flash_dq_card(
                q, k, v, do, lse, delta, scale=sc, causal=True, window=None,
                q_offset=0, route="simt")}
        for name, (kfn, pfn, lib) in runs.items():
            ms, plain, call = timings(kfn, pfn, match[name])
            b_ms, b_by = bound(*work[name], rate)
            simt = ""
            if esz == 4 and name in TF32_KERNELS:
                ms, simt_ms = in_turns(kfn, old[name], match[name],
                                       TC_KERNELS[name][4])
                simt = f" (the SIMT kernel it replaced {simt_ms:.5f} ms)"
            print(f"[kernel] {name} {'bf16' if esz == 2 else 'f32'} causal "
                  f"B{B} Hq{HQ} Hkv{HKV} S{S} D{D} ({match[name]}): "
                  f"device: kernel {ms:.5f} ms{simt} ("
                  f"{work[name][1] / ms / 1e9:.1f} TFLOP/s of needed work), "
                  f"plain {plain:.5f} ms, library "
                  f"{lib if lib is None else round(lib, 5)} ms; bound "
                  f"{b_ms:.5f} ms ({b_by}); host clock per call "
                  f"{call:.5f} ms")
            src = f"src/repro_torch/kernels/csrc/{match[name][:-7]}.cu"
            if esz == 4:
                f32_ms[name] = (ms, plain, lib, b_ms, src,
                                simt_ms if simt else None)
                continue
            key = {"flash_attention": "fwd",
                   "flash_attention_bwd_dkv": "dkv",
                   "flash_attention_bwd_dq": "dq"}[name]
            if name in TC_KERNELS:
                src = (f"src/repro_torch/kernels/csrc/"
                       f"{TC_KERNELS[name][0]}.cu")
            rows[name] = dict(
                source=src,
                replaces="src/repro/kernels/flash_attention.py:" + {
                    "fwd": "161", "dkv": "599", "dq": "639"}[key],
                max_abs_err=errs[key], ms=ms, plain_ms=plain, call_ms=call,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library_call={
                    "fwd": "F.scaled_dot_product_attention(causal, "
                           "enable_gqa) forward"}.get(
                        key, "SDPA's whole backward (all three kernels' "
                             "work)"),
                f32_ms=f32_ms[name][0], f32_plain_ms=f32_ms[name][1],
                f32_library_ms=f32_ms[name][2], f32_bound_ms=f32_ms[name][3],
                f32_source=f32_ms[name][4], f32_simt_ms=f32_ms[name][5])
        del q, k, v, do, o, lse, delta, ql, kl, vl, lo
    # the preprocess is timed in preprocess_checks; its largest error here
    rows[PRE] = dict(max_abs_err=errs["pre"])
    return rows


def _delta_rows(torch, label, o, do, got, want):
    """Each row of delta within its own bound of the plain version ``want``
    (D * 2^-24 * sum_d |O dO| + 1e-30) and of a float64 run (13 * 2^-24 *
    the same); see PRE_ROW_ULPS_F64. Returns the largest share of the row
    bound that a row used."""
    prod = o.double() * do.double()
    mag = prod.abs().sum(-1)
    exact = prod.sum(-1)
    del prod
    unit = 2.0 ** -24
    row_bound = o.shape[-1] * unit * mag + PRE_ROW_ATOL
    err = (got.double() - want.double()).abs()
    bad = int((err > row_bound).sum())
    check(bad == 0, f"{label} delta: {bad} rows past their bound of the "
          f"plain version (largest err / bound "
          f"{float((err / row_bound).max()):.3e})")
    f64_bound = PRE_ROW_ULPS_F64 * unit * mag + PRE_ROW_ATOL
    bad = int(((got.double() - exact).abs() > f64_bound).sum())
    check(bad == 0, f"{label} delta: {bad} rows past their bound of a "
          "float64 run")
    return float((err / row_bound).max())


def _pre_inputs(torch, dev, dtype, b, hq, sq, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, hq, sq, d), generator=g, device=dev)
            .to(getattr(torch, dtype)) for _ in range(2)]


def _bmm_delta(torch, o, do):
    """The library yardstick: delta as one torch.bmm with a float32
    output (bf16 inputs; float32 inputs need no out_dtype)."""
    d = o.shape[-1]
    a, b = o.reshape(-1, 1, d), do.reshape(-1, d, 1)
    if o.dtype == torch.float32:
        return torch.bmm(a, b).reshape(o.shape[:-1])
    return torch.bmm(a, b, out_dtype=torch.float32).reshape(o.shape[:-1])


def preprocess_checks(torch, dev):
    """The flash backward's preprocess: the vec kernel against the plain
    version row by row (:func:`_delta_rows`) and against the outer bound
    flash_checks uses, at every (dtype, D) with ragged row counts and
    grid-stride passes, two runs bitwise equal, every launch that names no
    route on "vec"; then the timed shapes (:data:`PRE_TIMED`), the vec and
    the one-warp-a-row kernel in turns (vec, simt, simt, vec; cold L2),
    the plain version, the bound, one torch.bmm with a float32 output (the
    library call) and a one-row launch (a launch's fixed cost). Returns
    the preprocess's JSON row, headed by the training shape."""
    from repro_torch.kernels import ops, ref
    routes0 = ops.route_counts()[PRE]
    calls, worst, max_err = 0, 0.0, 0.0
    for label, dtype, b, hq, sq, d in PRE_TIMED + PRE_RAGGED:
        o, do = _pre_inputs(torch, dev, dtype, b, hq, sq, d, 11)
        got = ops.flash_attention_bwd_preprocess(o, do)
        again = ops.flash_attention_bwd_preprocess(o, do)
        old = ops._preprocess_card(o, do, "simt")
        want = ref.flash_attention_bwd_preprocess_ref(o, do)
        torch.cuda.synchronize()
        calls += 2
        check(torch.equal(got, again), f"preprocess {label}: two runs "
              "differ")
        check(bool(torch.isfinite(got).all()), f"preprocess {label}: "
              "non-finite")
        err = _err(got, want)
        tol = FLASH_ATOL_F32 * (1.0 if dtype == "float32" else
                                max(1.0, float(want.abs().max())))
        check(err <= tol, f"preprocess {label}: max err {err:.3e} > "
              f"{tol:.3e}")
        share = _delta_rows(torch, f"preprocess {label}", o, do, got, want)
        _delta_rows(torch, f"preprocess {label} (simt)", o, do, old, want)
        worst = max(worst, share)
        if label == "train":
            max_err = err
        print(f"[kernel] preprocess {label} ({dtype}, {b * hq * sq} rows, "
              f"D {d}): vec max err {err:.2e} (simt {_err(old, want):.2e}), "
              f"largest share of a row's bound {share:.3e}; bitwise "
              "repeatable")
        del o, do, got, again, old, want
    grew = {r: n - routes0[r] for r, n in ops.route_counts()[PRE].items()}
    n_cases = len(PRE_TIMED) + len(PRE_RAGGED)
    check(grew == {"vec": calls, "simt": n_cases}, f"preprocess: launches "
          f"by route {grew} != {{'vec': {calls}, 'simt': {n_cases}}}")
    # a launch's fixed cost: one bf16 row, cold L2
    o, do = _pre_inputs(torch, dev, "bfloat16", 1, 1, 1, D, 12)
    one_row = {r: device_ms(lambda: ops._preprocess_card(o, do, r),
                            PRE_NAMES[r]) for r in PRE_NAMES}
    print("[kernel] preprocess at one bf16 row (cold L2): " + ", ".join(
        f"{r} {t:.5f} ms" for r, t in one_row.items()))

    cases = {}
    for label, dtype, b, hq, sq, d in PRE_TIMED:
        o, do = _pre_inputs(torch, dev, dtype, b, hq, sq, d, 12)
        new_fn = (lambda: ops.flash_attention_bwd_preprocess(o, do))
        old_fn = (lambda: ops._preprocess_card(o, do, "simt"))
        dev_ms = {"vec": [], "simt": []}
        for route, fn in (("vec", new_fn), ("simt", old_fn),
                          ("simt", old_fn), ("vec", new_fn)):
            dev_ms[route].append(device_ms(fn, PRE_NAMES[route]))
        ms, old_ms = (sum(dev_ms[r]) / 2 for r in ("vec", "simt"))
        plain = device_ms(
            lambda: ref.flash_attention_bwd_preprocess_ref(o, do), None,
            iters=20)
        lib_err = _err(_bmm_delta(torch, o, do),
                       ref.flash_attention_bwd_preprocess_ref(o, do))
        lib = device_ms(lambda: _bmm_delta(torch, o, do), None, iters=20)
        rows = b * hq * sq
        esz = 2 if dtype == "bfloat16" else 4
        nbytes = 2 * rows * d * esz + 4 * rows
        b_ms, b_by = bound(nbytes, 2 * rows * d, F32_FLOPS_PER_S)
        cases[label] = dict(rows=rows, dtype=dtype, head_dim=d, ms=ms,
                            old_ms=old_ms, ms_turns=dev_ms["vec"],
                            old_ms_turns=dev_ms["simt"], plain_ms=plain,
                            library_ms=lib, library_max_abs_err=lib_err,
                            call_ms=time_ms(new_fn), bound_ms=b_ms,
                            bound_by=b_by, share_of_bound=b_ms / ms)
        print(f"[kernel] preprocess {label} ({dtype}, B{b} Hq{hq} S{sq} "
              f"D{d}, {rows} rows) device (turns vec, simt, simt, vec): "
              f"vec {dev_ms['vec'][0]:.5f}/{dev_ms['vec'][1]:.5f} ms, simt "
              f"{dev_ms['simt'][0]:.5f}/{dev_ms['simt'][1]:.5f} ms "
              f"(new/old {ms / old_ms:.3f}), plain {plain:.5f} ms, library "
              f"(torch.bmm, float32 out) {lib:.5f} ms (max err vs plain "
              f"{lib_err:.2e}); bound {b_ms:.5f} ms ({b_by}): vec "
              f"{100 * b_ms / ms:.1f}% of it, simt "
              f"{100 * b_ms / old_ms:.1f}%; past the one-row launch (vec "
              f"{one_row['vec']:.5f} ms) the vec kernel streams "
              f"{nbytes / max(ms - one_row['vec'], 1e-9) / 1e9:.2f} TB/s; "
              f"host clock per call {cases[label]['call_ms']:.5f} ms")
        del o, do
    head = cases["train"]
    return dict(
        source="src/repro_torch/kernels/csrc/flash_bwd_preprocess_vec.cu",
        simt_source="src/repro_torch/kernels/csrc/flash_bwd_preprocess.cu",
        replaces="src/repro/kernels/flash_attention.py:579",
        max_abs_err=max_err, library_call=PREPROCESS_LIBRARY_NOTE,
        headline=f"bf16, B {B}, Hq {HQ}, S {S}, D {D}",
        largest_row_bound_share=worst, one_row_ms=one_row,
        **{k: head[k] for k in ("ms", "old_ms", "plain_ms", "library_ms",
                                "call_ms", "bound_ms", "bound_by")},
        cases=cases)


def _lib_report(stem):
    """(HGMMA instructions in the SASS, registers a kernel, spill stores +
    loads a kernel) of a built library, from cuobjdump and ptxas."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import build
    rep = build.build_report[stem]
    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", rep["path"]],
        capture_output=True, text=True, timeout=300).stdout
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", rep["log"])]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", rep["log"])]
    return sass.count("HGMMA"), regs, spills


def tc_report():
    """The tensor-core kernels as built: each library's SASS must hold
    HGMMA (wgmma) instructions; their registers and spills from ptxas and
    their dynamic shared memory. The paged libraries likewise (HGMMA
    required of the prefill's, which runs wgmma). Returns {wrapper:
    report}."""
    from repro_torch.kernels import build
    out = {}
    for name, (stem, smem_fn, args, kname, _) in TC_KERNELS.items():
        hgmma, regs, spills = _lib_report(stem)
        check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in its SASS")
        rep = build.build_report[stem]
        smem = getattr(ctypes.CDLL(rep["path"]), smem_fn)(*args)
        out[name] = dict(hgmma=hgmma, registers=regs, spill_bytes=spills,
                         dynamic_smem_bytes=smem)
        print(f"[build] {kname} ({stem}.cu): {hgmma} HGMMA instructions in "
              f"its SASS; ptxas: registers {regs or 'not rebuilt'} a thread "
              f"at launch, spill stores + loads {spills or 'not rebuilt'} "
              f"bytes; {smem} bytes of dynamic shared memory a CTA")
    for name, (stem, smem_fn, kname) in TF32_KERNELS.items():
        hgmma, regs, spills = _lib_report(stem)
        check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in its SASS")
        rep = build.build_report[stem]
        smem = getattr(ctypes.CDLL(rep["path"]), smem_fn)()
        serial = rep["log"].count("serialized")
        out[f"{name}/tf32x3"] = dict(hgmma=hgmma, registers=regs,
                                     spill_bytes=spills,
                                     dynamic_smem_bytes=smem,
                                     serialized_wgmma=serial)
        print(f"[build] {kname} ({stem}.cu): {hgmma} HGMMA instructions in "
              f"its SASS; ptxas: registers {regs or 'not rebuilt'} a thread, "
              f"spill stores + loads {spills or 'not rebuilt'} bytes; "
              f"{smem} bytes of dynamic shared memory a CTA; serialized "
              f"wgmma warnings {serial}")
    for name, (stem, smem_fn, kname) in D128_KERNELS.items():
        hgmma, regs, spills = _lib_report(stem)
        rep = build.build_report[stem]
        smem = getattr(ctypes.CDLL(rep["path"]), smem_fn)()
        serial = rep["log"].count("serialized")       # ptxas C7512, C7514
        ignored = rep["log"].count("C7508")
        check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in its SASS")
        check(not any(spills), f"{stem}: ptxas reports spills {spills}")
        check(serial == 0 and ignored == 0, f"{stem}: ptxas serialized "
              f"wgmma ({serial}) or ignored setmaxnreg ({ignored})")
        out[f"{name}/wgmma128"] = dict(hgmma=hgmma, registers=regs,
                                       spill_bytes=spills,
                                       dynamic_smem_bytes=smem)
        print(f"[build] {kname} ({stem}.cu): {hgmma} HGMMA instructions in "
              f"its SASS; ptxas: registers {regs or 'not rebuilt'} a thread "
              f"at launch (consumers 240 by setmaxnreg), spill stores + "
              f"loads {spills or 'not rebuilt'} bytes, serialized wgmma "
              f"{serial}, ignored setmaxnreg {ignored}; {smem} bytes of "
              f"dynamic shared memory a CTA")
    for name, (stem, kname, wgmma) in PAGED_LIBS.items():
        if stem not in build.build_report:
            continue
        hgmma, regs, spills = _lib_report(stem)
        check(hgmma > 0 or not wgmma, f"{stem}: no HGMMA (wgmma) "
              "instruction in its SASS")
        # every decode instantiation also takes the fused append
        check(wgmma or not any(spills), f"{stem}: ptxas reports spills "
              f"{spills}")
        out[name] = dict(hgmma=hgmma, registers=regs, spill_bytes=spills)
        print(f"[build] {kname} ({stem}.cu): {hgmma} HGMMA instructions in "
              f"its SASS; ptxas: registers {regs or 'not rebuilt'} a thread, "
              f"spill stores + loads {spills or 'not rebuilt'} bytes (one "
              "entry an instantiation)")
    for name, (stem, kname, route) in PAGED128_LIBS.items():
        hgmma, regs, spills = _lib_report(stem)
        out[f"{name}/d128"] = dict(registers=regs, spill_bytes=spills)
        if route == "wgmma128":
            serial = build.build_report[stem]["log"].count("C7514")
            check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in "
                  "its SASS")
            check(not any(spills) and serial == 0, f"{stem}: ptxas "
                  f"reports spills {spills} or serialized wgmma ({serial})")
            out[f"{name}/d128"].update(hgmma=hgmma, serialized_wgmma=serial)
            print(f"[build] {kname} ({stem}.cu): {hgmma} HGMMA "
                  f"instructions in its SASS; ptxas: registers "
                  f"{regs or 'not rebuilt'} a thread, spill stores + loads "
                  f"{spills or 'not rebuilt'} bytes, serialized wgmma "
                  f"{serial} (one entry an instantiation: bf16 and int8 "
                  "pools)")
            continue
        check(not any(spills), f"{stem}: ptxas reports spills {spills}")
        print(f"[build] {kname} ({stem}.cu): ptxas: registers "
              f"{regs or 'not rebuilt'} a thread, spill stores + loads "
              f"{spills or 'not rebuilt'} bytes (one entry an "
              "instantiation: bf16 and int8 pools, groups 1 to 8; each "
              "also takes the fused append)")
    stem = "mlstm_chunked_tc"
    hgmma, regs, spills = _lib_report(stem)
    check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in its SASS")
    rep = build.build_report[stem]
    smem = ctypes.CDLL(rep["path"]).mlstm_chunked_tc_smem()
    serial = rep["log"].count("C7514")
    out["mlstm_chunked"] = dict(hgmma=hgmma, registers=regs,
                                spill_bytes=spills, dynamic_smem_bytes=smem,
                                serialized_instantiations=serial)
    print(f"[build] {MLSTM_NAMES['wgmma']} ({stem}.cu): {hgmma} HGMMA "
          f"instructions in its SASS; ptxas: registers {regs or 'not rebuilt'}"
          f" a thread, spill stores + loads {spills or 'not rebuilt'} bytes "
          f"(one entry an instantiation: DH 64, 128, 256, 512 for float32 "
          f"and bf16); {smem} bytes of dynamic shared memory a CTA; "
          f"{serial} instantiations with serialized wgmma (ptxas C7514)")
    stem = "mlstm_chunked_bwd_tc"
    hgmma, regs, spills = _lib_report(stem)
    check(hgmma > 0, f"{stem}: no HGMMA (wgmma) instruction in its SASS")
    rep = build.build_report[stem]
    lib = ctypes.CDLL(rep["path"])
    smem = [lib.mlstm_chunked_bwd_tc_smem(0), lib.mlstm_chunked_bwd_tc_smem(1)]
    serial = rep["log"].count("C7514")
    out["mlstm_chunked_bwd"] = dict(hgmma=hgmma, registers=regs,
                                    spill_bytes=spills,
                                    dynamic_smem_bytes=smem,
                                    serialized_instantiations=serial)
    print(f"[build] mlstm_bwd_tc kernels ({stem}.cu): {hgmma} HGMMA "
          f"instructions in its SASS; ptxas: registers {regs or 'not rebuilt'}"
          f" a thread, spill stores + loads {spills or 'not rebuilt'} bytes "
          f"(one entry a kernel and instantiation: gates, sweep and chunk at "
          f"DH 64, 128, 256, 512, float32 and bf16); dynamic shared memory "
          f"a CTA: sweep {smem[0]}, chunk {smem[1]} bytes; {serial} "
          f"instantiations with serialized wgmma (ptxas C7514)")
    return out


def dequant_check(torch, cfg, dev):
    """Dequantize bitwise on one ffn.wi leaf's rows (the codec's decode)."""
    from repro_torch.kernels import ops, ref
    m = cfg.num_layers * cfg.d_model * cfg.d_ff // ops.LANES
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randint(-127, 128, (m, ops.LANES), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-3
    scale[::97] = 0.0
    got = ops.dequantize_int8(q, scale)
    want = ref.dequantize_int8_ref(q, scale)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "dequantize differs from the plain version")
    ms, plain, call = timings(lambda: ops.dequantize_int8(q, scale),
                              lambda: ref.dequantize_int8_ref(q, scale),
                              "dequantize_int8_kernel")
    lib = device_ms(lambda: q * scale, None, iters=20)
    b_ms, b_by = bound(m * ops.LANES * (1 + 4) + m * 4, m * ops.LANES,
                       F32_FLOPS_PER_S)
    print(f"[kernel] dequantize_int8: bitwise equal ({m} rows, one ffn.wi "
          f"leaf); device: kernel {ms:.5f} ms, plain {plain:.5f} ms, "
          f"library (q * scale) {lib} ms; bound {b_ms:.5f} ms ({b_by}); "
          f"host clock per call {call:.5f} ms")
    return dict(source="src/repro_torch/kernels/csrc/dequantize.cu",
                replaces="src/repro/kernels/quantize.py:99", max_abs_err=0.0,
                ms=ms, plain_ms=plain, call_ms=call, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, library_call="q * scale")


# ----------------------------------------------------------- LoRA matmul
def _lora_inputs(torch, dev, dtype, m, k, n, r, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    return (rand((m, k), 1.0), rand((k, n), k ** -0.5),
            rand((k, r), k ** -0.5), rand((r, n), 0.1))


def _lora_work(m, k, n, r, esz):
    """(bytes, flops) of one call: each input read once, y written once."""
    return ((m * k + k * n + k * r + r * n + m * n) * esz,
            2 * m * k * n + 2 * m * k * r + 2 * m * r * n)


def _lora_tol(torch, dtype, want):
    peak = float(want.float().abs().max())
    return (LORA_RTOL_F32 if dtype == torch.float32 else BF16_ULP) * peak


def _lora_mma(args, scale):
    """The mma.sync kernel (csrc/lora_matmul.cu) on bf16 operands that the
    wrapper sends to the wgmma kernel: launched directly, uncounted, to
    time the kernel the wgmma route replaced on the same inputs."""
    import torch
    from repro_torch.kernels import build
    x, w, a, b = args
    y = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    err = build.load("lora_matmul")(
        1, x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), x.shape[0], w.shape[1], x.shape[1], a.shape[1],
        *w.stride(), *a.stride(), *b.stride(), scale,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"lora_matmul (mma) launch failed: CUDA error {err}")
    return y


def _lora_route_check(ops, before, want):
    grew = ops.route_counts()["lora_matmul"]
    grew = {r: n - before[r] for r, n in grew.items()}
    check(grew == {**dict.fromkeys(grew, 0), want: 1},
          f"lora_matmul launches by route {grew}, want one on {want}")


def lora_checks(torch, dev):
    """The fused LoRA kernel against its plain version on the card: the
    distill path's three (K, N) shapes at M = 4 x 1032, r = 4, forward and
    the backward's transposed dx layout, bf16 (on the wgmma kernel, with
    the mma.sync kernel it replaced checked and timed beside it) and
    float32, timed with a cold L2 beside the plain version and cuBLAS's
    three-GEMM composition; a ragged case (on the mma.sync kernel: its row
    stride 132 is no multiple of 8) and a rank-16 case; each launch's
    route as ``ops.lora_route`` says; and the autograd wrapper's dx, da
    and db against autograd through the plain version. Returns the
    kernel's JSON row (ffn.wo's bf16 forward as the headline, every shape
    under ``shapes``, one layer's five forward and five dx calls summed
    under ``layer_*``)."""
    from repro_torch.kernels import ops, ref
    scale = 2.0                      # alpha / rank = 2 * 4 / 4 on the path
    max_err = 0.0
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        match = ("lora_wgmma_kernel" if name == "bf16"
                 else "lora_f32_kernel")
        route = "wgmma" if name == "bf16" else "simt"
        esz = 2 if name == "bf16" else 4
        rate = BF16_FLOPS_PER_S if name == "bf16" else F32_FLOPS_PER_S
        for label, k, n in LORA_SHAPES:
            x, w, a, b = _lora_inputs(torch, dev, dtype, LORA_M, k, n, RANK,
                                      11)
            g = _lora_inputs(torch, dev, dtype, LORA_M, n, 1, 1, 12)[0]
            for layout, args, dims in (
                    ("forward", (x, w, a, b), (k, n)),
                    ("dx", (g, w.T, b.T, a.T), (n, k))):
                before = ops.route_counts()["lora_matmul"]
                got = ops.lora_matmul(*args, scale=scale)
                want = ref.lora_matmul_ref(*args, scale=scale)
                torch.cuda.synchronize()
                _lora_route_check(ops, before, route)
                check(bool(torch.isfinite(got).all()),
                      f"lora {name} {label} {layout}: non-finite")
                err, tol = _err(got, want), _lora_tol(torch, dtype, want)
                check(err <= tol, f"lora {name} {label} {layout}: max err "
                      f"{err:.3e} > {tol:.3e}")
                mma_ms = mma_err = None
                if name == "bf16":
                    max_err = max(max_err, err)
                    mma_err = _err(_lora_mma(args, scale), want)
                    check(mma_err <= tol, f"lora mma {label} {layout}: max "
                          f"err {mma_err:.3e} > {tol:.3e}")
                    mma_ms = device_ms(lambda: _lora_mma(args, scale),
                                       "lora_mma_kernel")
                xx, ww, aa, bb = args
                ms, plain, call = timings(
                    lambda: ops.lora_matmul(*args, scale=scale),
                    lambda: ref.lora_matmul_ref(*args, scale=scale), match)
                lib = device_ms(lambda: xx @ ww + scale * ((xx @ aa) @ bb),
                                None, iters=20)
                b_ms, b_by = bound(*_lora_work(LORA_M, *dims, RANK, esz),
                                   rate)
                shapes.append(dict(dtype=name, shape=label, layout=layout,
                                   m=LORA_M, k=dims[0], n=dims[1], r=RANK,
                                   route=route, max_abs_err=err, ms=ms,
                                   mma_ms=mma_ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=b_ms,
                                   bound_by=b_by, call_ms=call))
                old = ("" if mma_ms is None else
                       f", the mma.sync kernel {mma_ms:.5f} ms (max|err| "
                       f"{mma_err:.3e})")
                print(f"[kernel] lora_matmul {name} {label} {layout} "
                      f"(M {LORA_M}, K {dims[0]}, N {dims[1]}, r {RANK}): "
                      f"route {route}, max|err| {err:.3e} (atol "
                      f"{tol:.3e}); device: kernel {ms:.5f} ms "
                      f"({_lora_work(LORA_M, *dims, RANK, esz)[1] / ms / 1e9:.1f}"
                      f" TFLOP/s){old}, plain {plain:.5f} ms, cuBLAS "
                      f"x@w + s*((x@a)@b) (three GEMMs) {lib} ms; bound "
                      f"{b_ms:.5f} ms ({b_by}); host clock per call "
                      f"{call:.5f} ms")
            del x, w, a, b, g
        # ragged edges and the largest rank, checked only
        for label, (m, k, n, r) in (("ragged", (1000, 96, 132, 8)),
                                    ("rank 16", (LORA_M, 1024, 1024, 16))):
            x, w, a, b = _lora_inputs(torch, dev, dtype, m, k, n, r, 13)
            g = _lora_inputs(torch, dev, dtype, m, n, 1, 1, 14)[0]
            for layout, args in (("forward", (x, w, a, b)),
                                 ("dx", (g, w.T, b.T, a.T))):
                want_route = ops.lora_route(dtype, args[0].shape,
                                            args[1].stride())
                check(want_route == ("wgmma" if name == "bf16"
                                     and label == "rank 16" else "simt"),
                      f"lora {name} {label} {layout}: route {want_route}")
                before = ops.route_counts()["lora_matmul"]
                got = ops.lora_matmul(*args, scale=scale)
                want = ref.lora_matmul_ref(*args, scale=scale)
                torch.cuda.synchronize()
                _lora_route_check(ops, before, want_route)
                err, tol = _err(got, want), _lora_tol(torch, dtype, want)
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"lora {name} {label} {layout}: max err {err:.3e} > "
                      f"{tol:.3e}")
                print(f"[kernel] lora_matmul {name} {label} {layout} "
                      f"(M {m}, K {k}, N {n}, r {r}): route {want_route}, "
                      f"max|err| {err:.3e} (atol {tol:.3e})")
    # the autograd wrapper: dx through the kernel, da and db in float32
    for dtype in (torch.float32, torch.bfloat16):
        x, w, a, b = _lora_inputs(torch, dev, dtype, LORA_M, 4096, 1024,
                                  RANK, 15)
        g = _lora_inputs(torch, dev, dtype, LORA_M, 1024, 1, 1, 16)[0]
        grads = []
        for fn in (ops.lora_matmul_ad,
                   lambda *t, scale: ref.lora_matmul_ref(*t, scale=scale)):
            leaves = [t.detach().clone().requires_grad_() for t in (x, a, b)]
            y = fn(leaves[0], w, leaves[1], leaves[2], scale=scale)
            grads.append(torch.autograd.grad(y, leaves, g))
        for label, got, want in zip(("dx", "da", "db"), *grads):
            err, tol = _err(got, want), _lora_tol(torch, dtype, want)
            check(err <= tol, f"lora_matmul_ad {dtype} {label}: max err "
                  f"{err:.3e} > {tol:.3e}")
            print(f"[kernel] lora_matmul_ad {dtype} ffn.wo {label}: max|err| "
                  f"{err:.3e} (atol {tol:.3e})")
        del x, w, a, b, g, grads
    head = next(r for r in shapes if r["dtype"] == "bf16"
                and r["shape"] == "ffn.wo" and r["layout"] == "forward")
    per_layer = {"wq/attn.wo": 2, "wk/wv": 2, "ffn.wo": 1}
    layer = {key: sum(per_layer[r["shape"]] * r[key] for r in shapes
                      if r["dtype"] == "bf16")
             for key in ("ms", "mma_ms", "plain_ms", "library_ms",
                         "bound_ms")}
    print(f"[kernel] lora_matmul bf16, one layer's 5 forward + 5 dx calls: "
          f"kernel {layer['ms']:.5f} ms, the mma.sync kernel "
          f"{layer['mma_ms']:.5f} ms, plain {layer['plain_ms']:.5f} ms, "
          f"cuBLAS composition {layer['library_ms']:.5f} ms, bound "
          f"{layer['bound_ms']:.5f} ms")
    return dict(source="src/repro_torch/kernels/csrc/lora_matmul_tc.cu",
                mma_source="src/repro_torch/kernels/csrc/lora_matmul.cu",
                mma_ms=head["mma_ms"],
                replaces="src/repro/kernels/lora_matmul.py:57",
                max_abs_err=max_err, ms=head["ms"], plain_ms=head["plain_ms"],
                call_ms=head["call_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                library_call="x @ w + s * ((x @ a) @ b): a composition of "
                             "three cuBLAS GEMMs, no single PyTorch call",
                headline="bf16 ffn.wo forward, M 4128, K 4096, N 1024, r 4",
                **{f"layer_{k}": v for k, v in layer.items()}, shapes=shapes)


def _leaf_names(tree, prefix=""):
    """Leaf paths in flatten (sorted-key) order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _leaf_names(tree[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def _leaf_sizes(torch, cfg):
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    return [t.numel() for t in leaves(lm.abstract_params(cfg))]


def train_main_path(torch, cfg, dev):
    """Two hier_fl rounds at full width through the launcher; checks the
    launch counts, losses, moved params and wire metrics. The codec's
    quantize launches are also counted by leaf: the bits source names the
    leaf it draws words for, and the int8 encode that follows adds the
    growth of the wrapper's count to that leaf."""
    import math
    from repro_torch.comm import codecs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    sizes = _leaf_sizes(torch, cfg)
    leaf_names = _leaf_names(lm.abstract_params(cfg))
    by_leaf = dict.fromkeys(leaf_names, 0)
    drawn = []
    bits_call, encode = codecs.GeneratorBits.__call__, codecs.Int8Codec.encode

    def recording_bits(self, leaf, client, shape):
        drawn.append(leaf)
        return bits_call(self, leaf, client, shape)

    def recording_encode(self, flat, bits):
        leaf = drawn.pop()
        check(not drawn and flat.numel() == sizes[leaf],
              f"int8 encode of {flat.numel()} elements after words for "
              f"leaf {leaf} ({sizes[leaf]} elements)")
        n = ops.quantize_int8.launches
        payload = encode(self, flat, bits)
        by_leaf[leaf_names[leaf]] += ops.quantize_int8.launches - n
        return payload

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    codecs.GeneratorBits.__call__ = recording_bits
    codecs.Int8Codec.encode = recording_encode
    try:
        t0 = time.perf_counter()
        out = launch.main(TRAIN_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        codecs.GeneratorBits.__call__ = bits_call
        codecs.Int8Codec.encode = encode
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = ROUNDS * CLIENTS * LOCAL_STEPS * cfg.num_layers
    codec = ROUNDS * CLIENTS * len(sizes)
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=steps, flash_attention_bwd_preprocess=steps,
                flash_attention_bwd_dkv=steps, flash_attention_bwd_dq=steps,
                quantize_int8=codec, dequantize_int8=codec)
    check(counts == want, f"training launches {counts} != {want}")
    check(by_leaf == dict.fromkeys(leaf_names, ROUNDS * CLIENTS),
          f"quantize launches by leaf {by_leaf}: not {ROUNDS} rounds x "
          f"{CLIENTS} clients each")
    routes = check_routes(ops, counts, "training", (*TC_KERNELS, PRE))
    hist = out["history"]
    check(len(hist) == ROUNDS, "one history entry per round")
    for h in hist:
        check(bool(np.isfinite(h["per_client/loss"]).all()),
              f"non-finite loss in round {h['round']}")
    # the topology's formulas, computed here from the leaf sizes
    per_client = sum(n + 4 * -(-n // 128) for n in sizes)
    arrivals = [per_client / NANO_BPS + per_client / BACKHAUL_BPS
                + BACKHAUL_S,
                per_client / AGX_BPS + per_client / BACKHAUL_BPS
                + BACKHAUL_S]
    for h in hist:
        check(h["comm_bytes_up"] == CLIENTS * per_client,
              f"comm_bytes_up {h['comm_bytes_up']} != "
              f"{CLIENTS * per_client}")
        check(h["comm_bytes_backhaul"] == 2 * per_client,
              f"comm_bytes_backhaul {h['comm_bytes_backhaul']}")
        check(math.isclose(h["sim_round_s"], max(arrivals), rel_tol=1e-12),
              f"sim_round_s {h['sim_round_s']} != {max(arrivals)}")
    # every weight matrix moves; the bf16 norm scales stay at 1.0, since
    # each step's update (at most lr = 1e-3) is under half a bf16 ulp there
    with torch.no_grad():
        merged = leaves(out["session"].merged_params())
        init = leaves(lm.init(cfg, seed=0, device=dev).to_dict())
        moved = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(merged, init)]
        check(all(bool(torch.isfinite(t).all()) for t in merged),
              "non-finite global params")
    names = _leaf_names(out["session"].merged_params())
    check(all(m > 0 for m, n in zip(moved, names) if not n.endswith("scale")),
          f"a weight matrix did not move: {dict(zip(names, moved))}")
    tokens = ROUNDS * CLIENTS * LOCAL_STEPS * B * S
    print(f"[train] hier_fl {ROUNDS} rounds x {CLIENTS} clients x "
          f"{LOCAL_STEPS} local steps at {S}x{B}, int8 uplinks: wall "
          f"{wall:.1f} s incl. set-up ({tokens / wall:.0f} tokens/s); "
          f"losses by round "
          + ", ".join(f"{np.mean(h['per_client/loss']):.4f}" for h in hist)
          + f"; peak device memory {peak:.1f} GiB; wire per round: up "
          f"{per_client * CLIENTS} B, backhaul {2 * per_client} B, "
          f"sim {max(arrivals):.4f} s; largest change per leaf "
          + ", ".join(f"{m:.2e}" for m in moved) + f"; launches {counts}; "
          f"flash launches by route {routes}; quantize launches by leaf "
          f"{by_leaf}")
    del out, merged, init
    torch.cuda.empty_cache()
    return counts, peak, routes, by_leaf


def _async_inputs(torch, dev, vocab, shape):
    """(codec bits, round batches) shared by the hier_fl and async runs:
    the words of round/wave r, leaf i, client c from a generator seeded by
    (r, i, c), so both strategies get the same words however they order
    their draws; round/wave r's [C, E, B, S] batch from one seeded by r."""
    def bits(r, leaf, client, shp):
        gen = torch.Generator(device=dev)
        gen.manual_seed((r * 1000 + leaf) * 100 + client + 7)
        return torch.randint(-2 ** 31, 2 ** 31, tuple(shp), generator=gen,
                             dtype=torch.int32, device=dev).view(
                                 torch.uint32)

    def batch(r):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + r)
        return {k: torch.randint(0, vocab, (CLIENTS, LOCAL_STEPS,
                                            shape.global_batch,
                                            shape.seq_len), generator=gen,
                                 dtype=torch.int32, device=dev)
                for k in ("tokens", "labels")}
    return bits, batch


def _free(torch):
    """Collect dropped sessions' cycles, then return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _trace_kernels(path):
    """{name: launches} of the device kernels in a torch.profiler Chrome
    trace, and (busy us, span us): the kernels' summed durations and the
    time from the first kernel's start to the last one's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    names = {}
    for e in kern:
        names[e["name"]] = names.get(e["name"], 0) + 1
    if not kern:
        return names, 0.0, 0.0
    busy = sum(float(e["dur"]) for e in kern)
    span = (max(float(e["ts"]) + float(e["dur"]) for e in kern)
            - min(float(e["ts"]) for e in kern))
    return names, busy, span


def async_main_path(torch, cfg, dev, shape=None):
    """Step 5b: async_hier_fl of flad-adllm at full width and depth, int8
    uplinks over TOPOLOGY, LOCAL_STEPS local steps of B x S tokens:
      * sync: clock=None, one merge from the state a hier_fl Session
        inits; its global params must equal one hier_fl round's from the
        same state, batches and codec bits, bitwise;
      * async: the merge clock at half the sync run's simulated merge
        time, compute jitter ASYNC_JITTER, a mobility step every half
        clock on ASYNC_MOBILITY's grid, ASYNC_MERGES merges traced into
        OUT/async_trace.json: at least one merge of fewer than CLIENTS
        vehicles, at least one pod migration, the trace valid; an
        untraced rerun's params and event log bitwise the traced run's;
      * profile: one more merge under profiled(ProfileOptions(...)),
        whose exported trace must name the flash and codec kernels; its
        device busy and idle share.
    Each run's launches are exact: every vehicle a wave trains runs
    LOCAL_STEPS steps of the model's layers, one launch of each flash
    kernel a layer and step (all on the wgmma route, the preprocess on
    vec), and one quantize and one dequantize a leaf. Returns (launches
    summed over the async runs, flash launches by route, summary)."""
    from repro_torch.api import LoopHooks, Session
    from repro_torch.comm.events import MobilitySpec
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import ProfileOptions
    from repro_torch.obs.validate import validate_file
    from repro_torch.tree import leaves
    shape = shape or ShapeConfig("cli", S, B, "train")
    OUT.mkdir(parents=True, exist_ok=True)
    n_leaves = len(_leaf_sizes(torch, cfg))
    bits, batch = _async_inputs(torch, dev, cfg.vocab_size, shape)
    quiet = LoopHooks(log_every=1, log_fn=lambda *a, **k: None)
    common = dict(cfg=cfg, shape=shape, topology=TOPOLOGY, codec="int8",
                  local_steps=LOCAL_STEPS, device=dev, codec_bits=bits)
    totals = dict.fromkeys(ops.launch_counts(), 0)
    routes = {fn: dict.fromkeys(ops.route_counts()[fn], 0)
              for fn in (*TC_KERNELS, PRE)}
    flash = (*FLASH_NAMES,)

    def counted(ses, label, fn):
        """Run fn() with the counts from zero; check them against the
        engine's waves; add them to the totals."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        trained = sum(map(len, ses.strategy.engine.wave_members))
        want = dict.fromkeys(counts, 0)
        want.update({f: trained * LOCAL_STEPS * cfg.num_layers
                     for f in flash})
        want.update(quantize_int8=trained * n_leaves,
                    dequantize_int8=trained * n_leaves)
        check(counts == want, f"async {label}: launches {counts} != {want} "
              f"({trained} trained vehicles)")
        by_route = check_routes(ops, counts, f"async {label}",
                                (*TC_KERNELS, PRE))
        for fn_name in routes:
            for r, n in by_route[fn_name].items():
                routes[fn_name][r] += n
        for name in totals:
            totals[name] += counts[name]
        return out, wall, trained

    # sync: one hier_fl round, then the engine with no clock
    hier = Session(strategy="hier_fl", **common)
    _, state0 = hier.build()
    hier.run(1, state=state0, batches=batch, hooks=quiet)
    want = [x[0].clone() for x in leaves(hier.state[0])]
    del hier
    _free(torch)
    ses = Session(strategy="async_hier_fl", **common)
    out, sync_wall, _ = counted(ses, "sync", lambda: ses.run(
        1, state=state0, batches=batch, hooks=quiet))
    t_sync = out["sim_time_s"]
    got = leaves(ses.merged_params())
    check(ses.strategy.engine.wave_members == [tuple(range(CLIENTS))],
          f"sync waves {ses.strategy.engine.wave_members}")
    same = sum(bool(torch.equal(a, b)) for a, b in zip(got, want))
    check(same == len(want), f"sync async_hier_fl: {len(want) - same} of "
          f"{len(want)} leaves differ from one hier_fl round's")
    print(f"[async] sync (clock=None): 1 merge at sim {t_sync:.4f} s in "
          f"{sync_wall:.2f} s wall; global params bitwise one hier_fl "
          f"round's ({same}/{len(want)} leaves)")
    del ses, out, got, want
    _free(torch)

    # async: a clock, jitter, migrations; traced, then untraced
    clock = 0.5 * t_sync
    opts = dict(clock=clock, compute_jitter=ASYNC_JITTER,
                migrate_every=0.5 * clock,
                mobility=MobilitySpec(**ASYNC_MOBILITY))
    path = str(OUT / "async_trace.json")
    runs = []
    for trace in (path, None):
        torch.cuda.reset_peak_memory_stats()
        ses = Session(strategy="async_hier_fl", **common, **opts)
        out, wall, trained = counted(
            ses, "traced" if trace else "untraced", lambda: ses.run(
                ASYNC_MERGES, state=state0, batches=batch, hooks=quiet,
                trace=trace))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs.append((ses if trace is None else None, out, wall, trained,
                     peak, [x.clone() for x in leaves(ses.merged_params())]))
        if trace is not None:
            del ses, out
            _free(torch)
    (_, o1, wall, trained, peak, p1), (ses, o2, wall2, _, _, p2) = runs
    del runs
    check(o1["event_log"] == o2["event_log"], "async: the untraced rerun's "
          "event log differs from the traced run's")
    same = sum(bool(torch.equal(a, b)) for a, b in zip(p1, p2))
    check(same == len(p1), f"async: {len(p1) - same} leaves of the "
          "untraced rerun differ from the traced run's")
    errors = validate_file(path)
    check(not errors, f"async trace: {errors[:3]}")
    hist = o1["history"]
    vehicles = [int(h["n_vehicles"]) for h in hist]
    kinds = [e[0] for e in o1["event_log"]]
    check(o1["merges"] == ASYNC_MERGES, f"merges {o1['merges']}")
    check(min(vehicles) < CLIENTS, f"every merge covered all vehicles: "
          f"{vehicles}")
    check("pod_migration" in kinds, "no pod migration in the async run")
    check(all(bool(torch.isfinite(x.float()).all()) for x in p1),
          "non-finite global params")
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    waves = [len(m) for m in ses.strategy.engine.wave_members]
    summary = dict(
        sync_sim_s=t_sync, sync_wall_s=sync_wall, clock_s=clock,
        merges=o1["merges"], vehicles_a_merge=vehicles,
        staleness_mean=[h["staleness_mean"] for h in hist],
        lag_max=[h["lag_max"] for h in hist],
        sim_time_s=o1["sim_time_s"], wall_s=wall, rerun_wall_s=wall2,
        waves=waves, trained_vehicles=trained,
        migrations=kinds.count("pod_migration"),
        edge_flushes=kinds.count("edge_flush"), events=len(kinds),
        trace_events=n_events, peak_gib=peak)
    print(f"[async] clock {clock:.4f} s, jitter {ASYNC_JITTER}, mobility "
          f"every {0.5 * clock:.4f} s on {ASYNC_MOBILITY}: {o1['merges']} "
          f"merges of {vehicles} vehicles, observed staleness (mean a "
          f"merge) {summary['staleness_mean']}, lag {summary['lag_max']}, "
          f"{summary['migrations']} pod migration(s), "
          f"{summary['edge_flushes']} edge flushes; waves {waves} "
          f"({trained} vehicle trainings); sim {o1['sim_time_s']:.4f} s in "
          f"{wall:.2f} s wall (untraced rerun {wall2:.2f} s, bitwise the "
          f"same params and event log); peak device memory {peak:.2f} GiB; "
          f"trace {path}: {n_events} events, valid")
    del o1, o2, p1, p2
    _free(torch)

    # one more merge under the profiler
    opts_p = ProfileOptions(trace_dir=str(OUT / "async_profile"))
    out, pwall, ptrained = counted(ses, "profiled", lambda: ses.run(
        1, batches=batch, hooks=quiet, profile=opts_p))
    names, busy, span = _trace_kernels(out["profile_path"])
    need = [TC_KERNELS[f][3] for f in TC_KERNELS if f != "lora_matmul"] + [
        PRE_NAMES["vec"], "quantize_int8_kernel", "dequantize_int8_kernel"]
    missing = [n for n in need if not any(n in k for k in names)]
    check(not missing, f"the profiled merge's trace names none of "
          f"{missing}")
    summary.update(profile_path=out["profile_path"], profile_wall_s=pwall,
                   profile_trained=ptrained, device_busy_ms=busy / 1e3,
                   device_span_ms=span / 1e3,
                   idle_share=1.0 - busy / span if span else 1.0,
                   profile_kernels={n: c for n, c in names.items()
                                    if any(x in n for x in need)})
    print(f"[async] profiled merge ({ptrained} vehicle trainings, "
          f"{out['merges']} merge): {pwall:.2f} s wall under the profiler; "
          f"device busy {busy / 1e3:.3f} ms of the {span / 1e3:.3f} ms from "
          f"its first kernel to its last (idle "
          f"{100 * summary['idle_share']:.1f}%); {out['profile_path']} "
          f"names " + ", ".join(f"{n} x{c}" for n, c in
                                summary["profile_kernels"].items()))
    del ses, out, state0
    _free(torch)
    return totals, routes, summary


def traced_serving(torch, cfg, params, dev, plain):
    """The serving path's fleet trace (bf16 cache) with its final warm
    pass traced into OUT/serve_trace.json: the streams must equal the
    untraced run's (``plain``) bitwise, the launches the untraced run's
    formula, the file must validate, with one queued and one decode span a
    request. Returns (launch counts, summary)."""
    from repro_torch.kernels import ops
    from repro_torch.obs.validate import validate_file
    OUT.mkdir(parents=True, exist_ok=True)
    path = str(OUT / "serve_trace.json")
    ops.reset_launch_counts()
    rep = _serve_trace(cfg, params, dev, "fp32", trace=path)
    counts = ops.launch_counts()
    L = cfg.num_layers
    want = dict.fromkeys(counts, 0)
    want.update({FUSED: 2 * L * rep["decode_steps"],
                 "paged_prefill_attention": 2 * L * rep["prefill_chunks"]})
    check(counts == want, f"traced serving: launches {counts} != {want}")
    check(rep["sequences"] == plain["sequences"], "traced serving: the "
          "streams differ from the untraced run's")
    errors = validate_file(path)
    check(not errors, f"serve trace: {errors[:3]}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    check(spans.get("queued") == spans.get("decode") == rep["requests"],
          f"serve trace spans {spans}")
    summary = dict(path=path, events=len(events), spans=spans,
                   warm_tokens_per_s=rep["warm_tokens_per_s"],
                   untraced_warm_tokens_per_s=plain["warm_tokens_per_s"])
    print(f"[serve] traced warm pass (bf16 cache): streams bitwise the "
          f"untraced run's, {len(events)} trace events ({spans}), valid; "
          f"warm {rep['warm_tokens_per_s']:.1f} tok/s traced against "
          f"{plain['warm_tokens_per_s']:.1f} untraced; launches {counts}")
    return counts, summary


def _factor_sizes(torch, cfg):
    """Per-client element counts of the factor leaves, flatten order."""
    from repro_torch.distill.celladapt import adllm_config, init_adllm
    from repro_torch.distill.lora import LoRAConfig, init_lora
    from repro_torch.tree import leaves
    acfg = adllm_config(cfg, feature_dim=FEATURES, feature_tokens=PREFIX,
                        num_waypoints=WAYPOINTS)
    tree = init_lora(init_adllm(acfg, device="meta"),
                     LoRAConfig(rank=RANK, alpha=2.0 * RANK))
    return [t.numel() for t in leaves(tree)]


def distill_main_path(torch, cfg, dev):
    """Two distill_fl rounds at full width through the launcher; checks
    the exact launch counts, finite losses, the base bitwise unchanged,
    every factor B moved and the wire metrics over the factor tree."""
    import math
    from repro_torch.api.strategies import DistillFLStrategy
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.tree import flatten, leaves, tree_map
    snap = {}
    init = DistillFLStrategy.init

    def recording_init(self, *args, **kw):
        state = init(self, *args, **kw)
        snap["base"] = tree_map(lambda t: t.clone(), state[0]["base"])
        return state

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    DistillFLStrategy.init = recording_init
    try:
        t0 = time.perf_counter()
        out = launch.main(DISTILL_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DistillFLStrategy.init = init
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_layers
    steps = ROUNDS * CLIENTS * LOCAL_STEPS
    want = dict.fromkeys(counts, 0)
    # warmup: forward + backward of the whole model; a local step: the
    # teacher and the student forward, the student's backward; the
    # student's 5 adapted projections a layer launch the LoRA kernel
    # forward and for dx, except layer 0's wq/wk/wv, whose input (the
    # frozen embeddings) needs no grad
    bwd = WARMUP * L + steps * L
    want.update(flash_attention=WARMUP * L + 2 * steps * L,
                flash_attention_bwd_preprocess=bwd,
                flash_attention_bwd_dkv=bwd, flash_attention_bwd_dq=bwd,
                quantize_int8=ROUNDS * CLIENTS * FACTOR_LEAVES,
                dequantize_int8=ROUNDS * CLIENTS * FACTOR_LEAVES,
                lora_matmul=steps * (5 * L + 5 * L - 3))
    check(counts == want, f"distill launches {counts} != {want}")
    routes = check_routes(ops, counts, "distillation", (*TC_KERNELS, PRE))
    hist = out["history"]
    check(len(hist) == ROUNDS, "one history entry per round")
    for h in hist:
        for key in ("loss", "task_l1", "kd_l1", "kd_kl"):
            check(bool(np.isfinite(h[f"per_client/{key}"]).all()),
                  f"non-finite {key} in round {h['round']}")
    session = out["session"]
    base, factors = session.state[0]["base"], session.state[0]["factors"]
    same = [torch.equal(a, b) for a, b in zip(leaves(snap["base"]),
                                              leaves(base))]
    check(all(same), "the frozen base changed during the rounds")
    flat, spec = flatten(factors)
    names = _leaf_names(factors)
    check(len(flat) == FACTOR_LEAVES, f"factor leaves {names}")
    b_moved = {n: float(t.abs().max()) for n, t in zip(names, flat)
               if n.endswith(".B")}
    check(all(v > 0 for v in b_moved.values()),
          f"a factor B did not move: {b_moved}")
    check(all(bool(torch.isfinite(t).all()) for t in flat),
          "non-finite factors")
    sizes = _factor_sizes(torch, cfg)
    per_client = sum(n + 4 * -(-n // 128) for n in sizes)
    arrivals = [per_client / NANO_BPS + per_client / BACKHAUL_BPS
                + BACKHAUL_S,
                per_client / AGX_BPS + per_client / BACKHAUL_BPS
                + BACKHAUL_S]
    for h in hist:
        check(h["comm_bytes_up"] == CLIENTS * per_client,
              f"comm_bytes_up {h['comm_bytes_up']} != "
              f"{CLIENTS * per_client}")
        check(h["comm_bytes_backhaul"] == 2 * per_client,
              f"comm_bytes_backhaul {h['comm_bytes_backhaul']}")
        check(math.isclose(h["sim_round_s"], max(arrivals), rel_tol=1e-12),
              f"sim_round_s {h['sim_round_s']} != {max(arrivals)}")
    tokens = steps * B * (S + PREFIX)
    warm = session.strategy.warmup_history
    print(f"[distill] distill_fl {ROUNDS} rounds x {CLIENTS} clients x "
          f"{LOCAL_STEPS} local steps at {S}x{B} (+{PREFIX} prefix "
          f"tokens), rank {RANK}, int8 uplinks, {WARMUP} warmup steps: "
          f"wall {wall:.1f} s incl. set-up and warmup ({tokens / wall:.0f} "
          f"student tokens/s); warmup losses "
          + ", ".join(f"{x:.4f}" for x in warm) + "; by round (mean over "
          "clients) " + "; ".join(
              f"loss {np.mean(h['per_client/loss']):.4f} task_l1 "
              f"{np.mean(h['per_client/task_l1']):.4f} kd_l1 "
              f"{np.mean(h['per_client/kd_l1']):.4f} kd_kl "
              f"{np.mean(h['per_client/kd_kl']):.3e}" for h in hist)
          + f"; base bitwise unchanged; max|B| per leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in b_moved.items())
          + f"; peak device memory {peak:.1f} GiB; wire per round: up "
          f"{per_client * CLIENTS} B, backhaul {2 * per_client} B, sim "
          f"{max(arrivals):.6f} s; launches {counts}; flash launches by "
          f"route {routes}")
    del out, session, base, factors, flat, snap
    torch.cuda.empty_cache()
    return counts, wall, peak, routes


def _distill_setup(torch, cfg, dev, dtype, seed):
    """Full-width AD-LLM base, rank-4 factors with a nonzero B, and one
    client's batch of 4 x 1024 tokens with 8 prefix features."""
    from repro_torch.distill.celladapt import adllm_config, init_adllm
    from repro_torch.distill.lora import LoRAConfig, init_lora
    acfg = adllm_config(cfg.replace(param_dtype=dtype),
                        feature_dim=FEATURES, feature_tokens=PREFIX,
                        num_waypoints=WAYPOINTS)
    base = init_adllm(acfg, seed=seed, device=dev)
    lcfg = LoRAConfig(rank=RANK, alpha=2.0 * RANK)
    factors = init_lora(base, lcfg, seed=seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    for f in _walk_factors(factors):
        f["B"] = torch.randn(f["B"].shape, generator=g, device=dev) * 1e-2
    batch = {"features": torch.randn((B, PREFIX, FEATURES), generator=g,
                                     device=dev),
             "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device=dev, dtype=torch.int32),
             "waypoints": torch.randn((B, WAYPOINTS, 2), generator=g,
                                      device=dev)}
    return acfg, lcfg, base, factors, batch


def _walk_factors(tree):
    if "A" in tree:
        yield tree
        return
    for v in tree.values():
        yield from _walk_factors(v)


def _plain_lora_ad(ref):
    """The plain LoRA matmul under autograd, in place of the kernel."""
    def lora_matmul_ad(x, w, a, b, *, scale=1.0):
        return ref.lora_matmul_ref(x, w, a, b, scale=scale)
    return lora_matmul_ad


def distill_step_vs_plain(torch, cfg, dev):
    """One float32 distill local step at full width (teacher and student
    forwards, the student's backward, Adam on the factors) through the
    kernels and through the plain versions: loss, factor grads, updated
    factors."""
    from repro_torch.distill.federated import (make_student_loss,
                                               make_student_step)
    from repro_torch.kernels import ops, ref
    from repro_torch.train.optimizer import Adam
    from repro_torch.tree import flatten, leaves, unflatten
    acfg, lcfg, base, factors, batch = _distill_setup(torch, cfg, dev,
                                                      "float32", 21)
    loss_fn = make_student_loss(acfg, lcfg)
    opt = Adam(lr=1e-3)
    flat, spec = flatten(factors)

    def run():
        live = [f.detach().requires_grad_() for f in flat]
        loss, _ = loss_fn(unflatten(spec, live), base, batch)
        grads = torch.autograd.grad(loss, live)
        new, st, _ = make_student_step(loss_fn, opt)(
            factors, opt.init(factors), batch, base)
        torch.cuda.synchronize()
        return float(loss.detach()), grads, leaves(new), leaves(st.v)

    ops.reset_launch_counts()
    kernel = run()
    counts = ops.launch_counts()
    check(counts["lora_matmul"] > 0 and counts["flash_attention"] > 0,
          f"the kernel run launched no kernel: {counts}")
    saved = ops.flash_attention_ad, ops.lora_matmul_ad
    ops.flash_attention_ad = _plain_flash_ad(ref)
    ops.lora_matmul_ad = _plain_lora_ad(ref)
    ops.reset_launch_counts()
    try:
        plain = run()
    finally:
        ops.flash_attention_ad, ops.lora_matmul_ad = saved
    check(sum(ops.launch_counts().values()) == 0,
          "the plain run launched a kernel")
    dloss = abs(kernel[0] - plain[0])
    check(dloss <= DISTILL_LOSS_ATOL, f"f32 distill loss differs by {dloss}")
    grad_rel = max(float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(kernel[1], plain[1]))
    check(grad_rel <= STEP_GRAD_RTOL,
          f"f32 distill factor grads differ: {grad_rel}")
    near = total = 0
    worst = worst_near = 0.0
    for a, b, va, vb in zip(kernel[2], plain[2], kernel[3], plain[3]):
        d = (a - b).abs()
        den = torch.minimum(*(torch.where(
            v > 0, torch.sqrt(v / (1 - opt.b2)), torch.inf) for v in (va, vb)))
        flag = den < NEAR_EPS
        near += int(flag.sum())
        total += d.numel()
        worst = max(worst, float(torch.where(flag, 0.0, d).max()))
        worst_near = max(worst_near, float(d.max()))
    check(worst <= STEP_PARAM_ATOL,
          f"f32 distill step: updated factors differ by {worst:.3e}")
    check(worst_near <= 2 * opt.lr,
          f"f32 distill step: near-eps factors differ by {worst_near:.3e}")
    print(f"[distill-step] float32 local step, kernels vs plain versions "
          f"(flash attention and LoRA matmul): loss {kernel[0]:.6f} vs "
          f"{plain[0]:.6f} (|diff| {dloss:.2e}, atol {DISTILL_LOSS_ATOL}); "
          f"factor grads max |diff| / leaf max {grad_rel:.2e} (rtol "
          f"{STEP_GRAD_RTOL}); updated factors max |diff| {worst:.2e} (atol "
          f"{STEP_PARAM_ATOL}) on all but the {near} of {total} near-eps "
          f"elements, those within {worst_near:.2e} (atol {2 * opt.lr}); "
          f"kernel run launches {counts}")
    del kernel, plain, base, factors, flat
    torch.cuda.empty_cache()
    return dloss, grad_rel, worst, near


def profile_distill_step(torch, cfg, dev, steps=3, kernels=None):
    """A bf16 distill local step at full width (one client, 4 x 1024
    tokens + 8 prefix tokens): wall time, tokens/s, device busy share,
    top device ops, the LoRA kernel's share and the tensor-core flash
    kernels' time a launch."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distill.federated import (make_student_loss,
                                               make_student_step)
    from repro_torch.train.optimizer import Adam
    acfg, lcfg, base, factors, batch = _distill_setup(torch, cfg, dev,
                                                      "bfloat16", 31)
    opt = Adam(lr=1e-3)
    step = make_student_step(make_student_loss(acfg, lcfg), opt)
    state = [factors, opt.init(factors)]

    def run(n):
        for _ in range(n):
            state[0], state[1], _ = step(state[0], state[1], batch, base)
        torch.cuda.synchronize()

    run(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:70])
                  for e in prof.key_averages())[::-1]
    busy = sum(r[0] for r in rows)
    lora = sum(r[0] for r in rows if TC_KERNELS["lora_matmul"][3] in r[2])
    flash, split = flash_split(rows)
    tokens = B * (S + PREFIX)
    print(f"[profile] bf16 distill local step, {B}x({S}+{PREFIX}) tokens, "
          f"rank {RANK}: wall {wall:.3f} ms, {tokens / wall * 1e3:.0f} "
          f"tokens/s, device busy {busy:.3f} ms (idle "
          f"{100 * max(0.0, 1 - busy / wall):.1f}%), "
          f"{sum(r[1] for r in rows)} device ops/step, peak memory "
          f"{peak:.2f} GiB; LoRA kernel {lora:.3f} ms "
          f"({100 * lora / busy:.1f}% of device time), flash kernels "
          f"{flash:.3f} ms ({100 * flash / busy:.1f}%): "
          + ", ".join(f"{k} {t:.3f}" for k, t in split.items()))
    for t, n, key in rows[:10]:
        print(f"[profile]   {t:.4f} ms/step in {n:4d} x {key}")
    per_launch(rows, kernels)
    del state, base, factors
    torch.cuda.empty_cache()
    return wall, busy, lora, peak


def _plain_flash_ad(ref):
    """Plain attention with autograd, in place of the flash kernels."""
    def flash_attention_ad(q, k, v, scale=None, causal=True, window=None,
                           q_offset=0, *, block_q=128, block_k=128):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, q_offset=q_offset)
    return flash_attention_ad


def step_vs_plain(torch, cfg, dev):
    """One float32 local train step at full width, through the kernels and
    through plain attention: loss, grads and updated params."""
    from repro_torch.config import ShapeConfig
    from repro_torch.core.steps import make_train_step
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import Adam
    from repro_torch.tree import flatten, leaves, unflatten
    c32 = cfg.replace(param_dtype="float32")
    params = lm.init(c32, seed=1, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    shape = ShapeConfig("cli", S, B, "train")
    opt = Adam(lr=1e-3)
    flat, spec = flatten(params)

    def run():
        live = [p.detach().requires_grad_() for p in flat]
        loss, _ = build_model(c32).loss(unflatten(spec, live), batch,
                                        remat=False)
        grads = torch.autograd.grad(loss, live)
        new, st, m = make_train_step(c32, shape, opt, remat=False)(
            params, opt.init(params), batch)
        torch.cuda.synchronize()
        return (float(loss.detach()), grads, leaves(new), float(m["loss"]),
                leaves(st.v))

    kernel = run()
    saved = ops.flash_attention_ad
    ops.flash_attention_ad = _plain_flash_ad(ref)
    try:
        plain = run()
    finally:
        ops.flash_attention_ad = saved
    dloss = abs(kernel[0] - plain[0])
    check(dloss <= STEP_LOSS_ATOL, f"f32 step loss differs by {dloss}")
    grad_rel = max(float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(kernel[1], plain[1]))
    check(grad_rel <= STEP_GRAD_RTOL, f"f32 step grads differ: {grad_rel}")
    near = near_apart = total = 0
    worst = worst_near = 0.0
    for a, b, va, vb in zip(kernel[2], plain[2], kernel[4], plain[4]):
        d = (a - b).abs()
        # Adam's first-step denominator |g| (= sqrt(v_hat)), either run's
        den = torch.minimum(*(torch.where(
            v > 0, torch.sqrt(v / (1 - opt.b2)), torch.inf) for v in (va, vb)))
        flag = den < NEAR_EPS
        near += int(flag.sum())
        near_apart += int((flag & (d > STEP_PARAM_ATOL)).sum())
        total += d.numel()
        worst = max(worst, float(torch.where(flag, 0.0, d).max()))
        worst_near = max(worst_near, float(d.max()))
    check(worst <= STEP_PARAM_ATOL,
          f"f32 step: updated params differ by {worst:.3e} > "
          f"{STEP_PARAM_ATOL}")
    check(worst_near <= 2 * opt.lr,
          f"f32 step: near-eps params differ by {worst_near:.3e}")
    print(f"[step] float32 local step, kernels vs plain attention: loss "
          f"{kernel[0]:.6f} vs {plain[0]:.6f} (|diff| {dloss:.2e}, atol "
          f"{STEP_LOSS_ATOL}); grads max |diff| / leaf max {grad_rel:.2e} "
          f"(rtol {STEP_GRAD_RTOL}); updated params max |diff| {worst:.2e} "
          f"(atol {STEP_PARAM_ATOL}) on all but the {near} of {total} "
          f"near-eps params (0 < |g| < {NEAR_EPS}); {near_apart} of those "
          f"over {STEP_PARAM_ATOL}, max {worst_near:.2e} (atol "
          f"{2 * opt.lr})")
    del kernel, plain, params, flat
    torch.cuda.empty_cache()
    return dloss, grad_rel, worst, near


def profile_local_step(torch, cfg, dev, steps=3, kernels=None):
    """A bf16 local train step at full width (one client, 4 x 1024
    tokens): wall time, tokens/s, device busy share, top device ops, peak
    memory and the tensor-core flash kernels' time a launch."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import ShapeConfig
    from repro_torch.core.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.optimizer import Adam
    params = lm.init(cfg, seed=2, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(8)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    opt = Adam(lr=1e-3)
    step = make_train_step(cfg, ShapeConfig("cli", S, B, "train"), opt,
                           remat=False)
    state = [params, opt.init(params)]

    def run(n):
        for _ in range(n):
            state[0], state[1], _ = step(state[0], state[1], batch)
        torch.cuda.synchronize()

    run(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:70])
                  for e in prof.key_averages())[::-1]
    busy = sum(r[0] for r in rows)
    ops_per_step = sum(r[1] for r in rows)
    flash, split = flash_split(rows)
    print(f"[profile] bf16 local train step, {B}x{S} tokens: wall "
          f"{wall:.3f} ms, {B * S / wall * 1e3:.0f} tokens/s, device busy "
          f"{busy:.3f} ms (idle {100 * max(0.0, 1 - busy / wall):.1f}%), "
          f"{ops_per_step} device ops/step, peak memory {peak:.2f} GiB; "
          f"flash kernels {flash:.3f} ms ({100 * flash / busy:.1f}% of "
          f"device time): "
          + ", ".join(f"{k} {t:.3f}" for k, t in split.items()))
    for t, n, key in rows[:8]:
        print(f"[profile]   {t:.4f} ms/step in {n:4d} x {key}")
    per_launch(rows, kernels)
    del state, params
    torch.cuda.empty_cache()
    return wall, busy, peak


# ------------------------------------------------------------ FHDP slice
def vision_flash_checks(torch, dev):
    """The four flash kernels at the FHDP step's attention shape (float32,
    non-causal, B 2, Hq = Hkv 12, S 256, D 64): each against its plain
    version (the forward's o and lse, delta, dK, dV, dQ; float32
    tolerances as flash_checks), every launch on its route
    (``VISION_ROUTES``: the forward, dK/dV and dQ on 3xTF32 wgmma, the
    preprocess on its vec kernel), the replaced SIMT forward, dK/dV and dQ
    against their plain versions too; then each timed (cold L2) beside its
    plain version, its bounds (float32 on the CUDA cores; for the 3xTF32
    kernels also three tf32 passes on the tensor cores) and
    scaled_dot_product_attention in float32 (forward; the whole backward;
    the preprocess against one torch.bmm, as preprocess_checks), the
    3xTF32 kernels in turns with the SIMT kernels they replaced.
    Returns per-kernel JSON keys ``vision_f32_*``."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (torch.randn((VMB, VH, VS, D), generator=g, device=dev)
                   for _ in range(4))
    sc = D ** -0.5
    kw = dict(causal=False)
    card = dict(scale=sc, causal=False, window=None, q_offset=0)
    routes0 = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    delta = ops.flash_attention_bwd_preprocess(o, do)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    grew = {fn: {r: n - routes0[fn][r] for r, n in c.items()}
            for fn, c in ops.route_counts().items() if fn in VISION_ROUTES}
    so, slse = ops._flash_fwd_card(q, k, v, return_lse=True, route="simt",
                                   **card)
    sdk, sdv = ops._flash_dkv_card(q, k, v, do, lse, delta, route="simt",
                                   **card)
    sdq = ops._flash_dq_card(q, k, v, do, lse, delta, route="simt", **card)
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               scale=sc, **kw)
    rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale=sc,
                                         **kw)
    rdelta = ref.flash_attention_bwd_preprocess_ref(o, do)
    torch.cuda.synchronize()
    errs, simt_errs = {}, {}
    for name, label, got, want, tol in (
            ("flash_attention", "o", o, ro, FLASH_ATOL_F32),
            ("flash_attention", "lse", lse, rlse, FLASH_ATOL_F32),
            (PRE, "delta", delta, rdelta, FLASH_ATOL_F32),
            ("flash_attention_bwd_dkv", "dk", dk, rdk, FLASH_GRAD_ATOL_F32),
            ("flash_attention_bwd_dkv", "dv", dv, rdv, FLASH_GRAD_ATOL_F32),
            ("flash_attention_bwd_dq", "dq", dq, rdq, FLASH_GRAD_ATOL_F32),
            ("simt flash_attention", "o", so, ro, FLASH_ATOL_F32),
            ("simt flash_attention", "lse", slse, rlse, FLASH_ATOL_F32),
            ("simt flash_attention_bwd_dkv", "dk", sdk, rdk,
             FLASH_GRAD_ATOL_F32),
            ("simt flash_attention_bwd_dkv", "dv", sdv, rdv,
             FLASH_GRAD_ATOL_F32),
            ("simt flash_attention_bwd_dq", "dq", sdq, rdq,
             FLASH_GRAD_ATOL_F32)):
        err = _err(got, want)
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"flash f32 vision {name} {label}: max err {err:.3e} > "
              f"{tol:.3e}")
        into = simt_errs if name.startswith("simt ") else errs
        key = name.removeprefix("simt ")
        into[key] = max(into.get(key, 0.0), err)
    want = {fn: {r: 0 for r in c} for fn, c in grew.items()}
    for fn, route in VISION_ROUTES.items():
        want[fn][route] = 1
    check(grew == want, f"flash f32 vision: launches by route {grew}")
    print(f"[kernel] flash f32 vision: launches by route {grew}; max err "
          f"vs plain {errs}; the replaced SIMT kernels' {simt_errs}")
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl)
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                        None, iters=20)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), do, retain_graph=True), None, iters=20)
    lib_err = _err(_bmm_delta(torch, o, do), rdelta)
    check(lib_err <= FLASH_ATOL_F32,
          f"torch.bmm delta at the vision shape: max err {lib_err:.3e}")
    lib_pre = device_ms(lambda: _bmm_delta(torch, o, do), None, iters=20)
    nq, stat, pairs = VMB * VH * VS * D, VMB * VH * VS, VMB * VH * VS * VS
    runs = {   # (kernel, plain, library ms, bytes, operations)
        "flash_attention": (
            lambda: ops.flash_attention(q, k, v, return_lse=True, **kw),
            lambda: ref.flash_attention_ref(q, k, v, return_lse=True, **kw),
            lib_fwd, 4 * (4 * nq + stat), 4 * D * pairs),
        PRE: (lambda: ops.flash_attention_bwd_preprocess(o, do),
              lambda: ref.flash_attention_bwd_preprocess_ref(o, do),
              lib_pre, 4 * (2 * nq + stat), 2 * nq),
        "flash_attention_bwd_dkv": (
            lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                **kw),
            lambda: ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    scale=sc, **kw),
            lib_bwd, 4 * (6 * nq + 2 * stat), 8 * D * pairs),
        "flash_attention_bwd_dq": (
            lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               **kw),
            lambda: ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                   scale=sc, **kw),
            lib_bwd, 4 * (5 * nq + 2 * stat), 6 * D * pairs),
    }
    old = {   # the SIMT kernels the 3xTF32 ones replaced, same inputs
        "flash_attention": lambda: ops._flash_fwd_card(
            q, k, v, return_lse=True, route="simt", **card),
        "flash_attention_bwd_dkv": lambda: ops._flash_dkv_card(
            q, k, v, do, lse, delta, route="simt", **card),
        "flash_attention_bwd_dq": lambda: ops._flash_dq_card(
            q, k, v, do, lse, delta, route="simt", **card)}
    rows = {}
    for name, (kfn, pfn, lib, nbytes, ops_) in runs.items():
        ms, plain, call = timings(kfn, pfn, VISION_NAMES[name])
        b_ms, b_by = bound(nbytes, ops_, F32_FLOPS_PER_S)
        extra, note = {}, ""
        if name in TF32_KERNELS:
            ms, simt_ms = in_turns(kfn, old[name], VISION_NAMES[name],
                                   TC_KERNELS[name][4])
            t_ms, t_by = bound(nbytes, ops_, TF32X3_FLOPS_PER_S)
            extra = {"vision_f32_simt_ms": simt_ms,
                     "vision_f32_simt_max_abs_err": simt_errs[name],
                     "vision_f32_bound_tf32x3_ms": t_ms,
                     "vision_f32_bound_tf32x3_by": t_by,
                     "vision_f32_route": "tf32x3"}
            note = (f" (the SIMT kernel it replaced {simt_ms:.5f} ms, in "
                    f"turns); bound at 3xTF32 {t_ms:.5f} ms ({t_by}, "
                    f"{100 * t_ms / ms:.1f}% of it)")
        print(f"[kernel] {name} f32 vision (B{VMB} Hq{VH} Hkv{VH} S{VS} D{D},"
              f" non-causal; {VISION_NAMES[name]}): device: kernel {ms:.5f} "
              f"ms ({ops_ / ms / 1e9:.2f} TFLOP/s){note}, plain {plain:.5f} "
              f"ms, library {lib:.5f} ms; bound on the CUDA cores "
              f"{b_ms:.5f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it); host "
              f"clock per call {call:.5f} ms")
        rows[name] = {"vision_f32_ms": ms, "vision_f32_plain_ms": plain,
                      "vision_f32_library_ms": lib,
                      "vision_f32_bound_ms": b_ms,
                      "vision_f32_bound_by": b_by,
                      "vision_f32_max_abs_err": errs[name],
                      "vision_f32_route": VISION_ROUTES[name],
                      "vision_f32_shape": f"B {VMB}, Hq = Hkv {VH}, S {VS}, "
                                          f"D {D}, float32, non-causal",
                      **extra}
    rows["flash_attention"]["vision_f32_library_call"] = (
        "F.scaled_dot_product_attention, float32, non-causal, forward")
    rows[PRE]["vision_f32_library_call"] = (
        "torch.bmm(o [rows, 1, D], dO [rows, D, 1]), float32")
    rows[PRE]["vision_f32_library_max_abs_err"] = lib_err
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        rows[name]["vision_f32_library_call"] = "SDPA's whole backward"
    del q, k, v, do, o, lse, ql, kl, vl, lo
    torch.cuda.empty_cache()
    return rows


def _vision_launches(cfg, steps, columns, microbatches):
    """A pipelined step's launches: each (column, microbatch, layer) runs
    the forward twice (per-layer remat recomputes it in the backward) and
    each backward kernel once."""
    n = steps * columns * microbatches * cfg.num_layers
    return {"flash_attention": 2 * n, PRE: n, "flash_attention_bwd_dkv": n,
            "flash_attention_bwd_dq": n}


def _check_vision_launches(ops, counts, want, path):
    full = dict.fromkeys(counts, 0)
    full.update(want)
    check(counts == full, f"{path}: launches {counts} != {full}")
    routes = ops.route_counts()
    for fn, n in want.items():
        route = VISION_ROUTES[fn]
        check(routes[fn] == {**{r: 0 for r in routes[fn]}, route: n},
              f"{path}: {fn} launches by route {routes[fn]}")
    return {fn: dict(routes[fn]) for fn in want}


def _zero2_den(p, v, bc2, staged):
    """Adam's sqrt(v_hat) per element of param leaf ``p`` from its flat
    ZeRO-2 moment ``v`` ([D, shard] or [S, D, shard]); inf where v is 0."""
    lead = p.shape[0] if staged else 1
    n = p.numel() // lead
    v = v.reshape(lead, -1)[:, :n].reshape(p.shape)
    return v.new_full(v.shape, float("inf")).where(
        v <= 0, (v / bc2).sqrt())


def vision_step_vs_plain(torch, step, pp, opt, batch, lr):
    """One FHDP step from the same state through the flash kernels and
    through plain attention: loss, Adam moments and updated params."""
    from repro_torch.kernels import ops, ref
    from repro_torch.tree import leaves
    kern = step(pp, opt, batch)
    saved = ops.flash_attention_ad
    ops.flash_attention_ad = _plain_flash_ad(ref)
    try:
        plain = step(pp, opt, batch)
    finally:
        ops.flash_attention_ad = saved
    torch.cuda.synchronize()
    lk, lp = float(kern[2]["loss"]), float(plain[2]["loss"])
    check(abs(lk - lp) <= VISION_LOSS_RTOL * abs(lp),
          f"vision step loss: kernels {lk} vs plain {lp}")
    worst_m = 0.0
    for key in ("m", "v"):
        for a, b in zip(leaves(kern[1][key]), leaves(plain[1][key])):
            if not b.numel():
                continue
            tol = VISION_MOMENT_RTOL * (b.abs() + b.abs().max())
            over = float(((a - b).abs() - tol).max())
            worst_m = max(worst_m, float(((a - b).abs() / (
                b.abs() + b.abs().max())).max()))
            check(over <= 0, f"vision step {key}: kernels vs plain beyond "
                  f"rtol {VISION_MOMENT_RTOL}")
    bc2 = 1 - 0.95 ** int(kern[1]["step"])
    near = total = 0
    worst = worst_near = 0.0
    for part in ("shared", "stacks"):
        for a, b, va, vb in zip(leaves(kern[0][part]), leaves(plain[0][part]),
                                leaves(kern[1]["v"][part]),
                                leaves(plain[1]["v"][part])):
            staged = part == "stacks"
            den = torch.minimum(_zero2_den(a, va, bc2, staged),
                                _zero2_den(b, vb, bc2, staged))
            d = (a - b).abs()
            flag = den < VISION_NEAR_EPS
            near += int(flag.sum())
            total += d.numel()
            worst = max(worst, float(torch.where(flag, 0.0, d).max()))
            worst_near = max(worst_near, float(d.max()))
    check(worst <= VISION_PARAM_ATOL, f"vision step params differ by "
          f"{worst:.3e} > {VISION_PARAM_ATOL}")
    check(worst_near <= 2 * lr and near <= 1e-3 * total,
          f"vision step: {near} near-eps params, max diff {worst_near:.3e}")
    print(f"[vision] one FHDP step, kernels vs plain attention: loss "
          f"{lk:.7f} vs {lp:.7f}; moments max |diff| / (|plain| + leaf max)"
          f" {worst_m:.2e} (rtol {VISION_MOMENT_RTOL}); params max |diff| "
          f"{worst:.2e} (atol {VISION_PARAM_ATOL}) on all but {near} of "
          f"{total} near-eps params (max {worst_near:.2e}, atol {2 * lr})")
    return abs(lk - lp), worst_m, worst, near


def profile_vision_step(torch, step, state, batch, steps=3,
                        label="FHDP step"):
    """Wall time, samples/s, device busy and idle share, the flash
    kernels' share and peak memory of a warm FHDP step at full width."""
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for _ in range(n):
            state[0], state[1], _ = step(state[0], state[1], batch)
        torch.cuda.synchronize()

    run(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:70])
                  for e in prof.key_averages())[::-1]
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    split = {n: sum(r[0] for r in rows if n in r[2])
             for n in VISION_NAMES.values()}
    flash = sum(split.values())
    bs = VISION_GEOMETRY[0] * VISION_GEOMETRY[1] * VISION_GEOMETRY[2]
    print(f"[profile] {label}, flad-vision full width, {bs} samples on a "
          f"(2, 4) mesh: wall {wall:.3f} ms, {bs / wall * 1e3:.1f} "
          f"samples/s, device busy {busy:.3f} ms (idle "
          f"{100 * max(0.0, 1 - busy / wall):.1f}%), {n_ops} device "
          f"ops/step, peak memory {peak:.2f} GiB; flash kernels "
          f"{flash:.3f} ms ({100 * flash / busy:.1f}% of device time): "
          + ", ".join(f"{k} {t:.3f}" for k, t in split.items()))
    for t, n, key in rows[:8]:
        print(f"[profile]   {t:.4f} ms/step in {n:4d} x {key}")
    return dict(wall_ms=wall, busy_ms=busy, peak_gib=peak, ops=n_ops,
                flash_ms=flash, samples_per_s=bs / wall * 1e3)


def numpy_vision_batches(cfg, n, seed):
    """``n`` flad-vision batches of 16 samples from numpy's generator with
    ``seed``: the reference trajectory's inputs (the same draws, in the
    same order, as ``tests/test_torch_trajectory.numpy_batches``)."""
    rng = np.random.default_rng(seed)
    p, f = cfg.prefix_tokens, cfg.prefix_dim
    out = []
    for _ in range(n):
        out.append({
            "rgb": rng.standard_normal((16, p, f)).astype(np.float32),
            "lidar": rng.standard_normal((16, p, f)).astype(np.float32),
            "waypoints": rng.standard_normal(
                (16, cfg.num_waypoints, 2)).astype(np.float32),
            "light": rng.integers(0, cfg.num_light_classes, (16,))
            .astype(np.int32)})
    return out


def vision_vs_reference(torch, dev, label, quiet):
    """The Session at lr 1e-3 from the reference trajectory's start: the
    port's init with the Session's seed on the CPU, moved to the card,
    on the same numpy batches; each step's loss against the reference's
    (``VISION_REF_LOSSES``), the first ``VISION_REF_GATED`` steps held to
    ``VISION_REF_RTOL``."""
    from repro_torch.api import MeshSpec, Session
    from repro_torch.core.fhdp import init_fhdp
    from repro_torch.tree import tree_map
    want = VISION_REF_LOSSES[label]
    ses = Session(**VISION_SESSION, device=dev)
    pp, opt, _ = init_fhdp(ses.cfg, MeshSpec((2, 4)).build("cpu"), ses.seed)
    state = tuple(tree_map(lambda t: t.to(dev), x) for x in (pp, opt))
    drawn = numpy_vision_batches(ses.cfg, 1 if label == "one_batch"
                                 else len(want), VISION_REF_SEEDS[label])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in drawn]
    if label == "one_batch":
        batches = batches * len(want)
    out = ses.run(len(want), state=state, batches=batches, hooks=quiet)
    torch.cuda.synchronize()
    got = [e["loss"] for e in out["history"]]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    n = VISION_REF_GATED[label]
    print(f"[vision] {label}, lr {ses.strategy.learning_rate}, from the "
          f"reference run's start: losses "
          + ", ".join(f"{x:.6f}" for x in got) + "; the reference's "
          + ", ".join(f"{x:.6f}" for x in want) + "; |diff| / |reference| "
          + ", ".join(f"{x:.2e}" for x in rel)
          + f" (the first {n} held to {VISION_REF_RTOL})")
    check(all(np.isfinite(got)) and max(rel[:n]) <= VISION_REF_RTOL,
          f"vision {label}: losses {got} leave the reference's {want}")
    del ses, pp, opt, state, out
    torch.cuda.empty_cache()
    return dict(losses=got, reference=list(want), rel=rel)


def vision_main_path(torch, dev):
    """FHDP on flad-vision at full width and depth through the ported
    Session at its own lr, 1e-3: the reference's descent check (8
    pipelined steps on one batch, a (2, 4) mesh), then the same Session
    from the reference trajectory's start on its fresh and repeated
    batches, then one fl_pipeline round of 2 local steps. Checks the
    first loss against the flat model's, the exact flash launches (the
    float32 forward, dK/dV and dQ on tf32x3, the preprocess on vec:
    ``VISION_ROUTES``), the losses
    against the reference's, one step through the kernels against plain
    attention and the round's merged params' shapes; reports whether the
    8 steps descended."""
    from repro_torch.api import LoopHooks, Session
    from repro_torch.configs.common import concrete_batch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves
    quiet = LoopHooks(log_every=1, log_fn=lambda *a, **k: None)
    t0 = time.perf_counter()
    ses = Session(**VISION_SESSION, device=dev)
    step, (pp0, opt0) = ses.build()
    cfg, shape = ses.cfg, ses.shape
    torch.cuda.synchronize()
    h = ses.strategy.helpers
    geom = (h["microbatches"], h["mb"], h["columns"])
    check(geom == VISION_GEOMETRY and shape.global_batch == 16
          and ses.strategy.learning_rate == 1e-3,
          f"vision geometry {geom}, batch {shape.global_batch}, lr "
          f"{ses.strategy.learning_rate}")
    n_params = sum(t.numel() for t in leaves(ses.merged_params()))
    print(f"[vision] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, {n_params / 1e6:.1f} M params in {cfg.param_dtype};"
          f" mesh {ses.mesh.shape}, templates {h['templates']}, "
          f"microbatches {geom[0]} of {geom[1]} a column, lr "
          f"{ses.strategy.learning_rate} "
          f"({time.perf_counter() - t0:.1f} s to init)")
    gen = torch.Generator(device=dev).manual_seed(11)
    batch = concrete_batch(cfg, shape, gen)
    with torch.no_grad():
        flat = float(build_model(cfg).loss(ses.merged_params(), batch)[0])

    # the main path: the reference's descent check, 8 steps on one batch
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ses.run(VISION_STEPS, batches=[batch] * VISION_STEPS, hooks=quiet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _vision_launches(cfg, VISION_STEPS, geom[2], geom[0])
    routes = _check_vision_launches(ops, counts, want, "vision pipeline")
    losses = [e["loss"] for e in out["history"]]
    check(all(np.isfinite(losses)), f"vision losses {losses}")
    check(abs(losses[0] - flat) <= VISION_LOSS_RTOL * abs(flat),
          f"vision first loss {losses[0]} vs the flat model's {flat}")
    print(f"[vision] pipeline: {VISION_STEPS} steps on one batch in "
          f"{wall:.2f} s; losses " + ", ".join(f"{x:.6f}" for x in losses)
          + f"; first vs the flat model's {flat:.6f} (|diff| "
          f"{abs(losses[0] - flat):.2e}, rtol {VISION_LOSS_RTOL}); launches "
          f"{want}, by route {routes}")
    del out
    ses.state = None

    # the same Session from the reference trajectory's start
    ref = {label: vision_vs_reference(torch, dev, label, quiet)
           for label in ("fresh", "one_batch")}

    # one step through the kernels vs plain attention, from the init
    cmp = vision_step_vs_plain(torch, step, pp0, opt0, batch,
                               ses.strategy.learning_rate)
    prof = profile_vision_step(torch, step, [pp0, opt0], batch)
    del pp0, opt0
    ses.state = ses._built = None
    torch.cuda.empty_cache()

    # one fl_pipeline round of 2 local steps
    fl = Session(**dict(VISION_SESSION, strategy="fl_pipeline"), device=dev,
                 local_steps=VISION_LOCAL)
    fl.build()
    round_batch = concrete_batch(cfg, shape, gen, lead=(VISION_LOCAL,))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rout = fl.run(1, batches=[round_batch], hooks=quiet)
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t0
    rcounts = ops.launch_counts()
    rwant = _vision_launches(cfg, VISION_LOCAL, geom[2], geom[0])
    rroutes = _check_vision_launches(ops, rcounts, rwant, "vision fl round")
    merged = fl.merged_params()
    flat_shapes = [tuple(t.shape) for t in leaves(
        build_model(cfg).init(device="meta").to_dict())]
    check([tuple(t.shape) for t in leaves(merged)] == flat_shapes,
          "fl_pipeline merged params do not have the flat model's shapes")
    check(all(bool(torch.isfinite(t).all()) for t in leaves(merged)),
          "fl_pipeline merged params not finite")
    rloss = rout["history"][0]["loss"]
    check(np.isfinite(rloss), f"fl round loss {rloss}")
    print(f"[vision] fl_pipeline: one round of {VISION_LOCAL} local steps in "
          f"{rwall:.2f} s, column 0's loss {rloss:.6f}; merged params have "
          f"the flat model's {len(flat_shapes)} leaf shapes; launches "
          f"{rwant}")
    del fl, merged, rout
    torch.cuda.empty_cache()
    # reported, not held: at this width and lr the reference's own loss
    # rises on one batch too (8.842516 after 8 steps from 2.150192), and
    # the card's losses keep to the reference's (vision_vs_reference)
    print(f"[vision] descent over {VISION_STEPS} steps on one batch at lr "
          f"{ses.strategy.learning_rate}: first {losses[0]:.6f}, last "
          f"{losses[-1]:.6f}, "
          + ("descended" if losses[-1] < losses[0] else "did not descend")
          + "; the reference's own run on one batch: first "
          f"{VISION_REF_LOSSES['one_batch'][0]}, last "
          f"{VISION_REF_LOSSES['one_batch'][-1]}")
    launches = {fn: want[fn] + rwant[fn] for fn in want}
    by_route = {fn: {r: routes[fn][r] + rroutes[fn][r] for r in routes[fn]}
                for fn in routes}
    summary = dict(steps=VISION_STEPS, wall_s=wall, losses=losses,
                   descended=losses[-1] < losses[0], flat_loss=flat,
                   reference=ref, round_wall_s=rwall,
                   round_loss=rloss,
                   vs_plain=dict(zip(("loss_diff", "moment_rel",
                                      "param_diff", "near_eps"), cmp)),
                   **prof)
    return launches, by_route, summary


def swift_fleet(unit_cap):
    """``SWIFT_FLEET`` as the strategy's spec dicts."""
    f = SWIFT_FLEET
    return [dict(cmp=f["cmp"], com=f["com"], mem=m * unit_cap, stb=st)
            for m, st in zip(f["mem"], f["stb"])]


def swift_policy(torch, dev, vehicles, units):
    """SWIFT's phase-2 policy: a double DQN trained on the card for
    ``SWIFT_DQN_EPISODES`` episodes over the fleet, then one ``swift``
    run with it. Every essential pipeline must cover every unit; returns
    how many came from the policy and how many from the greedy
    fallback, and the times."""
    from repro_torch.sched.costmodel import CostParams
    from repro_torch.sched.swift import (dqn_pipeline, swift, train_policy,
                                         window_fleet)
    cp = CostParams()
    t0 = time.perf_counter()
    agent = train_policy(lambda: (vehicles, units),
                         episodes=SWIFT_DQN_EPISODES, seed=0, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(agent.online["w1"].device.type == "cuda" and agent.replay.n > 0,
          "the DQN did not train on the card")
    res = swift(vehicles, units, agent=agent, cp=cp)
    head = res.initial.path[0].vid if res.initial is not None else None
    from_policy = fallback = 0
    for vid, pipe in res.essential.items():
        check(sum(len(part) for part in pipe.partition) == len(units),
              f"essential pipeline of vehicle {vid} covers "
              f"{pipe.template()} of {len(units)} units")
        if vid == head:
            continue
        idx = next(i for i, v in enumerate(vehicles) if v.vid == vid)
        win, h = window_fleet(vehicles, idx)
        mine = dqn_pipeline(agent, win, units, cp, head=h)
        if mine is not None and mine.template() == pipe.template() and \
                [v.vid for v in mine.path] == [v.vid for v in pipe.path]:
            from_policy += 1
        else:
            fallback += 1
    # learn() updates once the replay holds a batch
    updates = max(0, agent.replay.n - agent.cfg.batch + 1)
    print(f"[swift] DQN: {SWIFT_DQN_EPISODES} episodes on the card in "
          f"{train_s:.2f} s ({agent.replay.n} transitions, {updates} Adam "
          f"updates of batch {agent.cfg.batch}); swift(agent=) in "
          f"{res.phase1_s * 1e3:.3f} + {res.phase2_s * 1e3:.3f} ms: "
          f"{len(res.essential)} essential pipelines, each over "
          f"{len(units)} units ({from_policy} from the policy, {fallback} "
          f"from the greedy fallback, 1 the phase-1 pipeline); templates "
          + ", ".join(f"{vid}: {p.template()}"
                      for vid, p in sorted(res.essential.items())))
    return dict(episodes=SWIFT_DQN_EPISODES, train_s=train_s,
                transitions=agent.replay.n, updates=updates,
                from_policy=from_policy,
                fallback=fallback, phase1_s=res.phase1_s,
                phase2_s=res.phase2_s,
                templates={str(k): list(p.template())
                           for k, p in res.essential.items()})


def swift_main_path(torch, dev):
    """SWIFT-scheduled FHDP with a live template switch, at full width:
    the ported Session under ``swift_pipeline`` over ``SWIFT_FLEET`` at
    its own lr, from the reference trajectory's start (the port's init on
    the CPU, moved to the card; numpy batches), ``SWIFT_STEPS`` steps
    with a Repartitioner departing vehicle 0 after step index 1, an edge
    backup every 2 steps and a checkpoint every 2. Checks the templates
    (4, 4, 3, 1) -> (4, 3, 3, 2), the restage bitwise, the shrunken fleet,
    the exact flash launches by route, the first loss against the flat
    model's and every loss against the reference's, the step-4 checkpoint
    (its sidecar and the params bitwise) and the latest backup restaged
    under the balanced template; then trains a DQN policy on the card and
    runs SWIFT with it."""
    import tempfile

    from repro_torch.api import LoopHooks, MeshSpec, Session
    from repro_torch.api.session import load_config
    from repro_torch.core import pipeline as pl
    from repro_torch.core.fhdp import init_fhdp
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.recovery.backup import EdgeBackup, restage
    from repro_torch.recovery.recover import Repartitioner
    from repro_torch.sched.costmodel import model_units
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    units = model_units(load_config("flad-vision", full=True),
                        seq_len=SWIFT_SESSION["seq_len"])
    ses = Session(**SWIFT_SESSION, fleet=swift_fleet(units[0].cap),
                  device=dev)
    cfg, strat = ses.cfg, ses.strategy
    tmpl = strat.resolve_templates(cfg, ses.mesh)
    vehicles = list(strat.vehicles)
    res = strat.swift_result
    check(tmpl == {"blocks": SWIFT_TEMPLATES[0]}
          and sum(tmpl["blocks"]) == cfg.num_layers,
          f"swift template {tmpl}, want {SWIFT_TEMPLATES[0]}")
    check(ses.shape.global_batch == 16 and strat.learning_rate == 1e-3,
          f"swift batch {ses.shape.global_batch}, lr "
          f"{strat.learning_rate}")
    print(f"[swift] {cfg.name} full width over {len(vehicles)} vehicles "
          f"(unit {units[0].cap:.0f} B, memories {SWIFT_FLEET['mem']} "
          f"units): SWIFT phase 1 {res.phase1_s * 1e3:.3f} ms, phase 2 "
          f"{res.phase2_s * 1e3:.3f} ms; active template {tmpl['blocks']} "
          f"on vehicles {[v.vid for v in strat.active_pipeline.path]}; "
          f"departure templates " + ", ".join(
              f"{vid}: {p.template() if p else None}" for vid, p in
              strat.template_set.on_departure.items()))
    pp, opt, _ = init_fhdp(cfg, MeshSpec((2, 4)).build("cpu"), ses.seed,
                           templates=tmpl)
    state = tuple(tree_map(lambda t: t.to(dev), x) for x in (pp, opt))
    del pp, opt
    drawn = numpy_vision_batches(cfg, SWIFT_STEPS, SWIFT_REF_SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in drawn]
    with torch.no_grad():
        flat = float(build_model(cfg).loss(
            strat.merge_params(state, cfg), batches[0])[0])
    start = tree_map(torch.clone, state[0])
    step0, _ = ses.build(init=False)
    h = strat.helpers
    geom = (h["microbatches"], h["mb"], h["columns"])
    check(geom == VISION_GEOMETRY, f"swift geometry {geom}")
    torch.cuda.synchronize()
    print(f"[swift] set up in {time.perf_counter() - t0:.1f} s")

    tmpdir = tempfile.TemporaryDirectory(prefix="swift_ckpt_")
    path = str(Path(tmpdir.name) / "swift")
    rep = Repartitioner(ses, dict(SWIFT_DEPART))
    backup = EdgeBackup(interval=SWIFT_BACKUP_EVERY)
    hooks = LoopHooks(log_every=1, log_fn=lambda *a, **k: None,
                      backup=backup, checkpoint_path=path,
                      checkpoint_every=SWIFT_CKPT_EVERY, repartition=rep)
    # the main path: counts from zero just before the run, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ses.run(SWIFT_STEPS, state=state, batches=batches, hooks=hooks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _vision_launches(cfg, SWIFT_STEPS, geom[2], geom[0])
    routes = _check_vision_launches(ops, counts, want, "swift pipeline")
    del state

    # the switch
    check(len(rep.events) == 1, f"{len(rep.events)} repartition events")
    ev = rep.events[0]
    check(ev.old_template == {"blocks": SWIFT_TEMPLATES[0]}
          and ev.new_template == {"blocks": SWIFT_TEMPLATES[1]}
          and all(sum(t["blocks"]) == cfg.num_layers
                  for t in (ev.old_template, ev.new_template)),
          f"swift templates {ev.old_template} -> {ev.new_template}")
    check(ev.params_identical, "the restage changed the merged params")
    check([v.vid for v in strat.vehicles] == [v.vid for v in vehicles
                                              if v.vid != ev.vid]
          and ev.vid == SWIFT_DEPART[1],
          f"fleet after the departure {[v.vid for v in strat.vehicles]}")
    check({k: tuple(v) for k, v in strat.templates.items()}
          == ev.new_template, f"strategy templates {strat.templates}")
    check(ses._built[0] is out["step_fn"] and out["step_fn"] is not step0,
          "the session did not keep the rebuilt step")
    # the losses
    losses = [e["loss"] for e in out["history"]]
    check(len(losses) == SWIFT_STEPS and all(np.isfinite(losses)),
          f"swift losses {losses}")
    check(abs(losses[0] - flat) <= VISION_LOSS_RTOL * abs(flat),
          f"swift first loss {losses[0]} vs the flat model's {flat}")
    rel = [abs(g - w) / abs(w) for g, w in zip(losses, SWIFT_REF_LOSSES)]
    n = SWIFT_REF_GATED
    check(max(rel[:n]) <= VISION_REF_RTOL,
          f"swift losses {losses} leave the reference's {SWIFT_REF_LOSSES}")
    print(f"[swift] {SWIFT_STEPS} steps in {wall:.2f} s, vehicle "
          f"{ev.vid} departed after step index {ev.step}: template "
          f"{ev.old_template['blocks']} -> {ev.new_template['blocks']}, "
          f"params identical {ev.params_identical}; lookup "
          f"{ev.lookup_s * 1e3:.3f} ms, restage {ev.restage_s * 1e3:.3f} "
          f"ms, rebuild {ev.rebuild_s * 1e3:.3f} ms (switch "
          f"{ev.total_s * 1e3:.3f} ms), template refresh "
          f"{ev.refresh_s * 1e3:.3f} ms, {ev.moved_bytes:.0f} B to "
          f"redistribute; losses " + ", ".join(f"{x:.6f}" for x in losses)
          + "; the reference's " + ", ".join(
              f"{x:.6f}" for x in SWIFT_REF_LOSSES)
          + "; |diff| / |reference| " + ", ".join(f"{x:.2e}" for x in rel)
          + f" (the first {n} held to {VISION_REF_RTOL}); first vs the "
          f"flat model's {flat:.6f} (|diff| {abs(losses[0] - flat):.2e}); "
          f"launches {want}, by route {routes}")

    # the checkpoint of step 4: its sidecar, and the params bitwise
    final = ses.state
    meta = ckpt.load_meta(path)
    check(meta == {"strategy": "swift_pipeline", "arch": cfg.name,
                   "templates": {"blocks": list(SWIFT_TEMPLATES[1])}},
          f"checkpoint sidecar {meta}")
    t0 = time.perf_counter()
    restored, at = ckpt.load(path, tree_map(lambda t: t.to("meta"),
                                            final[0]), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(at == SWIFT_STEPS and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(leaves(restored), leaves(final[0]))),
          "the step-4 checkpoint does not load back bitwise")
    del restored
    t0 = time.perf_counter()
    ckpt.save(path + "_timed", final[0], step=SWIFT_STEPS,
              meta=ses._checkpoint_meta())
    save_s = time.perf_counter() - t0
    ckpt_mb = Path(path + ".npz").stat().st_size / 1e6
    tmpdir.cleanup()
    # the latest backup restages under the balanced template, bitwise
    snap = backup.latest
    check(snap is not None and snap.step == SWIFT_STEPS - 2
          and backup.backups_taken == SWIFT_STEPS // SWIFT_BACKUP_EVERY,
          f"backups {backup.backups_taken}, latest "
          f"{None if snap is None else snap.step}")
    balanced = pl.make_templates(cfg, ses.mesh.shape["model"])
    t0 = time.perf_counter()
    back = pl.merge_stage_params(restage(snap.tree, cfg, balanced,
                                         ses.mesh), balanced)
    torch.cuda.synchronize()
    restage_s = time.perf_counter() - t0
    check(all(a.device.type == dev.type and torch.equal(a.cpu(), b)
              for a, b in zip(leaves(back), leaves(snap.tree))),
          "the backup does not restage under the balanced template bitwise")
    del back
    backup_mb = sum(t.numel() * t.element_size()
                    for t in leaves(snap.tree)) / 1e6
    print(f"[swift] checkpoint of step {at}: sidecar {meta['templates']}, "
          f"{ckpt_mb:.1f} MB, loads back bitwise in {load_s:.3f} s (a save "
          f"of the final state {save_s:.3f} s); edge backups "
          f"{backup.backups_taken} of {backup_mb:.1f} MB each in "
          + ", ".join(f"{x:.3f}" for x in backup.seconds)
          + f" s; the latest (step index {snap.step}) restages under "
          f"{balanced['blocks']} and merges back bitwise in "
          f"{restage_s:.3f} s")

    # the step before and after the switch, warm, from the start and the
    # final state
    before = profile_vision_step(
        torch, step0, [start, pl.zero2_init(start, 2)], batches[0],
        steps=2, label=f"swift step under {SWIFT_TEMPLATES[0]}")
    del start
    after = profile_vision_step(
        torch, out["step_fn"], [final[0], final[1]], batches[0], steps=2,
        label=f"swift step under {SWIFT_TEMPLATES[1]}")
    del out, final, ses
    torch.cuda.empty_cache()

    dqn = swift_policy(torch, dev, vehicles, units)
    summary = dict(steps=SWIFT_STEPS, wall_s=wall, losses=losses,
                   reference=list(SWIFT_REF_LOSSES), rel=rel,
                   flat_loss=flat, templates=[list(t) for t in
                                              SWIFT_TEMPLATES],
                   event={k: v for k, v in ev.as_dict().items()},
                   swift_phase1_s=res.phase1_s, swift_phase2_s=res.phase2_s,
                   backup_s=list(backup.seconds), backup_mb=backup_mb,
                   checkpoint_save_s=save_s, checkpoint_load_s=load_s,
                   checkpoint_mb=ckpt_mb, restage_balanced_s=restage_s,
                   step_before=before, step_after=after, dqn=dqn)
    return want, routes, summary


# ------------------------------------------------------------------ mLSTM
def _mlstm_inputs(torch, dev, b, nh, s, dh, dtype, seed, state):
    """q, k (pre-scaled), v in ``dtype``, float32 gates (lf = log sigmoid),
    and the initial state: random when ``state == "random"``, the fresh
    zeros / -1e30 of a prefill when ``"fresh"``, none when None."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    args = (rand(b, nh, s, dh).to(dtype),
            (rand(b, nh, s, dh) * dh ** -0.5).to(dtype),
            rand(b, nh, s, dh).to(dtype), rand(b, nh, s),
            torch.nn.functional.logsigmoid(rand(b, nh, s) + 2.0))
    kw = {}
    if state == "random":
        kw = dict(C0=rand(b, nh, dh, dh) * 0.1, n0=rand(b, nh, dh) * 0.1,
                  m0=rand(b, nh))
    elif state == "fresh":
        kw = dict(C0=torch.zeros((b, nh, dh, dh), device=dev),
                  n0=torch.zeros((b, nh, dh), device=dev),
                  m0=torch.full((b, nh), -1e30, device=dev))
    return args, kw


def _mlstm_work(b, nh, s, dh, esz, state):
    """(bytes, flops) of one call: q, k, v, the gates and the initial
    state read once, h and the final state written once; 4 S DH^2 flops
    per (b, h) for C q and the C update, 4 DH per causal pair inside a
    64-step chunk for q.k and P v (what the recurrence needs at the
    kernel's chunk)."""
    pairs = sum(c * (c + 1) // 2 for c in
                [min(MLSTM_CHUNK, s - t) for t in range(0, s, MLSTM_CHUNK)])
    st = (dh * dh + dh + 1) * 4
    nbytes = b * nh * (4 * s * dh * esz + 2 * s * 4 + st
                       + (st if state else 0))
    return nbytes, b * nh * (4 * s * dh * dh + 4 * dh * pairs)


def _mlstm_f64(torch, ref, args, kw):
    """The plain chunkwise version (chunk 64) computed in float64."""
    q, k, v, ig, lf = (t.double() for t in args)
    b, nh, s, dh = q.shape
    if kw:
        C, n, m = (kw[x].double() for x in ("C0", "n0", "m0"))
    else:
        C = torch.zeros((b, nh, dh, dh), dtype=torch.float64, device=q.device)
        n = torch.zeros((b, nh, dh), dtype=torch.float64, device=q.device)
        m = torch.full((b, nh), -1e30, dtype=torch.float64, device=q.device)
    hs = []
    for t0 in range(0, s, MLSTM_CHUNK):
        sl = slice(t0, t0 + MLSTM_CHUNK)
        C, n, m, h = ref.mlstm_chunk_body(C, n, m, q[:, :, sl], k[:, :, sl],
                                          v[:, :, sl], ig[:, :, sl],
                                          lf[:, :, sl])
        hs.append(h)
    return torch.cat(hs, dim=2), (C, n, m)


def _mlstm_phases(torch, ops, args, st, route):
    """{phase: share of the CTA cycles} of one launch of ``route``'s
    kernel, from its clock64() phase counters (thread 0 of each CTA)."""
    names = MLSTM_PHASES[route]
    prof = torch.zeros(len(names) + 1, dtype=torch.int64, device="cuda")
    ops._mlstm_card(*args, *st, route=route, prof=prof)
    torch.cuda.synchronize()
    p = prof.tolist()
    return {n: x / p[-1] for n, x in zip(names, p)}


def mlstm_checks(torch, dev):
    """The chunkwise mLSTM's tensor-core kernel (route wgmma) and the SIMT
    kernel it replaced against the plain version (chunk 64) on the card,
    every case timed with a cold L2 for both kernels on the same inputs
    (turns new, old, old, new) beside the plain version and two bounds:
    float32 on the CUDA cores and 3xTF32 on the tensor cores (the one the
    wgmma kernel is held to; bf16 inputs need two passes). Cases: the
    prefill's shape with the fresh state it is given there, a ragged S, a
    random initial state, bf16 inputs, the reduced config's DH 64 and the
    ssm FHDP step's one-sample microbatches (B 1 at XF_S_CUT and XF_S).
    Also the errors of both kernels and of the plain version against a
    float64 plain run, the launch's cudaOccupancyMaxActiveClusters, and
    each kernel's phase split at the prefill's shape. Returns the
    kernel's JSON row (the prefill's shape as the headline, every case
    under ``cases``)."""
    from repro_torch.kernels import build, ops, ref
    lib = ctypes.CDLL(build.build_report["mlstm_chunked_tc"]["path"])
    clusters = {d: lib.mlstm_chunked_tc_clusters(c, XB, 4)
                for d, c in (("float32", 0), ("bfloat16", 1))}
    ncl = 512 // 64                 # a cluster's CTAs: DH / 64
    n_cl = XB * 4
    print(f"[kernel] mlstm_chunked wgmma launch at DH 512 (B {XB}, NH 4: "
          f"{n_cl} clusters of {ncl} CTAs, {lib.mlstm_chunked_tc_smem()} "
          f"bytes of shared memory a CTA): cudaOccupancyMaxActiveClusters "
          f"{clusters}, so {-(-n_cl // max(1, clusters['float32']))} waves")
    cases = [("path", 8, 4, XCTX, 512, torch.float32, "fresh"),
             ("ragged S 333", 8, 4, 333, 512, torch.float32, None),
             ("initial state", 2, 4, XCTX, 512, torch.float32, "random"),
             ("bf16", 8, 4, XCTX, 512, torch.bfloat16, "fresh"),
             ("DH 64", 8, 4, XCTX, 64, torch.float32, "random"),
             *((f"FHDP microbatch S {s_}", 1, 4, s_, 512, torch.float32,
                "fresh") for s_ in (XF_S_CUT, XF_S))]
    max_err, rows, phases = 0.0, {}, {}
    for label, b, nh, s, dh, dtype, state in cases:
        args, kw = _mlstm_inputs(torch, dev, b, nh, s, dh, dtype, 41, state)
        st = (kw.get("C0"), kw.get("n0"), kw.get("m0"))
        check(ops.mlstm_route(dtype, dh) == "wgmma",
              f"mlstm {label}: not on the wgmma route")
        before = ops.route_counts()["mlstm_chunked"]
        got = ops.mlstm_chunked(*args, **kw)
        check(ops.route_counts()["mlstm_chunked"]["wgmma"]
              == before["wgmma"] + 1, f"mlstm {label}: no wgmma launch")
        old = ops._mlstm_card(*args, *st, route="simt")
        want = ref.mlstm_chunkwise_ref(*args, chunk=MLSTM_CHUNK, **kw)
        exact = _mlstm_f64(torch, ref, args, kw)
        torch.cuda.synchronize()
        errs, f64 = [], []
        for i, name in enumerate("hCnm"):
            g = got[0] if i == 0 else got[1][i - 1]
            o = old[0] if i == 0 else old[1][i - 1]
            w = want[0] if i == 0 else want[1][i - 1]
            x = exact[0] if i == 0 else exact[1][i - 1]
            peak = max(1.0, float(w.float().abs().max()))
            rtol = (MLSTM_STATE_RTOL if name != "h" else
                    MLSTM_H_RTOL_F32 if dtype == torch.float32 else BF16_ULP)
            for who, t in (("wgmma", g), ("simt", o)):
                check(bool(torch.isfinite(t).all()),
                      f"mlstm {label} {name} ({who}): non-finite")
                err = _err(t, w)
                check(err <= rtol * peak, f"mlstm {label} {name} ({who}): "
                      f"max err {err:.3e} > {rtol * peak:.3e}")
            err = _err(g, w)
            errs.append(f"{name} {err:.2e} (simt {_err(o, w):.2e})")
            if name == "h":
                max_err = max(max_err, err)
            xpeak = max(1.0, float(x.abs().max()))
            f64.append(f"{name} wgmma {_err(g, x) / xpeak:.2e}, simt "
                       f"{_err(o, x) / xpeak:.2e}, plain "
                       f"{_err(w, x) / xpeak:.2e}")
        line = (f"[kernel] mlstm_chunked {label} (B {b}, NH {nh}, S {s}, "
                f"DH {dh}, {str(dtype).split('.')[-1]}, initial state "
                f"{state}): max|err| vs plain " + ", ".join(errs)
                + "; vs a float64 plain run, relative to the largest "
                "|value|: " + "; ".join(f64))
        new_fn = (lambda: ops._mlstm_card(*args, *st))
        old_fn = (lambda: ops._mlstm_card(*args, *st, route="simt"))
        turns = [("wgmma", new_fn), ("simt", old_fn), ("simt", old_fn),
                 ("wgmma", new_fn)]
        dev_ms = {"wgmma": [], "simt": []}
        call_ms = {"wgmma": [], "simt": []}
        for route, fn in turns:
            call_ms[route].append(time_ms(fn, iters=20, warmup=3))
            dev_ms[route].append(device_ms(fn, MLSTM_NAMES[route], iters=20))
        plain = device_ms(
            lambda: ref.mlstm_chunkwise_ref(*args, chunk=MLSTM_CHUNK, **kw),
            None, iters=10)
        ms, old_ms = (sum(dev_ms[r]) / 2 for r in ("wgmma", "simt"))
        esz = 4 if dtype == torch.float32 else 2
        nbytes, flops = _mlstm_work(b, nh, s, dh, esz, state)
        passes = MLSTM_TC_PASSES[str(dtype).split(".")[-1]]
        b_ms, b_by = bound(nbytes, flops * passes, TF32_FLOPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        rows[label] = dict(ms=ms, old_ms=old_ms, ms_turns=dev_ms["wgmma"],
                           old_ms_turns=dev_ms["simt"], plain_ms=plain,
                           call_ms=sum(call_ms["wgmma"]) / 2,
                           old_call_ms=sum(call_ms["simt"]) / 2,
                           bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                           f32_bound_by=f32_by)
        line += (f"; device (turns new, old, old, new): wgmma "
                 f"{dev_ms['wgmma'][0]:.5f}/{dev_ms['wgmma'][1]:.5f} ms, "
                 f"simt {dev_ms['simt'][0]:.5f}/{dev_ms['simt'][1]:.5f} ms "
                 f"(new/old {ms / old_ms:.3f}), plain {plain:.5f} ms; bounds "
                 f"3xTF32 ({passes} passes at {TF32_FLOPS_PER_S / 1e12:.0f} "
                 f"TFLOP/s) {b_ms:.5f} ms ({b_by}), float32 CUDA cores "
                 f"{f32_ms:.5f} ms ({f32_by}); {flops / 1e9:.2f} GFLOP and "
                 f"{nbytes / 1e6:.1f} MB needed; wgmma {flops / ms / 1e9:.1f} "
                 f"TFLOP/s of needed work; host clock per call wgmma "
                 f"{rows[label]['call_ms']:.5f} ms, simt "
                 f"{rows[label]['old_call_ms']:.5f} ms")
        print(line)
        if label in ("path", "bf16"):
            for r in ("simt", "wgmma"):
                ph = _mlstm_phases(torch, ops, args, st, r)
                phases[f"{r} {label}"] = ph
                print(f"[kernel] mlstm_chunked {r} phase split, {label} "
                      f"case (clock64 between the points thread 0 of "
                      f"every CTA passes, summed): " + ", ".join(
                          f"{n} {100 * x:.1f}%" for n, x in ph.items()))
        # faster in the mean of the turns is the verdict recorded; the run
        # fails when the new kernel is slower beyond the spread between a
        # kernel's own two turns (calls differ by up to 3%)
        spread = max(abs(t[0] - t[1]) for t in dev_ms.values())
        rows[label]["faster"] = ms < old_ms
        print(f"[kernel] mlstm_chunked {label}: wgmma "
              f"{'faster' if ms < old_ms else 'NOT faster'} than simt "
              f"({ms:.5f} against {old_ms:.5f} ms, turns' spread "
              f"{spread:.5f} ms)")
        check(ms - old_ms <= spread, f"mlstm {label}: the wgmma kernel "
              f"({ms:.5f} ms) is slower than the simt kernel ({old_ms:.5f} "
              f"ms) beyond the turns' spread {spread:.5f} ms")
        del args, kw, got, want, old, exact
    check(rows["bf16"]["ms"] <= rows["path"]["ms"],
          f"mlstm: bf16 ({rows['bf16']['ms']:.5f} ms) slower than float32 "
          f"({rows['path']['ms']:.5f} ms)")
    head = rows["path"]
    return dict(source="src/repro_torch/kernels/csrc/mlstm_chunked_tc.cu",
                simt_source="src/repro_torch/kernels/csrc/mlstm_chunked.cu",
                replaces="src/repro/kernels/mlstm.py:90", max_abs_err=max_err,
                library_ms=None, library_call=MLSTM_LIBRARY_NOTE,
                headline="float32, B 8, NH 4, S 512, DH 512, fresh state",
                **head, max_active_clusters=clusters, phases=phases,
                cases=rows)


def xlstm_main_path(torch, cfg, dev):
    """Serve xlstm-350m through the launcher's legacy scheduler
    (Session.serve); checks the exact launch counts, the streams and the
    last logits; returns (launch counts, report, peak GiB)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import xlstm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = launch.main(XLSTM_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_super, n_m = xlstm._layout(cfg)
    want = dict.fromkeys(counts, 0)
    want["mlstm_chunked"] = XREQ * n_super * n_m     # 21 a prefill
    check(counts == want, f"xlstm launches {counts} != {want}")
    routes = check_routes(ops, counts, "xlstm", ("mlstm_chunked",))
    print(f"[xlstm] mlstm_chunked launches by route: "
          f"{routes['mlstm_chunked']}")
    seqs = rep["sequences"]
    check(len(seqs) == XREQ and all(tuple(x.shape) == (XB, XDECODE + 1)
                                    for x in seqs), "xlstm stream shapes")
    check(all(0 <= int(x.min()) and int(x.max()) < cfg.vocab_size
              for x in seqs), "xlstm token id out of range")
    logits = rep["last_logits"]
    check(tuple(logits.shape) == (XB, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "xlstm logits non-finite")
    print(f"[xlstm] {cfg.name}: {XREQ} request batches of {XB} x {XCTX} "
          f"tokens + {XDECODE} decode steps through Session.serve(legacy): "
          f"{rep['total_tokens']} tokens, cold {rep['tokens_per_s']:.1f} "
          f"tok/s, warm {rep['warm_tokens_per_s']:.1f} tok/s, wall "
          f"{wall:.2f} s incl. init; peak device memory {peak:.2f} GiB; "
          f"first row {seqs[0][0, :8].tolist()}; launches {counts}")
    del rep
    torch.cuda.empty_cache()
    return counts, peak, routes["mlstm_chunked"]


def _profiled(torch, fn, n):
    """(wall ms per call, device busy ms per call, top device ops) of
    ``n`` calls of ``fn``, each ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / n / 1e3,
                   e.count // n, e.key[:70])
                  for e in prof.key_averages())[::-1]
    return wall, sum(r[0] for r in rows), rows


def profile_xlstm(torch, cfg, dev):
    """A bf16 prefill of 8 x 512 tokens and a decode step of xlstm-350m:
    wall time, device busy and idle share, top device ops; the prefill
    also with every mLSTM launch sent to the SIMT kernel, in the same
    call. (The cells' heads are float32, so the prefill runs the float32
    mLSTM kernels.)"""
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm
    params = xlstm.init(cfg, seed=0, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (XB, XCTX), generator=g,
                         device=dev, dtype=torch.int32)
    out = {}
    with torch.no_grad():
        st = [xlstm.init_state(cfg, XB, dev)]

        def prefill():
            st[0] = xlstm.init_state(cfg, XB, dev)
            out["logits"] = xlstm.forward(params, cfg, toks, states=st[0],
                                          logits_slice=1)[0]

        def decode():
            tok = out["logits"][:, -1:].argmax(-1).to(torch.int32)
            out["logits"] = xlstm.forward(params, cfg, tok, states=st[0],
                                          step=True)[0]

        prefill()
        res = {}
        best = ops.mlstm_route

        def simt_prefill():
            ops.mlstm_route = lambda dtype, dh: "simt"
            try:
                prefill()
            finally:
                ops.mlstm_route = best

        for name, fn, n in (("prefill", prefill, 2),
                            ("prefill (SIMT mLSTM)", simt_prefill, 2),
                            ("prefill", prefill, 2),
                            ("decode step", decode, 8)):
            wall, busy, rows = _profiled(torch, fn, n)
            mlstm = sum(r[0] for r in rows
                        if any(n in r[2] for n in MLSTM_NAMES.values()))
            res.setdefault(name, []).append((wall, busy, mlstm))
            print(f"[profile] xlstm bf16 {name} (batch {XB}"
                  + (f", {XCTX} tokens" if "prefill" in name else "")
                  + f"): wall {wall:.3f} ms, device busy {busy:.3f} ms "
                  f"(idle {100 * max(0.0, 1 - busy / wall):.1f}%), "
                  f"{sum(r[1] for r in rows)} device ops, mLSTM kernel "
                  f"{mlstm:.3f} ms")
            for t, k, key in rows[:6]:
                print(f"[profile]   {t:.4f} ms in {k:5d} x {key}")
        check(bool(torch.isfinite(out["logits"]).all()),
              "xlstm profile: non-finite logits")
    del params, st, out
    torch.cuda.empty_cache()
    return res


def xlstm_f32_vs_plain(torch, cfg, dev):
    """Float32 prefill (8 x 512 tokens) plus decode steps at full width,
    through the kernel and through the plain version (the path's chunk),
    teacher-forced on the kernel run's greedy tokens: max logit
    difference and greedy agreement."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import xlstm
    c32 = cfg.replace(param_dtype="float32")
    params = xlstm.init(c32, seed=1, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (XB, XCTX), generator=g,
                         device=dev, dtype=torch.int32)

    def run(forced=None):
        logits_all, greedy = [], []
        with torch.no_grad():
            st = xlstm.init_state(c32, XB, dev)
            logits = xlstm.forward(params, c32, toks, states=st,
                                   logits_slice=1)[0]
            for i in range(XLSTM_F32_STEPS + 1):
                logits_all.append(logits)
                greedy.append(logits[:, -1:].argmax(-1).to(torch.int32))
                if i == XLSTM_F32_STEPS:
                    break
                tok = greedy[-1] if forced is None else forced[i]
                logits = xlstm.forward(params, c32, tok, states=st,
                                       step=True)[0]
        torch.cuda.synchronize()
        return logits_all, greedy

    n_super, n_m = xlstm._layout(cfg)
    ops.reset_launch_counts()
    kernel = run()
    check(ops.mlstm_chunked.launches == n_super * n_m, "f32 kernel run: "
          f"launches {ops.mlstm_chunked.launches} != {n_super * n_m}")
    saved = ops.mlstm_chunked

    def plain(q, k, v, ig, lf, *, chunk=64, C0=None, n0=None, m0=None):
        return ref.mlstm_chunkwise_ref(q, k, v, ig, lf, chunk=chunk, C0=C0,
                                       n0=n0, m0=m0)

    ops.mlstm_chunked = plain
    ops.reset_launch_counts()
    try:
        plain_run = run(forced=kernel[1])
    finally:
        ops.mlstm_chunked = saved
    check(sum(ops.launch_counts().values()) == 0,
          "the plain run launched a kernel")
    peak = max(float(l.abs().max()) for l in plain_run[0])
    drift = max(_err(a, b) for a, b in zip(kernel[0], plain_run[0]))
    agree = sum(int((a == b).sum()) for a, b in zip(kernel[1], plain_run[1]))
    total = sum(a.numel() for a in kernel[1])
    check(drift <= XLSTM_LOGIT_RTOL * peak, f"f32 xlstm logits differ by "
          f"{drift:.3e} > {XLSTM_LOGIT_RTOL * peak:.3e}")
    print(f"[xlstm-f32] prefill of {XB} x {XCTX} + {XLSTM_F32_STEPS} decode "
          f"steps, float32, kernel vs plain version (teacher-forced): max "
          f"logit |diff| {drift:.3e} (atol {XLSTM_LOGIT_RTOL * peak:.3e} = "
          f"{XLSTM_LOGIT_RTOL} x largest |logit| {peak:.3f}); greedy "
          f"agreement {agree}/{total}")
    del params, kernel, plain_run
    torch.cuda.empty_cache()
    return drift, agree, total


# ------------------------------------------------------- xLSTM training
def _mlstm_bwd_work(b, nh, s, dh):
    """(bytes, flops) of one backward: q, k, v, h, dh, the gates, the
    saved states (each chunk's C, n, m and every step's m_t, qn_t) read
    once, dq, dk, dv, dig, dlf written once; per (b, h) 8 S DH^2 flops
    for the four products with a DH x DH matrix (dC's recursion, dnum C,
    v dC', k dC'^T), 10 DH per causal pair inside a 64-step chunk for
    its five [c, c] products (q k^T, dnum v^T, P^T dnum, dS k, dS^T q)
    and 2 DH^2 a chunk for <C, dC'>."""
    chunks = [min(MLSTM_CHUNK, s - t) for t in range(0, s, MLSTM_CHUNK)]
    pairs = sum(c * (c + 1) // 2 for c in chunks)
    k = len(chunks)
    nbytes = b * nh * 4 * (8 * s * dh + 6 * s + k * (dh * dh + dh + 1))
    flops = b * nh * (8 * s * dh * dh + 10 * dh * pairs + 2 * k * dh * dh)
    return nbytes, flops


def _mlstm_bwd_phases(torch, ops, args, h, dh, states):
    """{kernel: {phase: share of its CTA cycles}} of one wgmma-route
    launch, from the sweep's and the chunk kernel's clock64() phase
    counters (thread 0 of each CTA)."""
    ns, nc = (len(MLSTM_BWD_PHASES[k]) + 1 for k in ("sweep", "chunk"))
    prof = torch.zeros(ns + nc, dtype=torch.int64, device="cuda")
    ops._mlstm_bwd_card(*args, h, dh, states, route="wgmma", prof=prof)
    torch.cuda.synchronize()
    p = prof.tolist()
    out = {}
    for kern, lo, n in (("sweep", 0, ns), ("chunk", ns, nc)):
        part = p[lo:lo + n]
        out[kern] = {name: x / part[-1]
                     for name, x in zip(MLSTM_BWD_PHASES[kern], part)}
    return out


def mlstm_bwd_checks(torch, dev):
    """The mLSTM backward's two routes against the plain backward on the
    card, on the states the forward kernel saved: the wgmma route
    (csrc/mlstm_chunked_bwd_tc.cu, 3xTF32, what the path launches) and
    the SIMT kernels it replaced (csrc/mlstm_chunked_bwd.cu), at the
    training shape (B 4, NH 4, S 512, DH 512, float32, the fresh state a
    training forward starts from), at a ragged S with an initial state
    and at the ssm FHDP step's one-sample microbatches (B 1 at XF_S_CUT
    and XF_S, fresh). Each case: every gradient of both routes within
    MLSTM_BWD_RTOL of its largest magnitude, two wgmma launches bitwise
    equal, the
    forward with the state writes giving h and the final state bitwise
    those without; cold L2 device times of the two routes in turns (new,
    old, old, new), each route's kernels apart, the plain backward and the
    wgmma forward with and without the state writes, beside the 3xTF32
    and the CUDA-core bounds. The wgmma route must be faster than the
    SIMT one at the training shape. Returns the kernel's JSON row (the
    training shape as the headline)."""
    from repro_torch.kernels import build, ops, ref
    lib = ctypes.CDLL(build.build_report["mlstm_chunked_bwd_tc"]["path"])
    clusters = lib.mlstm_chunked_bwd_tc_clusters(0, XT_B, 4, XT_S)
    n_cl = XT_B * 4 * -(-XT_S // MLSTM_CHUNK)
    print(f"[kernel] mlstm_chunked_bwd wgmma chunk kernel at DH 512 (B "
          f"{XT_B}, NH 4, S {XT_S}: {n_cl} clusters of 8 CTAs, "
          f"{lib.mlstm_chunked_bwd_tc_smem(1)} bytes of shared memory a "
          f"CTA; the sweep {lib.mlstm_chunked_bwd_tc_smem(0)}): "
          f"cudaOccupancyMaxActiveClusters {clusters}, so "
          f"{-(-n_cl // max(1, clusters))} waves")
    cases = [("path", XT_B, 4, XT_S, 512, "fresh"),
             ("ragged S 333, initial state", 2, 4, 333, 512, "random"),
             *((f"FHDP microbatch S {s_}", 1, 4, s_, 512, "fresh")
               for s_ in (XF_S_CUT, XF_S))]
    rows, max_err = {}, 0.0
    for label, b, nh, s, dh, state in cases:
        args, kw = _mlstm_inputs(torch, dev, b, nh, s, dh, torch.float32, 43,
                                 state)
        st = (kw.get("C0"), kw.get("n0"), kw.get("m0"))
        g = torch.Generator(device=dev).manual_seed(44)
        dh_ = torch.randn((b, nh, s, dh), generator=g, device=dev)
        h0, fin0 = ops.mlstm_chunked(*args, **kw)
        h, fin, states = ops.mlstm_chunked(*args, **kw, states=True)
        torch.cuda.synchronize()
        check(ops.mlstm_route(torch.float32, dh) == "wgmma",
              f"mlstm bwd {label}: the forward and the backward are not on "
              f"the wgmma route")
        check(torch.equal(h, h0) and all(torch.equal(x, y)
                                         for x, y in zip(fin, fin0)),
              f"mlstm {label}: the forward with state writes is not "
              f"bitwise the serving forward")
        before = dict(ops.route_counts()["mlstm_chunked_bwd"])
        got = ops.mlstm_chunked_bwd(*args, h, dh_, states)
        again = ops.mlstm_chunked_bwd(*args, h, dh_, states)
        old = ops._mlstm_bwd_card(*args, h, dh_, states, route="simt")
        want = ref.mlstm_chunkwise_bwd_ref(*args, h, dh_, states,
                                           chunk=MLSTM_CHUNK)
        torch.cuda.synchronize()
        after = ops.route_counts()["mlstm_chunked_bwd"]
        check(after == {"wgmma": before["wgmma"] + 2,
                        "simt": before["simt"] + 1},
              f"mlstm bwd {label}: launches by route {after} after "
              f"{before}")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"mlstm bwd {label}: two wgmma launches differ")
        errs = {"wgmma": {}, "simt": {}}
        for i, name in enumerate(("dq", "dk", "dv", "dig", "dlf")):
            y = want[i]
            peak = float(y.abs().max())
            for route, x in (("wgmma", got[i]), ("simt", old[i])):
                check(bool(torch.isfinite(x).all()),
                      f"mlstm bwd {label} {name} ({route}): non-finite")
                err = _err(x, y)
                errs[route][name] = err / peak
                check(err <= MLSTM_BWD_RTOL * peak, f"mlstm bwd {label} "
                      f"{name} ({route}): max err {err:.3e} > "
                      f"{MLSTM_BWD_RTOL * peak:.3e}")
                if route == "wgmma":
                    max_err = max(max_err, err)
        new_fn = (lambda: ops.mlstm_chunked_bwd(*args, h, dh_, states))
        old_fn = (lambda: ops._mlstm_bwd_card(*args, h, dh_, states,
                                              route="simt"))
        turns = [("wgmma", new_fn), ("simt", old_fn), ("simt", old_fn),
                 ("wgmma", new_fn)]
        dev_ms = {"wgmma": [], "simt": []}
        for route, fn in turns:
            dev_ms[route].append(device_ms(fn, MLSTM_BWD_NAME, iters=20))
        ms, old_ms = (sum(dev_ms[r]) / 2 for r in ("wgmma", "simt"))
        split = {f"wgmma {part}": device_ms(new_fn, f"mlstm_bwd_tc_{part}",
                                            iters=20)
                 for part in ("gates", "sweep", "chunk")}
        split.update({f"simt {part}": device_ms(old_fn, f"mlstm_bwd_{part}",
                                                iters=20)
                      for part in ("sweep", "chunk")})
        plain = device_ms(lambda: ref.mlstm_chunkwise_bwd_ref(
            *args, h, dh_, states, chunk=MLSTM_CHUNK), None, iters=5)
        phases = _mlstm_bwd_phases(torch, ops, args, h, dh_, states)
        print(f"[kernel] mlstm_chunked_bwd wgmma phase split, {label} (clock64"
              f" between the points thread 0 of every CTA passes, summed): "
              + "; ".join(f"{k}: " + ", ".join(
                  f"{n} {100 * x:.1f}%" for n, x in ph.items())
                  for k, ph in phases.items()))
        fwd = device_ms(lambda: ops._mlstm_card(*args, *st),
                        MLSTM_NAMES["wgmma"], iters=20)
        fwd_st = device_ms(lambda: ops._mlstm_card(*args, *st, states=True),
                           MLSTM_NAMES["wgmma"], iters=20)
        nbytes, flops = _mlstm_bwd_work(b, nh, s, dh)
        b_ms, b_by = bound(nbytes, flops, TF32X3_FLOPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        spread = max(abs(t[0] - t[1]) for t in dev_ms.values())
        rows[label] = dict(ms=ms, simt_ms=old_ms, ms_turns=dev_ms["wgmma"],
                           simt_ms_turns=dev_ms["simt"], split_ms=split,
                           phases=phases,
                           plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                           fwd_ms=fwd, fwd_states_ms=fwd_st, rel_err=errs,
                           faster=ms < old_ms, turns_spread_ms=spread,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6)
        print(f"[kernel] mlstm_chunked_bwd {label} (B {b}, NH {nh}, S {s}, "
              f"DH {dh}, float32, initial state {state}): max|err| / largest"
              f" |grad| vs the plain backward, wgmma " + ", ".join(
                  f"{n} {e:.2e}" for n, e in errs["wgmma"].items())
              + "; simt " + ", ".join(
                  f"{n} {e:.2e}" for n, e in errs["simt"].items())
              + f" (rtol {MLSTM_BWD_RTOL}); two wgmma launches bitwise; "
              f"device (turns new, old, old, new): wgmma "
              f"{dev_ms['wgmma'][0]:.5f}/{dev_ms['wgmma'][1]:.5f} ms, simt "
              f"{dev_ms['simt'][0]:.5f}/{dev_ms['simt'][1]:.5f} ms (new/old "
              f"{ms / old_ms:.3f}); apart: " + ", ".join(
                  f"{k} {v:.5f} ms" for k, v in split.items())
              + f"; plain {plain:.5f} ms; bounds 3xTF32 ("
              f"{TF32X3_FLOPS_PER_S / 1e12:.0f} TFLOP/s) {b_ms:.5f} ms "
              f"({b_by}), float32 CUDA cores {f32_ms:.5f} ms ({f32_by}); "
              f"{flops / 1e9:.2f} GFLOP and {nbytes / 1e6:.1f} MB needed; "
              f"wgmma {flops / ms / 1e9:.1f} TFLOP/s of needed work; the "
              f"wgmma forward {fwd:.5f} ms, with the state writes "
              f"{fwd_st:.5f} ms; forward with state writes bitwise the "
              f"serving forward")
        print(f"[kernel] mlstm_chunked_bwd {label}: wgmma "
              f"{'faster' if ms < old_ms else 'NOT faster'} than simt "
              f"({ms:.5f} against {old_ms:.5f} ms, turns' spread "
              f"{spread:.5f} ms)")
        if label == "path":
            check(ms < old_ms, f"mlstm bwd {label}: the wgmma route "
                  f"({ms:.5f} ms) is not faster than the simt kernels "
                  f"({old_ms:.5f} ms)")
        del args, kw, h, fin, states, got, again, old, want, h0, fin0, dh_
        torch.cuda.empty_cache()
    head = rows["path"]
    return dict(source="src/repro_torch/kernels/csrc/mlstm_chunked_bwd_tc.cu",
                simt_source="src/repro_torch/kernels/csrc/mlstm_chunked_bwd.cu",
                replaces="src/repro/models/recurrent.py:114 (no Pallas "
                "kernel: XLA differentiates mlstm_chunk_body)",
                max_abs_err=max_err, library_ms=None,
                library_call=MLSTM_BWD_LIBRARY_NOTE,
                headline=f"float32, B {XT_B}, NH 4, S {XT_S}, DH 512, fresh "
                "state", max_active_clusters=clusters,
                **{k: head[k] for k in ("ms", "simt_ms", "split_ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "f32_bound_ms", "fwd_ms",
                                        "fwd_states_ms")},
                cases=rows)


def _xt_wire(cfg):
    """(uplink bytes, backhaul bytes, sim round s) of one xLSTM round
    from the topology's formulas: each vehicle sends every leaf as int8
    codes plus a float32 scale a 128-wide row; 2 pods of one vehicle
    each (nano, agx), each pod's partial average over the backhaul."""
    from repro_torch.models import xlstm
    from repro_torch.tree import leaves
    sizes = [t.numel() for t in leaves(xlstm.abstract_params(cfg))]
    per = sum(n + 4 * -(-n // 128) for n in sizes)
    arrivals = [per / bps + per / BACKHAUL_BPS + BACKHAUL_S
                for bps in (NANO_BPS, AGX_BPS)]
    return XT_CLIENTS * per, 2 * per, max(arrivals), len(sizes)


def xlstm_train_main_path(torch, cfg, dev):
    """Two hier_fl rounds of xlstm-350m at full width through the
    launcher; checks the exact launches (the mLSTM forward twice a layer
    and step, the recompute of the checkpointed layer; the backward once;
    one quantize and one dequantize a leaf, vehicle and round), finite
    losses, moved params and the wire metrics. Returns (launch counts,
    routes, summary)."""
    import math
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import xlstm
    from repro_torch.tree import leaves
    n_super, n_m = xlstm._layout(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch.main(XT_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    up, backhaul, sim, n_leaves = _xt_wire(cfg)
    steps = ROUNDS * XT_CLIENTS * LOCAL_STEPS
    want = dict.fromkeys(counts, 0)
    want.update(mlstm_chunked=2 * steps * n_super * n_m,
                mlstm_chunked_bwd=steps * n_super * n_m,
                quantize_int8=ROUNDS * XT_CLIENTS * n_leaves,
                dequantize_int8=ROUNDS * XT_CLIENTS * n_leaves)
    check(counts == want, f"xlstm training launches {counts} != {want}")
    routes = check_routes(ops, counts, "xlstm training",
                          ("mlstm_chunked", "mlstm_chunked_bwd"))
    hist = out["history"]
    check(len(hist) == ROUNDS, "one history entry per round")
    for h in hist:
        check(bool(np.isfinite(h["per_client/loss"]).all()),
              f"xlstm training: non-finite loss in round {h['round']}")
        check(h["comm_bytes_up"] == up, f"xlstm comm_bytes_up "
              f"{h['comm_bytes_up']} != {up}")
        check(h["comm_bytes_backhaul"] == backhaul, f"xlstm "
              f"comm_bytes_backhaul {h['comm_bytes_backhaul']} != {backhaul}")
        check(math.isclose(h["sim_round_s"], sim, rel_tol=1e-12),
              f"xlstm sim_round_s {h['sim_round_s']} != {sim}")
    with torch.no_grad():
        merged = leaves(out["session"].merged_params())
        init = leaves(xlstm.init(cfg, seed=0, device=dev).to_dict())
        moved = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(merged, init)]
        check(all(bool(torch.isfinite(t).all()) for t in merged),
              "xlstm training: non-finite global params")
    names = _leaf_names(out["session"].merged_params())
    # the bf16 norm scales stay (lr 1e-3 is under half a bf16 ulp at 1.0)
    check(all(m > 0 for m, n in zip(moved, names)
              if not n.split(".")[-1] in ("ln", "gn", "scale")),
          f"an xlstm weight did not move: {dict(zip(names, moved))}")
    losses = [float(np.mean(h["per_client/loss"])) for h in hist]
    tokens = steps * XT_B * XT_S
    print(f"[xlstm-train] {cfg.name} hier_fl {ROUNDS} rounds x {XT_CLIENTS} "
          f"vehicles ({XT_TOPOLOGY}) x {LOCAL_STEPS} local steps at "
          f"{XT_S}x{XT_B}, int8 uplinks, bf16: wall {wall:.1f} s incl. "
          f"set-up ({tokens / wall:.0f} tokens/s); losses by round "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; peak device memory {peak:.2f} GiB; wire per round: up {up} "
          f"B, backhaul {backhaul} B, sim {sim:.4f} s (the topology's "
          f"formulas); launches {counts}; by route "
          f"{ {k: routes[k] for k in ('mlstm_chunked', 'mlstm_chunked_bwd')} }"
          f"; largest change per leaf " + ", ".join(
              f"{n} {m:.2e}" for n, m in zip(names, moved)))
    summary = dict(wall_s=wall, losses=losses, peak_gib=peak,
                   comm_bytes_up=up, comm_bytes_backhaul=backhaul,
                   sim_round_s=sim, launches=counts)
    del out, merged, init
    torch.cuda.empty_cache()
    return counts, routes, summary


def _plain_mlstm(ref, chunk=None):
    """The plain chunkwise mLSTM with autograd (at the caller's chunk, or
    at ``chunk``), in place of the forward and backward kernels."""
    def mlstm_chunked(q, k, v, ig, lf, *, chunk=64, C0=None, n0=None,
                      m0=None, _fixed=chunk):
        return ref.mlstm_chunkwise_ref(q, k, v, ig, lf, chunk=_fixed or chunk,
                                       C0=C0, n0=n0, m0=m0)
    return mlstm_chunked


def xlstm_step_vs_plain(torch, cfg, dev):
    """One float32 local train step of xlstm-350m at full width (B 4, S
    512), through the mLSTM kernels and through the plain chunkwise
    version with autograd (at the path's chunk, 256): loss, grads and
    updated params, held to the flad-adllm step's limits (STEP_LOSS_ATOL,
    STEP_GRAD_RTOL, STEP_PARAM_ATOL).

    What STEP_PARAM_ATOL holds differs from the flad-adllm step. Adam's
    first step moves a param by u(g) = lr g / (|g| + eps), about lr
    sign(g) (g after the global-norm clip), so a grad at float32 noise
    moves it by up to 2 lr either
    way; the flad-adllm step exempts |g| < NEAR_EPS, but here grads well
    above that sit at the noise of their leaf's sums (the plain version
    against itself at the kernels' chunk, 64, printed as the yardstick,
    fails that rule too). So each updated param is held to STEP_PARAM_ATOL
    beyond |u(g_kernel) - u(g_plain)|, the move its two grads explain,
    which the grad check holds."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import xlstm
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import Adam, global_norm
    from repro_torch.tree import flatten, leaves, unflatten
    c32 = cfg.replace(param_dtype="float32")
    params = xlstm.init(c32, seed=1, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab_size, (XT_B, XT_S), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    opt = Adam(lr=1e-3)
    flat, spec = flatten(params)
    n_super, n_m = xlstm._layout(cfg)

    def run():
        """The local step as make_train_step takes it (the loss with
        every layer checkpointed, its grads, one Adam update), keeping
        the grads the update used."""
        live = [p.detach().requires_grad_() for p in flat]
        loss, _ = build_model(c32).loss(unflatten(spec, live), batch)
        grads = torch.autograd.grad(loss, live)
        new, _ = opt.update(unflatten(spec, list(grads)), opt.init(params),
                            unflatten(spec, [p.detach() for p in flat]))
        torch.cuda.synchronize()
        return float(loss.detach()), grads, leaves(new)

    def plain_grads(chunk):
        live = [p.detach().requires_grad_() for p in flat]
        saved = ops.mlstm_chunked_ad, ops.mlstm_chunked
        ops.mlstm_chunked_ad = ops.mlstm_chunked = _plain_mlstm(ref, chunk)
        try:
            loss, _ = build_model(c32).loss(unflatten(spec, live), batch)
            return torch.autograd.grad(loss, live)
        finally:
            ops.mlstm_chunked_ad, ops.mlstm_chunked = saved

    ops.reset_launch_counts()
    kernel = run()
    counts = ops.launch_counts()
    check(counts["mlstm_chunked"] == 2 * n_super * n_m
          and counts["mlstm_chunked_bwd"] == n_super * n_m,
          f"float32 xlstm step launches {counts}")
    saved = ops.mlstm_chunked_ad, ops.mlstm_chunked
    ops.mlstm_chunked_ad = ops.mlstm_chunked = _plain_mlstm(ref)
    ops.reset_launch_counts()
    try:
        plain = run()
    finally:
        ops.mlstm_chunked_ad, ops.mlstm_chunked = saved
    plain64 = plain_grads(MLSTM_CHUNK)
    check(sum(ops.launch_counts().values()) == 0,
          "the plain xlstm step launched a kernel")
    dloss = abs(kernel[0] - plain[0])
    check(dloss <= STEP_LOSS_ATOL, f"f32 xlstm step loss differs by {dloss}")
    grad_rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(kernel[1], plain[1])]
    names = _leaf_names(params)
    check(max(grad_rel) <= STEP_GRAD_RTOL, f"f32 xlstm step grads differ: "
          f"{dict(zip(names, grad_rel))}")
    def clip(grads):
        """The grads as Adam's global-norm clip hands them to the step."""
        norm = float(global_norm(unflatten(spec, list(grads))))
        scale = min(1.0, opt.grad_clip / (norm + 1e-9))
        return [x * scale for x in grads]

    def first_step(x):
        return opt.lr * x / (x.abs() + opt.eps)

    worst = worst_raw = 0.0
    explained = 0
    for a, b, ga, gb in zip(kernel[2], plain[2], clip(kernel[1]),
                            clip(plain[1])):
        d = (a - b).abs()
        moved = (first_step(ga) - first_step(gb)).abs()
        worst = max(worst, float((d - moved).max()))
        worst_raw = max(worst_raw, float(d.max()))
        explained += int((d > STEP_PARAM_ATOL).sum())
    check(worst <= STEP_PARAM_ATOL, f"f32 xlstm step: updated params differ "
          f"by {worst:.3e} > {STEP_PARAM_ATOL} beyond what their grads "
          f"explain")

    def first_step_apart(ga, gb):
        """Params whose first Adam step lr g / (|g| + eps) differs by more
        than STEP_PARAM_ATOL, off the |g| < NEAR_EPS ones (the flad-adllm
        rule)."""
        n = 0
        for x, y in zip(ga, gb):
            d = first_step(x) - first_step(y)
            near = torch.minimum(x.abs(), y.abs()) < NEAR_EPS
            n += int(((d.abs() > STEP_PARAM_ATOL) & ~near).sum())
        return n

    kernel_rule = first_step_apart(clip(kernel[1]), clip(plain[1]))
    plain_rule = first_step_apart(clip(plain64), clip(plain[1]))
    print(f"[xlstm-step] float32 local step of {cfg.name} ({XT_B}x{XT_S}), "
          f"mLSTM kernels vs the plain chunkwise version with autograd: "
          f"loss {kernel[0]:.6f} vs {plain[0]:.6f} (|diff| {dloss:.2e}, atol "
          f"{STEP_LOSS_ATOL}); grads max |diff| / leaf max {max(grad_rel):.2e}"
          f" (rtol {STEP_GRAD_RTOL}; worst leaf "
          f"{names[int(np.argmax(grad_rel))]}); updated params max |diff| "
          f"{worst:.2e} beyond the first-step move their grads explain "
          f"(atol {STEP_PARAM_ATOL}), {worst_raw:.2e} raw, {explained} "
          f"params over {STEP_PARAM_ATOL} raw; under the flad-adllm step's "
          f"rule (|g| < "
          f"{NEAR_EPS} exempt) {kernel_rule} params' first steps differ by "
          f"more than {STEP_PARAM_ATOL}, and {plain_rule} between the plain "
          f"version at chunk {MLSTM_CHUNK} and at 256; kernel launches "
          f"{counts}")
    del kernel, plain, params, flat, plain64
    torch.cuda.empty_cache()
    return dict(dloss=dloss, grad_rel=max(grad_rel), param_diff=worst,
                param_diff_raw=worst_raw, params_apart_raw=explained,
                flad_rule_apart=kernel_rule,
                flad_rule_apart_plain_vs_plain=plain_rule)


def profile_xlstm_step(torch, cfg, dev, steps=1):
    """A warm bf16 local train step of xlstm-350m at full width (one
    vehicle, 4 x 512 tokens): wall time, tokens/s, device busy and idle
    share, top device ops, peak memory and the mLSTM kernels' share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import ShapeConfig
    from repro_torch.core.steps import make_train_step
    from repro_torch.models import xlstm
    from repro_torch.train.optimizer import Adam
    params = xlstm.init(cfg, seed=2, device=dev).to_dict()
    g = torch.Generator(device=dev).manual_seed(12)
    batch = {k: torch.randint(0, cfg.vocab_size, (XT_B, XT_S), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    opt = Adam(lr=1e-3)
    step = make_train_step(cfg, ShapeConfig("cli", XT_S, XT_B, "train"), opt)
    state = [params, opt.init(params)]

    def run(n):
        for _ in range(n):
            state[0], state[1], _ = step(state[0], state[1], batch)
        torch.cuda.synchronize()

    run(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps)
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:70])
                  for e in prof.key_averages())[::-1]
    busy = sum(r[0] for r in rows)
    ops_per_step = sum(r[1] for r in rows)
    fwd = sum(r[0] for r in rows if MLSTM_NAMES["wgmma"] in r[2])
    bwd = sum(r[0] for r in rows if MLSTM_BWD_NAME in r[2])
    idle = max(0.0, 1 - busy / wall)
    print(f"[profile] bf16 xlstm local train step, {XT_B}x{XT_S} tokens: wall "
          f"{wall:.3f} ms, {XT_B * XT_S / wall * 1e3:.0f} tokens/s, device "
          f"busy {busy:.3f} ms (idle {100 * idle:.1f}%), {ops_per_step} device"
          f" ops/step, peak memory {peak:.2f} GiB; mLSTM forward kernel "
          f"{fwd:.3f} ms, backward kernels {bwd:.3f} ms "
          f"({100 * (fwd + bwd) / busy:.1f}% of device time)")
    for t, n, key in rows[:10]:
        print(f"[profile]   {t:.4f} ms/step in {n:5d} x {key}")
    del state, params
    torch.cuda.empty_cache()
    return dict(wall_ms=wall, busy_ms=busy, idle=idle, peak_gib=peak,
                ops=ops_per_step, mlstm_fwd_ms=fwd, mlstm_bwd_ms=bwd,
                top=[(t, n, key) for t, n, key in rows[:10]])


# --------------------------------------------------------------- main path
def serve_main_path(torch, cfg, params, dev):
    """Serve a fleet trace with both cache modes; returns launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serve import serve_continuous
    totals = dict.fromkeys(ops.launch_counts(), 0)
    routes = {fn: dict.fromkeys(ops.route_counts()[fn], 0)
              for fn in SERVE_PAGED}
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
        want = dict.fromkeys(counts, 0)
        want.update({
            # every decode step's layer one fused launch (the append inside
            # the decode kernel), no stand-alone decode
            FUSED: passes * L * rep["decode_steps"],
            "paged_prefill_attention": passes * L * rep["prefill_chunks"],
            # one K/V append launch a layer and prefill chunk in int8
            # mode; the quantizer serves the codec only
            "quantize_kv_append": (passes * L * rep["prefill_chunks"]
                                   if cache == "int8" else 0),
        })
        check(counts == want, f"{cache}: launches {counts} != {want}")
        by_route = check_routes(ops, counts, cache, SERVE_PAGED)
        for fn in SERVE_PAGED:     # bf16 q over bf16 or int8 pools
            for r, n in by_route[fn].items():
                routes[fn][r] += n
        for name in totals:
            totals[name] += counts[name]
        print(f"[serve] cache={cache}: {rep['requests']} requests, "
              f"{rep['total_new_tokens']} tokens, {rep['decode_steps']} "
              f"decode steps, {rep['prefill_chunks']} prefill chunks; warm "
              f"{rep['warm_tokens_per_s']:.1f} tok/s (cold "
              f"{rep['tokens_per_s']:.1f}); launches {counts}; paged "
              f"launches by route " + ", ".join(
                  f"{fn} {by_route[fn]}" for fn in SERVE_PAGED))
        reports[cache] = rep
    for name in (FUSED, "paged_prefill_attention", "quantize_kv_append"):
        check(totals[name] > 0, f"{name} was never launched serving")
    check(totals["quantize_int8"] == 0, "serving launched quantize_int8")
    return totals, reports, routes


def _serve_trace(cfg, params, dev, cache, **kw):
    """The serving path's fleet trace through serve_continuous (a cold and
    a warm pass), as serve_main_path runs it."""
    from repro_torch.serve import serve_continuous
    return serve_continuous(
        cfg, params=params, device=dev, cache=cache, prefill="chunked",
        prefill_chunk=CHUNK, slots=SLOTS, block_size=BLOCK, max_context=128,
        warm_passes=1, log_fn=None, **TRACE, **kw)


def _spec_launches(cfg, rep, cache):
    """The launches a speculative run of the trace makes, two passes:
    each prefill chunk twice (the target's and the draft's mirror), each
    speculative step SPEC_K + 1 draft decode forwards and one verify. A
    bf16 run's draft decodes are fused launches (the append inside the
    decode kernel) and its int8 cache appends with a launch of its own
    for every prefill chunk and verify; a float32 run (the SIMT route)
    appends first for every one of those forwards, draft decodes
    included, and launches the stand-alone decode."""
    L, passes = cfg.num_layers, 2
    steps, chunks = rep["spec_steps"], rep["prefill_chunks"]
    fused = cfg.param_dtype == "bfloat16"
    decodes = passes * L * (SPEC_K + 1) * steps
    appends = 2 * chunks + (1 if fused else SPEC_K + 2) * steps
    return {FUSED if fused else "paged_decode_attention": decodes,
            "paged_prefill_attention": passes * L * 2 * chunks,
            "paged_verify_attention": passes * L * steps,
            "quantize_kv_append": (passes * L * appends
                                   if cache == "int8" else 0)}


def _equal_tokens(got, want):
    """Stream tokens of ``got`` equal to ``want``'s at the same place."""
    return sum(int(a == b) for rid in want
               for a, b in zip(got[rid], want[rid]))


def spec_main_path(torch, cfg, params, dev, plain):
    """Speculative decoding of flad-adllm at full width and depth through
    serve_continuous(speculative=True) on the serving path's trace:
      * float32 params (the bf16 weights cast up), fp32 and int8 caches,
        each with a self-draft and with a random draft (seed 7, rejected
        nearly always: every step rolls back): the streams must equal
        plain decode's bitwise (the reference's contract), with the exact
        launch counts, every paged launch on the SIMT route;
      * bf16 params (the serving path's), both caches, self-draft:
        reported (acceptance, tokens/s, stream tokens equal to plain
        decode's from ``plain``), not gated on equality: the verify's
        k+1-row products round differently from decode's one-row ones;
        every paged launch on its Hopper route; then the same runs with
        the verify swapped for two probes, P rounded once (the verify
        before the split) and every row through the decode kernel,
        reported alone: their launches are in no count returned;
      * a preemption run (float32, a tight block cap, a later request
        with a tighter deadline) whose streams equal the run without
        preemption.
    Every run's counts start at zero and are read right after it. Returns
    (launch counts summed over the runs, the paged wrappers' launches by
    route summed likewise, the summary printed)."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    paged = (*SERVE_PAGED, "paged_verify_attention")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    spec_routes = {fn: dict.fromkeys(ops.route_counts()[fn], 0)
                   for fn in paged}
    summary = {}

    def run(c, p, cache, route, **kw):
        """One run of the main path: its counts added to the totals and,
        speculative, gated exactly."""
        ops.reset_launch_counts()
        rep = _serve_trace(c, p, dev, cache, **kw)
        counts = ops.launch_counts()
        routes = ops.route_counts()
        for name in totals:
            totals[name] += counts[name]
        for fn in paged:
            for r, n in routes[fn].items():
                spec_routes[fn][r] += n
        check(rep["requests"] == 12 and rep["unstarted_requests"] == 0,
              "spec: not every request finished")
        if kw.get("speculative"):
            want = dict.fromkeys(counts, 0)
            want.update(_spec_launches(c, rep, cache))
            check(counts == want, f"spec {c.param_dtype} {cache}: launches "
                  f"{counts} != {want}")
            hopper = {f.__name__: key for f, key in ops.ROUTED.items()}
            for fn in paged:
                fast = route if route == "simt" else hopper[fn]
                check(routes[fn] == {**dict.fromkeys(routes[fn], 0),
                                     fast: counts[fn]},
                      f"spec {c.param_dtype} {cache}: {fn} launches by "
                      f"route {routes[fn]}, want all on {fast}")
        return rep, counts

    # float32 at full width: the gate
    c32 = cfg.replace(param_dtype="float32")
    p32 = lm.LM(c32, _cast(params.to_dict(), torch.float32))
    rand32 = lm.init(c32, seed=7, device=dev)
    for cache in ("fp32", "int8"):
        base, _ = run(c32, p32, cache, "simt")
        for draft, dp in (("self", None), ("random", rand32)):
            rep, counts = run(c32, p32, cache, "simt", speculative=True,
                              draft_k=SPEC_K, draft_params=dp)
            eq = _equal_tokens(rep["sequences"], base["sequences"])
            n = sum(len(x) for x in base["sequences"].values())
            key = f"float32 cache={cache} draft={draft}"
            summary[key] = dict(acceptance=rep["acceptance_rate"],
                                equal_tokens=eq, tokens=n,
                                spec_steps=rep["spec_steps"],
                                warm_tokens_per_s=rep["warm_tokens_per_s"],
                                plain_warm_tokens_per_s=base[
                                    "warm_tokens_per_s"],
                                preemptions=rep["preemptions"])
            print(f"[spec] {key}: acceptance {rep['acceptance_rate']:.4f} "
                  f"({rep['accepted_drafts']}/{rep['proposed_drafts']}), "
                  f"{rep['spec_steps']} spec steps, {rep['total_new_tokens']}"
                  f" tokens, warm {rep['warm_tokens_per_s']:.1f} tok/s "
                  f"(plain decode {base['warm_tokens_per_s']:.1f}), "
                  f"{rep['preemptions']} preemptions; streams vs plain "
                  f"decode {eq}/{n} tokens equal; launches {counts}")
            check(rep["sequences"] == base["sequences"], f"{key}: the "
                  f"speculative streams differ from plain decode's "
                  f"({eq}/{n} tokens equal)")
            if draft == "self":
                check(rep["acceptance_rate"] == 1.0,
                      f"{key}: a self-draft's acceptance "
                      f"{rep['acceptance_rate']} != 1.0")
            else:
                check(rep["acceptance_rate"] < 0.2 and
                      rep["proposed_drafts"] > 0,
                      f"{key}: a random draft's acceptance "
                      f"{rep['acceptance_rate']} is not below 0.2")
        del base
    del rand32
    torch.cuda.empty_cache()

    # bf16, the serving path's params: the main path (the verify with P
    # split), then two probes, each with ops.paged_verify_attention
    # swapped for a stand-in that counts nothing: P rounded once (the
    # verify before the split) and every window row through the decode
    # kernel's arithmetic. A probe's launches stay out of the totals.
    route = ops.paged_route("prefill", torch.bfloat16, torch.bfloat16,
                            cfg.hd, BLOCK)
    probes = {"before": _verify_p_rounded_once(ops, route),
              "rows by decode": _verify_by_decode(torch, ops)}
    first = None
    for cache in ("fp32", "int8"):
        want = plain[cache]["sequences"]
        n = sum(len(x) for x in want.values())
        for when in ("after", *probes):
            if when == "after":
                rep, counts = run(cfg, params, cache, "fast",
                                  speculative=True, draft_k=SPEC_K)
            else:
                rep, counts = _probe_run(torch, ops, probes[when], cfg,
                                         params, dev, cache)
            eq = _equal_tokens(rep["sequences"], want)
            key = f"bfloat16 cache={cache} draft=self {when}"
            summary[key] = dict(acceptance=rep["acceptance_rate"],
                                equal_tokens=eq, tokens=n,
                                spec_steps=rep["spec_steps"],
                                warm_tokens_per_s=rep["warm_tokens_per_s"],
                                plain_warm_tokens_per_s=plain[cache][
                                    "warm_tokens_per_s"],
                                preemptions=rep["preemptions"])
            print(f"[spec] {key}: acceptance "
                  f"{rep['acceptance_rate']:.4f} ({rep['accepted_drafts']}/"
                  f"{rep['proposed_drafts']}), {rep['spec_steps']} spec "
                  f"steps, warm {rep['warm_tokens_per_s']:.1f} tok/s (plain "
                  f"decode {plain[cache]['warm_tokens_per_s']:.1f}); streams "
                  f"vs plain decode {eq}/{n} tokens equal (bf16: reported, "
                  f"not gated); launches {counts}"
                  + ("" if when == "after" else " (a probe: not the main "
                     "path's, counted nowhere)"))
            if when == "after" and first is None and eq < n:
                first = _first_difference(rep["sequences"], want, cache)
    if first is not None:
        summary["bf16 first difference"] = spec_probe(
            torch, cfg, params, dev, first,
            {"after": ops.paged_verify_attention,
             "rows by decode": probes["rows by decode"]})

    summary["preemption"] = preemption_run(torch, c32, p32, dev)
    del p32
    torch.cuda.empty_cache()
    check(totals["paged_verify_attention"] > 0,
          "the speculative runs never launched the verify kernel")
    return totals, spec_routes, summary


def _probe_run(torch, ops, verify, cfg, params, dev, cache):
    """The bf16 self-drafted speculative run with
    ``ops.paged_verify_attention`` swapped for ``verify``. Returns (the
    run's report, the counts it left: its stand-in's launches are in no
    count)."""
    wrapper = ops.paged_verify_attention
    ops.reset_launch_counts()
    ops.paged_verify_attention = verify
    try:
        rep = _serve_trace(cfg, params, dev, cache, speculative=True,
                           draft_k=SPEC_K)
    finally:
        ops.paged_verify_attention = wrapper
    return rep, ops.launch_counts()


def _verify_p_rounded_once(ops, route):
    """A stand-in for ``ops.paged_verify_attention`` (bf16 q, the wgmma
    route) with P rounded once to bf16 before P V, the verify before the
    split; it counts nothing."""
    def verify(q, k, v, tables, ctx, win, *, scale=None, k_scales=None,
               v_scales=None):
        return _verify_launch(ops, route, q, k, v, tables, ctx, win,
                              scale if scale is not None
                              else q.shape[-1] ** -0.5, k_scales, v_scales,
                              split_p=False)
    return verify


def _verify_by_decode(torch, ops):
    """A stand-in for ``ops.paged_verify_attention`` (a probe, counting
    nothing) that computes every window row with the paged decode
    kernel's arithmetic: one launch of the TMA decode kernel over the B x
    C (lane, row) pairs, row c of lane b seeing ctx[b] + c + 1 keys
    through lane b's table, the keys split as for B lanes (the plan the
    serving path's decode step takes)."""
    def verify(q, k, v, tables, ctx, win, *, scale=None, k_scales=None,
               v_scales=None):
        b, hq, c, d = q.shape
        scale = scale if scale is not None else d ** -0.5
        qd = q.transpose(1, 2).reshape(b * c, hq, d).contiguous()
        td = tables.repeat_interleave(c, dim=0).contiguous()
        cols = torch.arange(c, dtype=torch.int32, device=q.device)
        seen = torch.where(cols[None] < win[:, None],
                           ctx[:, None] + cols[None] + 1, 0)
        seen = seen.reshape(-1).to(torch.int32).contiguous()
        out = torch.empty_like(qd)
        err = ops._decode_tma_launch(qd, k, v, td, seen, scale, k_scales,
                                     v_scales, out, b)
        check(err == 0, f"the decode kernel over verify rows: error {err}")
        return out.reshape(b, c, hq, d).transpose(1, 2).contiguous()
    return verify


def _first_difference(got, want, cache):
    """(cache, rid, index, want's stream) of the first stream token of
    ``got`` that differs from ``want`` (the lowest rid with one)."""
    for rid in sorted(want):
        for j, (a, b) in enumerate(zip(got[rid], want[rid])):
            if a != b:
                return cache, rid, j, list(want[rid])
    return None


def spec_probe(torch, cfg, params, dev, first, variants):
    """Where a bf16 verify row and the decode step part, at the position
    of a stream's first differing token, under the serving path's shapes
    (SLOTS lanes, the other lanes dead, so every product has the rows it
    has there: SLOTS for decode, SLOTS x (SPEC_K + 1) for the verify):
    the request's prompt and plain stream up to that token are prefilled
    by chunks into lane 0's pools; then the pending token's decode step
    and a verify window starting at the same position (the pending token
    and the plain stream's next tokens) run on the same pools, each
    layer's intermediates recorded for lane 0's row at that position (row
    0 of the window, which attends the same keys as the decode step).
    ``variants``: {name: ops.paged_verify_attention or a stand-in for it}
    to probe each verify arithmetic (the route, rows through the decode
    kernel). Prints
    and returns, for each, layer by layer and operation by operation,
    whether the two are bitwise equal and how far apart, and names the
    first operation where they part."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.serve import (PagedCacheSpec, PagedEngine,
                                   generate_fleet_requests)
    cache, rid, j, plain = first
    reqs = {r.rid: r for r in generate_fleet_requests(
        TRACE["fleet"], num_requests=TRACE["num_requests"],
        max_prompt=TRACE["max_prompt"], seed=TRACE["seed"], deadline_s=4.0,
        vocab_size=cfg.vocab_size)}
    stream = list(reqs[rid].prompt) + list(plain)
    pos = len(reqs[rid].prompt) + j - 1       # the pending token's position
    c = SPEC_K + 1
    window = np.zeros((SLOTS, c), np.int32)
    live = stream[pos:pos + c]
    window[0, :len(live)] = live
    spec = PagedCacheSpec.for_requests(SLOTS, max(len(stream) + c, 128),
                                       block_size=BLOCK,
                                       quantized=cache == "int8")
    eng = PagedEngine(cfg, spec, max_context=128, slots=SLOTS, device=dev)
    tables = np.zeros((SLOTS, spec.max_blocks_per_req), np.int32)
    tables[0] = np.arange(1, spec.max_blocks_per_req + 1)
    one = np.zeros(SLOTS, np.int32)
    ctx, tok, win = one.copy(), one.copy(), one.copy()
    ctx[0], tok[0], win[0] = pos, stream[pos], len(live)
    names = ("ln1", "q", "k", "v", "attention", "wo + residual", "ln2",
             "mlp", "block out")

    def prefilled():
        pools = eng.init_pools()
        for lo in range(0, pos, CHUNK):
            n = min(CHUNK, pos - lo)
            buf = np.zeros(CHUNK, np.int32)
            buf[:n] = stream[lo:lo + n]
            _, pools = eng.prefill_chunk(params, pools, buf, tables[0], lo,
                                         n)
        return pools

    def recorded(fn):
        rec = []

        def layer(lp, lpools, x, rot, attend):
            h = B.rms_norm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = B.qkv(lp["attn"], h, cfg, rot)
            n_kv = cfg.num_kv_heads
            o = attend(q, k.transpose(0, 1).reshape(n_kv, -1, cfg.hd),
                       v.transpose(0, 1).reshape(n_kv, -1, cfg.hd), lpools)
            x1 = x + (o @ lp["attn"]["wo"]).to(x.dtype)
            hh = B.rms_norm(lp["ln2"], x1, cfg.norm_eps)
            m = B.mlp(lp["ffn"], hh)
            out = x1 + m
            rec.append([t.clone() for t in (
                h[0, 0], q[0, :, 0], k[0, :, 0], v[0, :, 0], o[0, 0],
                x1[0, 0], hh[0, 0], m[0, 0], out[0, 0])])
            return out

        pools = prefilled()
        eng._layer = layer
        try:
            logits = fn(pools)
        finally:
            del eng._layer
        return rec, logits

    dec, dlog = recorded(lambda pools: eng.decode(
        params, pools, tok, tables, ctx)[0][0])
    top = torch.topk(dlog.float(), 2).values
    wrapper, out = ops.paged_verify_attention, {}
    for vname, fn in variants.items():
        ops.paged_verify_attention = fn
        try:
            ver, vlog = recorded(lambda pools: eng.verify(
                params, pools, window, tables, ctx, win)[0][0, 0])
        finally:
            ops.paged_verify_attention = wrapper
        torch.cuda.synchronize()
        parts, first_op = [], None
        for layer_i, (a, b) in enumerate(zip(dec, ver)):
            for name, x, y in zip(names, a, b):
                same = bool(torch.equal(x, y))
                if not same and first_op is None:
                    first_op = f"layer {layer_i} {name}"
                if layer_i < 2 or not same:
                    parts.append(f"L{layer_i} {name}: " + (
                        "bitwise" if same else
                        f"{float((x.float() - y.float()).abs().max()):.3e}"))
        r = dict(first_op=first_op,
                 logits_max_diff=float((dlog.float() - vlog.float())
                                       .abs().max()),
                 decode_argmax=int(dlog.argmax()),
                 verify_argmax=int(vlog.argmax()),
                 layers_bitwise=sum(all(torch.equal(x, y) for x, y in
                                        zip(a, b))
                                    for a, b in zip(dec, ver)))
        out[vname] = r
        print(f"[spec] bf16 probe, verify {vname} ({cache} cache, request "
              f"{rid}, stream token {j}, position {pos}, {SLOTS} lanes): "
              f"first operation where the verify's row parts from the "
              f"decode step: {first_op}; {r['layers_bitwise']} of "
              f"{len(dec)} layers bitwise; logits max|diff| "
              f"{r['logits_max_diff']:.3e}, argmax decode "
              f"{r['decode_argmax']} / verify {r['verify_argmax']} "
              f"(decode's top-2 gap {float(top[0] - top[1]):.3e}); "
              + ", ".join(parts[:40]))
    return dict(cache=cache, rid=rid, token_index=j, position=pos,
                decode_top2_gap=float(top[0] - top[1]), **out)


def preemption_run(torch, cfg, params, dev):
    """Two requests at full width (float32): request 0 admitted and
    decoding, then request 1 with a tighter deadline under a block cap
    that cannot hold both. Request 0 must be preempted once, resume
    through the prefix cache, and both streams equal those of an
    unpressured run."""
    from repro_torch.serve import (ContinuousScheduler, PagedCacheSpec,
                                   PagedEngine, ServeRequest)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, (40,)).astype(np.int32),
               rng.integers(1, cfg.vocab_size, (40,)).astype(np.int32)]

    def requests():
        return [ServeRequest(rid=0, prompt=prompts[0].copy(),
                             max_new_tokens=24, deadline_s=100.0),
                ServeRequest(rid=1, prompt=prompts[1].copy(),
                             max_new_tokens=8, deadline_s=1.0)]

    spec = PagedCacheSpec.for_requests(2, 64, block_size=BLOCK)
    eng = PagedEngine(cfg, spec, max_context=64, slots=2, device=dev)
    kw = dict(prefill="chunked", prefill_chunk=CHUNK, prefix_cache=True)
    want = {r.rid: list(r.tokens) for r in ContinuousScheduler(
        eng, params, **kw).run_to_completion(requests())}
    need = spec.blocks_needed(40 + 24)
    sched = ContinuousScheduler(eng, params, preemption=True,
                                max_inflight_blocks=need + 1, **kw)
    ra, rb = requests()
    sched.submit(ra)
    steps = 0
    while len(ra.tokens) < 4:
        sched.step(float(steps))
        steps += 1
    sched.submit(rb)
    while not sched.idle:
        sched.step(float(steps))
        steps += 1
        check(steps < 1000, "preemption run did not drain")
    got = {r.rid: list(r.tokens) for r in sched.finished}
    order = [r.rid for r in sched.finished]
    print(f"[spec] preemption (float32, cap {need + 1} blocks, each request "
          f"needs {need}): {sched.preemptions} preemption(s), finish order "
          f"{order}, streams equal to the unpressured run: {got == want}")
    check(sched.preemptions == 1, f"preemptions {sched.preemptions} != 1")
    check(order == [1, 0], f"finish order {order} != [1, 0]")
    check(got == want, "the preempted streams differ from the unpressured "
          "run's")
    return dict(preemptions=sched.preemptions, order=order,
                equal=got == want)


def _separate_decode(ops):
    """The kernels module as the serving engine sees it, with the decode
    step's layer as it ran before the fold: the stand-alone append (the
    int8 cache's quantize_kv_append, the model-dtype cache's two
    scatters), then paged_decode_attention over ctx + 1 keys, that sum
    taken once a step as the engine took it. Used to count a step's
    device operations and time it both ways in one run."""
    seen = {}

    def layer(q, k_rows, v_rows, k_pages, v_pages, tables, ctx_lens, phys,
              off, *, scale, k_scales, v_scales):
        if seen.get("ctx") is not ctx_lens:
            seen.update(ctx=ctx_lens, keys=ctx_lens + 1)
        _pair_append(ops, [k_pages, v_pages, k_scales, v_scales],
                     (k_rows, v_rows), phys, off)
        return ops.paged_decode_attention(
            q, k_pages, v_pages, tables, seen["keys"], scale=scale,
            k_scales=k_scales, v_scales=v_scales)
    return _OpsWith(ops, **{FUSED: layer})


def profile_decode(torch, cfg, params, dev, steps=10, kernels=None):
    """Warm decode steps with all lanes live, with the model-dtype KV
    cache and with the int8 cache, each step run two ways on one
    scheduler: the main path ("fused": the K/V append inside the decode
    kernel's launch) and the step as it ran before the fold ("separate":
    :func:`_separate_decode`). Wall time per step on the host clock in
    turns (separate, fused, fused, separate), and for each way the
    device's busy time and operations per step from torch.profiler (the
    summed kernel, copy and fill durations on the one stream); the decode
    kernel's device time a launch in the fused step beside its
    ``decode_append_checks`` time alone (cold L2, headline shape); no
    stand-alone append in a fused step, one a layer in an int8 separate
    one. Returns {cache: {way: (wall, busy, ops, counts by kernel)}}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serve import (ContinuousScheduler, PagedCacheSpec,
                                   PagedEngine, generate_fleet_requests)
    from repro_torch.serve import engine
    out = {}
    L = cfg.num_layers
    ways = {"fused": engine.kops, "separate": _separate_decode(ops)}
    for cache in ("bf16", "int8"):
        # the requests run out after 100 tokens: 10 warm steps, 40 timed
        # and 20 profiled leave room
        spec = PagedCacheSpec.for_requests(SLOTS, 96 + 110, block_size=BLOCK,
                                           quantized=cache == "int8")
        eng = PagedEngine(cfg, spec, max_context=128, slots=SLOTS,
                          device=dev)
        sched = ContinuousScheduler(eng, params, prefill="chunked",
                                    prefill_chunk=CHUNK)
        for r in generate_fleet_requests(
                TRACE["fleet"], num_requests=SLOTS, max_prompt=96, seed=1,
                short_new=(100, 110), long_new=(100, 110),
                vocab_size=cfg.vocab_size):
            sched.submit(r)
        while not (sched.num_active == SLOTS and sched.prefill_done.all()):
            sched.step()

        def run(way):
            engine.kops = ways[way]
            try:
                for _ in range(steps):
                    sched.step()
                torch.cuda.synchronize()
            finally:
                engine.kops = ways["fused"]

        run("fused")
        walls = {"fused": [], "separate": []}
        for way in ("separate", "fused", "fused", "separate"):
            t0 = time.perf_counter()
            run(way)
            walls[way].append((time.perf_counter() - t0) / steps * 1e3)
        out[cache] = {}
        for way in ("separate", "fused"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(way)
            wall = sum(walls[way]) / 2
            rows = sorted(((getattr(e, "device_time_total", 0)
                            or getattr(e, "cuda_time_total", 0))
                           / steps / 1e3, e.count // steps, e.key[:60])
                          for e in prof.key_averages())[::-1]
            busy = sum(r[0] for r in rows)
            launches = sum(r[1] for r in rows)
            print(f"[profile] warm decode step ({way}), {cache} KV cache, "
                  f"{SLOTS} live lanes: wall {wall:.3f} ms (in turns: "
                  + ", ".join(f"{w:.3f}" for w in walls[way])
                  + f"), device busy {busy:.3f} ms (idle "
                  f"{100 * (1 - busy / wall):.1f}%), {launches} device "
                  f"ops/step, {SLOTS / wall * 1e3:.0f} tok/s")
            for t, n, key in rows[:6]:
                print(f"[profile]   {t:.4f} ms/step in {n:4d} x {key}")
            name = PAGED_LIBS["paged_decode_attention"][1]
            hits = [r for r in rows if name in r[2]]
            n = sum(r[1] for r in hits)
            check(n == L, f"decode step ({way}, {cache}): {n} {name} "
                  f"launches in the profile, want {L}")
            app = sum(r[1] for r in rows if "kv_append_kernel" in r[2])
            want_app = L if (way, cache) == ("separate", "int8") else 0
            check(app == want_app, f"decode step ({way}, {cache}): {app} "
                  f"stand-alone appends, want {want_app}")
            check(not any("quantize_int8_kernel" in r[2] for r in rows),
                  f"decode step ({way}, {cache}) launched quantize_int8")
            if way == "fused":
                alone = kernels[FUSED]["ms"] if kernels else None
                print(f"[profile]   decode attention with its append "
                      f"{sum(r[0] for r in hits):.4f} ms/step: {name} "
                      f"{sum(r[0] for r in hits) / n:.5f} ms a launch x {n} "
                      f"in the step vs {alone} ms alone "
                      f"(decode_append_checks, cold L2)")
            counts = {}             # by full kernel name (rows cut it)
            for e in prof.key_averages():
                counts[e.key] = counts.get(e.key, 0) + e.count // steps
            out[cache][way] = (wall, busy, launches, counts)
        sep, fus = out[cache]["separate"], out[cache]["fused"]
        diff = {k: fus[3].get(k, 0) - sep[3].get(k, 0)
                for k in set(sep[3]) | set(fus[3])
                if fus[3].get(k, 0) != sep[3].get(k, 0)}
        print(f"[profile]   {cache} step, fused - separate: "
              f"{fus[2] - sep[2]:+d} device ops ({sep[2]} -> {fus[2]}), "
              f"wall {fus[0] - sep[0]:+.3f} ms; by kernel: " + "; ".join(
                  f"{k[:90]}: {n:+d}" for k, n in sorted(diff.items())))
        del sched, eng
        torch.cuda.empty_cache()
    a, b = out["bf16"]["fused"][3], out["int8"]["fused"][3]
    diff = {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)
            if b.get(k, 0) != a.get(k, 0)}
    extra = out["int8"]["fused"][2] - out["bf16"]["fused"][2]
    print(f"[profile]   int8 step - bf16 step (fused): {extra} device ops; "
          f"by kernel: " + "; ".join(
              f"{k[:110]}: {n:+d}" for k, n in sorted(diff.items())))
    return out


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


# ---------------------------------------- head_dim 128, Hymba, the ssm FHDP
#: the dense configs at head_dim 128: qwen3-14b at full width and depth
#: (40 layers, 14.77 B parameters, 29.5 GB of bf16 weights), the 32B
#: class at full width cut to CUT_LAYERS layers (32.8-34.4 B parameters
#: do not fit 80 GB beside a KV pool); each served through the serving
#: phase's scheduler and trace, qwen3-14b over both caches
DENSE_FULL = "qwen3-14b"
DENSE_CUT = ("qwen2.5-32b", "qwen3-32b", "yi-34b")
CUT_LAYERS = 4
#: qwen3-14b cut to DT_LAYERS layers, trained by the tensor strategy at
#: DT_S x DT_B tokens for DT_STEPS steps: the flash kernels at head_dim
#: 128 (their SIMT route) on a main path. Two layers, since the port's
#: Adam holds float32 grads, moments and their updates at once: 2.22 B
#: parameters (the embedding and head are 1.56 B) peak near 60 GB. The
#: steps run the strategy's own step on its own init: a Session keeps its
#: initial state alive through a run, 22 GB more here, which does not fit
DT_LAYERS, DT_B, DT_S, DT_STEPS = 2, 2, 1024, 2
#: Hymba-1.5b at full width and depth: legacy serving (HY_REQUESTS
#: batches of HY_BATCH x HY_CONTEXT-token prompts, HY_DECODE decode
#: steps), then tensor-strategy steps of HY_TRAIN_B x HY_TRAIN_S tokens
#: (the bf16 wgmma flash kernels at Hq 25 over Hkv 5)
HY_BATCH, HY_CONTEXT, HY_DECODE, HY_REQUESTS = 8, 512, 32, 2
HY_TRAIN_B, HY_TRAIN_S, HY_TRAIN_STEPS = 4, 512, 3
#: bf16 loss of one batch through the flash kernels vs plain attention
HY_LOSS_RTOL = 2.0 ** -7
#: xlstm-350m's FHDP step at full width and depth: the pipeline strategy
#: on a (2, 4) mesh (2 FL columns x 4 stages; 3 super-blocks, 6 units),
#: XF_B sequences of XF_S tokens, XF_STEPS steps (``--xlstm-fhdp``). The
#: whole script cuts the sequences to XF_S_CUT tokens: the sLSTM's loop
#: over time steps runs for each of the 8 one-sample microbatches, and
#: at 512 tokens a step took 39-62 s of host-bound wall
XF_MESH, XF_B, XF_S, XF_STEPS, XF_S_CUT = "2,4", 8, 512, 2, 256
#: bf16: the FHDP loss against the flat Model.loss on the same params
#: and batch (readings 2.62e-5 at 512 tokens, 5.72e-5 at 256); the
#: stack-after-stack order of the reference's adapter must miss it
XF_LOSS_RTOL = 5e-4
FLASH_FNS = ("flash_attention", PRE, "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
#: each flash wrapper's route at bf16 head_dim 128: the forward, dK/dV and
#: dQ on their tensor-core kernels (the preprocess on vec)
D128_ROUTES = {"flash_attention": "wgmma128", PRE: "vec",
               "flash_attention_bwd_dkv": "wgmma128",
               "flash_attention_bwd_dq": "wgmma128"}
#: each paged wrapper's route at bf16 head_dim 128 over bf16 or int8
#: pools: decode on its TMA-fed kernel, prefill on its wgmma one
D128_PAGED_ROUTES = {"paged_decode_attention": "tma128",
                     "paged_prefill_attention": "wgmma128"}
#: the route of each paged wrapper a dense serving run launches: every
#: decode step's layer one fused launch of the tma128 kernel, prefill on
#: wgmma128
D128_SERVE_ROUTES = {FUSED: "tma128", "paged_prefill_attention": "wgmma128"}
#: qwen3-14b's warm tokens/s over the serving trace (bf16 cache "fp32",
#: int8 cache) when its paged decode ran the SIMT kernel, on an H100
#: 80GB HBM3 at a 700 W limit: the reading the dense phase prints its own
#: beside
SIMT_DECODE_WARM_TOKS = {"fp32": 12.4, "int8": 10.0}
#: each flash wrapper's route at bf16 head_dim 64
D64_ROUTES = {**dict.fromkeys(FLASH_FNS, "wgmma"), PRE: "vec"}
#: seamless-m4t-large-v2 at full width and depth: legacy serving
#: (ED_REQUESTS batches of ED_BATCH requests of ED_CONTEXT frames and
#: ED_CONTEXT prompt tokens, ED_DECODE decode steps), then
#: ED_TRAIN_STEPS tensor-strategy steps of ED_TRAIN_B sequences of
#: ED_TRAIN_S (half frames, half tokens), then the FHDP step on a
#: ED_MESH mesh at ED_FHDP_B x ED_FHDP_S for ED_FHDP_STEPS steps (24
#: units over 4 stages; the sequence cut to 256 to keep the script's
#: time: 8 one-sample microbatches run every unit one at a time)
ED_BATCH, ED_CONTEXT, ED_DECODE, ED_REQUESTS = 8, 512, 32, 2
ED_TRAIN_B, ED_TRAIN_S, ED_TRAIN_STEPS = 4, 1024, 3
ED_MESH, ED_FHDP_B, ED_FHDP_S, ED_FHDP_STEPS = "2,4", 8, 256, 2
#: the FHDP step's microbatch: ED_FHDP_B over 2 FL columns x 4 microbatches
ED_FHDP_MB = 1
#: bf16: the FHDP loss against the flat Model.loss on the same params and
#: batch (one-sample microbatches against a batch of 8: other GEMM
#: shapes, other bf16 roundings), as XF_LOSS_RTOL holds the ssm one
ED_FHDP_RTOL = 5e-4
#: the flash kernels' shapes that the new paths reach, (B, Hq, Hkv, S, D,
#: causal, each wrapper's route; the wrappers checked are its keys):
#: head_dim 128 at the dense training shape (qwen3-14b's 40/8 heads; also
#: checked at 56/8 and 64/8, :func:`d128_flash_checks`), Hymba's GQA group
#: of 5 at its training shape, the encoder-decoder's group of 1 (16/16
#: heads): its encoder's prefill in serving (non-causal, the forward
#: only), its training's encoder (non-causal) and decoder (causal), in the
#: tensor strategy and in the FHDP step's microbatches
FLASH_SHAPES = {
    "head_dim_128": (DT_B, 40, 8, DT_S, 128, True, D128_ROUTES),
    "hymba_group_5": (HY_TRAIN_B, 25, 5, HY_TRAIN_S, 64, True, D64_ROUTES),
    "encdec_g1_serve": (ED_BATCH, 16, 16, ED_CONTEXT, 64, False,
                        {"flash_attention": "wgmma"}),
    "encdec_g1_full": (ED_TRAIN_B, 16, 16, ED_TRAIN_S // 2, 64, False,
                       D64_ROUTES),
    "encdec_g1_causal": (ED_TRAIN_B, 16, 16, ED_TRAIN_S // 2, 64, True,
                         D64_ROUTES),
    "encdec_g1_fhdp_full": (ED_FHDP_MB, 16, 16, ED_FHDP_S // 2, 64, False,
                            D64_ROUTES),
    "encdec_g1_fhdp_causal": (ED_FHDP_MB, 16, 16, ED_FHDP_S // 2, 64, True,
                              D64_ROUTES)}
#: the main path whose launches each FLASH_SHAPES row reports, and the
#: mask they are counted under (None: all of the path's launches)
FLASH_SHAPE_PATHS = {"head_dim_128": ("dense_train", None),
                     "hymba_group_5": ("hymba_train", None),
                     "encdec_g1_serve": ("encdec_serve", None),
                     "encdec_g1_full": ("encdec_train", "non-causal"),
                     "encdec_g1_causal": ("encdec_train", "causal"),
                     "encdec_g1_fhdp_full": ("encdec_fhdp", "non-causal"),
                     "encdec_g1_fhdp_causal": ("encdec_fhdp", "causal")}
ENCDEC_SHAPES = ("encdec_g1_serve", "encdec_g1_full", "encdec_g1_causal",
                 "encdec_g1_fhdp_full", "encdec_g1_fhdp_causal")


def d128_paged_checks(torch, dev):
    """:func:`d128_layout_checks` at every (query heads, KV heads) that
    the dense configs reach (40/8: qwen3-14b and qwen2.5-32b; 64/8:
    qwen3-32b; 56/8: yi-34b), timed at :data:`DENSE_FULL`'s. Returns its
    rows, every layout's largest error folded into ``max_abs_err`` and
    the layouts checked under ``layouts``."""
    from repro_torch.configs import get_config
    out, seen = None, []
    for arch in (DENSE_FULL,) + DENSE_CUT:
        cfg = get_config(arch)
        heads = f"{cfg.num_heads}/{cfg.num_kv_heads}"
        if heads in seen:
            continue
        seen.append(heads)
        rows = d128_layout_checks(torch, cfg, dev, timed=out is None)
        if out is None:
            out = rows
            continue
        for fn, row in rows.items():
            out[fn]["max_abs_err"] = max(out[fn]["max_abs_err"],
                                         row["max_abs_err"])
    for row in out.values():
        row["layouts"] = seen
    return out


def d128_layout_checks(torch, cfg, dev, timed=True):
    """Paged decode and prefill at head_dim 128 (``cfg``'s heads, e.g.
    qwen3-14b's 40 query over 8 KV heads), where ``ops.paged_route``
    sends bf16 q to decode's TMA-fed kernel (``csrc/paged_decode_tma128.cu``,
    route tma128) and to prefill's wgmma kernel
    (``csrc/paged_prefill_tc128.cu``, route wgmma128): the serving shapes
    (8 lanes to ctx 300; chunks at 0, 112 and 288), 8 lanes at 4096 keys
    and a ragged lane list (ctx 0 to 4096), chunks at 4080 and a partial
    one at 4088, over bf16 and int8 pools with a NaN-poisoned null block,
    each held to the float32 plain version as :func:`paged_checks` holds
    the Hopper kernels (two calls bitwise equal; the SIMT kernel on the
    same inputs too); the serving and 4096-key cases timed with a cold L2
    beside the plain version and the gather + SDPA composition (with
    ``timed``), each kernel in turns with its SIMT kernel (``simt_ms``);
    then the batched verify on prefill's route
    (:func:`d128_verify_checks`). Returns {wrapper: {"bf16": times,
    "int8": times, "serving bf16": ..., "serving int8": ..., (prefill)
    "verify bf16": ..., "verify int8": ..., "max_abs_err": e}}."""
    from repro_torch.kernels import ops, ref
    hq, d = cfg.num_heads, cfg.hd
    scale = d ** -0.5
    rng = np.random.default_rng(31)
    out = {fn: {"max_abs_err": 0.0} for fn in ("paged_decode_attention",
                                               "paged_prefill_attention")}
    dtypes = (("bf16", torch.bfloat16, 2), ("int8", torch.int8, 1))
    q = torch.randn((SLOTS, hq, d), device=dev).to(torch.bfloat16)
    tw = LONG_CTX // BLOCK
    for case, ctx_list, timed_case in (
            ("serving", DECODE_CTX, timed),
            ("long", [LONG_CTX] * SLOTS, timed),
            ("ragged", [0, 1, 16, 17, 1000, 2049, LONG_CTX - 1, LONG_CTX],
             False)):
        width = -(-max(ctx_list) // BLOCK) + 1 if case == "serving" else tw
        tnp, n = block_tables(ctx_list, width, rng)
        tables = torch.tensor(tnp, device=dev)
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        for name, kv_dtype, esz in dtypes:
            route = D128_PAGED_ROUTES["paged_decode_attention"]
            check(ops.paged_route("decode", q.dtype, kv_dtype, d, BLOCK)
                  == route, f"head_dim 128 decode is not on {route}")
            k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, n + 1, 5, dev)
            kw = dict(scale=scale, k_scales=ks, v_scales=vs)
            args = (q, k, v, tables, ctx)
            fn = lambda: ops.paged_decode_attention(*args, **kw)
            simt_fn = lambda: ops._paged_decode(*args, route="simt", **kw)
            e, use = _paged_run(
                torch, f"decode D{d} {case} {name}", fn, simt_fn,
                lambda: ref.paged_decode_attention_ref(q.float(), *args[1:],
                                                       **kw),
                PAGED_RTOL["decode"], route, ops, "paged_decode_attention",
                zero_rows=ctx == 0)
            row = out["paged_decode_attention"]
            row["max_abs_err"] = max(row["max_abs_err"], e[0])
            msg = (f"[kernel] paged_decode_attention D{d} Hq{hq} "
                   f"Hkv{cfg.num_kv_heads} {case} {name} pools (ctx "
                   f"{min(ctx_list)}..{max(ctx_list)}, {route}): max|err| "
                   f"{e[0]:.3e} (SIMT {e[1]:.3e}), worst row at "
                   f"{use[0]:.3f} of its bound (SIMT {use[1]:.3f}); "
                   "bitwise repeatable")
            if timed_case:
                ms, simt_ms = in_turns(
                    fn, simt_fn, PAGED128_LIBS["paged_decode_attention"][1],
                    PAGED_SIMT_NAMES["paged_decode_attention"])
                r = dict(ms=ms, simt_ms=simt_ms,
                         plain_ms=device_ms(
                             lambda: ref.paged_decode_attention_ref(*args,
                                                                    **kw),
                             None, iters=20),
                         composition_ms=device_ms(
                             lambda: _decode_composition(
                                 torch, q, k, v, ks, vs, tables, ctx, scale),
                             None, iters=20))
                nbytes, flops = _decode_work(cfg, ctx_list, esz, SLOTS)
                nbytes += tables.numel() * 4 + ctx.numel() * 4
                r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOPS_PER_S)
                row[name if case == "long" else f"{case} {name}"] = r
                msg += (f"; device: kernel {r['ms']:.5f} ms (in turns "
                        f"with the SIMT kernel on the same inputs: "
                        f"{r['simt_ms']:.5f} ms), plain "
                        f"{r['plain_ms']:.5f} ms, composition (gather + "
                        f"SDPA) {r['composition_ms']:.5f} ms; bound "
                        f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
            print(msg)
            del k, v, ks, vs
    ctx_max = max(o + c for o, c in PREFILL_CHUNKS)
    row = out["paged_prefill_attention"]
    route = D128_PAGED_ROUTES["paged_prefill_attention"]
    names = (PAGED128_LIBS["paged_prefill_attention"][1],
             PAGED_SIMT_NAMES["paged_prefill_attention"])
    for case, chunks, keys in (("serving", PREFILL_CHUNKS, ctx_max),
                               ("long", LONG_PREFILL_CHUNKS, LONG_CTX)):
        tnp, n = block_tables([keys], -(-keys // BLOCK) + 1, rng)
        table = torch.tensor(tnp[0], device=dev)
        timed_chunk = (None if not timed else chunks[-1]
                       if case == "serving" else chunks[0])
        for name, kv_dtype, esz in dtypes:
            check(ops.paged_route("prefill", torch.bfloat16, kv_dtype, d,
                                  BLOCK) == route,
                  f"head_dim 128 prefill is not on {route}")
            k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, n + 1, 6, dev)
            kw = dict(scale=scale, k_scales=ks, v_scales=vs)
            for off, clen in chunks:
                qc = torch.randn((hq, CHUNK, d), device=dev).to(
                    torch.bfloat16)
                args = (qc, k, v, table, off, off + clen)
                fn = lambda: ops.paged_prefill_attention(*args, **kw)
                simt_fn = lambda: ops._paged_prefill(*args, route="simt",
                                                     **kw)
                e, use = _paged_run(
                    torch, f"prefill D{d} {name} @{off}+{clen}", fn,
                    simt_fn, lambda: ref.paged_prefill_attention_ref(
                        qc.float(), *args[1:], **kw),
                    PAGED_RTOL["prefill"], route, ops,
                    "paged_prefill_attention",
                    rows=lambda x, c=clen: x[:, :c])
                row["max_abs_err"] = max(row["max_abs_err"], e[0])
                msg = (f"[kernel] paged_prefill_attention D{d} Hq{hq} "
                       f"Hkv{cfg.num_kv_heads} {name} pools (chunk at "
                       f"{off}, {clen} rows, {route}): max|err| "
                       f"{e[0]:.3e} (SIMT {e[1]:.3e}), worst row at "
                       f"{use[0]:.3f} of its bound (SIMT {use[1]:.3f}); "
                       "bitwise repeatable")
                if (off, clen) == timed_chunk:
                    ms, simt_ms = in_turns(fn, simt_fn, *names)
                    r = dict(ms=ms, simt_ms=simt_ms,
                             plain_ms=device_ms(
                                 lambda: ref.paged_prefill_attention_ref(
                                     *args, **kw), None, iters=20),
                             composition_ms=device_ms(
                                 lambda: _prefill_composition(
                                     torch, qc, k, v, ks, vs, table, off,
                                     off + clen, scale), None, iters=20))
                    nbytes = (2 * hq * CHUNK * d * 2 + table.numel() * 4
                              + 2 * (off + clen) * cfg.num_kv_heads
                              * (d * esz + (4 if esz == 1 else 0)))
                    flops = 4 * hq * d * sum(off + c + 1
                                             for c in range(clen))
                    r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                         BF16_FLOPS_PER_S)
                    row[name if case == "long" else f"{case} {name}"] = r
                    msg += (f"; device: kernel {r['ms']:.5f} ms (in turns "
                            f"with the SIMT kernel on the same inputs: "
                            f"{r['simt_ms']:.5f} ms), plain "
                            f"{r['plain_ms']:.5f} ms, composition "
                            f"(gather + SDPA) {r['composition_ms']:.5f} ms;"
                            f" bound {r['bound_ms']:.5f} ms "
                            f"({r['bound_by']})")
                print(msg)
            del k, v, ks, vs
    d128_verify_checks(torch, cfg, dev, rng, row, timed)
    return out


def d128_verify_checks(torch, cfg, dev, rng, row, timed):
    """The batched verify (``ops.paged_verify_attention``, one launch for
    all lanes) at head_dim 128 and ``cfg``'s heads, on the prefill's
    route (wgmma128, P in two bf16 parts): 8 lanes with draft windows of
    up to SPEC_K + 1 rows (:data:`VERIFY_CTX`, :data:`VERIFY_WIN`: a dead
    lane, partial windows) over bf16 and int8 pools with a NaN-poisoned
    null block, each window's rows within PAGED_RTOL["prefill"] of the
    float32 plain version, the dead lane exactly 0, two calls bitwise
    equal; with ``timed``, the launch timed with a cold L2 beside the
    plain version and its bound. Adds its errors and times to ``row``
    (the prefill's) under "verify <pools>"."""
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    scale = d ** -0.5
    c = SPEC_K + 1
    ctx_np, win_np = np.array(VERIFY_CTX), np.array(VERIFY_WIN)
    t = -(-int((ctx_np + win_np).max()) // BLOCK) + 1
    tables_np, nb = block_tables(list(ctx_np + win_np), t, rng)
    tables = torch.tensor(tables_np, device=dev)
    ctx = torch.tensor(ctx_np, dtype=torch.int32, device=dev)
    win = torch.tensor(win_np, dtype=torch.int32, device=dev)
    live = torch.arange(c, device=dev)[None] < win[:, None]    # [B, C]
    keys = int((ctx_np + win_np)[win_np > 0].sum())
    flops = 4 * hq * d * sum(cx + j + 1 for cx, w in
                             zip(VERIFY_CTX, VERIFY_WIN) for j in range(w))
    route = D128_PAGED_ROUTES["paged_prefill_attention"]
    q = torch.randn((SLOTS, hq, c, d), device=dev).to(torch.bfloat16)
    for name, kv_dtype, esz in (("bf16", torch.bfloat16, 2),
                                ("int8", torch.int8, 1)):
        k, v, ks, vs = paged_pools(torch, cfg, kv_dtype, nb + 1, 7, dev)
        kw = dict(scale=scale, k_scales=ks, v_scales=vs)
        args = (q, k, v, tables, ctx, win)
        fn = lambda: ops.paged_verify_attention(*args, **kw)
        e, use = _paged_run(
            torch, f"verify D{d} {name}", fn, fn,
            lambda: ref.paged_verify_attention_ref(q.float(), *args[1:],
                                                   **kw),
            PAGED_RTOL["prefill"], route, ops, "paged_verify_attention",
            zero_rows=(ctx + win) == 0,
            rows=lambda x: x.transpose(1, 2)[live])
        row["max_abs_err"] = max(row["max_abs_err"], e[0])
        msg = (f"[kernel] paged_verify_attention D{d} Hq{hq} Hkv{hkv} "
               f"{name} pools ({SLOTS} lanes, windows {VERIFY_WIN} at ctx "
               f"{VERIFY_CTX}, {route}): max|err| {e[0]:.3e}, worst row at "
               f"{use[0]:.3f} of its bound; the dead lane exactly 0; "
               "bitwise repeatable")
        if timed:
            r = dict(ms=device_ms(fn, PAGED128_LIBS[
                "paged_prefill_attention"][1]),
                     plain_ms=device_ms(
                         lambda: ref.paged_verify_attention_ref(*args, **kw),
                         None, iters=20))
            nbytes = (2 * SLOTS * hq * c * d * 2 + tables.numel() * 4
                      + 2 * SLOTS * 4
                      + 2 * keys * hkv * (d * esz + (4 if esz == 1 else 0)))
            r["bound_ms"], r["bound_by"] = bound(nbytes, flops,
                                                 BF16_FLOPS_PER_S)
            row[f"verify {name}"] = r
            msg += (f"; device: kernel {r['ms']:.5f} ms (one launch), plain "
                    f"{r['plain_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms "
                    f"({r['bound_by']})")
        print(msg)
        del k, v, ks, vs


def d128_flash_checks(torch, dev):
    """:func:`flash_shape_checks` at head_dim 128 for every (query heads,
    KV heads) that the dense configs reach (40/8: qwen3-14b and
    qwen2.5-32b; 64/8: qwen3-32b; 56/8: yi-34b), timed at
    :data:`DENSE_FULL`'s. Returns its rows, every layout's largest error
    folded into ``max_abs_err`` and the layouts checked under
    ``layouts``."""
    from repro_torch.configs import get_config
    out, seen = None, []
    for arch in (DENSE_FULL,) + DENSE_CUT:
        cfg = get_config(arch)
        heads = (cfg.num_heads, cfg.num_kv_heads)
        if heads in seen:
            continue
        seen.append(heads)
        rows = flash_shape_checks(torch, dev, "head_dim_128", heads=heads,
                                  timed=out is None)
        if out is None:
            out = rows
            continue
        for fn, row in rows.items():
            out[fn]["max_abs_err"] = max(out[fn]["max_abs_err"],
                                         row["max_abs_err"])
    for row in out.values():
        row["layouts"] = [f"{hq}/{hkv}" for hq, hkv in seen]
    return out


def flash_shape_checks(torch, dev, label, heads=None, timed=True):
    """The flash wrappers of one of :data:`FLASH_SHAPES` (bf16, with the
    shape's mask: the forward, and unless the shape checks the forward
    only, the preprocess, dK/dV and dQ; ``heads`` = (Hq, Hkv) in place
    of the shape's): each against its plain version (bf16 outputs within
    a bf16 ulp of the largest magnitude, lse and delta within 1e-5 of
    theirs), the backward bitwise repeatable, each launch on the shape's
    route for its wrapper; with ``timed``, timed with a cold L2 beside the
    plain version and one PyTorch call with the same ``is_causal``
    (SDPA's forward; SDPA's whole backward for dK/dV and dQ; for the
    preprocess one torch.bmm with a float32 output, as
    :func:`preprocess_checks` times it), a kernel on the wgmma128 route in
    turns with the SIMT kernel on the same inputs. Returns {wrapper:
    row}."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    b, hq, hkv, s, d, causal, routes = FLASH_SHAPES[label]
    hq, hkv = heads or (hq, hkv)
    fns = tuple(fn for fn in FLASH_FNS if fn in routes)
    bwd = len(fns) > 1
    mask = "causal" if causal else "non-causal"
    g = torch.Generator(device=dev).manual_seed(17)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, do = rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d), \
        rand(b, hq, s, d)
    sc = d ** -0.5
    before = ops.route_counts()
    o, lse = ops.flash_attention(q, k, v, return_lse=True, causal=causal)
    if bwd:
        delta = ops.flash_attention_bwd_preprocess(o, do)
        dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             causal=causal)
        dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                        causal=causal)
    grew = {fn: {r: n - before[fn][r] for r, n in c.items()}
            for fn, c in ops.route_counts().items() if fn in FLASH_FNS}
    for fn in FLASH_FNS:
        want = dict.fromkeys(grew[fn], 0)
        if fn in fns:
            want[routes[fn]] = 1
        check(grew[fn] == want, f"flash {label} Hq{hq} Hkv{hkv} {fn}: "
              f"launches by route {grew[fn]} != {want}")
    ro, rlse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                       causal=causal)
    cases = [("o", "flash_attention", o, ro),
             ("lse", "flash_attention", lse, rlse)]
    if bwd:
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(again, (dq, dk, dv))),
              f"flash {label} Hq{hq} Hkv{hkv}: two backward runs differ")
        del again
        rdelta = ref.flash_attention_bwd_preprocess_ref(o, do)
        rdk, rdv = ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   scale=sc, causal=causal)
        rdq = ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                             scale=sc, causal=causal)
        cases += [("delta", PRE, delta, rdelta),
                  ("dk", "flash_attention_bwd_dkv", dk, rdk),
                  ("dv", "flash_attention_bwd_dkv", dv, rdv),
                  ("dq", "flash_attention_bwd_dq", dq, rdq)]
    torch.cuda.synchronize()
    errs = {}
    for lab, fn, got, want in cases:
        check(bool(torch.isfinite(got).all()), f"flash {label} {lab}: "
              "non-finite")
        err = _err(got, want)
        tol = (FLASH_ATOL_F32 * max(1.0, float(want.abs().max()))
               if lab in ("lse", "delta")
               else BF16_ULP * float(want.float().abs().max()))
        check(err <= tol, f"flash {label} Hq{hq} Hkv{hkv} {lab}: max err "
              f"{err:.3e} > {tol:.3e}")
        errs[fn] = max(errs.get(fn, 0.0), err)
    print(f"[kernel] flash {label} Hq{hq} Hkv{hkv} {mask}: routes "
          + ", ".join(f"{fn} {routes[fn]}" for fn in fns)
          + "; max|err| " + ", ".join(f"{fn} {e:.3e}"
                                      for fn, e in errs.items())
          + ("; backward bitwise repeatable" if bwd else ""))
    del cases
    rows = {fn: dict(max_abs_err=errs[fn], route=routes[fn]) for fn in fns}
    if not bwd:
        delta = dk = dv = dq = None
    if not timed:
        del q, k, v, do, o, lse, delta, dk, dv, dq
        torch.cuda.empty_cache()
        return rows
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                        enable_gqa=True)
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), None, iters=20)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), do, retain_graph=True), None, iters=20) \
        if bwd else None
    lib_pre = device_ms(lambda: _bmm_delta(torch, o, do), None, iters=20) \
        if PRE in fns else None
    nq, nkv, stat = b * hq * s * d, b * hkv * s * d, b * hq * s
    pairs = b * hq * _pairs(s, s, causal=causal)
    card = dict(scale=sc, causal=causal, window=None, q_offset=0)
    runs = {
        "flash_attention": (
            lambda: ops.flash_attention(q, k, v, return_lse=True,
                                        causal=causal),
            lambda: ref.flash_attention_ref(q, k, v, return_lse=True,
                                            causal=causal),
            lib_fwd, ((2 * nq + 2 * nkv) * 2 + 4 * stat, 4 * d * pairs),
            lambda: ops._flash_fwd_card(q, k, v, return_lse=True,
                                        route="simt", **card)),
        PRE: (
            lambda: ops.flash_attention_bwd_preprocess(o, do),
            lambda: ref.flash_attention_bwd_preprocess_ref(o, do),
            lib_pre, (2 * nq * 2 + 4 * stat, 2 * nq), None),
        "flash_attention_bwd_dkv": (
            lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal=causal),
            lambda: ref.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    scale=sc, causal=causal),
            lib_bwd, ((2 * nq + 4 * nkv) * 2 + 8 * stat, 8 * d * pairs),
            lambda: ops._flash_dkv_card(q, k, v, do, lse, delta,
                                        route="simt", **card)),
        "flash_attention_bwd_dq": (
            lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               causal=causal),
            lambda: ref.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                   scale=sc, causal=causal),
            lib_bwd, ((3 * nq + 2 * nkv) * 2 + 8 * stat, 6 * d * pairs),
            lambda: ops._flash_dq_card(q, k, v, do, lse, delta,
                                       route="simt", **card))}
    for fn in fns:
        kfn, pfn, lib, work, simt_fn = runs[fn]
        route = routes[fn]
        match = PRE_NAMES["vec"] if fn == PRE else flash_kernel(fn, route)
        simt_ms = None
        if route == "wgmma128":
            ms, simt_ms = in_turns(kfn, simt_fn, match,
                                   flash_kernel(fn, "simt"))
        else:
            ms = device_ms(kfn, match)
        plain = device_ms(pfn, None, iters=20)
        b_ms, b_by = bound(*work, BF16_FLOPS_PER_S)
        rows[fn].update(
            shape=f"B{b} Hq{hq} Hkv{hkv} S{s} D{d} bf16 {mask}",
            kernel=match, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib, simt_ms=simt_ms,
            f32_cuda_core_bound_ms=bound(work[0], work[1],
                                         F32_FLOPS_PER_S)[0])
        simt = ("" if simt_ms is None else
                f" (in turns with the SIMT kernel on the same inputs: "
                f"{simt_ms:.5f} ms)")
        print(f"[kernel] {fn} {label} ({rows[fn]['shape']}, {match}): "
              f"max|err| {errs[fn]:.3e}; device: kernel {ms:.5f} ms{simt}, "
              f"plain {plain:.5f} ms, library "
              f"{'n/a' if lib is None else round(lib, 5)} ms; bound "
              f"{b_ms:.5f} ms ({b_by}; on the CUDA cores in float32 "
              f"{rows[fn]['f32_cuda_core_bound_ms']:.5f} ms)")
    del q, k, v, do, o, lse, delta, dk, dv, dq, ql, kl, vl, lo, runs
    torch.cuda.empty_cache()
    return rows


def _cold_pass_shadowed(ops, ref, worst):
    """:func:`_shadowed_paged` for the cold pass of the next
    serve_continuous call alone: every paged launch of that pass is held
    against its plain version on the same inputs (the bound shares go
    into ``worst``), and the shadow comes off as the warm pass's scheduler
    is made, so the warm pass runs bare and its wall is the kernels'.
    The two passes serve the same requests. Returns the undo."""
    from repro_torch import serve
    undo_shadow = _shadowed_paged(ops, ref, worst)
    made, orig = [0], serve.ContinuousScheduler

    def counting(*args, **kw):
        made[0] += 1
        if made[0] == 2:
            undo_shadow()
        return orig(*args, **kw)

    serve.ContinuousScheduler = counting

    def undo():
        serve.ContinuousScheduler = orig
        if made[0] < 2:
            undo_shadow()
    return undo


def _dense_serve(torch, cfg, params, dev, caches):
    """The serving phase's fleet trace through serve_continuous (a cold
    and a warm pass) with each cache mode in ``caches``: the exact
    launches, every decode step's layer one fused launch on its TMA-fed
    route and every prefill launch on its wgmma one
    (:data:`D128_SERVE_ROUTES`, head_dim 128), each paged launch of the
    cold pass within its row bounds of the float32 plain version on the
    same inputs and every appended slot bitwise the plain append's
    (:func:`_cold_pass_shadowed`), every int8 prefill chunk's append one
    launch of its own, finite in-range tokens; the warm pass's tokens/s
    beside :data:`SIMT_DECODE_WARM_TOKS` for qwen3-14b. Returns (launch
    totals, {cache: report})."""
    from repro_torch.kernels import ops, ref
    totals = dict.fromkeys(ops.launch_counts(), 0)
    reports, L = {}, cfg.num_layers
    for cache in caches:
        ops.reset_launch_counts()
        worst = {}
        undo = _cold_pass_shadowed(ops, ref, worst)
        t0 = time.perf_counter()
        try:
            rep = _serve_trace(cfg, params, dev, cache)
            torch.cuda.synchronize()
        finally:
            undo()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(rep["requests"] == TRACE["num_requests"]
              and rep["unstarted_requests"] == 0,
              f"{cfg.name} {cache}: not every request finished")
        check(all(0 <= tok < cfg.vocab_size
                  for s in rep["sequences"].values() for tok in s),
              f"{cfg.name} {cache}: token id out of range")
        want = dict.fromkeys(counts, 0)
        want.update({
            FUSED: 2 * L * rep["decode_steps"],
            "paged_prefill_attention": 2 * L * rep["prefill_chunks"],
            "quantize_kv_append": (2 * L * rep["prefill_chunks"]
                                   if cache == "int8" else 0)})
        check(counts == want, f"{cfg.name} {cache}: launches {counts} != "
              f"{want}")
        routes = ops.route_counts()
        for fn, route in D128_SERVE_ROUTES.items():
            check(routes[fn][route] == counts[fn], f"{cfg.name} {cache}: "
                  f"{fn} launches by route {routes[fn]}, want all {route}")
        # the cold pass is half the launches: every one of them checked
        check(set(worst) == set(D128_SERVE_ROUTES)
              and max(worst.values()) <= 1.0, f"{cfg.name} {cache}: the "
              f"cold pass's paged launches vs their plain versions: "
              f"{worst} of their row bounds")
        was = (f" (its SIMT decode kernel: {SIMT_DECODE_WARM_TOKS[cache]}"
               f" warm tok/s)" if cfg.name == DENSE_FULL else "")
        print(f"[dense] {cfg.name} ({L} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}) "
              f"cache={cache}: {rep['requests']} requests, "
              f"{rep['total_new_tokens']} tokens, {rep['decode_steps']} "
              f"decode steps, {rep['prefill_chunks']} prefill chunks; warm "
              f"{rep['warm_tokens_per_s']:.1f} tok/s{was} (cold, its "
              f"launches each checked against the plain version: "
              f"{rep['tokens_per_s']:.1f}); two passes {wall:.1f} s of "
              f"wall; launches {counts}, decode (with its append) on "
              f"{D128_SERVE_ROUTES[FUSED]}, prefill on "
              f"{D128_SERVE_ROUTES['paged_prefill_attention']}; the cold "
              f"pass's largest share of a row's bound " + ", ".join(
                  f"{k} {v:.3f}" for k, v in worst.items()))
        reports[cache] = dict(rep, wall_s=wall, shadow_bound_share=worst)
        for name in totals:
            totals[name] += counts[name]
    return totals, reports


def _oracle_requests(cfg, rep):
    """The four longest requests of the serving trace and their served
    streams in ``rep``."""
    from repro_torch.serve import generate_fleet_requests
    trace = generate_fleet_requests(
        TRACE["fleet"], num_requests=TRACE["num_requests"],
        max_prompt=TRACE["max_prompt"], seed=TRACE["seed"], deadline_s=4.0,
        vocab_size=cfg.vocab_size)
    reqs = sorted(trace, key=lambda r: -len(r.prompt))[:4]
    return reqs, {r.rid: rep["sequences"][r.rid] for r in reqs}


class _OpsWith:
    """The kernels module as the serving engine sees it, with some of its
    functions replaced (the module itself stays untouched: its wrappers
    count their launches on their own function objects)."""

    def __init__(self, ops, **replaced):
        self._ops, self._replaced = ops, replaced

    def __getattr__(self, name):
        return self._replaced.get(name) or getattr(self._ops, name)


def _shadowed_paged(ops, ref, worst):
    """Give the serving engine the decode step's fused append-and-decode
    and paged prefill that launch the kernel and hold its output against
    the float32 plain version on the same inputs: every row within
    PAGED_RTOL of its largest |plain value| + PAGED_ROW_ATOL (as
    :func:`_paged_run`; the decode over the pools the kernel appended
    to, whose live lanes' new slots must hold the plain append's values
    bitwise); the largest share of a row's bound goes into ``worst``
    [wrapper]. Returns the undo."""
    from repro_torch.serve import engine

    def decode_plain(q, k_rows, v_rows, k, v, tables, ctx, phys, off, *,
                     scale, k_scales, v_scales):
        """The plain decode over the appended pools, after checking the
        live lanes' slots (a dead lane's, the null block's, is
        garbage)."""
        live = phys != 0
        p, o = phys[live], off[live]
        if k_scales is None:
            want = [r[:, live].to(k.dtype) for r in (k_rows, v_rows)]
            got = [k[:, p, o], v[:, p, o]]
        else:
            kq, ks = ref._quantize_rows_nearest(k_rows[:, live])
            vq, vs = ref._quantize_rows_nearest(v_rows[:, live])
            want = [kq, vq, ks, vs]
            got = [k[:, p, o], v[:, p, o], k_scales[:, p, o],
                   v_scales[:, p, o]]
        check(all(torch_equal_bits(a, b) for a, b in zip(got, want)),
              f"{FUSED}: an appended slot differs from the plain append")
        return ref.paged_decode_attention_ref(
            q, k, v, tables, ctx + 1, scale=scale, k_scales=k_scales,
            v_scales=v_scales)

    def shadow(fn, kind):
        kernel = getattr(ops, fn)
        plain = (decode_plain if fn == FUSED
                 else getattr(ref, f"{fn}_ref"))

        def call(q, *args, **kw):
            out = kernel(q, *args, **kw)
            want = plain(q.float(), *args, **kw).float()
            got = out.float()
            if kind == "prefill":            # the chunk's live rows
                rows = args[4] - args[3]
                got, want = got[:, :rows], want[:, :rows]
            tol = (PAGED_RTOL[kind] * want.abs().amax(-1, keepdim=True)
                   + PAGED_ROW_ATOL)
            check(bool(got.isfinite().all()), f"{fn}: non-finite output")
            worst[fn] = max(worst.get(fn, 0.0),
                            float(((got - want).abs() / tol).max()))
            return out
        return call

    saved = engine.kops
    engine.kops = _OpsWith(ops, **{fn: shadow(fn, fn.split("_")[1]) for fn in (
        FUSED, "paged_prefill_attention")})
    return lambda: setattr(engine, "kops", saved)


def torch_equal_bits(a, b):
    """Two tensors of one dtype and shape bitwise equal (NaN included)."""
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(torch, a.contiguous()), _bits(torch, b.contiguous()))


def _dense_oracle(torch, cfg, params, dev, reqs, streams):
    """The served streams of ``reqs`` teacher-forced in the model's bf16:
    the paged engine (the kernels) against lm.forward with a contiguous
    cache (plain attention) within ORACLE_ATOL_BF16, as the serving phase
    holds flad-adllm; then :func:`int8_cache_fidelity` (bf16 pools
    against int8 pools, as that phase reports it) with every paged
    launch of both engines held against its plain version on the same
    inputs (:func:`_shadowed_paged`, row bounds PAGED_RTOL)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import int8_cache_fidelity
    drift, agree, n = contiguous_oracle(
        torch, cfg, params, dev, [streams[r.rid] for r in reqs],
        [r.prompt for r in reqs])
    print(f"[oracle] {cfg.name} bfloat16: paged (kernels) vs contiguous "
          f"(plain) logits over {n} teacher-forced positions: max|diff| "
          f"{drift:.3e} (atol {ORACLE_ATOL_BF16}), argmax agreement "
          f"{agree:.3f}")
    check(drift <= ORACLE_ATOL_BF16, f"{cfg.name} paged-vs-contiguous "
          f"drift {drift}")
    worst = {}
    undo = _shadowed_paged(ops, ref, worst)
    try:
        fid = int8_cache_fidelity(cfg, params, reqs, streams,
                                  block_size=BLOCK, max_context=128,
                                  prefill="chunked", prefill_chunk=CHUNK,
                                  device=dev)
    finally:
        undo()
    check(np.isfinite(fid["max_logit_drift"]), f"{cfg.name}: non-finite "
          "int8 cache logits")
    check(worst and max(worst.values()) <= 1.0, f"{cfg.name} teacher-"
          f"forced paged launches vs their plain versions: {worst} of "
          "their row bounds")
    print(f"[oracle] {cfg.name} int8 cache vs bf16 cache, teacher-forced: "
          f"greedy disagreement {fid['disagreement']:.4f} over "
          f"{fid['positions']} positions, max logit drift "
          f"{fid['max_logit_drift']:.3e}; every paged launch of both "
          f"engines vs its plain version on the same inputs: largest "
          f"share of a row's bound " + ", ".join(
              f"{k} {v:.3f}" for k, v in worst.items()))
    return dict(drift=drift, argmax_agreement=agree, positions=n,
                int8_disagreement=fid["disagreement"],
                int8_max_logit_drift=fid["max_logit_drift"],
                shadow_bound_share=worst)


def _dense_oracle_f32(torch, cfg, dev, reqs, streams):
    """``cfg`` in float32 (drawn from the same seed, on the card) with
    the streams of ``reqs`` teacher-forced: the paged engine (the SIMT
    kernels at float32 q) against lm.forward with a contiguous cache
    within ORACLE_ATOL_F32, as the serving phase holds flad-adllm."""
    from repro_torch.models import lm
    c = cfg.replace(param_dtype="float32")
    params = lm.init(c, seed=0, device=dev)
    drift, agree, n = contiguous_oracle(
        torch, c, params, dev, [streams[r.rid] for r in reqs],
        [r.prompt for r in reqs])
    print(f"[oracle] {cfg.name} float32: paged (kernels) vs contiguous "
          f"(plain) logits over {n} teacher-forced positions: max|diff| "
          f"{drift:.3e} (atol {ORACLE_ATOL_F32}), argmax agreement "
          f"{agree:.3f}")
    check(drift <= ORACLE_ATOL_F32, f"{cfg.name} float32 paged-vs-"
          f"contiguous drift {drift}")
    del params
    torch.cuda.empty_cache()
    return dict(f32_drift=drift, f32_argmax_agreement=agree)


def dense_main_path(torch, dev):
    """qwen3-14b at full width and depth served over the model-dtype and
    int8 caches, the 32B class at full width and CUT_LAYERS layers over
    the model-dtype cache, each held to the oracles (:func:`_dense_oracle`
    on the served weights, then :func:`_dense_oracle_f32`); then
    qwen3-14b at DT_LAYERS layers trained by the tensor strategy (the
    flash kernels at head_dim 128). Returns ({path: launch counts},
    {path: route counts}, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    summary, serve = {}, None
    for arch, layers, caches in (
            ((DENSE_FULL, None, ("fp32", "int8")),)
            + tuple((a, CUT_LAYERS, ("fp32",)) for a in DENSE_CUT)):
        cfg = get_config(arch)
        cfg = cfg.replace(num_layers=layers) if layers else cfg
        t0 = time.perf_counter()
        params = lm.init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"[dense] {cfg.name}: {cfg.num_layers} layers, "
              f"{n_params / 1e9:.2f} B params in {cfg.param_dtype} "
              f"({time.perf_counter() - t0:.1f} s to init on the card)")
        counts, reports = _dense_serve(torch, cfg, params, dev, caches)
        serve = counts if serve is None else {
            k: serve[k] + counts[k] for k in serve}
        reqs, streams = _oracle_requests(cfg, reports["fp32"])
        oracle = _dense_oracle(torch, cfg, params, dev, reqs, streams)
        del params
        torch.cuda.empty_cache()
        oracle.update(_dense_oracle_f32(torch, cfg, dev, reqs, streams))
        summary[cfg.name] = dict(
            params=n_params, layers=cfg.num_layers, oracle=oracle,
            **{cache: {k: rep[k] for k in (
                "warm_tokens_per_s", "tokens_per_s", "decode_steps",
                "prefill_chunks", "wall_s", "shadow_bound_share")}
               for cache, rep in reports.items()})
    serve_routes = {fn: {route: serve[fn]}
                    for fn, route in D128_SERVE_ROUTES.items()}
    train, train_routes, summary["train"] = dense_train_path(torch, dev)
    return ({"dense_serve": serve, "dense_train": train},
            {"dense_serve": serve_routes, "dense_train": train_routes},
            summary)


def dense_train_path(torch, dev):
    """qwen3-14b at full width cut to DT_LAYERS layers: one batch's bf16
    loss through the flash kernels against plain attention (within
    HY_LOSS_RTOL); then DT_STEPS steps of the tensor strategy (its step
    and init, as a Session builds them) on that batch: the exact flash
    launches (the forward twice a layer and step, the checkpoint's
    recompute included; the preprocess, dK/dV and dQ once), the forward,
    dK/dV and dQ on the wgmma128 route, the preprocess on vec
    (:data:`D128_ROUTES`); finite losses, moved weights."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models.registry import build_model
    cfg = get_config(DENSE_FULL).replace(num_layers=DT_LAYERS)
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(23)
    batch = {k: torch.randint(0, cfg.vocab_size, (DT_B, DT_S), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    # one batch's loss through the kernels and through plain attention
    params = lm.init(cfg, seed=0, device=dev)
    model = build_model(cfg)
    ops.reset_launch_counts()
    with torch.no_grad():
        loss_k = float(model.loss(params, batch)[0])
        fwd = ops.route_counts()["flash_attention"]
        saved = ops.flash_attention_ad
        ops.flash_attention_ad = _plain_flash_ad(ref)
        try:
            loss_p = float(model.loss(params, batch)[0])
        finally:
            ops.flash_attention_ad = saved
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[dense-train] bf16 loss of a {DT_B}x{DT_S} batch at {DT_LAYERS} "
          f"layers: flash kernels {loss_k:.6f} ({fwd['wgmma128']} forward "
          f"launches on wgmma128), plain attention {loss_p:.6f} (rel "
          f"{rel:.2e}, rtol {HY_LOSS_RTOL})")
    check(fwd == {**dict.fromkeys(fwd, 0), "wgmma128": DT_LAYERS},
          f"dense loss: forward launches by route {fwd}")
    check(np.isfinite(loss_k) and rel <= HY_LOSS_RTOL,
          f"dense loss through the kernels {loss_k} vs plain {loss_p}")
    del params, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ses = Session(cfg=cfg, strategy="tensor", shape=f"{DT_S}x{DT_B}",
                  device=dev)
    step = ses.strategy.make_step(cfg, ses.shape, ses.mesh)
    params, opt = ses.strategy.init(cfg, ses.shape, ses.mesh, ses.seed)
    wq0 = params["blocks"]["attn"]["wq"].clone()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(DT_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    L, n = DT_LAYERS, DT_STEPS
    want = dict.fromkeys(counts, 0)
    want.update({"flash_attention": 2 * L * n, PRE: L * n,
                 "flash_attention_bwd_dkv": L * n,
                 "flash_attention_bwd_dq": L * n})
    check(counts == want, f"dense training launches {counts} != {want}")
    routes = ops.route_counts()
    for fn in FLASH_FNS:
        want = {**dict.fromkeys(routes[fn], 0), D128_ROUTES[fn]: counts[fn]}
        check(routes[fn] == want, f"dense training: {fn} launches by route "
              f"{routes[fn]} != {want}")
    check(all(np.isfinite(losses)), f"dense training losses {losses}")
    moved = float((params["blocks"]["attn"]["wq"].float()
                   - wq0.float()).abs().max())
    check(moved > 0, "dense training: wq did not move")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[dense-train] {cfg.name} at {L} layers (full width), tensor "
          f"strategy, {n} steps of {DT_B}x{DT_S} tokens: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; wall {wall:.2f} s; peak {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in counts.items() if v} }, the flash forward, "
          f"dK/dV and dQ on wgmma128 (head_dim 128), the preprocess on "
          f"vec")
    del params, opt, ses, step, wq0
    torch.cuda.empty_cache()
    return counts, {fn: routes[fn] for fn in FLASH_FNS}, dict(
        losses=losses, wall_s=wall, peak_gib=peak, loss_kernels=loss_k,
        loss_plain=loss_p, loss_rel=rel)


def _profile_rows(torch, fn, steps=1):
    """(wall ms a call, device rows (ms, launches, name) a call, device
    busy ms a call) of ``fn`` under torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    rows = sorted(((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0)) / steps / 1e3,
                   e.count // steps, e.key[:70])
                  for e in prof.key_averages())[::-1]
    return wall, rows, sum(r[0] for r in rows)


def hymba_main_path(torch, dev):
    """Hymba-1.5b at full width and depth (bf16, random weights from a
    seed): legacy serving through Session.serve (no kernel: plain
    attention over the contiguous cache, the plain Mamba); one batch's
    loss through the flash kernels against plain attention; then
    HY_TRAIN_STEPS tensor-strategy steps: the exact flash launches, all
    on the wgmma route (the preprocess on vec), finite losses, moved
    weights; a warm step profiled (wall, device busy, idle share) and an
    estimate of the Mamba heads' device time a step (one layer profiled
    apart, times the layers). Returns (launches, routes, summary)."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import hymba
    from repro_torch.models import recurrent as R
    from repro_torch.models.registry import build_model
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    params = hymba.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[hymba] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.hd}, Mamba d_inner {cfg.ssm.expand * cfg.d_model} N "
          f"{cfg.ssm.state_size}, {n_params / 1e9:.3f} B params "
          f"({time.perf_counter() - t0:.1f} s to init)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = Session(cfg=cfg, device=dev).serve(
        scheduler="legacy", batch=HY_BATCH, context=HY_CONTEXT,
        decode_steps=HY_DECODE, requests=HY_REQUESTS, params=params,
        log_fn=None)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    check(not any(serve_counts.values()), f"hymba legacy serving launched "
          f"{serve_counts}")
    check(bool(torch.isfinite(rep["last_logits"]).all()),
          "hymba serving: non-finite logits")
    for seqs in rep["sequences"]:
        check(tuple(seqs.shape) == (HY_BATCH, HY_DECODE + 1)
              and int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size,
              "hymba serving: bad token ids")
    print(f"[hymba] legacy serving, {HY_REQUESTS} batches of {HY_BATCH} x "
          f"{HY_CONTEXT}-token prompts, {HY_DECODE} decode steps: "
          f"{rep['total_tokens']} tokens in {serve_wall:.1f} s, warm "
          f"{rep['warm_tokens_per_s']:.1f} tok/s; no kernel (plain "
          f"attention over the contiguous cache, the plain Mamba)")
    # one batch's loss through the kernels and through plain attention
    g = torch.Generator(device=dev).manual_seed(29)
    batch = {k: torch.randint(0, cfg.vocab_size, (HY_TRAIN_B, HY_TRAIN_S),
                              generator=g, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    model = build_model(cfg)
    with torch.no_grad():
        loss_k = float(model.loss(params, batch)[0])
        saved = ops.flash_attention_ad
        ops.flash_attention_ad = _plain_flash_ad(ref)
        try:
            loss_p = float(model.loss(params, batch)[0])
        finally:
            ops.flash_attention_ad = saved
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[hymba] bf16 loss of a {HY_TRAIN_B}x{HY_TRAIN_S} batch: flash "
          f"kernels {loss_k:.6f}, plain attention {loss_p:.6f} (rel "
          f"{rel:.2e}, rtol {HY_LOSS_RTOL})")
    check(np.isfinite(loss_k) and rel <= HY_LOSS_RTOL,
          f"hymba loss through the kernels {loss_k} vs plain {loss_p}")
    del params, model
    torch.cuda.empty_cache()
    # training: the tensor strategy
    torch.cuda.reset_peak_memory_stats()
    ses = Session(cfg=cfg, strategy="tensor",
                  shape=f"{HY_TRAIN_S}x{HY_TRAIN_B}", device=dev)
    step, (p, o) = ses.build()
    w0 = p["blocks"]["mamba"]["w_in"].clone()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(HY_TRAIN_STEPS):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    L, n = cfg.num_layers, HY_TRAIN_STEPS
    want = dict.fromkeys(counts, 0)
    want.update({"flash_attention": 2 * L * n, PRE: L * n,
                 "flash_attention_bwd_dkv": L * n,
                 "flash_attention_bwd_dq": L * n})
    check(counts == want, f"hymba training launches {counts} != {want}")
    routes = check_routes(ops, counts, "hymba training",
                          ("flash_attention", "flash_attention_bwd_dkv",
                           "flash_attention_bwd_dq", PRE))
    check(all(np.isfinite(losses)), f"hymba training losses {losses}")
    moved = float((p["blocks"]["mamba"]["w_in"].float() - w0.float())
                  .abs().max())
    check(moved > 0, "hymba training: the Mamba's w_in did not move")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = [p, o]

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    swall, rows, busy = _profile_rows(torch, one)
    idle = max(0.0, 1 - busy / swall)
    flash = sum(r[0] for r in rows if "flash" in r[2])
    busy = max(busy, 1e-9)
    # the Mamba heads alone: one layer's sequence form forward and
    # backward at the step's shape, as the step runs it (forward, the
    # checkpoint's recompute, backward), times the layers
    lp = {k: v[0].detach().clone().requires_grad_()
          for k, v in state[0]["blocks"]["mamba"].items()}
    x = torch.randn((HY_TRAIN_B, HY_TRAIN_S, cfg.d_model), device=dev,
                    dtype=cfg.dtype, requires_grad=True)

    def mamba_layer():
        y, _ = R.apply_mamba_seq(lp, x, cfg)
        with torch.no_grad():
            R.apply_mamba_seq(lp, x, cfg)
        torch.autograd.grad(y.float().sum(), [x] + list(lp.values()))

    _, _, mbusy = _profile_rows(torch, mamba_layer, steps=2)
    mamba = mbusy * L
    print(f"[hymba-train] tensor strategy, {n} steps of {HY_TRAIN_B}x"
          f"{HY_TRAIN_S} tokens: losses " + ", ".join(f"{x_:.4f}"
                                                    for x_ in losses)
          + f"; wall {wall:.2f} s incl. the first step; peak {peak:.2f} GiB;"
          f" launches {({k: v for k, v in counts.items() if v})}, all on "
          f"wgmma (Hq 25 / Hkv 5), the preprocess on vec")
    print(f"[profile] bf16 hymba train step, {HY_TRAIN_B}x{HY_TRAIN_S} "
          f"tokens: wall {swall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"{100 * idle:.1f}%), {sum(r[1] for r in rows)} device ops; "
          f"flash kernels {flash:.2f} ms; the Mamba heads, an estimate "
          f"from one isolated layer profiled apart (its forward, recompute "
          f"and backward, {mbusy:.2f} ms, x {L} layers; not read from the "
          f"step's trace, whose elementwise kernels carry no layer): about "
          f"{mamba:.1f} ms, {100 * mamba / busy:.1f}% of the step's device "
          f"time")
    for t, k_, name in rows[:10]:
        print(f"[profile]   {t:.4f} ms/step in {k_:5d} x {name}")
    summary = dict(params=n_params, serve_wall_s=serve_wall,
                   serve_warm_tokens_per_s=rep["warm_tokens_per_s"],
                   loss_kernels=loss_k, loss_plain=loss_p, losses=losses,
                   train_wall_s=wall, peak_gib=peak, step_wall_ms=swall,
                   step_busy_ms=busy, step_idle=idle, flash_ms=flash,
                   mamba_ms_estimate=mamba, top=rows[:10])
    del state, p, o, ses, step, lp, x, w0
    torch.cuda.empty_cache()
    return ({"hymba_serve": serve_counts, "hymba_train": counts},
            {"hymba_train": {fn: routes[fn] for fn in FLASH_FNS}}, summary)


def _tally_by_mask(ops):
    """Counts the flash launches by mask until the returned undo: each
    card launch of the forward, dK/dV and dQ under its ``causal``, and the
    preprocess under the mask of the backward that runs it. Returns
    ({"non-causal" | "causal": {wrapper: launches}}, undo)."""
    tally = {m: dict.fromkeys(FLASH_FNS, 0) for m in ("non-causal", "causal")}
    saved = {}

    def counted(attr, fn):
        orig = saved[attr] = getattr(ops, attr)

        def run(*args, **kw):
            out = orig(*args, **kw)
            tally["causal" if kw["causal"] else "non-causal"][fn] += 1
            return out
        setattr(ops, attr, run)

    for attr, fn in (("_flash_fwd_card", "flash_attention"),
                     ("_flash_dkv_card", "flash_attention_bwd_dkv"),
                     ("_flash_dq_card", "flash_attention_bwd_dq"),
                     ("flash_attention_bwd", PRE)):
        counted(attr, fn)

    def undo():
        for attr, orig in saved.items():
            setattr(ops, attr, orig)
    return tally, undo


def _check_by_mask(tally, counts, per_unit, label):
    """``tally`` (:func:`_tally_by_mask`) against the path's ``counts``
    and the units of each mask (``per_unit``: {mask: units}; each unit one
    checkpointed attention: its forward twice, each backward kernel
    once)."""
    for mask, units in per_unit.items():
        want = {fn: (2 if fn == "flash_attention" else 1) * units
                for fn in FLASH_FNS}
        check(tally[mask] == want, f"{label} {mask} launches {tally[mask]} "
              f"!= {want}")
    check(all(sum(t[fn] for t in tally.values()) == counts[fn]
              for fn in FLASH_FNS), f"{label}: launches by mask {tally} do "
          f"not add up to {counts}")


def encdec_main_path(torch, dev):
    """seamless-m4t-large-v2 at full width and depth (12 + 12 layers,
    16/16 heads of 64, vocab 256206, bf16, random weights from a seed):
    (a) legacy serving through Session.serve (each prefill's encoder on
    the flash forward, non-causal, ``enc_layers`` launches; the decoder
    and cross-attention plain over the contiguous cache: no other
    launch); (b) one batch's loss through the flash kernels against plain
    attention (HY_LOSS_RTOL); (c) ED_TRAIN_STEPS tensor-strategy steps:
    the exact flash launches (remat: every layer's forward twice, the
    preprocess, dK/dV and dQ once), all on wgmma (the preprocess on
    vec), finite losses, moved weights, a warm step profiled (wall,
    device busy, idle share, the top operations); (d) the FHDP step on a
    ED_MESH mesh: its first loss against the flat Model.loss on the
    merged params (ED_FHDP_RTOL), the exact flash launches (each kept
    microbatch's 24 units, each checkpointed), finite losses, moved
    stacks. In (c) and (d) the launches are also counted by mask: the
    encoder's non-causal, the decoder's causal (summary
    ``launches_by_mask``). Returns (launches, routes, summary)."""
    from repro_torch.api import Session
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.configs.common import concrete_batch
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    cfg = get_config("seamless-m4t-large-v2")
    L = cfg.enc_layers + cfg.dec_layers
    t0 = time.perf_counter()
    params = encdec.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[encdec] {cfg.name}: {cfg.enc_layers} + {cfg.dec_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params in "
          f"{cfg.param_dtype} ({time.perf_counter() - t0:.1f} s to init)")
    # (a) legacy serving
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = Session(cfg=cfg, device=dev).serve(
        scheduler="legacy", batch=ED_BATCH, context=ED_CONTEXT,
        decode_steps=ED_DECODE, requests=ED_REQUESTS, params=params,
        log_fn=None)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    want = dict.fromkeys(serve_counts, 0)
    want["flash_attention"] = cfg.enc_layers * ED_REQUESTS
    check(serve_counts == want, f"encdec legacy serving launches "
          f"{serve_counts} != {want}")
    serve_routes = check_routes(ops, serve_counts, "encdec serving",
                                ("flash_attention",))
    check(bool(torch.isfinite(rep["last_logits"]).all()),
          "encdec serving: non-finite logits")
    for seqs in rep["sequences"]:
        check(tuple(seqs.shape) == (ED_BATCH, ED_DECODE + 1)
              and int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size,
              "encdec serving: bad token ids")
    print(f"[encdec] legacy serving, {ED_REQUESTS} batches of {ED_BATCH} "
          f"requests of {ED_CONTEXT} frames + {ED_CONTEXT} prompt tokens, "
          f"{ED_DECODE} decode steps: {rep['total_tokens']} tokens in "
          f"{serve_wall:.1f} s, warm {rep['warm_tokens_per_s']:.1f} tok/s; "
          f"launches {({k: v for k, v in serve_counts.items() if v})} (the "
          f"encoder's {cfg.enc_layers} layers a prefill, non-causal, on "
          f"wgmma; the decoder and cross-attention plain)")
    # (b) one batch's loss through the kernels and through plain attention
    shape = ShapeConfig("encdec", ED_TRAIN_S, ED_TRAIN_B, "train")
    batch = concrete_batch(cfg, shape,
                           torch.Generator(device=dev).manual_seed(43))
    model = build_model(cfg)
    with torch.no_grad():
        loss_k = float(model.loss(params, batch)[0])
        saved = ops.flash_attention_ad
        ops.flash_attention_ad = _plain_flash_ad(ref)
        try:
            loss_p = float(model.loss(params, batch)[0])
        finally:
            ops.flash_attention_ad = saved
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[encdec] bf16 loss of a {ED_TRAIN_B} x ({ED_TRAIN_S // 2} frames "
          f"+ {ED_TRAIN_S // 2} tokens) batch: flash kernels {loss_k:.6f}, "
          f"plain attention {loss_p:.6f} (rel {rel:.2e}, rtol "
          f"{HY_LOSS_RTOL})")
    check(np.isfinite(loss_k) and rel <= HY_LOSS_RTOL,
          f"encdec loss through the kernels {loss_k} vs plain {loss_p}")
    del params, model
    torch.cuda.empty_cache()
    # (c) training: the tensor strategy
    torch.cuda.reset_peak_memory_stats()
    ses = Session(cfg=cfg, strategy="tensor",
                  shape=f"{ED_TRAIN_S}x{ED_TRAIN_B}", device=dev)
    step, (p, o) = ses.build()
    w0 = {"enc": p["enc_blocks"]["attn"]["wq"].clone(),
          "xattn": p["dec_blocks"]["xattn"]["wk"].clone()}
    ops.reset_launch_counts()
    tally, undo = _tally_by_mask(ops)
    t0 = time.perf_counter()
    losses = []
    try:
        for _ in range(ED_TRAIN_STEPS):
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n = ED_TRAIN_STEPS
    want = dict.fromkeys(counts, 0)
    want.update({"flash_attention": 2 * L * n, PRE: L * n,
                 "flash_attention_bwd_dkv": L * n,
                 "flash_attention_bwd_dq": L * n})
    check(counts == want, f"encdec training launches {counts} != {want}")
    _check_by_mask(tally, counts, {"non-causal": cfg.enc_layers * n,
                                   "causal": cfg.dec_layers * n},
                   "encdec training")
    by_mask = {"encdec_train": tally}
    routes = check_routes(ops, counts, "encdec training",
                          ("flash_attention", "flash_attention_bwd_dkv",
                           "flash_attention_bwd_dq", PRE))
    check(all(np.isfinite(losses)), f"encdec training losses {losses}")
    moved = {k: float((p[a][b_][c].float() - w.float()).abs().max())
             for (k, w), (a, b_, c) in zip(
                 w0.items(), (("enc_blocks", "attn", "wq"),
                              ("dec_blocks", "xattn", "wk")))}
    check(all(v > 0 for v in moved.values()),
          f"encdec training: weights did not move {moved}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = [p, o]

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    swall, rows, busy = _profile_rows(torch, one)
    idle = max(0.0, 1 - busy / swall)
    flash = sum(r[0] for r in rows if "flash" in r[2])
    print(f"[encdec-train] tensor strategy, {n} steps of {ED_TRAIN_B} x "
          f"({ED_TRAIN_S // 2} frames + {ED_TRAIN_S // 2} tokens): losses "
          + ", ".join(f"{x_:.4f}" for x_ in losses)
          + f"; wall {wall:.2f} s incl. the first step; peak {peak:.2f} GiB;"
          f" launches {({k: v for k, v in counts.items() if v})}, all on "
          f"wgmma (16/16 heads; the encoder's non-causal, the decoder's "
          f"causal), the preprocess on vec")
    print(f"[profile] bf16 encdec train step, {ED_TRAIN_B} x {ED_TRAIN_S} "
          f"tokens: wall {swall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"{100 * idle:.1f}%), {sum(r[1] for r in rows)} device ops; "
          f"flash kernels {flash:.2f} ms")
    for t, k_, name in rows[:10]:
        print(f"[profile]   {t:.4f} ms/step in {k_:5d} x {name}")
    summary = dict(params=n_params, serve_wall_s=serve_wall,
                   serve_warm_tokens_per_s=rep["warm_tokens_per_s"],
                   serve_tokens=rep["total_tokens"], loss_kernels=loss_k,
                   loss_plain=loss_p, losses=losses, train_wall_s=wall,
                   peak_gib=peak, step_wall_ms=swall, step_busy_ms=busy,
                   step_idle=idle, flash_ms=flash, top=rows[:10])
    del state, p, o, ses, step, w0, rep
    torch.cuda.empty_cache()
    # (d) the FHDP step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ses = Session(cfg=cfg, strategy="pipeline", mesh=ED_MESH,
                  shape=f"{ED_FHDP_S}x{ED_FHDP_B}", device=dev)
    fstep, (pp, opt) = ses.build()
    tmpl, h = ses.strategy.templates, ses.strategy.helpers
    check(h["mb"] == ED_FHDP_MB, f"encdec FHDP microbatch {h['mb']} != "
          f"{ED_FHDP_MB}, the shape its flash rows are checked at")
    print(f"[encdec-fhdp] pipeline on mesh {ED_MESH}: templates {tmpl}, "
          f"stage plan {pl.stage_plan(cfg, tmpl)} "
          f"({time.perf_counter() - t0:.1f} s to build)")
    fbatch = concrete_batch(cfg, ses.shape,
                            torch.Generator(device=dev).manual_seed(47))
    with torch.no_grad():
        flat = float(build_model(cfg).loss(pl.merge_stage_params(pp, tmpl),
                                           fbatch)[0])
    w0 = {k: pp["stacks"][k]["attn"]["wq"].clone() for k in ("enc", "dec")}
    ops.reset_launch_counts()
    tally, undo = _tally_by_mask(ops)
    flosses, walls = [], []
    try:
        for _ in range(ED_FHDP_STEPS):
            t0 = time.perf_counter()
            pp, opt, m = fstep(pp, opt, fbatch)
            flosses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        undo()
    fcounts = ops.launch_counts()
    # each kept microbatch (one a stage here) runs every unit, each
    # checkpointed: its forward twice
    stages = int(ED_MESH.split(",")[-1])
    chains = h["columns"] * min(h["microbatches"], stages)
    units = ED_FHDP_STEPS * chains * L
    want = dict.fromkeys(fcounts, 0)
    want.update({"flash_attention": 2 * units, PRE: units,
                 "flash_attention_bwd_dkv": units,
                 "flash_attention_bwd_dq": units})
    check(fcounts == want, f"encdec FHDP launches {fcounts} != {want}")
    per = ED_FHDP_STEPS * chains
    _check_by_mask(tally, fcounts, {"non-causal": cfg.enc_layers * per,
                                    "causal": cfg.dec_layers * per},
                   "encdec FHDP")
    by_mask["encdec_fhdp"] = tally
    froutes = check_routes(ops, fcounts, "encdec FHDP",
                           ("flash_attention", "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dq", PRE))
    frel = abs(flosses[0] - flat) / abs(flat)
    check(all(np.isfinite(flosses)), f"encdec FHDP losses {flosses}")
    check(frel <= ED_FHDP_RTOL, f"encdec FHDP loss {flosses[0]} vs the flat "
          f"model's {flat} (rel {frel:.2e})")
    fmoved = {k: float((pp["stacks"][k]["attn"]["wq"].float()
                        - w.float()).abs().max()) for k, w in w0.items()}
    check(all(v > 0 for v in fmoved.values()),
          f"encdec FHDP: stacks did not move {fmoved}")
    fpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[encdec-fhdp] {ED_FHDP_STEPS} steps of {ED_FHDP_B} x "
          f"({ED_FHDP_S // 2} frames + {ED_FHDP_S // 2} tokens), "
          f"{h['columns']} FL columns x {h['microbatches']} microbatches of "
          f"{h['mb']}: losses " + ", ".join(f"{x:.6f}" for x in flosses)
          + f", the flat Model.loss {flat:.6f} (rel {frel:.2e}, rtol "
          f"{ED_FHDP_RTOL}); step walls " + ", ".join(f"{w:.1f}"
                                                      for w in walls)
          + f" s; peak {fpeak:.2f} GiB; launches "
          f"{ {k: v for k, v in fcounts.items() if v} }, all on wgmma")
    summary.update(fhdp_losses=flosses, fhdp_flat_loss=flat, fhdp_rel=frel,
                   fhdp_step_walls_s=walls, fhdp_peak_gib=fpeak,
                   fhdp_templates={k: list(v) for k, v in tmpl.items()},
                   fhdp_seq=ED_FHDP_S, launches_by_mask=by_mask)
    del pp, opt, ses, fstep, w0
    torch.cuda.empty_cache()
    pick = ("flash_attention", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq", PRE)
    return ({"encdec_serve": serve_counts, "encdec_train": counts,
             "encdec_fhdp": fcounts},
            {"encdec_serve": {"flash_attention":
                              serve_routes["flash_attention"]},
             "encdec_train": {fn: routes[fn] for fn in pick},
             "encdec_fhdp": {fn: froutes[fn] for fn in pick}}, summary)


def _stack_after_stack_loss(params, cfg, batch):
    """The mean loss of the reference adapter's order on the flat
    ``params``: every super-block's mLSTM unit, then every sLSTM unit
    (m0 m1 .. s0 s1 ..), each unit the one the FHDP step runs, then the
    head."""
    from repro_torch.core import pipeline as pl
    from repro_torch.models import xlstm
    from repro_torch.models.lm import layer
    p = params.to_dict() if hasattr(params, "to_dict") else params
    x = pl._tok_embed(p, batch, cfg)
    for name in ("mlstm", "slstm"):
        for s in range(xlstm._layout(cfg)[0]):
            x = pl._xlstm_block(name, layer(p[name], s), x, cfg, None, None,
                                None)
    lsum, n, _ = pl._head_ce_loss(p, x, batch, cfg)
    return float(lsum) / n


def xlstm_fhdp_main_path(torch, dev, seq=XF_S_CUT, profile_step=False):
    """xlstm-350m's FHDP step at full width and depth through Session
    (the pipeline strategy on a (2, 4) mesh, 3 super-blocks as 6 units
    over 4 stages, in the flat model's order; XF_B sequences of ``seq``
    tokens): the first loss against the
    flat Model.loss on the same params and batch (XF_LOSS_RTOL, bf16),
    which the reference adapter's stack-after-stack order on them
    (:func:`_stack_after_stack_loss`) must miss,
    XF_STEPS steps with the exact mLSTM launches (each kept microbatch's
    21 layers: the forward twice, the checkpoint's recompute included,
    the backward once), all on the wgmma route; finite losses, moved
    stacks; with ``profile_step`` a third step under torch.profiler (at
    full width its CUDA trace holds about 2.9 million kernels, and
    reading it takes minutes: the ``--xlstm-fhdp`` flag only). Returns
    (launches, routes, summary)."""
    from repro_torch.api import Session
    from repro_torch.configs.common import concrete_batch
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm
    from repro_torch.models.registry import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ses = Session("xlstm-350m", full=True, strategy="pipeline",
                  mesh=XF_MESH, shape=f"{seq}x{XF_B}", device=dev)
    step, (pp, opt) = ses.build()
    cfg, tmpl = ses.cfg, ses.strategy.templates
    n_super, n_m = xlstm._layout(cfg)
    print(f"[xlstm-fhdp] {cfg.name} pipeline on mesh {XF_MESH}: templates "
          f"{tmpl}, stage plan {pl.stage_plan(cfg, tmpl)} "
          f"({time.perf_counter() - t0:.1f} s to build)")
    batch = concrete_batch(cfg, ses.shape,
                           torch.Generator(device=dev).manual_seed(41))
    with torch.no_grad():
        merged = pl.merge_stage_params(pp, tmpl)
        flat = float(build_model(cfg).loss(merged, batch)[0])
        stacked = _stack_after_stack_loss(merged, cfg, batch)
        del merged
    wrong = abs(stacked - flat) / abs(flat)
    print(f"[xlstm-fhdp] the stack-after-stack order's loss "
          f"{stacked:.6f} against the flat {flat:.6f}: rel {wrong:.2e}, "
          f"{'beyond' if wrong > XF_LOSS_RTOL else 'WITHIN'} rtol "
          f"{XF_LOSS_RTOL}")
    check(wrong > XF_LOSS_RTOL, f"xlstm FHDP: the stack-after-stack order "
          f"({stacked}) is within rtol {XF_LOSS_RTOL} of the flat loss "
          f"({flat}): the check cannot tell the orders apart")
    w0 = pp["stacks"]["slstm"]["w"].clone()
    ops.reset_launch_counts()
    losses, walls = [], []
    for _ in range(XF_STEPS):
        t0 = time.perf_counter()
        pp, opt, m = step(pp, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    # the microbatches whose loss the step keeps: each column's batch in
    # one-sample microbatches (a microbatch a stage), all scored
    columns, stages = 2, 4
    mb = max(1, XF_B // columns // stages)
    chains = columns * min(XF_B // columns // mb, stages)
    want = dict.fromkeys(counts, 0)
    want.update(mlstm_chunked=2 * XF_STEPS * chains * n_super * n_m,
                mlstm_chunked_bwd=XF_STEPS * chains * n_super * n_m)
    check(counts == want, f"xlstm FHDP launches {counts} != {want}")
    routes = check_routes(ops, counts, "xlstm FHDP",
                          ("mlstm_chunked", "mlstm_chunked_bwd"))
    rel = abs(losses[0] - flat) / abs(flat)
    check(all(np.isfinite(losses)), f"xlstm FHDP losses {losses}")
    check(rel <= XF_LOSS_RTOL, f"xlstm FHDP loss {losses[0]} vs the flat "
          f"model's {flat} (rel {rel:.2e})")
    moved = float((pp["stacks"]["slstm"]["w"] - w0).abs().max())
    check(moved > 0, "xlstm FHDP: the sLSTM's w did not move")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[xlstm-fhdp] {XF_STEPS} steps of {XF_B}x{seq} tokens: losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f", the flat Model.loss {flat:.6f} (rel {rel:.2e}, rtol "
          f"{XF_LOSS_RTOL}); step walls " + ", ".join(f"{w:.1f}"
                                                      for w in walls)
          + f" s; peak {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in counts.items() if v} } by route "
          + str({k: routes[k] for k in ("mlstm_chunked",
                                         "mlstm_chunked_bwd")}))
    summary = dict(seq=seq, losses=losses, flat_loss=flat, rel=rel,
                   stack_after_stack_loss=stacked, stack_after_stack_rel=wrong,
                   step_walls_s=walls, peak_gib=peak,
                   templates={k: list(v) for k, v in tmpl.items()})
    if profile_step:
        state = [pp, opt]

        def one():
            state[0], state[1], _ = step(state[0], state[1], batch)

        t0 = time.perf_counter()
        swall, rows, busy = _profile_rows(torch, one)
        idle = max(0.0, 1 - busy / swall)
        fwd = sum(r[0] for r in rows if MLSTM_NAMES["wgmma"] in r[2])
        bwd = sum(r[0] for r in rows if MLSTM_BWD_NAME in r[2])
        print(f"[profile] bf16 xlstm FHDP step: wall {swall:.1f} ms, device "
              f"busy {busy:.1f} ms (idle {100 * idle:.1f}%), "
              f"{sum(r[1] for r in rows)} device ops; mLSTM forward "
              f"{fwd:.2f} ms, backward {bwd:.2f} ms (the profile took "
              f"{time.perf_counter() - t0:.1f} s)")
        for t, k_, name in rows[:8]:
            print(f"[profile]   {t:.4f} ms/step in {k_:5d} x {name}")
        summary.update(step_wall_ms=swall, step_busy_ms=busy,
                       step_idle=idle, mlstm_fwd_ms=fwd, mlstm_bwd_ms=bwd)
        del state
    del pp, opt, ses, step, w0
    torch.cuda.empty_cache()
    return ({"xlstm_fhdp": counts},
            {"xlstm_fhdp": {k: routes[k] for k in ("mlstm_chunked",
                                                   "mlstm_chunked_bwd")}},
            summary)


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
    start = time.perf_counter()

    def phase(label):
        print(f"[time] {label} done at {time.perf_counter() - start:.1f} s")

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
    tc = tc_report()
    phase("build")

    # 3. kernels against their plain versions
    cfg = get_config("flad-adllm")
    if "--dense" in sys.argv[1:]:
        rows = {"d128": d128_paged_checks(torch, dev),
                "head_dim_128": d128_flash_checks(torch, dev)}
        launches, routes, summary = dense_main_path(torch, dev)
        print(json.dumps({"kernels": rows, "launches": launches,
                          "by_route": routes, "dense": summary},
                         default=str))
        print("chip_smoke --dense: the head_dim-128 kernels and the dense "
              "configs' phase only; no result line")
        return 0
    if "--flash128" in sys.argv[1:]:
        rows = d128_flash_checks(torch, dev)
        counts, routes, summary = dense_train_path(torch, dev)
        print(json.dumps({"kernels": rows, "launches": counts,
                          "by_route": routes, "dense_train": summary},
                         default=str))
        print("chip_smoke --flash128: the head_dim-128 flash kernels and "
              "the dense training phase only; no result line")
        return 0
    if "--hymba" in sys.argv[1:]:
        rows = flash_shape_checks(torch, dev, "hymba_group_5")
        launches, routes, summary = hymba_main_path(torch, dev)
        print(json.dumps({"kernels": rows, "launches": launches,
                          "by_route": routes, "hymba": summary},
                         default=str))
        print("chip_smoke --hymba: the group-5 flash kernels and the Hymba "
              "phase only; no result line")
        return 0
    if "--encdec" in sys.argv[1:]:
        rows = {label: flash_shape_checks(torch, dev, label)
                for label in ENCDEC_SHAPES}
        launches, routes, summary = encdec_main_path(torch, dev)
        phase("encdec")
        print(json.dumps({"kernels": rows, "launches": launches,
                          "by_route": routes, "encdec": summary},
                         default=str))
        print("chip_smoke --encdec: the group-1 flash kernels and the "
              "encoder-decoder phase only; no result line")
        return 0
    if "--xlstm-fhdp" in sys.argv[1:]:
        launches, routes, summary = xlstm_fhdp_main_path(
            torch, dev, seq=XF_S, profile_step=True)
        print(json.dumps({"launches": launches, "by_route": routes,
                          "xlstm_fhdp": summary}, default=str))
        print("chip_smoke --xlstm-fhdp: the ssm FHDP phase only; no result "
              "line")
        return 0
    if "--decode-append" in sys.argv[1:]:
        print(json.dumps({FUSED: decode_append_checks(torch, dev)}))
        print("chip_smoke --decode-append: the fused append-and-decode's "
              "checks only; no result line")
        return 0
    if "--paged" in sys.argv[1:]:
        rows = paged_checks(torch, cfg, dev, np.random.default_rng(0))
        print(json.dumps(rows))
        print("chip_smoke --paged: the paged kernels only; no result line")
        return 0
    if "--spec" in sys.argv[1:]:
        rows = {"paged_verify_attention": verify_checks(torch, cfg, dev),
                PRE: preprocess_checks(torch, dev)}
        params = lm.init(cfg, seed=0, device=dev)
        _, reports, _ = serve_main_path(torch, cfg, params, dev)
        rows["traced_serving"] = traced_serving(torch, cfg, params, dev,
                                                reports["fp32"])[1]
        rows["speculative_phase"] = spec_main_path(torch, cfg, params, dev,
                                                   reports)[2]
        print(json.dumps(rows))
        print("chip_smoke --spec: the verify and preprocess kernels, the "
              "serving path and the speculative phase only; no result line")
        return 0
    if "--vision" in sys.argv[1:]:
        rows = vision_flash_checks(torch, dev)
        launches, by_route, summary = vision_main_path(torch, dev)
        print(json.dumps({"flash": rows, "launches": launches,
                          "by_route": by_route, "vision": summary}))
        print("chip_smoke --vision: the float32 flash kernels at the FHDP "
              "shape and the FHDP phase only; no result line")
        return 0
    if "--async" in sys.argv[1:]:
        launches, by_route, summary = async_main_path(torch, cfg, dev)
        print(json.dumps({"launches": launches, "by_route": by_route,
                          "async": summary}))
        print("chip_smoke --async: the async_hier_fl phase only; no result "
              "line")
        return 0
    if "--swift" in sys.argv[1:]:
        launches, by_route, summary = swift_main_path(torch, dev)
        print(json.dumps({"launches": launches, "by_route": by_route,
                          "swift": summary}))
        print("chip_smoke --swift: the SWIFT phase only; no result line")
        return 0
    if "--xlstm-train" in sys.argv[1:]:
        xcfg = get_config("xlstm-350m")
        row = mlstm_bwd_checks(torch, dev)
        launches, routes, summary = xlstm_train_main_path(torch, xcfg, dev)
        step = xlstm_step_vs_plain(torch, xcfg, dev)
        prof = profile_xlstm_step(torch, xcfg, dev)
        print(json.dumps({"mlstm_chunked_bwd": row, "launches": launches,
                          "by_route": routes, "xlstm_train": summary,
                          "step_vs_plain": step, "profile": prof}))
        print("chip_smoke --xlstm-train: the mLSTM backward's checks and the "
              "xLSTM training phases only; no result line")
        return 0
    if "--mlstm-bwd" in sys.argv[1:]:
        print(json.dumps({"mlstm_chunked_bwd": mlstm_bwd_checks(torch, dev)}))
        print("chip_smoke --mlstm-bwd: the mLSTM backward's checks only; no "
              "result line")
        return 0
    if "--mlstm" in sys.argv[1:]:
        rows = {"mlstm_chunked": mlstm_checks(torch, dev),
                "quantize_kv_append": append_checks(torch, cfg, dev)}
        print(json.dumps(rows))
        print("chip_smoke --mlstm: the mLSTM kernels and the fused append "
              "only; no result line")
        return 0
    kernels = kernel_checks(torch, cfg, dev)
    kernels["paged_verify_attention"] = verify_checks(torch, cfg, dev)
    kernels.update(flash_checks(torch, dev))
    pre = preprocess_checks(torch, dev)
    pre["max_abs_err"] = max(pre["max_abs_err"],
                             kernels[PRE]["max_abs_err"])
    kernels[PRE] = pre
    for name, extra in vision_flash_checks(torch, dev).items():
        kernels[name].update(extra)
    check(all(kernels[n]["vision_f32_library_ms"] is not None
              for n in VISION_NAMES), "a flash row lacks its FHDP-shape "
          "times")
    kernels["dequantize_int8"] = dequant_check(torch, cfg, dev)
    kernels["lora_matmul"] = lora_checks(torch, dev)
    kernels["mlstm_chunked"] = mlstm_checks(torch, dev)
    kernels["mlstm_chunked_bwd"] = mlstm_bwd_checks(torch, dev)
    for name, extra in d128_paged_checks(torch, dev).items():
        kernels[name]["head_dim_128"] = extra
    kernels[FUSED] = decode_append_checks(torch, dev)
    for label, rows in (("head_dim_128", d128_flash_checks(torch, dev)),
                        *((lab, flash_shape_checks(torch, dev, lab))
                          for lab in ("hymba_group_5",) + ENCDEC_SHAPES)):
        for name, extra in rows.items():
            kernels[name][label] = extra
    phase("kernel checks")

    # 4. the main path: serve flad-adllm at full width and depth
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e6:.1f} M params in {cfg.param_dtype}"
          f" ({time.perf_counter() - t0:.1f} s to init)")
    launches, reports, serve_routes = serve_main_path(torch, cfg, params,
                                                      dev)
    traced_launches, traced_summary = traced_serving(torch, cfg, params, dev,
                                                     reports["fp32"])
    profile_decode(torch, cfg, params, dev, kernels=kernels)

    # 4b. paged path vs contiguous oracle, teacher-forced on served streams
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

    phase("serving")

    # 4c. speculative decoding and preemption on the serving path
    spec_launches, spec_routes, spec_summary = spec_main_path(
        torch, cfg, params, dev, reports)

    phase("speculative serving")

    # 5. the training path: two hier_fl rounds at full width
    del params
    torch.cuda.empty_cache()
    train_launches, _, train_routes, codec_by_leaf = train_main_path(
        torch, cfg, dev)

    phase("hier_fl training")

    # 5b. event-driven async FL: sync equivalence, a clocked traced run
    async_launches, async_routes, async_summary = async_main_path(
        torch, cfg, dev)

    phase("async FL")

    # 6. float32 step through kernels vs plain attention; a step's profile
    step_vs_plain(torch, cfg, dev)
    profile_local_step(torch, cfg, dev, kernels=kernels)

    phase("train step checks")

    # 7. the distillation path: two distill_fl rounds at full width
    distill_launches, _, _, distill_routes = distill_main_path(torch, cfg,
                                                               dev)

    phase("distillation")

    # 8. float32 distill step through kernels vs plain; a step's profile
    distill_step_vs_plain(torch, cfg, dev)
    profile_distill_step(torch, cfg, dev, kernels=kernels)

    phase("distill step checks")

    # 8b. the FHDP path: flad-vision pipelined over a (2, 4) mesh
    vision_launches, vision_routes, vision_summary = vision_main_path(
        torch, dev)

    phase("FHDP")

    # 8c. SWIFT-scheduled FHDP with a live template switch
    swift_launches, swift_routes, swift_summary = swift_main_path(torch,
                                                                  dev)

    phase("SWIFT")

    # 9. the xLSTM serving path: xlstm-350m through the legacy scheduler
    xcfg = get_config("xlstm-350m")
    xlstm_launches, _, xlstm_routes = xlstm_main_path(torch, xcfg, dev)
    profile_xlstm(torch, xcfg, dev)
    xlstm_f32_vs_plain(torch, xcfg, dev)

    phase("xLSTM serving")

    # 9b. the xLSTM training path: xlstm-350m by hier_fl
    xt_launches, xt_routes, xt_summary = xlstm_train_main_path(torch, xcfg,
                                                               dev)
    xt_step = xlstm_step_vs_plain(torch, xcfg, dev)
    xt_profile = profile_xlstm_step(torch, xcfg, dev)
    phase("xLSTM training")

    # 9c. the dense configs at head_dim 128, Hymba, the ssm FHDP step, the
    # encoder-decoder
    new_launches, new_routes, new_summary = {}, {}, {}
    for label, path in (("dense", dense_main_path),
                        ("hymba", hymba_main_path),
                        ("xlstm_fhdp", xlstm_fhdp_main_path),
                        ("encdec", encdec_main_path)):
        counts, routes, new_summary[label] = path(torch, dev)
        new_launches.update(counts)
        new_routes.update(routes)
        phase(label)

    def new_routes_of(name, r):
        return sum(c.get(name, {}).get(r, 0) for c in new_routes.values())

    def with_fused(name, counts):
        """A paged decode kernel's launches through both its wrappers:
        the stand-alone decode's and the fused append-and-decode's."""
        return counts.get(name, 0) + (counts.get(FUSED, 0)
                                      if name == "paged_decode_attention"
                                      else 0)

    # 10. one line per ported kernel
    print(f"[kernels] serving kernels' library_ms is null: {LIBRARY_NOTE}; "
          f"mlstm_chunked's: {MLSTM_LIBRARY_NOTE}; mlstm_chunked_bwd's: "
          f"{MLSTM_BWD_LIBRARY_NOTE}")
    rows = []
    for name, k in kernels.items():
        # the paged decode kernels' launches through both wrappers (the
        # fused append-and-decode's also on a row of its own)
        by_path = {"serve": with_fused(name, launches),
                   "serve_traced": with_fused(name, traced_launches),
                   "spec_serve": with_fused(name, spec_launches),
                   "train": train_launches[name],
                   "async": async_launches[name],
                   "distill": distill_launches[name],
                   "xlstm_serve": xlstm_launches[name],
                   "xlstm_train": xt_launches[name],
                   "vision": vision_launches.get(name, 0),
                   "swift": swift_launches.get(name, 0),
                   **{p: with_fused(name, c)
                      for p, c in new_launches.items()}}
        check(sum(by_path.values()) > 0, f"{name} was never launched")
        for label, (path, mask) in (
                ("head_dim_128", ("dense_serve" if name in PAGED_LIBS
                                  else "dense_train", None)),
                *((lab, FLASH_SHAPE_PATHS[lab])
                  for lab in ("hymba_group_5",) + ENCDEC_SHAPES)):
            if label in k:
                counts = (new_launches[path] if mask is None else
                          new_summary["encdec"]["launches_by_mask"][path][mask])
                k[label]["launches"] = with_fused(name, counts)
                check(k[label]["launches"] > 0, f"{name} at {label}: never "
                      f"launched on {path}" + (f" {mask}" if mask else ""))
        if k["ms"] < k["bound_ms"]:
            print(f"[kernels] {name}: {k['ms']:.5f} ms is below its bound "
                  f"{k['bound_ms']:.5f} ms: some input came from the L2")
        extra = {}
        if name in TC_KERNELS:
            extra = {"launches_by_route": {
                r: train_routes[name][r] + distill_routes[name][r]
                + vision_routes.get(name, {}).get(r, 0)
                + swift_routes.get(name, {}).get(r, 0)
                + async_routes.get(name, {}).get(r, 0)
                + new_routes_of(name, r)
                for r in train_routes[name]}, "build": tc[name]}
        if name in TF32_KERNELS:
            extra["build_tf32x3"] = tc[f"{name}/tf32x3"]
        if name in PAGED_LIBS or name == FUSED:
            extra = {"launches_by_route": {
                r: serve_routes[name][r] + spec_routes[name][r]
                + new_routes_of(name, r)
                for r in serve_routes[name]}, "build": tc[name]
                if name != FUSED else {
                    "tma": tc["paged_decode_attention"],
                    "tma128": tc["paged_decode_attention/d128"]}}
            if name != FUSED:
                extra["traced_serving"] = traced_summary
        if name == "paged_decode_attention":
            # its launches above count the fused wrapper's too
            extra["launches_by_wrapper"] = {
                w: sum(c.get(w, 0) for c in (
                    launches, traced_launches, spec_launches,
                    *new_launches.values())) for w in (name, FUSED)}
            for r in extra["launches_by_route"]:
                extra["launches_by_route"][r] += (
                    serve_routes[FUSED].get(r, 0)
                    + spec_routes[FUSED].get(r, 0) + new_routes_of(FUSED, r))
        if name == "mlstm_chunked":
            extra = {"launches_by_route": {
                r: xlstm_routes[r] + xt_routes[name][r]
                + new_routes_of(name, r)
                for r in xlstm_routes}, "build": tc[name]}
        if name == "mlstm_chunked_bwd":
            extra = {"launches_by_route": {
                r: n + new_routes_of(name, r)
                for r, n in xt_routes[name].items()},
                     "build": tc[name],
                     "xlstm_train_phase": xt_summary,
                     "xlstm_step_vs_plain": xt_step,
                     "xlstm_step_profile": xt_profile}
        if name == PRE:
            extra = {"launches_by_route": {
                r: train_routes[name][r] + distill_routes[name][r]
                + vision_routes[name][r] + swift_routes[name][r]
                + async_routes[name][r] + new_routes_of(name, r)
                for r in train_routes[name]}}
        if name == "flash_attention":
            extra["fhdp_phase"] = vision_summary
            extra["swift_phase"] = swift_summary
            extra["async_phase"] = async_summary
            extra["dense_phase"] = new_summary["dense"]
            extra["hymba_phase"] = new_summary["hymba"]
            extra["encdec_phase"] = new_summary["encdec"]
        if name == "mlstm_chunked_bwd":
            extra["xlstm_fhdp_phase"] = new_summary["xlstm_fhdp"]
        if name == "quantize_int8":
            extra = {"train_launches_by_leaf": codec_by_leaf}
        if name == "paged_verify_attention":
            extra = {"launches_by_route":
                     spec_routes["paged_verify_attention"],
                     "build": tc["paged_prefill_attention"],
                     "speculative_phase": spec_summary}
        rows.append({"name": name, "route": "cuda", "source": k["source"],
                     "replaces": k["replaces"],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path, **extra,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k.get("library_ms"),
                     **{x: v for x, v in k.items() if x not in (
                         "source", "replaces", "max_abs_err", "ms",
                         "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}})
    # the flash kernels' head_dim-128 kernels (route wgmma128), a line
    # each: their launches on the main paths, their times at the dense
    # training shape
    for name, (stem, _, kname) in D128_KERNELS.items():
        k = kernels[name]["head_dim_128"]
        by_path = {p: c.get(name, {}).get("wgmma128", 0)
                   for p, c in new_routes.items()}
        check(sum(by_path.values()) > 0, f"{kname} was never launched")
        rows.append({"name": f"{name}_d128", "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
                     "replaces": kernels[name]["replaces"],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path, "kernel": kname,
                     "build": tc[f"{name}/wgmma128"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "simt_ms": k["simt_ms"],
                     "shape": k["shape"], "layouts": k["layouts"]})
    # the paged head_dim-128 kernels (decode's route tma128, prefill's
    # wgmma128): their launches on the dense serving paths, their times at
    # the serving shape (decode: 8 lanes to ctx 300; prefill: the 7-row
    # chunk at 288; bf16 pools) and, beside them, over the int8 pools, at
    # 4096 keys and (prefill) the batched verify's
    shapes = {"paged_decode_attention": "8 lanes to ctx 300, bf16 pools",
              "paged_prefill_attention": "a 7-row chunk at 288, bf16 "
                                         "pools"}
    for name, (stem, kname, route) in PAGED128_LIBS.items():
        k = kernels[name]["head_dim_128"]
        by_path = {p: c.get(name, {}).get(route, 0)
                   + (c.get(FUSED, {}).get(route, 0)
                      if name == "paged_decode_attention" else 0)
                   for p, c in new_routes.items()}
        check(sum(by_path.values()) > 0, f"{kname} was never launched")
        main = k["serving bf16"]
        rows.append({"name": f"{name}_d128", "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
                     "replaces": kernels[name]["replaces"],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path, "kernel": kname,
                     "build": tc[f"{name}/d128"],
                     "max_abs_err": k["max_abs_err"], "ms": main["ms"],
                     "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"], "library_ms": None,
                     "simt_ms": main["simt_ms"],
                     "composition_ms": main["composition_ms"],
                     "shape": shapes[name],
                     **{c: r for c, r in k.items() if isinstance(r, dict)
                        and c != "serving bf16"},
                     "layouts": k["layouts"]})
    print(json.dumps({"kernels": rows}, default=str))
    phase("the whole script")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
