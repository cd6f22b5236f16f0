"""repro_torch — the PyTorch/CUDA port of the FLAD reproduction.

A second package beside the JAX reference (``repro``): the same module
layout and names, PyTorch idiom inside. It imports ``torch``, numpy and
the standard library only — never ``jax`` and never ``repro`` — so it
runs on a machine that has no JAX. Every entry point takes an explicit
``device`` and defaults to ``"cuda"``; the tests pass ``device="cpu"``,
where each hand-written kernel's wrapper runs its plain PyTorch version.

Ported so far: FHDP, the paper's pipelined FL training, of FLAD's
vision encoder (``pipeline`` and ``fl_pipeline`` over a pod x data x
model mesh whose ranks all run on the one card, the default of
:class:`repro_torch.api.Session`) and the ``tensor`` baseline; for the
dense decoder family, the continuous-batching serving path
(:func:`repro_torch.serve.serve_continuous`), hierarchical FL training
(``hier_fl``) and federated LoRA distillation (``distill_fl``); for the
dense decoder, the xLSTM and Hymba, serving with the legacy static-batch
scheduler (``Session.serve``) and training with every strategy but
``distill_fl``. Eight configs are registered (``repro_torch.configs``):
FLAD's two, xlstm-350m, hymba-1.5b and the dense qwen2.5-32b, qwen3-14b,
qwen3-32b and yi-34b. They are carried by ten hand-written CUDA
kernels in :mod:`repro_torch.kernels` (paged decode and prefill
attention, int8 quantize and dequantize, the flash-attention forward and
its three backward kernels, the fused LoRA matmul, the chunkwise mLSTM);
the flash forward and dK/dV have a second, tensor-core (wgmma) kernel
that bf16 at head_dim 64 takes.
"""
