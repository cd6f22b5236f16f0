"""repro_torch — the PyTorch/CUDA port of the FLAD reproduction.

A second package beside the JAX reference (``repro``): the same module
layout and names, PyTorch idiom inside. It imports ``torch``, numpy and
the standard library only — never ``jax`` and never ``repro`` — so it
runs on a machine that has no JAX. Every entry point takes an explicit
``device`` and defaults to ``"cuda"``; the tests pass ``device="cpu"``,
where each hand-written kernel's wrapper runs its plain PyTorch version.

Ported so far: the continuous-batching serving path for the dense
decoder family (:func:`repro_torch.serve.serve_continuous`), carried by
three hand-written CUDA kernels in :mod:`repro_torch.kernels`
(paged decode attention, chunked paged prefill attention, int8 row
quantization).
"""
