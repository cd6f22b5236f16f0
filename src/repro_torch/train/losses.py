"""Loss functions (port of ``repro/train/losses.py``).

``chunked_ce`` computes token cross-entropy over sequence chunks so the
full [B, S, V] float32 logits tensor is never held at once: each chunk's
logits are recomputed in the backward pass (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``). The reference's sharding hints
(``constrain_map``/``constrain_vocab``) have no counterpart on one card.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_ce(xc, w, lc, bias):
    """Summed CE and correct count of one chunk: xc [B, cs, d] float
    against w [d, V] float32, logits in float32."""
    logits = xc.float() @ w
    if bias is not None:
        logits = logits + bias
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    correct = (logits.argmax(-1) == lc).sum()
    return (lse - ll).sum(), correct


def chunked_ce(x, w, labels, *, bias: Optional[torch.Tensor] = None,
               seq_chunk: int = 256):
    """x: [B, S, d] final hidden states; w: [d, V]; labels: [B, S] int.

    Returns (mean_loss, metrics). Logits are ``x.float() @ w.float()`` —
    float32 products of the unrounded inputs, the reference's
    ``preferred_element_type=float32`` — one sequence chunk at a time.
    The float32 head weight is made once, outside the chunks."""
    b, s, _ = x.shape
    cs = min(seq_chunk, s)
    while s % cs:
        cs -= 1
    wf = w.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(0, s, cs):
        xc, lc = x[:, c:c + cs], labels[:, c:c + cs]
        if torch.is_grad_enabled() and (x.requires_grad or wf.requires_grad):
            part, hit = checkpoint(_chunk_ce, xc, wf, lc, bias,
                                   use_reentrant=False)
        else:
            part, hit = _chunk_ce(xc, wf, lc, bias)
        tot = tot + part
        correct = correct + hit
    n = b * s
    loss = tot / n
    return loss, {"ce": loss, "acc": correct.float() / n}


def head_weight(params) -> torch.Tensor:
    """Unembedding matrix [d, V] for either tied or separate heads."""
    if "head" in params:
        return params["head"]["w"]
    return params["embed"]["table"].T
