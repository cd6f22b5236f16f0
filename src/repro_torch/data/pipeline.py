"""Host-side batching (the part of ``repro/data/pipeline.py`` that
``distill_fl`` uses, numpy only): shuffled epoch iterators and
client-stacked round batches. Batches stay numpy; the caller moves them
to its device."""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def batches(data: Dict[str, np.ndarray], batch_size: int, *, seed: int = 0,
            epochs: int = 1, drop_last: bool = True
            ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = rng.permutation(n)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            idx = perm[i:i + batch_size]
            yield {k: v[idx] for k, v in data.items()}


def client_round_batches(datasets: Sequence[Dict[str, np.ndarray]],
                         local_steps: int, batch_size: int, *,
                         round_idx: int = 0) -> Dict[str, np.ndarray]:
    """Assemble one FL round's batches: [C, E, B, ...] per key."""
    out: Dict[str, List] = {}
    for ci, data in enumerate(datasets):
        it = batches(data, batch_size, seed=round_idx * 977 + ci,
                     epochs=local_steps + 1)
        steps = [next(it) for _ in range(local_steps)]
        for k in steps[0]:
            out.setdefault(k, []).append(np.stack([s[k] for s in steps]))
    return {k: np.stack(v) for k, v in out.items()}
