"""Non-IID partitioning of the synthetic driving data across vehicles and
edge pods (the ``distill_fl`` part of ``repro/data/partition.py``, numpy
only).

Every vehicle of a pod draws from its pod's Dirichlet(beta) town mixture
— beta -> 0 approaches hard partitioning, beta -> inf is IID. numpy's
``default_rng`` streams are the same in both packages, so the datasets
are bit-equal to the reference's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.synthetic import (DrivingDataConfig, TownWorld,
                                        make_tokens)


def dirichlet_mixtures(n_vehicles: int, n_towns: int, beta: float,
                       seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.dirichlet([beta] * n_towns, size=n_vehicles)


def adllm_vehicle_dataset(world: TownWorld, mixture: np.ndarray, n: int, *,
                          seq_len: int, vocab: int,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """AD-LLM training triples for one vehicle drawn from a town mixture;
    the context tokens carry the town id each sample came from.

    Returns ``{"features" [n, P, F], "tokens" [n, S] int32,
    "waypoints" [n, W, 2]}``.
    """
    rng = np.random.default_rng(seed)
    towns = rng.choice(len(mixture), size=n, p=mixture)
    feats, toks, wps = [], [], []
    for t in range(len(mixture)):
        cnt = int((towns == t).sum())
        if not cnt:
            continue
        s = world.sample(t, cnt, rng)
        feats.append(s["rgb"])
        wps.append(s["waypoints"])
        toks.append(make_tokens(s["light"], t, seq_len, vocab, rng))
    if not feats:               # n == 0: keep keys/trailing shapes
        s = world.sample(0, 0, rng)
        feats.append(s["rgb"])
        wps.append(s["waypoints"])
        toks.append(make_tokens(s["light"], 0, seq_len, vocab, rng))
    out = {"features": np.concatenate(feats).astype(np.float32),
           "tokens": np.concatenate(toks),
           "waypoints": np.concatenate(wps).astype(np.float32)}
    perm = rng.permutation(len(out["tokens"]))
    return {k: v[perm] for k, v in out.items()}


def adllm_public_dataset(cfg: DrivingDataConfig, n: int, *, seq_len: int,
                         vocab: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """IID 'public AD corpus' (uniform town mixture): what the cloud warms
    the AD-LLM on before it freezes as the distillation teacher."""
    world = TownWorld(cfg)
    uniform = np.full((cfg.n_towns,), 1.0 / cfg.n_towns)
    return adllm_vehicle_dataset(world, uniform, n, seq_len=seq_len,
                                 vocab=vocab, seed=seed)


def pod_datasets(cfg: DrivingDataConfig, members, samples_per_vehicle: int,
                 *, seq_len: int, vocab: int, beta: float = 0.1,
                 seed: int = 0, heldout: int = 64):
    """Pod-level non-IID split for federated distillation.

    ``members``: per-edge member index arrays (a topology's
    ``member_indices``). Returns ``(train, held, mixtures)``: ``train[c]``
    is vehicle ``c``'s dataset, ``held[e]`` a held-out set drawn from pod
    ``e``'s mixture, and ``mixtures`` the [E, n_towns] pod mixtures.
    """
    world = TownWorld(cfg)
    mix = dirichlet_mixtures(len(members), cfg.n_towns, beta, seed)
    n_clients = sum(len(m) for m in members)
    train: List[Dict[str, np.ndarray]] = [None] * n_clients
    held = []
    for e, idx in enumerate(members):
        for ci in np.asarray(idx):
            train[int(ci)] = adllm_vehicle_dataset(
                world, mix[e], samples_per_vehicle, seq_len=seq_len,
                vocab=vocab, seed=seed + 101 + int(ci))
        held.append(adllm_vehicle_dataset(
            world, mix[e], heldout, seq_len=seq_len, vocab=vocab,
            seed=seed + 7919 + e))
    return train, held, mix
