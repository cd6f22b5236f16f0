"""Synthetic CARLA-like multimodal driving data (paper §6.1; a copy of
``repro/data/synthetic.py``, numpy only, so both packages draw the same
samples from the same seed).

Generates what the stubbed frontends would emit: RGB patch features and
LiDAR pillar features, plus ground-truth waypoints and traffic-light
state, with *town-conditioned non-IID structure*:

  * each town t has a latent environment matrix E_t that colors the
    feature distribution (weather/architecture analogue);
  * the traffic-light state is a (town-rotated) linear readout of the RGB
    features — learnable, but the readout direction drifts across towns,
    so a model trained on one town underperforms on others (this is what
    FL across towns fixes in Fig. 8a);
  * waypoints follow a smooth town-biased trajectory; a red light scales
    them toward the stop line.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DrivingDataConfig:
    n_towns: int = 4
    patches: int = 128          # tokens per modality
    feature_dim: int = 256
    num_waypoints: int = 10
    num_light_classes: int = 4
    noise: float = 0.1
    seed: int = 0


class TownWorld:
    """Latent per-town generative parameters."""

    def __init__(self, cfg: DrivingDataConfig):
        rng = np.random.default_rng(cfg.seed)
        self.cfg = cfg
        f = cfg.feature_dim
        self.env = rng.normal(0, 1, (cfg.n_towns, f, f)) / np.sqrt(f)
        for t in range(cfg.n_towns):
            self.env[t] += np.eye(f) * 1.0           # keep well-conditioned
        self.light_readout = rng.normal(0, 1, (f, cfg.num_light_classes))
        # town-specific rotation of the readout (the non-IID shift)
        self.town_rot = np.stack([
            _random_rotation(f, rng, angle=0.35 * t)
            for t in range(cfg.n_towns)])
        self.heading = rng.uniform(0, 2 * np.pi, cfg.n_towns)

    def sample(self, town: int, n: int, rng) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        f, p = cfg.feature_dim, cfg.patches
        base = rng.normal(0, 1, (n, p, f)).astype(np.float32)
        rgb = base @ self.env[town].astype(np.float32)
        lidar = rng.normal(0, 1, (n, p, f)).astype(np.float32) \
            @ self.env[town].T.astype(np.float32)

        # light state: argmax of the town-rotated readout of mean rgb feats
        pooled = rgb.mean(axis=1)                                   # [n, f]
        logits = pooled @ self.town_rot[town] @ self.light_readout
        light = np.argmax(
            logits + rng.normal(0, cfg.noise, logits.shape), axis=1
        ).astype(np.int32)

        # waypoints: smooth arc along the town heading; red (class 0) stops
        tt = np.linspace(0.2, 2.0, cfg.num_waypoints)
        curv = rng.normal(0, 0.15, (n, 1))
        theta = self.heading[town] + curv * tt[None, :]
        step = np.where(light[:, None] == 0,
                        np.linspace(1, 0.05, cfg.num_waypoints)[None, :],
                        1.0) * tt[None, :]
        wps = np.stack([step * np.cos(theta), step * np.sin(theta)],
                       axis=-1).astype(np.float32)
        wps += rng.normal(0, cfg.noise * 0.1, wps.shape).astype(np.float32)
        return {"rgb": rgb, "lidar": lidar, "light": light,
                "waypoints": wps}


def _random_rotation(f: int, rng, angle: float) -> np.ndarray:
    """Rotation by `angle` in a few random 2-D planes (mild town drift)."""
    R = np.eye(f)
    for _ in range(8):
        i, j = rng.choice(f, 2, replace=False)
        c, s = np.cos(angle), np.sin(angle)
        G = np.eye(f)
        G[i, i] = c; G[i, j] = -s; G[j, i] = s; G[j, j] = c
        R = R @ G
    return R


def make_tokens(light: np.ndarray, town: int, seq_len: int, vocab: int,
                rng) -> np.ndarray:
    """Context 'instruction' tokens for the AD-LLM (navigation + notice):
    a town id token, the light state, then filler."""
    n = light.shape[0]
    toks = rng.integers(10, vocab, (n, seq_len), dtype=np.int64)
    toks[:, 0] = 1 + town
    toks[:, 1] = 5 + light
    return toks.astype(np.int32)
