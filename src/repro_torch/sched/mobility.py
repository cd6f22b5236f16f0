"""DTMC vehicle mobility model + stability scoring (paper §4.1.2, Eq. 3–5;
a copy of ``repro/sched/mobility.py``, numpy only, so both packages draw
the same trajectories from a seed).

The area is an R x R grid of unit cells; mobility patterns are Markov
transition matrices over cells; future-position prediction marginalizes
over patterns given a history (Eq. 3); neighbor stability integrates the
expected relative distance over the dwell horizon (Eq. 5 — lower expected
distance => higher stability; we return the negated distance integral so
"bigger is more stable", matching the argmax in Eq. 6).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class GridWorld:
    size: int                     # cells per side
    patterns: np.ndarray          # [K, C, C] row-stochastic transitions

    @property
    def n_cells(self) -> int:
        return self.size * self.size

    def cell_xy(self, c) -> np.ndarray:
        return np.stack([np.asarray(c) // self.size,
                         np.asarray(c) % self.size], axis=-1)

    def cell_dist(self, a, b) -> np.ndarray:
        """Cell-count distance n(c_a -> c_b) (paper's grid metric)."""
        pa, pb = self.cell_xy(a), self.cell_xy(b)
        return np.abs(pa - pb).sum(axis=-1)


def make_patterns(size: int, n_patterns: int, seed: int = 0,
                  persistence: float = 0.55) -> GridWorld:
    """Synthetic mobility patterns: each pattern is a biased random walk
    with a preferred heading (models route classes, e.g. 'north-bound
    arterial'), plus a stay-put mass."""
    rng = np.random.default_rng(seed)
    C = size * size
    pats = np.zeros((n_patterns, C, C))
    headings = rng.uniform(0, 2 * np.pi, n_patterns)
    for k in range(n_patterns):
        dx = int(np.round(np.cos(headings[k])))
        dy = int(np.round(np.sin(headings[k])))
        for c in range(C):
            x, y = divmod(c, size)
            moves = {}
            for (mx, my), w in (((0, 0), persistence),
                                ((dx, dy), 1 - persistence),
                                ((1, 0), .05), ((-1, 0), .05),
                                ((0, 1), .05), ((0, -1), .05)):
                nx, ny = min(max(x + mx, 0), size - 1), \
                    min(max(y + my, 0), size - 1)
                moves[nx * size + ny] = moves.get(nx * size + ny, 0) + w
            total = sum(moves.values())
            for cc, w in moves.items():
                pats[k, c, cc] = w / total
    return GridWorld(size, pats)


def sample_trajectory(world: GridWorld, pattern: int, start: int,
                      steps: int, rng) -> np.ndarray:
    traj = [start]
    c = start
    for _ in range(steps):
        c = rng.choice(world.n_cells, p=world.patterns[pattern, c])
        traj.append(c)
    return np.asarray(traj)


def pattern_posterior(world: GridWorld, history: Sequence[int]) -> np.ndarray:
    """P(m_a | H) by trajectory likelihood under each pattern (Eq. 3's
    mixture weights)."""
    K = world.patterns.shape[0]
    logp = np.zeros(K)
    for k in range(K):
        for a, b in zip(history[:-1], history[1:]):
            logp[k] += np.log(world.patterns[k, a, b] + 1e-12)
    logp -= logp.max()
    p = np.exp(logp)
    return p / p.sum()


def future_distribution(world: GridWorld, history: Sequence[int],
                        horizon: int) -> np.ndarray:
    """Eq. 3: P(c_f at t | H) for t = 1..horizon. Returns [horizon, C]."""
    post = pattern_posterior(world, history)
    cur = np.zeros(world.n_cells)
    cur[history[-1]] = 1.0
    out = np.zeros((horizon, world.n_cells))
    per_pat = np.tile(cur, (world.patterns.shape[0], 1))
    for t in range(horizon):
        per_pat = np.einsum("kc,kcd->kd", per_pat, world.patterns)
        out[t] = post @ per_pat
    return out


def expected_relative_distance(world: GridWorld, hist_v: Sequence[int],
                               hist_nb: Sequence[int], horizon: int
                               ) -> float:
    """E[sum_t RD_nb(t)] via the joint independent-future factorization of
    Eq. 4."""
    fv = future_distribution(world, hist_v, horizon)
    fn = future_distribution(world, hist_nb, horizon)
    cells = np.arange(world.n_cells)
    D = world.cell_dist(cells[:, None], cells[None, :])   # [C, C]
    return float(np.einsum("tc,td,cd->", fv, fn, D))


def stability_score(world: GridWorld, hist_v: Sequence[int],
                    hist_nb: Sequence[int], dwell_steps: int) -> float:
    """Stb_nb (Eq. 5): negated expected cumulative relative distance over
    the dwell horizon, normalized per step (higher = more stable)."""
    rd = expected_relative_distance(world, hist_v, hist_nb, dwell_steps)
    return -rd / max(dwell_steps, 1)


def in_range_probability(world: GridWorld, hist_v, hist_nb, horizon: int,
                         radius_cells: int) -> float:
    """P(neighbour stays within comm radius for the whole horizon) under a
    per-step independence approximation (used by clustering's c3)."""
    fv = future_distribution(world, hist_v, horizon)
    fn = future_distribution(world, hist_nb, horizon)
    cells = np.arange(world.n_cells)
    D = world.cell_dist(cells[:, None], cells[None, :])
    within = (D <= radius_cells).astype(float)
    p = 1.0
    for t in range(horizon):
        p *= float(np.einsum("c,d,cd->", fv[t], fn[t], within))
    return p
