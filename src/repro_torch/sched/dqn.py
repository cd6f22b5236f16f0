"""Double DQN in PyTorch (port of ``repro/sched/dqn.py``; paper §4.1.3
"DQN-based Pipeline Generation").

Generic: an environment supplies (state, valid-action mask) vectors; the
agent owns the online/target networks, the replay buffer and the
double-DQN update (action selection by the online net, evaluation by the
target).

The Q-net is a dict of float32 tensors on the agent's ``device``, drawn
from a CPU ``torch.Generator`` (so a seed gives the same weights on every
device); it trains through :class:`repro_torch.train.optimizer.Adam` and
autograd. The replay buffer and the epsilon-greedy exploration keep the
reference's ``np.random.default_rng(seed)``, drawn in the reference's
order, so the same seed gives the same transitions in both packages.
Masking adds ``(mask - 1) * 1e9`` in float32 and ``argmax`` keeps the
first maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.train.optimizer import Adam
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    obs_dim: int
    n_actions: int
    hidden: int = 64
    gamma: float = 0.98
    lr: float = 1e-3
    batch: int = 64
    buffer: int = 20000
    target_update: int = 200
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 3000


def init_qnet(gen: torch.Generator, cfg: DQNConfig, device="cuda") -> dict:
    """Q-net params drawn from ``gen`` (a CPU generator), on ``device``."""
    h = cfg.hidden

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen) * fan_in ** -0.5).to(device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {"w1": normal((cfg.obs_dim, h), cfg.obs_dim), "b1": zeros(h),
            "w2": normal((h, h), h), "b2": zeros(h),
            "w3": normal((h, cfg.n_actions), h), "b3": zeros(cfg.n_actions)}


def q_values(p, obs):
    x = torch.relu(obs @ p["w1"] + p["b1"])
    x = torch.relu(x @ p["w2"] + p["b2"])
    return x @ p["w3"] + p["b3"]


class Replay:
    def __init__(self, cfg: DQNConfig):
        self.cfg = cfg
        self.obs = np.zeros((cfg.buffer, cfg.obs_dim), np.float32)
        self.act = np.zeros(cfg.buffer, np.int32)
        self.rew = np.zeros(cfg.buffer, np.float32)
        self.nxt = np.zeros((cfg.buffer, cfg.obs_dim), np.float32)
        self.nxt_mask = np.zeros((cfg.buffer, cfg.n_actions), np.float32)
        self.done = np.zeros(cfg.buffer, np.float32)
        self.n = 0
        self.i = 0

    def add(self, obs, act, rew, nxt, nxt_mask, done):
        i = self.i
        self.obs[i], self.act[i], self.rew[i] = obs, act, rew
        self.nxt[i], self.nxt_mask[i], self.done[i] = nxt, nxt_mask, done
        self.i = (i + 1) % self.cfg.buffer
        self.n = min(self.n + 1, self.cfg.buffer)

    def sample(self, rng, batch):
        idx = rng.integers(0, self.n, batch)
        return (self.obs[idx], self.act[idx], self.rew[idx],
                self.nxt[idx], self.nxt_mask[idx], self.done[idx])


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


class DoubleDQN:
    """The agent. ``seed`` seeds both the Q-net's generator and the
    numpy generator of exploration and replay sampling."""

    def __init__(self, cfg: DQNConfig, seed: int = 0, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        self.online = init_qnet(gen, cfg, self.device)
        self.target = _clone(self.online)
        self.opt = Adam(lr=cfg.lr, grad_clip=5.0)
        self.opt_state = self.opt.init(self.online)
        self.replay = Replay(cfg)
        self.rng = np.random.default_rng(seed)
        self.step_count = 0

    def set_params(self, online, target=None) -> None:
        """Adopt Q-net params (``target`` defaults to a copy of
        ``online``); Adam restarts."""
        self.online = _clone(online)
        self.target = _clone(online if target is None else target)
        self.opt_state = self.opt.init(self.online)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _update(self, batch) -> float:
        obs, act, rew, nxt, nxt_mask, done = batch
        obs, rew, nxt, nxt_mask, done = (self._tensor(x) for x in (
            obs, rew, nxt, nxt_mask, done))
        act = self._tensor(act, torch.long)
        with torch.no_grad():
            # double-DQN target: online argmax, target value
            q_next_online = q_values(self.online, nxt) + (nxt_mask - 1) * 1e9
            a_star = torch.argmax(q_next_online, dim=1)
            q_star = q_values(self.target, nxt).gather(
                1, a_star[:, None])[:, 0]
            tgt = rew + self.cfg.gamma * (1 - done) * q_star
        live = tree_map(lambda x: x.detach().requires_grad_(), self.online)
        with torch.enable_grad():
            q_sa = q_values(live, obs).gather(1, act[:, None])[:, 0]
            loss = torch.mean((q_sa - tgt) ** 2)
            names = sorted(live)
            grads = torch.autograd.grad(loss, [live[k] for k in names])
        self.online, self.opt_state = self.opt.update(
            dict(zip(names, grads)), self.opt_state, self.online)
        return float(loss.detach())

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(self.step_count / c.eps_decay_steps, 1.0)
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def greedy(self, obs: np.ndarray, mask: np.ndarray) -> int:
        with torch.no_grad():
            q = q_values(self.online, self._tensor(obs)) \
                + (self._tensor(mask) - 1) * 1e9
            return int(torch.argmax(q))

    def act(self, obs: np.ndarray, mask: np.ndarray,
            explore: bool = True) -> int:
        valid = np.flatnonzero(mask > 0)
        if len(valid) == 0:
            return 0
        if explore and self.rng.random() < self.epsilon():
            return int(self.rng.choice(valid))
        return self.greedy(obs, mask)

    def record(self, *transition):
        self.replay.add(*transition)

    def learn(self) -> float:
        self.step_count += 1
        if self.replay.n < self.cfg.batch:
            return 0.0
        loss = self._update(self.replay.sample(self.rng, self.cfg.batch))
        if self.step_count % self.cfg.target_update == 0:
            self.target = _clone(self.online)
        return loss
