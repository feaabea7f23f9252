"""RL baselines: Behavior Cloning, BPPO (behavior-proximal policy
optimization) and SAC, with their policy and critic nets and replay buffers.

Port of ``diffphycon_tpu/baselines/rl.py`` (reference baselines/{BC,BPPO}_burgers
and sac_burgers). States and actions are flat vectors (Burgers: u_t (Nx,) ->
f_t (Nx,)), or (H, W, C) fields for the conv nets, channels-last as in the
JAX package.

Nets:
  GaussPolicyMLP: ReLU MLP, tanh head emitting (mu, std) with log_std
    soft-clamped into [-5, 0]; ValueMLP / QMLP: ReLU MLPs with tanh heads.
  ConvGaussPolicy / ConvQ: a strided-conv encoder (flax "SAME" padding,
    which pads (0, 1) at stride 2 on an even size) with a transposed-conv
    decoder (flax's unflipped kernel and "SAME" crop) or a dense head.

Learners (each ``step`` takes its batch, and its Gaussian noise as an
argument or from the learner's ``torch.Generator``; ``update`` samples the
batch with the learner's numpy generator, the indices JAX samples for the
same seed):
  V(s)   <- mse to the stored discounted return;
  Q(s,a) <- SARSA target r + gamma * mask * Q_target(s', a'), Polyak target;
  BC     <- maximise log pi(a|s);
  BPPO   <- clipped-ratio improvement against the frozen old policy with
            advantage Q(s, a~old) - V(s), normalised by the population std;
  SAC    <- twin Q with a tanh-squashed Gaussian policy and automatic
            entropy tuning.
Every optimizer is Adam(0.9, 0.999, eps 1e-8), optax.adam's defaults.

The replay buffers keep their arrays on the host in numpy, as the JAX
package does (a 1e6-transition ``RingReplay`` at state dim 257 and action
dim 128 is ~2.6 GB of host memory, touched only where written); ``sample``
copies the drawn batch to the learner's device.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.nets.init import seeded_init_

CONST_EPS = 1e-10
_BATCH_FIELDS = ("state", "action", "reward", "ret", "next_state", "next_action", "mask")


def soft_clamp(x, low, high):
    """Rescale a tanh output in [-1, 1] to [low, high]."""
    return low + 0.5 * (high - low) * (x + 1.0)


class MLP(nn.Module):
    """ReLU MLP: ``depth`` hidden layers of ``hidden_dim``, then a linear
    output with an optional relu or tanh."""

    def __init__(self, in_dim: int, hidden_dim: int, depth: int, output_dim: int,
                 final_activation: Optional[str] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * depth + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.final_activation = final_activation

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        x = self.layers[-1](x)
        if self.final_activation == "relu":
            x = F.relu(x)
        elif self.final_activation == "tanh":
            x = torch.tanh(x)
        return x


def _mu_std(out, dim: int):
    mu, log_std = out.chunk(2, dim=dim)
    return mu, torch.exp(soft_clamp(log_std, -5.0, 0.0))


class GaussPolicyMLP(nn.Module):
    """s (B, state_dim) -> (mu, std), each (B, action_dim)."""

    def __init__(self, state_dim: int, hidden_dim: int, depth: int, action_dim: int):
        super().__init__()
        self.mlp = MLP(state_dim, hidden_dim, depth, 2 * action_dim, "tanh")

    def forward(self, s):
        return _mu_std(self.mlp(s), -1)


def gauss_log_prob(mu, std, action):
    """Diagonal normal log prob summed over every action dim, (B, 1)."""
    lp = -0.5 * ((action - mu) / std) ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi)
    return lp.reshape(lp.shape[0], -1).sum(-1, keepdim=True)


def _same_pad(x, k: int, stride: int):
    """flax's "SAME" padding of the last two dims of NCHW ``x``: the total
    max((ceil(n / s) - 1) * s + k - n, 0), the smaller half in front."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _encoded_size(n: int) -> int:
    for _ in range(3):
        n = -(-n // 2)
    return n


class _ConvEncoder(nn.Module):
    """Three 3x3 stride-2 convs with ReLU (64 -> 8), NCHW."""

    def __init__(self, in_channels: int, features: int = 32):
        super().__init__()
        chans = [in_channels] + [features * m for m in (1, 2, 4)]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2) for a, b in
                                   zip(chans[:-1], chans[1:]))

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(_same_pad(x, 3, 2)))
        return x


class ConvGaussPolicy(nn.Module):
    """CNN Gaussian policy emitting a per-pixel action field: s (B, H, W,
    C) -> (mu, std), each (B, H, W, action_channels). mu is unbounded (SAC's
    tanh squash is the one bound).

    The decoder's transposed convs follow flax's ``ConvTranspose`` (stride
    2, "SAME"): the stride-dilated input padded (2, 1) and correlated with
    the unflipped kernel. ``nn.ConvTranspose2d(padding=0)`` pads (2, 2) and
    flips its kernel, so the forward crops the last row and column and
    ``utils.convert`` flips the flax kernel."""

    def __init__(self, in_channels: int, action_channels: int = 2, features: int = 32):
        super().__init__()
        self.encoder = _ConvEncoder(in_channels, features)
        chans = [4 * features] + [features * m for m in (2, 1, 1)]
        self.ups = nn.ModuleList(nn.ConvTranspose2d(a, b, 3, stride=2) for a, b in
                                 zip(chans[:-1], chans[1:]))
        self.head = nn.Conv2d(features, 2 * action_channels, 3, padding=1)

    def forward(self, s):
        h = self.encoder(s.permute(0, 3, 1, 2))
        for up in self.ups:
            n, m = 2 * h.shape[-2], 2 * h.shape[-1]
            h = F.relu(up(h)[..., :n, :m])
        mu, std = _mu_std(self.head(h), 1)
        return mu.permute(0, 2, 3, 1), std.permute(0, 2, 3, 1)


class ConvQ(nn.Module):
    """Q over (field obs, field action): s (B, H, W, Cs), a (B, H, W, Ca)
    -> (B, 1) in (-1, 1). The encoder's output is flattened channels-last,
    as flax flattens it."""

    def __init__(self, in_channels: int, image_size=64, features: int = 32,
                 hidden_dim: int = 256):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
        self.encoder = _ConvEncoder(in_channels, features)
        self.fc = nn.Linear(4 * features * _encoded_size(h) * _encoded_size(w), hidden_dim)
        self.out = nn.Linear(hidden_dim, 1)

    def forward(self, s, a):
        h = self.encoder(torch.cat([s, a], dim=-1).permute(0, 3, 1, 2))
        h = F.relu(self.fc(h.permute(0, 2, 3, 1).flatten(1)))
        return torch.tanh(self.out(h))


class ValueMLP(nn.Module):
    def __init__(self, state_dim: int, hidden_dim: int, depth: int):
        super().__init__()
        self.mlp = MLP(state_dim, hidden_dim, depth, 1, "tanh")

    def forward(self, s):
        return self.mlp(s)


class QMLP(nn.Module):
    def __init__(self, state_dim: int, action_dim: int, hidden_dim: int, depth: int):
        super().__init__()
        self.mlp = MLP(state_dim + action_dim, hidden_dim, depth, 1, "tanh")

    def forward(self, s, a):
        return self.mlp(torch.cat([s, a], dim=-1))


# ---------------------------------------------------------------------------
# replay buffers (host numpy storage; batches copied to the learner's device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayBuffer:
    """Offline transitions (s, a, r, return-to-go, s', a', mask)."""

    state: np.ndarray       # (N, state_dim)
    action: np.ndarray      # (N, action_dim)
    reward: np.ndarray      # (N,) immediate reward
    ret: np.ndarray         # (N,) discounted return-to-go
    next_state: np.ndarray
    next_action: np.ndarray
    mask: np.ndarray        # (N,) 0 at episode ends

    @classmethod
    def from_trajectories(cls, states, actions, rewards, gamma=0.99):
        """states (B, T+1, D), actions (B, T, A), rewards (B, T)."""
        b, t = rewards.shape
        ret = np.zeros_like(rewards)
        acc = np.zeros(b)
        for i in range(t - 1, -1, -1):
            acc = rewards[:, i] + gamma * acc
            ret[:, i] = acc
        mask = np.ones((b, t), np.float32)
        mask[:, -1] = 0.0
        next_action = np.concatenate([actions[:, 1:], np.zeros_like(actions[:, :1])], axis=1)

        def flat(a):
            return a.reshape(b * t, *a.shape[2:]).astype(np.float32)

        return cls(state=flat(states[:, :t]), action=flat(actions), reward=flat(rewards),
                   ret=flat(ret), next_state=flat(states[:, 1 : t + 1]),
                   next_action=flat(next_action), mask=flat(mask))

    def sample(self, rng: np.random.Generator, batch_size: int, device):
        """A uniform batch of the 7 fields as tensors on ``device``."""
        idx = rng.integers(0, len(self.state), batch_size)
        return tuple(torch.as_tensor(getattr(self, f)[idx], device=device)
                     for f in _BATCH_FIELDS)


class RingReplay:
    """Online replay memory: fixed capacity, FIFO overwrite, uniform
    sampling of (s, a, r, s', mask). ``sample`` returns ReplayBuffer's
    7-tuple (``ret`` and ``next_action`` zero) so ``SAC.update`` takes
    either buffer."""

    def __init__(self, capacity: int, state_dim, action_dim):
        """state_dim / action_dim: flat sizes (int) or field shapes (tuple)."""
        def as_shape(d):
            return (d,) if isinstance(d, int) else tuple(d)

        self.capacity = capacity
        self.state = np.zeros((capacity, *as_shape(state_dim)), np.float32)
        self.action = np.zeros((capacity, *as_shape(action_dim)), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_state = np.zeros_like(self.state)
        self.mask = np.zeros((capacity,), np.float32)
        self.pos = 0
        self.size = 0

    def push_batch(self, s, a, r, s2, mask):
        s, a = np.asarray(s, np.float32), np.asarray(a, np.float32)
        r, s2 = np.asarray(r, np.float32), np.asarray(s2, np.float32)
        mask = np.broadcast_to(np.asarray(mask, np.float32), r.shape)
        n = s.shape[0]
        idx = (self.pos + np.arange(n)) % self.capacity
        self.state[idx], self.action[idx] = s, a
        self.reward[idx], self.next_state[idx] = r, s2
        self.mask[idx] = mask
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, batch_size: int, device):
        idx = rng.integers(0, self.size, batch_size)

        def t(a):
            return torch.as_tensor(a, device=device)

        z = torch.zeros((batch_size,), device=device)
        a = t(self.action[idx])
        return (t(self.state[idx]), a, t(self.reward[idx]), z, t(self.next_state[idx]),
                torch.zeros_like(a), t(self.mask[idx]))


# ---------------------------------------------------------------------------
# learners
# ---------------------------------------------------------------------------


def _place(net: nn.Module, gen: torch.Generator, device) -> nn.Module:
    seeded_init_(net, gen)
    return net.to(device)


def _adam_step(opt: torch.optim.Optimizer, loss, params: Sequence[torch.Tensor]) -> None:
    """One Adam step on ``loss``'s gradient with respect to ``params`` only
    (other nets in its graph keep no gradient)."""
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=list(params))
    opt.step()


@torch.no_grad()
def _polyak_(target: nn.Module, online: nn.Module, tau: float) -> None:
    for tp, p in zip(target.parameters(), online.parameters()):
        tp.copy_((1 - tau) * tp + tau * p)


def _noise(like, noise, generator):
    if noise is not None:
        return noise
    return torch.randn(like.shape, generator=generator, device=like.device)


@torch.no_grad()
def _gauss_action(policy: nn.Module, s, noise=None):
    """The policy's mean, plus std * noise when noise is given, clipped to
    [-1, 1]."""
    mu, std = policy(s)
    if noise is not None:
        mu = mu + std * noise
    return mu.clamp(-1.0, 1.0)


class BehaviorCloning:
    """Maximise log pi(a|s) on the offline buffer. ``policy``: a custom
    module (e.g. ConvGaussPolicy for field observations) in place of the
    GaussPolicyMLP."""

    def __init__(self, state_dim, action_dim, hidden_dim=512, depth=2, lr=1e-4,
                 batch_size=512, seed=0, policy: Optional[nn.Module] = None, device=None):
        self.device = resolve_device(device)
        net = policy if policy is not None else GaussPolicyMLP(state_dim, hidden_dim, depth,
                                                               action_dim)
        self.policy = _place(net, torch.Generator().manual_seed(seed), self.device)
        self.opt = torch.optim.Adam(self.policy.parameters(), lr=lr)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def step(self, s, a):
        mu, std = self.policy(s)
        loss = -gauss_log_prob(mu, std, a).mean()
        _adam_step(self.opt, loss, self.policy.parameters())
        return loss.detach()

    def update(self, buffer) -> float:
        s, a, *_ = buffer.sample(self._rng, self.batch_size, self.device)
        return float(self.step(s, a))

    def select_action(self, s, noise=None):
        return _gauss_action(self.policy, s, noise)


class ValueLearner:
    """V(s) regression onto the stored returns."""

    def __init__(self, state_dim, hidden_dim=512, depth=2, lr=1e-4, batch_size=512, seed=0,
                 device=None):
        self.device = resolve_device(device)
        self.net = _place(ValueMLP(state_dim, hidden_dim, depth),
                          torch.Generator().manual_seed(seed), self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def step(self, s, ret):
        loss = ((self.net(s) - ret[:, None]) ** 2).mean()
        _adam_step(self.opt, loss, self.net.parameters())
        return loss.detach()

    def update(self, buffer) -> float:
        s, _, _, ret, *_ = buffer.sample(self._rng, self.batch_size, self.device)
        return float(self.step(s, ret))


class QSarsaLearner:
    """Q with the SARSA TD target and a Polyak-averaged target net."""

    def __init__(self, state_dim, action_dim, hidden_dim=512, depth=2, lr=1e-4,
                 batch_size=512, gamma=0.99, tau=5e-3, seed=0, device=None):
        self.device = resolve_device(device)
        self.net = _place(QMLP(state_dim, action_dim, hidden_dim, depth),
                          torch.Generator().manual_seed(seed), self.device)
        self.target = copy.deepcopy(self.net)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.batch_size = batch_size
        self.gamma, self.tau = gamma, tau
        self._rng = np.random.default_rng(seed)

    def step(self, s, a, r, s2, a2, mask):
        with torch.no_grad():
            target = r[:, None] + self.gamma * mask[:, None] * self.target(s2, a2)
        loss = ((self.net(s, a) - target) ** 2).mean()
        _adam_step(self.opt, loss, self.net.parameters())
        _polyak_(self.target, self.net, self.tau)
        return loss.detach()

    def update(self, buffer) -> float:
        s, a, r, _, s2, a2, mask = buffer.sample(self._rng, self.batch_size, self.device)
        return float(self.step(s, a, r, s2, a2, mask))


class BPPO:
    """Behavior-proximal policy optimization: starts from the BC policy and
    improves it with a clipped-ratio objective against the frozen old
    policy, advantage Q(s, a ~ old) - V(s)."""

    def __init__(self, bc: BehaviorCloning, q: QSarsaLearner, v: ValueLearner, lr=1e-4,
                 clip_ratio=0.25, clip_decay=0.96, entropy_weight=0.0, batch_size=512,
                 seed=0):
        self.device = bc.device
        self.policy = copy.deepcopy(bc.policy)
        self.old_policy = copy.deepcopy(bc.policy)
        self.q, self.v = q, v
        self.opt = torch.optim.Adam(self.policy.parameters(), lr=lr)
        self.clip_ratio, self.clip_decay = clip_ratio, clip_decay
        self.entropy_weight = entropy_weight
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def step(self, s, clip: float, noise=None):
        """One update; the old policy's action is mu + std * noise (drawn
        from the learner's generator when None)."""
        with torch.no_grad():
            mu_o, std_o = self.old_policy(s)
            a = mu_o + std_o * _noise(mu_o, noise, self._gen)
            adv = self.q.net(s, a) - self.v.net(s)
            adv = (adv - adv.mean()) / (adv.std(correction=0) + CONST_EPS)
            old_lp = gauss_log_prob(mu_o, std_o, a)
        mu, std = self.policy(s)
        ratio = torch.exp(gauss_log_prob(mu, std, a) - old_lp)
        l1 = ratio * adv
        l2 = ratio.clamp(1 - clip, 1 + clip) * adv
        entropy = (0.5 * (1 + math.log(2 * math.pi)) + torch.log(std)).sum(-1, keepdim=True)
        loss = -(torch.minimum(l1, l2) + entropy * self.entropy_weight).mean()
        _adam_step(self.opt, loss, self.policy.parameters())
        return loss.detach()

    def update(self, buffer, is_clip_decay=True, noise=None) -> float:
        s, *_ = buffer.sample(self._rng, self.batch_size, self.device)
        loss = self.step(s, self.clip_ratio, noise)
        if is_clip_decay:
            self.clip_ratio *= self.clip_decay
        return float(loss)

    def replace_old(self):
        self.old_policy.load_state_dict(self.policy.state_dict())

    def select_action(self, s, noise=None):
        return _gauss_action(self.policy, s, noise)


class SAC:
    """Twin-Q soft actor-critic with a tanh-squashed Gaussian policy and
    automatic entropy tuning (reference sac_burgers/scripts_SAC/sac_2d.py).
    ``policy`` / ``q_module`` (a factory): custom modules for field
    observations (ConvGaussPolicy / ConvQ); ``action_shape``: the per-sample
    action shape when it is a field, for the default target entropy
    -prod(action_shape)."""

    def __init__(self, state_dim, action_dim, hidden_dim=512, depth=2, lr=3e-4, gamma=0.99,
                 tau=5e-3, batch_size=256, seed=0, target_entropy=None,
                 policy: Optional[nn.Module] = None,
                 q_module: Optional[Callable[[], nn.Module]] = None,
                 action_shape: Optional[Sequence[int]] = None, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.policy = _place(policy if policy is not None else
                             GaussPolicyMLP(state_dim, hidden_dim, depth, action_dim),
                             gen, self.device)
        make_q = q_module if q_module is not None else (
            lambda: QMLP(state_dim, action_dim, hidden_dim, depth))
        self.q1 = _place(make_q(), gen, self.device)
        self.q2 = _place(make_q(), gen, self.device)
        self.q1_target = copy.deepcopy(self.q1)
        self.q2_target = copy.deepcopy(self.q2)
        self.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        shape = tuple(action_shape) if action_shape is not None else (action_dim,)
        self.target_entropy = (-float(np.prod(shape)) if target_entropy is None
                               else target_entropy)
        self.opt_pi = torch.optim.Adam(self.policy.parameters(), lr=lr)
        self.opt_q1 = torch.optim.Adam(self.q1.parameters(), lr=lr)
        self.opt_q2 = torch.optim.Adam(self.q2.parameters(), lr=lr)
        self.opt_a = torch.optim.Adam([self.log_alpha], lr=lr)
        self.gamma, self.tau = gamma, tau
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _sample_action(self, s, noise=None):
        """(tanh(mu + std * noise), its log prob with the tanh correction
        log(1 - a^2 + 1e-6) summed per sample)."""
        mu, std = self.policy(s)
        pre = mu + std * _noise(mu, noise, self._gen)
        a = torch.tanh(pre)
        corr = torch.log(1 - a ** 2 + 1e-6)
        logp = gauss_log_prob(mu, std, pre) - corr.reshape(corr.shape[0], -1).sum(
            -1, keepdim=True)
        return a, logp

    def step(self, s, a, r, s2, mask, noise=(None, None)):
        """One update of both Qs, the policy and alpha, then the Polyak
        targets. ``noise``: the draws for the next-state action and for the
        policy loss's action (None: the learner's generator). Returns (the
        two Q losses summed, the policy loss)."""
        alpha = self.log_alpha.detach().exp()
        with torch.no_grad():
            a2, logp2 = self._sample_action(s2, noise[0])
            tq = torch.minimum(self.q1_target(s2, a2), self.q2_target(s2, a2))
            target = r[:, None] + self.gamma * mask[:, None] * (tq - alpha * logp2)
        l1 = ((self.q1(s, a) - target) ** 2).mean()
        _adam_step(self.opt_q1, l1, self.q1.parameters())
        l2 = ((self.q2(s, a) - target) ** 2).mean()
        _adam_step(self.opt_q2, l2, self.q2.parameters())
        an, logp = self._sample_action(s, noise[1])
        qv = torch.minimum(self.q1(s, an), self.q2(s, an))
        lp = (alpha * logp - qv).mean()
        _adam_step(self.opt_pi, lp, self.policy.parameters())
        # the alpha loss takes the log prob of the policy before its update
        la = (-self.log_alpha.exp() * (logp.detach() + self.target_entropy)).mean()
        _adam_step(self.opt_a, la, [self.log_alpha])
        _polyak_(self.q1_target, self.q1, self.tau)
        _polyak_(self.q2_target, self.q2, self.tau)
        return (l1 + l2).detach(), lp.detach()

    def update(self, buffer, noise=(None, None)):
        s, a, r, _, s2, _, mask = buffer.sample(self._rng, self.batch_size, self.device)
        ql, pl = self.step(s, a, r, s2, mask, noise)
        return float(ql), float(pl)

    @torch.no_grad()
    def select_action(self, s, noise=None):
        """tanh(mu), or with ``noise`` the exploring sample tanh(mu + std *
        noise)."""
        if noise is None:
            return torch.tanh(self.policy(s)[0])
        return self._sample_action(s, noise)[0]
