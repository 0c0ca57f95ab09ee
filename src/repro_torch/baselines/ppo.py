"""PPO baseline (§6.2, after Zhang et al. 2024). Counterpart of
``repro/baselines/ppo.py``.

MDP: state = previous normalized (power, layer); continuous action in
[0,1]^2; reward = accuracy/100 with a -5 penalty on constraint violation;
transition adds N(0, 0.01) noise. Trained for 100 environment steps
(= 100 function evaluations) with entropy coef 0.05, lr 3e-4. The
severely constrained budget prevents meaningful learning — as the paper
reports.

The policy (a 2-32-2 MLP and a learned log std) and the value net
(2-32-1) are plain functions on float32 tensors on ``device`` (the card
unless the caller asks for the CPU); ``torch.autograd.grad`` gives the
gradients and Adam is written out as the reference writes it. The nets'
initial weights and the action noise are the run's ``draws``
(:meth:`PPOBaseline.draw` makes them from a ``torch.Generator`` seeded
with ``seed`` on the device); ``run(seed, draws=...)`` takes them from
the caller instead, so a run can replay the reference's ``jax.random``
draws. The state's transition noise comes from
``np.random.default_rng(seed)``, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bo import BOResult
from repro_torch.device import resolve_device

F32 = torch.float32
POLICY_SIZES = (2, 32, 2)
VALUE_SIZES = (2, 32, 1)


def _mlp(params, x):
    """``params``: a flat list ``[w0, b0, w1, b1, ...]``."""
    n = len(params) // 2
    for i in range(n):
        x = x @ params[2 * i] + params[2 * i + 1]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def _adam(params, grads, state, lr, t):
    b1, b2, eps = 0.9, 0.999, 1e-8
    m0, v0 = state
    m = [b1 * m_ + (1 - b1) * g for m_, g in zip(m0, grads)]
    v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(v0, grads)]
    params = [p - lr * (m_ / (1 - b1 ** t))
              / (torch.sqrt(v_ / (1 - b2 ** t)) + eps)
              for p, m_, v_ in zip(params, m, v)]
    return params, (m, v)


def _grad(loss_fn, params, *args):
    leaves = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        return list(torch.autograd.grad(loss_fn(leaves, *args), leaves))


class PPOBaseline:
    name = "RL (PPO)"

    def __init__(self, problem, budget: int = 100, lr: float = 3e-4,
                 entropy_coef: float = 0.05, clip: float = 0.2,
                 epochs: int = 4, gamma: float = 0.9, device="cuda"):
        self.device = resolve_device(device)
        self.problem = problem
        self.budget = budget
        self.lr = lr
        self.entropy_coef = entropy_coef
        self.clip = clip
        self.epochs = epochs
        self.gamma = gamma

    def draw(self, seed: int = 0) -> dict:
        """The run's random draws from a ``torch.Generator`` seeded with
        ``seed`` on the device: ``pi`` and ``vf``, each net's
        ``[w0, b0, w1, b1]`` (weights N(0, 1/fan_in), zero biases), and
        ``noise``, the ``(budget, 2)`` standard normal action noise."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def net(sizes):
            out = []
            for a, b in zip(sizes[:-1], sizes[1:]):
                out.append(torch.randn((a, b), generator=gen, dtype=F32,
                                       device=self.device) / math.sqrt(a))
                out.append(torch.zeros((b,), dtype=F32, device=self.device))
            return out

        pi, vf = net(POLICY_SIZES), net(VALUE_SIZES)
        noise = torch.randn((self.budget, 2), generator=gen, dtype=F32,
                            device=self.device)
        return dict(pi=pi, vf=vf, noise=noise)

    def run(self, seed: int = 0, draws: Optional[dict] = None) -> BOResult:
        pb = self.problem
        dev = self.device
        rng = np.random.default_rng(seed)
        if draws is None:
            draws = self.draw(seed)

        def dev32(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=dev, dtype=F32)
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        # pi: [w0, b0, w1, b1, log_std]; vf: [w0, b0, w1, b1]
        pi = [dev32(x) for x in draws["pi"]] + [
            torch.full((2,), -1.0, dtype=F32, device=dev)]
        vf = [dev32(x) for x in draws["vf"]]
        noise = dev32(draws["noise"])
        if noise.shape != (self.budget, 2):
            raise ValueError(f"action noise of shape {tuple(noise.shape)}, "
                             f"need ({self.budget}, 2)")
        opt_state = dict(pi=([torch.zeros_like(p) for p in pi],
                             [torch.zeros_like(p) for p in pi]),
                         vf=([torch.zeros_like(p) for p in vf],
                             [torch.zeros_like(p) for p in vf]))
        half_log_2pi = 0.5 * torch.log(
            torch.tensor(2 * math.pi, dtype=F32, device=dev))
        half_log_2pie = 0.5 * torch.log(
            torch.tensor(2 * math.pi * math.e, dtype=F32, device=dev))

        def logp(pi, s, a):
            mu = torch.sigmoid(_mlp(pi[:-1], s))
            log_std = pi[-1]
            std = torch.exp(log_std)
            return torch.sum(-0.5 * ((a - mu) / std) ** 2 - log_std
                             - half_log_2pi, -1)

        def entropy(pi):
            return torch.sum(pi[-1] + half_log_2pie)

        def pi_loss(pi, s, a, adv, logp_old):
            ratio = torch.exp(logp(pi, s, a) - logp_old)
            un = ratio * adv
            cl = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
            return (-torch.mean(torch.minimum(un, cl))
                    - self.entropy_coef * entropy(pi))

        def vf_loss(vf, s, ret):
            return torch.mean((_mlp(vf, s)[:, 0] - ret) ** 2)

        utilities, accs, feas, inc = [], [], [], []
        best_a, best_u, best_acc = None, -np.inf, 0.0

        s = rng.random(2)
        batch_s, batch_a, batch_r, batch_lp = [], [], [], []
        t_adam = 0
        while len(utilities) < self.budget:
            s_t = torch.as_tensor(s, dtype=F32, device=dev)
            mu = torch.sigmoid(_mlp(pi[:-1], s_t))
            a = (mu + torch.exp(pi[-1]) * noise[len(utilities)]).cpu().numpy()
            a = np.clip(a, 0, 1)
            u = pb.evaluate(a)
            rec = pb.history[-1]
            r = u / 100.0 + (-5.0 if not rec.feasible else 0.0)
            utilities.append(u)
            accs.append(rec.accuracy)
            feas.append(rec.feasible)
            if rec.feasible and u > best_u:
                best_a, best_u, best_acc = a.copy(), u, rec.accuracy
            inc.append(best_u if np.isfinite(best_u) else 0.0)

            batch_s.append(s)
            batch_a.append(a)
            batch_r.append(r)
            batch_lp.append(float(logp(pi, s_t, torch.as_tensor(a,
                                                                device=dev))))
            s = np.clip(a + rng.normal(0, 0.01, 2), 0, 1)

            if len(batch_s) == 20 or len(utilities) == self.budget:
                S = torch.as_tensor(np.array(batch_s), dtype=F32, device=dev)
                A = torch.as_tensor(np.array(batch_a), dtype=F32, device=dev)
                R = np.array(batch_r)
                # discounted returns-to-go
                G = np.zeros_like(R)
                acc_g = 0.0
                for i in range(len(R) - 1, -1, -1):
                    acc_g = R[i] + self.gamma * acc_g
                    G[i] = acc_g
                Gt = torch.as_tensor(G, dtype=F32, device=dev)
                V = _mlp(vf, S)[:, 0]
                adv = Gt - V
                # the population std, as jnp's
                adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
                LP = torch.as_tensor(np.array(batch_lp), dtype=F32,
                                     device=dev)
                for _ in range(self.epochs):
                    t_adam += 1
                    gp_ = _grad(pi_loss, pi, S, A, adv, LP)
                    pi, opt_state["pi"] = _adam(pi, gp_, opt_state["pi"],
                                                self.lr, t_adam)
                    gv = _grad(vf_loss, vf, S, Gt)
                    vf, opt_state["vf"] = _adam(vf, gv, opt_state["vf"],
                                                self.lr, t_adam)
                batch_s, batch_a, batch_r, batch_lp = [], [], [], []

        return BOResult(best_a, float(best_u), float(best_acc),
                        len(utilities), utilities, accs, feas, inc)
