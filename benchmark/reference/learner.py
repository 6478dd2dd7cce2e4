"""The VDN learner's update in plain PyTorch: the masked TD loss of a
minibatch of whole episodes (BPTT over the episode, target Qs from the
target weights with the next step's actions masked on padded steps, the
agents' Qs summed), its gradients by autograd, the clip by global norm and
Adam in optax's form (bias-corrected moments, eps outside the square root,
the learning rate of a cosine decay to ``lr_decay_alpha`` read before the
step).

``cfg`` holds the learner's settings as the configuration file states
them (``gamma``, ``lr``, ``lr_decay_steps`` (0: constant), ``lr_decay_alpha``,
``grad_norm_clip``, ``adam_betas``, ``adam_eps``) and the net's.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference import net
from benchmark.reference.precision import float32, tf32

MASKED_Q = -9999999.0   # the target Q of an action not available


def td_loss(w: dict, target: dict, batch: dict, cfg: dict) -> torch.Tensor:
    """``sum(td^2) / sum(mask)`` of a minibatch: ``o_ext`` (b, T+1, N, obs),
    ``u`` (b, T, N, 1), ``r``, ``padded``, ``terminated`` (b, T, 1)."""
    A = cfg["n_actions"]
    o = batch["o_ext"].float()
    u = batch["u"].long()
    r = batch["r"].float()
    term = batch["terminated"].float()
    mask = 1.0 - batch["padded"].float()
    onehot = torch.nn.functional.one_hot(u[..., 0], A).float() * mask[..., None]
    eval_in, tgt_in = o[:, :-1], o[:, 1:]
    if cfg["last_action"]:
        prev = torch.cat([torch.zeros_like(onehot[:, :1]), onehot[:, :-1]], 1)
        eval_in = torch.cat([eval_in, prev], dim=-1)
        tgt_in = torch.cat([tgt_in, onehot], dim=-1)
    q_eval = net.unroll(w, eval_in, cfg)
    with torch.no_grad():
        q_next = net.unroll(target, tgt_in, cfg)
    q_taken = q_eval.gather(3, u)[..., 0]                      # (b, T, N)
    # every action is available on a live step and none on a padded one
    avail = mask[..., None].expand(q_next.shape)
    q_best = torch.where(avail == 0.0, MASKED_Q, q_next).amax(3)
    q_tot = q_taken.sum(dim=2, keepdim=True)                   # VDN
    q_tot_next = q_best.sum(dim=2, keepdim=True)
    y = r + cfg["gamma"] * q_tot_next * (1.0 - term)
    td = (y.detach() - q_tot) * mask
    return (td ** 2).sum() / mask.sum()


def learning_rate(count: int, cfg: dict) -> float:
    """The step size before the ``count``-th update (0-based): ``lr``, or
    its cosine decay over ``lr_decay_steps`` to ``lr_decay_alpha`` of it,
    in float32 as optax computes it."""
    f = np.float32
    steps = cfg["lr_decay_steps"]
    if not steps:
        return float(f(cfg["lr"]))
    c = f(min(count, steps))
    cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(steps)))
    alpha = f(cfg["lr_decay_alpha"])
    return float(f(cfg["lr"]) * ((f(1) - alpha) * cosine + alpha))


class Adam:
    """Clip by global norm, then Adam, over a dict of weights."""

    def __init__(self, w: dict, cfg: dict):
        self.cfg = cfg
        self.mu = {k: torch.zeros_like(v) for k, v in w.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in w.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, w: dict, grads: dict) -> dict:
        """Step ``w`` in place; returns the clipped gradients."""
        clip = self.cfg["grad_norm_clip"]
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        grads = {k: g * scale for k, g in grads.items()}
        b1, b2 = self.cfg["adam_betas"]
        eps = self.cfg["adam_eps"]
        lr = learning_rate(self.count, self.cfg)
        self.count += 1
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - b2 ** self.count
        for k, g in grads.items():
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
            w[k] -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                               + eps)
        return grads


def updates(w0: dict, batches: list, cfg: dict, half_batch: bool = False,
            control: bool = False):
    """Follow ``len(batches)`` updates from weights ``w0`` (the target
    weights are ``w0`` throughout: no sync falls in so few).  Returns each
    update's loss before its step, the first update's clipped gradients
    and the weights after the last.  ``half_batch`` computes each loss over
    the first half of its minibatch only (a planted fault); ``control``
    computes in TF32."""
    float32()
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    target = {k: v.detach().clone() for k, v in w0.items()}
    opt = Adam(w, cfg)
    losses, first = [], None
    with tf32() if control else contextlib.nullcontext():
        for batch in batches:
            if half_batch:
                half = batch["u"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            loss = td_loss(w, target, batch, cfg)
            grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
            clipped = opt.step(w, grads)
            if first is None:
                first = clipped
            losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in w.items()}
