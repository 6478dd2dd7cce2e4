"""The QMIX mixer's FLOPs, by :mod:`benchmark.flops`' convention: the
multiply-adds of its matmuls, 2 FLOPs each, of one forward of one row (an
(episode, step) pair: all agents' Qs and one global state); an update
counts 3 such forwards a sample, over batch x T rows: the eval mix's
forward, its backward and the target mix's forward.  The backward is
about one forward's work, where :mod:`benchmark.flops` counts two for the agent
net's: the hyper layers take the global state, which needs no gradient,
so only their weights' gradients are computed (the gradient of the
agents' Qs passes through the small mixing product alone)."""

from __future__ import annotations

from benchmark import flops


def mix_row_flops(cfg: dict) -> float:
    """FLOPs of one forward of the mixer (``reference/qmix.py``'s layers)
    on one row."""
    S, N = cfg["state_dim"], cfg["n_droplets"]
    H, Hh = cfg["qmix_hidden"], cfg["hyper_hidden"]
    if cfg["two_hyper_layers"]:
        hyper = S * Hh + Hh * N * H + S * Hh + Hh * H   # w1, w2
    else:
        hyper = S * N * H + S * H
    hyper += S * H + S * H + H                          # b1, b2
    return 2.0 * (hyper + N * H + H)                    # q^T w1, h w2


def update_flops(cfg: dict, T: int) -> float:
    """One learner update over ``batch_size`` episodes of T steps: the
    agent net's (:func:`benchmark.flops.update_flops`) and the mixer's."""
    return (flops.update_flops(cfg, T)
            + 3.0 * mix_row_flops(cfg) * cfg["batch_size"] * T)


def cycle_flops(cfg: dict, chips: int, T: int) -> float:
    """A training cycle: its rollout (no mixer runs there) and its
    updates."""
    return (flops.rollout_flops(cfg, chips, T)
            + cfg["updates_per_cycle"] * update_flops(cfg, T))
