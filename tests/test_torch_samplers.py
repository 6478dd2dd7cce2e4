"""The port's own draws against the JAX package's, in distribution.

Torch generators cannot replay JAX keys, so every sweep and evaluation of
the port draws other tasks, wear maps, exploration and move outcomes than
the JAX package's; the replay tests hold the dynamics equal given the same
draws, and these hold the draws alike.  Each statistic is a mean over chips
of a per-chip value, drawn from many chips on each side; the two means may
differ by at most ``SIGMAS`` standard errors of their difference (each
side's sample variance over its chip count).  The chip counts make that
bound a few percent of the statistic: a sampler off by so much would move
a degradation sweep's wear, and so its collapse, by as much.

* tasks (``init``: starts, goals, obstacle blocks) at 50x50-4d (the
  degradation rows' board), 20x20-10d (past the lattice fallback's
  threshold, 601 candidate rounds) and 20x20-4d with 2 blocks: the mean
  start-goal Manhattan distance, the mean start and goal coordinates and
  the blocks' mean cell;
* wear maps (``random_degrade_map`` at ``per_degrade`` 1.0, as the sweeps
  run): the mean factor and the share below 0.7;
* the rollout's exploration and move draws, through ``make_rollout`` with a
  policy whose greedy action is always 0, at epsilon 0.3 on chips of health
  0.7: the share of each action and of move draws within the health,
  against the JAX rollout's (``jax.random.randint`` over the 5 actions when
  a uniform draw is below epsilon; a move when its uniform draw is at most
  the health), whose shares are exactly 0.7 + 0.3 / 5 for the greedy action
  and 0.3 / 5 for each other, and 0.7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu.envs import dmfb as jdmfb
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.rollout import make_rollout

SIGMAS = 4.0

torch.set_num_threads(1)


def _close(name, port, jax_, sigmas=SIGMAS):
    port, jax_ = np.asarray(port, np.float64), np.asarray(jax_, np.float64)
    se = np.sqrt(port.var(ddof=1) / port.size + jax_.var(ddof=1) / jax_.size)
    diff = abs(port.mean() - jax_.mean())
    assert diff <= sigmas * se, (
        f"{name}: port {port.mean():.5f}, JAX {jax_.mean():.5f}, "
        f"difference {diff:.5f} > {sigmas} x {se:.5f}")


def _task_stats(start, goal, blocks):
    """Per-chip statistics of ``(B, N, 2)`` starts and goals and ``(B, W,
    L)`` block masks (numpy)."""
    out = {"distance": np.abs(start - goal).sum(-1).mean(-1),
           "start_x": start[..., 0].mean(-1), "start_y": start[..., 1].mean(-1),
           "goal_x": goal[..., 0].mean(-1), "goal_y": goal[..., 1].mean(-1)}
    if blocks.any():
        xs = np.arange(blocks.shape[1])[None, :, None]
        ys = np.arange(blocks.shape[2])[None, None, :]
        cells = blocks.sum(axis=(1, 2))
        out["blocks"] = cells
        out["block_x"] = (blocks * xs).sum(axis=(1, 2)) / cells
        out["block_y"] = (blocks * ys).sum(axis=(1, 2)) / cells
    return out


@pytest.mark.parametrize("width, n, blocks, chips", [
    (50, 4, 0, 16384), (20, 10, 0, 2048), (20, 4, 2, 8192)])
def test_tasks_and_wear_follow_jax(width, n, blocks, chips):
    kw = dict(width=width, length=width, n_droplets=n, n_blocks=blocks,
              fov=9, b_degrade=True, per_degrade=1.0)
    tstate = tdmfb.init(tdmfb.DMFBParams(**kw), chips,
                        torch.Generator().manual_seed(width + n), "cpu")
    jp = jdmfb.DMFBParams(**kw)
    keys = jax.random.split(jax.random.PRNGKey(width * n), chips)
    jstate = jax.jit(lambda ks: jax.lax.map(lambda k: jdmfb.init(jp, k),
                                            ks))(keys)
    port = _task_stats(tstate.start.numpy(), tstate.goal.numpy(),
                       tstate.block_mask.numpy())
    want = _task_stats(np.asarray(jstate.start), np.asarray(jstate.goal),
                       np.asarray(jstate.block_mask))
    assert port.keys() == want.keys() and ("blocks" in port) == (blocks > 0)
    for name in port:
        _close(name, port[name], want[name])
    td, jd = tstate.degrade.numpy(), np.asarray(jstate.degrade)
    assert td.min() >= 0.6 and td.max() <= 1.0
    _close("degrade mean", td.mean(axis=(1, 2)), jd.mean(axis=(1, 2)))
    _close("degrade below 0.7", (td < 0.7).mean(axis=(1, 2)),
           (jd < 0.7).mean(axis=(1, 2)))


class _Greedy0(torch.nn.Module):
    """A policy whose greedy action is always 0."""

    def forward(self, x, h):
        q = torch.zeros((x.shape[0], 5))
        q[:, 0] = 1.0
        return q, h


def test_exploration_and_move_draws_follow_jax():
    env = make_env("dmfb", width=10, length=10, n_droplets=4, fov=9,
                   b_degrade=True, per_degrade=1.0)
    chips, health = 4096, 0.7
    seen = {"a": [], "moved": []}
    step_core = env.step_core

    def recording(states, a, uniforms):
        seen["a"].append(a.clone())
        seen["moved"].append(uniforms <= states.health[0, 0, 0])
        return step_core(states, a, uniforms)

    g = torch.Generator().manual_seed(3)
    states = env.init(chips, g, "cpu")
    states = states._replace(health=torch.full_like(states.health, health))
    roll = make_rollout(env._replace(step_core=recording), _Greedy0(), 8)
    roll(states, g, 0.3, 0.0, 0.3)
    a = torch.stack(seen["a"])                      # (T, B, N)
    moved = torch.stack(seen["moved"])
    # JAX's shares, exactly: epsilon 0.3 draws one of the 5 actions
    jax_shares = {0: 0.7 + 0.3 / 5, **{k: 0.3 / 5 for k in range(1, 5)}}
    for k, p in jax_shares.items():
        share = (a == k).float().mean(dim=(0, 2)).numpy()   # per chip
        se = np.sqrt(share.var(ddof=1) / chips)
        assert abs(share.mean() - p) <= SIGMAS * se, (k, share.mean(), p)
    share = moved.float().mean(dim=(0, 2)).numpy()
    se = np.sqrt(share.var(ddof=1) / chips)
    assert abs(share.mean() - health) <= SIGMAS * se, share.mean()
    # and JAX's own draws of one step, the same statistics
    k_rand, k_expl, k_env = jax.random.split(jax.random.PRNGKey(5), 3)
    ja = jnp.where(jax.random.uniform(k_expl, (chips, 4)) < 0.3,
                   jax.random.randint(k_rand, (chips, 4), 0, 5), 0)
    ju = jax.random.uniform(k_env, (chips, 4)) <= health
    _close("greedy action share", (a == 0).float().mean(dim=(0, 2)),
           np.asarray(ja == 0).mean(-1))
    _close("moves within the health", share, np.asarray(ju).mean(-1))
