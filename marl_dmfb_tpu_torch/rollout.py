"""Batched episode rollout: the actor loop (obs -> net -> action -> env
step) over T steps for B chips (JAX ``rollout.py:37-271``).

The JAX package fused the loop into one ``lax.scan``; here it is a Python
loop over T whose env step is a hand kernel on CUDA, one launch a step for
DMFB (``ops/dmfb_step.py``) and for MEDA (``ops/meda_step.py``).  Episode semantics
are the JAX package's:

* episodes run to ``terminated`` and are then frozen; their remaining
  steps are stored zeroed with ``padded=1`` and ``terminated=1``;
* the team reward is the mean over agents; ``terminated`` is all agents;
* epsilon anneals by ``anneal_per_step * live_frac`` per step, so ended
  episodes stop consuming schedule, and the final value is returned; an
  epsilon of shape (S,) (the seed farm's) splits the chips into S
  seed-major groups, each exploring with and annealing its own epsilon by
  its own live fraction;
* failed episodes count as ``episode_limit`` steps;
* ``o_ext`` holds T+1 observations (o_0 .. o_T), and with ``with_state``
  (QMIX) ``s_ext`` the T+1 global states, int8, each written as its step
  runs (a MEDA 30x60 state is 3600 values a chip).

A rollout is the span ``rollout`` (``utils/tracing.py``): first
``rollout.reset`` (the new tasks and the first observation), then each
step's work, ``rollout.act`` (the net, the argmax, the exploration draws),
``rollout.env_step`` (the move-success draws and the env's step) and
``rollout.record`` (the freezing of ended episodes, the stored fields, the
metrics, the epsilon anneal), and ``rollout.pack`` stacks the episodes.
With ``with_state`` each ``env.global_state`` call is a ``rollout.state``
span: the first before the steps, the others in their records.

Under a mesh (``parallel/mesh.py``) the chips are this rank's rows of the
global batch, and every draw is made at the global shape from the
generator, which is alike on every rank, and cut to the rank's rows: the
new tasks of the reset, the random actions, the exploration draws and the
move-success draws (JAX ``rollout.py:98-134``).  A rank's episodes are then
the same rows of the one-device rollout's, and epsilon anneals by the live
share of the global batch, summed over the ranks at each step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from marl_dmfb_tpu_torch.envs.registry import Env
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                               shard_rows, tile_rows)
from marl_dmfb_tpu_torch.utils import tracing
from marl_dmfb_tpu_torch.utils.platform import disable_tf32


class RolloutResult(NamedTuple):
    episodes: dict              # each (B, T, ...) — replay-buffer layout
    env_states: object          # batched env state (post-episode)
    epsilon: torch.Tensor       # () f32 — annealed epsilon; (S,) per seed
    # per-episode metrics, each (B,)
    reward: torch.Tensor
    steps: torch.Tensor
    constraints: torch.Tensor
    success: torch.Tensor


class RolloutNoise(NamedTuple):
    """Pre-drawn randomness for a rollout, each (T, B, N); ``rand_a`` and
    ``explore_u`` are unused (may be None) in a greedy rollout."""

    rand_a: Optional[torch.Tensor]     # int32 in [0, n_actions)
    explore_u: Optional[torch.Tensor]  # f32 in [0, 1): explore iff < eps
    env_uniforms: torch.Tensor         # f32 in [0, 1): move-success draws


def _tree_where(cond_b: torch.Tensor, a, b):
    def sel(x, y):
        if x is y:   # a field the step left as it was
            return x
        return torch.where(cond_b.view(-1, *([1] * (x.dim() - 1))), x, y)

    return type(a)(*(sel(x, y) for x, y in zip(a, b)))


def make_rollout(env: Env, net: torch.nn.Module, rnn_hidden: int,
                 with_state: bool = False, last_action: bool = True,
                 mesh: Optional[Mesh] = None):
    """Build ``rollout(env_states, generator, epsilon, anneal_per_step,
    min_epsilon, greedy=False, noise=None) -> RolloutResult``.

    ``net`` is called as it is when the rollout runs, so a caller may
    update its parameters in place between rollouts.  Its input ends with
    the last action's one-hot when ``last_action`` is on.  Randomness comes
    from ``generator`` (on the states' device) unless ``noise`` gives it,
    which lets tests replay the JAX package's draws, and the seed farm
    give each seed its own generator's.  ``with_state`` adds the episodes'
    global states, ``s_ext`` (JAX rollout.py:191-193, 239-243).  Under
    ``mesh`` the states are this rank's rows of the global batch and
    ``noise``, when given, is the global batch's (module docstring)."""
    disable_tf32()
    N, A, T = env.n_agents, env.n_actions, env.episode_limit

    def net_forward(obs, last_oh, h):
        B = obs.shape[0]
        x = obs.float()
        if last_action:
            x = torch.cat([x, last_oh], dim=-1)
        x = x.reshape(B * N, -1)
        q, h2 = net(x, h.reshape(B * N, rnn_hidden))
        return q.view(B, N, A), h2.view(B, N, rnn_hidden)

    @torch.no_grad()
    def rollout(env_states, generator: torch.Generator, epsilon,
                anneal_per_step, min_epsilon, greedy: bool = False,
                noise: Optional[RolloutNoise] = None) -> RolloutResult:
        with tracing.span("rollout"):
            return run(env_states, generator, epsilon, anneal_per_step,
                       min_epsilon, greedy, noise)

    def run(env_states, generator, epsilon, anneal_per_step, min_epsilon,
            greedy, noise) -> RolloutResult:
        with tracing.span("rollout.reset"):
            if mesh is None:
                states = env.reset(env_states, generator)
            else:   # the global batch's new tasks, this rank's rows of them
                states = shard_rows(mesh, env.reset(
                    tile_rows(mesh, env_states), generator))
            obs0 = env.observe(states)
        B, device = obs0.shape[0], obs0.device
        n = 1 if mesh is None else mesh.size
        rows = slice(None) if mesh is None else mesh.rows(B * n)
        f32 = dict(dtype=torch.float32, device=device)
        eps = torch.as_tensor(epsilon, **f32)
        anneal = torch.as_tensor(anneal_per_step, **f32)
        min_eps = torch.as_tensor(min_epsilon, **f32)
        seeds = eps.shape[0] if eps.dim() else 0
        if seeds:   # each chip explores with its seed's epsilon
            def live_frac(live):
                return live.view(seeds, -1).float().mean(dim=1)

            def chip_eps(eps):
                return eps.repeat_interleave(B // seeds)[:, None]
        else:
            def live_frac(live):
                return all_reduce_sum(mesh, live.float().sum()) / (B * n)

            def chip_eps(eps):
                return eps

        obs = obs0
        last = torch.zeros((B, N, A), **f32)
        h = torch.zeros((B, N, rnn_hidden), **f32)
        live = torch.ones((B,), dtype=torch.bool, device=device)
        trans = {k: [] for k in ("o_next", "u", "r", "padded", "terminated")}
        if with_state:
            with tracing.span("rollout.state"):
                s0 = env.global_state(states)
            s_ext = s0.new_empty((B, T + 1, s0.shape[1]))
            s_ext[:, 0] = s0
        metrics = {k: [] for k in ("reward", "live", "constraints", "success")}
        for t in range(T):
            with tracing.span("rollout.act"):
                q, h = net_forward(obs, last, h)
                a = q.argmax(dim=-1).to(torch.int32)
                if not greedy:
                    if noise is None:
                        rand_a = torch.randint(
                            0, A, (B * n, N), generator=generator,
                            device=device, dtype=torch.int32)
                        explore_u = torch.rand(
                            (B * n, N), generator=generator, device=device)
                    else:
                        rand_a = noise.rand_a[t]
                        explore_u = noise.explore_u[t]
                    a = torch.where(explore_u[rows] < chip_eps(eps),
                                    rand_a[rows], a)
            with tracing.span("rollout.env_step"):
                uniforms = (torch.rand((B * n, N), generator=generator,
                                       device=device)
                            if noise is None else noise.env_uniforms[t])[rows]
                new_states, out = env.step_core(states, a, uniforms)
            with tracing.span("rollout.record"):
                states = _tree_where(live, new_states, states)

                lv3 = live[:, None, None]
                trans["o_next"].append(torch.where(lv3, out.obs, 0))
                trans["u"].append(torch.where(lv3, a[..., None], 0))
                trans["r"].append(
                    torch.where(live, out.team_reward, 0.0)[:, None])
                trans["padded"].append((~live)[:, None])
                trans["terminated"].append(
                    torch.where(live, out.terminated, True)[:, None])
                if with_state:
                    with tracing.span("rollout.state"):
                        s_next = env.global_state(new_states)
                    s_ext[:, t + 1] = torch.where(live[:, None], s_next, 0)
                metrics["reward"].append(
                    torch.where(live, out.team_reward, 0.0))
                metrics["live"].append(live.int())
                metrics["constraints"].append(
                    torch.where(live, out.constraints, 0))
                metrics["success"].append(torch.where(live, out.success, 0))
                if not greedy:
                    eps = torch.maximum(min_eps,
                                        eps - anneal * live_frac(live))
                # obs/last-action carries of ended episodes need no
                # freezing: everything stored from them is masked by `live`
                live = live & ~out.terminated
                obs = out.obs
                last = F.one_hot(a.long(), A).float()

        tracing.count("rollout.chip_steps", B * T)
        with tracing.span("rollout.pack"):
            episodes = {k: torch.stack(v, dim=1) for k, v in trans.items()}
            episodes["o_ext"] = torch.cat(
                [obs0[:, None], episodes.pop("o_next")], dim=1)
            if with_state:
                episodes["s_ext"] = s_ext
            m = {k: torch.stack(v) for k, v in metrics.items()}   # (T, B)
            del trans, metrics   # the steps' tensors are freed in the span
            success = (m["success"].sum(dim=0) > 0).int()
            steps = torch.where(success == 1, m["live"].sum(dim=0), T)
            return RolloutResult(
                episodes=episodes,
                env_states=states,
                epsilon=eps,
                reward=m["reward"].sum(dim=0),
                steps=steps.int(),
                constraints=m["constraints"].sum(dim=0).int(),
                success=success,
            )

    return rollout


def summarize_eval(result: RolloutResult,
                   mesh: Optional[Mesh] = None) -> dict:
    """Average the per-episode metrics (reference ``Evaluator.evaluate``);
    under ``mesh``, over every rank's episodes (float64 sums)."""
    if mesh is None:
        return {
            "reward": float(result.reward.mean()),
            "steps": float(result.steps.float().mean()),
            "constraints": float(result.constraints.float().mean()),
            "success_rate": float(result.success.float().mean()),
        }
    sums = torch.stack([x.double().sum() for x in (
        result.reward, result.steps, result.constraints, result.success)]
        + [torch.tensor(float(result.reward.numel()), dtype=torch.float64,
                        device=result.reward.device)])
    sums = all_reduce_sum(mesh, sums).tolist()
    return {k: v / sums[-1] for k, v in zip(
        ("reward", "steps", "constraints", "success_rate"), sums)}
