"""Actor throughput (JAX ``bench.py``): the whole actor loop (observe ->
CRNN forward -> epsilon-greedy -> env step) of B chips over T lockstep
steps, on DMFB 10x10, 4 droplets, fov 9 by default.  Prints one JSON line.

Usage::

    python -m marl_dmfb_tpu_torch.bench [B] [n_blocks] [env] [dtype] \\
        [--device cuda|cpu]

``env`` is ``dmfb`` (default) or ``meda`` (30x60, 4 droplets, fov 19, the
v0.2 observation); ``dtype`` is ``float32`` (default) or ``bf16``.  On the
card a DMFB step is the hand kernel ``csrc/dmfb_step.cu``, T launches a
rollout.

The metric is ``actor_env_steps_per_sec`` = B * T / s over 10 rollouts
chained through their env states (epsilon 1.0, no annealing, floor 0.05,
as JAX passes), with JAX's suffixes ``_meda``, ``_blocks<n>`` and
``_<dtype>``.  JAX's ``vs_baseline`` divides by a north star set for a TPU
host (``BASELINE.json``); here it is null.
"""

from __future__ import annotations

import argparse
import json

import torch

from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.models.networks import build_agent_net, init_params
from marl_dmfb_tpu_torch.rollout import make_rollout
from marl_dmfb_tpu_torch.utils.benchmarking import timeit_chained
from marl_dmfb_tpu_torch.utils.platform import select_device

ITERS = 10
# the arguments of every timed rollout: epsilon, anneal a step, floor
EXPLORE = (1.0, 0.0, 0.05)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", type=int, nargs="?", default=16384)
    p.add_argument("n_blocks", type=int, nargs="?", default=0)
    p.add_argument("env", nargs="?", default="dmfb", choices=["dmfb", "meda"])
    p.add_argument("dtype", nargs="?", default="float32",
                   choices=["float32", "bf16"])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_args(B: int, n_blocks: int, env_name: str, dtype: str,
              device: str) -> Args:
    """JAX ``bench.py``'s configuration."""
    if env_name == "meda":
        if n_blocks:
            raise SystemExit("bench: meda has no obstacle blocks; n_blocks "
                             "must be 0")
        args = Args(name="meda", drop_num=4, n_parallel_envs=B,
                    compute_dtype=dtype, device=device)
    else:
        args = Args(name="dmfb", drop_num=4, fov=9, width=10, length=10,
                    n_parallel_envs=B, block_num=n_blocks,
                    compute_dtype=dtype, device=device)
    args.apply_env_defaults()
    return args.load_hparams()


def actor(args: Args, seed: int = 0):
    """The env of ``args``, its rollout with the agent's parameters drawn
    from ``seed`` (as ``Trainer`` draws them), and B chips of seed 1 on
    ``args.device``: ``(env, net, rollout, states, generator)``."""
    env = make_env_from_args(args)
    args.update_env_info(env.env_info())
    net = init_params(build_agent_net(args),
                      torch.Generator().manual_seed(seed)).to(args.device)
    rollout = make_rollout(env, net, args.rnn_hidden_dim,
                           last_action=args.last_action)
    g = torch.Generator(device=args.device).manual_seed(1)
    states = env.init(args.rollout_batch, g, args.device)
    return env, net, rollout, states, g


def chained(rollout, generator):
    """``timeit_chained``'s step: a rollout from the last one's env
    states (the first from ``init``'s)."""
    def step(i, carry):
        states = getattr(carry, "env_states", carry)
        return rollout(states, generator, *EXPLORE)

    return step


def main(argv=None, iters: int = ITERS) -> dict:
    """Run the benchmark; print and return its line."""
    a = parse(argv)
    select_device(a.device)
    args = make_args(a.B, a.n_blocks, a.env, a.dtype, a.device)
    env, _, rollout, states, g = actor(args)
    sec, _ = timeit_chained(chained(rollout, g), states, iters=iters)
    sps = a.B * env.episode_limit / sec
    metric = ("actor_env_steps_per_sec" if a.env == "dmfb"
              else f"actor_env_steps_per_sec_{a.env}")
    if a.n_blocks:
        metric += f"_blocks{a.n_blocks}"
    if a.dtype != "float32":
        metric += f"_{a.dtype}"
    line = {"metric": metric, "value": sps, "unit": "env-steps/s",
            "vs_baseline": None}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
