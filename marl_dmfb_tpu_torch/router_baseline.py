"""Success rate of the MEDA staircase router (the JAX package's root
``router_baseline.py``).

The reference ships ``BaseLineRouter`` (env/MEDA/meda.py:348-454) as its
non-RL baseline but never calls it, and its reward estimator cannot run as
written.  This plans staircase paths (``envs/baseline_router.py``) for
random tasks drawn by the port's MEDA ``init`` on 30x60, and scores them
with the RL success criterion: every droplet reaches its goal (the snap
radius) within the episode limit.

Usage::

    python -m marl_dmfb_tpu_torch.router_baseline [n_tasks] [drop_num] \\
        [--device cpu]

Prints one JSON line.  The tasks are drawn on the GPU unless ``--device
cpu`` is given (raising where CUDA is asked for and absent); the planner
runs on the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from marl_dmfb_tpu_torch.envs import baseline_router as br
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.utils.platform import select_device


def route_task(starts, dests, width, length, limit):
    """Plan every droplet, then check the RL success criterion; returns
    (success, steps of the longest path, at most ``limit``)."""
    road_map: list = []
    paths = [br.plan_path(road_map, tuple(s), tuple(d), width, length)
             for s, d in zip(starts, dests)]
    sq = lambda a, b: (a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2
    longest = 0
    for path, s, d in zip(paths, starts, dests):
        cur = tuple(s)
        steps = None
        for t, act in enumerate(path):
            if sq(cur, d) < tmeda.SQ_GOAL:   # goal snap (meda.py:272-277)
                steps = t
                break
            cur = br._move_center(cur, act, width, length)
        if steps is None:
            if sq(cur, d) >= tmeda.SQ_GOAL:
                return False, limit   # a discarded or short path never
            steps = len(path)         # arrives
        longest = max(longest, steps)
    return longest <= limit, min(longest, limit)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_tasks", type=int, nargs="?", default=100)
    p.add_argument("drop_num", type=int, nargs="?", default=4)
    p.add_argument("--device", type=str, default="cuda")
    opts = p.parse_args(argv)
    device = select_device(opts.device)
    env = make_env("meda", width=30, length=60, n_droplets=opts.drop_num)
    limit = env.params.episode_limit
    g = torch.Generator(device=device).manual_seed(0)
    states = env.init(opts.n_tasks, g, device)
    starts = states.start.cpu().numpy()
    dests = states.dest.cpu().numpy()
    succ, steps = [], []
    for i in range(opts.n_tasks):
        ok, n_steps = route_task(starts[i], dests[i], 30, 60, limit)
        succ.append(ok)
        # failed episodes count the full limit (common/rollout.py:60-61)
        steps.append(limit if not ok else n_steps)
    result = {
        "metric": f"meda_router_success_{opts.drop_num}d",
        "value": float(np.mean(succ)),
        "unit": f"success rate over {opts.n_tasks} tasks (avg steps "
                f"{float(np.mean(steps)):.1f}, limit {limit})",
        "vs_baseline": None,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
