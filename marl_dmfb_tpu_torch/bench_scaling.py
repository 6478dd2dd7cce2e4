"""Scaling of the actor loop with the number of devices (JAX
``bench_scaling.py``): the rollout of ``per_device_b`` chips a rank over
n = 1, 2, 4, 8, ... ranks, up to the visible devices, with the agent's
parameters replicated.  Prints one JSON line a rank count, and, for each n
above 1, the sharding overhead.

Usage::

    python -m marl_dmfb_tpu_torch.bench_scaling [per_device_b] \\
        [--device cuda|cpu]

Each count n runs as n new processes in one ``torch.distributed`` group
(``parallel/distributed.spawn``: NCCL on the cards, rank r on ``cuda:r``;
gloo under ``--device cpu``, where every core counts as a device, as
``--mesh n`` counts them).  Above one rank the rollout is the data-parallel
one that ``train --mesh n`` runs: every rank draws the global batch's
tasks and draws and keeps its rows.  Each rank times ``ITERS`` chained
rollouts between two barriers, after one untimed rollout, and the slowest
rank's time counts, as the slowest device gates JAX's SPMD step.

* ``actor_env_steps_per_sec_{n}dev``: n * per_device_b * T / s, with
  ``vs_baseline`` the parallel efficiency against n = 1;
* ``sharding_overhead_ratio_{n}dev``: n ranks' rate against one device's
  on the same total batch (one rank at n * per_device_b chips).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from marl_dmfb_tpu_torch.bench import actor, chained
from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.parallel.distributed import (backend_for,
                                                      rank_devices, spawn)
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, barrier, replicate,
                                               shard_rows, visible_devices)
from marl_dmfb_tpu_torch.rollout import make_rollout
from marl_dmfb_tpu_torch.utils.benchmarking import hostread, timeit_chained
from marl_dmfb_tpu_torch.utils.platform import select_device

ITERS = 3
SIZES = (1, 2, 4, 8, 16, 32)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("per_device_b", type=int, nargs="?", default=1024)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_args(device: str) -> Args:
    """JAX ``bench_scaling.py``'s configuration: DMFB 10x10, 4 droplets,
    fov 9."""
    args = Args(name="dmfb", drop_num=4, fov=9, width=10, length=10,
                device=device)
    args.apply_env_defaults()
    return args.load_hparams()


def slowest(mesh: Mesh, seconds: float) -> float:
    """The largest of the ranks' ``seconds``."""
    t = torch.tensor([seconds], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def actor_rank(mesh: Mesh, args: Args, batches, iters: int, out: str):
    """A rank of the benchmark: for each global batch of ``batches``, the
    rollout of this rank's rows timed between barriers; rank 0 writes the
    slowest rank's seconds per rollout, by global batch, to ``out``."""
    one = mesh if mesh.size > 1 else None
    args.device = str(mesh.device)
    seconds = {}
    for B in batches:
        args.n_parallel_envs = B
        env, net, _, states, g = actor(args)
        replicate(one, net)
        rollout = make_rollout(env, net, args.rnn_hidden_dim,
                               last_action=args.last_action, mesh=one)
        step = chained(rollout, g)
        warm = step(0, shard_rows(one, states))
        hostread(warm)
        barrier(mesh)
        sec, _ = timeit_chained(step, warm, iters=iters, warmup=0)
        seconds[B] = slowest(mesh, sec)
        barrier(mesh)
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump(seconds, f)


def time_ranks(n: int, batches, args: Args, iters: int, device) -> dict:
    """Seconds per rollout of each global batch of ``batches`` over ``n``
    ranks (the slowest rank's)."""
    with tempfile.TemporaryDirectory(prefix="marl_dmfb_bench_") as tmp:
        out = os.path.join(tmp, "seconds.json")
        spawn(actor_rank, rank_devices(device, n), backend_for(device),
              args, list(batches), iters, out)
        with open(out) as f:
            return {int(B): s for B, s in json.load(f).items()}


def main(argv=None, iters: int = ITERS) -> list:
    """Run the benchmark; print and return its lines."""
    a = parse(argv)
    device = select_device(a.device)
    args = make_args(a.device)
    T = make_env_from_args(args).episode_limit
    b = a.per_device_b
    sizes = [n for n in SIZES if n <= visible_devices(device)]
    # one device: its own batch, and the total batch of every larger count
    alone = time_ranks(1, [b * n for n in sizes], args, iters, device)
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    for n in sizes:
        sec = alone[b] if n == 1 else time_ranks(n, [b * n], args, iters,
                                                 device)[b * n]
        sps = b * n * T / sec
        emit({"metric": f"actor_env_steps_per_sec_{n}dev", "value": sps,
              "unit": "env-steps/s",
              "vs_baseline": sps * alone[b] / (b * T * n)})
        if n > 1:
            ratio = alone[b * n] / sec
            emit({"metric": f"sharding_overhead_ratio_{n}dev",
                  "value": ratio,
                  "unit": (f"{n} ranks' throughput / one device's, same "
                           f"total batch ({b * n} chips)"),
                  "vs_baseline": ratio})
    return lines


if __name__ == "__main__":
    main()
