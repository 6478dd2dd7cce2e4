#!/usr/bin/env python3
"""Where the time of the PyTorch port's training cycle goes, on one GPU.

    python3 tools/profile_torch_learn.py [--envs 64] [--updates 8] [--top 12]
        [--seeds S]

Builds the trainer of ``python -m marl_dmfb_tpu_torch.train dmfb
--drop_num=4 --fov=9 --n_parallel_envs=<envs>`` (full width: 24 conv
channels, GRU hidden 128, learner batch 128, replay 5000), runs two warm-up
cycles, and prints the card's name and power limit and, each from a
``torch.profiler`` trace:

* one whole train cycle (rollout, store, the cycle's updates): wall time,
  device time summed over kernels, the device's idle share, and the
  heaviest kernels;
* ``--updates`` learner updates alone on one minibatch of 128 episodes: the
  same numbers per update.

The profiler slows the host, so each window is also timed without it
(host clock, ending in a synchronize), and the idle share is given against
both walls.

With ``--seeds S`` (S > 1) the same is done for the seed farm of S seeds
(``--vmap_seeds=S``): a farm cycle, and farm updates on S minibatches.

Writes nothing: the trainer runs cycles, not ``run``, so it saves no
checkpoint or curve.
"""

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from marl_dmfb_tpu_torch.config import (get_train_args,  # noqa: E402
                                        make_env_from_args)
from marl_dmfb_tpu_torch.parallel.seedfarm import SeedFarm  # noqa: E402
from marl_dmfb_tpu_torch.replay import sample, sample_stacked  # noqa: E402
from marl_dmfb_tpu_torch.trainer import Trainer  # noqa: E402
from marl_dmfb_tpu_torch.utils.benchmarking import (  # noqa: E402
    timeit_dispatch)
from marl_dmfb_tpu_torch.utils.platform import select_device  # noqa: E402


def _device_us(evt) -> float:
    """Self device time (microseconds), under either of torch's names."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def seconds(fn, reps: int) -> float:
    """Host-clock seconds of ``reps`` calls of ``fn`` back to back, ended by
    draining the card and reading the last result on the host
    (``utils/benchmarking.timeit_dispatch``)."""
    per_call, _ = timeit_dispatch(fn, iters=reps, warmup=0)
    return per_call * reps


def report(fn, reps: int, what: str, top: int):
    """Time ``reps`` calls of ``fn`` without and then with the profiler;
    print the wall times, the device time, the idle share and the heaviest
    kernels, each per call."""
    plain_ms = seconds(fn, reps) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = seconds(fn, reps) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / reps
    print(f"per {what}: wall {plain_ms:.2f} ms ({wall_ms:.2f} ms profiled), "
          f"device busy {device_ms:.2f} ms, idle share "
          f"{1 - device_ms / plain_ms:.3f} ({1 - device_ms / wall_ms:.3f} "
          f"profiled), {sum(e.count for e in kernels) / reps:.0f} kernel "
          "launches")
    print(f"{'device ms':>10} {'calls':>7}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"{_device_us(e) / 1e3 / reps:>10.3f} {e.count // reps:>7}  "
              f"{e.key[:100]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seeds", type=int, default=1,
                    help="profile the seed farm of this many seeds")
    opts = ap.parse_args(argv)

    select_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    argv = ["dmfb", "--drop_num=4", "--fov=9", f"--n_parallel_envs={opts.envs}"]
    farm = opts.seeds > 1
    if farm:
        argv.append(f"--vmap_seeds={opts.seeds}")
    args = get_train_args(argv, pri=False)
    env = make_env_from_args(args)
    trainer = SeedFarm(env, args, opts.seeds) if farm else Trainer(env, args)
    for _ in range(2):
        trainer.train_cycle()
    what = f"farm of {opts.seeds} seeds, " if farm else ""
    print(f"[{smi}] {what}train cycle, B={trainer.B}, "
          f"{trainer.updates_per_rollout} updates at batch "
          f"{args.batch_size}")
    report(trainer.train_cycle, 1, "cycle", opts.top)

    g = torch.Generator(device="cuda").manual_seed(0)
    if farm:
        idx = torch.randint(0, trainer.replay.size,
                            (opts.seeds, args.batch_size), generator=g,
                            device="cuda")
        batch = sample_stacked(trainer.replay, idx)
    else:
        batch = sample(trainer.replay, args.batch_size, g)
    trainer.learner.update(batch)
    print(f"[{smi}] {what}learner update, batch {args.batch_size} episodes "
          f"x {args.n_agents} agents, T = {args.episode_limit}")
    report(lambda: trainer.learner.update(batch), opts.updates, "update",
           opts.top)


if __name__ == "__main__":
    main()
