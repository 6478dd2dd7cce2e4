#!/usr/bin/env python3
"""Where the time of the PyTorch port's actor rollout goes, on one GPU.

    python3 tools/profile_torch_rollout.py [--batch 16384] [--greedy]

Runs one warm-up and one profiled epsilon-greedy rollout of DMFB 10x10, 4
droplets, fov 9 (CRNN at the evaluation width, seeded random weights) and
prints the card's name and power limit, the rollout's wall time, the device
time summed over kernels (and so the device's idle share), and the device
time of the heaviest operators and kernels.  Writes no trace file.
"""

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from marl_dmfb_tpu_torch.config import (get_evaluate_args,  # noqa: E402
                                        make_env_from_args)
from marl_dmfb_tpu_torch.evaluate import select_device  # noqa: E402
from marl_dmfb_tpu_torch.models.networks import (  # noqa: E402
    build_agent_net, init_params)
from marl_dmfb_tpu_torch.rollout import make_rollout  # noqa: E402
from marl_dmfb_tpu_torch.utils.benchmarking import (  # noqa: E402
    timeit_dispatch)


def _device_us(evt) -> float:
    """Self device time (microseconds), under either of torch's names."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _total_us(evt) -> float:
    """Device time including children (microseconds)."""
    return getattr(evt, "device_time_total",
                   getattr(evt, "cuda_time_total", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    opts = ap.parse_args(argv)

    select_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args = get_evaluate_args(["dmfb", "--drop_num=4", "--fov=9"])
    env = make_env_from_args(args)
    args.update_env_info(env.env_info())
    net = init_params(build_agent_net(args),
                      torch.Generator().manual_seed(args.seed))
    net = net.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    chips = env.init(opts.batch, g, "cuda")
    rollout = make_rollout(env, net, args.rnn_hidden_dim)
    eps = 0.0 if opts.greedy else 1.0
    anneal = (args.epsilon - args.min_epsilon) / args.anneal_steps * opts.batch
    res = rollout(chips, g, eps, anneal, args.min_epsilon, greedy=opts.greedy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, res = timeit_dispatch(
            lambda: rollout(res.env_states, g, eps, anneal, args.min_epsilon,
                            greedy=opts.greedy), iters=1, warmup=0)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"[{smi}] rollout B={opts.batch}, T={env.episode_limit}, "
          f"{'greedy' if opts.greedy else 'epsilon-greedy'}: wall "
          f"{wall * 1e3:.1f} ms (profiled), device busy {device_ms:.1f} ms, "
          f"idle share {1 - device_ms / (wall * 1e3):.3f}")
    print(f"{'device ms':>10} {'calls':>7}  kernel")
    for e in sorted(kernels, key=_device_us, reverse=True)[:opts.top]:
        print(f"{_device_us(e) / 1e3:>10.2f} {e.count:>7}  {e.key[:100]}")
    ops = [e for e in events if e.device_type.name == "CPU"
           and _total_us(e) > 0]
    print(f"{'device ms':>10} {'calls':>7}  operator (device time incl. "
          "children)")
    for e in sorted(ops, key=_total_us, reverse=True)[:opts.top]:
        print(f"{_total_us(e) / 1e3:>10.2f} {e.count:>7}  {e.key}")


if __name__ == "__main__":
    main()
