#!/usr/bin/env python3
"""What the data-parallel path and a spawned rank add to one process's
training, on one GPU.

    python3 tools/profile_torch_mesh.py [--reps 2] [--cycles 4]

Builds trainers of ``python -m marl_dmfb_tpu_torch.train dmfb
--drop_num=4 --fov=9 --n_parallel_envs=64`` (full width) in five settings
and prints the card's name and power limit and each one's ms per train
cycle of a fresh trainer (host clock, ending on a host read, ``utils/benchmarking``), the
first cycle included:

* in this process before it joins a group, and then, once it has joined a
  one-rank NCCL group, alone and as that group's rank (the mesh path: the
  byte gather of each minibatch,
  the packed gradient ``all_reduce``, a collective each rollout step),
  ``--reps`` times in turns; for these also, per call after a warm-up
  cycle, a learner update's, a minibatch sample's, a loss and gradient's
  and an epsilon-greedy rollout's wall time, kernel launches and device
  time (``torch.profiler``), and the ATen operators that the mesh path
  runs more often;
* in a process started with ``torch.multiprocessing``'s spawn method,
  alone, and as the one rank of an NCCL group (``parallel.distributed.
  spawn``, as ``train --mesh`` starts its ranks).

Writes nothing but a temporary file a spawned process reports in.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from marl_dmfb_tpu_torch.config import (get_train_args,  # noqa: E402
                                        make_env_from_args)
from marl_dmfb_tpu_torch.parallel.distributed import spawn  # noqa: E402
from marl_dmfb_tpu_torch.parallel.mesh import from_group  # noqa: E402
from marl_dmfb_tpu_torch.replay import sample  # noqa: E402
from marl_dmfb_tpu_torch.trainer import Trainer  # noqa: E402
from marl_dmfb_tpu_torch.utils.benchmarking import (  # noqa: E402
    timeit_dispatch)

ARGV = ["dmfb", "--drop_num=4", "--fov=9", "--n_parallel_envs=64",
        "--evaluate_task=100"]


def profiled(fn, reps: int = 2) -> dict:
    """Kernel launches, device ms and ATen operator counts per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in kernels)
    return dict(launches=sum(e.count for e in kernels) / reps,
                device_ms=device_us / 1e3 / reps,
                ops={e.key: e.count / reps for e in events
                     if e.device_type.name == "CPU"
                     and e.key.startswith("aten::")})


def cycles_ms(mesh, data_dir: str, n: int) -> list:
    """ms of each of ``n`` train cycles of a fresh trainer."""
    args = get_train_args(ARGV + [f"--data_dir={data_dir}"], pri=False)
    if mesh is not None:
        args.device = str(mesh.device)
    trainer = Trainer(make_env_from_args(args), args, mesh=mesh)
    out = []
    for _ in range(n):
        seconds, _ = timeit_dispatch(trainer.train_cycle, iters=1,
                                     warmup=0, subtract_rtt=False)
        out.append(seconds * 1e3)
    return out


def _spawned_alone(index, data_dir, n, path):
    torch.cuda.set_device(0)
    torch.save(cycles_ms(None, data_dir, n), path)


def _spawned_rank(mesh, data_dir, n, path):
    torch.save(cycles_ms(mesh, data_dir, n), path)


def measure(mesh, data_dir: str) -> dict:
    args = get_train_args(ARGV + [f"--data_dir={data_dir}"], pri=False)
    trainer = Trainer(make_env_from_args(args), args, mesh=mesh)
    trainer.train_cycle()
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, trainer.replay.size, (args.batch_size,),
                        generator=g, device="cuda")
    draw = lambda: sample(trainer.replay, args.batch_size, idx=idx,
                          mesh=mesh)
    batch = draw()
    calls = {
        "update": (lambda: trainer.learner.update(draw()), 10),
        "sample": (draw, 20),
        "loss_and_grads": (lambda: trainer.learner.loss_and_grads(batch),
                           10),
        "rollout": (lambda: trainer.rollout(trainer.env_states,
                                            trainer.generator, 0.5, 0.0,
                                            args.min_epsilon), 3),
    }
    out = {}
    for name, (fn, reps) in calls.items():
        seconds, _ = timeit_dispatch(fn, iters=reps, warmup=1,
                                     subtract_rtt=False)
        out[name] = dict(ms=seconds * 1e3, **profiled(fn))
    seconds, _ = timeit_dispatch(trainer.train_cycle, iters=2, warmup=0,
                                 subtract_rtt=False)
    out["cycle"] = dict(ms=seconds * 1e3)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--cycles", type=int, default=4)
    opts = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_mesh: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.cuda.set_device(0)
    fmt = lambda ms: "[" + ", ".join(f"{x:.1f}" for x in ms) + "]"
    with tempfile.TemporaryDirectory() as tmp:
        ms = cycles_ms(None, os.path.join(tmp, "first"), opts.cycles)
        print(f"[{smi}] this process, no group: ms a cycle {fmt(ms)}",
              flush=True)
        path = os.path.join(tmp, "cycles.pt")
        torch.multiprocessing.start_processes(
            _spawned_alone, args=(os.path.join(tmp, "sa"), opts.cycles,
                                  path), nprocs=1, start_method="spawn")
        print(f"[{smi}] spawned process alone: ms a cycle "
              f"{fmt(torch.load(path))}", flush=True)
        spawn(_spawned_rank, ["cuda:0"], "nccl", os.path.join(tmp, "sr"),
              opts.cycles, path)
        print(f"[{smi}] spawned process, one NCCL rank: ms a cycle "
              f"{fmt(torch.load(path))}", flush=True)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            results = {}
            for rep in range(opts.reps):
                for name, mesh in (("alone", None),
                                   ("rank", from_group("cuda:0"))):
                    ms = cycles_ms(mesh, os.path.join(tmp, name),
                                   opts.cycles)
                    print(f"[{smi}] {rep} this process, {name}: ms a cycle "
                          f"{fmt(ms)}", flush=True)
                    results[name] = measure(mesh, os.path.join(tmp, name))
                    print(f"[{smi}] {rep} {name}: " + ", ".join(
                        f"{k} {v['ms']:.2f} ms"
                        + (f" ({v['launches']:.0f} launches, "
                           f"{v['device_ms']:.2f} ms device)"
                           if "launches" in v else "")
                        for k, v in results[name].items()), flush=True)
        finally:
            dist.destroy_process_group()
    for what in ("update", "rollout"):
        a, b = results["alone"][what]["ops"], results["rank"][what]["ops"]
        more = sorted(((b.get(k, 0) - a.get(k, 0)), k)
                      for k in set(a) | set(b))
        print(f"{what}: ATen ops {sum(a.values()):.0f} alone, "
              f"{sum(b.values()):.0f} as a rank; run more as a rank: "
              + ", ".join(f"{k} +{d:.0f}" for d, k in reversed(more[-8:])
                          if d > 0))


if __name__ == "__main__":
    main()
