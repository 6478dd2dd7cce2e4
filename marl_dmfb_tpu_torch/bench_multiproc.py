"""Training-cycle time against the number of ranks at a fixed total work
(the counterpart of JAX ``bench_multiproc.py``).

JAX compares one process of 4 virtual CPU devices with 2 processes of 2
and 4 of 1: the same mesh, with the collectives crossing more process
boundaries.  In ``torch.distributed`` a rank owns one device, so here the
total work stays JAX's and the rank count varies: DMFB 10x10, 2 droplets,
fov 9, a global rollout of ``TOTAL_B`` = 32 chips, ``max(1, round(train_time
* B / n_episodes))`` updates a cycle at the YAML's minibatch (rounded down
to tile the ranks under ``--local_sampling``, as JAX rounds it), one
untimed cycle and ``CYCLES`` = 3 timed ones.  The variants, each a new
group of processes (``parallel/distributed.spawn``):

* ``train_cycle_s_1rank``: one rank, no mesh;
* ``train_cycle_s_2rank``: 2 ranks, the global ring;
* ``train_cycle_s_2rank_local_sampling``: 2 ranks, a ring each;
* ``train_cycle_s_4rank``: 4 ranks, the global ring;
* ``multiproc_efficiency``: the 1-rank time over the 2-rank time.

Under ``--device cpu`` the ranks are gloo processes on the CPU, the
stand-in that JAX's script is; under ``--device cuda`` (the default) NCCL
ranks, rank r on ``cuda:r``, and a variant that needs more cards than are
visible is left out (a line on stderr says so).  The slowest rank's time
counts.

``collective_bytes_per_update`` lines count the port's own collectives, per
rank and update, for DMFB 10x10-2d and MEDA 30x60-4d: the gradient
``all_reduce`` (the parameters' float32 bytes and the loss's two sums), and
under the global ring the minibatch gather (``mesh.gather_rows``), which
all-reduces the bytes of every minibatch row on every rank; under
``--local_sampling`` no row moves.  The store's gather of a cycle's
episodes (global ring only) is given per cycle at ``TOTAL_B``.

Usage::

    python -m marl_dmfb_tpu_torch.bench_multiproc [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from marl_dmfb_tpu_torch import replay as replay_lib
from marl_dmfb_tpu_torch.bench_scaling import slowest
from marl_dmfb_tpu_torch.config import Args, make_env_from_args
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.models.networks import build_agent_net
from marl_dmfb_tpu_torch.parallel.distributed import (backend_for,
                                                      rank_devices, spawn)
from marl_dmfb_tpu_torch.parallel.mesh import Mesh, barrier, visible_devices
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.benchmarking import hostread, timeit_chained
from marl_dmfb_tpu_torch.utils.platform import select_device

CYCLES = 3
TOTAL_B = 32
# (metric suffix, ranks, --local_sampling)
VARIANTS = (("1rank", 1, False), ("2rank", 2, False),
            ("2rank_local_sampling", 2, True), ("4rank", 4, False))
UNIT = f"s/cycle (B={TOTAL_B}, 10x10-2d)"
# the rows of the bytes count, each env built as JAX's is
# (bench_multiproc.py:151-157: ``make_env(name, **kw)``, which gives MEDA
# its v0 observation, float32 in the ring)
BYTE_ROWS = (("dmfb", dict(width=10, length=10, n_droplets=2, fov=9),
              "dmfb 10x10-2d fov9 (this bench)"),
             ("meda", dict(width=30, length=60, n_droplets=4, fov=19),
              "meda 30x60-4d fov19"))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def make_args(device: str, n: int, local: bool) -> Args:
    """JAX's worker configuration (``bench_multiproc.py:50-58``) for ``n``
    ranks."""
    args = Args(name="dmfb", drop_num=2, fov=9, width=10, length=10,
                n_parallel_envs=TOTAL_B, local_sampling=local,
                device=device)
    args.apply_env_defaults()
    args.load_hparams()
    if local and args.batch_size % n:
        args.batch_size = args.batch_size // n * n
    return args


def train_rank(mesh: Mesh, args: Args, cycles: int, out: str):
    """A rank of one variant: a ``Trainer`` on this rank's rows, one
    untimed cycle, then ``cycles`` timed between barriers; rank 0 writes
    the slowest rank's seconds a cycle and the updates a cycle to
    ``out``."""
    args.device = str(mesh.device)
    trainer = Trainer(make_env_from_args(args), args,
                      mesh=mesh if mesh.size > 1 else None)

    def step(i, loss):
        trainer.train_cycle()
        return trainer.losses[-1]

    hostread(step(0, None))
    barrier(mesh)
    sec, _ = timeit_chained(step, None, iters=cycles, warmup=0)
    sec = slowest(mesh, sec)
    barrier(mesh)
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump({"cycle_s": sec,
                       "updates": trainer.updates_per_rollout}, f)


def run_variant(n: int, local: bool, device, cycles: int) -> dict:
    """``{"cycle_s", "updates"}`` of ``n`` ranks."""
    with tempfile.TemporaryDirectory(prefix="marl_dmfb_bench_") as tmp:
        out = os.path.join(tmp, "variant.json")
        spawn(train_rank, rank_devices(device, n), backend_for(device),
              make_args(str(device), n, local), cycles, out)
        with open(out) as f:
            return json.load(f)


def collective_bytes(n: int = 4) -> list:
    """Bytes that a rank gives the collectives, per update (and the
    store's per cycle), for each of :data:`BYTE_ROWS` on ``n`` ranks."""
    rows = []
    for name, kw, label in BYTE_ROWS:
        args = Args(name=name, drop_num=kw["n_droplets"], fov=kw["fov"],
                    width=kw["width"], length=kw["length"], device="cpu")
        args.apply_env_defaults()
        args.load_hparams()
        env = make_env(name, **kw)
        args.update_env_info(env.env_info())
        params = sum(p.numel() for p in build_agent_net(args).parameters())
        ring = replay_lib.init_replay(
            1, args.episode_limit, args.n_agents, args.obs_shape[-1],
            obs_dtype=env.params.obs_dtype)
        episode = sum(v.numel() * v.element_size()
                      for v in ring.data.values())
        grads = params * 4 + 8          # + the squares' and mask's sums
        gather = args.batch_size * episode
        rows.append({
            "config": label,
            "ranks": n,
            "param_bytes": params * 4,
            "grad_all_reduce_bytes": grads,
            "replay_gather_bytes_global": gather,
            "replay_gather_bytes_local": 0,
            "gather_over_grads": gather / grads,
            "store_gather_bytes_global_per_cycle": TOTAL_B * episode,
            "batch_size": args.batch_size,
            "episode_bytes": episode,
        })
    return rows


def main(argv=None, cycles: int = CYCLES) -> list:
    """Run the benchmark; print and return its lines."""
    a = parse(argv)
    device = select_device(a.device)
    have = visible_devices(device)
    lines, t = [], {}

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    for suffix, n, local in VARIANTS:
        if n > have:
            print(f"bench_multiproc: train_cycle_s_{suffix} left out: "
                  f"{n} ranks, {have} devices visible", file=sys.stderr,
                  flush=True)
            continue
        r = run_variant(n, local, device, cycles)
        t[suffix] = r["cycle_s"]
        unit = f"{UNIT}, {r['updates']} updates a cycle"
        if local:
            unit += (", --local_sampling: each rank's ring and minibatch "
                     "its own; vs_baseline: the global ring's time over "
                     "this")
        vs = None          # JAX's: the global ring's, and 1 over 4 ranks
        if local:
            vs = t["2rank"] / r["cycle_s"]
        elif n == 4:
            vs = t["1rank"] / r["cycle_s"]
        emit({"metric": f"train_cycle_s_{suffix}", "value": r["cycle_s"],
              "unit": unit, "vs_baseline": vs})
        if suffix == "2rank":
            emit({"metric": "multiproc_efficiency",
                  "value": t["1rank"] / t["2rank"],
                  "unit": ("1-rank cycle time / 2-rank cycle time (same "
                           "total batch; 1.0 = the second rank costs "
                           "nothing)"),
                  "vs_baseline": None})
    for row in collective_bytes():
        emit({"metric": "collective_bytes_per_update", **row})
    return lines


if __name__ == "__main__":
    main()
