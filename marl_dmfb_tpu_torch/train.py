"""Train a VDN or QMIX policy on DMFB or MEDA (JAX ``train.py``).

Usage::

    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        [--alg=qmix] [--n_parallel_envs=64] [--exact_steps=N] [--device=cpu]
    python -m marl_dmfb_tpu_torch.train meda --drop_num=4 [--alg=qmix] \\
        [--remat] [--device=cpu]
    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        --vmap_seeds=4 [--ckpt_replay] [--load_model]
    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        --n_parallel_envs=64 --mesh=2 [--local_sampling]
    torchrun --nproc_per_node 2 -m marl_dmfb_tpu_torch.train dmfb ...

Checkpoints land under ``<data_dir>/model`` and the ``.npy`` curves under
``<data_dir>/TrainResult`` (``data_dir`` defaults to ``data-<env>``).  Runs
on the GPU unless ``--device cpu`` is given, and raises when CUDA is asked
for and absent.  ``--load_model`` resumes from a full-state checkpoint of
the port (``--load_model_name``, default ``final``).

``--profile_dir DIR`` runs the first cycle after step 0 under
``torch.profiler`` and writes ``DIR/trace.json`` (a Chrome trace, the
port's ``marl.*`` spans beside the kernels) and ``DIR/spans.json`` (the
spans' summary, ``utils/tracing.py``); under a mesh each rank writes
``DIR/rank<r>/``.

``--vmap_seeds K`` (K > 1) trains seeds ``seed .. seed + K - 1`` in
lockstep as one program (``parallel/seedfarm.py``); its ``--load_model``
resumes from the farm's newest ``farm_<E>_resume.pt``.

Data parallelism (``parallel/``): one process per device.  Under a launcher
(``WORLD_SIZE`` above 1, or ``MARL_DMFB_DISTRIBUTED=1``) each process joins
the launcher's group on ``cuda:LOCAL_RANK`` (or the CPU); ``--mesh n`` in a
process started alone starts n ranks itself, rank r on ``cuda:r`` (or the
CPU under ``--device cpu``), NCCL on the card and gloo on the CPU, and
raises when fewer than n devices are visible.  ``--mesh auto``, the
default, is JAX's: in a process started alone on a machine with more than
one visible card it starts one rank a card, as ``--mesh n`` does with n the
count, and ``--vmap_seeds`` exits there; with one card, or on the CPU, it
trains on one device.  Pass ``--mesh=off`` for one device on a machine with
several cards.
"""

from __future__ import annotations

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import Args, get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.parallel.distributed import (backend_for,
                                                      init_distributed,
                                                      launched, rank_devices,
                                                      spawn)
from marl_dmfb_tpu_torch.parallel.mesh import (Mesh, auto_size,
                                               check_visible, mesh_from_flag,
                                               requested_size)
from marl_dmfb_tpu_torch.parallel.seedfarm import SeedFarm
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.platform import select_device


def main(argv=None):
    """CLI entry; returns the trainer (the farm under ``--vmap_seeds``)
    after its run, or None where it started the ranks of ``--mesh``."""
    args = get_train_args(argv)
    if launched():
        args.device = str(init_distributed(select_device(args.device)))
    else:
        n = requested_size(args.mesh)
        if n is None:
            n = auto_size(args.device)
            if n > 1 and args.vmap_seeds > 1:   # JAX train.py:39-44
                raise SystemExit("--vmap_seeds runs on one device; use "
                                 "--mesh=off")
        if n > 1:
            check_visible(n, args.device)
            select_device(args.device)
            spawn(_rank, rank_devices(args.device, n),
                  backend_for(args.device), args)
            return None
    return run(args, mesh_from_flag(args.mesh, args.device))


def _rank(mesh: Mesh, args: Args):
    args.device = str(mesh.device)
    run(args, mesh)


def run(args: Args, mesh=None):
    """Train ``args`` on this process's device, as a rank of ``mesh`` when
    one is given."""
    select_device(args.device)
    if mesh is not None:
        if args.vmap_seeds > 1:   # JAX train.py:39-48
            raise SystemExit("--vmap_seeds runs on one device; use "
                             "--mesh=off")
        if mesh.rank == 0:
            print(f"mesh: {mesh.size} devices, sharding env batch",
                  flush=True)
    env = make_env_from_args(args)
    if args.vmap_seeds > 1:
        farm = SeedFarm(env, args, args.vmap_seeds)
        farm.run(profile_dir=args.profile_dir)
        return farm
    trainer = Trainer(env, args, mesh=mesh)
    if args.load_model:
        trainer.load_model(load_model_tag(args))
    trainer.run(online_evaluate=args.online_eval,
                profile_dir=args.profile_dir)
    return trainer


if __name__ == "__main__":
    main()
