"""Train a VDN or QMIX policy on DMFB or MEDA (JAX ``train.py``, without
the device mesh).

Usage::

    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        [--alg=qmix] [--n_parallel_envs=64] [--exact_steps=N] [--device=cpu]
    python -m marl_dmfb_tpu_torch.train meda --drop_num=4 [--alg=qmix] \\
        [--remat] [--device=cpu]
    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        --vmap_seeds=4 [--ckpt_replay] [--load_model]

Checkpoints land under ``<data_dir>/model`` and the ``.npy`` curves under
``<data_dir>/TrainResult`` (``data_dir`` defaults to ``data-<env>``).  Runs
on the GPU unless ``--device cpu`` is given, and raises when CUDA is asked
for and absent.  ``--load_model`` resumes from a full-state checkpoint of
the port (``--load_model_name``, default ``final``).

``--vmap_seeds K`` (K > 1) trains seeds ``seed .. seed + K - 1`` in
lockstep as one program (``parallel/seedfarm.py``); its ``--load_model``
resumes from the farm's newest ``farm_<E>_resume.pt``.
"""

from __future__ import annotations

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.parallel.seedfarm import SeedFarm
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.platform import select_device


def main(argv=None):
    """CLI entry; returns the trainer (the farm under ``--vmap_seeds``)
    after its run."""
    args = get_train_args(argv)
    select_device(args.device)
    env = make_env_from_args(args)
    if args.vmap_seeds > 1:
        farm = SeedFarm(env, args, args.vmap_seeds)
        farm.run()
        return farm
    trainer = Trainer(env, args)
    if args.load_model:
        trainer.load_model(load_model_tag(args))
    trainer.run(online_evaluate=args.online_eval)
    return trainer


if __name__ == "__main__":
    main()
