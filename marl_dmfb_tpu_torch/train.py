"""Train a VDN or QMIX policy on DMFB or MEDA (JAX ``train.py``, without
the device mesh and the seed farm).

Usage::

    python -m marl_dmfb_tpu_torch.train dmfb --drop_num=4 --fov=9 \\
        [--alg=qmix] [--n_parallel_envs=64] [--exact_steps=N] [--device=cpu]
    python -m marl_dmfb_tpu_torch.train meda --drop_num=4 [--alg=qmix] \\
        [--remat] [--device=cpu]

Checkpoints land under ``<data_dir>/model`` and the ``.npy`` curves under
``<data_dir>/TrainResult`` (``data_dir`` defaults to ``data-<env>``).  Runs
on the GPU unless ``--device cpu`` is given, and raises when CUDA is asked
for and absent.  ``--load_model`` resumes from a full-state checkpoint of
the port (``--load_model_name``, default ``final``).
"""

from __future__ import annotations

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.platform import select_device


def main(argv=None) -> Trainer:
    """CLI entry; returns the trainer after its run."""
    args = get_train_args(argv)
    select_device(args.device)
    env = make_env_from_args(args)
    trainer = Trainer(env, args)
    if args.load_model:
        trainer.load_model(load_model_tag(args))
    trainer.run(online_evaluate=args.online_eval)
    return trainer


if __name__ == "__main__":
    main()
