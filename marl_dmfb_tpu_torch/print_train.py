"""Print a run's saved training curves, or evaluate its checkpoints again
with ``--load_model`` (the JAX package's root ``print_train.py``; the
reference's printTrain.py).

Usage::

    python -m marl_dmfb_tpu_torch.print_train dmfb --drop_num=4 --fov=9 \\
        --data_dir=<run dir>                # print the .npy curves
    python -m marl_dmfb_tpu_torch.print_train dmfb --drop_num=4 --fov=9 \\
        --data_dir=<run dir> --load_model   # evaluate every checkpoint

``--ith_run=i`` reads run i's files (seed i of a seed farm).  The
``--load_model`` path runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os

import numpy as np

from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer, curve_dir, curve_prefix
from marl_dmfb_tpu_torch.utils.platform import select_device


def main(argv=None):
    args = get_train_args(argv)
    if args.load_model:
        select_device(args.device)
        trainer = Trainer(make_env_from_args(args), args, eval_only=True)
        trainer.evaluate_total()
        rewards, steps = trainer.episode_rewards, trainer.episode_steps
        constraints = trainer.episode_constraints
        success_rate, runtime = trainer.success_rate, trainer.time_cost
    else:
        base, prefix = curve_dir(args), curve_prefix(args)
        load = lambda name: np.load(
            os.path.join(base, f"{prefix}{name}_{args.ith_run}.npy"))
        rewards, steps = load("Rewards"), load("steps")
        constraints, success_rate = load("constraints"), load("success_rate")
        runtime = load("runtime")
    print("The rewards are:  {}".format(rewards))
    print("The steps is: {}".format(steps))
    print("The successful rate are: {}".format(success_rate))
    print("The runtime are: {}".format(runtime))
    print("The constraints are: {}".format(constraints))


if __name__ == "__main__":
    main()
