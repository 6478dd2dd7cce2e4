"""A sequential sweep of full trainings (the JAX package's root
``multi_train.py``; the reference's multiTrain.py): fov in {7, 5, 9} x
drop_num in {3, 4} on DMFB, each trained with offline evaluation (train,
then evaluate every saved checkpoint).

Usage::

    python -m marl_dmfb_tpu_torch.multi_train [train flags...]
    python -m marl_dmfb_tpu_torch.multi_train --sweep_fovs=5,9 \\
        --sweep_drops=4 [train flags...]

``--sweep_fovs``/``--sweep_drops`` replace the reference's grid
(multiTrain.py:8-23); every other flag goes to each training, whose swept
fov and drop_num, the reference's ``--n_steps=20`` budget and run id 5
come last and win, as in the reference.  Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import sys

from marl_dmfb_tpu_torch.config import get_train_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer
from marl_dmfb_tpu_torch.utils.platform import select_device


def _pop_sweep_flag(argv, name, default):
    vals, rest = default, []
    for a in argv:
        if a.startswith(f"--{name}="):
            vals = [int(v) for v in a.split("=", 1)[1].split(",") if v]
        else:
            rest.append(a)
    return vals, rest


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    fovs, argv = _pop_sweep_flag(argv, "sweep_fovs", [7, 5, 9])
    drops, argv = _pop_sweep_flag(argv, "sweep_drops", [3, 4])
    for fov in fovs:
        for d in drops:
            args = get_train_args(
                argv + ["dmfb", "--n_steps=20", f"--fov={fov}",
                        f"--drop_num={d}", "--ith_run=5"], pri=False)
            args.load_model = False
            select_device(args.device)
            print("drop number:", args.drop_num)
            print("chip size:", args.width, "*", args.length)
            print("FOV size:", args.fov)
            trainer = Trainer(make_env_from_args(args), args)
            trainer.run(online_evaluate=False)   # -> evaluate_total


if __name__ == "__main__":
    main()
