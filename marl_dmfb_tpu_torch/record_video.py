"""Record a video of a trained policy routing droplets (the JAX package's
root ``record_video.py``: the reference's ``--show``/``--show_save``
workload, with procedural frames since its sprite images are missing).

Usage::

    python -m marl_dmfb_tpu_torch.record_video dmfb --drop_num=4 --fov=9 \\
        --load_model_name=0_final --evaluate_task=3 --data_dir=<run dir> \\
        [--show] [--device=cpu]

Writes ``<data_dir>/video/<W>by<L>-<N>d<B>b.mp4`` of up to 10 greedy
episodes of the checkpoint (its EMA weights where it has them), with
OpenCV (``cv2``; ``ImportError`` where it is not installed).  Runs on the
GPU unless ``--device cpu`` is given, and raises when CUDA is asked for
and absent.
"""

from __future__ import annotations

import os

from marl_dmfb_tpu_torch.config import get_evaluate_args
from marl_dmfb_tpu_torch.evaluate import evaluate_rendered, load_policy
from marl_dmfb_tpu_torch.utils.platform import select_device


def main(argv=None) -> dict:
    args = get_evaluate_args(argv)
    select_device(args.device)
    trainer = load_policy(args)
    path = os.path.join(
        args.data_dir, "video",
        f"{args.width}by{args.length}-{args.drop_num}d{args.block_num}b.mp4")
    m = evaluate_rendered(trainer, args, path,
                          episodes=max(1, min(int(args.evaluate_task), 10)))
    for i, (steps, ok) in enumerate(zip(m["per_episode"]["steps"],
                                        m["per_episode"]["success"])):
        print(f"episode {i}: steps={int(steps)} success={int(ok)}",
              flush=True)
    return m


if __name__ == "__main__":
    main()
