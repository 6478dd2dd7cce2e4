"""Evaluate the agent on fresh random tasks (JAX ``evaluate.py:94-157``).

Usage::

    python -m marl_dmfb_tpu_torch.evaluate dmfb --drop_num=4 --fov=9 \\
        --chip_size=50 --load_model_name=0_final --data_dir=<run dir> \\
        [--evaluate_task=100] [--boards=10,20,50] [--compute_dtype=bf16] \\
        [--version=0.1] [--alg=qmix] [--device=cpu]
    python -m marl_dmfb_tpu_torch.evaluate meda --drop_num=4 \\
        --data_dir=<run dir> [--alg=qmix] [--version=0.1] [--device=cpu]

MEDA defaults to the v0.2 observation, fov 19 and a 30x60 board (80x80 at
10 droplets).  A QMIX checkpoint trained on another board evaluates with
its agent and without its mixer, which greedy evaluation does not call.

Runs on the GPU unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent.  As in the JAX package, evaluation always loads a
checkpoint (``--load_model_name``, default ``final``, under ``--data_dir``)
with the net hyperparameters it was saved with: the port's own ``.pt``, or
a JAX checkpoint exported by ``tools/export_flax_npz.py``.  Without one it
raises ``FileNotFoundError``.  ``--show`` and ``--show_save`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import sys
import time

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import get_evaluate_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from marl_dmfb_tpu_torch.utils.platform import select_device


def evaluate_one(args) -> dict:
    """Evaluate one (board, model) configuration; returns the metric
    dict."""
    if args.show or args.show_save:
        raise NotImplementedError(
            "--show/--show_save: ROADMAP.md Queue 1 item 9 (rendering)")
    env = make_env_from_args(args)
    tag = load_model_tag(args) if args.load_model else None
    if tag is not None:
        restore_net_config(args, tag)
    trainer = Trainer(env, args, eval_only=True)
    if tag is not None:
        trainer.load_model(tag, params_only=True)
    return trainer.evaluate()


def main(argv=None):
    """CLI entry; returns the metric dict (a list of ``(size, metrics)``
    with ``--boards``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # --boards=10,20,50: the zero-shot generalization sweep in one command
    boards = None
    for a in list(argv):
        if a.startswith("--boards"):
            argv.remove(a)
            boards = [int(b) for b in
                      (a.split("=", 1)[1] if "=" in a else "").split(",")
                      if b]
    args = get_evaluate_args(argv)
    select_device(args.device)
    start = time.time()
    if boards:
        rows = []
        for size in boards:
            a = get_evaluate_args(argv)
            a.width = a.length = size
            a.apply_env_defaults()
            m = evaluate_one(a)
            rows.append((size, m))
            print(f"{size}x{size}: success {m['success_rate']:.2f}, "
                  f"steps {m['steps']:.1f}, reward {m['reward']:.2f}",
                  flush=True)
        print("time:", time.time() - start)
        print(f"{'board':>8} {'success':>8} {'steps':>7} {'reward':>8}")
        for size, m in rows:
            print(f"{size:>5}x{size:<3} {m['success_rate']:>8.2f} "
                  f"{m['steps']:>7.1f} {m['reward']:>8.2f}")
        return rows
    m = evaluate_one(args)
    print("time:", time.time() - start)
    print("The average total_rewards of {} is  {}".format(args.alg,
                                                         m["reward"]))
    print("The average total_steps is: {}".format(m["steps"]))
    print("The successful rate is: {}".format(m["success_rate"]))
    return m


if __name__ == "__main__":
    main()
