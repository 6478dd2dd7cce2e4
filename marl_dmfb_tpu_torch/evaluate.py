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
raises ``FileNotFoundError``.

``--show`` (a pygame window) and ``--show_save`` (an mp4 under
``<data_dir>/video``, written with OpenCV) render every evaluation episode,
one chip at a time (:func:`evaluate_rendered`); where the package is not
installed they raise ``ImportError`` naming it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import get_evaluate_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from marl_dmfb_tpu_torch.utils.platform import select_device


@torch.no_grad()
def evaluate_rendered(trainer: Trainer, args, save_path=None,
                      episodes=None) -> dict:
    """Greedy episodes of one chip each, every state drawn by the
    ``Renderer`` (JAX ``evaluate.py:21-80``; the reference renders inside
    ``Evaluator.one_step``): in a window with ``args.show``, into the video
    ``save_path``.  ``episodes`` (default ``args.evaluate_task``) tasks
    from the trainer's evaluation generator: each a ``reset`` of the chip,
    then one move-success draw per step, which is what a greedy rollout of
    one chip draws up to the episode's end.  The metrics count as the
    rollout's do (a failed episode counts ``episode_limit`` steps); they
    come with each episode's under ``per_episode``."""
    from marl_dmfb_tpu_torch.render import Renderer

    env, net, g = trainer.env, trainer.net, trainer.generator
    N, A, H = args.n_agents, args.n_actions, args.rnn_hidden_dim
    device = trainer.device
    renderer = Renderer(env, show=args.show, save_path=save_path)
    state = env.init(1, g, device)
    T = env.episode_limit
    rows = []
    for _ in range(int(args.evaluate_task if episodes is None
                       else episodes)):
        state = env.reset(state, g)
        h = torch.zeros((N, H), device=device)
        last = torch.zeros((N, A), device=device)
        renderer.draw(state)
        ep_r, ep_c, ok, t_used = 0.0, 0, 0, T
        for t in range(T):
            x = env.observe(state)[0].float()
            if args.last_action:
                x = torch.cat([x, last], dim=-1)
            q, h = net(x, h)
            a = q.argmax(dim=-1).to(torch.int32)
            last = torch.nn.functional.one_hot(a.long(), A).float()
            state, out = env.step(state, a[None], g)
            renderer.draw(state)
            ep_r += float(out.team_reward[0])
            ep_c += int(out.constraints[0])
            if bool(out.terminated[0]):
                ok = int(out.success[0])
                if ok:
                    t_used = t + 1
                break
        rows.append((ep_r, t_used, ep_c, ok))
    renderer.close()
    if save_path is not None:
        print("video saved to", renderer.video_path)
    r, steps, cons, succ = (np.asarray(c, dtype=np.float64)
                            for c in zip(*rows))
    return {"reward": float(r.mean()), "steps": float(steps.mean()),
            "constraints": float(cons.mean()),
            "success_rate": float(succ.mean()),
            "per_episode": {"reward": r, "steps": steps, "constraints": cons,
                            "success": succ}}


def load_policy(args) -> Trainer:
    """An evaluation Trainer holding the checkpoint ``args`` names (with
    the net hyperparameters it was saved with), or fresh weights without
    ``--load_model``."""
    env = make_env_from_args(args)
    tag = load_model_tag(args) if args.load_model else None
    if tag is not None:
        restore_net_config(args, tag)
    trainer = Trainer(env, args, eval_only=True)
    if tag is not None:
        trainer.load_model(tag, params_only=True)
    return trainer


def evaluate_one(args) -> dict:
    """Evaluate one (board, model) configuration; returns the metric
    dict."""
    trainer = load_policy(args)
    if args.show or args.show_save:
        save_path = None
        if args.show_save:
            save_path = os.path.join(
                args.data_dir, "video",
                f"eval-{args.width}by{args.length}-"
                f"{args.drop_num}d{args.block_num}b.mp4")
        return evaluate_rendered(trainer, args, save_path)
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
