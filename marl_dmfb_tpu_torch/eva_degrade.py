"""Electrode-degradation sweep (JAX ``eva_degrade.py:1-124``, reference
``evaDegre.py``).

    python -m marl_dmfb_tpu_torch.eva_degrade dmfb --drop_num=4 --fov=9 \\
        --chip_size=50 --evaluate_task=20 --load_model_name=0_final \\
        --data_dir=<run dir> [--evaluate_epoch=20] [--noise_eps=0.3] \\
        [--device=cpu]
    python -m marl_dmfb_tpu_torch.eva_degrade meda --drop_num=4 \\
        --data_dir=<run dir> [--alg=qmix] [--device=cpu]

The protocol is the JAX package's: ``N_RUNS`` = 5 fully degradable chips
(``b_degrade`` on, ``per_degrade`` 1.0) run in one lockstep batch, so the
env-step kernel runs at B = 5.  Per epoch the health and usage boards are
snapshotted, then ``--evaluate_task`` episodes run one after another on the
same chips: every reset keeps the wear and applies the health decay, so the
electrodes degrade across episodes and epochs.  A DMFB sweep's env step is
the kernel at B = 5, a MEDA sweep's the MEDA kernel; the output is
labelled ``<W>by<L>-<n>d<b>b`` for both (MEDA has no blocks, ``b`` is 0).  ``--noise_eps`` is a fixed
epsilon (no anneal; greedy only at 0), for the control sweeps with a
weakened policy.  ``rewards``, ``steps`` and ``success`` ``(5, epochs)`` and
``health`` and ``usage`` ``(5, epochs, W, L)`` are saved as ``.npy`` under
:func:`degre_dir`.

Like ``evaluate``, it loads a checkpoint (the port's ``.pt`` or a JAX
export, ``.npz``), runs on the GPU unless ``--device cpu`` is given, and
raises when CUDA is asked for and absent.  Torch generators cannot replay
JAX keys, so its arrays are not the JAX package's committed ones; the CPU
tests hold its accounting to JAX's with JAX's draws injected.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from marl_dmfb_tpu_torch.checkpoint import load_model_tag
from marl_dmfb_tpu_torch.config import get_evaluate_args, make_env_from_args
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from marl_dmfb_tpu_torch.utils.platform import select_device

N_RUNS = 5  # reference evaDegre.py:36


def degre_dir(args) -> str:
    """The sweep's output directory, ``<data_dir>/DegreData/<W>by<L>-
    <n>d<b>b``, with ``-eps<noise>`` for a control sweep (JAX
    ``eva_degrade.py:35-44``)."""
    label = f"{args.width}by{args.length}-{args.drop_num}d{args.block_num}b"
    if getattr(args, "noise_eps", 0.0):
        label += f"-eps{args.noise_eps:g}"
    return os.path.join(args.data_dir, "DegreData", label)


def sweep(trainer: Trainer, states, epochs: int, tasks: int,
          noise_eps: float, generator: torch.Generator, noise=None) -> dict:
    """Run ``epochs`` x ``tasks`` episodes of ``trainer``'s policy on the
    chips ``states``, carrying their wear across episodes; returns the
    per-epoch means ``rewards``/``steps``/``success`` ``(B, epochs)`` and
    the snapshots ``health``/``usage`` ``(B, epochs, W, L)`` (float64, as
    the JAX package saves them).  ``noise(epoch, task)`` gives a rollout's
    draws instead of ``generator`` (tests replay the JAX package's)."""
    B, W, L = states.health.shape
    out = {k: np.zeros((B, epochs)) for k in ("rewards", "steps", "success")}
    out.update(health=np.zeros((B, epochs, W, L)),
               usage=np.zeros((B, epochs, W, L)))
    greedy = noise_eps == 0.0
    for epoch in range(epochs):
        out["health"][:, epoch] = states.health.cpu().numpy()
        out["usage"][:, epoch] = states.usage.cpu().numpy()
        ep = {k: np.zeros(B) for k in ("reward", "steps", "success")}
        for task in range(tasks):
            res = trainer.rollout(
                states, generator, noise_eps, 0.0, noise_eps, greedy=greedy,
                noise=None if noise is None else noise(epoch, task))
            states = res.env_states
            for k in ep:
                ep[k] += getattr(res, k).cpu().numpy()
        out["rewards"][:, epoch] = ep["reward"] / tasks
        out["steps"][:, epoch] = ep["steps"] / tasks
        out["success"][:, epoch] = ep["success"] / tasks
        print(f"epoch {epoch}: success "
              f"{out['success'][:, epoch].mean():.3f} steps "
              f"{out['steps'][:, epoch].mean():.1f}", flush=True)
    return out


def main(argv=None) -> dict:
    """CLI entry; returns the arrays it saved and ``path``, their
    directory."""
    args = get_evaluate_args(list(sys.argv[1:] if argv is None else argv))
    device = select_device(args.device)
    args.b_degrade = True
    args.per_degrade = 1.0
    env = make_env_from_args(args)
    tag = load_model_tag(args) if args.load_model else None
    if tag is not None:
        restore_net_config(args, tag)
    trainer = Trainer(env, args, eval_only=True)
    if tag is not None:
        trainer.load_model(tag, params_only=True)

    # the chips and the episodes' draws come from two seeds, as the JAX
    # package's keys do (PRNGKey(seed) and PRNGKey(seed + 1))
    states = env.init(N_RUNS, torch.Generator(device).manual_seed(args.seed),
                      device)
    out = sweep(trainer, states, int(args.evaluate_epoch),
                int(args.evaluate_task), float(args.noise_eps),
                torch.Generator(device).manual_seed(args.seed + 1))
    path = degre_dir(args)
    os.makedirs(path, exist_ok=True)
    for name, arr in out.items():
        np.save(os.path.join(path, f"{name}.npy"), arr)
    print("saved to", path)
    return dict(out, path=path)


if __name__ == "__main__":
    main()
