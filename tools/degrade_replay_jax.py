#!/usr/bin/env python3
"""Replay the JAX package's degradation sweep of one DMFB DegreData row
through the port's sweep, with JAX's tasks and draws, and say epoch by
epoch whether the two agree bitwise.

    JAX_PLATFORMS=cpu python3 tools/degrade_replay_jax.py 20by20-10d0b \\
        [--epochs 20] [--work /tmp/replay]

A JAX-side tool, like ``tools/export_flax_npz.py``: it needs the JAX
package and runs on the CPU.  It runs the JAX package's ``eva_degrade.py``
for the row (the row's policy and flags from
``tools/degrade_sweeps_torch.py``'s ``ROWS``, seed 12), recording each
rollout's chips and key, checks that the run reproduces the committed
arrays in ``artifacts/DegreData/<row>/``, then runs the port's
``eva_degrade.sweep`` on the CPU with each episode's tasks taken from
JAX's reset and its draws replayed from JAX's keys (:func:`replay`, which
``tests/test_torch_eva_degrade.py`` runs at small sizes).  Prints, for
``steps``, ``success``, ``health`` and ``usage``, the epochs on which the
port's arrays equal JAX's, and the first place where the port's actions
depart from JAX's, with both packages' Q-values there (float32 sums in
another order can turn a near tie of two actions' Q-values either way).  Torch generators cannot replay JAX keys, so
the port's own sweeps draw other tasks and moves; this separates what the
draws decide from what the dynamics do.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NAMES = ("rewards", "steps", "success", "health", "usage")


def replay(cli, export, epochs, tasks, work) -> tuple:
    """The JAX package's ``eva_degrade.py`` with the flags ``cli`` and the
    Orbax checkpoint ``artifacts/<export>``, ``epochs`` x ``tasks``
    episodes under ``work``, recording each rollout's chips and key; then
    the port's ``eva_degrade.sweep`` on the CPU with the committed export of
    the same checkpoint, each episode's tasks from JAX's reset of the same
    chips (the port's own wear kept) and its draws from JAX's keys.
    Returns the port's arrays and JAX's, by name, and the first departure
    of the port's actions from JAX's (None if none; :func:`departure`)."""
    import jax

    import eva_degrade as jeva
    from marl_dmfb_tpu.envs import make_env as jmake_env
    from marl_dmfb_tpu_torch import config as tconfig
    from marl_dmfb_tpu_torch import eva_degrade as teva
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
    from tests.torch_port_util import WEIGHTS, replay_noise, to_torch_state
    from tools.degrade_sweeps_torch import SEED

    src, = glob.glob(os.path.join(WEIGHTS, export, "model", "*", "fov*",
                                  "0_final_state.npz"))
    model = os.path.join(work, os.path.relpath(os.path.dirname(src),
                                               os.path.join(WEIGHTS, export)))
    os.makedirs(model, exist_ok=True)
    link = os.path.join(model, "0_final_state")
    if not os.path.exists(link):
        os.symlink(os.path.join(ROOT, "artifacts", export), link)

    calls, actions, jax_trainer = [], [], []

    class Recording(jeva.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            jax_trainer.append(self)
            inner = self.rollout

            def rollout(params, states, key, *rest, **kw):
                calls.append((states, key))
                res = inner(params, states, key, *rest, **kw)
                actions.append(np.asarray(res.episodes["u"]))
                return res

            self.rollout = rollout

    argv = list(cli) + [f"--evaluate_task={tasks}",
                        f"--evaluate_epoch={epochs}",
                        "--load_model_name=0_final",
                        f"--seed={SEED}"]
    trainer_cls, jeva.Trainer = jeva.Trainer, Recording
    try:
        jeva.main(argv + [f"--data_dir={work}"])
    finally:
        jeva.Trainer = trainer_cls
    path = jeva.degre_dir(
        jeva.get_evaluate_args(argv + [f"--data_dir={work}"]))
    want = {k: np.load(os.path.join(path, f"{k}.npy")) for k in NAMES}

    args = tconfig.get_evaluate_args(
        argv + ["--device=cpu", f"--data_dir={os.path.join(WEIGHTS, export)}"])
    args.b_degrade, args.per_degrade = True, 1.0
    env = tconfig.make_env_from_args(args)
    jenv = jmake_env("dmfb", width=args.width, length=args.length,
                     n_droplets=args.drop_num, n_blocks=args.block_num,
                     fov=args.fov, b_degrade=True, per_degrade=1.0)
    jreset = jax.jit(jax.vmap(jenv.reset))
    resets = {}
    T, N, A = env.episode_limit, env.n_agents, env.n_actions

    def noise(e, t):
        i = e * tasks + t
        resets[i] = jreset(calls[i][0])
        return replay_noise(calls[i][1], resets[i], T, teva.N_RUNS, N, A)

    episode = iter(range(len(calls)))

    def reset(state, generator):
        """JAX's next tasks on the port's own chips (its wear kept)."""
        task = to_torch_state(resets[next(episode)])
        return tdmfb.update_health(state._replace(
            pos=task.pos, start=task.start, goal=task.goal, dist=task.dist,
            block_mask=task.block_mask, step_count=task.step_count,
            cum_constraints=task.cum_constraints))

    restore_net_config(args, "final")
    trainer = Trainer(env._replace(reset=reset), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    seen = {"episodes": 0, "first": None}
    inner = trainer.rollout

    def rollout(*a, **kw):
        """The port's rollout, keeping the first episode whose actions
        differ from JAX's."""
        res = inner(*a, **kw)
        i = seen["episodes"]
        seen["episodes"] += 1
        u = res.episodes["u"].numpy()
        if seen["first"] is None and not np.array_equal(u, actions[i]):
            seen["first"] = (i, u, res.episodes["o_ext"].numpy())
        return res

    trainer.rollout = rollout
    got = teva.sweep(trainer, to_torch_state(calls[0][0]), epochs, tasks,
                     float(args.noise_eps), None, noise=noise)
    found = seen["first"]
    return got, want, found and departure(
        found, actions[found[0]], tasks, trainer, jax_trainer[0],
        args.last_action)


def departure(found, jax_u, tasks, trainer, jax_trainer, last_action):
    """Where the port's actions first depart from JAX's: the episode, chip,
    step and agent, both actions, and both packages' Q-values there, each
    net run over the episode's observations up to that step (equal in both
    up to it) with the same last actions, at the rollout's batch of rows
    (a GEMM's summing order follows its shape)."""
    import jax
    import jax.numpy as jnp
    import torch

    i, u, o_ext = found
    b, t, n = (int(x) for x in np.argwhere(u != jax_u)[0][:3])
    B, N, A = u.shape[0], u.shape[2], trainer.env.n_actions
    H = trainer.args.rnn_hidden_dim
    theta = jax_trainer.learner_state.params["agent"]
    apply = jax.jit(lambda x, h: jax_trainer.net.apply({"params": theta},
                                                        x, h))
    net = trainer.net.eval()
    h, jh = torch.zeros((B * N, H)), jnp.zeros((B * N, H))
    last = np.zeros((B * N, A), np.float32)
    for s in range(t + 1):
        x = o_ext[:, s].reshape(B * N, -1).astype(np.float32)
        if last_action:
            x = np.concatenate([x, last], axis=-1)
        with torch.no_grad():
            q, h = net(torch.from_numpy(x), h)
        jq, jh = apply(jnp.asarray(x), jh)
        last = np.eye(A, dtype=np.float32)[u[:, s, :, 0].reshape(-1)]
    row = b * N + n
    return {"episode": i, "epoch": i // tasks, "task": i % tasks,
            "chip": b, "step": t, "agent": n,
            "port_action": int(u[b, t, n, 0]),
            "jax_action": int(jax_u[b, t, n, 0]),
            "port_q": q[row].tolist(), "jax_q": np.asarray(jq[row]).tolist()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("row")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--work", default=None)
    a = p.parse_args(argv)

    from tools.degrade_sweeps_torch import ROWS, TASKS

    label, export, cli, epochs = {r[0]: r for r in ROWS}[a.row]
    if cli[0] != "dmfb":
        raise SystemExit(f"{label}: only the DMFB rows are replayed")
    epochs = a.epochs or epochs
    work = a.work or tempfile.mkdtemp(prefix="degrade_replay_")
    got, want, first = replay(cli, export, epochs, TASKS, work)
    committed = np.load(os.path.join(ROOT, "artifacts", "DegreData", label,
                                      "success.npy"))
    print("JAX's run reproduces the committed arrays:",
          bool(np.array_equal(want["success"], committed[:, :epochs])),
          flush=True)
    out = {}
    for k in ("steps", "success", "health", "usage"):
        out[k] = [bool(np.array_equal(got[k][:, e], want[k][:, e]))
                  for e in range(epochs)]
        print(f"{k}: equal on {sum(out[k])} of {epochs} epochs "
              f"{out[k]}", flush=True)
    out["first_departure"] = first
    print("first departure of the port's actions from JAX's:", first,
          flush=True)
    return out


if __name__ == "__main__":
    main()
