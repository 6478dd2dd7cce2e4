"""The PyTorch port's degradation sweep (``marl_dmfb_tpu_torch.eva_degrade``)
against the JAX package's ``eva_degrade.py`` on the CPU.

Torch generators cannot replay JAX keys, so the JAX sweep records each
episode's chips and key, and the port replays them: its reset takes the
tasks of JAX's reset of the same chips (its own wear maps stay its own),
and its rollout takes JAX's draws (``replay_noise``).  Two epochs of two
tasks at 10x10 with the ``dmfb_10x10_4d_fov9_vdn`` policy (the JAX
package's Orbax checkpoint there, its committed export here), greedy and
with ``--noise_eps=0.3``: the health and usage snapshots, the steps and the
success are equal, the per-epoch mean rewards within ``REWARD_ATOL``."""

import os

import jax
import numpy as np
import pytest
import torch

import eva_degrade as jeva
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import eva_degrade as teva
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from tests.torch_port_util import (WEIGHTS, committed_export, replay_noise,
                                   to_torch_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "dmfb_10x10_4d_fov9_vdn"
REWARD_ATOL = 1e-5   # means of sums of 40 float32 team rewards

torch.set_num_threads(1)


def _jax_sweep(tmp_path, monkeypatch, argv):
    """Run the JAX package's sweep, recording each rollout's chips and key;
    returns its arrays and the records."""
    d = tmp_path / "model" / "vdn" / "fov9"
    d.mkdir(parents=True)
    os.symlink(os.path.join(ROOT, "artifacts", NAME), d / "0_final_state")
    calls = []

    class Recording(jeva.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.rollout

            def rollout(params, states, key, *rest, **kw):
                calls.append((states, key))
                return inner(params, states, key, *rest, **kw)

            self.rollout = rollout

    monkeypatch.setattr(jeva, "Trainer", Recording)
    jeva.main(argv + [f"--data_dir={tmp_path}"])
    args = jeva.get_evaluate_args(argv + [f"--data_dir={tmp_path}"])
    path = jeva.degre_dir(args)
    return {k: np.load(os.path.join(path, f"{k}.npy")) for k in
            ("rewards", "steps", "success", "health", "usage")}, calls


@pytest.mark.parametrize("noise_eps", [0.0, 0.3])
def test_sweep_matches_jax(tmp_path, monkeypatch, noise_eps):
    epochs, tasks = 2, 2
    argv = ["dmfb", "--drop_num=4", "--fov=9", f"--evaluate_task={tasks}",
            f"--evaluate_epoch={epochs}", f"--noise_eps={noise_eps}"]
    want, calls = _jax_sweep(tmp_path / "jax", monkeypatch, argv)
    assert len(calls) == epochs * tasks

    args = tconfig.get_evaluate_args(
        argv + ["--device=cpu", f"--data_dir={os.path.join(WEIGHTS, NAME)}"])
    args.b_degrade, args.per_degrade = True, 1.0
    env = tconfig.make_env_from_args(args)
    jenv = jmake_env("dmfb", width=10, length=10, n_droplets=4, fov=9,
                     b_degrade=True, per_degrade=1.0)
    resets = [jax.jit(jax.vmap(jenv.reset))(s) for s, _ in calls]
    T, N, A = env.episode_limit, env.n_agents, env.n_actions
    noises = [replay_noise(k, r, T, teva.N_RUNS, N, A)
              for (_, k), r in zip(calls, resets)]
    episode = iter(range(len(calls)))

    def reset(state, generator):
        """JAX's next tasks on the port's own chips."""
        task = to_torch_state(resets[next(episode)])
        zeros = torch.zeros_like(state.step_count)
        return tdmfb.update_health(state._replace(
            pos=task.pos, start=task.start, goal=task.goal, dist=task.dist,
            block_mask=task.block_mask, step_count=zeros,
            cum_constraints=zeros.clone()))

    restore_net_config(args, "final")
    trainer = Trainer(env._replace(reset=reset), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    got = teva.sweep(trainer, to_torch_state(calls[0][0]), epochs, tasks,
                     noise_eps, None,
                     noise=lambda e, t: noises[e * tasks + t])
    for k in ("steps", "success", "health", "usage"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0,
                               atol=REWARD_ATOL)
    # the wear moved: usage grew in the second epoch's snapshot
    assert (got["usage"][:, 1] >= got["usage"][:, 0]).all()
    assert got["usage"][:, 1].sum() > 0


@pytest.mark.parametrize("argv", [
    ["dmfb"],
    ["dmfb", "--chip_size=50", "--drop_num=4", "--noise_eps=0.3"],
    ["dmfb", "-w", "30", "-l", "20", "--block_num=2", "--noise_eps=0.05",
     "--data_dir=out"],
])
def test_degre_dir_matches_jax(argv):
    assert teva.degre_dir(tconfig.get_evaluate_args(argv)) == \
        jeva.degre_dir(jeva.get_evaluate_args(argv))


def test_main_saves_the_sweep_on_cpu(tmp_path):
    """The CLI on the CPU with the committed export: five arrays of the JAX
    package's shapes and dtypes under ``degre_dir``; health never rises and
    usage never falls between the snapshots of a chip."""
    run = tmp_path / "model" / "vdn" / "fov9"
    run.mkdir(parents=True)
    os.symlink(committed_export(NAME), run / "0_final_state.npz")
    out = teva.main(["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20",
                     "--evaluate_task=2", "--evaluate_epoch=3",
                     "--device=cpu", f"--data_dir={tmp_path}"])
    assert out["path"] == str(tmp_path / "DegreData" / "20by20-4d0b")
    for k, shape in (("rewards", (5, 3)), ("steps", (5, 3)),
                     ("success", (5, 3)), ("health", (5, 3, 20, 20)),
                     ("usage", (5, 3, 20, 20))):
        arr = np.load(os.path.join(out["path"], f"{k}.npy"))
        assert arr.shape == shape and arr.dtype == np.float64, k
    h = out["health"]
    assert (np.diff(h, axis=1) <= 0).all() and (h <= 1).all()


def test_eva_degrade_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teva.main(["dmfb", "--evaluate_task=1", "--evaluate_epoch=1"])
