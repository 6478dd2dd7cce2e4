"""MEDA training, evaluation and sweeps in the PyTorch port against the JAX
package on the CPU.

* the MEDA train and evaluate CLIs parse to JAX's values, and
  ``MEDA_HPARAMS`` equals ``marl_dmfb_tpu/data/meda/*.yaml``;
* ``--remat`` gives the loss and gradients of the stepwise loop without
  it, and of the default sequence unroll to float32 rounding, and the
  updates match JAX's with it;
* MEDA rollout -> store -> ``learn_many`` against JAX's
  (``tests/torch_learn_util.check_composed``);
* the committed MEDA exports, evaluated greedily on JAX's own tasks and
  draws, give JAX's per-episode steps and success exactly and its rewards
  within ``REWARD_SUM_ATOL``;
* the MEDA degradation sweep gives JAX's health, usage, steps and success
  with JAX's tasks and draws injected;
* the train, evaluate and sweep CLIs run MEDA (VDN and QMIX) on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import eva_degrade as jeva
from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu.models.networks import CRNNAgent as JCRNN
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu_torch import checkpoint as tckpt
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import eva_degrade as teva
from marl_dmfb_tpu_torch import evaluate, train
from marl_dmfb_tpu_torch.algos import qlearn
from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from tests.test_torch_export import restored
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, QMIX, SMALL_MEDA,
                                    batch_for, check_composed, check_updates,
                                    jax_learner, port_learner)
from tests.torch_port_util import WEIGHTS, replay_noise, to_torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_DIR = os.path.join(os.path.dirname(jconfig.__file__), "data", "meda")
VDN_4D = "meda_30x60_4d_fov19_vdn"
QMIX_3D = "meda_30x60_3d_fov19_qmix"
# a sum of T = 90 per-step team rewards, each within 1e-6 of JAX's
REWARD_SUM_ATOL = 1e-5

torch.set_num_threads(1)


@pytest.mark.parametrize("drops", [2, 3, 4, 10])
def test_meda_hparams_equal_yaml(drops):
    with open(os.path.join(YAML_DIR, f"{drops}d.yaml")) as f:
        netdata, traindata = yaml.safe_load_all(f.read())
    assert tconfig.MEDA_HPARAMS[drops] == (netdata, traindata)


def test_every_meda_yaml_is_carried():
    files = {int(n[:-6]) for n in os.listdir(YAML_DIR) if n.endswith("d.yaml")}
    assert files == set(tconfig.MEDA_HPARAMS)


def _same_args(t, j):
    for field in tconfig.Args.__dataclass_fields__:
        if field not in ("device", "profile_dir"):   # the port's own
            assert getattr(t, field) == getattr(j, field), field
    assert (tconfig.make_env_from_args(t).env_info()
            == jconfig.make_env_from_args(j).env_info())


@pytest.mark.parametrize("argv", [
    ["meda"],
    ["meda", "--drop_num=4", "--n_parallel_envs=64", "--lr_decay",
     "--param_ema=0.999"],
    ["meda", "-d", "10", "--remat", "--buffer_size=2000"],
    ["meda", "--drop_num=3", "--alg=qmix", "--version=0.1"],
    ["meda", "--drop_num=2", "-w", "45", "-l", "90", "--version=0"],
], ids=["default", "recipe", "80x80-10d", "qmix-v01", "45x90"])
def test_meda_train_args_match_jax(argv):
    t = tconfig.get_train_args(argv, pri=False)
    _same_args(t, jconfig.get_train_args(argv, pri=False))
    assert t.total_env_steps == jconfig.get_train_args(
        argv, pri=False).total_env_steps


@pytest.mark.parametrize("argv", [
    ["meda"],
    ["meda", "--drop_num=3", "--alg=qmix", "--evaluate_task=7"],
    ["meda", "-d", "10", "--evaluate_epoch=3", "--noise_eps=0.3"],
], ids=["default", "qmix", "80x80-10d"])
def test_meda_evaluate_args_match_jax(argv):
    t = tconfig.get_evaluate_args(argv)
    _same_args(t, jconfig.get_evaluate_args(argv))
    # the 4-droplet MEDA hyperparameters, whatever the droplet count
    assert t.hyper_hidden_dim == 32 and t.batch_size == 64
    assert t.version == "0.2" and t.fov == 19


@pytest.mark.parametrize("items", [SMALL_MEDA, QMIX + SMALL_MEDA],
                         ids=["vdn", "qmix"])
def test_remat_gives_the_same_loss_and_gradients(items, monkeypatch):
    """``--remat`` gives bitwise the loss and gradients of the stepwise loop
    that keeps its activations, and those of the default sequence unroll
    to float32 rounding (loss rtol ``LOSS_RTOL``, gradients ``GRAD_ATOL``
    of their global norm)."""
    J = jax_learner(items)
    plain = port_learner(J.ta, J.init(jax.random.PRNGKey(2)))
    remat = port_learner(dataclasses.replace(J.ta, remat=True),
                         J.init(jax.random.PRNGKey(2)))
    calls = []
    inner = qlearn.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(qlearn, "checkpoint", counting)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for(J.ta, np.random.RandomState(0)).items()}
    l_seq, g_seq = plain.loss_and_grads(batch)
    with monkeypatch.context() as m:   # the stepwise loop, no remat
        m.setattr(qlearn, "runs_as_sequence", lambda net: False)
        l0, g0 = plain.loss_and_grads(batch)
    assert not calls
    l1, g1 = remat.loss_and_grads(batch)
    assert len(calls) == J.ta.episode_limit       # one per BPTT step
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() == g_seq.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    torch.testing.assert_close(l_seq, l1, rtol=LOSS_RTOL, atol=0)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in g1.values())))
    for k in g1:
        torch.testing.assert_close(g_seq[k], g1[k], rtol=0,
                                   atol=GRAD_ATOL * norm)


def test_remat_updates_match_jax():
    check_updates(QMIX + SMALL_MEDA + (("remat", True),), n=2)


def test_meda_rollout_store_learn_many_match_jax():
    jr, tr, port = check_composed(SMALL_MEDA + (("buffer_size", 6),))
    assert tr.data["o_ext"].dtype == torch.int8 and port.train_step == 4


def _deploy(name):
    tree = restored(name)
    return tree["ema"] if "ema" in tree else tree["learner"]["params"]


@pytest.mark.parametrize("name,n,alg", [(VDN_4D, 4, "vdn"),
                                        (QMIX_3D, 3, "qmix")])
def test_export_greedy_matches_jax(name, n, alg):
    """The export's weights, JAX's from its Orbax checkpoint and the port's
    from the committed export, evaluated greedily on 16 shared 30x60 chips
    with JAX's move draws."""
    kw = dict(width=30, length=60, n_droplets=n, fov=19)
    jenv = jmake_env("meda", version="0.2", **kw)
    N, A, T, B = n, 9, jenv.episode_limit, 16
    jnet = JCRNN(n_actions=A, obs_channels=3, fov=19, conv_channels=32)
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(3), B))
    key = jax.random.PRNGKey(12)
    jres = jmake_rollout(jenv, jnet, 128)(
        _deploy(name)["agent"], states, key, jnp.float32(0),
        jnp.float32(0), jnp.float32(0), greedy=True)

    args = tconfig.get_evaluate_args(
        ["meda", f"--drop_num={n}", f"--alg={alg}", "--evaluate_task=2",
         "--device=cpu", f"--data_dir={os.path.join(WEIGHTS, name)}"])
    restore_net_config(args, "final")
    trainer = Trainer(tconfig.make_env_from_args(args), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    reset = jax.jit(jax.vmap(jenv.reset))(states)
    to_port = lambda s: to_torch_state(s, cls=tmeda.MEDAState)
    t_reset = to_port(reset)
    troll = tmake_rollout(trainer.env._replace(reset=lambda s, g: t_reset),
                          trainer.net, 128)
    tres = troll(to_port(states), None, 0.0, 0.0, 0.0, greedy=True,
                 noise=replay_noise(key, reset, T, B, N, A))
    np.testing.assert_array_equal(np.array(jres.steps), tres.steps.numpy())
    np.testing.assert_array_equal(np.array(jres.success),
                                  tres.success.numpy())
    np.testing.assert_allclose(np.array(jres.reward), tres.reward.numpy(),
                               rtol=0, atol=REWARD_SUM_ATOL)
    assert tres.success.sum() >= 12     # trained policies (0.96, 0.98)


def test_meda_sweep_matches_jax(tmp_path, monkeypatch):
    """Two epochs of two tasks on 30x60 with the 4-droplet policy: the
    health and usage snapshots, the steps and the success are JAX's, the
    per-epoch mean rewards within ``REWARD_SUM_ATOL``."""
    epochs, tasks = 2, 2
    argv = ["meda", "--drop_num=4", f"--evaluate_task={tasks}",
            f"--evaluate_epoch={epochs}"]
    jdir = tmp_path / "jax"
    d = jdir / "model" / "vdn" / "fov19"
    d.mkdir(parents=True)
    os.symlink(os.path.join(ROOT, "artifacts", VDN_4D), d / "0_final_state")
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
    jeva.main(argv + [f"--data_dir={jdir}"])
    jpath = jeva.degre_dir(jeva.get_evaluate_args(
        argv + [f"--data_dir={jdir}"]))
    want = {k: np.load(os.path.join(jpath, f"{k}.npy")) for k in
            ("rewards", "steps", "success", "health", "usage")}

    args = tconfig.get_evaluate_args(
        argv + ["--device=cpu", f"--data_dir={os.path.join(WEIGHTS, VDN_4D)}"])
    args.b_degrade, args.per_degrade = True, 1.0
    env = tconfig.make_env_from_args(args)
    jenv = jmake_env("meda", version="0.2", width=30, length=60,
                     n_droplets=4, fov=19, b_degrade=True, per_degrade=1.0)
    resets = [jax.jit(jax.vmap(jenv.reset))(s) for s, _ in calls]
    T, N, A = env.episode_limit, env.n_agents, env.n_actions
    noises = [replay_noise(k, r, T, teva.N_RUNS, N, A)
              for (_, k), r in zip(calls, resets)]
    episode = iter(range(len(calls)))
    to_port = lambda s: to_torch_state(s, cls=tmeda.MEDAState)

    def reset(state, generator):
        """JAX's next tasks on the port's own chips."""
        task = to_port(resets[next(episode)])
        zeros = torch.zeros_like(state.step_count)
        return tmeda.update_health(env.params, state._replace(
            center=task.center, start=task.start, dest=task.dest,
            sq_dist=task.sq_dist, status=torch.zeros_like(state.status),
            step_count=zeros, fails_count=zeros.clone()))

    restore_net_config(args, "final")
    trainer = Trainer(env._replace(reset=reset), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    got = teva.sweep(trainer, to_port(calls[0][0]), epochs, tasks, 0.0, None,
                     noise=lambda e, t: noises[e * tasks + t])
    for k in ("steps", "success", "health", "usage"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0,
                               atol=REWARD_SUM_ATOL)
    assert got["usage"][:, 1].sum() > 0


@pytest.mark.parametrize("argv", [
    ["meda"], ["meda", "--drop_num=3", "--noise_eps=0.3"],
    ["meda", "-d", "10", "--data_dir=out"]])
def test_meda_degre_dir_matches_jax(argv):
    assert teva.degre_dir(tconfig.get_evaluate_args(argv)) == \
        jeva.degre_dir(jeva.get_evaluate_args(argv))


@pytest.mark.parametrize("name,flags", [
    (VDN_4D, ["--drop_num=4"]),
    (QMIX_3D, ["--drop_num=3", "--alg=qmix"]),
], ids=["vdn_4d", "qmix_3d"])
def test_evaluate_and_sweep_clis_run_meda_on_cpu(tmp_path, name, flags):
    data_dir = os.path.join(WEIGHTS, name)
    m = evaluate.main(["meda", "--device", "cpu", f"--data_dir={data_dir}",
                       "--evaluate_task", "5"] + flags)
    assert set(m) == {"reward", "steps", "constraints", "success_rate"}
    assert 0 < m["steps"] <= 90 and m["success_rate"] >= 0.6
    run = tmp_path / "model" / ("qmix" if "--alg=qmix" in flags else "vdn")
    (run / "fov19").mkdir(parents=True)
    path = tckpt.model_state_path(
        tconfig.get_evaluate_args(["meda", f"--data_dir={data_dir}"] + flags),
        "final")
    os.symlink(path, run / "fov19" / "0_final_state.npz")
    out = teva.main(["meda", "--evaluate_task=1", "--evaluate_epoch=2",
                     "--device=cpu", f"--data_dir={tmp_path}"] + flags)
    n = int(flags[0].split("=")[1])
    assert out["path"] == str(tmp_path / "DegreData" / f"30by60-{n}d0b")
    assert out["health"].shape == (5, 2, 30, 60)


@pytest.mark.parametrize("flags", [["--drop_num=4"],
                                   ["--drop_num=3", "--alg=qmix"]],
                         ids=["vdn_4d", "qmix_3d"])
def test_train_cli_runs_meda_on_cpu(tmp_path, flags):
    """The MEDA configurations at full width (32 conv channels, GRU 128,
    the v0.2 observation) for a few hundred steps, with a small replay and
    minibatch so that the CPU is quick; the final checkpoint evaluates
    through the evaluate CLI."""
    common = ["meda", "--device", "cpu", "--evaluate_task=2",
              f"--data_dir={tmp_path}"] + flags
    t = train.main(common + ["--exact_steps=200", "--buffer_size=16",
                             "--batch_size=4", "--n_parallel_envs=4"])
    a = t.args
    assert (a.hyper_hidden_dim, a.rnn_hidden_dim, a.width, a.length,
            a.obs_shape[-1]) == (32, 128, 30, 60, 1085)
    assert t.replay.data["o_ext"].dtype == torch.int8
    assert ("s_ext" in t.replay.data) == ("--alg=qmix" in flags)
    assert t.learner.train_step > 0 and t.n_cycles > 0
    losses = torch.stack(t.losses)
    assert losses.isfinite().all()
    m = evaluate.main(common + ["--load_model"])
    assert 0 <= m["success_rate"] <= 1
