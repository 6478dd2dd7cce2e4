"""JAX checkpoints carried to the PyTorch port: ``tools/export_flax_npz.py``
writes an Orbax checkpoint as a numpy-only ``.npz``, and the port reads it.

* the export round-trips bitwise against ``marl_dmfb_tpu.checkpoint.restore``;
* each export committed under ``tests/fixtures/torch_weights/`` equals a
  fresh export of its artifact;
* a params-only load takes the EMA where there is one, as JAX's
  ``Trainer.load_model`` does, and a full export resumes the learner state;
* the flagship export, the obstacle-blocks and the 10-droplet exports at
  20x20 and the MEDA 80x80-10d export, evaluated greedily on JAX's own
  task states and draws, give JAX's per-episode steps and success exactly
  and its per-episode rewards within ``REWARD_SUM_ATOL``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu import checkpoint as jckpt
from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu.models.networks import CRNNAgent as JCRNN
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu.trainer import Trainer as JTrainer
from marl_dmfb_tpu.trainer import restore_net_config as jrestore_net_config
from marl_dmfb_tpu_torch import checkpoint as tckpt
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.models.convert import (from_flax_learner_state,
                                                from_flax_params)
from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from tests.torch_port_util import (WEIGHTS, committed_export, replay_noise,
                                   to_torch_state)
from tools import export_flax_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# artifact name -> its Orbax directory under artifacts/
EXPORTS = {
    "dmfb_20x20_4d_fov9_vdn_b64": "dmfb_20x20_4d_fov9_vdn_b64",
    "dmfb_20x20_4d_bf16": "dmfb_20x20_4d_bf16/0_final_state",
    "dmfb_10x10_2d_fov9_vdn_v01": "dmfb_10x10_2d_fov9_vdn_v01",
    "dmfb_10x10_4d_fov9_vdn": "dmfb_10x10_4d_fov9_vdn",
    "meda_30x60_4d_fov19_vdn": "meda_30x60_4d_fov19_vdn",
    "meda_30x60_3d_fov19_qmix": "meda_30x60_3d_fov19_qmix",
    "dmfb_20x20_4d_fov9_qmix": "dmfb_20x20_4d_fov9_qmix",
    "dmfb_20x20_10d_fov9_vdn": "dmfb_20x20_10d_fov9_vdn",
    "dmfb_20x20_5d_fov9_vdn": "dmfb_20x20_5d_fov9_vdn",
    "dmfb_20x20_4d2b_8m": "dmfb_20x20_4d2b_8m/0_final_state",
    "dmfb_30x30_4d2b_8m": "dmfb_30x30_4d2b_8m/0_final_state",
    "dmfb_10x10_2d_fov9_vdn": "dmfb_10x10_2d_fov9_vdn",
    "dmfb_10x10_3d_fov9_vdn": "dmfb_10x10_3d_fov9_vdn",
    "dmfb_10x10_3d_fov9_vdn_v01": "dmfb_10x10_3d_fov9_vdn_v01",
    "meda_30x60_2d_fov19_vdn": "meda_30x60_2d_fov19_vdn",
    "meda_30x60_3d_fov19_vdn": "meda_30x60_3d_fov19_vdn",
    "meda_30x60_4d_4m_s12": "meda_30x60_4d_4m_s12/0_final_state",
    "meda_80x80_10d_fov19_vdn": "meda_80x80_10d_fov19_vdn",
}
# a sum of T = 80 per-step team rewards, each within 1e-5 of JAX's
REWARD_SUM_ATOL = 1e-5

torch.set_num_threads(1)


def orbax(name):
    return os.path.join(ROOT, "artifacts", EXPORTS[name])


@functools.lru_cache(maxsize=None)
def restored(name):
    return jckpt.restore(orbax(name))


def _leaves(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    elif tree is not None:
        yield prefix, np.asarray(tree)


def _export(tmp_path, name, what):
    out = str(tmp_path / f"{name}_{what}.npz")
    export_flax_npz.main([orbax(name), out, "--what", what])
    return out


@pytest.mark.parametrize("what", ["deploy", "full"])
def test_export_round_trips_bitwise(tmp_path, what):
    """Every leaf that the export keeps reads back bitwise, with its dtype,
    from the file; the deploy export keeps the learner's params (this
    checkpoint has no EMA), the full one the whole learner state."""
    name = "dmfb_10x10_4d_fov9_vdn"
    tree = restored(name)
    back = tckpt.read_export(_export(tmp_path, name, what))
    want = dict(_leaves({"learner": tree["learner"],
                         "epsilon": tree["epsilon"]}))
    if what == "deploy":
        want = {k: v for k, v in want.items()
                if k.startswith("learner/params/") or "/" not in k
                or k == "learner/train_step"}
    got = dict(_leaves({k: v for k, v in back.items() if k != "net_config"}))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert back["net_config"] == {
        k: (v if isinstance(v, str) else int(v))
        for k, v in tree["net_config"].items()}
    assert "key" not in back


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_committed_export_equals_a_fresh_export(tmp_path, name):
    fresh = np.load(_export(tmp_path, name, "deploy"))
    kept = np.load(committed_export(name))
    assert sorted(fresh.files) == sorted(kept.files)
    for k in fresh.files:
        assert fresh[k].dtype == kept[k].dtype, k
        np.testing.assert_array_equal(fresh[k], kept[k], err_msg=k)
    # the deploy weights are the EMA where the checkpoint has one
    tree = restored(name)
    src = "ema" if "ema" in tree else "learner/params"
    assert all(k.startswith(src + "/") for k in fresh.files
               if k not in ("epsilon", "train_step", "net_config"))


def _link(tmp_path, name):
    """A run directory whose model/vdn/fov9/0_final_state is the artifact
    (for the JAX package) beside its deploy export (for the port)."""
    d = tmp_path / "model" / "vdn" / "fov9"
    d.mkdir(parents=True)
    os.symlink(orbax(name), d / "0_final_state")
    os.symlink(committed_export(name), d / "0_final_state.npz")
    return str(tmp_path)


@pytest.mark.parametrize("name", ["dmfb_20x20_4d_fov9_vdn_b64",
                                  "dmfb_10x10_4d_fov9_vdn"])
def test_params_only_load_takes_what_jax_takes(tmp_path, name):
    """The JAX package's ``load_model(params_only=True)`` and the port's,
    on the same checkpoint: the same weights (the EMA of the flagship, the
    learner's params of the other), the same net config and epsilon."""
    argv = ["dmfb", "--drop_num=4", "--fov=9", "--evaluate_task=2",
            f"--data_dir={_link(tmp_path, name)}"]
    ja = jconfig.get_evaluate_args(argv)
    jrestore_net_config(ja, "final")
    jt = JTrainer(jconfig.make_env_from_args(ja), ja, eval_only=True)
    jt.load_model("final", params_only=True)

    ta = tconfig.get_evaluate_args(argv + ["--device=cpu"])
    restore_net_config(ta, "final")
    tt = Trainer(tconfig.make_env_from_args(ta), ta, eval_only=True)
    tt.load_model("final", params_only=True)
    assert tt.args.hyper_hidden_dim == ja.hyper_hidden_dim == 24
    want = from_flax_params(jax.tree.map(np.asarray,
                                         jt.learner_state.params["agent"]))
    for k, p in tt.net.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    assert float(tt.epsilon) == float(jt.epsilon)


def test_full_export_resumes_the_learner_state(tmp_path):
    """A training Trainer with the flagship's flags takes the full export
    as it would take its own checkpoint: params, target params, Adam's
    moments and count, the schedule count, the EMA and epsilon."""
    name = "dmfb_20x20_4d_fov9_vdn_b64"
    d = tmp_path / "model" / "vdn" / "fov9"
    d.mkdir(parents=True)
    export_flax_npz.main([orbax(name), str(d / "0_final_state.npz"),
                          "--what", "full"])
    args = tconfig.get_train_args(
        ["dmfb", "--drop_num=4", "--fov=9", "--chip_size=20", "--device=cpu",
         "--lr_decay", "--param_ema=0.999", "--evaluate_task=2",
         "--buffer_size=8", f"--data_dir={tmp_path}"], pri=False)
    t = Trainer(tconfig.make_env_from_args(args), args)
    gen = t.generator.get_state()
    t.load_model("final")
    tree = restored(name)
    want = from_flax_learner_state(tree["learner"])
    got = t.learner.state()
    flat = lambda x: dict(_leaves(jax.tree.map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, x)))
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    assert set(t.learner.opt_state) == {"count", "mu", "nu",
                                        "schedule_count"}
    ema = from_flax_params(tree["ema"]["agent"])
    for k, p in t.ema_net.named_parameters():
        assert torch.equal(p, ema[k]), k
    assert float(t.epsilon) == float(tree["epsilon"])
    assert torch.equal(t.generator.get_state(), gen)   # no key to take


def _greedy_matches_jax(name, env, n, argv, B, fov, **kw):
    """The export ``name``'s weights, the JAX package's from its Orbax
    checkpoint and the port's from the committed export, evaluated greedily
    on B shared chips of ``env`` (``kw``: its board) with JAX's move draws:
    the same per-episode steps and success, rewards within
    ``REWARD_SUM_ATOL``.  Returns the port's successes."""
    jenv = jmake_env(env, n_droplets=n, fov=fov, **kw)
    N, T = n, jenv.episode_limit
    tree = restored(name)
    params = (tree["ema"] if "ema" in tree else tree["learner"]["params"])
    jnet = JCRNN(n_actions=jenv.n_actions, obs_channels=3, fov=fov,
                 conv_channels=int(tree["net_config"]["hyper_hidden_dim"]))
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(3), B))
    key = jax.random.PRNGKey(12)
    jres = jmake_rollout(jenv, jnet, 128)(
        params["agent"], states, key, jnp.float32(0), jnp.float32(0),
        jnp.float32(0), greedy=True)

    args = tconfig.get_evaluate_args(
        [env, f"--drop_num={n}", "--evaluate_task=2", "--device=cpu",
         f"--data_dir={os.path.join(WEIGHTS, name)}"] + argv)
    restore_net_config(args, "final")
    trainer = Trainer(tconfig.make_env_from_args(args), args, eval_only=True)
    trainer.load_model("final", params_only=True)
    cls = tmeda.MEDAState if env == "meda" else tdmfb.DMFBState
    reset = jax.jit(jax.vmap(jenv.reset))(states)
    t_reset = to_torch_state(reset, cls=cls)
    troll = tmake_rollout(trainer.env._replace(reset=lambda s, g: t_reset),
                          trainer.net, 128)
    tres = troll(to_torch_state(states, cls=cls), None, 0.0, 0.0, 0.0,
                 greedy=True, noise=replay_noise(key, reset, T, B, N,
                                                 jenv.n_actions))
    np.testing.assert_array_equal(np.array(jres.steps), tres.steps.numpy())
    np.testing.assert_array_equal(np.array(jres.success),
                                  tres.success.numpy())
    np.testing.assert_allclose(np.array(jres.reward), tres.reward.numpy(),
                               rtol=0, atol=REWARD_SUM_ATOL)
    return tres.success


def test_flagship_greedy_matches_jax_at_20x20():
    """The flagship's EMA weights on 16 shared 20x20 chips."""
    success = _greedy_matches_jax("dmfb_20x20_4d_fov9_vdn_b64", "dmfb", 4,
                                  ["--fov=9", "--chip_size=20"], 16, 9,
                                  width=20, length=20)
    assert success.sum() >= 13     # a trained policy (0.96 recorded)


@pytest.mark.parametrize("name,n,blocks,least", [
    # obstacle blocks (0.932 recorded over 500 tasks)
    ("dmfb_20x20_4d2b_8m", 4, 2, 12),
    # 10 droplets, the tile kernel's 16-droplet instantiation (0.73)
    ("dmfb_20x20_10d_fov9_vdn", 10, 0, 8),
], ids=["4d2b", "10d"])
def test_export_greedy_matches_jax_at_20x20(name, n, blocks, least):
    """The blocks policy with 2 blocks and the 10-droplet policy on 16
    shared 20x20 chips (the blocks from JAX's init)."""
    success = _greedy_matches_jax(
        name, "dmfb", n, ["--fov=9", "--chip_size=20",
                          f"--block_num={blocks}"], 16, 9,
        width=20, length=20, n_blocks=blocks)
    assert success.sum() >= least


def test_meda_80x80_10d_greedy_matches_jax():
    """JAX's largest configuration, MEDA 80x80 v0.2 with 10 droplets (T =
    160), on 3 shared chips, JAX's rollout jitted."""
    success = _greedy_matches_jax("meda_80x80_10d_fov19_vdn", "meda", 10,
                                  [], 3, 19, version="0.2", width=80,
                                  length=80)
    assert success.sum() >= 2      # a trained policy (0.94 recorded)


def test_flagship_evaluates_20_droplets_through_the_entry_point():
    """The evaluate entry point at 20 droplets on 20x20 with the flagship
    export (JAX's evaluate takes any droplet count and the 4-droplet net):
    past the tile kernel's 16 droplets, which the card's wide kernel takes,
    the CPU runs the plain step."""
    from marl_dmfb_tpu_torch import evaluate

    name = "dmfb_20x20_4d_fov9_vdn_b64"
    with pytest.warns(UserWarning, match="lattice"):
        m = evaluate.main(["dmfb", "--drop_num=20", "--fov=9",
                           "--chip_size=20", "--evaluate_task=4",
                           "--load_model_name=0_final", "--device=cpu",
                           f"--data_dir={os.path.join(WEIGHTS, name)}"])
    assert all(np.isfinite(v) for v in m.values())
    assert 0 < m["steps"] <= 80 and 0.0 <= m["success_rate"] <= 1.0
