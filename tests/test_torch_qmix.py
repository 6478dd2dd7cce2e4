"""QMIX in the PyTorch port against the JAX package on the CPU.

* ``QMixer`` with weights carried from a flax ``QMixer``, both variants,
  within ``MIX_TOL`` relative and absolute (float32 sums in another order:
  a few ulp of joint Qs up to about 20);
* the QMIX learner's updates against JAX's ``make_learner`` on DMFB and
  MEDA, with the tolerances of ``tests/torch_learn_util.check_updates``
  (loss rtol 1e-6, gradients 1e-6 of their norm, params 1e-5 outside
  float-noise gradients);
* a rollout with the global states -> ``store`` -> ``learn_many`` against
  JAX's, the states and the rings exactly;
* DMFB's ``global_state`` bitwise, and the ``s_ext`` ring;
* the mixer carried through a full export of a JAX QMIX checkpoint, its
  Adam moments and its EMA included;
* a params-only load across boards, which drops the mixer (its first
  layers are ``state_dim`` wide) and keeps the agent bitwise.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marl_dmfb_tpu.envs.dmfb as jdmfb
from marl_dmfb_tpu import replay as jreplay
from marl_dmfb_tpu.models.networks import QMixer as JQMixer
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import replay as treplay
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.models.convert import (from_flax_learner_state,
                                                from_flax_mixer,
                                                from_flax_params)
from marl_dmfb_tpu_torch.models.networks import QMixer
from marl_dmfb_tpu_torch.trainer import Trainer, restore_net_config
from tests.test_torch_export import _leaves, orbax, restored
from tests.torch_learn_util import (QMIX, SMALL_MEDA, assert_rings_equal,
                                    check_composed, check_updates)
from tests.torch_port_util import (WEIGHTS, jax_states, params_pair,
                                   to_torch_state)
from tools import export_flax_npz

MIX_TOL = 1e-6
QMIX_EXPORT = "dmfb_20x20_4d_fov9_qmix"

torch.set_num_threads(1)


@pytest.mark.parametrize("two_layers", [True, False],
                         ids=["two_hyper_layers", "one_hyper_layer"])
def test_qmixer_matches_flax(two_layers):
    n, S, b, T = 3, 40, 4, 6
    jm = JQMixer(n_agents=n, state_dim=S, qmix_hidden=8, hyper_hidden=5,
                 two_hyper_layers=two_layers)
    rng = np.random.RandomState(int(two_layers))
    qs = rng.randn(b, T, n).astype(np.float32)
    states = rng.randint(0, n + 1, (b, T, S)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), qs, states)["params"]
    want = np.array(jax.jit(jm.apply)({"params": params}, qs, states))
    tm = QMixer(n, S, qmix_hidden=8, hyper_hidden=5,
                two_hyper_layers=two_layers)
    tm.load_state_dict(from_flax_mixer(jax.tree.map(np.asarray, params)))
    got = tm(torch.from_numpy(qs), torch.from_numpy(states))
    assert got.shape == (b, T, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=MIX_TOL,
                               atol=MIX_TOL)
    # monotonic in every agent's Q
    q = torch.from_numpy(qs).requires_grad_()
    (g,) = torch.autograd.grad(tm(q, torch.from_numpy(states)).sum(), q)
    assert (g >= 0).all()


@pytest.mark.parametrize("items", [
    QMIX,
    QMIX + (("two_hyper_layers", False),),
    QMIX + SMALL_MEDA,
], ids=["dmfb", "dmfb_one_hyper_layer", "meda"])
def test_qmix_updates_match_jax(items):
    st, port, norms = check_updates(items, n=3)
    assert int(st.train_step) == 3            # a target sync ran
    assert any(k.startswith("mixer.") for k in port.all_params)
    state = port.state()
    assert set(state["params"]) == set(state["opt_state"]["mu"]) == {
        "agent", "mixer"}


@pytest.mark.parametrize("env_items", [(), SMALL_MEDA], ids=["dmfb", "meda"])
def test_rollout_store_learn_many_match_jax(env_items):
    """Two cycles of rollout (with the global states) -> store ->
    ``learn_many`` (2 updates each, a target sync at the second) on a ring
    of 6 episodes, which the second store wraps
    (``tests/torch_learn_util.check_composed``)."""
    jr, tr, port = check_composed(QMIX + env_items + (("buffer_size", 6),))
    s_ext = tr.data["s_ext"]
    assert s_ext.dtype == torch.int8 and s_ext.shape[1:] == (
        port.args.episode_limit + 1, port.args.state_shape)
    assert s_ext.any() and port.train_step == 4


@pytest.mark.parametrize("blocks", [0, 2])
def test_dmfb_global_state_is_bitwise_jaxs(blocks):
    jp, tp = params_pair(width=10, length=12, n_droplets=4, n_blocks=blocks,
                         fov=9)
    js = jax_states(jp, 6, seed=blocks, at_goal=0)
    want = np.array(jax.jit(jax.vmap(
        functools.partial(jdmfb.global_state, jp)))(js))
    got = tdmfb.global_state(tp, to_torch_state(js))
    assert got.dtype == torch.int8 and got.shape == (6, tp.state_dim)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    assert (want[:, 2 * 120:] > 0).any() == (blocks > 0)


def test_s_ext_ring_matches_jax():
    """Random episodes with global states, stored three times into a ring
    of 5 (the third store wraps), in both packages."""
    T, N, D, S = 4, 2, 3, 7
    jr = jreplay.init_replay(5, T, N, D, 5, state_dim=S)
    tr = treplay.init_replay(5, T, N, D, state_dim=S)
    rng = np.random.RandomState(0)
    for B in (2, 2, 3):
        eps = {"o_ext": rng.randint(-1, 3, (B, T + 1, N, D)).astype(np.int8),
               "u": rng.randint(0, 5, (B, T, N, 1)).astype(np.int32),
               "r": rng.randn(B, T, 1).astype(np.float32),
               "padded": rng.rand(B, T, 1) < 0.3,
               "terminated": rng.rand(B, T, 1) < 0.3,
               "s_ext": rng.randint(0, 4, (B, T + 1, S)).astype(np.int8)}
        jr = jreplay.store(jr, {k: jnp.asarray(v) for k, v in eps.items()})
        tr = treplay.store(tr, {k: torch.from_numpy(v)
                                for k, v in eps.items()})
        assert_rings_equal(jr, tr)
    views = treplay.sample(tr, 4, idx=torch.tensor([4, 0, 0, 2]))
    np.testing.assert_array_equal(views["s_ext"].numpy(),
                                  np.array(jr.data["s_ext"])[[4, 0, 0, 2]])


def test_full_export_carries_the_mixer(tmp_path):
    """A QMIX trainer with the artifact's flags takes the full export of
    the JAX package's 20x20 QMIX checkpoint as its own: the agent's and the
    mixer's params, target params and Adam moments, the EMA of both, and
    epsilon."""
    d = tmp_path / "model" / "qmix" / "fov9"
    d.mkdir(parents=True)
    export_flax_npz.main([orbax(QMIX_EXPORT), str(d / "0_final_state.npz"),
                          "--what", "full"])
    args = tconfig.get_train_args(
        ["dmfb", "--alg=qmix", "--drop_num=4", "--fov=9", "--chip_size=20",
         "--device=cpu", "--lr_decay", "--param_ema=0.999",
         "--evaluate_task=2", "--buffer_size=8", f"--data_dir={tmp_path}"],
        pri=False)
    t = Trainer(tconfig.make_env_from_args(args), args)
    t.load_model("final")
    tree = restored(QMIX_EXPORT)
    want = from_flax_learner_state(tree["learner"])
    got = t.learner.state()
    flat = lambda x: dict(_leaves(jax.tree.map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, x)))
    assert flat(got).keys() == flat(want).keys()
    assert any("/mixer/" in k for k in flat(want) if k.startswith("opt"))
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    ema_mixer = from_flax_mixer(tree["ema"]["mixer"])
    for k, p in t.ema_mixer.named_parameters():
        assert torch.equal(p, ema_mixer[k]), k
    assert float(t.epsilon) == float(tree["epsilon"])


@pytest.mark.parametrize("board", [20, 50])
def test_params_only_load_across_boards(board):
    """The 20x20 QMIX export, evaluated on its board, loads whole; on 50x50
    the mixer's first layers (1200 wide there, 7500 here) do not fit, so
    the mixer is dropped and this board's fresh one kept, and the agent
    loads bitwise (JAX trainer.py:373-390)."""
    data_dir = os.path.join(WEIGHTS, QMIX_EXPORT)
    args = tconfig.get_evaluate_args(
        ["dmfb", "--alg=qmix", "--drop_num=4", "--fov=9",
         f"--chip_size={board}", "--evaluate_task=2", "--device=cpu",
         f"--data_dir={data_dir}"])
    restore_net_config(args, "final")
    t = Trainer(tconfig.make_env_from_args(args), args, eval_only=True)
    fresh = {k: v.detach().clone() for k, v in t.mixer.named_parameters()}
    t.load_model("final", params_only=True)
    ema = restored(QMIX_EXPORT)["ema"]
    agent = from_flax_params(jax.tree.map(np.asarray, ema["agent"]))
    for k, p in t.net.named_parameters():
        assert torch.equal(p.detach(), agent[k]), k
    mixer = from_flax_mixer(jax.tree.map(np.asarray, ema["mixer"]))
    want = mixer if board == 20 else fresh
    for k, p in t.mixer.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
    assert t.mixer.state_dim == 3 * board * board
    m = t.evaluate()
    assert 0.0 <= m["success_rate"] <= 1.0


def test_trainer_builds_qmix_with_the_state():
    """``--alg qmix`` trains with the mixer, the global states in the ring,
    and ``two_hyper_layers`` in the saved net config; VDN has none."""
    for alg in ("vdn", "qmix"):
        args = tconfig.get_train_args(
            ["dmfb", f"--alg={alg}", "--device=cpu", "--buffer_size=4",
             "--evaluate_task=2"], pri=False)
        t = Trainer(tconfig.make_env_from_args(args), args)
        assert ("s_ext" in t.replay.data) == (alg == "qmix")
        assert (t.mixer is not None) == (alg == "qmix")
        assert t._tree()["net_config"]["two_hyper_layers"] is True
    assert t.replay.data["s_ext"].shape == (4, 41, 300)
    assert t.replay.data["s_ext"].dtype == torch.int8
