"""The DMFB v0.1 observation (4 float32 layers) in the PyTorch port against
the JAX package's (``envs/dmfb_v01.py``), on the CPU:

* ``observe`` is bitwise equal on many random states and on crowded states
  whose projected goals collide, so that the fallback scatter runs in its
  order of ascending distance;
* a v0.1 step (the transition, then the observation) matches JAX's
  ``step_core``: integer and bool outputs, usage and observations bitwise,
  rewards within ``REWARD_ATOL``;
* rollout -> store -> ``learn_many`` matches JAX with its draws replayed,
  as ``test_torch_train_composed.py`` holds the v0 path (loss rtol 1e-6,
  params 1e-5 outside float-noise gradients, ``tests/torch_learn_util``);
* the CLIs build v0.1 envs, and the trainer's replay ring holds float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marl_dmfb_tpu.envs.dmfb as jdmfb
from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu import replay as jreplay
from marl_dmfb_tpu.algos.qlearn import make_learner
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch import replay as treplay
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.envs import make_env as tmake_env
from marl_dmfb_tpu_torch.ops import dmfb_step
from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
from marl_dmfb_tpu_torch.trainer import Trainer
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, SMALL, agent_np,
                                    assert_params_close, assert_rings_equal,
                                    global_norm, port_learner)
from tests.torch_port_util import (assert_step_equal, jax_states,
                                   params_pair, replay_noise, to_torch_state)

V01 = dict(obs_version="v0.1")


def _jax_observe(jp, states):
    return np.array(jax.jit(jax.vmap(functools.partial(jdmfb.observe, jp)))(
        states))


@pytest.mark.parametrize("width,n,blocks,fov", [
    (10, 2, 0, 9), (10, 4, 2, 9), (20, 3, 0, 9), (12, 5, 1, 5),
    (20, 10, 0, 9), (30, 16, 2, 7)])
def test_observe_matches_jax(width, n, blocks, fov):
    """128 chips from JAX's ``init``, a tenth of the droplets on their goals;
    from 10 droplets on, the agent's own goal is drawn only inside the
    FOV."""
    jp, tp = params_pair(width=width, length=width, n_droplets=n,
                         n_blocks=blocks, fov=fov, **V01)
    js = jax_states(jp, 128, seed=width * n + fov, degrade=False,
                    at_goal=0.1)
    want = _jax_observe(jp, js)
    got = tdmfb.observe(tp, to_torch_state(js))
    assert got.dtype == torch.float32
    assert got.shape == (128, n, tp.obs_dim) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _crowded_states(jp, rng, batch):
    """Chips whose droplets sit in one 5x5 patch and whose goals lie far
    off in a few shared directions: many seen goals project onto the same
    border cells, so the occupancy fallback writes most of them."""
    W, n = jp.width, jp.n_droplets
    states = jax_states(jp, batch, seed=7, degrade=False, at_goal=0)
    pos = np.zeros((batch, n, 2), np.int32)
    goal = np.zeros((batch, n, 2), np.int32)
    for b in range(batch):
        cells = rng.choice(25, n, replace=False)
        corner = rng.randint(0, W - 5, 2)
        pos[b] = corner + np.stack([cells // 5, cells % 5], 1)
        for i in range(n):
            far = rng.choice([0, W - 1], 2)
            goal[b, i] = np.where(rng.rand(2) < 0.3, pos[b, i], far)
    return states._replace(
        pos=jnp.asarray(pos), start=jnp.asarray(pos), goal=jnp.asarray(goal),
        dist=jnp.asarray(np.abs(pos - goal).sum(-1).astype(np.int32)))


def test_fallback_scatter_matches_jax():
    """64 crowded chips, the first one built by hand: agent 0 at (10, 10)
    sees droplet 1 at (11, 10) heading for (29, 10) and droplet 2 at
    (12, 10) heading for (28, 10).  Both goals project to the FOV cell
    (8, 4); droplet 2, nearer its goal, writes there first, and droplet 1
    falls back to (7, 4), the first free cell of the reference's order."""
    jp, tp = params_pair(width=30, length=30, n_droplets=8, fov=9, **V01)
    js = _crowded_states(jp, np.random.RandomState(0), 64)
    pos, goal = np.array(js.pos), np.array(js.goal)
    pos[0] = [(10, 10), (11, 10), (12, 10)] + [(25, 2 + 3 * k)
                                               for k in range(5)]
    goal[0] = [(0, 0), (29, 10), (28, 10)] + [(20, 2 + 3 * k)
                                              for k in range(5)]
    js = js._replace(pos=jnp.asarray(pos), goal=jnp.asarray(goal),
                     dist=jnp.asarray(np.abs(pos - goal).sum(-1)
                                      .astype(np.int32)))
    want = _jax_observe(jp, js)
    got = tdmfb.observe(tp, to_torch_state(js)).numpy()
    np.testing.assert_array_equal(got, want)
    layer2 = got[0, 0, 2 * 81:3 * 81].reshape(9, 9)
    assert layer2[8, 4] == 3 and layer2[7, 4] == 2
    assert (layer2 > 0).sum() == 2


@pytest.mark.parametrize("width,n,blocks", [(10, 2, 0), (10, 4, 2),
                                            (20, 10, 0)])
def test_step_matches_jax(width, n, blocks):
    """Four chained steps of 16 chips on degraded electrodes, through the
    kernel's dispatch (its plain version on the CPU)."""
    jp, tp = params_pair(width=width, length=width, n_droplets=n,
                         n_blocks=blocks, fov=9, **V01)
    rng = np.random.RandomState(width + n)
    js = jax_states(jp, 16, seed=n, rng=rng)
    ts = to_torch_state(js)
    step = jax.jit(jax.vmap(functools.partial(jdmfb.step_core, jp)))
    before = dmfb_step.launches
    for it in range(4):
        acts = rng.randint(0, 5, (16, n)).astype(np.int32)
        unis = rng.rand(16, n).astype(np.float32)
        js, jo = step(js, acts, unis)
        ts, to = dmfb_step.step_batch(tp, ts, torch.from_numpy(acts),
                                      torch.from_numpy(unis))
        assert to.obs.dtype == torch.float32
        assert_step_equal(js, jo, ts, to, where=f"at step {it}")
    assert dmfb_step.launches == before


def test_rollout_store_learn_many_match_jax():
    """Two cycles of rollout -> store -> ``learn_many`` (2 updates each) on
    a 5x5 board with 2 droplets, the v0.1 observation and a float32 ring
    of 6 episodes."""
    env_kw = dict(width=5, length=5, n_droplets=2, fov=5)
    kw = {**SMALL, "version": "0.1", "buffer_size": 6}
    ja = jconfig.Args(**kw)
    ta = tconfig.Args(**kw, device="cpu")
    jenv = jmake_env("dmfb", version="0.1", **env_kw)
    tenv = tmake_env("dmfb", version="0.1", **env_kw)
    ja.update_env_info(jenv.env_info())
    ta.update_env_info(tenv.env_info())
    assert ta.obs_shape == ja.obs_shape == (4, 5, 5, 2, 102)
    init, learn, jnet, learn_many, loss_fn = make_learner(ja, jenv)
    loss_grad = jax.jit(jax.value_and_grad(loss_fn))
    B, K, N, A, T = ja.rollout_batch, 2, 2, ja.n_actions, ja.episode_limit
    jst = init(jax.random.PRNGKey(5))
    port = port_learner(ta, jst)
    jroll = jmake_rollout(jenv, jnet, ja.rnn_hidden_dim)
    jr = jreplay.init_replay(6, T, N, ja.obs_shape[-1], A,
                             obs_dtype=jnp.float32)
    tr = treplay.init_replay(6, T, N, ta.obs_shape[-1],
                             obs_dtype=tenv.params.obs_dtype)
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(6), B))
    noisy = {k: np.zeros(v.shape, bool) for k, v in port.params.items()}
    for cycle in range(2):
        key = jax.random.PRNGKey(10 + cycle)
        jres = jroll(jst.params["agent"], states, key, jnp.float32(0.6),
                     jnp.float32(0.002), jnp.float32(0.05))
        reset = jax.jit(jax.vmap(jenv.reset))(states)
        t_reset = to_torch_state(reset)
        troll = tmake_rollout(tenv._replace(reset=lambda s, g: t_reset),
                              port.net, ta.rnn_hidden_dim)
        tres = troll(to_torch_state(states), None, 0.6, 0.002, 0.05,
                     noise=replay_noise(key, reset, T, B, N, A))
        assert tres.episodes["o_ext"].dtype == torch.float32
        for k in jres.episodes:
            np.testing.assert_array_equal(
                np.array(jres.episodes[k]).astype(np.float32),
                tres.episodes[k].numpy().astype(np.float32), err_msg=k)
        jr = jreplay.store(jr, jres.episodes)
        tr = treplay.store(tr, tres.episodes)
        assert_rings_equal(jr, tr)

        lkey = jax.random.PRNGKey(20 + cycle)
        idx = np.stack([np.array(jax.random.randint(
            k, (ja.batch_size,), 0, jnp.maximum(jr.size, 1)))
            for k in jax.random.split(lkey, K)])
        st = jst
        for k in range(K):
            batch = jreplay.logical_views(
                {name: v[idx[k]] for name, v in jr.data.items()})
            _, g = loss_grad(st.params, st.target_params, batch)
            g = agent_np(g)
            norm = global_norm(g)
            for name, gn in g.items():
                noisy[name] |= np.abs(gn) <= GRAD_ATOL * norm
            st, _ = learn(st, batch)
        jst, jloss = learn_many(jst, jr.data, jr.size, lkey, K)
        tloss = port.learn_many(tr, K, idx=torch.from_numpy(idx))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
        updates = K * (cycle + 1)
        assert port.train_step == int(jst.train_step) == updates
        assert_params_close(agent_np(jst.params), port.params, noisy,
                            ja.lr, updates, f"cycle {cycle}: ")
        states = jres.env_states


@pytest.mark.parametrize("argv", [
    ["dmfb", "--version=0.1", "--drop_num=2"],
    ["dmfb", "-v", "0.1", "--drop_num=3", "--chip_size=20", "--block_num=2"],
])
def test_cli_builds_v01(argv):
    j = jconfig.get_evaluate_args(argv)
    t = tconfig.get_evaluate_args(argv + ["--device=cpu"])
    je, te = jconfig.make_env_from_args(j), tconfig.make_env_from_args(t)
    assert te.params.obs_version == "v0.1"
    assert je.env_info() == te.env_info()
    args = tconfig.get_train_args(argv + ["--device=cpu", "--buffer_size=4",
                                          "--evaluate_task=2"], pri=False)
    trainer = Trainer(tconfig.make_env_from_args(args), args)
    assert trainer.replay.data["o_ext"].dtype == torch.float32
    assert trainer.net.obs_channels == 4
