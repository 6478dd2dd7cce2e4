"""The port's reference-style ``Agents`` facade (``agent.py``) on the CPU:
the reference's interactive episode loop through the shim, ``train``'s loss
against the JAX facade's on the same batch from carried-across params
(rtol 1e-6, as ``tests/torch_learn_util.py`` holds the learner), in the
reference's layout and the port's, and a bad ``--alg`` raising."""

import jax
import numpy as np
import pytest
import torch

from marl_dmfb_tpu.agent import Agents as JaxAgents
from marl_dmfb_tpu.config import Args as JaxArgs
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu_torch.agent import Agents
from marl_dmfb_tpu_torch.config import Args
from marl_dmfb_tpu_torch.envs import make_env
from marl_dmfb_tpu_torch.envs.pettingzoo_shim import ParallelEnvShim
from marl_dmfb_tpu_torch.models.convert import from_flax_learner_state
from tests.torch_learn_util import LOSS_RTOL

torch.set_num_threads(1)

SMALL = dict(name="dmfb", drop_num=2, fov=5, width=5, length=5)


def agents_pair(**kw):
    """The JAX facade and the port's, the port's carrying the JAX
    learner state."""
    ja = JaxArgs(**{**SMALL, **kw})
    ja.update_env_info(jmake_env("dmfb", width=5, length=5, n_droplets=2,
                                 fov=5).env_info())
    ta = Args(**{**SMALL, **kw}, device="cpu")
    env = make_env("dmfb", width=5, length=5, n_droplets=2, fov=5)
    ta.update_env_info(env.env_info())
    jag, tag = JaxAgents(ja), Agents(ta)
    tag.learner.load_state(from_flax_learner_state(
        jax.tree.map(np.asarray, jag.learner_state)))
    return jag, tag, env


def reference_episode(agents, env, seed=0):
    """The reference's interactive loop (rollout.py:19-39) through the shim;
    returns the episode batch in the reference's layout."""
    shim = ParallelEnvShim(env, seed=seed, device="cpu")
    obs = shim.reset()
    agents.init_hidden(1)
    last_action = np.zeros((2, 5))
    episode = {"o": [], "u": [], "r": [], "o_next": [], "padded": [],
               "terminated": [], "avail_u": [], "u_onehot": []}
    for _ in range(env.episode_limit):
        actions = []
        for i in range(2):
            a = agents.choose_action(obs[i], last_action[i], i, [1] * 5, 0.3)
            actions.append(a)
            last_action[i] = np.eye(5)[a]
        new_obs, rewards, dones, info = shim.step(actions)
        episode["o"].append(np.stack(obs))
        episode["u"].append(np.array(actions)[:, None])
        episode["r"].append([np.mean(list(rewards.values()))])
        episode["o_next"].append(np.stack(new_obs))
        episode["padded"].append([0.0])
        episode["terminated"].append([float(all(dones.values()))])
        episode["avail_u"].append(np.ones((2, 5)))
        episode["u_onehot"].append(np.eye(5)[actions])
        obs = new_obs
        if all(dones.values()):
            break
    return {k: np.asarray(v)[None] for k, v in episode.items()}


@pytest.mark.parametrize("alg", ["vdn", "qmix"])
def test_reference_loop_trains_as_the_jax_facade(alg):
    """The reference loop runs as written, and ``train`` on its batch gives
    the JAX facade's loss, update after update (the batch in the
    reference's layout, then in the port's)."""
    jag, tag, env = agents_pair(alg=alg)
    batch = reference_episode(tag, env)
    if alg == "qmix":
        batch.pop("avail_u")   # QMIX needs the states: give the port's layout
        T = batch["u"].shape[1]
        batch["s_ext"] = np.zeros((1, T + 1, tag.args.state_shape), np.int8)
    for step in range(3):
        want = jag.train(batch, step)
        got = tag.train(batch, step)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    o_ext = np.concatenate([batch["o"], batch["o_next"][:, -1:]], axis=1)
    port_layout = {k: v for k, v in batch.items() if k not in ("o", "o_next")}
    np.testing.assert_allclose(tag.train({**port_layout, "o_ext": o_ext}, 3),
                               jag.train(batch, 3), rtol=LOSS_RTOL)


def test_choose_action_is_greedy_when_evaluating():
    _, tag, env = agents_pair()
    obs = ParallelEnvShim(env, seed=1, device="cpu").reset()
    x = torch.cat([torch.from_numpy(obs[0]).float(), torch.zeros(5)])
    q, _ = tag.net(x[None], torch.zeros((1, tag.args.rnn_hidden_dim)))
    a = tag.choose_action(obs[0], np.zeros(5), 0, [1] * 5, 1.0,
                          evaluate=True)
    assert a == int(q.argmax())
    tag.init_hidden(1)
    masked = tag.choose_action(obs[0], np.zeros(5), 0, [0, 0, 1, 0, 0], 0.0)
    assert masked == 2


def test_bad_alg_raises():
    args = Args(**SMALL, alg="coma", device="cpu")
    args.update_env_info(make_env("dmfb", width=5, length=5, n_droplets=2,
                                  fov=5).env_info())
    with pytest.raises(Exception, match="No such algorithm"):
        Agents(args)
