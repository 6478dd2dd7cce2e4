"""The port's rollout against the JAX package's ``make_rollout``: the same
start chips, weights and random draws give the same episodes and metrics,
greedy and epsilon-greedy; and the committed 10x10-4d policy, carried
across, gives the same per-episode greedy success."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu.models.networks import CRNNAgent as JCRNN
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu.rollout import summarize_eval as jsummarize
from marl_dmfb_tpu_torch.envs import make_env as tmake_env
from marl_dmfb_tpu_torch.models.convert import from_flax_params
from marl_dmfb_tpu_torch.models.networks import CRNNAgent as TCRNN
from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
from marl_dmfb_tpu_torch.rollout import summarize_eval as tsummarize
from tests.torch_port_util import REWARD_ATOL, replay_noise, to_torch_state

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "artifacts", "dmfb_10x10_4d_fov9_vdn")


def _run_both(params_np, jenv, tenv, jnet, tnet, states, key, eps, anneal,
              min_eps, greedy):
    """Run the JAX rollout, then the port's from the same post-reset chips
    (the port's reset is replaced by the JAX reset's result) with the same
    draws."""
    N, A, T = jenv.n_agents, jenv.n_actions, jenv.episode_limit
    jroll = jmake_rollout(jenv, jnet, 128)
    jres = jroll(params_np, states, key, jnp.float32(eps),
                 jnp.float32(anneal), jnp.float32(min_eps), greedy=greedy)
    reset_states = jax.jit(jax.vmap(jenv.reset))(states)
    B = reset_states.pos.shape[0]
    noise = replay_noise(key, reset_states, T, B, N, A)
    t_reset = to_torch_state(reset_states)
    tenv = tenv._replace(reset=lambda s, g: t_reset)
    tnet.load_state_dict(from_flax_params(params_np))
    troll = tmake_rollout(tenv, tnet, 128)
    tres = troll(to_torch_state(states), torch.Generator(), eps, anneal,
                 min_eps, greedy=greedy, noise=noise)
    return jres, tres


def _assert_results_equal(jres, tres):
    for k in ("o_ext", "u", "padded", "terminated"):
        np.testing.assert_array_equal(np.array(jres.episodes[k]),
                                      tres.episodes[k].numpy(), err_msg=k)
    np.testing.assert_allclose(np.array(jres.episodes["r"]),
                               tres.episodes["r"].numpy(), rtol=0,
                               atol=REWARD_ATOL)
    for k in ("steps", "constraints", "success"):
        np.testing.assert_array_equal(np.array(getattr(jres, k)),
                                      getattr(tres, k).numpy(), err_msg=k)
    np.testing.assert_allclose(np.array(jres.reward), tres.reward.numpy(),
                               rtol=0, atol=1e-4)  # a sum of up to T rewards
    np.testing.assert_allclose(float(jres.epsilon), float(tres.epsilon),
                               rtol=0, atol=1e-7)
    for f in ("pos", "dist", "usage", "step_count", "cum_constraints",
              "health"):
        np.testing.assert_array_equal(np.array(getattr(jres.env_states, f)),
                                      getattr(tres.env_states, f).numpy(),
                                      err_msg=f)
    js, ts = jsummarize(jres), tsummarize(tres)
    assert js.keys() == ts.keys()
    for k in js:
        assert js[k] == pytest.approx(ts[k], abs=1e-5), k


@functools.lru_cache(maxsize=None)
def _artifact_run(greedy):
    """JAX and port rollouts of the artifact policy on 16 shared chips;
    epsilon-greedy runs on degraded electrodes so the move draws matter."""
    from marl_dmfb_tpu import checkpoint

    tree = checkpoint.restore(ARTIFACT)
    params = tree["learner"]["params"]["agent"]
    ch = int(tree["net_config"]["hyper_hidden_dim"])
    kw = dict(width=10, length=10, n_droplets=4, fov=9)
    jenv, tenv = jmake_env("dmfb", **kw), tmake_env("dmfb", **kw)
    jnet = JCRNN(n_actions=5, obs_channels=3, fov=9, conv_channels=ch)
    tnet = TCRNN(n_actions=5, obs_channels=3, fov=9, conv_channels=ch)
    B = 16
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(11), B))
    eps = (0.0, 0.0, 0.0)
    if not greedy:
        rng = np.random.RandomState(6)
        states = states._replace(health=jnp.asarray(
            rng.rand(B, 10, 10) * 0.4 + 0.6, jnp.float32))
        eps = (0.3, 0.002, 0.05)
    return _run_both(params, jenv, tenv, jnet, tnet, states,
                     jax.random.PRNGKey(12), *eps, greedy)


@pytest.mark.parametrize("greedy", [True, False])
def test_rollout_matches_jax(greedy):
    jres, tres = _artifact_run(greedy)
    _assert_results_equal(jres, tres)
    # episodes ended early, so the padded/terminated masking ran
    assert tres.episodes["padded"].any()


def test_artifact_greedy_success_matches_jax():
    jres, tres = _artifact_run(True)
    np.testing.assert_array_equal(np.array(jres.success),
                                  tres.success.numpy())
    np.testing.assert_array_equal(np.array(jres.steps), tres.steps.numpy())
    # a trained policy: most of the 16 tasks succeed
    assert tres.success.sum() >= 12
