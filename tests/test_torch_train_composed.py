"""The composed training path of the PyTorch port against the JAX
package's on the CPU: the same rollout (the JAX draws replayed), ``store``
into the replay ring, and ``learn_many`` with JAX's minibatch indices
(``keys = split(key, K)``, ``randint(keys[k], (batch,), 0, max(size, 1))``),
over two cycles.  Tolerances: ``tests/torch_learn_util`` (loss rtol 1e-6,
params atol 1e-5 outside float-noise gradients); the episodes and the rings
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_dmfb_tpu import replay as jreplay
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu_torch import replay as treplay
from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, agent_np, arg_pair,
                                    assert_params_close, assert_rings_equal,
                                    global_norm, jax_learner, port_learner)
from tests.torch_port_util import replay_noise, to_torch_state

N = 2


def test_rollout_store_learn_many_match_jax():
    """Two cycles of rollout -> store -> ``learn_many`` (2 updates each, a
    target sync at the second) on a ring of 6 episodes, which the second
    store wraps."""
    items = (("buffer_size", 6),)
    J = jax_learner(items)
    ja, ta, jenv, tenv = arg_pair(**dict(items))
    B, K, A = ja.rollout_batch, 2, ja.n_actions
    jst = J.init(jax.random.PRNGKey(5))
    port = port_learner(ta, jst)
    jroll = jmake_rollout(jenv, J.net, ja.rnn_hidden_dim)
    troll_env = tenv
    jr = jreplay.init_replay(6, ja.episode_limit, N, ja.obs_shape[-1], A)
    tr = treplay.init_replay(6, ta.episode_limit, N, ta.obs_shape[-1])
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(6), B))
    eps, anneal = 0.6, 0.002
    noisy = {k: np.zeros(v.shape, bool) for k, v in port.params.items()}
    updates = 0
    for cycle in range(2):
        key = jax.random.PRNGKey(10 + cycle)
        jres = jroll(jst.params["agent"], states, key, jnp.float32(eps),
                     jnp.float32(anneal), jnp.float32(0.05))
        reset = jax.jit(jax.vmap(jenv.reset))(states)
        noise = replay_noise(key, reset, ja.episode_limit, B, N, A)
        t_reset = to_torch_state(reset)
        troll = tmake_rollout(troll_env._replace(reset=lambda s, g: t_reset),
                              port.net, ta.rnn_hidden_dim)
        tres = troll(to_torch_state(states), None, eps, anneal, 0.05,
                     noise=noise)
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
        # the JAX gradients of the same updates, one at a time, mark the
        # elements whose gradient is float noise
        st = jst
        for k in range(K):
            batch = jreplay.logical_views(
                {n: v[idx[k]] for n, v in jr.data.items()})
            _, g = J.loss_grad(st.params, st.target_params, batch)
            g = agent_np(g)
            norm = global_norm(g)
            for n, gn in g.items():
                noisy[n] |= np.abs(gn) <= GRAD_ATOL * norm
            st, _ = J.learn(st, batch)
        jst, jloss = J.learn_many(jst, jr.data, jr.size, lkey, K)
        tloss = port.learn_many(tr, K, idx=torch.from_numpy(idx))
        updates += K
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
        assert port.train_step == int(jst.train_step) == updates
        assert_params_close(agent_np(jst.params), port.params, noisy,
                            ja.lr, updates, f"cycle {cycle}: ")
        assert_params_close(agent_np(jst.target_params),
                            dict(port.target_net.named_parameters()), noisy,
                            ja.lr, updates, f"cycle {cycle}: target ")
        states = jres.env_states
