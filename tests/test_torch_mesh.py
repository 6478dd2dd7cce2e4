"""Data parallelism of the PyTorch port against the JAX package's, on the
CPU: the composed path (rollout -> store -> ``learn_many``, two cycles) on
2 gloo ranks (``tests/torch_mesh_worker.composed``) against JAX's on a
2-device mesh of the 8 virtual CPU devices of ``tests/conftest.py``, for
the global ring and for ``--local_sampling``, VDN and QMIX (whose global
states travel with their episodes), DMFB v0.1 (float observations in a
float ring, gathered as bytes like the int8 ones) and ``--fused_streams``.

JAX's draws are replayed: the rollouts' through ``noise=``, the global
minibatches' indices (``split(key, K)``, ``randint``) through ``idx=``,
and under ``--local_sampling`` each device's, ``randint(fold_in(key, d),
...)`` over its shard's ``clip(size // n, 1, C / n)`` rows, given to rank d.

Tolerances: ``tests/torch_learn_util``'s: each rank's episodes and its rows
of the ring exactly those of JAX's shard; the loss within rtol 1e-6; the
parameters within 1e-5, except elements whose gradient (JAX's, on the
global minibatch) was float noise at some update, held to
``2 * lr * updates``.  The parameters are also bitwise alike on both
ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu import replay as jreplay
from marl_dmfb_tpu.algos.qlearn import make_learner
from marl_dmfb_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
from marl_dmfb_tpu_torch.models.convert import from_flax_learner_state
from marl_dmfb_tpu_torch.parallel.distributed import spawn
from tests import torch_mesh_worker
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, QMIX, agent_np,
                                    arg_pair, assert_params_close,
                                    flat_names, global_norm, jax_learner)
from tests.torch_port_util import replay_noise, to_torch_state

N_RANKS = 2
# 5x5, 2 droplets, fov 5; 8 chips a rollout, rings of 16, minibatches of 8
MESH = (("n_parallel_envs", 8), ("buffer_size", 16), ("batch_size", 8))
K = 2          # updates a cycle
CYCLES = 2


def _run_jax(items, local):
    """Two cycles of JAX's composed path on a 2-device mesh; returns, per
    cycle, the replayed draws and JAX's results."""
    J = jax_learner(items)
    ja, ta, jenv, _ = arg_pair(**dict(items))
    mesh = make_mesh(jax.devices()[:N_RANKS])
    n = N_RANKS
    B, C, b = ja.rollout_batch, ja.buffer_size, ja.batch_size
    cap_l = C // n
    qmix = ja.alg == "qmix"
    *_, learn_many, _ = make_learner(ja, jenv, mesh=mesh)
    jst = replicate(mesh, J.init(jax.random.PRNGKey(5)))
    start = jax.tree.map(np.asarray, jst)
    jroll = jmake_rollout(jenv, J.net, ja.rnn_hidden_dim, with_state=qmix,
                          mesh_sharded=True)
    jr = shard_batch(mesh, jreplay.init_replay(
        C, ja.episode_limit, ja.n_agents, ja.obs_shape[-1], ja.n_actions,
        obs_dtype=jenv.params.obs_dtype,
        state_dim=ja.state_shape if qmix else None))
    store = jreplay.make_local_store(mesh) if local else jreplay.store
    states = shard_batch(mesh, jax.vmap(jenv.init)(
        jax.random.split(jax.random.PRNGKey(6), B)))
    eps, anneal = 0.6, 0.002
    cycles, results = [], []
    st = J.init(jax.random.PRNGKey(5))
    noisy = None
    for cycle in range(CYCLES):
        key = jax.random.PRNGKey(10 + cycle)
        jres = jroll(jst.params["agent"], states, key, jnp.float32(eps),
                     jnp.float32(anneal), jnp.float32(0.05))
        reset = jax.jit(jax.vmap(jenv.reset))(states)
        noise = replay_noise(key, reset, ja.episode_limit, B, ja.n_agents,
                             ja.n_actions)
        jr = store(jr, jres.episodes)
        lkey = jax.random.PRNGKey(20 + cycle)
        keys = jax.random.split(lkey, K)
        size = int(jr.size)
        if local:
            local_size = min(max(size // n, 1), cap_l)
            idx = np.stack([np.stack([np.array(jax.random.randint(
                jax.random.fold_in(keys[k], d), (b // n,), 0, local_size))
                for k in range(K)]) for d in range(n)])   # (n, K, b/n)
            rows = np.concatenate([d * cap_l + idx[d] for d in range(n)],
                                  axis=1)                 # (K, b)
        else:
            idx = np.stack([np.array(jax.random.randint(
                keys[k], (b,), 0, max(size, 1))) for k in range(K)])
            rows = idx
        data = jax.tree.map(np.asarray, jr.data)
        # JAX's gradients of the same updates mark the float-noise ones
        for k in range(K):
            batch = jreplay.logical_views(
                {f: jnp.asarray(v[rows[k]]) for f, v in data.items()})
            _, g = J.loss_grad(st.params, st.target_params, batch)
            g = agent_np(g)
            norm = global_norm(g)
            mark = {f: np.abs(x) <= GRAD_ATOL * norm for f, x in g.items()}
            noisy = mark if noisy is None else {
                f: noisy[f] | m for f, m in mark.items()}
            st, _ = J.learn(st, batch)
        jst, jloss = learn_many(jst, jr.data, jr.size, lkey, K)
        cycles.append(dict(
            reset=to_torch_state(reset), noise=noise, eps=eps,
            anneal=anneal, idx=torch.from_numpy(idx)))
        results.append(dict(
            episodes={k: np.asarray(v) for k, v in jres.episodes.items()},
            epsilon=float(jres.epsilon), ring=data, cursor=int(jr.cursor),
            size=size, loss=float(jloss),
            params=agent_np(jst.params), target=agent_np(jst.target_params),
            noisy=dict(noisy), updates=K * (cycle + 1)))
        states = jres.env_states
    return ta, start, cycles, results


@pytest.mark.parametrize("items,local", [
    (MESH, False), (MESH + (("local_sampling", True),), True),
    (QMIX + MESH, False), (MESH + (("version", "0.1"),), False),
    (MESH + (("fused_streams", True),), False)],
    ids=["global", "local_sampling", "qmix", "v01", "fused_streams"])
def test_two_ranks_match_jax_mesh(items, local, tmp_path):
    ta, start, cycles, want = _run_jax(items, local)
    state = from_flax_learner_state(start)
    spawn(torch_mesh_worker.composed, ["cpu"] * N_RANKS, "gloo", ta, state,
          cycles, local, str(tmp_path))
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(N_RANKS)]
    B, C = ta.rollout_batch, ta.buffer_size
    for c, w in enumerate(want):
        where = f"cycle {c}: "
        for r, rec in enumerate(got):
            g = rec[c]
            rows = slice(r * B // N_RANKS, (r + 1) * B // N_RANKS)
            assert g["episodes"].keys() == w["episodes"].keys()
            for k, v in w["episodes"].items():
                np.testing.assert_array_equal(
                    v[rows].astype(np.float32),
                    g["episodes"][k].numpy().astype(np.float32),
                    err_msg=f"{where}rank {r} episodes {k}")
            assert float(g["epsilon"]) == pytest.approx(w["epsilon"],
                                                        abs=1e-7)
            shard = slice(r * C // N_RANKS, (r + 1) * C // N_RANKS)
            for k, v in w["ring"].items():
                np.testing.assert_array_equal(
                    v[shard], g["ring"][k].numpy(),
                    err_msg=f"{where}rank {r} ring {k}")
            assert (g["cursor"], g["size"]) == (w["cursor"], w["size"])
            np.testing.assert_allclose(float(g["loss"]), w["loss"],
                                       rtol=LOSS_RTOL)
            assert_params_close(w["params"], flat_names(g["state"]["params"]),
                                w["noisy"], ta.lr, w["updates"],
                                f"{where}rank {r} ")
            assert_params_close(w["target"],
                                flat_names(g["state"]["target_params"]),
                                w["noisy"], ta.lr, w["updates"],
                                f"{where}rank {r} target ")
        first, second = (flat_names(rec[c]["state"]["params"])
                         for rec in got)
        for k in first:
            assert torch.equal(first[k], second[k]), f"{where}{k}"
