"""The seed farm's stacked learner (``algos/qlearn.py:StackedQLearner``)
against ``jax.vmap`` of the JAX package's ``learn`` (the JAX farm's
learner, ``seedfarm.py:farm_cycle``), on the CPU: S learner states of
``PRNGKey(s)`` carried across by ``models/convert.py``, three updates on S
random minibatches, for VDN, QMIX, Adam with ``--lr_decay``, ``--remat``
(the farm's recomputation under ``torch.func``) and ``--fused_streams``
with ``--remat``.

Tolerances: ``tests/torch_learn_util.py``'s, per seed: the loss within
rtol 1e-6; the params and target params within 1e-5, except elements whose
JAX gradient was float noise (within 1e-6 of the gradient's global norm of
zero) at some update, held to ``2 * lr * updates``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch.algos.qlearn import MIXER, StackedQLearner
from marl_dmfb_tpu_torch.models.convert import from_flax_learner_state
from marl_dmfb_tpu_torch.models.networks import build_agent_net, build_mixer
from tests.torch_learn_util import (GRAD_ATOL, LOSS_RTOL, QMIX, agent_np,
                                    assert_params_close, batch_for,
                                    flat_names, global_norm, jax_learner)

S = 2


def _stack(trees: list):
    """Trees of one layout stacked leaf by leaf on a new first axis; the
    0-dim counts, the seeds' shared ones, taken from the first."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees) if first.dim() else first


def _seed(tree, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], tree)


@pytest.mark.parametrize("items", [
    (),
    QMIX,
    (("lr_decay", True), ("n_steps", 60)),
    (("remat", True),),
    (("fused_streams", True), ("remat", True)),
], ids=["vdn", "qmix", "lr_decay", "remat", "fused_remat"])
def test_stacked_learner_matches_vmapped_jax_learn(items):
    J = jax_learner(items)
    ta = J.ta
    jst = jax.vmap(J.init)(jnp.stack([jax.random.PRNGKey(s)
                                      for s in range(S)]))
    state = _stack([from_flax_learner_state(_seed(jst, i)) for i in range(S)])
    params = {k: v.clone() for k, v in flat_names(state["params"]).items()}
    port = StackedQLearner(ta, build_agent_net(ta), build_mixer(ta), params)
    port.load_state(state)
    learn = jax.jit(jax.vmap(J.learn))
    loss_grad = jax.vmap(J.loss_grad)
    rng = np.random.RandomState(7)
    noisy = [None] * S
    for k in range(3):
        seeds = [batch_for(ta, rng) for _ in range(S)]
        np_batch = {n: np.stack([b[n] for b in seeds]) for n in seeds[0]}
        jb = {n: jnp.asarray(v) for n, v in np_batch.items()}
        tb = {n: torch.from_numpy(v) for n, v in np_batch.items()}
        _, jg = loss_grad(jst.params, jst.target_params, jb)
        for i in range(S):
            g = agent_np(_seed(jg, i))
            norm = global_norm(g)
            mark = {n: np.abs(x) <= GRAD_ATOL * norm for n, x in g.items()}
            noisy[i] = mark if noisy[i] is None else {
                n: noisy[i][n] | m for n, m in mark.items()}
        jst, jloss = learn(jst, jb)
        tloss = port.update(tb)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                                   rtol=LOSS_RTOL)
        assert port.train_step == k + 1
        assert all(int(c) == k + 1 for c in np.asarray(jst.train_step))
        for i in range(S):
            where = f"seed {i}, after update {k + 1}: "
            mine = port.seed_state(i)
            assert_params_close(agent_np(_seed(jst.params, i)),
                                flat_names(mine["params"]), noisy[i], ta.lr,
                                k + 1, where)
            assert_params_close(agent_np(_seed(jst.target_params, i)),
                                flat_names(mine["target_params"]), noisy[i],
                                ta.lr, k + 1, where + "target ")
    assert any(k.startswith(MIXER) for k in port.params) == (ta.alg == "qmix")
