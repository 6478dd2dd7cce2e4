"""The port's VDN learner (``marl_dmfb_tpu_torch/algos/qlearn.py``), and
where a case says so its QMIX learner, against the JAX package's
``make_learner`` on the CPU: the loss, the gradients, and
the params and target params after each of several Adam updates (a target
sync every 2 updates), from a fresh state and from a carried mid-training
state, with the last action in the input and without it, and with the
global-norm clip active and inactive.  Tolerances: ``tests/torch_learn_util``
(loss rtol 1e-6, gradients atol 1e-6 of their norm, params atol 1e-5)."""

import jax
import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch.algos.qlearn import QLearner, unroll
from marl_dmfb_tpu_torch.models.networks import build_agent_net
from tests.torch_learn_util import (QMIX, batch_for, both, check_updates,
                                    jax_learner, random_batch)


@pytest.mark.parametrize("items", [
    (),
    (("last_action", False),),
], ids=["last_action", "no_last_action"])
def test_adam_updates_match_jax(items):
    st, port, norms = check_updates(items, n=4)
    assert int(st.train_step) == 4        # two target syncs ran
    assert max(norms) < 9.0               # the default clip stayed inactive


@pytest.mark.parametrize("alg", [(), QMIX], ids=["vdn", "qmix"])
def test_clipped_updates_match_jax(alg):
    """Every gradient norm of these batches is above 1 (checked), so the
    clip rescales every update; under QMIX by one global norm over the
    agent's and the mixer's gradients, as JAX's ``optax.chain`` clips."""
    _, port, norms = check_updates((("grad_norm_clip", 1.0),) + alg, n=3)
    assert min(norms) > 1.0
    assert (port.mixer is not None) == bool(alg)


@pytest.mark.parametrize("items", [
    (), (("lr_decay", True), ("n_steps", 90)),
    QMIX + (("lr_decay", True), ("n_steps", 90))],
    ids=["adam", "adam_lr_decay", "qmix_lr_decay"])
def test_updates_from_a_carried_state_match_jax(items):
    """Three JAX updates, then the state (moments, counts, target) carried
    across by ``from_flax_learner_state``, then three more in both; under
    QMIX the mixer's moments and the schedule's count come across too."""
    J = jax_learner(items)
    st = J.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(9)
    for _ in range(3):
        st, _ = J.learn(st, both(batch_for(J.ta, rng))[0])
    st, port, _ = check_updates(items, n=3, jstate=st, seed=3)
    assert int(st.train_step) == 6
    opt = port.state()["opt_state"]
    assert int(opt["count"]) == 6
    if "schedule_count" in opt:
        assert int(opt["schedule_count"]) == 6
    if port.mixer is not None:
        assert {"mixer"} <= opt["mu"].keys() and {"mixer"} <= opt["nu"].keys()


def test_unroll_feeds_the_hidden_state_forward():
    """The unroll's step t sees the hidden state of step t-1: the Qs of a
    two-step unroll equal two chained calls of the net."""
    ta = jax_learner().ta
    net = build_agent_net(ta)
    x = torch.randn(3, 2, ta.n_agents, 77 + ta.n_actions)
    q = unroll(net, x, ta.rnn_hidden_dim)
    h = torch.zeros(3 * ta.n_agents, ta.rnn_hidden_dim)
    q0, h = net(x[:, 0].reshape(-1, x.shape[-1]), h)
    q1, _ = net(x[:, 1].reshape(-1, x.shape[-1]), h)
    torch.testing.assert_close(q[:, 0].reshape(-1, ta.n_actions), q0,
                               rtol=0, atol=0)
    torch.testing.assert_close(q[:, 1].reshape(-1, ta.n_actions), q1,
                               rtol=0, atol=0)


def test_padded_steps_add_nothing_and_stay_finite():
    """On a padded step the target Qs are the -9999999 sentinel times
    (1 - terminated) = 0: the loss is finite, and it does not change when
    the padded steps' observations change."""
    ta = jax_learner().ta
    learner = QLearner(ta, build_agent_net(ta))
    batch = random_batch(np.random.RandomState(4))
    assert batch["padded"].any()
    base = float(learner.loss(both(batch)[1]).detach())
    pad = batch["padded"][:, :, 0]
    junk = dict(batch)
    o = batch["o_ext"].copy()
    o[:, 1:][pad] = 7          # the observations after the last live step
    junk["o_ext"] = o
    assert np.isfinite(base)
    assert float(learner.loss(both(junk)[1]).detach()) == base
