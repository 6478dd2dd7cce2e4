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
from marl_dmfb_tpu_torch.models.networks import (CRNNAgent, RNNAgent,
                                                 build_agent_net)
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


def _chained(net, x, rnn_hidden):
    """Two chained calls of the net on steps 0 and 1 of ``x``."""
    h = torch.zeros(x.shape[0] * x.shape[2], rnn_hidden)
    q0, h = net(x[:, 0].reshape(-1, x.shape[-1]), h)
    q1, _ = net(x[:, 1].reshape(-1, x.shape[-1]), h)
    return q0, q1


def test_unroll_feeds_the_hidden_state_forward():
    """The unroll's step t sees the hidden state of step t-1: the Qs of a
    two-step unroll of the stepwise branch (``remat``; without gradients
    its loop calls the net itself) equal two chained calls of the net,
    bitwise."""
    ta = jax_learner().ta
    net = build_agent_net(ta)
    x = torch.randn(3, 2, ta.n_agents, 77 + ta.n_actions)
    with torch.no_grad():
        q = unroll(net, x, ta.rnn_hidden_dim, remat=True)
        q0, q1 = _chained(net, x, ta.rnn_hidden_dim)
    torch.testing.assert_close(q[:, 0].reshape(-1, ta.n_actions), q0,
                               rtol=0, atol=0)
    torch.testing.assert_close(q[:, 1].reshape(-1, ta.n_actions), q1,
                               rtol=0, atol=0)


# the sequence branch against the stepwise one, in float32: the batched
# convolutions and products and the sequence GRU sum in another order
Q_RTOL, Q_ATOL = 1e-5, 1e-6
SEQ_GRAD_ATOL = 1e-6   # times the gradient's global norm


def test_sequence_unroll_feeds_the_hidden_state_forward():
    """The sequence branch (the default for a float32 agent) also feeds
    step t the hidden state of step t-1: its Qs equal two chained calls of
    the net to float32 rounding."""
    ta = jax_learner().ta
    net = build_agent_net(ta)
    x = torch.randn(3, 2, ta.n_agents, 77 + ta.n_actions)
    with torch.no_grad():
        q = unroll(net, x, ta.rnn_hidden_dim)
        q0, q1 = _chained(net, x, ta.rnn_hidden_dim)
    torch.testing.assert_close(q[:, 0].reshape(-1, ta.n_actions), q0,
                               rtol=Q_RTOL, atol=Q_ATOL)
    torch.testing.assert_close(q[:, 1].reshape(-1, ta.n_actions), q1,
                               rtol=Q_RTOL, atol=Q_ATOL)


def _agent(kind: str):
    """(net, input width) of each case, weights from a fixed seed."""
    torch.manual_seed(5)
    A = 7
    if kind == "rnn":
        return RNNAgent(40 + A, A, rnn_hidden=32), 40 + A
    fov, ch = {"crnn_fov9": (9, 24), "crnn_fov19": (19, 32)}[kind]
    net = CRNNAgent(A, obs_channels=3, fov=fov, conv_channels=ch,
                    rnn_hidden=32)
    return net, 3 * fov * fov + 2 + A


@pytest.mark.parametrize("kind", ["crnn_fov9", "crnn_fov19", "rnn"])
def test_sequence_unroll_matches_stepwise(kind):
    """The sequence branch's Qs and the gradients of every parameter leaf
    of a masked loss equal the stepwise branch's (``remat``, bitwise the
    plain loop) on a random batch whose episodes end early: padded steps
    carry zero inputs and no weight in the loss.  Tolerances: Qs rtol
    ``Q_RTOL`` = 1e-5, atol ``Q_ATOL`` = 1e-6; each gradient within
    ``SEQ_GRAD_ATOL`` = 1e-6 of the global gradient norm."""
    net, width = _agent(kind)
    b, T, N = 3, 12, 2
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(b, T, N, width, generator=gen)
    live = torch.arange(T)[None, :] < torch.tensor([[T], [7], [4]])
    x = x * live[:, :, None, None]                  # (b, T) episodes end
    w = torch.randn(b, T, N, 7, generator=gen) * live[:, :, None, None]
    params = list(net.parameters())
    out = {}
    for branch, remat in (("sequence", False), ("stepwise", True)):
        q = unroll(net, x, 32, remat=remat)
        grads = torch.autograd.grad(torch.sum((q * w) ** 2), params)
        out[branch] = q.detach(), grads
    (q_s, g_s), (q_w, g_w) = out["sequence"], out["stepwise"]
    torch.testing.assert_close(q_s, q_w, rtol=Q_RTOL, atol=Q_ATOL)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in g_w)))
    assert norm > 0
    for (name, _), a, e in zip(net.named_parameters(), g_s, g_w):
        torch.testing.assert_close(a, e, rtol=0, atol=SEQ_GRAD_ATOL * norm,
                                   msg=lambda m, name=name: f"{name}: {m}")


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
