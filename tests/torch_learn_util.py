"""Helpers for the learner tests of the PyTorch port: the same small VDN
configuration in both packages, random episode batches, the JAX learner
state carried across, and the parameter comparison.

Tolerances, for float32 on the CPU in both packages:

* the loss: rtol ``LOSS_RTOL`` = 1e-6 (the two packages sum in another
  order);
* the gradients: atol ``GRAD_ATOL`` = 1e-6 times the gradient's global
  norm;
* the parameters after each update: atol ``PARAM_ATOL`` = 1e-5.  Adam
  divides by ``sqrt(nu) + 1e-8``, so an element whose gradient is float
  noise (within ``GRAD_ATOL`` of zero) moves by up to a learning rate in
  either package, whatever its sign: such an element, and only one whose
  JAX gradient was that small at some update, is held to
  ``2 * lr * updates`` instead.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from marl_dmfb_tpu import config as jconfig
from marl_dmfb_tpu.algos.qlearn import make_learner
from marl_dmfb_tpu.envs import make_env as jmake_env
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.algos.qlearn import VDNLearner
from marl_dmfb_tpu_torch.envs import make_env as tmake_env
from marl_dmfb_tpu_torch.models.convert import (from_flax_learner_state,
                                                from_flax_params)
from marl_dmfb_tpu_torch.models.networks import build_agent_net

LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-6      # times the global norm of the gradient
PARAM_ATOL = 1e-5

# 5x5 board, 2 droplets, fov 5 (T = 20, obs_dim = 77), GRU hidden 16, 8 conv
# channels, minibatches of 4 episodes, a target sync every 2 updates
SMALL = dict(name="dmfb", drop_num=2, fov=5, width=5, length=5,
             batch_size=4, buffer_size=8, n_parallel_envs=4,
             rnn_hidden_dim=16, hyper_hidden_dim=8, target_update_cycle=2)
ENV = dict(width=5, length=5, n_droplets=2, fov=5)

torch.set_num_threads(1)


def arg_pair(**kw):
    """(JAX args, port args, JAX env, port env) of one configuration."""
    ja = jconfig.Args(**{**SMALL, **kw})
    ta = tconfig.Args(**{**SMALL, **kw}, device="cpu")
    je, te = jmake_env("dmfb", **ENV), tmake_env("dmfb", **ENV)
    ja.update_env_info(je.env_info())
    ta.update_env_info(te.env_info())
    return ja, ta, je, te


class JaxLearner(NamedTuple):
    init: object        # key -> LearnerState
    learn: object       # (state, batch) -> (state, loss), jitted
    loss_grad: object   # (params, target_params, batch) -> (loss, grads)
    learn_many: object
    net: object
    ja: object          # the JAX args
    ta: object          # the port's args


@functools.lru_cache(maxsize=None)
def jax_learner(items=()) -> JaxLearner:
    """``make_learner`` of the configuration ``SMALL`` updated by
    ``dict(items)``, cached, so that a test file compiles each
    configuration once."""
    ja, ta, je, te = arg_pair(**dict(items))
    init, learn, net, learn_many, loss_fn = make_learner(ja, je)
    return JaxLearner(init, learn, jax.jit(jax.value_and_grad(loss_fn)),
                      learn_many, net, ja, ta)


def port_learner(ta, jstate) -> VDNLearner:
    """The port's learner, carrying ``jstate`` (a JAX ``LearnerState``)."""
    learner = VDNLearner(ta, build_agent_net(ta))
    learner.load_state(from_flax_learner_state(
        jax.tree.map(np.asarray, jstate)))
    return learner


def random_batch(rng, b=4, T=20, N=2, D=77) -> dict:
    """``b`` episodes in the learner's ``(b, T, N, .)`` layout, of random
    lengths: steps after the last are padded (zero action and reward) and
    terminated, as the rollout stores them."""
    lens = rng.randint(1, T + 1, size=b)
    t = np.arange(T)[None]
    padded = t >= lens[:, None]
    u = rng.randint(0, 5, size=(b, T, N))
    return {
        "o_ext": rng.randint(-1, 3, size=(b, T + 1, N, D)).astype(np.int8),
        "u": np.where(padded[..., None], 0, u).astype(np.int8)[..., None],
        "r": np.where(padded, 0, rng.randn(b, T)).astype(
            np.float32)[..., None],
        "padded": padded[..., None],
        "terminated": (t >= lens[:, None] - 1)[..., None],
    }


def both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def agent_np(tree) -> dict:
    """A flax agent tree (JAX params or grads) in the port's names."""
    return {k: v.numpy() for k, v in from_flax_params(
        jax.tree.map(np.asarray, tree["agent"])).items()}


def global_norm(grads: dict) -> float:
    return float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads.values())))


def assert_params_close(jax_params: dict, port: dict, noisy: dict,
                        lr: float, updates: int, what=""):
    """Parameters within ``PARAM_ATOL``, except elements marked ``noisy``,
    which are held to ``2 * lr * updates``."""
    for k, want in jax_params.items():
        got = port[k].detach().numpy()
        diff = np.abs(got - want)
        wide = diff > PARAM_ATOL
        assert not (wide & ~noisy[k]).any(), (
            f"{what}{k}: {int((wide & ~noisy[k]).sum())} elements differ "
            f"by up to {diff[~noisy[k]].max():.3g} > {PARAM_ATOL}")
        assert diff.max() <= max(PARAM_ATOL, 2 * lr * updates), (
            f"{what}{k}: a noise-gradient element moved {diff.max():.3g}")


def check_updates(items=(), n=3, jstate=None, seed=0):
    """Run ``n`` updates on random minibatches in both packages from the
    same state (JAX's fresh one from ``PRNGKey(0)``, or ``jstate``) and
    hold the loss, the gradients and, after each update, the params, the
    target params and the update count to the tolerances above.  Returns
    the final JAX state, the port's learner and the JAX gradient norms."""
    J = jax_learner(items)
    st = J.init(jax.random.PRNGKey(0)) if jstate is None else jstate
    port = port_learner(J.ta, st)
    rng = np.random.RandomState(seed)
    noisy, norms = None, []
    for k in range(n):
        jb, tb = both(random_batch(rng))
        jl, jg = J.loss_grad(st.params, st.target_params, jb)
        jg = agent_np(jg)
        norm = global_norm(jg)
        norms.append(norm)
        # the elements whose JAX gradient is float noise at some update
        noise = {name: np.abs(g) <= GRAD_ATOL * norm
                 for name, g in jg.items()}
        noisy = noise if noisy is None else {
            name: noisy[name] | m for name, m in noise.items()}
        tl, tg = port.loss_and_grads(tb)
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=LOSS_RTOL)
        for name, g in jg.items():
            np.testing.assert_allclose(tg[name].numpy(), g, rtol=0,
                                       atol=GRAD_ATOL * norm, err_msg=name)
        st, jloss = J.learn(st, jb)
        tloss = port.update(tb)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
        assert port.train_step == int(st.train_step)
        where = f"after update {k + 1}: "
        assert_params_close(agent_np(st.params), port.params, noisy,
                            J.ja.lr, k + 1, where)
        assert_params_close(agent_np(st.target_params),
                            dict(port.target_net.named_parameters()),
                            noisy, J.ja.lr, k + 1, where + "target ")
    return st, port, norms


def assert_rings_equal(jr, tr):
    """A JAX replay ring and the port's hold the same episodes, cursor and
    size, exactly."""
    assert int(jr.cursor) == tr.cursor and int(jr.size) == tr.size
    assert jr.data.keys() == tr.data.keys()
    for k in jr.data:
        assert tr.data[k].dtype == getattr(torch, str(jr.data[k].dtype)), k
        np.testing.assert_array_equal(np.array(jr.data[k]),
                                      tr.data[k].numpy(), err_msg=k)
