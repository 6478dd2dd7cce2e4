"""Helpers for the learner tests of the PyTorch port: the same small VDN or
QMIX configuration in both packages (DMFB, or MEDA with ``SMALL_MEDA``),
random episode batches, the JAX learner state carried across, and the
parameter comparison (the agent's, and a QMIX mixer's).

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
from marl_dmfb_tpu_torch import config as tconfig
from marl_dmfb_tpu_torch.algos.qlearn import QLearner
from marl_dmfb_tpu_torch.models.convert import (from_flax_learner_state,
                                                from_flax_tree)
from marl_dmfb_tpu_torch.models.networks import build_agent_net, build_mixer

LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-6      # times the global norm of the gradient
PARAM_ATOL = 1e-5

# 5x5 board, 2 droplets, fov 5 (T = 20, obs_dim = 77), GRU hidden 16, 8 conv
# channels, minibatches of 4 episodes, a target sync every 2 updates
SMALL = dict(name="dmfb", drop_num=2, fov=5, width=5, length=5,
             batch_size=4, buffer_size=8, n_parallel_envs=4,
             rnn_hidden_dim=16, hyper_hidden_dim=8, target_update_cycle=2)
# MEDA 15x30, 2 droplets, fov 5, the v0.2 observation (T = 45, obs_dim =
# 77, a QMIX state of 900), the same widths
SMALL_MEDA = (("name", "meda"), ("width", 15), ("length", 30),
              ("version", "0.2"))
# QMIX: mixer hidden 8, its hypernets' hidden layer 8 (hyper_hidden_dim)
QMIX = (("alg", "qmix"), ("qmix_hidden_dim", 8))

torch.set_num_threads(1)


def arg_pair(**kw):
    """(JAX args, port args, JAX env, port env) of one configuration."""
    ja = jconfig.Args(**{**SMALL, **kw})
    ta = tconfig.Args(**{**SMALL, **kw}, device="cpu")
    je, te = jconfig.make_env_from_args(ja), tconfig.make_env_from_args(ta)
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


def port_learner(ta, jstate) -> QLearner:
    """The port's learner, carrying ``jstate`` (a JAX ``LearnerState``)."""
    learner = QLearner(ta, build_agent_net(ta), build_mixer(ta))
    learner.load_state(from_flax_learner_state(
        jax.tree.map(np.asarray, jstate)))
    return learner


def random_batch(rng, b=4, T=20, N=2, D=77, A=5, S=None) -> dict:
    """``b`` episodes in the learner's ``(b, T, N, .)`` layout, of random
    lengths: steps after the last are padded (zero action and reward) and
    terminated, as the rollout stores them; with ``S``, global states of
    ids in [0, N] (zero on padded steps)."""
    lens = rng.randint(1, T + 1, size=b)
    t = np.arange(T)[None]
    padded = t >= lens[:, None]
    u = rng.randint(0, A, size=(b, T, N))
    batch = {}
    if S is not None:
        s_ext = rng.randint(0, N + 1, size=(b, T + 1, S))
        live = np.arange(T + 1)[None] <= lens[:, None]
        batch["s_ext"] = np.where(live[..., None], s_ext, 0).astype(np.int8)
    return batch | {
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


def flat_names(tree: dict) -> dict:
    """``{"agent": ..., "mixer": ...}`` of tensors -> the learner's flat
    names (``QLearner.all_params``: the mixer's prefixed ``mixer.``)."""
    return {("mixer." if part == "mixer" else "") + k: v
            for part, d in tree.items() for k, v in d.items()}


def agent_np(tree) -> dict:
    """A flax params tree (JAX params or grads: the agent's, and a QMIX
    mixer's) in the port's flat names."""
    return {k: v.numpy() for k, v in flat_names(from_flax_tree(
        jax.tree.map(np.asarray, dict(tree)))).items()}


def batch_for(ta, rng) -> dict:
    """A random batch of ``ta``'s shapes (a state under QMIX)."""
    return random_batch(rng, T=ta.episode_limit, N=ta.n_agents,
                        D=ta.obs_shape[-1], A=ta.n_actions,
                        S=ta.state_shape if ta.alg == "qmix" else None)


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
        jb, tb = both(batch_for(J.ta, rng))
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
        state = port.state()
        assert_params_close(agent_np(st.params),
                            flat_names(state["params"]), noisy, J.ja.lr,
                            k + 1, where)
        assert_params_close(agent_np(st.target_params),
                            flat_names(state["target_params"]), noisy,
                            J.ja.lr, k + 1, where + "target ")
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


def check_composed(items=(), cycles=2, K=2):
    """:func:`composed` with epsilon 0.6 and an anneal of 0.002 a step,
    anew each cycle; returns the two rings and the port's learner."""
    return composed(items, cycles, K)[:3]


def check_long_horizon(items, cycles, data_dir, K=2):
    """:func:`composed` with the trainers' schedules; returns the two
    rings, the port's learner and the last epsilon."""
    return composed(items, cycles, K, data_dir)


def composed(items=(), cycles=2, K=2, data_dir=None):
    """``cycles`` cycles of rollout (JAX's draws replayed; with the global
    states under QMIX) -> ``store`` -> ``learn_many`` (``K`` updates, with
    JAX's minibatch indices: ``keys = split(key, K)``, ``randint(keys[k],
    (batch,), 0, max(size, 1))``) in both packages, from the same state,
    on a ring of ``buffer_size`` episodes.  The episodes and the rings are
    held equal exactly, the losses and params to the tolerances above.

    With ``data_dir`` (where JAX's ``Trainer`` makes its directories) the
    cycles carry the trainers' schedules: epsilon starts at ``epsilon`` and
    anneals by each package's ``Trainer.anneal_per_step``, carried from
    cycle to cycle (held equal exactly), the port's learner is its
    ``Trainer``'s own, and under ``--param_ema`` each trainer's EMA step
    (JAX's ``Trainer._ema_step``, the port's ``Trainer.ema_step``) follows
    each cycle, the EMA params (the agent's and a QMIX mixer's, the
    trainer's own and its checkpoint's) held as the params are.  Else
    epsilon is 0.6 with an anneal of 0.002 a step, anew each cycle.
    Returns the two rings, the port's learner and the last epsilon."""
    from marl_dmfb_tpu import replay as jreplay
    from marl_dmfb_tpu import trainer as jtrainer
    from marl_dmfb_tpu.rollout import make_rollout as jmake_rollout
    from marl_dmfb_tpu_torch import replay as treplay
    from marl_dmfb_tpu_torch import trainer as ttrainer
    from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
    from marl_dmfb_tpu_torch.envs import meda as tmeda
    from marl_dmfb_tpu_torch.rollout import make_rollout as tmake_rollout
    from tests.torch_port_util import replay_noise, to_torch_state

    J = jax_learner(items)
    ja, ta, jenv, tenv = arg_pair(**dict(items))
    B, A, N, S = ja.rollout_batch, ja.n_actions, ja.n_agents, ja.buffer_size
    qmix = ja.alg == "qmix"
    cls = tmeda.MEDAState if ja.name == "meda" else tdmfb.DMFBState
    to_port = lambda s: to_torch_state(s, cls=cls)
    jst = J.init(jax.random.PRNGKey(5))
    port = port_learner(ta, jst)
    jroll = jmake_rollout(jenv, J.net, ja.rnn_hidden_dim, with_state=qmix)
    state_dim = ja.state_shape if qmix else None
    jr = jreplay.init_replay(S, ja.episode_limit, N, ja.obs_shape[-1], A,
                             obs_dtype=jenv.params.obs_dtype,
                             state_dim=state_dim)
    tr = treplay.init_replay(S, ta.episode_limit, N, ta.obs_shape[-1],
                             obs_dtype=tenv.params.obs_dtype,
                             state_dim=state_dim)
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(6), B))
    eps, anneal, jema = 0.6, 0.002, None
    if data_dir is not None:
        ja.data_dir, ja.evaluate_task = str(data_dir), B
        ta.data_dir, ta.evaluate_task = str(data_dir), B
        jt, tt = jtrainer.Trainer(jenv, ja), ttrainer.Trainer(tenv, ta)
        assert (jt.updates_per_rollout, tt.updates_per_rollout) == (K, K)
        eps, anneal = np.float32(jt.epsilon), jt.anneal_per_step
        assert np.float32(tt.epsilon) == eps
        assert np.float32(tt.anneal_per_step) == anneal
        t_eps, t_anneal = tt.epsilon, tt.anneal_per_step
        # the port's side is the trainer's own learner and EMA, from JAX's
        # state: its EMA starts at the params, as both trainers' do
        port = tt.learner
        port.load_state(from_flax_learner_state(
            jax.tree.map(np.asarray, jst)))
        if ja.param_ema:
            jema = jst.params
            tema = ttrainer._named(tt.ema_net, tt.ema_mixer)
            ttrainer._copy(tema, ttrainer._named(tt.net, tt.mixer))
            assert np.float32(jt._ema_step(1.0, 0.0)) == np.float32(
                tt.cycle_decay)
    noisy = {k: np.zeros(v.shape, bool) for k, v in port.all_params.items()}
    updates = 0
    for cycle in range(cycles):
        key = jax.random.PRNGKey(10 + cycle)
        jres = jroll(jst.params["agent"], states, key, jnp.float32(eps),
                     jnp.float32(anneal), jnp.float32(ja.min_epsilon))
        reset = jax.jit(jax.vmap(jenv.reset))(states)
        noise = replay_noise(key, reset, ja.episode_limit, B, N, A)
        t_reset = to_port(reset)
        troll = tmake_rollout(tenv._replace(reset=lambda s, g: t_reset),
                              port.net, ta.rnn_hidden_dim, with_state=qmix)
        if data_dir is None:
            tres = troll(to_port(states), None, eps, anneal, 0.05,
                         noise=noise)
        else:
            tres = troll(to_port(states), None, t_eps, t_anneal,
                         ta.min_epsilon, noise=noise)
            eps, t_eps = jres.epsilon, tres.epsilon
            assert np.float32(t_eps) == np.float32(eps), cycle
        assert tres.episodes.keys() == jres.episodes.keys()
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
        state = port.state()
        assert_params_close(agent_np(jst.params), flat_names(state["params"]),
                            noisy, ja.lr, updates, f"cycle {cycle}: ")
        assert_params_close(agent_np(jst.target_params),
                            flat_names(state["target_params"]), noisy,
                            ja.lr, updates, f"cycle {cycle}: target ")
        if jema is not None:
            jema = jt._ema_step(jema, jst.params)
            tt.ema_step()
            # every EMA tensor of JAX's (the mixer's under QMIX) is the
            # trainer's, and its checkpoint tree holds them all
            assert agent_np(jema).keys() == flat_names(tema).keys()
            assert flat_names(tt._tree()["ema"]).keys() == flat_names(
                tema).keys()
            assert_params_close(agent_np(jema), flat_names(tema), noisy,
                                ja.lr, updates, f"cycle {cycle}: EMA ")
        states = jres.env_states
    return jr, tr, port, float(eps)
