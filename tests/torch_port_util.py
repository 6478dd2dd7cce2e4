"""Helpers shared by the ``test_torch_*`` files: build batched DMFB states
with the JAX package, carry them to the PyTorch port as numpy arrays, and
compare the two packages' outputs."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import marl_dmfb_tpu.envs.dmfb as jdmfb
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from marl_dmfb_tpu_torch.rollout import RolloutNoise

# integer/bool fields held bitwise equal; float fields within REWARD_ATOL
STATE_EXACT = ("pos", "start", "goal", "dist", "block_mask", "usage",
               "step_count", "cum_constraints")
OUT_EXACT = ("obs", "dones", "terminated", "constraints", "success")
REWARD_ATOL = 1e-5   # float32 sums taken in another order
# the deploy exports of JAX artifacts (tools/export_flax_npz.py), each a run
# directory holding model/<alg>/fov<fov>/0_final_state.npz
WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_weights")


def committed_export(name: str) -> str:
    """The committed deploy export of the artifact ``name`` (its one
    ``model/<alg>/fov<fov>/0_final_state.npz``)."""
    found = glob.glob(os.path.join(WEIGHTS, name, "model", "*", "fov*",
                                   "0_final_state.npz"))
    assert len(found) == 1, (name, found)
    return found[0]

# pytest-xdist runs several workers on the same cores, and torch's intra-op
# pool in each would oversubscribe them: the port's many small CPU ops then
# spend most of their time waiting for threads
torch.set_num_threads(1)


def params_pair(**kw):
    return jdmfb.DMFBParams(**kw), tdmfb.DMFBParams(**kw)


def to_torch_state(jstate, device="cpu", cls=tdmfb.DMFBState):
    """A batched JAX env state as the port's ``cls`` (DMFBState, or
    MEDAState); the PRNG key is dropped."""
    return cls(**{
        f: torch.from_numpy(np.array(getattr(jstate, f))).to(device)
        for f in cls._fields
    })


def jax_states(jparams, batch, seed, rng=None, degrade=True, at_goal=0.25):
    """B JAX states from ``init``, with degraded health in [0.5, 1) and a
    share ``at_goal`` of droplets placed on their goal, so that move failures
    and the stall/done branches run."""
    states = jax.jit(jax.vmap(functools.partial(jdmfb.init, jparams)))(
        jax.random.split(jax.random.PRNGKey(seed), batch))
    rng = np.random.RandomState(seed) if rng is None else rng
    W, L, N = jparams.width, jparams.length, jparams.n_droplets
    if degrade:
        states = states._replace(health=jnp.asarray(
            rng.rand(batch, W, L) * 0.5 + 0.5, jnp.float32))
    if at_goal:
        pos = np.array(states.pos)
        goal = np.array(states.goal)
        sel = rng.rand(batch, N) < at_goal
        goal = np.where(sel[..., None], pos, goal)
        states = states._replace(
            goal=jnp.asarray(goal),
            dist=jnp.asarray(np.abs(pos - goal).sum(-1).astype(np.int32)))
    return states


def jax_step_fn(jparams):
    return jax.jit(jax.vmap(functools.partial(jdmfb.step_core, jparams)))


def assert_step_equal(jstate, jout, tstate, tout, where=""):
    for f in STATE_EXACT:
        np.testing.assert_array_equal(
            np.array(getattr(jstate, f)), getattr(tstate, f).cpu().numpy(),
            err_msg=f"state.{f} {where}")
    for f in OUT_EXACT:
        np.testing.assert_array_equal(
            np.array(getattr(jout, f)), getattr(tout, f).cpu().numpy(),
            err_msg=f"out.{f} {where}")
    for f in ("rewards", "team_reward"):
        np.testing.assert_allclose(
            np.array(getattr(jout, f)), getattr(tout, f).cpu().numpy(),
            rtol=0, atol=REWARD_ATOL, err_msg=f"out.{f} {where}")


def replay_noise(key, reset_states, T, B, N, A):
    """The draws JAX's rollout makes from ``key`` (actions) and from each
    chip's state key (move success, rollout.py:166-175, dmfb.py:606-607),
    as (T, B, N) tensors."""
    rand_a, explore_u, env_u = [], [], []
    k = key
    keys = reset_states.key
    split_env = jax.jit(jax.vmap(jax.random.split))
    draw_env = jax.jit(jax.vmap(lambda s: jax.random.uniform(s, (N,))))
    for _ in range(T):
        k, k_rand, k_expl = jax.random.split(k, 3)
        rand_a.append(np.array(
            jax.random.randint(k_rand, (B, N), 0, A, jnp.int32)))
        explore_u.append(np.array(jax.random.uniform(k_expl, (B, N))))
        pair = split_env(keys)
        keys, subs = pair[:, 0], pair[:, 1]
        env_u.append(np.array(draw_env(subs)))
    t = lambda xs: torch.from_numpy(np.stack(xs))
    return RolloutNoise(t(rand_a), t(explore_u), t(env_u))
