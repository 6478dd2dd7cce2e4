"""The PyTorch port's DMFB env against the JAX package's: the batched plain
step (``step_core`` + ``observe``) in lockstep over full episodes, the
state helpers, and the invariants of task generation (whose random draws
the two packages cannot share)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marl_dmfb_tpu.envs.dmfb as jdmfb
from marl_dmfb_tpu_torch.envs import dmfb as tdmfb
from tests.torch_port_util import (assert_step_equal, jax_states,
                                   jax_step_fn, params_pair, to_torch_state)

CONFIGS = [
    # (width, n_droplets, n_blocks)
    (10, 2, 0),
    (10, 4, 0),
    (10, 4, 2),
    (20, 4, 2),    # zoom scale 16/6: rounding ties off the 10x10 board
    (20, 10, 0),
    (20, 2, 2),
    (20, 20, 0),   # above the tile kernel's 16 droplets
    (10, 13, 0),   # JAX's cap on 10x10: the lattice fallback
    (200, 4, 0),   # one chip beyond the tile kernel's shared memory
]
# the 200x200 episode is cut to 40 of its 800 lockstep steps, to keep the
# test short: a step's code does not depend on the step count but through
# the limit, which the 10x10 and 20x20 boards reach
STEP_CAP = {200: 40}


def _lattice_warning(width, n):
    """Expect the lattice warning where the board is too crowded for
    random task generation (both packages warn)."""
    if tdmfb._spacing_p_valid(width, width, n) < 1e-6:
        return pytest.warns(UserWarning, match="lattice")
    return _null()


@pytest.mark.parametrize("width,n,blocks", CONFIGS)
def test_lockstep_full_episode(width, n, blocks):
    with _lattice_warning(width, n):
        jp, tp = params_pair(width=width, length=width, n_droplets=n,
                             n_blocks=blocks, fov=9)
    B = 8
    rng = np.random.RandomState(width * 100 + n * 10 + blocks)
    js = jax_states(jp, B, seed=n + blocks, rng=rng)
    ts = to_torch_state(js)
    np.testing.assert_array_equal(
        np.array(jax.vmap(functools.partial(jdmfb.observe, jp))(js)),
        tdmfb.observe(tp, ts).numpy())
    jstep = jax_step_fn(jp)
    for t in range(STEP_CAP.get(width, jp.max_step)):
        acts = rng.randint(0, 5, (B, n)).astype(np.int32)
        unis = rng.rand(B, n).astype(np.float32)
        js, jo = jstep(js, acts, unis)
        ts, to = tdmfb.step_core(tp, ts, torch.from_numpy(acts),
                                 torch.from_numpy(unis))
        assert_step_equal(js, jo, ts, to, where=f"at step {t}")


@pytest.mark.parametrize("n", [120, 130])
def test_observe_matches_jax_above_127_droplets(n):
    """Droplet ids past 127 in the v0 observation: JAX takes the max over
    ids already cast to int8, so id 128 wraps negative and loses to the 0s
    of the droplets elsewhere.  40x40 holds up to 186 droplets; 120 is
    below the wrap, 130 past it.  Only the observation is compared: JAX's
    unrolled step at 130 droplets compiles too slowly for this suite."""
    with _lattice_warning(40, n):
        jp, tp = params_pair(width=40, length=40, n_droplets=n, fov=9)
    js = jax_states(jp, 4, seed=n)
    want = np.array(jax.jit(jax.vmap(functools.partial(jdmfb.observe, jp)))(
        js))
    got = tdmfb.observe(tp, to_torch_state(js)).numpy()
    np.testing.assert_array_equal(want, got)
    # some observer sees a droplet of id 128 or more: the layers then hold
    # a wrapped id or lose it to a 0
    pos = np.array(js.pos)
    near = np.abs(pos[:, :, None] - pos[:, None]).max(-1) <= jp.fov // 2
    assert near[:, :, 127:].any() == (n > 127)


def test_global_state_matches_jax_ring_above_127_droplets():
    """The QMIX state's int8 ids as JAX's ring stores them: JAX builds the
    state in float32 and the ring's ``astype(int8)`` (replay.py:118)
    saturates ids past 127 at 127."""
    with _lattice_warning(40, 130):
        jp, tp = params_pair(width=40, length=40, n_droplets=130, fov=9)
    js = jax_states(jp, 4, seed=5)
    want = np.array(jax.jit(lambda s: jax.vmap(functools.partial(
        jdmfb.global_state, jp))(s).astype(jnp.int8))(js))
    got = tdmfb.global_state(tp, to_torch_state(js))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(want, got.numpy())
    assert (want == 127).sum() > 2 * 4, "ids 127-130 on both id boards"


def test_zoom_matches_jax_on_many_boards():
    """The direction zoom's rounding ties: the port multiplies by the same
    float32 reciprocal that XLA substitutes for the JAX division."""
    for fov in (3, 5, 9, 19):
        for extent in range(max(fov, 5), 90, 9):
            jp, tp = params_pair(width=extent, length=extent, n_droplets=1,
                                 fov=fov)
            d = np.arange(-extent, extent + 1, dtype=np.int32)
            want = np.array(jax.jit(
                lambda x: jdmfb._zoom_dir(jp, x, extent))(d))
            got = tdmfb._zoom_dir(tp, torch.from_numpy(d),
                                  tp.zoom_reciprocals()[0]).numpy()
            np.testing.assert_array_equal(want, got,
                                          err_msg=f"fov {fov} board {extent}")


def test_update_health_restart_match_jax():
    jp, tp = params_pair(width=10, length=10, n_droplets=4, b_degrade=True,
                         per_degrade=0.5)
    js = jax_states(jp, 8, seed=3)
    rng = np.random.RandomState(4)
    js = js._replace(usage=jax.numpy.asarray(
        rng.randint(0, 100, (8, 10, 10)).astype(np.float32)))
    ts = to_torch_state(js)
    jh = jax.vmap(jdmfb.update_health)(js)
    th = tdmfb.update_health(ts)
    for f in ("health", "usage"):
        np.testing.assert_array_equal(np.array(getattr(jh, f)),
                                      getattr(th, f).numpy())
    jr = jax.vmap(functools.partial(jdmfb.restart, jp))(js)
    tr = tdmfb.restart(tp, ts)
    for f in ("pos", "dist", "step_count", "cum_constraints"):
        np.testing.assert_array_equal(np.array(getattr(jr, f)),
                                      getattr(tr, f).numpy())


def _check_tasks(params, state):
    pos, goal = state.pos.numpy(), state.goal.numpy()
    pts = np.concatenate([pos, goal], axis=1)               # (B, 2N, 2)
    B, n2 = pts.shape[:2]
    assert (pts[..., 0] >= 0).all() and (pts[..., 0] < params.width).all()
    assert (pts[..., 1] >= 0).all() and (pts[..., 1] < params.length).all()
    d = pts[:, :, None] - pts[:, None]
    sq = (d * d).sum(-1) + np.eye(n2, dtype=int) * 10 ** 6
    assert (sq > 2).all(), "start/goal cells closer than the spacing rule"
    np.testing.assert_array_equal(state.dist.numpy(),
                                  np.abs(pos - goal).sum(-1))
    blocks = state.block_mask.numpy()
    assert (blocks.reshape(B, -1).sum(1) == 4 * params.n_blocks).all()
    for b in range(B):
        for x, y in pts[b]:
            assert not blocks[b, x, y], "a block covers a start/goal cell"
        # every block cell belongs to a 2x2 square anchored in range
        xs, ys = np.nonzero(blocks[b])
        assert xs.max(initial=0) <= params.width - 3
        assert ys.max(initial=0) <= params.length - 3


@pytest.mark.parametrize("width,n,blocks", [(10, 4, 0), (10, 4, 2),
                                            (20, 10, 3), (10, 10, 0)])
def test_task_generation_invariants(width, n, blocks):
    with pytest.warns(UserWarning) if (width, n) == (10, 10) else _null():
        p = tdmfb.DMFBParams(width=width, length=width, n_droplets=n,
                             n_blocks=blocks)
    g = torch.Generator().manual_seed(0)
    s = tdmfb.init(p, 64, g, "cpu")
    _check_tasks(p, s)
    assert (s.health == 1).all() and (s.usage == 0).all()
    s2 = tdmfb.reset(p, s._replace(usage=s.usage + 60.0), g)
    _check_tasks(p, s2)
    assert (s2.usage == 0).all(), "reset decays worn cells"
    assert not torch.equal(s2.goal, s.goal), "reset draws new tasks"


def test_env_step_draws_from_the_generator():
    """``Env.step`` is ``step_core`` with its move draws taken from the
    generator, through the kernel dispatch (the plain version on the CPU)."""
    from marl_dmfb_tpu_torch.envs import make_env

    env = make_env("dmfb", n_droplets=4, n_blocks=1)
    g = torch.Generator().manual_seed(3)
    s = env.init(6, g, "cpu")
    s = s._replace(health=torch.rand(s.health.shape, generator=g) * 0.5 + 0.5)
    a = torch.randint(0, 5, (6, 4), generator=g, dtype=torch.int32)
    g_copy = torch.Generator().set_state(g.get_state())
    s1, o1 = env.step(s, a, g)
    s2, o2 = tdmfb.step_core(env.params, s, a,
                             torch.rand((6, 4), generator=g_copy))
    for x, y in zip(tuple(s1) + tuple(o1), tuple(s2) + tuple(o2)):
        assert torch.equal(x, y)


def test_lattice_fallback_keeps_spacing():
    p = tdmfb.DMFBParams(width=10, length=10, n_droplets=4)
    pts = tdmfb._fallback_lattice(p, 32, torch.Generator().manual_seed(1),
                                  torch.device("cpu"))
    d = pts[:, :, None] - pts[:, None]
    sq = (d * d).sum(-1) + torch.eye(8, dtype=torch.int32) * 100
    assert (sq >= 4).all()


def test_degrade_map_range():
    p = tdmfb.DMFBParams(b_degrade=True, per_degrade=0.3)
    m = tdmfb.random_degrade_map(p, 256, torch.Generator().manual_seed(2),
                                 torch.device("cpu"))
    assert ((m >= 0.6) & (m <= 1.0)).all()
    frac = (m < 1.0).float().mean().item()
    assert 0.25 < frac < 0.35


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
