"""The port's MEDA env (``marl_dmfb_tpu_torch/envs/meda.py``) against the
JAX package's (``marl_dmfb_tpu/envs/meda.py``), jitted, on the CPU.

* lockstep full episodes of ``step_core`` (which observes) from states made
  by JAX's ``init`` and carried across, with the same actions and numpy
  uniforms: the integer, bool and observation outputs bitwise equal at
  every step, the rewards within ``REWARD_ATOL``; every observation, on
  30x60 at 2 and 4 droplets, 45x90-4d and 80x80-10d (where the v0.2 zoom
  lands on ties); half of each batch on degraded health, half on full;
* the footprint's mean health (the move probability) bitwise;
* ``reset``, ``restart`` and ``update_health``; the task generation's
  invariants and its lattice fallback; ``global_state`` bitwise; the
  params' errors; ``step``'s draws from its generator;
* on a machine with a card (``cuda``), a full episode on the card against
  the CPU.

JAX is imported inside the tests that need it, so that the card's machine,
which has no JAX, can run the ``cuda`` tests of this file:
``python -m pytest --noconftest -m cuda tests/test_torch_meda_env.py``.
"""

import functools
import types

import numpy as np
import pytest
import torch

from marl_dmfb_tpu_torch.envs import meda as tmeda
from marl_dmfb_tpu_torch.envs import make_env

REWARD_ATOL = 1e-6
STATE_EXACT = ("center", "start", "dest", "sq_dist", "status", "health",
               "usage", "degrade", "step_count", "fails_count")
OUT_EXACT = ("obs", "dones", "terminated", "constraints", "success")
BOARDS = [(30, 60, 2), (30, 60, 4), (45, 90, 4), (80, 80, 10)]
VERSIONS = ["v0", "v0.1", "v0.2"]
B = 8

torch.set_num_threads(1)

# (dx, dy) signs toward the goal -> the action that moves that way
_TOWARD = {(0, -1): 0, (1, 0): 1, (0, 1): 2, (-1, 0): 3, (1, -1): 4,
           (1, 1): 5, (-1, 1): 6, (-1, -1): 7, (0, 0): 8}


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    import marl_dmfb_tpu.envs.meda as jmeda

    return types.SimpleNamespace(jax=jax, jnp=jnp, meda=jmeda)


def params_pair(J, width, length, n, version="v0", **kw):
    kw = dict(width=width, length=length, n_droplets=n,
              fov=19, obs_version=version, **kw)
    return J.meda.MEDAParams(**kw), tmeda.MEDAParams(**kw)


def to_torch(jstate, device="cpu") -> tmeda.MEDAState:
    return tmeda.MEDAState(**{
        f: torch.from_numpy(np.array(getattr(jstate, f))).to(device)
        for f in tmeda.MEDAState._fields})


def jax_states(J, jp, batch, seed, rng):
    """B chips of JAX's ``init``; chips [0, B/2) on health in [0.5, 1),
    the rest on full health; a quarter of the droplets with a destination
    within 3 cells, so that snaps, the done branch and success occur."""
    jax, jnp = J.jax, J.jnp
    s = jax.jit(jax.vmap(functools.partial(J.meda.init, jp)))(
        jax.random.split(jax.random.PRNGKey(seed), batch))
    W, L, N = jp.width, jp.length, jp.n_droplets
    health = np.ones((batch, W, L), np.float32)
    health[: batch // 2] = rng.rand(batch // 2, W, L) * 0.5 + 0.5
    center = np.array(s.center)
    dest = np.array(s.dest)
    near = rng.rand(batch, N) < 0.25
    lo, hi = tmeda.RADIUS, np.array([L - 1 - tmeda.RADIUS,
                                     W - 1 - tmeda.RADIUS])
    close = np.clip(center + rng.randint(-3, 4, (batch, N, 2)), lo, hi)
    dest = np.where(near[..., None], close, dest).astype(np.int32)
    sq = ((center - dest) ** 2).sum(-1).astype(np.int32)
    return s._replace(health=jnp.asarray(health, jnp.float32),
                      dest=jnp.asarray(dest), sq_dist=jnp.asarray(sq))


def actions_toward(rng, center, dest, explore=0.4):
    """Mostly the move toward the goal, else a random action."""
    d = np.sign(dest - center)
    toward = np.vectorize(lambda x, y: _TOWARD[(x, y)])(d[..., 0], d[..., 1])
    rand = rng.randint(0, tmeda.N_ACTIONS, toward.shape)
    return np.where(rng.rand(*toward.shape) < explore, rand,
                    toward).astype(np.int32)


def assert_equal(jstate, jout, tstate, tout, where):
    for f in STATE_EXACT:
        np.testing.assert_array_equal(
            np.array(getattr(jstate, f)), getattr(tstate, f).cpu().numpy(),
            err_msg=f"state.{f} {where}")
    for f in OUT_EXACT:
        want = np.array(getattr(jout, f))
        got = getattr(tout, f).cpu().numpy()
        assert got.dtype == want.dtype, f"out.{f} dtype {where}"
        np.testing.assert_array_equal(want, got, err_msg=f"out.{f} {where}")
    for f in ("rewards", "team_reward"):
        np.testing.assert_allclose(
            np.array(getattr(jout, f)), getattr(tout, f).cpu().numpy(),
            rtol=0, atol=REWARD_ATOL, err_msg=f"out.{f} {where}")


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("width,length,n", BOARDS,
                         ids=[f"{w}x{l}-{n}d" for w, l, n in BOARDS])
def test_lockstep_episode_matches_jax(J, width, length, n, version):
    jp, tp = params_pair(J, width, length, n, version)
    rng = np.random.RandomState(width + n)
    js = jax_states(J, jp, B, seed=width * n, rng=rng)
    ts = to_torch(js)
    jstep = J.jax.jit(J.jax.vmap(functools.partial(J.meda.step_core, jp)))
    jobs = np.array(J.jax.jit(J.jax.vmap(
        functools.partial(J.meda.observe, jp)))(js))
    np.testing.assert_array_equal(jobs, tmeda.observe(tp, ts).numpy())
    seen = dict(snap=False, success=False, fails=False, failed_move=False)
    for t in range(jp.episode_limit):
        a = actions_toward(rng, np.array(js.center), np.array(js.dest))
        u = rng.rand(B, n).astype(np.float32)
        before = np.array(js.center)
        js, jo = jstep(js, J.jnp.asarray(a), J.jnp.asarray(u))
        ts, to = tmeda.step_core(tp, ts, torch.from_numpy(a),
                                 torch.from_numpy(u))
        assert_equal(js, jo, ts, to, f"at step {t}")
        seen["snap"] |= bool(np.array(js.status).any())
        seen["success"] |= bool(np.array(jo.success).any())
        seen["fails"] |= bool(np.array(jo.constraints).any())
        seen["failed_move"] |= bool(
            ((np.array(js.center) == before).all(-1) & (a != 8)
             & ~np.array(js.status)).any())
    assert np.array(jo.dones).all()          # the step limit ends the episode
    assert seen["snap"] and seen["fails"] and seen["failed_move"], seen
    assert tp.obs_dtype == {"v0.2": torch.int8}.get(version, torch.float32)


def test_footprint_mean_health_is_bitwise_jaxs(J):
    """The move probability under degraded health equals jitted JAX's bit
    for bit (the sum's order and the reciprocal of 25)."""
    jax = J.jax
    rng = np.random.RandomState(3)
    jp, _ = params_pair(J, 30, 60, 4)
    health = (rng.rand(64, 30, 60) * 0.5 + 0.5).astype(np.float32)
    center = np.stack([rng.randint(2, 58, (64, 4)),
                       rng.randint(2, 28, (64, 4))], -1).astype(np.int32)
    f = jax.jit(jax.vmap(jax.vmap(
        lambda h, c: J.meda._footprint_mean_health(jp, h, c),
        in_axes=(None, 0))))
    want = np.array(f(health, center))
    got = tmeda.footprint_mean_health(torch.from_numpy(health),
                                      torch.from_numpy(center)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extent", [30, 45, 60, 80, 90, 120])
def test_v02_zoom_matches_jitted_jax_on_every_offset(J, extent):
    """Every offset of a board's axis, ties (80/30: |d| = 4 gives 1.5)
    included."""
    d = np.arange(-extent, extent + 1, dtype=np.int32)
    want = np.array(J.jax.jit(
        lambda d: J.jnp.round(d / (extent / 30.0)).astype(J.jnp.int8))(d))
    got = tmeda.zoom(torch.from_numpy(d), extent).to(torch.int8).numpy()
    np.testing.assert_array_equal(got, want)


def test_update_restart_and_reset_match_jax(J):
    jax = J.jax
    jp, tp = params_pair(J, 30, 60, 4, b_degrade=True, per_degrade=1.0)
    rng = np.random.RandomState(11)
    js = jax_states(J, jp, B, seed=5, rng=rng)
    js = js._replace(usage=J.jnp.asarray(
        rng.randint(40, 60, (B, 30, 60)).astype(np.float32)),
        status=J.jnp.asarray(rng.rand(B, 4) < 0.5),
        step_count=J.jnp.full((B,), 7, J.jnp.int32),
        fails_count=J.jnp.full((B,), 2, J.jnp.int32))
    ts = to_torch(js)
    for name, jfn, tfn in (
            ("update_health", J.meda.update_health, tmeda.update_health),
            ("restart", J.meda.restart, tmeda.restart)):
        want = jax.jit(jax.vmap(functools.partial(jfn, jp)))(js)
        got = tfn(tp, ts)
        for f in STATE_EXACT:
            np.testing.assert_array_equal(
                np.array(getattr(want, f)), getattr(got, f).numpy(),
                err_msg=f"{name}: {f}")
    # update_health is a no-op without b_degrade
    _, tp_off = params_pair(J, 30, 60, 4)
    assert tmeda.update_health(tp_off, ts) is ts
    # reset: new tasks from the generator, the wear decayed as JAX's
    g = torch.Generator().manual_seed(0)
    r = tmeda.reset(tp, ts, g)
    jr = jax.jit(jax.vmap(functools.partial(J.meda.reset, jp)))(js)
    for f in ("health", "usage", "degrade"):
        np.testing.assert_array_equal(np.array(getattr(jr, f)),
                                      getattr(r, f).numpy(), err_msg=f)
    assert not r.status.any() and (r.step_count == 0).all()
    assert (r.fails_count == 0).all() and torch.equal(r.center, r.start)
    assert not torch.equal(r.start, ts.start)


def _check_tasks(p, s):
    c, d = s.start.long(), s.dest.long()
    for pts in (c, d):
        assert (pts[..., 0] >= 2).all() and (pts[..., 0] <= p.length - 3).all()
        assert (pts[..., 1] >= 2).all() and (pts[..., 1] <= p.width - 3).all()
        sq = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
        off = ~torch.eye(p.n_droplets, dtype=torch.bool)
        assert (sq[:, off] >= tmeda.SQ_TOO_CLOSE).all()
    assert not ((d - c).abs() <= 4).all(-1).any()     # no self-overlap
    assert torch.equal(s.sq_dist, ((c - d) ** 2).sum(-1).int())


@pytest.mark.parametrize("width,length,n", BOARDS,
                         ids=[f"{w}x{l}-{n}d" for w, l, n in BOARDS])
def test_task_generation_invariants(J, width, length, n):
    p = tmeda.MEDAParams(width=width, length=length, n_droplets=n)
    s = tmeda.init(p, 256, torch.Generator().manual_seed(n), "cpu")
    _check_tasks(p, s)
    np.testing.assert_array_equal(
        tmeda.fallback_lattice(p), np.array(J.meda._fallback_lattice(
            J.meda.MEDAParams(width=width, length=length, n_droplets=n))))
    assert s.center.dtype == torch.int32 and s.status.dtype == torch.bool
    assert (s.health == 1).all() and (s.usage == 0).all()


def test_task_generation_falls_back_to_the_lattice(monkeypatch):
    """Where every candidate is invalid (here: all at one cell), the first
    droplet takes it and the others their lattice points."""
    p = tmeda.MEDAParams(width=30, length=60, n_droplets=4)
    one = lambda params, batch, gen, dev: torch.full(
        (batch, tmeda.GEN_ROUNDS, 2), 2, dtype=torch.int32, device=dev)
    monkeypatch.setattr(tmeda, "_candidates", one)
    s = tmeda.init(p, 3, torch.Generator().manual_seed(0), "cpu")
    lat = torch.from_numpy(tmeda.fallback_lattice(p))
    assert (s.start[:, 0] == 2).all()
    assert torch.equal(s.start[:, 1:], lat[1:].expand(3, -1, -1))
    # destinations, from the lattice reversed: droplet 0's candidate
    # overlaps its own start, droplet 1's is valid, and droplets 2 and 3's
    # are too close to droplet 1's destination
    rev = lat.flip(0)
    assert torch.equal(s.dest[:, 0], rev[0].expand(3, -1))
    assert (s.dest[:, 1] == 2).all()
    assert torch.equal(s.dest[:, 2:], rev[2:].expand(3, -1, -1))


@pytest.mark.parametrize("width,length,n", [(30, 60, 3), (80, 80, 10)])
def test_global_state_is_bitwise_jaxs(J, width, length, n):
    jp, tp = params_pair(J, width, length, n)
    rng = np.random.RandomState(n)
    js = jax_states(J, jp, B, seed=n, rng=rng)
    want = np.array(J.jax.jit(J.jax.vmap(
        functools.partial(J.meda.global_state, jp)))(js))
    got = tmeda.global_state(tp, to_torch(js))
    assert got.dtype == torch.int8 and got.shape == (B, tp.state_dim)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    assert make_env("meda", width=width, length=length, n_droplets=n
                    ).global_state(to_torch(js)).equal(got)


def test_params_match_jax_and_raise_as_it(J):
    for kw in (dict(), dict(width=80, length=80, n_droplets=10),
               dict(n_droplets=2, obs_version="v0.2"),
               dict(obs_version="v0.1", fov=9)):
        j, t = J.meda.MEDAParams(**kw), tmeda.MEDAParams(**kw)
        assert t.env_info() == j.env_info()
        assert (t.obs_dim, t.n_layers, t.max_step) == (
            j.obs_dim, j.n_layers, j.max_step)
    with pytest.raises(RuntimeError, match="Too many droplets"):
        tmeda.MEDAParams(width=30, length=60, n_droplets=9)
    with pytest.raises(RuntimeError, match="Too many droplets"):
        J.meda.MEDAParams(width=30, length=60, n_droplets=9)
    with pytest.raises(ValueError, match="odd"):
        tmeda.MEDAParams(fov=18)
    with pytest.raises(ValueError, match="unknown MEDA observation"):
        tmeda.MEDAParams(obs_version="v0.3")


def test_registry_maps_versions_as_jax(J):
    from marl_dmfb_tpu.envs import make_env as jmake_env

    for version in (None, "0.1", "0.2", "0.5"):
        t = make_env("meda", version=version)
        j = jmake_env("meda", version=version)
        assert t.params.obs_version == j.params.obs_version
        assert t.n_actions == j.n_actions == 9
        assert t.env_info() == j.env_info()
    assert make_env("dmfb").n_actions == 5


def test_step_draws_from_the_generator():
    p = tmeda.MEDAParams(width=30, length=60, n_droplets=4,
                         obs_version="v0.2")
    s = tmeda.init(p, 16, torch.Generator().manual_seed(1), "cpu")
    s = s._replace(health=torch.full_like(s.health, 0.5))
    a = torch.randint(0, 8, (16, 4), generator=torch.Generator().manual_seed(2),
                      dtype=torch.int32)
    g = torch.Generator().manual_seed(9)
    u = torch.rand((16, 4), generator=torch.Generator().manual_seed(9))
    s1, o1 = tmeda.step(p, s, a, g)
    s2, o2 = tmeda.step_core(p, s, a, u)
    assert torch.equal(s1.center, s2.center) and torch.equal(o1.obs, o2.obs)
    s3, _ = tmeda.step(p, s, a, g)             # the generator moved on
    assert not torch.equal(s3.center, s1.center)


def test_action_deltas_are_the_table():
    a = torch.arange(-2, 12, dtype=torch.int32)
    want = [tmeda.ACTION_DELTAS[k] if 0 <= k < 9 else (0, 0)
            for k in a.tolist()]
    assert tmeda._action_deltas(a).tolist() == [list(d) for d in want]


def test_invalid_actions_move_nothing(J):
    """An action outside [0, 9) is a zero one-hot row in JAX: no move."""
    jp, tp = params_pair(J, 30, 60, 2)
    js = jax_states(J, jp, 4, seed=1, rng=np.random.RandomState(1))
    a = np.array([[9, -1], [12, 3], [-5, 8], [0, 100]], np.int32)
    u = np.zeros((4, 2), np.float32)
    jn, jo = J.jax.jit(J.jax.vmap(functools.partial(J.meda.step_core, jp)))(
        js, J.jnp.asarray(a), J.jnp.asarray(u))
    tn, to = tmeda.step_core(tp, to_torch(js), torch.from_numpy(a),
                             torch.from_numpy(u))
    assert_equal(jn, jo, tn, to, "with invalid actions")


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
def test_cuda_episode_matches_cpu(version):
    """A full 30x60-4d episode on the card against the CPU, from the same
    chips, actions and draws: integer, bool and observation outputs
    bitwise, rewards within ``REWARD_ATOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    p = tmeda.MEDAParams(obs_version=version, b_degrade=True,
                         per_degrade=1.0)
    g = torch.Generator().manual_seed(8)
    cpu = tmeda.init(p, 512, g, "cpu")
    cpu = cpu._replace(health=torch.rand(cpu.health.shape, generator=g)
                       * 0.5 + 0.5)
    card = tmeda.MEDAState(*(t.cuda() for t in cpu))
    for t in range(p.episode_limit):
        a = torch.randint(0, 9, (512, 4), generator=g, dtype=torch.int32)
        u = torch.rand((512, 4), generator=g)
        cpu, oc = tmeda.step_core(p, cpu, a, u)
        card, og = tmeda.step_core(p, card, a.cuda(), u.cuda())
        for f in STATE_EXACT:
            assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f
        for f in OUT_EXACT:
            assert torch.equal(getattr(oc, f), getattr(og, f).cpu()), f
        assert (oc.rewards - og.rewards.cpu()).abs().max() <= REWARD_ATOL
